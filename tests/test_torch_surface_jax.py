"""Reflecting surfaces: the port's Integrator against the JAX package's on the
CPU, and the spectral loop over a BRDF surface.

Each case runs 8 batches on each side (the JAX XLA fastpath at K = 1, the
port's plain version of the kernel) and holds each mean against the other
within 5 combined standard errors of the batch means: a bottom hit can be
counted several times and a BRDF carries lane weights, so no binomial sigma
bounds these tallies.  Each side builds its domain and configuration with
its own classes from the same numpy arrays.  The JAX fastpath's Iwabuchi
roulette drops exp(-tau) in one case (ROADMAP Queue 3): the radiance cases
run without roulette.
"""

import importlib
from dataclasses import replace
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from i3rc_tpu.core.illumination import PhotonSource as JaxSource
from i3rc_tpu.integrators import spectral as jspectral
from i3rc_tpu.integrators.integrator import Integrator as JaxIntegrator
from i3rc_tpu_torch import Integrator, PhotonSource, batch_key, run_band
from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component

torch.set_num_threads(2)


def host(pkg: str) -> SimpleNamespace:
    """One side's host layer: the port keeps its copies under the JAX
    package's module paths."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    pf = mod("core.phase_functions")
    return SimpleNamespace(
        Domain=mod("core.optics").Domain, PhaseFunction=pf.PhaseFunction,
        PhaseFunctionTable=pf.PhaseFunctionTable, hg=pf.henyey_greenstein_coefficients,
        make_step_cloud=mod("models.step_cloud").make_step_cloud,
        Surface=mod("core.surface").SurfaceDescription,
        KDistribution=mod("core.k_distribution").KDistribution,
        gas=mod("integrators.spectral").domain_with_gas_component,
        cfg=mod("integrators.config").IntegratorConfig(
            use_ray_tracing=False, max_events=500, compute_volume_absorption=False))


JAX, PORT = host("i3rc_tpu"), host("i3rc_tpu_torch")
GAS = np.concatenate([np.full(16, 1e-3), np.full(8, 5e-4), np.full(8, 1e-4)])


def column_scene(h):
    """A 5 x 4 column grid, one homogeneous layer per column with its own
    extinction, base and top (tests/test_torch_fused_block.py): the column
    (Landsat-like) fastpath."""
    rng = np.random.default_rng(3)
    ext = np.zeros((5, 4, 6))
    for ix in range(5):
        for iy in range(4):
            lo = int(rng.integers(0, 3))
            ext[ix, iy, lo:lo + int(rng.integers(1, 4))] = rng.uniform(0.005, 0.05)
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.85, 48))], key=[1.0])
    dom = h.Domain.create(np.linspace(0, 500.0, 6), np.linspace(0, 400.0, 5),
                          np.linspace(0, 300.0, 7))
    return dom.add_component("c", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32), table)


RPV = dict(surface=("rpv", [0.2, 0.8, -0.1]), intensity_mus=[0.5, -0.5],
           intensity_phis=[40.0, 0.0])
# name -> (scene, config changes, Integrator.create keywords, photons per batch,
#          mean fields compared)
CASES = {
    "step_albedo": (lambda h: h.make_step_cloud(1.0), {}, dict(surface_albedo=0.2), 1 << 12,
                    ("fup", "fdn")),
    "albedo_detectors": (lambda h: h.make_step_cloud(1.0), {},
                         dict(surface_albedo=0.3, intensity_mus=[1.0, 0.5],
                              intensity_phis=[0.0, 0.0]), 1 << 12,
                         ("fup", "i0", "i1", "srf0", "srf1")),
    "rpv_radiance": (lambda h: h.make_step_cloud(1.0), {}, RPV, 1 << 12, ("fup", "i0", "i1")),
    "cox_munk": (lambda h: h.make_step_cloud(1.0), {},
                 dict(surface=("cox_munk", [8.0, 1.34])), 1 << 12, ("fup", "fdn")),
    "absorbing_reflecting_volume": (lambda h: h.make_step_cloud(0.99),
                                    dict(compute_volume_absorption=True),
                                    dict(surface_albedo=0.3), 1 << 12,
                                    ("fup", "fdn", "fabs")),
    "gas_albedo": (lambda h: h.gas(h.make_step_cloud(0.99), GAS), {},
                   dict(surface_albedo=0.2), 1 << 12, ("fup", "fdn", "fabs")),
    "column_albedo": (column_scene, {}, dict(surface_albedo=0.2), 1 << 12, ("fup", "fdn")),
}
BATCHES = 8


def _means(res, intensity: bool) -> dict:
    m = {"fup": res.mean_flux_up, "fdn": res.mean_flux_down, "fabs": res.mean_flux_absorbed}
    if intensity:
        i = np.asarray(res.mean_intensity, np.float64)
        s = np.asarray(res.intensity_by_component, np.float64)[..., 0].mean(axis=(0, 1))
        m.update({f"i{d}": i[d] for d in range(i.size)} | {f"srf{d}": s[d] for d in range(s.size)})
    return {k: float(v) for k, v in m.items()}


def _create(h, name):
    scene, cfg_kw, kw, _, _ = CASES[name]
    kw = dict(kw)
    if "surface" in kw:
        brdf, params = kw["surface"]
        kw["surface"] = h.Surface.uniform(params, brdf_name=brdf)
    cfg = replace(h.cfg, **cfg_kw)
    if h is JAX:
        return JaxIntegrator.create(scene(h), config=replace(cfg, fastpath_unroll=1), **kw)
    return Integrator.create(scene(h), config=cfg, device="cpu", **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_jax(name):
    n, fields = CASES[name][3], CASES[name][4]
    jinteg, tinteg = _create(JAX, name), _create(PORT, name)
    jplan = jinteg._fast_plan
    assert jplan is not None and tinteg._fast_plan is not None
    det = tinteg.intensity is not None
    jfn = jinteg.batch_fn(JaxSource.directional(0.5, 0.0), n, n_lanes=n)
    tfn = tinteg.batch_fn(PhotonSource.directional(0.5, 0.0), n, n_lanes=n)
    jrows, trows = [], []
    for b in range(BATCHES):
        jres, tres = jfn(jax.random.PRNGKey(100 + b)), tfn(batch_key(100, b))
        assert int(tres.n_bad) == 0 and int(jres.n_bad) == 0
        jrows.append(_means(jres, det))
        trows.append(_means(tres, det))
        if name == "absorbing_reflecting_volume":
            # The exact flux / volume identity (tests/test_fastpath.py:263-264).
            vol = tres.volume_absorption.double().sum(dim=2) * (250.0 / 32)
            np.testing.assert_allclose(vol.numpy(), tres.flux_absorbed.double().numpy(),
                                       rtol=1e-5)
    for k in fields:
        j = np.array([r[k] for r in jrows])
        t = np.array([r[k] for r in trows])
        se = np.sqrt(j.var(ddof=1) / BATCHES + t.var(ddof=1) / BATCHES)
        assert abs(t.mean() - j.mean()) <= 5 * se + 1e-12, (name, k, t.mean(), j.mean(), se)
    if name == "albedo_detectors":
        # Slot 0 is the surface: upward detectors see it.
        assert min(r["srf0"] for r in trows) > 0.0 and min(r["srf1"] for r in trows) > 0.0


def test_brdf_band_matches_jax_and_differs_from_black():
    """``run_band`` over a BRDF surface carries the surface into every k
    point's integrator: the band differs from the black-surface band (by
    far more than its sigma) and matches the JAX baked band within 4 sigma."""
    z = np.linspace(0, 250.0, 5)

    def slab(h):
        dom = h.Domain.create([0, 500.0], [0, 500.0], z)
        ext = np.full((1, 1, 4), 0.5 / 250.0)
        table = h.PhaseFunctionTable.from_phase_functions(
            [h.PhaseFunction.from_legendre(h.hg(0.85, 64))], key=[1.0])
        return dom.add_component("cloud", ext, np.ones_like(ext),
                                 np.zeros(ext.shape, np.int32), table)

    def kd(h):
        return h.KDistribution.create(z, np.broadcast_to([[0.1 / 250, 0.5 / 250]], (4, 2)).copy(),
                                      [0.6, 0.4], wavelength_limits=(0.5, 0.7),
                                      spectral_fraction=1.0)

    n, batches = 1 << 12, 4
    means = lambda r: {"fup": r.mean_flux_up, "fdn": r.mean_flux_down}
    surface = lambda h: h.Surface.uniform([0.2, 0.05, 0.02], brdf_name="ross_li")
    bands = {}
    for label, surf in (("brdf", surface(PORT)), ("black", None)):
        integ = Integrator.create(domain_with_gas_component(slab(PORT), kd(PORT)
                                                            .absorption_profiles_on(z)[:, 0]),
                                  config=PORT.cfg, surface=surf, device="cpu")
        bands[label] = run_band(integ, slab(PORT), kd(PORT), PhotonSource.directional(0.5, 0.0),
                                n, batches, seed=3, derive=means)
    jinteg = JaxIntegrator.create(JAX.gas(slab(JAX), kd(JAX).absorption_profiles_on(z)[:, 0]),
                                  config=replace(JAX.cfg, fastpath_unroll=1),
                                  surface=surface(JAX))
    jband = jspectral.run_band(jinteg, slab(JAX), kd(JAX), JaxSource.directional(0.5, 0.0), n,
                               batches, seed=3, derive=means, bake_fastpath=True)
    got, black = bands["brdf"].mean["derived"], bands["black"].mean["derived"]
    se = {k: float(bands["brdf"].stderr["derived"][k]) for k in ("fup", "fdn")}
    jse = {k: float(jband.stderr["derived"][k]) for k in ("fup", "fdn")}
    for k in ("fup", "fdn"):
        sigma = (se[k] ** 2 + jse[k] ** 2) ** 0.5
        assert float(got[k]) == pytest.approx(float(jband.mean["derived"][k]), abs=4 * sigma), k
    assert float(got["fup"]) - float(black["fup"]) > 10 * se["fup"]
