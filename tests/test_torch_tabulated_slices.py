"""Slices of the table modes on the port's fastpath: Monte Carlo estimates of
the plain twin against the JAX package's fastpath, against the port's own
general kernel (an independent sampler of the same cubic fit, with the
dense forward table for radiance), and against the discrete-ordinates slab
oracle; and a namelist over a tabulated domain through the driver.

Tolerances (estimates of independent runs): fluxes within 4 combined
binomial sigma; radiances within 5 combined standard errors of the batch
means (the JAX package's own gate is rtol 0.08 at 2^15 photons,
tests/test_fastpath.py:1101); closure within 1e-4; the isotropic slab within
4 sigma of ``slab_fluxes``.  The JAX side compiles its XLA fastpath at K = 1
(``fastpath_unroll``: same physics, ~3 s to compile on a CPU instead of ~30).
"""

import importlib.util
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from i3rc_tpu.integrators.config import IntegratorConfig as JaxConfig
from i3rc_tpu.integrators.integrator import Integrator as JaxIntegrator
from i3rc_tpu_torch import Integrator, IntegratorConfig, batch_key
from i3rc_tpu_torch.drivers.monte_carlo_driver import run_from_namelist
from i3rc_tpu_torch.integrators import integrator as port_integrator
from i3rc_tpu_torch.io.netcdf import write_domain
from tests.disort_oracle import slab_fluxes

_spec = importlib.util.spec_from_file_location("tabulated_scenes",
                                               Path(__file__).with_name("tabulated_scenes.py"))
scenes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(scenes)

torch.set_num_threads(2)
JAX, PORT = scenes.host("i3rc_tpu"), scenes.host("i3rc_tpu_torch")
CFG_KW = dict(use_ray_tracing=False, max_events=2000, compute_volume_absorption=False)
DET2 = dict(intensity_mus=[0.5, -0.5], intensity_phis=[0.0, 0.0])
FIELDS = ("mean_flux_up", "mean_flux_down", "mean_flux_absorbed")


def run(side: str, scene, n: int, batches: int, seed: int, det=None, **cfg_kw):
    """Per batch (fluxes, radiances) of n photons: the port's fastpath (its
    twin on the CPU), the port's general kernel ("general"), or the JAX
    package's fastpath."""
    det = det or {}
    if side == "jax":
        integ = JaxIntegrator.create(scene(JAX), config=JaxConfig(
            **CFG_KW, fastpath_unroll=1, **cfg_kw), **det)
        assert integ._fast_plan is not None and integ._fast_plan.cubic is not None
        fn = integ.batch_fn(JAX.Source.directional(0.5, 0.0), n)
        res = [fn(jax.random.PRNGKey(seed + b)) for b in range(batches)]
    else:
        general = side == "general"
        integ = Integrator.create(scene(PORT), config=IntegratorConfig(
            **CFG_KW, use_fastpath=not general,
            **(dict(majorant_block_size=4) if general else {}), **cfg_kw), device="cpu", **det)
        assert (integ._fast_plan is None) == general
        if not general:
            assert integ._fast_plan.cubic is not None
        fn = integ.batch_fn(PORT.Source.directional(0.5, 0.0), n)
        res = [fn(batch_key(seed, b)) for b in range(batches)]
    flux = np.array([[float(getattr(r, f)) for f in FIELDS] for r in res])
    rad = np.array([np.asarray(r.mean_intensity, np.float64) for r in res]) if det else None
    return flux, rad, res


def assert_fluxes_agree(a, b, n_a, n_b, what, k=4.0):
    """Each flux of two runs within k combined binomial sigma."""
    fa, fb = a.mean(0), b.mean(0)
    for i, f in enumerate(FIELDS):
        p = max(0.5 * (fa[i] + fb[i]), 1e-4)
        sigma = np.sqrt(p * (1 - p) * (1.0 / n_a + 1.0 / n_b))
        assert abs(fa[i] - fb[i]) <= k * sigma, (what, f, fa, fb, sigma)


def assert_radiances_agree(a, b, what, k=5.0):
    """Each detector's batch mean within k combined standard errors."""
    se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
    assert np.all(np.abs(a.mean(0) - b.mean(0)) <= k * se), (what, a.mean(0), b.mean(0), se)


def assert_closure(flux, tol=1e-4):
    assert np.all(np.abs(flux.sum(1) - 1.0) <= tol), flux


@pytest.mark.parametrize("name,scene,det", [
    ("c1_slab", scenes.c1_slab, None),
    ("c1_slab_radiance", scenes.c1_slab, DET2),
    ("c1_gas", scenes.c1_gas_slab, None),
])
def test_slab_slices_match_jax_and_general(name, scene, det):
    """The C.1 slab (with two detectors; with a gas): the twin against the
    JAX fastpath and the port's general kernel, 8 x 2^12 photons a side."""
    n, b = 1 << 12, 8
    port, port_rad, res = run("port", scene, n, b, 31, det)
    jx, jx_rad, _ = run("jax", scene, n, b, 41, det)
    gen, gen_rad, _ = run("general", scene, n, b, 51, det)
    assert_closure(port)
    assert all(int(r.n_bad) == 0 for r in res)
    assert_fluxes_agree(port, jx, n * b, n * b, f"{name} vs JAX")
    assert_fluxes_agree(port, gen, n * b, n * b, f"{name} vs general")
    if det:
        assert np.all(port_rad.mean(0) > 0.0)
        assert_radiances_agree(port_rad, jx_rad, f"{name} vs JAX")
        assert_radiances_agree(port_rad, gen_rad, f"{name} vs general")


def test_column_props_slice_matches_jax_and_general():
    """Per-column ssa and three table entries (tests/test_fastpath.py:618):
    Fup, Fdn and the absorbed flux within 4 combined sigma of the JAX
    fastpath and of the general kernel; closure."""
    n, b = 1 << 13, 4
    port, _, res = run("port", scenes.column_props_scene, n, b, 61)
    jx, _, _ = run("jax", scenes.column_props_scene, n, b, 71)
    gen, _, _ = run("general", scenes.column_props_scene, n, b, 81)
    assert_closure(port, 1e-5)
    assert all(int(r.n_bad) == 0 for r in res) and port[:, 2].mean() > 0.02
    assert_fluxes_agree(port, jx, n * b, n * b, "column props vs JAX")
    assert_fluxes_agree(port, gen, n * b, n * b, "column props vs general")


def test_isotropic_slab_matches_the_oracle():
    """tau = 1, ssa = 1, mu0 = 0.5, isotropic scattering (the cubic fit is
    exact): R and T within 4 sigma of the discrete-ordinates oracle."""
    n, b = 1 << 14, 2
    flux, _, _ = run("port", scenes.isotropic_slab, n, b, 91)
    r, t = slab_fluxes(1.0, 1.0, [0.0], 0.5)
    for got, want in ((flux[:, 0].mean(), r), (flux[:, 1].mean(), t)):
        sigma = np.sqrt(want * (1 - want) / (n * b))
        assert abs(got - want) <= 4 * sigma, (got, want, sigma)
    assert_closure(flux, 1e-5)


def test_driver_runs_a_tabulated_domain_on_the_fastpath(tmp_path, monkeypatch):
    """A namelist over a netCDF domain with the C.1 table (written by the
    port's io/netcdf.py) and useRayTracing = .false.: the driver plans the
    fastpath's table mode and never builds the general kernel's tracer."""
    write_domain(scenes.c1_step_cloud(PORT), str(tmp_path / "c1.opt"))
    plans = []
    real = port_integrator.make_fast_tracer

    def fast(geom, plan, *a, **k):
        plans.append(plan)
        return real(geom, plan, *a, **k)

    def general(*a, **k):
        raise AssertionError("the driver took the general kernel")

    monkeypatch.setattr(port_integrator, "make_fast_tracer", fast)
    monkeypatch.setattr(port_integrator, "make_batch_tracer", general)
    nml = tmp_path / "run.nml"
    nml.write_text(textwrap.dedent(f"""
    &radiativeTransfer
      solarFlux = 1., solarMu = 0.5, solarAzimuth = 0.
    /
    &monteCarlo
      numPhotonsPerBatch = 2048, numBatches = 2, iseed = 7
    /
    &algorithms
      useRayTracing = .false.
    /
    &fileNames
      domainFileName = "{tmp_path}/c1.opt",
      outputFluxFile = "{tmp_path}/fluxes.out"
    /
    """))
    out = run_from_namelist(str(nml), quiet=True, device="cpu")
    assert plans and all(p.cubic is not None and p.cubic.shape == (256, 4) for p in plans)
    (fup, _), (fdn, _), _ = out["mean_stats"]
    assert fup + fdn == pytest.approx(1.0, abs=1e-4) and 0.2 < fup < 0.9
    assert (tmp_path / "fluxes.out").is_file()
