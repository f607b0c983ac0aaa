"""The port's polarized path against the JAX package on the CPU: one shared
Rayleigh scene with two detectors through ``run_batches`` on both sides
(fluxes and all four Stokes components within 5 combined standard errors),
the polarization-neutral matrix against the port's scalar general kernel,
Lambertian depolarization, and the two places where the port differs from
the JAX module on purpose (ADVICE.md): the ratio-tracking budget of a
grazing detector, and the warning that names the configuration the
polarized path ignores.
"""

import importlib.util
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from i3rc_tpu_torch.core.rng import batch_key
from i3rc_tpu_torch.parallel.mesh import run_batches
from i3rc_tpu_torch.utils.errors import I3RCWarning

torch.set_num_threads(2)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


scenes = _load("polarized_scenes")
H, J = scenes.host("i3rc_tpu_torch"), scenes.host("i3rc_tpu")


def polarized(h, dom, max_events, **kw):
    cfg = h.Config(**scenes.CFG_KW, max_events=max_events)
    if h is H:
        kw["device"] = "cpu"
    return h.Polarized().create(dom, config=cfg, **kw)


def test_port_matches_jax_on_a_rayleigh_scene():
    """Rayleigh (depolarization 0.03, tau 1) over an albedo of 0.2 with a
    detector up and one down at another azimuth: 8 batches of 16384 photons
    a side, the batch means of fluxes and every Stokes component within 5
    combined standard errors (+1e-6 for V, which is 0 on both sides)."""
    det = dict(surface_albedo=0.2, intensity_mus=[0.8, -0.5], intensity_phis=[0.0, 60.0])
    n, n_batches = 16384, 8
    from i3rc_tpu.parallel.mesh import run_batches as jax_run_batches

    sides = []
    for h, run in ((J, jax_run_batches), (H, run_batches)):
        integ = polarized(h, scenes.rayleigh_slab(h, 1.0, depol=0.03), 200, **det)
        stats = run(integ, h.Source.directional(0.5, 0.0), n, n_batches, seed=4)
        m, e = stats.mean, stats.stderr
        sides.append({k: (np.asarray(getattr(m, k), np.float64).ravel(),
                          np.asarray(getattr(e, k), np.float64).ravel())
                      for k in ("flux_up", "flux_down", "flux_absorbed", "intensity")})
    (jm, tm) = sides
    for k in jm:
        (a, ea), (b, eb) = jm[k], tm[k]
        tol = 5 * np.sqrt(ea ** 2 + eb ** 2) + 1e-6
        assert np.all(np.abs(a - b) <= tol), (k, a, b, tol)
    assert float(tm["intensity"][0][1]) < 0.0      # Q < 0 at the up detector


def test_identity_matrix_matches_the_scalar_general_kernel():
    """b1 = 0, a2 = a3 = a4 = a1 leaves the Stokes vector alone: fluxes and
    radiance equal those of the port's scalar general kernel (maximum
    cross-section, the same P11) within the JAX test's bounds
    (tests/test_polarized.py:229-274), and no polarization appears."""
    from i3rc_tpu_torch.integrators.integrator import Integrator

    n = 60_000
    ang = np.linspace(0.0, np.pi, 181)
    vals = H.rayleigh_values(ang)["a1"]
    pm = H.PhaseMatrix.from_elements(ang, vals, np.zeros_like(vals), vals, a2=vals, a4=vals)
    mtab = H.PhaseMatrixTable.from_phase_matrices([pm], [1.0])
    dom = H.Domain.create([0.0, 500.0], [0.0, 500.0], np.linspace(0.0, 250.0, 3))
    ext = np.full((1, 1, 2), 2.0 / 250.0)
    comp = lambda tab: dom.add_component("c", ext, np.full_like(ext, 0.9),
                                         np.zeros(ext.shape, np.int32), tab)
    det = dict(intensity_mus=[0.7], intensity_phis=[30.0])
    src = H.Source.directional(0.5, 0.0)
    res_p = polarized(H, comp(mtab), 200, **det).compute(batch_key(11, 0), src, n)
    cfg = H.Config(use_ray_tracing=False, max_events=200, use_fastpath=False,
                   use_russian_roulette=False, compute_volume_absorption=False)
    res_s = Integrator.create(comp(mtab.scalar), cfg, device="cpu", **det).compute(
        batch_key(12, 0), src, n)
    sig = 2.0 / np.sqrt(n)
    for name in ("mean_flux_up", "mean_flux_down", "mean_flux_absorbed"):
        assert float(getattr(res_p, name)) == pytest.approx(float(getattr(res_s, name)),
                                                            abs=4 * sig), name
    s = res_p.mean_intensity[0].numpy()
    assert float(s[0]) == pytest.approx(float(res_s.mean_intensity[0]), rel=0.04)
    assert abs(s[1]) < 0.01 * s[0] and abs(s[2]) < 0.01 * s[0]


def test_lambertian_surface_depolarizes():
    """Thin Rayleigh over a bright Lambertian surface: the upwelling DoP
    falls well below single scattering's, and the surface feeds the
    detector (tests/test_polarized.py:277-302; 50,000 photons, the gates
    hold by a wide margin)."""
    dom = scenes.rayleigh_slab(H, 0.1)
    det = dict(intensity_mus=[0.6], intensity_phis=[0.0])
    src = H.Source.directional(0.6, 0.0)
    res = polarized(H, dom, 100, surface_albedo=0.8, **det).compute(batch_key(7, 0), src, 50_000)
    assert float(res.degree_of_polarization[0]) < 0.2
    res0 = polarized(H, dom, 100, **det).compute(batch_key(7, 0), src, 50_000)
    assert float(res.mean_intensity[0, 0]) > 2.0 * float(res0.mean_intensity[0, 0])


def test_grazing_detector_budget_differs_from_jax_on_purpose():
    """ADVICE.md: the JAX module sizes the ratio-tracking rounds with |mu|
    floored at 1e-3 (polarized.py:266-270) although create accepts any
    |mu| > 1e-30, so a grazing detector's rays can run out of rounds and land
    in n_bad.  The port sizes them from the true smallest |mu|: with |mu| =
    5e-4 over tau 5 its budget is the JAX formula's at |mu| = 5e-4, twice
    the floored one, and no photon is bad."""
    mus, phis = [5e-4, 0.8], [0.0, 0.0]
    dom = scenes.rayleigh_slab(H, 5.0)
    integ = polarized(H, dom, 200, intensity_mus=mus, intensity_phis=phis)
    maj_h = float(np.float32(5.0 / 250.0)) * 250.0     # the majorant optical depth
    port_rounds = integ.spec_args["max_rounds"]
    assert port_rounds == 64 + 8 * int(maj_h / 5e-4)
    assert port_rounds > 1.99 * (64 + 8 * int(maj_h / 1e-3))       # JAX's floored budget
    res = integ.compute(batch_key(31, 0), H.Source.directional(0.5, 0.0), 8192)
    assert int(res.n_bad) == 0
    assert torch.isfinite(res.intensity).all() and float(res.mean_intensity[0, 0]) > 0.0


def test_ignored_flags_warn_unlike_jax():
    """ADVICE.md: the JAX create ignores settings the polarized path does
    not run without a word (polarized.py:670-739).  The port warns once,
    naming each such flag set away from what the path runs, and still runs
    the namelist; the default configuration is silent."""
    dom_j, dom_t = scenes.rayleigh_slab(J, 1.0), scenes.rayleigh_slab(H, 1.0)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        J.Polarized().create(dom_j, config=J.Config(use_ray_tracing=True))
    assert not [w for w in rec if "ignores" in str(w.message)]
    with pytest.warns(I3RCWarning, match="use_ray_tracing=True") as rec:
        integ = H.Polarized().create(dom_t, config=H.Config(use_ray_tracing=True,
                                                            compute_volume_absorption=False),
                                     device="cpu")
    assert len(rec) == 1 and "compute_volume_absorption" not in str(rec[0].message)
    with pytest.warns(I3RCWarning) as rec:
        H.Polarized().create(dom_t, config=H.Config(
            use_hybrid_phase_funs=True, limit_intensity_contributions=True,
            use_russian_roulette_for_intensity=True, majorant_block_size=4,
            use_ray_tracing=False), device="cpu")
    msg = str(rec[0].message)
    for flag in ("use_hybrid_phase_funs", "limit_intensity_contributions",
                 "use_russian_roulette_for_intensity", "majorant_block_size",
                 "compute_volume_absorption"):
        assert flag in msg, (flag, msg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        H.Polarized().create(dom_t, device="cpu")
    res = integ.compute(batch_key(1, 0), H.Source.directional(0.5, 0.0), 4096)
    assert abs(float(res.mean_flux_up + res.mean_flux_down) - 1.0) < 0.02
