"""Scenes and runners shared by the general-kernel tests that hold the port
against the JAX package (tests/test_torch_general_jax.py,
tests/test_torch_general_scenes_jax.py).

Each side builds its domain and configuration with its own classes from the
same numpy arrays (``host(pkg)``), runs ``batches`` independent batches
through its ``Integrator.batch_fn`` (the JAX package's general kernel, XLA on
the CPU; the port's plain version of the general event block), and the means
of each field agree within ``n_se`` combined standard errors of the batch
means: the RNG streams differ, and weights and roulette rule out a binomial
sigma.
"""

import jax
import numpy as np
import torch

from i3rc_tpu_torch.core.rng import batch_key
from tests.general_oracles import host
from tests.general_scenes import DET_MUS, DET_PHIS, step_cloud_32x8


JAX, PORT = host("i3rc_tpu"), host("i3rc_tpu_torch")


def fields(res, profile: bool, radiance: bool = False) -> dict:
    if radiance:
        return {f"I{d}": float(v) for d, v in enumerate(np.asarray(res.mean_intensity,
                                                                   np.float64))}
    out = {k: float(getattr(res, f"mean_flux_{k}")) for k in ("up", "down", "absorbed")}
    if profile:
        out.update({f"abs_z{k}": float(v) for k, v in
                    enumerate(np.asarray(res.absorbed_profile, np.float64))})
    return out


def run_side(h, dom, cfg_kw: dict, create_kw: dict, n: int, batches: int, lanes: int,
             profile: bool = False, radiance: bool = False):
    """(integrator, {field: per-batch values}) of ``batches`` batches; with
    ``radiance`` the fields are the detectors' mean radiances."""
    cfg = h.Config(**cfg_kw)
    if h.pkg == "i3rc_tpu":
        integ = h.Integrator.create(dom, config=cfg, **create_kw)
        fn = integ.batch_fn(h.Source.directional(0.5, 0.0), n, n_lanes=lanes)
        runs = [fn(jax.random.PRNGKey(100 + b)) for b in range(batches)]
    else:
        integ = h.Integrator.create(dom, config=cfg, device="cpu", **create_kw)
        fn = integ.batch_fn(h.Source.directional(0.5, 0.0), n, n_lanes=lanes)
        with torch.inference_mode():
            runs = [fn(batch_key(200, b)) for b in range(batches)]
    per = [fields(r, profile, radiance) for r in runs]
    return integ, {k: np.array([p[k] for p in per]) for k in per[0]}, runs


def assert_agree(jv: dict, tv: dict, n_se: float = 4.0, floor: float = 0.0) -> None:
    """Each field's means within n_se combined standard errors of the batch
    means (plus ``floor``, for fields whose batches can all agree)."""
    for k in jv:
        a, b = jv[k], tv[k]
        se = np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
        assert abs(a.mean() - b.mean()) <= n_se * se + floor, (k, a.mean(), b.mean(), se)


def compare_radiance(dom_fn, cfg_kw: dict, create_fn=None, n: int = 2048, batches: int = 4,
                     n_se: float = 4.0):
    """The I3RC detectors' mean radiances of ``batches`` batches of ``n``
    photons (one wavefront) on each side, the domain ``dom_fn(h)`` and the
    creation arguments ``create_fn(h)`` built with that side's classes,
    agreeing within ``n_se`` combined standard errors.  The JAX side runs
    its inline estimator (use_queued_intensity=False: the queued one has
    its expectations, and compiles 3x longer on the CPU); the port takes
    ``cfg_kw`` as given.  Returns (JAX integrator, port integrator, the
    port's Results)."""
    def create(h):
        kw = dict(intensity_mus=DET_MUS, intensity_phis=DET_PHIS)
        kw.update(create_fn(h) if create_fn else {})
        return kw

    ji, jv, _ = run_side(JAX, dom_fn(JAX), dict(cfg_kw, use_queued_intensity=False), create(JAX),
                         n, batches, n, radiance=True)
    ti, tv, runs = run_side(PORT, dom_fn(PORT), cfg_kw, create(PORT), n, batches, n,
                            radiance=True)
    assert_agree(jv, tv, n_se)
    return ji, ti, runs


MODES = {"ray_tracing": dict(use_ray_tracing=True),
         "max_cross_section": dict(use_ray_tracing=False),
         "woodcock": dict(use_ray_tracing=False, majorant_block_size=4)}


def check_mode_radiance(mode: str, iwabuchi: bool) -> None:
    """The step cloud 32 x 8 (ssa 0.99) with the I3RC detectors in transport
    ``mode`` (MODES), exact trace or Iwabuchi roulette at zeta_min 0.3,
    fastpath off: the port's estimator and mode, finite fields, few bad
    photons, and its radiances against the JAX package's
    (compare_radiance)."""
    from i3rc_tpu_torch.integrators.wavefront import EXACT, IWABUCHI

    cfg = dict(use_fastpath=False, max_events=500, compute_volume_absorption=False,
               use_russian_roulette_for_intensity=iwabuchi, zeta_min=0.3, **MODES[mode])
    _, ti, runs = compare_radiance(step_cloud_32x8, cfg)
    spec = ti.batch_tracer(2048, 2048).spec
    assert spec.mode == list(MODES).index(mode)
    assert spec.det.est == (IWABUCHI if iwabuchi else EXACT) and not spec.chained
    for r in runs:
        assert int(r.n_bad) <= 1e-3 * 2048
        assert np.isfinite(r.intensity.numpy()).all() and r.intensity.shape == (32, 1, 3)
