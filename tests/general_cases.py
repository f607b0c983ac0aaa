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


JAX, PORT = host("i3rc_tpu"), host("i3rc_tpu_torch")


def step_cloud_32x8(h, ssa=0.99):
    """The 32 x 1 x 8 step cloud of tests/test_integrator.py:157."""
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.85, 64))], key=[1.0])
    ext = np.where(np.arange(32)[:, None, None] < 16, 2.0, 18.0) / 250.0 * np.ones((32, 1, 8))
    dom = h.Domain.create(np.linspace(0, 500, 33), [0.0, 500.0], np.linspace(0, 250, 9))
    return dom.add_component("cloud", ext, np.full_like(ext, ssa), np.zeros(ext.shape, np.int32),
                             table)


def two_component(h):
    """A seeded random 3-D domain: an HG cloud with two phase entries and a
    tabulated non-HG (Rayleigh) haze, ssa < 1, irregular x and z."""
    rng = np.random.default_rng(7)
    shape = (6, 5, 6)
    ext1 = rng.uniform(0.0, 0.06, shape) * (rng.uniform(size=shape) > 0.3)
    ext2 = rng.uniform(0.002, 0.01, shape)
    hg = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(g, 48)) for g in (0.85, 0.5)], key=[1.0, 2.0])
    ang = np.linspace(0.0, np.pi, 91)
    ray = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_tabulated(ang, 0.75 * (1 + np.cos(ang) ** 2))], key=[0.0])
    z = np.concatenate([[0.0], np.cumsum(rng.uniform(25.0, 60.0, shape[2]))])
    x = np.concatenate([[0.0], np.cumsum(rng.uniform(60.0, 140.0, shape[0]))])
    dom = h.Domain.create(x, np.linspace(0, 500.0, 6), z)
    dom = dom.add_component("cloud", ext1, rng.uniform(0.9, 1.0, shape),
                            rng.integers(0, 2, shape).astype(np.int32), hg)
    return dom.add_component("haze", ext2, np.full(shape, 0.9), np.zeros(shape, np.int32), ray)


def weight1_domain(h):
    """tests/test_serial_path.py:101-136's random 8^3 cloud, here at ssa 0.9."""
    rng = np.random.default_rng(3)
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.85, 32))], key=[1.0])
    ext = rng.uniform(0.0, 0.03, (8, 8, 8))
    ext[ext < 0.01] = 0.0
    dom = h.Domain.create(np.linspace(0, 800.0, 9), np.linspace(0, 800.0, 9),
                          np.linspace(0, 400.0, 9))
    return dom.add_component("c", ext, np.full_like(ext, 0.9), np.zeros(ext.shape, np.int32),
                             table)


RPV_GRID = np.array([[[0.1, 0.8, -0.1], [0.3, 0.7, 0.1]],
                     [[0.2, 0.9, 0.0], [0.05, 0.6, -0.2]]])


def rpv_grid(h):
    """A 2 x 2 gridded RPV surface under the step cloud."""
    return h.Surface.create(RPV_GRID, [0.0, 250.0, 500.0], [0.0, 250.0, 500.0],
                            brdf_name="rpv")


def fields(res, profile: bool) -> dict:
    out = {k: float(getattr(res, f"mean_flux_{k}")) for k in ("up", "down", "absorbed")}
    if profile:
        out.update({f"abs_z{k}": float(v) for k, v in
                    enumerate(np.asarray(res.absorbed_profile, np.float64))})
    return out


def run_side(h, dom, cfg_kw: dict, create_kw: dict, n: int, batches: int, lanes: int,
             profile: bool = False):
    """(integrator, {field: per-batch values}) of ``batches`` batches."""
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
    per = [fields(r, profile) for r in runs]
    return integ, {k: np.array([p[k] for p in per]) for k in per[0]}, runs


def assert_agree(jv: dict, tv: dict, n_se: float = 4.0, floor: float = 0.0) -> None:
    """Each field's means within n_se combined standard errors of the batch
    means (plus ``floor``, for fields whose batches can all agree)."""
    for k in jv:
        a, b = jv[k], tv[k]
        se = np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
        assert abs(a.mean() - b.mean()) <= n_se * se + floor, (k, a.mean(), b.mean(), se)
