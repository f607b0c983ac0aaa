"""The general kernel's deterministic building blocks, port against the JAX
package on identical numpy inputs: the DDA (``ops/dda.py``
``trace_extinction``) on a heterogeneous grid with regular and irregular z
and on a block-majorant grid, the inverse-CDF cubic tables, the block
majorants, the packed per-cell optics and the cubic angle sampler.

Tolerances: cell indices and statuses must be equal (they decide the
physics); positions and optical depths within 4 float32 ulps of their
scale (the domain's extent on that axis; tau's magnitude) per DDA step of
the lane: XLA on the CPU contracts x + s * u into
one fused multiply-add, torch and the CUDA kernel (built with --fmad=false)
round the product first, so a step may differ by one rounding and the
coordinates that do not snap to a face carry it along; tables, majorants
and packed rows equal; the sampled cosine within 1e-6 (the JAX read is a
one-hot matmul).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3rc_tpu.integrators.integrator import Integrator as JaxIntegrator
from i3rc_tpu.ops import dda as jdda
from i3rc_tpu_torch.integrators import integrator as tint
from i3rc_tpu_torch.integrators.wavefront import sample_cos_scat
from i3rc_tpu_torch.ops import dda as tdda
from tests.general_cases import JAX, PORT
from tests.general_scenes import two_component

torch.set_num_threads(2)
SIDES = ("i3rc_tpu", "i3rc_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def edges(irregular_z: bool):
    rng = np.random.default_rng(11)
    xe = np.linspace(0.0, 600.0, 7)
    ye = np.linspace(-100.0, 400.0, 6)
    if irregular_z:
        ze = np.concatenate([[0.0], np.cumsum(rng.uniform(20.0, 90.0, 7))])
    else:
        ze = np.linspace(0.0, 350.0, 8)
    return xe, ye, ze


def field(shape, seed=12):
    """A heterogeneous extinction field with empty cells."""
    rng = np.random.default_rng(seed)
    ext = rng.uniform(0.0, 0.02, shape) * (rng.uniform(size=shape) > 0.25)
    return ext.astype(np.float32)


def lanes(xe, ye, ze, n=512, seed=13):
    """Lanes inside the domain with random, grazing, vertical and axis-
    aligned directions and exponential optical-depth targets."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(xe[0], xe[-1], n).astype(np.float32)
    y = rng.uniform(ye[0], ye[-1], n).astype(np.float32)
    z = rng.uniform(ze[0], ze[-1], n).astype(np.float32)
    mu = rng.uniform(-1.0, 1.0, n)
    mu[:64] = rng.choice([-1.0, 1.0], 64) * rng.uniform(1e-4, 2e-3, 64)     # grazing
    mu[64:80] = rng.choice([-1.0, 1.0], 16)                                 # vertical
    phi = rng.uniform(0.0, 2 * np.pi, n)
    phi[80:96] = 0.0                                                        # along x
    s = np.sqrt(np.maximum(1 - mu * mu, 0.0))
    ux, uy, uz = (s * np.cos(phi)).astype(np.float32), (s * np.sin(phi)).astype(np.float32), \
        mu.astype(np.float32)
    uy[80:96] = 0.0
    tau = rng.exponential(2.0, n).astype(np.float32)
    tau[96:128] = 50.0                                                     # exit, mostly
    active = rng.uniform(size=n) > 0.05
    return x, y, z, ux, uy, uz, tau, active


def run_both(xe, ye, ze, ext, max_crossings, irregular_z, seed=13):
    """(JAX result, port result) as numpy tuples (x, y, z, ix, iy, iz, tau,
    status), both sides starting from their own located cells."""
    x, y, z, ux, uy, uz, tau, active = lanes(xe, ye, ze, seed=seed)
    jg = jdda.GridGeometry.from_edges(xe, ye, ze, True, not irregular_z)
    tg = tdda.GridGeometry.from_edges(xe, ye, ze, True, not irregular_z)
    jcells = [np.asarray(f(jnp.asarray(v))) for f, v in ((jg.locate_x, x), (jg.locate_y, y),
                                                          (jg.locate_z, z))]
    tcells = [f(torch.as_tensor(v)).numpy() for f, v in ((tg.locate_x, x), (tg.locate_y, y),
                                                          (tg.locate_z, z))]
    for a, b in zip(jcells, tcells):
        np.testing.assert_array_equal(a, b)
    j = jdda.trace_extinction(jg, jnp.asarray(ext.ravel()), *map(jnp.asarray, (x, y, z)),
                              *map(jnp.asarray, jcells), *map(jnp.asarray, (ux, uy, uz)),
                              jnp.asarray(tau), jnp.asarray(active), max_crossings)
    steps = torch.zeros(x.size, dtype=torch.int32)
    t = tdda.trace_extinction(tg, torch.as_tensor(ext.ravel()),
                              *map(torch.as_tensor, (x, y, z)),
                              *(torch.as_tensor(c) for c in tcells),
                              *map(torch.as_tensor, (ux, uy, uz)), torch.as_tensor(tau),
                              torch.as_tensor(active), max_crossings, steps=steps)
    return [np.asarray(a) for a in j], [b.numpy() for b in t], steps.numpy()


def assert_traces_equal(j, t, steps, xe, ye, ze):
    jx, jy, jz, jix, jiy, jiz, jtau, jst = j
    tx, ty, tz, tix, tiy, tiz, ttau, tst = t
    # Inactive lanes come back unchanged with status BAD on both sides.
    np.testing.assert_array_equal(jst, tst)
    for a, b in ((jix, tix), (jiy, tiy), (jiz, tiz)):
        np.testing.assert_array_equal(a, b)
    for a, b, scale in ((jx, tx, xe), (jy, ty, ye), (jz, tz, ze), (jtau, ttau, ttau)):
        # ulps of the coordinate's scale: the domain's extent on that axis.
        ulp = np.spacing(np.maximum(np.maximum(np.abs(a), np.abs(b)),
                                    np.abs(scale).max()).astype(np.float32))
        assert np.all(np.abs(a - b) <= 4 * ulp * np.maximum(steps, 1)), \
            float((np.abs(a - b) / ulp / np.maximum(steps, 1)).max())
    return jst


@pytest.mark.parametrize("irregular_z", [False, True])
def test_trace_extinction_matches_jax(irregular_z):
    """Every status and cell index equal, positions and tau within 4 ulp;
    the lanes cover collisions, wraps, exits through the top and the bottom,
    grazing and vertical directions, inactive lanes and, with a budget of 3
    crossings, budget exhaustion."""
    xe, ye, ze = edges(irregular_z)
    ext = field((6, 5, 7))
    for budget in (1024, 3):
        j, t, steps = run_both(xe, ye, ze, ext, budget, irregular_z)
        st = assert_traces_equal(j, t, steps, xe, ye, ze)
        active = lanes(xe, ye, ze)[-1]
        kinds = {int(k) for k in st[active]}
        assert {tdda.SCATTER, tdda.EXIT_TOP, tdda.EXIT_BOT} <= kinds
        if budget == 3:
            assert tdda.BAD in kinds


def test_trace_on_block_majorants_matches_jax():
    """The Woodcock flight: the DDA over the super-voxel grid (every 2nd
    fine edge) with the block majorants as its extinction; the majorants and
    the coarse geometry equal on both sides."""
    from i3rc_tpu.integrators import integrator as jint

    xe, ye, ze = np.linspace(0, 800.0, 9), np.linspace(0, 600.0, 7), np.linspace(0, 300.0, 11)
    ext = field((8, 6, 10), seed=21)
    blocks = tint.majorant_block_shape(ext.shape, 2)
    assert blocks == jint.majorant_block_shape(ext.shape, 2) == (2, 2, 2)
    tmaj = tint.block_majorants(ext, blocks)
    np.testing.assert_array_equal(tmaj, jint.block_majorants(ext, blocks))
    j, t, steps = run_both(xe[::2], ye[::2], ze[::2], tmaj.reshape(4, 3, 5), 64, False,
                           seed=22)
    assert np.all(steps[lanes(xe[::2], ye[::2], ze[::2], seed=22)[-1]] > 0)
    assert_traces_equal(j, t, steps, xe[::2], ye[::2], ze[::2])


def test_packed_optics_tables_and_majorants_equal_the_originals():
    """device_optics_from_flat (the packed row with the co-albedo, the block
    majorants, the uniformity flags, the maximum) and build_inverse_cubic
    equal the JAX package's."""
    from i3rc_tpu.integrators import integrator as jint

    jflat, tflat = (mod(h.pkg, "core.optics").flatten_optics(two_component(h))
                    for h in (JAX, PORT))
    jopt = jint.device_optics_from_flat(jflat, 2)
    topt = tint.device_optics_from_flat(tflat, 2)
    np.testing.assert_array_equal(np.asarray(jopt.cell_matrix), topt.cell_matrix.numpy())
    np.testing.assert_array_equal(np.asarray(jopt.total_ext), topt.total_ext.numpy())
    np.testing.assert_array_equal(np.asarray(jopt.block_majorant), topt.block_majorant.numpy())
    assert float(jopt.max_extinction) == topt.max_extinction
    assert (jopt.n_components, jopt.uniform_ssa, jopt.uniform_phase_index) == \
        (topt.n_components, topt.uniform_ssa, topt.uniform_phase_index) == (2, None, None)
    jcub = mod("i3rc_tpu", "integrators.tables").build_inverse_cubic(jflat)
    tcub = mod("i3rc_tpu_torch", "integrators.tables").build_inverse_cubic(tflat)
    assert tcub.shape == (2, 2, 256, 4)
    np.testing.assert_array_equal(jcub, tcub)
    # The single-component step cloud: uniform ssa and phase index.
    j1, t1 = (mod(p, "core.optics").flatten_optics(
        mod(p, "models.step_cloud").make_step_cloud(0.99)) for p in SIDES)
    ju, tu = jint.device_optics_from_flat(j1), tint.device_optics_from_flat(t1)
    assert (ju.uniform_ssa, ju.uniform_phase_index) == (tu.uniform_ssa, tu.uniform_phase_index)
    assert tu.uniform and tu.block_majorant.numel() == 0


def _closure(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def test_sample_cos_scat_matches_jax():
    """The scattering cosine of the piecewise-cubic inverse CDF, per
    (component, phase entry), on the same uniforms: within 1e-6."""
    jdom = two_component(JAX)
    cfg = mod("i3rc_tpu", "integrators.config").IntegratorConfig(use_fastpath=False)
    jint = JaxIntegrator.create(jdom, config=cfg)
    trace = jint.batch_tracer(256, 256)
    jsample = _closure(_closure(trace, "event_step"), "sample_cos_scat")
    port = tint.Integrator.create(two_component(PORT), device="cpu")
    rng = np.random.default_rng(41)
    u = rng.uniform(size=4096).astype(np.float32)
    u[:4] = [0.0, 1.0 - 2 ** -24, 0.5, 1.0]
    comp = rng.integers(0, 2, 4096).astype(np.int32)
    pf = rng.integers(0, 2, 4096).astype(np.int32) * (comp == 0)
    got = sample_cos_scat(port.tables, torch.as_tensor(comp), torch.as_tensor(pf),
                          torch.as_tensor(u)).numpy()
    want = np.asarray(jsample(jnp.asarray(comp), jnp.asarray(pf), jnp.asarray(u)))
    assert np.abs(got - want).max() <= 1e-6
    assert got.min() >= -1.0 and got.max() <= 1.0
