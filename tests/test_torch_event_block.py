"""The event block's plain twin against the JAX package's own fast_event.

The JAX ``fast_event`` is captured from ``make_fast_tracer``: with
``use_pallas_fastpath=True`` it hands the function to
``_build_pallas_block``, which the test replaces with a recorder.  Both
sides then run from the same random in-domain lane state on the same
uniforms (numpy, seeded), one event and one K=8 block.

Tolerance: integer fields equal on >= 99.5% of lanes, and float fields
within 1e-5 relative to each field's magnitude on >= 99.5% of those lanes.
The two sides differ only in the last-ulp rounding of rsqrt and log (XLA's
and torch's are each ~1 ulp accurate, but round differently).  Near the
poles the rotation divides by sqrt(1 - uz^2), which turns a 1-ulp
difference in uz into ~3e-5 in the new direction, so a few lanes per ten
thousand exceed 1e-5 after one event and a few per thousand after eight.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3rc_tpu.core.optics import Domain
from i3rc_tpu.core.phase_functions import (
    PhaseFunction,
    PhaseFunctionTable,
    henyey_greenstein_coefficients,
)
from i3rc_tpu.integrators import fastpath as jfast
from i3rc_tpu.integrators.config import IntegratorConfig
from i3rc_tpu.integrators.integrator import Integrator as JaxIntegrator
from i3rc_tpu.models.step_cloud import make_step_cloud
from i3rc_tpu_torch.core.rng import batch_key, philox_uniforms
from i3rc_tpu_torch.integrators.fastpath import event_spec, plan_from_jax, state_from_numpy
from i3rc_tpu_torch.integrators.integrator import Integrator
from i3rc_tpu_torch.kernels.event_block import (
    compare_states,
    event_block,
    event_block_reference,
)

torch.set_num_threads(2)
CFG = IntegratorConfig(use_ray_tracing=False, max_events=500)
L = 4096


def y_scene(ssa):
    """A separable scene with x, y and z structure (y is tracked)."""
    vx = np.array([1.0, 2.0, 2.0, 0.5])
    vy = np.array([1.0, 3.0, 1.0])
    vz = np.array([0.0, 0.02, 0.03, 0.0])
    ext = vx[:, None, None] * vy[None, :, None] * vz[None, None, :]
    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(0.85, 48))], key=[1.0])
    dom = Domain.create(np.linspace(0, 300.0, 5), np.linspace(0, 200.0, 4),
                        np.linspace(0, 100.0, 5))
    return dom.add_component("c", ext, np.full_like(ext, ssa),
                             np.zeros(ext.shape, np.int32), table)


def _setup(dom, monkeypatch):
    """(JAX fast_event, port EventSpec, JAX geometry) for one domain."""
    jinteg = JaxIntegrator.create(dom, config=CFG)
    captured = {}

    def record(fast_event, track_y, L_, K, **kw):
        captured.update(fe=fast_event, track_y=track_y, n_draws=kw["n_draws"])
        return lambda seed2, st: st

    monkeypatch.setattr(jfast, "_build_pallas_block", record)
    jfast.make_fast_tracer(jinteg.geometry, jinteg._fast_plan,
                           replace(CFG, use_pallas_fastpath=True), 1 << 14, L)
    tinteg = Integrator.create(dom, config=CFG, device="cpu")
    spec = event_spec(tinteg.geometry, plan_from_jax(jinteg._fast_plan), CFG)
    assert spec.track_y == captured["track_y"] and spec.n_draws == captured["n_draws"]
    return captured["fe"], spec


def _random_state(spec, rng):
    """Random in-domain lanes: a numpy tuple in the JAX state order."""
    x = rng.uniform(spec.x0, spec.x_max, L)
    y = rng.uniform(spec.y0, spec.y_max, L)
    z = rng.uniform(spec.z0, spec.z_max, L)
    d = rng.normal(size=(3, L))
    d /= np.linalg.norm(d, axis=0)
    tau = np.where(rng.uniform(size=L) < 0.5, 0.0, rng.exponential(size=L))
    orders = rng.integers(0, 40, L)
    orders[:16] = spec.max_events - 1          # lanes about to hit the cap
    alive = rng.uniform(size=L) < 0.9
    f32 = lambda a: np.asarray(a, np.float32)
    i32 = lambda a: np.asarray(a, np.int32)
    return (alive, f32(x), f32(y), f32(z), f32(d[0]), f32(d[1]), f32(d[2]), f32(tau),
            i32(orders), np.zeros(L, np.int32), np.zeros(L, np.int32),
            i32(rng.integers(0, 100, L)))


@pytest.mark.parametrize("scene,ssa", [("step_cloud", 1.0), ("step_cloud", 0.99),
                                       ("y_scene", 1.0), ("y_scene", 0.99)])
def test_twin_matches_jax_fast_event(scene, ssa, monkeypatch):
    dom = make_step_cloud(ssa) if scene == "step_cloud" else y_scene(ssa)
    fast_event, spec = _setup(dom, monkeypatch)
    assert spec.track_y == (scene == "y_scene")
    rng = np.random.default_rng(11)
    st0 = _random_state(spec, rng)
    U = rng.uniform(size=(spec.K, spec.n_draws, L)).astype(np.float32)
    for K in (1, spec.K):
        jst = tuple(jnp.asarray(a) for a in st0) + (jnp.zeros((1, 1), jnp.float32),)
        for j in range(K):
            jst = fast_event(jnp.asarray(U[j]), jst)
        ref = state_from_numpy([np.asarray(a) for a in jst])
        got = state_from_numpy(st0)
        event_block_reference(replace(spec, K=K), got, torch.from_numpy(U[:K]))
        agree = compare_states(spec, got, ref, rtol=1e-5)
        assert agree["int_frac"] >= 0.995, agree
        assert agree["float_frac"] >= 0.995, agree
    # The block did real work: collisions, exits and (when absorbing) deaths.
    pk = got.i[2]
    assert int((pk == 1).sum()) > 0 and int((pk == 2).sum()) > 0
    assert (int((pk == 3).sum()) > 0) == (ssa < 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("ssa", [1.0, 0.99])
def test_kernel_matches_twin_on_gpu(ssa):
    """The CUDA kernel against its twin on the same Philox draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    integ = Integrator.create(y_scene(ssa), config=CFG, device=dev)
    spec = event_spec(integ.geometry, integ._fast_plan, CFG)
    st = state_from_numpy(_random_state(spec, np.random.default_rng(5)), device=dev)
    got, ref = st.clone(), st.clone()
    key = batch_key(1, 2)
    event_block(spec, got, key, 3)
    event_block_reference(spec, ref, philox_uniforms(key, 3, spec.K, spec.n_draws, L, dev))
    agree = compare_states(spec, got, ref, rtol=1e-4)
    assert agree["int_frac"] >= 0.999 and agree["float_frac"] == 1.0, agree
