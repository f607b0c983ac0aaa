"""The event block's plain twin against the JAX package's own fast_event.

The JAX ``fast_event`` is captured from ``make_fast_tracer``: with
``use_pallas_fastpath=True`` it hands the function to
``_build_pallas_block``, which the test replaces with a recorder.  Both
sides then run from the same random in-domain lane state on the same
uniforms (numpy, seeded), one event and one K=8 block.  Each side builds
its domain and configuration with its own classes from the same numpy
arrays.

Tolerance: integer fields equal on >= 99.5% of lanes, and float fields
within 1e-5 relative to each field's magnitude on >= 99.5% of those lanes.

The dead-lane contract that the kernel's compaction of live lanes relies on
is pinned exactly, on the twin (a whole block) and on the JAX fast_event
(one event): a dead lane's only change in an event is its free path, tau =
-log(max(u0, TINY)), taken when tau <= 0.
The two sides differ only in the last-ulp rounding of rsqrt and log (XLA's
and torch's are each ~1 ulp accurate, but round differently).  Near the
poles the rotation divides by sqrt(1 - uz^2), which turns a 1-ulp
difference in uz into ~3e-5 in the new direction, so a few lanes per ten
thousand exceed 1e-5 after one event and a few per thousand after eight.
"""

import importlib
from dataclasses import replace
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3rc_tpu.core.rng import exponential_deviate as jax_exponential_deviate
from i3rc_tpu.integrators import fastpath as jfast
from i3rc_tpu.integrators.integrator import Integrator as JaxIntegrator
from i3rc_tpu_torch.core.rng import batch_key, exponential_deviate, philox_uniforms
from i3rc_tpu_torch.integrators.fastpath import event_spec, plan_from_jax, state_from_numpy
from i3rc_tpu_torch.integrators.integrator import Integrator
from i3rc_tpu_torch.kernels.event_block import (
    compare_states,
    event_block,
    event_block_reference,
)

torch.set_num_threads(2)
L = 4096


def host(pkg: str) -> SimpleNamespace:
    """One side's host layer: the port keeps its copies under the JAX
    package's module paths."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    pf = mod("core.phase_functions")
    return SimpleNamespace(
        Domain=mod("core.optics").Domain, PhaseFunction=pf.PhaseFunction,
        PhaseFunctionTable=pf.PhaseFunctionTable, hg=pf.henyey_greenstein_coefficients,
        make_step_cloud=mod("models.step_cloud").make_step_cloud,
        make_landsat_cloud=mod("models.landsat_cloud").make_landsat_cloud,
        cfg=mod("integrators.config").IntegratorConfig(use_ray_tracing=False,
                                                        max_events=500))


JAX, PORT = host("i3rc_tpu"), host("i3rc_tpu_torch")
CFG = PORT.cfg


def y_scene(h, ssa):
    """A separable scene with x, y and z structure (y is tracked)."""
    vx = np.array([1.0, 2.0, 2.0, 0.5])
    vy = np.array([1.0, 3.0, 1.0])
    vz = np.array([0.0, 0.02, 0.03, 0.0])
    ext = vx[:, None, None] * vy[None, :, None] * vz[None, None, :]
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.85, 48))], key=[1.0])
    dom = h.Domain.create(np.linspace(0, 300.0, 5), np.linspace(0, 200.0, 4),
                          np.linspace(0, 100.0, 5))
    return dom.add_component("c", ext, np.full_like(ext, ssa),
                             np.zeros(ext.shape, np.int32), table)


SCENES = {"step_cloud": lambda h, ssa: h.make_step_cloud(ssa), "y_scene": y_scene}


def _setup(scene, ssa, monkeypatch):
    """(JAX fast_event, port EventSpec) for one scene, each side's domain
    built with its own classes."""
    jinteg = JaxIntegrator.create(SCENES[scene](JAX, ssa), config=JAX.cfg)
    captured = {}

    def record(fast_event, track_y, L_, K, **kw):
        captured.update(fe=fast_event, track_y=track_y, n_draws=kw["n_draws"])
        return lambda seed2, st: st

    monkeypatch.setattr(jfast, "_build_pallas_block", record)
    jfast.make_fast_tracer(jinteg.geometry, jinteg._fast_plan,
                           replace(JAX.cfg, use_pallas_fastpath=True), 1 << 14, L)
    tinteg = Integrator.create(SCENES[scene](PORT, ssa), config=CFG, device="cpu")
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
    fast_event, spec = _setup(scene, ssa, monkeypatch)
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


@pytest.mark.parametrize("scene", ["step_cloud", "landsat"])
def test_dead_lane_contract_of_the_block(scene):
    """A block on lanes dead at entry (tau <= 0 for some) and lanes that die
    mid-block: a dead lane's rows change exactly as the contract says.  The
    step cloud runs its separable plan at K = 8, Landsat its column plan at
    the planner's K = 32."""
    make = PORT.make_step_cloud if scene == "step_cloud" else PORT.make_landsat_cloud
    integ = Integrator.create(make(0.99), config=CFG, device="cpu")
    spec = event_spec(integ.geometry, integ._fast_plan, CFG)
    assert spec.K == (8 if scene == "step_cloud" else 32) and spec.col == (scene == "landsat")
    rng = np.random.default_rng(23)
    st0 = state_from_numpy(_random_state(spec, rng))
    U = torch.from_numpy(rng.uniform(size=(spec.K, spec.n_draws, L)).astype(np.float32))
    # The state after each event: blocks of one event in a row.
    snaps = [st0.clone()]
    for j in range(spec.K):
        snaps.append(snaps[-1].clone())
        event_block_reference(replace(spec, K=1), snaps[-1], U[j:j + 1])
    got = st0.clone()
    event_block_reference(spec, got, U)
    assert torch.equal(got.f, snaps[-1].f) and torch.equal(got.i, snaps[-1].i)

    # Dead at entry: tau drawn at event 0 when tau <= 0, nothing else.
    dead0 = st0.i[0] == 0
    want = st0.clone()
    tau = want.f[6]
    want.f[6] = torch.where(tau > 0.0, tau, exponential_deviate(U[0, 0]))
    assert int(dead0.sum()) > 0 and int((dead0 & (st0.f[6] <= 0.0)).sum()) > 0
    assert torch.equal(got.f[:, dead0], want.f[:, dead0])
    assert torch.equal(got.i[:, dead0], want.i[:, dead0])
    # Died at event e - 1 (alive for e events): the state after e events, then
    # the draw of event e when tau <= 0 and e < K.
    events = (got.i[4] - st0.i[4]).tolist()
    died = [lane for lane in range(L) if not dead0[lane] and got.i[0, lane] == 0]
    assert len(died) > 100 and len({events[lane] for lane in died}) > 2
    for lane in died:
        e = events[lane]
        f, i = snaps[e].f[:, lane].clone(), snaps[e].i[:, lane]
        assert int(i[0]) == 0
        if e < spec.K and not float(f[6]) > 0.0:
            f[6] = exponential_deviate(U[e, 0, lane])
        assert torch.equal(got.f[:, lane], f) and torch.equal(got.i[:, lane], i), lane


def test_dead_lane_contract_of_jax_fast_event(monkeypatch):
    """One JAX fast_event on the step cloud: a dead lane keeps every field
    but tau, which becomes -log(max(u0, TINY)) where it was <= 0."""
    fast_event, spec = _setup("step_cloud", 0.99, monkeypatch)
    rng = np.random.default_rng(29)
    st0 = _random_state(spec, rng)
    U = rng.uniform(size=(spec.n_draws, L)).astype(np.float32)
    jst = tuple(jnp.asarray(a) for a in st0) + (jnp.zeros((1, 1), jnp.float32),)
    out = [np.asarray(a) for a in fast_event(jnp.asarray(U), jst)]
    dead = ~st0[0]
    assert int(dead.sum()) > 0 and int((dead & (st0[7] <= 0.0)).sum()) > 0
    tau = np.asarray(jnp.where(jnp.asarray(st0[7]) > 0.0, jnp.asarray(st0[7]),
                               jax_exponential_deviate(jnp.asarray(U[0]))))
    for k in range(12):
        want = tau if k == 7 else st0[k]
        assert np.array_equal(out[k][dead], np.asarray(want)[dead]), k


@pytest.mark.cuda
@pytest.mark.parametrize("ssa", [1.0, 0.99])
def test_kernel_matches_twin_on_gpu(ssa):
    """The CUDA kernel against its twin on the same Philox draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    integ = Integrator.create(y_scene(PORT, ssa), config=CFG, device=dev)
    spec = event_spec(integ.geometry, integ._fast_plan, CFG)
    st = state_from_numpy(_random_state(spec, np.random.default_rng(5)), device=dev)
    got, ref = st.clone(), st.clone()
    key = batch_key(1, 2)
    event_block(spec, got, key, 3)
    event_block_reference(spec, ref, philox_uniforms(key, 3, spec.K, spec.n_draws, L, dev))
    agree = compare_states(spec, got, ref, rtol=1e-4)
    assert agree["int_frac"] >= 0.999 and agree["float_frac"] == 1.0, agree
