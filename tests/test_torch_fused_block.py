"""One whole block of the trace loop: ``fused_block`` and its plain version.

A block is the prologue (renormalize, flush of pending exits, FIFO refill)
and then the K events.  On the CPU ``fused_block`` runs
``fused_block_reference``; these tests hold that

* to the sequence the trace loop ran before the prologue became a stage of
  the kernel (renormalize, flush, refill, ``event_block_reference``,
  transcribed below), bit for bit, on mid-flight states with pending exits
  of every kind, dead lanes and a photon budget that runs out inside the
  block, for flux, absorption with the volume tally, the gas channel,
  detectors and column media, and for each of the six source kinds;
* the FIFO rule to a numpy reconstruction of the JAX rule
  (i3rc_tpu/integrators/fastpath.py:2019-2045);
* the trace's loop check every N blocks to the check every block: equal
  ``RawTallies`` field for field, for N = 1, 4 and more than the trace has
  blocks (96), also when the block cap ends the trace;
* the step-cloud slice to the JAX package within the 4 sigma that
  tests/test_torch_integrator.py states;
* the planner and the card to each other: every plan ``fast_plan`` returns
  passes ``launch_refusal``, and what the kernel is not built for is refused
  at the plan, naming its ROADMAP item.

The CUDA cases (marker ``cuda``) repeat the bit-for-bit check against the
kernel itself, over reflecting surfaces too, and run the plans the card
used to refuse (D = 9 and 16, K = 4 and 32).  Only the comparison with the JAX package imports it, inside
its test, so that the file also runs on a machine with a card and no JAX
(``python -m pytest --noconftest tests/test_torch_fused_block.py -m cuda``).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from i3rc_tpu_torch import (
    Domain,
    Integrator,
    IntegratorConfig,
    PhaseFunction,
    PhaseFunctionTable,
    PhotonSource,
    SurfaceDescription,
    batch_key,
    henyey_greenstein_coefficients,
    make_step_cloud,
)
from i3rc_tpu_torch.core.rng import STREAM_REFILL, gas_thresholds, philox_uniforms
from i3rc_tpu_torch.integrators import fastpath
from i3rc_tpu_torch.integrators.fastpath import event_spec, launch_state, prologue_spec
from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component
from i3rc_tpu_torch.integrators.wavefront import make_direction_cosines
from i3rc_tpu_torch.kernels.event_block import (
    ALIVE,
    DONE,
    ORDERS,
    PK,
    TAU,
    TGAS,
    UX,
    UY,
    UZ,
    X,
    Y,
    Z,
    block_buffers,
    event_block,
    event_block_reference,
    fused_block,
    fused_block_reference,
    launch_refusal,
    refill,
)

torch.set_num_threads(2)
L = 1000                      # not a multiple of the kernel's 256 lanes per CTA
CFG = IntegratorConfig(use_ray_tracing=False, max_events=500, compute_volume_absorption=False)
DIRECTIONAL = PhotonSource.directional(0.5, 0.0)
SOURCES = {
    "directional": DIRECTIONAL,
    "random_azimuth": PhotonSource.random_azimuth(0.6),
    "flux_weighted": PhotonSource.flux_weighted(),
    "spotlight": PhotonSource.spotlight(0.5, 30.0, 0.3, 0.6),
    "internal_flux": PhotonSource.internal_flux(0.4, 0.5, 0.7, False, delta_x=0.2,
                                                delta_y=0.1),
    "internal_intensity": PhotonSource.internal_intensity(0.4, 0.5, 0.7, -0.8, 45.0),
}


def column_scene(ssa: float):
    """A 5 x 4 column grid, one homogeneous layer per column with its own
    extinction, base and top: not separable, so the planner takes the
    column mode."""
    rng = np.random.default_rng(3)
    ext = np.zeros((5, 4, 6))
    for ix in range(5):
        for iy in range(4):
            lo = int(rng.integers(0, 3))
            ext[ix, iy, lo:lo + int(rng.integers(1, 4))] = rng.uniform(0.005, 0.05)
    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(0.85, 48))], key=[1.0])
    dom = Domain.create(np.linspace(0, 500.0, 6), np.linspace(0, 400.0, 5),
                        np.linspace(0, 300.0, 7))
    return dom.add_component("c", ext, np.full_like(ext, ssa), np.zeros(ext.shape, np.int32),
                             table)


def wide_detectors(n: int) -> dict:
    """n detector directions: an azimuth scan at mu = 0.5, as the JAX
    package's comment on wide detector sets names it."""
    return dict(intensity_mus=[0.5] * n,
                intensity_phis=[360.0 * d / n for d in range(n)])


DET3 = dict(intensity_mus=[1.0, 0.5, 0.5], intensity_phis=[0.0, 0.0, 180.0])
IWABUCHI = replace(CFG, use_russian_roulette_for_intensity=True, zeta_min=0.3)
GAS = np.concatenate([np.full(16, 1e-3), np.full(8, 5e-4), np.full(8, 1e-4)])
# name -> (domain, config, Integrator.create keywords)
CASES = {
    "flux": (lambda: make_step_cloud(1.0), CFG, {}),
    "absorbing_volume": (lambda: make_step_cloud(0.9),
                         replace(CFG, compute_volume_absorption=True), {}),
    "gas": (lambda: domain_with_gas_component(make_step_cloud(0.99), GAS), CFG, {}),
    "detectors": (lambda: make_step_cloud(1.0), IWABUCHI, DET3),
    "column": (lambda: column_scene(0.95), replace(CFG, compute_volume_absorption=True), {}),
}


def midflight(case: str, source: PhotonSource, device="cpu", lanes: int = L):
    """(spec, pro, state, buffers, key, kb): a state two blocks into a trace
    (pending exits, dead lanes), entering block ``kb`` with a budget that
    covers half of its dead lanes, so that the FIFO rank decides who takes."""
    make, cfg, kw = CASES[case]
    integ = Integrator.create(make(), config=cfg, device=device, **kw)
    geom = integ.geometry
    spec = event_spec(geom, integ._fast_plan, cfg)
    key = batch_key(17, 4)
    st = launch_state(geom, DIRECTIONAL.sample(key, lanes, device), lanes,
                      gas_key=key if spec.gas else None)
    pro = prologue_spec(geom, spec, cfg, 100 * lanes)
    buf = block_buffers(spec, pro, st, lanes)
    kb = 2
    for k in range(kb):
        fused_block_reference(spec, pro, st, buf, key, DIRECTIONAL, k)
    launched = int(buf.ctl[kb & 1])
    n_dead = int((st.i[ALIVE] == 0).sum())
    assert n_dead > 20 and int((st.i[PK] != 0).sum()) > 0
    pro = replace(pro, n_photons=launched + n_dead // 2)
    return spec, pro, st, block_buffers(spec, pro, st, launched, kb), key, kb


# ---------------------------------------------------------------------------
# The sequence the trace loop ran per block before the prologue moved into
# the kernel, transcribed.

def old_renormalize(st):
    ux, uy, uz = st.f[UX], st.f[UY], st.f[UZ]
    st.f[UX:UZ + 1] *= torch.rsqrt(torch.clamp(ux * ux + uy * uy + uz * uz,
                                               min=float(np.float32(1e-12))))


def old_flush(pro, spec, columns, vol, st):
    x, y, z = st.f[X], st.f[Y], st.f[Z]
    pk = st.i[PK]
    col = torch.clamp(((x - pro.x0) * pro.inv_dx).to(torch.int64), 0, pro.n_x - 1)
    if spec.track_y and pro.n_y > 1:
        iy = torch.clamp(((y - pro.y0) * pro.inv_dy).to(torch.int64), 0, pro.n_y - 1)
        col = col * pro.n_y + iy
    kinds = [pk == 1, pk == 2] + ([pk == 3] if pro.deaths else [])
    columns.index_add_(0, col, torch.stack(kinds, dim=1).to(torch.float64))
    if pro.vol_tally:
        iz = torch.clamp(((z - pro.z0) * pro.inv_dz_cell).to(torch.int64), 0, pro.n_z - 1)
        vol.index_add_(0, col * pro.n_z + iz, (pk == 3).to(torch.float64))
    pk.zero_()


def old_refill(pro, spec, st, launched, key, source, kb):
    n = st.n_lanes
    dead = st.i[ALIVE] == 0
    dead_i = dead.to(torch.int64)
    new_id = launched + torch.cumsum(dead_i, 0) - dead_i
    take = dead & (new_id < pro.n_photons)
    fresh = source.sample(key, n, st.f.device, stream=STREAM_REFILL, block=kb)
    f, i = st.f, st.i
    f[X] = torch.where(take, pro.x0 + fresh.x * (pro.x_max - pro.x0), f[X])
    f[Y] = torch.where(take, pro.y0 + fresh.y * (pro.y_max - pro.y0), f[Y])
    f[Z] = torch.where(take, pro.z0 + fresh.z * (pro.z_max - pro.z0), f[Z])
    for row, v in zip((UX, UY, UZ), make_direction_cosines(fresh.mu, fresh.phi)):
        f[row] = torch.where(take, v, f[row])
    f[TAU] = torch.where(take, 0.0, f[TAU])
    if spec.gas:
        f[TGAS] = torch.where(take, gas_thresholds(key, kb, n, f.device), f[TGAS])
    i[ORDERS] = torch.where(take, 0, i[ORDERS])
    i[ALIVE] = i[ALIVE] | take.to(torch.int32)
    return launched + take.sum()


def old_block(spec, pro, st, buf, launched, key, source, kb):
    old_renormalize(st)
    old_flush(pro, spec, buf.columns, buf.vol, st)
    launched = old_refill(pro, spec, st, launched, key, source, kb)
    u = philox_uniforms(key, kb, spec.K, spec.n_draws, st.n_lanes, st.f.device)
    event_block_reference(spec, st, u, buf.acc)
    return int(launched)


def assert_same_block(got_st, got, ref_st, ref, slot: int) -> None:
    """13 state rows, tallies, accumulator and the control state, bit for bit."""
    assert torch.equal(got_st.f, ref_st.f) and torch.equal(got_st.i, ref_st.i)
    assert torch.equal(got.columns, ref.columns) and torch.equal(got.vol, ref.vol)
    assert (got.acc is None) == (ref.acc is None)
    if ref.acc is not None:
        assert torch.equal(got.acc, ref.acc)
    assert torch.equal(got.ctl, ref.ctl)
    assert torch.equal(got.dead[slot], ref.dead[slot])


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_the_unfused_sequence(case):
    spec, pro, st, buf, key, kb = midflight(case, DIRECTIONAL)
    launched = int(buf.ctl[kb & 1])
    kinds = set(st.i[PK].unique().tolist())
    assert {1, 2} <= kinds and ((3 in kinds) == pro.deaths)
    assert spec.gas == (case == "gas") and spec.col == (case == "column")
    assert pro.vol_tally == (case in ("absorbing_volume", "column"))
    old_st, old_buf = st.clone(), buf.clone()
    old_launched = old_block(spec, pro, old_st, old_buf, launched, key, DIRECTIONAL, kb)
    fused_block(spec, pro, st, buf, key, DIRECTIONAL, kb)
    assert torch.equal(st.f, old_st.f) and torch.equal(st.i, old_st.i)
    assert torch.equal(buf.columns, old_buf.columns) and torch.equal(buf.vol, old_buf.vol)
    assert float(buf.columns.sum()) > 0 and (not pro.vol_tally or float(buf.vol.sum()) > 0)
    if case == "detectors":
        assert torch.equal(buf.acc, old_buf.acc) and float(buf.acc.sum()) > 0
    # The budget ran out inside the block: all of it launched, not every
    # dead lane refilled.
    assert int(buf.ctl[(kb + 1) & 1]) == old_launched == pro.n_photons
    assert int(buf.ctl[DONE]) == -1


@pytest.mark.parametrize("kind", sorted(SOURCES))
def test_reference_equals_the_unfused_sequence_for_each_source(kind):
    source = SOURCES[kind]
    spec, pro, st, buf, key, kb = midflight("flux", source)
    old_st, old_buf = st.clone(), buf.clone()
    old_launched = old_block(spec, pro, old_st, old_buf, int(buf.ctl[kb & 1]), key, source, kb)
    fused_block(spec, pro, st, buf, key, source, kb)
    assert torch.equal(st.f, old_st.f) and torch.equal(st.i, old_st.i)
    assert torch.equal(buf.columns, old_buf.columns)
    assert int(buf.ctl[(kb + 1) & 1]) == old_launched


def test_fifo_rule_matches_the_jax_rule():
    """Dead lane l takes photon launched + (dead lanes below l) while that id
    is below the budget (fastpath.py:2023-2026, :2044-2045), reconstructed in
    numpy; a lane that takes starts at the source's sample with tau 0 and
    orders 0, every other lane keeps its rows."""
    spec, pro, st, buf, key, kb = midflight("gas", DIRECTIONAL)
    launched = int(buf.ctl[kb & 1])
    alive = st.i[ALIVE].numpy() != 0
    dead_i = (~alive).astype(np.int64)
    new_id = launched + np.cumsum(dead_i) - dead_i
    take = ~alive & (new_id < pro.n_photons)
    assert 0 < take.sum() < dead_i.sum()
    assert np.array_equal(np.sort(new_id[take]), np.arange(launched, pro.n_photons))
    got = st.clone()
    new_launched = refill(spec, pro, got, buf.ctl[kb & 1].clone(), key, DIRECTIONAL, kb)
    assert int(new_launched) == launched + int(take.sum()) == pro.n_photons
    assert np.array_equal(got.i[ALIVE].numpy() != 0, alive | take)
    t = torch.from_numpy(take)
    assert torch.equal(got.f[:, ~t], st.f[:, ~t]) and torch.equal(got.i[:, ~t], st.i[:, ~t])
    fresh = DIRECTIONAL.sample(key, L, "cpu", stream=STREAM_REFILL, block=kb)
    assert torch.equal(got.f[X][t], (pro.x0 + fresh.x * (pro.x_max - pro.x0))[t])
    assert torch.equal(got.f[UZ][t], fresh.mu[t])
    assert torch.equal(got.f[TGAS][t], gas_thresholds(key, kb, L, "cpu")[t])
    assert float(got.f[TAU][t].abs().max()) == 0.0 and int(got.i[ORDERS][t].abs().max()) == 0
    # The whole block leaves the same count for the next one.
    fused_block(spec, pro, st, buf, key, DIRECTIONAL, kb)
    assert int(buf.ctl[(kb + 1) & 1]) == int(new_launched)


def test_loop_end_is_recorded_by_the_block():
    """DONE is the first block at whose entry no lane is alive and the budget
    is spent; later blocks leave it, and the tallies, alone."""
    integ = Integrator.create(make_step_cloud(1.0), config=CFG, device="cpu")
    spec = event_spec(integ.geometry, integ._fast_plan, CFG)
    n = 3 * L
    pro = prologue_spec(integ.geometry, spec, CFG, n)
    key = batch_key(2, 1)
    st = launch_state(integ.geometry, DIRECTIONAL.sample(key, L, "cpu"), n)
    buf = block_buffers(spec, pro, st, L)
    ends = []
    for kb in range(200):
        ends.append(not bool(st.i[ALIVE].any()) and int(buf.ctl[kb & 1]) >= n)
        fused_block(spec, pro, st, buf, key, DIRECTIONAL, kb)
        if ends[-1] and len(ends) - ends.index(True) > 3:
            break
    first = ends.index(True)
    assert first > 3 and int(buf.ctl[DONE]) == first
    assert float(buf.columns.sum()) == n and int(st.i[PK].abs().max()) == 0


BEYOND = 96
TRACES = {
    "flux": ("flux", 1 << 13, CFG),
    "gas": ("gas", 1 << 12, CFG),
    "detectors": ("detectors", 1 << 12, IWABUCHI),
    # 6 blocks at most: the trace ends at the block cap with lanes in flight.
    "block_cap": ("flux", 1 << 12, replace(CFG, max_events=4)),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_loop_check_every_n_blocks_changes_no_tally(name, monkeypatch):
    case, n, cfg = TRACES[name]
    make, _, kw = CASES[case]
    integ = Integrator.create(make(), config=cfg, device="cpu", **kw)
    tracer = integ.batch_tracer(n, 1 << 10)
    key = batch_key(31, 0)
    batch = DIRECTIONAL.sample(key, 1 << 10, "cpu")
    raws = {}
    for every in (1, 4, BEYOND):
        monkeypatch.setattr(fastpath, "CHECK_EVERY", every)
        raws[every] = tracer(key, batch, DIRECTIONAL)
    ref = raws[1]
    # BEYOND is more blocks than the trace has: its one check is the first.
    assert 4 * 8 < ref.n_iterations < BEYOND * 8 or name == "block_cap"
    assert (int(ref.n_bad) > 0) == (name == "block_cap")
    for every in (4, BEYOND):
        for field in ref.__dataclass_fields__:
            a, b = getattr(raws[every], field), getattr(ref, field)
            same = torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b
            assert same, (every, field, a, b)


def test_step_cloud_slice_matches_jax():
    """Port vs the JAX XLA fastpath on the step cloud, 4 sigma as in
    tests/test_torch_integrator.py (the JAX side at K = 1 for its compile
    time; K sets when deaths are tallied, not what is tallied)."""
    import jax
    from i3rc_tpu.core.illumination import PhotonSource as JaxSource
    from i3rc_tpu.integrators.config import IntegratorConfig as JaxConfig
    from i3rc_tpu.integrators.integrator import Integrator as JaxIntegrator
    from i3rc_tpu.models.step_cloud import make_step_cloud as jax_step_cloud

    n, lanes = 1 << 14, 1 << 12
    jcfg = JaxConfig(use_ray_tracing=False, max_events=500, compute_volume_absorption=False,
                     fastpath_unroll=1)
    jres = JaxIntegrator.create(jax_step_cloud(1.0), config=jcfg).batch_fn(
        JaxSource.directional(0.5, 0.0), n, n_lanes=lanes)(jax.random.PRNGKey(9))
    tres = Integrator.create(make_step_cloud(1.0), config=CFG, device="cpu").batch_fn(
        DIRECTIONAL, n, n_lanes=lanes)(batch_key(9, 0))
    sigma = float(np.sqrt(2 * 0.58 * 0.42 / n))
    assert float(tres.mean_flux_up) == pytest.approx(float(jres.mean_flux_up), abs=4 * sigma)
    assert float(tres.mean_flux_up + tres.mean_flux_down) == pytest.approx(1.0, abs=1e-5)
    assert int(tres.n_bad) == 0


# ---------------------------------------------------------------------------
# The planner and the card accept the same plans.

PLANS = {
    "flux": ("flux", {}, {}),
    "flux_K4": ("flux", dict(fastpath_unroll=4), {}),
    "flux_K32_chain3": ("flux", dict(fastpath_unroll=32, fastpath_chain=3), {}),
    "flux_chain0": ("flux", dict(fastpath_chain=0), {}),
    "gas_K5": ("gas", dict(fastpath_unroll=5), {}),
    "column_K7_chain1": ("column", dict(fastpath_unroll=7, fastpath_chain=1), {}),
    "detectors_9": ("detectors", {}, wide_detectors(9)),
    "detectors_16_K3": ("detectors", dict(fastpath_unroll=3), wide_detectors(16)),
    # Past the templated depths: the runtime-depth variant on the card.
    "flux_chain5": ("flux", dict(fastpath_chain=5), {}),
    "gas_chain4": ("gas", dict(fastpath_chain=4), {}),
    "column_K7_chain6": ("column", dict(fastpath_unroll=7, fastpath_chain=6), {}),
}


def planned(name: str, device="cpu"):
    case, cfg_kw, det = PLANS[name]
    make, cfg, kw = CASES[case]
    cfg = replace(cfg, **cfg_kw)
    return Integrator.create(make(), config=cfg, device=device, **{**kw, **det}), cfg


@pytest.mark.parametrize("name", sorted(PLANS))
def test_every_plan_is_one_the_kernel_launches(name):
    integ, cfg = planned(name)
    plan = integ._fast_plan
    assert plan is not None
    spec = event_spec(integ.geometry, plan, cfg)
    assert launch_refusal(spec) is None
    assert spec.K == (cfg.fastpath_unroll or (32 if spec.col else 8))
    # The plain version runs it too.
    res = integ.batch_fn(DIRECTIONAL, 1 << 9, n_lanes=1 << 8)(batch_key(1, 0))
    total = res.mean_flux_up + res.mean_flux_down + res.mean_flux_absorbed
    assert float(total) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("cfg_kw,det", [({}, wide_detectors(17)),
                                        (dict(fastpath_chain=4), {})])
def test_plans_past_the_kernels_reach_are_refused_at_the_plan(cfg_kw, det):
    """The plans the event block once refused now run: chain depth 4 plans
    on the fastpath (the runtime-depth variant on the card), and 17
    detectors get no fastpath plan, so the general kernel's estimate stage
    runs them (JAX's XLA fastpath does, fastpath.py:1702-1712)."""
    integ = Integrator.create(make_step_cloud(1.0), config=replace(CFG, **cfg_kw),
                              device="cpu", **det)
    plan = integ._fast_plan
    if det:
        assert plan is None
    else:
        assert plan is not None and launch_refusal(event_spec(integ.geometry, plan, integ.config)
                                                   ) is None
    res = integ.batch_fn(DIRECTIONAL, 1 << 9, n_lanes=1 << 8)(batch_key(1, 0))
    assert float(res.mean_flux_up + res.mean_flux_down) == pytest.approx(1.0, abs=1e-5)
    if det:
        assert res.intensity.shape[-1] == 17 and bool(torch.isfinite(res.intensity).all())


def test_launch_refusal_names_what_it_refuses():
    integ = Integrator.create(make_step_cloud(1.0), config=CFG, device="cpu")
    spec = event_spec(integ.geometry, integ._fast_plan, CFG)
    assert launch_refusal(spec) is None
    assert launch_refusal(replace(spec, chain=4)) is None
    assert launch_refusal(replace(spec, chain=9)) is None
    assert "depth >= 0" in launch_refusal(replace(spec, chain=-1))
    assert "K >= 1" in launch_refusal(replace(spec, K=0))
    dinteg = Integrator.create(make_step_cloud(1.0), config=CFG, device="cpu", **DET3)
    dspec = event_spec(dinteg.geometry, dinteg._fast_plan, CFG)
    assert "chain depth 0" in launch_refusal(replace(dspec, chain=1))
    wide = replace(dspec.det, dirs=dspec.det.dirs * 6)
    assert "holds 16 detectors" in launch_refusal(replace(dspec, det=wide))


# ---------------------------------------------------------------------------
# On the card

def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_kernel_matches_reference_on_gpu(case):
    dev = need_card()
    spec, pro, st, buf, key, kb = midflight(case, DIRECTIONAL, dev, lanes=(1 << 14) + 77)
    ref_st, ref = st.clone(), buf.clone()
    fused_block_reference(spec, pro, ref_st, ref, key, DIRECTIONAL, kb)
    fused_block(spec, pro, st, buf, key, DIRECTIONAL, kb)
    if ref.acc is not None:
        # The order of the accumulator's float64 sum differs.
        assert float((buf.acc - ref.acc).abs().max() / ref.acc.abs().max()) <= 1e-9
        buf.acc.copy_(ref.acc)
    assert_same_block(st, buf, ref_st, ref, (kb + 1) & 1)


# Reflecting surfaces: the block ends with the surface stage (a second
# kernel of the same call on the card).  name -> (domain, config, keywords).
SURFACED = {
    "albedo_flux": (lambda: make_step_cloud(0.99), replace(CFG, compute_volume_absorption=True),
                    dict(surface_albedo=0.3)),
    "albedo_detectors": (lambda: make_step_cloud(1.0), IWABUCHI,
                         dict(surface_albedo=0.3, **DET3)),
    "albedo_gas": (lambda: domain_with_gas_component(make_step_cloud(0.99), GAS), CFG,
                   dict(surface_albedo=0.2)),
    "albedo_column": (lambda: column_scene(1.0), CFG, dict(surface_albedo=0.2)),
    "cox_munk_flux": (lambda: make_step_cloud(1.0), CFG,
                      dict(surface=SurfaceDescription.uniform([8.0, 1.34], "cox_munk"))),
    "rpv_detectors": (lambda: make_step_cloud(1.0), CFG,
                      dict(surface=SurfaceDescription.uniform([0.2, 0.8, -0.1], "rpv"),
                           intensity_mus=[0.5, -0.5], intensity_phis=[40.0, 0.0])),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SURFACED))
def test_surfaced_block_matches_reference_on_gpu(name):
    """The whole block over a reflecting surface, kernel against plain
    version, two blocks into a trace: every state row (and the lane weight),
    the control state and dead counts bit for bit; the flux tallies bit for
    bit over an albedo (unit counts), within 1e-6 relative under a BRDF
    (weights summed in another order; chip_smoke.py phase 4d states the rule
    for a BRDF's libdevice rounding); the accumulators within 1e-9."""
    dev = need_card()
    make, cfg, kw = SURFACED[name]
    integ = Integrator.create(make(), config=cfg, device=dev, **kw)
    spec = event_spec(integ.geometry, integ._fast_plan, cfg)
    key = batch_key(17, 4)
    lanes = (1 << 14) + 77
    st = launch_state(integ.geometry, DIRECTIONAL.sample(key, lanes, dev), lanes,
                      gas_key=key if spec.gas else None, weighted=spec.weighted)
    pro = prologue_spec(integ.geometry, spec, cfg, 4 * lanes)
    buf = block_buffers(spec, pro, st, lanes)
    for kb in range(2):
        fused_block_reference(spec, pro, st, buf, key, DIRECTIONAL, kb)
    ref_st, ref = st.clone(), buf.clone()
    fused_block_reference(spec, pro, ref_st, ref, key, DIRECTIONAL, 2)
    fused_block(spec, pro, st, buf, key, DIRECTIONAL, 2)
    for a, b in ((buf.acc, ref.acc), (buf.srf, ref.srf)):
        if b is not None:
            assert float((a - b).abs().max() / b.abs().max().clamp(min=1e-300)) <= 1e-9
    if spec.weighted:
        assert float((buf.columns - ref.columns).abs().max() / ref.columns.abs().max()) <= 1e-6
        buf.columns.copy_(ref.columns)
        assert torch.equal(st.w, ref_st.w)
    for t in (buf.acc, buf.srf):
        if t is not None:
            t.copy_(ref.acc if t is buf.acc else ref.srf)
    assert_same_block(st, buf, ref_st, ref, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(SOURCES))
def test_fused_kernel_matches_reference_for_each_source_on_gpu(kind):
    dev = need_card()
    source = SOURCES[kind]
    spec, pro, st, buf, key, kb = midflight("flux", source, dev, lanes=1 << 14)
    ref_st, ref = st.clone(), buf.clone()
    fused_block_reference(spec, pro, ref_st, ref, key, source, kb)
    fused_block(spec, pro, st, buf, key, source, kb)
    assert_same_block(st, buf, ref_st, ref, (kb + 1) & 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["detectors_9", "detectors_16_K3", "flux_K4",
                                  "flux_K32_chain3", "gas_K5", "column_K7_chain1",
                                  "flux_chain5", "gas_chain4", "column_K7_chain6"])
def test_plans_the_card_used_to_refuse_match_the_twin_on_gpu(name):
    dev = need_card()
    integ, cfg = planned(name, dev)
    spec = event_spec(integ.geometry, integ._fast_plan, cfg)
    key = batch_key(5, 6)
    lanes = 1 << 14
    st = launch_state(integ.geometry, DIRECTIONAL.sample(key, lanes, dev), lanes,
                      gas_key=key if spec.gas else None)
    new_acc = lambda: (torch.zeros((spec.det.n_cols, spec.det.n), dtype=torch.float64,
                                   device=dev) if spec.det is not None else None)
    ref, acc_k, acc_t = st.clone(), new_acc(), new_acc()
    for kb in range(2):
        event_block(spec, st, key, kb, acc_k)
        event_block_reference(spec, ref, philox_uniforms(key, kb, spec.K, spec.n_draws,
                                                         lanes, dev), acc_t)
    assert torch.equal(st.f, ref.f) and torch.equal(st.i, ref.i)
    if acc_t is not None:
        assert float(acc_t.sum()) > 0.0
        assert float((acc_k - acc_t).abs().max() / acc_t.abs().max()) <= 1e-9
