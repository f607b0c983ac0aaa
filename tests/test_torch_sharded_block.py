"""The sharded tracer's whole block on the CPU: the plain version of SD's
launch (``kernels/sharded_block.py`` ``block_prologue_reference``, the K
events, ``block_epilogue_reference``) and of SB's pack (``shadow_pack_reference``)
held against the rules a block keeps, on a world of one:

  * the FIFO refill takes the free lanes in lane order after the placed
    arrivals and leaves ``RESERVE`` of them free;
  * the send buffers hold the first CAP tagged photons (and rays) of each
    direction, in lane (slot) order, +1 in the first and -1 in the second;
  * the arriving rows of a direction are the inbox's waiting rows, then the
    received ones: they take the free lanes (slots) in order, +1 before -1,
    and the rest wait, in order, in the next parity's inbox;
  * the counts vector after SD (its photon side) and after SB's pack (its
    ray side) equals the counts recomputed from the state and the pool, and
    the pack's free slots and sent slots are the pool's, in slot order;
  * a whole trace on one rank gives the tallies that
    ``tests/test_torch_sharded_domain.py`` expects against JAX, within 4
    combined binomial standard errors, and conserves photons exactly.
"""

import numpy as np
import pytest
import torch

import sharded_reference as ref
import sharded_scenes as ss
from i3rc_tpu_torch import PhotonSource
from i3rc_tpu_torch.core.rng import STREAM_REFILL
from i3rc_tpu_torch.integrators.wavefront import f32, make_direction_cosines
from i3rc_tpu_torch.kernels import sharded_block as sb
from i3rc_tpu_torch.parallel.mesh import default_mesh
from i3rc_tpu_torch.parallel.sharded_domain import ShardedTrace

LANES = 512


def trace(name: str, photons: int = 1 << 12, lanes: int = LANES, seed: int = 5) -> ShardedTrace:
    sc = ss.scene(name, ss.host("i3rc_tpu_torch"), 1)
    return ShardedTrace.create(sc["domain"], PhotonSource.directional(*sc["src"]), photons,
                               default_mesh(device="cpu"), n_lanes_per_shard=lanes, seed=seed,
                               **sc["kw"])


def advance(tr: ShardedTrace, blocks: int) -> ShardedTrace:
    """``blocks`` blocks, then the next block's plan."""
    for _ in range(blocks):
        assert tr.running()
        tr.block()
    assert tr.running()
    return tr


def counts_of(tr: ShardedTrace, plan: sb.BlockPlan) -> list:
    """This rank's counts recomputed from the state, the pool and the plan
    of the block that made them."""
    i, qi = tr.state.i, tr.pool.i
    busy = (i[sb.ALIVE] != 0) | (i[sb.TAG] != 0) | (i[sb.PEND] != 0)
    row = [0] * sb.N_COUNTS
    row[sb.WORK] = plan.work
    row[sb.BUSY_PH] = int(busy.sum())
    row[sb.SPACE_PH:sb.SPACE_PH + 2] = plan.space_ph
    row[sb.SPACE_Q:sb.SPACE_Q + 2] = plan.space_q
    row[sb.WAIT_PH] = int((i[sb.TAG] == 1).sum())
    row[sb.WAIT_PH + 1] = int((i[sb.TAG] == -1).sum())
    row[sb.FREE_PH] = int((~busy).sum())
    if tr.spec.n_dirs:
        row[sb.BUSY_Q] = int(((qi[sb.QALIVE] != 0) | (qi[sb.QTAG] != 0)).sum())
        row[sb.WAIT_Q] = int((qi[sb.QTAG] == 1).sum())
        row[sb.WAIT_Q + 1] = int((qi[sb.QTAG] == -1).sum())
        row[sb.FREE_Q] = int(((qi[sb.QALIVE] == 0) & (qi[sb.QTAG] == 0)).sum())
    return row


def assert_pack_lists(tr: ShardedTrace) -> None:
    """The pool's free slots in slot order at the head of ``free_q``, and
    the first CAP slots tagged each way in slot order in ``tag_q``."""
    qi, bufs = tr.pool.i, tr.bufs
    free = ((qi[sb.QALIVE] == 0) & (qi[sb.QTAG] == 0)).nonzero()[:, 0].to(torch.int32)
    assert torch.equal(bufs.free_q[:free.numel()], free), tr.kb
    for k, dirn in enumerate(sb.DIRS):
        slots = (qi[sb.QTAG] == dirn).nonzero()[:, 0][:bufs.cap].to(torch.int32)
        assert torch.equal(bufs.tag_q[k, :slots.numel()], slots), tr.kb


def test_refill_takes_free_lanes_in_lane_order_keeping_the_reserve():
    tr = trace("landsat")
    assert tr.running()
    plan = tr._plan
    # The first block: every lane free, RESERVE of them kept for immigrants.
    assert plan.n_new == LANES - tr.RESERVE and sum(plan.placed_ph) == 0
    tr.block()
    advance(tr, 3)
    plan = tr._plan
    kb = tr.kb
    st, pool, bufs = tr.state.clone(), tr.pool.clone(), tr.bufs.clone()
    i0 = st.i.clone()
    for k, dirn in enumerate(sb.DIRS):
        i0[sb.TAG, (i0[sb.TAG] == dirn).nonzero()[:, 0][:plan.sent_ph[k]]] = 0
    free = ((i0[sb.ALIVE] == 0) & (i0[sb.TAG] == 0) & (i0[sb.PEND] == 0)).nonzero()[:, 0]
    sb.block_prologue_reference(tr.spec, st, pool, bufs, plan, tr.key, kb, tr.source)
    placed = sum(plan.placed_ph)
    fresh = free[placed:placed + plan.n_new]
    assert plan.n_new > 0 and fresh.numel() == plan.n_new
    # The fresh lanes: the source sample at (lane, kb, STREAM_REFILL), tau 0,
    # orders 0, alive; the free lanes after them stay free.
    b = tr.source.sample(tr.key, fresh.numel(), "cpu", stream=STREAM_REFILL, block=kb,
                         lanes=fresh)
    s = tr.spec
    assert torch.equal(st.f[sb.X, fresh], s.x_lo + b.x * f32(s.x_hi - s.x_lo))
    assert torch.equal(st.f[sb.Y, fresh], s.y0 + b.y * s.wy)
    ux, uy, uz = make_direction_cosines(b.mu, b.phi)
    assert torch.equal(st.f[sb.UZ, fresh], uz) and torch.equal(st.f[sb.UX, fresh], ux)
    assert bool((st.f[sb.TAU, fresh] == 0).all() and (st.i[sb.ORDERS, fresh] == 0).all())
    assert bool((st.i[sb.ALIVE, free[:placed + plan.n_new]] == 1).all())
    rest = free[placed + plan.n_new:]
    assert bool((st.i[sb.ALIVE, rest] == 0).all())
    assert rest.numel() >= tr.RESERVE or tr.launched == tr.budget
    untouched = torch.ones(LANES, dtype=torch.bool)
    untouched[free[:placed + plan.n_new]] = False
    assert torch.equal(st.f[:, untouched], tr.state.f[:, untouched])


def test_send_buffers_hold_the_first_cap_tagged_rows_in_lane_order():
    tr = advance(trace("detectors"), 3)
    kb, cap = tr.kb, tr.bufs.cap
    st, pool, bufs = tr.state.clone(), tr.pool.clone(), tr.bufs.clone()
    # More migrants of each direction than the buffers hold: lanes out of
    # flight, tagged at random.
    g = torch.Generator().manual_seed(3)
    pick = torch.rand(LANES, generator=g)
    tag = torch.where(pick < 0.35, 1, torch.where(pick < 0.7, -1, 0)).to(torch.int32)
    out = tag != 0
    st.i[sb.TAG] = tag
    st.i[sb.ALIVE, out], st.i[sb.PEND, out], st.i[sb.PK, out] = 0, 0, 0
    plan = sb.BlockPlan()
    sb.block_epilogue_reference(tr.spec, st, pool, bufs, plan, tr.key, kb, 0.0)
    npar = (kb + 1) & 1
    row = bufs.counts[0].tolist()
    for k, dirn in enumerate(sb.DIRS):
        lanes = (tag == dirn).nonzero()[:, 0]
        assert lanes.numel() > cap and row[sb.WAIT_PH + k] == lanes.numel()
        want = torch.cat([st.f[:sb.TAU + 1, lanes[:cap]],
                          st.i[sb.ORDERS, lanes[:cap]][None].float()]).t()
        assert torch.equal(bufs.send_ph[npar, k], want)
    # The rays: SB's pack takes the first CAP tagged slots of each direction.
    qtag = torch.where(pick < 0.3, 1, torch.where(pick > 0.65, -1, 0)).to(torch.int32)
    pool.i[sb.QTAG] = qtag
    sb.shadow_pack_reference(tr.spec, pool, bufs)
    row = bufs.counts[0].tolist()
    for k, dirn in enumerate(sb.DIRS):
        slots = (qtag == dirn).nonzero()[:, 0]
        assert slots.numel() > cap and row[sb.WAIT_Q + k] == slots.numel()
        assert torch.equal(bufs.tag_q[k], slots[:cap].to(torch.int32))
        want = torch.cat([pool.f[:, slots[:cap]], pool.i[sb.QDET, slots[:cap]][None].float()]).t()
        assert torch.equal(bufs.send_q[k], want)
    free = ((pool.i[sb.QALIVE] == 0) & (qtag == 0)).nonzero()[:, 0]
    assert row[sb.FREE_Q] == free.numel()
    assert torch.equal(bufs.free_q[:free.numel()], free.to(torch.int32))


def test_arrivals_follow_the_inbox_rows():
    tr = advance(trace("detectors"), 3)
    kb = tr.kb
    par, npar = kb & 1, (kb + 1) & 1
    st, pool, bufs = tr.state.clone(), tr.pool.clone(), tr.bufs.clone()
    bufs.self_exchange = False
    g = torch.Generator().manual_seed(4)
    rows = lambda n, w: torch.rand(n, w, generator=g) + torch.arange(n)[:, None]
    # Per direction: 3 (photons) or 2 (rays) rows waiting, 4 received; the
    # +1 rows all placed but the last two, then as many -1 rows as fit.
    box_ph = [rows(3, sb.PHOTON_FIELDS), rows(3, sb.PHOTON_FIELDS)]
    rx_ph = [rows(4, sb.PHOTON_FIELDS), rows(4, sb.PHOTON_FIELDS)]
    box_q = [rows(2, sb.RAY_FIELDS), rows(2, sb.RAY_FIELDS)]
    rx_q = [rows(4, sb.RAY_FIELDS), rows(4, sb.RAY_FIELDS)]
    for k in range(2):
        for r in (box_ph[k], rx_ph[k]):
            r[:, sb.TAU + 1] = torch.arange(r.shape[0]).float()
        for r in (box_q[k], rx_q[k]):
            r[:, 5] = torch.arange(r.shape[0]).float()
        bufs.inbox_ph[par, k, :3], bufs.recv_ph[k, :4] = box_ph[k], rx_ph[k]
        bufs.inbox_q[par, k, :2], bufs.recv_q[k, :4] = box_q[k], rx_q[k]
    free = ((st.i[sb.ALIVE] == 0) & (st.i[sb.TAG] == 0) & (st.i[sb.PEND] == 0)).nonzero()[:, 0]
    n_free_q = tr._counts()[0][sb.FREE_Q]
    assert free.numel() >= 10 and n_free_q >= 8
    plan = sb.BlockPlan(n_in_ph=(3, 3), n_rx_ph=(4, 4), placed_ph=(5, 4), n_in_q=(2, 2),
                        n_rx_q=(4, 4), placed_q=(4, 3))
    sb.block_prologue_reference(tr.spec, st, pool, bufs, plan, tr.key, kb, tr.source)
    seq_ph = [torch.cat([box_ph[k], rx_ph[k]]) for k in range(2)]
    got = torch.cat([st.f[:sb.TAU + 1, free[:9]], st.i[sb.ORDERS, free[:9]][None].float()]).t()
    assert torch.equal(got, torch.cat([seq_ph[0][:5], seq_ph[1][:4]]))
    assert bool((st.i[sb.ALIVE, free[:9]] == 1).all())
    assert torch.equal(bufs.inbox_ph[npar, 0, :2], seq_ph[0][5:])
    assert torch.equal(bufs.inbox_ph[npar, 1, :3], seq_ph[1][4:])
    seq_q = [torch.cat([box_q[k], rx_q[k]]) for k in range(2)]
    slots = bufs.free_q[:7].long()
    got = torch.cat([pool.f[:, slots], pool.i[sb.QDET, slots][None].float()]).t()
    assert torch.equal(got, torch.cat([seq_q[0][:4], seq_q[1][:3]]))
    assert bool((pool.i[sb.QALIVE, slots] == 1).all())
    assert torch.equal(bufs.inbox_q[npar, 0, :2], seq_q[0][4:])
    assert torch.equal(bufs.inbox_q[npar, 1, :3], seq_q[1][3:])


@pytest.mark.parametrize("name", ["detectors", "graft"])
def test_counts_equal_the_state(name):
    tr = trace(name, photons=1 << 11)
    n_checked = 0
    running = tr.running()
    while running:
        plan = tr._plan
        tr.block()
        assert tr.bufs.counts[0].tolist() == counts_of(tr, plan), tr.kb
        assert_pack_lists(tr)
        n_checked += 1
        running = tr.running()
    assert n_checked > 8


def test_trace_against_jax_and_conserved():
    """The reflecting random field on one rank against JAX's trace on a
    mesh of 4 CPU devices (tests/test_torch_sharded_scenes.py's gate); the
    absorbing Landsat scene conserves its photons."""
    tr = trace("reflecting", photons=ref.PHOTONS, lanes=ref.LANES, seed=21)
    while tr.running():
        tr.block()
    got = ref.fluxes(ss.summary(tr.finish()))
    jx = ref.fluxes(ref.jax_trace("reflecting"))
    for k in ("fup", "fdn", "fabs"):
        assert abs(got[k] - jx[k]) < 4 * ref.flux_sigma(jx[k], ref.PHOTONS, ref.PHOTONS), (
            k, got, jx)
    tr = trace("landsat", photons=1 << 12, lanes=1 << 10)
    while tr.running():
        tr.block()
    s = ss.summary(tr.finish())
    total = s["flux_up"].sum() + s["flux_down"].sum() + s["flux_absorbed"].sum()
    assert total + s["n_bad"] == s["n_photons"] == 1 << 12
    assert s["migrations"] > 0 and np.all(np.isfinite(s["flux_up"]))
