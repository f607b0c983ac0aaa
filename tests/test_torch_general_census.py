"""The general event block's lane order and its warp census, on the CPU.

The CUDA kernel (csrc/general_event_block.cuh) runs each CTA's live lanes
packed onto its first threads, grouped by a key of the lane's expected DDA
length; ``kernels/general_block.py`` holds the plain version of that order
(``lane_keys``, ``lane_order``) and the census that scores an order against
the per-event DDA steps the twin records (``warp_census``,
``census_orders``).  Tested here:

  * ``warp_census`` on hand-made step tables of known efficiency;
  * ``lane_order``: a permutation within each CTA, live lanes first, keys
    non-decreasing, stable within a bucket, idle slots last;
  * ``lane_keys`` against the cell's extinction or the block's majorant;
  * the twin's recording hook changes nothing it records.
"""

import numpy as np
import pytest
import torch

from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, batch_key,
                            make_step_cloud)
from i3rc_tpu_torch.kernels import general_block as gb

torch.set_num_threads(2)
SRC = PhotonSource.directional(0.5, 0.0)
CTA = gb.CTA_THREADS
MODES = {"rt": dict(use_ray_tracing=True),
         "maxcs": dict(use_ray_tracing=False),
         "woodcock": dict(use_ray_tracing=False, majorant_block_size=4)}


def table(rows):
    """(K, L) int32 steps and bool alive from per-event lists (None: dead)."""
    steps = torch.tensor([[0 if v is None else v for v in r] for r in rows], dtype=torch.int32)
    alive = torch.tensor([[v is not None for v in r] for r in rows])
    return steps, alive


def test_one_slow_lane_in_a_warp():
    steps, alive = table([[20] + [1] * 31])
    c = gb.warp_census(steps, alive, gb.identity_order(32))
    assert c["trips"] == 1 and c["warp_steps"] == 20 and c["lane_steps"] == 51
    assert c["dda_efficiency"] == pytest.approx(51 / 640)
    assert c["event_efficiency"] == 1.0 and c["sparse_share"] == 0.0


def test_dead_lanes_idle_and_empty_warps_make_no_trip():
    """64 lanes, two events: warp 0 has 4 live lanes at event 0 and none at
    event 1; warp 1 has 32 live lanes at event 0 and 8 at event 1."""
    row0 = [3, None, 5, None, 2, 7] + [None] * 26 + [2] * 32
    row1 = [None] * 32 + [4] * 8 + [None] * 24
    steps, alive = table([row0, row1])
    c = gb.warp_census(steps, alive, gb.identity_order(64))
    assert c["trips"] == 3 and c["warp_steps"] == 7 + 2 + 4
    assert c["lane_steps"] == 17 + 64 + 32 and c["lane_events"] == 4 + 32 + 8
    assert c["dda_efficiency"] == pytest.approx(113 / (32 * 13))
    assert c["event_efficiency"] == pytest.approx(44 / 96)
    assert c["sparse_share"] == pytest.approx(2 / 3)


def test_an_order_moves_lanes_between_warps():
    """Two warps of one slow and 31 quick lanes each: an order that puts
    both slow lanes into one warp halves the DDA loop's trips over the
    second warp; a slot of -1 idles."""
    row = [9] + [1] * 31 + [9] + [1] * 31
    steps, alive = table([row])
    ident = gb.warp_census(steps, alive, gb.identity_order(64))
    order = torch.tensor([0, 32] + [k for k in range(64) if k not in (0, 32)])
    moved = gb.warp_census(steps, alive, order)
    assert ident["warp_steps"] == 18 and moved["warp_steps"] == 10
    assert moved["lane_steps"] == ident["lane_steps"] == 80
    idle = gb.warp_census(steps, alive, torch.where(order == 32, -1, order))
    assert idle["lane_steps"] == 71 and idle["lane_events"] == 63


@pytest.mark.parametrize("n_buckets,tiles", [(1, 1), (2, 1), (4, 1), (8, 1), (1, 3), (4, 2)])
def test_lane_order_packs_each_cta(n_buckets, tiles):
    rng = np.random.default_rng(n_buckets)
    L = 5 * CTA + 77
    alive = torch.as_tensor(rng.uniform(size=L) < rng.uniform(0.0, 1.0, L))
    alive[:CTA] = False                        # an empty tile
    alive[CTA:2 * CTA] = True                  # a full one
    bucket = torch.as_tensor(rng.integers(0, n_buckets, L), dtype=torch.int32)
    order = gb.lane_order(alive, bucket if n_buckets > 1 else None, n_buckets, tiles)
    span = tiles * CTA
    n_ctas = -(-L // span)
    assert order.shape == (n_ctas * span,)
    for c in range(n_ctas):
        slots = order[c * span:(c + 1) * span]
        lanes = torch.arange(c * span, min(L, (c + 1) * span))
        live = lanes[alive[lanes]]
        n = live.numel()
        # The live lanes of this CTA on its first n slots, the rest idle.
        assert sorted(slots[:n].tolist()) == live.tolist()
        assert bool((slots[n:] == -1).all())
        # Ordered by bucket, and by lane id within a bucket.
        keys = bucket[slots[:n]].long() * L + slots[:n]
        assert bool((keys[1:] > keys[:-1]).all())


def test_cta_tiles_gather_a_cta_of_live_lanes():
    """About CTA_THREADS live lanes a group of tiles: one tile while most
    lanes live, n_lanes // n_live in the drain, at most MAX_TILES."""
    L = 1 << 20
    assert [gb.cta_tiles(L, n) for n in (L, L // 2 + 1, L // 9, L // 100, 0)] == \
        [1, 1, 9, gb.MAX_TILES, gb.MAX_TILES]


def test_lane_order_without_keys_is_the_compaction():
    alive = torch.tensor([k % 3 == 0 for k in range(CTA + 40)])
    order = gb.lane_order(alive)
    assert order[:86].tolist() == list(range(0, CTA, 3))
    assert order[CTA:CTA + 13].tolist() == list(range(CTA + 2, CTA + 40, 3))
    assert bool((order[86:CTA] == -1).all()) and bool((order[CTA + 13:] == -1).all())


def block_inputs(mode: str, L: int = 1024, ssa: float = 0.99):
    cfg = IntegratorConfig(max_events=500, use_fastpath=False, **MODES[mode])
    integ = Integrator.create(make_step_cloud(ssa), cfg, surface_albedo=0.2, device="cpu")
    spec = integ.batch_tracer(4 * L, L).spec
    opt = integ.device_optics
    key = batch_key(11, 3)
    st = gb.launch_state(spec, SRC.sample(key, L, "cpu"), 4 * L)
    buf = gb.general_buffers(spec, st, L)
    return integ, spec, gb.variant(spec, opt), opt, key, st, buf


def test_lane_keys_read_the_extinction_and_the_majorant():
    """The step cloud's halves differ 9x in extinction: the thick half is
    bucket 0, the thin one -floor(log2(1/9)) = 4 (clipped to the last
    bucket); maximum cross-section has no key."""
    for mode in ("rt", "woodcock"):
        integ, spec, var, opt, key, st, buf = block_inputs(mode)
        x = st.f[gb.X]
        thin = x < 250.0
        for n in (4, 8):
            keys = gb.lane_keys(spec, opt, st, n)
            assert keys.dtype == torch.int32
            assert bool((keys[~thin] == 0).all()) and bool((keys[thin] == min(4, n - 1)).all())
        assert bool((gb.lane_keys(spec, opt, st, 1) == 0).all())
    integ, spec, var, opt, key, st, buf = block_inputs("maxcs")
    assert bool((gb.lane_keys(spec, opt, st) == 0).all())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_the_record_hook_changes_nothing(mode):
    """Two blocks with and without ``record``: state, tallies and control
    bit for bit; the recorded steps add up to the lanes' DDA counter."""
    integ, spec, var, opt, key, st, buf = block_inputs(mode, L=512)
    gb.general_block_reference(spec, var, opt, integ.tables, st, buf, key, SRC, 0)
    a_st, a_buf, b_st, b_buf = st.clone(), buf.clone(), st.clone(), buf.clone()
    gb.general_block_reference(spec, var, opt, integ.tables, a_st, a_buf, key, SRC, 1)
    rec = {}
    gb.general_block_reference(spec, var, opt, integ.tables, b_st, b_buf, key, SRC, 1,
                               record=rec)
    assert torch.equal(a_st.f, b_st.f) and torch.equal(a_st.i, b_st.i)
    for name in ("columns", "vol", "ctl", "dead"):
        assert torch.equal(getattr(a_buf, name), getattr(b_buf, name))
    K, L = spec.K, st.n_lanes
    assert rec["alive"].shape == (K, L) and rec["steps"].shape == (K, L)
    assert torch.equal(rec["steps"].sum(0), b_st.i[gb.XING] - st.i[gb.XING])
    # A lane-event counts unless its DDA ran out of budget (bad).
    events = rec["alive"].sum(0, dtype=torch.int32)
    evct, bad = (b_st.i[r] - st.i[r] for r in (gb.EVCT, gb.BAD))
    assert bool((evct <= events).all()) and bool((events <= evct + bad).all())
    assert torch.equal(rec["alive"][0], rec["entry"].i[gb.ALIVE] != 0)
    census = gb.census_orders(spec, opt, rec)
    assert set(census) == ({"identity", "compact"} if mode == "maxcs" else
                           {"identity", "compact", "grouped_2", "grouped_4", "grouped_8"})
    ident = census["identity"]
    for c in census.values():
        # Every order runs the same lane-events and steps, in no more trips.
        assert c["lane_steps"] == ident["lane_steps"]
        assert c["lane_events"] == ident["lane_events"]
        assert c["trips"] <= ident["trips"]
