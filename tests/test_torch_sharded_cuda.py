"""The sharded tracer's kernels on the card: the whole block (SD's launch,
then with detectors SB's) against its plain version
(``sharded_block_reference``, ``shadow_advance_reference``,
``shadow_pack_reference``), and SB alone against its plain version, at a
mid-flight and a tail state of a trace of each scene of
``tests/sharded_scenes.py`` on a world of one: the absorbing Landsat
scene (flux), the reflecting random field (surface), its volume
absorption, its three detectors over the
albedo, and the scene of ``__graft_entry__.py:127-156`` (two components, an
albedo, two detectors, the volume tally).  The lane state, the pool, the
send buffers, the free-slot list, the tiles' counts, the counts vector and
the flux tallies bit for bit; the radiance tallies within 1e-9 of their sum
(SB adds them in another order); SB's own count of its ray loop against the
plain version's census.  SB also past its shared histogram's bins (the
detector scene), on pools from one tile a CTA to past one wave of its CTAs
at the longest run (where each CTA traces its own run), with more tagged
rays than the send buffer holds, and over a pool with no ray in flight,
where it still packs.

The last test holds them on each rank of a gloo world of two that share
the card (each rank's half slab, whose faces at the middle of the domain
are interior).

Marked ``cuda``: skipped without a card; imports no JAX, so it runs on the
card's machine with ``--noconftest``.
"""

import sys
from pathlib import Path

import pytest
import torch

# Imported by name: the spawned ranks of the two-rank test unpickle its job
# from this module.
sys.path.insert(0, str(Path(__file__).resolve().parent))
import sharded_scenes as _scenes  # noqa: E402
CASES = {"flux": ("landsat", 1 << 18, 1 << 16), "surface": ("reflecting", 1 << 16, 1 << 14),
         "volume": ("volume", 1 << 16, 1 << 14), "detectors": ("detectors", 1 << 16, 1 << 14),
         "graft": ("graft", 1 << 16, 1 << 14)}


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_equal_their_twins(case):
    dev = need_card()
    from i3rc_tpu_torch.kernels import sharded_block as sb

    name, photons, lanes = CASES[case]
    sc = _scenes.scene(name, _scenes.host("i3rc_tpu_torch"), 2)
    st = _scenes.trace_states(sc, photons, lanes, dev)
    assert len(st["block"]) == 2, [kept[0] for kept in st["block"]]
    for r in _scenes.states_vs_twins(st):
        assert r["bit_equal"] and r.get("tally_ok", True), r
        if r["kernel"] == "SB":
            assert r["tally_abs_err"] <= 1e-9 * max(1.0, r["tally_sum"]), r
            assert (r["use"]["rays"], r["use"]["steps"]) == (r["rays"], r["steps"]), r
        else:
            assert r["lane_events"] > 0
    assert not st["spec"].n_dirs or len(st["sb"]) >= 1
    before = (sb.sharded_event_block.launches, sb.shadow_block.launches)
    _scenes.block_vs_twin(st["spec"], st["key"], st["source"], st["albedo"], st["block"][0])
    d = int(st["spec"].n_dirs > 0)
    assert (sb.sharded_event_block.launches, sb.shadow_block.launches) == (
        before[0] + 1, before[1] + d)


def _sb_ok(r: dict) -> None:
    assert r["bit_equal"] and r["tally_abs_err"] <= 1e-9 * max(1.0, r["tally_sum"]), r


# A captured pool's slots repeated these many times: from one tile a CTA to
# SB_MAX_TILES within one wave of the H100's CTAs, and a pool past one wave
# at any run length (2^22 slots), where each CTA traces its own run.
WIDEN = (1, 9, 25, 58, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["detectors", "graft"])
def test_shadow_block_histograms_and_runs(case):
    """The detector scene's 576 radiance bins pass the shared histogram's
    cap and go to device memory, the graft scene's 64 stay in shared
    memory; SB equals its plain version on pools from 64 tiles to past one
    wave of its CTAs at the longest run, so at the run lengths its launch
    picks from the pool's size, with its traced tiles spread over the pool
    (a cooperative launch) or each CTA tracing its own run's."""
    dev = need_card()
    from i3rc_tpu_torch.kernels import sharded_block as sb

    name, photons, lanes = CASES[case]
    st = _scenes.trace_states(_scenes.scene(name, _scenes.host("i3rc_tpu_torch"), 2), photons,
                              lanes, dev)
    kb, pool0, bufs0 = st["sb"][0]
    lengths = []
    for m in WIDEN:
        pool, bufs = _scenes.widened(pool0, bufs0, m)
        n_tiles = -(-pool.n_rays // sb.CTA_THREADS)
        r = _scenes.sb_vs_twin(st["spec"], pool, bufs)
        _sb_ok(r)
        assert (r["n_bins"] > sb.SHADOW_SMEM_BINS) == (case == "detectors"), r
        assert (r["use"]["rays"], r["use"]["steps"]) == (r["rays"], r["steps"]), r
        T = -(-n_tiles // r["use"]["runs"])
        assert 1 <= T <= sb.SHADOW_MAX_TILES and r["use"]["runs"] == -(-n_tiles // T), r
        lengths.append(T)
    props = torch.cuda.get_device_properties(dev)
    assert sb.CTA_THREADS * sb.SHADOW_MAX_TILES * props.multi_processor_count * 8 < (
        WIDEN[-1] * pool0.n_rays), "the largest pool must pass a wave at the longest run"
    assert lengths == sorted(lengths) and lengths[-1] == sb.SHADOW_MAX_TILES, lengths
    assert len(set(lengths)) >= 3, lengths


@pytest.mark.cuda
def test_shadow_block_packs_past_cap_and_an_idle_pool():
    """More tagged rays of each direction than the send buffer holds, and a
    pool with no ray in flight (every slot free, then every busy slot
    tagged): SB still packs, as its plain version does."""
    dev = need_card()
    from i3rc_tpu_torch.kernels import sharded_block as sb

    name, photons, lanes = CASES["graft"]
    st = _scenes.trace_states(_scenes.scene(name, _scenes.host("i3rc_tpu_torch"), 2), photons,
                              lanes, dev)
    spec = st["spec"]
    kb, pool0, bufs0 = st["sb"][0]
    g = torch.Generator(device=dev).manual_seed(3)
    pick = torch.rand(pool0.n_rays, generator=g, device=dev)
    crowded = pool0.clone()
    tag = torch.where(pick < 0.3, 1, torch.where(pick > 0.65, -1, 0)).to(torch.int32)
    crowded.i[sb.QTAG] = tag
    crowded.i[sb.QALIVE] = torch.where(tag != 0, 1, crowded.i[sb.QALIVE])
    r = _scenes.sb_vs_twin(spec, crowded, bufs0)
    _sb_ok(r)
    for dirn in sb.DIRS:
        assert int((tag == dirn).sum()) > bufs0.cap
    idle = pool0.clone()
    idle.i[sb.QALIVE] = 0
    idle.i[sb.QTAG] = 0
    r = _scenes.sb_vs_twin(spec, idle, bufs0)
    _sb_ok(r)
    assert r["rays"] == 0 and r["use"]["rays"] == 0
    parked = pool0.clone()
    parked.i[sb.QTAG] = torch.where(parked.i[sb.QALIVE] != 0, 1, 0).to(torch.int32)
    r = _scenes.sb_vs_twin(spec, parked, bufs0)
    _sb_ok(r)
    assert r["rays"] == 0 and r["steps"] == 0


@pytest.mark.cuda
def test_kernels_equal_their_twins_on_two_ranks():
    need_card()
    ranks = _scenes.run_world(2, _scenes.twin_check_job, ("graft", 1 << 16, 1 << 14),
                              device="cuda:0", timeout=600)
    for r in ranks:
        assert sorted((c["kernel"], c["state"]) for c in r["checks"]) == [
            ("SB", "mid"), ("SB", "tail"), ("SD", "mid"), ("SD", "tail")], r["checks"]
        for c in r["checks"]:
            assert c["bit_equal"] and c.get("tally_ok", True), c
            if c["kernel"] == "SB":
                _sb_ok(c)
            assert c["state"] != "mid" or c["tagged"] + c.get("sent", 0) > 0, c
