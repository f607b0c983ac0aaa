"""The sharded tracer's kernels on the card: the whole block (SD's launch,
then with detectors SR and SP) against its plain version
(``sharded_block_reference``, ``shadow_advance_reference``,
``shadow_pack_reference``), and SR alone against its twin, at a mid-flight
and a tail state of a trace of each scene of ``tests/sharded_scenes.py`` on
a world of one: the absorbing Landsat scene (flux), the reflecting random
field (surface), its volume absorption, its three detectors over the
albedo, and the scene of ``__graft_entry__.py:127-156`` (two components, an
albedo, two detectors, the volume tally).  The lane state, the pool, the
send buffers, the free-slot list, the tiles' counts, the counts vector and
the flux tallies bit for bit; the radiance tallies within 1e-9 of their sum
(SR adds them in another order).

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
        if r["kernel"] == "SR":
            assert r["tally_abs_err"] <= 1e-9 * max(1.0, r["tally_sum"]), r
        else:
            assert r["lane_events"] > 0
    assert not st["spec"].n_dirs or len(st["sr"]) >= 1
    before = (sb.sharded_event_block.launches, sb.shadow_advance.launches,
              sb.shadow_pack.launches)
    _scenes.block_vs_twin(st["spec"], st["key"], st["source"], st["albedo"], st["block"][0])
    d = int(st["spec"].n_dirs > 0)
    assert (sb.sharded_event_block.launches, sb.shadow_advance.launches,
            sb.shadow_pack.launches) == (before[0] + 1, before[1] + d, before[2] + d)


@pytest.mark.cuda
def test_kernels_equal_their_twins_on_two_ranks():
    need_card()
    ranks = _scenes.run_world(2, _scenes.twin_check_job, ("graft", 1 << 16, 1 << 14),
                              device="cuda:0", timeout=600)
    for r in ranks:
        assert len(r["checks"]) == 4, r["checks"]
        for c in r["checks"]:
            assert c["bit_equal"] and c.get("tally_ok", True), c
            assert c["state"] != "mid" or c["tagged"] + c.get("sent", 0) > 0, c
