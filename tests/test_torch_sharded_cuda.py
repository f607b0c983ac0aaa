"""The sharded tracer's kernels on the card: SD (the event block) and SR
(the shadow-ray advance) against their plain twins
(``sharded_block_reference``, ``shadow_advance_reference``) at a
mid-flight and a tail state of a trace of each scene of
``tests/sharded_scenes.py`` on a world of one: the absorbing Landsat scene
(flux), the reflecting random field (surface), its volume absorption, its
three detectors over the albedo, and the scene of
``__graft_entry__.py:127-156`` (two components, an albedo, two detectors,
the volume tally).  Every state row bit for bit; SR's float64 tallies
within 1e-9 of their sum (the kernel adds them in another order).

The last test holds both kernels against their twins on each rank of a
gloo world of two that share the card (each rank's half slab, whose
faces at the middle of the domain are interior).

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
    assert len(st["sd"]) == 2, [kb for kb, _ in st["sd"]]
    for kb, state in st["sd"]:
        r = _scenes.sd_vs_twin(st["spec"], state, st["key"], kb)
        assert r["bit_equal"], r
        assert r["lane_events"] > 0
    if st["spec"].n_dirs:
        assert len(st["sr"]) >= 1
        for kb, pool in st["sr"]:
            r = _scenes.sr_vs_twin(st["spec"], pool)
            assert r["bit_equal"], r
            assert r["tally_abs_err"] <= 1e-9 * max(1.0, r["tally_sum"]), r
    before = (sb.sharded_event_block.launches, sb.shadow_advance.launches)
    _scenes.sd_vs_twin(st["spec"], st["sd"][0][1], st["key"], st["sd"][0][0])
    assert sb.sharded_event_block.launches == before[0] + 1
    assert sb.shadow_advance.launches == before[1]


@pytest.mark.cuda
def test_kernels_equal_their_twins_on_two_ranks():
    need_card()
    ranks = _scenes.run_world(2, _scenes.twin_check_job, ("graft", 1 << 16, 1 << 14),
                              device="cuda:0", timeout=600)
    for r in ranks:
        assert len(r["checks"]) == 4, r["checks"]
        for c in r["checks"]:
            assert c["bit_equal"], c
            assert c["state"] != "mid" or c["tagged"] > 0, c

