"""The surface stage of the fast event block on the card: one whole block of
the CUDA kernels over a reflecting surface (prologue and K events, then the
surface stage's kernel: the bounce of the block's bottom hits, the exits'
and the surface radiance's tallies summed per CTA) against its plain
version (``fused_block_reference``, whose surface stage is
``resolve_surface``) at the launch, mid-flight and tail states of every
case of ``tests/surface_scenes.py`` surface_cases, which together put the
stage (FK or not) after every event-kernel instantiation, over every
surface kind.  Every lane-state row, the lane weight of a BRDF plan, the
control state and the dead counts bit for bit; the flux, volume, detector
and surface-radiance tallies within 1e-9 of their largest bin (the kernel
adds them in another order).  A surfaced plan on a card launches the
surfaced variant, counted in its own launch counter, and never runs the
plain version.

Marked ``cuda``: skipped without a card; imports no JAX, so it runs on the
card's machine with ``--noconftest``.  (tests/test_torch_surface.py holds
the plain surface stage to the JAX glue and imports JAX.)
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from i3rc_tpu_torch import PhotonSource, batch_key
from i3rc_tpu_torch.kernels import event_block as eb

_spec = importlib.util.spec_from_file_location("surface_scenes",
                                               Path(__file__).with_name("surface_scenes.py"))
_scenes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_scenes)
CASES = _scenes.surface_cases()
SRC = PhotonSource.directional(0.5, 0.0)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_surface_block_matches_reference_on_gpu(case):
    dev = need_card()
    integ = _scenes.case_integrator(case, dev)
    key = batch_key(31, 1)
    lanes = _scenes.LANES
    spec, pro, states = _scenes.trace_states(integ, SRC, 4 * lanes, lanes, key, CASES[case][3])
    assert spec.reflecting and [s[0] for s in states] == ["launch", "mid", "tail"]
    for name, st, buf, kb in states:
        r = _scenes.block_vs_twin(spec, pro, st, buf, key, SRC, kb)
        assert r["bit_equal"] and r["pending_after"] == 0, (name, r)
        assert r["tally_rel_err"] <= 1e-9, (name, r)


@pytest.mark.cuda
def test_surface_plan_launches_the_surface_variant_on_gpu():
    """A batch of an RPV plan with detectors on the card: the surfaced
    detector counter moves, no other, and the plain version never runs."""
    dev = need_card()
    integ = _scenes.case_integrator("hg_det_exact_ssa1.0_ny1_rpv", dev)
    ran = []
    real = eb.fused_block_reference
    eb.fused_block_reference = lambda *a, **k: ran.append(1) or real(*a, **k)
    try:
        eb.reset_launch_counters()
        res = integ.batch_fn(SRC, 1 << 15, n_lanes=1 << 13)(batch_key(3, 0))
    finally:
        eb.fused_block_reference = real
    counts = {n: getattr(eb.event_block, n) for n in eb.LAUNCH_COUNTERS.values()}
    assert counts.pop("detector_surface_launches") > 0 and not any(counts.values()), counts
    assert not ran
    assert int(res.n_bad) == 0 and bool(torch.isfinite(res.intensity).all())
