"""The fused-k variants of the fast event block on the card: one whole block
of the CUDA kernel (the per-k FIFO prologue, K events with the endpoint read
of each lane's k table, the exact death layer, weighted tallies and
detectors, the surface stage) against its plain version
(``fused_block_reference``) at the launch, mid-flight and tail states of
every case of ``tests/fused_k_scenes.py`` fk_cases, which together launch
every fused-k instantiation.  Every lane-state row (gcur included), the
per-k control state and the dead counts bit for bit; the flux, volume and
detector tallies within 1e-9 of their largest bin (each exit carries its
k's weight, and the kernel adds them in another order).  A fused-k plan on
a card launches the fused-k variant, counted in its own launch counter, and
never runs the plain version.

Marked ``cuda``: skipped without a card; imports no JAX, so it runs on the
card's machine with ``--noconftest``.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from i3rc_tpu_torch import batch_key
from i3rc_tpu_torch.kernels import event_block as eb

_spec = importlib.util.spec_from_file_location("fused_k_scenes",
                                               Path(__file__).with_name("fused_k_scenes.py"))
_scenes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_scenes)
CASES = _scenes.fk_cases()
LANES = (1 << 13) + 77           # a partial last CTA


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_k_block_matches_reference_on_gpu(case):
    dev = need_card()
    integ = _scenes.case_integrator(case, dev)
    src = _scenes.source(_scenes.host("i3rc_tpu_torch"), CASES[case][3])
    key = batch_key(29, 1)
    spec, pro, states = _scenes.trace_states(integ, src, 4 * LANES, LANES, key)
    assert spec.fused and [s[0] for s in states] == ["launch", "mid", "tail"]
    for name, st, buf, kb in states:
        r = _scenes.block_vs_twin(spec, pro, st, buf, key, src, kb)
        assert r["bit_equal"], (name, r)
        assert r["tally_rel_err"] <= 1e-9, (name, r)


@pytest.mark.cuda
def test_fused_k_plan_launches_the_fused_variant_on_gpu():
    """A batch of a fused-k plan on the card: the fused-k counter moves,
    no other, and the plain version never runs; every k's quota is
    launched."""
    dev = need_card()
    integ = _scenes.case_integrator("tab_flux_ssa0.99_ny4", dev)
    ran = []
    real = eb.fused_block_reference
    eb.fused_block_reference = lambda *a, **k: ran.append(1) or real(*a, **k)
    try:
        eb.reset_launch_counters()
        res = integ.batch_fn(_scenes.source(_scenes.host("i3rc_tpu_torch"), "directional"),
                             1 << 15, n_lanes=1 << 13)(batch_key(3, 0))
    finally:
        eb.fused_block_reference = real
    counts = {n: getattr(eb.event_block, n) for n in eb.LAUNCH_COUNTERS.values()}
    assert counts.pop("table_fused_k_launches") > 0 and not any(counts.values()), counts
    assert not ran
    total = float(res.mean_flux_up + res.mean_flux_down + res.mean_flux_absorbed)
    assert abs(total - 1.0) < 1e-5 and int(res.n_bad) == 0
