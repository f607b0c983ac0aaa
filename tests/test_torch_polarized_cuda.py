"""The polarized event block PZ on the card: one block of the CUDA kernel
(the FIFO prologue and K Stokes-vector events, with detectors their
polarized local estimates and ratio-tracking rays) against its plain
version ``polarized_block_reference`` at the launch, mid-flight and tail
states of every case of ``tests/polarized_scenes.py`` pz_cases, which
together launch the four instantiations (flux, detectors, Lambertian, both)
with one and two components, and sixteen detectors on the Mie step cloud
(many rays a collision in the CTA's ray queue).  Every lane-state row, the control state and
the dead counts bit for bit; the float64 tallies within 1e-9 (the kernel
adds them in another order).  A batch on the card launches PZ, counted per
instantiation, and never runs the plain version.

Marked ``cuda``: skipped without a card; imports no JAX, so it runs on the
card's machine with ``--noconftest``.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from i3rc_tpu_torch import batch_key
from i3rc_tpu_torch.kernels import polarized_block as pb

_spec = importlib.util.spec_from_file_location("polarized_scenes",
                                               Path(__file__).with_name("polarized_scenes.py"))
_scenes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_scenes)
CASES = _scenes.pz_cases()
LANES = (1 << 13) + 77           # a partial last CTA


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_polarized_block_matches_reference_on_gpu(case):
    dev = need_card()
    integ, src = _scenes.case_integrator(case, dev)
    key = batch_key(29, 1)
    spec, states = _scenes.trace_states(integ, src, 4 * LANES, LANES, key)
    assert [s[0] for s in states] == ["launch", "mid", "tail"]
    for name, st, buf, kb in states:
        r = _scenes.block_vs_twin(spec, st, buf, key, src, kb)
        assert r["bit_equal"], (name, r)
        assert r["tally_abs_err"] <= 1e-9, (name, r)


@pytest.mark.cuda
def test_polarized_batch_launches_the_kernel_on_gpu(monkeypatch):
    """A batch with detectors over a Lambertian surface: every block is one
    launch of the DET + LAMB instantiation, the plain version never runs."""
    dev = need_card()
    integ, src = _scenes.case_integrator("det_lamb", dev)
    from i3rc_tpu_torch.integrators import polarized as pz

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(pb, "polarized_block_reference", refuse)
    pb.reset_launch_counters()
    res = integ.batch_fn(src, 1 << 16, n_lanes=1 << 14)(batch_key(3, 0))
    assert pb.polarized_block.launches > 0
    assert pb.polarized_block.variant_launches == {
        "flux": 0, "detectors": 0, "lambertian": 0,
        "detectors_lambertian": pb.polarized_block.launches}
    assert int(res.n_bad) == 0 and bool(torch.isfinite(res.intensity).all())
    assert pz.PZ_K == integ.spec(1).K
