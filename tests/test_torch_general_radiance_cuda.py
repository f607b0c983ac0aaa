"""The general event block with radiance detectors on the card: one block of
the CUDA kernel (its estimate stage: the CTA's ray queue) against its plain
version (``general_block_reference``) for every case of
``tests/general_scenes.py`` RADIANCE_CASES: each estimator (exact trace,
Iwabuchi roulette, ratio tracking, the weight-1 class's) in each transport
mode that has it, over black, albedo and gridded RPV surfaces, with hybrid
phases and clipping, and sixteen detectors on the step cloud (many rays a
collision).  The lane state, the control state, the dead counts
and each lane's estimate steps bit for bit; the float64 tallies within
1e-9 of their largest entry (the kernel adds them in another order).

Marked ``cuda``: skipped without a card; imports no JAX, so it runs on the
card's machine with ``--noconftest``.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from i3rc_tpu_torch import PhotonSource, batch_key
from i3rc_tpu_torch.kernels import general_block as gb

_spec = importlib.util.spec_from_file_location("general_scenes",
                                               Path(__file__).with_name("general_scenes.py"))
_scenes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_scenes)
SRC = PhotonSource.directional(0.5, 0.0)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["launch", "mid"])
@pytest.mark.parametrize("case", sorted(_scenes.RADIANCE_CASES))
def test_estimate_stage_matches_reference_on_gpu(case, state):
    dev = need_card()
    integ = _scenes.radiance_case(_scenes.host("i3rc_tpu_torch"), case, dev)
    L = (1 << 13) + 77
    tracer = integ.general_tracer(4 * L, L)
    spec, opt, tables = tracer.spec, integ.device_optics, integ.tables
    var = gb.variant(spec, opt)
    key = batch_key(9, 2)
    st = gb.launch_state(spec, SRC.sample(key, L, dev), 4 * L)
    buf = gb.general_buffers(spec, st, L)
    kb = 0
    if state == "mid":
        for kb in range(2):
            gb.general_block(spec, var, opt, tables, st, buf, key, SRC, kb)
        kb = 2
    ref_st, ref_buf = st.clone(), buf.clone()
    gb.general_block(spec, var, opt, tables, st, buf, key, SRC, kb)
    gb.general_block_reference(spec, var, opt, tables, ref_st, ref_buf, key, SRC, kb)
    torch.cuda.synchronize()
    diff = int(((st.f != ref_st.f).any(0) | (st.i != ref_st.i).any(0)).sum())
    assert diff == 0, f"{diff} lanes differ"
    assert torch.equal(buf.ctl, ref_buf.ctl) and torch.equal(buf.dead, ref_buf.dead)
    assert torch.equal(buf.int_steps, ref_buf.int_steps)
    assert torch.equal(buf.int_rays, ref_buf.int_rays)
    assert int(ref_buf.int_steps.sum()) > 0 and float(ref_buf.intensity.sum()) > 0.0
    for what in ("columns", "intensity", "by_component", "excess"):
        assert rel_err(getattr(buf, what), getattr(ref_buf, what)) <= 1e-9, what
