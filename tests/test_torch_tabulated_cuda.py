"""The table variants of the fast event block on the card: one whole block of
the CUDA kernel (prologue, K events with the cubic inverse-CDF sampler, the
forward fit of the phase value, per-column ssa and table entries) against
its plain version (``fused_block_reference``) at the launch, mid-flight and
tail states of every case of ``tests/tabulated_scenes.py`` table_cases,
which together launch every table instantiation.  Every lane-state row, the
flux and volume tallies, the control state and the dead counts bit for bit;
the detector accumulators within 1e-9 of their largest bin (the kernel adds
them in another order).  A table plan on a card launches the table variant,
counted in its own launch counter, and never runs the plain version.

Marked ``cuda``: skipped without a card; imports no JAX, so it runs on the
card's machine with ``--noconftest``.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource, batch_key
from i3rc_tpu_torch.kernels import event_block as eb

_spec = importlib.util.spec_from_file_location("tabulated_scenes",
                                               Path(__file__).with_name("tabulated_scenes.py"))
_scenes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_scenes)
SRC = PhotonSource.directional(0.5, 0.0)
CASES = _scenes.table_cases()


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def integrator(name: str, dev):
    build, cfg, kw = CASES[name]
    return Integrator.create(build(_scenes.host("i3rc_tpu_torch")),
                             config=IntegratorConfig(**cfg), device=dev, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_table_block_matches_reference_on_gpu(case):
    dev = need_card()
    integ = integrator(case, dev)
    lanes = (1 << 13) + 77
    key = batch_key(23, 1)
    spec, pro, states = _scenes.trace_states(integ, SRC, 4 * lanes, lanes, key)
    assert spec.table and [s[0] for s in states] == ["launch", "mid", "tail"]
    for name, st, buf, kb in states:
        r = _scenes.block_vs_twin(spec, pro, st, buf, key, SRC, kb)
        assert r["bit_equal"], (name, r)
        assert r["acc_rel_err"] <= 1e-9, (name, r)


@pytest.mark.cuda
def test_table_plan_launches_the_table_variant_on_gpu():
    """A batch of a table plan on the card: the table counters move, the HG
    ones do not, and the plain version never runs."""
    dev = need_card()
    integ = integrator("col_c2_ssa0.9", dev)
    ran = []
    real = eb.fused_block_reference
    eb.fused_block_reference = lambda *a, **k: ran.append(1) or real(*a, **k)
    try:
        eb.reset_launch_counters()
        res = integ.batch_fn(SRC, 1 << 15, n_lanes=1 << 13)(batch_key(3, 0))
    finally:
        eb.fused_block_reference = real
    counts = {n: getattr(eb.event_block, n) for n in eb.LAUNCH_COUNTERS.values()}
    assert counts.pop("table_column_launches") > 0 and not any(counts.values()), counts
    assert not ran
    total = float(res.mean_flux_up + res.mean_flux_down + res.mean_flux_absorbed)
    assert abs(total - 1.0) < 1e-5 and int(res.n_bad) == 0
