"""The kernels' reach on the card: the event block's runtime-depth variant
(collision chains past depth 3) against its plain version on every one of
its instantiations (``tests/reach_scenes.py`` ``deep_cases``: flux HG and
table, absorbing or not, y tracked or not, with and without the gas channel;
column media HG and table, absorbing or not), the whole block at a launch,
a mid-flight and a tail state bit for bit; the general kernel's estimate
stage with 300 components (tally slots past the old 8-bit field) against
its plain version; and SD's refill from a source queue (a spotlight, an
internal source spread across the slabs) against its plain version, on a
world of one, and the x-uniform sharded trace's integer tallies at a fixed
seed as the tree before the source queue gave them.

Marked ``cuda``: skipped without a card; imports no JAX, so it runs on the
card's machine with ``--noconftest``.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import reach_scenes as _reach  # noqa: E402
import sharded_scenes as _sharded  # noqa: E402

LANES = (1 << 13) + 77
# The x-uniform sharded trace of the volume scene (a world of one, 2^16
# photons, 2^14 lanes, seed 3) on the card: the digest of its unit-count
# tallies, n_bad, migrations and blocks (sharded_scenes.x_uniform_digest)
# as the tree before the source queue gave it on an NVIDIA H100 80GB HBM3
# (the CPU twin gives the same).
X_UNIFORM_CARD = "f01d19b6b571c187"


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_reach.deep_cases()))
def test_runtime_depth_block_matches_the_twin_on_gpu(name):
    dev = need_card()
    for r in _reach.deep_vs_twin(name, dev, LANES):
        assert r["bit_equal"] and r["acc_rel_err"] == 0.0, r
        assert r["instantiation"].startswith("ILin1E") and r["chain"] > 3, r


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["launch", "mid"])
def test_estimate_stage_past_255_components_matches_the_twin_on_gpu(state):
    from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource, batch_key
    from i3rc_tpu_torch.models.step_cloud import make_step_cloud

    dev = need_card()
    h = _reach.host("i3rc_tpu_torch")
    dom = _reach.split_components(h, make_step_cloud(1.0), 300)
    integ = Integrator.create(dom, IntegratorConfig(), intensity_mus=_reach.I3RC_MUS,
                              intensity_phis=_reach.I3RC_PHIS, device=dev)
    r = _reach.general_vs_twin(integ, PhotonSource.directional(0.5, 0.0), LANES,
                               batch_key(9, 2), state)
    assert r["lanes_differ"] == 0 and r["equal"] and r["tally_rel_err"] <= 1e-9, r
    assert r["n_components"] == 300 and r["top_slot"] > 255 and r["rays"] > 0, r


@pytest.mark.cuda
@pytest.mark.parametrize("source", sorted(_sharded.NON_UNIFORM_SOURCES))
def test_sd_refill_from_the_source_queue_matches_the_twin_on_gpu(source):
    dev = need_card()
    sc = _sharded.scene("volume", _sharded.host("i3rc_tpu_torch"), 2)
    st = _sharded.trace_states(sc, 1 << 16, 1 << 14, dev,
                               source=_sharded.photon_source(source))
    assert len(st["block"]) == 2
    for r in _sharded.states_vs_twins(st):
        assert r["bit_equal"] and r.get("tally_ok", True), r
    raw = st["raw"]
    total = float(raw.flux_up.sum() + raw.flux_down.sum() + raw.flux_absorbed.sum())
    assert total + int(raw.n_bad) == 1 << 16


@pytest.mark.cuda
def test_x_uniform_sharded_tallies_are_unchanged_on_gpu():
    dev = need_card()
    assert _sharded.x_uniform_digest(dev) == X_UNIFORM_CARD
