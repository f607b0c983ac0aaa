"""The port's Philox4x32-10 streams (i3rc_tpu_torch/core/rng.py)."""

import numpy as np
import pytest
import torch

from i3rc_tpu_torch.core import rng

torch.set_num_threads(2)


@pytest.mark.parametrize("ctr,key,expect", [
    # Random123 known-answer vectors for philox4x32-10.
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, expect):
    c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
    assert tuple(int(w) for w in rng.philox4x32(*c, *key)) == expect


def test_uniforms_in_unit_interval_and_layout():
    key = rng.batch_key(3, 5)
    u = rng.philox_uniforms(key, kb=7, K=8, n_draws=9, n_lanes=512, device="cpu")
    assert u.shape == (8, 9, 512) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    # Event j, draw i reads group j * G + i // 4, word i % 4 (G = 3 here).
    flat = rng.stream_uniforms(key, rng.STREAM_EVENT, 7, 24, 512, "cpu")
    assert torch.equal(u[5, 6], flat[5 * 12 + 6])
    # Streams, blocks and batches are disjoint.
    other = [rng.stream_uniforms(key, rng.STREAM_REFILL, 7, 24, 512, "cpu"),
             rng.stream_uniforms(key, rng.STREAM_EVENT, 8, 24, 512, "cpu"),
             rng.stream_uniforms(rng.batch_key(3, 6), rng.STREAM_EVENT, 7, 24, 512, "cpu")]
    for o in other:
        assert not torch.equal(o, flat)
    # Uniform conversion: (bits >> 8) * 2**-24, exact in float32.
    assert np.all(np.asarray(flat) * 2 ** 24 == np.floor(np.asarray(flat) * 2 ** 24))


def test_exponential_deviate_guard():
    tau = rng.exponential_deviate(torch.tensor([0.0, 0.5, 1.0 - 2 ** -24]))
    assert torch.isfinite(tau).all()
    assert float(tau[0]) == pytest.approx(-np.log(np.float32(1.1754944e-38)), rel=1e-6)
    assert float(tau[1]) == pytest.approx(np.log(2.0), rel=1e-6)
