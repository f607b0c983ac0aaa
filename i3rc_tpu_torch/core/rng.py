"""Counter-based Philox4x32-10 random streams for the PyTorch port.

Port of ``i3rc_tpu/core/rng.py``.  The JAX package derives Threefry keys by
``fold_in``; here every draw is a pure function of a counter, evaluated with
the Philox4x32-10 block cipher (Salmon et al., SC'11 — the Random123
generator).  The same cipher runs inside the CUDA event-block kernel
(``csrc/fast_event_block.cu``), so the kernel and its plain PyTorch twin see
bit-identical uniforms.

Layout (shared bit for bit with the CUDA kernel):

  key     (k0, k1)         = (seed, batch), each taken mod 2**32
  counter (c0, c1, c2, c3) = (lane, block, group, stream)

  * ``lane``   photon lane index in [0, n_lanes)
  * ``block``  K-event block index ``kb`` of the trace loop (0 at launch)
  * ``group``  draw-group index: one Philox call yields 4 words, so draw
               ``r`` of a lane reads word ``r % 4`` of group ``r // 4``.
               Event draws use ``r = j * 4G + i`` for event ``j`` of the
               block and draw ``i`` of that event, with ``G = ceil(n_draws
               / 4)`` groups per event (the tail words of the last group
               are unused).
  * ``stream`` disjoint purpose ids: ``STREAM_EVENT`` (the event block's
               draws, fastpath.py:2075 in the JAX package),
               ``STREAM_REFILL`` (source samples for lanes refilled before
               block ``kb``, fastpath.py:2027), ``STREAM_LAUNCH`` (the
               batch's initial photons, integrator.py:459-460) and
               ``STREAM_GAS`` (the gas channel's optical-depth thresholds:
               group 0 at block ``kb`` for the lanes refilled before block
               ``kb``, fastpath.py:2037-2041, and at block
               ``GAS_LAUNCH_BLOCK`` = 0xFFFFFFFF for the launch,
               fastpath.py:2097-2106); ``STREAM_SURFACE`` (the surface
               bounce of the lanes that hit a reflecting bottom in block
               ``kb``: group 0 holds the revive test, the outgoing cosine
               and azimuth, fastpath.py:1884-1886) and ``STREAM_SURFACE_IW``
               (their Iwabuchi draws, one per detector, fastpath.py:
               1916-1919); ``STREAM_INTENSITY`` (the local estimate's draws
               in the general event block: event ``j`` of block ``kb``,
               detector ``d``, round pair ``q`` read group ``j + K * (d + D *
               q)``; ``intensity_group``).

Uniform conversion: ``u = (bits >> 8) * 2**-24``, exact in float32, in
[0, 1 - 2**-24].

Validation against the JAX package is statistical: the two packages use
different generators, so only distributions are compared, never streams.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Smallest positive normal float32: lower bound for -log(u) arguments,
# mirroring the reference's max(tiny(x), u) guard
# (Integrators/monteCarloRadiativeTransfer.f95:480).
TINY = float(np.float32(1.1754944e-38))

STREAM_EVENT = 0
STREAM_REFILL = 1
STREAM_LAUNCH = 2
STREAM_GAS = 3
STREAM_SURFACE = 4
STREAM_SURFACE_IW = 5
STREAM_INTENSITY = 6
GAS_LAUNCH_BLOCK = 0xFFFFFFFF

_M32 = 0xFFFFFFFF
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85
_TWO_M24 = 2.0 ** -24


@dataclass(frozen=True)
class PhiloxKey:
    """Decorrelated stream for one batch: the reference's (iseed, batch)."""

    seed: int
    batch: int


def batch_key(seed: int, batch: int) -> PhiloxKey:
    """Key of batch ``batch`` of a run seeded with ``seed``."""
    return PhiloxKey(int(seed), int(batch))


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) words of the 64-bit product m * c, c uint32 held in int64.

    int64 cannot hold the full product, so c is split into 16-bit halves:
    m * c = (m * c_hi) << 16 + m * c_lo, each partial product < 2**48.
    """
    p_lo = m * (c & 0xFFFF)
    p_hi = m * (c >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _M32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of counter words (int64 tensors or ints) under (k0, k1).

    Returns the four output words as int64 tensors holding uint32 values.
    """
    k0 &= _M32
    k1 &= _M32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _M32
            k1 = (k1 + _PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64 tensor) -> float32 uniforms in [0, 1)."""
    return (bits >> 8).to(torch.float32) * _TWO_M24


def stream_uniforms(key: PhiloxKey, stream: int, block: int, n_groups: int,
                    n_lanes: int, device, lanes: torch.Tensor | None = None) -> torch.Tensor:
    """(4 * n_groups, n_lanes) float32 uniforms; row r is draw r of a lane.
    ``lanes`` (int64, n_lanes entries) draws those lanes' columns only."""
    lane = (torch.arange(n_lanes, dtype=torch.int64, device=device) if lanes is None
            else lanes.to(device=device, dtype=torch.int64))
    group = torch.arange(n_groups, dtype=torch.int64, device=device)
    c0 = lane.expand(n_groups, n_lanes)
    c2 = group[:, None].expand(n_groups, n_lanes)
    c1 = torch.full_like(c0, int(block) & _M32)
    c3 = torch.full_like(c0, int(stream) & _M32)
    words = philox4x32(c0, c1, c2, c3, key.seed, key.batch)
    bits = torch.stack(words, dim=1).reshape(4 * n_groups, n_lanes)
    return bits_to_unit(bits)


def groups_per_event(n_draws: int) -> int:
    return -(-int(n_draws) // 4)


def philox_uniforms(key: PhiloxKey, kb: int, K: int, n_draws: int, n_lanes: int,
                    device) -> torch.Tensor:
    """(K, n_draws, n_lanes) event-block draws: exactly what the CUDA kernel
    draws for block ``kb`` (see the module docstring for the layout)."""
    G = groups_per_event(n_draws)
    u = stream_uniforms(key, STREAM_EVENT, kb, K * G, n_lanes, device)
    return u.reshape(K, 4 * G, n_lanes)[:, :n_draws]


def intensity_group(j, d, pair, K: int, D: int):
    """Philox group of the local estimate's draws for event ``j`` of a block
    of K events, detector ``d`` of D and round pair ``pair`` (Iwabuchi
    roulette reads words 0-1 of pair 0; ratio tracking's round r reads
    words 2 (r % 2) and 2 (r % 2) + 1 of pair r // 2)."""
    return j + K * (d + D * pair)


def intensity_uniforms(key: PhiloxKey, kb: int, lane: torch.Tensor,
                       group: torch.Tensor) -> torch.Tensor:
    """(4, n) float32 uniforms of ``STREAM_INTENSITY`` at block ``kb`` for
    the (lane, group) pairs of two int64 tensors of n entries."""
    c1 = torch.full_like(lane, int(kb) & _M32)
    c3 = torch.full_like(lane, STREAM_INTENSITY)
    words = philox4x32(lane, c1, group & _M32, c3, key.seed, key.batch)
    return bits_to_unit(torch.stack(words))


def exponential_deviate(u: torch.Tensor) -> torch.Tensor:
    """Optical-depth free path tau = -log(max(tiny, u)).

    Mirrors Integrators/monteCarloRadiativeTransfer.f95:480, including the
    guard against u == 0.
    """
    return -torch.log(torch.clamp(u, min=TINY))


def gas_thresholds(key: PhiloxKey, block: int, n_lanes: int, device) -> torch.Tensor:
    """(n_lanes,) exponential gas optical-depth thresholds drawn at ``block``
    of ``STREAM_GAS`` (``GAS_LAUNCH_BLOCK`` for the launch)."""
    return exponential_deviate(stream_uniforms(key, STREAM_GAS, block, 1, n_lanes, device)[0])
