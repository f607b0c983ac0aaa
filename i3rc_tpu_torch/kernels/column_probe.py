"""The column-read probe: K events of one column-table row read each.

``column_probe`` is the wrapper.  On a CUDA tensor it launches the
hand-written Hopper kernel ``csrc/column_read_probe.cu``, the port of the
TPU probe ``pallas_column_loop`` (benchmarks/column_read_probe.py:83,
``pallas_call`` at :140), and raises if the build or the launch fails; on a
CPU tensor it runs ``column_probe_reference``, the plain PyTorch version,
on the same Philox draws.  It measures what a bare column read costs per
lane-event on the card, beside the column event block that does the same
read inside a transport event.

Per event (column_read_probe.py:104-132): ix = clip(int(x * 128)), iy =
clip(int(y * 128)), [v, zb, zt, ss] = table[ix * 128 + iy], one uniform u
(draw 0 of the event in the event block's Philox layout, in place of the
TPU's hardware PRNG), then x += (v - zb 0.001 + zt 0.001 + ss 0) 0.01 +
u 0.001 and y += u 0.002 + v 0.005, each wrapped to [0, 1), and acc += v.
"""

from __future__ import annotations

import torch

from i3rc_tpu_torch.core.rng import PhiloxKey, philox_uniforms

N_SIDE = 128             # columns per axis: the table has N_SIDE ** 2 rows
K = 8                    # events per launch (the probe's k_events)


def probe_uniforms(key: PhiloxKey, kb: int, n_lanes: int, device) -> torch.Tensor:
    """(K, n_lanes) float32: the kernel's one draw per event of block kb."""
    return philox_uniforms(key, kb, K, 1, n_lanes, device)[:, 0]


def table_read(table: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(L, 4) rows of the (N_SIDE ** 2, 4) table at the lanes' (x, y) cells."""
    ix = torch.clamp((x * 128.0).to(torch.int32), 0, N_SIDE - 1)
    iy = torch.clamp((y * 128.0).to(torch.int32), 0, N_SIDE - 1)
    return table[ix.to(torch.int64) * N_SIDE + iy]


def column_probe_reference(table, x, y, u):
    """Plain PyTorch version of the kernel: K events with the draws ``u``
    ((K, L) float32).  Returns the new (x, y) and the launch's acc."""
    acc = torch.zeros_like(x)
    for j in range(K):
        r = table_read(table, x, y)
        v, zb, zt, ss = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
        x = x + (v - zb * 0.001 + zt * 0.001 + ss * 0.0) * 0.01 + u[j] * 0.001
        x = x - torch.floor(x)
        y = y + u[j] * 0.002 + v * 0.005
        y = y - torch.floor(y)
        acc = acc + v
    return x, y, acc


def _launch(table, x, y, acc, key: PhiloxKey, kb: int) -> None:
    from i3rc_tpu_torch.kernels.event_block import _check, _stream, build

    L = x.numel()
    for t, shape in ((x, (L,)), (y, (L,)), (acc, (L,)), (table, (N_SIDE * N_SIDE, 4))):
        if (t.device != x.device or t.dtype != torch.float32 or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"column_probe: expected a contiguous float32 {shape} tensor "
                             f"on {x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    with torch.cuda.device(x.device):
        rc = build().lib.i3rc_column_read_probe(
            x.data_ptr(), y.data_ptr(), acc.data_ptr(), table.data_ptr(), L,
            key.seed & 0xFFFFFFFF, key.batch & 0xFFFFFFFF, kb & 0xFFFFFFFF,
            _stream(x.device))
    _check(rc, "column_read_probe launch")


def column_probe(table: torch.Tensor, x: torch.Tensor, y: torch.Tensor, key: PhiloxKey,
                 kb: int) -> torch.Tensor:
    """K probe events on every lane with the draws of block ``kb``: x and y
    are updated in place, the launch's acc is returned.  CUDA tensors launch
    the kernel (counted in ``column_probe.launches``); CPU tensors run the
    plain twin."""
    if x.device.type == "cuda":
        acc = torch.empty_like(x)
        _launch(table, x, y, acc, key, kb)
        column_probe.launches += 1
        return acc
    if x.device.type != "cpu":
        raise NotImplementedError(f"column_probe: no kernel for device {x.device}")
    nx, ny, acc = column_probe_reference(table, x, y, probe_uniforms(key, kb, x.numel(),
                                                                     x.device))
    x.copy_(nx)
    y.copy_(ny)
    return acc


column_probe.launches = 0
