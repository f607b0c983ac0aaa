"""The polarized event block PZ: K Stokes-vector transport events per lane.

``polarized_block`` is the wrapper the polarized trace loop
(``integrators/polarized.py`` ``make_polarized_tracer``) calls for one
block: the FIFO refill of dead lanes, then K events with, given detectors,
each collision's polarized local estimate and its ratio-tracking rays.  On
a CUDA tensor it launches the hand-written Hopper kernel
``csrc/polarized_event_block.cuh`` once (one of four instantiations: flux,
detectors, a Lambertian surface, both) and raises if the build or the
launch fails; on a CPU tensor it runs
``integrators.polarized.polarized_block_reference``, the plain PyTorch twin,
on the same Philox draws.  The JAX package runs this path as XLA (a
``lax.while_loop`` over events, ``i3rc_tpu/integrators/polarized.py:455``,
with a nested ``while_loop`` of ratio-tracking rounds, :409-446); it has no
TPU kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from i3rc_tpu_torch.core.illumination import PhotonSource
from i3rc_tpu_torch.core.rng import PhiloxKey
from i3rc_tpu_torch.integrators.polarized import (
    DET_COLS,
    MATRIX_COLS,
    PolarizedBuffers,
    PolarizedSpec,
    PolarizedState,
    polarized_block_reference,
)
from i3rc_tpu_torch.kernels.event_block import CTA_THREADS, _SourceParams, source_constants
from i3rc_tpu_torch.kernels.general_block import _Grid, _grid, device_counter, ray_queue

VARIANTS = ("flux", "detectors", "lambertian", "detectors_lambertian")
PZ_RAY_F4 = 4                    # float4 words of a ray record in PZ's queue


class _PolParams(ctypes.Structure):
    _fields_ = [("g", _Grid)] + [
        (n, ctypes.c_void_p) for n in ("total_ext", "cells", "cubic", "matrix", "det",
                                       "columns", "intensity", "ctl", "dead")] + [
        ("src", _SourceParams), ("n_photons", ctypes.c_longlong)] + [
        (n, ctypes.c_int) for n in ("n_comp", "max_entries", "n_seg", "n_fwd", "n_dirs",
                                    "max_events", "max_rounds", "n_lanes", "K")] + [
        (n, ctypes.c_float) for n in ("inv_maj", "albedo", "q0", "u0", "v0", "zeta")] + [
        (n, ctypes.c_uint32) for n in ("key0", "key1", "kb")] + [
        ("flushes", ctypes.c_void_p), ("rays", ctypes.c_void_p)]


@functools.lru_cache(maxsize=None)
def build():
    """Compile (or reuse) PZ's library (``csrc/polarized_event_block.cu``, one
    ``nvcc`` process) and declare its C interface."""
    from i3rc_tpu_torch.kernels.build import build as _build

    built = _build("polarized_event_block", ("polarized_event_block.cu",))
    lib = built.lib
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.i3rc_polarized_params_size.argtypes = []
    lib.i3rc_polarized_params_size.restype = ci
    lib.i3rc_polarized_event_block.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.i3rc_polarized_event_block.restype = ci
    if lib.i3rc_polarized_params_size() != ctypes.sizeof(_PolParams):
        raise RuntimeError("PolParams layout differs between Python and CUDA")
    return built


def variant(spec: PolarizedSpec) -> str:
    """The instantiation a block of ``spec`` launches."""
    return VARIANTS[int(spec.n_dirs > 0) + 2 * int(spec.lambert)]


def _need(t, device, dtype, shape, what: str) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"polarized_block: {what} must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on the state's device")


def polarized_params(spec: PolarizedSpec, state: PolarizedState, buf: PolarizedBuffers,
                     key: PhiloxKey, source: PhotonSource, kb: int) -> _PolParams:
    """The kernel's by-value parameter block for one launch."""
    p = _PolParams()
    g = spec.geom
    p.g = _grid(g)
    p.total_ext, p.cells = spec.total_ext.data_ptr(), spec.cells.data_ptr()
    p.cubic, p.matrix = spec.cubic.data_ptr(), spec.matrix.data_ptr()
    p.det = spec.det.data_ptr() if spec.n_dirs else None
    p.columns, p.intensity = buf.columns.data_ptr(), buf.intensity.data_ptr()
    p.ctl, p.dead = buf.ctl.data_ptr(), buf.dead.data_ptr()
    for n, v in source_constants(source, state.f.device).items():
        if n == "dir":
            p.src.dir[:] = v
        else:
            setattr(p.src, n, v)
    p.src.x0, p.src.wx = g.x0, g.x_max - g.x0
    p.src.y0, p.src.wy = g.y0, g.y_max - g.y0
    p.src.z0, p.src.wz = g.z0, g.z_max - g.z0
    p.n_photons = spec.n_photons
    p.n_comp, p.max_entries, p.n_seg, p.n_fwd = (spec.n_comp, spec.max_entries, spec.n_seg,
                                                 spec.n_fwd)
    p.n_dirs, p.max_events, p.max_rounds = spec.n_dirs, spec.max_events, spec.max_rounds
    p.n_lanes, p.K = state.n_lanes, spec.K
    p.inv_maj, p.albedo, p.zeta = spec.inv_maj, spec.albedo, spec.zeta
    p.q0, p.u0, p.v0 = spec.q0, spec.u0, spec.v0
    p.key0, p.key1 = key.seed & 0xFFFFFFFF, key.batch & 0xFFFFFFFF
    p.kb = kb & 0xFFFFFFFF
    if spec.n_dirs:
        p.flushes = ray_flush_counter(state.f.device).data_ptr()
        p.rays = ray_queue(buf, state.n_lanes, spec.K, PZ_RAY_F4).data_ptr()
    return p


def _launch(spec: PolarizedSpec, state: PolarizedState, buf: PolarizedBuffers,
            key: PhiloxKey, source: PhotonSource, kb: int) -> None:
    """Check the arguments and launch the kernel for block ``kb``."""
    f, i = state.f, state.i
    L, dev = state.n_lanes, f.device
    if i.device != dev or dev.type != "cuda":
        raise ValueError("polarized_block: state tensors must share one CUDA device")
    _need(f, dev, torch.float32, (13, L), "the state's f")
    _need(i, dev, torch.int32, (6, L), "the state's i")
    if spec.K < 1:
        raise NotImplementedError(f"the polarized block needs K >= 1; got K={spec.K}")
    # The parameter block is built once per trace (the same buffers, key and
    # source); later blocks change its block index only.
    tag = (key, L, spec, source)
    cached = getattr(buf, "_params", None)
    if cached is not None and cached[0][:2] == tag[:2] and all(
            a is b for a, b in zip(cached[0][2:], tag[2:])):
        p = cached[1]
        p.kb = kb & 0xFFFFFFFF
    else:
        g = spec.geom
        n, rows = spec.n_comp, spec.n_comp * spec.max_entries
        for t, dt, shape, what in (
                (spec.total_ext, torch.float32, (g.n_cells,), "total_ext"),
                (spec.cells, torch.float32, (g.n_cells, 3 * n), "cells"),
                (spec.cubic, torch.float32, (rows * spec.n_seg, 4), "cubic"),
                (spec.matrix, torch.float32, (rows * spec.n_fwd, MATRIX_COLS), "matrix"),
                (spec.det, torch.float32, (spec.n_dirs, DET_COLS), "det"),
                (buf.columns, torch.float64, (g.n_x * g.n_y, 3), "columns"),
                (buf.intensity, torch.float64, (g.n_x * g.n_y * spec.n_dirs * 4,),
                 "intensity"),
                (buf.ctl, torch.int64, (4,), "ctl"),
                (buf.dead, torch.int32, (2, -(-L // CTA_THREADS)), "dead")):
            _need(t, dev, dt, shape, what)
        p = polarized_params(spec, state, buf, key, source, kb)
        buf._params = (tag, p)
    lib = build().lib
    with torch.cuda.device(dev):
        rc = lib.i3rc_polarized_event_block(
            f.data_ptr(), i.data_ptr(), ctypes.byref(p), int(spec.n_dirs > 0),
            int(spec.lambert), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"polarized_event_block launch: CUDA error {rc}")


def polarized_block(spec: PolarizedSpec, state: PolarizedState, buf: PolarizedBuffers,
                    key: PhiloxKey, source: PhotonSource, kb: int) -> None:
    """One block ``kb`` of the polarized trace loop, in place on ``state``
    and ``buf``: the refill, K events (with detectors their polarized local
    estimates), the loop's control state.  On CUDA tensors one launch of
    PZ, counted in ``polarized_block.launches`` (per instantiation in
    ``polarized_block.variant_launches``), and nothing else; on CPU tensors
    ``polarized_block_reference``."""
    dev = state.f.device
    if dev.type == "cuda":
        _launch(spec, state, buf, key, source, kb)
        polarized_block.launches += 1
        polarized_block.variant_launches[variant(spec)] += 1
    elif dev.type == "cpu":
        polarized_block_reference(spec, state, buf, key, source, kb)
    else:
        raise NotImplementedError(f"polarized_block: no kernel for device {dev}")


_FLUSHES: dict = {}


def ray_flush_counter(device) -> torch.Tensor:
    """int64 (1,) on ``device``: the flushes of the estimate's ray queue
    (one a CTA that queued a record) that the kernel has counted since
    ``reset_launch_counters``; a diagnostic of the card only."""
    return device_counter(_FLUSHES, device)


def reset_launch_counters() -> None:
    polarized_block.launches = 0
    polarized_block.variant_launches = {v: 0 for v in VARIANTS}
    for t in _FLUSHES.values():
        t.zero_()


reset_launch_counters()
