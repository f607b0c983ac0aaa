"""The sharded tracer's two kernels: the event block SD and the shadow-ray
advance SR, each beside its plain PyTorch twin.

The x-sharded domain tracer (``parallel/sharded_domain.py``) holds one
x-slab of the per-cell optics on each rank.  Its hot loops are XLA in the
JAX package (``i3rc_tpu/parallel/sharded_domain.py:230-363``, the event, and
``:464-530``, the shadow-ray steps, both inside the ``lax.while_loop`` at
``:713``); they have no TPU kernel.  Here each is a hand-written Hopper
kernel (``csrc/sharded_event_block.cu``), one thread a lane:

  * ``sharded_event_block`` (SD): K maximum cross-section events of each
    live lane, lane state in registers: the flight under the global
    majorant to the first of the tentative collision, the z exit and the
    slab's x faces (a migrant is pushed past its face and tagged, carrying
    its remaining optical depth), the wrap at the domain's x and y edges,
    the local cell read, the physical-or-null test, the component pick by
    cumulative extinction, Bernoulli absorption, with detectors each
    collision's per-detector prefactors w ssa P / (4 pi |mu_d|) from the
    replicated log-cubic forward fit (after which the lane freezes, ``pend``,
    until the glue moves its record into the shadow-ray pool), the cosine
    from the replicated cubic inverse CDF, the rotation, and the event
    budget;
  * ``shadow_advance`` (SR): K exact cell-DDA steps of each shadow ray of
    the pool in the local slab, the optical depth accumulated, a ray that
    crosses the slab's x face tagged to migrate, and an escaping ray's
    w exp(-tau) added to its exit column's float64 radiance tallies, the
    lanes of a warp that add to one bin summed first (``warp_red``).

On a CUDA tensor a wrapper launches its kernel and raises if the build or
the launch fails; on a CPU tensor it runs the twin
(``sharded_block_reference``, ``shadow_advance_reference``), which draws
the same Philox numbers (event j of block kb: groups 2j and 2j + 1 at
(lane, kb, ., ``STREAM_EVENT``) under the key (seed, rank)) and does the
same float32 arithmetic in the same order.

State layout (``ShardState``): ``f`` (7 + D, L) float32 rows x, y, z, ux,
uy, uz, tau and the D pending prefactors; ``i`` (9, L) int32 rows alive,
orders, pk (0 in flight, 1 up, 2 down, 3 absorbed), tag (+1 / -1: migrate
in x), bad, pend, pend_srf, pend_comp, evct (lane-events).  The pool
(``RayPool``): ``f`` (5, R) x, y, z, tau, prefactor; ``i`` (4, R) alive,
det (slot * D + d: slot 0 the surface, 1 + c component c), tag, steps.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from i3rc_tpu_torch.core.rng import PhiloxKey, exponential_deviate, philox_uniforms
from i3rc_tpu_torch.integrators.wavefront import f32, rotate_direction
from i3rc_tpu_torch.kernels.event_block import CTA_THREADS

X, Y, Z, UX, UY, UZ, TAU, PEND_PF = range(8)
ALIVE, ORDERS, PK, TAG, BAD, PEND, PEND_SRF, PEND_COMP, EVCT = range(9)
QX, QY, QZ, QTAU, QPF = range(5)
QALIVE, QDET, QTAG, QSTEPS = range(4)
N_DRAWS = 7        # free path, acceptance, absorption, cosine, azimuth, (unused), component
BIG = f32(3e38)
DIR_EPS = f32(2e-30)
EPS12 = f32(1e-12)
STEP_STRETCH = f32(1e-6)


@dataclass(frozen=True)
class ShardSpec:
    """One rank's slab and the replicated tables, on the rank's device, and
    every float32 constant the kernels and twins read."""

    cells: torch.Tensor      # (nx_loc * n_y * n_z, 1 + 3 C): ext | cum_c | ssa_c | row_c
    cubic: torch.Tensor      # (C * max_entries * n_seg, 4) inverse-CDF cubic rows
    fwd: torch.Tensor        # (C * max_entries * n_fwd, 4) log-phase cubic rows, or (0, 4)
    det: torch.Tensor        # (D, 4): direction, 1 / (4 pi |mu_d|); or (0, 4)
    n_comp: int
    n_seg: int
    n_fwd: int
    n_dirs: int
    nx_loc: int
    n_y: int
    n_z: int
    max_events: int
    K: int
    x_lo: float
    x_hi: float
    x0: float
    x_max: float
    y0: float
    y_max: float
    z0: float
    z_max: float
    wx: float                # x_max - x0
    wy: float
    hi_push: float           # x_hi + nudge: where a migrant in +x is put
    lo_push: float           # x_lo - nudge
    inv_dx: float
    inv_dy: float
    inv_dz: float
    dx: float
    dy: float
    dz: float
    inv_max_ext: float
    max_ext: float
    nudge: float
    fwd_scale: float         # n_fwd / pi

    @property
    def n_loc_cells(self) -> int:
        return self.nx_loc * self.n_y * self.n_z


@dataclass
class ShardState:
    f: torch.Tensor          # (7 + D, L) float32
    i: torch.Tensor          # (9, L) int32

    @property
    def n_lanes(self) -> int:
        return self.f.shape[1]

    def clone(self) -> "ShardState":
        return ShardState(self.f.clone(), self.i.clone())


@dataclass
class RayPool:
    f: torch.Tensor          # (5, R) float32
    i: torch.Tensor          # (4, R) int32

    @property
    def n_rays(self) -> int:
        return self.f.shape[1]

    def clone(self) -> "RayPool":
        return RayPool(self.f.clone(), self.i.clone())


def _cell_index(spec: ShardSpec, x, y, z):
    """The local cell row of positions (truncation, then the clip)."""
    ix = torch.clamp(((x - spec.x_lo) * spec.inv_dx).to(torch.int32), 0, spec.nx_loc - 1)
    iy = torch.clamp(((y - spec.y0) * spec.inv_dy).to(torch.int32), 0, spec.n_y - 1)
    iz = torch.clamp(((z - spec.z0) * spec.inv_dz).to(torch.int32), 0, spec.n_z - 1)
    return ix, iy, iz


def _wrap(v, lo: float, hi: float, w: float):
    return torch.where(v >= hi, v - w, torch.where(v < lo, v + w, v))


def _renormalized_rotation(ux, uy, uz, cs, u_az):
    """wavefront.rotate_direction, renormalized by an IEEE reciprocal of
    the square root (as the kernel computes it)."""
    nx, ny, nz = rotate_direction(ux, uy, uz, cs, u_az, renormalize=False)
    norm = torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=EPS12)).reciprocal()
    return nx * norm, ny * norm, nz * norm


def sharded_event(spec: ShardSpec, u: torch.Tensor, st: ShardState) -> None:
    """One event of every lane, in place: the plain version of SD's event
    (draws ``u`` (7, L)); lanes not alive or frozen on a pending record sit
    out."""
    f, iv = st.f, st.i
    act = (iv[ALIVE] != 0) & (iv[PEND] == 0)
    x, y, z, ux, uy, uz, tau = (f[r] for r in range(7))
    tau = torch.where(tau > 0.0, tau, exponential_deviate(u[0]))
    s_col = tau * spec.inv_max_ext
    s_top = torch.where(uz >= DIR_EPS, (spec.z_max - z) / uz, BIG)
    s_bot = torch.where(uz <= -DIR_EPS, (spec.z0 - z) / uz, BIG)
    s_xhi = torch.where(ux >= DIR_EPS, (spec.x_hi - x) / ux, BIG)
    s_xlo = torch.where(ux <= -DIR_EPS, (spec.x_lo - x) / ux, BIG)
    s_mig = torch.minimum(s_xhi, s_xlo)
    s_exit = torch.minimum(s_top, s_bot)
    adv = torch.clamp(torch.minimum(torch.minimum(s_col, s_exit), s_mig), min=0.0)
    collide = act & (s_col <= s_exit) & (s_col <= s_mig)
    leave = act & ~collide & (s_exit <= s_mig)
    migrate = act & ~collide & ~leave
    exit_top = leave & (s_top <= s_bot)
    exit_bot = leave & ~exit_top
    nx_ = x + ux * adv
    ny_ = y + uy * adv
    nz_ = z + uz * adv
    nx_ = torch.where(migrate, torch.where(s_xhi <= s_xlo, spec.hi_push, spec.lo_push), nx_)
    nx_ = _wrap(nx_, spec.x0, spec.x_max, spec.wx)
    ny_ = _wrap(ny_, spec.y0, spec.y_max, spec.wy)
    nz_ = torch.where(exit_top, spec.z_max, torch.where(exit_bot, spec.z0, nz_))
    tau = torch.where(collide, 0.0, tau - adv * spec.max_ext)
    x = torch.where(act, nx_, x)
    y = torch.where(act, ny_, y)
    z = torch.where(act, nz_, z)

    ix, iy, iz = _cell_index(spec, x, y, z)
    cell = spec.cells[((ix * spec.n_y + iy) * spec.n_z + iz).long()]
    C = spec.n_comp
    physical = collide & (u[1] < cell[:, 0] * spec.inv_max_ext)
    if C == 1:
        comp = torch.zeros_like(ix)
    else:
        comp = torch.clamp((u[6][:, None] >= cell[:, 1:1 + C]).sum(1).to(torch.int32), 0, C - 1)
    pick = lambda base: torch.gather(cell, 1, (base + comp).long()[:, None])[:, 0]
    ssa = pick(1 + C)
    rowb = pick(1 + 2 * C).to(torch.int32)
    died = physical & (u[2] >= ssa)
    scatter = physical & ~died

    if spec.n_dirs:
        for d in range(spec.n_dirs):
            dx_, dy_, dz_, inv_amu = (float(v) for v in spec.det[d].tolist())
            proj = torch.clamp(ux * dx_ + uy * dy_ + uz * dz_, -1.0, 1.0)
            pos = torch.acos(proj) * spec.fwd_scale
            seg = torch.clamp(pos.to(torch.int32), 0, spec.n_fwd - 1)
            t = pos - seg.to(torch.float32)
            c = spec.fwd[(rowb * spec.n_fwd + seg).long()]
            pf = torch.exp(((c[:, 3] * t + c[:, 2]) * t + c[:, 1]) * t + c[:, 0])
            f[PEND_PF + d] = torch.where(physical, pf * inv_amu * ssa, f[PEND_PF + d])
        iv[PEND_COMP] = torch.where(physical, comp, iv[PEND_COMP])
        iv[PEND_SRF] = torch.where(physical, 0, iv[PEND_SRF])
        iv[PEND] = torch.where(physical, 1, iv[PEND])

    pk = torch.where(exit_top, 1, torch.where(exit_bot, 2, torch.where(died, 3, iv[PK])))
    tag = torch.where(migrate, torch.where(ux >= 0.0, 1, -1), iv[TAG])
    pos_s = torch.clamp(u[3], 0.0, 1.0) * float(spec.n_seg)
    seg_s = torch.clamp(pos_s.to(torch.int32), 0, spec.n_seg - 1)
    t_s = pos_s - seg_s.to(torch.float32)
    c4 = spec.cubic[(rowb * spec.n_seg + seg_s).long()]
    cs = torch.clamp(((c4[:, 3] * t_s + c4[:, 2]) * t_s + c4[:, 1]) * t_s + c4[:, 0], -1.0, 1.0)
    nux, nuy, nuz = _renormalized_rotation(ux, uy, uz, cs, u[4])
    f[UX] = torch.where(scatter, nux, ux)
    f[UY] = torch.where(scatter, nuy, uy)
    f[UZ] = torch.where(scatter, nuz, uz)
    f[X], f[Y], f[Z] = x, y, z
    f[TAU] = torch.where(act, tau, f[TAU])
    orders = iv[ORDERS] + physical.to(torch.int32)
    # The event budget ends a lane still in flight (not one that left,
    # died or migrated in this event: it is tallied or sent).
    over = act & (orders >= spec.max_events) & (pk == 0) & (tag == 0)
    iv[ORDERS] = orders
    iv[PK] = pk.to(torch.int32)
    iv[TAG] = tag.to(torch.int32)
    iv[BAD] += over.to(torch.int32)
    iv[EVCT] += act.to(torch.int32)
    iv[ALIVE] = torch.where(act, ((pk == 0) & (tag == 0) & ~over).to(torch.int32), iv[ALIVE])


def sharded_block_reference(spec: ShardSpec, st: ShardState, key: PhiloxKey, kb: int) -> None:
    """SD's plain version: K events of block ``kb`` in place on ``st``."""
    u = philox_uniforms(key, kb, spec.K, N_DRAWS, st.n_lanes, st.f.device)
    for j in range(spec.K):
        sharded_event(spec, u[j], st)


def shadow_step(spec: ShardSpec, pool: RayPool, acc_int: torch.Tensor,
                acc_byc: torch.Tensor) -> None:
    """One exact cell-DDA step of every shadow ray in flight, in place:
    the plain version of SR's step."""
    qf, qi = pool.f, pool.i
    step = (qi[QALIVE] != 0) & (qi[QTAG] == 0)
    D, C = spec.n_dirs, spec.n_comp
    d = qi[QDET] % D
    slot = qi[QDET] // D
    dirs = spec.det[d.long()]
    rdx, rdy, rdz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    qx, qy, qz, qtau = qf[QX], qf[QY], qf[QZ], qf[QTAU]
    ix, iy, iz = _cell_index(spec, qx, qy, qz)
    ext = spec.cells[((ix * spec.n_y + iy) * spec.n_z + iz).long(), 0]
    up = lambda r: (r >= 0.0).to(torch.float32)
    fx = spec.x_lo + (ix.to(torch.float32) + up(rdx)) * spec.dx
    fy = spec.y0 + (iy.to(torch.float32) + up(rdy)) * spec.dy
    fz = spec.z0 + (iz.to(torch.float32) + up(rdz)) * spec.dz
    s_x = torch.where(torch.abs(rdx) >= DIR_EPS, (fx - qx) / rdx, BIG)
    s_y = torch.where(torch.abs(rdy) >= DIR_EPS, (fy - qy) / rdy, BIG)
    s_z = torch.where(torch.abs(rdz) >= DIR_EPS, (fz - qz) / rdz, BIG)
    s = torch.clamp(torch.minimum(torch.minimum(s_x, s_y), s_z), min=0.0)
    qtau = torch.where(step, qtau + ext * s, qtau)
    adv = s + s * STEP_STRETCH + spec.nudge
    nqx = qx + rdx * adv
    nqy = _wrap(qy + rdy * adv, spec.y0, spec.y_max, spec.wy)
    nqz = qz + rdz * adv
    escaped = step & (((rdz > 0.0) & (nqz >= spec.z_max)) | ((rdz < 0.0) & (nqz <= spec.z0)))
    if bool(escaped.any()):
        # The exit column from the crossing point, before the x wrap.
        eix, eiy, _ = _cell_index(spec, nqx, nqy, nqz)
        e = escaped.nonzero()[:, 0]
        contrib = (qf[QPF][e] * torch.exp(-qtau[e])).to(torch.float64)
        bin_ = ((eix[e] * spec.n_y + eiy[e]) * D + d[e]).long()
        acc_int.index_add_(0, bin_, contrib)
        acc_byc.index_add_(0, bin_ * (C + 1) + slot[e].long(), contrib)
    mig = step & ~escaped & ((nqx >= spec.x_hi) | (nqx < spec.x_lo))
    nqx = _wrap(nqx, spec.x0, spec.x_max, spec.wx)
    qi[QALIVE] = torch.where(escaped, 0, qi[QALIVE])
    qi[QTAG] = torch.where(mig, torch.where(rdx >= 0.0, 1, -1), qi[QTAG]).to(torch.int32)
    qi[QSTEPS] += step.to(torch.int32)
    qf[QX] = torch.where(step, nqx, qx)
    qf[QY] = torch.where(step, nqy, qy)
    qf[QZ] = torch.where(step, nqz, qz)
    qf[QTAU] = qtau


def shadow_advance_reference(spec: ShardSpec, pool: RayPool, acc_int: torch.Tensor,
                             acc_byc: torch.Tensor) -> None:
    """SR's plain version: K steps of the pool in place, tallies added."""
    for _ in range(spec.K):
        shadow_step(spec, pool, acc_int, acc_byc)


# ---------------------------------------------------------------------------
# The CUDA kernels

class _ShardParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("cells", "cubic", "fwd", "det", "acc_int",
                                               "acc_byc")] + [
        (n, ctypes.c_int) for n in ("n_lanes", "K", "n_comp", "n_seg", "n_fwd", "n_dirs",
                                    "nx_loc", "n_y", "n_z", "max_events")] + [
        (n, ctypes.c_float) for n in ("x_lo", "x_hi", "x0", "x_max", "y0", "y_max", "z0",
                                      "z_max", "wx", "wy", "hi_push", "lo_push", "inv_dx",
                                      "inv_dy", "inv_dz", "dx", "dy", "dz", "inv_max_ext",
                                      "max_ext", "nudge", "fwd_scale")] + [
        (n, ctypes.c_uint32) for n in ("key0", "key1", "kb")]


@functools.lru_cache(maxsize=None)
def build():
    """Compile (or reuse) SD's and SR's library (``csrc/sharded_event_block.cu``,
    one ``nvcc`` process) and declare its C interface."""
    from i3rc_tpu_torch.kernels.build import build as _build

    built = _build("sharded_event_block", ("sharded_event_block.cu",))
    lib = built.lib
    vp = ctypes.c_void_p
    lib.i3rc_sharded_params_size.argtypes = []
    lib.i3rc_sharded_params_size.restype = ctypes.c_int
    lib.i3rc_sharded_event_block.argtypes = [vp, vp, vp, vp]
    lib.i3rc_sharded_event_block.restype = ctypes.c_int
    lib.i3rc_shadow_advance.argtypes = [vp, vp, vp, vp]
    lib.i3rc_shadow_advance.restype = ctypes.c_int
    if lib.i3rc_sharded_params_size() != ctypes.sizeof(_ShardParams):
        raise RuntimeError("ShardParams layout differs between Python and CUDA")
    return built


def _need(t, device, dtype, shape, what: str) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"sharded block: {what} must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on the state's device")


def shard_params(spec: ShardSpec, n_lanes: int, key: PhiloxKey, kb: int,
                 acc_int=None, acc_byc=None) -> _ShardParams:
    """The kernels' by-value parameter block."""
    p = _ShardParams()
    p.cells, p.cubic = spec.cells.data_ptr(), spec.cubic.data_ptr()
    p.fwd = spec.fwd.data_ptr() if spec.n_dirs else None
    p.det = spec.det.data_ptr() if spec.n_dirs else None
    p.acc_int = acc_int.data_ptr() if acc_int is not None else None
    p.acc_byc = acc_byc.data_ptr() if acc_byc is not None else None
    p.n_lanes = n_lanes
    for n in ("K", "n_comp", "n_seg", "n_fwd", "n_dirs", "nx_loc", "n_y", "n_z", "max_events",
              "x_lo", "x_hi", "x0", "x_max", "y0", "y_max", "z0", "z_max", "wx", "wy",
              "hi_push", "lo_push", "inv_dx", "inv_dy", "inv_dz", "dx", "dy", "dz",
              "inv_max_ext", "max_ext", "nudge", "fwd_scale"):
        setattr(p, n, getattr(spec, n))
    p.key0, p.key1 = key.seed & 0xFFFFFFFF, key.batch & 0xFFFFFFFF
    p.kb = kb & 0xFFFFFFFF
    return p


def _check_spec(spec: ShardSpec, dev) -> None:
    C = spec.n_comp
    _need(spec.cells, dev, torch.float32, (spec.n_loc_cells, 1 + 3 * C), "cells")
    _need(spec.cubic, dev, torch.float32, (spec.cubic.shape[0], 4), "cubic")
    if spec.n_dirs:
        _need(spec.fwd, dev, torch.float32, (spec.fwd.shape[0], 4), "fwd")
        _need(spec.det, dev, torch.float32, (spec.n_dirs, 4), "det")
    if spec.K < 1 or spec.n_seg < 1 or (spec.n_dirs and spec.n_fwd < 1):
        raise ValueError(f"sharded block: K={spec.K}, n_seg={spec.n_seg}, n_fwd={spec.n_fwd}")


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def sharded_event_block(spec: ShardSpec, st: ShardState, key: PhiloxKey, kb: int) -> None:
    """K events of block ``kb`` in place on ``st``.  On CUDA tensors one
    launch of SD, counted in ``sharded_event_block.launches``; on CPU
    tensors ``sharded_block_reference``."""
    dev = st.f.device
    if dev.type == "cpu":
        sharded_block_reference(spec, st, key, kb)
        return
    if dev.type != "cuda":
        raise NotImplementedError(f"sharded_event_block: no kernel for device {dev}")
    L = st.n_lanes
    _check_spec(spec, dev)
    _need(st.f, dev, torch.float32, (PEND_PF + spec.n_dirs, L), "the state's f")
    _need(st.i, dev, torch.int32, (9, L), "the state's i")
    p = shard_params(spec, L, key, kb)
    with torch.cuda.device(dev):
        rc = build().lib.i3rc_sharded_event_block(st.f.data_ptr(), st.i.data_ptr(),
                                                  ctypes.byref(p), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"sharded_event_block launch: CUDA error {rc}")
    sharded_event_block.launches += 1


def shadow_advance(spec: ShardSpec, pool: RayPool, acc_int: torch.Tensor,
                   acc_byc: torch.Tensor) -> None:
    """K DDA steps of every shadow ray in flight, in place on ``pool`` and
    the float64 tallies.  On CUDA tensors one launch of SR, counted in
    ``shadow_advance.launches``; on CPU tensors ``shadow_advance_reference``."""
    dev = pool.f.device
    if dev.type == "cpu":
        shadow_advance_reference(spec, pool, acc_int, acc_byc)
        return
    if dev.type != "cuda":
        raise NotImplementedError(f"shadow_advance: no kernel for device {dev}")
    R, D, C = pool.n_rays, spec.n_dirs, spec.n_comp
    if D < 1:
        raise ValueError("shadow_advance: the plan has no detectors")
    _check_spec(spec, dev)
    _need(pool.f, dev, torch.float32, (5, R), "the pool's f")
    _need(pool.i, dev, torch.int32, (4, R), "the pool's i")
    n_cols = spec.nx_loc * spec.n_y
    _need(acc_int, dev, torch.float64, (n_cols * D,), "acc_int")
    _need(acc_byc, dev, torch.float64, (n_cols * D * (C + 1),), "acc_byc")
    p = shard_params(spec, R, PhiloxKey(0, 0), 0, acc_int, acc_byc)
    with torch.cuda.device(dev):
        rc = build().lib.i3rc_shadow_advance(pool.f.data_ptr(), pool.i.data_ptr(),
                                             ctypes.byref(p), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"shadow_advance launch: CUDA error {rc}")
    shadow_advance.launches += 1


def reset_launch_counters() -> None:
    sharded_event_block.launches = 0
    shadow_advance.launches = 0


reset_launch_counters()
