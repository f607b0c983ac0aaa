"""The sharded tracer's kernels: the whole block SD and the shadow-ray
kernel SB (the rays' steps, then their pack), each beside its plain
PyTorch version.

The x-sharded domain tracer (``parallel/sharded_domain.py``) holds one
x-slab of the per-cell optics on each rank.  Its block is XLA in the JAX
package (``i3rc_tpu/parallel/sharded_domain.py:230-363``, the event,
``:464-530``, the shadow-ray steps, and the glue around them, all inside
the ``lax.while_loop`` at ``:713``); it has no TPU kernel.  Here it is
two hand-written Hopper kernels (``csrc/sharded_event_block.cu``):

  * ``sharded_event_block`` (SD), the whole block in one launch: the rows
    the host sent leave, the arrived rows take free lanes and pool slots,
    the FIFO refill (``block_prologue_reference``); K maximum cross-section
    events of each live lane, lane state in registers: the flight under the
    global majorant to the first of the tentative collision, the z exit and
    the slab's x faces (a migrant is pushed past its face and tagged,
    carrying its remaining optical depth), the wrap at the domain's x and y
    edges, the local cell read, the physical-or-null test, the component
    pick by cumulative extinction, Bernoulli absorption, with detectors each
    collision's per-detector prefactors w ssa P / (4 pi |mu_d|) from the
    replicated log-cubic forward fit (after which the lane freezes,
    ``pend``, until the drain moves its record into the shadow-ray pool),
    the cosine from the replicated cubic inverse CDF, the rotation, and the
    event budget (``sharded_events_reference``); then the flush into the
    float64 tallies, the surface record and revive, the drain, the tagged
    photons packed into the send buffers and the counts the host plans the
    next block with (``block_epilogue_reference``); one thread a lane;
  * ``shadow_block`` (SB), the pool's shadow rays in one launch: K exact
    cell-DDA steps of each ray in flight in the local slab, the optical
    depth accumulated, a ray that crosses the slab's x face tagged to
    migrate, and an escaping ray's w exp(-tau) added to its exit column's
    float64 radiance tallies (``shadow_advance_reference``); then the tagged
    rays packed into the send buffers, the pool's free slots listed, the
    counts' ray side (``shadow_pack_reference``).  A CTA takes a run of
    tiles, queues its rays in flight in shared memory and pulls them, a
    warp refilling its idle threads, so that a ray runs to its escape, its
    tag or its K-th step; ``shadow_ray_use`` counts that loop.

The refill draws an x-uniform source's sample in the kernel, x over the
rank's slab; any other source comes as a ``SourceQueue``, the rank's share
of one batch drawn for all ranks, taken in order.

On a CUDA tensor a wrapper launches its kernel and raises if the build or
the launch fails; on a CPU tensor it runs the plain version, which draws
the same Philox numbers (event j of block kb: groups 2j and 2j + 1 at
(lane, kb, ., ``STREAM_EVENT``) under the key (seed, rank); the refill at
(lane, kb, ``STREAM_REFILL``), a revive at (lane, kb, 0,
``STREAM_SURFACE``)) and does the same float32 arithmetic in the same
order.

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
import itertools
from dataclasses import dataclass

import numpy as np
import torch

from i3rc_tpu_torch.core.rng import (
    STREAM_REFILL,
    STREAM_SURFACE,
    PhiloxKey,
    exponential_deviate,
    philox_uniforms,
    stream_uniforms,
)
from i3rc_tpu_torch.integrators.wavefront import (
    _sincos_2pi,
    f32,
    make_direction_cosines,
    rotate_direction,
)
from i3rc_tpu_torch.kernels.event_block import (
    CTA_THREADS,
    EPS6,
    _SourceParams,
    source_constants,
)

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


def sharded_events_reference(spec: ShardSpec, st: ShardState, key: PhiloxKey, kb: int) -> None:
    """K events of block ``kb`` in place on ``st`` (the event loop of SD's
    plain version)."""
    u = philox_uniforms(key, kb, spec.K, N_DRAWS, st.n_lanes, st.f.device)
    for j in range(spec.K):
        sharded_event(spec, u[j], st)


def shadow_step(spec: ShardSpec, pool: RayPool, acc_int: torch.Tensor,
                acc_byc: torch.Tensor) -> None:
    """One exact cell-DDA step of every shadow ray in flight, in place:
    the plain version of SB's step."""
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
    """The plain version of SB's ray loop: K steps of the pool in place,
    tallies added."""
    for _ in range(spec.K):
        shadow_step(spec, pool, acc_int, acc_byc)


# ---------------------------------------------------------------------------
# The whole block: SD's prologue and epilogue, and SB's pack

PHOTON_FIELDS = 8      # a migrating photon's row: x, y, z, ux, uy, uz, tau, orders (a float)
RAY_FIELDS = 6         # a migrating ray's row: x, y, z, tau, prefactor, det (a float)
DIRS = (1, -1)         # the directions of migration, in buffer order
# The counts vector (ShardBuffers.counts: a row of N_COUNTS int64 a rank,
# each rank writing its own and the others 0, so that one all_reduce sum
# gives every rank every row): whether the rank still has photons to
# launch or rows waiting in an inbox (the host's), its busy lanes (alive,
# tagged or pending) and busy pool slots (alive or tagged), its inboxes'
# space for photons and rays moving +1 and -1 (the host's), its tagged
# photons and rays of each direction, its free lanes and free pool slots.
WORK, BUSY_PH, BUSY_Q, SPACE_PH, SPACE_Q, WAIT_PH, WAIT_Q, FREE_PH, FREE_Q = (
    0, 1, 2, 3, 5, 7, 9, 11, 12)
N_COUNTS = 13
# Rows of ShardBuffers.tiles[parity], one entry a tile of CTA_THREADS lanes
# at the end of SD's launch: free lanes (not alive, tagged or pending),
# photons tagged +1 and -1, the tagged ones of the tiles below (exclusive
# prefixes), busy lanes.  The next launch's prologue ranks its lanes with
# them.
T_FREE, T_HI, T_LO, T_PRE_HI, T_PRE_LO, T_BUSY = range(6)
N_TILE_ROWS = 6
STATUS_INTS = 16       # a tile's look-back record (csrc SHARD_STATUS_INTS)


@dataclass
class ShardBuffers:
    """The block's buffers besides the lane state and the pool, on the
    rank's device.  Each direction's rows are [0] for +1 and [1] for -1;
    a parity is kb & 1 (what a launch reads) or (kb + 1) & 1 (what it
    writes for the next)."""

    send_ph: torch.Tensor    # (2, 2, CAP, 8) float32: [parity, direction] photons to send
    send_q: torch.Tensor     # (2, CAP, 6) float32: rays to send
    recv_ph: torch.Tensor    # (2, CAP, 8) float32: photons received
    recv_q: torch.Tensor     # (2, CAP, 6) float32: rays received
    inbox_ph: torch.Tensor   # (2, 2, INBOX, 8) float32: [parity, direction] rows waiting
    inbox_q: torch.Tensor    # (2, 2, INBOX, 6) float32
    tag_q: torch.Tensor      # (2, CAP) int32: the pool slot of each ray in send_q
    free_q: torch.Tensor     # (R,) int32: the free pool slots in slot order
    tiles: torch.Tensor      # (2, N_TILE_ROWS, n_tiles) int32: [parity]
    status: torch.Tensor     # (2, n_tiles, STATUS_INTS) int32: SD's, SB's look-back (+ done marks)
    ctl: torch.Tensor        # (4,) int32: SD's tickets and finished tiles, SB's tickets
    counts: torch.Tensor     # (n_ranks, N_COUNTS) int64
    columns: torch.Tensor    # (n_cols, 3) float64 flux tallies: up, down, absorbed
    vol: torch.Tensor        # (n_cols * n_z,) float64 volume tally, or (0,)
    rank: int
    self_exchange: bool      # a world of one: the rows sent are the rows received

    @property
    def cap(self) -> int:
        return self.send_ph.shape[2]

    def clone(self) -> "ShardBuffers":
        return ShardBuffers(*(getattr(self, k).clone() for k in (
            "send_ph", "send_q", "recv_ph", "recv_q", "inbox_ph", "inbox_q", "tag_q", "free_q",
            "tiles", "status", "ctl", "counts", "columns", "vol")), self.rank, self.self_exchange)


def shard_buffers(spec: ShardSpec, n_lanes: int, cap: int, inbox: int, n_ranks: int, rank: int,
                  volume: bool, device) -> ShardBuffers:
    """The buffers of a trace before its first block: every lane and pool
    slot free, nothing tagged or waiting, this rank's row of the counts
    vector as the host knows it (work; the inboxes' space CAP)."""
    L, D = n_lanes, spec.n_dirs
    R = L if D else 0
    n_tiles = -(-L // CTA_THREADS)
    z32 = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)
    tiles = i32(2, N_TILE_ROWS, n_tiles)
    tiles[0, T_FREE] = torch.clamp(L - CTA_THREADS * torch.arange(n_tiles, device=device),
                                   max=CTA_THREADS).to(torch.int32)
    counts = torch.zeros(n_ranks, N_COUNTS, dtype=torch.int64, device=device)
    counts[rank, SPACE_PH:SPACE_PH + 2] = cap
    counts[rank, SPACE_Q:SPACE_Q + 2] = cap
    counts[rank, FREE_PH], counts[rank, FREE_Q] = L, R
    n_cols = spec.nx_loc * spec.n_y
    return ShardBuffers(
        send_ph=z32(2, 2, cap, PHOTON_FIELDS), send_q=z32(2, cap, RAY_FIELDS),
        recv_ph=z32(2, cap, PHOTON_FIELDS), recv_q=z32(2, cap, RAY_FIELDS),
        inbox_ph=z32(2, 2, inbox, PHOTON_FIELDS), inbox_q=z32(2, 2, inbox, RAY_FIELDS),
        tag_q=i32(2, cap), free_q=torch.arange(R, dtype=torch.int32, device=device),
        tiles=tiles, status=i32(2, n_tiles, STATUS_INTS), ctl=i32(4), counts=counts,
        columns=torch.zeros(n_cols, 3, dtype=torch.float64, device=device),
        vol=torch.zeros(spec.n_loc_cells if volume else 0, dtype=torch.float64, device=device),
        rank=rank, self_exchange=n_ranks == 1)


@dataclass(frozen=True)
class SourceQueue:
    """A rank's photons of a source that is not uniform in x: ``rows`` (n, 6)
    float32 x, y, z, ux, uy, uz, the photons of one batch drawn for every
    rank whose x falls in this rank's slab, in batch order.  The refill
    takes them in that order (``BlockPlan.q_at`` the first of a block)."""

    rows: torch.Tensor


@dataclass(frozen=True)
class BlockPlan:
    """What the host decided for one block from the counts vector (every
    rank decides the same for the rows between two ranks): per direction
    (+1, -1) the photons and rays this rank sent (the first ones of its send
    buffers), the rows waiting in its inboxes and received, and how many of
    them take a free lane or pool slot; the refill's photons (from a
    source queue, its rows from ``q_at`` on), how many pending records the
    pool's free slots take, and the host's entries of the next counts vector
    (work left, the inboxes' space after the block)."""

    sent_ph: tuple = (0, 0)
    sent_q: tuple = (0, 0)
    n_in_ph: tuple = (0, 0)
    n_rx_ph: tuple = (0, 0)
    placed_ph: tuple = (0, 0)
    n_in_q: tuple = (0, 0)
    n_rx_q: tuple = (0, 0)
    placed_q: tuple = (0, 0)
    n_new: int = 0
    drain_cap: int = 0
    work: int = 0
    space_ph: tuple = (0, 0)
    space_q: tuple = (0, 0)
    q_at: int = 0


def received(bufs: ShardBuffers, kb: int) -> tuple:
    """The photons' and rays' receive buffers of block kb: a world of one
    receives what it sent at the end of block kb - 1."""
    if bufs.self_exchange:
        return bufs.send_ph[kb & 1], bufs.send_q
    return bufs.recv_ph, bufs.recv_q


def surface_prefactors(spec: ShardSpec, albedo: float) -> torch.Tensor:
    """A reflecting bottom hit's record: A / pi toward the upward detectors
    only (monteCarloRadiativeTransfer.f95:1473-1480)."""
    return torch.where(spec.det[:, 2] > 0.0, f32(albedo / np.pi), 0.0)


def _tile_sums(flag: torch.Tensor, n_tiles: int) -> torch.Tensor:
    pad = torch.zeros(n_tiles * CTA_THREADS, dtype=torch.int32, device=flag.device)
    pad[:flag.numel()] = flag.to(torch.int32)
    return pad.view(n_tiles, CTA_THREADS).sum(1, dtype=torch.int32)


def sharded_block_reference(spec: ShardSpec, st: ShardState, pool: RayPool, bufs: ShardBuffers,
                            plan: BlockPlan, key: PhiloxKey, kb: int, source,
                            albedo: float) -> None:
    """SD's plain version: one whole block ``kb`` on one rank, in place:
    ``block_prologue_reference``, the K events
    (``sharded_events_reference``) and ``block_epilogue_reference``."""
    block_prologue_reference(spec, st, pool, bufs, plan, key, kb, source)
    sharded_events_reference(spec, st, key, kb)
    block_epilogue_reference(spec, st, pool, bufs, plan, key, kb, albedo)


def block_prologue_reference(spec: ShardSpec, st: ShardState, pool: RayPool,
                             bufs: ShardBuffers, plan: BlockPlan, key: PhiloxKey, kb: int,
                             source) -> None:
    """The prologue of SD's plain version. The rows the host sent after the last block leave
    (the first ``plan.sent_ph`` tagged photons of each direction in lane order clear their
    tags; the rays of ``tag_q``'s first ``plan.sent_q`` clear tag and slot); the rows that
    arrive in each direction (the inbox's waiting rows, then the received ones) take, +1
    before -1, the pool's free slots in the order of the last pack (rays) and the free lanes
    in lane order (photons), the rest waiting in the next parity's inbox; then the FIFO
    refill of the next ``plan.n_new`` free lanes with the source sample at (lane, kb,
    ``STREAM_REFILL``), or from a ``SourceQueue`` its rows from ``plan.q_at`` on."""
    f, iv = st.f, st.i
    qf, qi = pool.f, pool.i
    D, dev = spec.n_dirs, f.device
    par, npar = kb & 1, (kb + 1) & 1
    recv_ph, recv_q = received(bufs, kb)
    for k, dirn in enumerate(DIRS):
        iv[TAG, (iv[TAG] == dirn).nonzero()[:, 0][:plan.sent_ph[k]]] = 0
        if D:
            slots = bufs.tag_q[k, :plan.sent_q[k]].long()
            qi[QTAG, slots] = 0
            qi[QALIVE, slots] = 0
    if D:
        at = 0
        for k in range(2):
            rows = torch.cat([bufs.inbox_q[par, k, :plan.n_in_q[k]], recv_q[k, :plan.n_rx_q[k]]])
            n = plan.placed_q[k]
            slots = bufs.free_q[at:at + n].long()
            qf[:, slots] = rows[:n, :5].t()
            qi[QDET, slots] = rows[:n, 5].to(torch.int32)
            qi[QALIVE, slots] = 1
            bufs.inbox_q[npar, k, :rows.shape[0] - n] = rows[n:]
            at += n
    free = ((iv[ALIVE] == 0) & (iv[TAG] == 0) & (iv[PEND] == 0)).nonzero()[:, 0]
    at = 0
    for k in range(2):
        rows = torch.cat([bufs.inbox_ph[par, k, :plan.n_in_ph[k]], recv_ph[k, :plan.n_rx_ph[k]]])
        n = plan.placed_ph[k]
        lanes = free[at:at + n]
        f[:TAU + 1, lanes] = rows[:n, :TAU + 1].t()
        iv[ORDERS, lanes] = rows[:n, TAU + 1].to(torch.int32)
        iv[ALIVE, lanes] = 1
        bufs.inbox_ph[npar, k, :rows.shape[0] - n] = rows[n:]
        at += n
    lanes = free[at:at + plan.n_new]
    if lanes.numel() and isinstance(source, SourceQueue):
        f[:UZ + 1, lanes] = source.rows[plan.q_at:plan.q_at + lanes.numel()].t()
        f[TAU, lanes] = 0.0
        iv[ORDERS, lanes] = 0
        iv[ALIVE, lanes] = 1
    elif lanes.numel():
        b = source.sample(key, lanes.numel(), dev, stream=STREAM_REFILL, block=kb, lanes=lanes)
        ux, uy, uz = make_direction_cosines(b.mu, b.phi)
        f[X, lanes] = spec.x_lo + b.x * f32(spec.x_hi - spec.x_lo)
        f[Y, lanes] = spec.y0 + b.y * spec.wy
        f[Z, lanes] = spec.z0 + b.z * f32(spec.z_max - spec.z0)
        f[UX, lanes], f[UY, lanes], f[UZ, lanes] = ux, uy, uz
        f[TAU, lanes] = 0.0
        iv[ORDERS, lanes] = 0
        iv[ALIVE, lanes] = 1


def block_epilogue_reference(spec: ShardSpec, st: ShardState, pool: RayPool,
                             bufs: ShardBuffers, plan: BlockPlan, key: PhiloxKey, kb: int,
                             albedo: float) -> None:
    """The epilogue of SD's plain version: the flush of the block's exits and deaths into the
    float64 column (and volume) tallies; over a reflecting surface each bottom hit's record
    (with detectors) and its Bernoulli revive at (lane, kb, 0, ``STREAM_SURFACE``); pk
    cleared; with detectors the drain of the first ``plan.drain_cap`` pending records, in
    lane order, into the free slots after the placed rays, D slots a record; the first CAP
    tagged photons of each direction, in lane order, into the next parity's send buffer; the
    tile counts for the next prologue, and this rank's row of the counts vector (its photon
    side and the host's entries)."""
    f, iv = st.f, st.i
    qf, qi = pool.f, pool.i
    D, dev = spec.n_dirs, f.device
    npar = (kb + 1) & 1
    e = (iv[PK] != 0).nonzero()[:, 0]
    if e.numel():
        pk = iv[PK][e].long()
        ix, iy, iz = _cell_index(spec, f[X][e], f[Y][e], f[Z][e])
        col = ix.long() * spec.n_y + iy.long()
        bufs.columns.index_put_((col, pk - 1), torch.ones(e.numel(), dtype=torch.float64,
                                                           device=dev), accumulate=True)
        if bufs.vol.numel():
            dead = pk == 3
            bufs.vol.index_add_(0, col[dead] * spec.n_z + iz[dead].long(),
                                torch.ones(int(dead.sum()), dtype=torch.float64, device=dev))
    h = (iv[PK] == 2).nonzero()[:, 0]
    if albedo > 0.0 and h.numel():
        if D:
            f[PEND_PF:, h] = surface_prefactors(spec, albedo)[:, None]
            iv[PEND_SRF, h] = 1
            iv[PEND, h] = 1
        u = stream_uniforms(key, STREAM_SURFACE, kb, 1, h.numel(), dev, h)
        up = u[0] < f32(albedo)
        rev, u = h[up], u[:, up]
        mu = torch.clamp(torch.sqrt(u[1]), min=EPS6)
        sin_t = torch.sqrt(torch.clamp(1.0 - u[1], min=0.0))
        s_az, c_az = _sincos_2pi(u[2])
        f[UX, rev], f[UY, rev], f[UZ, rev] = sin_t * c_az, sin_t * s_az, mu
        f[Z, rev] = f32(spec.z0 + spec.nudge)
        f[TAU, rev] = 0.0
        iv[ORDERS, rev] += 1
        iv[ALIVE, rev] = 1
    iv[PK] = 0
    if D:
        can = (iv[PEND] != 0).nonzero()[:, 0][:plan.drain_cap]
        if can.numel():
            base = plan.placed_q[0] + plan.placed_q[1]
            slots = bufs.free_q[base:base + can.numel() * D].long().view(-1, D)
            dets = torch.arange(D, dtype=torch.int32, device=dev)
            for r in (X, Y, Z):
                qf[r, slots] = f[r, can][:, None]
            qf[QTAU, slots] = 0.0
            qf[QPF, slots] = f[PEND_PF:, can].t()
            det = torch.where(iv[PEND_SRF, can][:, None] != 0, dets[None, :],
                              (iv[PEND_COMP, can][:, None] + 1) * D + dets[None, :])
            qi[QDET, slots] = det.to(torch.int32)
            qi[QALIVE, slots] = 1
            iv[PEND, can] = 0
    for k, dirn in enumerate(DIRS):
        idx = (iv[TAG] == dirn).nonzero()[:, 0][:bufs.cap]
        bufs.send_ph[npar, k, :idx.numel()] = torch.cat(
            [f[:TAU + 1, idx], iv[ORDERS, idx][None].to(torch.float32)]).t()
    busy = (iv[ALIVE] != 0) | (iv[TAG] != 0) | (iv[PEND] != 0)
    n_tiles = bufs.tiles.shape[2]
    t = bufs.tiles[npar]
    t[T_FREE] = _tile_sums(~busy, n_tiles)
    t[T_HI] = _tile_sums(iv[TAG] == 1, n_tiles)
    t[T_LO] = _tile_sums(iv[TAG] == -1, n_tiles)
    t[T_PRE_HI] = torch.cumsum(t[T_HI], 0, dtype=torch.int32) - t[T_HI]
    t[T_PRE_LO] = torch.cumsum(t[T_LO], 0, dtype=torch.int32) - t[T_LO]
    t[T_BUSY] = _tile_sums(busy, n_tiles)
    c = bufs.counts
    c.zero_()
    row = c[bufs.rank]
    row[WORK] = plan.work
    row[BUSY_PH] = busy.sum()
    row[SPACE_PH], row[SPACE_PH + 1] = plan.space_ph
    row[SPACE_Q], row[SPACE_Q + 1] = plan.space_q
    row[WAIT_PH], row[WAIT_PH + 1] = t[T_HI].sum(), t[T_LO].sum()
    row[FREE_PH] = t[T_FREE].sum()


def shadow_pack_reference(spec: ShardSpec, pool: RayPool, bufs: ShardBuffers) -> None:
    """The plain version of SB's pack, after its steps: the pool's free
    slots in slot order into ``free_q``; the first CAP tagged rays of each
    direction, in slot order, into ``send_q`` (their slots into ``tag_q``);
    this rank's row of the counts vector, its ray side."""
    qf, qi = pool.f, pool.i
    free = ((qi[QALIVE] == 0) & (qi[QTAG] == 0)).nonzero()[:, 0]
    bufs.free_q[:free.numel()] = free.to(torch.int32)
    row = bufs.counts[bufs.rank]
    for k, dirn in enumerate(DIRS):
        tagged = qi[QTAG] == dirn
        idx = tagged.nonzero()[:, 0][:bufs.cap]
        bufs.send_q[k, :idx.numel()] = torch.cat(
            [qf[:, idx], qi[QDET, idx][None].to(torch.float32)]).t()
        bufs.tag_q[k, :idx.numel()] = idx.to(torch.int32)
        row[WAIT_Q + k] = tagged.sum()
    row[BUSY_Q] = ((qi[QALIVE] != 0) | (qi[QTAG] != 0)).sum()
    row[FREE_Q] = free.numel()


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
        (n, ctypes.c_uint32) for n in ("key0", "key1", "kb")] + [
        (n, ctypes.c_void_p) for n in ("pool_f", "pool_i", "send_ph", "send_q", "recv_ph",
                                       "recv_q", "inbox_ph", "inbox_q", "tag_q", "free_q",
                                       "tiles", "status", "ctl", "counts", "columns", "vol",
                                       "surf_pf")] + [
        (n, ctypes.c_int) for n in ("n_rays", "cap", "inbox", "rank", "n_ranks", "epoch",
                                    "vol_on", "surface")] + [
        (n, ctypes.c_int * 2) for n in ("sent_ph", "sent_q", "n_in_ph", "n_rx_ph", "placed_ph",
                                        "n_in_q", "n_rx_q", "placed_q")] + [
        (n, ctypes.c_int) for n in ("n_new", "drain_cap", "work")] + [
        (n, ctypes.c_int * 2) for n in ("space_ph", "space_q")] + [
        (n, ctypes.c_float) for n in ("albedo", "z_revive")] + [("src", _SourceParams)] + [
        ("src_q", ctypes.c_void_p), ("q_at", ctypes.c_longlong)]


@functools.lru_cache(maxsize=None)
def build():
    """Compile (or reuse) SD's and SB's library
    (``csrc/sharded_event_block.cu``, one ``nvcc`` process) and declare its
    C interface."""
    from i3rc_tpu_torch.kernels.build import build as _build

    built = _build("sharded_event_block", ("sharded_event_block.cu",))
    declare(built.lib)
    return built


def declare(lib) -> None:
    """Declare the library's C interface (its ShardParams must be this
    module's)."""
    vp = ctypes.c_void_p
    lib.i3rc_sharded_params_size.argtypes = []
    lib.i3rc_sharded_params_size.restype = ctypes.c_int
    lib.i3rc_sharded_event_block.argtypes = [vp, vp, vp, vp]
    lib.i3rc_sharded_event_block.restype = ctypes.c_int
    lib.i3rc_shadow_block.argtypes = [vp, vp, vp]
    lib.i3rc_shadow_block.restype = ctypes.c_int
    if lib.i3rc_sharded_params_size() != ctypes.sizeof(_ShardParams):
        raise RuntimeError("ShardParams layout differs between Python and CUDA")


def _need(t, device, dtype, shape, what: str) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"sharded block: {what} must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on the state's device")


def shard_params(spec: ShardSpec, n_lanes: int, key: PhiloxKey, kb: int,
                 acc_int=None, acc_byc=None) -> _ShardParams:
    """The kernels' by-value parameter block without the block's buffers
    and plan, which ``_block_params`` and ``_shadow_params`` add."""
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


# A look-back record's epoch: unique to a launch in this process, so that a
# record left by an earlier launch (of this trace, or of a copy of its
# buffers) reads as not yet written.
_EPOCHS = itertools.count(1)


def _held_params(bufs: ShardBuffers, kernel: str, tag: tuple, make) -> _ShardParams:
    """A kernel's parameter block kept on the buffers while the objects of
    ``tag`` (compared by identity, the last by value) stay the same; else
    ``make()``'s.  Each launch then sets its own fields and a new epoch."""
    if not hasattr(bufs, "_params"):
        bufs._params = {}
    held = bufs._params.get(kernel)
    if held is None or held[0][-1] != tag[-1] or not all(
            x is y for x, y in zip(held[0][:-1], tag[:-1])):
        held = bufs._params[kernel] = (tag, make())
    p = held[1]
    p.epoch = next(_EPOCHS) % (1 << 29) or next(_EPOCHS)
    return p


def _block_params(spec: ShardSpec, st: ShardState, pool: RayPool, bufs: ShardBuffers,
                  plan: BlockPlan, key: PhiloxKey, kb: int, source,
                  albedo: float) -> _ShardParams:
    """SD's parameter block: the buffers (made and checked at the trace's
    first launch and kept on the buffers while the tensors, source and
    surface stay the same), and this launch's block, key, epoch, receive
    buffers and plan."""
    p = _held_params(bufs, "block", (spec, st.f, st.i, pool.f, pool.i, source, albedo),
                     lambda: _static_params(spec, st, pool, bufs, source, albedo))
    p.key0, p.key1 = key.seed & 0xFFFFFFFF, key.batch & 0xFFFFFFFF
    p.kb = kb & 0xFFFFFFFF
    recv_ph, recv_q = received(bufs, kb)
    p.recv_ph, p.recv_q = recv_ph.data_ptr(), recv_q.data_ptr()
    for n in ("sent_ph", "sent_q", "n_in_ph", "n_rx_ph", "placed_ph", "n_in_q", "n_rx_q",
              "placed_q", "space_ph", "space_q"):
        getattr(p, n)[:] = list(getattr(plan, n))
    p.n_new, p.drain_cap, p.work = plan.n_new, plan.drain_cap, plan.work
    p.q_at = plan.q_at
    return p


def _static_params(spec: ShardSpec, st: ShardState, pool: RayPool, bufs: ShardBuffers, source,
                   albedo: float) -> _ShardParams:
    """The parts of SD's parameter block that stay for a trace, after the
    checks of every buffer."""
    dev = bufs.ctl.device
    L, D = st.n_lanes, spec.n_dirs
    cap, box = bufs.cap, bufs.inbox_ph.shape[2]
    R = pool.n_rays
    n_tiles = -(-L // CTA_THREADS)
    n_vol = spec.n_loc_cells if bufs.vol.shape[0] else 0
    _check_spec(spec, dev)
    if D and R != L:
        raise ValueError("sharded block: the pool holds a slot a lane")
    for t, dtype, shape, what in (
            (st.f, torch.float32, (PEND_PF + D, L), "the state's f"),
            (st.i, torch.int32, (9, L), "the state's i"),
            (pool.f, torch.float32, (5, R), "the pool's f"),
            (pool.i, torch.int32, (4, R), "the pool's i"),
            (bufs.send_ph, torch.float32, (2, 2, cap, PHOTON_FIELDS), "send_ph"),
            (bufs.send_q, torch.float32, (2, cap, RAY_FIELDS), "send_q"),
            (bufs.recv_ph, torch.float32, (2, cap, PHOTON_FIELDS), "recv_ph"),
            (bufs.recv_q, torch.float32, (2, cap, RAY_FIELDS), "recv_q"),
            (bufs.inbox_ph, torch.float32, (2, 2, box, PHOTON_FIELDS), "inbox_ph"),
            (bufs.inbox_q, torch.float32, (2, 2, box, RAY_FIELDS), "inbox_q"),
            (bufs.tag_q, torch.int32, (2, cap), "tag_q"),
            (bufs.free_q, torch.int32, (R,), "free_q"),
            (bufs.tiles, torch.int32, (2, N_TILE_ROWS, n_tiles), "tiles"),
            (bufs.status, torch.int32, (2, n_tiles, STATUS_INTS), "status"),
            (bufs.ctl, torch.int32, (4,), "ctl"),
            (bufs.counts, torch.int64, (bufs.counts.shape[0], N_COUNTS), "counts"),
            (bufs.columns, torch.float64, (spec.nx_loc * spec.n_y, 3), "columns"),
            (bufs.vol, torch.float64, (n_vol,), "vol")):
        _need(t, dev, dtype, shape, what)
    p = shard_params(spec, L, PhiloxKey(0, 0), 0)
    ptr = lambda t: t.data_ptr() if t.shape[-1] else None
    p.pool_f, p.pool_i = ptr(pool.f), ptr(pool.i)
    p.send_ph, p.send_q = bufs.send_ph.data_ptr(), bufs.send_q.data_ptr()
    p.inbox_ph, p.inbox_q = bufs.inbox_ph.data_ptr(), bufs.inbox_q.data_ptr()
    p.tag_q, p.free_q, p.tiles = bufs.tag_q.data_ptr(), ptr(bufs.free_q), bufs.tiles.data_ptr()
    p.status, p.ctl = bufs.status[0].data_ptr(), bufs.ctl.data_ptr()
    p.counts, p.columns, p.vol = bufs.counts.data_ptr(), bufs.columns.data_ptr(), ptr(bufs.vol)
    p.n_rays, p.cap, p.inbox = R, cap, box
    p.rank, p.n_ranks = bufs.rank, bufs.counts.shape[0]
    p.vol_on = int(n_vol > 0)
    # The source's constants and the surface's prefactors (their making
    # reads device values back), kept with the parameter block.
    p.surface = int(albedo > 0.0)
    if p.surface and D:
        bufs._surf_pf = surface_prefactors(spec, albedo).contiguous()
        p.surf_pf = bufs._surf_pf.data_ptr()
    p.albedo, p.z_revive = f32(albedo), f32(spec.z0 + spec.nudge)
    if isinstance(source, SourceQueue):
        # The refill reads the queue's rows in place of the source sample.
        _need(source.rows, dev, torch.float32, (source.rows.shape[0], 6), "the source queue")
        p.src_q = source.rows.data_ptr() if source.rows.shape[0] else None
        return p
    for n, v in source_constants(source, dev).items():
        if n == "dir":
            p.src.dir[:] = v
        else:
            setattr(p.src, n, v)
    # The refill's scaling, the plain version's: x over the slab.
    p.src.x0, p.src.wx = spec.x_lo, f32(spec.x_hi - spec.x_lo)
    p.src.y0, p.src.wy = spec.y0, spec.wy
    p.src.z0, p.src.wz = spec.z0, f32(spec.z_max - spec.z0)
    return p


def _shadow_params(spec: ShardSpec, pool: RayPool, bufs: ShardBuffers, acc_int: torch.Tensor,
                   acc_byc: torch.Tensor) -> _ShardParams:
    """SB's parameter block: made and checked at the trace's first launch
    and kept on the buffers while the tensors stay the same; a launch sets
    its epoch."""
    def make() -> _ShardParams:
        dev = bufs.ctl.device
        R, D, C, cap = pool.n_rays, spec.n_dirs, spec.n_comp, bufs.cap
        n_cols = spec.nx_loc * spec.n_y
        _check_spec(spec, dev)
        for t, dtype, shape, what in (
                (pool.f, torch.float32, (5, R), "the pool's f"),
                (pool.i, torch.int32, (4, R), "the pool's i"),
                (acc_int, torch.float64, (n_cols * D,), "acc_int"),
                (acc_byc, torch.float64, (n_cols * D * (C + 1),), "acc_byc"),
                (bufs.send_q, torch.float32, (2, cap, RAY_FIELDS), "send_q"),
                (bufs.tag_q, torch.int32, (2, cap), "tag_q"),
                (bufs.free_q, torch.int32, (R,), "free_q"),
                (bufs.status, torch.int32, (2, -(-R // CTA_THREADS), STATUS_INTS), "status"),
                (bufs.ctl, torch.int32, (4,), "ctl"),
                (bufs.counts, torch.int64, (bufs.counts.shape[0], N_COUNTS), "counts")):
            _need(t, dev, dtype, shape, what)
        p = shard_params(spec, R, PhiloxKey(0, 0), 0, acc_int, acc_byc)
        p.pool_f, p.pool_i = pool.f.data_ptr(), pool.i.data_ptr()
        p.send_q, p.tag_q, p.free_q = (bufs.send_q.data_ptr(), bufs.tag_q.data_ptr(),
                                       bufs.free_q.data_ptr())
        p.status, p.ctl = bufs.status[1].data_ptr(), bufs.ctl[2:].data_ptr()
        p.counts = bufs.counts.data_ptr()
        p.n_rays, p.cap = R, cap
        p.rank, p.n_ranks = bufs.rank, bufs.counts.shape[0]
        return p

    return _held_params(bufs, "shadow", (spec, pool.f, pool.i, acc_int, acc_byc, None), make)


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


def sharded_event_block(spec: ShardSpec, st: ShardState, pool: RayPool, bufs: ShardBuffers,
                        plan: BlockPlan, key: PhiloxKey, kb: int, source,
                        albedo: float) -> None:
    """One whole block ``kb`` in place on ``st``, ``pool`` and ``bufs``
    (see ``sharded_block_reference``).  On CUDA tensors one launch of SD,
    counted in ``sharded_event_block.launches``; on CPU tensors
    ``sharded_block_reference``."""
    dev = st.f.device
    if dev.type == "cpu":
        sharded_block_reference(spec, st, pool, bufs, plan, key, kb, source, albedo)
        return
    if dev.type != "cuda":
        raise NotImplementedError(f"sharded_event_block: no kernel for device {dev}")
    p = _block_params(spec, st, pool, bufs, plan, key, kb, source, albedo)
    with torch.cuda.device(dev):
        rc = build().lib.i3rc_sharded_event_block(st.f.data_ptr(), st.i.data_ptr(),
                                                  ctypes.byref(p), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"sharded_event_block launch: CUDA error {rc}")
    sharded_event_block.launches += 1


def shadow_block(spec: ShardSpec, pool: RayPool, bufs: ShardBuffers, acc_int: torch.Tensor,
                 acc_byc: torch.Tensor) -> None:
    """K DDA steps of every shadow ray in flight, then the pool's pack, in
    place on ``pool``, ``bufs`` and the float64 tallies (see
    ``shadow_advance_reference`` and ``shadow_pack_reference``).  On CUDA
    tensors one launch of SB, counted in ``shadow_block.launches``, its ray
    loop in ``shadow_ray_use``; on CPU tensors the two plain versions."""
    dev = pool.f.device
    if dev.type == "cpu":
        shadow_advance_reference(spec, pool, acc_int, acc_byc)
        shadow_pack_reference(spec, pool, bufs)
        return
    if dev.type != "cuda":
        raise NotImplementedError(f"shadow_block: no kernel for device {dev}")
    if spec.n_dirs < 1:
        raise ValueError("shadow_block: the plan has no detectors")
    p = _shadow_params(spec, pool, bufs, acc_int, acc_byc)
    with torch.cuda.device(dev):
        rc = build().lib.i3rc_shadow_block(ctypes.byref(p), shadow_ray_use(dev).data_ptr(),
                                           _stream(dev))
    if rc != 0:
        raise RuntimeError(f"shadow_block launch: CUDA error {rc}")
    shadow_block.launches += 1


# SB's runs of tiles a CTA, at most, and the radiance bins (acc_int's and
# acc_byc's) its CTA sums in shared memory, at most (csrc SB_MAX_TILES,
# SB_SMEM_BINS).
SHADOW_MAX_TILES = 8
SHADOW_SMEM_BINS = 512
# SB's ray-loop counts (csrc SB_USE_*), by entry.
SHADOW_USE = ("rays", "steps", "slots", "runs")
_SHADOW_USE = {}


def shadow_ray_use(device) -> torch.Tensor:
    """int64 (4,) on ``device``: SB's ray loop since
    ``reset_launch_counters``, as ``SHADOW_USE`` names its entries: the rays
    in flight it took, their steps, the thread slots of the warps' trips
    (32 a trip; steps / slots is the loop's lane use) and the CTAs (runs of
    tiles) it ran; a diagnostic of the card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _SHADOW_USE:
        with torch.inference_mode(False):
            _SHADOW_USE[dev] = torch.zeros(len(SHADOW_USE), dtype=torch.int64, device=dev)
    return _SHADOW_USE[dev]


def reset_launch_counters() -> None:
    sharded_event_block.launches = 0
    shadow_block.launches = 0
    for t in _SHADOW_USE.values():
        t.zero_()


reset_launch_counters()
