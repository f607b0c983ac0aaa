"""Sharded-domain tracing: an x-decomposed domain with photon migration.

Port of ``i3rc_tpu/parallel/sharded_domain.py``.  The reference replicates
the whole domain on every rank (monteCarloDriver.f95:159; its wishlist
flags the memory, Wishlist.txt:43-49).  Here the domain is decomposed along
x over the ranks of a ``parallel.mesh.Mesh``: rank r holds only its x-slab
of the per-cell matrix ``[total_ext | cum_1..C | ssa_1..C | row_1..C]`` (the
getOpticalPropertiesByComponent flattening, opticalProperties.f95:429-539;
``row_c`` the cell's entry row in the replicated tables); the cubic
inverse-CDF fits (``tables.build_inverse_cubic``) and, with detectors, the
log-cubic forward fits are replicated.  Transport is maximum cross-section
under the global majorant: a flight that would leave the slab stops at its
x face and the photon migrates to the neighbouring rank with its remaining
optical depth, so no rank ever reads another's optics.  Collisions pick
their component by cumulative extinction; absorption is Bernoulli survival;
a Lambertian surface revives a bottom hit with probability A and a cosine
draw (the hit is tallied in Fdn first, so with A > 0 Fdn counts every hit);
with ``compute_volume_absorption`` a death lands in its exact cell.

Radiance detectors: every physical collision freezes its lane (``pend``)
with the prefactors w ssa_c P_c(cos Theta) / (4 pi |mu_d|) (the local
estimate of monteCarloRadiativeTransfer.f95:1419-1510 under this tracer's
weight-1 scheme), and a reflecting bottom hit with A / pi toward the upward
detectors, until the rank's shadow-ray pool has D free slots; the shadow
rays accumulate the exact line integral of extinction cell by cell
(:1512-1535), migrate across slab faces with their optical depth, and
tally w exp(-tau) at their exit column (total and by component slot: 0 the
surface, 1 + c component c).

Each block of the loop, on each rank (the JAX body's steps from its
migration on, so that a block's migrants are known when it starts):
  1. lossless receiver-granted migration of shadow rays and photons: one
     ``all_reduce`` tells every rank each rank's inbox space (at most
     ``CAP`` a kind and direction), its migrants waiting and whether it
     still has work; each sender sends min(waiting, the receiver's space)
     of each kind, in lane order (unsent migrants keep their tag and try
     again next block), and received ones fill free lanes in lane order,
     the rest waiting in the inbox;
  2. the refill of dead lanes from the rank's photon budget, keeping
     ``RESERVE`` lanes free for immigrants;
  3. ``kernels.sharded_block.sharded_event_block`` (SD: K events a lane);
  4. the flush of the block's exits into the local float64 column
     tallies (``index_put_``), the surface records and revive;
  5. with detectors the emission drain into the pool (lane-order
     compaction), then ``kernels.sharded_block.shadow_advance`` (SR: K exact
     cell-DDA steps a ray).
The loop ends when no rank has anything in flight, or at the block cap.

In the JAX package every ``jax.lax.ppermute`` is a ring shift along the
mesh axis.  Here each block makes that one ``all_reduce`` and one
``dist.batch_isend_irecv`` step carrying each direction's photons and
rays to the neighbour in one message of the size both ends computed from
the ``all_reduce``.  With NCCL the buffers stay on the
device; with gloo (the CPU, or ranks that share one GPU) they are staged
through pinned host memory.  The backend of the mesh's group decides; the
algorithm is the same.  A world of one exchanges with itself in memory.

Random streams: every rank draws from the Philox key (seed, rank), where
the JAX package folds the rank into its key (``fold_in(key, me)``,
sharded_domain.py:411, :642, :658): events at (lane, kb, group,
``STREAM_EVENT``), refills at ``STREAM_REFILL`` and surface revives at
``STREAM_SURFACE`` (core/rng.py).  Ranks are independent streams; a result
depends on the rank count only statistically.

Departures from the JAX tracer: the event budget ends only lanes still in
flight (JAX also counts a lane that dies or leaves on its last allowed
event as bad, and tallies it); a tracer needs an x-uniform source (JAX
samples each slab's share of any source in the slab).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from i3rc_tpu_torch.core.optics import flatten_optics
from i3rc_tpu_torch.core.rng import STREAM_REFILL, STREAM_SURFACE, PhiloxKey, stream_uniforms
from i3rc_tpu_torch.integrators.tables import build_forward_cubic, build_inverse_cubic
from i3rc_tpu_torch.integrators.wavefront import (
    RawTallies,
    _sincos_2pi,
    f32,
    make_direction_cosines,
)
from i3rc_tpu_torch.kernels import sharded_block as sb
from i3rc_tpu_torch.kernels.sharded_block import (
    ALIVE,
    BAD,
    ORDERS,
    PEND,
    PEND_COMP,
    PEND_PF,
    PEND_SRF,
    PK,
    QALIVE,
    QDET,
    QPF,
    QTAG,
    QTAU,
    TAG,
    TAU,
    RayPool,
    ShardSpec,
    ShardState,
)
from i3rc_tpu_torch.parallel.mesh import Mesh, all_reduce_sum

X_UNIFORM_SOURCES = ("directional", "random_azimuth", "flux_weighted")
PHOTON_FIELDS = 8      # x, y, z, ux, uy, uz, tau, orders
RAY_FIELDS = 6         # x, y, z, tau, prefactor, det


def shardable(domain, mesh: Mesh) -> bool:
    """Can the sharded tracer run this domain on the mesh?  Any optics on
    a regular grid whose x extent divides the rank count (the scattering
    samples replicated fits, so no phase function is excluded)."""
    if not (domain.xy_regularly_spaced and domain.z_regularly_spaced):
        return False
    return domain.n_x % mesh.size == 0


def shard_plan(domain, mesh: Mesh, max_events: int = 500, unroll: int = 8,
               intensity_mus=None, intensity_phis=None) -> ShardSpec:
    """Rank ``mesh.rank``'s slab and the replicated tables, on its device."""
    if not shardable(domain, mesh):
        raise ValueError(f"sharded tracer: the domain's grid must be regular and its "
                         f"{domain.n_x} x cells must divide {mesh.size} ranks")
    n_dev, me, dev = mesh.size, mesh.rank, mesh.device
    flat = flatten_optics(domain)
    n_x, n_y, n_z = domain.grid_shape
    nx_loc = n_x // n_dev
    C = len(flat.forward_tables)
    n_cells = n_x * n_y * n_z
    ext = np.asarray(flat.total_ext, np.float32)
    max_ext = float(ext.max())
    if not max_ext > 0.0:
        raise ValueError("sharded tracer: the domain is empty")
    inv_cub = build_inverse_cubic(flat)                 # (C, max_e, n_seg, 4)
    max_entries, n_seg = inv_cub.shape[1], inv_cub.shape[2]
    rows = (np.arange(C)[None, :] * max_entries
            + np.asarray(flat.phase_index).reshape(n_cells, C))
    per = nx_loc * n_y * n_z
    lo = me * per
    cellmat = np.concatenate([
        ext.reshape(n_cells, 1)[lo:lo + per],
        np.asarray(flat.cumulative_ext, np.float32).reshape(n_cells, C)[lo:lo + per],
        np.asarray(flat.ssa, np.float32).reshape(n_cells, C)[lo:lo + per],
        rows.astype(np.float32)[lo:lo + per]], axis=1)
    D = 0 if intensity_mus is None else np.atleast_1d(intensity_mus).size
    fwd = np.zeros((0, 4), np.float32)
    det = np.zeros((0, 4), np.float32)
    n_fwd = 0
    if D:
        mus = np.asarray(intensity_mus, np.float64).ravel()
        phis = np.deg2rad(np.asarray(intensity_phis, np.float64).ravel())
        if mus.size != phis.size or np.any(np.abs(mus) <= 1e-6):
            raise ValueError("sharded tracer: detector mu must be nonzero, one phi each")
        sin_d = np.sqrt(np.maximum(1.0 - mus ** 2, 0.0))
        det = np.stack([sin_d * np.cos(phis), sin_d * np.sin(phis), mus,
                        1.0 / (4.0 * np.pi * np.abs(mus))], axis=1).astype(np.float32)
        fwd_cub = build_forward_cubic(flat)
        n_fwd = fwd_cub.shape[2]
        fwd = fwd_cub.reshape(-1, 4)
    g = np.float32
    x0, x_max = g(domain.x_edges[0]), g(domain.x_edges[-1])
    y0, y_max = g(domain.y_edges[0]), g(domain.y_edges[-1])
    z0, z_max = g(domain.z_edges[0]), g(domain.z_edges[-1])
    dx = g(domain.x_edges[1] - domain.x_edges[0])
    dy = g(domain.y_edges[1] - domain.y_edges[0])
    dz = g(domain.z_edges[1] - domain.z_edges[0])
    shard_w = g((float(x_max) - float(x0)) / n_dev)
    x_lo = g(x0 + shard_w * g(me))
    x_hi = g(x_lo + shard_w)
    nudge = g(8 * 2.0 ** -23 * max(abs(float(x0)), abs(float(x_max)), abs(float(z_max))))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    return ShardSpec(
        cells=t(cellmat), cubic=t(inv_cub.reshape(-1, 4)), fwd=t(fwd), det=t(det),
        n_comp=C, n_seg=n_seg, n_fwd=n_fwd, n_dirs=D, nx_loc=nx_loc, n_y=n_y, n_z=n_z,
        max_events=int(max_events), K=int(unroll),
        x_lo=float(x_lo), x_hi=float(x_hi), x0=float(x0), x_max=float(x_max),
        y0=float(y0), y_max=float(y_max), z0=float(z0), z_max=float(z_max),
        wx=float(g(x_max - x0)), wy=float(g(y_max - y0)),
        hi_push=float(g(x_hi + nudge)), lo_push=float(g(x_lo - nudge)),
        inv_dx=f32(1.0 / float(dx)), inv_dy=f32(1.0 / float(dy)), inv_dz=f32(1.0 / float(dz)),
        dx=float(dx), dy=float(dy), dz=float(dz), inv_max_ext=f32(1.0 / max_ext),
        max_ext=f32(max_ext), nudge=float(nudge), fwd_scale=f32(n_fwd / np.pi))


def _exchange(mesh: Mesh, sends: dict, recv_sizes: dict) -> dict:
    """One ring step: ``sends[dirn]`` (a float32 vector) goes to rank
    ``rank + dirn`` and ``recv_sizes[dirn]`` floats arrive from ``rank -
    dirn``, each size known to both ends (an empty message is not sent).
    Returns the received vectors on the mesh's device."""
    if mesh.size == 1:
        return dict(sends)
    n, me, dev = mesh.size, mesh.rank, mesh.device
    staged = mesh.backend != "nccl" and dev.type == "cuda"

    def host(t):
        if not staged:
            return t.contiguous()
        buf = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf

    ops, got = [], {}
    # Two messages to one peer (a world of two) keep their order: the tag
    # names the direction, and every rank posts +1 before -1.
    for dirn in (1, -1):
        if sends[dirn].numel():
            ops.append(dist.P2POp(dist.isend, host(sends[dirn]), (me + dirn) % n, mesh.group,
                                  tag=dirn + 2))
    for dirn in (1, -1):
        got[dirn] = torch.empty(recv_sizes[dirn], dtype=torch.float32,
                                device="cpu" if staged else dev, pin_memory=staged)
        if recv_sizes[dirn]:
            ops.append(dist.P2POp(dist.irecv, got[dirn], (me - dirn) % n, mesh.group,
                                  tag=dirn + 2))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return {d: v.to(dev) for d, v in got.items()}


def _all_gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The ranks' (n, ...) tensors stacked in rank order along dim 0."""
    if mesh.group is None:
        return t
    if mesh.backend == "nccl":
        out = [torch.empty_like(t) for _ in range(mesh.size)]
        dist.all_gather(out, t.contiguous(), group=mesh.group)
        return torch.cat(out)
    host = t.cpu().contiguous()
    out = [torch.empty_like(host) for _ in range(mesh.size)]
    dist.all_gather(out, host, group=mesh.group)
    return torch.cat(out).to(t.device)


class ShardedTrace:
    """The state of one rank's trace and its block loop (``running``,
    ``block``, ``finish``); ``trace_sharded`` drives it, ``create`` takes
    its arguments."""

    @staticmethod
    def create(domain, source, n_photons: int, mesh: Mesh, n_lanes_per_shard: int = 1 << 14,
               max_events: int = 500, unroll: int = 8, seed: int = 0,
               surface_albedo: float = 0.0, intensity_mus=None, intensity_phis=None,
               compute_volume_absorption: bool = False) -> "ShardedTrace":
        spec = shard_plan(domain, mesh, max_events, unroll, intensity_mus, intensity_phis)
        return ShardedTrace(spec, mesh, source, n_photons, seed, n_lanes_per_shard,
                            surface_albedo, compute_volume_absorption)

    def __init__(self, spec: ShardSpec, mesh: Mesh, source, n_photons: int, seed: int,
                 n_lanes: int, surface_albedo: float = 0.0, volume: bool = False):
        if source.kind not in X_UNIFORM_SOURCES:
            raise ValueError(f"sharded tracer: the source must be uniform in x "
                             f"({', '.join(X_UNIFORM_SOURCES)}); got {source.kind!r}")
        self.spec, self.mesh, self.source = spec, mesh, source
        dev = mesh.device
        L = int(n_lanes)
        D, C = spec.n_dirs, spec.n_comp
        self.CAP = max(128, L // 16)            # migrants a direction and block
        self.RESERVE = 2 * self.CAP             # free lanes kept for immigrants
        self.INBOX = 2 * self.CAP
        self.budget = -(-int(n_photons) // mesh.size)
        self.n_total = self.budget * mesh.size
        self.key = PhiloxKey(int(seed), mesh.rank)
        self.albedo = float(surface_albedo)
        # Reflected radiance A / pi toward the upward detectors only
        # (:1473-1480).
        self.surf_pf = torch.where(spec.det[:, 2] > 0.0, f32(self.albedo / np.pi), 0.0)
        max_blocks = -(-4 * spec.max_events * (self.budget // L + 2) // spec.K)
        if D:
            # Shadow rays drain at ~K cells a block; budget the extra latency.
            max_blocks = 2 * max_blocks + 4 * (spec.nx_loc + spec.n_y + spec.n_z) // spec.K
        self.max_blocks = max_blocks
        self.state = ShardState(torch.zeros(PEND_PF + D, L, device=dev),
                                torch.zeros(9, L, dtype=torch.int32, device=dev))
        self.pool = RayPool(torch.zeros(5, L, device=dev),
                            torch.zeros(4, L, dtype=torch.int32, device=dev))
        n_cols = spec.nx_loc * spec.n_y
        f64 = dict(dtype=torch.float64, device=dev)
        self.columns = torch.zeros(n_cols, 3, **f64)
        self.vol = torch.zeros(spec.n_loc_cells if volume else 0, **f64)
        self.acc_int = torch.zeros(n_cols * D, **f64)
        self.acc_byc = torch.zeros(n_cols * D * (C + 1), **f64)
        # Migrants received but not yet placed: rows x count, a direction.
        self.inbox = {d: torch.zeros(PHOTON_FIELDS, 0, device=dev) for d in (1, -1)}
        self.q_inbox = {d: torch.zeros(RAY_FIELDS, 0, device=dev) for d in (1, -1)}
        self.kb = 0
        self.launched = 0
        self.n_mig = 0
        self._plan = None
        # The two kernels a block launches (a check may wrap them).
        self.event_block = sb.sharded_event_block
        self.shadow_advance = sb.shadow_advance

    # -- the loop's end and the migration plan (one all_reduce a block) ----
    def running(self) -> bool:
        """Whether any rank has work left (and the block cap is not hit).
        Every rank also learns every rank's inbox space and waiting
        migrants, so each sender and receiver computes the same counts for
        this block's migration: min(migrants, the receiver's space), each
        kind and direction."""
        i, qi = self.state.i, self.pool.i
        flags = torch.stack([
            (i[[ALIVE, TAG, PEND]] != 0).any().to(torch.int64),
            (qi[[QALIVE, QTAG]] != 0).any().to(torch.int64),
            (i[TAG] == 1).sum(dtype=torch.int64), (i[TAG] == -1).sum(dtype=torch.int64),
            (qi[QTAG] == 1).sum(dtype=torch.int64), (qi[QTAG] == -1).sum(dtype=torch.int64)])
        busy, q_busy, *waiting = flags.tolist()
        local = (busy or q_busy or self.launched < self.budget
                 or any(self.inbox[d].shape[1] or self.q_inbox[d].shape[1] for d in (1, -1)))
        n, me = self.mesh.size, self.mesh.rank
        space = lambda box, d: min(self.CAP, self.INBOX - box[d].shape[1])
        mine = [space(self.inbox, 1), space(self.inbox, -1), space(self.q_inbox, 1),
                space(self.q_inbox, -1)] + waiting
        vec = torch.zeros(1 + 8 * n, dtype=torch.float64)
        vec[0] = float(local)
        vec[1 + 8 * me:9 + 8 * me] = torch.tensor(mine, dtype=torch.float64)
        vec = all_reduce_sum(self.mesh, vec)
        g = vec[1:].view(n, 8).to(torch.int64).tolist()
        # Rank s sends photons (k = 0) or rays (k = 1) moving in dirn to
        # rank s + dirn: min(its waiting ones, the receiver's space).
        col = lambda dirn, k: (0 if dirn == 1 else 1) + 2 * k
        sent = lambda s_, dirn, k: min(g[s_][4 + col(dirn, k)], g[(s_ + dirn) % n][col(dirn, k)])
        self._plan = {
            "send": {d: (sent(me, d, 0), sent(me, d, 1)) for d in (1, -1)},
            "recv": {d: (sent((me - d) % n, d, 0), sent((me - d) % n, d, 1)) for d in (1, -1)}}
        return bool(vec[0] > 0) and self.kb < self.max_blocks

    # -- the glue ------------------------------------------------------------
    def _columns_of(self, x, y):
        s = self.spec
        ix = torch.clamp(((x - s.x_lo) * s.inv_dx).to(torch.int32), 0, s.nx_loc - 1)
        iy = torch.clamp(((y - s.y0) * s.inv_dy).to(torch.int32), 0, s.n_y - 1)
        return ix.long() * s.n_y + iy.long()

    def _flush(self) -> None:
        """Tally the exits and deaths the last block left in pk."""
        f, i = self.state.f, self.state.i
        e = (i[PK] != 0).nonzero()[:, 0]
        if not e.numel():
            return
        pk = i[PK][e].long()
        col = self._columns_of(f[0][e], f[1][e])
        self.columns.index_put_((col, pk - 1), torch.ones(e.numel(), dtype=torch.float64,
                                                           device=e.device), accumulate=True)
        if self.vol.numel():
            s = self.spec
            dead = pk == 3
            iz = torch.clamp(((f[2][e][dead] - s.z0) * s.inv_dz).to(torch.int32), 0, s.n_z - 1)
            self.vol.index_add_(0, col[dead] * s.n_z + iz.long(),
                                torch.ones(int(dead.sum()), dtype=torch.float64,
                                           device=e.device))

    def _surface(self) -> None:
        """Bottom hits: the reflected-radiance record (before the revive),
        then the Bernoulli revive with a Lambertian direction."""
        f, i = self.state.f, self.state.i
        h = (i[PK] == 2).nonzero()[:, 0]
        if not h.numel():
            return
        if self.spec.n_dirs:
            f[PEND_PF:, h] = self.surf_pf[:, None]
            i[PEND_SRF, h] = 1
            i[PEND, h] = 1
        u = stream_uniforms(self.key, STREAM_SURFACE, self.kb, 1, h.numel(), f.device, h)
        rev = h[u[0] < f32(self.albedo)]
        u = u[:, u[0] < f32(self.albedo)]
        mu = torch.clamp(torch.sqrt(u[1]), min=f32(1e-6))
        sin_t = torch.sqrt(torch.clamp(1.0 - u[1], min=0.0))
        s_az, c_az = _sincos_2pi(u[2])
        f[3, rev], f[4, rev], f[5, rev] = sin_t * c_az, sin_t * s_az, mu
        f[2, rev] = f32(self.spec.z0 + self.spec.nudge)
        f[TAU, rev] = 0.0
        i[ORDERS, rev] += 1
        i[ALIVE, rev] = 1

    def _drain(self) -> None:
        """Move pending records into free pool slots, D slots a record."""
        f, i = self.state.f, self.state.i
        qf, qi = self.pool.f, self.pool.i
        D = self.spec.n_dirs
        free = ((qi[QALIVE] == 0) & (qi[QTAG] == 0)).nonzero()[:, 0]
        pend = (i[PEND] != 0).nonzero()[:, 0]
        can = pend[:free.numel() // D]
        if not can.numel():
            return
        slots = free[:can.numel() * D].view(-1, D)
        dets = torch.arange(D, dtype=torch.int32, device=f.device)
        for r, row in ((0, 0), (1, 1), (2, 2)):
            qf[r, slots] = f[row, can][:, None]
        qf[QTAU, slots] = 0.0
        qf[QPF, slots] = f[PEND_PF:, can].t()
        det = torch.where(i[PEND_SRF, can][:, None] != 0, dets[None, :],
                          (i[PEND_COMP, can][:, None] + 1) * D + dets[None, :])
        qi[QDET, slots] = det.to(torch.int32)
        qi[QALIVE, slots] = 1
        i[PEND, can] = 0

    @staticmethod
    def _pack(tagged: torch.Tensor, cap: int, f: torch.Tensor, extra: torch.Tensor):
        """The first ``cap`` tagged lanes (lane order) and their rows: the
        float rows ``f`` and the int row ``extra`` as floats."""
        idx = tagged.nonzero()[:, 0][:cap]
        return idx, torch.cat([f[:, idx], extra[idx][None].to(torch.float32)])

    @staticmethod
    def _merge(box: dict, dirn: int, got: torch.Tensor, free: torch.Tensor):
        """Received rows after the inbox's: the first ones fill the free
        lanes in lane order; returns (lanes, rows) placed."""
        rows = torch.cat([box[dirn], got], dim=1)
        slots = free.nonzero()[:, 0][:rows.shape[1]]
        box[dirn] = rows[:, slots.numel():]
        return slots, rows[:, :slots.numel()]

    def _migrate(self) -> None:
        """Send each direction's planned photons and rays (the first
        tagged ones in lane order), exchange them, and place what arrives
        (rays first, +1 then -1, as the JAX body orders them)."""
        f, i = self.state.f, self.state.i
        qf, qi = self.pool.f, self.pool.i
        sends, sizes = {}, {}
        for dirn in (1, -1):
            n_ph, n_q = self._plan["send"][dirn]
            p_idx, p_rows = self._pack(i[TAG] == dirn, n_ph, f[:TAU + 1], i[ORDERS])
            i[TAG, p_idx] = 0
            parts = [p_rows.reshape(-1)]
            if n_q:
                q_idx, q_rows = self._pack(qi[QTAG] == dirn, n_q, qf, qi[QDET])
                qi[QTAG, q_idx] = 0
                qi[QALIVE, q_idx] = 0
                parts.append(q_rows.reshape(-1))
            sends[dirn] = torch.cat(parts)
            self.n_mig += n_ph + n_q
            r_ph, r_q = self._plan["recv"][dirn]
            sizes[dirn] = PHOTON_FIELDS * r_ph + RAY_FIELDS * r_q
        got = _exchange(self.mesh, sends, sizes)
        for dirn in (1, -1):
            r_ph, r_q = self._plan["recv"][dirn]
            rays = got[dirn][PHOTON_FIELDS * r_ph:].view(RAY_FIELDS, r_q)
            slots, rows = self._merge(self.q_inbox, dirn, rays,
                                      (qi[QALIVE] == 0) & (qi[QTAG] == 0))
            qf[:, slots] = rows[:5]
            qi[QDET, slots] = rows[5].to(torch.int32)
            qi[QALIVE, slots] = 1
        for dirn in (1, -1):
            r_ph = self._plan["recv"][dirn][0]
            photons = got[dirn][:PHOTON_FIELDS * r_ph].view(PHOTON_FIELDS, r_ph)
            slots, rows = self._merge(self.inbox, dirn, photons,
                                      (i[ALIVE] == 0) & (i[TAG] == 0) & (i[PEND] == 0))
            f[:TAU + 1, slots] = rows[:TAU + 1]
            i[ORDERS, slots] = rows[TAU + 1].to(torch.int32)
            i[ALIVE, slots] = 1

    def _refill(self) -> None:
        """Fresh photons of the rank's budget into dead lanes, in lane
        order, keeping RESERVE lanes free for immigrants."""
        f, i = self.state.f, self.state.i
        s = self.spec
        dead = ((i[ALIVE] == 0) & (i[TAG] == 0) & (i[PEND] == 0)).nonzero()[:, 0]
        n_new = min(max(dead.numel() - self.RESERVE, 0), self.budget - self.launched)
        if n_new <= 0:
            return
        lanes = dead[:n_new]
        b = self.source.sample(self.key, n_new, f.device, stream=STREAM_REFILL,
                               block=self.kb, lanes=lanes)
        ux, uy, uz = make_direction_cosines(b.mu, b.phi)
        f[0, lanes] = s.x_lo + b.x * f32(s.x_hi - s.x_lo)
        f[1, lanes] = s.y0 + b.y * s.wy
        f[2, lanes] = s.z0 + b.z * f32(s.z_max - s.z0)
        f[3, lanes], f[4, lanes], f[5, lanes] = ux, uy, uz
        f[TAU, lanes] = 0.0
        i[ORDERS, lanes] = 0
        i[ALIVE, lanes] = 1
        self.launched += n_new

    def block(self) -> None:
        """One block of the loop on this rank (call after ``running``).
        The JAX body's order from its migration on: the migrants of the
        last block are known when ``running`` plans their sends."""
        self._migrate()
        self._refill()
        self.event_block(self.spec, self.state, self.key, self.kb)
        self._flush()
        if self.albedo > 0.0:
            self._surface()
        self.state.i[PK] = 0
        if self.spec.n_dirs:
            self._drain()
            self.shadow_advance(self.spec, self.pool, self.acc_int, self.acc_byc)
        self.kb += 1

    def finish(self) -> RawTallies:
        """The final flush (no revive), n_bad and the global tallies."""
        self._flush()
        i, qi = self.state.i, self.pool.i
        moving = (i[ALIVE] != 0) | (i[TAG] != 0)
        waiting = lambda box: sum(box[d].shape[1] for d in (1, -1))
        n_bad = int(i[BAD].sum()) + int(moving.sum()) + waiting(self.inbox)
        if self.spec.n_dirs:
            # Undelivered radiance: records still pending on lanes not
            # counted above, rays in flight or waiting.
            n_bad += (int(((i[PEND] != 0) & ~moving).sum())
                      + int(((qi[QALIVE] != 0) | (qi[QTAG] != 0)).sum())
                      + waiting(self.q_inbox))
        tot = all_reduce_sum(self.mesh, torch.tensor([n_bad, self.n_mig], dtype=torch.float64))
        dev = self.mesh.device
        gather = lambda t: _all_gather_rows(self.mesh, t) if t.numel() else t
        cols, vol = gather(self.columns), gather(self.vol)
        acc_int, acc_byc = gather(self.acc_int), gather(self.acc_byc)
        n_cols = cols.shape[0]
        D, C = self.spec.n_dirs, self.spec.n_comp
        return RawTallies(
            flux_up=cols[:, 0], flux_down=cols[:, 1], flux_absorbed=cols[:, 2],
            volume_absorption=(vol if vol.numel() else
                               torch.zeros(n_cols * self.spec.n_z, dtype=torch.float64,
                                           device=dev)),
            intensity=acc_int, intensity_by_component=acc_byc,
            intensity_excess=torch.zeros(D * (C + 1), dtype=torch.float64, device=dev),
            n_photons=self.n_total,
            n_bad=torch.tensor(int(tot[0]), dtype=torch.int64, device=dev),
            n_iterations=self.kb * self.spec.K,
            n_lane_events=torch.tensor(float(tot[1]), dtype=torch.float64, device=dev))


def trace_sharded(domain, source, n_photons: int, mesh: Mesh, n_lanes_per_shard: int = 1 << 14,
                  max_events: int = 500, unroll: int = 8, seed: int = 0,
                  surface_albedo: float = 0.0, intensity_mus=None, intensity_phis=None,
                  compute_volume_absorption: bool = False) -> RawTallies:
    """Trace ``n_photons`` over the domain decomposed in x on ``mesh``.

    Every rank calls it with the same arguments.  Returns, on every rank,
    a RawTallies of the whole domain (float64 weight sums; normalize with
    ``integrators.results.normalize_tallies``): the (n_x n_y,) flux
    columns, the (n_x n_y n_z,) volume absorption when asked for, and with
    D detectors (``intensity_mus`` cosines, ``intensity_phis`` degrees) the
    (n_x n_y D,) radiance and its (n_x n_y D (C + 1),) split by slot.
    ``n_lane_events`` is the total number of migrations (photons and shadow
    rays across slab faces); ``n_bad`` counts photons ended by the event
    budget or the block cap and, with detectors, undelivered shadow rays,
    so ``sum(flux) + n_bad == n_photons`` holds over a black surface with
    D = 0 (with a reflecting surface Fdn counts every bottom hit).
    ``n_lanes_per_shard`` lanes (and as many pool slots) on each rank;
    ``unroll`` events (and shadow-ray steps) a block.
    """
    tr = ShardedTrace.create(domain, source, n_photons, mesh, n_lanes_per_shard, max_events,
                             unroll, seed, surface_albedo, intensity_mus, intensity_phis,
                             compute_volume_absorption)
    while tr.running():
        tr.block()
    return tr.finish()
