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
     ``all_reduce`` of the counts vector that the last block's kernels left
     tells every rank each rank's inbox space (at most ``CAP`` a kind and
     direction), its migrants waiting and whether it still has work; each
     sender sends min(waiting, the receiver's space) of each kind, the
     prefix of its send buffer (its first tagged rows in lane order;
     unsent migrants keep their tag and try again next block);
  2. ``kernels.sharded_block.sharded_event_block`` (SD), the whole block in
     one launch: the sent rows leave, the received ones fill free lanes
     and pool slots in order (the rest wait in the inbox), the refill of
     dead lanes from the rank's photon budget keeping ``RESERVE`` lanes
     free for immigrants, K events a lane, the flush of the block's exits
     into the local float64 tallies, the surface records and revive, with
     detectors the emission drain into the pool, and the packing of the
     tagged photons and of the counts;
  3. with detectors ``kernels.sharded_block.shadow_block`` (SB, one
     launch: K exact cell-DDA steps of each ray in flight, then the tagged
     rays and the pool's free slots packed, the ray side of the counts).
The host plans each block from the counts alone (``ShardedTrace.plan``:
integer arithmetic every rank repeats), so one read of the counts vector
is the block's only wait on the device.  The loop ends when no rank has
anything in flight, or at the block cap.

In the JAX package every ``jax.lax.ppermute`` is a ring shift along the
mesh axis.  Here each block makes that one ``all_reduce`` and one
``dist.batch_isend_irecv`` step carrying each direction's photons and
rays to the neighbour, a message a kind, of the size both ends computed
from the ``all_reduce``.  With NCCL the buffers stay on the device; with
gloo (the CPU, or ranks that share one GPU) they are staged through pinned
host memory.  The backend of the mesh's group decides; the algorithm is
the same.  A world of one receives what it sent, in place.

Sources: an x-uniform source (``X_UNIFORM_SOURCES``) is sampled in SD's
refill, x over the rank's slab, each rank launching ceil(n / ranks) photons.
Any other source (a spotlight, an internal source, whose x is a point or
spreads by ``delta_x``) is drawn once, n photons under a key that no rank
owns (``source_queue``); each rank keeps the photons whose x falls in its
slab, by the rule that locates a cell, and its refill takes them in batch
order.  So every photon starts where the unsharded source puts it, and the
ranks launch n in all (a spotlight's all on one rank).

Random streams: every rank draws from the Philox key (seed, rank), where
the JAX package folds the rank into its key (``fold_in(key, me)``,
sharded_domain.py:411, :642, :658): events at (lane, kb, group,
``STREAM_EVENT``), refills at ``STREAM_REFILL`` and surface revives at
``STREAM_SURFACE`` (core/rng.py); a source queue at (photon, 0, group,
``STREAM_LAUNCH``) under the key (seed, 0).  Ranks are independent streams;
a result depends on the rank count only statistically.

Departures from the JAX tracer: the event budget ends only lanes still in
flight (JAX also counts a lane that dies or leaves on its last allowed
event as bad, and tallies it); a source that is not uniform in x starts
its photons where the unsharded source does (JAX's ``sample_local``,
sharded_domain.py:222-228, scales every rank's draw of x into the rank's
own slab, so a spotlight or an internal source appears once a rank); a
shadow ray sent to the next rank frees its pool slot at the next block's
pack, not in the block that sends it (the free slots are the pack's, so
that the drain's slots are known without a second pass over the pool).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from i3rc_tpu_torch.core.optics import flatten_optics
from i3rc_tpu_torch.core.rng import STREAM_LAUNCH, PhiloxKey
from i3rc_tpu_torch.integrators.tables import build_forward_cubic, build_inverse_cubic
from i3rc_tpu_torch.integrators.wavefront import RawTallies, f32, make_direction_cosines
from i3rc_tpu_torch.kernels import sharded_block as sb
from i3rc_tpu_torch.kernels.sharded_block import (
    ALIVE,
    BAD,
    PEND,
    PEND_PF,
    QALIVE,
    QTAG,
    TAG,
    RayPool,
    ShardSpec,
    ShardState,
    SourceQueue,
)
from i3rc_tpu_torch.parallel.mesh import Mesh, all_reduce_sum

X_UNIFORM_SOURCES = ("directional", "random_azimuth", "flux_weighted")


def source_queue(source, n_photons: int, seed: int, spec: ShardSpec,
                 mesh: Mesh) -> tuple[SourceQueue, list]:
    """This rank's photons of a source that is not uniform in x, and every
    rank's count.  The n photons are drawn once, as the unsharded source
    draws a batch (photon i at (i, 0, group, ``STREAM_LAUNCH``)), under the
    key (seed, 0) on every rank; a photon belongs to the rank whose slab
    holds its x cell, the cell index clamped to the grid as a lane's is."""
    dev = mesh.device
    b = source.sample(PhiloxKey(int(seed), 0), int(n_photons), dev, stream=STREAM_LAUNCH)
    ux, uy, uz = make_direction_cosines(b.mu, b.phi)
    x = spec.x0 + b.x * spec.wx
    rows = torch.stack([x, spec.y0 + b.y * spec.wy, spec.z0 + b.z * f32(spec.z_max - spec.z0),
                        ux, uy, uz], dim=1)
    n_x = spec.nx_loc * mesh.size
    cell = torch.clamp(torch.floor((x - spec.x0) * spec.inv_dx), 0, n_x - 1).to(torch.int64)
    owner = cell // spec.nx_loc
    counts = torch.bincount(owner, minlength=mesh.size).tolist()
    return SourceQueue(rows[owner == mesh.rank].contiguous()), counts


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
        self.spec, self.mesh, self.source = spec, mesh, source
        dev = mesh.device
        L = int(n_lanes)
        D = spec.n_dirs
        self.CAP = max(128, L // 16)            # migrants a direction and block
        self.RESERVE = 2 * self.CAP             # free lanes kept for immigrants
        self.INBOX = 2 * self.CAP
        if source.kind in X_UNIFORM_SOURCES:
            # Sampled in SD's refill (the source, x over the slab).
            self.refill = source
            self.budget = -(-int(n_photons) // mesh.size)
            self.n_total = self.budget * mesh.size
            most = self.budget
        else:
            self.refill, counts = source_queue(source, n_photons, seed, spec, mesh)
            self.budget = counts[mesh.rank]
            self.n_total = int(n_photons)
            most = max(counts)
        self.key = PhiloxKey(int(seed), mesh.rank)
        self.albedo = float(surface_albedo)
        # The block cap, the same on every rank (from the largest budget).
        max_blocks = -(-4 * spec.max_events * (most // L + 2) // spec.K)
        if D:
            # Shadow rays drain at ~K cells a block; budget the extra latency.
            max_blocks = 2 * max_blocks + 4 * (spec.nx_loc + spec.n_y + spec.n_z) // spec.K
        self.max_blocks = max_blocks
        self.state = ShardState(torch.zeros(PEND_PF + D, L, device=dev),
                                torch.zeros(9, L, dtype=torch.int32, device=dev))
        R = L if D else 0
        self.pool = RayPool(torch.zeros(5, R, device=dev),
                            torch.zeros(4, R, dtype=torch.int32, device=dev))
        self.bufs = sb.shard_buffers(spec, L, self.CAP, self.INBOX, mesh.size, mesh.rank,
                                     volume, dev)
        self.bufs.counts[mesh.rank, sb.WORK] = int(self.budget > 0)
        n_cols = spec.nx_loc * spec.n_y
        f64 = dict(dtype=torch.float64, device=dev)
        self.acc_int = torch.zeros(n_cols * D, **f64)
        self.acc_byc = torch.zeros(n_cols * D * (spec.n_comp + 1), **f64)
        # Rows waiting in the inboxes (photons, rays), a direction: the
        # host's count of what the block kernel keeps there.
        self.waiting = {"ph": [0, 0], "q": [0, 0]}
        self.kb = 0
        self.launched = 0
        self.n_mig = 0
        self._plan = None
        # The block's kernels (a check may wrap them).
        self.event_block = sb.sharded_event_block
        self.shadow_block = sb.shadow_block

    # -- the loop's end and the block's plan (one read of the counts) -------
    def _counts(self) -> list:
        """Every rank's row of the counts vector, as Python ints: this
        rank's read from the device (under NCCL after the all_reduce on
        the device), all-reduced over the ranks."""
        c, mesh = self.bufs.counts, self.mesh
        if mesh.group is not None and mesh.backend == "nccl":
            dist.all_reduce(c, group=mesh.group)
            return c.cpu().tolist()
        host = c.cpu()
        if mesh.group is not None:
            dist.all_reduce(host, group=mesh.group)
        return host.tolist()

    def running(self) -> bool:
        """Whether any rank has work left (and the block cap is not hit).
        Every rank reads every rank's counts (inbox space, tagged migrants,
        free lanes and slots), so each sender and receiver computes the same
        counts for this block's migration: min(migrants, the receiver's
        space), each kind and direction; then this rank's placements, its
        refill and drain (``plan``)."""
        g = self._counts()
        if not (any(r[sb.WORK] or r[sb.BUSY_PH] or r[sb.BUSY_Q] for r in g)
                and self.kb < self.max_blocks):
            return False
        self._plan = self.plan(g)
        return True

    def plan(self, g: list) -> sb.BlockPlan:
        """The block's plan from the counts ``g`` (a row a rank)."""
        n, me, D = self.mesh.size, self.mesh.rank, self.spec.n_dirs
        src = [(me - dirn) % n for dirn in sb.DIRS]
        # Rank s sends kind (photons, rays) moving in direction k to rank
        # s + dirn: min(its waiting ones, the receiver's space).
        sent = lambda s, k, wait, space: min(g[s][wait + k], g[(s + sb.DIRS[k]) % n][space + k])
        kinds = {"ph": (sb.WAIT_PH, sb.SPACE_PH, sb.FREE_PH), "q": (sb.WAIT_Q, sb.SPACE_Q,
                                                                   sb.FREE_Q)}
        out = {}
        for kind, (wait, space, free) in kinds.items():
            if kind == "q" and not D:
                out[kind] = dict(sent=(0, 0), n_in=(0, 0), n_rx=(0, 0), placed=(0, 0), free=0)
                continue
            snd = tuple(sent(me, k, wait, space) for k in range(2))
            rx = tuple(sent(src[k], k, wait, space) for k in range(2))
            n_in = tuple(self.waiting[kind])
            # A photon sent frees its lane in this block; a ray's slot joins
            # the free slots at the next pack.
            room = g[me][free] + (sum(snd) if kind == "ph" else 0)
            placed = []
            for k in range(2):
                placed.append(min(n_in[k] + rx[k], room))
                room -= placed[k]
            self.waiting[kind] = [n_in[k] + rx[k] - placed[k] for k in range(2)]
            self.n_mig += sum(snd)
            out[kind] = dict(sent=snd, n_in=n_in, n_rx=rx, placed=tuple(placed), free=room)
        n_new = min(max(out["ph"]["free"] - self.RESERVE, 0), self.budget - self.launched)
        q_at = self.launched
        self.launched += n_new
        waiting = sum(self.waiting["ph"]) + sum(self.waiting["q"])
        space = lambda kind: tuple(min(self.CAP, self.INBOX - w) for w in self.waiting[kind])
        ph, q = out["ph"], out["q"]
        return sb.BlockPlan(
            sent_ph=ph["sent"], sent_q=q["sent"], n_in_ph=ph["n_in"], n_rx_ph=ph["n_rx"],
            placed_ph=ph["placed"], n_in_q=q["n_in"], n_rx_q=q["n_rx"], placed_q=q["placed"],
            n_new=n_new, drain_cap=q["free"] // D if D else 0,
            work=int(self.launched < self.budget or waiting > 0),
            space_ph=space("ph"), space_q=space("q"), q_at=q_at)

    def _exchange(self, plan: sb.BlockPlan) -> None:
        """One ring step: the planned prefix of each send buffer goes to
        rank ``rank + dirn`` (photons and rays, one message each) and the
        planned rows arrive from ``rank - dirn`` into the receive buffers.
        With NCCL the buffers stay on the device; with gloo (the CPU, or
        ranks that share one GPU) they are staged through pinned host
        buffers made at the first exchange.  A world of one receives what
        it sent in place."""
        bufs, mesh = self.bufs, self.mesh
        if bufs.self_exchange:
            return
        n, me, dev = mesh.size, mesh.rank, mesh.device
        staged = mesh.backend != "nccl" and dev.type == "cuda"
        if staged and not hasattr(self, "_pinned"):
            pin = lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned = {"send": [pin(bufs.send_ph[0, k]) for k in range(2)]
                            + [pin(bufs.send_q[k]) for k in range(2)],
                            "recv": [pin(bufs.recv_ph[k]) for k in range(2)]
                            + [pin(bufs.recv_q[k]) for k in range(2)]}
        par = self.kb & 1
        # (send buffer, receive buffer, rows sent, rows received, tag) of
        # each kind and direction: every rank posts photons before rays and
        # +1 before -1, and the tag names the kind and direction, so two
        # messages to one peer (a world of two) keep apart.
        msgs = [(bufs.send_ph[par, k], bufs.recv_ph[k], plan.sent_ph[k], plan.n_rx_ph[k], 2 + dirn)
                for k, dirn in enumerate(sb.DIRS)]
        msgs += [(bufs.send_q[k], bufs.recv_q[k], plan.sent_q[k], plan.n_rx_q[k], 6 + dirn)
                 for k, dirn in enumerate(sb.DIRS)]
        ops, got = [], []
        for m, ((send, _, n_send, _, tag), dirn) in enumerate(zip(msgs, sb.DIRS * 2)):
            if n_send:
                t = send[:n_send]
                if staged:
                    t = self._pinned["send"][m][:n_send].copy_(t)
                ops.append(dist.P2POp(dist.isend, t, (me + dirn) % n, mesh.group, tag=tag))
        for m, ((_, recv, _, n_recv, tag), dirn) in enumerate(zip(msgs, sb.DIRS * 2)):
            if n_recv:
                t = recv[:n_recv]
                buf = self._pinned["recv"][m][:n_recv] if staged else t
                got.append((t, buf))
                ops.append(dist.P2POp(dist.irecv, buf, (me - dirn) % n, mesh.group, tag=tag))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        for t, buf in got:
            if buf is not t:
                t.copy_(buf, non_blocking=True)

    # -- one block -----------------------------------------------------------
    def block(self) -> None:
        """One block of the loop on this rank (call after ``running``): the
        exchange of the migrants its plan names, then the block's kernels
        (SD, and with detectors SB), which leave the next counts."""
        plan = self._plan
        self._exchange(plan)
        self.event_block(self.spec, self.state, self.pool, self.bufs, plan, self.key, self.kb,
                         self.refill, self.albedo)
        if self.spec.n_dirs:
            self.shadow_block(self.spec, self.pool, self.bufs, self.acc_int, self.acc_byc)
        self.kb += 1

    def finish(self) -> RawTallies:
        """n_bad and the global tallies (every exit is flushed in the block
        that made it)."""
        i, qi = self.state.i, self.pool.i
        moving = (i[ALIVE] != 0) | (i[TAG] != 0)
        n_bad = int(i[BAD].sum()) + int(moving.sum()) + sum(self.waiting["ph"])
        if self.spec.n_dirs:
            # Undelivered radiance: records still pending on lanes not
            # counted above, rays in flight or waiting.
            n_bad += (int(((i[PEND] != 0) & ~moving).sum())
                      + int(((qi[QALIVE] != 0) | (qi[QTAG] != 0)).sum())
                      + sum(self.waiting["q"]))
        tot = all_reduce_sum(self.mesh, torch.tensor([n_bad, self.n_mig], dtype=torch.float64))
        dev = self.mesh.device
        gather = lambda t: _all_gather_rows(self.mesh, t) if t.numel() else t
        cols, vol = gather(self.bufs.columns), gather(self.bufs.vol)
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
