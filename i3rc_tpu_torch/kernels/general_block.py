"""The general event block: K general transport events per lane, kernel and twin.

``general_block`` is the wrapper the general trace loop
(``integrators/wavefront.py`` ``make_batch_tracer``) calls for one block:
the FIFO refill of dead lanes from the photon budget (source sampled in
the kernel), then K events of the general kernel
(``wavefront.general_event``), with radiance detectors each event's local
estimate (``wavefront.intensity_estimate``; in the kernel each estimate
a record in its CTA's ray queue, whose rays the CTA traces after its lanes'
events: ``gen_flush``).  On a CUDA tensor it launches the
hand-written Hopper kernel ``csrc/general_event_block.cuh`` once and raises
if the build or the launch fails; on a CPU tensor it runs
``general_block_reference``, the plain PyTorch version, on the same Philox
draws.  The JAX package runs this path as XLA (a masked ``lax.while_loop``
over events, ``i3rc_tpu/integrators/wavefront.py:657``, with a nested
``while_loop`` for the DDA, ``i3rc_tpu/ops/dda.py:241``); it has no TPU
kernel.

Draw layout: event ``j`` of block ``kb`` reads ``philox_uniforms(key, kb,
K, n_draws, L)[j, d]`` for its draw ``d`` (``rng.STREAM_EVENT``; a trace
runs either the fastpath or the general kernel, so the stream is not
shared), in the order of ``Variant.draws``: free path, cosine, azimuth,
then the Woodcock / maximum cross-section acceptance, the surface's two
draws, the component pick and the roulette (or, in the weight-1 class, the
survival draw), each only where the variant consumes it
(wavefront.py:1184-1199).  The local estimate draws from
``rng.STREAM_INTENSITY`` at (lane, kb, ``rng.intensity_group(j, d,
pair)``): Iwabuchi roulette words 0-1 of pair 0 per detector, ratio
tracking two words a round, one Philox call every two rounds.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from i3rc_tpu_torch.core.illumination import PhotonSource
from i3rc_tpu_torch.core.rng import STREAM_REFILL, PhiloxKey, philox_uniforms
from i3rc_tpu_torch.integrators.wavefront import (
    EXACT,
    IWABUCHI,
    MAXCS,
    ONEHOT_MAX_ROWS,
    RATIO,
    RT,
    WOODCOCK,
    DetectorSet,
    DeviceOptics,
    DeviceTables,
    f32,
    general_event,
    make_direction_cosines,
)
from i3rc_tpu_torch.kernels.event_block import (
    BRDF_KINDS,
    CTA_THREADS,
    DONE,
    SPENT,
    _SourceParams,
    cta_dead_counts,
    source_constants,
)
from i3rc_tpu_torch.ops.dda import GridGeometry

MODE_NAMES = {RT: "ray_tracing", MAXCS: "max_cross_section", WOODCOCK: "woodcock"}
EST_NAMES = {EXACT: "exact", IWABUCHI: "iwabuchi", RATIO: "ratio"}
ALBEDO = 1                       # surface kinds: 0 black, 1 albedo, then BRDF_KINDS
MAX_BRDF_PARAMS = 4
GENERAL_K = 8                    # events per launch
MAX_DRAWS = 8                    # the kernel's draw registers per event
MAX_TILES = 16                   # the kernel's GEN_MAX_TILES: tiles of CTA_THREADS lanes a CTA
KEY_BUCKETS = 4                  # the kernel's GEN_KEY_BUCKETS: buckets of the key (lane_keys)
KEY_LIFT = 1.0 + 2.0 ** -10      # the key's scale over inv_max_ext (lane_keys)
GEN_RAY_F4 = 3                   # float4 words of a ray record in the kernel's queue
RAY_MAX_SLOT = 0xFFFF            # the record's tally-slot (comp + 1) field: GEN_RAY_MAX_SLOT

# Rows of GeneralState.f and GeneralState.i.
X, Y, Z, UX, UY, UZ, W = range(7)
ALIVE, IX, IY, IZ, ORDER, BAD, EVCT, XING = range(8)


@dataclass(frozen=True)
class GeneralSpec:
    """What the block needs besides the optics, the tables and the state:
    the transport mode, the fine grid (``geom``) and the block-majorant grid
    (``coarse``: Woodcock transport or ratio-tracking estimates), the
    detectors (``det``, None without), the surface (kind 0 black, ALBEDO, or a
    BRDF kind with its (n_xs * n_ys, n_params) float32 parameter grid and
    edge tensors; ``srf_x0`` / ``srf_wx`` etc. are the grid's origin and
    float32 width), the roulette, the event and crossing budgets (the
    crossing budget of the grid the DDA walks), the volume tally, K, and
    ``chained``: the weight-1 class applies to uniform single-component
    optics (integrators/wavefront.py ``variant``; with detectors only under
    ratio tracking without hybrid phases or clipping, wavefront.py:697-705)."""

    mode: int
    geom: GridGeometry
    coarse: GridGeometry | None
    surface_kind: int
    albedo: float
    brdf_fn: object
    srf_params: torch.Tensor | None
    srf_x_edges: torch.Tensor | None
    srf_y_edges: torch.Tensor | None
    n_xs: int
    n_ys: int
    srf_x0: float
    srf_wx: float
    srf_y0: float
    srf_wy: float
    use_rr: bool
    rr_w: float
    max_events: int
    max_crossings: int
    vol: bool
    chained: bool
    K: int
    n_photons: int
    det: DetectorSet | None = None


@dataclass(frozen=True)
class Variant:
    """The static specialization of one (spec, optics) pair
    (wavefront.py:1170-1199): ``uniform`` single-component optics (``coalb``
    = f32(1 - ssa)), the weight-1 class (``bernoulli``, ``absorbing`` when
    ssa < 1, survival test ``u >= ssa``), the roulette (``rr`` with its
    float32 half weight), f32(1 / max(ext_max, 1e-30)) and the names of the
    event's draws in their order."""

    uniform: bool
    bernoulli: bool
    absorbing: bool
    ssa: float
    coalb: float
    rr: bool
    rr_half: float
    inv_max_ext: float
    draws: tuple

    @property
    def n_draws(self) -> int:
        return len(self.draws)


def detector_set(intensity, config, geom: GridGeometry, coarse: GridGeometry | None,
                 n_components: int, dev) -> DetectorSet:
    """The detectors and the local estimator of a tracer, decided as
    make_batch_tracer decides (wavefront.py:672-674, :906-933): ratio
    tracking when the config asks for it and block majorants exist, else
    Iwabuchi roulette or the exact trace."""
    if config.use_ratio_tracking_for_intensity and coarse is not None:
        est = RATIO
    else:
        est = IWABUCHI if config.use_russian_roulette_for_intensity else EXACT
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(np.asarray(a, dt)), device=dev)
    dirs = t(intensity.directions, np.float32)
    hybrid = config.use_hybrid_phase_funs and config.num_orders_orig_phase_fun > 0
    return DetectorSet(
        n=int(intensity.n_directions), n_comp=int(n_components), dirs=dirs,
        abs_mu=t(intensity.abs_mu, np.float32), exit_status=t(intensity.exit_status, np.int32),
        phi=torch.atan2(dirs[1], dirs[0]).contiguous(), est=est, zeta=f32(config.zeta_min),
        zeta_ratio=f32(max(config.zeta_min, 1e-3)),
        n_orig=int(config.num_orders_orig_phase_fun) if hybrid else 0,
        clip=bool(config.limit_intensity_contributions),
        cap=f32(config.max_intensity_contribution),
        max_crossings=int(config.max_intensity_crossings
                          or max(1024, 8 * (geom.n_x + geom.n_y + geom.n_z))),
        ratio_crossings=max(64, 4 * (coarse.n_x + coarse.n_y + coarse.n_z)) if coarse else 0)


def general_spec(geom: GridGeometry, coarse: GridGeometry | None, surface, config,
                 n_photons: int, intensity=None, n_components: int = 1) -> GeneralSpec:
    """The block's constants for one tracer, decided as make_batch_tracer
    decides (wavefront.py:671-709); ``n_components`` sizes the radiance by
    component."""
    n_x, n_y, n_z = geom.n_x, geom.n_y, geom.n_z
    dev = geom.x_edges.device
    det = None if intensity is None else detector_set(intensity, config, geom, coarse,
                                                      n_components, dev)
    ratio = det is not None and det.est == RATIO
    if config.use_ray_tracing:
        mode, coarse = RT, coarse if ratio else None
        budget = config.max_crossings or max(1024, 8 * (n_x + n_y + n_z))
    elif coarse is not None:
        mode = WOODCOCK
        budget = max(64, 4 * (coarse.n_x + coarse.n_y + coarse.n_z))
    else:
        mode, budget = MAXCS, 0
    kind, albedo, brdf = 0, 0.0, None
    params = xe = ye = None
    n_xs = n_ys = 1
    sx0 = swx = sy0 = swy = 0.0
    if surface.uses_brdf:
        kind, brdf = BRDF_KINDS[surface.brdf_name], surface.brdf_fn
        params = torch.as_tensor(np.asarray(surface.params, np.float32), device=dev)
        xe32 = np.asarray(surface.x_edges, np.float32)
        ye32 = np.asarray(surface.y_edges, np.float32)
        xe, ye = torch.as_tensor(xe32, device=dev), torch.as_tensor(ye32, device=dev)
        n_xs, n_ys = int(surface.n_xs), int(surface.n_ys)
        sx0, swx = float(xe32[0]), float(xe32[-1] - xe32[0])
        sy0, swy = float(ye32[0]), float(ye32[-1] - ye32[0])
    elif float(surface.albedo) > 0.0:
        kind, albedo = ALBEDO, f32(surface.albedo)
    black = kind == 0
    vol = bool(config.compute_volume_absorption)
    # The weight-1 class (wavefront.py:688-709) with the one-hot read regime
    # read as "cells <= 2^18": auto chain 6 above it, 1 (off) below.
    chain = int(config.general_chain) or (6 if geom.n_cells > ONEHOT_MAX_ROWS else 1)
    chained = (chain > 1 and mode == WOODCOCK and black and not vol
               and (det is None or (ratio and not config.use_hybrid_phase_funs
                                    and not config.limit_intensity_contributions)))
    return GeneralSpec(
        mode=mode, geom=geom, coarse=coarse, surface_kind=kind, albedo=albedo, brdf_fn=brdf,
        srf_params=params, srf_x_edges=xe, srf_y_edges=ye, n_xs=n_xs, n_ys=n_ys,
        srf_x0=sx0, srf_wx=swx, srf_y0=sy0, srf_wy=swy,
        use_rr=bool(config.use_russian_roulette), rr_w=f32(config.russian_roulette_w),
        max_events=int(config.max_events), max_crossings=int(budget), vol=vol,
        chained=chained, K=GENERAL_K, n_photons=int(n_photons), det=det)


def variant(spec: GeneralSpec, opt: DeviceOptics) -> Variant:
    """The specialization the kernel and its twin run for these optics."""
    uniform = opt.uniform
    bernoulli = spec.chained and uniform
    ssa = f32(opt.uniform_ssa) if uniform else 1.0
    absorbing = bernoulli and ssa < 1.0
    black = spec.surface_kind == 0
    conservative = uniform and opt.uniform_ssa == 1.0
    rr = spec.use_rr and not bernoulli and not (conservative and black)
    names = ["tau", "scat", "chi"]
    if spec.mode != RT:
        names.append("accept")
    if not black:
        names += ["srf_mu", "srf_phi"]
    if not uniform:
        names.append("comp")
    if absorbing:
        names.append("abs")
    if rr:
        names.append("rr")
    max_ext = np.maximum(np.float32(opt.max_extinction), np.float32(1e-30))
    return Variant(uniform=uniform, bernoulli=bernoulli, absorbing=absorbing, ssa=ssa,
                   coalb=f32(1.0 - opt.uniform_ssa) if uniform else 0.0, rr=rr,
                   rr_half=f32(float(spec.rr_w) / 2.0),
                   inv_max_ext=float(np.float32(1.0) / max_ext), draws=tuple(names))


@dataclass
class GeneralState:
    """Per-lane state of the general kernel: ``f`` (7, L) float32 rows x, y,
    z, ux, uy, uz, w (the photon weight); ``i`` (8, L) int32 rows alive, ix,
    iy, iz (the cell, kept in ray-tracing mode only), order (scattering
    order), bad (lane's bad count), evct (lane-events), xing (DDA steps:
    the cell crossings and stops of every trace)."""

    f: torch.Tensor
    i: torch.Tensor

    @property
    def n_lanes(self) -> int:
        return self.f.shape[1]

    def clone(self) -> "GeneralState":
        return GeneralState(self.f.clone(), self.i.clone())


@dataclass
class GeneralBuffers:
    """What a trace carries between blocks besides the lane state: the
    float64 ``columns`` (n_cols, 3: up, down, absorbed) and ``vol``
    (n_cells, or empty) tallies, the loop control of
    ``event_block.BlockBuffers``: ``ctl`` int64 (4,) (launched at kb & 1,
    DONE, SPENT) and ``dead`` int32 (2, n_tiles) (dead lanes per tile of
    CTA_THREADS lanes); with D detectors the float64 radiance tallies
    ``intensity`` (n_cols * D,), ``by_component`` (n_cols * D * (n_comp +
    1),) and ``excess`` (D * (n_comp + 1),) and the int32 ``int_steps``
    and ``int_rays`` (L,), each lane's estimate DDA steps and rays (D per
    estimating event; all empty without detectors)."""

    columns: torch.Tensor
    vol: torch.Tensor
    ctl: torch.Tensor
    dead: torch.Tensor
    intensity: torch.Tensor
    by_component: torch.Tensor
    excess: torch.Tensor
    int_steps: torch.Tensor
    int_rays: torch.Tensor

    def clone(self) -> "GeneralBuffers":
        return GeneralBuffers(*(t.clone() for t in (
            self.columns, self.vol, self.ctl, self.dead, self.intensity, self.by_component,
            self.excess, self.int_steps, self.int_rays)))


def _place(spec: GeneralSpec, x, y, z, mu, phi, f, i, take) -> None:
    """Lanes ``take`` start a photon at the normalized (x, y, z) with
    direction (mu, phi) (the domain scaling of wavefront.py:1213-1219)."""
    g = spec.geom
    f[X] = torch.where(take, g.x0 + x * (g.x_max - g.x0), f[X])
    f[Y] = torch.where(take, g.y0 + y * (g.y_max - g.y0), f[Y])
    f[Z] = torch.where(take, g.z0 + z * (g.z_max - g.z0), f[Z])
    for row, v in zip((UX, UY, UZ), make_direction_cosines(mu, phi)):
        f[row] = torch.where(take, v, f[row])
    f[W] = torch.where(take, 1.0, f[W])
    i[ORDER] = torch.where(take, 0, i[ORDER])
    if spec.mode == RT:
        for row, loc, v in ((IX, g.locate_x, f[X]), (IY, g.locate_y, f[Y]),
                            (IZ, g.locate_z, f[Z])):
            i[row] = torch.where(take, loc(v), i[row])


def launch_state(spec: GeneralSpec, batch, n_photons: int) -> GeneralState:
    """Lane state for a launch batch; lanes beyond the budget start dead."""
    L = batch.n_photons
    dev = batch.x.device
    f = torch.zeros((7, L), dtype=torch.float32, device=dev)
    i = torch.zeros((8, L), dtype=torch.int32, device=dev)
    take = torch.arange(L, device=dev) < n_photons
    _place(spec, batch.x, batch.y, batch.z, batch.mu, batch.phi, f, i, take)
    i[ALIVE] = take.to(torch.int32)
    return GeneralState(f, i)


def general_buffers(spec: GeneralSpec, state: GeneralState, launched: int,
                    kb: int = 0) -> GeneralBuffers:
    """Zeroed tallies and the loop's control state for a trace that enters
    block ``kb`` on ``state`` with ``launched`` photons launched."""
    dev = state.f.device
    g = spec.geom
    D = spec.det.n if spec.det is not None else 0
    n1 = spec.det.n_comp + 1 if spec.det is not None else 1
    f64 = lambda m: torch.zeros(m, dtype=torch.float64, device=dev)
    ctl = torch.tensor([0, 0, -1, -1], dtype=torch.int64, device=dev)
    ctl[kb & 1] = launched
    dead = torch.zeros((2, -(-state.n_lanes // CTA_THREADS)), dtype=torch.int32, device=dev)
    dead[kb & 1] = cta_dead_counts(state.i[ALIVE])
    return GeneralBuffers(
        columns=torch.zeros((g.n_x * g.n_y, 3), dtype=torch.float64, device=dev),
        vol=f64(g.n_cells if spec.vol else 0), ctl=ctl, dead=dead,
        intensity=f64(g.n_x * g.n_y * D), by_component=f64(g.n_x * g.n_y * D * n1),
        excess=f64(D * n1),
        int_steps=torch.zeros(state.n_lanes if D else 0, dtype=torch.int32, device=dev),
        int_rays=torch.zeros(state.n_lanes if D else 0, dtype=torch.int32, device=dev))


def general_block_reference(spec: GeneralSpec, var: Variant, opt: DeviceOptics,
                            tables: DeviceTables, state: GeneralState, buf: GeneralBuffers,
                            key: PhiloxKey, source: PhotonSource, kb: int,
                            record: dict | None = None) -> None:
    """Plain PyTorch version of one block: the loop's end condition as seen
    at entry, the FIFO refill (while the batch has more photons than
    lanes: dead lane l takes photon launched + its rank among the dead
    lanes, with the source sample at (l, kb, group, STREAM_REFILL)), then the
    K events of ``wavefront.general_event`` and the next block's CTA dead
    counts, all in place on ``state`` and ``buf``.  ``record``, a dict,
    receives what ``warp_census`` reads: ``entry``, a copy of the state
    after the refill, and per event the lanes alive at its start
    (``alive``, (K, L) bool) and the DDA steps each lane took in it
    (``steps``, (K, L) int32); with detectors what ``ray_census`` reads:
    ``rays``, int64 (4, n_rays) rows (event j, lane, detector, the ray's
    DDA steps), in event order and lane-major within an event."""
    ctl = buf.ctl
    f, i = state.f, state.i
    L = state.n_lanes
    launched = ctl[kb & 1].clone()
    spent = launched >= spec.n_photons
    ctl[SPENT] = torch.where(spent & (ctl[SPENT] < 0), kb, ctl[SPENT])
    ctl[DONE] = torch.where(spent & ~i[ALIVE].any() & (ctl[DONE] < 0), kb, ctl[DONE])
    if spec.n_photons > L:
        dead = i[ALIVE] == 0
        dead_i = dead.to(torch.int64)
        take = dead & (launched + torch.cumsum(dead_i, 0) - dead_i < spec.n_photons)
        fresh = source.sample(key, L, f.device, stream=STREAM_REFILL, block=kb)
        _place(spec, fresh.x, fresh.y, fresh.z, fresh.mu, fresh.phi, f, i, take)
        i[ALIVE] = i[ALIVE] | take.to(torch.int32)
        launched = launched + take.sum()
    ctl[(kb + 1) & 1] = launched
    u = philox_uniforms(key, kb, spec.K, var.n_draws, L, f.device)
    names = ("x", "y", "z", "ux", "uy", "uz", "w")
    s = {n: f[r] for r, n in enumerate(names)}
    s.update(alive=i[ALIVE] != 0, ix=i[IX], iy=i[IY], iz=i[IZ], order=i[ORDER], bad=i[BAD],
             evct=i[EVCT], xing=i[XING].clone())
    if record is not None:
        record["entry"] = state.clone()
        alive_rows, step_rows = [], []
    for j in range(spec.K):
        if record is not None:
            alive_rows.append(s["alive"].clone())
            xing0 = s["xing"].clone()
        general_event(spec, var, opt, tables, u[j], s, buf, key, kb, j, record)
        if record is not None:
            step_rows.append(s["xing"] - xing0)
    if record is not None:
        record["alive"], record["steps"] = torch.stack(alive_rows), torch.stack(step_rows)
        record["rays"] = torch.cat(record.get("rays", [])
                                   or [torch.zeros((4, 0), dtype=torch.int64,
                                                   device=f.device)], dim=1)
    f.copy_(torch.stack([s[n] for n in names]))
    i.copy_(torch.stack([s["alive"].to(torch.int32), s["ix"], s["iy"], s["iz"], s["order"],
                         s["bad"], s["evct"], s["xing"]]))
    buf.dead[(kb + 1) & 1] = cta_dead_counts(i[ALIVE])


# ---------------------------------------------------------------------------
# The kernel's lane order, and the warp census of an order

def cta_tiles(n_lanes: int, n_live: int) -> int:
    """T, the tiles of CTA_THREADS lanes a working CTA of the kernel runs
    (``general_prologue`` in csrc/general_event_block.cuh), for ``n_live``
    lanes alive after the refill: about CTA_THREADS live lanes a CTA,
    n_lanes // n_live within [1, MAX_TILES].  The kernel estimates n_live
    from a sample of the tiles' dead counts; here it is exact."""
    return min(max(n_lanes // n_live, 1), MAX_TILES) if n_live > 0 else MAX_TILES


def lane_keys(spec: GeneralSpec, opt: DeviceOptics, state: GeneralState,
              n_buckets: int = KEY_BUCKETS) -> torch.Tensor:
    """int32 (L,): the bucket of each lane's expected DDA length at block
    entry, the key of the census's grouped order and, in ray tracing, of the
    kernel's order on one tile (``rt_bucket``; the Woodcock key cost the
    card 7% per Landsat batch and is not built, PERF.md): the extinction of
    the lane's cell (ray tracing) or the majorant of its coarse block
    (Woodcock), r = e * (inv_max_ext * (1 + 2^-10)) in float32 (the factor
    lifts the largest e, whose r may round below 1, into bucket 0), bucket
    min(-floor(log2 r), n_buckets - 1) from r's float32 exponent (0 for the
    densest, n_buckets - 1 for r < 2^-(n_buckets - 1) and r = 0); every
    lane 0 under maximum cross-section (no DDA) and with one bucket."""
    L = state.n_lanes
    if spec.mode == MAXCS or n_buckets == 1:
        return torch.zeros(L, dtype=torch.int32, device=state.f.device)
    inv_max_ext = variant(spec, opt).inv_max_ext
    if spec.mode == RT:
        g = spec.geom
        flat = ((state.i[IX] * g.n_y + state.i[IY]) * g.n_z + state.i[IZ]).clamp(0, g.n_cells - 1)
        e = opt.total_ext[flat.long()]
    else:
        c = spec.coarse
        flat = (c.locate_x(state.f[X]) * c.n_y + c.locate_y(state.f[Y])) * c.n_z \
            + c.locate_z(state.f[Z])
        e = opt.block_majorant[flat.long()]
    scale = torch.tensor(inv_max_ext, dtype=torch.float32) * torch.tensor(KEY_LIFT,
                                                                         dtype=torch.float32)
    r = e * scale.to(e.device)
    exponent = ((r.view(torch.int32) >> 23) & 0xFF) - 127
    return (-exponent).clamp(0, n_buckets - 1).to(torch.int32)


def lane_order(alive: torch.Tensor, bucket: torch.Tensor | None = None,
               n_buckets: int = 1, tiles: int = 1) -> torch.Tensor:
    """int64 (n_ctas * tiles * CTA_THREADS,): the lane in each slot of the
    CTAs' live-lane lists, -1 for an empty slot; slots 32k to 32k + 31 of a
    CTA are the chunk one warp runs.  A CTA holds ``tiles`` tiles of
    CTA_THREADS lanes, its live lanes packed onto its first slots in lane
    order or, with ``bucket``, ordered by bucket (a counting sort into
    ``n_buckets``) and by lane id within one.  The kernel's order is the
    grouped one in ray tracing on one tile, else the compaction over
    ``cta_tiles`` tiles."""
    L = alive.shape[0]
    dev = alive.device
    span = tiles * CTA_THREADS
    n_slots = -(-L // span) * span
    live = torch.zeros(n_slots, dtype=torch.bool, device=dev)
    live[:L] = alive.bool()
    b = torch.zeros(n_slots, dtype=torch.int64, device=dev)
    if bucket is not None:
        b[:L] = bucket.long().clamp(0, n_buckets - 1)
    lanes = torch.arange(n_slots, device=dev)
    rank = (lanes // span) * (n_buckets + 1) + torch.where(live, b, n_buckets)
    _, perm = torch.sort(rank, stable=True)
    return torch.where(live[perm], perm, -1)


def identity_order(L: int, device=None) -> torch.Tensor:
    """The thread slots of the first design: thread l runs lane l."""
    n_slots = -(-L // CTA_THREADS) * CTA_THREADS
    lanes = torch.arange(n_slots, device=device)
    return torch.where(lanes < L, lanes, -1)


def warp_census(steps: torch.Tensor, alive: torch.Tensor, order: torch.Tensor,
                sparse_lanes: int = 8) -> dict:
    """How well the warps of an order use their lanes over one block's
    events.  ``steps`` (K, L) DDA steps per lane and event, ``alive`` (K, L)
    the lanes alive at each event's start (``general_block_reference``'s
    record), ``order`` the lane of each thread slot (-1 idle).  A warp
    makes an event's trip while any of its lanes is alive, and its DDA loop
    runs as long as its longest lane's.  Returns ``trips`` (warp-event
    trips), ``warp_steps`` (the sum over trips of the longest lane's
    steps), ``lane_steps`` and ``lane_events`` (the sums over lanes),
    ``dda_efficiency`` = lane_steps / (32 warp_steps),
    ``event_efficiency`` = lane_events / (32 trips), and ``sparse_share``,
    the share of trips with at most ``sparse_lanes`` live lanes."""
    valid = order >= 0
    idx = order.clamp(min=0)
    a = alive[:, idx] & valid                                  # (K, n_slots)
    st = torch.where(a, steps[:, idx], 0)
    K = a.shape[0]
    a = a.view(K, -1, 32)
    st = st.view(K, -1, 32)
    live = a.sum(dim=2)
    trip = live > 0
    trips = int(trip.sum())
    warp_steps = int(st.max(dim=2).values.sum())
    lane_steps = int(st.sum())
    lane_events = int(live.sum())
    return {"trips": trips, "warp_steps": warp_steps, "lane_steps": lane_steps,
            "lane_events": lane_events,
            "dda_efficiency": lane_steps / (32 * warp_steps) if warp_steps else float("nan"),
            "event_efficiency": lane_events / (32 * trips) if trips else float("nan"),
            "sparse_share": int((trip & (live <= sparse_lanes)).sum()) / trips
            if trips else float("nan")}


def _round_cost(cost: torch.Tensor, group: torch.Tensor, n: int = 32) -> tuple[int, int]:
    """(sum over rounds of the longest cost, rounds): the costs, sorted so
    that each ``group`` is contiguous, dealt ``n`` at a time within their
    group."""
    if cost.numel() == 0:
        return 0, 0
    _, counts = torch.unique_consecutive(group, return_counts=True)
    start = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    pos = torch.arange(cost.numel(), device=cost.device) - start
    grp = torch.repeat_interleave(torch.arange(counts.numel(), device=cost.device), counts)
    rnd = grp * (int(counts.max()) // n + 1) + pos // n
    _, rid = torch.unique(rnd, return_inverse=True)
    top = torch.zeros(int(rid.max()) + 1, dtype=cost.dtype, device=cost.device)
    top.scatter_reduce_(0, rid, cost, "amax")
    return int(top.sum()), top.numel()


def ray_census(rays: torch.Tensor, order: torch.Tensor, cta_slots: int = CTA_THREADS) -> dict:
    """The warp cost of one recorded block's detector rays under three
    designs of the estimate stage.  ``rays`` int64 (4, n) rows (event j,
    lane, detector, cost: the ray's DDA steps or ratio-tracking rounds),
    the ``record["rays"]`` of ``general_block_reference`` or of
    ``polarized_block_reference``; ``order`` the lane of each thread slot
    (-1 idle: ``lane_order``, ``identity_order``), slot // 32 its warp and
    slot // ``cta_slots`` its CTA.  A warp's time on a set of rays is the
    longest ray of each round it runs:

    * ``serial`` (i), the first design: a lane traces its D rays of an
      event one after another; per (event, warp) trip the largest sum over
      a lane's rays;
    * ``warp`` (ii): the rays of a warp's lanes in push order (event,
      slot, detector), traced 32 at a time by the warp's threads;
    * ``cta_by_detector`` (iii): the rays of a CTA's lanes grouped by
      detector (detector, event, slot), 32 at a time by its warps;
    * ``warp_pull`` (iv): the rays of a warp's lanes pulled one at a time
      by whichever of its threads is free, a step of every thread's ray per
      trip of one loop: the warp's time is at least max(ceil(cost / 32),
      its longest ray), the bound given.

    Each gives ``warp_cost`` (the sum of the longest rays), ``rounds`` (the
    trips or rounds of 32) and ``efficiency`` = cost / (32 warp_cost); and
    ``rays`` and ``cost``, the block's totals.  The ratio of two designs'
    warp costs bounds the gain of the ray stage: the card bills latency,
    not lane use."""
    j, lane, d, cost = (r.long() for r in rays)
    dev = cost.device
    n_slots = order.numel()
    valid = order >= 0
    slot_of = torch.full((int(order.max()) + 1 if valid.any() else 1,), -1, dtype=torch.int64,
                         device=dev)
    slot_of[order[valid]] = torch.nonzero(valid).flatten()
    slot = slot_of[lane]
    if bool((slot < 0).any()):
        raise ValueError("ray_census: a ray's lane has no thread slot in the order")
    total = int(cost.sum())
    out = {"rays": int(cost.numel()), "cost": total}

    def fields(warp_cost: int, rounds: int) -> dict:
        return {"warp_cost": warp_cost, "rounds": rounds,
                "efficiency": total / (32 * warp_cost) if warp_cost else float("nan")}

    K = int(j.max()) + 1 if j.numel() else 1
    warp = slot // 32
    n_warps = -(-n_slots // 32)
    # (i): per (event, lane) the sum of its rays, per (event, warp) the largest
    lane_event = j * n_slots + slot
    le, inv = torch.unique(lane_event, return_inverse=True)
    sums = torch.zeros(le.numel(), dtype=torch.int64, device=dev).index_add_(0, inv, cost)
    trip = (le // n_slots) * n_warps + (le % n_slots) // 32
    tr, tinv = torch.unique(trip, return_inverse=True)
    top = torch.zeros(tr.numel(), dtype=torch.int64, device=dev)
    top.scatter_reduce_(0, tinv, sums, "amax")
    out["serial"] = fields(int(top.sum()), tr.numel())
    # (ii): a warp's rays in push order, 32 at a time
    key = ((warp * K + j) * n_slots + slot) * (int(d.max()) + 1 if d.numel() else 1) + d
    perm = torch.sort(key, stable=True).indices
    out["warp"] = fields(*_round_cost(cost[perm], warp[perm]))
    # (iii): a CTA's rays grouped by detector, 32 at a time
    cta = slot // cta_slots
    key = ((cta * (int(d.max()) + 1 if d.numel() else 1) + d) * K + j) * n_slots + slot
    perm = torch.sort(key, stable=True).indices
    out["cta_by_detector"] = fields(*_round_cost(cost[perm], cta[perm]))
    # (iv): a warp's rays pulled by its free threads
    w_ids, winv = torch.unique(warp, return_inverse=True)
    w_sum = torch.zeros(w_ids.numel(), dtype=torch.int64, device=dev).index_add_(0, winv, cost)
    w_max = torch.zeros_like(w_sum).scatter_reduce_(0, winv, cost, "amax")
    pull = torch.maximum(-(-w_sum // 32), w_max)
    out["warp_pull"] = fields(int(pull.sum()), w_ids.numel())
    return out


def census_orders(spec: GeneralSpec, opt: DeviceOptics, record: dict,
                  buckets=(2, KEY_BUCKETS, 8), tiles: int | None = None) -> dict:
    """``warp_census`` of one recorded block under (a) the first design's
    identity order (``identity``), (b) the compaction within each tile of
    CTA_THREADS lanes (``compact``), (c) (b) grouped by ``lane_keys``
    (``grouped_<n>`` for each bucket count n; not under maximum cross-
    section, which has no key), and the kernel's order, the compaction over
    groups of ``tiles`` tiles (``compact_tiles``; default ``cta_tiles`` of
    the block; only when more than one)."""
    entry = record["entry"]
    alive0 = entry.i[ALIVE] != 0
    steps, alive = record["steps"], record["alive"]
    if tiles is None:
        tiles = cta_tiles(entry.n_lanes, int(alive0.sum()))
    out = {"identity": warp_census(steps, alive, identity_order(entry.n_lanes, alive0.device)),
           "compact": warp_census(steps, alive, lane_order(alive0))}
    if tiles > 1:
        out["compact_tiles"] = warp_census(steps, alive, lane_order(alive0, tiles=tiles))
    if spec.mode != MAXCS:
        for n in buckets:
            out[f"grouped_{n}"] = warp_census(
                steps, alive, lane_order(alive0, lane_keys(spec, opt, entry, n), n))
    return out


# ---------------------------------------------------------------------------
# The CUDA kernel

class _Grid(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("nx", "ny", "nz", "xy_regular", "z_regular")] + [
        (n, ctypes.c_float) for n in ("x0", "y0", "z0", "x_max", "y_max", "z_max", "dx", "dy",
                                      "dz", "wx", "wy")] + [
        (n, ctypes.c_void_p) for n in ("xe", "ye", "ze")]


class _GeneralParams(ctypes.Structure):
    _fields_ = [("fine", _Grid), ("coarse", _Grid)] + [
        (n, ctypes.c_void_p) for n in ("total_ext", "cell", "majorant", "cubic")] + [
        (n, ctypes.c_int) for n in ("n_comp", "n_segments", "max_entries", "uniform_pf",
                                    "absorbing", "rr")] + [
        (n, ctypes.c_float) for n in ("uniform_coalb", "ssa", "inv_max_ext", "rr_w",
                                      "rr_half")] + [
        (n, ctypes.c_int) for n in ("max_crossings", "max_events", "n_draws", "d_accept",
                                    "d_srf_mu", "d_srf_phi", "d_comp", "d_extra",
                                    "srf_kind", "n_xs", "n_ys", "n_params")] + [
        ("albedo", ctypes.c_float),
        ("srf_params", ctypes.c_void_p), ("srf_xe", ctypes.c_void_p),
        ("srf_ye", ctypes.c_void_p)] + [
        (n, ctypes.c_float) for n in ("srf_x0", "srf_wx", "srf_y0", "srf_wy")] + [
        ("columns", ctypes.c_void_p), ("vol", ctypes.c_void_p),
        ("n_photons", ctypes.c_longlong), ("ctl", ctypes.c_void_p), ("dead", ctypes.c_void_p),
        ("src", _SourceParams)] + [
        (n, ctypes.c_uint32) for n in ("key0", "key1", "kb")] + [
        ("n_lanes", ctypes.c_int), ("K", ctypes.c_int)] + [
        (n, ctypes.c_int) for n in ("n_dirs", "est", "n_orig", "clip", "max_int_crossings",
                                    "ratio_crossings", "n_fwd")] + [
        (n, ctypes.c_float) for n in ("zeta", "zeta_ratio", "cap")] + [
        (n, ctypes.c_void_p) for n in ("dirs", "abs_mu", "exit_status", "det_phi", "forward",
                                       "forward_orig", "intensity", "by_comp", "excess",
                                       "int_steps", "int_rays", "flushes", "rays")]


def _grid(g: GridGeometry | None) -> _Grid:
    q = _Grid()
    if g is None:
        return q
    q.nx, q.ny, q.nz = g.n_x, g.n_y, g.n_z
    q.xy_regular, q.z_regular = int(g.xy_regular), int(g.z_regular)
    for n in ("x0", "y0", "z0", "x_max", "y_max", "z_max", "dx", "dy", "dz"):
        setattr(q, n, getattr(g, n))
    q.wx = float(np.float32(g.x_max - g.x0))
    q.wy = float(np.float32(g.y_max - g.y0))
    q.xe, q.ye, q.ze = (e.data_ptr() for e in (g.x_edges, g.y_edges, g.z_edges))
    return q


@functools.lru_cache(maxsize=None)
def build():
    """Compile (or reuse) the general kernel's library and declare its C
    interface (``csrc/general_event_block.cu`` and the detector set
    ``csrc/general_event_block_det.cu``, one ``nvcc`` process each)."""
    from i3rc_tpu_torch.kernels.build import build as _build

    built = _build("general_event_block", ("general_event_block.cu",
                                           "general_event_block_det.cu"))
    lib = built.lib
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.i3rc_general_params_size.argtypes = []
    lib.i3rc_general_params_size.restype = ci
    lib.i3rc_general_event_block.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    lib.i3rc_general_event_block.restype = ci
    if lib.i3rc_general_params_size() != ctypes.sizeof(_GeneralParams):
        raise RuntimeError("GeneralParams layout differs between Python and CUDA")
    return built


def launch_refusal(spec: GeneralSpec, var: Variant, opt: DeviceOptics) -> str | None:
    """Why the CUDA kernel does not run this block, or None when it does: a
    pure function of the spec, the variant and the optics' shapes."""
    if spec.K < 1:
        return f"the general block needs K >= 1 events per launch; got K={spec.K}"
    if var.n_draws > MAX_DRAWS:
        return f"the general block holds {MAX_DRAWS} draws per event; got {var.n_draws}"
    if spec.surface_kind > ALBEDO and spec.srf_params.shape[1] > MAX_BRDF_PARAMS:
        return f"the general block holds {MAX_BRDF_PARAMS} BRDF parameters"
    if var.bernoulli and spec.mode != WOODCOCK:
        return "the weight-1 class runs on Woodcock transport only"
    if var.bernoulli and spec.det is not None and spec.det.est != RATIO:
        return "the weight-1 class estimates radiance by ratio tracking only"
    if spec.det is not None and opt.n_components + 1 > RAY_MAX_SLOT:
        return (f"the estimate's ray record holds tally slots up to {RAY_MAX_SLOT}: at most "
                f"{RAY_MAX_SLOT - 1} components with detectors; got {opt.n_components}")
    return None


def _need(t, device, dtype, shape, what: str) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"general_block: {what} must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on the state's device")


def general_params(spec: GeneralSpec, var: Variant, opt: DeviceOptics, tables: DeviceTables,
                   state: GeneralState, buf: GeneralBuffers, key: PhiloxKey,
                   source: PhotonSource, kb: int) -> _GeneralParams:
    """The kernel's by-value parameter block for one launch."""
    p = _GeneralParams()
    p.fine, p.coarse = _grid(spec.geom), _grid(spec.coarse)
    p.total_ext, p.cell = opt.total_ext.data_ptr(), opt.cell_matrix.data_ptr()
    p.majorant = opt.block_majorant.data_ptr() if opt.block_majorant.numel() else None
    p.cubic = tables.inverse_cubic.data_ptr()
    p.n_comp, p.n_segments, p.max_entries = opt.n_components, tables.n_segments, \
        tables.max_entries
    p.uniform_pf = int(opt.uniform_phase_index) if var.uniform else 0
    p.absorbing, p.rr = int(var.absorbing), int(var.rr)
    p.uniform_coalb, p.ssa, p.inv_max_ext = var.coalb, var.ssa, var.inv_max_ext
    p.rr_w, p.rr_half = spec.rr_w, var.rr_half
    p.max_crossings, p.max_events, p.n_draws = spec.max_crossings, spec.max_events, var.n_draws
    slot = lambda n: var.draws.index(n) if n in var.draws else -1
    p.d_accept, p.d_srf_mu, p.d_srf_phi, p.d_comp = (slot(n) for n in ("accept", "srf_mu",
                                                                       "srf_phi", "comp"))
    p.d_extra = slot("abs") if var.bernoulli else slot("rr")
    p.srf_kind, p.albedo = spec.surface_kind, spec.albedo
    p.n_xs, p.n_ys = spec.n_xs, spec.n_ys
    if spec.srf_params is not None:
        p.n_params = spec.srf_params.shape[1]
        p.srf_params = spec.srf_params.data_ptr()
        p.srf_xe, p.srf_ye = spec.srf_x_edges.data_ptr(), spec.srf_y_edges.data_ptr()
        p.srf_x0, p.srf_wx, p.srf_y0, p.srf_wy = (spec.srf_x0, spec.srf_wx, spec.srf_y0,
                                                  spec.srf_wy)
    p.columns = buf.columns.data_ptr()
    p.vol = buf.vol.data_ptr() if spec.vol else None
    p.n_photons = spec.n_photons
    p.ctl, p.dead = buf.ctl.data_ptr(), buf.dead.data_ptr()
    for n, v in source_constants(source, state.f.device).items():
        if n == "dir":
            p.src.dir[:] = v
        else:
            setattr(p.src, n, v)
    g = spec.geom
    p.src.x0, p.src.wx = g.x0, g.x_max - g.x0
    p.src.y0, p.src.wy = g.y0, g.y_max - g.y0
    p.src.z0, p.src.wz = g.z0, g.z_max - g.z0
    p.key0, p.key1 = key.seed & 0xFFFFFFFF, key.batch & 0xFFFFFFFF
    p.kb = kb & 0xFFFFFFFF
    p.n_lanes, p.K = state.n_lanes, spec.K
    det = spec.det
    if det is not None:
        p.n_dirs, p.est, p.n_orig, p.clip = det.n, det.est, det.n_orig, int(det.clip)
        p.max_int_crossings, p.ratio_crossings = det.max_crossings, det.ratio_crossings
        p.n_fwd = tables.n_forward_steps
        p.zeta, p.zeta_ratio, p.cap = det.zeta, det.zeta_ratio, det.cap
        p.dirs, p.abs_mu = det.dirs.data_ptr(), det.abs_mu.data_ptr()
        p.exit_status, p.det_phi = det.exit_status.data_ptr(), det.phi.data_ptr()
        p.forward, p.forward_orig = tables.forward.data_ptr(), tables.forward_orig.data_ptr()
        p.intensity, p.by_comp = buf.intensity.data_ptr(), buf.by_component.data_ptr()
        p.excess, p.int_steps = buf.excess.data_ptr(), buf.int_steps.data_ptr()
        p.int_rays = buf.int_rays.data_ptr()
        p.flushes = ray_flush_counter(state.f.device).data_ptr()
        p.rays = ray_queue(buf, state.n_lanes, spec.K, GEN_RAY_F4).data_ptr()
    return p


def _launch(spec: GeneralSpec, var: Variant, opt: DeviceOptics, tables: DeviceTables,
            state: GeneralState, buf: GeneralBuffers, key: PhiloxKey, source: PhotonSource,
            kb: int) -> None:
    """Check the arguments and launch the kernel for block ``kb``."""
    f, i = state.f, state.i
    L, dev = state.n_lanes, f.device
    if i.device != dev or dev.type != "cuda":
        raise ValueError("general_block: state tensors must share one CUDA device")
    _need(f, dev, torch.float32, (7, L), "the state's f")
    _need(i, dev, torch.int32, (8, L), "the state's i")
    why = launch_refusal(spec, var, opt)
    if why:
        raise NotImplementedError(why)
    g = spec.geom
    # The parameter block is built once per trace (the same buffers, key,
    # optics and source objects); later blocks change its block index only.
    tag = (key, L, spec, var, opt, tables, source)
    cached = getattr(buf, "_params", None)
    if cached is not None and cached[0][:2] == tag[:2] and all(
            a is b for a, b in zip(cached[0][2:], tag[2:])):
        p = cached[1]
        p.kb = kb & 0xFFFFFFFF
    else:
        n = opt.n_components
        _need(opt.total_ext, dev, torch.float32, (g.n_cells,), "total_ext")
        _need(opt.cell_matrix, dev, torch.float32, (g.n_cells, 1 + 3 * n), "cell_matrix")
        if spec.coarse is not None:
            c = spec.coarse
            _need(opt.block_majorant, dev, torch.float32, (c.n_x * c.n_y * c.n_z,),
                  "block_majorant")
        _need(tables.inverse_cubic, dev, torch.float32,
              (n * tables.max_entries * tables.n_segments, 4), "inverse_cubic")
        _need(buf.columns, dev, torch.float64, (g.n_x * g.n_y, 3), "columns")
        _need(buf.vol, dev, torch.float64, (g.n_cells if spec.vol else 0,), "vol")
        _need(buf.ctl, dev, torch.int64, (4,), "ctl")
        _need(buf.dead, dev, torch.int32, (2, -(-L // CTA_THREADS)), "dead")
        det = spec.det
        if det is not None:
            D, n1 = det.n, det.n_comp + 1
            n_fwd = n * tables.max_entries * tables.n_forward_steps
            for t, dt, shape, what in (
                    (det.dirs, torch.float32, (3, D), "detector directions"),
                    (det.abs_mu, torch.float32, (D,), "abs_mu"),
                    (det.exit_status, torch.int32, (D,), "exit_status"),
                    (det.phi, torch.float32, (D,), "detector azimuths"),
                    (tables.forward, torch.float32, (n_fwd,), "forward"),
                    (tables.forward_orig, torch.float32, (n_fwd,), "forward_orig"),
                    (buf.intensity, torch.float64, (g.n_x * g.n_y * D,), "intensity"),
                    (buf.by_component, torch.float64, (g.n_x * g.n_y * D * n1,), "by_component"),
                    (buf.excess, torch.float64, (D * n1,), "excess"),
                    (buf.int_steps, torch.int32, (L,), "int_steps"),
                    (buf.int_rays, torch.int32, (L,), "int_rays")):
                _need(t, dev, dt, shape, what)
        p = general_params(spec, var, opt, tables, state, buf, key, source, kb)
        buf._params = (tag, p)
    lib = build().lib
    with torch.cuda.device(dev):
        rc = lib.i3rc_general_event_block(
            f.data_ptr(), i.data_ptr(), ctypes.byref(p), spec.mode, int(var.uniform),
            int(spec.surface_kind != 0), int(var.bernoulli),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"general_event_block launch: CUDA error {rc}")


def general_block(spec: GeneralSpec, var: Variant, opt: DeviceOptics, tables: DeviceTables,
                  state: GeneralState, buf: GeneralBuffers, key: PhiloxKey,
                  source: PhotonSource, kb: int) -> None:
    """One block ``kb`` of the general trace loop, in place on ``state`` and
    ``buf``: the refill, K events (with detectors their local estimates),
    the loop's control state.  On CUDA tensors one launch of the kernel,
    counted in ``general_block.launches`` (per transport mode in
    ``general_block.mode_launches``, and those with detectors, which run the
    estimate stage, in ``general_block.det_launches``), and nothing else;
    on CPU tensors ``general_block_reference``."""
    dev = state.f.device
    if dev.type == "cuda":
        _launch(spec, var, opt, tables, state, buf, key, source, kb)
        general_block.launches += 1
        general_block.mode_launches[MODE_NAMES[spec.mode]] += 1
        general_block.det_launches += int(spec.det is not None)
    elif dev.type == "cpu":
        general_block_reference(spec, var, opt, tables, state, buf, key, source, kb)
    else:
        raise NotImplementedError(f"general_block: no kernel for device {dev}")




def ray_queue(buf, n_lanes: int, K: int, f4: int) -> torch.Tensor:
    """The device scratch of a kernel's ray queue (``rays`` of G's or PZ's
    parameter block): room for a record of ``f4`` float4 words at every
    event of every lane, CTA by CTA (a CTA's segment is its tiles' lanes x
    K records).  Made at the first launch with ``buf`` and kept on it; its
    contents do not outlive a launch."""
    n = -(-n_lanes // CTA_THREADS) * CTA_THREADS * K * f4 * 4
    t = getattr(buf, "_rays", None)
    if t is None or t.numel() < n or t.device != buf.ctl.device:
        t = torch.empty(n, dtype=torch.float32, device=buf.ctl.device)
        buf._rays = t
    return t


def device_counter(counters: dict, device) -> torch.Tensor:
    """The int64 (1,) counter of ``counters`` on ``device`` (``cuda`` is the
    current card), made at first use: a normal tensor even when that use is
    inside a trace's inference mode, so that ``reset_launch_counters`` can
    zero it outside one."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in counters:
        with torch.inference_mode(False):
            counters[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    return counters[dev]


_FLUSHES: dict = {}


def ray_flush_counter(device) -> torch.Tensor:
    """int64 (1,) on ``device``: the flushes of the estimate stage's ray
    queue (one a working CTA that queued a record: the CTA's rays traced
    after its lanes' events) that the kernel has counted since
    ``reset_launch_counters``; a diagnostic of the card only."""
    return device_counter(_FLUSHES, device)


def reset_launch_counters() -> None:
    general_block.launches = general_block.det_launches = 0
    general_block.mode_launches = {name: 0 for name in MODE_NAMES.values()}
    for t in _FLUSHES.values():
        t.zero_()


reset_launch_counters()
