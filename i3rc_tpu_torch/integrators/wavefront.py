"""Transport primitives and the general transport kernel's flux path.

Port of ``i3rc_tpu/integrators/wavefront.py``: the raw tally record, the
direction helpers, the surface and intensity specs, and the general
wavefront kernel (``make_batch_tracer``, wavefront.py:657) for flux:
voxel ray tracing, maximum cross-section against the global majorant and
super-voxel Woodcock against block majorants; any number of components
with per-cell ssa and phase index sampled from the piecewise-cubic inverse
CDF; weight-carrying absorption with Russian roulette, or the weight-1
class of ``make_chained_flux_tracer`` (Bernoulli absorption); black,
Lambertian-albedo and gridded BRDF surfaces; flux up, down and absorbed per
column and the volume absorption.  ``general_event`` is one ``event_step``
(wavefront.py:1144-1540, flux branch) as torch ops on (L,) lane tensors:
the plain version of the CUDA event block (``kernels/general_block.py``).

Differences from the JAX kernel, none of them in the estimator:
  * dead lanes are refilled at the start of a K-event block, in FIFO order
    from the photon budget, not before every event: that changes the random
    stream (which photon a lane carries when), not what a photon does;
  * draws come from the port's Philox stream (``core/rng.py``), event j of
    block kb reading group j * G + d // 4, word d % 4 for its draw d;
  * the chained tracer's schedule (``general_chain`` cycles of
    ``general_dda_steps`` crossings per iteration) is TPU scheduling: the
    port keeps its estimator (weight 1, Bernoulli survival, exits and
    deaths as counts) and traces each flight to its end;
  * tallies are float64 sums, added as the events happen (no one-hot
    matmul: the card reads and adds by index);
  * a maximum cross-section exit is placed on the boundary plane from the
    lane's own position (x + ux * d, d the distance to the plane), not by
    tracing back from the jump's end (px - ux * bt, :1277-1283): when the
    jump is far longer than the domain (a majorant near 0; 1e30 m at 0) the
    jump's end has lost x and y to rounding, and the reference's exit
    column is noise.

Float32 arithmetic follows the JAX functions operation by operation (same
order, same constants rounded to float32), so the port and the reference
agree to a few ulps on identical inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from i3rc_tpu_torch.core.rng import TINY, exponential_deviate
from i3rc_tpu_torch.ops.dda import (
    BAD,
    EXIT_BOT,
    EXIT_TOP,
    SCATTER,
    fmod_positive,
    trace_extinction,
)


def f32(v) -> float:
    """A Python float holding the float32 rounding of v.

    Torch applies a Python scalar to a float32 tensor in float32, so passing
    the float32 value of each constant reproduces the JAX arithmetic.
    """
    return float(np.float32(v))


@dataclass(frozen=True)
class SurfaceSpec:
    """Either a scalar Lambertian albedo or a gridded BRDF (host data):
    ``brdf_fn`` the torch kernel of ``core/surface.py`` registered as
    ``brdf_name``."""

    albedo: float = 0.0
    brdf_fn: object = None
    brdf_name: str | None = None
    params: object = None     # np.ndarray (nxs*nys, n_params)
    x_edges: object = None
    y_edges: object = None
    n_xs: int = 1
    n_ys: int = 1

    @property
    def uses_brdf(self) -> bool:
        return self.brdf_fn is not None


@dataclass(frozen=True)
class IntensitySpec:
    directions: np.ndarray     # (3, D) unit vectors
    abs_mu: np.ndarray         # (D,)
    exit_status: np.ndarray    # (D,) int32: EXIT_TOP for up-going, EXIT_BOT down
    n_directions: int


@dataclass(frozen=True)
class RawTallies:
    """Un-normalized accumulators (sums of photon weights, float64)."""

    flux_up: torch.Tensor          # (nx*ny,)
    flux_down: torch.Tensor
    flux_absorbed: torch.Tensor
    volume_absorption: torch.Tensor  # (nx*ny*nz,)
    intensity: torch.Tensor          # (nx*ny*D,) or (0,)
    intensity_by_component: torch.Tensor  # (nx*ny*D*(ncomp+1),) or (0,)
    intensity_excess: torch.Tensor        # (D*(ncomp+1),) or (0,)
    n_photons: int
    n_bad: torch.Tensor            # scalar int64
    n_iterations: int              # event-loop trips (diagnostic)
    n_lane_events: torch.Tensor    # scalar: total live lane-events (diagnostic)
    n_dda_steps: torch.Tensor | None = None  # scalar: DDA crossings (general kernel; diagnostic)


def make_direction_cosines(mu, phi):
    """(sin t cos p, sin t sin p, mu) — makeDirectionCosines (:2041-2059)."""
    sin_theta = torch.sqrt(torch.clamp(1.0 - mu * mu, min=0.0))
    return sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), mu


# Quarter-wave polynomial coefficients of _sincos_2pi, as float32 values.
SINCOS_S = tuple(f32(c) for c in (1.5707924, -0.64590601, 0.07946485, -0.0043527978))
SINCOS_C = tuple(f32(c) for c in (0.99999997, -1.2336987, 0.25365383, -0.020816208,
                                  8.612909e-4))


def _sincos_2pi(u):
    """(sin, cos) of 2 pi u for u in [0, 1) — quarter-wave polynomials.

    The azimuth deviate spans exactly one period, so no range reduction is
    needed: quadrant from floor(4u), then degree-7/8 least-squares fits on
    the quarter wave (max error 1.6e-6).
    """
    s0, s1, s2, s3 = SINCOS_S
    c0, c1, c2, c3, c4 = SINCOS_C
    t = 4.0 * u
    q = torch.floor(t)
    r = t - q
    r2 = r * r
    s = r * (s0 + r2 * (s1 + r2 * (s2 + r2 * s3)))
    c = c0 + r2 * (c1 + r2 * (c2 + r2 * (c3 + r2 * c4)))
    swap = (q == 1.0) | (q == 3.0)
    sin_q = torch.where(swap, c, s)
    cos_q = torch.where(swap, s, c)
    sign_sin = torch.where(q >= 2.0, -1.0, 1.0)
    sign_cos = torch.where((q == 1.0) | (q == 2.0), -1.0, 1.0)
    return sign_sin * sin_q, sign_cos * cos_q


def rotate_direction(ux, uy, uz, cos_scat, u_azimuth, renormalize=True):
    """New direction after scattering by cos_scat with uniform azimuth.

    Physics-equivalent replacement for NEXT_DIRECT (:2086-2113): chi = 2 pi u
    feeds the standard rotation, branch-free.  renormalize=False skips the
    final rescale for hot paths that renormalize in bulk elsewhere (the
    fastpath renormalizes once per K-event block).
    """
    sin_chi, cos_chi = _sincos_2pi(u_azimuth)
    sin_scat = torch.sqrt(torch.clamp(1.0 - cos_scat * cos_scat, min=0.0))
    denom2 = torch.clamp(1.0 - uz * uz, min=0.0)
    # sqrt then an IEEE reciprocal, as the CUDA kernel computes it (torch's
    # CUDA rsqrt is an approximation).
    rs = torch.sqrt(torch.clamp(denom2, min=f32(1e-12))).reciprocal()
    denom = denom2 * rs
    near_pole = denom < f32(1e-6)
    inv_denom = torch.where(near_pole, 0.0, rs)
    nx = sin_scat * (ux * uz * cos_chi - uy * sin_chi) * inv_denom + ux * cos_scat
    ny = sin_scat * (uy * uz * cos_chi + ux * sin_chi) * inv_denom + uy * cos_scat
    nz = -sin_scat * cos_chi * denom + uz * cos_scat
    # Vertical incidence limit: rotate about z directly.
    sgn_z = torch.where(uz >= 0.0, 1.0, -1.0)
    pol_x = sin_scat * cos_chi
    pol_y = sgn_z * sin_scat * sin_chi
    pol_z = sgn_z * cos_scat
    nx = torch.where(near_pole, pol_x, nx)
    ny = torch.where(near_pole, pol_y, ny)
    nz = torch.where(near_pole, pol_z, nz)
    if not renormalize:
        return nx, ny, nz
    norm = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=f32(1e-12)))
    return nx * norm, ny * norm, nz * norm


# ---------------------------------------------------------------------------
# The general transport kernel (flux)
# ---------------------------------------------------------------------------

# Rows of the JAX package's one-hot read limit (i3rc_tpu/ops/gather.py): the
# create-time rule for block majorants, the weight-1 class and the column
# fastpath's eligibility read it.
ONEHOT_MAX_ROWS = 1 << 18
_MIN_MU = f32(1e-6)         # surface-reflection vertical floor (:542-549)
_TWO_PI = f32(2.0 * np.pi)
# Transport modes of the general kernel (template parameter MODE of the CUDA
# kernel): voxel ray tracing, maximum cross-section, super-voxel Woodcock.
RT, MAXCS, WOODCOCK = 0, 1, 2


@dataclass(frozen=True)
class DeviceOptics:
    """Flattened optics on the device (wavefront.py:77-117).

    ``cell_matrix`` packs every per-cell quantity as float32 columns,
    [ total_ext | cum_1..cum_n | (1-ssa)_1..(1-ssa)_n | pfidx_1..pfidx_n ]:
    the absorption block holds the CO-albedo, so that nearly conservative
    media keep their absorbed fraction's relative accuracy.  ``total_ext``
    is its first column, contiguous (the DDA reads it per crossing);
    ``block_majorant`` the super-voxel majorants, (0,) when off.  The
    spectral loop swaps per-k optics of the same shape through the same
    tracer.  ``uniform_ssa`` / ``uniform_phase_index``: a single component
    whose ssa / phase index are the same in every cell with extinction (the
    kernel then reads only the extinction and skips the component pick)."""

    cell_matrix: torch.Tensor    # (n_cells, 1 + 3 n_components) float32
    total_ext: torch.Tensor      # (n_cells,) float32
    max_extinction: float        # a float32 value
    block_majorant: torch.Tensor  # (n_blocks,) float32
    n_components: int
    uniform_ssa: float | None = None
    uniform_phase_index: int | None = None

    @property
    def n_cells(self) -> int:
        return self.total_ext.shape[0]

    @property
    def uniform(self) -> bool:
        """The static single-component specialization (wavefront.py:1174-1176)."""
        return (self.n_components == 1 and self.uniform_ssa is not None
                and self.uniform_phase_index is not None)


@dataclass(frozen=True)
class DeviceTables:
    """The piecewise-cubic inverse CDF of every (component, phase entry):
    ``inverse_cubic`` (n_components * max_entries * n_segments, 4) float32
    (tables.build_inverse_cubic)."""

    inverse_cubic: torch.Tensor
    n_segments: int
    max_entries: int


def sample_cos_scat(tables: DeviceTables, comp, pf_idx, u):
    """Scattering-angle cosine from the piecewise-cubic inverse CDF
    (wavefront.py:772-781)."""
    s = tables.n_segments
    pos = torch.clamp(u, 0.0, 1.0) * float(s)
    seg = torch.clamp(pos.to(torch.int32), 0, s - 1)
    t = pos - seg.to(pos.dtype)
    row = (comp * tables.max_entries + pf_idx) * s + seg
    c = tables.inverse_cubic[row.long()]
    mu = ((c[:, 3] * t + c[:, 2]) * t + c[:, 1]) * t + c[:, 0]
    return torch.clamp(mu, -1.0, 1.0)


def surface_reflectance(spec, x, y, mu_in, mu_out, phi_in, phi_out):
    """computeSurfaceReflectance (surfaceProperties.f95:121-148; wavefront.py:
    783-796): the albedo, or the BRDF with the parameters of the surface
    cell that holds (x, y), periodically wrapped."""
    if spec.brdf_fn is None:
        return torch.full_like(x, spec.albedo)
    xe, ye = spec.srf_x_edges, spec.srf_y_edges
    xp = spec.srf_x0 + fmod_positive(x - spec.srf_x0, spec.srf_wx)
    yp = spec.srf_y0 + fmod_positive(y - spec.srf_y0, spec.srf_wy)
    ixs = torch.clamp(torch.searchsorted(xe, xp.contiguous(), right=True) - 1, 0,
                      spec.n_xs - 1)
    iys = torch.clamp(torch.searchsorted(ye, yp.contiguous(), right=True) - 1, 0,
                      spec.n_ys - 1)
    params = spec.srf_params[ixs * spec.n_ys + iys]
    return spec.brdf_fn([params[:, k] for k in range(params.shape[1])],
                        mu_in, mu_out, phi_in, phi_out)


def general_event(spec, var, opt: DeviceOptics, tables: DeviceTables, u, s: dict,
                  columns, vol) -> None:
    """One ``event_step`` (wavefront.py:1144-1540, the flux branch) on the lane
    tensors in ``s``, in place: free path, transport (DDA, maximum cross-
    section jump or Woodcock on the block majorants), exits, the surface,
    the collision (component pick, absorption by weight or, in the weight-1
    class, by survival; roulette; the inverse-CDF angle and rotation) and
    the budgets.  ``u`` is the event's (n_draws, L) draws in the order of
    ``var.draws``; exits and absorption add float64 weights to ``columns``
    ((n_cols, 3): up, down, absorbed) and, with the volume tally, ``vol``
    ((n_cells,))."""
    d = {n: u[k] for k, n in enumerate(var.draws)}
    geom = spec.geom
    alive = s["alive"]
    x, y, z, ux, uy, uz, w = (s[k] for k in ("x", "y", "z", "ux", "uy", "uz", "w"))
    tau = exponential_deviate(d["tau"])
    zeros_b = torch.zeros_like(alive)

    if spec.mode == RT:
        # Ray tracing: travel until tau extinction accumulates (:481-487).
        rx, ry, rz, rix, riy, riz, _, status = trace_extinction(
            geom, opt.total_ext, x, y, z, s["ix"], s["iy"], s["iz"], ux, uy, uz, tau, alive,
            spec.max_crossings, steps=s["xing"])
        bad = alive & (status == BAD)
    elif spec.mode == WOODCOCK:
        # Tentative collision by the DDA over the block-majorant grid; the
        # fine cell is located again from the stop position.
        cg = spec.coarse
        rx, ry, rz, fbx, fby, fbz, _, status = trace_extinction(
            cg, opt.block_majorant, x, y, z, cg.locate_x(x), cg.locate_y(y), cg.locate_z(z),
            ux, uy, uz, tau, alive, spec.max_crossings, steps=s["xing"])
        bad = alive & (status == BAD)
        rix, riy, riz = geom.locate_x(rx), geom.locate_y(ry), geom.locate_z(rz)
        maj = opt.block_majorant[((fbx * cg.n_y + fby) * cg.n_z + fbz).long()]
        inv_maj = 1.0 / torch.clamp(maj, min=f32(1e-30))
    if spec.mode != MAXCS:
        exit_top = alive & (status == EXIT_TOP)
        exit_bot = alive & (status == EXIT_BOT)
        collide = alive & (status == SCATTER)
    else:
        # Maximum cross-section jump (:492-497), exits placed on the
        # boundary plane for the tally column (:504-527; module docstring).
        step = tau * var.inv_max_ext
        px, py, pz = x + ux * step, y + uy * step, z + uz * step
        exit_top = alive & (pz >= geom.z_max)
        exit_bot = alive & ~exit_top & (pz <= geom.z0)
        collide = alive & ~exit_top & ~exit_bot
        safe_uz = torch.where(torch.abs(uz) > f32(1e-30), uz, 1.0)
        dist = torch.abs(torch.where(exit_top, (geom.z_max - z) / safe_uz,
                                     (geom.z0 - z) / safe_uz))
        hit = exit_top | exit_bot
        rx = geom.wrap_x(torch.where(hit, x + ux * dist, px))
        ry = geom.wrap_y(torch.where(hit, y + uy * dist, py))
        rz = torch.where(exit_top, geom.z_max, torch.where(exit_bot, geom.z0, pz))
        rix, riy, riz = geom.locate_x(rx), geom.locate_y(ry), geom.locate_z(rz)
        bad = zeros_b
    flat = ((rix * geom.n_y + riy) * geom.n_z + riz).long()

    # The cell's optics: the extinction alone, or the packed row.
    n = opt.n_components
    if var.uniform:
        cell_ext = opt.total_ext[flat]
    else:
        row = opt.cell_matrix[flat]
        cell_ext = row[:, 0]
    if spec.mode == RT:
        physical = collide
    elif spec.mode == WOODCOCK:
        physical = collide & (d["accept"] < cell_ext * inv_maj)
    else:
        physical = collide & (d["accept"] < cell_ext * var.inv_max_ext)

    # The surface (:1315-1330).
    if spec.surface_kind == 0:
        w_srf = torch.zeros_like(w)
        surf_alive = zeros_b
        sux, suy, suz = ux, uy, uz
    else:
        mu_s = torch.clamp(torch.sqrt(d["srf_mu"]), min=_MIN_MU)
        phi_s = _TWO_PI * d["srf_phi"]
        refl = surface_reflectance(spec, rx, ry, uz, mu_s, torch.atan2(uy, ux), phi_s)
        w_srf = w * refl
        surf_alive = exit_bot & (w_srf > TINY)
        sux, suy, suz = make_direction_cosines(mu_s, phi_s)

    # The collision: component pick and absorption (:1332-1349).
    if var.uniform:
        comp = torch.zeros_like(rix)
        coalb = torch.full_like(w, var.coalb)
        pf_idx = torch.full_like(rix, int(opt.uniform_phase_index))
    else:
        cum = row[:, 1:1 + n]
        comp = torch.clamp((d["comp"][:, None] >= cum).sum(dim=1, dtype=torch.int32), 0, n - 1)
        pick = comp.long()[:, None]
        coalb = row[:, 1 + n:1 + 2 * n].gather(1, pick)[:, 0]
        pf_idx = row[:, 1 + 2 * n:1 + 3 * n].gather(1, pick)[:, 0].to(torch.int32)
    col = (rix * geom.n_y + riy).long()
    if var.bernoulli:
        # The weight-1 class (wavefront.py:264-315): survival with
        # probability ssa, exits and deaths as counts.
        died = physical & (d["abs"] >= var.ssa) if var.absorbing else zeros_b
        w_sc = torch.where(died, 0.0, w)
        absorbed = torch.where(died, 1.0, 0.0)
        order_next = s["order"] + physical.to(torch.int32)
    else:
        absorbed = torch.where(physical, w * coalb, 0.0)
        w_sc = w * (1.0 - coalb)
        order_next = s["order"] + (physical | exit_bot).to(torch.int32)
    columns.index_add_(0, col, torch.stack([torch.where(exit_top, w, 0.0),
                                            torch.where(exit_bot, w, 0.0),
                                            absorbed], dim=1).to(torch.float64))
    if spec.vol:
        vol.index_add_(0, flat, absorbed.to(torch.float64))
    math_move = collide & ~physical if spec.mode != RT else zeros_b

    # Russian roulette (:1499-1505).
    if var.rr:
        do_rr = physical & (w_sc < var.rr_half)
        killed = do_rr & (d["rr"] >= w_sc / torch.full_like(w_sc, spec.rr_w))
        w_sc = torch.where(do_rr, torch.where(killed, 0.0, spec.rr_w), w_sc)
    scat_alive = physical & (w_sc > TINY)

    # The scattering angle and rotation (:1507-1509).
    cos_scat = sample_cos_scat(tables, comp, pf_idx, d["scat"])
    nux, nuy, nuz = rotate_direction(ux, uy, uz, cos_scat, d["chi"])

    over_budget = (scat_alive | surf_alive) & (order_next >= spec.max_events)
    moved = scat_alive | surf_alive | math_move
    s["x"] = torch.where(moved, rx, x)
    s["y"] = torch.where(moved, ry, y)
    s["z"] = torch.where(surf_alive, geom.z0, torch.where(moved, rz, z))
    if spec.mode == RT:
        s["ix"] = torch.where(moved, rix, s["ix"])
        s["iy"] = torch.where(moved, riy, s["iy"])
        s["iz"] = torch.where(surf_alive, 0, torch.where(moved, riz, s["iz"]))
    s["ux"] = torch.where(scat_alive, nux, torch.where(surf_alive, sux, ux))
    s["uy"] = torch.where(scat_alive, nuy, torch.where(surf_alive, suy, uy))
    s["uz"] = torch.where(scat_alive, nuz, torch.where(surf_alive, suz, uz))
    s["w"] = torch.where(physical, w_sc, torch.where(exit_bot, w_srf, w))
    s["order"] = order_next
    s["alive"] = (scat_alive | surf_alive | math_move) & ~over_budget
    s["bad"] = s["bad"] + (bad | over_budget).to(torch.int32)
    s["evct"] = s["evct"] + (exit_top | exit_bot | collide).to(torch.int32)


def make_batch_tracer(geom, optics: DeviceOptics, tables: DeviceTables, surface, intensity,
                      config, n_photons: int, n_lanes: int | None = None,
                      coarse_geom=None):
    """Build trace(key, batch, source, optics_override=None) -> RawTallies
    for the general kernel (wavefront.py:657): one ``general_block`` per
    K-event block (on a card one launch of the CUDA kernel, on the CPU its
    plain version), the loop's end a device flag read every
    ``fastpath.CHECK_EVERY`` blocks.  Radiance detectors on the general
    kernel are ROADMAP item 16b."""
    if intensity is not None:
        raise NotImplementedError(
            "radiance detectors on the general kernel (no fastpath plan): ROADMAP item 16b")
    from i3rc_tpu_torch.integrators.fastpath import CHECK_EVERY, lane_width
    from i3rc_tpu_torch.kernels import general_block as gb

    L = lane_width(n_photons, n_lanes)
    spec = gb.general_spec(geom, coarse_geom, surface, config, n_photons)
    # Global hang guard (counts K-event blocks): the JAX kernel's event cap,
    # max_events * (n_photons // L + 2) events.
    max_blocks = -(-config.max_events * (n_photons // L + 2) // spec.K)

    @torch.inference_mode()
    def trace(key, batch, source, optics_override=None) -> RawTallies:
        opt = optics if optics_override is None else optics_override
        if opt.n_components != optics.n_components:
            raise ValueError("optics override must keep the number of components")
        var = gb.variant(spec, opt)
        st = gb.launch_state(spec, batch, n_photons)
        buf = gb.general_buffers(spec, st, min(L, n_photons))
        kb, done = 0, -1
        while kb < max_blocks and done < 0:
            gb.general_block(spec, var, opt, tables, st, buf, key, source, kb)
            kb += 1
            if kb % CHECK_EVERY == 0 or kb == max_blocks:
                done = int(buf.ctl[gb.DONE])
        i = st.i
        # Lanes alive at the block cap vanish with their weight: count bad.
        n_bad = i[gb.BAD].sum(dtype=torch.int64) + i[gb.ALIVE].sum(dtype=torch.int64)
        n_blocks = done if done >= 0 else kb
        n_cols = geom.n_x * geom.n_y
        zeros = lambda m: torch.zeros(m, dtype=torch.float64, device=buf.columns.device)
        return RawTallies(
            flux_up=buf.columns[:, 0], flux_down=buf.columns[:, 1],
            flux_absorbed=buf.columns[:, 2],
            volume_absorption=buf.vol if spec.vol else zeros(n_cols * geom.n_z),
            intensity=zeros(0), intensity_by_component=zeros(0), intensity_excess=zeros(0),
            n_photons=int(n_photons), n_bad=n_bad, n_iterations=n_blocks * spec.K,
            n_lane_events=i[gb.EVCT].sum(dtype=torch.int64),
            n_dda_steps=i[gb.XING].sum(dtype=torch.int64))

    trace.spec = spec
    return trace
