"""Transport primitives and the general transport kernel (flux and radiance).

Port of ``i3rc_tpu/integrators/wavefront.py``: the raw tally record, the
direction helpers, the surface and intensity specs, and the general
wavefront kernel (``make_batch_tracer``, wavefront.py:657): voxel ray
tracing, maximum cross-section against the global majorant and
super-voxel Woodcock against block majorants; any number of components
with per-cell ssa and phase index sampled from the piecewise-cubic inverse
CDF; weight-carrying absorption with Russian roulette, or the weight-1
class of ``make_chained_flux_tracer`` (Bernoulli absorption); black,
Lambertian-albedo and gridded BRDF surfaces; flux up, down and absorbed per
column, the volume absorption, and local-estimate radiance toward each
detector direction (``intensity_estimate``: the phase value at the
photon-to-detector angle from the forward tables, hybrid or original by
order, the surface's 1/pi or BRDF value, and the transmittance to the
boundary by the exact trace, Iwabuchi roulette or ratio tracking, with
optional clipping).  ``general_event`` is one ``event_step``
(wavefront.py:1144-1540) as torch ops on (L,) lane tensors: the plain
version of the CUDA event block (``kernels/general_block.py``).

Differences from the JAX kernel, none of them in the estimator:
  * dead lanes are refilled at the start of a K-event block, in FIFO order
    from the photon budget, not before every event: that changes the random
    stream (which photon a lane carries when), not what a photon does;
  * draws come from the port's Philox stream (``core/rng.py``), event j of
    block kb reading group j * G + d // 4, word d % 4 for its draw d; the
    local estimate's from ``rng.STREAM_INTENSITY`` (``rng.intensity_group``);
  * the chained tracer's schedule (``general_chain`` cycles of
    ``general_dda_steps`` crossings per iteration) is TPU scheduling: the
    port keeps its estimator (weight 1, Bernoulli survival, exits and
    deaths as counts; with detectors the prefactor ssa P / (4 pi |mu_d|)
    at every physical collision and ratio-tracked rays, a bad or over-long
    ray counted bad) and traces each flight and each ray to its end;
  * so is the queued local estimation (``use_queued_intensity``,
    ``intensity_ray_steps``: persistent ray slots and frozen lanes, whose
    expectations are the inline estimator's, wavefront.py:1387-1394): the
    port accepts both fields and runs the inline estimator, every ray of a
    collision traced to its end by the thread that collided;
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

from i3rc_tpu_torch.core.rng import (
    TINY,
    exponential_deviate,
    intensity_group,
    intensity_uniforms,
)
from i3rc_tpu_torch.ops.dda import (
    BAD,
    EXIT_BOT,
    EXIT_TOP,
    SCATTER,
    _div,
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
    n_int_steps: torch.Tensor | None = None  # scalar: the local estimate's DDA steps (diagnostic)
    n_int_rays: torch.Tensor | None = None   # scalar: the local estimate's rays (diagnostic)


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
    (tables.build_inverse_cubic); with radiance detectors the phase values
    on ``n_forward_steps`` equally spaced angles of [0, pi], ``forward``
    (n_components * max_entries * n_forward_steps,) float32, hybridized when
    the config asks for hybrid phase functions, and ``forward_orig``, the
    original values (tables.build_forward_tables; wavefront.py:121-127)."""

    inverse_cubic: torch.Tensor
    n_segments: int
    max_entries: int
    forward: torch.Tensor | None = None
    forward_orig: torch.Tensor | None = None
    n_forward_steps: int = 0


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


def table_lookup(flat_table, row_base, position, n_steps: int):
    """Linear interpolation into rows of a flattened (rows, n_steps) table,
    grid points at i / (n_steps - 1) of ``position`` in [0, 1]
    (_table_lookup, wavefront.py:251-261)."""
    pos = torch.clamp(position, 0.0, 1.0) * float(n_steps - 1)
    i0 = torch.clamp(pos.to(torch.int32), 0, n_steps - 2)
    frac = pos - i0.to(pos.dtype)
    idx = (row_base + i0).long()
    return (1.0 - frac) * flat_table[idx] + frac * flat_table[idx + 1]


# ---------------------------------------------------------------------------
# Local estimation (radiance detectors) of the general kernel

# Estimators of the transmittance to the boundary (DetectorSet.est): the
# exact trace on the fine grid, Iwabuchi (2006) roulette on it, ratio
# tracking over the block majorants (wavefront.py:933-982).
EXACT, IWABUCHI, RATIO = 0, 1, 2
_PI = f32(np.pi)
_FOUR_PI = f32(4.0 * np.pi)
_INV_PI = f32(1.0 / np.pi)
_TRACE_TARGET = f32(3.0e38)


@dataclass(frozen=True)
class DetectorSet:
    """The detectors of a general-kernel tracer, on its device: D (``n``)
    unit ``dirs`` (3, D) float32, the optics' ``n_comp`` components (the
    radiance by component has n_comp + 1 slots), ``abs_mu`` (D,) float32,
    ``exit_status`` (D,) int32 (EXIT_TOP for up-going directions), ``phi``
    (D,) float32
    atan2(dir_y, dir_x) (the BRDF's outgoing azimuth); the estimator
    ``est``, float32 ``zeta`` (zeta_min) and ``zeta_ratio`` (max(zeta_min,
    1e-3), ratio tracking's roulette), ``n_orig`` (orders <= n_orig read the
    original phase table under hybrid phase functions; 0 never), the clip
    ``cap`` (``clip`` on), ``max_crossings`` (the fine trace's crossing
    budget, ratio tracking's round budget) and ``ratio_crossings`` (the
    crossing budget of one ratio-tracking flight on the block grid)."""

    n: int
    n_comp: int
    dirs: torch.Tensor
    abs_mu: torch.Tensor
    exit_status: torch.Tensor
    phi: torch.Tensor
    est: int
    zeta: float
    zeta_ratio: float
    n_orig: int
    clip: bool
    cap: float
    max_crossings: int
    ratio_crossings: int


def ratio_transmittance(spec, opt: DeviceOptics, key, kb: int, j: int, lane, d, px, py, pz,
                        dx, dy, dz, steps, rounds: int):
    """Ratio tracking to the boundary over the block majorants
    (ratio_transmittance, wavefront.py:798-855) of the (lane, detector)
    rays: free paths against the majorants of ``spec.coarse``, each
    tentative collision multiplying T by clip(1 - ext / majorant, 0, 1),
    roulette of T at ``zeta_ratio``; round r draws words 2 (r % 2) and 2 (r
    % 2) + 1 of pair r // 2.  At most ``rounds`` rounds.  Returns (T, exit
    column index x, y, escaped through the detector's side, the ray ended
    bad: a bad flight or alive after the last round); ``steps`` counts each
    ray's DDA steps in place."""
    det, cg, g = spec.det, spec.coarse, spec.geom
    n = px.shape[0]
    T = torch.ones(n, dtype=torch.float32, device=px.device)
    fix = torch.zeros(n, dtype=torch.int32, device=px.device)
    fiy = torch.zeros_like(fix)
    esc = torch.zeros(n, dtype=torch.bool, device=px.device)
    bad = torch.zeros_like(esc)
    live = torch.ones_like(esc)
    exit_d = det.exit_status[d]
    for r in range(rounds):
        idx = torch.nonzero(live).flatten()
        if idx.numel() == 0:
            break
        group = intensity_group(j, d[idx].long(), r >> 1, spec.K, det.n)
        u = intensity_uniforms(key, kb, lane[idx].long(), group)
        w0 = 2 * (r & 1)
        u_free, u_kill = u[w0], u[w0 + 1]
        x0, y0, z0 = px[idx], py[idx], pz[idx]
        st = torch.zeros(idx.numel(), dtype=torch.int32, device=px.device)
        rx, ry, rz, fbx, fby, fbz, _, status = trace_extinction(
            cg, opt.block_majorant, x0, y0, z0, cg.locate_x(x0), cg.locate_y(y0),
            cg.locate_z(z0), dx[idx], dy[idx], dz[idx], exponential_deviate(u_free),
            torch.ones_like(st, dtype=torch.bool), det.ratio_crossings, steps=st)
        steps.index_add_(0, idx, st)
        good = status == exit_d[idx]
        esc[idx] = good
        fix[idx] = torch.where(good, g.locate_x(rx), 0)
        fiy[idx] = torch.where(good, g.locate_y(ry), 0)
        bad[idx] = status == BAD
        collided = status == SCATTER
        flat = ((g.locate_x(rx) * g.n_y + g.locate_y(ry)) * g.n_z + g.locate_z(rz)).long()
        maj = opt.block_majorant[((fbx * cg.n_y + fby) * cg.n_z + fbz).long()]
        ratio = torch.clamp(1.0 - opt.total_ext[flat] / torch.clamp(maj, min=f32(1e-30)),
                            0.0, 1.0)
        t = torch.where(collided, T[idx] * ratio, T[idx])
        rr = collided & (t < det.zeta_ratio)
        killed = rr & (u_kill >= _div(t, det.zeta_ratio))
        t = torch.where(rr, torch.where(killed, 0.0, det.zeta_ratio), t)
        T[idx] = t
        go = collided & (t > 0.0)
        live[idx] = go
        px[idx], py[idx], pz[idx] = (torch.where(go, a, b) for a, b in ((rx, x0), (ry, y0),
                                                                       (rz, z0)))
    return T, fix, fiy, esc, bad | live


def intensity_estimate(spec, var, opt: DeviceOptics, tables: DeviceTables, key, kb: int, j: int,
                       est, is_surface, x, y, z, ix, iy, iz, ux, uy, uz, weight, comp, pf_idx,
                       order, buf, record: dict | None = None) -> torch.Tensor:
    """Local estimation toward each detector (intensity_contribution,
    wavefront.py:884-1003; in the weight-1 class the chained tracer's,
    :485-503 and :532-603) for the lanes ``est`` of an event, at (x, y, z)
    in cell (ix, iy, iz) with the incoming direction u: the phase value at
    the photon-to-detector angle over 4 pi |mu_d| (the original table for
    orders <= n_orig), 1/pi at a Lambertian surface or R(in -> detector)/pi
    at a BRDF surface (0 for a downward detector), times ``weight`` (the
    weight-1 class: ssa), times the transmittance to the boundary, counted
    only through the detector's side; clipped at the cap with the excess
    kept.  Adds to ``buf.intensity`` (column of the exit * D + d),
    ``buf.by_component`` (slot 0 the surface, comp + 1 otherwise),
    ``buf.excess``, ``buf.int_steps`` (the rays' DDA steps per lane) and
    ``buf.int_rays`` (the rays per lane).  ``record``, a dict, receives in
    its list ``rays`` one int64 (4, n) tensor of the event's rays, rows
    (event j, lane, detector, DDA steps), lane-major (``ray_census``).
    Returns the lanes' bad rays (the weight-1 class counts them; (L,)
    int32)."""
    det, g = spec.det, spec.geom
    D = det.n
    L = est.shape[0]
    dev = est.device
    bad_lane = torch.zeros(L, dtype=torch.int32, device=dev)
    sel = torch.nonzero(est).flatten()
    if sel.numel() == 0:
        return bad_lane
    lane = sel.repeat_interleave(D)                      # (lane, detector) rays, lane-major
    d = torch.arange(D, device=dev).repeat(sel.numel())
    dx, dy, dz = det.dirs[0][d], det.dirs[1][d], det.dirs[2][d]
    uxl, uyl, uzl = ux[lane], uy[lane], uz[lane]
    proj = torch.clamp(uxl * dx + uyl * dy + uzl * dz, -1.0, 1.0)
    pos = _div(torch.acos(proj), _PI)
    n_fwd = tables.n_forward_steps
    row = (comp[lane] * tables.max_entries + pf_idx[lane]) * n_fwd
    pf = table_lookup(tables.forward, row, pos, n_fwd)
    if det.n_orig > 0:
        pf = torch.where(order[lane] <= det.n_orig,
                         table_lookup(tables.forward_orig, row, pos, n_fwd), pf)
    surf = is_surface[lane]
    if var.bernoulli:
        pre = pf * var.ssa / (_FOUR_PI * det.abs_mu[d])
    else:
        norm_pf = pf / (_FOUR_PI * det.abs_mu[d])
        if spec.surface_kind > 1:          # a BRDF (kernels/general_block.py ALBEDO = 1)
            phi_in = torch.atan2(uyl, uxl)
            refl = surface_reflectance(spec, x[lane], y[lane], uzl, dz, phi_in, det.phi[d])
            srf_pf = torch.where(dz > 0.0, _div(refl, _PI), 0.0)
            norm_pf = torch.where(surf, srf_pf, norm_pf)
        else:
            norm_pf = torch.where(surf, _INV_PI, norm_pf)
        w = weight[lane]
    steps = torch.zeros(lane.shape[0], dtype=torch.int32, device=dev)
    if det.est == RATIO:
        rounds = 4 * det.max_crossings if var.bernoulli else det.max_crossings
        T, fix, fiy, esc, bad = ratio_transmittance(
            spec, opt, key, kb, j, lane, d, x[lane].clone(), y[lane].clone(), z[lane].clone(),
            dx, dy, dz, steps, rounds)
        if var.bernoulli:
            contrib = torch.where(esc, pre * T, 0.0)
            bad_lane.index_add_(0, lane, bad.to(torch.int32))
        else:
            contrib = torch.where(esc, w * norm_pf * T, 0.0)
    else:
        if det.est == IWABUCHI:
            u = intensity_uniforms(key, kb, lane, intensity_group(j, d, 0, spec.K, D))
            u_free, u_accept = u[0], u[1]
            tau_free = exponential_deviate(u_free)
            pn = _PI * norm_pf
            small = pn <= det.zeta
            tau_max = -torch.log(torch.full_like(pn, det.zeta) / torch.clamp(pn, min=TINY))
            target = torch.where(small, tau_free, tau_max + tau_free)
        else:
            target = torch.full_like(dx, _TRACE_TARGET)
        _, _, _, fix, fiy, _, tau, status = trace_extinction(
            g, opt.total_ext, x[lane], y[lane], z[lane], ix[lane], iy[lane], iz[lane], dx, dy,
            dz, target, torch.ones_like(surf), det.max_crossings, steps=steps)
        esc = status == det.exit_status[d]
        if det.est == IWABUCHI:
            flat = _div(w * det.zeta, _PI)
            c_small = torch.where(esc & (u_accept <= _div(pn, det.zeta)), flat, 0.0)
            c_large = torch.where(esc & (tau <= tau_max), w * norm_pf * torch.exp(-tau),
                                  torch.where(esc, flat, 0.0))
            contrib = torch.where(small, c_small, c_large)
        else:
            contrib = torch.where(esc, w * norm_pf * torch.exp(-tau), 0.0)
    buf.int_steps.index_add_(0, lane, steps)
    buf.int_rays.index_add_(0, lane, torch.ones_like(steps))
    if record is not None:
        record.setdefault("rays", []).append(
            torch.stack([torch.full_like(lane, j), lane, d, steps.long()]))
    n1 = det.n_comp + 1
    slot = torch.where(surf, 0, comp[lane] + 1).long()
    if det.clip:
        excess = torch.clamp(contrib - det.cap, min=0.0)
        contrib = torch.minimum(contrib, torch.full_like(contrib, det.cap))
        buf.excess.index_add_(0, d * n1 + slot, excess.to(torch.float64))
    bin_ = ((fix * g.n_y + fiy).long() * D + d)
    buf.intensity.index_add_(0, bin_, contrib.to(torch.float64))
    buf.by_component.index_add_(0, bin_ * n1 + slot, contrib.to(torch.float64))
    return bad_lane


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


def general_event(spec, var, opt: DeviceOptics, tables: DeviceTables, u, s: dict, buf,
                  key=None, kb: int = 0, j: int = 0, record: dict | None = None) -> None:
    """One ``event_step`` (wavefront.py:1144-1540, the inline branch) on the
    lane tensors in ``s``, in place: free path, transport (DDA, maximum
    cross-section jump or Woodcock on the block majorants), exits, the
    surface, the collision (component pick, absorption by weight or, in the
    weight-1 class, by survival), with detectors the local estimate
    (``intensity_estimate``, draws at (key, kb, event j)), roulette, the
    inverse-CDF angle and rotation, and the budgets.  ``u`` is the event's
    (n_draws, L) draws in the order of ``var.draws``; exits and absorption
    add float64 weights to ``buf.columns`` ((n_cols, 3): up, down,
    absorbed) and, with the volume tally, ``buf.vol`` ((n_cells,));
    ``record`` goes to ``intensity_estimate``."""
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
    buf.columns.index_add_(0, col, torch.stack([torch.where(exit_top, w, 0.0),
                                                torch.where(exit_bot, w, 0.0),
                                                absorbed], dim=1).to(torch.float64))
    if spec.vol:
        buf.vol.index_add_(0, flat, absorbed.to(torch.float64))
    math_move = collide & ~physical if spec.mode != RT else zeros_b

    # Local estimation (:1487-1497): every physical collision with the
    # post-absorption weight, and the surface: a BRDF's every bottom hit with
    # the pre-reflection weight, an albedo's live reflections with w_srf.
    if spec.det is not None:
        brdf = spec.surface_kind > 1           # kinds above ALBEDO are BRDFs
        est = physical | (exit_bot if brdf else surf_alive)
        w_event = torch.where(exit_bot, w if brdf else w_srf, w_sc)
        s["bad"] = s["bad"] + intensity_estimate(
            spec, var, opt, tables, key, kb, j, est, exit_bot, rx, ry, rz, rix, riy, riz,
            ux, uy, uz, w_event, comp, pf_idx, order_next, buf, record)

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
    ``fastpath.CHECK_EVERY`` blocks.  With ``intensity`` the blocks make
    the local estimate of every collision and surface event (the inline
    estimator: ``use_queued_intensity`` and ``intensity_ray_steps`` are TPU
    scheduling, module docstring); the tallies carry the radiance,
    ``n_int_steps`` and ``n_int_rays``."""
    from i3rc_tpu_torch.integrators.fastpath import CHECK_EVERY, lane_width
    from i3rc_tpu_torch.kernels import general_block as gb

    L = lane_width(n_photons, n_lanes)
    spec = gb.general_spec(geom, coarse_geom, surface, config, n_photons, intensity,
                           optics.n_components)
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
            intensity=buf.intensity, intensity_by_component=buf.by_component,
            intensity_excess=buf.excess,
            n_photons=int(n_photons), n_bad=n_bad, n_iterations=n_blocks * spec.K,
            n_lane_events=i[gb.EVCT].sum(dtype=torch.int64),
            n_dda_steps=i[gb.XING].sum(dtype=torch.int64),
            n_int_steps=buf.int_steps.sum(dtype=torch.int64),
            n_int_rays=buf.int_rays.sum(dtype=torch.int64))

    trace.spec = spec
    return trace
