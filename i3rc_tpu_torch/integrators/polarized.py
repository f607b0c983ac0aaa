"""Polarized (Stokes-vector) transport on a PyTorch device.

Port of ``i3rc_tpu/integrators/polarized.py`` (the reference's Wishlist item
3: phase matrices in place of phase functions, photons carrying Stokes
vectors, polarized local estimation for radiances):

    integ = PolarizedIntegrator.create(domain, config=..., device="cuda",
                                       intensity_mus=..., intensity_phis=...)
    res = integ.compute(batch_key(seed, batch), source, n_photons)

Every domain component carries a ``PhaseMatrixTable``.  A photon carries
its direction u, a unit frame vector e1 perpendicular to u and the Stokes
vector (1, q, u, v) normalized to I = 1 on the triad (e1, u x e1, u), the
magnitude in the weight w (the Euler-frame bookkeeping of the JAX module's
docstring).  Transport is maximum cross-section against the global
majorant; a Lambertian surface reflects depolarized; at a physical
collision (theta, chi) are drawn from P11's piecewise-cubic inverse CDF and
a uniform azimuth, the weight takes the polarized intensity ratio
[M(theta) L(chi) S]_I / a1(theta) and the Stokes vector is renormalized.
With detectors every collision and Lambertian reflection makes the
polarized local estimate toward each detector, rotated into the detector's
meridian frame, times a ratio-tracking transmittance to the boundary.

The trace loop runs blocks of ``PZ_K`` events: ``kernels/polarized_block.py``
``polarized_block``, on a CUDA tensor one launch of the hand-written kernel
``csrc/polarized_event_block.cuh`` (PZ), on a CPU tensor
``polarized_block_reference`` below, its plain twin on the same Philox
draws: the FIFO refill of dead lanes from the photon budget (source
samples at (lane, kb, group, ``STREAM_REFILL``), as the general kernel
does), then K events of 8 draws (two Philox groups of ``STREAM_EVENT``, in
the JAX event's order: free path, acceptance, component, theta, chi,
roulette and the Lambertian pair); ratio tracking draws from
``STREAM_INTENSITY`` at ``intensity_group(j, d, round // 2)``, two words a
round.  JAX draws a whole fresh source sample every event and Threefry
keys: the streams differ by design, the statistics do not.

Two faults of the JAX module are not copied.  Its ratio-tracking budget
floors |mu| at 1e-3 although ``create`` accepts any |mu| > 1e-30, so a
grazing detector's rays can run out of rounds and land in n_bad; here the
budget is sized from the true smallest |mu| (still capped at 2^20 rounds).
Its ``create`` silently ignores configuration the polarized path does not
run; here one I3RCWarning names every such flag (``IGNORED_FLAGS``).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from i3rc_tpu_torch.core.illumination import PhotonSource
from i3rc_tpu_torch.core.optics import Domain, flatten_optics
from i3rc_tpu_torch.core.phase_matrices import PhaseMatrixTable
from i3rc_tpu_torch.core.rng import (
    STREAM_REFILL,
    PhiloxKey,
    exponential_deviate,
    intensity_group,
    intensity_uniforms,
    philox_uniforms,
)
from i3rc_tpu_torch.integrators.config import IntegratorConfig
from i3rc_tpu_torch.integrators.fastpath import CHECK_EVERY, lane_width
from i3rc_tpu_torch.integrators.integrator import resolve_device
from i3rc_tpu_torch.integrators.results import column_weights
from i3rc_tpu_torch.integrators.tables import build_inverse_cubic
from i3rc_tpu_torch.integrators.wavefront import _sincos_2pi, f32, make_direction_cosines
from i3rc_tpu_torch.kernels.event_block import DONE, SPENT, cta_dead_counts
from i3rc_tpu_torch.ops.dda import GridGeometry, _div
from i3rc_tpu_torch.utils.errors import I3RCWarning, Status

TINY = f32(1e-12)
EPS6 = f32(1e-6)
EPS20 = f32(1e-20)
ROULETTE_W = f32(0.01)   # weight roulette floor (spread comes only from the
# polarized-ratio multiplier, so it triggers rarely)
PI = f32(np.pi)
FOUR_PI = f32(4.0 * np.pi)
PZ_K = 8                 # events per block (one launch of PZ)
N_DRAWS = 8              # draws per event: two Philox groups
MATRIX_COLS = 8          # a table row's 6 elements padded to two float4
DET_COLS = 12            # a detector row: d, m1, m2, |mu|, 2 pad
MAX_ROUNDS = 1 << 20     # the ratio-tracking round cap

# Rows of PolarizedState.f and .i.
X, Y, Z, UX, UY, UZ, E1X, E1Y, E1Z, Q, U, V, W = range(13)
ALIVE, ORDER, BAD, EVCT, RAYS, ROUNDS = range(6)

# Settings the polarized path does not run, with the value it runs: one
# I3RCWarning in create names every flag of the caller's config that asks
# for something else (the JAX create ignores them without a word).
IGNORED_FLAGS = {"use_ray_tracing": False, "use_hybrid_phase_funs": False,
                 "limit_intensity_contributions": False,
                 "use_russian_roulette_for_intensity": False, "majorant_block_size": 0,
                 "compute_volume_absorption": False}


# ---------------------------------------------------------------------------
# Results

@dataclass(frozen=True)
class PolarizedResults:
    """Normalized polarized outputs.

    ``intensity`` is (nx, ny, D, 4) Stokes (I, Q, U, V) per column per
    detector, Q/U in the detector-meridian convention; fluxes are scalar (I)
    per unit incident flux, as in Results.
    """

    flux_up: torch.Tensor            # (nx, ny)
    flux_down: torch.Tensor          # (nx, ny)
    flux_absorbed: torch.Tensor      # (nx, ny)
    intensity: torch.Tensor          # (nx, ny, D, 4)
    n_photons: torch.Tensor
    n_bad: torch.Tensor

    @property
    def mean_flux_up(self):
        return torch.mean(self.flux_up)

    @property
    def mean_flux_down(self):
        return torch.mean(self.flux_down)

    @property
    def mean_flux_absorbed(self):
        return torch.mean(self.flux_absorbed)

    @property
    def mean_intensity(self):
        """(D, 4) domain-mean Stokes radiances."""
        return torch.mean(self.intensity, dim=(0, 1))

    @property
    def degree_of_polarization(self):
        """(D,) domain-mean linear + circular DoP sqrt(Q^2+U^2+V^2)/I."""
        s = self.mean_intensity
        return torch.sqrt(s[:, 1] ** 2 + s[:, 2] ** 2 + s[:, 3] ** 2) / \
            torch.clamp(s[:, 0], min=TINY)


# ---------------------------------------------------------------------------
# Tables and frames (host numpy, as the JAX module builds them)

def _bake_matrix_tables(domain: Domain, n_fwd: int) -> dict:
    """Flatten every component's PhaseMatrixTable onto a uniform angle grid:
    ``packed`` (ncomp * max_entries * n_fwd, 6) float32 rows of a1 and the
    five ratios x / a1 (zero where a1 underflows), entries padded with the
    component's last; ``n_fwd``, ``max_entries``."""
    angles = np.linspace(0.0, np.pi, n_fwd)
    comps = []
    for c in domain.components:
        entries = []
        for m in c.table.phase_matrices:
            v = m.values(angles)
            a1 = np.maximum(v["a1"], 0.0)
            safe = np.maximum(a1, 1e-30)
            entries.append(np.stack([a1] + [np.where(a1 > 0, v[k] / safe, 0.0)
                                            for k in ("b1", "a2", "a3", "a4", "b2")]))
        comps.append(np.stack(entries))               # (entries, 6, n_fwd)
    max_entries = max(c.shape[0] for c in comps)
    out = np.zeros((len(comps), max_entries, 6, n_fwd), np.float32)
    for i, c in enumerate(comps):
        out[i, :c.shape[0]] = c
        if c.shape[0] < max_entries:
            out[i, c.shape[0]:] = c[-1]
    packed = np.moveaxis(out, 2, 3).reshape(-1, 6)
    return {"packed": packed, "n_fwd": n_fwd, "max_entries": max_entries}


def _meridian_basis(dirs: np.ndarray):
    """Per-detector meridian frame (m1, m2) of the (3, D) directions d: m1
    in the plane of d and z (the x-z plane when d is vertical), m2 = d x m1;
    float32 (D, 3) each."""
    d = dirs.T
    z = np.array([0.0, 0.0, 1.0])
    m1 = z[None, :] - d * d[:, 2:3]
    nrm = np.linalg.norm(m1, axis=1, keepdims=True)
    x = np.array([1.0, 0.0, 0.0])
    fallback = x[None, :] - d * d[:, 0:1]
    fb_n = np.linalg.norm(fallback, axis=1, keepdims=True)
    m1 = np.where(nrm > 1e-6, m1 / np.maximum(nrm, 1e-30),
                  fallback / np.maximum(fb_n, 1e-30))
    m2 = np.cross(d, m1)
    return m1.astype(np.float32), m2.astype(np.float32)


def _initial_frame(ux, uy, uz):
    """Meridian-plane e1 for a direction (x-z plane fallback at the poles)."""
    px = -uz * ux
    py = -uz * uy
    pz = 1.0 - uz * uz
    nrm = torch.sqrt(px * px + py * py + pz * pz)
    pole = nrm < EPS6
    inv = torch.where(pole, 0.0, torch.clamp(nrm, min=TINY).reciprocal())
    return (torch.where(pole, 1.0, px * inv), torch.where(pole, 0.0, py * inv),
            torch.where(pole, 0.0, pz * inv))


# ---------------------------------------------------------------------------
# The block's constants, state and buffers

@dataclass(frozen=True, eq=False)
class PolarizedSpec:
    """What a block needs: the grid, the device optics (``total_ext``
    (n_cells,); ``cells`` (n_cells, 3 n_comp) float32 columns cum | ssa |
    phase index), the cubic inverse CDF of P11 (``cubic`` (rows, 4)), the
    phase-matrix table padded to ``MATRIX_COLS`` (``matrix``), the detector
    rows (``det`` (D, DET_COLS): direction, meridian m1 and m2, |mu|), the
    float32 ``inv_maj`` = f32(1 / global majorant), the surface albedo
    (Lambertian when > 0), the source's normalized Stokes (q0, u0, v0), the
    event budget, K, the photon budget, the ratio-tracking ``zeta`` and
    round budget ``max_rounds``."""

    geom: GridGeometry
    total_ext: torch.Tensor
    cells: torch.Tensor
    cubic: torch.Tensor
    matrix: torch.Tensor
    det: torch.Tensor
    n_comp: int
    max_entries: int
    n_seg: int
    n_fwd: int
    inv_maj: float
    albedo: float
    q0: float
    u0: float
    v0: float
    max_events: int
    K: int
    n_photons: int
    zeta: float
    max_rounds: int

    @property
    def n_dirs(self) -> int:
        return self.det.shape[0]

    @property
    def lambert(self) -> bool:
        return self.albedo > 0.0


@dataclass
class PolarizedState:
    """Per-lane state: ``f`` (13, L) float32 rows x, y, z, ux, uy, uz, e1x,
    e1y, e1z, q, u, v, w; ``i`` (6, L) int32 rows alive, order (physical
    collisions), bad (over-budget events and bad estimate rays), evct
    (lane-events), rays (estimate rays), rounds (ratio-tracking rounds)."""

    f: torch.Tensor
    i: torch.Tensor

    @property
    def n_lanes(self) -> int:
        return self.f.shape[1]

    def clone(self) -> "PolarizedState":
        return PolarizedState(self.f.clone(), self.i.clone())


@dataclass
class PolarizedBuffers:
    """The float64 tallies ``columns`` (n_cols, 3: up, down, absorbed) and
    ``intensity`` (n_cols * D * 4, Stokes per column and detector), and the
    loop control of ``event_block.BlockBuffers``: ``ctl`` int64 (4,)
    (launched at kb & 1, DONE, SPENT) and ``dead`` int32 (2, n_tiles)."""

    columns: torch.Tensor
    intensity: torch.Tensor
    ctl: torch.Tensor
    dead: torch.Tensor

    def clone(self) -> "PolarizedBuffers":
        return PolarizedBuffers(self.columns.clone(), self.intensity.clone(),
                                self.ctl.clone(), self.dead.clone())


def _place(spec: PolarizedSpec, x, y, z, mu, phi, f, i, take) -> None:
    """Lanes ``take`` start a photon at the normalized (x, y, z) with
    direction (mu, phi), its meridian frame, the source's Stokes vector,
    weight 1 and order 0."""
    g = spec.geom
    ux, uy, uz = make_direction_cosines(mu, phi)
    vals = ((X, g.x0 + x * (g.x_max - g.x0)), (Y, g.y0 + y * (g.y_max - g.y0)),
            (Z, g.z0 + z * (g.z_max - g.z0)), (UX, ux), (UY, uy), (UZ, uz))
    for row, v in vals + tuple(zip((E1X, E1Y, E1Z), _initial_frame(ux, uy, uz))):
        f[row] = torch.where(take, v, f[row])
    for row, v in ((Q, spec.q0), (U, spec.u0), (V, spec.v0), (W, 1.0)):
        f[row] = torch.where(take, v, f[row])
    i[ORDER] = torch.where(take, 0, i[ORDER])


def launch_state(spec: PolarizedSpec, batch, n_photons: int) -> PolarizedState:
    """Lane state for a launch batch; lanes beyond the budget start dead."""
    L = batch.n_photons
    dev = batch.x.device
    f = torch.zeros((13, L), dtype=torch.float32, device=dev)
    i = torch.zeros((6, L), dtype=torch.int32, device=dev)
    take = torch.arange(L, device=dev) < n_photons
    _place(spec, batch.x, batch.y, batch.z, batch.mu, batch.phi, f, i, take)
    i[ALIVE] = take.to(torch.int32)
    return PolarizedState(f, i)


def polarized_buffers(spec: PolarizedSpec, state: PolarizedState, launched: int,
                      kb: int = 0) -> PolarizedBuffers:
    """Zeroed tallies and the loop's control state for a trace that enters
    block ``kb`` on ``state`` with ``launched`` photons launched."""
    dev = state.f.device
    g = spec.geom
    ctl = torch.tensor([0, 0, -1, -1], dtype=torch.int64, device=dev)
    ctl[kb & 1] = launched
    dead = torch.zeros((2, -(-state.n_lanes // 256)), dtype=torch.int32, device=dev)
    dead[kb & 1] = cta_dead_counts(state.i[ALIVE])
    return PolarizedBuffers(
        columns=torch.zeros((g.n_x * g.n_y, 3), dtype=torch.float64, device=dev),
        intensity=torch.zeros(g.n_x * g.n_y * spec.n_dirs * 4, dtype=torch.float64,
                              device=dev),
        ctl=ctl, dead=dead)


# ---------------------------------------------------------------------------
# The plain twin of PZ: one block in torch ops, in the kernel's order

def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _matrix_apply(spec: PolarizedSpec, row, pos, q, u, v):
    """[M(theta) S] for S = (1, q, u, v) at pos = theta / pi: one
    interpolated read of the padded table (two rows); returns (I, Q, U, V,
    a1)."""
    n = spec.n_fwd
    p = torch.clamp(pos, 0.0, 1.0) * float(n - 1)
    i0 = torch.clamp(p.to(torch.int32), 0, n - 2)
    frac = p - i0.to(p.dtype)
    idx = (row + i0).long()
    e = (1.0 - frac)[:, None] * spec.matrix[idx] + frac[:, None] * spec.matrix[idx + 1]
    a1, rb1, ra2, ra3, ra4, rb2 = (e[:, k] for k in range(6))
    return (a1 * (1.0 + rb1 * q), a1 * (rb1 + ra2 * q), a1 * (ra3 * u + rb2 * v),
            a1 * (-rb2 * u + ra4 * v), a1)


def _ratio_track(spec: PolarizedSpec, key: PhiloxKey, kb: int, j: int, lane, d, x, y, z,
                 dx, dy, dz, up):
    """Ratio tracking of the (lane, detector) rays to the boundary against
    the global majorant: each tentative collision multiplies T by clip(1 -
    ext / majorant, 0, 1), roulette of T at zeta; round r reads words
    2 (r % 2), 2 (r % 2) + 1 of pair r // 2.  Returns (T, exit column,
    escaped through the detector's side, alive after the last round,
    rounds run) per ray."""
    g = spec.geom
    n = lane.shape[0]
    dev = lane.device
    T = torch.ones(n, dtype=torch.float32, device=dev)
    ecol = torch.zeros(n, dtype=torch.int64, device=dev)
    esc = torch.zeros(n, dtype=torch.bool, device=dev)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    rounds = torch.zeros(n, dtype=torch.int32, device=dev)
    x, y, z = x.clone(), y.clone(), z.clone()
    for r in range(spec.max_rounds):
        idx = torch.nonzero(act).flatten()
        if idx.numel() == 0:
            break
        rounds[idx] += 1
        u = intensity_uniforms(key, kb, lane[idx],
                               intensity_group(j, d[idx], r >> 1, spec.K, spec.n_dirs))
        u_free, u_kill = u[2 * (r & 1)], u[2 * (r & 1) + 1]
        rx, ry, rz = x[idx], y[idx], z[idx]
        ddx, ddy, ddz = dx[idx], dy[idx], dz[idx]
        step = exponential_deviate(u_free) * spec.inv_maj
        nz = rz + step * ddz
        top = nz >= g.z_max
        out = top | (nz <= g.z0)
        good = out & (top == up[idx])
        safe = torch.where(torch.abs(ddz) < TINY, TINY, ddz)
        tb = torch.where(out, (torch.where(top, g.z_max, g.z0) - rz) / safe, step)
        nx = g.wrap_x(rx + tb * ddx)
        ny = g.wrap_y(ry + tb * ddy)
        ecol[idx] = torch.where(good, (g.locate_x(nx) * g.n_y + g.locate_y(ny)).long(),
                                ecol[idx])
        esc[idx] = esc[idx] | good
        nz = torch.clamp(nz, g.z0, g.z_max)
        flat = ((g.locate_x(nx) * g.n_y + g.locate_y(ny)) * g.n_z + g.locate_z(nz)).long()
        ratio = torch.clamp(1.0 - spec.total_ext[flat] * spec.inv_maj, 0.0, 1.0)
        coll = ~out
        t = torch.where(coll, T[idx] * ratio, T[idx])
        rr = coll & (t < spec.zeta)
        killed = rr & (u_kill >= _div(t, spec.zeta))
        T[idx] = torch.where(rr, torch.where(killed, 0.0, spec.zeta), t)
        act[idx] = coll & (T[idx] > 0.0)
        x[idx], y[idx], z[idx] = nx, ny, nz
    return T, ecol, esc, act, rounds


def detector_estimates(spec: PolarizedSpec, key: PhiloxKey, kb: int, j: int, est, surface,
                       s: dict, w_scat, comp, pf, buf: PolarizedBuffers,
                       record: dict | None = None) -> None:
    """The polarized local estimate of the lanes ``est`` toward every
    detector (JAX polarized.py:328-453): the virtual scattering toward d
    (the chi rotation of (Q, U), the matrix at the photon-to-detector
    angle), the rotation into the detector's meridian frame (L(-a): the
    ``-s2a`` sign), the prefactor w / (4 pi |mu_d|), or for a Lambertian
    reflection (``surface``) w / pi toward upward detectors, depolarized;
    times the ratio-tracking transmittance, tallied at the exit column.  A
    ray alive after ``max_rounds`` rounds counts bad on its lane; each lane
    counts its rays and rounds.  ``record``, a dict, receives in its list
    ``rays`` one int64 (4, n) tensor of the event's rays, rows (event j,
    lane, detector, ratio-tracking rounds), lane-major (``ray_census``)."""
    sel = torch.nonzero(est).flatten()
    if sel.numel() == 0:
        return
    D = spec.n_dirs
    dev = sel.device
    lane = sel.repeat_interleave(D)
    d = torch.arange(D, device=dev).repeat(sel.numel())
    det = spec.det[d]
    dv = (det[:, 0], det[:, 1], det[:, 2])
    m1 = (det[:, 3], det[:, 4], det[:, 5])
    m2 = (det[:, 6], det[:, 7], det[:, 8])
    abs_mu = det[:, 9]
    uu = (s["ux"][lane], s["uy"][lane], s["uz"][lane])
    e1 = (s["e1x"][lane], s["e1y"][lane], s["e1z"][lane])
    q, us, v, w = s["q"][lane], s["u"][lane], s["v"][lane], w_scat[lane]
    e2 = _cross(uu, e1)
    ctd = torch.clamp(_dot(uu, dv), -1.0, 1.0)
    dpar = _dot(e1, dv)
    dperp = _dot(e2, dv)
    st2 = torch.clamp(dpar * dpar + dperp * dperp, min=0.0)
    deg = st2 < TINY
    inv_st2 = torch.where(deg, 0.0, torch.clamp(st2, min=TINY).reciprocal())
    c2 = torch.where(deg, 1.0, (dpar * dpar - dperp * dperp) * inv_st2)
    s2 = torch.where(deg, 0.0, 2.0 * dpar * dperp * inv_st2)
    qr, ur = c2 * q + s2 * us, -s2 * q + c2 * us
    row = (comp[lane] * spec.max_entries + pf[lane]) * spec.n_fwd
    i2, q2, u2, v2, _ = _matrix_apply(spec, row, _div(torch.acos(ctd), PI), qr, ur, v)
    st = torch.sqrt(st2)
    inv_st = torch.where(deg, 0.0, torch.clamp(st, min=TINY).reciprocal())
    e1d = tuple((dv[k] - ctd * uu[k]) * inv_st for k in range(3))
    e1s = tuple(-st * uu[k] + ctd * e1d[k] for k in range(3))
    ca, sa = _dot(e1s, m1), _dot(e1s, m2)
    c2a = torch.where(deg, 1.0, ca * ca - sa * sa)
    s2a = torch.where(deg, 0.0, 2.0 * ca * sa)
    qd, ud = c2a * q2 + -s2a * u2, s2a * q2 + c2a * u2
    pref = w / (FOUR_PI * abs_mu)
    srf = surface[lane]
    amps = (torch.where(srf, torch.where(dv[2] > 0.0, _div(w, PI), 0.0), pref * i2),
            torch.where(srf, 0.0, pref * qd), torch.where(srf, 0.0, pref * ud),
            torch.where(srf, 0.0, pref * v2))
    T, ecol, esc, act, rounds = _ratio_track(spec, key, kb, j, lane, d, s["x"][lane],
                                             s["y"][lane], s["z"][lane], *dv, dv[2] > 0.0)
    bins = (ecol * D + d) * 4
    for k, amp in enumerate(amps):
        buf.intensity.index_add_(0, bins[esc] + k, (amp * T)[esc].to(torch.float64))
    s["bad"].index_add_(0, lane, act.to(torch.int32))
    s["rays"].index_add_(0, lane, torch.ones_like(rounds))
    s["rounds"].index_add_(0, lane, rounds)
    if record is not None:
        record.setdefault("rays", []).append(
            torch.stack([torch.full_like(lane, j), lane, d, rounds.long()]))


def polarized_event(spec: PolarizedSpec, u, s: dict, buf: PolarizedBuffers, key: PhiloxKey,
                    kb: int, j: int, record: dict | None = None) -> None:
    """Event j of block kb on every lane (JAX polarized.py:492-622), in
    place on the state dict ``s``; dead lanes keep their state; ``record``
    goes to ``detector_estimates``."""
    g = spec.geom
    a = s["alive"]
    x, y, z, ux, uy, uz, w = (s[k] for k in ("x", "y", "z", "ux", "uy", "uz", "w"))
    # Free path against the global majorant, exits, horizontal wrap.
    step = exponential_deviate(u[0]) * spec.inv_maj
    nz = z + step * uz
    top = a & (nz >= g.z_max)
    bot = a & (nz <= g.z0)
    out = top | bot
    safe = torch.where(torch.abs(uz) < TINY, TINY, uz)
    tb = torch.where(out, (torch.where(top, g.z_max, g.z0) - z) / safe, step)
    x = torch.where(a, g.wrap_x(x + tb * ux), x)
    y = torch.where(a, g.wrap_y(y + tb * uy), y)
    z = torch.where(a, torch.clamp(nz, g.z0, g.z_max), z)
    ix, iy = g.locate_x(x), g.locate_y(y)
    col = (ix * g.n_y + iy).long()
    buf.columns[:, 0].index_add_(0, col[top], w[top].to(torch.float64))
    buf.columns[:, 1].index_add_(0, col[bot], w[bot].to(torch.float64))
    e1x, e1y, e1z, q, us, v = (s[k] for k in ("e1x", "e1y", "e1z", "q", "u", "v"))
    # The depolarizing Lambertian surface.
    refl = bot if spec.lambert else torch.zeros_like(bot)
    if spec.lambert:
        w = torch.where(refl, w * spec.albedo, w)
        mu_r = torch.sqrt(torch.clamp(u[6], min=TINY))
        sr = torch.sqrt(torch.clamp(1.0 - mu_r * mu_r, min=0.0))
        s_chi, c_chi = _sincos_2pi(u[7])
        ux = torch.where(refl, sr * c_chi, ux)
        uy = torch.where(refl, sr * s_chi, uy)
        uz = torch.where(refl, mu_r, uz)
        r1 = _initial_frame(ux, uy, uz)
        e1x, e1y, e1z = (torch.where(refl, r, e) for r, e in zip(r1, (e1x, e1y, e1z)))
        q, us, v = (torch.where(refl, 0.0, t) for t in (q, us, v))
        z = torch.where(refl, g.z0, z)
        alive = a & ~top
    else:
        alive = a & ~out
    # The collision: the cell's extinction, the component, ssa, phase index.
    flat = ((ix * g.n_y + iy) * g.n_z + g.locate_z(z)).long()
    physical = alive & ~out & (u[1] < spec.total_ext[flat] * spec.inv_maj)
    n = spec.n_comp
    cells = spec.cells[flat]
    comp = torch.zeros_like(ix)
    for c in range(n - 1):
        comp = comp + (u[2] >= cells[:, c]).to(torch.int32)
    pick = comp.long()[:, None]
    ssa = cells.gather(1, n + pick)[:, 0]
    pf = cells.gather(1, 2 * n + pick)[:, 0].to(torch.int32)
    w_scat = torch.where(physical, w * ssa, w)
    buf.columns[:, 2].index_add_(0, col[physical],
                                 (w * (1.0 - ssa))[physical].to(torch.float64))
    s.update(x=x, y=y, z=z, ux=ux, uy=uy, uz=uz, e1x=e1x, e1y=e1y, e1z=e1z, q=q, u=us, v=v)
    if spec.n_dirs:
        detector_estimates(spec, key, kb, j, physical | refl, refl, s, w_scat, comp, pf, buf,
                           record)
    # Polarized scattering: the chi rotation of the frame and of (Q, U).
    uu, e1 = (ux, uy, uz), (e1x, e1y, e1z)
    s_chi, c_chi = _sincos_2pi(u[4])
    e2 = _cross(uu, e1)
    r1 = tuple(c_chi * e1[k] + s_chi * e2[k] for k in range(3))
    c2 = c_chi * c_chi - s_chi * s_chi
    s2 = 2.0 * s_chi * c_chi
    qr, ur = c2 * q + s2 * us, -s2 * q + c2 * us
    # Theta from the scalar inverse-CDF cubic (P11 importance).
    S = spec.n_seg
    pos = torch.clamp(u[3], 0.0, 1.0) * float(S)
    seg = torch.clamp(pos.to(torch.int32), 0, S - 1)
    t = pos - seg.to(pos.dtype)
    entry = comp * spec.max_entries + pf
    cc = spec.cubic[(entry * S + seg).long()]
    mu_s = torch.clamp(((cc[:, 3] * t + cc[:, 2]) * t + cc[:, 1]) * t + cc[:, 0], -1.0, 1.0)
    i2, q2, u2, v2, a1 = _matrix_apply(spec, entry * spec.n_fwd, _div(torch.acos(mu_s), PI),
                                       qr, ur, v)
    wmul = torch.where(a1 > EPS20, i2 / torch.clamp(a1, min=TINY), 1.0)
    inv_i2 = torch.where(i2 > EPS20, torch.clamp(i2, min=TINY).reciprocal(), 0.0)
    sin_s = torch.sqrt(torch.clamp(1.0 - mu_s * mu_s, min=0.0))
    nu = tuple(mu_s * uu[k] + sin_s * r1[k] for k in range(3))
    n1 = tuple(-sin_s * uu[k] + mu_s * r1[k] for k in range(3))
    nrm = torch.sqrt(torch.clamp(_dot(nu, nu), min=TINY)).reciprocal()
    nu = tuple(c * nrm for c in nu)
    dot = _dot(n1, nu)
    n1 = tuple(n1[k] - dot * nu[k] for k in range(3))
    nrm1 = torch.sqrt(torch.clamp(_dot(n1, n1), min=TINY)).reciprocal()
    n1 = tuple(c * nrm1 for c in n1)
    for name, new, old in zip(("ux", "uy", "uz", "e1x", "e1y", "e1z", "q", "u", "v"),
                              nu + n1 + (q2 * inv_i2, u2 * inv_i2, v2 * inv_i2),
                              uu + e1 + (q, us, v)):
        s[name] = torch.where(physical, new, old)
    w = torch.where(physical, w_scat * wmul, w)
    # Weight roulette and the event budget.
    low = alive & (w < ROULETTE_W)
    die = low & (u[5] >= 0.5)
    s["w"] = torch.where(low & ~die, w * 2.0, w)
    s["order"] = s["order"] + physical.to(torch.int32)
    over = physical & (s["order"] >= spec.max_events)
    s["bad"] = s["bad"] + over.to(torch.int32)
    s["alive"] = alive & ~die & ~over
    s["evct"] = s["evct"] + a.to(torch.int32)


FLOAT_ROWS = ("x", "y", "z", "ux", "uy", "uz", "e1x", "e1y", "e1z", "q", "u", "v", "w")
INT_ROWS = ("alive", "order", "bad", "evct", "rays", "rounds")


def polarized_block_reference(spec: PolarizedSpec, state: PolarizedState,
                              buf: PolarizedBuffers, key: PhiloxKey, source: PhotonSource,
                              kb: int, record: dict | None = None) -> None:
    """Plain PyTorch version of one block (the twin of PZ): the loop's end
    condition as seen at entry, the FIFO refill (while the batch has more
    photons than lanes: dead lane l takes photon launched + its rank among
    the dead lanes, with the source sample at (l, kb, group,
    STREAM_REFILL)), the K events and the next block's CTA dead counts, in
    place on ``state`` and ``buf``.  ``record``, a dict, receives ``rays``:
    int64 (4, n_rays) rows (event j, lane, detector, ratio-tracking rounds)
    of the block's detector rays, in event order and lane-major within an
    event (``kernels.general_block.ray_census``)."""
    ctl = buf.ctl
    f, i = state.f, state.i
    L = state.n_lanes
    launched = ctl[kb & 1].clone()
    spent = launched >= spec.n_photons
    ctl[SPENT] = torch.where(spent & (ctl[SPENT] < 0), kb, ctl[SPENT])
    ctl[DONE] = torch.where(spent & ~i[ALIVE].bool().any() & (ctl[DONE] < 0), kb, ctl[DONE])
    if spec.n_photons > L:
        dead = i[ALIVE] == 0
        dead_i = dead.to(torch.int64)
        take = dead & (launched + torch.cumsum(dead_i, 0) - dead_i < spec.n_photons)
        fresh = source.sample(key, L, f.device, stream=STREAM_REFILL, block=kb)
        _place(spec, fresh.x, fresh.y, fresh.z, fresh.mu, fresh.phi, f, i, take)
        i[ALIVE] = i[ALIVE] | take.to(torch.int32)
        launched = launched + take.sum()
    ctl[(kb + 1) & 1] = launched
    u = philox_uniforms(key, kb, spec.K, N_DRAWS, L, f.device)
    s = {n: f[r] for r, n in enumerate(FLOAT_ROWS)}
    s.update({n: i[r].clone() for r, n in enumerate(INT_ROWS)})
    s["alive"] = s["alive"] != 0
    for j in range(spec.K):
        polarized_event(spec, u[j], s, buf, key, kb, j, record)
    if record is not None:
        record["rays"] = torch.cat(record.get("rays", [])
                                   or [torch.zeros((4, 0), dtype=torch.int64,
                                                   device=f.device)], dim=1)
    f.copy_(torch.stack([s[n] for n in FLOAT_ROWS]))
    s["alive"] = s["alive"].to(torch.int32)
    i.copy_(torch.stack([s[n] for n in INT_ROWS]))
    buf.dead[(kb + 1) & 1] = cta_dead_counts(i[ALIVE])


# ---------------------------------------------------------------------------
# The trace loop

def make_polarized_tracer(spec: PolarizedSpec, n_lanes: int, null_factor: int):
    """Build trace(key, batch, source) -> raw tallies: one ``polarized_block``
    per K-event block, the loop's end a device flag read every
    ``fastpath.CHECK_EVERY`` blocks, until no lane is alive and none is left
    to launch or JAX's event budget (max_events (n_photons // L + 2) trips
    times the null-collision factor) is spent; lanes alive at the end count
    bad."""
    from i3rc_tpu_torch.kernels.polarized_block import polarized_block

    n_photons = spec.n_photons
    max_iters = spec.max_events * (n_photons // n_lanes + 2) * null_factor
    max_blocks = -(-max_iters // spec.K)

    @torch.inference_mode()
    def trace(key: PhiloxKey, batch, source: PhotonSource) -> dict:
        st = launch_state(spec, batch, n_photons)
        buf = polarized_buffers(spec, st, min(n_lanes, n_photons))
        kb, done = 0, -1
        while kb < max_blocks and done < 0:
            polarized_block(spec, st, buf, key, source, kb)
            kb += 1
            if kb % CHECK_EVERY == 0 or kb == max_blocks:
                done = int(buf.ctl[DONE])
        i = st.i
        total = lambda row: i[row].sum(dtype=torch.int64)
        return {"up": buf.columns[:, 0], "down": buf.columns[:, 1],
                "absorbed": buf.columns[:, 2], "intensity": buf.intensity,
                "n_photons": n_photons, "n_bad": total(BAD) + total(ALIVE),
                "n_blocks": done if done >= 0 else kb, "lane_events": total(EVCT),
                "rays": total(RAYS), "rounds": total(ROUNDS)}

    trace.max_blocks = max_blocks
    return trace


# ---------------------------------------------------------------------------
# Public integrator

@dataclass(frozen=True, eq=False)
class PolarizedIntegrator:
    """Stokes-vector Monte Carlo integrator on one device (JAX
    polarized.py:650-778): ``create`` then ``compute`` / ``batch_fn``."""

    geometry: GridGeometry
    config: IntegratorConfig
    device: torch.device
    spec_args: dict
    null_factor: int
    _col_weights: np.ndarray

    @staticmethod
    def create(domain: Domain, config: IntegratorConfig | None = None,
               surface_albedo: float = 0.0, intensity_mus=None, intensity_phis=None,
               source_stokes=(1.0, 0.0, 0.0, 0.0), n_forward_steps: int = 1024,
               device="cuda") -> "PolarizedIntegrator":
        dev = resolve_device(device)
        if config is None:
            config = IntegratorConfig(**IGNORED_FLAGS)
        config = config.validate()
        s = Status()
        s.fail_if(not domain.components, "domain contains no components")
        for c in domain.components:
            s.fail_if(not isinstance(c.table, PhaseMatrixTable),
                      f"component {c.name}: polarized transport needs a "
                      "PhaseMatrixTable (got a scalar phase-function table)")
        s.fail_if(not 0.0 <= surface_albedo <= 1.0, "surface albedo out of range")
        s.fail_if((intensity_mus is None) != (intensity_phis is None),
                  "both or neither of intensityMus and intensityPhis")
        stokes = np.asarray(source_stokes, np.float64)
        s.fail_if(stokes.shape != (4,), "source_stokes must have 4 entries")
        if stokes.shape == (4,):
            s.fail_if(stokes[0] <= 0.0, "source Stokes I must be positive")
            s.fail_if(stokes[1] ** 2 + stokes[2] ** 2 + stokes[3] ** 2
                      > stokes[0] ** 2 * (1.0 + 1e-6),
                      "source Stokes vector over-polarized (Q^2+U^2+V^2 > I^2)")
        dirs = None
        if intensity_mus is not None:
            mus = np.atleast_1d(np.asarray(intensity_mus, np.float64))
            phis = np.atleast_1d(np.asarray(intensity_phis, np.float64))
            s.fail_if(mus.size != phis.size,
                      "intensityMus and intensityPhis must be the same length")
            s.fail_if(bool(np.any(np.abs(mus) > 1.0)), "intensityMus must be in [-1, 1]")
            s.fail_if(bool(np.any(np.abs(mus) < 1e-30)),
                      "intensityMus can't be 0 (directly sideways)")
            if mus.size == phis.size:
                sin_t = np.sqrt(np.maximum(1.0 - mus ** 2, 0.0))
                pr = np.deg2rad(phis)
                dirs = np.stack([sin_t * np.cos(pr), sin_t * np.sin(pr), mus])
        s.check("PolarizedIntegrator.create")
        ignored = [name for name, runs in IGNORED_FLAGS.items()
                   if getattr(config, name) != runs]
        if ignored:
            warnings.warn("polarized transport runs maximum cross-section transport with "
                          "ratio-tracking radiances and column absorption only; it ignores "
                          + ", ".join(f"{n}={getattr(config, n)!r}" for n in ignored),
                          I3RCWarning, stacklevel=2)

        flat = flatten_optics(domain)
        n_comp = flat.n_components
        cubic = build_inverse_cubic(flat)
        tabs = _bake_matrix_tables(domain, n_forward_steps)
        matrix = np.zeros((tabs["packed"].shape[0], MATRIX_COLS), np.float32)
        matrix[:, :6] = tabs["packed"]
        cells = np.concatenate([flat.cumulative_ext.reshape(-1, n_comp),
                                flat.ssa.reshape(-1, n_comp),
                                flat.phase_index.reshape(-1, n_comp).astype(np.float32)],
                               axis=1)
        geom = GridGeometry.from_edges(domain.x_edges, domain.y_edges, domain.z_edges,
                                       domain.xy_regularly_spaced, domain.z_regularly_spaced,
                                       device=dev)
        maj = max(flat.max_extinction, 1e-30)
        ext_pos = flat.total_ext[flat.total_ext > 0]
        # Each trip is one tentative collision against the global majorant:
        # the event budget scales with the mean null-collision factor.
        null_factor = max(1, min(64, int(np.ceil(maj / max(float(ext_pos.mean()), 1e-30)
                                                 if ext_pos.size else 1.0))))
        det = np.zeros((0, DET_COLS), np.float32)
        max_rounds = 0
        if dirs is not None:
            m1, m2 = _meridian_basis(dirs)
            d32 = dirs.astype(np.float32)
            det = np.zeros((d32.shape[1], DET_COLS), np.float32)
            det[:, 0:3], det[:, 3:6], det[:, 6:9] = d32.T, m1, m2
            det[:, 9] = np.abs(d32[2])
            # Rounds ~ the majorant optical depth of the slant path: sized by
            # the true smallest |mu| (the JAX module floors it at 1e-3).
            min_abs_mu = float(np.min(np.abs(dirs[2])))
            max_rounds = min(64 + 8 * int(min(maj * (geom.z_max - geom.z0) / min_abs_mu,
                                              MAX_ROUNDS)), MAX_ROUNDS)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        q0, u0, v0 = (f32(np.float32(c) / max(np.float32(stokes[0]), np.float32(TINY)))
                      for c in stokes[1:])
        spec_args = dict(
            geom=geom, total_ext=t(flat.total_ext.reshape(-1)), cells=t(cells),
            cubic=t(cubic.reshape(-1, 4)), matrix=t(matrix), det=t(det), n_comp=n_comp,
            max_entries=tabs["max_entries"], n_seg=cubic.shape[2], n_fwd=n_forward_steps,
            inv_maj=f32(1.0 / maj), albedo=f32(surface_albedo), q0=q0, u0=u0, v0=v0,
            max_events=int(config.max_events), K=PZ_K,
            zeta=f32(max(min(config.zeta_min, 1.0), 1e-3)), max_rounds=max_rounds)
        return PolarizedIntegrator(
            geometry=geom, config=config, device=dev, spec_args=spec_args,
            null_factor=null_factor,
            _col_weights=column_weights(domain.x_edges, domain.y_edges))

    @property
    def n_dirs(self) -> int:
        return self.spec_args["det"].shape[0]

    def spec(self, n_photons: int) -> PolarizedSpec:
        return PolarizedSpec(n_photons=int(n_photons), **self.spec_args)

    def batch_tracer(self, n_photons: int, n_lanes: int | None = None):
        """The raw (key, PhotonBatch, source) -> tallies function."""
        return make_polarized_tracer(self.spec(n_photons), lane_width(n_photons, n_lanes),
                                     self.null_factor)

    def batch_fn(self, source: PhotonSource, n_photons: int, n_lanes: int | None = None):
        """key -> PolarizedResults for one batch; cached per (source, sizes)."""
        cache = self.__dict__.setdefault("_batch_fn_cache", {})
        lanes = lane_width(n_photons, n_lanes)
        ck = (source, int(n_photons), lanes)
        if ck not in cache:
            tracer = self.batch_tracer(n_photons, lanes)
            n_x, n_y, D = self.geometry.n_x, self.geometry.n_y, self.n_dirs
            cw = torch.as_tensor(self._col_weights.astype(np.float64), device=self.device)

            @torch.inference_mode()
            def run(key: PhiloxKey) -> PolarizedResults:
                raw = tracer(key, source.sample(key, lanes, self.device), source)
                inv = 1.0 / (raw["n_photons"] / (n_x * n_y) * cw)
                out = lambda a: a.to(torch.float32)
                return PolarizedResults(
                    flux_up=out(raw["up"].reshape(n_x, n_y) * inv),
                    flux_down=out(raw["down"].reshape(n_x, n_y) * inv),
                    flux_absorbed=out(raw["absorbed"].reshape(n_x, n_y) * inv),
                    intensity=out(raw["intensity"].reshape(n_x, n_y, D, 4)
                                  * inv[:, :, None, None]),
                    n_photons=torch.tensor(raw["n_photons"], dtype=torch.int64,
                                           device=self.device),
                    n_bad=raw["n_bad"])

            cache[ck] = run
        return cache[ck]

    def compute(self, key: PhiloxKey, source: PhotonSource, n_photons: int) -> PolarizedResults:
        return self.batch_fn(source, n_photons)(key)
