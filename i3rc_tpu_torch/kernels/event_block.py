"""The fast event block: K transport events per lane, kernel and plain twin.

``event_block`` is the wrapper the trace loop calls.  On a CUDA tensor it
launches the hand-written Hopper kernel ``csrc/fast_event_block.cuh`` (the
port of the Pallas kernel ``_build_pallas_block``,
i3rc_tpu/integrators/fastpath.py:665, in its flux variant, its radiance
detector variant ``n_detectors > 0`` and the gas-channel variant
``gas=True`` of either; and the column-mode event of the XLA fastpath,
fastpath.py:1320-1345, in the design of the column-read probe
``pallas_column_loop``, benchmarks/column_read_probe.py:83) and raises if
the build or the launch fails; on a
CPU tensor it runs ``event_block_reference``, the plain PyTorch version, on
the same Philox draws.  Both update the lane state in place and
add the detector contributions of the block to a float64 (n_cols, D)
accumulator.

The twin applies exactly the kernel's draw layout: event ``j`` of the block
reads ``uniforms[j, i]`` for its draw ``i`` (``rng.philox_uniforms``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from i3rc_tpu_torch.core.rng import (
    STREAM_EVENT,
    PhiloxKey,
    TINY,
    exponential_deviate,
    philox_uniforms,
)
from i3rc_tpu_torch.integrators.wavefront import f32, rotate_direction

MAX_SEGMENTS = 24
MAX_DETECTORS = 8
HUGE = f32(3.0e38)
PI = f32(np.pi)
SUPPORTED_K = (1, 8, 16)
SUPPORTED_CHAIN = (0, 1, 2, 3)

# Rows of LaneState.f and LaneState.i.
X, Y, Z, UX, UY, UZ, TAU, TGAS = range(8)
ALIVE, ORDERS, PK, BAD, EVCT = range(5)


@dataclass
class LaneState:
    """Per-lane wavefront state, one fixed layout for every plan.

    ``f`` is (8, L) float32: x, y, z, ux, uy, uz, tau (remaining optical
    depth; 0 = draw a fresh free path), tgas (remaining gas optical depth
    before a gas absorption).  ``i`` is (5, L) int32: alive, orders, pk
    (pending exit kind: 1 top, 2 bottom, 3 absorbed), bad, evct.  The y and
    tgas rows are always present; plans that do not track y, or have no gas
    channel, leave them untouched.
    """

    f: torch.Tensor
    i: torch.Tensor

    @property
    def n_lanes(self) -> int:
        return self.f.shape[1]

    def clone(self) -> "LaneState":
        return LaneState(self.f.clone(), self.i.clone())


@dataclass(frozen=True)
class DetectorSpec:
    """Radiance detectors with the closed-form shadow trace
    (i3rc_tpu/integrators/fastpath.py:1140-1247), as float32 constants in
    Python floats (``fastpath.shadow_constants`` builds them).

    Per detector: direction (dx, dy, dz), f32(1/dz), the horizontal
    component dh along the varying axis and f32(1/dh), ``h_mode`` (0: no
    horizontal factor, 1: the ray keeps its horizontal position, so the
    factor is one chain value; 2: the cumulative integral FhP of the factor)
    and ``norm`` = f32(1 / (4 pi |mu|)).  ``z_segs`` are the (lo, hi, value)
    z segments with extinction > 0, value = fz * the constant other
    horizontal factor.  ``h_axis`` (0 x, 1 y, -1 none) names the varying
    horizontal factor; FhP's constants are ``h_lo``, ``h_tot``, ``h_w``,
    ``h_inv_w`` and ``h_cums`` (the integral at each interior threshold).
    The exit column wraps with ``wrap_w*`` / ``wrap_inv_*`` and bins with
    ``x0``/``inv_dx`` (and y when ``col_y``).  ``iwabuchi`` turns on the
    roulette of fastpath.py:1533-1550 with ``zeta`` and ``zeta_pi`` =
    f32(zeta / pi).  ``g_segs`` are the (lo, hi, value) z segments of the
    gas channel with value > 0 (fastpath.py:1160-1164), added to every
    shadow ray without a horizontal factor.
    """

    dirs: tuple
    inv_dz: tuple
    dh: tuple
    inv_dh: tuple
    h_mode: tuple
    norm: tuple
    z_segs: tuple
    h_axis: int
    h_lo: float
    h_tot: float
    h_w: float
    h_inv_w: float
    h_cums: tuple
    z_top: float
    z_bot: float
    x0: float
    inv_dx: float
    wrap_wx: float
    wrap_inv_x: float
    n_x: int
    col_y: bool
    y0: float
    inv_dy: float
    wrap_wy: float
    wrap_inv_y: float
    n_y: int
    iwabuchi: bool
    zeta: float
    zeta_pi: float
    g_segs: tuple = ()

    @property
    def n(self) -> int:
        return len(self.dirs)

    @property
    def n_cols(self) -> int:
        return self.n_x * (self.n_y if self.col_y else 1)


@dataclass(frozen=True)
class EventSpec:
    """Everything the event block needs besides the state and the draws.

    fx/fy/fz are fastpath.StepFactor chains; inv_* carry the reciprocal
    values (0 for zero segments).  Bounds, widths and nudges are float32
    values held in Python floats.  ``det`` holds the radiance detectors
    (None: flux only); detectors imply chain depth 0 (fastpath.py:1286).
    ``gz``/``inv_gz`` are the gas channel's StepFactor chain over z and its
    reciprocal (None: no gas channel, fastpath.py:925-936).  ``column`` is
    the column table of column media (fastpath.py:1320-1345) as an (n_cols,
    4) float32 tensor on the state's device, rows [v, z_base, z_top, 0]
    (padded so that a row is one 16-byte load), row ix * n_y + iy; the
    column read bins x and y with ``inv_dx``/``inv_dy`` and the faces step
    by ``dx``/``dy`` (float32 values in Python floats).
    """

    fx: object
    fy: object
    fz: object
    inv_fx: object
    inv_fy: object
    inv_fz: object
    x0: float
    y0: float
    z0: float
    x_max: float
    y_max: float
    z_max: float
    wx: float
    wy: float
    nudge_x: float
    nudge_y: float
    nudge_z: float
    g: float
    ssa: float
    max_events: int
    K: int
    chain: int
    track_y: bool
    det: DetectorSpec | None = None
    gz: object = None
    inv_gz: object = None
    column: torch.Tensor | None = None
    n_x: int = 1
    n_y: int = 1
    inv_dx: float = 0.0
    inv_dy: float = 0.0
    dx: float = 0.0
    dy: float = 0.0

    @property
    def gas(self) -> bool:
        return self.gz is not None

    @property
    def col(self) -> bool:
        return self.column is not None

    @property
    def absorbing(self) -> bool:
        return self.ssa < 1.0

    @property
    def bonus_draws(self) -> int:
        return 4 if self.absorbing else 3

    @property
    def n_draws(self) -> int:
        """Draws per event: free path, cosine, azimuth (+ absorption), then
        one Iwabuchi draw per detector (fastpath.py:890-895) or the chain's
        bonus phases (detectors and chaining exclude each other)."""
        iw = self.det.n if self.det is not None and self.det.iwabuchi else 0
        return self.bonus_draws * (1 + self.chain) + iw


def hg_cosine(g: float, u):
    """Exact HG inverse CDF: the closed form of sampleHG (g != 0)."""
    g = np.float32(g)
    one = np.float32(1.0)
    # Scalar factors in float32 arithmetic, as the JAX version computes them;
    # both divisions are tensor / tensor, since torch turns a division by a
    # scalar into a multiply by its reciprocal (a second rounding).
    denom = 1.0 + float(g) * (2.0 * u - 1.0)
    frac = torch.full_like(denom, float(one - g * g)) / denom
    c = (float(one + g * g) - frac * frac) / torch.full_like(denom, float(g + g))
    return torch.clamp(c, -1.0, 1.0)


def hg_phase(g: float, cos_theta):
    """HG phase value, normalized so integral over d(mu) is 2 (P_iso == 1).

    fastpath.py:658-662 with rsqrt as an IEEE sqrt and reciprocal, as the
    CUDA kernel computes it (torch's CUDA rsqrt is an approximation).
    """
    g = np.float32(g)
    one = np.float32(1.0)
    t = torch.clamp(float(one + g * g) - float(g + g) * cos_theta, min=f32(1e-12))
    r = torch.sqrt(t).reciprocal()
    return float(one - g * g) * r * r * r


def _cum_h(spec: EventSpec, xu):
    """FhP: the cumulative integral of the varying horizontal factor,
    periodically extended (fastpath.py:1175-1186)."""
    det = spec.det
    hf = (spec.fx, spec.fy)[det.h_axis]
    n = torch.floor((xu - det.h_lo) * det.h_inv_w)
    r = xu - n * det.h_w
    F = f32(hf.values[0]) * (r - det.h_lo)
    for t, v, c in zip(hf.thresholds, hf.values[1:], det.h_cums):
        F = torch.where(r >= f32(t), c + f32(v) * (r - f32(t)), F)
    return n * det.h_tot + F


def shadow_closed(spec: EventSpec, d: int, x, y, z):
    """(optical depth to the z boundary, exit column) along detector d from
    (x, y, z): the closed-form shadow trace (fastpath.py:1194-1247)."""
    det = spec.det
    dx, dy, dz = det.dirs[d]
    inv_dz = det.inv_dz[d]
    up = dz >= 0.0
    ph = (x, y)[det.h_axis] if det.h_axis >= 0 else None
    tau = torch.zeros_like(x)
    for zl, zh, v in det.z_segs:
        a, b = (zl, zh) if up else (zh, zl)
        t_lo = torch.clamp((a - z) * inv_dz, min=0.0)
        t_hi = torch.clamp((b - z) * inv_dz, min=0.0)
        if det.h_mode[d] == 2:
            dh = det.dh[d]
            seg = (_cum_h(spec, ph + t_hi * dh) - _cum_h(spec, ph + t_lo * dh)) \
                * det.inv_dh[d]
        elif det.h_mode[d] == 1:
            seg = (spec.fx, spec.fy)[det.h_axis](ph) * (t_hi - t_lo)
        else:
            seg = t_hi - t_lo
        tau = tau + v * torch.clamp(seg, min=0.0)
    for zl, zh, v in det.g_segs:
        a, b = (zl, zh) if up else (zh, zl)
        t_lo = torch.clamp((a - z) * inv_dz, min=0.0)
        t_hi = torch.clamp((b - z) * inv_dz, min=0.0)
        tau = tau + v * torch.clamp(t_hi - t_lo, min=0.0)
    t_ex = ((det.z_top if up else det.z_bot) - z) * inv_dz
    xe = x + t_ex * dx
    xe = xe - det.wrap_wx * torch.floor((xe - det.x0) * det.wrap_inv_x)
    col = torch.clamp(((xe - det.x0) * det.inv_dx).to(torch.int64), 0, det.n_x - 1)
    if det.col_y:
        ye = y + t_ex * dy
        ye = ye - det.wrap_wy * torch.floor((ye - det.y0) * det.wrap_inv_y)
        iy = torch.clamp(((ye - det.y0) * det.inv_dy).to(torch.int64), 0, det.n_y - 1)
        col = col * det.n_y + iy
    return tau, col


def _detector_block(spec: EventSpec, u, pos, dirs, collided, acc, records) -> None:
    """Local-estimate radiance of every collision (fastpath.py:1501-1571):
    P(photon -> detector) / (4 pi |mu_d|) x exp(-tau to the boundary) at the
    shadow ray's exit column, with Iwabuchi roulette when asked for.  ``pos``
    is the collision point, ``dirs`` the direction before scattering."""
    det = spec.det
    x, y, z = pos
    ux, uy, uz = dirs
    for d, (dx, dy, dz) in enumerate(det.dirs):
        proj = torch.clamp(ux * dx + uy * dy + uz * dz, -1.0, 1.0)
        norm_pf = hg_phase(spec.g, proj) * det.norm[d]
        tau, col = shadow_closed(spec, d, x, y, z)
        if det.iwabuchi:
            # Iwabuchi Eq 13/14 on the exact tau (monteCarloRadiativeTransfer
            # .f95:1536-1596): pf_pi <= zeta contributes zeta / pi with
            # probability (pf_pi / zeta) exp(-tau), the acceptance times the
            # transmittance of the reference's trace; otherwise beyond tau_max
            # the contribution survives with probability exp(tau_max - tau).
            # The JAX fastpath (fastpath.py:1544) leaves exp(-tau) out of the
            # first case and overestimates; the port does not copy that.
            u_iw = u[spec.bonus_draws + d]
            pf_pi = PI * norm_pf
            tau_max = -torch.log(torch.full_like(pf_pi, det.zeta)
                                 / torch.clamp(pf_pi, min=TINY))
            c_small = torch.where(u_iw * det.zeta <= pf_pi * torch.exp(-tau),
                                  det.zeta_pi, 0.0)
            c_large = torch.where(
                tau <= tau_max, norm_pf * torch.exp(-tau),
                torch.where(u_iw < torch.exp(tau_max - tau), det.zeta_pi, 0.0))
            contrib = torch.where(collided, torch.where(pf_pi <= det.zeta, c_small,
                                                        c_large), 0.0)
        else:
            contrib = torch.where(collided, norm_pf * torch.exp(-tau), 0.0)
        if acc is not None:
            acc.view(-1).index_add_(0, col * det.n + d, contrib.to(torch.float64))
        if records is not None:
            records.append((contrib, col))


def _wrap(v, lo: float, hi: float, w: float):
    """Periodic wrap for positions at most one event-step outside."""
    return torch.where(v >= hi, v - w, torch.where(v < lo, v + w, v))


def _fast_event(spec: EventSpec, u, s: dict, acc=None, records=None) -> None:
    """One fast_event (fastpath.py:1291-1676 with MARCH = 1) on the lane
    tensors in ``s``; u is the (n_draws, L) draw block of the event.
    Detector contributions go into ``acc`` ((n_cols, D) float64) and, per
    event and detector, as (contribution, column) pairs into ``records``.
    With a gas channel the lanes also carry ``s["tgas"]``."""
    x, y, z = s["x"], s["y"], s["z"]
    ux, uy, uz = s["ux"], s["uy"], s["uz"]
    alive, pk = s["alive"], s["pk"]
    ty, gas = spec.track_y, spec.gas
    tau = torch.where(s["tau"] > 0.0, s["tau"], exponential_deviate(u[0]))

    up_x, up_z = ux >= 0.0, uz >= 0.0
    sign_x = torch.where(up_x, spec.nudge_x, -spec.nudge_x)
    sign_z = torch.where(up_z, spec.nudge_z, -spec.nudge_z)
    if spec.col:
        # The lane's column row [v, z_base, z_top] (fastpath.py:1320-1345):
        # ix/iy truncate toward zero and clip; the faces are the x/y grid
        # lines (floor) and the column's own layer bounds.
        ix = torch.clamp(((x - spec.x0) * spec.inv_dx).to(torch.int64), 0, spec.n_x - 1)
        iy = torch.clamp(((y - spec.y0) * spec.inv_dy).to(torch.int64), 0, spec.n_y - 1)
        row = spec.column[ix * spec.n_y + iy]
        vcol, zb, zt = row[:, 0], row[:, 1], row[:, 2]
        ext = torch.where((z >= zb) & (z < zt), vcol, 0.0)
        face_x = spec.x0 + (torch.floor((x - spec.x0) * spec.inv_dx)
                            + up_x.to(torch.float32)) * spec.dx
        face_z = torch.where(up_z,
                             torch.where(z < zb, zb, torch.where(z < zt, zt, spec.z_max)),
                             torch.where(z > zt, zt, torch.where(z > zb, zb, spec.z0)))
    else:
        ext = spec.fx(x) * spec.fz(z)
        inv_ext = spec.inv_fx(x) * spec.inv_fz(z)
        face_x = spec.fx.next_face(x, up_x, spec.x0, spec.x_max)
        face_z = spec.fz.next_face(z, up_z, spec.z0, spec.z_max)
    if gas:
        # Steps also stop at the gas segment faces, so gz is constant along
        # the step (fastpath.py:1361-1369).
        tgas = s["tgas"]
        gzv = spec.gz(z)
        face_zg = spec.gz.next_face(z, up_z, spec.z0, spec.z_max)
        face_z = torch.where(up_z, torch.minimum(face_z, face_zg),
                             torch.maximum(face_z, face_zg))
    sx = torch.where(ux.abs() >= f32(2e-30), (face_x - x) / ux, HUGE)
    sz = torch.where(uz.abs() >= f32(2e-30), (face_z - z) / uz, HUGE)
    s_bnd = torch.minimum(sx, sz)
    if ty:
        up_y = uy >= 0.0
        sign_y = torch.where(up_y, spec.nudge_y, -spec.nudge_y)
        if spec.col:
            face_y = spec.y0 + (torch.floor((y - spec.y0) * spec.inv_dy)
                                + up_y.to(torch.float32)) * spec.dy
        else:
            ext = ext * spec.fy(y)
            inv_ext = inv_ext * spec.inv_fy(y)
            face_y = spec.fy.next_face(y, up_y, spec.y0, spec.y_max)
        sy = torch.where(uy.abs() >= f32(2e-30), (face_y - y) / uy, HUGE)
        s_bnd = torch.minimum(s_bnd, sy)
    s_bnd = torch.clamp(s_bnd, min=0.0)
    if spec.col:
        # A division here, tensor by tensor (fastpath.py:1378-1379).
        s_col = torch.where(ext > 0.0, tau / torch.clamp(ext, min=TINY), HUGE)
    else:
        s_col = torch.where(ext > 0.0, tau * inv_ext, HUGE)

    if gas:
        # The gas absorption competes as a third outcome; its optical depth
        # is consumed along every step (fastpath.py:1383-1391).
        s_gas = torch.where(gzv > 0.0, tgas * spec.inv_gz(z), HUGE)
        collide = alive & (s_col <= s_bnd) & (s_col <= s_gas)
        gas_die = alive & ~collide & (s_gas <= s_bnd)
        cross = alive & ~collide & ~gas_die
        adv = torch.minimum(torch.minimum(s_col, s_bnd), s_gas)
        tgas = torch.where(alive, tgas - adv * gzv, tgas)
    else:
        collide = alive & (s_col <= s_bnd)
        cross = alive & ~collide
        adv = torch.minimum(s_col, s_bnd)
    nxp = torch.where(cross & (sx <= s_bnd), face_x + sign_x, x + ux * adv)
    nzp = torch.where(cross & (sz <= s_bnd), face_z + sign_z, z + uz * adv)
    nxp = _wrap(nxp, spec.x0, spec.x_max, spec.wx)
    exit_top = cross & (nzp >= spec.z_max)
    exit_bot = cross & ~exit_top & (nzp <= spec.z0)
    pk = torch.where(exit_top, 1, torch.where(exit_bot, 2, pk))
    if gas:
        pk = torch.where(gas_die, 3, pk)
    tau = torch.where(cross, tau - s_bnd * ext, torch.where(collide, 0.0, tau))
    x = torch.where(alive, nxp, x)
    z = torch.where(alive, nzp, z)
    if ty:
        nyp = torch.where(cross & (sy <= s_bnd), face_y + sign_y, y + uy * adv)
        y = torch.where(alive, _wrap(nyp, spec.y0, spec.y_max, spec.wy), y)

    collided = collide
    if spec.absorbing:
        die = collided & (u[3] >= f32(spec.ssa))
        pk = torch.where(die, 3, pk)
        collided = collided & ~die
    if spec.det is not None:
        _detector_block(spec, u, (x, y, z), (ux, uy, uz), collided, acc, records)
    nux, nuy, nuz = rotate_direction(ux, uy, uz, hg_cosine(spec.g, u[1]), u[2],
                                     renormalize=False)
    ux = torch.where(collided, nux, ux)
    uy = torch.where(collided, nuy, uy)
    uz = torch.where(collided, nuz, uz)
    n_coll = collided.to(torch.int32)

    if spec.chain:
        # Collision chaining inside the segment box of the collision point
        # (fastpath.py:1598-1665); in column media the box is the x/y cell
        # of the collision point and the layer of the column read at the
        # start of the event (:1607-1614).
        if spec.col:
            wx_lo = spec.x0 + torch.floor((x - spec.x0) * spec.inv_dx) * spec.dx
            wx_hi = wx_lo + spec.dx
            wz_lo, wz_hi = zb, zt
            inv_c = torch.ones_like(vcol) / torch.clamp(vcol, min=TINY)
        else:
            wx_lo = spec.fx.face_dn(x, spec.x0)
            wx_hi = spec.fx.face_up(x, spec.x_max)
            wz_lo = spec.fz.face_dn(z, spec.z0)
            wz_hi = spec.fz.face_up(z, spec.z_max)
            inv_c = spec.inv_fx(x) * spec.inv_fz(z)
        if ty:
            if spec.col:
                wy_lo = spec.y0 + torch.floor((y - spec.y0) * spec.inv_dy) * spec.dy
                wy_hi = wy_lo + spec.dy
            else:
                wy_lo = spec.fy.face_dn(y, spec.y0)
                wy_hi = spec.fy.face_up(y, spec.y_max)
                inv_c = inv_c * spec.inv_fy(y)
        if gas:
            # The box also ends at the gas faces; a candidate commits only
            # while the gas threshold outlasts it (fastpath.py:1622-1652).
            gzv_c = spec.gz(z)
            wz_lo = torch.maximum(wz_lo, spec.gz.face_dn(z, spec.z0))
            wz_hi = torch.minimum(wz_hi, spec.gz.face_up(z, spec.z_max))
        chain = collided
        for b in range(spec.chain):
            i0 = spec.bonus_draws * (1 + b)
            tau_new = exponential_deviate(u[i0])
            s_c = tau_new * inv_c
            cx = x + ux * s_c
            cz = z + uz * s_c
            inside = (cx > wx_lo) & (cx < wx_hi) & (cz > wz_lo) & (cz < wz_hi)
            if ty:
                cy = y + uy * s_c
                inside = inside & (cy > wy_lo) & (cy < wy_hi)
            if gas:
                gcost = s_c * gzv_c
                inside = inside & (gcost < tgas)
            commit = chain & inside
            tau = torch.where(chain & ~inside, tau_new, tau)
            x = torch.where(commit, cx, x)
            z = torch.where(commit, cz, z)
            if ty:
                y = torch.where(commit, cy, y)
            if gas:
                tgas = torch.where(commit, tgas - gcost, tgas)
            n_coll = n_coll + commit.to(torch.int32)
            if spec.absorbing:
                die_c = commit & (u[i0 + 3] >= f32(spec.ssa))
                pk = torch.where(die_c, 3, pk)
                commit = commit & ~die_c
            bx, by, bz = rotate_direction(ux, uy, uz, hg_cosine(spec.g, u[i0 + 1]),
                                          u[i0 + 2], renormalize=False)
            ux = torch.where(commit, bx, ux)
            uy = torch.where(commit, by, uy)
            uz = torch.where(commit, bz, uz)
            chain = commit

    orders = s["orders"] + n_coll
    over = alive & (orders >= spec.max_events)
    s.update(x=x, y=y, z=z, ux=ux, uy=uy, uz=uz, tau=tau, pk=pk, orders=orders,
             bad=s["bad"] + over.to(torch.int32),
             evct=s["evct"] + alive.to(torch.int32),
             alive=alive & (pk == 0) & ~over)
    if gas:
        s["tgas"] = tgas


def event_block_reference(spec: EventSpec, state: LaneState, uniforms, acc=None,
                          records=None) -> None:
    """Plain PyTorch version of the kernel: K events with the given draws.

    ``uniforms`` is (K, n_draws, L) float32 in the kernel's layout.  Updates
    ``state`` in place; with detectors, adds their contributions to ``acc``
    ((n_cols, D) float64) and appends each event's per-detector
    (contribution, column) pairs to the list ``records`` when given.
    """
    f, i = state.f, state.i
    s = {"x": f[X], "y": f[Y], "z": f[Z], "ux": f[UX], "uy": f[UY], "uz": f[UZ],
         "tau": f[TAU], "tgas": f[TGAS], "alive": i[ALIVE] != 0, "orders": i[ORDERS],
         "pk": i[PK], "bad": i[BAD], "evct": i[EVCT]}
    for j in range(spec.K):
        _fast_event(spec, uniforms[j], s, acc, records)
    state.f.copy_(torch.stack([s[k] for k in ("x", "y", "z", "ux", "uy", "uz", "tau",
                                              "tgas")]))
    state.i.copy_(torch.stack([s["alive"].to(torch.int32), s["orders"], s["pk"],
                               s["bad"], s["evct"]]))


def compare_states(spec: EventSpec, got: LaneState, ref: LaneState, rtol: float) -> dict:
    """Lane-by-lane agreement of two states after the same event block.

    ``int_frac``: share of lanes whose five integer fields are equal.
    ``float_frac``: share of those lanes whose eight float fields are all
    within rtol of ``ref`` relative to the field's magnitude, max(|ref|, 1)
    over the lanes (x and y compared on the periodic domain).
    ``max_abs_err``: largest float difference on those lanes.
    A lane can flip an integer field when one rounding step differs (a lane
    sitting on a segment face); such lanes are counted, not compared.
    """
    int_eq = (got.i == ref.i).all(dim=0)
    d = (got.f - ref.f).abs()
    d[X] = torch.minimum(d[X], (spec.wx - d[X]).abs())
    d[Y] = torch.minimum(d[Y], (spec.wy - d[Y]).abs())
    scale = ref.f.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    ok = (d <= rtol * scale).all(dim=0) & int_eq
    n_eq = int(int_eq.sum())
    return {"int_frac": n_eq / got.n_lanes,
            "float_frac": int(ok.sum()) / max(n_eq, 1),
            "max_abs_err": float(d[:, int_eq].max()) if n_eq else float("inf")}


# ---------------------------------------------------------------------------
# The CUDA kernel

class _StepChain(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int),
                ("t", ctypes.c_float * MAX_SEGMENTS),
                ("v", ctypes.c_float * (MAX_SEGMENTS + 1)),
                ("iv", ctypes.c_float * (MAX_SEGMENTS + 1))]


class _DetParams(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("n_bins", ctypes.c_int)] + [
        (n, ctypes.c_float * MAX_DETECTORS)
        for n in ("dx", "dy", "dz", "inv_dz", "dh", "inv_dh", "norm")] + [
        ("mode", ctypes.c_int * MAX_DETECTORS), ("n_z", ctypes.c_int)] + [
        (n, ctypes.c_float * (MAX_SEGMENTS + 1)) for n in ("z_lo", "z_hi", "z_v")] + [
        ("h_axis", ctypes.c_int)] + [
        (n, ctypes.c_float) for n in ("h_lo", "h_tot", "h_w", "h_inv_w")] + [
        ("h_cum", ctypes.c_float * MAX_SEGMENTS)] + [
        (n, ctypes.c_float) for n in ("z_top", "z_bot", "x0", "inv_dx", "wrap_wx",
                                      "wrap_inv_x", "y0", "inv_dy", "wrap_wy",
                                      "wrap_inv_y")] + [
        (n, ctypes.c_int) for n in ("n_x", "n_y", "col_y")] + [
        (n, ctypes.c_float) for n in ("zeta", "zeta_pi")] + [
        ("n_g", ctypes.c_int)] + [
        (n, ctypes.c_float * (MAX_SEGMENTS + 1)) for n in ("g_lo", "g_hi", "g_v")]


class _EventParams(ctypes.Structure):
    _fields_ = [("fx", _StepChain), ("fy", _StepChain), ("fz", _StepChain)] + [
        (n, ctypes.c_float) for n in ("x0", "y0", "z0", "x_max", "y_max", "z_max",
                                      "wx", "wy", "nudge_x", "nudge_y", "nudge_z",
                                      "g", "ssa")] + [
        ("max_events", ctypes.c_int), ("key0", ctypes.c_uint32),
        ("key1", ctypes.c_uint32), ("kb", ctypes.c_uint32), ("n_lanes", ctypes.c_int),
        ("det", _DetParams), ("gz", _StepChain), ("n_x", ctypes.c_int),
        ("n_y", ctypes.c_int)] + [
        (n, ctypes.c_float) for n in ("inv_dx", "inv_dy", "dx", "dy")]


def _step_chain(f, inv) -> _StepChain:
    c = _StepChain()
    c.n = len(f.thresholds)
    c.t[:c.n] = [f32(t) for t in f.thresholds]
    c.v[:c.n + 1] = [f32(v) for v in f.values]
    c.iv[:c.n + 1] = [f32(v) for v in inv.values]
    return c


def _det_params(det: DetectorSpec) -> _DetParams:
    q = _DetParams()
    q.n, q.n_bins = det.n, det.n_cols * det.n
    for d, (dx, dy, dz) in enumerate(det.dirs):
        q.dx[d], q.dy[d], q.dz[d] = dx, dy, dz
        q.inv_dz[d], q.dh[d], q.inv_dh[d] = det.inv_dz[d], det.dh[d], det.inv_dh[d]
        q.norm[d], q.mode[d] = det.norm[d], det.h_mode[d]
    q.n_z = len(det.z_segs)
    for k, (lo, hi, v) in enumerate(det.z_segs):
        q.z_lo[k], q.z_hi[k], q.z_v[k] = lo, hi, v
    q.n_g = len(det.g_segs)
    for k, (lo, hi, v) in enumerate(det.g_segs):
        q.g_lo[k], q.g_hi[k], q.g_v[k] = lo, hi, v
    q.h_axis = det.h_axis
    q.h_cum[:len(det.h_cums)] = list(det.h_cums)
    for n in ("h_lo", "h_tot", "h_w", "h_inv_w", "z_top", "z_bot", "x0", "inv_dx",
              "wrap_wx", "wrap_inv_x", "y0", "inv_dy", "wrap_wy", "wrap_inv_y", "n_x",
              "n_y", "col_y", "zeta", "zeta_pi"):
        setattr(q, n, getattr(det, n))
    return q


@functools.lru_cache(maxsize=None)
def build():
    """Compile (or reuse) the kernel library and declare its C interface: the
    event block in its three sources and the column-read probe
    (``kernels/column_probe.py``), four ``nvcc`` processes in parallel."""
    from i3rc_tpu_torch.kernels.build import build as _build

    built = _build("fast_event_block", ("fast_event_block.cu", "fast_event_block_gas.cu",
                                        "fast_event_block_col.cu", "column_read_probe.cu"))
    lib = built.lib
    vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.i3rc_event_params_size.argtypes = []
    lib.i3rc_event_params_size.restype = ci
    lib.i3rc_fast_event_block.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.i3rc_fast_event_block.restype = ci
    lib.i3rc_philox_uniforms.argtypes = [vp, cu, cu, cu, cu, ci, ci, vp]
    lib.i3rc_philox_uniforms.restype = ci
    lib.i3rc_philox_bits.argtypes = [vp, cu, cu, cu, cu, cu, ci, vp]
    lib.i3rc_philox_bits.restype = ci
    lib.i3rc_column_read_probe.argtypes = [vp, vp, vp, vp, ci, cu, cu, cu, vp]
    lib.i3rc_column_read_probe.restype = ci
    if lib.i3rc_event_params_size() != ctypes.sizeof(_EventParams):
        raise RuntimeError("EventParams layout differs between Python and CUDA")
    return built


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _launch(spec: EventSpec, state: LaneState, key: PhiloxKey, kb: int, acc) -> None:
    f, i = state.f, state.i
    L = state.n_lanes
    if f.device != i.device or i.device.type != "cuda":
        raise ValueError("event_block: state tensors must share one CUDA device")
    if f.dtype != torch.float32 or i.dtype != torch.int32:
        raise TypeError("event_block: state must be float32 (f) and int32 (i)")
    if f.shape != (8, L) or i.shape != (5, L) or not (f.is_contiguous()
                                                      and i.is_contiguous()):
        raise ValueError("event_block: state must be contiguous (8, L) and (5, L)")
    if spec.K not in SUPPORTED_K or spec.chain not in SUPPORTED_CHAIN:
        raise NotImplementedError(
            f"event_block kernel is built for K in {SUPPORTED_K} and chain depth in "
            f"{SUPPORTED_CHAIN}; got K={spec.K}, chain={spec.chain}")
    det = spec.det
    col = spec.column
    if col is not None:
        if det is not None or spec.gas or not spec.track_y:
            raise NotImplementedError("event_block kernel runs column media for flux "
                                      "without the gas channel, y tracked")
        if (col.device != f.device or col.dtype != torch.float32
                or col.shape != (spec.n_x * spec.n_y, 4) or not col.is_contiguous()):
            raise ValueError("event_block: the column table must be a contiguous float32 "
                             f"({spec.n_x * spec.n_y}, 4) tensor on the state's device")
    if det is not None:
        if det.n > MAX_DETECTORS or spec.chain:
            raise NotImplementedError(
                f"event_block kernel takes at most {MAX_DETECTORS} detectors at chain "
                f"depth 0; got {det.n} at chain {spec.chain}")
        if (acc.device != f.device or acc.dtype != torch.float64
                or acc.shape != (det.n_cols, det.n) or not acc.is_contiguous()):
            raise ValueError("event_block: acc must be a contiguous float64 "
                             f"({det.n_cols}, {det.n}) tensor on the state's device")
    p = event_params(spec, key, kb, L)
    lib = build().lib
    with torch.cuda.device(f.device):
        rc = lib.i3rc_fast_event_block(
            f.data_ptr(), i.data_ptr(), acc.data_ptr() if det is not None else None,
            col.data_ptr() if col is not None else None,
            ctypes.byref(p), spec.K, spec.chain, int(spec.absorbing), int(spec.track_y),
            int(det is not None), int(det is not None and det.iwabuchi), int(spec.gas),
            _stream(f.device))
    _check(rc, "fast_event_block launch")


def event_params(spec: EventSpec, key: PhiloxKey, kb: int, n_lanes: int) -> _EventParams:
    """The kernel's by-value parameter block for one launch."""
    p = _EventParams()
    p.fx = _step_chain(spec.fx, spec.inv_fx)
    p.fy = _step_chain(spec.fy, spec.inv_fy)
    p.fz = _step_chain(spec.fz, spec.inv_fz)
    for n in ("x0", "y0", "z0", "x_max", "y_max", "z_max", "wx", "wy",
              "nudge_x", "nudge_y", "nudge_z", "g", "ssa"):
        setattr(p, n, getattr(spec, n))
    p.max_events = spec.max_events
    p.key0, p.key1 = key.seed & 0xFFFFFFFF, key.batch & 0xFFFFFFFF
    p.kb = kb & 0xFFFFFFFF
    p.n_lanes = n_lanes
    if spec.det is not None:
        p.det = _det_params(spec.det)
    if spec.gas:
        p.gz = _step_chain(spec.gz, spec.inv_gz)
    p.n_x, p.n_y = spec.n_x, spec.n_y
    for n in ("inv_dx", "inv_dy", "dx", "dy"):
        setattr(p, n, getattr(spec, n))
    return p


def event_block(spec: EventSpec, state: LaneState, key: PhiloxKey, kb: int,
                acc=None) -> None:
    """Advance every lane K events, in place, with the draws of block ``kb``.

    With detectors (``spec.det``) their contributions are added to ``acc``,
    a float64 (n_cols, D) tensor on the state's device.  CUDA tensors launch
    the kernel, counted per variant in ``event_block.launches`` (flux),
    ``detector_launches`` (detectors), ``gas_launches`` (flux with the gas
    channel), ``gas_detector_launches`` (detectors with the gas channel) and
    ``column_launches`` (flux in column media); CPU tensors run the plain
    twin on ``philox_uniforms`` draws.
    """
    if (spec.det is None) != (acc is None):
        raise ValueError("event_block: acc is given exactly when the spec has detectors")
    device = state.f.device
    if device.type == "cuda":
        _launch(spec, state, key, kb, acc)
        counter = LAUNCH_COUNTERS[(spec.det is not None, spec.gas, spec.col)]
        setattr(event_block, counter, getattr(event_block, counter) + 1)
    elif device.type == "cpu":
        u = philox_uniforms(key, kb, spec.K, spec.n_draws, state.n_lanes, device)
        event_block_reference(spec, state, u, acc)
    else:
        raise NotImplementedError(f"event_block: no kernel for device {device}")


# The launch counter of each kernel variant, by (detectors, gas, column).
LAUNCH_COUNTERS = {(False, False, False): "launches",
                   (True, False, False): "detector_launches",
                   (False, True, False): "gas_launches",
                   (True, True, False): "gas_detector_launches",
                   (False, False, True): "column_launches"}


def reset_launch_counters() -> None:
    for name in LAUNCH_COUNTERS.values():
        setattr(event_block, name, 0)


reset_launch_counters()


def kernel_philox_uniforms(key: PhiloxKey, kb: int, K: int, n_draws: int, n_lanes: int,
                           device) -> torch.Tensor:
    """The kernel's own event draws, (K, n_draws, L): the test entry of the
    CUDA library, for bit-for-bit checks against rng.philox_uniforms."""
    G = -(-n_draws // 4)
    out = torch.empty((4 * K * G, n_lanes), dtype=torch.float32, device=device)
    with torch.cuda.device(out.device):
        rc = build().lib.i3rc_philox_uniforms(
            out.data_ptr(), key.seed & 0xFFFFFFFF, key.batch & 0xFFFFFFFF,
            kb & 0xFFFFFFFF, STREAM_EVENT, K * G, n_lanes, _stream(out.device))
    _check(rc, "philox_uniforms launch")
    return out.reshape(K, 4 * G, n_lanes)[:, :n_draws]


def kernel_philox_bits(k0: int, k1: int, c1: int, c2: int, c3: int, n_lanes: int,
                       device) -> torch.Tensor:
    """(n_lanes, 4) raw Philox4x32-10 words at counter (lane, c1, c2, c3)."""
    out = torch.empty((n_lanes, 4), dtype=torch.int32, device=device)
    with torch.cuda.device(out.device):
        rc = build().lib.i3rc_philox_bits(out.data_ptr(), k0, k1, c1, c2, c3, n_lanes,
                                          _stream(out.device))
    _check(rc, "philox_bits launch")
    return out.to(torch.int64) & 0xFFFFFFFF
