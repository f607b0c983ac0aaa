"""Fused transport fastpath (separable or column optics, HG phase) in PyTorch.

Port of ``i3rc_tpu/integrators/fastpath.py`` for flux and radiance on a
black surface, with or without the baked gas channel, and for flux in
column media (one homogeneous layer per (x, y) column: the I3RC Landsat
scene):

  * the host-side planner (``StepFactor``, ``separable_factors``,
    ``detect_hg``, ``FastPlan``, ``fast_plan``) in numpy, with the
    StepFactor where-chains also as torch functions, and the constants of
    the closed-form shadow trace (``shadow_constants``), and the cloud + gas
    split of two-component domains (``_gas_split``), and the column table of
    column media (``column_structure``);
  * the trace loop (``make_fast_tracer``): per K-event block it renormalizes
    directions, flushes pending exits into float64 per-column tallies
    (``index_add_``), refills dead lanes in FIFO order (``cumsum``) and runs
    the event block (``kernels/event_block.py``: the CUDA kernel on a card,
    its plain twin on the CPU), which also adds the radiance detectors'
    local estimates to a float64 (n_cols, D) accumulator.  A gas plan
    draws each lane's exponential gas threshold at launch and at refill
    (``rng.STREAM_GAS``).

Extinction is factorized as ext(x, y, z) = fx(x) * fy(y) * fz(z) with few-
segment step functions, or read per event from the lane's row [v, z_base,
z_top] of the column table; every photon keeps weight 1 and tallies once at
its death (exit top, exit bottom, or absorption: Bernoulli when ssa < 1, or
the gas channel when its threshold runs out).

Plans the JAX package supports but the port does not yet — the marching
shadow trace, reflecting surfaces, fused-k gas batching, tabulated phase
functions (per-column properties included) — raise NotImplementedError
naming their ROADMAP item;
configurations the JAX planner rejects return None, as there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from i3rc_tpu_torch.core.illumination import PhotonSource
from i3rc_tpu_torch.core.rng import (GAS_LAUNCH_BLOCK, STREAM_REFILL, PhiloxKey,
                                     gas_thresholds)
from i3rc_tpu_torch.integrators.wavefront import RawTallies, f32, make_direction_cosines
# hg_cosine is re-exported: the JAX package defines it in fastpath.
from i3rc_tpu_torch.kernels.event_block import (  # noqa: F401
    ALIVE, BAD, EVCT, MAX_SEGMENTS, ORDERS, PK, TAU, TGAS, UX, UY, UZ, X, Y, Z,
    DetectorSpec, EventSpec, LaneState, event_block, hg_cosine,
)

# Rows of the JAX package's one-hot read limit (i3rc_tpu/ops/gather.py):
# column media beyond it are not eligible there either.
ONEHOT_MAX_ROWS = 1 << 18

# Lanes per wavefront when the caller gives none (not tuned on the GPU yet).
DEFAULT_LANES = 1 << 20


def lane_width(n_photons: int, n_lanes: int | None = None) -> int:
    """The wavefront width: the caller's, else min(n_photons, DEFAULT_LANES)."""
    return int(n_lanes or min(n_photons, DEFAULT_LANES))

# Features of the JAX fastpath not ported yet, by ROADMAP item number.
_ITEM_MARCHING = (10.5, "the marching shadow trace for radiance detectors (two varying "
                        "horizontal factors): ROADMAP item 10b")
_ITEM_SURFACE = (11, "reflecting surfaces and BRDFs on the fastpath: ROADMAP item 11")
_ITEM_GAS_K = (13.5, "fused-k gas batching (GasKTables): ROADMAP item 13b")
_ITEM_TABLE = (15, "tabulated (non-HG) phase functions on the fastpath: ROADMAP item 15")


# ---------------------------------------------------------------------------
# Host-side plan construction
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StepFactor:
    """Piecewise-constant 1-D function of position: values[i] applies on
    [thresholds[i-1], thresholds[i]) with implicit end thresholds."""

    thresholds: tuple[float, ...]  # ascending interior breakpoints
    values: tuple[float, ...]      # len(thresholds) + 1

    def __call__(self, pos):
        v = torch.full_like(pos, f32(self.values[0]))
        for t, val in zip(self.thresholds, self.values[1:]):
            v = torch.where(pos >= f32(t), f32(val), v)
        return v

    def face_up(self, pos, hi: float):
        """Nearest segment boundary (or domain edge) above pos (strict)."""
        face = torch.full_like(pos, f32(hi))
        for t in reversed(self.thresholds):
            face = torch.where(pos < f32(t), f32(t), face)
        return face

    def face_dn(self, pos, lo: float):
        """Nearest segment boundary (or domain edge) below pos (strict)."""
        face = torch.full_like(pos, f32(lo))
        for t in self.thresholds:
            face = torch.where(pos > f32(t), f32(t), face)
        return face

    def next_face(self, pos, up, lo: float, hi: float):
        """Nearest segment boundary (or domain edge) in the travel direction."""
        return torch.where(up, self.face_up(pos, hi), self.face_dn(pos, lo))

    @property
    def n_ops(self) -> int:
        return len(self.thresholds)

    def reciprocal(self) -> "StepFactor":
        """Reciprocal-value chain (zero segments -> 0; masked by ext > 0)."""
        return StepFactor(self.thresholds,
                          tuple(1.0 / v if v else 0.0 for v in self.values))


def _compress_factor(values: np.ndarray, edges: np.ndarray) -> StepFactor | None:
    """Run-length compress per-cell values into a StepFactor over position."""
    values = np.asarray(values, dtype=np.float64)
    change = np.flatnonzero(np.diff(values)) + 1
    if change.size > MAX_SEGMENTS:
        return None
    return StepFactor(tuple(float(edges[i]) for i in change),
                      tuple([float(values[0])] + [float(values[i]) for i in change]))


def separable_factors(ext: np.ndarray, x_edges, y_edges, z_edges):
    """Exact rank-1 factorization ext = fx ⊗ fy ⊗ fz, or None.

    Chooses the max-extinction cell as pivot and verifies the outer product
    reproduces the field to float32 accuracy.  Zero fields factorize
    trivially.
    """
    ext = np.asarray(ext, dtype=np.float64)
    if ext.ndim != 3:
        return None
    if not np.any(ext):
        return StepFactor((), (0.0,)), StepFactor((), (1.0,)), StepFactor((), (1.0,))
    i0, j0, k0 = np.unravel_index(np.argmax(ext), ext.shape)
    pivot = ext[i0, j0, k0]
    vx = ext[:, j0, k0] / pivot
    vy = ext[i0, :, k0] / pivot
    vz = ext[i0, j0, :]
    recon = vx[:, None, None] * vy[None, :, None] * vz[None, None, :]
    if not np.allclose(recon, ext, rtol=1e-6, atol=1e-9 * pivot):
        return None
    fx = _compress_factor(vx, np.asarray(x_edges, float))
    fy = _compress_factor(vy, np.asarray(y_edges, float))
    fz = _compress_factor(vz, np.asarray(z_edges, float))
    if fx is None or fy is None or fz is None:
        return None
    return fx, fy, fz


def column_structure(ext: np.ndarray, z_edges: np.ndarray, ssa=None, pfi=None):
    """(n_cols, 3 or 5) column table when every column is one homogeneous
    layer, else None — the eligibility test of the JAX column mode
    (fastpath.py:164-211), kept so the port declines the same domains."""
    nx, ny, nz = ext.shape
    if nx * ny > ONEHOT_MAX_ROWS:
        return None
    flat = ext.reshape(nx * ny, nz)
    nonzero = flat > 0.0
    count = nonzero.sum(axis=1)
    first = np.where(count > 0, np.argmax(nonzero, axis=1), 0)
    last = np.where(count > 0, nz - 1 - np.argmax(nonzero[:, ::-1], axis=1), -1)
    if not np.all((last - first + 1 == count) | (count == 0)):
        return None
    v = flat.max(axis=1)
    if not np.all(np.where(nonzero, flat, v[:, None]) == v[:, None]):
        return None
    z_edges = np.asarray(z_edges, np.float64)
    zb = np.where(count > 0, z_edges[first], z_edges[0])
    zt = np.where(count > 0, z_edges[last + 1], z_edges[0])
    cols = [v, zb, zt]
    if ssa is not None:
        for field in (np.asarray(ssa, np.float64).reshape(nx * ny, nz),
                      np.asarray(pfi, np.float64).reshape(nx * ny, nz)):
            rep = field[np.arange(nx * ny), first]
            if not np.all(np.where(nonzero, field, rep[:, None]) == rep[:, None]):
                return None
            cols.append(np.where(count > 0, rep, 0.0))
    return np.stack(cols, axis=1).astype(np.float32)


def detect_hg(table) -> float | None:
    """Asymmetry parameter when the (single-entry) table is pure HG.

    HG Legendre moments are xi_l = g^l; the tolerance grows with the order
    because netCDF round trips store the coefficients as float32.
    """
    if len(table.phase_functions) != 1:
        return None
    c = table.phase_functions[0].legendre_coefficients
    if c is None or c.size < 2:
        return None
    g = float(c[0])
    if abs(g) >= 1.0:
        return None
    orders = np.arange(1, c.size + 1)
    expect = g ** orders
    tol = 2.5e-7 * (orders + 1) * np.abs(expect) + 1e-12
    if not np.all(np.abs(np.asarray(c, float) - expect) <= tol):
        return None
    return g


@dataclass(frozen=True)
class FastPlan:
    """Static (host-side) description of one fastpath trace: the separable
    extinction factors, the HG asymmetry, the block length K (``unroll``)
    and the uniform single-scattering albedo (< 1: Bernoulli absorption)."""

    fx: StepFactor
    fy: StepFactor
    fz: StepFactor
    hg_g: float
    unroll: int
    ssa: float = 1.0
    # (dx, dy, dz, |mu|) per radiance detector; closed_shadow: at most one
    # horizontal factor varies and every detector leaves the z range, so the
    # transmittance is closed-form (fastpath.py:602-606).
    detectors: tuple = ()
    closed_shadow: bool = False
    # Gas channel (fastpath.py:925-936): the horizontally uniform pure
    # absorber of a cloud + gas domain as a StepFactor over z, and the gas
    # component's index (the cloud is the other one).
    gas_factor: StepFactor | None = None
    gas_idx: int = -1
    # Column media (fastpath.py:289-297): (n_cols, 3) float32 [v, z_base,
    # z_top] per (x, y) column, row ix * n_y + iy; fx = fy = fz = 1.
    column_data: np.ndarray | None = None

    def __eq__(self, other):
        if not isinstance(other, FastPlan):
            return NotImplemented
        a, b = self.column_data, other.column_data
        same_cols = (a is None and b is None) or (
            a is not None and b is not None and np.array_equal(a, b))
        return same_cols and all(getattr(self, f) == getattr(other, f) for f in
                                 self.__dataclass_fields__ if f != "column_data")


@dataclass(frozen=True)
class OpticsFlags:
    """Single-component uniformity flags the planner reads
    (i3rc_tpu/integrators/integrator.py:95-107)."""

    n_components: int
    uniform_ssa: float | None
    uniform_phase_index: int | None


def optics_flags(flat) -> OpticsFlags:
    """Uniform ssa / phase index over every cell with extinction, or None."""
    n_comp = flat.n_components
    uniform_ssa = uniform_pf = None
    if n_comp == 1:
        occupied = flat.total_ext.ravel() > 0.0
        if occupied.any():
            s = flat.ssa.ravel()[occupied]
            p = flat.phase_index.ravel()[occupied]
            if np.all(s == s[0]):
                uniform_ssa = float(s[0])
            if np.all(p == p[0]):
                uniform_pf = int(p[0])
    return OpticsFlags(n_comp, uniform_ssa, uniform_pf)


def _gas_split(flat, geom):
    """The JAX planner's cloud + gas decomposition (fastpath.py:440-491):
    (cloud_idx, cloud_field, ssa, g, gas_factor, gas_idx) or None where it
    declines."""
    total = np.asarray(flat.total_ext, np.float64)
    cum = np.asarray(flat.cumulative_ext, np.float64)
    ssa_c = np.asarray(flat.ssa, np.float64)
    pfi = np.asarray(flat.phase_index)
    exts = [cum[..., 0] * total, (cum[..., 1] - cum[..., 0]) * total]

    def is_gas(c):
        occ = exts[c] > 0.0
        if not occ.any() or np.any(ssa_c[..., c][occ] != 0.0):
            return False
        prof = exts[c]
        tol = 1e-6 * max(prof.max(), 1e-30) + 4e-7 * float(total.max())
        return bool(np.ptp(prof, axis=(0, 1)).max() <= tol)

    gas_idx = next((c for c in (1, 0) if is_gas(c)), -1)
    if gas_idx < 0:
        return None
    cloud_idx = 1 - gas_idx
    gas_profile = exts[gas_idx].mean(axis=(0, 1))
    cloud_ext = np.maximum(total - gas_profile[None, None, :], 0.0)
    occ = cloud_ext > 0.0
    if not occ.any():
        return None
    s_occ = ssa_c[..., cloud_idx][occ]
    p_occ = pfi[..., cloud_idx][occ]
    if not (np.all(s_occ == s_occ.flat[0]) and np.all(p_occ == p_occ.flat[0])):
        return None
    uniform_ssa = float(s_occ.flat[0])
    if not (0.0 < uniform_ssa <= 1.0):
        return None
    snap = 1e-6 * max(gas_profile.max(), 1e-30) + 4e-7 * float(total.max())
    for i in range(1, gas_profile.size):
        if abs(gas_profile[i] - gas_profile[i - 1]) <= snap:
            gas_profile[i] = gas_profile[i - 1]
    gas_factor = _compress_factor(gas_profile, np.asarray(geom.z_edges.cpu()))
    if gas_factor is None:
        return None
    return (cloud_idx, np.asarray(cloud_ext, np.float32), uniform_ssa,
            detect_hg(flat.forward_tables[cloud_idx]), gas_factor, gas_idx)


def _detector_plan(fx, fy, fz, intensity, geom, gas: bool):
    """The JAX planner's detectors and shadow-trace choice (fastpath.py:
    592-631): (detectors, closed_shadow), or None where it declines."""
    dirs = np.asarray(intensity.directions, float)
    mus = np.asarray(intensity.abs_mu, float)
    detectors = tuple((float(dirs[0, d]), float(dirs[1, d]), float(dirs[2, d]),
                       float(mus[d])) for d in range(dirs.shape[1]))
    if (fx.n_ops > 0) + (fy.n_ops > 0) <= 1 and all(abs(d[2]) > 1e-6 for d in detectors):
        return detectors, True
    if gas:
        return None
    xe, ye, ze = (np.asarray(e.cpu(), float) for e in
                  (geom.x_edges, geom.y_edges, geom.z_edges))

    def min_gap(f, lo, hi):
        return float(np.diff(np.asarray([lo, *f.thresholds, hi])).min())

    shadow_steps = 0
    for dx_, dy_, dz_, _ in detectors:
        path = (ze[-1] - ze[0]) / max(abs(dz_), 1e-6)
        steps = 2 + fz.n_ops + 1
        if fx.n_ops:
            steps += int(path * abs(dx_) / min_gap(fx, xe[0], xe[-1])) + 1
        steps += int(path * abs(dx_) / (xe[-1] - xe[0])) + 1
        if fy.n_ops:
            steps += int(path * abs(dy_) / min_gap(fy, ye[0], ye[-1])) + 1
        steps += int(path * abs(dy_) / (ye[-1] - ye[0])) + 1
        shadow_steps = max(shadow_steps, steps)
    return (detectors, False) if shadow_steps <= 24 else None


def fast_plan(geom, flat, optics: OpticsFlags, surface, intensity, config) -> FastPlan | None:
    """Eligibility check + plan, decided as the JAX ``fast_plan`` decides.

    Returns None where the JAX planner returns None.  Where it would return
    a plan that uses a feature the port lacks, raises
    NotImplementedError naming the ROADMAP item.
    """
    if not getattr(config, "use_fastpath", True) or config.use_ray_tracing:
        return None
    if intensity is not None and (config.use_hybrid_phase_funs
                                  or config.limit_intensity_contributions):
        return None
    missing = []
    if surface.uses_brdf:
        if not (surface.n_xs == 1 and surface.n_ys == 1):
            return None
        missing.append(_ITEM_SURFACE)
    else:
        if not (0.0 <= float(surface.albedo) <= 1.0):
            return None
        if float(surface.albedo) > 0.0:
            missing.append(_ITEM_SURFACE)
    if not (geom.xy_regular and geom.z_regular):
        return None

    gas = optics.n_components == 2
    per_col_props = False
    gas_factor, gas_idx = None, -1
    if gas:
        split = _gas_split(flat, geom)
        if split is None:
            return None
        cloud_idx, cloud_field, uniform_ssa, g, gas_factor, gas_idx = split
    elif optics.n_components == 1 and optics.uniform_ssa is not None \
            and optics.uniform_phase_index is not None:
        if not (0.0 < optics.uniform_ssa <= 1.0):
            return None
        uniform_ssa = float(optics.uniform_ssa)
        g = detect_hg(flat.forward_tables[0])
        cloud_field = flat.total_ext
    elif optics.n_components == 1 and intensity is None:
        if np.any((np.asarray(flat.ssa) < 0.0) | (np.asarray(flat.ssa) > 1.0)):
            return None
        per_col_props = True
        uniform_ssa, g, cloud_field = 1.0, 0.0, flat.total_ext
    else:
        return None
    if per_col_props or g is None or g == 0.0:
        comp = cloud_idx if gas else 0
        if not per_col_props and len(flat.forward_tables[comp].phase_functions) != 1:
            return None
        missing.append(_ITEM_TABLE)
        g = 0.0
    factors = None if per_col_props else separable_factors(
        cloud_field, *(np.asarray(e.cpu()) for e in
                       (geom.x_edges, geom.y_edges, geom.z_edges)))
    if factors is not None and sum(f.n_ops for f in factors) > MAX_SEGMENTS:
        factors = None
    column_data = None
    if factors is None:
        if intensity is not None or gas:
            return None
        # Per-column ssa and phase index (5-field tables) need the tabulated
        # inverse-CDF tables: item 15 is already in ``missing`` for them.
        column_data = column_structure(
            flat.total_ext, np.asarray(geom.z_edges.cpu()),
            ssa=np.asarray(flat.ssa)[..., 0] if per_col_props else None,
            pfi=np.asarray(flat.phase_index)[..., 0] if per_col_props else None)
        if column_data is None:
            return None
        trivial = StepFactor((), (1.0,))
        fx = fy = fz = trivial
    elif per_col_props:
        return None
    else:
        fx, fy, fz = factors
    detectors, closed_shadow = (), False
    if intensity is not None:
        det = _detector_plan(fx, fy, fz, intensity, geom, gas)
        if det is None:
            return None
        detectors, closed_shadow = det
        if not closed_shadow:
            missing.append(_ITEM_MARCHING)
    if missing:
        raise NotImplementedError(f"fastpath plan needs {min(missing)[1]}")
    # K = 8 for every plan: the JAX package's 32 for column plans
    # (fastpath.py:633-635) is an XLA tuning, and the kernel takes K in
    # SUPPORTED_K only.
    cfg_unroll = getattr(config, "fastpath_unroll", None)
    return FastPlan(fx=fx, fy=fy, fz=fz, hg_g=g,
                    unroll=int(cfg_unroll) if cfg_unroll else 8, ssa=uniform_ssa,
                    detectors=detectors, closed_shadow=closed_shadow,
                    gas_factor=gas_factor, gas_idx=gas_idx, column_data=column_data)


def plan_from_jax(plan) -> FastPlan:
    """The port's plan for a JAX ``FastPlan`` (host numpy already)."""
    extras = {"surface_albedo": _ITEM_SURFACE,
              "brdf_fn": _ITEM_SURFACE, "gas_k": _ITEM_GAS_K,
              "column_props": _ITEM_TABLE, "cubic": _ITEM_TABLE,
              "fwd_cubic": _ITEM_TABLE}
    for name, item in extras.items():
        v = getattr(plan, name, None)
        if v is not None and not (isinstance(v, (tuple, bool, float)) and not v):
            raise NotImplementedError(f"fastpath plan needs {item[1]}")
    if plan.detectors and not plan.closed_shadow:
        raise NotImplementedError(f"fastpath plan needs {_ITEM_MARCHING[1]}")
    conv = lambda f: StepFactor(tuple(f.thresholds), tuple(f.values))
    gas = plan.gas_factor
    return FastPlan(conv(plan.fx), conv(plan.fy), conv(plan.fz), float(plan.hg_g),
                    int(plan.unroll), float(plan.ssa),
                    detectors=tuple(tuple(float(v) for v in d) for d in plan.detectors),
                    closed_shadow=bool(plan.closed_shadow),
                    gas_factor=None if gas is None else conv(gas),
                    gas_idx=int(plan.gas_idx),
                    column_data=None if plan.column_data is None
                    else np.asarray(plan.column_data, np.float32))


def state_from_numpy(st, device="cpu") -> LaneState:
    """Lane state from a JAX fast-event state tuple converted to numpy:
    (alive, x, y, z, ux, uy, uz, tau, orders, pk, bad, evct, acc, tgas, ...).
    A scalar y placeholder (untracked y) fills the y row; without ``tgas``
    (no gas channel) the tgas row is zero."""
    alive, x, y, z, ux, uy, uz, tau, orders, pk, bad, evct = st[:12]
    tgas = st[13] if len(st) > 13 else 0.0
    L = np.shape(x)[0]
    fl = np.stack([np.broadcast_to(np.asarray(a, np.float32), (L,))
                   for a in (x, y, z, ux, uy, uz, tau, tgas)])
    it = np.stack([np.asarray(a).astype(np.int32) for a in (alive, orders, pk, bad, evct)])
    return LaneState(torch.as_tensor(fl, device=device).contiguous(),
                     torch.as_tensor(it, device=device).contiguous())


# ---------------------------------------------------------------------------
# Trace loop
# ---------------------------------------------------------------------------

def event_spec(geom, plan: FastPlan, config) -> EventSpec:
    """Constants of the event block for one plan on one grid; a column plan's
    table moves to the grid's device here, once per tracer."""
    x0, y0, z0 = geom.x0, geom.y0, geom.z0
    x_max, y_max, z_max = geom.x_max, geom.y_max, geom.z_max
    # Face-push nudges: ~8 float32 ulps of the coordinate scale per axis.
    nudge = lambda lo, hi: f32(8 * 2.0 ** -23 * max(abs(lo), abs(hi)))
    chain = int(getattr(config, "fastpath_chain", -1))
    column = None
    if plan.column_data is not None:
        cols = np.zeros((plan.column_data.shape[0], 4), np.float32)
        cols[:, :3] = plan.column_data
        column = torch.as_tensor(cols, device=geom.x_edges.device)
    # y drops out for slab-symmetric domains: nothing reads it.  Column
    # media always track it (fastpath.py:876).
    track_y = column is not None or not (geom.n_y == 1 and plan.fy.n_ops == 0)
    gas = plan.gas_factor
    return EventSpec(
        fx=plan.fx, fy=plan.fy, fz=plan.fz,
        inv_fx=plan.fx.reciprocal(), inv_fy=plan.fy.reciprocal(),
        inv_fz=plan.fz.reciprocal(),
        x0=x0, y0=y0, z0=z0, x_max=x_max, y_max=y_max, z_max=z_max,
        wx=float(np.float32(x_max) - np.float32(x0)),
        wy=float(np.float32(y_max) - np.float32(y0)),
        nudge_x=nudge(x0, x_max), nudge_y=nudge(y0, y_max), nudge_z=nudge(z0, z_max),
        g=f32(plan.hg_g), ssa=f32(plan.ssa), max_events=int(config.max_events),
        K=max(1, plan.unroll),
        # Collision-chain depth: auto (-1) is 2 for cloud media and 3 with
        # the gas channel (fastpath.py:1283-1286).  Detectors need the shadow
        # trace of every collision: no chaining with them.
        chain=0 if plan.detectors else ((3 if gas else 2) if chain < 0 else chain),
        track_y=track_y,
        det=shadow_constants(geom, plan, config, track_y) if plan.detectors else None,
        gz=gas, inv_gz=None if gas is None else gas.reciprocal(),
        column=column, n_x=geom.n_x, n_y=geom.n_y, inv_dx=f32(1.0 / geom.dx),
        inv_dy=f32(1.0 / geom.dy), dx=f32(geom.dx), dy=f32(geom.dy))


def shadow_constants(geom, plan: FastPlan, config, track_y: bool) -> DetectorSpec:
    """Constants of the detector block and the closed-form shadow trace
    (fastpath.py:890-895, :1140-1192, and the gas segments of :1160-1164),
    computed as the JAX package computes them: in Python double, rounded to
    float32 at the point of use."""
    if not plan.closed_shadow:
        raise NotImplementedError(f"fastpath plan needs {_ITEM_MARCHING[1]}")
    fx, fy, fz = plan.fx, plan.fy, plan.fz
    x0, y0, z0 = geom.x0, geom.y0, geom.z0
    x_max, y_max, z_max = geom.x_max, geom.y_max, geom.z_max
    if fx.n_ops:
        h_f, h_lo, h_hi, h_axis = fx, x0, x_max, 0
        c_other = float(fy.values[0])
    elif fy.n_ops:
        h_f, h_lo, h_hi, h_axis = fy, y0, y_max, 1
        c_other = float(fx.values[0])
    else:
        h_f, h_lo, h_hi, h_axis = None, 0.0, 0.0, -1
        c_other = float(fx.values[0]) * float(fy.values[0])
    z_segs = tuple((f32(lo), f32(hi), f32(float(v) * c_other)) for lo, hi, v in
                   zip((float(z0),) + fz.thresholds, fz.thresholds + (float(z_max),),
                       fz.values) if float(v) * c_other > 0.0)
    gf = plan.gas_factor
    g_segs = () if gf is None else tuple(
        (f32(lo), f32(hi), f32(v)) for lo, hi, v in
        zip((float(z0),) + gf.thresholds, gf.thresholds + (float(z_max),), gf.values)
        if float(v) > 0.0)
    h_tot = h_w = h_inv_w = 0.0
    h_cums = ()
    if h_f is not None:
        # FhP: cumulative integral of the horizontal factor at each threshold.
        cums = [0.0]
        for s_, e_, v_ in zip((float(h_lo),) + h_f.thresholds,
                              h_f.thresholds + (float(h_hi),), h_f.values):
            cums.append(cums[-1] + float(v_) * (e_ - s_))
        h_tot, h_w, h_inv_w = f32(cums[-1]), f32(h_hi - h_lo), f32(1.0 / (h_hi - h_lo))
        h_cums = tuple(f32(c) for c in cums[1:-1])
    dhs = [(dx, dy)[h_axis] if h_axis >= 0 else 0.0 for dx, dy, _, _ in plan.detectors]
    modes = tuple(0 if h_axis < 0 else (2 if abs(dh) > 1e-12 else 1) for dh in dhs)
    col_y = track_y and geom.n_y > 1
    zeta = f32(max(float(config.zeta_min), 1e-30))
    return DetectorSpec(
        dirs=tuple((f32(dx), f32(dy), f32(dz)) for dx, dy, dz, _ in plan.detectors),
        inv_dz=tuple(f32(1.0 / d[2]) for d in plan.detectors),
        dh=tuple(f32(dh) for dh in dhs),
        inv_dh=tuple(f32(1.0 / dh) if m == 2 else 0.0 for dh, m in zip(dhs, modes)),
        h_mode=modes,
        norm=tuple(f32(1.0 / (4.0 * np.pi * d[3])) for d in plan.detectors),
        z_segs=z_segs, h_axis=h_axis, h_lo=f32(h_lo), h_tot=h_tot, h_w=h_w,
        h_inv_w=h_inv_w, h_cums=h_cums, z_top=f32(z_max), z_bot=f32(z0),
        x0=f32(x0), inv_dx=f32(1.0 / geom.dx), wrap_wx=f32(x_max - x0),
        wrap_inv_x=f32(1.0 / (x_max - x0)), n_x=geom.n_x, col_y=col_y,
        y0=f32(y0), inv_dy=f32(1.0 / geom.dy) if col_y else 0.0,
        wrap_wy=f32(y_max - y0) if col_y else 0.0,
        wrap_inv_y=f32(1.0 / (y_max - y0)) if col_y else 0.0, n_y=geom.n_y,
        iwabuchi=bool(getattr(config, "use_russian_roulette_for_intensity", False)),
        zeta=zeta, zeta_pi=f32(zeta / np.pi), g_segs=g_segs)


def launch_state(geom, batch, n_photons: int, gas_key: PhiloxKey | None = None) -> LaneState:
    """Lane state for a launch batch (positions in [0, 1] scaled to the
    domain); lanes beyond the photon budget start dead.  With ``gas_key``
    (a gas plan) the tgas row takes the launch's gas thresholds, else 0."""
    L = batch.n_photons
    dev = batch.x.device
    f = torch.zeros((8, L), dtype=torch.float32, device=dev)
    i = torch.zeros((5, L), dtype=torch.int32, device=dev)
    f[X] = geom.x0 + batch.x * (geom.x_max - geom.x0)
    f[Y] = geom.y0 + batch.y * (geom.y_max - geom.y0)
    f[Z] = geom.z0 + batch.z * (geom.z_max - geom.z0)
    f[UX], f[UY], f[UZ] = make_direction_cosines(batch.mu, batch.phi)
    i[ALIVE] = (torch.arange(L, device=dev) < n_photons).to(torch.int32)
    if gas_key is not None:
        f[TGAS] = gas_thresholds(gas_key, GAS_LAUNCH_BLOCK, L, dev)
    return LaneState(f, i)


def renormalize(st: LaneState) -> None:
    """Rescale directions to unit length in place: the event block skips the
    per-rotation rescale, so the trace loop does it once per block."""
    ux, uy, uz = st.f[UX], st.f[UY], st.f[UZ]
    st.f[UX:UZ + 1] *= torch.rsqrt(torch.clamp(ux * ux + uy * uy + uz * uz,
                                               min=f32(1e-12)))


def make_fast_tracer(geom, plan: FastPlan, config, n_photons: int,
                     n_lanes: int | None = None):
    """Build trace(key, batch, source) -> RawTallies for the fast plan; the
    trace runs on the device of the launch batch's tensors."""
    n_x, n_y, n_z = geom.n_x, geom.n_y, geom.n_z
    L = lane_width(n_photons, n_lanes)
    spec = event_spec(geom, plan, config)
    K = spec.K
    x0, y0, z0 = geom.x0, geom.y0, geom.z0
    x_max, y_max, z_max = geom.x_max, geom.y_max, geom.z_max
    inv_dx, inv_dy = 1.0 / geom.dx, 1.0 / geom.dy
    inv_dz_cell = f32(n_z / (z_max - z0))
    # Global hang guard (counts K-event blocks): ~2x the event budget.
    max_blocks = -(-2 * config.max_events * (n_photons // L + 2) // K)
    n_cols = n_x * n_y
    D = len(plan.detectors)
    absorbing = spec.absorbing
    # Kind-3 deaths: Bernoulli absorption and the gas channel
    # (fastpath.py:1731-1732, :1745-1746).
    deaths = absorbing or spec.gas
    vol_tally = bool(getattr(config, "compute_volume_absorption", False)) and deaths

    def flush(columns, vol, st: LaneState) -> None:
        """Tally pending exits at their frozen positions, then clear pk."""
        x, y, z = st.f[X], st.f[Y], st.f[Z]
        pk = st.i[PK]
        col = torch.clamp(((x - x0) * inv_dx).to(torch.int64), 0, n_x - 1)
        if spec.track_y and n_y > 1:
            iy = torch.clamp(((y - y0) * inv_dy).to(torch.int64), 0, n_y - 1)
            col = col * n_y + iy
        kinds = [pk == 1, pk == 2] + ([pk == 3] if deaths else [])
        columns.index_add_(0, col, torch.stack(kinds, dim=1).to(torch.float64))
        if vol_tally:
            iz = torch.clamp(((z - z0) * inv_dz_cell).to(torch.int64), 0, n_z - 1)
            vol.index_add_(0, col * n_z + iz, (pk == 3).to(torch.float64))
        pk.zero_()

    def refill(st: LaneState, launched, key: PhiloxKey, source: PhotonSource, kb: int):
        """Dead lanes take the next photons of the budget, in lane order."""
        dead = st.i[ALIVE] == 0
        dead_i = dead.to(torch.int64)
        new_id = launched + torch.cumsum(dead_i, 0) - dead_i
        take = dead & (new_id < n_photons)
        fresh = source.sample(key, L, st.f.device, stream=STREAM_REFILL, block=kb)
        f, i = st.f, st.i
        f[X] = torch.where(take, x0 + fresh.x * (x_max - x0), f[X])
        f[Y] = torch.where(take, y0 + fresh.y * (y_max - y0), f[Y])
        f[Z] = torch.where(take, z0 + fresh.z * (z_max - z0), f[Z])
        for row, v in zip((UX, UY, UZ), make_direction_cosines(fresh.mu, fresh.phi)):
            f[row] = torch.where(take, v, f[row])
        f[TAU] = torch.where(take, 0.0, f[TAU])
        if spec.gas:
            f[TGAS] = torch.where(take, gas_thresholds(key, kb, L, f.device), f[TGAS])
        i[ORDERS] = torch.where(take, 0, i[ORDERS])
        i[ALIVE] = i[ALIVE] | take.to(torch.int32)
        return launched + take.sum()

    @torch.inference_mode()
    def trace(key: PhiloxKey, batch, source: PhotonSource) -> RawTallies:
        dev = batch.x.device
        st = launch_state(geom, batch, n_photons, gas_key=key if spec.gas else None)
        f, i = st.f, st.i
        launched = torch.tensor(min(L, n_photons), dtype=torch.int64, device=dev)
        columns = torch.zeros((n_cols, 3 if deaths else 2), dtype=torch.float64,
                              device=dev)
        vol = torch.zeros(n_cols * n_z if vol_tally else 0, dtype=torch.float64,
                          device=dev)
        # Detector contributions per (exit column, detector), added inside
        # the event block.
        acc = torch.zeros((n_cols, D), dtype=torch.float64, device=dev) if D else None
        kb = 0
        while kb < max_blocks:
            # The loop condition: one host sync per K-event block.
            any_alive, n_launched = torch.stack(
                [i[ALIVE].any().to(torch.int64), launched]).tolist()
            if not (any_alive or n_launched < n_photons):
                break
            renormalize(st)
            flush(columns, vol, st)
            if n_photons > L:
                launched = refill(st, launched, key, source, kb)
            event_block(spec, st, key, kb, acc)
            kb += 1
        flush(columns, vol, st)
        # Lanes alive at the block cap vanish with their weight: count bad.
        n_bad = i[BAD].sum(dtype=torch.int64) + i[ALIVE].sum(dtype=torch.int64)
        zeros = lambda n: torch.zeros(n, dtype=torch.float64, device=dev)
        # Radiance layout of fastpath.py:2126-2153: (n_cols * D), and per
        # component (n_cols * D, 1 + n_components) with slot 0 the surface,
        # which a black surface leaves at zero.  The collisions are the
        # cloud's: slot 1, or with a gas channel slot 1 + (1 - gas_idx), the
        # gas (a pure absorber) keeping its slot at zero.
        coll = acc.reshape(-1) if D else zeros(0)
        slots = [torch.zeros_like(coll)] * (3 if spec.gas else 2)
        slots[1 + (1 - plan.gas_idx) if spec.gas else 1] = coll
        return RawTallies(
            flux_up=columns[:, 0], flux_down=columns[:, 1],
            flux_absorbed=columns[:, 2] if deaths else zeros(n_cols),
            volume_absorption=vol if vol_tally else zeros(n_cols * n_z),
            intensity=coll,
            intensity_by_component=torch.stack(slots, dim=1).reshape(-1),
            intensity_excess=zeros(len(slots) * D), n_photons=int(n_photons),
            n_bad=n_bad,
            n_iterations=kb * K,
            n_lane_events=i[EVCT].sum(dtype=torch.int64))

    return trace
