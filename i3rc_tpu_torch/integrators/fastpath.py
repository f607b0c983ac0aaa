"""Fused transport fastpath (separable or column optics) in PyTorch.

Port of ``i3rc_tpu/integrators/fastpath.py`` for flux and radiance over a
black, Lambertian or uniform-BRDF surface, with or without the baked gas
channel, and for flux in column media (one homogeneous layer per (x, y)
column: the I3RC Landsat scene):

  * the host-side planner (``StepFactor``, ``separable_factors``,
    ``detect_hg``, ``FastPlan``, ``fast_plan``) in numpy, with the
    StepFactor where-chains also as torch functions, and the constants of
    the closed-form shadow trace (``shadow_constants``), and the cloud + gas
    split of two-component domains (``_gas_split``), and the column table of
    column media (``column_structure``);
  * the trace loop (``make_fast_tracer``): one ``fused_block`` per K-event
    block (``kernels/event_block.py``: on a card one launch of the CUDA
    kernel, on the CPU its plain version), which renormalizes directions,
    flushes pending exits into float64 per-column tallies, refills dead
    lanes in FIFO order, runs the K events and adds the radiance detectors'
    local estimates to a float64 (n_cols, D) accumulator.  The loop's end
    is a flag the block keeps on the device; the host reads it every
    ``CHECK_EVERY`` blocks.  A gas plan draws each lane's exponential gas
    threshold at launch and at refill (``rng.STREAM_GAS``).  Over a
    reflecting surface the block ends with the bounce of the lanes that hit
    the bottom in it (``kernels/event_block.py`` ``resolve_surface``), and a
    BRDF plan carries a lane weight.

Extinction is factorized as ext(x, y, z) = fx(x) * fy(y) * fz(z) with few-
segment step functions, or read per event from the lane's row [v, z_base,
z_top] of the column table; a photon tallies at every exit (top, bottom,
or absorption: Bernoulli when ssa < 1, or the gas channel when its
threshold runs out), with weight 1 except over a BRDF surface, and a
bottom hit over a reflecting surface revives it with the surface's
probability.  The scattering cosine is the Henyey-Greenstein inversion for
an exact-HG table, else the piecewise-cubic inverse-CDF fit of the table
(``FastPlan.cubic``, the table modes: one single-entry table, or with
per-column ssa and phase entries every entry of the table, ``column_props``);
a tabulated plan's detectors read the phase value from the log-space cubic
fit (``FastPlan.fwd_cubic``).

Fused-k spectral batching (``GasKTables``, fastpath.py:244-265, :966-1057):
a gas-channel plan with ``gas_k`` traces every k point of a band in one
trace, k a per-lane attribute (``fused_k``: lanes in blocks of whole CTAs
per k point, sized by weight, exact per-k photon quotas, tallies weighted
w_k n_photons / quota_k; see kernels/event_block.py for the lane
partition), at chain depth 0 and a lane width of at least CTA_THREADS per k
point.  Each lane carries Gz(z) of its k profile from its own launch height
(JAX starts every lane at the Gz of the domain top, fastpath.py:1029-1032,
:2012, :2107-2108, which an internal source does not share).

Configurations the JAX planner rejects return None, as there; so does a
plan with more radiance detectors than the event block holds
(``MAX_DETECTORS``), which the general kernel's estimate stage runs (JAX
runs it on its XLA fastpath, fastpath.py:1702-1712).  Every collision-chain
depth plans (``fastpath_chain``, fastpath.py:1283-1286).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from i3rc_tpu_torch.core.illumination import PhotonSource
from i3rc_tpu_torch.core.rng import GAS_LAUNCH_BLOCK, PhiloxKey, gas_thresholds
from i3rc_tpu_torch.integrators.tables import build_forward_cubic, build_inverse_cubic
from i3rc_tpu_torch.integrators.wavefront import (
    ONEHOT_MAX_ROWS,
    RawTallies,
    f32,
    make_direction_cosines,
)
# hg_cosine is re-exported (the JAX package defines it in fastpath), and
# renormalize for callers that step a state by hand.
from i3rc_tpu_torch.kernels.event_block import (  # noqa: F401
    ALBEDO, ALIVE, BAD, BRDF_KINDS, CTA_THREADS, DONE, EVCT, GCUR, MAX_DETECTORS,
    MAX_SEGMENTS, PK, TGAS, UX, UY, UZ, X, Y, Z, DetectorSpec, EventSpec,
    FusedK, LaneState, PrologueSpec, SurfaceLaw, block_buffers, flush, fused_block, gas_read,
    hg_cosine, launch_refusal, renormalize,
)

# Lanes per wavefront when the caller gives none (not tuned on the GPU yet).
DEFAULT_LANES = 1 << 20

# The trace loop reads its end flag from the device once in this many
# blocks: the blocks between queue without a host round trip, and at most
# this many minus one run past the end (on dead lanes and a spent budget
# they change no tally).
CHECK_EVERY = 8


def lane_width(n_photons: int, n_lanes: int | None = None, n_k: int = 0) -> int:
    """The wavefront width: the caller's, else min(n_photons, DEFAULT_LANES);
    a fused-k trace of n_k points needs a CTA per k point, so below
    CTA_THREADS * n_k lanes it takes that many."""
    return max(int(n_lanes or min(n_photons, DEFAULT_LANES)), CTA_THREADS * n_k)


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


@dataclass(frozen=True, eq=False)
class GasKTables:
    """Fused spectral-k batching (fastpath.py:244-265): every k point of a
    band in one trace.  ``profiles`` (n_k, n_z) float64 per-layer gas
    extinction of each k point, ``weights`` (n_k,) its positive quadrature
    weights."""

    profiles: np.ndarray
    weights: np.ndarray

    def __eq__(self, other):
        return (isinstance(other, GasKTables) and np.array_equal(self.profiles, other.profiles)
                and np.array_equal(self.weights, other.weights))


@dataclass(frozen=True)
class FastPlan:
    """Static (host-side) description of one fastpath trace: the separable
    extinction factors, the HG asymmetry, the block length K (``unroll``)
    and the uniform single-scattering albedo (< 1: Bernoulli absorption;
    with column properties the least ssa of the occupied columns)."""

    fx: StepFactor
    fy: StepFactor
    fz: StepFactor
    hg_g: float
    unroll: int
    ssa: float = 1.0
    # (dx, dy, dz, |mu|) per radiance detector; closed_shadow: at most one
    # horizontal factor varies and every detector leaves the z range, so the
    # transmittance is closed-form (fastpath.py:602-606); else the marching
    # trace of at most shadow_steps segment steps (fastpath.py:613-631).
    detectors: tuple = ()
    closed_shadow: bool = False
    shadow_steps: int = 0
    # Gas channel (fastpath.py:925-936): the horizontally uniform pure
    # absorber of a cloud + gas domain as a StepFactor over z, and the gas
    # component's index (the cloud is the other one).
    gas_factor: StepFactor | None = None
    gas_idx: int = -1
    # Column media (fastpath.py:289-297): (n_cols, 3) float32 [v, z_base,
    # z_top] per (x, y) column, row ix * n_y + iy; fx = fy = fz = 1.
    column_data: np.ndarray | None = None
    # A reflecting surface (fastpath.py:326-372): a Lambertian albedo > 0,
    # or a uniform BRDF by its core/surface.py registry name with its
    # parameters (float32 values; the albedo is then 0).
    surface_albedo: float = 0.0
    brdf: str | None = None
    brdf_params: tuple = ()
    # Table modes (fastpath.py:318-346): a non-HG table samples the
    # scattering cosine from ``cubic``, the (entries * 256, 4) float32
    # piecewise-cubic inverse-CDF fit (tables.build_inverse_cubic; hg_g is
    # then 0); ``cubic_entries`` of them flattened.  ``column_props``: the
    # column table widens to (n_cols, 5) [v, z_base, z_top, ssa, pf_index]
    # and each lane reads its ssa and table entry from its column.
    # ``fwd_cubic``: a tabulated plan's detectors take the phase value from
    # the (512, 4) log-space cubic fit (tables.build_forward_cubic).
    cubic: np.ndarray | None = None
    cubic_entries: int = 1
    fwd_cubic: np.ndarray | None = None
    column_props: bool = False
    # Fused-k spectral batching (fastpath.py:356-361): attached by the
    # tracer of an integrator created with gas_k, on a gas-channel plan.
    gas_k: GasKTables | None = None

    def __eq__(self, other):
        if not isinstance(other, FastPlan):
            return NotImplemented
        arrays = ("column_data", "cubic", "fwd_cubic")

        def same(a, b):
            return (a is None and b is None) or (
                a is not None and b is not None and np.array_equal(a, b))

        return all(same(getattr(self, f), getattr(other, f)) for f in arrays) and all(
            getattr(self, f) == getattr(other, f) for f in self.__dataclass_fields__
            if f not in arrays)


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
    592-631): (detectors, closed_shadow, shadow_steps), or None where it
    declines: gas with the marching trace (its faces hold no gas segments),
    or a marching budget above 24 steps."""
    dirs = np.asarray(intensity.directions, float)
    mus = np.asarray(intensity.abs_mu, float)
    detectors = tuple((float(dirs[0, d]), float(dirs[1, d]), float(dirs[2, d]),
                       float(mus[d])) for d in range(dirs.shape[1]))
    if (fx.n_ops > 0) + (fy.n_ops > 0) <= 1 and all(abs(d[2]) > 1e-6 for d in detectors):
        return detectors, True, 0
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
    return (detectors, False, shadow_steps) if shadow_steps <= 24 else None


def fast_plan(geom, flat, optics: OpticsFlags, surface, intensity, config) -> FastPlan | None:
    """Eligibility check + plan, decided as the JAX ``fast_plan`` decides.

    Returns None where the JAX planner returns None, and past
    ``MAX_DETECTORS`` detectors (the general kernel runs those).  A table that is not
    exactly HG takes the table modes (fastpath.py:502-553): per-column ssa
    and phase entries the flattened cubic fit of every entry, a single
    entry (with a gas channel, the cloud component's) its own fit, and with
    detectors the forward fit too.
    """
    if not getattr(config, "use_fastpath", True) or config.use_ray_tracing:
        return None
    if intensity is not None and (config.use_hybrid_phase_funs
                                  or config.limit_intensity_contributions):
        return None
    brdf, brdf_params, surface_albedo = None, (), 0.0
    if surface.uses_brdf:
        # Uniform-parameter BRDFs only (fastpath.py:414-430); a gridded
        # field takes the general kernel.
        if not (surface.n_xs == 1 and surface.n_ys == 1):
            return None
        brdf = surface.brdf_name
        brdf_params = tuple(float(v) for v in np.asarray(surface.params, np.float32).ravel())
    else:
        surface_albedo = float(surface.albedo)
        if not (0.0 <= surface_albedo <= 1.0):
            return None
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
    cubic, cubic_entries, fwd_cubic = None, 1, None
    if per_col_props:
        cub = np.asarray(build_inverse_cubic(flat)[0], np.float32)
        cubic_entries = cub.shape[0]
        cubic = cub.reshape(-1, 4)
        g = 0.0
    elif g is None or g == 0.0:
        comp = cloud_idx if gas else 0
        if len(flat.forward_tables[comp].phase_functions) != 1:
            return None
        cubic = np.asarray(build_inverse_cubic(flat)[comp, 0], np.float32)
        if intensity is not None:
            fwd_cubic = np.asarray(build_forward_cubic(flat)[comp, 0], np.float32)
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
        column_data = column_structure(
            flat.total_ext, np.asarray(geom.z_edges.cpu()),
            ssa=np.asarray(flat.ssa)[..., 0] if per_col_props else None,
            pfi=np.asarray(flat.phase_index)[..., 0] if per_col_props else None)
        if column_data is None:
            return None
        if per_col_props:
            # The static absorbing switch: the least ssa of the occupied
            # columns (fastpath.py:573-576).
            occ = column_data[:, 0] > 0.0
            uniform_ssa = float(column_data[occ, 3].min()) if occ.any() else 1.0
        trivial = StepFactor((), (1.0,))
        fx = fy = fz = trivial
    elif per_col_props:
        return None
    else:
        fx, fy, fz = factors
    detectors, closed_shadow, shadow_steps = (), False, 0
    if intensity is not None:
        det = _detector_plan(fx, fy, fz, intensity, geom, gas)
        if det is None:
            return None
        detectors, closed_shadow, shadow_steps = det
    # Past the event block's detector cap there is no plan: the general
    # kernel's estimate stage (G+E) has none, and runs it.
    if len(detectors) > MAX_DETECTORS:
        return None
    # K as the JAX planner gives it (fastpath.py:633-635): 32 for column
    # plans, 8 for separable ones.
    cfg_unroll = getattr(config, "fastpath_unroll", None)
    unroll = int(cfg_unroll) if cfg_unroll else (32 if column_data is not None else 8)
    return FastPlan(fx=fx, fy=fy, fz=fz, hg_g=g, unroll=unroll, ssa=uniform_ssa,
                    detectors=detectors, closed_shadow=closed_shadow,
                    shadow_steps=shadow_steps, gas_factor=gas_factor, gas_idx=gas_idx, column_data=column_data,
                    surface_albedo=surface_albedo, brdf=brdf, brdf_params=brdf_params,
                    cubic=cubic, cubic_entries=cubic_entries, fwd_cubic=fwd_cubic,
                    column_props=per_col_props)


def _chain_depth(config, detectors, gas: bool, fused: bool = False) -> int:
    """Collision-chain depth: auto (-1) is 2 for cloud media and 3 with the
    gas channel (fastpath.py:1283-1286).  Detectors need the shadow trace of
    every collision, and a fused-k plan an endpoint read per move: no
    chaining with them."""
    chain = int(getattr(config, "fastpath_chain", -1))
    return 0 if detectors or fused else ((3 if gas else 2) if chain < 0 else chain)


def plan_from_jax(plan) -> FastPlan:
    """The port's plan for a JAX ``FastPlan`` (host numpy already); its BRDF
    kernel maps to the registry name its function carries
    (``cox_munk_brdf`` -> "cox_munk")."""
    conv = lambda f: StepFactor(tuple(f.thresholds), tuple(f.values))
    gas = plan.gas_factor
    return FastPlan(conv(plan.fx), conv(plan.fy), conv(plan.fz), float(plan.hg_g),
                    int(plan.unroll), float(plan.ssa),
                    detectors=tuple(tuple(float(v) for v in d) for d in plan.detectors),
                    closed_shadow=bool(plan.closed_shadow),
                    shadow_steps=int(plan.shadow_steps),
                    gas_factor=None if gas is None else conv(gas),
                    gas_idx=int(plan.gas_idx),
                    column_data=None if plan.column_data is None
                    else np.asarray(plan.column_data, np.float32),
                    surface_albedo=float(plan.surface_albedo),
                    brdf=None if plan.brdf_fn is None
                    else plan.brdf_fn.__name__.removesuffix("_brdf"),
                    brdf_params=() if plan.brdf_params is None
                    else tuple(float(v) for v in np.asarray(plan.brdf_params, np.float32)),
                    cubic=None if plan.cubic is None else np.asarray(plan.cubic, np.float32),
                    cubic_entries=int(plan.cubic_entries),
                    fwd_cubic=None if plan.fwd_cubic is None
                    else np.asarray(plan.fwd_cubic, np.float32),
                    column_props=bool(plan.column_props),
                    gas_k=None if plan.gas_k is None else GasKTables(
                        np.asarray(plan.gas_k.profiles, np.float64),
                        np.asarray(plan.gas_k.weights, np.float64)))


def _split(frac: np.ndarray, n: int) -> np.ndarray:
    """n parts in proportion to ``frac``, each at least 1: JAX's remainder
    rule (fastpath.py:1004-1009, :1015-1020)."""
    c = np.maximum(1, np.floor(frac * n).astype(np.int64))
    for _ in range(int(n - c.sum())):
        c[np.argmax(frac * n - c)] += 1
    while c.sum() > n:
        c[np.argmax(c)] -= 1
    return c


def fused_k(geom, gas_k: GasKTables, n_photons: int, n_lanes: int, exact_layer: bool,
            device) -> FusedK:
    """The per-k tables of a fused-k tracer (fastpath.py:994-1049): the
    (n_k * n_z, 2) [gz, Gz at the layer's base] table, each k's photon
    quota (JAX's gk_budget, an exact partition of n_photons by weight) and
    tally weight w_k n_photons / quota_k, Gz(z_max), and the lanes' blocks:
    JAX's remainder rule in units of whole CTAs (JAX's in lanes), so that a
    CTA holds one k.  Needs n_photons >= n_k and n_lanes >= CTA_THREADS n_k."""
    prof = np.asarray(gas_k.profiles, np.float64)
    w = np.asarray(gas_k.weights, np.float64)
    n_k, n_z = prof.shape
    if n_z != geom.n_z or w.shape != (n_k,) or np.any(w <= 0.0):
        raise ValueError("gas_k: profiles must be (n_k, n_z) with n_k positive weights")
    if n_photons < n_k:
        raise ValueError(f"gas_k: {n_photons} photons for {n_k} k points; each needs one")
    n_ctas = -(-n_lanes // CTA_THREADS)
    if n_ctas < n_k:
        raise ValueError(f"gas_k: {n_lanes} lanes for {n_k} k points; each needs a CTA "
                         f"of {CTA_THREADS}")
    dz = float(geom.z_max - geom.z0) / n_z
    cum = np.concatenate([np.zeros((n_k, 1)), np.cumsum(prof * dz, axis=1)], axis=1)
    frac = w / w.sum()
    counts = _split(frac, n_ctas)
    quota = _split(frac, int(n_photons))
    t = lambda a, dtype: torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)
    return FusedK(
        table=t(np.stack([prof, cum[:, :n_z]], axis=-1).reshape(n_k * n_z, 2), np.float32),
        weight=t(w * n_photons / quota, np.float32), gtop=t(cum[:, n_z], np.float32),
        quota=t(quota, np.int64), cta0=t(np.concatenate([[0], np.cumsum(counts)]), np.int32),
        cta_k=t(np.repeat(np.arange(n_k), counts), np.int32), n_z=n_z, dz=f32(dz),
        inv_dz=f32(n_z / (geom.z_max - geom.z0)), exact_layer=bool(exact_layer),
        lanes=int(n_lanes))


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

def event_spec(geom, plan: FastPlan, config, n_photons: int | None = None,
               n_lanes: int | None = None) -> EventSpec:
    """Constants of the event block for one plan on one grid; a column plan's
    table and a table plan's cubic fits move to the grid's device here, once
    per tracer, and so do a fused-k plan's tables (``fused_k``: its quotas
    and lane blocks need the batch's ``n_photons`` and ``n_lanes``).

    The column table is (n_cols, 4) float32, one 16-byte row a lane reads
    per event: [v, z_base, z_top, 0]; on a table plan [v, z_base, z_top,
    ssa], the column's ssa (plan.ssa where it is uniform) riding the row's
    fourth word.  The table entry is needed only at a collision, so it is a
    separate int32 (n_cols,) array ``pf_row`` of row bases pf_index * n_seg
    (zeros for a single entry), read once per collision rather than
    widening every event's row read (the JAX package read it every event,
    fastpath.py:1334; the result is the same)."""
    x0, y0, z0 = geom.x0, geom.y0, geom.z0
    x_max, y_max, z_max = geom.x_max, geom.y_max, geom.z_max
    # Face-push nudges: ~8 float32 ulps of the coordinate scale per axis.
    nudge = lambda lo, hi: f32(8 * 2.0 ** -23 * max(abs(lo), abs(hi)))
    dev = geom.x_edges.device
    table = plan.cubic is not None
    n_seg = plan.cubic.shape[0] // plan.cubic_entries if table else 0
    column = pf_row = None
    if plan.column_data is not None:
        cd = plan.column_data
        cols = np.zeros((cd.shape[0], 4), np.float32)
        cols[:, :3] = cd[:, :3]
        if table:
            cols[:, 3] = cd[:, 3] if plan.column_props else np.float32(plan.ssa)
            rows = (cd[:, 4].astype(np.int32) * n_seg if plan.column_props
                    else np.zeros(cd.shape[0], np.int32))
            pf_row = torch.as_tensor(rows, device=dev)
        column = torch.as_tensor(cols, device=dev)
    fwd = plan.fwd_cubic
    # y drops out for slab-symmetric domains: nothing reads it.  Column
    # media always track it (fastpath.py:876).
    track_y = column is not None or not (geom.n_y == 1 and plan.fy.n_ops == 0)
    gas = plan.gas_factor
    surface = None
    if plan.brdf is not None:
        # The surface radiance's outgoing azimuth per detector (fastpath.py:
        # 922-923), from the plan's float32 direction cosines.
        surface = SurfaceLaw(kind=BRDF_KINDS[plan.brdf],
                             params=tuple(f32(v) for v in plan.brdf_params),
                             det_phi=tuple(f32(np.arctan2(dy, dx))
                                           for dx, dy, _, _ in plan.detectors))
    elif plan.surface_albedo > 0.0:
        surface = SurfaceLaw(kind=ALBEDO, albedo=f32(plan.surface_albedo))
    spec = EventSpec(
        fx=plan.fx, fy=plan.fy, fz=plan.fz,
        inv_fx=plan.fx.reciprocal(), inv_fy=plan.fy.reciprocal(),
        inv_fz=plan.fz.reciprocal(),
        x0=x0, y0=y0, z0=z0, x_max=x_max, y_max=y_max, z_max=z_max,
        wx=float(np.float32(x_max) - np.float32(x0)),
        wy=float(np.float32(y_max) - np.float32(y0)),
        nudge_x=nudge(x0, x_max), nudge_y=nudge(y0, y_max), nudge_z=nudge(z0, z_max),
        g=f32(plan.hg_g), ssa=f32(plan.ssa), max_events=int(config.max_events),
        K=max(1, plan.unroll),
        chain=_chain_depth(config, plan.detectors, gas is not None, plan.gas_k is not None),
        track_y=track_y,
        det=shadow_constants(geom, plan, config, track_y) if plan.detectors else None,
        gz=gas, inv_gz=None if gas is None else gas.reciprocal(),
        column=column, n_x=geom.n_x, n_y=geom.n_y, inv_dx=f32(1.0 / geom.dx),
        inv_dy=f32(1.0 / geom.dy), dx=f32(geom.dx), dy=f32(geom.dy), surface=surface,
        cubic=torch.as_tensor(np.ascontiguousarray(plan.cubic), device=dev) if table else None,
        n_seg=n_seg, pf_row=pf_row,
        fwd=None if fwd is None else torch.as_tensor(np.ascontiguousarray(fwd), device=dev),
        fwd_scale=0.0 if fwd is None else f32(fwd.shape[0] / np.pi),
        fk=None if plan.gas_k is None else fused_k(
            geom, plan.gas_k, n_photons, n_lanes,
            bool(getattr(config, "compute_volume_absorption", False)), dev))
    # The twin and the card accept exactly the same plans.
    why = launch_refusal(spec)
    if why:
        raise NotImplementedError(why)
    return spec


def shadow_constants(geom, plan: FastPlan, config, track_y: bool) -> DetectorSpec:
    """Constants of the detector block and the closed-form shadow trace
    (fastpath.py:890-895, :1140-1192, and the gas segments of :1160-1164),
    and of a marching plan's trace (:1061-1093), computed as the JAX package
    computes them: in Python double, rounded to float32 at the point of
    use."""
    march = not plan.closed_shadow
    if march and plan.shadow_steps < 1:
        raise ValueError("a marching shadow trace needs shadow_steps >= 1")
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
    # A fused-k plan's shadow rays take each lane's own gas instead.
    gf = plan.gas_factor if plan.gas_k is None else None
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
        zeta=zeta, zeta_pi=f32(zeta / np.pi), g_segs=g_segs,
        march_steps=int(plan.shadow_steps) if march else 0,
        inv_dxd=tuple(f32(1.0 / dx) if abs(dx) >= 1e-12 else 0.0
                      for dx, _, _, _ in plan.detectors),
        inv_dyd=tuple(f32(1.0 / dy) if abs(dy) >= 1e-12 else 0.0
                      for _, dy, _, _ in plan.detectors),
        use_x=tuple(abs(dx) >= 1e-12 for dx, _, _, _ in plan.detectors),
        use_y=tuple(track_y and abs(dy) >= 1e-12 for _, dy, _, _ in plan.detectors),
        march_ty=track_y)


def launch_state(geom, batch, n_photons: int, gas_key: PhiloxKey | None = None,
                 weighted: bool = False, spec: EventSpec | None = None) -> LaneState:
    """Lane state for a launch batch (positions in [0, 1] scaled to the
    domain); lanes beyond the photon budget start dead.  With ``gas_key``
    (a gas plan) the tgas row takes the launch's gas thresholds, else 0.
    ``weighted`` (a BRDF plan): every lane's weight starts at 1.  With the
    ``spec`` of a fused-k plan a lane starts alive when its rank in its k
    block is below its k's quota (fastpath.py:1837-1843), and every lane's
    GCUR is Gz of its k at its own height."""
    L = batch.n_photons
    dev = batch.x.device
    fk = spec.fk if spec is not None else None
    f = torch.zeros((8 if fk is None else 9, L), dtype=torch.float32, device=dev)
    i = torch.zeros((5, L), dtype=torch.int32, device=dev)
    f[X] = geom.x0 + batch.x * (geom.x_max - geom.x0)
    f[Y] = geom.y0 + batch.y * (geom.y_max - geom.y0)
    f[Z] = geom.z0 + batch.z * (geom.z_max - geom.z0)
    f[UX], f[UY], f[UZ] = make_direction_cosines(batch.mu, batch.phi)
    if fk is None:
        i[ALIVE] = (torch.arange(L, device=dev) < n_photons).to(torch.int32)
    else:
        k = fk.lane_k()
        rank = torch.arange(L, device=dev) - fk.cta0.long()[k] * CTA_THREADS
        i[ALIVE] = (rank < fk.quota[k]).to(torch.int32)
        f[GCUR] = gas_read(spec, k * fk.n_z, f[Z])[1]
    if gas_key is not None:
        f[TGAS] = gas_thresholds(gas_key, GAS_LAUNCH_BLOCK, L, dev)
    w = torch.ones(L, dtype=torch.float32, device=dev) if weighted else None
    return LaneState(f, i, w)


def prologue_spec(geom, spec: EventSpec, config, n_photons: int) -> PrologueSpec:
    """Constants of the block's prologue for one tracer."""
    # Kind-3 deaths: Bernoulli absorption and the gas channel
    # (fastpath.py:1731-1732, :1745-1746).
    deaths = spec.absorbing or spec.gas
    return PrologueSpec(
        n_photons=int(n_photons), n_x=geom.n_x, n_y=geom.n_y, n_z=geom.n_z,
        x0=geom.x0, y0=geom.y0, z0=geom.z0, x_max=geom.x_max, y_max=geom.y_max,
        z_max=geom.z_max, inv_dx=1.0 / geom.dx, inv_dy=1.0 / geom.dy,
        inv_dz_cell=f32(geom.n_z / (geom.z_max - geom.z0)),
        col_y=spec.track_y and geom.n_y > 1, deaths=deaths,
        vol_tally=bool(getattr(config, "compute_volume_absorption", False)) and deaths)


def make_fast_tracer(geom, plan: FastPlan, config, n_photons: int,
                     n_lanes: int | None = None):
    """Build trace(key, batch, source) -> RawTallies for the fast plan; the
    trace runs on the device of the launch batch's tensors.  A fused-k plan
    traces n_photons over all its k points, at ``lane_width(n_photons,
    n_lanes, n_k)`` lanes."""
    n_z = geom.n_z
    L = lane_width(n_photons, n_lanes, 0 if plan.gas_k is None else len(plan.gas_k.weights))
    spec = event_spec(geom, plan, config, n_photons, L)
    pro = prologue_spec(geom, spec, config, n_photons)
    K = spec.K
    # Global hang guard (counts K-event blocks): ~2x the event budget.
    max_blocks = -(-2 * config.max_events * (n_photons // L + 2) // K)
    n_cols = pro.n_cols
    D = len(plan.detectors)

    @torch.inference_mode()
    def trace(key: PhiloxKey, batch, source: PhotonSource) -> RawTallies:
        dev = batch.x.device
        st = launch_state(geom, batch, n_photons, gas_key=key if spec.gas else None,
                          weighted=spec.weighted, spec=spec)
        buf = block_buffers(spec, pro, st,
                            spec.fk.launch_counts() if spec.fused else min(L, n_photons))
        # The loop ends at the first block at whose entry no lane is alive
        # and the budget is spent: the block itself records that, and the
        # host reads it every CHECK_EVERY blocks.
        kb, done = 0, -1
        while kb < max_blocks and done < 0:
            fused_block(spec, pro, st, buf, key, source, kb)
            kb += 1
            if kb % CHECK_EVERY == 0 or kb == max_blocks:
                done = int(buf.ctl[DONE])
        i, columns, acc = st.i, buf.columns, buf.acc
        # Lanes alive at the block cap vanish with their weight: count bad;
        # over a reflecting surface so would a bottom hit still pending
        # (fastpath.py:2118-2122), though every block bounces its own.
        n_bad = i[BAD].sum(dtype=torch.int64) + i[ALIVE].sum(dtype=torch.int64)
        if spec.reflecting:
            n_bad = n_bad + (i[PK] == 2).sum(dtype=torch.int64)
        if done < 0:
            # The block cap: pending exits still wait for their tally.
            flush(pro, buf.columns, buf.vol, st,
                  spec.fk.weight[spec.fk.lane_k()] if spec.fused else None)
        n_blocks = done if done >= 0 else kb
        zeros = lambda n: torch.zeros(n, dtype=torch.float64, device=dev)
        # Radiance layout of fastpath.py:2126-2153: (n_cols * D), and per
        # component (n_cols * D, 1 + n_components) with slot 0 the surface
        # (zero over a black one), intensity the sum of the slots.  The
        # collisions are the cloud's: slot 1, or with a gas channel slot
        # 1 + (1 - gas_idx), the gas (a pure absorber) keeping its slot at
        # zero.
        coll = acc.reshape(-1) if D else zeros(0)
        srf = buf.srf.reshape(-1) if buf.srf is not None else torch.zeros_like(coll)
        slots = [srf] + [torch.zeros_like(coll)] * (2 if spec.gas else 1)
        slots[1 + (1 - plan.gas_idx) if spec.gas else 1] = coll
        return RawTallies(
            flux_up=columns[:, 0], flux_down=columns[:, 1],
            flux_absorbed=columns[:, 2] if pro.deaths else zeros(n_cols),
            volume_absorption=buf.vol if pro.vol_tally else zeros(n_cols * n_z),
            intensity=coll + srf if buf.srf is not None else coll,
            intensity_by_component=torch.stack(slots, dim=1).reshape(-1),
            intensity_excess=zeros(len(slots) * D), n_photons=int(n_photons),
            n_bad=n_bad,
            n_iterations=n_blocks * K,
            n_lane_events=i[EVCT].sum(dtype=torch.int64))

    return trace
