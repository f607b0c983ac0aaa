"""The fast event block: K transport events per lane, kernel and plain twin.

``fused_block`` is the wrapper the trace loop calls: one whole block of the
loop, the prologue (renormalize, flush of pending exits into the float64
tallies, FIFO refill of dead lanes from the photon budget) and then the K
events.  ``event_block`` is the K events alone.  On a CUDA tensor each
launches the hand-written Hopper kernel ``csrc/fast_event_block.cuh`` (the
port of the Pallas kernel ``_build_pallas_block``,
i3rc_tpu/integrators/fastpath.py:665, in its flux variant, its radiance
detector variant ``n_detectors > 0`` and the gas-channel variant
``gas=True`` of either; and the column-mode event of the XLA fastpath,
fastpath.py:1320-1345, in the design of the column-read probe
``pallas_column_loop``, benchmarks/column_read_probe.py:83) and raises if
the build or the launch fails (one launch either way: with the prologue it
is a stage of the same kernel); on a CPU tensor ``event_block`` runs
``event_block_reference`` and ``fused_block`` ``fused_block_reference``, the
plain PyTorch versions, on the same Philox draws.  All update the lane
state in place and add the detector contributions of the block to a
float64 (n_cols, D) accumulator.  Over a reflecting surface (a Lambertian
albedo or a uniform BRDF, ``SurfaceLaw``) the whole block ends with the
surface stage (``resolve_surface``; on the card a second hand-written
kernel, ``fast_event_block_surface_kernel``, launched by the same call, its
tallies summed per CTA, and on a plan with the marching shadow trace
``fast_event_block_surface_kernel_march``, whose CTAs take runs of tiles
and pull their emitting hits' rays from a queue; ``surface_census`` counts
their work and their tallies' atomics block by block).  The kernel takes
every K >= 1, every collision-chain depth (0-3 as template instantiations,
deeper ones in the runtime-depth variant, ``CHAIN_TEMPLATED``) and up to
16 detectors (the planner gives a plan with more none, so G+E runs it);
``launch_refusal`` names what it does not.
Every variant also comes as a table variant (``EventSpec.cubic``: a phase
function that is not exactly HG samples the cosine from the piecewise-cubic
inverse CDF, its detectors read the phase value from the log-space cubic
``fwd``, and in column media each lane reads its ssa and table entry from
its column; the table modes of the XLA fastpath, fastpath.py:1573-1586,
:1508-1520, :1330-1336), counted in the ``table_*`` launch counters.
The gas variants, HG and table, also come as a fused-k variant
(``EventSpec.fk``, ``FusedK``: every k point of a spectral band in one
trace, k a per-lane attribute; the XLA fastpath's ``gask_mode``,
fastpath.py:966-1057, :1409-1470, which never reached Pallas), counted in
the ``fused_k_*`` and ``table_fused_k_*`` launch counters.

Fused-k lanes fall into contiguous blocks of whole CTAs, one block per k
point, sized by quadrature weight; each k point has its exact photon quota
(JAX's ``gk_budget``) and a lane tallies with its k's weight w_k n_photons /
quota_k.  The FIFO refill ranks a dead lane within its k block.  JAX
partitions lanes one by one (a block needs one lane, not one CTA): the
lane blocks only schedule photons, so the quotas and weights, and with
them the expectation, are JAX's, but the draws differ, and port and
reference agree statistically (as JAX's own fused-vs-baked test says,
tests/test_spectral.py:133-137).

The twin applies exactly the kernel's draw layout: event ``j`` of the block
reads ``uniforms[j, i]`` for its draw ``i`` (``rng.philox_uniforms``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from i3rc_tpu_torch.core.illumination import _MIN_MU, _TWO_PI, PhotonSource
from i3rc_tpu_torch.core.rng import (
    STREAM_EVENT,
    STREAM_REFILL,
    STREAM_SURFACE,
    STREAM_SURFACE_IW,
    PhiloxKey,
    TINY,
    exponential_deviate,
    gas_thresholds,
    philox_uniforms,
    stream_uniforms,
)
from i3rc_tpu_torch.core.surface import BRDF_REGISTRY
from i3rc_tpu_torch.integrators.wavefront import (
    _sincos_2pi,
    f32,
    make_direction_cosines,
    rotate_direction,
)

MAX_SEGMENTS = 24
MAX_DETECTORS = 16                 # the kernel's parameter block holds this many
HUGE = f32(3.0e38)
PI = f32(np.pi)
INV_PI = f32(1.0 / np.pi)
TWO_PI = f32(2.0 * np.pi)
# Chain depths with an instantiation of their own; deeper ones run the
# runtime-depth variant (csrc/fast_event_block_deep.cu).
CHAIN_TEMPLATED = (0, 1, 2, 3)
CTA_THREADS = 256                  # lanes per CTA of the kernel (BlockBuffers.dead)
# Entries of BlockBuffers.ctl: launched has one slot for even and one for odd kb.
# A fused-k trace keeps launched per k point after these, k's slot for
# parity p at LAUNCHED_K + 2 k + p (ctl[LAUNCHED_K + p::2]).
LAUNCHED, DONE, SPENT, LAUNCHED_K = 0, 2, 3, 4

# Rows of LaneState.f (GCUR on fused-k plans only) and LaneState.i.
X, Y, Z, UX, UY, UZ, TAU, TGAS, GCUR = range(9)
ALIVE, ORDERS, PK, BAD, EVCT = range(5)
EPS6 = f32(1e-6)


@dataclass
class LaneState:
    """Per-lane wavefront state, one fixed layout for every plan.

    ``f`` is (8, L) float32: x, y, z, ux, uy, uz, tau (remaining optical
    depth; 0 = draw a fresh free path), tgas (remaining gas optical depth
    before a gas absorption); on a fused-k plan (9, L), row ``GCUR`` the
    cumulative gas optical depth Gz(z) of the lane's k profile at its
    position (fastpath.py:1296-1299).  ``i`` is (5, L) int32: alive, orders,
    pk (pending exit kind: 1 top, 2 bottom, 3 absorbed), bad, evct.  The y
    and tgas rows are always present; plans that do not track y, or have no
    gas channel, leave them untouched.  ``w`` is the (L,) float32 lane
    weight of a BRDF surface (fastpath.py:908-917: 1 at launch and refill,
    times max(R, 1) at each bounce), None on every other plan.
    """

    f: torch.Tensor
    i: torch.Tensor
    w: torch.Tensor | None = None

    @property
    def n_lanes(self) -> int:
        return self.f.shape[1]

    def clone(self) -> "LaneState":
        return LaneState(self.f.clone(), self.i.clone(),
                         None if self.w is None else self.w.clone())


@dataclass(frozen=True)
class DetectorSpec:
    """Radiance detectors with the closed-form shadow trace
    (i3rc_tpu/integrators/fastpath.py:1140-1247) or the marching one
    (:1061-1127), as float32 constants in Python floats
    (``fastpath.shadow_constants`` builds them).

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

    ``march_steps`` > 0 takes the marching trace (``shadow_march``) of that
    many masked segment steps: per detector f32(1/dx) and f32(1/dy)
    (``inv_dxd``, ``inv_dyd``; 0 on an axis the ray does not step along) and
    the flags ``use_x``, ``use_y`` (|d| >= 1e-12; y only when tracked);
    ``march_ty``: y is tracked, so the extinction takes fy too.
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
    march_steps: int = 0
    inv_dxd: tuple = ()
    inv_dyd: tuple = ()
    use_x: tuple = ()
    use_y: tuple = ()
    march_ty: bool = False

    @property
    def n(self) -> int:
        return len(self.dirs)

    @property
    def n_cols(self) -> int:
        return self.n_x * (self.n_y if self.col_y else 1)


# Surface kinds of the event block: 0 black (no SurfaceLaw), 1 a Lambertian
# albedo, then the uniform BRDFs of core/surface.py by registry name.
ALBEDO = 1
BRDF_KINDS = {"lambertian": 2, "rpv": 3, "cox_munk": 4, "ross_li": 5}
MAX_BRDF_PARAMS = 4                # the kernel's parameter block holds this many


@dataclass(frozen=True)
class SurfaceLaw:
    """A reflecting bottom (fastpath.py:896-924): ``kind`` ALBEDO revives a
    lane that hit the bottom with probability ``albedo``; a BRDF kind with
    probability min(R, 1), R = max(brdf(params, uz, mu_r, atan2(uy, ux),
    2 pi u2), 0), and carries max(R, 1) on the lane weight.  ``params``
    (the BRDF's, float32 values) and ``det_phi`` (f32(atan2(dy, dx)) per
    detector, the outgoing azimuth of surface radiance) are Python floats."""

    kind: int
    albedo: float = 0.0
    params: tuple = ()
    det_phi: tuple = ()

    @property
    def brdf(self) -> bool:
        return self.kind != ALBEDO


def brdf_function(law: SurfaceLaw):
    """The torch BRDF kernel of a BRDF surface kind."""
    return BRDF_REGISTRY[next(n for n, k in BRDF_KINDS.items() if k == law.kind)]


@dataclass(frozen=True)
class FusedK:
    """Fused-k spectral batching (fastpath.GasKTables; JAX fastpath.py:
    966-1057): the per-k tables of one tracer, on the grid's device
    (``fastpath.fused_k`` builds them).

    ``table`` is the (n_k * n_z, 2) float32 [gz, Gz at the layer's base] of
    each k profile, row k * n_z + layer (the row offset of k is k * n_z).
    Per k: ``weight`` the float32 tally weight w_k n_photons / quota_k,
    ``gtop`` the float32 Gz(z_max), ``quota`` the int64 photon quota.  The
    lanes fall into blocks of whole CTAs (``CTA_THREADS`` lanes): block k
    is CTAs [cta0[k], cta0[k + 1]) (int32 (n_k + 1,)), and ``cta_k`` (int32
    (n_ctas,)) names each CTA's k; the last block ends at ``lanes``.
    ``dz`` and ``inv_dz`` are the gas layers' float32 height and its
    inverse over ``n_z`` layers from z0.  ``exact_layer`` (the volume tally
    on): a gas death inverts the lane's cumulative row for its exact layer
    (fastpath.py:1432-1460); off, it dies at the constant-gz fraction of
    its step."""

    table: torch.Tensor
    weight: torch.Tensor
    gtop: torch.Tensor
    quota: torch.Tensor
    cta0: torch.Tensor
    cta_k: torch.Tensor
    n_z: int
    dz: float
    inv_dz: float
    exact_layer: bool
    lanes: int

    @property
    def n_k(self) -> int:
        return self.weight.shape[0]

    def lane_k(self) -> torch.Tensor:
        """(lanes,) int64: the k point of each lane."""
        return self.cta_k.long().repeat_interleave(CTA_THREADS)[:self.lanes]

    def block_lanes(self) -> list:
        """[(first lane, end lane)] of each k block."""
        c = [min(int(v) * CTA_THREADS, self.lanes) for v in self.cta0.tolist()]
        return list(zip(c[:-1], c[1:]))

    def launch_counts(self) -> list:
        """Photons each k point launches with its block at the start:
        min(its lanes, its quota)."""
        return [min(e - s, q) for (s, e), q in zip(self.block_lanes(), self.quota.tolist())]


def gas_read(spec: "EventSpec", k_row, z):
    """(gz, Gz(z)) of each lane's k profile (rows from ``k_row`` = k * n_z)
    at z clipped to the domain: the endpoint read of fastpath.py:1415-1422,
    Gz linear within the layer."""
    fk = spec.fk
    zc = torch.clamp(z, spec.z0, spec.z_max)
    lay = torch.clamp(((zc - spec.z0) * fk.inv_dz).to(torch.int32), 0, fk.n_z - 1)
    row = fk.table[(k_row + lay).long()]
    return row[:, 0], row[:, 1] + (zc - (spec.z0 + lay.to(torch.float32) * fk.dz)) * row[:, 0]


def lane_constants(spec: "EventSpec") -> dict:
    """A fused-k plan's per-lane constants of the twin: the row offset of
    the lane's k (int64), its tally weight and Gz(z_max) (float32)."""
    k = spec.fk.lane_k()
    return {"k_row": k * spec.fk.n_z, "kw": spec.fk.weight[k], "gtop": spec.fk.gtop[k]}


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
    by ``dx``/``dy`` (float32 values in Python floats).  ``surface`` is the
    reflecting bottom (None: black).

    Table modes (fastpath.py:1573-1586, :1508-1520): ``cubic`` is the
    (entries * n_seg, 4) float32 piecewise-cubic inverse CDF that samples
    the scattering cosine in place of the HG inversion (None: HG, ``g``);
    on a column plan each lane reads its ssa from slot 3 of its column row
    and, at a collision, the row base of its table entry from the int32
    (n_cols,) ``pf_row``.  ``fwd`` is the (n_fwd, 4) float32 log-space
    cubic of the phase value that a table plan's detectors read at the
    photon-to-detector angle, ``fwd_scale`` = f32(n_fwd / pi).

    ``fk`` (a gas plan only, chain depth 0) runs the fused-k variant: no
    step stops at a gas face; the gas depth of a step comes from the lane's
    carried Gz and one endpoint read of its k table (``FusedK``).  ``gz``
    still holds the k = 0 chain, which it does not read.
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
    surface: SurfaceLaw | None = None
    cubic: torch.Tensor | None = None
    n_seg: int = 0
    pf_row: torch.Tensor | None = None
    fwd: torch.Tensor | None = None
    fwd_scale: float = 0.0
    fk: FusedK | None = None

    @property
    def fused(self) -> bool:
        """A fused-k plan: k is a per-lane attribute."""
        return self.fk is not None

    @property
    def table(self) -> bool:
        """A table plan: the cubic inverse CDF samples the cosine."""
        return self.cubic is not None

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
    def reflecting(self) -> bool:
        return self.surface is not None

    @property
    def weighted(self) -> bool:
        """A BRDF surface: the lanes carry a weight."""
        return self.surface is not None and self.surface.brdf

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


def cubic_cosine(spec: "EventSpec", u, pf_row=None):
    """Scattering-angle cosine from the piecewise-cubic inverse CDF
    (fastpath.py:1573-1586): the row of segment floor(u * n_seg) of the
    lane's table entry (``pf_row``, row bases; None: the single entry),
    evaluated at the segment's fraction.  The general kernel's
    ``wavefront.sample_cos_scat`` on one table."""
    s = spec.n_seg
    pos = torch.clamp(u, 0.0, 1.0) * float(s)
    seg = torch.clamp(pos.to(torch.int32), 0, s - 1)
    t = pos - seg.to(pos.dtype)
    c = spec.cubic[(seg if pf_row is None else pf_row + seg).long()]
    return torch.clamp(((c[:, 3] * t + c[:, 2]) * t + c[:, 1]) * t + c[:, 0], -1.0, 1.0)


def forward_phase(spec: "EventSpec", proj):
    """A table plan's phase value at the cosine ``proj`` of the photon-to-
    detector angle: exp of the log-space cubic at segment floor(theta *
    n_fwd / pi) (fastpath.py:1508-1520)."""
    pos = torch.acos(proj) * spec.fwd_scale
    seg = torch.clamp(pos.to(torch.int32), 0, spec.fwd.shape[0] - 1)
    t = pos - seg.to(pos.dtype)
    c = spec.fwd[seg.long()]
    return torch.exp(((c[:, 3] * t + c[:, 2]) * t + c[:, 1]) * t + c[:, 0])


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


_MARCH_CENSUS = []      # the open march_census records


@contextlib.contextmanager
def march_census(lane_steps: bool = False):
    """While open, ``shadow_march`` counts into the record it yields: its
    ``rays`` (live lanes x detectors traced), ``steps`` (each ray's segment
    steps until it reaches the boundary or the budget ends: the steps the
    kernel's loop takes), ``warp_steps`` (per group of 32 lanes in lane
    order, the most steps of its rays: what a warp of those lanes runs),
    ``unfinished`` (rays the budget ended) and ``most`` (the largest steps
    of one ray); with ``lane_steps`` also, per call, each lane's steps (0
    where not live).  The plain version on CPU or CUDA tensors; nothing else
    changes."""
    rec = {"rays": 0, "steps": 0, "warp_steps": 0, "unfinished": 0, "most": 0}
    if lane_steps:
        rec["lane_steps"] = []
    _MARCH_CENSUS.append(rec)
    try:
        yield rec
    finally:
        _MARCH_CENSUS.remove(rec)


def _count_march(live, steps, done) -> None:
    L = steps.numel()
    pad = torch.zeros(-(-L // 32) * 32, dtype=steps.dtype, device=steps.device)
    pad[:L] = steps
    counts = {"rays": int(live.sum()), "steps": int(steps.sum()),
              "warp_steps": int(pad.view(-1, 32).max(dim=1).values.sum()),
              "unfinished": int((live & ~done).sum())}
    for rec in _MARCH_CENSUS:
        for k, v in counts.items():
            rec[k] += v
        rec["most"] = max(rec["most"], int(steps.max()) if L else 0)
        if "lane_steps" in rec:
            rec["lane_steps"].append(torch.where(live, steps, 0))


def shadow_march(spec: EventSpec, d: int, live, x, y, z):
    """(optical depth to the z boundary, exit column, ok) along detector d
    from (x, y, z) by the marching trace (fastpath.py:1061-1127): at most
    ``march_steps`` segment steps, each to the nearest face of the z chain
    and of the x and y chains the ray moves along (strict faces), with the
    face nudges and the periodic wrap; the exit column from the stepped
    position; ok = the ray reached the boundary within the budget, for the
    ``live`` lanes only.  A lane whose ray is done keeps its state."""
    det = spec.det
    dx, dy, dz = det.dirs[d]
    up = dz >= 0.0
    use_x, use_y = det.use_x[d], det.use_y[d]
    tau = torch.zeros_like(x)
    col = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    done = ~live
    steps = torch.zeros(x.shape, dtype=torch.int64, device=x.device) if _MARCH_CENSUS else None
    for _ in range(det.march_steps):
        if steps is not None:
            steps += (~done).long()
        ext = spec.fx(x) * spec.fz(z)
        if det.march_ty:
            ext = ext * spec.fy(y)
        face_z = spec.fz.face_up(z, spec.z_max) if up else spec.fz.face_dn(z, spec.z0)
        s_z = (face_z - z) * det.inv_dz[d]
        s_b = s_z
        if use_x:
            face_x = spec.fx.face_up(x, spec.x_max) if dx >= 0.0 else spec.fx.face_dn(x, spec.x0)
            s_x = (face_x - x) * det.inv_dxd[d]
            s_b = torch.minimum(s_b, s_x)
        if use_y:
            face_y = spec.fy.face_up(y, spec.y_max) if dy >= 0.0 else spec.fy.face_dn(y, spec.y0)
            s_y = (face_y - y) * det.inv_dyd[d]
            s_b = torch.minimum(s_b, s_y)
        s_b = torch.clamp(s_b, min=0.0)
        tau = torch.where(done, tau, tau + s_b * ext)
        nz = torch.where(s_z <= s_b, face_z + (spec.nudge_z if up else -spec.nudge_z),
                         z + dz * s_b)
        nx, ny = x, y
        if use_x:
            nx = torch.where(s_x <= s_b, face_x + (spec.nudge_x if dx >= 0.0 else -spec.nudge_x),
                             x + dx * s_b)
            nx = _wrap(nx, spec.x0, spec.x_max, spec.wx)
        if use_y:
            ny = torch.where(s_y <= s_b, face_y + (spec.nudge_y if dy >= 0.0 else -spec.nudge_y),
                             y + dy * s_b)
            ny = _wrap(ny, spec.y0, spec.y_max, spec.wy)
        exit_now = ~done & ((nz >= spec.z_max) if up else (nz <= spec.z0))
        col_s = torch.clamp(((nx - det.x0) * det.inv_dx).to(torch.int64), 0, det.n_x - 1)
        if det.col_y:
            iy = torch.clamp(((ny - det.y0) * det.inv_dy).to(torch.int64), 0, det.n_y - 1)
            col_s = col_s * det.n_y + iy
        col = torch.where(exit_now, col_s, col)
        done = done | exit_now
        x = torch.where(done, x, nx)
        y = torch.where(done, y, ny)
        z = torch.where(done, z, nz)
    if steps is not None:
        _count_march(live, steps, done)
    return tau, col, done & live


def shadow(spec: EventSpec, d: int, live, x, y, z):
    """(tau, exit column, ok) of detector d's shadow ray from (x, y, z):
    the marching trace when the plan has one, else the closed form, whose
    ray always reaches the boundary (ok = live)."""
    if spec.det.march_steps:
        return shadow_march(spec, d, live, x, y, z)
    return (*shadow_closed(spec, d, x, y, z), live)


def _iwabuchi(det: DetectorSpec, norm_pf, tau, u_iw):
    """Iwabuchi Eq 13/14 on the exact tau (monteCarloRadiativeTransfer.f95:
    1536-1596): pf_pi <= zeta contributes zeta / pi with probability
    (pf_pi / zeta) exp(-tau), the acceptance times the transmittance of the
    reference's trace; otherwise beyond tau_max the contribution survives
    with probability exp(tau_max - tau).  The JAX fastpath (fastpath.py:1544
    for collisions, :1950-1951 for the surface) leaves exp(-tau) out of the
    first case and overestimates; the port does not copy that."""
    pf_pi = PI * norm_pf
    tau_max = -torch.log(torch.full_like(pf_pi, det.zeta) / torch.clamp(pf_pi, min=TINY))
    c_small = torch.where(u_iw * det.zeta <= pf_pi * torch.exp(-tau), det.zeta_pi, 0.0)
    c_large = torch.where(
        tau <= tau_max, norm_pf * torch.exp(-tau),
        torch.where(u_iw < torch.exp(tau_max - tau), det.zeta_pi, 0.0))
    return torch.where(pf_pi <= det.zeta, c_small, c_large)


def _detector_block(spec: EventSpec, u, pos, dirs, collided, acc, records, w=None,
                    lane=None) -> None:
    """Local-estimate radiance of every collision (fastpath.py:1501-1571):
    P(photon -> detector) / (4 pi |mu_d|) x exp(-tau to the boundary) at the
    shadow ray's exit column, with Iwabuchi roulette when asked for, times
    the lane weight ``w`` of a BRDF surface (fastpath.py:1553-1556).
    ``pos`` is the collision point, ``dirs`` the direction before
    scattering.  On a fused-k plan ``lane`` holds the lanes' ``gcur`` and
    ``lane_constants``: the shadow ray adds the lane's own gas, max((Gz at
    the exit - gcur) / dz_d, 0), and the contribution takes its k's weight
    (fastpath.py:1526-1531, :1557-1562)."""
    det = spec.det
    x, y, z = pos
    ux, uy, uz = dirs
    for d, (dx, dy, dz) in enumerate(det.dirs):
        proj = torch.clamp(ux * dx + uy * dy + uz * dz, -1.0, 1.0)
        pf = forward_phase(spec, proj) if spec.fwd is not None else hg_phase(spec.g, proj)
        norm_pf = pf * det.norm[d]
        tau, col, ok = shadow(spec, d, collided, x, y, z)
        if lane is not None:
            g_exit = lane["gtop"] if dz > 0.0 else torch.zeros_like(tau)
            tau = tau + torch.clamp((g_exit - lane["gcur"]) * det.inv_dz[d], min=0.0)
        if det.iwabuchi:
            contrib = torch.where(ok, _iwabuchi(det, norm_pf, tau, u[spec.bonus_draws + d]), 0.0)
        else:
            contrib = torch.where(ok, norm_pf * torch.exp(-tau), 0.0)
        if w is not None:
            contrib = contrib * w
        if lane is not None:
            contrib = contrib * lane["kw"]
        if acc is not None:
            acc.view(-1).index_add_(0, col * det.n + d, contrib.to(torch.float64))
        if records is not None:
            records.append((contrib, col))


def _wrap(v, lo: float, hi: float, w: float):
    """Periodic wrap for positions at most one event-step outside."""
    return torch.where(v >= hi, v - w, torch.where(v < lo, v + w, v))


def _death_fraction(spec: EventSpec, k_row, g_t, z, denom):
    """A fused-k gas death's exact fraction of its step (fastpath.py:
    1432-1460): the layer ld whose base Gz the lane's cumulative row
    reaches at the death target g_t = gcur + tgas uz (the count of bases
    <= g_t, less one, clipped), the height where Gz = g_t inside it
    (linear; the layer's middle where gz is 0), and that height's share of
    the step's rise ``denom`` = uz * step, clipped to [0, 1]."""
    fk = spec.fk
    n_z = fk.n_z
    rows = fk.table[(k_row[:, None] + torch.arange(n_z, device=k_row.device)).long(), 1]
    ld = torch.clamp((rows <= g_t[:, None]).sum(dim=1, dtype=torch.int32) - 1, 0, n_z - 1)
    row = fk.table[(k_row + ld).long()]
    gz_ld = row[:, 0]
    z_d = (spec.z0 + ld.to(torch.float32) * fk.dz) + torch.where(
        gz_ld > 0.0, (g_t - row[:, 1]) / torch.clamp(gz_ld, min=TINY), f32(0.5 * fk.dz))
    return torch.clamp((z_d - z) / torch.where(denom.abs() > 0.0, denom, 1.0), 0.0, 1.0)


def _fast_event(spec: EventSpec, u, s: dict, acc=None, records=None) -> None:
    """One fast_event (fastpath.py:1291-1676 with MARCH = 1) on the lane
    tensors in ``s``; u is the (n_draws, L) draw block of the event.
    Detector contributions go into ``acc`` ((n_cols, D) float64) and, per
    event and detector, as (contribution, column) pairs into ``records``.
    With a gas channel the lanes also carry ``s["tgas"]``.  A table plan
    samples the cosine from the cubic inverse CDF, on a column plan at the
    row of the lane's table entry with the lane's ssa in the absorption
    tests (both read from the column of the event's start).  A fused-k plan
    (fastpath.py:1409-1470) stops at no gas face: the step's gas depth is
    (Gz(z_end) - gcur) / uz from one endpoint read of the lane's k table
    (gz * step when |uz| < 1e-6), a lane whose depth reaches tgas dies in
    the step at the constant-gz fraction or, with ``exact_layer``, at the
    layer where its cumulative row reaches gcur + tgas uz, and the
    survivors carry gcur = Gz(z_end); ``s`` then also holds ``gcur`` and
    ``lane_constants``."""
    x, y, z = s["x"], s["y"], s["z"]
    ux, uy, uz = s["ux"], s["uy"], s["uz"]
    alive, pk = s["alive"], s["pk"]
    ty, fk = spec.track_y, spec.fk
    gas = spec.gas and fk is None      # the gas chain with its faces
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
        ci = ix * spec.n_y + iy
        row = spec.column[ci]
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
    if ty:
        nyp = torch.where(cross & (sy <= s_bnd), face_y + sign_y, y + uy * adv)
        nyp = _wrap(nyp, spec.y0, spec.y_max, spec.wy)
    if fk is not None:
        tgas, gcur = s["tgas"], s["gcur"]
        g2, g_next = gas_read(spec, s["k_row"], nzp)
        steep = uz.abs() >= EPS6
        dgas = torch.clamp(torch.where(steep, (g_next - gcur) / uz, g2 * adv), min=0.0)
        gas_die = alive & (dgas >= tgas)
        fdie = torch.clamp(tgas / torch.clamp(dgas, min=TINY), 0.0, 1.0)
        if fk.exact_layer:
            fdie = torch.where(steep, _death_fraction(spec, s["k_row"], gcur + tgas * uz, z,
                                                      uz * adv), fdie)
        xd = _wrap(x + ux * adv * fdie, spec.x0, spec.x_max, spec.wx)
        zd = z + uz * adv * fdie
        collide = collide & ~gas_die
        cross = cross & ~gas_die
        surv = alive & ~gas_die
        s["tgas"] = torch.where(surv, tgas - dgas, tgas)
        s["gcur"] = torch.where(surv, g_next, gcur)
    exit_top = cross & (nzp >= spec.z_max)
    exit_bot = cross & ~exit_top & (nzp <= spec.z0)
    pk = torch.where(exit_top, 1, torch.where(exit_bot, 2, pk))
    if gas or fk is not None:
        pk = torch.where(gas_die, 3, pk)
    tau = torch.where(cross, tau - s_bnd * ext, torch.where(collide, 0.0, tau))
    if fk is not None:
        x = torch.where(gas_die, xd, torch.where(alive, nxp, x))
        z = torch.where(gas_die, zd, torch.where(alive, nzp, z))
        if ty:
            yd = _wrap(y + uy * adv * fdie, spec.y0, spec.y_max, spec.wy)
            y = torch.where(gas_die, yd, torch.where(alive, nyp, y))
    else:
        x = torch.where(alive, nxp, x)
        z = torch.where(alive, nzp, z)
        if ty:
            y = torch.where(alive, nyp, y)

    # The ssa of the absorption tests and the cosine's sampler.
    ssa, pf_row = f32(spec.ssa), None
    if spec.table and spec.col:
        ssa, pf_row = row[:, 3], spec.pf_row[ci]
    if spec.table:
        sample_mu = lambda uu: cubic_cosine(spec, uu, pf_row)
    else:
        sample_mu = lambda uu: hg_cosine(spec.g, uu)
    collided = collide
    if spec.absorbing:
        die = collided & (u[3] >= ssa)
        pk = torch.where(die, 3, pk)
        collided = collided & ~die
    if spec.det is not None:
        _detector_block(spec, u, (x, y, z), (ux, uy, uz), collided, acc, records, s.get("w"),
                        s if fk is not None else None)
    nux, nuy, nuz = rotate_direction(ux, uy, uz, sample_mu(u[1]), u[2], renormalize=False)
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
                die_c = commit & (u[i0 + 3] >= ssa)
                pk = torch.where(die_c, 3, pk)
                commit = commit & ~die_c
            bx, by, bz = rotate_direction(ux, uy, uz, sample_mu(u[i0 + 1]), u[i0 + 2],
                                          renormalize=False)
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
    (contribution, column) pairs to the list ``records`` when given.  The
    lane weight ``state.w`` (a BRDF surface) scales the contributions.  A
    fused-k plan's lanes carry the GCUR row.
    """
    f, i = state.f, state.i
    s = {"x": f[X], "y": f[Y], "z": f[Z], "ux": f[UX], "uy": f[UY], "uz": f[UZ],
         "tau": f[TAU], "tgas": f[TGAS], "alive": i[ALIVE] != 0, "orders": i[ORDERS],
         "pk": i[PK], "bad": i[BAD], "evct": i[EVCT], "w": state.w}
    rows = ["x", "y", "z", "ux", "uy", "uz", "tau", "tgas"]
    if spec.fused:
        s.update(lane_constants(spec), gcur=f[GCUR])
        rows.append("gcur")
    for j in range(spec.K):
        _fast_event(spec, uniforms[j], s, acc, records)
    state.f.copy_(torch.stack([s[k] for k in rows]))
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
# The block's prologue: renormalize, flush, FIFO refill

@dataclass(frozen=True)
class PrologueSpec:
    """Constants of a block's prologue for one tracer: the photon budget,
    the tally grid as the trace loop bins it (``col_y``: the exit column
    bins y too; ``deaths``: a third tally column for kind-3 deaths;
    ``vol_tally``: those also count into their (column, z cell)), and the
    domain bounds as the geometry holds them (Python doubles: torch rounds
    each to float32 where it meets a tensor, and the kernel gets those
    float32 values)."""

    n_photons: int
    n_x: int
    n_y: int
    n_z: int
    x0: float
    y0: float
    z0: float
    x_max: float
    y_max: float
    z_max: float
    inv_dx: float
    inv_dy: float
    inv_dz_cell: float
    col_y: bool
    deaths: bool
    vol_tally: bool

    @property
    def n_cols(self) -> int:
        return self.n_x * self.n_y

    @property
    def n_kinds(self) -> int:
        return 3 if self.deaths else 2


@dataclass
class BlockBuffers:
    """What a trace carries from block to block besides the lane state.

    ``columns`` (n_cols, 2 or 3) and ``vol`` (n_cols * n_z, or empty) are the
    float64 flux and volume tallies, ``acc`` the (n_cols, D) detector
    accumulator (None without detectors), ``srf`` the (n_cols, D) surface
    radiance accumulator (None without detectors or a reflecting surface:
    component slot 0 of the radiance).  ``ctl`` is int64 (4,): photons
    launched so far as block ``kb`` reads it at ``kb & 1`` and leaves it for
    the next at ``(kb + 1) & 1``; ``DONE``, the first ``kb`` at whose entry no
    lane was alive and the budget was spent (-1 until then: the trace loop's
    end); ``SPENT``, the first at whose entry the budget was spent.  A
    fused-k trace has (4 + 2 n_k,): its launched slots stay 0, and k's count
    is at ``LAUNCHED_K + 2 k + (kb & 1)``; its budget is spent when every k
    has launched its quota (fastpath.py:2084).  ``dead`` is int32 (2,
    n_ctas): dead lanes per ``CTA_THREADS`` lanes at the entry of block
    ``kb`` in row ``kb & 1``, which the kernel's FIFO rank reads."""

    columns: torch.Tensor
    vol: torch.Tensor
    acc: torch.Tensor | None
    ctl: torch.Tensor
    dead: torch.Tensor
    srf: torch.Tensor | None = None

    def clone(self) -> "BlockBuffers":
        opt = lambda t: None if t is None else t.clone()
        return BlockBuffers(self.columns.clone(), self.vol.clone(), opt(self.acc),
                            self.ctl.clone(), self.dead.clone(), opt(self.srf))


def cta_dead_counts(alive) -> torch.Tensor:
    """(n_ctas,) int32: dead lanes in each run of CTA_THREADS lanes."""
    L = alive.shape[0]
    n_ctas = -(-L // CTA_THREADS)
    dead = torch.zeros(n_ctas * CTA_THREADS, dtype=torch.int32, device=alive.device)
    dead[:L] = (alive == 0).to(torch.int32)
    return dead.view(n_ctas, CTA_THREADS).sum(dim=1, dtype=torch.int32)


def block_buffers(spec: EventSpec, pro: PrologueSpec, state: LaneState, launched,
                  kb: int = 0) -> BlockBuffers:
    """Zeroed tallies and the loop's control state for a trace that enters
    block ``kb`` on ``state`` with ``launched`` photons launched (on a
    fused-k plan, the n_k counts of its k points)."""
    dev = state.f.device
    f64 = lambda *shape: torch.zeros(shape, dtype=torch.float64, device=dev)
    n_k = spec.fk.n_k if spec.fused else 0
    ctl = torch.tensor([0, 0, -1, -1] + [0] * (2 * n_k), dtype=torch.int64, device=dev)
    if spec.fused:
        ctl[LAUNCHED_K + (kb & 1)::2] = torch.as_tensor(launched, dtype=torch.int64)
    else:
        ctl[kb & 1] = launched
    dead = torch.zeros((2, -(-state.n_lanes // CTA_THREADS)), dtype=torch.int32, device=dev)
    dead[kb & 1] = cta_dead_counts(state.i[ALIVE])
    radiance = spec.det is not None
    return BlockBuffers(
        columns=f64(pro.n_cols, pro.n_kinds),
        vol=f64(pro.n_cols * pro.n_z if pro.vol_tally else 0),
        acc=f64(spec.det.n_cols, spec.det.n) if radiance else None,
        ctl=ctl, dead=dead,
        srf=f64(spec.det.n_cols, spec.det.n) if radiance and spec.reflecting else None)


def renormalize(st: LaneState) -> None:
    """Rescale directions to unit length in place: the event block skips the
    per-rotation rescale, so the prologue does it once per block."""
    ux, uy, uz = st.f[UX], st.f[UY], st.f[UZ]
    st.f[UX:UZ + 1] *= torch.rsqrt(torch.clamp(ux * ux + uy * uy + uz * uz,
                                               min=f32(1e-12)))


def flux_column(pro: PrologueSpec, x, y):
    """The tally column of a frozen exit position."""
    col = torch.clamp(((x - pro.x0) * pro.inv_dx).to(torch.int64), 0, pro.n_x - 1)
    if pro.col_y:
        iy = torch.clamp(((y - pro.y0) * pro.inv_dy).to(torch.int64), 0, pro.n_y - 1)
        col = col * pro.n_y + iy
    return col


def flush(pro: PrologueSpec, columns, vol, st: LaneState, kw=None) -> None:
    """Tally pending exits at their frozen positions, each with its lane
    weight on a BRDF surface (fastpath.py:1748-1749, :1758-1759) times, on
    a fused-k plan, its k's weight ``kw`` (float32 per lane, :1750-1760),
    then clear pk."""
    x, z = st.f[X], st.f[Z]
    pk = st.i[PK]
    col = flux_column(pro, x, st.f[Y])
    w = None if st.w is None else st.w.to(torch.float64)
    if kw is not None:
        w = kw.to(torch.float64) if w is None else w * kw.to(torch.float64)
    kinds = [pk == 1, pk == 2] + ([pk == 3] if pro.deaths else [])
    vals = torch.stack(kinds, dim=1).to(torch.float64)
    columns.index_add_(0, col, vals if w is None else vals * w[:, None])
    if pro.vol_tally:
        iz = torch.clamp(((z - pro.z0) * pro.inv_dz_cell).to(torch.int64), 0, pro.n_z - 1)
        dead = (pk == 3).to(torch.float64)
        vol.index_add_(0, col * pro.n_z + iz, dead if w is None else dead * w)
    pk.zero_()


def refill(spec: EventSpec, pro: PrologueSpec, st: LaneState, launched, key: PhiloxKey,
           source: PhotonSource, kb: int):
    """Dead lanes take the next photons of the budget, in lane order;
    returns the new count of photons launched."""
    dead = st.i[ALIVE] == 0
    dead_i = dead.to(torch.int64)
    new_id = launched + torch.cumsum(dead_i, 0) - dead_i
    take = dead & (new_id < pro.n_photons)
    _take_fresh(spec, pro, st, take, key, source, kb)
    return launched + take.sum()


def _take_fresh(spec: EventSpec, pro: PrologueSpec, st: LaneState, take, key: PhiloxKey,
                source: PhotonSource, kb: int) -> None:
    """The lanes ``take`` start a fresh photon: the source sample of block kb
    (STREAM_REFILL), tau 0, orders 0, alive, and with the gas channel a
    fresh threshold (STREAM_GAS)."""
    L = st.n_lanes
    fresh = source.sample(key, L, st.f.device, stream=STREAM_REFILL, block=kb)
    f, i = st.f, st.i
    f[X] = torch.where(take, pro.x0 + fresh.x * (pro.x_max - pro.x0), f[X])
    f[Y] = torch.where(take, pro.y0 + fresh.y * (pro.y_max - pro.y0), f[Y])
    f[Z] = torch.where(take, pro.z0 + fresh.z * (pro.z_max - pro.z0), f[Z])
    for row, v in zip((UX, UY, UZ), make_direction_cosines(fresh.mu, fresh.phi)):
        f[row] = torch.where(take, v, f[row])
    f[TAU] = torch.where(take, 0.0, f[TAU])
    if spec.gas:
        f[TGAS] = torch.where(take, gas_thresholds(key, kb, L, f.device), f[TGAS])
    i[ORDERS] = torch.where(take, 0, i[ORDERS])
    i[ALIVE] = i[ALIVE] | take.to(torch.int32)


def refill_fused(spec: EventSpec, pro: PrologueSpec, st: LaneState, launched,
                 key: PhiloxKey, source: PhotonSource, kb: int):
    """A fused-k plan's refill (fastpath.py:1984-2017): a dead lane ranks
    among the dead lanes of its own k block, in lane order, and takes a
    photon while its k's quota lasts; a fresh lane starts with gcur = Gz at
    its own height (not JAX's Gz at the domain top, :2012, which is wrong
    for an internal source).  ``launched`` is the (n_k,) int64 count per k;
    returns the new counts."""
    fk = spec.fk
    lane_k = fk.lane_k()
    dead = st.i[ALIVE] == 0
    dead_i = dead.to(torch.int64)
    below = torch.cumsum(dead_i, 0) - dead_i
    first = (fk.cta0.long() * CTA_THREADS)[lane_k]
    rank = below - below[first]
    take = dead & (launched[lane_k] + rank < fk.quota[lane_k])
    _take_fresh(spec, pro, st, take, key, source, kb)
    st.f[GCUR] = torch.where(take, gas_read(spec, lane_k * fk.n_z, st.f[Z])[1], st.f[GCUR])
    return launched + torch.bincount(lane_k[take], minlength=fk.n_k)


def surface_uniforms(spec: EventSpec, key: PhiloxKey, kb: int, n_lanes: int, device):
    """The surface bounce's draws of block ``kb``: (3, L) from group 0 of
    STREAM_SURFACE (revive test, outgoing cosine, azimuth) and, with the
    Iwabuchi roulette, (D, L) from STREAM_SURFACE_IW (draw d: word d % 4 of
    group d // 4), else None."""
    u = stream_uniforms(key, STREAM_SURFACE, kb, 1, n_lanes, device)[:3]
    det = spec.det
    if det is None or not det.iwabuchi:
        return u, None
    return u, stream_uniforms(key, STREAM_SURFACE_IW, kb, -(-det.n // 4), n_lanes,
                              device)[:det.n]


def resolve_surface(spec: EventSpec, pro: PrologueSpec, st: LaneState, buf: BlockBuffers,
                    u, u_iw=None) -> None:
    """The surface stage that ends a block over a reflecting surface, on the
    draws ``u`` (3, L) and ``u_iw`` (D, L) of ``surface_uniforms``
    (fastpath.py:1871-1981): every exit of the block tallied with its lane
    weight (``flush``: Fdn of a bottom hit at its frozen column); for the
    bottom hits (pk == 2) the revive test (u0 < albedo, or u0 < min(R, 1)
    under a BRDF), the surface radiance into ``buf.srf`` (every hit under a
    BRDF with R(in -> d) / pi times the weight, the revived lanes of an
    albedo with 1 / pi; upward detectors only, shadow ray from z0 +
    nudge_z; the Iwabuchi rule of the collisions, exp(-tau) kept); then a
    revived lane takes the cosine-weighted direction (max(sqrt(u1), 1e-6),
    azimuth 2 pi u2), z0 + nudge_z, orders + 1, its weight times max(R, 1),
    and is alive; it keeps its tau.  A lane that exited and stays dead gets
    weight 1 for its refill.  On a fused-k plan every tally takes the
    lane's k weight, the surface's shadow rays add the whole gas column of
    the lane's k, Gz(z_max) / dz_d, and a revived lane restarts at gcur = 0
    (fastpath.py:1931-1934, :1964-1965, :1979-1983)."""
    law, det = spec.surface, spec.det
    f, i = st.f, st.i
    x, y, ux, uy, uz = f[X], f[Y], f[UX], f[UY], f[UZ]
    exited = i[PK] != 0
    hit = i[PK] == 2
    w = st.w
    lane = lane_constants(spec) if spec.fused else None
    flush(pro, buf.columns, buf.vol, st, None if lane is None else lane["kw"])
    mu_r = torch.clamp(torch.sqrt(u[1]), min=f32(1e-6))
    sin_r = torch.sqrt(torch.clamp(1.0 - u[1], min=0.0))
    z_surf = f32(np.float32(spec.z0) + np.float32(spec.nudge_z))
    if law.brdf:
        brdf = brdf_function(law)
        phi_in = torch.atan2(uy, ux)
        refl = torch.clamp(brdf(law.params, uz, mu_r, phi_in, TWO_PI * u[2]), min=0.0)
        revive = hit & (u[0] < torch.clamp(refl, max=1.0))
    else:
        revive = hit & (u[0] < law.albedo)
    if buf.srf is not None:
        emit = hit if law.brdf else revive
        zs = torch.full_like(x, z_surf)
        for d, (_, _, dz) in enumerate(det.dirs):
            if dz <= 0.0:
                continue            # a surface emits upward only
            tau, col, ok = shadow(spec, d, emit, x, y, zs)
            if lane is not None:
                tau = tau + lane["gtop"] * det.inv_dz[d]
            if law.brdf:
                npf = torch.clamp(brdf(law.params, uz, torch.full_like(uz, dz), phi_in,
                                       torch.full_like(uz, law.det_phi[d])), min=0.0) * INV_PI
            else:
                npf = torch.full_like(x, INV_PI)
            if det.iwabuchi:
                contrib = _iwabuchi(det, npf, tau, u_iw[d])
            else:
                contrib = npf * torch.exp(-tau)
            contrib = torch.where(ok, contrib, 0.0)
            if w is not None:
                contrib = contrib * w
            if lane is not None:
                contrib = contrib * lane["kw"]
            buf.srf.view(-1).index_add_(0, col * det.n + d, contrib.to(torch.float64))
    if w is not None:
        w.copy_(torch.where(revive, w * torch.clamp(refl, min=1.0),
                            torch.where(exited, 1.0, w)))
    sin_az, cos_az = _sincos_2pi(u[2])
    f[UX] = torch.where(revive, sin_r * cos_az, ux)
    f[UY] = torch.where(revive, sin_r * sin_az, uy)
    f[UZ] = torch.where(revive, mu_r, uz)
    f[Z] = torch.where(revive, z_surf, f[Z])
    i[ORDERS] = torch.where(revive, i[ORDERS] + 1, i[ORDERS])
    i[ALIVE] = i[ALIVE] | revive.to(torch.int32)
    if spec.fused:
        f[GCUR] = torch.where(revive, 0.0, f[GCUR])


SURFACE_SMEM_BINS = 1024            # the stage's CTA histograms in shared memory (SRF_SMEM_BINS)
SURFACE_MAX_TILES = 16              # the marching stage's tiles a CTA's run, at most (SM_MAX_TILES)
SURFACE_QUEUE = 512                 # records of its CTA's queue (SM_QUEUE)
MARCH_REFILL_AT = 8                 # a warp of a ray loop refills at this many busy threads


def queue_trips(steps: torch.Tensor, n: torch.Tensor) -> int:
    """The warp trips of a ray loop that deals each unit's rays to the
    CTA_THREADS threads of a CTA (march_flush's and the marching surface
    stage's rule): ``steps`` (U, R) int64 holds each unit's ray steps (each
    >= 1) in deal order, ``n`` (U,) its rays.  The idle threads of a warp
    take the next rays, warps in order; a warp runs trips, each advancing
    each of its rays one step, until none of its threads holds a ray or, while
    rays were left when it last took some, at most MARCH_REFILL_AT do; it
    leaves the loop when it finds no ray to take.  The warps advance in
    lockstep (on the card they race, so this is a model of the slots; the
    steps are exact)."""
    U = steps.shape[0]
    if U == 0 or not bool((n > 0).any()):
        return 0
    W, dev = CTA_THREADS // 32, steps.device
    rem = torch.zeros((U, W, 32), dtype=torch.int64, device=dev)
    more = (n > 0)[:, None, None].expand(U, W, 32).clone()
    need = torch.ones((U, W), dtype=torch.bool, device=dev)
    done = torch.zeros((U, W), dtype=torch.bool, device=dev)
    left = torch.zeros((U, W), dtype=torch.bool, device=dev)
    nxt = torch.zeros(U, dtype=torch.int64, device=dev)
    nn = n[:, None, None]
    trips = 0
    while True:
        want = (need & ~done)[:, :, None] & (rem == 0) & more
        w = want.long()
        cw = w.sum(2)
        r = nxt[:, None, None] + (torch.cumsum(cw, 1) - cw)[:, :, None] + torch.cumsum(w, 2) - w
        more = torch.where(want, r < nn, more)
        got = want & (r < nn)
        pick = torch.gather(steps, 1, r.clamp(0, steps.shape[1] - 1).view(U, -1)).view(U, W, 32)
        rem = torch.where(got, pick, rem)
        nxt += cw.sum(1)
        busy = (rem > 0).sum(2)
        refilled = need & ~done
        done |= refilled & (busy == 0)
        left = torch.where(refilled, more.any(2), left)
        running = ~done & (busy > 0)
        if not bool(running.any()):
            return trips
        trips += int(running.sum())
        rem = torch.where(running[:, :, None] & (rem > 0), rem - 1, rem)
        busy = (rem > 0).sum(2)
        need = running & ((busy == 0) | (left & (busy <= MARCH_REFILL_AT)))


def _surface_queue(exited, emit, lane_steps: list, tiles: int) -> dict:
    """The marching surface stage's work, run by run (``tiles`` tiles a
    CTA): each run's exits in lane order in rounds of CTA_THREADS, its
    emitting hits queued, the queue traced when a round leaves more than
    SURFACE_QUEUE - CTA_THREADS records (a flush) and at the run's end; a
    flush's rays are its records toward each upward detector in turn, each
    with the steps of its lane's ray (``lane_steps``, one (L,) tensor an
    upward detector)."""
    L, dev = emit.shape[0], emit.device
    per_run = CTA_THREADS * tiles
    n_runs = -(-L // per_run)
    run = torch.arange(L, device=dev) // per_run
    # Each exit's round within its run, and the flush its record falls in.
    order = torch.cumsum(exited.long(), 0) - exited.long()
    first = torch.zeros(n_runs + 1, dtype=torch.int64, device=dev)
    first[1:] = torch.cumsum(torch.bincount(run[exited], minlength=n_runs), 0)
    rnd = (order - first[run]) // CTA_THREADS
    n_rounds = -(-per_run // CTA_THREADS)
    flush_of = torch.zeros(L, dtype=torch.int64, device=dev)
    queued = torch.zeros(n_runs, dtype=torch.int64, device=dev)
    group = torch.zeros(n_runs, dtype=torch.int64, device=dev)
    for k in range(n_rounds):
        at = emit & (rnd == k)
        flush_of = torch.where(at, group[run], flush_of)
        queued += torch.bincount(run[at], minlength=n_runs)
        full = queued > SURFACE_QUEUE - CTA_THREADS
        group += full.long()
        queued = torch.where(full, 0, queued)
    n_up = len(lane_steps)
    hits_run = torch.bincount(run[emit], minlength=n_runs)
    # Flush units: (run, flush), their records in lane order.
    unit = run * (n_rounds + 1) + flush_of
    keys, inv, n_rec = torch.unique(unit[emit], return_inverse=True, return_counts=True)
    U = keys.numel()
    out = {"tiles": tiles, "runs": n_runs, "flushes": U,
           "emitting_hits": {"sum": int(hits_run.sum()), "max": int(hits_run.max()) if n_runs else 0},
           "rays": {"sum": int(hits_run.sum()) * n_up,
                    "max": int(hits_run.max()) * n_up if n_runs else 0}}
    if U == 0 or n_up == 0:
        return dict(out, steps=0, slots=0, lane_use=None)
    lanes = torch.nonzero(emit)[:, 0]
    rank = torch.arange(lanes.numel(), device=dev) - (torch.cumsum(n_rec, 0) - n_rec)[inv]
    R = int(n_rec.max()) * n_up
    steps = torch.zeros((U, R), dtype=torch.int64, device=dev)
    for k, ls in enumerate(lane_steps):
        steps[inv, k * n_rec[inv] + rank] = ls[lanes]
    total = int(steps.sum())
    slots = 32 * queue_trips(steps, n_rec * n_up)
    return dict(out, steps=total, slots=slots, lane_use=total / slots)


def surface_census(spec: EventSpec, pro: PrologueSpec, st: LaneState, buf: BlockBuffers,
                   u, u_iw=None, entry_alive=None, tiles: int = SURFACE_MAX_TILES) -> dict:
    """Counts of the surface stage that ends one block over a reflecting
    surface, on the state ``resolve_surface`` would take (after the K events,
    exits pending) and its draws; changes nothing.  ``entry_alive`` is the
    alive flag of each lane as the K events began (after the refill), whose
    lanes the kernel compacts onto the first threads of their CTA; every
    pending exit is one of them.

    Per block: ``exits`` (by kind), ``hits`` (pk == 2), ``revived``; the
    ``warps`` (in lane order, as the stage's kernel runs them:
    ``warps_lane_order``; compacted, as a stage inside the event kernel
    would hold them: ``warps_compacted``) and ``ctas`` that hold an exit;
    ``bins_per_cta`` (the distinct flux bins of a CTA's exits: sum and
    max); the float64 atomics of the tallies into device memory
    (``atomics``: flux columns, volume, surface radiance) as one atomic a
    warp and bin issues them (``warp``, lane order) and as a CTA's sum in
    shared memory does (``cta``: one a CTA and bin while the histogram has
    at most SURFACE_SMEM_BINS bins), each with the most that fall on one
    address (``same_address``; past that many bins, one a warp and bin as
    before).  With detectors: ``emits`` (the nonzero
    surface-radiance contributions of each upward detector), and the lane
    use of the per-hit detector loop (emitting hit x upward detector
    pairs over 32 x the rounds a warp runs), one lane per thread in lane
    order (``loop_lane_order``), compacted (``loop_compacted``), and with a
    warp's pairs dealt to all its threads (``loop_dealt``); the bounce's lane
    use (hits over 32 x the warps holding a hit) in both orders.  With the
    marching trace, ``queue``: the marching stage's runs of ``tiles``
    tiles, their emitting hits and rays (sum and most in one run), flushes,
    the rays' steps, the thread slots of its queue-dealt ray loop
    (``queue_trips``) and their ratio, ``lane_use``, also ``loop_queue``."""
    law, det = spec.surface, spec.det
    f, i = st.f, st.i
    L = st.n_lanes
    pk = i[PK].long()
    exited, hit = pk != 0, pk == 2
    lane = torch.arange(L, device=f.device)
    cta = lane // CTA_THREADS
    if entry_alive is None:
        entry_alive = exited
    entry_alive = entry_alive != 0
    if bool((exited & ~entry_alive).any()):
        raise ValueError("surface_census: an exit pends on a lane that did not run the block")
    # The compacted thread of each lane that ran: its rank among its CTA's.
    live = entry_alive.long()
    below = torch.cumsum(live, 0) - live
    starts = below[::CTA_THREADS]
    slot = below - starts[cta]
    warp_lane = lane // 32
    warp_comp = cta * (CTA_THREADS // 32) + slot // 32
    n_warps = -(-L // CTA_THREADS) * (CTA_THREADS // 32)

    if law.brdf:
        mu_r = torch.clamp(torch.sqrt(u[1]), min=f32(1e-6))
        phi_in = torch.atan2(f[UY], f[UX])
        refl = torch.clamp(brdf_function(law)(law.params, f[UZ], mu_r, phi_in, TWO_PI * u[2]),
                           min=0.0)
        revive = hit & (u[0] < torch.clamp(refl, max=1.0))
    else:
        revive = hit & (u[0] < law.albedo)

    def groups(warp, key, ok):
        """(atomics, same-address max) of one add per distinct (group, key)."""
        if not bool(ok.any()):
            return 0, 0
        pairs = torch.unique(warp[ok] * (1 << 40) + key[ok])
        per_key = torch.unique(pairs % (1 << 40), return_counts=True)[1]
        return int(pairs.numel()), int(per_key.max())

    def tally(key, ok, n_bins, reps: int = 1):
        """One tally's adds (its keys and flags for reps copies of the lanes)."""
        by_warp = groups(warp_lane.repeat(reps), key, ok)
        by_cta = groups(cta.repeat(reps), key, ok) if n_bins <= SURFACE_SMEM_BINS else by_warp
        return {"warp": by_warp[0], "warp_same_address": by_warp[1],
                "cta": by_cta[0], "cta_same_address": by_cta[1]}

    col = flux_column(pro, f[X], f[Y])
    key = col * pro.n_kinds + pk - 1
    flux_ok = exited & (pk <= pro.n_kinds)
    atomics = {"columns": tally(key, flux_ok, pro.n_cols * pro.n_kinds)}
    if pro.vol_tally:
        dead = pk == 3
        iz = torch.clamp(((f[Z] - pro.z0) * pro.inv_dz_cell).to(torch.int64), 0, pro.n_z - 1)
        per = torch.unique(col[dead] * pro.n_z + iz[dead], return_counts=True)[1]
        n = int(dead.sum())
        most = int(per.max()) if n else 0
        atomics["vol"] = {"warp": n, "warp_same_address": most, "cta": n,
                          "cta_same_address": most}
    cta_bins = torch.unique(cta[flux_ok] * (1 << 40) + key[flux_ok])
    per_cta = torch.unique(cta_bins // (1 << 40), return_counts=True)[1]

    def lane_use(work, warp, rounds_of, per_item: int = 1):
        """The work's items (per_item each) over 32 x the rounds that the
        warps holding it run (rounds_of: a warp's count of work -> rounds)."""
        if not bool(work.any()):
            return None
        n = torch.bincount(warp[work], minlength=n_warps)
        return int(work.sum()) * per_item / (32 * int(rounds_of(n[n > 0]).sum()))

    out = {"lanes": L, "exits": {k: int((pk == k).sum()) for k in (1, 2, 3)},
           "hits": int(hit.sum()), "revived": int(revive.sum()),
           "warps_lane_order": int(torch.unique(warp_lane[exited]).numel()),
           "warps_compacted": int(torch.unique(warp_comp[exited]).numel()),
           "ctas": int(torch.unique(cta[exited]).numel()),
           "bins_per_cta": {"sum": int(cta_bins.numel()),
                            "max": int(per_cta.max()) if per_cta.numel() else 0}}
    for name, warp in (("lane_order", warp_lane), ("compacted", warp_comp)):
        out[f"bounce_{name}"] = lane_use(hit, warp, torch.ones_like)
    if buf.srf is not None:
        emit = hit if law.brdf else revive
        up = [d for d, (_, _, dz) in enumerate(det.dirs) if dz > 0.0]
        zs = torch.full_like(f[X], f32(np.float32(spec.z0) + np.float32(spec.nudge_z)))
        lane_k = lane_constants(spec) if spec.fused else None
        keys, oks, emits = [], [], {}
        marching = bool(det.march_steps)
        outer = _MARCH_CENSUS[:]            # the census's own rays count in no open census
        _MARCH_CENSUS.clear()
        try:
            with march_census(lane_steps=True) as mc:
                traced = [shadow(spec, d, emit, f[X], f[Y], zs) for d in up]
        finally:
            _MARCH_CENSUS[:] = outer
        for d, (tau, dcol, ok) in zip(up, traced):
            if lane_k is not None:
                tau = tau + lane_k["gtop"] * det.inv_dz[d]
            if law.brdf:
                dz = det.dirs[d][2]
                npf = torch.clamp(brdf_function(law)(law.params, f[UZ], torch.full_like(f[UZ], dz),
                                                     phi_in, torch.full_like(f[UZ], law.det_phi[d])),
                                  min=0.0) * INV_PI
            else:
                npf = torch.full_like(f[X], INV_PI)
            c = _iwabuchi(det, npf, tau, u_iw[d]) if det.iwabuchi else npf * torch.exp(-tau)
            nonzero = ok & (c != 0.0)
            emits[d] = int(nonzero.sum())
            keys.append(dcol * det.n + d)
            oks.append(nonzero)
        n_up = len(up)
        out["emits"] = emits
        out["emitting_hits"] = int(emit.sum())
        if n_up:
            atomics["srf"] = tally(torch.cat(keys), torch.cat(oks), det.n_cols * det.n, n_up)
        for name, warp in (("lane_order", warp_lane), ("compacted", warp_comp)):
            out[f"loop_{name}"] = lane_use(emit, warp, lambda n: torch.full_like(n, n_up),
                                           n_up) if n_up else None
        out["loop_dealt"] = lane_use(emit, warp_comp, lambda n: -(-(n * n_up) // 32),
                                     n_up) if n_up else None
        if marching:
            out["queue"] = _surface_queue(exited, emit, mc["lane_steps"], tiles)
            out["loop_queue"] = out["queue"]["lane_use"]
    out["atomics"] = atomics
    return out


def fused_block_reference(spec: EventSpec, pro: PrologueSpec, state: LaneState,
                          buf: BlockBuffers, key: PhiloxKey, source: PhotonSource,
                          kb: int) -> None:
    """Plain PyTorch version of one whole block of the trace loop: the loop's
    end condition as seen at entry, then renormalize, flush, refill (while
    the batch has more photons than lanes), the K events of
    ``event_block_reference`` and, over a reflecting surface, the surface
    stage (``resolve_surface``: the block's exits and the bounce of its
    bottom hits, before the next block's dead counts are taken, so that its
    FIFO rank sees a revived lane alive), all in place on ``state`` and
    ``buf``.  A fused-k plan flushes with each lane's k weight and refills
    per k (``refill_fused``), its budget spent when every k's is."""
    ctl = buf.ctl
    fused = spec.fused
    launched = (ctl[LAUNCHED_K + (kb & 1)::2] if fused else ctl[kb & 1]).clone()
    spent = (launched >= spec.fk.quota).all() if fused else launched >= pro.n_photons
    none_alive = ~state.i[ALIVE].any()
    ctl[SPENT] = torch.where(spent & (ctl[SPENT] < 0), kb, ctl[SPENT])
    ctl[DONE] = torch.where(spent & none_alive & (ctl[DONE] < 0), kb, ctl[DONE])
    renormalize(state)
    if fused:
        flush(pro, buf.columns, buf.vol, state, lane_constants(spec)["kw"])
        ctl[LAUNCHED_K + ((kb + 1) & 1)::2] = refill_fused(spec, pro, state, launched, key,
                                                           source, kb)
    else:
        flush(pro, buf.columns, buf.vol, state)
        if pro.n_photons > state.n_lanes:
            launched = refill(spec, pro, state, launched, key, source, kb)
        ctl[(kb + 1) & 1] = launched
    u = philox_uniforms(key, kb, spec.K, spec.n_draws, state.n_lanes, state.f.device)
    event_block_reference(spec, state, u, buf.acc)
    if spec.reflecting:
        resolve_surface(spec, pro, state, buf,
                        *surface_uniforms(spec, key, kb, state.n_lanes, state.f.device))
    buf.dead[(kb + 1) & 1] = cta_dead_counts(state.i[ALIVE])


@functools.lru_cache(maxsize=64)
def source_constants(source: PhotonSource, device: torch.device) -> dict:
    """The kernel's SourceParams fields for a source: how each coordinate of
    ``PhotonSource.sample`` arises, with every constant as the float32 the
    plain version computes on ``device`` (one sampled lane gives the
    constant height and, for a fixed (mu, phi), the direction cosines, by
    the plain version's own operations)."""
    one = source.sample(PhiloxKey(0, 0), 1, device)
    internal = source.kind in ("internal_flux", "internal_intensity")
    fixed_xy = internal or source.kind == "spotlight"
    mu_mode = {"flux_weighted": 1,
               "internal_flux": 2 if source.detector_points_up else 3}.get(source.kind, 0)
    phi_random = source.kind in ("random_azimuth", "flux_weighted", "internal_flux")
    dirs = [float(v[0]) for v in make_direction_cosines(one.mu, one.phi)]
    return dict(
        uniform_xy=int(not fixed_xy), mu_mode=mu_mode, phi_random=int(phi_random),
        px=f32(source.detector_x if internal else source.solar_x),
        py=f32(source.detector_y if internal else source.solar_y), pz=float(one.z[0]),
        delta_x=f32(source.delta_x) if internal else 0.0,
        delta_y=f32(source.delta_y) if internal else 0.0,
        mu=float(one.mu[0]) if mu_mode == 0 else 0.0, min_mu=_MIN_MU, two_pi=f32(_TWO_PI),
        dir=dirs if not phi_random else [0.0, 0.0, 0.0])


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
        (n, ctypes.c_float * (MAX_SEGMENTS + 1)) for n in ("g_lo", "g_hi", "g_v")] + [
        ("march_steps", ctypes.c_int), ("march_ty", ctypes.c_int),
        ("march_xy", ctypes.c_uint32)] + [
        (n, ctypes.c_float * MAX_DETECTORS) for n in ("inv_dxd", "inv_dyd")]


class _SourceParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("uniform_xy", "mu_mode", "phi_random")] + [
        (n, ctypes.c_float) for n in ("px", "py", "pz", "delta_x", "delta_y", "mu",
                                      "min_mu", "two_pi")] + [
        ("dir", ctypes.c_float * 3)] + [
        (n, ctypes.c_float) for n in ("x0", "wx", "y0", "wy", "z0", "wz")]


class _Prologue(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("on", "n_kinds", "col_y", "vol_on", "n_z")] + [
        ("inv_dz_cell", ctypes.c_float), ("n_photons", ctypes.c_longlong)] + [
        (n, ctypes.c_void_p) for n in ("columns", "vol", "ctl", "dead")] + [
        ("src", _SourceParams)]


class _SurfaceParams(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("iw", ctypes.c_int), ("albedo", ctypes.c_float),
                ("params", ctypes.c_float * MAX_BRDF_PARAMS),
                ("det_phi", ctypes.c_float * MAX_DETECTORS),
                ("w", ctypes.c_void_p), ("acc", ctypes.c_void_p)]


class _FusedK(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("tab", "w", "gtop", "quota", "cta0", "cta_k")] + [
        ("n_k", ctypes.c_int), ("n_z", ctypes.c_int), ("dz", ctypes.c_float),
        ("inv_dz", ctypes.c_float), ("exact_layer", ctypes.c_int)]


class _EventParams(ctypes.Structure):
    _fields_ = [("fx", _StepChain), ("fy", _StepChain), ("fz", _StepChain)] + [
        (n, ctypes.c_float) for n in ("x0", "y0", "z0", "x_max", "y_max", "z_max",
                                      "wx", "wy", "nudge_x", "nudge_y", "nudge_z",
                                      "g", "ssa")] + [
        ("max_events", ctypes.c_int), ("key0", ctypes.c_uint32),
        ("key1", ctypes.c_uint32), ("kb", ctypes.c_uint32), ("n_lanes", ctypes.c_int),
        ("K", ctypes.c_int),
        ("det", _DetParams), ("gz", _StepChain), ("n_x", ctypes.c_int),
        ("n_y", ctypes.c_int)] + [
        (n, ctypes.c_float) for n in ("inv_dx", "inv_dy", "dx", "dy")] + [
        ("pro", _Prologue), ("srf", _SurfaceParams)] + [
        (n, ctypes.c_void_p) for n in ("cubic", "fwd", "pf_row")] + [
        ("n_seg", ctypes.c_int), ("n_fwd", ctypes.c_int), ("fwd_scale", ctypes.c_float),
        ("fk", _FusedK), ("rays", ctypes.c_void_p), ("ray_use", ctypes.c_void_p),
        ("chain", ctypes.c_int)]


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
              "n_y", "col_y", "zeta", "zeta_pi", "march_steps", "march_ty"):
        setattr(q, n, getattr(det, n))
    if det.march_steps:
        q.march_xy = sum((int(ux) << d) | (int(uy) << (16 + d))
                         for d, (ux, uy) in enumerate(zip(det.use_x, det.use_y)))
        q.inv_dxd[:det.n] = list(det.inv_dxd)
        q.inv_dyd[:det.n] = list(det.inv_dyd)
    return q


@functools.lru_cache(maxsize=None)
def build():
    """Compile (or reuse) the kernel library and declare its C interface: the
    event block in its ten sources and the column-read probe
    (``kernels/column_probe.py``), eleven ``nvcc`` processes in parallel."""
    from i3rc_tpu_torch.kernels.build import build as _build

    built = _build("fast_event_block", SOURCES)
    declare(built.lib)
    return built


# The event block's sources, compiled in parallel (the column-read probe too).
SOURCES = ("fast_event_block.cu", "fast_event_block_gas.cu", "fast_event_block_tab.cu",
           "fast_event_block_tab_gas.cu", "fast_event_block_fk.cu", "fast_event_block_tab_fk.cu",
           "fast_event_block_col.cu", "fast_event_block_march.cu",
           "fast_event_block_tab_march.cu", "fast_event_block_deep.cu", "column_read_probe.cu")


def declare(lib, prefix: bool = False) -> None:
    """Declare the library's C interface.  Its EventParams must be this
    module's, or with ``prefix`` (another commit's build, for A/B timing) a
    prefix of it: fields are only ever appended."""
    vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    for fn in (lib.i3rc_event_params_size, lib.i3rc_cta_threads):
        fn.argtypes = []
        fn.restype = ci
    lib.i3rc_fast_event_block.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
    lib.i3rc_fast_event_block.restype = ci
    lib.i3rc_philox_uniforms.argtypes = [vp, cu, cu, cu, cu, ci, ci, vp]
    lib.i3rc_philox_uniforms.restype = ci
    lib.i3rc_philox_bits.argtypes = [vp, cu, cu, cu, cu, cu, ci, vp]
    lib.i3rc_philox_bits.restype = ci
    lib.i3rc_brdf_reflectance.argtypes = [vp, vp, vp, vp, vp, ci, vp, vp]
    lib.i3rc_brdf_reflectance.restype = ci
    lib.i3rc_column_read_probe.argtypes = [vp, vp, vp, vp, ci, cu, cu, cu, vp]
    lib.i3rc_column_read_probe.restype = ci
    if hasattr(lib, "i3rc_surface_march_runs"):      # another commit's build may lack it
        lib.i3rc_surface_march_runs.argtypes = [ci, ci, ci, vp]
        lib.i3rc_surface_march_runs.restype = ci
    size = lib.i3rc_event_params_size()
    if size != ctypes.sizeof(_EventParams) and not (prefix and size < ctypes.sizeof(_EventParams)):
        raise RuntimeError("EventParams layout differs between Python and CUDA")
    if lib.i3rc_cta_threads() != CTA_THREADS:
        raise RuntimeError("CTA_THREADS differs between Python and CUDA")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def launch_refusal(spec: EventSpec) -> str | None:
    """Why the CUDA kernel does not run ``spec``, or None when it does: a
    pure function of the spec, so that the planner refuses on every device
    exactly what the card would (``fastpath.event_spec`` raises it)."""
    det = spec.det
    if spec.K < 1:
        return f"the event block needs K >= 1 events per launch; got K={spec.K}"
    if spec.chain < 0:
        return f"the event block needs a collision-chain depth >= 0; got {spec.chain}"
    if det is not None and det.n > MAX_DETECTORS:
        return (f"the event block's parameter block holds {MAX_DETECTORS} detectors; got "
                f"{det.n} (the planner gives such plans to the general kernel)")
    if det is not None and spec.chain:
        return f"the event block runs detectors at chain depth 0; got chain {spec.chain}"
    if det is not None and det.march_steps and spec.gas:
        return "the marching shadow trace runs without the gas channel"
    if spec.weighted and len(spec.surface.params) > MAX_BRDF_PARAMS:
        return f"the event block holds {MAX_BRDF_PARAMS} BRDF parameters"
    if spec.col and (det is not None or spec.gas or not spec.track_y):
        return ("the event block runs column media for flux without the gas channel, "
                "y tracked")
    if spec.table and ((det is not None) != (spec.fwd is not None)
                       or spec.col != (spec.pf_row is not None)):
        return ("a table plan carries the forward fit exactly with detectors and the "
                "entry rows exactly in column media")
    if spec.fused and (not spec.gas or spec.col or spec.chain):
        return "the event block runs fused-k plans with the gas channel at chain depth 0"
    return None


def _need(t, device, dtype, shape, what: str) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"event_block: {what} must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on the state's device")


def _launch(spec: EventSpec, state: LaneState, key: PhiloxKey, kb: int, acc,
            pro: PrologueSpec | None = None, buf: BlockBuffers | None = None,
            source: PhotonSource | None = None) -> None:
    """Check the arguments and launch the kernel: the K events alone, or with
    ``pro``, ``buf`` and ``source`` the whole block."""
    f, i = state.f, state.i
    L = state.n_lanes
    rows = 9 if spec.fused else 8
    if f.device != i.device or i.device.type != "cuda":
        raise ValueError("event_block: state tensors must share one CUDA device")
    if f.dtype != torch.float32 or i.dtype != torch.int32:
        raise TypeError("event_block: state must be float32 (f) and int32 (i)")
    if f.shape != (rows, L) or i.shape != (5, L) or not (f.is_contiguous()
                                                         and i.is_contiguous()):
        raise ValueError(f"event_block: state must be contiguous ({rows}, L) and (5, L)")
    why = launch_refusal(spec)
    if why:
        raise NotImplementedError(why)
    det = spec.det
    col = spec.column
    if col is not None:
        _need(col, f.device, torch.float32, (spec.n_x * spec.n_y, 4), "the column table")
    if spec.table:
        _need(spec.cubic, f.device, torch.float32, (spec.cubic.shape[0], 4), "the cubic table")
        if spec.cubic.shape[0] % spec.n_seg:
            raise ValueError("event_block: the cubic table holds whole entries of n_seg rows")
    if spec.pf_row is not None:
        _need(spec.pf_row, f.device, torch.int32, (spec.n_x * spec.n_y,), "pf_row")
    if spec.fwd is not None:
        _need(spec.fwd, f.device, torch.float32, (spec.fwd.shape[0], 4), "the forward table")
    if spec.fused:
        fk = spec.fk
        if fk.lanes != L:
            raise ValueError("event_block: the fused-k partition is for another lane count")
        for t, dtype, shape, what in (
                (fk.table, torch.float32, (fk.n_k * fk.n_z, 2), "the fused-k table"),
                (fk.weight, torch.float32, (fk.n_k,), "the fused-k weights"),
                (fk.gtop, torch.float32, (fk.n_k,), "the fused-k Gz(z_max)"),
                (fk.quota, torch.int64, (fk.n_k,), "the fused-k quotas"),
                (fk.cta0, torch.int32, (fk.n_k + 1,), "the fused-k blocks"),
                (fk.cta_k, torch.int32, (-(-L // CTA_THREADS),), "the fused-k CTA map")):
            _need(t, f.device, dtype, shape, what)
    if det is not None:
        _need(acc, f.device, torch.float64, (det.n_cols, det.n), "acc")
    if (state.w is not None) != spec.weighted:
        raise ValueError("event_block: the state carries a lane weight exactly on a BRDF plan")
    if state.w is not None:
        _need(state.w, f.device, torch.float32, (L,), "the lane weight")
    # The parameter block is built once per trace (the same buffers, key and
    # plan objects); later blocks change its block index only.
    w_ptr = state.w.data_ptr() if state.w is not None else None
    tag = (key, L, w_ptr, spec, pro, source)
    cached = getattr(buf, "_params", None)
    if cached is not None and cached[0][:3] == tag[:3] and all(
            a is b for a, b in zip(cached[0][3:], tag[3:])):
        p = cached[1]
        p.kb = kb & 0xFFFFFFFF
    else:
        p = event_params(spec, key, kb, L)
        p.srf.w = w_ptr
        if buf is not None:
            _need(buf.columns, f.device, torch.float64, (pro.n_cols, pro.n_kinds), "columns")
            _need(buf.vol, f.device, torch.float64,
                  (pro.n_cols * pro.n_z if pro.vol_tally else 0,), "vol")
            _need(buf.ctl, f.device, torch.int64,
                  (4 + 2 * spec.fk.n_k if spec.fused else 4,), "ctl")
            _need(buf.dead, f.device, torch.int32, (2, -(-L // CTA_THREADS)), "dead")
            if (spec.n_x, spec.n_y) != (pro.n_x, pro.n_y):
                raise ValueError("event_block: the prologue's grid differs from the spec's")
            p.pro = _prologue_params(pro, buf, source_constants(source, f.device))
            if buf.srf is not None:
                _need(buf.srf, f.device, torch.float64, (det.n_cols, det.n), "srf")
                p.srf.acc = buf.srf.data_ptr()
            buf._params = (tag, p)
    if det is not None and det.march_steps:
        p.rays = march_queue(f.device, L, spec.K).data_ptr()
        p.ray_use = march_ray_use(f.device).data_ptr()
    lib = build().lib
    with torch.cuda.device(f.device):
        rc = lib.i3rc_fast_event_block(
            f.data_ptr(), i.data_ptr(), acc.data_ptr() if det is not None else None,
            col.data_ptr() if col is not None else None,
            ctypes.byref(p), spec.chain, int(spec.absorbing), int(spec.track_y),
            int(det is not None), int(det is not None and det.iwabuchi), int(spec.gas),
            _stream(f.device))
    _check(rc, "fast_event_block launch")


def _prologue_params(pro: PrologueSpec, buf: BlockBuffers, src: dict) -> _Prologue:
    q = _Prologue()
    q.on, q.n_kinds, q.col_y = 1, pro.n_kinds, int(pro.col_y)
    q.vol_on, q.n_z, q.inv_dz_cell = int(pro.vol_tally), pro.n_z, pro.inv_dz_cell
    q.n_photons = pro.n_photons
    q.columns, q.ctl, q.dead = buf.columns.data_ptr(), buf.ctl.data_ptr(), buf.dead.data_ptr()
    q.vol = buf.vol.data_ptr() if pro.vol_tally else None
    s = q.src
    for n, v in src.items():
        if n == "dir":
            s.dir[:] = v
        else:
            setattr(s, n, v)
    # launch_state's and refill's scaling: f32(lo) + u * f32(hi - lo).
    s.x0, s.wx = pro.x0, pro.x_max - pro.x0
    s.y0, s.wy = pro.y0, pro.y_max - pro.y0
    s.z0, s.wz = pro.z0, pro.z_max - pro.z0
    return q


def event_params(spec: EventSpec, key: PhiloxKey, kb: int, n_lanes: int) -> _EventParams:
    """The kernel's by-value parameter block for one launch (prologue off)."""
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
    p.K = spec.K
    p.chain = spec.chain
    if spec.det is not None:
        p.det = _det_params(spec.det)
    if spec.gas:
        p.gz = _step_chain(spec.gz, spec.inv_gz)
    if spec.reflecting:
        law, q = spec.surface, p.srf
        q.kind, q.albedo = law.kind, law.albedo
        q.iw = int(spec.det is not None and spec.det.iwabuchi)
        q.params[:len(law.params)] = list(law.params)
        q.det_phi[:len(law.det_phi)] = list(law.det_phi)
    p.n_x, p.n_y = spec.n_x, spec.n_y
    for n in ("inv_dx", "inv_dy", "dx", "dy"):
        setattr(p, n, getattr(spec, n))
    if spec.table:
        p.cubic, p.n_seg = spec.cubic.data_ptr(), spec.n_seg
    if spec.pf_row is not None:
        p.pf_row = spec.pf_row.data_ptr()
    if spec.fwd is not None:
        p.fwd, p.n_fwd, p.fwd_scale = spec.fwd.data_ptr(), spec.fwd.shape[0], spec.fwd_scale
    if spec.fused:
        fk, q = spec.fk, p.fk
        q.tab, q.w, q.gtop = fk.table.data_ptr(), fk.weight.data_ptr(), fk.gtop.data_ptr()
        q.quota, q.cta0, q.cta_k = fk.quota.data_ptr(), fk.cta0.data_ptr(), fk.cta_k.data_ptr()
        q.n_k, q.n_z, q.dz, q.inv_dz = fk.n_k, fk.n_z, fk.dz, fk.inv_dz
        q.exact_layer = int(fk.exact_layer)
    return p


def _count_launch(spec: EventSpec, surface: bool = False) -> None:
    counter = LAUNCH_COUNTERS[(spec.det is not None, spec.gas, spec.col, spec.fused,
                               spec.table, surface)]
    setattr(event_block, counter, getattr(event_block, counter) + 1)
    if spec.chain not in CHAIN_TEMPLATED:
        # The runtime-depth variant, also counted in its variant's counter.
        setattr(event_block, DEEP_PREFIX + counter,
                getattr(event_block, DEEP_PREFIX + counter) + 1)
    if spec.det is not None and spec.det.march_steps:
        counter = MARCH_COUNTERS[surface]
        setattr(event_block, counter, getattr(event_block, counter) + 1)


def event_block(spec: EventSpec, state: LaneState, key: PhiloxKey, kb: int,
                acc=None) -> None:
    """Advance every lane K events, in place, with the draws of block ``kb``.

    With detectors (``spec.det``) their contributions are added to ``acc``,
    a float64 (n_cols, D) tensor on the state's device.  CUDA tensors launch
    the kernel, counted per variant in ``event_block.launches`` (flux),
    ``detector_launches`` (detectors), ``gas_launches`` (flux with the gas
    channel), ``gas_detector_launches`` (detectors with the gas channel) and
    ``column_launches`` (flux in column media), a fused-k plan's in
    ``fused_k_launches`` and ``fused_k_detector_launches``, and a table
    plan's in the same names prefixed ``table_`` (``table_launches``, ...,
    ``table_fused_k_detector_launches``), and at a chain depth past 3 (the
    runtime-depth variant) in the same name prefixed ``deep_`` as well
    (``deep_launches``, ``deep_gas_launches``, ``deep_column_launches``,
    ``deep_table_launches``, ...); CPU tensors run the plain twin on
    ``philox_uniforms`` draws.  The K events carry no surface bounce
    (that is a stage of the whole block); a BRDF plan's lane weight
    ``state.w`` scales the detector contributions.
    """
    if (spec.det is None) != (acc is None):
        raise ValueError("event_block: acc is given exactly when the spec has detectors")
    device = state.f.device
    if device.type == "cuda":
        _launch(spec, state, key, kb, acc)
        _count_launch(spec)
    elif device.type == "cpu":
        u = philox_uniforms(key, kb, spec.K, spec.n_draws, state.n_lanes, device)
        event_block_reference(spec, state, u, acc)
    else:
        raise NotImplementedError(f"event_block: no kernel for device {device}")


def fused_block(spec: EventSpec, pro: PrologueSpec, state: LaneState, buf: BlockBuffers,
                key: PhiloxKey, source: PhotonSource, kb: int) -> None:
    """One whole block ``kb`` of the trace loop, in place on ``state`` and
    ``buf``: renormalize, flush, refill, K events, and the loop's control
    state (``BlockBuffers``), and over a reflecting surface the bounce of
    the lanes that hit the bottom.  On CUDA tensors this is one launch of
    the kernel, counted as ``event_block`` counts its launches (over a
    reflecting surface in the ``*surface_launches`` counter of the
    variant, e.g. ``surface_launches``, ``detector_surface_launches``), and
    nothing else; CPU tensors run ``fused_block_reference``."""
    if (spec.det is None) != (buf.acc is None):
        raise ValueError("fused_block: buf.acc is given exactly when the spec has detectors")
    if (buf.srf is not None) != (spec.det is not None and spec.reflecting):
        raise ValueError("fused_block: buf.srf is given exactly for detectors over a "
                         "reflecting surface")
    device = state.f.device
    if device.type == "cuda":
        _launch(spec, state, key, kb, buf.acc, pro, buf, source)
        _count_launch(spec, spec.reflecting)
    elif device.type == "cpu":
        fused_block_reference(spec, pro, state, buf, key, source, kb)
    else:
        raise NotImplementedError(f"fused_block: no kernel for device {device}")


# The launch counter of each kernel variant, by (detectors, gas, column,
# fused-k, table, the whole block over a reflecting surface).
_COUNTERS = {(False, False, False, False): "launches",
             (True, False, False, False): "detector_launches",
             (False, True, False, False): "gas_launches",
             (True, True, False, False): "gas_detector_launches",
             (False, False, True, False): "column_launches",
             (False, True, False, True): "fused_k_launches",
             (True, True, False, True): "fused_k_detector_launches"}
LAUNCH_COUNTERS = {
    k + (tab, srf): ("table_" if tab else "")
    + (name.replace("launches", "surface_launches") if srf else name)
    for k, name in _COUNTERS.items() for tab in (False, True) for srf in (False, True)}
# The launches of a plan with the marching shadow trace (HG or table), also
# counted in their variant's counter above: the block without and with the
# surface stage.
MARCH_COUNTERS = {False: "march_launches", True: "march_surface_launches"}
# The launches of a plan at a chain depth past CHAIN_TEMPLATED (the
# runtime-depth variant), also counted in their variant's counter: its name
# prefixed (deep_launches, deep_gas_launches, deep_column_launches, ...).
DEEP_PREFIX = "deep_"


# K3-M's ray queues and the counts of its ray loop and of the marching
# surface stage's, per device.
MARCH_REC_F4 = 2                   # float4 words a queued record (csrc MARCH_REC_F4)
MARCH_USE = ("rays", "steps", "slots", "flushes",      # csrc MARCH_USE_*
             "surface_rays", "surface_steps", "surface_slots", "surface_runs")  # SRF_USE_*
_MARCH_QUEUES: dict = {}
_MARCH_USE: dict = {}


def march_queue(device, n_lanes: int, K: int) -> torch.Tensor:
    """The device scratch of K3-M's ray queues (``EventParams.rays``): a
    record of ``MARCH_REC_F4`` float4 words at every event of every lane,
    CTA by CTA.  Made at the first launch that needs it and kept per device;
    its contents do not outlive a launch."""
    n = -(-n_lanes // CTA_THREADS) * CTA_THREADS * K * MARCH_REC_F4 * 4
    t = _MARCH_QUEUES.get(device)
    if t is None or t.numel() < n:
        t = _MARCH_QUEUES[device] = torch.empty(n, dtype=torch.float32, device=device)
    return t


def march_ray_use(device) -> torch.Tensor:
    """int64 (8,) on ``device``: K3-M's ray loop since
    ``reset_launch_counters``, as ``MARCH_USE`` names its entries: the rays
    traced, their segment steps, the thread slots of the warps' trips (32 a
    trip of a warp holding a ray; steps / slots is the loop's lane use) and
    the flushes (one a CTA that queued a record); then the same of the
    marching surface stage's ray loop (``surface_*``: its rays, steps and
    slots, and the runs of tiles its CTAs took); a diagnostic of the card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _MARCH_USE:
        with torch.inference_mode(False):
            _MARCH_USE[dev] = torch.zeros(len(MARCH_USE), dtype=torch.int64, device=dev)
    return _MARCH_USE[dev]


def surface_march_runs(pro: PrologueSpec, spec: EventSpec, n_lanes: int, device) -> dict:
    """The marching surface stage's launch shape on the card ``device`` for
    ``n_lanes`` lanes: ``tiles`` (T, the 256-lane tiles of a CTA's run),
    ``runs`` (its CTAs) and ``wave`` (the CTAs of one wave at the kernel's
    occupancy with this plan's shared histograms)."""
    det = spec.det
    n_fbins = pro.n_kinds * pro.n_x * (pro.n_y if pro.col_y else 1)
    n_rbins = det.n_cols * det.n if det is not None and spec.reflecting else -1
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(torch.device(device)):
        _check(build().lib.i3rc_surface_march_runs(n_lanes, n_fbins, n_rbins, out),
               "surface_march_runs")
    return {"tiles": out[0], "runs": out[1], "wave": out[2]}


def reset_launch_counters() -> None:
    for name in (*LAUNCH_COUNTERS.values(), *MARCH_COUNTERS.values(),
                 *(DEEP_PREFIX + n for n in LAUNCH_COUNTERS.values())):
        setattr(event_block, name, 0)
    for t in _MARCH_USE.values():
        t.zero_()


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


def kernel_brdf_reflectance(law: SurfaceLaw, mu_in, mu_out, phi_in, phi_out) -> torch.Tensor:
    """R of a BRDF surface law at each element of four float32 CUDA tensors
    of one shape, through the kernel's own BRDF (the test entry of the
    library, for checks against core/surface.py)."""
    q = _SurfaceParams()
    q.kind = law.kind
    q.params[:len(law.params)] = list(law.params)
    args = [t.contiguous() for t in (mu_in, mu_out, phi_in, phi_out)]
    out = torch.empty_like(args[0])
    with torch.cuda.device(out.device):
        rc = build().lib.i3rc_brdf_reflectance(out.data_ptr(), *(t.data_ptr() for t in args),
                                               out.numel(), ctypes.byref(q),
                                               _stream(out.device))
    _check(rc, "brdf_reflectance launch")
    return out


def kernel_philox_bits(k0: int, k1: int, c1: int, c2: int, c3: int, n_lanes: int,
                       device) -> torch.Tensor:
    """(n_lanes, 4) raw Philox4x32-10 words at counter (lane, c1, c2, c3)."""
    out = torch.empty((n_lanes, 4), dtype=torch.int32, device=device)
    with torch.cuda.device(out.device):
        rc = build().lib.i3rc_philox_bits(out.data_ptr(), k0, k1, c1, c2, c3, n_lanes,
                                          _stream(out.device))
    _check(rc, "philox_bits launch")
    return out.to(torch.int64) & 0xFFFFFFFF
