"""Transport primitives shared by the port's kernels.

The subset of ``i3rc_tpu/integrators/wavefront.py`` that the fastpath
needs: the raw tally record, the direction helpers, and the surface and
intensity specs that the planner reads.  The general wavefront kernel
itself is not ported yet (ROADMAP Queue 1 item 16).

Float32 arithmetic follows the JAX functions operation by operation (same
order, same constants rounded to float32), so the port and the reference
agree to a few ulps on identical inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


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
