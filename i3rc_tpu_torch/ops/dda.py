"""Grid geometry and the voxel traversal (DDA) of the general transport kernel.

Port of ``i3rc_tpu/ops/dda.py``: ``GridGeometry`` with its cell location
and periodic wrap, and the Amanatides-Woo crossing stepper
(``make_crossing_stepper``) and ``trace_extinction`` as torch functions on
(L,) lane tensors, a masked loop over crossings.  They are the plain
version of the DDA that the CUDA general event block
(``csrc/general_event_block.cuh``) runs per thread; the rules are the
reference's, operation by operation:

  * faces by arithmetic on a regular grid (x0 + (i + side) * dx, as
    ``locate_*``'s floor division bins), from the edge arrays otherwise;
  * an axis crosses when it attains the minimum step or lands within
    2 * spacing of its face (the near-corner guard, spacing = 2^-23 *
    max(|x|, 1e-20));
  * periodic x/y by exact edge reassignment; exits through the top or the
    bottom end the trace;
  * a non-positive step is BAD, and so is running out of the crossing
    budget.

Divisions by a grid constant are tensor-by-tensor (torch turns a division
by a Python scalar into a multiply by its reciprocal), so the float32
arithmetic is the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Lane status after a trace (ops/dda.py:28-32 of the JAX package).
TRACING = 0   # still going (internal only)
SCATTER = 1   # reached the target optical depth inside the domain
EXIT_TOP = 2  # left through the top boundary
EXIT_BOT = 3  # left through the bottom boundary
BAD = 4       # geometry error or crossing budget exceeded

EPS = float(np.float32(1.1920929e-7))   # 2**-23: float32 ulp scale of spacing()
HUGE = float(np.float32(3.0e38))
DIR_EPS = float(np.float32(2e-30))      # |u| below this: parallel to the faces
EXT_EPS = float(np.float32(1e-30))


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c for a float32 constant c, as a true division."""
    return a / torch.full_like(a, c)


def fmod_positive(a: torch.Tensor, b: float) -> torch.Tensor:
    """jnp.mod(a, b) for b > 0: the truncated remainder, moved into [0, b)."""
    m = torch.fmod(a, torch.full_like(a, b))
    return torch.where((m != 0.0) & (m < 0.0), m + b, m)


@dataclass(frozen=True)
class GridGeometry:
    """Static per-domain geometry: edge tensors plus host-float bounds."""

    x_edges: torch.Tensor  # (nx+1,) float32
    y_edges: torch.Tensor
    z_edges: torch.Tensor
    n_x: int
    n_y: int
    n_z: int
    x0: float
    y0: float
    z0: float
    x_max: float
    y_max: float
    z_max: float
    dx: float  # first-cell widths; exact for regular grids
    dy: float
    dz: float
    xy_regular: bool
    z_regular: bool

    @staticmethod
    def from_edges(x_edges, y_edges, z_edges, xy_regular, z_regular,
                   device="cpu") -> "GridGeometry":
        xe = np.asarray(x_edges, dtype=np.float32)
        ye = np.asarray(y_edges, dtype=np.float32)
        ze = np.asarray(z_edges, dtype=np.float32)
        t = lambda a: torch.as_tensor(a, device=device)
        return GridGeometry(
            x_edges=t(xe), y_edges=t(ye), z_edges=t(ze),
            n_x=xe.size - 1, n_y=ye.size - 1, n_z=ze.size - 1,
            x0=float(xe[0]), y0=float(ye[0]), z0=float(ze[0]),
            x_max=float(xe[-1]), y_max=float(ye[-1]), z_max=float(ze[-1]),
            dx=float(xe[1] - xe[0]), dy=float(ye[1] - ye[0]), dz=float(ze[1] - ze[0]),
            xy_regular=bool(xy_regular), z_regular=bool(z_regular),
        )

    @property
    def n_cells(self) -> int:
        return self.n_x * self.n_y * self.n_z

    # --- position -> cell index (findXYIndicies analog, :1353-1374) --------
    def _locate(self, v, lo: float, d: float, edges, n: int, regular: bool):
        if regular:
            i = torch.floor(_div(v - lo, d)).to(torch.int32)
        else:
            i = torch.searchsorted(edges, v.contiguous(), right=True).to(torch.int32) - 1
        return torch.clamp(i, 0, n - 1)

    def locate_x(self, x):
        return self._locate(x, self.x0, self.dx, self.x_edges, self.n_x, self.xy_regular)

    def locate_y(self, y):
        return self._locate(y, self.y0, self.dy, self.y_edges, self.n_y, self.xy_regular)

    def locate_z(self, z):
        return self._locate(z, self.z0, self.dz, self.z_edges, self.n_z, self.z_regular)

    def wrap_x(self, x):
        """Periodic wrap into [x0, x_max) (makePeriodic analog, :2063-2082)."""
        out = self.x0 + fmod_positive(x - self.x0, float(np.float32(self.x_max - self.x0)))
        return torch.where(out >= self.x_max, self.x0, out)

    def wrap_y(self, y):
        out = self.y0 + fmod_positive(y - self.y0, float(np.float32(self.y_max - self.y0)))
        return torch.where(out >= self.y_max, self.y0, out)


def _spacing(x):
    return EPS * torch.clamp(torch.abs(x), min=float(np.float32(1e-20)))


def make_crossing_stepper(geom: GridGeometry, total_ext_flat: torch.Tensor, ux, uy, uz):
    """One-cell-crossing step over per-lane DDA state, for fixed directions.

    Returns step(state, tau_target, active) -> state with state = (x, y, z,
    ix, iy, iz, tau, status); lanes whose status is not TRACING (or not
    active) pass through unchanged.
    """
    n_y, n_z = geom.n_y, geom.n_z
    n_flat = total_ext_flat.shape[0]
    sides = [(u >= 0).to(torch.int32) for u in (ux, uy, uz)]
    incs = [2 * s - 1 for s in sides]
    movable = [torch.abs(u) >= DIR_EPS for u in (ux, uy, uz)]
    invs = [torch.where(m, 1.0 / u, HUGE) for m, u in zip(movable, (ux, uy, uz))]

    def face(i, side, lo, d, edges, n, regular):
        if regular:
            return lo + (i + side).to(torch.float32) * d
        return edges[torch.clamp(i + side, 0, n).long()]

    def step(state, tau_target, active):
        x, y, z, ix, iy, iz, tau, status = state
        tracing = active & (status == TRACING)
        ex = face(ix, sides[0], geom.x0, geom.dx, geom.x_edges, geom.n_x, geom.xy_regular)
        ey = face(iy, sides[1], geom.y0, geom.dy, geom.y_edges, geom.n_y, geom.xy_regular)
        ez = face(iz, sides[2], geom.z0, geom.dz, geom.z_edges, geom.n_z, geom.z_regular)
        sx = torch.where(movable[0], (ex - x) * invs[0], HUGE)
        sy = torch.where(movable[1], (ey - y) * invs[1], HUGE)
        sz = torch.where(movable[2], (ez - z) * invs[2], HUGE)
        s = torch.minimum(torch.minimum(sx, sy), sz)

        bad = tracing & (s <= 0.0)  # :1711-1714
        flat = torch.clamp((ix * n_y + iy) * n_z + iz, 0, n_flat - 1)
        cell_ext = total_ext_flat[flat.long()]

        # Would this crossing overshoot the target optical depth?
        overshoot = tracing & ~bad & (tau + s * cell_ext > tau_target)
        partial = torch.where(cell_ext > 0.0,
                              (tau_target - tau) / torch.clamp(cell_ext, min=EXT_EPS), 0.0)
        full = tracing & ~bad & ~overshoot

        # Overshoot: partial step, stop inside the cell (:1721-1731).
        x = torch.where(overshoot, x + partial * ux, x)
        y = torch.where(overshoot, y + partial * uy, y)
        z = torch.where(overshoot, z + partial * uz, z)
        tau = torch.where(overshoot, tau_target, tau)
        status = torch.where(overshoot, SCATTER, status)

        # Full crossings: to the closest face, with the near-corner guard.
        new_x, new_y, new_z = x + s * ux, y + s * uy, z + s * uz
        cross_x = full & ((sx <= s) | (torch.abs(ex - new_x) <= 2.0 * _spacing(new_x)))
        cross_y = full & ((sy <= s) | (torch.abs(ey - new_y) <= 2.0 * _spacing(new_y)))
        cross_z = full & ((sz <= s) | (torch.abs(ez - new_z) <= 2.0 * _spacing(new_z)))
        x = torch.where(cross_x, ex, torch.where(full, new_x, x))
        y = torch.where(cross_y, ey, torch.where(full, new_y, y))
        z = torch.where(cross_z, ez, torch.where(full, new_z, z))
        ix = torch.where(cross_x, ix + incs[0], ix)
        iy = torch.where(cross_y, iy + incs[1], iy)
        iz = torch.where(cross_z, iz + incs[2], iz)
        tau = torch.where(full, tau + s * cell_ext, tau)

        # Periodic x/y (:1774-1788): exact edge reassignment.
        lo_x, hi_x = full & (ix < 0), full & (ix >= geom.n_x)
        ix = torch.where(lo_x, geom.n_x - 1, torch.where(hi_x, 0, ix))
        x = torch.where(lo_x, geom.x_max, torch.where(hi_x, geom.x0, x))
        lo_y, hi_y = full & (iy < 0), full & (iy >= geom.n_y)
        iy = torch.where(lo_y, geom.n_y - 1, torch.where(hi_y, 0, iy))
        y = torch.where(lo_y, geom.y_max, torch.where(hi_y, geom.y0, y))

        # Vertical exits (:1793-1804).
        out_top, out_bot = full & (iz >= geom.n_z), full & (iz < 0)
        status = torch.where(out_top, EXIT_TOP, torch.where(out_bot, EXIT_BOT, status))
        z = torch.where(out_top, geom.z_max, torch.where(out_bot, geom.z0, z))
        iz = torch.clamp(iz, 0, geom.n_z - 1)
        status = torch.where(bad, BAD, status)
        return x, y, z, ix, iy, iz, tau, status

    return step


def trace_extinction(geom: GridGeometry, total_ext_flat: torch.Tensor, x, y, z, ix, iy, iz,
                     ux, uy, uz, tau_target, active, max_crossings: int, steps=None):
    """Trace lanes until ``tau_target`` extinction is accumulated or they exit.

    Returns (x, y, z, ix, iy, iz, tau_accumulated, status): SCATTER inside a
    cell at tau_target, EXIT_TOP / EXIT_BOT on the boundary, BAD for a
    non-positive step or ``max_crossings`` crossings used up; lanes not
    ``active`` come back unchanged with status BAD, which callers ignore.
    ``steps``, an int32 lane tensor, counts each lane's steps in place.
    """
    step = make_crossing_stepper(geom, total_ext_flat, ux, uy, uz)
    status = torch.where(active, TRACING, BAD).to(torch.int32)
    state = (x, y, z, ix, iy, iz, torch.zeros_like(x), status)
    for _ in range(int(max_crossings)):
        tracing = active & (state[7] == TRACING)
        if not bool(tracing.any()):
            break
        if steps is not None:
            steps += tracing.to(torch.int32)
        state = step(state, tau_target, active)
    x, y, z, ix, iy, iz, tau, status = state
    # Lanes that exhausted the crossing budget are bad (grazing trajectories).
    status = torch.where(active & (status == TRACING), BAD, status)
    return x, y, z, ix, iy, iz, tau, status
