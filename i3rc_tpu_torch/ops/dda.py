"""Grid geometry for the transport kernels.

Port of ``GridGeometry.from_edges`` from ``i3rc_tpu/ops/dda.py:43-82``.  The
voxel traversal (DDA) of that module belongs to the general kernel, which
the port does not have yet (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


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
