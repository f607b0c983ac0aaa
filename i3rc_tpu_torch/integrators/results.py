"""Results: normalized radiative quantities for one photon batch.

Port of ``i3rc_tpu/integrators/results.py:19-103``: clipped-intensity excess
redistribution, division by the average number of photons per column
(area-weighted for irregular grids) and volume absorption divided by layer
thickness (Integrators/monteCarloRadiativeTransfer.f95:327-395).  The
float64 tallies are normalized in float64 and returned as float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Results:
    """Normalized outputs; fluxes are per unit incident flux on the domain."""

    flux_up: torch.Tensor            # (nx, ny)
    flux_down: torch.Tensor          # (nx, ny)
    flux_absorbed: torch.Tensor      # (nx, ny)
    volume_absorption: torch.Tensor  # (nx, ny, nz)
    intensity: torch.Tensor          # (nx, ny, D); D may be 0
    intensity_by_component: torch.Tensor  # (nx, ny, D, ncomp+1); component 0 = surface
    n_photons: torch.Tensor
    n_bad: torch.Tensor

    # reportResults' domain means (:739-742, :796-807)
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
    def absorbed_profile(self):
        """Layer-mean absorption profile (:776-782)."""
        return torch.mean(self.volume_absorption, dim=(0, 1))

    @property
    def mean_intensity(self):
        return torch.mean(self.intensity, dim=(0, 1))


def column_weights(x_edges, y_edges) -> np.ndarray:
    """Relative area of each column, normalized to mean 1 (:358-367)."""
    dx = np.diff(np.asarray(x_edges, dtype=np.float64))
    dy = np.diff(np.asarray(y_edges, dtype=np.float64))
    area = dx[:, None] * dy[None, :]
    return (area / area.mean()).astype(np.float32)


def normalize_tallies(raw, n_x, n_y, n_z, n_dirs, n_comp,
                      col_weights: np.ndarray, dz: np.ndarray) -> Results:
    """Raw weight sums -> per-unit-flux results."""
    dev = raw.flux_up.device
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    inv_ppc = 1.0 / (raw.n_photons / (n_x * n_y) * f64(col_weights))
    out = lambda a: a.to(torch.float32)
    vol = (raw.volume_absorption.reshape(n_x, n_y, n_z) * inv_ppc[:, :, None]
           / f64(dz)[None, None, :])
    if n_dirs > 0:
        intensity = raw.intensity.reshape(n_x, n_y, n_dirs)
        by_comp = raw.intensity_by_component.reshape(n_x, n_y, n_dirs, n_comp + 1)
        excess = raw.intensity_excess.reshape(n_dirs, n_comp + 1)
        # Redistribute clipped excess proportionally to each component's
        # spatial pattern (:327-347), before normalization.
        comp_sum = by_comp.sum(dim=(0, 1))
        scale = torch.where(comp_sum > 0.0, excess / comp_sum.clamp(min=1e-30), 0.0)
        intensity = (intensity + (by_comp * scale).sum(dim=-1)) * inv_ppc[:, :, None]
        by_comp = by_comp * (1.0 + scale) * inv_ppc[:, :, None, None]
    else:
        intensity = torch.zeros((n_x, n_y, 0), dtype=torch.float64, device=dev)
        by_comp = torch.zeros((n_x, n_y, 0, n_comp + 1), dtype=torch.float64, device=dev)
    return Results(
        flux_up=out(raw.flux_up.reshape(n_x, n_y) * inv_ppc),
        flux_down=out(raw.flux_down.reshape(n_x, n_y) * inv_ppc),
        flux_absorbed=out(raw.flux_absorbed.reshape(n_x, n_y) * inv_ppc),
        volume_absorption=out(vol), intensity=out(intensity),
        intensity_by_component=out(by_comp),
        n_photons=torch.tensor(raw.n_photons, dtype=torch.int64, device=dev),
        n_bad=raw.n_bad)
