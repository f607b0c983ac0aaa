# Copy of i3rc_tpu/core/k_distribution.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""Spectral k-distributions for broadband gaseous absorption.

The reference declares this capability but ships it substantially as a stub:
Code/kDistribution.f95 has a constructor/getInfo/copy (:52-167, 226-259)
while getAbsorptionProfile(s), read_ and write_ are empty shells (:169-213,
:261-277) and nothing references the module (Code/Makefile:6-8).  This
module completes it (SURVEY.md phase 9):

A KDistribution holds, for one spectral band, a set of gaseous-absorption
extinction profiles ("k points") with quadrature weights, produced by an
external correlated-k program from temperature/pressure/gas profiles.  The
band's radiative transfer is the weight-sum of monochromatic solutions, one
per k point, optionally weighted by the band's fraction of the solar
spectrum — the spectral loop implemented in integrators/spectral.py.

Layer convention: ``z_edges`` are the nz+1 layer boundaries and
``absorption_profiles`` is (nz, n_k) extinction per LAYER (the reference's
stub stored numZs values without defining level-vs-layer semantics;
layer-mean extinction is what the voxel transport consumes).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from i3rc_tpu_torch.utils.errors import Status


@dataclass(frozen=True)
class KDistribution:
    """One band's gaseous-absorption quadrature (type kDistribution analog)."""

    z_edges: np.ndarray              # (nz + 1,)
    absorption_profiles: np.ndarray  # (nz, n_k) extinction, same units as domain
    weights: np.ndarray              # (n_k,) sums to 1 within the band
    description: str = ""
    wavelength_limits: tuple = (0.0, 0.0)   # microns
    spectral_fraction: float = 1.0          # band's share of the source spectrum

    @staticmethod
    def create(z_edges, absorption_profiles, weights, description="",
               wavelength_limits=(0.0, 0.0), spectral_fraction=1.0) -> "KDistribution":
        """new_kDistribution analog (kDistribution.f95:52-101) with validation."""
        z_edges = np.asarray(z_edges, dtype=np.float64)
        profiles = np.asarray(absorption_profiles, dtype=np.float64)
        weights = np.atleast_1d(np.asarray(weights, dtype=np.float64))
        s = Status()
        s.fail_if(profiles.ndim != 2 or profiles.shape[0] != z_edges.size - 1
                  or profiles.shape[1] != weights.size,
                  "absorptionProfiles must be dimensioned (nLayers, nKs)")
        s.fail_if(bool(np.any(np.diff(z_edges) <= 0.0)),
                  "zPosition must be increasing and unique")
        s.fail_if(bool(np.any(profiles < 0.0)), "absorption must be non-negative")
        s.fail_if(bool(np.any(weights <= 0.0)), "weights must be positive")
        lim = tuple(float(v) for v in wavelength_limits)
        s.fail_if(lim != (0.0, 0.0) and (lim[0] <= 0 or lim[1] < lim[0]),
                  "wavelengthLimits must be positive and increasing")
        s.fail_if(not 0.0 < spectral_fraction <= 1.0,
                  "spectralFraction must be between 0 and 1")
        s.warn_if(abs(weights.sum() - 1.0) > 1e-3,
                  f"k-point weights sum to {weights.sum():.4f}, not 1")
        s.check("KDistribution.create")
        return KDistribution(z_edges, profiles, weights, description, lim,
                             float(spectral_fraction))

    @property
    def n_k(self) -> int:
        return self.weights.size

    @property
    def n_layers(self) -> int:
        return self.absorption_profiles.shape[0]

    def absorption_profile(self, k: int, target_z_edges=None) -> np.ndarray:
        """One k point's extinction profile (getAbsorptionProfile analog).

        With ``target_z_edges``, re-grids conserving layer optical depth
        (exact overlap integration of the piecewise-constant profile).
        """
        prof = self.absorption_profiles[:, k]
        if target_z_edges is None:
            return prof.copy()
        tz = np.asarray(target_z_edges, dtype=np.float64)
        out = np.empty(tz.size - 1)
        for i in range(tz.size - 1):
            lo, hi = tz[i], tz[i + 1]
            overlap = (np.minimum(hi, self.z_edges[1:])
                       - np.maximum(lo, self.z_edges[:-1]))
            out[i] = np.sum(prof * np.clip(overlap, 0.0, None)) / (hi - lo)
        return out

    def absorption_profiles_on(self, target_z_edges=None) -> np.ndarray:
        """All k points re-gridded: (n_target_layers, n_k) (getAbsorptionProfiles)."""
        return np.stack([self.absorption_profile(k, target_z_edges)
                         for k in range(self.n_k)], axis=1)


# ---------------------------------------------------------------------------
# netCDF persistence.  The reference's read_/write_ are empty stubs, so this
# format is ours: classic netCDF with zEdges/kPoints dims, profile/weight
# variables, and band metadata as global attributes.
# ---------------------------------------------------------------------------
def write_k_distribution(kdist: KDistribution, file_name: str) -> None:
    from scipy.io import netcdf_file

    with netcdf_file(file_name, "w") as nc:
        nc.createDimension("zEdges", kdist.z_edges.size)
        nc.createDimension("zLayers", kdist.n_layers)
        nc.createDimension("kPoints", kdist.n_k)
        nc.createVariable("zEdges", "f", ("zEdges",))[:] = kdist.z_edges.astype(np.float32)
        nc.createVariable("absorptionProfiles", "f", ("zLayers", "kPoints"))[:] = \
            kdist.absorption_profiles.astype(np.float32)
        nc.createVariable("absorptionWeights", "f", ("kPoints",))[:] = \
            kdist.weights.astype(np.float32)
        nc.description = kdist.description
        nc.wavelengthLimits = np.asarray(kdist.wavelength_limits, np.float32)
        nc.spectralFraction = np.float32(kdist.spectral_fraction)


def read_k_distribution(file_name: str) -> KDistribution:
    from scipy.io import netcdf_file

    with netcdf_file(file_name, "r", mmap=False) as nc:
        desc = getattr(nc, "description", b"")
        return KDistribution.create(
            np.array(nc.variables["zEdges"][...], dtype=np.float64),
            np.array(nc.variables["absorptionProfiles"][...], dtype=np.float64),
            np.array(nc.variables["absorptionWeights"][...], dtype=np.float64),
            description=desc.decode() if isinstance(desc, bytes) else desc,
            wavelength_limits=tuple(np.array(nc.wavelengthLimits, dtype=float)),
            spectral_fraction=float(nc.spectralFraction))
