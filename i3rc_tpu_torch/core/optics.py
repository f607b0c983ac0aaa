# Copy of i3rc_tpu/core/optics.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""Optical-property domains: voxel grids of extinction / albedo / phase index.

Re-implements Code/opticalProperties.f95.  A Domain is a 3D cell-edge grid
plus a list of optical components (cloud, aerosol, Rayleigh, gas absorber,
...).  Each component carries extinction, single-scattering albedo, and an
index into its own PhaseFunctionTable, either fully 3D or horizontally
uniform (1D profile), possibly occupying only a vertical sub-range
(z_level_base, opticalProperties.f95:44-52).

``flatten_optics`` produces the integrator's device-ready structure-of-arrays
(total extinction, cumulative fractional extinction per component, albedo,
phase index), mirroring getOpticalPropertiesByComponent
(opticalProperties.f95:429-539) and the r == 1 edge-case padding applied in
new_Integrator (Integrators/monteCarloRadiativeTransfer.f95:226-235).

Indices are 0-based everywhere in this package; the netCDF layer converts to
and from the reference's 1-based on-file convention.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from i3rc_tpu_torch.core.phase_functions import PhaseFunctionTable
from i3rc_tpu_torch.utils.errors import Status


@dataclass(frozen=True)
class OpticalComponent:
    """One scattering/absorbing constituent of the domain.

    Mirrors type opticalComponent (opticalProperties.f95:34-52).  Arrays have
    shape (nx, ny, nz_component), or (1, 1, nz_component) when horizontally
    uniform; z_level_base locates the first component layer in the domain
    grid (0-based).
    """

    name: str
    extinction: np.ndarray
    single_scattering_albedo: np.ndarray
    phase_function_index: np.ndarray  # 0-based into table
    table: PhaseFunctionTable
    z_level_base: int = 0

    @property
    def horizontally_uniform(self) -> bool:
        return self.extinction.shape[0] == 1 and self.extinction.shape[1] == 1

    @property
    def n_layers(self) -> int:
        return self.extinction.shape[2]


@dataclass(frozen=True)
class Domain:
    """Cell-edge grid plus optical components (type domain, opticalProperties.f95:54-65)."""

    x_edges: np.ndarray
    y_edges: np.ndarray
    z_edges: np.ndarray
    components: tuple = field(default_factory=tuple)

    @staticmethod
    def create(x_edges, y_edges, z_edges) -> "Domain":
        """new_Domain analog (opticalProperties.f95:93-131) with validation."""
        x_edges = np.asarray(x_edges, dtype=np.float64)
        y_edges = np.asarray(y_edges, dtype=np.float64)
        z_edges = np.asarray(z_edges, dtype=np.float64)
        s = Status()
        for name, e in (("x", x_edges), ("y", y_edges), ("z", z_edges)):
            s.fail_if(e.ndim != 1 or e.size < 2, f"{name} edges need at least 2 points")
            if e.size >= 2:
                s.fail_if(bool(np.any(np.diff(e) <= 0.0)),
                          f"{name} edges must be increasing and unique")
        s.check("Domain.create")
        return Domain(x_edges, y_edges, z_edges)

    # --- geometry -----------------------------------------------------------
    @property
    def n_x(self) -> int:
        return self.x_edges.size - 1

    @property
    def n_y(self) -> int:
        return self.y_edges.size - 1

    @property
    def n_z(self) -> int:
        return self.z_edges.size - 1

    @property
    def grid_shape(self):
        return (self.n_x, self.n_y, self.n_z)

    def _regular(self, edges: np.ndarray) -> bool:
        # Regular-spacing detection as in new_Integrator
        # (monteCarloRadiativeTransfer.f95:193-211).
        d = np.diff(edges)
        return bool(np.all(np.abs(d - d[0]) <= 4.0 * np.spacing(np.abs(edges[1:]).astype(np.float32))))

    @property
    def xy_regularly_spaced(self) -> bool:
        return self._regular(self.x_edges) and self._regular(self.y_edges)

    @property
    def z_regularly_spaced(self) -> bool:
        return self._regular(self.z_edges)

    # --- component management ------------------------------------------------
    def _validate_component(self, name, extinction, ssa, index, table, z_level_base,
                            horizontally_uniform) -> None:
        """validateOpticalComponent analog (opticalProperties.f95:929-987)."""
        s = Status()
        nx, ny = (1, 1) if horizontally_uniform else (self.n_x, self.n_y)
        nz = extinction.shape[2]
        for label, a in (("extinction", extinction), ("singleScatteringAlbedo", ssa),
                         ("phaseFunctionIndex", index)):
            s.fail_if(a.shape != (nx, ny, nz), f"component {name}: {label} has wrong shape")
        s.fail_if(z_level_base < 0 or z_level_base + nz > self.n_z,
                  f"component {name}: z range [{z_level_base}, {z_level_base + nz}) "
                  f"outside domain ({self.n_z} layers)")
        s.fail_if(bool(np.any(extinction < 0.0)), f"component {name}: negative extinction")
        s.fail_if(bool(np.any((ssa < 0.0) | (ssa > 1.0))),
                  f"component {name}: single scattering albedo out of bounds")
        s.fail_if(bool(np.any((index < 0) | (index >= table.n_entries))),
                  f"component {name}: phase function index out of table bounds")
        s.check("Domain.add_component")

    def add_component(self, name, extinction, single_scattering_albedo,
                      phase_function_index, table, z_level_base: int = 0) -> "Domain":
        """addOpticalComponent analog (opticalProperties.f95:133-230); returns a new Domain."""
        extinction = np.asarray(extinction, dtype=np.float64)
        ssa = np.asarray(single_scattering_albedo, dtype=np.float64)
        index = np.asarray(phase_function_index, dtype=np.int32)
        uniform = extinction.ndim == 1
        if uniform:
            extinction = extinction[None, None, :]
            ssa = ssa[None, None, :]
            index = index[None, None, :]
        self._validate_component(name, extinction, ssa, index, table, z_level_base, uniform)
        comp = OpticalComponent(name, extinction, ssa, index, table, z_level_base)
        return replace(self, components=self.components + (comp,))

    def replace_component(self, position: int, name, extinction, single_scattering_albedo,
                          phase_function_index, table, z_level_base: int = 0) -> "Domain":
        """replaceOpticalComponent analog (opticalProperties.f95:232-310); 0-based position."""
        if not 0 <= position < len(self.components):
            raise IndexError(f"no component at position {position}")
        updated = self.add_component(name, extinction, single_scattering_albedo,
                                     phase_function_index, table, z_level_base)
        comps = list(updated.components[:-1])
        comps[position] = updated.components[-1]
        return replace(self, components=tuple(comps))

    def delete_component(self, position: int) -> "Domain":
        """deleteOpticalComponent analog (opticalProperties.f95:312-357); 0-based."""
        if not 0 <= position < len(self.components):
            raise IndexError(f"no component at position {position}")
        comps = self.components[:position] + self.components[position + 1:]
        return replace(self, components=comps)

    @property
    def component_names(self):
        return tuple(c.name for c in self.components)


@dataclass(frozen=True)
class FlatOptics:
    """Flattened per-cell optics, the integrator's working representation.

    Mirrors the integrator state arrays (monteCarloRadiativeTransfer.f95:78-81)
    filled by getOpticalPropertiesByComponent: cumulative fractional
    extinction lets the kernel pick the scattering component with one random
    number (opticalProperties.f95:429-539).
    """

    total_ext: np.ndarray        # (nx, ny, nz) float32
    cumulative_ext: np.ndarray   # (nx, ny, nz, n_components) float32, fractional
    ssa: np.ndarray              # (nx, ny, nz, n_components) float32
    phase_index: np.ndarray      # (nx, ny, nz, n_components) int32, 0-based
    forward_tables: tuple        # per-component PhaseFunctionTable

    @property
    def n_components(self) -> int:
        return self.cumulative_ext.shape[-1]

    @property
    def max_extinction(self) -> float:
        return float(self.total_ext.max())


def flatten_optics(domain: Domain) -> FlatOptics:
    """Expand components onto the full grid and build cumulative extinction.

    Horizontally uniform components broadcast to 3D; sub-range components are
    zero outside [z_level_base, z_level_base + n_layers).  The final
    cumulative fraction is padded above 1 wherever there is extinction so a
    uniform deviate of exactly 1.0 still selects a component
    (monteCarloRadiativeTransfer.f95:226-235).
    """
    if not domain.components:
        raise ValueError("flatten_optics: domain contains no optical components")
    nx, ny, nz = domain.grid_shape
    n_comp = len(domain.components)
    ext = np.zeros((nx, ny, nz, n_comp), dtype=np.float64)
    ssa = np.zeros((nx, ny, nz, n_comp), dtype=np.float64)
    index = np.zeros((nx, ny, nz, n_comp), dtype=np.int32)
    for i, c in enumerate(domain.components):
        z0, z1 = c.z_level_base, c.z_level_base + c.n_layers
        ext[:, :, z0:z1, i] = c.extinction
        ssa[:, :, z0:z1, i] = c.single_scattering_albedo
        index[:, :, z0:z1, i] = c.phase_function_index
    cum = np.cumsum(ext, axis=-1)
    total = cum[..., -1].copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(total[..., None] > 0.0, cum / total[..., None], 0.0)
    # Pad the last component's fraction above 1 where there is extinction.
    eps = np.spacing(np.float32(1.0))
    frac[..., -1] = np.where(total > 0.0, 1.0 + eps, 0.0)
    return FlatOptics(
        total_ext=total.astype(np.float32),
        cumulative_ext=frac.astype(np.float32),
        ssa=ssa.astype(np.float32),
        phase_index=index,
        # Polarized components (PhaseMatrixTable) downgrade to their P11
        # scalar tables here: the scalar kernels transport P11 and ignore
        # polarization, so a matrix-table domain runs unchanged on every
        # scalar path; the polarized integrator reads the matrices from
        # domain.components directly.
        forward_tables=tuple(
            c.table.scalar if hasattr(c.table, "phase_matrices") else c.table
            for c in domain.components),
    )
