# Copy of i3rc_tpu/io/netcdf.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""netCDF artifact I/O, file-compatible with the Fortran reference.

The reference's pipeline currency is netCDF classic files: phase-function
tables (scatteringPhaseFunctions.f95:899-1252), optical-property domains
with embedded per-component prefixed tables (opticalProperties.f95:554-844),
and result files (monteCarloDriver.f95:609-854).  scipy's netcdf_file
implements the same classic (CDF-1) wire format as the reference's
nf90_create default, so files written here are readable by the Fortran
tools and vice versa.

Convention notes:
  * phase function indices are int16 and 1-based on file
    (opticalProperties.f95:624-631); in memory this package is 0-based.
  * component prefixes are "Component<N>_" with N starting at 1
    (opticalProperties.f95:1013-1016).
  * tables store either "Angle-Value" (shared angle grid) or
    "LegendreCoefficients" (concatenated with start/length vectors).
  * DIMENSION ORDER: the Fortran netCDF API lists dimensions fastest-
    varying FIRST, so a variable declared (/xDim, yDim, zDim/) in the
    reference is (z, y, x) in on-disk/CDL order.  Every multi-dimensional
    variable here is therefore created with the REVERSED dimension tuple
    and written transposed: Extinction etc. as CDL (z, y, x)
    (opticalProperties.f95:627-643), phaseFunctionValues as CDL
    (entry, angle) (scatteringPhaseFunctions.f95:1023-1024).  Round-trip
    tests alone cannot catch this (a consistent transpose is self-
    inverse); the frozen goldens in tests/goldens pin the true layout.
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

from i3rc_tpu_torch.core.optics import Domain
from i3rc_tpu_torch.core.phase_functions import PhaseFunction, PhaseFunctionTable
from i3rc_tpu_torch.utils.errors import ValidationError


def _att(nc, name, default=None):
    v = getattr(nc, name, default)
    if isinstance(v, bytes):
        return v.decode()
    if isinstance(v, np.ndarray) and v.size == 1:
        return v.item()
    return v


def _var(nc, name):
    return np.array(nc.variables[name][...])


# ---------------------------------------------------------------------------
# Phase function tables
# ---------------------------------------------------------------------------
def _add_phase_matrix_table(nc, table, prefix: str) -> None:
    """Write a PhaseMatrixTable: the P11 scalar table in the reference's
    exact Angle-Value layout PLUS one extra variable holding the other
    five matrix elements.

    BACKWARD COMPATIBLE by construction: a Fortran reader
    (read_PhaseFunctionTable, scatteringPhaseFunctions.f95:1129-1252) sees
    a normal Angle-Value table (the P11 element) and ignores the extra
    ``phaseMatrixElements`` variable; only this package's reader (and any
    future polarized Fortran — Wishlist.txt:20-31) reconstructs the
    matrices.  Elements share P11's absolute scale; CDL order
    (entry, element, angle) with elements ordered (b1, a2, a3, a4, b2).
    """
    angles0 = table.phase_matrices[0].scattering_angle
    if not all(np.array_equal(m.scattering_angle, angles0)
               for m in table.phase_matrices):
        raise ValidationError(
            "add_phase_function_table: phase matrices in one table must "
            "share an angle grid to be written")
    add_phase_function_table(nc, table.scalar, prefix=prefix)
    nc.createDimension(prefix + "matrixElement", 5)
    mv = nc.createVariable(prefix + "phaseMatrixElements", "f",
                           (prefix + "phaseFunctionNumber",
                            prefix + "matrixElement",
                            prefix + "scatteringAngle"))
    mv[:] = np.stack([np.stack([m.b1, m.a2, m.a3, m.a4, m.b2])
                      for m in table.phase_matrices]).astype(np.float32)
    setattr(nc, prefix + "phaseMatrixStorageType", "PhaseMatrix")


def add_phase_function_table(nc, table, prefix: str = "") -> None:
    """Write a table into an open netcdf_file (add_PhaseFunctionTable analog).

    Accepts a PhaseFunctionTable or (polarized extension) a
    PhaseMatrixTable — the latter lands as P11 in the reference layout
    plus a phaseMatrixElements variable (see _add_phase_matrix_table).
    """
    if hasattr(table, "phase_matrices"):
        _add_phase_matrix_table(nc, table, prefix)
        return
    n_entries = table.n_entries
    stored_legendre = all(p.stored_as_legendre for p in table.phase_functions)
    one_angle_set = (not stored_legendre) and all(
        p.stored_as_tabulated
        and p.scattering_angle.shape == table.phase_functions[0].scattering_angle.shape
        and np.array_equal(p.scattering_angle, table.phase_functions[0].scattering_angle)
        for p in table.phase_functions)
    if not (stored_legendre or one_angle_set):
        raise ValidationError(
            "add_phase_function_table: can't write general phase function tables "
            "(entries must share one angle grid or all be Legendre)")

    nc.createDimension(prefix + "phaseFunctionNumber", n_entries)
    dim_e = (prefix + "phaseFunctionNumber",)
    key_v = nc.createVariable(prefix + "phaseFunctionKeyT", "f", dim_e)
    ext_v = nc.createVariable(prefix + "extinctionT", "f", dim_e)
    ssa_v = nc.createVariable(prefix + "singleScatteringAlbedoT", "f", dim_e)
    key_v[:] = table.key.astype(np.float32)
    ext_v[:] = table.extinctions.astype(np.float32)
    ssa_v[:] = table.single_scattering_albedos.astype(np.float32)
    if table.description:
        setattr(nc, prefix + "description", table.description)

    if one_angle_set:
        angles = table.phase_functions[0].scattering_angle
        nc.createDimension(prefix + "scatteringAngle", angles.size)
        ang_v = nc.createVariable(prefix + "scatteringAngle", "f",
                                  (prefix + "scatteringAngle",))
        ang_v[:] = angles.astype(np.float32)
        # CDL (entry, angle) == the reference's Fortran (/angle, entry/)
        # declaration (scatteringPhaseFunctions.f95:1023-1024).
        val_v = nc.createVariable(prefix + "phaseFunctionValues", "f",
                                  (prefix + "phaseFunctionNumber",
                                   prefix + "scatteringAngle"))
        vals = np.stack([p.value for p in table.phase_functions], axis=0)
        val_v[:] = vals.astype(np.float32)
        setattr(nc, prefix + "phaseFunctionStorageType", "Angle-Value")
    else:
        lengths = np.array([p.n_moments for p in table.phase_functions], np.int32)
        starts = np.ones(n_entries, np.int32)
        starts[1:] = 1 + np.cumsum(lengths[:-1])
        total = int(starts[-1] + lengths[-1] - 1)
        nc.createDimension(prefix + "coefficents", total)  # sic: reference typo
        st_v = nc.createVariable(prefix + "start", "i", dim_e)
        ln_v = nc.createVariable(prefix + "length", "i", dim_e)
        co_v = nc.createVariable(prefix + "legendreCoefficients", "f",
                                 (prefix + "coefficents",))
        st_v[:] = starts
        ln_v[:] = lengths
        co_v[:] = np.concatenate(
            [p.legendre_coefficients for p in table.phase_functions]).astype(np.float32)
        setattr(nc, prefix + "phaseFunctionStorageType", "LegendreCoefficients")


def read_phase_function_table_nc(nc, prefix: str = ""):
    """Read a table from an open netcdf_file (read_PhaseFunctionTable analog).

    Returns a PhaseMatrixTable when the polarized-extension
    ``phaseMatrixElements`` variable is present (see
    _add_phase_matrix_table), else a PhaseFunctionTable.
    """
    if prefix + "phaseMatrixElements" in nc.variables:
        from i3rc_tpu_torch.core.phase_matrices import PhaseMatrix, PhaseMatrixTable

        key = _var(nc, prefix + "phaseFunctionKeyT").astype(np.float64)
        ext = _var(nc, prefix + "extinctionT").astype(np.float64)
        ssa = _var(nc, prefix + "singleScatteringAlbedoT").astype(np.float64)
        angles = _var(nc, prefix + "scatteringAngle").astype(np.float64)
        p11 = _var(nc, prefix + "phaseFunctionValues").astype(np.float64)
        el = _var(nc, prefix + "phaseMatrixElements").astype(np.float64)
        mats = [
            PhaseMatrix.from_elements(
                angles, p11[i], el[i, 0], a2=el[i, 1], a3=el[i, 2],
                a4=el[i, 3], b2=el[i, 4], extinction=ext[i],
                single_scattering_albedo=ssa[i])
            for i in range(key.size)
        ]
        return PhaseMatrixTable.from_phase_matrices(
            mats, key, description=_att(nc, prefix + "description", "") or "")
    storage = _att(nc, prefix + "phaseFunctionStorageType")
    if storage is None:
        raise ValidationError(
            f"read_phase_function_table: no table with prefix '{prefix}' in file")
    key = _var(nc, prefix + "phaseFunctionKeyT").astype(np.float64)
    ext = _var(nc, prefix + "extinctionT").astype(np.float64)
    ssa = _var(nc, prefix + "singleScatteringAlbedoT").astype(np.float64)
    description = _att(nc, prefix + "description", "") or ""
    if storage == "Angle-Value":
        angles = _var(nc, prefix + "scatteringAngle").astype(np.float64)
        # On disk CDL (entry, angle); in memory (angle, entry).
        values = _var(nc, prefix + "phaseFunctionValues").astype(np.float64).T
        return PhaseFunctionTable.from_tabulated(angles, values, key, ext, ssa,
                                                 description=description)
    if storage == "LegendreCoefficients":
        starts = _var(nc, prefix + "start")
        lengths = _var(nc, prefix + "length")
        coeffs = _var(nc, prefix + "legendreCoefficients").astype(np.float64)
        pfs = [
            PhaseFunction.from_legendre(coeffs[s - 1: s - 1 + l],
                                        extinction=e, single_scattering_albedo=a)
            for s, l, e, a in zip(starts, lengths, ext, ssa)
        ]
        return PhaseFunctionTable.from_phase_functions(pfs, key, description)
    raise ValidationError(f"unknown phaseFunctionStorageType '{storage}'")


def write_phase_function_table(table: PhaseFunctionTable, file_name: str) -> None:
    """write_PhaseFunctionTable analog (scatteringPhaseFunctions.f95:899-926)."""
    with netcdf_file(file_name, "w") as nc:
        add_phase_function_table(nc, table)


def read_phase_function_table(file_name: str, prefix: str = "") -> PhaseFunctionTable:
    with netcdf_file(file_name, "r", mmap=False) as nc:
        return read_phase_function_table_nc(nc, prefix)


# ---------------------------------------------------------------------------
# Domains
# ---------------------------------------------------------------------------
def write_domain(domain: Domain, file_name: str) -> None:
    """write_Domain analog (opticalProperties.f95:554-716)."""
    with netcdf_file(file_name, "w") as nc:
        nc.createDimension("x-Edges", domain.x_edges.size)
        nc.createDimension("y-Edges", domain.y_edges.size)
        nc.createDimension("z-Edges", domain.z_edges.size)
        nc.createDimension("x-Grid", domain.n_x)
        nc.createDimension("y-Grid", domain.n_y)
        nc.createDimension("z-Grid", domain.n_z)
        for name, edges in (("x-Edges", domain.x_edges), ("y-Edges", domain.y_edges),
                            ("z-Edges", domain.z_edges)):
            v = nc.createVariable(name, "f", (name,))
            v[:] = edges.astype(np.float32)
        nc.xyRegularlySpaced = np.int8(domain.xy_regularly_spaced)
        nc.zRegularlySpaced = np.int8(domain.z_regularly_spaced)
        if domain.components:
            nc.numberOfComponents = np.int32(len(domain.components))
        for i, comp in enumerate(domain.components, start=1):
            prefix = f"Component{i}_"
            setattr(nc, prefix + "Name", comp.name)
            setattr(nc, prefix + "zLevelBase", np.int32(comp.z_level_base + 1))
            fills_vertical = comp.z_level_base == 0 and comp.n_layers == domain.n_z
            if fills_vertical:
                z_dim = "z-Grid"
            else:
                z_dim = prefix + "z-Grid"
                nc.createDimension(z_dim, comp.n_layers)
            if comp.horizontally_uniform:
                dims = (z_dim,)
                ext = comp.extinction[0, 0]
                ssa = comp.single_scattering_albedo[0, 0]
                idx = comp.phase_function_index[0, 0]
            else:
                # CDL (z, y, x) == the reference's Fortran (/x, y, z/)
                # declaration (opticalProperties.f95:627-643).
                dims = (z_dim, "y-Grid", "x-Grid")
                ext = comp.extinction.T
                ssa = comp.single_scattering_albedo.T
                idx = comp.phase_function_index.T
            ev = nc.createVariable(prefix + "Extinction", "f", dims)
            sv = nc.createVariable(prefix + "SingleScatteringAlbedo", "f", dims)
            iv = nc.createVariable(prefix + "PhaseFunctionIndex", "h", dims)
            ev[:] = ext.astype(np.float32)
            sv[:] = ssa.astype(np.float32)
            iv[:] = (idx + 1).astype(np.int16)  # 1-based on file
            add_phase_function_table(nc, comp.table, prefix=prefix)


def read_domain(file_name: str) -> Domain:
    """read_Domain analog (opticalProperties.f95:708-844)."""
    with netcdf_file(file_name, "r", mmap=False) as nc:
        x_edges = _var(nc, "x-Edges").astype(np.float64)
        y_edges = _var(nc, "y-Edges").astype(np.float64)
        z_edges = _var(nc, "z-Edges").astype(np.float64)
        domain = Domain.create(x_edges, y_edges, z_edges)
        n_comp = int(_att(nc, "numberOfComponents", 0) or 0)
        for i in range(1, n_comp + 1):
            prefix = f"Component{i}_"
            name = _att(nc, prefix + "Name", f"component {i}")
            z_base = int(_att(nc, prefix + "zLevelBase", 1)) - 1
            # 3-D fields are CDL (z, y, x) on disk (see module docstring);
            # horizontally uniform components are 1-D (z,) either way.
            ext = _var(nc, prefix + "Extinction").astype(np.float64).T
            ssa = _var(nc, prefix + "SingleScatteringAlbedo").astype(np.float64).T
            idx = (_var(nc, prefix + "PhaseFunctionIndex").astype(np.int32) - 1).T
            table = read_phase_function_table_nc(nc, prefix)
            domain = domain.add_component(name, ext, ssa, idx, table,
                                          z_level_base=z_base)
        return domain
