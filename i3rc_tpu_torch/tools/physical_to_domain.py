# Copy of i3rc_tpu/tools/physical_to_domain.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""Physical-properties -> domain converter.

Re-implements Tools/PhysicalPropertiesToDomain.f95: ASCII particle files
(three formats: 1-parameter LWC, 2-parameter LWC+Reff, multicomponent) plus
up to five Mie phase-function tables, with optional extra atmosphere levels,
a molecular-absorption extinction profile, and Rayleigh scattering computed
from the hypsometric pressure profile.  Emits one optical component per
particle type plus "Rayleigh scattering" and "Molecular absorption"
components, then writes the domain file.

Per-cell optics come from linear interpolation of (extinction * mass, ssa)
in effective radius within each table, with the nearest entry's phase
function (PhysicalPropertiesToDomain.f95:242-276).

Reference defect note: the Fortran's rayleigh_extinct builds the pressure
profile in a loop but keeps only the final (top) pressure, so every level's
extinction uses the top-of-atmosphere pressure (:563-580).  This port keeps
the per-level pressures — the documented intent.
"""

from __future__ import annotations

import sys

import numpy as np

from i3rc_tpu_torch.core.optics import Domain
from i3rc_tpu_torch.core.phase_functions import PhaseFunction, PhaseFunctionTable
from i3rc_tpu_torch.utils.errors import ValidationError

MAX_NUM_COMPONENTS = 5


class _Tokens:
    """List-directed-style token stream over an ASCII file."""

    def __init__(self, path):
        with open(path) as f:
            self.lines = f.read().splitlines()
        self.i = 0

    def line(self):
        s = self.lines[self.i]
        self.i += 1
        return s

    def values(self, n, conv=float):
        """Read n values, continuing across lines like Fortran list input."""
        out = []
        while len(out) < n:
            out.extend(conv(t) for t in self.line().split())
        if len(out) > n:
            raise ValidationError(f"expected {n} values, got {len(out)}")
        return out


def read_particle_file(path, drop_num_conc=0.0, n_scat_tables=1):
    """Read any of the three particle-file formats (:373-456).

    Returns dict with nx, ny, nz, delta_x, delta_y (km), z_levels (nz+1, km),
    temps (nz+1, K), and per-cell component lists: n_comp (nx,ny,nz),
    ptype/mass/reff (n_scat_tables, nx, ny, nz); ptype is 1-based table ids.
    """
    t = _Tokens(path)
    kind = int(t.line().split()[0])
    nx, ny, nz = (int(v) for v in t.line().split()[:3])
    delta_x, delta_y = (float(v) for v in t.line().split()[:2])
    z_levels = np.array(t.values(nz + 1))
    temps = np.array(t.values(nz + 1))

    n_comp = np.zeros((nx, ny, nz), np.int32)
    ptype = np.zeros((n_scat_tables, nx, ny, nz), np.int32)
    mass = np.zeros((n_scat_tables, nx, ny, nz))
    reff = np.zeros((n_scat_tables, nx, ny, nz))

    if kind in (1, 2):
        if n_scat_tables != 1:
            raise ValidationError("1- or 2-parameter LWC files require exactly "
                                  "one scattering table")
        while t.i < len(t.lines):
            parts = t.line().split()
            if not parts:
                continue
            ix, iy, iz = int(parts[0]) - 1, int(parts[1]) - 1, int(parts[2]) - 1
            lwc = float(parts[3])
            if kind == 1:
                # Reff from LWC for a gamma distribution with alpha = 7 (:421)
                re = 100.0 * (lwc * 0.75 * 1.3889 / (3.14159 * drop_num_conc)) ** (1.0 / 3)
            else:
                re = float(parts[4])
            if 0 <= ix < nx and 0 <= iy < ny and 0 <= iz < nz:
                n_comp[ix, iy, iz] = 1
                ptype[0, ix, iy, iz] = 1
                mass[0, ix, iy, iz] = lwc
                reff[0, ix, iy, iz] = re
    elif kind == 3:
        while t.i < len(t.lines):
            parts = t.line().split()
            if not parts:
                continue
            ix, iy, iz = int(parts[0]) - 1, int(parts[1]) - 1, int(parts[2]) - 1
            nc = int(parts[3])
            use = min(nc, n_scat_tables)
            if 0 <= ix < nx and 0 <= iy < ny and 0 <= iz < nz:
                n_comp[ix, iy, iz] = nc
                for k in range(use):
                    pt = int(parts[4 + 3 * k])
                    if pt > n_scat_tables:
                        raise ValidationError(
                            "particle type greater than number of scattering tables")
                    ptype[k, ix, iy, iz] = pt
                    mass[k, ix, iy, iz] = float(parts[5 + 3 * k])
                    reff[k, ix, iy, iz] = float(parts[6 + 3 * k])
    else:
        raise ValidationError(f"unknown particle file format type {kind}")

    return dict(nx=nx, ny=ny, nz=nz, delta_x=delta_x, delta_y=delta_y,
                z_levels=z_levels, temps=temps, n_comp=n_comp, ptype=ptype,
                mass=mass, reff=reff)


def organize_levels(z_par, temp_par, other_heights, other_temps):
    """Merge extra atmosphere levels outside the particle range (:460-504).

    Returns (z_levels, temps, iz_level_base) with iz_level_base the 0-based
    layer index where the particle layers start.
    """
    z_par = np.asarray(z_par)
    other_heights = np.asarray(other_heights, dtype=np.float64)
    other_temps = np.asarray(other_temps, dtype=np.float64)
    if np.any(np.diff(z_par) <= 0):
        raise ValidationError("particle-file heights must increase")
    if np.any((other_heights >= z_par[0]) & (other_heights <= z_par[-1])):
        raise ValidationError("OtherHeights must be outside the particle height range")
    if np.any(np.diff(other_heights) <= 0):
        raise ValidationError("OtherHeights must increase")
    below = other_heights < z_par[0]
    z = np.concatenate([other_heights[below], z_par, other_heights[~below]])
    temp = np.concatenate([other_temps[below], temp_par, other_temps[~below]])
    return z, temp, int(np.count_nonzero(below))


def read_molecular_absorption(path, z_levels):
    """Three-line gas-extinction profile (:509-538); validates the levels."""
    t = _Tokens(path)
    nz = int(t.line().split()[0])
    z_in = np.array(t.values(nz + 1))
    if nz != z_levels.size - 1 or np.any(np.abs(z_in - z_levels) > 1e-4):
        raise ValidationError("molecular absorption file Z levels do not match")
    return np.array(t.values(nz))


def rayleigh_extinction(z_levels, temps, wavelength_um):
    """Rayleigh extinction per layer [1/km] (:543-583, with the pressure
    profile stored per level — see module docstring)."""
    z = np.asarray(z_levels, dtype=np.float64)
    t = np.asarray(temps, dtype=np.float64)
    nz = z.size - 1
    raylcoef = 2.97e-4 * wavelength_um ** (-4.15 + 0.2 * wavelength_um)
    pres = np.empty(nz + 1)
    lapse0 = 6.5e-3
    pres[0] = 1013.0 * (t[0] / (t[0] + lapse0 * z[0] * 1000.0)) ** (9.8 / (287.0 * lapse0))
    for i in range(nz):
        dz = 1000.0 * (z[i + 1] - z[i])
        lapse = (t[i] - t[i + 1]) / dz
        if abs(lapse) > 1e-4:
            pres[i + 1] = pres[i] * (t[i + 1] / t[i]) ** (9.8 / (287.0 * lapse))
        else:
            pres[i + 1] = pres[i] * np.exp(-9.8 * dz / (287.0 * t[i]))
    ext_lev = raylcoef * pres / t
    # Layer average assuming exponential decay (:581-582).
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = ext_lev[:-1] / ext_lev[1:]
        out = np.where(np.abs(np.log(ratio)) > 1e-12,
                       (ext_lev[:-1] - ext_lev[1:]) / np.log(ratio), ext_lev[:-1])
    return out


RAYLEIGH_COEFFICIENTS = np.array([0.0, 0.5]) / np.array([3.0, 5.0])  # (:314)


def physical_properties_to_domain(particle_file, scat_tables, drop_num_conc=0.0,
                                  other_heights=(), other_temps=(),
                                  molec_abs_file="", rayleigh_wavelength=0.0,
                                  verbose=False) -> Domain:
    """The full conversion pipeline; scat_tables is a list of
    PhaseFunctionTable (or file paths)."""
    from i3rc_tpu_torch.io.netcdf import read_phase_function_table

    tables = [read_phase_function_table(s) if isinstance(s, str) else s
              for s in scat_tables]
    n_tab = len(tables)
    if n_tab == 0 or n_tab > MAX_NUM_COMPONENTS:
        raise ValidationError(f"need 1..{MAX_NUM_COMPONENTS} scattering tables")

    p = read_particle_file(particle_file, drop_num_conc, n_tab)
    z_levels, temps, iz_base = organize_levels(
        p["z_levels"], p["temps"],
        np.asarray(other_heights)[np.asarray(other_temps) > 0]
        if len(other_heights) else np.zeros(0),
        np.asarray(other_temps)[np.asarray(other_temps) > 0]
        if len(other_temps) else np.zeros(0))
    nzt = z_levels.size - 1
    nx, ny, nzp = p["nx"], p["ny"], p["nz"]

    gas_ext = np.zeros(nzt)
    if molec_abs_file:
        gas_ext = read_molecular_absorption(molec_abs_file, z_levels)
    rayl_ext = np.zeros(nzt)
    if rayleigh_wavelength > 0:
        rayl_ext = rayleigh_extinction(z_levels, temps, rayleigh_wavelength)

    # Per-cell interpolation in effective radius (:242-276).
    extinct = np.zeros((nx, ny, nzp, n_tab))
    ssa = np.zeros((nx, ny, nzp, n_tab))
    pf_index = np.zeros((nx, ny, nzp, n_tab), np.int32)
    warned = 0
    for i_tab, table in enumerate(tables):
        keys = table.key
        ext_t = table.extinctions
        ssa_t = table.single_scattering_albedos
        for k in range(n_tab):
            sel = p["ptype"][k] == i_tab + 1  # (nx, ny, nz) cells using this table
            if not np.any(sel):
                continue
            re = p["reff"][k][sel]
            mass = p["mass"][k][sel]
            inside = (re > keys.min()) & (re <= keys.max())
            il = np.clip(np.searchsorted(keys, re, side="right") - 1, 0, keys.size - 2)
            f = (re - keys[il]) / (keys[il + 1] - keys[il])
            ext_v = np.where(inside, mass * ((1 - f) * ext_t[il] + f * ext_t[il + 1]), 0.0)
            ssa_v = np.where(inside, (1 - f) * ssa_t[il] + f * ssa_t[il + 1], 0.0)
            idx_v = np.where(f < 0.5, il, il + 1)
            warned += int(np.count_nonzero(~inside & (mass > 0)))
            extinct[..., i_tab][sel] = ext_v
            ssa[..., i_tab][sel] = ssa_v
            pf_index[..., i_tab][sel] = idx_v
    if warned and verbose:
        print(f"Warning: {warned} cells have effective radius outside the table")

    domain = Domain.create(p["delta_x"] * np.arange(nx + 1),
                           p["delta_y"] * np.arange(ny + 1), z_levels)
    for i_tab, table in enumerate(tables):
        domain = domain.add_component(f"Particle type {i_tab + 1}",
                                      extinct[..., i_tab], ssa[..., i_tab],
                                      pf_index[..., i_tab], table,
                                      z_level_base=iz_base)
    if np.any(rayl_ext > 0):
        rayl_table = PhaseFunctionTable.from_phase_functions(
            [PhaseFunction.from_legendre(RAYLEIGH_COEFFICIENTS)], key=[0.0],
            description="Rayleigh scattering")
        domain = domain.add_component("Rayleigh scattering", rayl_ext,
                                      np.ones(nzt), np.zeros(nzt, np.int32),
                                      rayl_table)
    if np.any(gas_ext > 0):
        gas_table = PhaseFunctionTable.from_phase_functions(
            [PhaseFunction.from_legendre(np.zeros(1))], key=[0.0],
            description="Molecular absorption")
        domain = domain.add_component("Molecular absorption", gas_ext,
                                      np.zeros(nzt), np.zeros(nzt, np.int32),
                                      gas_table)
    return domain


def main(argv=None):
    """CLI: python -m i3rc_tpu_torch.tools.physical_to_domain <namelist.nml>."""
    from i3rc_tpu_torch.io.netcdf import write_domain
    from i3rc_tpu_torch.utils.namelist import read_namelist

    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m i3rc_tpu_torch.tools.physical_to_domain <namelist.nml>",
              file=sys.stderr)
        return 1
    g = read_namelist(argv[0])
    fn = g.get("filenames", {})
    scat = fn.get("scattablefiles", [])
    if isinstance(scat, str):
        scat = [scat]
    scat = [s.strip() for s in scat if s.strip()]
    prof = g.get("profile", {})
    heights = prof.get("otherheights", [])
    temps = prof.get("othertemps", [])
    heights = [heights] if isinstance(heights, (int, float)) else list(heights)
    temps = [temps] if isinstance(temps, (int, float)) else list(temps)
    phys = g.get("physicalproperties", {})
    domain = physical_properties_to_domain(
        str(fn.get("particlefilename", "")).strip(), scat,
        drop_num_conc=float(phys.get("dropnumconc", 0.0)),
        other_heights=heights, other_temps=temps,
        molec_abs_file=str(fn.get("molecabsfilename", "")).strip(),
        rayleigh_wavelength=float(phys.get("rayleighwavelength", 0.0)),
        verbose=True)
    out = str(fn.get("outputfilename", "")).strip()
    write_domain(domain, out)
    print(f"Wrote domain ({', '.join(domain.component_names)}) to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
