# Copy of i3rc_tpu/drivers/results_io.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""Result-file writers matching the reference's ASCII and netCDF outputs.

Re-implements writeResults_ASCII (Example-Drivers/monteCarloDriver.f95:
436-605) and writeResults_netcdf (:609-854): every field is written as a
(mean, standard-error) pair, with the full run configuration recorded in
headers / global attributes — the reference's observability contract
(SURVEY.md section 5).
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file


def _header_lines(cfg: dict) -> list[str]:
    return [
        f"!  Property_File={cfg['domain_file']:<60}",
        f"!  Num_Photons={cfg['num_photons']:>10d}",
        f"!  PhotonTracing={'T' if cfg['use_ray_tracing'] else 'F'}"
        f"    Russian_Roulette={'T' if cfg['use_russian_roulette'] else 'F'}",
        f"!  Hybrid_Phase_Func_for_Radiance={'T' if cfg['use_hybrid'] else 'F'}"
        f"   Gaussian_Phase_Func_Width_deg={cfg['hybrid_width']:5.2f}",
        f"!  Solar_Flux={cfg['solar_flux']:13.6E}   Solar_Mu={cfg['solar_mu']:10.7f}"
        f"   Solar_Phi={cfg['solar_azimuth']:7.3f}",
        f"!  Lambertian_Surface_Albedo={cfg['surface_albedo']:7.4f}",
    ]


def write_flux_ascii(path, cfg, x_edges, y_edges, z_edges,
                     mean_stats, flux_up, flux_down, flux_absorbed):
    """Pixel flux file (:484-511).  *_stats args are (mean, stderr) pairs."""
    nx, ny = flux_up[0].shape
    xc = 0.5 * (x_edges[:-1] + x_edges[1:])
    yc = 0.5 * (y_edges[:-1] + y_edges[1:])
    with open(path, "w") as f:
        f.write("!   I3RC Monte Carlo 3D Solar Radiative Transfer: Flux\n")
        f.write("\n".join(_header_lines(cfg)) + "\n")
        f.write("!  Output_Type= Pixel Flux\n")
        f.write(f"!  Upwelling_Level={z_edges[-1]:7.3f}   Downwelling_level={z_edges[0]:7.3f}\n")
        f.write("!   X      Y           Flux_Up             Flux_Down            Flux_Absorbed \n")
        f.write("!                  Mean     StdErr       Mean     StdErr       Mean     StdErr\n")
        m = mean_stats
        f.write(f"!  Average:     {m[0][0]:9.4f}  {m[0][1]:9.4f}   {m[1][0]:9.4f}"
                f"  {m[1][1]:9.4f}   {m[2][0]:9.4f}  {m[2][1]:9.4f}\n")
        for j in range(ny):
            for i in range(nx):
                f.write(f"{xc[i]:7.3f}{yc[j]:7.3f}"
                        f"  {flux_up[0][i, j]:9.4f}  {flux_up[1][i, j]:9.4f}"
                        f"   {flux_down[0][i, j]:9.4f}  {flux_down[1][i, j]:9.4f}"
                        f"   {flux_absorbed[0][i, j]:9.4f}  {flux_absorbed[1][i, j]:9.4f}\n")


def write_absorption_profile_ascii(path, cfg, z_edges, profile):
    """Absorption-profile file (:517-536); profile is (mean, stderr) of (nz,)."""
    zc = 0.5 * (z_edges[:-1] + z_edges[1:])
    with open(path, "w") as f:
        f.write("!   I3RC Monte Carlo 3D Solar Radiative Transfer: Absorption Profile\n")
        f.write("\n".join(_header_lines(cfg)) + "\n")
        f.write("!  Output_Type= Absorption Profile\n")
        f.write("!   Z    Absorbed_Flux (flux/km) \n!          Mean     StdErr \n")
        for k in range(zc.size):
            f.write(f"{zc[k]:7.3f}  {profile[0][k]:9.4f}  {profile[1][k]:9.4f}\n")


def write_volume_absorption_ascii(path, cfg, x_edges, y_edges, z_edges, volume):
    """3D absorption file (:542-567); volume is (mean, stderr) of (nx,ny,nz)."""
    xc = 0.5 * (x_edges[:-1] + x_edges[1:])
    yc = 0.5 * (y_edges[:-1] + y_edges[1:])
    zc = 0.5 * (z_edges[:-1] + z_edges[1:])
    with open(path, "w") as f:
        f.write("!   I3RC Monte Carlo 3D Solar Radiative Transfer: 3D Absorption Field\n")
        f.write("\n".join(_header_lines(cfg)) + "\n")
        f.write("!  Output_Type= Volume Absorption \n")
        f.write("!    X       Y        Z       Absorbed_Flux (flux/km)\n")
        f.write("!                               Mean     StdErr \n")
        for i in range(xc.size):
            for j in range(yc.size):
                for k in range(zc.size):
                    f.write(f"{xc[i]:7.3f} {yc[j]:7.3f} {zc[k]:7.3f} "
                            f" {volume[0][i, j, k]:9.4f}  {volume[1][i, j, k]:9.4f}\n")


def write_radiance_ascii(path, cfg, x_edges, y_edges, z_edges,
                         intensity_mus, intensity_phis, radiance):
    """Pixel radiance file (:572-604); radiance is (mean, stderr) of (nx,ny,D).

    Polarized extension (Wishlist.txt:30-31, "the driver programs need to
    report polarized results"): a (nx, ny, D, 4) radiance writes four
    (mean, StdErr) column pairs per pixel, I Q U V in the detector-
    meridian convention (integrators/polarized.py docstring)."""
    stokes = radiance[0].ndim == 4
    nx, ny, nd = radiance[0].shape[:3]
    xc = 0.5 * (x_edges[:-1] + x_edges[1:])
    yc = 0.5 * (y_edges[:-1] + y_edges[1:])
    with open(path, "w") as f:
        f.write("!   I3RC Monte Carlo 3D Solar Radiative Transfer: Radiance\n")
        f.write("\n".join(_header_lines(cfg)) + "\n")
        f.write(f"!  Intensity_uses_Russian_Roulette="
                f"{'T' if cfg['use_rr_intensity'] else 'F'}"
                f"   Intensity_Russian_Roulette_zeta_min={cfg['zeta_min']:5.2f}\n")
        f.write(f"!  limited_intensity_contributions="
                f"{'T' if cfg['limit_intensity'] else 'F'}"
                f"   max_intensity_contribution={cfg['max_intensity']:5.2f}\n")
        if stokes:
            f.write("!  Output_Type= Pixel Stokes Radiance (I Q U V, "
                    "detector-meridian frame)\n")
        else:
            f.write("!  Output_Type= Pixel Radiance\n")
        f.write(f"!  RADIANCE AT Z={z_edges[-1]:7.3f}   NXO={nx:4d}   NYO={ny:4d}"
                f"   NDIR={nd:4d}\n")
        if stokes:
            f.write("!   X      Y         I (Mean, StdErr)   Q   U   V\n")
        else:
            f.write("!   X      Y         Radiance (Mean, StdErr)\n")
        for k in range(nd):
            f.write(f"!  {intensity_mus[k]:8.5f} {intensity_phis[k]:6.2f}  <- (mu,phi)\n")
            for j in range(ny):
                for i in range(nx):
                    if stokes:
                        cols = "".join(
                            f"  {radiance[0][i, j, k, c]:9.4f}"
                            f"  {radiance[1][i, j, k, c]:9.4f}"
                            for c in range(4))
                        f.write(f"{xc[i]:7.3f}{yc[j]:7.3f}{cols}\n")
                    else:
                        f.write(f"{xc[i]:7.3f}{yc[j]:7.3f}"
                                f"  {radiance[0][i, j, k]:9.4f}"
                                f"  {radiance[1][i, j, k]:9.4f}\n")


def write_results_netcdf(path, cfg, x_edges, y_edges, z_edges,
                         flux_up, flux_down, flux_absorbed,
                         absorption_profile=None, absorbed_volume=None,
                         intensity=None, intensity_mus=None, intensity_phis=None):
    """Result netCDF (:609-854): config as global attrs, mean + StdErr vars."""
    nx, ny, nz = x_edges.size - 1, y_edges.size - 1, z_edges.size - 1
    with netcdf_file(path, "w") as nc:
        nc.description = "Output from I3RC Community Monte Carlo Model (i3rc_tpu)"
        nc.Domain_filename = cfg["domain_file"]
        nc.Surface_albedo = np.float32(cfg["surface_albedo"])
        nc.Total_number_of_photons = np.int32(cfg["num_photons"])
        nc.Number_of_batches = np.int32(cfg["num_batches"])
        nc.Solar_flux = np.float32(cfg["solar_flux"])
        nc.Solar_mu = np.float32(cfg["solar_mu"])
        nc.Solar_phi = np.float32(cfg["solar_azimuth"])
        nc.Random_number_seed = np.int32(cfg["seed"])
        nc.Phase_function_table_sizes = np.int32(cfg["n_phase_intervals"])
        nc.Algorithm = "Ray_tracing" if cfg["use_ray_tracing"] else "Max_cross_section"
        nc.Intensity_uses_hyrbid_phase_functions = np.int32(cfg["use_hybrid"])
        nc.Hybrid_phase_function_width = np.float32(
            cfg["hybrid_width"] if cfg["use_hybrid"] else 0.0)
        nc.Intensity_uses_Russian_roulette = np.int32(cfg["use_rr_intensity"])
        nc.Intensity_Russian_roulette_zeta_min = np.float32(
            cfg["zeta_min"] if cfg["use_rr_intensity"] else 0.0)
        nc.limited_intensity_contributions = np.int32(cfg["limit_intensity"])
        nc.max_intensity_contribution = np.float32(
            cfg["max_intensity"] if cfg["limit_intensity"] else 0.0)
        nc.Cpu_time_total = np.float32(cfg.get("time_total", 0.0))
        nc.Cpu_time_setup = np.float32(cfg.get("time_setup", 0.0))
        nc.Number_of_processors_used = np.int32(cfg.get("n_devices", 1))

        nc.createDimension("x", nx)
        nc.createDimension("y", ny)
        nc.createVariable("x", "f", ("x",))[:] = (
            0.5 * (x_edges[:-1] + x_edges[1:])).astype(np.float32)
        nc.createVariable("y", "f", ("y",))[:] = (
            0.5 * (y_edges[:-1] + y_edges[1:])).astype(np.float32)
        if absorption_profile is not None or absorbed_volume is not None:
            nc.createDimension("z", nz)
            nc.createVariable("z", "f", ("z",))[:] = (
                0.5 * (z_edges[:-1] + z_edges[1:])).astype(np.float32)

        def put(name, dims, mean, stderr):
            # The reference declares its variables with Fortran dimension
            # lists (fastest-varying first), so the on-disk CDL order is
            # the REVERSE: fluxUp(y, x), absorbedVolume(z, y, x),
            # intensity(direction, y, x) (monteCarloDriver.f95:724-768).
            # In-memory arrays here are (x, y[, ...]) — write transposed.
            nc.createVariable(name, "f", dims)[:] = np.asarray(
                mean, np.float32).T
            nc.createVariable(name + "_StdErr", "f", dims)[:] = np.asarray(
                stderr, np.float32).T

        put("fluxUp", ("y", "x"), *flux_up)
        put("fluxDown", ("y", "x"), *flux_down)
        put("fluxAbsorbed", ("y", "x"), *flux_absorbed)
        if absorption_profile is not None:
            put("absorptionProfile", ("z",), *absorption_profile)
        if absorbed_volume is not None:
            put("absorbedVolume", ("z", "y", "x"), *absorbed_volume)
        if intensity is not None:
            stokes = intensity[0].ndim == 4
            nd = intensity[0].shape[2] if stokes else intensity[0].shape[-1]
            nc.createDimension("direction", nd)
            nc.createVariable("intensityMus", "f", ("direction",))[:] = np.asarray(
                intensity_mus, np.float32)
            nc.createVariable("intensityPhis", "f", ("direction",))[:] = np.asarray(
                intensity_phis, np.float32)
            if stokes:
                # Polarized extension: (x, y, D, 4) in memory writes as CDL
                # (stokes, direction, y, x); component order I Q U V in the
                # detector-meridian convention.
                nc.createDimension("stokes", 4)
                nc.Stokes_convention = (
                    "I Q U V; Q parallel to the detector meridian plane")
                put("intensity", ("stokes", "direction", "y", "x"),
                    *intensity)
            else:
                put("intensity", ("direction", "y", "x"), *intensity)
