"""The production driver on a PyTorch device: namelist-configured batches.

Port of ``i3rc_tpu/drivers/monte_carlo_driver.py:35-256``
(Example-Drivers/monteCarloDriver.f95): reads the namelists from the file
named on the command line, reads the domain, runs numBatches independent
photon batches, accumulates first/second moments, and writes ASCII and/or
netCDF flux and radiance results with standard errors through the JAX
package's own writers.

    python -m i3rc_tpu_torch.drivers.monte_carlo_driver [--device cuda] run.nml

``--device`` defaults to ``cuda``; a missing GPU raises instead of running
on the CPU.  The port covers flux and radiance with ray tracing
(``useRayTracing = .true.``, the reference's default: the general kernel,
its local estimate with the namelist's Iwabuchi roulette and ``zetaMin``,
hybrid phase functions and contribution clipping) or maximum cross-section
(the fastpath where it has a plan, else the general kernel), over a black
or Lambertian (``surfaceAlbedo``) surface; polarized transport raises
NotImplementedError naming ROADMAP item 17.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from i3rc_tpu_torch.drivers import results_io
from i3rc_tpu_torch.drivers.nml_common import get as _get
from i3rc_tpu_torch.drivers.nml_common import intensity_directions
from i3rc_tpu_torch.integrators.config import IntegratorConfig
from i3rc_tpu_torch.io.netcdf import read_domain
from i3rc_tpu_torch.utils.namelist import read_namelist
from i3rc_tpu_torch.core.illumination import PhotonSource
from i3rc_tpu_torch.integrators.integrator import Integrator
from i3rc_tpu_torch.parallel.mesh import run_batches


def run_from_namelist(namelist_path: str, quiet: bool = False, device="cuda") -> dict:
    """Execute the full driver; returns a dict of stats for programmatic use."""
    t0 = time.perf_counter()
    g = read_namelist(namelist_path)

    # --- namelist parameters with reference defaults (:60-103) -------------
    solar_flux = float(_get(g, "radiativetransfer", "solarflux", 1.0))
    solar_mu = float(_get(g, "radiativetransfer", "solarmu", 1.0))
    solar_azimuth = float(_get(g, "radiativetransfer", "solarazimuth", 0.0))
    surface_albedo = float(_get(g, "radiativetransfer", "surfacealbedo", 0.0))
    intensity_mus = _get(g, "radiativetransfer", "intensitymus", [0.0])
    intensity_phis = _get(g, "radiativetransfer", "intensityphis", [0.0])

    n_photons = int(_get(g, "montecarlo", "numphotonsperbatch", 0))
    n_batches = int(_get(g, "montecarlo", "numbatches", 100))
    iseed = int(_get(g, "montecarlo", "iseed", 10))
    n_phase_intervals = int(_get(g, "montecarlo", "nphaseintervals", 10001))

    use_ray_tracing = bool(_get(g, "algorithms", "useraytracing", True))
    use_rr = bool(_get(g, "algorithms", "userussianroulette", True))
    use_hybrid = bool(_get(g, "algorithms", "usehybridphasefunsforintencalcs", False))
    hybrid_width = float(_get(g, "algorithms", "hybridphasefunwidth", 7.0))
    use_rr_intensity = bool(_get(g, "algorithms", "userussianrouletteforintensity", True))
    zeta_min = float(_get(g, "algorithms", "zetamin", 0.3))
    limit_intensity = bool(_get(g, "algorithms", "limitintensitycontributions", False))
    max_intensity = float(_get(g, "algorithms", "maxintensitycontribution", 77.0))
    polarized = bool(_get(g, "algorithms", "polarized", False))

    report_volume = bool(_get(g, "output", "reportvolumeabsorption", False))
    report_profile = bool(_get(g, "output", "reportabsorptionprofile", False))

    domain_file = str(_get(g, "filenames", "domainfilename", ""))
    out_flux = str(_get(g, "filenames", "outputfluxfile", ""))
    out_rad = str(_get(g, "filenames", "outputradfile", ""))
    out_abs_prof = str(_get(g, "filenames", "outputabsproffile", ""))
    out_abs_vol = str(_get(g, "filenames", "outputabsvolumefile", ""))
    out_netcdf = str(_get(g, "filenames", "outputnetcdffile", ""))

    # Intensity directions: nonzero mus count (:151-154)
    mus, phis, compute_intensity = intensity_directions(
        intensity_mus, intensity_phis, bool(out_rad) or bool(out_netcdf))
    if polarized:
        raise NotImplementedError("monte_carlo_driver: polarized transport: ROADMAP item 17")

    # --- domain + integrator ------------------------------------------------
    domain = read_domain(domain_file)
    config = IntegratorConfig(
        use_ray_tracing=use_ray_tracing,
        use_russian_roulette=use_rr,
        use_hybrid_phase_funs=use_hybrid,
        hybrid_phase_fun_width=hybrid_width,
        use_russian_roulette_for_intensity=use_rr_intensity,
        zeta_min=zeta_min,
        limit_intensity_contributions=limit_intensity,
        max_intensity_contribution=max_intensity,
        min_forward_table_size=n_phase_intervals,
        min_inverse_table_size=n_phase_intervals,
        compute_volume_absorption=(report_volume or report_profile
                                   or bool(out_abs_prof) or bool(out_abs_vol)),
    )
    integ = Integrator.create(domain, config=config, surface_albedo=surface_albedo,
                              intensity_mus=mus, intensity_phis=phis, device=device)
    source = PhotonSource.directional(solar_mu, solar_azimuth)
    t_setup = time.perf_counter() - t0
    if not quiet:
        print(f"Setup time (secs, approx): {t_setup:.1f}")

    def derive(res):
        out = {"mean_flux_up": res.mean_flux_up,
               "mean_flux_down": res.mean_flux_down,
               "mean_flux_absorbed": res.mean_flux_absorbed,
               "absorbed_profile": res.absorbed_profile}
        if compute_intensity:
            out["mean_intensity"] = res.mean_intensity
        return out

    stats = run_batches(integ, source, n_photons, n_batches, seed=iseed,
                        chunk_batches=2, derive=derive).scaled(solar_flux)
    n_batches = stats.n_batches
    t_total = time.perf_counter() - t0
    if not quiet:
        print(f"Total time (secs, approx): {t_total:.1f}")

    res_m, res_e = stats.mean["results"], stats.stderr["results"]
    der_m, der_e = stats.mean["derived"], stats.stderr["derived"]
    cfg = dict(domain_file=domain_file, num_photons=n_photons * n_batches,
               num_batches=n_batches, use_ray_tracing=use_ray_tracing,
               use_russian_roulette=use_rr, use_hybrid=use_hybrid,
               hybrid_width=hybrid_width, solar_flux=solar_flux,
               solar_mu=solar_mu, solar_azimuth=solar_azimuth,
               surface_albedo=surface_albedo, use_rr_intensity=use_rr_intensity,
               zeta_min=zeta_min, limit_intensity=limit_intensity,
               max_intensity=max_intensity, seed=iseed,
               n_phase_intervals=n_phase_intervals, time_total=t_total,
               time_setup=t_setup, n_devices=1)

    x_edges = np.asarray(domain.x_edges)
    y_edges = np.asarray(domain.y_edges)
    z_edges = np.asarray(domain.z_edges)
    np_ = lambda a: a.cpu().numpy().astype(np.float32)
    flux_up = (np_(res_m.flux_up), np_(res_e.flux_up))
    flux_down = (np_(res_m.flux_down), np_(res_e.flux_down))
    flux_abs = (np_(res_m.flux_absorbed), np_(res_e.flux_absorbed))
    profile = (np_(der_m["absorbed_profile"]), np_(der_e["absorbed_profile"]))
    volume = (np_(res_m.volume_absorption), np_(res_e.volume_absorption))
    radiance = ((np_(res_m.intensity), np_(res_e.intensity))
                if compute_intensity else None)
    mean_stats = [(float(der_m[k]), float(der_e[k]))
                  for k in ("mean_flux_up", "mean_flux_down", "mean_flux_absorbed")]

    if out_flux:
        results_io.write_flux_ascii(out_flux, cfg, x_edges, y_edges, z_edges,
                                    mean_stats, flux_up, flux_down, flux_abs)
    if out_abs_prof:
        results_io.write_absorption_profile_ascii(out_abs_prof, cfg, z_edges, profile)
    if out_abs_vol:
        results_io.write_volume_absorption_ascii(out_abs_vol, cfg, x_edges,
                                                 y_edges, z_edges, volume)
    if out_rad and compute_intensity:
        results_io.write_radiance_ascii(out_rad, cfg, x_edges, y_edges, z_edges,
                                        mus, phis, radiance)
    if out_netcdf:
        results_io.write_results_netcdf(
            out_netcdf, cfg, x_edges, y_edges, z_edges,
            flux_up, flux_down, flux_abs,
            absorption_profile=profile if report_profile else None,
            absorbed_volume=volume if report_volume else None,
            intensity=radiance, intensity_mus=mus, intensity_phis=phis)
    if not quiet:
        print("Wrote results")

    return {"cfg": cfg, "mean_stats": mean_stats, "flux_up": flux_up,
            "flux_down": flux_down, "flux_absorbed": flux_abs,
            "absorbed_profile": profile, "volume": volume, "radiance": radiance,
            "stats": stats}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m i3rc_tpu_torch.drivers.monte_carlo_driver",
        description="Namelist-driven 3-D Monte Carlo run on a PyTorch device.")
    parser.add_argument("namelist", nargs="?", help="namelist file")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; no CPU fallback)")
    args = parser.parse_args(argv)
    path = args.namelist
    if path is None:
        # getOneArgument's stdin fallback (userInterface_Unix.f95:70-99).
        print("Enter the namelist file name: ", end="", flush=True)
        path = sys.stdin.readline().strip()
        if not path:
            parser.print_usage(sys.stderr)
            return 1
    run_from_namelist(path, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
