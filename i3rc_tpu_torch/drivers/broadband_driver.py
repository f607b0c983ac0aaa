"""Broadband (correlated-k) driver on a PyTorch device.

Port of ``i3rc_tpu/drivers/broadband_driver.py``: reads the namelist named
on the command line, the domain (optionally one per band) and the
k-distribution files, runs every band's k points through
``integrators/spectral.py``, and writes broadband fluxes (and radiances,
the absorption profile and netCDF output when asked for) with standard
errors through the port's own writers (``drivers/results_io.py``).

    python -m i3rc_tpu_torch.drivers.broadband_driver [--device cuda] run.nml
    torchrun --nproc_per_node=N -m i3rc_tpu_torch.drivers.broadband_driver run.nml

Namelist groups: the monteCarloDriver five (radiativeTransfer, monteCarlo,
algorithms, output, fileNames) plus

    &spectral
      kDistributionFiles = "band1.kd", "band2.kd"   ! required
      bandDomainFiles    = "d1.dom", "d2.dom"       ! optional, per band
      spectralMode       = "auto"   ! auto | fused | baked | traced
    /

On the port (integrators/spectral.py) "baked" runs one baked gas-channel
integrator per k point (a k point changes only the event kernel's
parameter block, so there is no compile to amortize); "fused" runs every k
point of a band in one trace of the fused-k kernel variant, k a per-lane
attribute (a band without a gas-channel fastpath plan raises a ValueError
naming why); "traced" swaps each k point's optics into the band
integrator's general kernel (radiance detectors included: its local
estimate); "auto" takes fused where the band can run it and a band batch
is at most spectral.FUSED_AUTO_MAX_PHOTONS photons, else baked where the
baked plan is a fastpath plan, else traced.  ``--device`` defaults to
``cuda``; a missing GPU raises instead of running on the CPU.  The surface
is the namelist's ``surfaceAlbedo``, or a ``SurfaceDescription`` that a
caller of ``run_from_namelist`` passes as ``surface`` (the namelist has no
BRDF entry; the albedo must then be 0).  Under ``torchrun`` each rank runs
its share of every k point's batches on ``cuda:LOCAL_RANK`` and rank 0
alone writes (as the monteCarloDriver port does).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from i3rc_tpu_torch.core.k_distribution import read_k_distribution
from i3rc_tpu_torch.drivers import results_io
from i3rc_tpu_torch.drivers.nml_common import get as _get
from i3rc_tpu_torch.drivers.nml_common import intensity_directions
from i3rc_tpu_torch.integrators.config import IntegratorConfig
from i3rc_tpu_torch.io.netcdf import read_domain
from i3rc_tpu_torch.utils.namelist import read_namelist
from i3rc_tpu_torch.core.illumination import PhotonSource
from i3rc_tpu_torch.integrators.spectral import MODES, run_broadband
from i3rc_tpu_torch.parallel.mesh import default_mesh, initialize_multihost, tree_map


def _listify(v):
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [str(x) for x in v]
    return [str(v)]


def run_from_namelist(namelist_path: str, quiet: bool = False, device="cuda",
                      surface=None, mesh=None) -> dict:
    """Execute the broadband driver; returns a dict for programmatic use.
    ``mesh`` (default: ``default_mesh`` on ``device``) spreads the batches
    over its ranks, on the mesh's device; rank 0 alone writes and prints."""
    t0 = time.perf_counter()
    mesh = mesh or default_mesh(device=device)
    device = mesh.device
    quiet = quiet or mesh.rank != 0
    g = read_namelist(namelist_path)

    solar_flux = float(_get(g, "radiativetransfer", "solarflux", 1.0))
    solar_mu = float(_get(g, "radiativetransfer", "solarmu", 1.0))
    solar_azimuth = float(_get(g, "radiativetransfer", "solarazimuth", 0.0))
    surface_albedo = float(_get(g, "radiativetransfer", "surfacealbedo", 0.0))
    intensity_mus = np.atleast_1d(np.asarray(
        _get(g, "radiativetransfer", "intensitymus", [0.0]), dtype=np.float64))
    intensity_phis = np.atleast_1d(np.asarray(
        _get(g, "radiativetransfer", "intensityphis", [0.0]), dtype=np.float64))

    n_photons = int(_get(g, "montecarlo", "numphotonsperbatch", 10000))
    n_batches = int(_get(g, "montecarlo", "numbatches", 4))
    iseed = int(_get(g, "montecarlo", "iseed", 10))

    use_ray_tracing = bool(_get(g, "algorithms", "useraytracing", False))
    majorant_block_size = int(_get(g, "algorithms", "majorantblocksize", 16))
    max_events = int(_get(g, "algorithms", "maxevents", 500))

    report_volume = bool(_get(g, "output", "reportvolumeabsorption", False))
    report_profile = bool(_get(g, "output", "reportabsorptionprofile", False))

    domain_file = str(_get(g, "filenames", "domainfilename", ""))
    out_flux = str(_get(g, "filenames", "outputfluxfile", ""))
    out_rad = str(_get(g, "filenames", "outputradfile", ""))
    out_abs_prof = str(_get(g, "filenames", "outputabsproffile", ""))
    out_netcdf = str(_get(g, "filenames", "outputnetcdffile", ""))

    kd_files = _listify(_get(g, "spectral", "kdistributionfiles", None))
    band_dom_files = _listify(_get(g, "spectral", "banddomainfiles", None))
    mode = str(_get(g, "spectral", "spectralmode", "auto")).lower()
    if not kd_files:
        raise ValueError("spectral namelist group needs kDistributionFiles")
    if mode not in MODES:
        raise ValueError(f"spectralMode must be one of {sorted(MODES)}, got {mode!r}")
    if band_dom_files and len(band_dom_files) != len(kd_files):
        raise ValueError("bandDomainFiles must match kDistributionFiles "
                         f"({len(band_dom_files)} vs {len(kd_files)})")

    mus, phis, compute_intensity = intensity_directions(
        intensity_mus, intensity_phis, bool(out_rad) or bool(out_netcdf))

    kds = [read_k_distribution(p) for p in kd_files]
    band_domains = [read_domain(p) for p in band_dom_files] if band_dom_files else None
    base_domain = band_domains[0] if band_domains is not None else read_domain(domain_file)

    config = IntegratorConfig(
        use_ray_tracing=use_ray_tracing, majorant_block_size=majorant_block_size,
        max_events=max_events,
        compute_volume_absorption=report_volume or report_profile or bool(out_abs_prof))
    source = PhotonSource.directional(solar_mu, solar_azimuth)
    t_setup = time.perf_counter() - t0
    if not quiet:
        print(f"Setup time (secs, approx): {t_setup:.1f}")

    # Domain means accumulate per batch, so their standard error is the batch
    # spread of the mean (monteCarloDriver.f95:300-305).
    def derive(res):
        out = {"mean_flux_up": res.mean_flux_up, "mean_flux_down": res.mean_flux_down,
               "mean_flux_absorbed": res.mean_flux_absorbed,
               "absorbed_profile": res.absorbed_profile}
        if compute_intensity:
            out["mean_intensity"] = res.mean_intensity
        return out

    broadband, bands = run_broadband(
        base_domain, kds, source, n_photons, n_batches, seed=iseed, config=config,
        surface_albedo=surface_albedo, surface=surface, intensity_mus=mus,
        intensity_phis=phis,
        band_domains=band_domains, derive=derive, mode=mode, integrator_cache={},
        device=device, mesh=mesh)
    bb_res, bb_der = broadband["results"], broadband["derived"]
    # Bands are independent runs: their spectral-fraction-weighted standard
    # errors add in quadrature (monteCarloDriver.f95:358-378).
    bb_var = None
    for band in bands:
        contrib = tree_map(lambda s, f=band.spectral_fraction: (s * f) ** 2, band.stderr)
        bb_var = contrib if bb_var is None else tree_map(torch.add, bb_var, contrib)
    bb_err = tree_map(torch.sqrt, bb_var)
    err_res, err_der = bb_err["results"], bb_err["derived"]
    t_total = time.perf_counter() - t0
    if not quiet:
        print(f"Total time (secs, approx): {t_total:.1f}")

    np_ = lambda a: a.cpu().numpy().astype(np.float32) * np.float32(solar_flux)
    x_edges = np.asarray(base_domain.x_edges)
    y_edges = np.asarray(base_domain.y_edges)
    z_edges = np.asarray(base_domain.z_edges)
    cfg = dict(domain_file=domain_file or ";".join(band_dom_files),
               k_distribution_files=";".join(kd_files), spectral_mode=mode,
               num_photons=n_photons * n_batches * sum(k.n_k for k in kds),
               num_batches=n_batches, num_bands=len(kds), solar_flux=solar_flux,
               solar_mu=solar_mu, solar_azimuth=solar_azimuth,
               surface_albedo=surface_albedo, seed=iseed, time_total=t_total,
               time_setup=t_setup, n_devices=mesh.size,
               # Header keys of results_io; this driver runs the default
               # estimator configuration.
               use_ray_tracing=use_ray_tracing,
               use_russian_roulette=config.use_russian_roulette,
               use_hybrid=config.use_hybrid_phase_funs,
               hybrid_width=config.hybrid_phase_fun_width,
               use_rr_intensity=config.use_russian_roulette_for_intensity,
               zeta_min=config.zeta_min,
               limit_intensity=config.limit_intensity_contributions,
               max_intensity=config.max_intensity_contribution,
               n_phase_intervals=config.min_forward_table_size)

    flux_up = (np_(bb_res.flux_up), np_(err_res.flux_up))
    flux_down = (np_(bb_res.flux_down), np_(err_res.flux_down))
    flux_abs = (np_(bb_res.flux_absorbed), np_(err_res.flux_absorbed))
    mean_stats = [(float(np_(bb_der[k])), float(np_(err_der[k])))
                  for k in ("mean_flux_up", "mean_flux_down", "mean_flux_absorbed")]
    radiance = ((np_(bb_res.intensity), np_(err_res.intensity))
                if compute_intensity else None)
    volume = (np_(bb_res.volume_absorption), np_(err_res.volume_absorption))
    # Layer-mean absorption profile, per meter, with its batch-derived stderr.
    profile = (np_(bb_der["absorbed_profile"]), np_(err_der["absorbed_profile"]))

    if mesh.rank != 0:
        out_flux = out_abs_prof = out_rad = out_netcdf = ""
    if out_flux:
        results_io.write_flux_ascii(out_flux, cfg, x_edges, y_edges, z_edges, mean_stats,
                                    flux_up, flux_down, flux_abs)
    if out_abs_prof:
        results_io.write_absorption_profile_ascii(out_abs_prof, cfg, z_edges, profile)
    if out_rad and compute_intensity:
        results_io.write_radiance_ascii(out_rad, cfg, x_edges, y_edges, z_edges, mus, phis,
                                        radiance)
    if out_netcdf:
        results_io.write_results_netcdf(
            out_netcdf, cfg, x_edges, y_edges, z_edges, flux_up, flux_down, flux_abs,
            absorption_profile=profile if report_profile else None,
            absorbed_volume=volume if report_volume else None,
            intensity=radiance, intensity_mus=mus, intensity_phis=phis)
    if not quiet:
        for band in bands:
            lam = band.wavelength_limits
            bm = float(band.mean["derived"]["mean_flux_up"])
            be = float(band.stderr["derived"]["mean_flux_up"])
            print(f"  band {lam[0]:.3f}-{lam[1]:.3f}um  f={band.spectral_fraction:.3f}  "
                  f"Fup {bm:.4f} +- {be:.4f}")
        print("Wrote results")

    return {"cfg": cfg, "mean_stats": mean_stats, "flux_up": flux_up,
            "flux_down": flux_down, "flux_absorbed": flux_abs, "radiance": radiance,
            "volume": volume, "profile": profile, "bands": bands}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m i3rc_tpu_torch.drivers.broadband_driver",
        description="Namelist-driven broadband (correlated-k) run on a PyTorch device.")
    parser.add_argument("namelist", help="namelist file")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; no CPU fallback)")
    args = parser.parse_args(argv)
    if "WORLD_SIZE" in os.environ:       # launched by torchrun
        mesh = initialize_multihost(device=args.device)
        try:
            run_from_namelist(args.namelist, device=mesh.device, mesh=mesh)
        finally:
            torch.distributed.destroy_process_group()
    else:
        run_from_namelist(args.namelist, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
