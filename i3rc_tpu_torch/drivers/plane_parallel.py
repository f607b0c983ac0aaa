"""Plane-parallel slab driver on a PyTorch device: the verification tool.

Port of ``i3rc_tpu/drivers/plane_parallel.py`` (Example-Drivers/
planeParallel.f95): builds a homogeneous slab in code (no input files), runs
numBatches independent batches, and prints domain-mean fluxes (or radiances)
with between-batch errors to stdout in the reference's tabular format
(:241-273).  Accepts the reference's shipped planeParallel namelist files:

    python -m i3rc_tpu_torch.drivers.plane_parallel [--device cuda] planeParallel.nml

``--device`` defaults to ``cuda``; a missing GPU raises instead of running
on the CPU.  ``--profile DIR`` traces the run with ``torch.profiler`` into DIR
and prints the device time by kernel to stderr (``utils/profiling.py``).
"""

from __future__ import annotations

import sys

import numpy as np

from i3rc_tpu_torch.core.illumination import PhotonSource
from i3rc_tpu_torch.core.rng import batch_key
from i3rc_tpu_torch.core.surface import SurfaceDescription
from i3rc_tpu_torch.drivers.nml_common import get as _get
from i3rc_tpu_torch.integrators.config import IntegratorConfig
from i3rc_tpu_torch.integrators.integrator import Integrator
from i3rc_tpu_torch.models.slab import make_slab_domain
from i3rc_tpu_torch.utils.namelist import read_namelist

USAGE = ("usage: python -m i3rc_tpu_torch.drivers.plane_parallel [--device DEV] "
         "[--profile DIR] <namelist.nml>")


def run_from_namelist(namelist_path: str, quiet: bool = False, device="cuda") -> dict:
    g = read_namelist(namelist_path)

    # radiativeTransfer (:47-57)
    solar_mu = float(_get(g, "radiativetransfer", "solarmu", 0.5))
    solar_azimuth = float(_get(g, "radiativetransfer", "solarazimuth", 0.0))
    surface_albedo = float(_get(g, "radiativetransfer", "surfacealbedo", 0.0))
    intensity_mus = np.atleast_1d(np.asarray(
        _get(g, "radiativetransfer", "intensitymus", [0.0]), dtype=np.float64))
    intensity_phis = np.atleast_1d(np.asarray(
        _get(g, "radiativetransfer", "intensityphis", [0.0]), dtype=np.float64))
    # monteCarlo (:61-64)
    n_photons = int(_get(g, "montecarlo", "numphotonsperbatch", 100_000))
    n_batches = int(_get(g, "montecarlo", "numbatches", 4))
    iseed = int(_get(g, "montecarlo", "iseed", 10))
    n_phase_intervals = int(_get(g, "montecarlo", "nphaseintervals", 10_000))
    # algorithms (:69-79)
    use_ray_tracing = bool(_get(g, "algorithms", "useraytracing", True))
    use_rr = bool(_get(g, "algorithms", "userussianroulette", True))
    use_hybrid = bool(_get(g, "algorithms", "usehybridphasefunsforintencalcs", False))
    hybrid_width = float(_get(g, "algorithms", "hybridphasefunwidth", 7.0))
    n_orders_orig = int(_get(g, "algorithms", "numordersorigphasefunintencalcs", 0))
    use_rr_intensity = bool(_get(g, "algorithms", "userussianrouletteforintensity", True))
    zeta_min = float(_get(g, "algorithms", "zetamin", 0.0))
    # problemOptics (:84-99)
    ssa = float(_get(g, "problemoptics", "ssa", 1.0))
    optical_depth = float(_get(g, "problemoptics", "opticaldepth", 1.0))
    hg_g = float(_get(g, "problemoptics", "g", 0.85))
    n_coeffs = int(_get(g, "problemoptics", "nlegendrecoefficients", 64))
    n_angles = int(_get(g, "problemoptics", "nangles", 5000))
    use_moments = bool(_get(g, "problemoptics", "usemoments", True))
    table_file = str(_get(g, "problemoptics", "phasefunctiontablefile", ""))
    table_index = int(_get(g, "problemoptics", "phasefunctiontableindex", 0))
    # problemDomain (:101-106)
    domain_size = float(_get(g, "problemdomain", "domainsize", 500.0))
    thickness = float(_get(g, "problemdomain", "physicalthickness", 250.0))
    n_layers = int(_get(g, "problemdomain", "nlayers", 1))
    n_x = int(_get(g, "problemdomain", "nx", 1))
    n_y = int(_get(g, "problemdomain", "ny", 1))
    use_surface = bool(_get(g, "problemdomain", "usesurfaceproperties", False))
    # filenames
    domain_file = str(_get(g, "filenames", "domainfilename", ""))

    active = np.abs(intensity_mus) > 0.0
    compute_intensity = bool(active.any())
    mus = intensity_mus[active] if compute_intensity else None
    phis = intensity_phis[: intensity_mus.size][active] if compute_intensity else None

    domain = make_slab_domain(
        optical_depth, ssa, g=hg_g, use_moments=use_moments,
        n_legendre_coefficients=n_coeffs, n_angles=n_angles,
        domain_size=domain_size, physical_thickness=thickness,
        n_layers=n_layers, n_x=n_x, n_y=n_y,
        phase_function_table_file=table_file,
        phase_function_table_index=table_index)
    if domain_file:
        from i3rc_tpu_torch.io.netcdf import write_domain

        write_domain(domain, domain_file)
        if not quiet:
            print(f"Wrote domain to file {domain_file}")

    config = IntegratorConfig(
        use_ray_tracing=use_ray_tracing, use_russian_roulette=use_rr,
        use_hybrid_phase_funs=use_hybrid, hybrid_phase_fun_width=hybrid_width,
        num_orders_orig_phase_fun=n_orders_orig,
        use_russian_roulette_for_intensity=use_rr_intensity, zeta_min=zeta_min,
        min_forward_table_size=n_phase_intervals,
        min_inverse_table_size=n_phase_intervals)
    surface = SurfaceDescription.uniform([surface_albedo]) if use_surface else None
    integ = Integrator.create(
        domain, config=config,
        surface_albedo=0.0 if use_surface else surface_albedo,
        surface=surface, intensity_mus=mus, intensity_phis=phis, device=device)
    source = PhotonSource.directional(solar_mu, solar_azimuth)

    # Per-batch loop with between-batch statistics (:202-236).
    fups, fdns, fabss, rads = [], [], [], []
    for b in range(1, n_batches + 1):
        # The reference seeds with (batch, iseed) (planeParallel.f95:207).
        res = integ.compute(batch_key(iseed, b), source, n_photons)
        fups.append(float(res.mean_flux_up))
        fdns.append(float(res.mean_flux_down))
        fabss.append(float(res.mean_flux_absorbed))
        if compute_intensity:
            rads.append(res.mean_intensity.double().cpu().numpy())

    theta0 = np.degrees(np.arccos(solar_mu))
    out = {}
    if compute_intensity:
        rads = np.stack(rads)  # (batches, D)
        mean_rad = rads.mean(axis=0)
        err_rad = np.sqrt(np.mean((rads - mean_rad) ** 2, axis=0))
        if not quiet:
            print("  tau  omega   g  theta0    mu   phi radiance    error")
            for i in range(mus.size):
                print(f"{optical_depth:6.2f} {ssa:5.3f} {hg_g:5.3f}  {theta0:5.2f} "
                      f"{mus[i]:7.5f} {int(phis[i]):3d} {mean_rad[i]:8.6f} {err_rad[i]:10.8f}")
        out.update(radiance=mean_rad, radiance_err=err_rad)
    else:
        mean_up, mean_dn, mean_ab = np.mean(fups), np.mean(fdns), np.mean(fabss)
        if n_batches > 1:
            err_up = np.std(fups, ddof=1)
            err_dn = np.std(fdns, ddof=1)
            err_ab = np.std(fabss, ddof=1)
        else:
            err_up = err_dn = err_ab = 0.0
        if not quiet:
            print("  tau  omega   g  theta0   Fup      Fdn    FluxUpErr FluxDownErr"
                  " FluxAbs FluxAbsErr")
            print(f"{optical_depth:6.2f} {ssa:5.3f} {hg_g:5.3f}  {theta0:5.2f} "
                  f"{mean_up:7.5f}   {mean_dn:7.5f}   {err_up:7.5f}   {err_dn:7.5f}"
                  f"   {mean_ab:7.5f}   {err_ab:7.5f}")
        out.update(flux_up=mean_up, flux_down=mean_dn, flux_absorbed=mean_ab,
                   flux_up_err=err_up, flux_down_err=err_dn, flux_absorbed_err=err_ab)
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    profile_dir = None
    if "--profile" in argv:
        i = argv.index("--profile")
        profile_dir = argv[i + 1] if i + 1 < len(argv) else "profile_trace"
        argv = argv[:i] + argv[i + 2 if i + 1 < len(argv) else i + 1:]
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print(USAGE, file=sys.stderr)
            return 1
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if len(argv) == 0:
        # getOneArgument's stdin fallback (userInterface_Unix.f95:70-99):
        # with no CLI argument the reference prompts for the file name.
        print("Enter the namelist file name: ", end="", flush=True)
        line = sys.stdin.readline().strip()
        if line:
            argv = [line]
    if len(argv) != 1:
        print(USAGE, file=sys.stderr)
        return 1
    if profile_dir:
        from i3rc_tpu_torch.utils.profiling import profile_report, profile_run

        profile_run(lambda: run_from_namelist(argv[0], device=device), profile_dir, device)
        print(profile_report(profile_dir), file=sys.stderr)
    else:
        run_from_namelist(argv[0], device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
