"""The general kernel through the drivers and the spectral loop, port
against the JAX package on the CPU (small namelists):

  * ``monteCarloDriver`` with ``useRayTracing = .true.`` on the step cloud:
    the domain-mean fluxes of the two drivers within 4 combined standard
    errors (each driver's own batch statistics), and both netCDF files
    recording the algorithm as ``Ray_tracing``;
  * ``run_band(mode="traced")``: the k points' optics swapped into one
    general-kernel integrator (the JAX package's traced override loop,
    bake_fastpath=False), each k point's Fup, Fdn and Fabs within 4
    combined standard errors of the JAX band's.
"""

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from i3rc_tpu.drivers.monte_carlo_driver import run_from_namelist as jax_run
from i3rc_tpu.integrators import spectral as jspectral
from i3rc_tpu_torch import run_band
from i3rc_tpu_torch.drivers.monte_carlo_driver import run_from_namelist
from i3rc_tpu_torch.models.step_cloud import write_domains
from tests.general_cases import JAX, PORT, step_cloud_32x8

torch.set_num_threads(2)


def test_ray_tracing_driver_matches_jax(tmp_path):
    write_domains(str(tmp_path))
    out = {}
    for side, run in (("jax", lambda p: jax_run(p, quiet=True)),
                      ("port", lambda p: run_from_namelist(p, quiet=True, device="cpu"))):
        nml = tmp_path / f"{side}.nml"
        nml.write_text(f"""
&radiativeTransfer
  solarFlux = 1., solarMu = 0.5, solarAzimuth = 0.
/
&monteCarlo
  numPhotonsPerBatch = 1024, numBatches = 4, iseed = 5
/
&algorithms
  useRayTracing = .true., maxEvents = 500
/
&fileNames
  domainFileName = "{tmp_path}/StepCloud_Absorbing.opt",
  outputFluxFile = "{tmp_path}/{side}.out", outputNetcdfFile = "{tmp_path}/{side}.nc"
/
""")
        out[side] = run(str(nml))
        with netcdf_file(str(tmp_path / f"{side}.nc"), "r", mmap=False) as nc:
            assert nc.Algorithm == b"Ray_tracing"
    for (jm, je), (tm, te) in zip(out["jax"]["mean_stats"], out["port"]["mean_stats"]):
        assert abs(jm - tm) <= 4 * np.hypot(je, te) + 1e-6, (jm, tm, je, te)


def test_traced_band_matches_jax():
    z = np.asarray(step_cloud_32x8(PORT).z_edges)
    kds = {}
    for h in (JAX, PORT):
        kd_mod = __import__(f"{h.pkg}.core.k_distribution", fromlist=["KDistribution"])
        kds[h.pkg] = kd_mod.KDistribution.create(
            z, np.broadcast_to([[2e-4, 2e-3]], (8, 2)).copy(), [0.8, 0.2],
            wavelength_limits=(0.5, 0.7), spectral_fraction=0.9)
    cfg = dict(use_ray_tracing=False, max_events=500, compute_volume_absorption=False,
               majorant_block_size=4)
    means = lambda r: {"fup": r.mean_flux_up, "fdn": r.mean_flux_down,
                       "fabs": r.mean_flux_absorbed}
    jkd, tkd = kds["i3rc_tpu"], kds["i3rc_tpu_torch"]
    jdom, tdom = step_cloud_32x8(JAX, 1.0), step_cloud_32x8(PORT, 1.0)
    jinteg = JAX.Integrator.create(jspectral.domain_with_gas_component(
        jdom, jkd.absorption_profiles_on(z)[:, 0]), config=JAX.Config(**cfg))
    jband = jspectral.run_band(jinteg, jdom, jkd, JAX.Source.directional(0.5, 0.0), 1024, 4,
                               seed=3, derive=means)
    from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component

    tinteg = PORT.Integrator.create(domain_with_gas_component(
        tdom, tkd.absorption_profiles_on(z)[:, 0]), config=PORT.Config(**cfg), device="cpu")
    assert tinteg._fast_plan is not None      # traced overrides the fastpath's plan
    tband = run_band(tinteg, tdom, tkd, PORT.Source.directional(0.5, 0.0), 1024, 4, seed=3,
                     derive=means, mode="traced", n_lanes=1024)
    assert len(tband.per_k) == len(jband.per_k) == 2
    for js, ts in zip(jband.per_k, tband.per_k):
        for k in ("fup", "fdn", "fabs"):
            jm, je = float(js.mean["derived"][k]), float(js.stderr["derived"][k])
            tm, te = float(ts.mean["derived"][k]), float(ts.stderr["derived"][k])
            assert abs(jm - tm) <= 4 * np.hypot(je, te) + 1e-6, (k, jm, tm, je, te)
    d = tband.mean["derived"]
    assert float(d["fup"] + d["fdn"] + d["fabs"]) == pytest.approx(1.0, abs=5e-3)
