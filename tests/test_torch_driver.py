"""The port's namelist driver, run on the CPU (``--device cpu``)."""

import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from i3rc_tpu_torch.drivers.monte_carlo_driver import main, run_from_namelist
from i3rc_tpu_torch.models.step_cloud import write_domains

torch.set_num_threads(2)
ANCHOR_FUP = 0.58054   # tests/test_external_validation.py:227


def _namelist(tmp_path, radiative="", algorithms="useRayTracing = .false.,",
              domain="StepCloud_NonAbsorbing.opt", files=""):
    text = textwrap.dedent(f"""
    &radiativeTransfer
      solarFlux = 2., solarMu = 0.5, solarAzimuth = 0., {radiative}
    /
    &monteCarlo
      numPhotonsPerBatch = 4096, numBatches = 4, iseed = 7
    /
    &algorithms
      {algorithms}
    /
    &fileNames
      domainFileName = "{tmp_path}/{domain}",
      {files}
    /
    &output
      reportAbsorptionProfile = .true., reportVolumeAbsorption = .true.
    /
    """)
    path = tmp_path / "run.nml"
    path.write_text(text)
    return str(path)


def test_driver_flux_outputs(tmp_path):
    write_domains(str(tmp_path))
    nml = _namelist(tmp_path, domain="StepCloud_Absorbing.opt", files=f"""
      outputFluxFile = "{tmp_path}/fluxes.out",
      outputAbsProfFile = "{tmp_path}/absprof.out",
      outputNetcdfFile = "{tmp_path}/out.nc" """)
    assert main([nml, "--device", "cpu"]) == 0
    for name in ("fluxes.out", "absprof.out", "out.nc"):
        assert (tmp_path / name).is_file()
    out = run_from_namelist(nml, quiet=True, device="cpu")
    assert out["cfg"]["num_batches"] == 4 and out["cfg"]["num_photons"] == 4 * 4096
    # solarFlux scaling: the three fluxes sum to solarFlux exactly.
    m = out["mean_stats"]
    assert m[0][0] + m[1][0] + m[2][0] == pytest.approx(2.0, abs=1e-4)
    assert 0 < m[0][1] < 0.05
    header = (tmp_path / "fluxes.out").read_text().splitlines()
    assert header[0].startswith("!   I3RC Monte Carlo")
    with netcdf_file(str(tmp_path / "out.nc"), "r", mmap=False) as nc:
        assert nc.variables["fluxUp"].shape == (1, 32)
        assert "absorptionProfile" in nc.variables and "fluxUp_StdErr" in nc.variables
        assert nc.Algorithm == b"Max_cross_section"


def test_driver_step_cloud_anchor(tmp_path):
    write_domains(str(tmp_path))
    out = run_from_namelist(_namelist(tmp_path), quiet=True, device="cpu")
    (fup, _), (fdn, _), (fabs, _) = out["mean_stats"]
    # 4 batches give a noisy stderr; gate on the binomial sigma of all photons.
    sigma = (ANCHOR_FUP * (1 - ANCHOR_FUP) / out["cfg"]["num_photons"]) ** 0.5
    assert fup / 2 == pytest.approx(ANCHOR_FUP, abs=4 * sigma)
    assert fup + fdn == pytest.approx(2.0, abs=1e-4) and fabs == 0.0


@pytest.mark.parametrize("radiance", [False, True])
def test_driver_surface_albedo(tmp_path, radiance):
    """surfaceAlbedo > 0 runs, with and without radiance detectors: the flux
    file (and the radiance file) written, Fup above the black surface's
    anchor, the upward radiance finite and positive."""
    write_domains(str(tmp_path))
    rad = ("intensityMus = 1., .5, intensityPhis = 0., 180.," if radiance else "")
    files = f'outputFluxFile = "{tmp_path}/fluxes.out",' + (
        f' outputRadFile = "{tmp_path}/rad.out"' if radiance else "")
    out = run_from_namelist(_namelist(tmp_path, radiative=f"surfaceAlbedo = 0.3, {rad}",
                                      files=files), quiet=True, device="cpu")
    assert (tmp_path / "fluxes.out").is_file() and (tmp_path / "rad.out").is_file() == radiance
    (fup, fup_e), (fdn, _), (fabs, _) = out["mean_stats"]
    assert out["cfg"]["surface_albedo"] == 0.3 and fabs == 0.0
    assert fup / 2 > ANCHOR_FUP + 0.02 and fdn / 2 > 1.0 - ANCHOR_FUP
    if radiance:
        assert np.isfinite(out["radiance"][0]).all() and float(out["radiance"][0].min()) > 0.0


ANCHOR_I = (0.1285, 0.3285, 0.1800)   # chip_smoke.py: the I3RC detector set


@pytest.mark.parametrize("algorithms", ["useRayTracing = .true.,", ""],
                         ids=["ray_tracing", "reference_default"])
def test_driver_radiance_with_ray_tracing(tmp_path, algorithms):
    """Radiance with ray tracing, asked for or the reference's default:
    the general kernel's local estimate writes rad.out (3 detectors) and
    the netCDF record says Ray_tracing; each radiance within 5 of the
    driver's standard errors plus 5% of the step cloud's anchor (4 batches
    of 512 photons)."""
    write_domains(str(tmp_path))
    nml = _namelist(tmp_path, radiative="intensityMus = 1., .5, .5, "
                    "intensityPhis = 0., 0., 180.,", algorithms=algorithms,
                    files=f'outputRadFile = "{tmp_path}/rad.out", '
                          f'outputNetcdfFile = "{tmp_path}/rad.nc"')
    Path(nml).write_text(Path(nml).read_text().replace("numPhotonsPerBatch = 4096",
                                                       "numPhotonsPerBatch = 512"))
    out = run_from_namelist(nml, quiet=True, device="cpu")
    assert out["cfg"]["use_ray_tracing"] and (tmp_path / "rad.out").is_file()
    m, e = out["radiance"]
    # solarFlux = 2 scales every field.
    i_m = out["stats"].mean["derived"]["mean_intensity"].numpy() / 2.0
    i_e = out["stats"].stderr["derived"]["mean_intensity"].numpy() / 2.0
    assert m.shape == (32, 1, 3) and np.isfinite(m).all() and np.isfinite(e).all()
    for d, anchor in enumerate(ANCHOR_I):
        assert abs(i_m[d] - anchor) <= 5 * i_e[d] + 0.05 * anchor, (d, i_m, i_e)
    with netcdf_file(str(tmp_path / "rad.nc"), "r", mmap=False) as nc:
        assert nc.Algorithm == b"Ray_tracing" and "intensity" in nc.variables


@pytest.mark.parametrize("kwargs,item", [
    (dict(algorithms="useRayTracing = .false., polarized = .true.,"), "item 17"),
])
def test_driver_rejects_out_of_slice(tmp_path, kwargs, item):
    write_domains(str(tmp_path))
    with pytest.raises(NotImplementedError, match=item):
        run_from_namelist(_namelist(tmp_path, **kwargs), quiet=True, device="cpu")
