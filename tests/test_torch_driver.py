"""The port's namelist driver, run on the CPU (``--device cpu``)."""

import textwrap

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


@pytest.mark.parametrize("kwargs,item", [
    (dict(radiative="surfaceAlbedo = 0.3, intensityMus = 1., intensityPhis = 0.",
          files='outputRadFile = "rad.out"'), "item 11"),
    (dict(radiative="surfaceAlbedo = 0.3,"), "item 11"),
    (dict(algorithms="useRayTracing = .false., polarized = .true.,"), "item 17"),
    (dict(algorithms="useRayTracing = .true.,"), "item 16"),
    (dict(algorithms=""), "item 16"),    # the reference default is ray tracing
])
def test_driver_rejects_out_of_slice(tmp_path, kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        run_from_namelist(_namelist(tmp_path, **kwargs), quiet=True, device="cpu")
