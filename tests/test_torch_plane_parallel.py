"""The plane-parallel verification driver and its slab model on the port,
run on the CPU (``--device cpu``), against the JAX package's.

``i3rc_tpu_torch/models/slab.py`` is a copy of the JAX package's slab
builder; ``i3rc_tpu_torch/drivers/plane_parallel.py`` ports its driver
(Example-Drivers/planeParallel.f95).  The slab in all three phase-function
variants equals the JAX one array for array; the driver's fluxes and
radiances agree with the JAX driver's on the same namelist within 5
combined standard errors, and its Fup with the discrete-ordinates slab
(tests/disort_oracle.py) within 4 standard errors of the batch mean.
"""

import io
from pathlib import Path

import numpy as np
import pytest
import torch

from i3rc_tpu.drivers.plane_parallel import run_from_namelist as jax_run
from i3rc_tpu.io.netcdf import write_phase_function_table
from i3rc_tpu.models.slab import make_slab_domain as jax_slab
from i3rc_tpu_torch.drivers import plane_parallel
from i3rc_tpu_torch.drivers.plane_parallel import run_from_namelist
from i3rc_tpu_torch.io.netcdf import read_domain
from i3rc_tpu_torch.models.slab import make_slab_domain

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SHIPPED = ROOT / "examples" / "planeParallel.nml"
ORACLE_FUP = 0.164878     # tests/disort_oracle.py hg_slab_fluxes(1, 1, 0.85, 0.5)


def _same_domains(a, b):
    for edges in ("x_edges", "y_edges", "z_edges"):
        assert np.array_equal(np.asarray(getattr(a, edges)), np.asarray(getattr(b, edges)))
    (ca,), (cb,) = a.components, b.components
    for name in ("extinction", "single_scattering_albedo", "phase_function_index"):
        x, y = getattr(ca, name), getattr(cb, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert np.array_equal(ca.table.key, cb.table.key)
    assert len(ca.table.phase_functions) == len(cb.table.phase_functions)
    for pa, pb in zip(ca.table.phase_functions, cb.table.phase_functions):
        for name in ("legendre_coefficients", "scattering_angle", "value"):
            x, y = getattr(pa, name), getattr(pb, name)
            assert (x is None and y is None) or np.array_equal(x, y), name


@pytest.mark.parametrize("variant", ["moments", "angles", "table_file"])
def test_slab_equals_the_original(tmp_path, variant):
    """make_slab_domain's three phase-function variants (Legendre moments,
    HG angle-value pairs, an entry of a table file): the same arrays."""
    kw = dict(g=0.8, n_legendre_coefficients=32, n_angles=181, domain_size=300.0,
              physical_thickness=120.0, n_layers=3, n_x=2, n_y=2)
    if variant == "angles":
        kw["use_moments"] = False
    elif variant == "table_file":
        path = str(tmp_path / "pf.table")
        jax_table = jax_slab(1.0, g=0.6, n_legendre_coefficients=16).components[0].table
        write_phase_function_table(jax_table, path)
        kw.update(phase_function_table_file=path, phase_function_table_index=0)
    _same_domains(jax_slab(2.0, 0.9, **kw), make_slab_domain(2.0, 0.9, **kw))


def _copy(tmp_path, name: str, **swaps) -> str:
    text = SHIPPED.read_text()
    for old, new in swaps.items():
        assert old in text
        text = text.replace(old, new)
    path = tmp_path / name
    path.write_text(text)
    return str(path)


RADIANCE = {"  surfaceAlbedo = 0.0,": "  surfaceAlbedo = 0.0,\n  intensityMus = 1., 0.5,\n"
                                      "  intensityPhis = 0., 0.,"}


@pytest.mark.parametrize("mode", ["flux", "radiance"])
def test_driver_matches_jax(tmp_path, mode):
    """The shipped namelist (ray tracing: the general kernel), and its copy
    with two radiance detectors: the port's driver against the JAX driver on
    the same file, within 5 combined standard errors (flux: the batches'
    standard deviation over sqrt(n); radiance: the drivers' RMS about the
    mean over sqrt(n - 1))."""
    path = str(SHIPPED) if mode == "flux" else _copy(tmp_path, "rad.nml", **RADIANCE)
    got = run_from_namelist(path, quiet=True, device="cpu")
    want = jax_run(path, quiet=True)
    n = 4
    if mode == "flux":
        for key in ("flux_up", "flux_down"):
            sig = np.hypot(got[f"{key}_err"], want[f"{key}_err"]) / n ** 0.5
            assert abs(got[key] - want[key]) <= 5 * sig, (key, got, want)
        assert got["flux_up"] + got["flux_down"] == pytest.approx(1.0, abs=2e-3)
        assert 0.12 < got["flux_up"] < 0.21 and got["flux_up_err"] < 0.02
    else:
        assert got["radiance"].shape == want["radiance"].shape == (2,)
        sig = np.hypot(got["radiance_err"], want["radiance_err"]) / (n - 1) ** 0.5
        assert np.all(np.abs(got["radiance"] - want["radiance"]) <= 5 * sig), (got, want)
        assert np.all(got["radiance"] > 0.0)


def test_driver_against_the_slab_oracle(tmp_path, capsys):
    """Fup of the shipped slab without ray tracing (the fastpath), 8 batches
    of 2^15 photons, within 4 standard errors of the batch mean of the
    discrete-ordinates value; the reference's table printed, and the domain
    file written when the namelist names one."""
    dom = tmp_path / "slab.dom"
    path = _copy(tmp_path, "oracle.nml", **{
        "numPhotonsPerBatch = 10000,": "numPhotonsPerBatch = 32768,",
        "numBatches = 4,": "numBatches = 8,", "useRayTracing = T,": "useRayTracing = F,",
        'domainFileName = "",': f'domainFileName = "{dom}",'})
    out = run_from_namelist(path, device="cpu")
    printed = capsys.readouterr().out
    assert "Wrote domain to file" in printed and "FluxUpErr" in printed
    sigma = out["flux_up_err"] / 8 ** 0.5
    assert abs(out["flux_up"] - ORACLE_FUP) <= 4 * sigma, (out, sigma)
    assert out["flux_up"] + out["flux_down"] == pytest.approx(1.0, abs=1e-5)
    (comp,) = read_domain(str(dom)).components     # float32 on file
    np.testing.assert_allclose(comp.extinction, np.full((1, 1, 1), 1.0 / 250.0), rtol=1e-6)


def test_main_stdin_usage_and_profile(tmp_path, monkeypatch, capsys):
    """With no argument the driver prompts for the namelist on stdin
    (userInterface_Unix.f95:70-99), empty input or two files is the usage
    error (tests/test_drivers.py:235-256), and ``--profile DIR`` writes a
    torch.profiler trace under DIR and prints its table (on the CPU, the
    host's time by torch op) to stderr."""
    nml = _copy(tmp_path, "pp.nml", **{"numPhotonsPerBatch = 10000,":
                                       "numPhotonsPerBatch = 2000,"})
    monkeypatch.setattr("sys.stdin", io.StringIO(f"{nml}\n"))
    assert plane_parallel.main(["--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert "Enter the namelist file name:" in captured.out and "Fup" in captured.out
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    assert plane_parallel.main(["--device", "cpu"]) == 1
    assert plane_parallel.main([nml, nml, "--device", "cpu"]) == 1
    assert "usage:" in capsys.readouterr().err
    trace = tmp_path / "trace"
    assert plane_parallel.main(["--profile", str(trace), nml, "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "host time by torch op" in err and "a CPU run: no device" in err
    assert list(trace.glob("trace-*.json"))
