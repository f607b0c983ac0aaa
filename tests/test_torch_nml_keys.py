"""The port's namelist driver reads the &algorithms keys the JAX driver reads.

``numOrdersOrigPhaseFunIntenCalcs`` (the orders of a radiance estimate that
take the original phase function before the hybrid one) and
``majorantBlockSize`` (the super-voxel majorant, 16 by default, 0 the
reference's one global majorant) reach ``IntegratorConfig`` as in
i3rc_tpu/drivers/monte_carlo_driver.py:59, :69, :96, :103.  Run on the CPU,
on the 32 x 1 x 8 step cloud of tests/general_scenes.py (the JAX package's
ray tracing on the full 32 x 1 x 32 cloud takes minutes here).
"""

import dataclasses
import importlib.util
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import i3rc_tpu.drivers.monte_carlo_driver as jax_driver
import i3rc_tpu_torch.drivers.monte_carlo_driver as port_driver
from i3rc_tpu_torch.io.netcdf import write_domain

torch.set_num_threads(2)
_spec = importlib.util.spec_from_file_location("general_scenes",
                                               Path(__file__).with_name("general_scenes.py"))
_scenes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_scenes)


def write_cloud(tmp_path) -> None:
    write_domain(_scenes.step_cloud_32x8(_scenes.host("i3rc_tpu_torch"), 1.0),
                 str(tmp_path / "cloud.dom"))


def _namelist(tmp_path, tag: str, algorithms: str) -> str:
    path = tmp_path / f"{tag}.nml"
    path.write_text(textwrap.dedent(f"""
    &radiativeTransfer
      solarFlux = 1., solarMu = 0.5, solarAzimuth = 0.,
      intensityMus = 1., 0.5, intensityPhis = 0., 0.,
    /
    &monteCarlo
      numPhotonsPerBatch = 1024, numBatches = 4, iseed = 5
    /
    &algorithms
      useRayTracing = .true., useHybridPhaseFunsForIntenCalcs = .true.,
      hybridPhaseFunWidth = 7., useRussianRouletteForIntensity = .false.,
      {algorithms}
    /
    &fileNames
      domainFileName = "{tmp_path}/cloud.dom",
      outputRadFile = "{tmp_path}/{tag}_rad.out"
    /
    &output
    /
    """))
    return str(path)


class _Capture:
    """Integrator.create of one driver module, recording each config."""

    def __init__(self, real):
        self.real, self.configs = real, []

    def create(self, domain, config=None, **kw):
        self.configs.append(config)
        return self.real.create(domain, config=config, **kw)


def _run_both(tmp_path, monkeypatch, algorithms: str):
    """Both drivers on the same namelist: (port's, JAX's) config and results."""
    write_cloud(tmp_path)
    out = []
    for tag, mod, run in (("port", port_driver,
                           lambda p: port_driver.run_from_namelist(p, quiet=True, device="cpu")),
                          ("jax", jax_driver, lambda p: jax_driver.run_from_namelist(p, quiet=True))):
        cap = _Capture(mod.Integrator)
        monkeypatch.setattr(mod, "Integrator", cap)
        res = run(_namelist(tmp_path, tag, algorithms))
        assert len(cap.configs) == 1
        out.append((cap.configs[0], res))
    return out


def test_orders_and_majorant_reach_the_config(tmp_path, monkeypatch):
    """Hybrid phase functions with N = 2 orders of the original one and
    8-cell super-voxels: the IntegratorConfig that reaches
    Integrator.create equals the JAX driver's field by field, and the two
    drivers' radiances agree within 5 combined standard errors."""
    (tcfg, tres), (jcfg, jres) = _run_both(
        tmp_path, monkeypatch,
        "numOrdersOrigPhaseFunIntenCalcs = 2, majorantBlockSize = 8,")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.num_orders_orig_phase_fun, tcfg.majorant_block_size) == (2, 8)
    assert tcfg.use_hybrid_phase_funs
    i_t = np.asarray(tres["stats"].mean["derived"]["mean_intensity"], np.float64)
    e_t = np.asarray(tres["stats"].stderr["derived"]["mean_intensity"], np.float64)
    i_j = np.asarray(jres["stats"].mean["derived"]["mean_intensity"], np.float64)
    e_j = np.asarray(jres["stats"].stderr["derived"]["mean_intensity"], np.float64)
    assert i_t.shape == i_j.shape == (2,) and np.all(i_t > 0.0)
    assert np.all(np.abs(i_t - i_j) <= 5 * np.hypot(e_t, e_j)), (i_t, e_t, i_j, e_j)


@pytest.mark.parametrize("algorithms,majorant", [("majorantBlockSize = 0,", 0), ("", 16)])
def test_majorant_block_size_default_and_zero(tmp_path, monkeypatch, algorithms, majorant):
    """An explicit majorantBlockSize = 0 (the reference's one global
    majorant) reaches the config as 0, and an absent key as JAX's default,
    16; the orders default to 0, as in the JAX driver."""
    write_cloud(tmp_path)
    cap = _Capture(port_driver.Integrator)
    monkeypatch.setattr(port_driver, "Integrator", cap)
    path = _namelist(tmp_path, "port", algorithms)
    text = open(path).read().replace("numPhotonsPerBatch = 1024", "numPhotonsPerBatch = 256")
    open(path, "w").write(text)
    port_driver.run_from_namelist(path, quiet=True, device="cpu")
    (cfg,) = cap.configs
    assert cfg.majorant_block_size == majorant and cfg.num_orders_orig_phase_fun == 0


def test_polarized_namelist_warns_of_no_majorant(tmp_path):
    """The polarized branch passes on what its path runs (one global
    majorant, column absorption): a namelist that sets no ignored flag
    draws no I3RCWarning from PolarizedIntegrator.create
    (integrators/polarized.py IGNORED_FLAGS)."""
    from i3rc_tpu_torch.utils.errors import I3RCWarning

    spec = importlib.util.spec_from_file_location(
        "polarized_scenes", Path(__file__).with_name("polarized_scenes.py"))
    scenes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scenes)
    dom_path = str(tmp_path / "ray.dom")
    write_domain(scenes.rayleigh_slab(scenes.host("i3rc_tpu_torch"), 0.5), dom_path)
    nml = tmp_path / "pol.nml"
    nml.write_text(textwrap.dedent(f"""
    &radiativeTransfer
      solarFlux = 1., solarMu = 0.6, solarAzimuth = 0.,
    /
    &monteCarlo
      numPhotonsPerBatch = 512, numBatches = 2, iseed = 3
    /
    &algorithms
      useRayTracing = .false., useRussianRouletteForIntensity = .false., polarized = .true.,
    /
    &fileNames
      domainFileName = "{dom_path}",
    /
    &output
    /
    """))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        port_driver.run_from_namelist(str(nml), quiet=True, device="cpu")
    assert not [w for w in caught if issubclass(w.category, I3RCWarning)], \
        [str(w.message) for w in caught]
