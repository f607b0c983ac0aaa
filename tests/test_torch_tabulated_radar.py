"""The I3RC radar cloud (case 2, 640 x 1 x 54) with the Dermendjian C.1
tabulated phase function on the port's general kernel against the C++
scalar Monte Carlo oracle (i3rc_tpu/native/scalar_mc.cc, built into a
temporary directory here; the test skips only if no C++ compiler builds
it), as tests/test_external_validation.py:293-331 holds the JAX package.

The scene is neither separable nor one layer per column, so both planners
send it to the general kernel.  The oracle samples C.1 by exact
piecewise-quadratic CDF inversion over its (mu, value) pairs; the port
samples the 256-segment cubic mu(p) fit: the same distribution, independent
implementations.  Fup within 3 combined binomial sigma (the JAX test's
gate), n_bad below 1e-3 of the photons.
"""

import importlib.util
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource, batch_key
from i3rc_tpu_torch.models.radar_cloud import DATA_DIR, load_extinction, make_radar_cloud

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """i3rc_tpu/native/scalar_mc's binding, loaded from a copy beside a
    library built here from scalar_mc.cc (the package directory stays as
    it is)."""
    src = Path(__file__).resolve().parents[1] / "i3rc_tpu" / "native"
    out = tmp_path_factory.mktemp("native")
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the native oracle")
    built = subprocess.run([cxx, "-O3", "-shared", "-fPIC", "-std=c++17",
                            str(src / "scalar_mc.cc"), "-o", str(out / "_scalar_mc.so")],
                           capture_output=True, text=True)
    if built.returncode != 0:
        pytest.skip(f"the native oracle does not build: {built.stderr[-300:]}")
    shutil.copy(src / "scalar_mc.py", out / "scalar_mc.py")
    spec = importlib.util.spec_from_file_location("scalar_mc_copy", out / "scalar_mc.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.available()
    return mod


def test_radar_cloud_c1_matches_native_oracle(native):
    n = 1 << 14
    dom = make_radar_cloud("c1")
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=2000,
                           compute_volume_absorption=False, majorant_block_size=16)
    integ = Integrator.create(dom, config=cfg, device="cpu")
    assert integ._fast_plan is None          # not separable, not one layer a column
    res = integ.batch_fn(PhotonSource.directional(0.5, 0.0), n)(batch_key(21, 0))
    fup = float(res.mean_flux_up)
    raw = np.loadtxt(Path(DATA_DIR) / "C.1_PF")
    mu = np.cos(np.deg2rad(raw[:, 0]))[::-1].copy()   # ascending in mu
    val = raw[:, 1][::-1].copy()
    ext = load_extinction()
    ro = native.trace(ext, np.ones_like(ext), 0.0, np.asarray(dom.x_edges),
                      np.asarray(dom.y_edges), np.asarray(dom.z_edges), 0.5, 0.0, 4 * n,
                      seed=23, phase_mu=mu, phase_val=val)
    fup_o = ro["flux_up"].sum() / (4 * n)
    sigma = np.sqrt(fup_o * (1 - fup_o) * (1.0 / n + 1.0 / (4 * n)))
    assert abs(fup - fup_o) <= 3 * sigma, (fup, fup_o, sigma)
    assert abs(float(res.mean_flux_up + res.mean_flux_down) - 1.0) <= 1e-3
    assert ro["n_bad"] == 0 and int(res.n_bad) < 1e-3 * n
