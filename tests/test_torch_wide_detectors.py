"""More than 16 radiance detectors on a plan the fastpath would take: the
event block's parameter block holds 16, so the port's planner gives the
plan no fastpath plan and the general kernel's estimate stage (G+E) runs
it; the JAX package runs it on its XLA fastpath (past K D = 32,
i3rc_tpu/integrators/fastpath.py:1702-1712).  On a separable HG cloud
(tests/reach_scenes.py ``grid``, 8 x 1 x 8 cells) with 17 and 32 directions
(``scan``, each set a prefix of the 32), the exact estimator (the JAX
fastpath's Iwabuchi roulette drops exp(-tau), ROADMAP Queue 3): each
detector's domain-mean radiance within 4 combined standard errors of JAX's
32-detector run (batch means of 4 batches a side), the fluxes within 4
combined standard errors, and the port's closure within 1e-5.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import reach_scenes as rs  # noqa: E402

torch.set_num_threads(2)
BATCHES = 4
PORT_PHOTONS, JAX_PHOTONS = 1 << 10, 1 << 11


def _derive_port(res):
    return {"I": res.intensity.mean(dim=(0, 1)), "fup": res.mean_flux_up,
            "fdn": res.mean_flux_down}


@pytest.fixture(scope="module")
def jax_run():
    from i3rc_tpu.parallel.mesh import default_mesh
    from i3rc_tpu.parallel.mesh import run_batches as jax_run_batches

    h = rs.host("i3rc_tpu")
    mus, phis = rs.scan(32)
    cfg = h.Config(use_ray_tracing=False, max_events=500, compute_volume_absorption=False,
                   fastpath_unroll=1)
    integ = h.Integrator.create(rs.grid(h, rs.hg_table(h)), cfg, intensity_mus=mus,
                                intensity_phis=phis)
    derive = lambda r: {"I": jnp.mean(r.intensity, axis=(0, 1)), "fup": r.mean_flux_up,
                        "fdn": r.mean_flux_down}
    st = jax_run_batches(integ, h.Source.directional(0.5, 0.0), JAX_PHOTONS, BATCHES, seed=3,
                         n_lanes=JAX_PHOTONS, mesh=default_mesh(jax.devices()[:1]),
                         derive=derive, derive_token="I_fup_fdn")
    return {k: (np.asarray(st.mean["derived"][k]), np.asarray(st.stderr["derived"][k]))
            for k in ("I", "fup", "fdn")}


@pytest.mark.parametrize("n_dirs", [17, 32])
def test_wide_detectors_run_on_the_general_kernel_and_match_jax(jax_run, n_dirs):
    from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource, run_batches

    h = rs.host("i3rc_tpu_torch")
    mus, phis = rs.scan(n_dirs)
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                           compute_volume_absorption=False)
    integ = Integrator.create(rs.grid(h, rs.hg_table(h)), cfg, intensity_mus=mus,
                              intensity_phis=phis, device="cpu")
    assert integ._fast_plan is None          # past MAX_DETECTORS: G+E
    st = run_batches(integ, PhotonSource.directional(0.5, 0.0), PORT_PHOTONS, BATCHES, seed=5,
                     n_lanes=PORT_PHOTONS, derive=_derive_port)
    mean = {k: st.mean["derived"][k].numpy() for k in ("I", "fup", "fdn")}
    err = {k: st.stderr["derived"][k].numpy() for k in ("I", "fup", "fdn")}
    ji, je = jax_run["I"][0][:n_dirs], jax_run["I"][1][:n_dirs]
    assert mean["I"].shape == (n_dirs,) and np.all(mean["I"] > 0.0)
    sigma = np.hypot(err["I"], je)
    assert np.all(np.abs(mean["I"] - ji) <= 4 * sigma), (mean["I"], ji, sigma)
    for k in ("fup", "fdn"):
        assert abs(mean[k] - jax_run[k][0]) <= 4 * np.hypot(err[k], jax_run[k][1]), k
    assert float(mean["fup"] + mean["fdn"]) == pytest.approx(1.0, abs=1e-5)
