"""The general kernel with radiance detectors past 254 components: the ray
record's tally slot (comp + 1) is 16 bits since the 8-bit field refused
them.  A separable HG cloud (tests/reach_scenes.py ``grid``, 8 x 1 x 8
cells) split into 300 components of equal optics (each 1/300 of the
extinction: the physics of the one component) runs on the port's general
kernel with the I3RC detectors (exact estimator): each detector's
domain-mean radiance within 4 combined standard errors of the JAX
package's on the one-component cloud (its XLA fastpath; the JAX general
path on 300 components takes ~50 s to fit its tables and ~85 s to compile
on this CPU), the fluxes too, and the weight of the components' slots past
255 in the radiance split by component.
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
PORT_PHOTONS, JAX_PHOTONS = 1 << 10, 1 << 12
N_COMP = 300


def test_300_components_with_detectors_match_jax():
    from i3rc_tpu.parallel.mesh import default_mesh
    from i3rc_tpu.parallel.mesh import run_batches as jax_run_batches
    from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource, run_batches

    hj = rs.host("i3rc_tpu")
    jcfg = hj.Config(use_ray_tracing=False, max_events=500, compute_volume_absorption=False,
                     fastpath_unroll=1)
    jinteg = hj.Integrator.create(rs.grid(hj, rs.hg_table(hj)), jcfg,
                                  intensity_mus=rs.I3RC_MUS, intensity_phis=rs.I3RC_PHIS)
    jst = jax_run_batches(jinteg, hj.Source.directional(0.5, 0.0), JAX_PHOTONS, BATCHES,
                          seed=4, n_lanes=JAX_PHOTONS, mesh=default_mesh(jax.devices()[:1]),
                          derive=lambda r: {"I": jnp.mean(r.intensity, axis=(0, 1)),
                                            "fup": r.mean_flux_up},
                          derive_token="I_fup")

    h = rs.host("i3rc_tpu_torch")
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                           compute_volume_absorption=False)
    integ = Integrator.create(rs.split_components(h, rs.grid(h, rs.hg_table(h)), N_COMP), cfg,
                              intensity_mus=rs.I3RC_MUS, intensity_phis=rs.I3RC_PHIS,
                              device="cpu")
    assert integ._fast_plan is None and integ.device_optics.n_components == N_COMP
    byc = {}

    def derive(res):
        byc["split"], byc["total"] = res.intensity_by_component, res.intensity
        return {"I": res.intensity.mean(dim=(0, 1)), "fup": res.mean_flux_up}

    st = run_batches(integ, PhotonSource.directional(0.5, 0.0), PORT_PHOTONS, BATCHES, seed=6,
                     n_lanes=PORT_PHOTONS, derive=derive)
    for k in ("I", "fup"):
        t, te = st.mean["derived"][k].numpy(), st.stderr["derived"][k].numpy()
        j, je = np.asarray(jst.mean["derived"][k]), np.asarray(jst.stderr["derived"][k])
        assert np.all(np.abs(t - j) <= 4 * np.hypot(te, je)), (k, t, j, te, je)
    split = byc["split"]
    assert split.shape[-1] == N_COMP + 1
    assert float(split[..., 256:].abs().sum()) > 0.0
    # The split adds up to the total (slot 0 the surface: black here).
    assert torch.allclose(split.sum(dim=-1), byc["total"], rtol=1e-5, atol=1e-7)
