"""Collision chains past depth 3 (JAX's ``fastpath_chain``, i3rc_tpu/
integrators/fastpath.py:1283-1286) on the port: the event block's plain
version at depth 4 and 6 against the JAX package's XLA fastpath at the same
depth on the absorbing step cloud (ssa 0.99, mu0 0.5): Fup, Fdn and Fabs
within 4 combined binomial standard errors, and the port's energy closure
within 1e-5.  On the card the runtime-depth variant runs these plans, bit
for bit with this plain version (tests/test_torch_reach_cuda.py).
"""

import jax
import numpy as np
import pytest
import torch

from i3rc_tpu.core.illumination import PhotonSource as JaxSource
from i3rc_tpu.integrators.config import IntegratorConfig as JaxConfig
from i3rc_tpu.integrators.integrator import Integrator as JaxIntegrator
from i3rc_tpu.models.step_cloud import make_step_cloud as jax_step_cloud
from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource, batch_key, make_step_cloud
from i3rc_tpu_torch.integrators.fastpath import event_spec

torch.set_num_threads(2)
N, LANES = 1 << 14, 1 << 12


@pytest.mark.parametrize("depth", [4, 6])
def test_deep_chain_matches_the_jax_fastpath(depth):
    # The JAX reference runs one event per block (K = 1) to keep its XLA
    # compile to seconds; K sets when deaths are tallied, not what is.
    jcfg = JaxConfig(use_ray_tracing=False, max_events=500, compute_volume_absorption=False,
                     fastpath_unroll=1, fastpath_chain=depth)
    jres = JaxIntegrator.create(jax_step_cloud(0.99), config=jcfg).batch_fn(
        JaxSource.directional(0.5, 0.0), N, n_lanes=LANES)(jax.random.PRNGKey(depth))
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                           compute_volume_absorption=False, fastpath_chain=depth)
    integ = Integrator.create(make_step_cloud(0.99), config=cfg, device="cpu")
    assert event_spec(integ.geometry, integ._fast_plan, cfg).chain == depth
    tres = integ.batch_fn(PhotonSource.directional(0.5, 0.0), N, n_lanes=LANES)(
        batch_key(11, depth))
    for name in ("mean_flux_up", "mean_flux_down", "mean_flux_absorbed"):
        p = float(getattr(jres, name))
        sigma = float(np.sqrt(max(p * (1.0 - p), 1e-4) * 2.0 / N))
        assert float(getattr(tres, name)) == pytest.approx(p, abs=4 * sigma), name
    total = tres.mean_flux_up + tres.mean_flux_down + tres.mean_flux_absorbed
    assert float(total) == pytest.approx(1.0, abs=1e-5)
    assert int(tres.n_bad) == 0
