"""The port's Integrator and batch statistics against the JAX package and the
deterministic slab oracle.

The two packages draw from different generators (Philox vs Threefry), so
agreement is statistical: each gate is a stated number of standard errors.
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from i3rc_tpu.core.illumination import PhotonSource as JaxSource
from i3rc_tpu.integrators.config import IntegratorConfig
from i3rc_tpu.integrators.integrator import Integrator as JaxIntegrator
from i3rc_tpu.models.slab import make_slab_domain
from i3rc_tpu.models.step_cloud import make_step_cloud
from i3rc_tpu.parallel.mesh import default_mesh
from i3rc_tpu.parallel.mesh import run_batches as jax_run_batches
from i3rc_tpu_torch import Integrator, PhotonSource, batch_key, run_batches
from tests.disort_oracle import hg_slab_fluxes

torch.set_num_threads(2)
CFG = IntegratorConfig(use_ray_tracing=False, max_events=500,
                       compute_volume_absorption=False)
# The JAX reference runs one event per block (K=1) to keep its XLA compile
# to seconds; K sets when deaths are tallied, not what is tallied.
JAX_CFG = replace(CFG, fastpath_unroll=1)
N, LANES = 1 << 14, 1 << 12


def test_step_cloud_matches_jax_fastpath():
    """Port vs the JAX XLA fastpath on the step cloud (test_fastpath.py:741)."""
    jres = JaxIntegrator.create(make_step_cloud(1.0), config=JAX_CFG).batch_fn(
        JaxSource.directional(0.5, 0.0), N, n_lanes=LANES)(jax.random.PRNGKey(5))
    tres = Integrator.create(make_step_cloud(1.0), config=CFG, device="cpu").batch_fn(
        PhotonSource.directional(0.5, 0.0), N, n_lanes=LANES)(batch_key(5, 0))
    sigma = float(np.sqrt(2 * 0.58 * 0.42 / N))
    assert float(tres.mean_flux_up) == pytest.approx(float(jres.mean_flux_up),
                                                     abs=4 * sigma)
    # Conservative cloud over a black surface: energy closes exactly.
    assert float(tres.mean_flux_up + tres.mean_flux_down) == pytest.approx(1.0, abs=1e-5)
    assert int(tres.n_bad) == 0
    assert tres.flux_up.shape == (32, 1) and tres.flux_up.dtype == torch.float32


def test_absorbing_step_cloud_closes():
    """ssa 0.99: Bernoulli absorption tallies close the energy budget."""
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500)
    res = Integrator.create(make_step_cloud(0.99), config=cfg, device="cpu").batch_fn(
        PhotonSource.directional(0.5, 0.0), N, n_lanes=LANES)(batch_key(6, 0))
    total = res.mean_flux_up + res.mean_flux_down + res.mean_flux_absorbed
    assert float(total) == pytest.approx(1.0, abs=1e-5)
    assert float(res.mean_flux_absorbed) > 0.0 and int(res.n_bad) == 0
    # Column absorption equals the layer-integrated volume absorption.
    dz = 250.0 / 32
    assert float(res.volume_absorption.sum(-1).mean() * dz) == pytest.approx(
        float(res.mean_flux_absorbed), rel=1e-5)


def test_slab_vs_oracle():
    """Homogeneous slab, tau 1, HG g 0.85, mu0 0.5: the discrete-ordinates
    oracle (tests/disort_oracle.py) within 4 sigma."""
    n = 1 << 15
    r_ex, t_ex = hg_slab_fluxes(1.0, 1.0, 0.85, 0.5, n_legendre=64)
    res = Integrator.create(make_slab_domain(1.0), config=CFG, device="cpu").batch_fn(
        PhotonSource.directional(0.5, 0.0), n, n_lanes=LANES)(batch_key(7, 0))
    sigma = np.sqrt(r_ex * (1.0 - r_ex) / n)
    assert float(res.mean_flux_up) == pytest.approx(r_ex, abs=4 * sigma)
    assert float(res.mean_flux_down) == pytest.approx(t_ex, abs=4 * sigma)


def test_run_batches_matches_jax():
    """Batch means and standard errors: port vs JAX run_batches, within 4
    combined standard errors; both round 1 batch up to the minimum of 2."""
    n, batches = 1 << 12, 8
    derive = lambda res: {"fup": res.mean_flux_up}
    jst = jax_run_batches(
        JaxIntegrator.create(make_step_cloud(1.0), config=JAX_CFG),
        JaxSource.directional(0.5, 0.0), n, batches, seed=3, derive=derive,
        derive_token="fup", n_lanes=LANES, mesh=default_mesh(jax.devices()[:1]))
    tinteg = Integrator.create(make_step_cloud(1.0), config=CFG, device="cpu")
    tst = run_batches(tinteg, PhotonSource.directional(0.5, 0.0), n, batches, seed=3,
                      derive=derive, n_lanes=LANES, chunk_batches=3)
    assert tst.n_batches == batches
    jm, je = float(jst.mean["derived"]["fup"]), float(jst.stderr["derived"]["fup"])
    tm, te = float(tst.mean["derived"]["fup"]), float(tst.stderr["derived"]["fup"])
    assert tm == pytest.approx(jm, abs=4 * np.hypot(je, te))
    assert 0.25 < te / je < 4.0
    assert tst.mean["results"].flux_up.dtype == torch.float64
    # Chunking only moves where the sums are added.
    whole = run_batches(tinteg, PhotonSource.directional(0.5, 0.0), n, batches, seed=3,
                        derive=derive, n_lanes=LANES)
    assert float(whole.mean["derived"]["fup"]) == pytest.approx(tm, abs=1e-12)
    assert run_batches(tinteg, PhotonSource.directional(0.5, 0.0), 256, 1,
                       n_lanes=256).n_batches == 2
