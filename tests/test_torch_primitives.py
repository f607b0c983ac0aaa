"""Direction and phase-function primitives: the port against the JAX package.

Same float32 inputs (numpy, seeded) through both; the port follows the JAX
arithmetic operation by operation, so the only differences are libm ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3rc_tpu.integrators import fastpath as jfast
from i3rc_tpu.integrators import wavefront as jwave
from i3rc_tpu_torch.integrators import fastpath as tfast
from i3rc_tpu_torch.integrators import wavefront as twave

torch.set_num_threads(2)
TOL = 2e-6
N = 4096


def _dirs(rng):
    v = rng.normal(size=(3, N))
    v /= np.linalg.norm(v, axis=0)
    # A few lanes at the poles exercise the vertical-incidence branch.
    v[:, :4] = [[0, 0, 0, 0], [0, 0, 0, 0], [1, -1, 1, -1]]
    return v.astype(np.float32)


def _close(j, t):
    assert np.max(np.abs(np.asarray(j) - t.numpy())) <= TOL


def test_make_direction_cosines():
    rng = np.random.default_rng(1)
    mu = rng.uniform(-1, 1, N).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, N).astype(np.float32)
    for j, t in zip(jwave.make_direction_cosines(jnp.asarray(mu), jnp.asarray(phi)),
                    twave.make_direction_cosines(torch.from_numpy(mu), torch.from_numpy(phi))):
        _close(j, t)


def test_sincos_2pi():
    u = np.random.default_rng(2).uniform(0, 1, N).astype(np.float32)
    u[:4] = [0.0, 0.25, 0.5, 0.75]
    for j, t in zip(jwave._sincos_2pi(jnp.asarray(u)), twave._sincos_2pi(torch.from_numpy(u))):
        _close(j, t)


@pytest.mark.parametrize("renormalize", [True, False])
def test_rotate_direction(renormalize):
    rng = np.random.default_rng(3)
    ux, uy, uz = _dirs(rng)
    cos_s = rng.uniform(-1, 1, N).astype(np.float32)
    u_az = rng.uniform(0, 1, N).astype(np.float32)
    j = jwave.rotate_direction(*map(jnp.asarray, (ux, uy, uz, cos_s, u_az)),
                               renormalize=renormalize)
    t = twave.rotate_direction(*map(torch.from_numpy, (ux, uy, uz, cos_s, u_az)),
                               renormalize=renormalize)
    for a, b in zip(j, t):
        _close(a, b)


@pytest.mark.parametrize("g", [0.85, -0.3])
def test_hg_cosine(g):
    u = np.random.default_rng(4).uniform(0, 1, N).astype(np.float32)
    _close(jfast.hg_cosine(g, jnp.asarray(u)), tfast.hg_cosine(g, torch.from_numpy(u)))
