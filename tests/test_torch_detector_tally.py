"""The detector tally of the CUDA event block at every histogram size.

The kernel keeps a scene's (column, detector) histogram in one of three
places, by its bin count (``hist_room`` in csrc/fast_event_block.cuh): one
private slice per warp in shared memory up to 751 bins, one CTA histogram
in shared memory up to 6144 bins (past the default shared memory of a CTA
from 6012 bins on), else the global accumulator.  Each test runs one K-event
block of the detector variant on a separable scene whose column grid puts
the histogram in one of those places, and holds it against the plain twin
on the same Philox draws: every state row bit for bit, the accumulator
within 1e-9 relative (only the order of its sum may differ).

Imports only the port, so that it runs on a machine with a card and no JAX.
Needs the card and nvcc; skipped without them.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from i3rc_tpu_torch import Domain, Integrator, IntegratorConfig, batch_key
from i3rc_tpu_torch.core.phase_functions import (PhaseFunction, PhaseFunctionTable,
                                                 henyey_greenstein_coefficients)
from i3rc_tpu_torch.core.rng import philox_uniforms
from i3rc_tpu_torch.integrators.fastpath import event_spec, state_from_numpy
from i3rc_tpu_torch.kernels.event_block import event_block, event_block_reference

DET = dict(intensity_mus=[1.0, 0.5, 0.5], intensity_phis=[0.0, 0.0, 180.0])
L = 1 << 16
CFG = IntegratorConfig(use_ray_tracing=False, max_events=500, compute_volume_absorption=False)


def grid_scene(n_x: int, n_y: int, ssa: float):
    """Separable scene on an n_x x n_y column grid of 50 m cells whose only
    varying horizontal factor is fy (a band of 3x extinction), so the exit
    column bins x and y: n_x * n_y columns."""
    vx = np.ones(n_x)
    vy = np.ones(n_y)
    vy[n_y // 3:2 * n_y // 3 + 1] = 3.0
    vz = np.array([0.0, 0.02, 0.03, 0.0])
    ext = vx[:, None, None] * vy[None, :, None] * vz[None, None, :]
    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(0.85, 48))], key=[1.0])
    dom = Domain.create(np.linspace(0, 50.0 * n_x, n_x + 1), np.linspace(0, 50.0 * n_y, n_y + 1),
                        np.linspace(0, 100.0, 5))
    return dom.add_component("c", ext, np.full_like(ext, ssa), np.zeros(ext.shape, np.int32),
                             table)


def random_state(spec, rng):
    """Random in-domain lanes, 90% alive, half of them with tau = 0."""
    f32 = lambda a: np.asarray(a, np.float32)
    d = rng.normal(size=(3, L))
    d /= np.linalg.norm(d, axis=0)
    tau = np.where(rng.uniform(size=L) < 0.5, 0.0, rng.exponential(size=L))
    return (rng.uniform(size=L) < 0.9, f32(rng.uniform(spec.x0, spec.x_max, L)),
            f32(rng.uniform(spec.y0, spec.y_max, L)), f32(rng.uniform(spec.z0, spec.z_max, L)),
            f32(d[0]), f32(d[1]), f32(d[2]), f32(tau), rng.integers(0, 40, L).astype(np.int32),
            np.zeros(L, np.int32), np.zeros(L, np.int32),
            rng.integers(0, 100, L).astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n_x,n_y,ssa,iw", [
    (4, 3, 1.0, True),        # 36 bins: warp slices
    (16, 16, 0.99, False),    # 768 bins: one CTA histogram
    (64, 32, 1.0, True),      # 6144 bins: one CTA histogram, past the default budget
    (64, 64, 1.0, False)])    # 12288 bins: the global accumulator
def test_detector_tally_matches_twin_on_gpu(n_x, n_y, ssa, iw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    cfg = replace(CFG, use_russian_roulette_for_intensity=iw, zeta_min=0.3)
    integ = Integrator.create(grid_scene(n_x, n_y, ssa), config=cfg, device=dev, **DET)
    spec = event_spec(integ.geometry, integ._fast_plan, cfg)
    assert spec.det.col_y and spec.det.n_cols * spec.det.n == n_x * n_y * 3
    st = state_from_numpy(random_state(spec, np.random.default_rng(n_x * n_y)), device=dev)
    got, ref = st.clone(), st.clone()
    acc_k = torch.zeros((spec.det.n_cols, spec.det.n), dtype=torch.float64, device=dev)
    acc_t = torch.zeros_like(acc_k)
    key = batch_key(3, n_x)
    event_block(spec, got, key, 5, acc_k)
    event_block_reference(spec, ref, philox_uniforms(key, 5, spec.K, spec.n_draws, L, dev),
                          acc_t)
    assert torch.equal(got.f, ref.f) and torch.equal(got.i, ref.i)
    assert float(acc_t.sum()) > 0.0
    assert float((acc_k - acc_t).abs().max() / acc_t.abs().max()) <= 1e-9
