"""Radiance on the general kernel in ray tracing with Iwabuchi roulette
(zeta_min 0.3), and hybrid phase functions, port against the JAX package on
the CPU: the 32 x 1 x 8 step cloud (ssa 0.99) with the I3RC detectors,
fastpath off, 4 batches of 2048 photons a side, mean radiances within 4
combined standard errors of the batch means (tests/general_cases.py).  The
exact trace in ray tracing is tests/test_torch_general.py's default-config
case.

Hybrid phase functions (a Gaussian forward peak of 10 degrees spliced onto
the phase value the estimate reads, tables.hybridize; at the default 7
degrees HG 0.85 from 64 moments has no crossing and keeps its table) with
num_orders_orig_phase_fun 0 (every order reads the hybrid table) and 1
(first-order estimates read the original): the port's forward tables are
the JAX package's, and each side's radiances agree.
"""

import numpy as np
import pytest
import torch

from tests.general_cases import check_mode_radiance, compare_radiance
from tests.general_scenes import step_cloud_32x8

torch.set_num_threads(2)


def test_iwabuchi_matches_jax():
    check_mode_radiance("ray_tracing", True)


@pytest.mark.parametrize("n_orig", [0, 1])
def test_hybrid_phase_functions_match_jax(n_orig):
    cfg = dict(use_fastpath=False, max_events=500, compute_volume_absorption=False,
               use_hybrid_phase_funs=True, hybrid_phase_fun_width=10.0,
               num_orders_orig_phase_fun=n_orig)
    ji, ti, _ = compare_radiance(step_cloud_32x8, cfg)
    jt, tt = ji.tables, ti.tables
    np.testing.assert_array_equal(np.asarray(jt.forward), tt.forward.numpy())
    np.testing.assert_array_equal(np.asarray(jt.forward_orig), tt.forward_orig.numpy())
    assert not np.array_equal(tt.forward.numpy(), tt.forward_orig.numpy())
    assert ti.batch_tracer(2048, 2048).spec.det.n_orig == n_orig
