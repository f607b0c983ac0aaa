"""The general kernel, port against the JAX package on the CPU: the step
cloud of tests/test_integrator.py:157 (32 x 1 x 8 cells, ssa 0.99, a
Lambertian albedo of 0.2) through ray tracing, maximum cross-section and
super-voxel Woodcock, both sides with the fastpath off.

Each side runs 4 batches of 2048 photons (one wavefront, no refill on
either side); Fup, Fdn and Fabs agree within 4 combined standard errors of
the batch means (tests/general_cases.py).  Closure does not hold per batch
here: roulette and the surface carry weights.  Bad photons (a non-positive
DDA step, ~4e-5 of the photons in ray tracing on both sides) stay below
1e-3.
"""

import pytest
import torch

from tests.general_cases import JAX, PORT, assert_agree, run_side
from tests.general_scenes import step_cloud_32x8

torch.set_num_threads(2)

MODES = {"ray_tracing": dict(use_ray_tracing=True),
         "max_cross_section": dict(use_ray_tracing=False),
         "woodcock": dict(use_ray_tracing=False, majorant_block_size=4)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_step_cloud_over_albedo_matches_jax(mode):
    cfg = dict(use_fastpath=False, max_events=500, compute_volume_absorption=False,
               **MODES[mode])
    kw = dict(surface_albedo=0.2)
    jinteg, jv, _ = run_side(JAX, step_cloud_32x8(JAX), cfg, kw, 2048, 4, 2048)
    tinteg, tv, runs = run_side(PORT, step_cloud_32x8(PORT), cfg, kw, 2048, 4, 2048)
    assert (jinteg._fast_plan, tinteg._fast_plan) == (None, None)
    tracer = tinteg.batch_tracer(2048, 2048)
    assert tracer.spec.mode == {"ray_tracing": 0, "max_cross_section": 1, "woodcock": 2}[mode]
    # Ray tracing loses ~4e-5 of its photons to a collision point that rounds
    # onto a face (a non-positive DDA step), on both sides.
    assert all(int(r.n_bad) <= 1e-3 * 2048 for r in runs)
    assert_agree(jv, tv)
