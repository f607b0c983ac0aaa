"""Radiance on the general kernel over reflecting surfaces, port against the
JAX package on the CPU: the 32 x 1 x 8 step cloud (ssa 0.99) with the I3RC
detectors, fastpath off, 4 batches of 2048 photons a side, mean radiances
within 4 combined standard errors of the batch means
(tests/general_cases.py compare_radiance):

  * a Lambertian albedo of 0.2 (maximum cross-section): the surface's
    estimate is 1/pi with the post-reflection weight;
  * the 2 x 2 gridded RPV surface (ray tracing): the surface's estimate is
    R(in -> detector)/pi with the pre-reflection weight, at every bottom
    hit (wavefront.py:857-882).
"""

import torch

from tests.general_cases import compare_radiance
from tests.general_scenes import rpv_grid, step_cloud_32x8

torch.set_num_threads(2)
BASE = dict(use_fastpath=False, max_events=500, compute_volume_absorption=False)


def test_albedo_surface_matches_jax():
    compare_radiance(step_cloud_32x8, dict(BASE, use_ray_tracing=False),
                     lambda h: dict(surface_albedo=0.2))


def test_gridded_rpv_surface_matches_jax():
    _, ti, _ = compare_radiance(step_cloud_32x8, dict(BASE, use_ray_tracing=True),
                                lambda h: dict(surface=rpv_grid(h)))
    assert ti.batch_tracer(2048, 2048).spec.surface_kind > 1
