"""Radiance on the general kernel with clipped contributions, port against
the JAX package on the CPU: the 32 x 1 x 8
step cloud (ssa 0.99) with the I3RC detectors, fastpath off, 4 batches of
2048 photons a side, mean radiances within 4 combined standard errors of the
batch means (tests/general_cases.py compare_radiance).

clipping at a cap that bites (max_intensity_contribution 0.05, as in
tests/test_variance_reduction.py:115-129; Woodcock): the excess above the
cap is kept per (detector, component) and redistributed by the
normalization, so the means still agree.
"""

import torch

from i3rc_tpu_torch import PhotonSource, batch_key
from tests.general_cases import compare_radiance
from tests.general_scenes import step_cloud_32x8

torch.set_num_threads(2)
BASE = dict(use_fastpath=False, max_events=500, compute_volume_absorption=False)


def test_clipping_matches_jax():
    cfg = dict(BASE, use_ray_tracing=False, majorant_block_size=4,
               limit_intensity_contributions=True, max_intensity_contribution=0.05)
    _, ti, _ = compare_radiance(step_cloud_32x8, cfg)
    det = ti.batch_tracer(2048, 2048).spec.det
    assert det.clip and det.cap == 0.05000000074505806
    # The raw tallies carry the excess the cap cut off.
    key, src = batch_key(3, 0), PhotonSource.directional(0.5, 0.0)
    raw = ti.batch_tracer(2048, 2048)(key, src.sample(key, 2048, "cpu"), src)
    assert float(raw.intensity_excess.sum()) > 0.0
    assert float(raw.intensity_excess.reshape(3, 2)[:, 0].sum()) == 0.0   # no surface
