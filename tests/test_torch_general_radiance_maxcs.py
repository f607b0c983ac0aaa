"""Radiance on the general kernel in maximum cross-section, port against
the JAX package on the CPU: the 32 x 1 x 8 step cloud (ssa 0.99) with the
I3RC detectors (1, 0), (0.5, 0), (0.5, 180), the exact transmittance trace
and Iwabuchi roulette (zeta_min 0.3), fastpath off.  Each side runs 4
batches of 2048 photons; the mean radiances agree within 4 combined
standard errors of the batch means (tests/general_cases.py
check_mode_radiance).  On the general kernel the JAX Iwabuchi rule keeps
exp(-tau) (wavefront.py:975-978), so the comparison runs with it on.
"""

import pytest
import torch

from tests.general_cases import check_mode_radiance

torch.set_num_threads(2)


@pytest.mark.parametrize("iwabuchi", [False, True], ids=["exact", "iwabuchi"])
def test_step_cloud_radiance_matches_jax(iwabuchi):
    check_mode_radiance("max_cross_section", iwabuchi)
