"""The general kernel, port against the JAX package on the CPU, on the
scenes only it runs: a seeded random 3-D domain of two components (an HG
cloud with two phase entries and a tabulated Rayleigh haze, ssa < 1,
irregular x and z) with the volume absorption tallied; a 2 x 2 gridded RPV
surface (maximum cross-section); and the weight-1 class of make_chained_flux_tracer (Bernoulli
absorption at ssa 0.9, forced with general_chain = 2 and 4-cell
super-voxels as tests/test_serial_path.py:101-136 does).

Each side runs 4 batches (8 for the two-component domain, whose nine
fields include each layer of the absorption profile); every field agrees
within 4 combined standard errors of the batch means
(tests/general_cases.py).
"""

import numpy as np
import pytest
import torch

from i3rc_tpu_torch.kernels import general_block as gb
from tests.general_cases import (JAX, PORT, assert_agree, rpv_grid, run_side,
                                 step_cloud_32x8, two_component, weight1_domain)

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", ["max_cross_section", "ray_tracing"])
def test_two_components_with_volume_absorption_match_jax(mode):
    cfg = dict(use_fastpath=False, max_events=500, compute_volume_absorption=True,
               use_ray_tracing=mode == "ray_tracing")
    # 8 batches a side: nine fields are compared here, and the standard error
    # of 4 batch means is itself too noisy a yardstick for that many.
    _, jv, _ = run_side(JAX, two_component(JAX), cfg, {}, 2048, 8, 2048, profile=True)
    tinteg, tv, runs = run_side(PORT, two_component(PORT), cfg, {}, 2048, 8, 2048,
                                profile=True)
    spec = tinteg.batch_tracer(2048, 2048).spec
    assert not spec.geom.xy_regular and not spec.geom.z_regular
    var = gb.variant(spec, tinteg.device_optics)
    assert not var.uniform and "comp" in var.draws
    assert all(float(r.volume_absorption.sum()) > 0.0 for r in runs)
    assert_agree(jv, tv)


def test_gridded_rpv_surface_matches_jax():
    cfg = dict(use_fastpath=False, max_events=500, compute_volume_absorption=False,
               use_ray_tracing=False)
    jinteg, jv, _ = run_side(JAX, step_cloud_32x8(JAX, 1.0), cfg, dict(surface=rpv_grid(JAX)),
                             2048, 4, 2048)
    tinteg, tv, _ = run_side(PORT, step_cloud_32x8(PORT, 1.0), cfg,
                             dict(surface=rpv_grid(PORT)), 2048, 4, 2048)
    assert jinteg._fast_plan is None and tinteg._fast_plan is None
    spec = tinteg.batch_tracer(2048, 2048).spec
    assert spec.surface_kind == gb.BRDF_KINDS["rpv"] and (spec.n_xs, spec.n_ys) == (2, 2)
    assert_agree(jv, tv)


def test_weight1_class_matches_jax():
    """Counts, not weights: every exit and death is one photon, so each
    batch closes exactly (Fup + Fdn + Fabs = 1 less the bad photons)."""
    cfg = dict(use_ray_tracing=False, max_events=200, compute_volume_absorption=False,
               majorant_block_size=4, use_fastpath=False, general_chain=2,
               general_dda_steps=2)
    jinteg, jv, _ = run_side(JAX, weight1_domain(JAX), cfg, {}, 4096, 4, 4096)
    assert "chained" in jinteg.batch_tracer(4096, 4096).__qualname__
    tinteg, tv, runs = run_side(PORT, weight1_domain(PORT), cfg, {}, 4096, 4, 4096)
    var = gb.variant(tinteg.batch_tracer(4096, 4096).spec, tinteg.device_optics)
    assert var.bernoulli and var.absorbing and not var.rr
    for r in runs:
        total = float(r.mean_flux_up + r.mean_flux_down + r.mean_flux_absorbed)
        assert total == pytest.approx(1.0 - int(r.n_bad) / 4096, abs=1e-5)
        assert np.all(np.asarray(r.flux_absorbed) >= 0.0)
    assert_agree(jv, tv)
