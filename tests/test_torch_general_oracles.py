"""The port's general kernel (its plain version on the CPU) against closed
forms that share no code with it (tests/general_oracles.py), on the scenes
whose physics the port-vs-JAX tests hold only to a few percent (two
components in the same cells: tests/test_torch_general_mixture.py):

  * a slab over a Lambertian albedo (the surface bounce and its weight),
    against the discrete-ordinates slab added to the surface;
  * a gridded RPV surface on unequal cells under a transparent atmosphere
    (the cell lookup, the BRDF weight), against the area mean of each
    cell's directional albedo; a lookup that swaps the cells moves the mean
    by ~170 of its sigmas.

Slabs run 8 batches of 8192 photons; each flux is within 4 standard errors
of the batch means of the closed form (about 1% of Fup).  The clear sky
runs one batch of 65536 photons, whose per-photon variance is known in
closed form: Fup within 5 of its sigmas, Fdn = 1 to 1e-12.
"""

import numpy as np
import pytest
import torch

from i3rc_tpu_torch import PhotonSource, batch_key
from i3rc_tpu_torch.core.surface import rpv_brdf
from i3rc_tpu_torch.kernels import general_block as gb
from tests import general_oracles as go

torch.set_num_threads(2)
PORT = go.host("i3rc_tpu_torch")
MODES = {"rt": dict(use_ray_tracing=True),
         "maxcs": dict(use_ray_tracing=False),
         "woodcock": dict(use_ray_tracing=False, majorant_block_size=16)}
ALBEDO = 0.6


def batches(dom, mode: str, n_batches: int = 8, n: int = 8192, **create_kw):
    """(variant, per-batch Fup, Fdn, Fabs) of the port's general kernel."""
    cfg = PORT.Config(max_events=2000, compute_volume_absorption=False, use_fastpath=False,
                      **MODES[mode])
    integ = PORT.Integrator.create(dom, cfg, device="cpu", **create_kw)
    assert integ._fast_plan is None
    var = gb.variant(integ.batch_tracer(n, n).spec, integ.device_optics)
    fn = integ.batch_fn(PhotonSource.directional(0.5, 0.0), n, n_lanes=n)
    out = []
    for b in range(n_batches):
        r = fn(batch_key(31, b))
        assert int(r.n_bad) <= 1e-3 * n
        out.append([float(r.mean_flux_up), float(r.mean_flux_down),
                    float(r.mean_flux_absorbed)])
    return var, np.array(out).T


def assert_within(values: np.ndarray, expect: float, what: str, n_se: float = 4.0) -> None:
    se = values.std(ddof=1) / np.sqrt(values.size)
    assert abs(values.mean() - expect) <= n_se * se, (what, values.mean(), expect, se)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_slab_over_albedo_matches_adding(mode):
    var, (fup, fdn, fabs) = batches(go.hg_slab(PORT, 1.0, 0.9), mode, surface_albedo=ALBEDO)
    assert var.uniform
    r, d = go.slab_over_albedo(1.0, 0.9, go.HG_CHI, 0.5, ALBEDO)
    assert_within(fup, r, "Fup")
    assert_within(fdn, d, "Fdn")
    # What neither leaves at the top nor stays in the surface is absorbed.
    assert_within(fabs, 1.0 - r - (1.0 - ALBEDO) * d, "Fabs")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_gridded_rpv_under_a_clear_sky(mode):
    """With no extinction anywhere a maximum cross-section jump is 1e30 m
    long: its exit is placed on the surface from the lane's position (the
    JAX package's trace back from the jump's end loses x and y there)."""
    dom, srf = go.clear_sky(PORT)
    n = 1 << 16
    _, (fup, fdn, _) = batches(dom, mode, n_batches=1, n=n, surface=srf)
    mean, var = go.clear_sky_brdf(rpv_brdf, go.RPV_PARAMS, go.RPV_X, go.RPV_Y, -0.5, 0.0)
    sigma = np.sqrt(var / n)
    assert abs(fup[0] - mean) <= 5 * sigma, (fup[0], mean, sigma)
    assert fdn[0] == pytest.approx(1.0, abs=1e-12)
    swapped, _ = go.clear_sky_brdf(rpv_brdf, go.RPV_PARAMS.transpose(1, 0, 2), go.RPV_X,
                                   go.RPV_Y, -0.5, 0.0)
    assert abs(swapped - mean) > 100 * sigma
