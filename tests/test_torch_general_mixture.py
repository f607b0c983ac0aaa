"""The port's general kernel (its plain version on the CPU) on two
components in the same cells, an HG cloud and a tabulated Rayleigh haze at
different single-scattering albedos (the component pick, each component's
absorption, the cubic inverse CDF of a non-HG table), against the one slab
they act as (tests/general_oracles.py ``mixture``, the discrete-ordinates
slab), over a black surface and a Lambertian albedo.  8 batches of 8192
photons; each flux within 4 standard errors of the batch means of the
closed form (tests/test_torch_general_oracles.py ``batches``).
"""

import pytest

from tests import general_oracles as go
from tests.test_torch_general_oracles import ALBEDO, PORT, assert_within, batches


@pytest.mark.parametrize("mode,albedo", [("rt", 0.0), ("maxcs", 0.0), ("woodcock", 0.0),
                                         ("maxcs", ALBEDO)])
def test_two_components_match_their_mixture(mode, albedo):
    dom, (ext, omega, chi) = go.mixture_slab(PORT)
    var, (fup, fdn, fabs) = batches(dom, mode, surface_albedo=albedo)
    assert not var.uniform and "comp" in var.draws
    r, d = go.slab_over_albedo(ext, omega, chi, 0.5, albedo)
    assert_within(fup, r, "Fup")
    assert_within(fdn, d, "Fdn")
    assert_within(fabs, 1.0 - r - (1.0 - albedo) * d, "Fabs")
