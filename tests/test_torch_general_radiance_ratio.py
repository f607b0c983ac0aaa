"""Ratio-tracking radiance on the general kernel, port against the JAX
package on the CPU (4 batches of 2048 photons a side, the I3RC detectors,
mean radiances within 4 combined standard errors of the batch means,
tests/general_cases.py compare_radiance):

  * the 32 x 1 x 8 step cloud (ssa 0.99) on 4-cell super-voxels (Woodcock)
    with ratio tracking: the inline estimator (wavefront.py:798-855);
  * the weight-1 class with detectors (tests/test_serial_path.py's random
    8^3 cloud at ssa 0.9, general_chain 2, ratio tracking, no volume
    tally): the chained tracer's estimator (wavefront.py:485-603),
    prefactor ssa P / (4 pi |mu_d|) at every physical collision;
  * the create-time rule (JAX integrator.py:219-239): above 2^18 cells,
    with block majorants and no estimator chosen, ratio tracking is turned
    on with the JAX package's I3RCWarning; Iwabuchi roulette, if chosen,
    stays.  Ratio tracking asked for without block majorants is first
    dropped by the config's validation (config.py:189-192, the blocks come
    from the create-time rule after it), then turned on by the rule, on
    both sides.
"""

import warnings

import numpy as np
import pytest
import torch

from i3rc_tpu_torch.integrators.wavefront import RATIO
from i3rc_tpu_torch.utils.errors import I3RCWarning
from tests.general_cases import JAX, PORT, compare_radiance
from tests.general_scenes import step_cloud_32x8, weight1_domain

torch.set_num_threads(2)
BASE = dict(use_fastpath=False, max_events=500, compute_volume_absorption=False,
            use_ray_tracing=False, majorant_block_size=4, use_ratio_tracking_for_intensity=True)


def test_ratio_tracking_matches_jax():
    _, ti, runs = compare_radiance(step_cloud_32x8, BASE)
    spec = ti.batch_tracer(2048, 2048).spec
    assert spec.det.est == RATIO and spec.mode == 2 and not spec.chained
    assert all(int(r.n_bad) <= 1e-3 * 2048 for r in runs)


@pytest.mark.filterwarnings("ignore:PhaseFunction.from_legendre")
def test_weight1_class_with_detectors_matches_jax():
    ji, ti, runs = compare_radiance(weight1_domain, dict(BASE, general_chain=2))
    spec = ti.batch_tracer(2048, 2048).spec
    assert spec.chained and spec.det.est == RATIO
    from i3rc_tpu_torch.kernels import general_block as gb
    assert gb.variant(spec, ti.device_optics).bernoulli
    assert all(int(r.n_bad) <= 1e-3 * 2048 for r in runs)
    # Black surface: every contribution is the cloud's (slot 1).
    assert float(runs[0].intensity_by_component[..., 0].abs().sum()) == 0.0


def _big(h):
    """A 65 x 65 x 64 uniform cloud: 270,400 cells, above 2^18."""
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.85, 16))], key=[1.0])
    ext = np.full((65, 65, 64), 0.01)
    dom = h.Domain.create(np.linspace(0, 650.0, 66), np.linspace(0, 650.0, 66),
                          np.linspace(0, 640.0, 65))
    return dom.add_component("c", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32), table)


@pytest.mark.parametrize("chosen", [None, "use_russian_roulette_for_intensity",
                                    "use_ratio_tracking_for_intensity"])
def test_large_domain_turns_ratio_tracking_on(chosen):
    cfg = {chosen: True} if chosen else {}
    made = {}
    for h, dev in ((JAX, {}), (PORT, dict(device="cpu"))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            integ = h.Integrator.create(_big(h), config=h.Config(**cfg), intensity_mus=[1.0],
                                        intensity_phis=[0.0], **dev)
        said = [str(w.message) for w in caught if "ratio-tracking" in str(w.message)]
        made[h.pkg] = (integ.config.use_ratio_tracking_for_intensity,
                       integ.config.majorant_block_size, said,
                       [w.category.__name__ for w in caught if "ratio-tracking" in str(w.message)])
    assert made["i3rc_tpu"] == made["i3rc_tpu_torch"]
    on, block, said, kinds = made["i3rc_tpu_torch"]
    assert on == (chosen != "use_russian_roulette_for_intensity") and block == 8
    iwabuchi = chosen == "use_russian_roulette_for_intensity"
    assert len(said) == (0 if iwabuchi else 1) and set(kinds) <= {I3RCWarning.__name__}
