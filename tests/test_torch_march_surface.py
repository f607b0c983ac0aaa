"""The marching slice over a reflecting surface (K3-M+S) against the JAX
package on the CPU.

A plan whose x and y factors both vary keeps the JAX planner's bounded
marching shadow trace (i3rc_tpu/integrators/fastpath.py:1061-1127), and over
a reflecting surface the block's surface glue (:1874-1981) sends each
emitting bottom hit's radiance toward the upward detectors along the same
marching trace.  Here the port's slice (its plain version on the CPU: the
marching twin and ``resolve_surface``) is held to the JAX XLA fastpath on
two cases of tests/march_scenes.py: HG over a Lambertian albedo and the C.1
table over RPV, both with the exact estimator (the JAX fastpath's Iwabuchi
rule drops exp(-tau), tests/test_torch_detectors.py), the two upward
detectors, 4 batches a side of 2^13 photons at 2^12 lanes: each detector's
radiance within 4 combined standard errors.  The port's fluxes close
exactly: every photon ends at the top (Fup), in the atmosphere (Fabs) or at
the surface, so Fup + Fabs + Fdn - (the weight the surface sends back up)/N
= 1, the last counted at each block's surface stage.

Each side builds its domain and configuration with its own classes from the
same numpy arrays.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from i3rc_tpu.core.illumination import PhotonSource as JaxSource
from i3rc_tpu_torch import PhotonSource, batch_key
from i3rc_tpu_torch.kernels import event_block as eb

torch.set_num_threads(2)
_spec = importlib.util.spec_from_file_location("march_scenes",
                                               Path(__file__).with_name("march_scenes.py"))
ms = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ms)
JAX = ms.host("i3rc_tpu")
N, LANES, BATCHES = 1 << 13, 1 << 12, 4


def _jax_integrator(name: str):
    """march_scenes' case on the JAX package, its XLA fastpath at K = 1 (the
    same physics, a quicker compile)."""
    build, cfg, kw = ms.march_cases()[name]
    kw = dict(kw)
    kw.update(ms._srf.surface_kw(JAX, kw.pop("_srf")))
    return JAX.Integrator.create(build(JAX), config=JAX.Config(**cfg, fastpath_unroll=1), **kw)


def _port_batches(name: str):
    """(per-batch radiances, per-batch closure Fup + Fabs + Fdn - back / N) of
    the port's slice; ``back`` sums each revived lane's weight after the
    bounce, counted around every block's surface stage."""
    integ = ms.case_integrator(name, "cpu")
    assert integ._fast_plan is not None and not integ._fast_plan.closed_shadow
    fn = integ.batch_fn(PhotonSource.directional(0.5, 0.0), N, n_lanes=LANES)
    real = eb.resolve_surface
    back = [0.0]

    def counted(spec, pro, st, buf, u, u_iw=None):
        hit = st.i[eb.PK] == 2
        real(spec, pro, st, buf, u, u_iw)
        revived = hit & (st.i[eb.ALIVE] != 0)
        w = st.w[revived].double().sum() if st.w is not None else revived.sum()
        back[0] += float(w)

    rows, closure = [], []
    eb.resolve_surface = counted
    try:
        for b in range(BATCHES):
            back[0] = 0.0
            res = fn(batch_key(61, b))
            assert int(res.n_bad) == 0
            rows.append(res.mean_intensity.double().numpy())
            closure.append(float(res.mean_flux_up + res.mean_flux_absorbed
                                 + res.mean_flux_down) - back[0] / N)
    finally:
        eb.resolve_surface = real
    return np.stack(rows), closure


@pytest.mark.parametrize("name", ["hg_exact_albedo", "tab_exact_rpv"])
def test_marching_surface_slice_matches_jax(name):
    jinteg = _jax_integrator(name)
    assert not jinteg._fast_plan.closed_shadow and jinteg._fast_plan.shadow_steps > 0
    jfn = jinteg.batch_fn(JaxSource.directional(0.5, 0.0), N, n_lanes=LANES)
    jrows = np.stack([np.asarray(jfn(jax.random.PRNGKey(61 + b)).mean_intensity, np.float64)
                      for b in range(BATCHES)])
    rows, closure = _port_batches(name)
    assert rows.shape == jrows.shape == (BATCHES, 2) and np.all(rows > 0.0)
    se = np.sqrt(rows.var(0, ddof=1) / BATCHES + jrows.var(0, ddof=1) / BATCHES)
    z = np.abs(rows.mean(0) - jrows.mean(0)) / se
    assert np.all(z <= 4.0), (rows.mean(0), jrows.mean(0), se)
    np.testing.assert_allclose(closure, 1.0, atol=1e-5)
