"""The marching shadow trace on the port's fastpath against the JAX package.

A plan whose x and y extinction factors both vary has no closed-form
transmittance; the JAX planner keeps a bounded marching trace
(i3rc_tpu/integrators/fastpath.py:590-631, the trace ``shadow_trace`` at
:1061-1127, XLA only).  Here the port's plan, its plain twin event by event
(``kernels/event_block.py`` shadow_march), its slice, the closed trace
against the marching one, and the marching slice against the port's
general kernel are each held to the JAX package or to each other on the
CPU.  The JAX fastpath's Iwabuchi rule drops exp(-tau) when the phase value
is below zeta (fastpath.py:1544); the event test rebuilds the port's rule
from the JAX records of a run without roulette (tests/test_torch_detectors.py).

Each side builds its domain and configuration with its own classes from the
same numpy arrays (tests/march_scenes.py).
"""

import importlib.util
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from i3rc_tpu.core.illumination import PhotonSource as JaxSource
from i3rc_tpu.integrators import fastpath as jfast
from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, batch_key,
                            make_step_cloud)
from i3rc_tpu_torch.integrators.fastpath import (event_spec, make_fast_tracer, plan_from_jax,
                                                 state_from_numpy)
from i3rc_tpu_torch.kernels.event_block import (compare_states, event_block_reference,
                                                 march_census)
from test_torch_column import _find
from test_torch_detectors import L, _iwabuchi_reference, _random_state, _run_jax

torch.set_num_threads(2)
_spec = importlib.util.spec_from_file_location("march_scenes",
                                               Path(__file__).with_name("march_scenes.py"))
ms = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ms)
JAX, PORT = ms.host("i3rc_tpu"), ms.host("i3rc_tpu_torch")
SRC = PhotonSource.directional(0.5, 0.0)


def _config(h, iw: bool = False, **kw):
    return h.Config(**dict(ms.CFG_KW, use_russian_roulette_for_intensity=iw, zeta_min=0.3,
                           **kw))


def _jax_fast_event(jinteg):
    """The JAX fast_event of the XLA fastpath (the Mosaic block takes
    detectors only with the closed trace, fastpath.py:1707-1712), from the
    closure cells of the tracer."""
    tracer = jfast.make_fast_tracer(jinteg.geometry, jinteg._fast_plan, jinteg.config,
                                    1 << 14, L)
    fe = _find(tracer, "fast_event")
    assert fe is not None
    return fe


@pytest.mark.parametrize("ssa,iw", [(1.0, False), (1.0, True), (0.95, False), (0.95, True)])
def test_twin_matches_jax_marching_event(ssa, iw):
    """One event and one K = 8 block on the same state and uniforms, with the
    tolerances of test_torch_detectors.test_twin_matches_jax_detector_event:
    integer fields equal and floats within 1e-5 on >= 99.5% of lanes; on
    lanes whose integer state agrees and where either side contributes, the
    exit column equal and the contribution within 1e-5 relative on >= 99.5%
    of them."""
    jinteg = JAX.Integrator.create(ms.separable_3d(JAX, ssa), config=_config(JAX, iw),
                                   **ms.DETECTORS)
    jplan = jinteg._fast_plan
    assert not jplan.closed_shadow and 0 < jplan.shadow_steps <= 24
    fe = _jax_fast_event(jinteg)
    fe_exact = _jax_fast_event(JAX.Integrator.create(
        ms.separable_3d(JAX, ssa), config=_config(JAX), **ms.DETECTORS)) if iw else None
    tinteg = Integrator.create(ms.separable_3d(PORT, ssa), config=_config(PORT, iw),
                               device="cpu", **ms.DETECTORS)
    assert tinteg._fast_plan == plan_from_jax(jplan)
    spec = event_spec(tinteg.geometry, tinteg._fast_plan, tinteg.config)
    det = spec.det
    assert det.march_steps == jplan.shadow_steps and det.march_ty and det.col_y
    assert det.use_x == (False, True, True) and det.use_y == (False, True, True)
    rng = np.random.default_rng(29)
    st0 = _random_state(spec, rng)
    U = rng.uniform(size=(spec.K, spec.n_draws, L)).astype(np.float32)
    for K in (1, spec.K):
        ref, dirs, jrecs = _run_jax(fe, st0, U, K)
        if iw:
            exact = _run_jax(fe_exact, st0, U[:, :spec.bonus_draws], K)[2]
            want = _iwabuchi_reference(spec, dirs, exact, jrecs, U)
        else:
            want = [c for c, _ in jrecs]
        got = state_from_numpy(st0)
        acc = torch.zeros((det.n_cols, det.n), dtype=torch.float64)
        recs = []
        with march_census() as cen:
            event_block_reference(replace(spec, K=K), got, torch.from_numpy(U[:K]), acc, recs)
        assert cen["rays"] > 0 and cen["most"] <= det.march_steps
        agree = compare_states(spec, got, ref, rtol=1e-5)
        assert agree["int_frac"] >= 0.995 and agree["float_frac"] >= 0.995, agree
        int_eq = (got.i == ref.i).all(dim=0).numpy()
        assert len(recs) == len(jrecs) == det.n * K
        n_ok = n_all = 0
        for (c, col), w, (_, jcol) in zip(recs, want, jrecs):
            c, col = c.numpy(), col.numpy()
            live = int_eq & ((c != 0) | (w != 0))
            ok = (col == jcol) & (np.abs(c - w) <= 1e-5 * np.abs(w))
            n_ok += int((ok & live).sum())
            n_all += int(live.sum())
        assert n_all > 100 and n_ok >= 0.995 * n_all, (n_ok, n_all)


def test_marching_slice_matches_jax():
    """The 3-D scene, the exact estimator, 2^14 photons at 2^12 lanes: the
    port's marching slice against the JAX XLA fastpath (K = 1 there, the
    same physics) at rtol 0.12, test_torch_detectors.test_slice_matches_jax's
    tolerance; fluxes close with the absorbed part."""
    n, lanes = 1 << 14, 1 << 12
    jres = JAX.Integrator.create(ms.separable_3d(JAX), config=_config(JAX, fastpath_unroll=1),
                                 **ms.DETECTORS).batch_fn(
        JaxSource.directional(0.5, 0.0), n, n_lanes=lanes)(jax.random.PRNGKey(37))
    tinteg = Integrator.create(ms.separable_3d(PORT), config=_config(PORT), device="cpu",
                               **ms.DETECTORS)
    assert not tinteg._fast_plan.closed_shadow
    tres = tinteg.batch_fn(SRC, n, n_lanes=lanes)(batch_key(37, 0))
    got = tres.mean_intensity.numpy()
    assert np.all(got > 0.0)
    np.testing.assert_allclose(got, np.asarray(jres.mean_intensity), rtol=0.12)
    total = float(tres.mean_flux_up + tres.mean_flux_down + tres.mean_flux_absorbed)
    assert total == pytest.approx(1.0, abs=1e-5) and int(tres.n_bad) == 0
    assert tres.intensity.shape == (6, 4, 3)


def test_closed_and_marching_plans_agree():
    """tests/test_fastpath.py:994-1030 on the port: the step cloud's closed
    plan and the same plan with 24 marching steps, one key: flux tallies
    bitwise equal (the shadow trace draws no random numbers), the radiance
    sum within rtol 2e-4, each column within rtol 0.02, atol 1e-3 of the
    largest.  y is not tracked on this plan."""
    integ = Integrator.create(make_step_cloud(1.0), _config(PORT), device="cpu",
                              **ms.CLOSED_VS_MARCH_DETECTORS)
    n, lanes = 1 << 14, 1 << 12
    key = batch_key(77, 1)
    raws = []
    for plan in ms.closed_and_marching(integ):
        spec = event_spec(integ.geometry, plan, integ.config)
        assert spec.det.march_steps == (0 if plan.closed_shadow else 24)
        assert not spec.track_y and not any(spec.det.use_y)
        tracer = make_fast_tracer(integ.geometry, plan, integ.config, n, lanes)
        raws.append(tracer(key, SRC.sample(key, lanes, "cpu"), SRC))
    cmp = ms.compare_closed_and_marching(*raws)
    assert cmp["ok"], cmp


def test_marching_slice_matches_general_kernel():
    """The 3-D scene's radiance by the marching fastpath against the port's
    general kernel G (IntegratorConfig(): ray tracing, the exact trace) on
    the same scene: 4 batches of 2^12 photons a side, within 4 combined
    standard errors per detector."""
    n, lanes, nb = 1 << 12, 1 << 12, 4
    fast = Integrator.create(ms.separable_3d(PORT), config=_config(PORT), device="cpu",
                             **ms.DETECTORS)
    gen = Integrator.create(ms.separable_3d(PORT), config=IntegratorConfig(), device="cpu",
                            **ms.DETECTORS)
    assert fast._fast_plan is not None and gen._fast_plan is None
    sides = []
    for integ, seed in ((fast, 50), (gen, 60)):
        fn = integ.batch_fn(SRC, n, n_lanes=lanes)
        sides.append(np.stack([fn(batch_key(seed, b)).mean_intensity.double().numpy()
                               for b in range(nb)]))
    (a, b) = sides
    sig = np.sqrt(a.var(0, ddof=1) / nb + b.var(0, ddof=1) / nb)
    assert np.all(np.abs(a.mean(0) - b.mean(0)) <= 4 * sig), (a.mean(0), b.mean(0), sig)
