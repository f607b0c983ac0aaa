"""Scenes of the fastpath's marching shadow trace (a plan whose x and y
factors both vary: K3 with ``march_steps`` > 0, K3-M, and its surface stage
over a reflecting surface, K3-M+S), built with either package's classes
(``host(pkg)`` of tests/general_oracles.py): a small separable scene with
structure along x, y and z, HG or the C.1 table, and the whole-block
comparison of the kernels with their plain version at the launch,
mid-flight and tail states.

Imports neither jax nor the JAX package: ``chip_smoke.py`` and the tests
marked ``cuda`` load it on the card's machine.
"""

import importlib.util
from pathlib import Path

import numpy as np


def _load(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_tab = _load("tabulated_scenes")
_srf = _load("surface_scenes")
host = _tab.host
instantiation = _tab.instantiation

CFG_KW = dict(use_ray_tracing=False, max_events=500, compute_volume_absorption=False)
# Detectors of the marching scene: a nadir view, an oblique one along a
# diagonal (both horizontal components nonzero) and a downward one; and
# the two upward ones over a reflecting surface.
DETECTORS = dict(intensity_mus=[1.0, 0.5, -0.5], intensity_phis=[0.0, 40.0, 250.0])
UP_DETECTORS = dict(intensity_mus=[1.0, 0.5], intensity_phis=[0.0, 40.0])
LANES = (1 << 13) + 77           # a partial last CTA


def separable_3d(h, ssa: float = 0.95, table: bool = False, scale: float = 1.0):
    """A separable scene with structure along x, y and z (zero layers too;
    tests/test_torch_fastpath_plan.py separable_3d), HG g = 0.7 or the C.1
    table, its extinction times ``scale``."""
    vx = np.array([1.0, 1.0, 2.0, 2.0, 0.5, 0.5])
    vy = np.array([1.0, 3.0, 3.0, 1.0])
    vz = np.array([0.0, 0.01, 0.02, 0.02, 0.0])
    ext = scale * vx[:, None, None] * vy[None, :, None] * vz[None, None, :]
    pf_table = _tab.c1_table(h) if table else h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.7, 48))], key=[1.0])
    dom = h.Domain.create(np.linspace(0, 300.0, 7), np.linspace(0, 200.0, 5),
                          np.linspace(0, 100.0, 6))
    return dom.add_component("c", ext, np.full_like(ext, ssa), np.zeros(ext.shape, np.int32),
                             pf_table)


def march_cases() -> dict:
    """name -> (domain builder of a host, config keywords, Integrator.create
    keywords of the port): HG and the table variant, Iwabuchi off and on,
    absorbing and conservative, over a black surface (K3-M; y is tracked,
    the tally in the warps' slices); then over a Lambertian albedo and an
    RPV BRDF with upward detectors (K3-M+S), Iwabuchi on and off."""
    cases = {}
    for table in (False, True):
        for ssa in (1.0, 0.95):
            for iw in (False, True):
                cfg = dict(CFG_KW, use_russian_roulette_for_intensity=iw, zeta_min=0.3)
                cases[f"{'tab' if table else 'hg'}_{'iw' if iw else 'exact'}_ssa{ssa}"] = (
                    lambda h, s=ssa, t=table: separable_3d(h, s, t), cfg, dict(DETECTORS))
    for srf, iw, table in (("albedo", False, False), ("rpv", True, False),
                           ("albedo", True, True), ("rpv", False, True)):
        cfg = dict(CFG_KW, use_russian_roulette_for_intensity=iw, zeta_min=0.3)
        cases[f"{'tab' if table else 'hg'}_{'iw' if iw else 'exact'}_{srf}"] = (
            lambda h, t=table: separable_3d(h, 0.95, t), cfg, dict(UP_DETECTORS, _srf=srf))
    return cases


def case_integrator(name: str, dev, pkg: str = "i3rc_tpu_torch"):
    """The integrator of march_cases()[name] of package ``pkg``."""
    build, cfg, kw = march_cases()[name]
    h = host(pkg)
    kw = dict(kw)
    if "_srf" in kw:
        kw.update(_srf.surface_kw(h, kw.pop("_srf")))
    extra = {"device": dev} if pkg == "i3rc_tpu_torch" else {}
    return h.Integrator.create(build(h), config=h.Config(**cfg), **kw, **extra)


def trace_states(integ, source, n_photons: int, lanes: int, key):
    """(spec, pro, [(name, state, buffers, kb)]): the launch, mid-flight and
    tail states of one trace (tabulated_scenes.trace_states)."""
    return _tab.trace_states(integ, source, n_photons, lanes, key)


def block_vs_twin(spec, pro, st0, buf0, key, source, kb: int) -> dict:
    """One whole block of the kernels (K3-M, and over a reflecting surface
    its surface stage, K3-M+S) against ``fused_block_reference`` from the
    same state: ``bit_equal`` (every lane-state row, the lane weight of a
    BRDF plan, the control state and the next block's dead counts; over a
    black surface the flux and volume tallies too), ``acc_rel_err`` (the
    largest relative difference of the detector and surface-radiance
    tallies, and over a reflecting surface of the flux tallies: sums in
    another order), and the block's work from the plain version: lanes that
    ran (``live``), ``lane_events``, ``collisions`` (the growth of
    ``orders``, a refilled lane's restarting at 0; a revival counts one)
    and the bottom ``hits`` (the block's Fdn tally: exact over an albedo,
    weighted under a BRDF)."""
    import torch

    from i3rc_tpu_torch.kernels.event_block import (ALIVE, EVCT, ORDERS, fused_block,
                                                     fused_block_reference)

    got_st, got = st0.clone(), buf0.clone()
    ref_st, ref = st0.clone(), buf0.clone()
    fused_block(spec, pro, got_st, got, key, source, kb)
    fused_block_reference(spec, pro, ref_st, ref, key, source, kb)
    slot = (kb + 1) & 1
    pairs = [(got_st.f, ref_st.f), (got_st.i, ref_st.i), (got.ctl, ref.ctl),
             (got.dead[slot], ref.dead[slot])]
    summed = [(got.acc, ref.acc), (got.srf, ref.srf)]
    flux = [(got.columns, ref.columns), (got.vol, ref.vol)]
    (summed if spec.reflecting else pairs).extend(flux)
    if ref_st.w is not None:
        pairs.append((got_st.w, ref_st.w))
    err = 0.0
    for a, b in summed:
        if b is not None and b.numel():
            err = max(err, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300))
    ran = ref_st.i[EVCT] > st0.i[EVCT]
    dead0 = st0.i[ALIVE] == 0
    collisions = ref_st.i[ORDERS].sum() - (st0.i[ORDERS] * ~(dead0 & ran)).sum()
    hits = (ref.columns - buf0.columns).view(-1, pro.n_kinds)[:, 1].sum() \
        if spec.reflecting else 0
    return {"bit_equal": all(torch.equal(a, b) for a, b in pairs), "acc_rel_err": err,
            "max_abs_err": float((got_st.f - ref_st.f).abs().max()),
            "live": int(ran.sum()), "lane_events": int((ref_st.i[EVCT] - st0.i[EVCT]).sum()),
            "collisions": int(collisions), "hits": int(hits), "kb": kb}


# Phase 56 of chip_smoke.py and its CPU test: the step cloud's closed plan
# against the same plan made to march (tests/test_fastpath.py:994-1030).
CLOSED_VS_MARCH_DETECTORS = dict(intensity_mus=[1.0, 0.5, -0.5],
                                 intensity_phis=[0.0, 40.0, 180.0])
CLOSED_VS_MARCH_STEPS = 24


def closed_and_marching(integ):
    """(closed plan, the same plan with the marching trace of
    CLOSED_VS_MARCH_STEPS steps) of an integrator whose plan is closed."""
    from dataclasses import replace

    plan = integ._fast_plan
    assert plan is not None and plan.closed_shadow and plan.detectors
    return plan, replace(plan, closed_shadow=False, shadow_steps=CLOSED_VS_MARCH_STEPS)


def compare_closed_and_marching(r_c, r_m) -> dict:
    """The comparison of tests/test_fastpath.py:1022-1030 on two RawTallies
    of one key: the flux tallies bitwise equal (the shadow trace draws no
    random numbers), the radiance sums within rtol 2e-4, and each column
    within rtol 0.02 with atol 1e-3 of the largest."""
    i_c = r_c.intensity.double().cpu().numpy()
    i_m = r_m.intensity.double().cpu().numpy()
    flux_equal = all(bool((getattr(r_c, n) == getattr(r_m, n)).all())
                     for n in ("flux_up", "flux_down", "flux_absorbed"))
    sum_rel = abs(i_c.sum() - i_m.sum()) / abs(i_c.sum())
    atol = 1e-3 * float(np.abs(i_m).max())
    col_ok = bool(np.all(np.abs(i_c - i_m) <= atol + 0.02 * np.abs(i_m)))
    return {"flux_bit_equal": flux_equal, "sum_rel": float(sum_rel), "columns_ok": col_ok,
            "ok": flux_equal and i_c.sum() > 0.0 and sum_rel <= 2e-4 and col_ok,
            "max_col_diff": float(np.abs(i_c - i_m).max())}
