"""Fused-k spectral batching on the port (every k point of a band in one
trace, k a per-lane attribute) against the JAX package's fused mode
(``GasKTables``, i3rc_tpu/integrators/fastpath.py:244-265, :966-1057) and
against closed forms, on the CPU (the port's plain twin of the fused-k
kernel; the JAX fused mode runs on its XLA fastpath, as it always does).

The port partitions lanes into blocks of whole CTAs per k point (JAX: lane
by lane), so that a CTA holds one k; the quotas and tally weights are
JAX's, and the two agree in expectation, not draw for draw.  The band tests
are Monte Carlo comparisons: fluxes within 4 (JAX) or 5 (baked, traced)
combined sigma, closure within 1e-5, the closed forms at the JAX tests'
tolerances.  The one-event test holds the twin to JAX's own fast_event on
the same state, uniforms and per-lane k constants (integer fields equal on
>= 99.5% of lanes, floats within 1e-5 relative on >= 99.5% of those, as
tests/test_torch_gas.py holds the gas channel).
"""

import importlib.util
from dataclasses import replace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3rc_tpu.core.illumination import PhotonSource as JaxSource
from i3rc_tpu.integrators import fastpath as jfast
from i3rc_tpu.integrators import spectral as jspectral
from i3rc_tpu_torch import Integrator, KDistribution, PhotonSource, batch_key, run_band
from i3rc_tpu_torch.integrators import spectral
from i3rc_tpu_torch.integrators.fastpath import (GasKTables, event_spec, plan_from_jax,
                                                 state_from_numpy)
from i3rc_tpu_torch.kernels.event_block import (ALIVE, GCUR, LAUNCHED_K, PK, TGAS,
                                                _fast_event, compare_states)

_spec = importlib.util.spec_from_file_location("fused_k_scenes",
                                               Path(__file__).with_name("fused_k_scenes.py"))
fks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fks)

torch.set_num_threads(2)
JAX, PORT = fks.host("i3rc_tpu"), fks.host("i3rc_tpu_torch")
FIELDS = ("flux_up", "flux_down", "flux_absorbed")
L = 4096


def mean(band, field, stderr=False):
    return float(np.asarray(getattr(band.stderr if stderr else band.mean, field)).mean())


def _gas(h, dom, profile):
    return importlib.import_module(f"{h.pkg}.integrators.spectral").domain_with_gas_component(
        dom, profile)


def band_integrator(h, dom, kd, cfg_kw, **kw):
    """The band integrator of either side: its settings on the domain plus
    k point 0's gas (the port's on the CPU)."""
    z = np.asarray(dom.z_edges)
    if h is PORT:
        kw["device"] = "cpu"
    return h.Integrator.create(_gas(h, dom, kd.absorption_profiles_on(z)[:, 0]),
                               config=h.Config(**cfg_kw), **kw)


def jax_fused_tracer(dom, kd, cfg_kw, n_photons, lanes, **kw):
    """The JAX package's fused-k plan of the scene, its tracer's fast_event
    and the tracer's closure variables (its per-lane k vectors)."""
    integ = JAX.Integrator.create(
        _gas(JAX, dom, kd.absorption_profiles_on(np.asarray(dom.z_edges))[:, 0]),
        config=JAX.Config(**cfg_kw),
        gas_k=(kd.absorption_profiles_on(np.asarray(dom.z_edges)).T, kd.weights), **kw)
    plan = replace(integ._fast_plan, gas_k=jfast.GasKTables(*integ._gas_k))
    tracer = jfast.make_fast_tracer(integ.geometry, plan, integ.config, n_photons, lanes)
    return plan, closure_cells(tracer), integ


def closure_cells(fn, found=None):
    """Every variable of the closures reachable from fn, by name."""
    found = {} if found is None else found
    for name, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
        try:
            v = cell.cell_contents
        except ValueError:
            continue
        if name not in found:
            found[name] = v
            if callable(v) and getattr(v, "__code__", None) is not None:
                closure_cells(v, found)
    return found


def _bench3(h):
    dom = importlib.import_module(f"{h.pkg}.models.step_cloud").make_step_cloud(1.0)
    z = np.asarray(dom.z_edges)
    kd = importlib.import_module(f"{h.pkg}.core.k_distribution").KDistribution.create(
        z, np.broadcast_to([[4e-4], [4e-3], [2e-2]], (3, 32)).T.copy(), [0.5, 0.3, 0.2],
        spectral_fraction=1.0)
    return dom, kd, dict(fks.CFG_KW, majorant_block_size=16)


def _c1_band(h):
    """tests/test_spectral.py:336-367: a C.1 slab of optical depth 2 and a
    band of gas 0.3 / 3.0 (weights 0.7 / 0.3)."""
    dom = fks._tab.c1_slab(h)
    z = np.asarray(dom.z_edges)
    kd = importlib.import_module(f"{h.pkg}.core.k_distribution").KDistribution.create(
        z, np.broadcast_to([[0.3, 3.0]], (4, 2)).copy() / 250.0, [0.7, 0.3],
        spectral_fraction=1.0)
    return dom, kd, dict(fks.CFG_KW, max_events=2000)


# name -> (base domain, KDistribution, config keywords) of a host
PLAN_SCENES = {"bench_3k": _bench3, "c1_2k": _c1_band,
               "beer_lambert_detectors": lambda h: (*fks.beer_lambert(h), fks.CFG_KW)}


@pytest.mark.parametrize("scene", sorted(PLAN_SCENES))
def test_fused_plan_matches_jax(scene):
    """plan_from_jax of JAX's fused plan equals the port's; the port's k
    table, quotas and tally weights are JAX's (gk_table, gk_budget and the
    per-lane gk_lane_w of each k block)."""
    jdom, jkd, cfg = PLAN_SCENES[scene](JAX)
    tdom, tkd, _ = PLAN_SCENES[scene](PORT)
    det = dict(intensity_mus=[1.0, 0.5], intensity_phis=[0.0, 0.0]) \
        if scene.endswith("detectors") else {}
    n, lanes = 3000, 1024
    jplan, cells, _ = jax_fused_tracer(jdom, jkd, cfg, n, lanes, **det)
    tinteg = band_integrator(PORT, tdom, tkd, cfg, **det)
    z = np.asarray(tdom.z_edges)
    fused = Integrator.create(
        _gas(PORT, tdom, tkd.absorption_profiles_on(z)[:, 0]), config=PORT.Config(**cfg),
        device="cpu", gas_k=(tkd.absorption_profiles_on(z).T, tkd.weights), **det)
    tplan = fks.fused_plan(fused)
    assert tplan == plan_from_jax(jplan)
    assert tplan == replace(tinteg._fast_plan, gas_k=GasKTables(
        tkd.absorption_profiles_on(z).T, np.asarray(tkd.weights)))
    spec = event_spec(fused.geometry, tplan, fused.config, n, lanes)
    fk = spec.fk
    assert spec.fused and spec.gas and spec.chain == 0
    assert spec.det is None or spec.det.g_segs == ()
    assert np.array_equal(fk.table.numpy(), np.asarray(cells["gk_table"]))
    assert fk.quota.tolist() == np.asarray(cells["gk_budget"]).tolist()
    assert int(fk.quota.sum()) == n
    starts = np.asarray(cells["gk_starts_idx"])
    assert np.array_equal(fk.weight.numpy(), np.asarray(cells["gk_lane_w"])[starts])
    assert np.array_equal(fk.gtop.numpy(), np.asarray(cells["gk_gtop_lane"])[starts])
    assert fk.exact_layer is False and fk.lanes == lanes
    # The lane blocks: whole CTAs, JAX's remainder rule over them.
    counts = np.diff(fk.cta0.numpy())
    assert counts.sum() == lanes // 256 and counts.min() >= 1
    assert fk.launch_counts() == [min(256 * c, q) for c, q in zip(counts, fk.quota.tolist())]


def _twin_events(spec, st0, U, K, lane, acc):
    """K events of the twin on ``st0`` with per-lane k constants ``lane``."""
    got = state_from_numpy(st0[:14])
    f, i = got.f, got.i
    s = {"x": f[0], "y": f[1], "z": f[2], "ux": f[3], "uy": f[4], "uz": f[5], "tau": f[6],
         "tgas": f[7], "gcur": torch.from_numpy(np.asarray(st0[14], np.float32)),
         "alive": i[0] != 0, "orders": i[1], "pk": i[2], "bad": i[3], "evct": i[4],
         "w": None, **lane}
    for j in range(K):
        _fast_event(spec, torch.from_numpy(U[j]), s, acc)
    f = torch.stack([s[k] for k in ("x", "y", "z", "ux", "uy", "uz", "tau", "tgas", "gcur")])
    i = torch.stack([s["alive"].to(torch.int32), s["orders"], s["pk"], s["bad"], s["evct"]])
    return type(got)(f, i)


EVENT_CASES = {
    # name -> (scene, detectors, volume tally)
    "flux": ("bench_3k", False, False),
    "exact_layer": ("bench_3k", False, True),
    "detectors": ("bench_3k", True, False),
}


@pytest.mark.parametrize("case", sorted(EVENT_CASES))
def test_twin_matches_jax_fused_event(case):
    """One event and a block of 8 of the twin's fused-k step against JAX's
    fast_event in gask_mode on the same random state (tgas and gcur = Gz(z)
    of each lane's k), uniforms and per-lane k constants: the endpoint read,
    the death fraction (or with the volume tally the exact death layer),
    gcur and tgas of the survivors, and with detectors the weighted
    local estimates with each lane's own gas on the shadow ray."""
    scene, with_det, vol = EVENT_CASES[case]
    jdom, jkd, cfg = PLAN_SCENES[scene](JAX)
    tdom, tkd, _ = PLAN_SCENES[scene](PORT)
    cfg = dict(cfg, compute_volume_absorption=vol)
    det = dict(intensity_mus=[1.0, 0.5], intensity_phis=[0.0, 180.0]) if with_det else {}
    jplan, cells, jinteg = jax_fused_tracer(jdom, jkd, cfg, 4 * L, L, **det)
    fe = cells["fast_event"]
    geom = band_integrator(PORT, tdom, tkd, cfg, **det).geometry
    spec = event_spec(geom, plan_from_jax(jplan), PORT.Config(**cfg), 4 * L, L)
    assert spec.fk.exact_layer == vol and spec.K == 8
    rng = np.random.default_rng(5)
    f32, i32 = (lambda a: np.asarray(a, np.float32)), (lambda a: np.asarray(a, np.int32))
    row_off = np.asarray(cells["gk_row_off"])
    z = f32(rng.uniform(spec.z0, spec.z_max, L))
    tab = np.asarray(cells["gk_table"], np.float64)
    lay = np.minimum(((z - spec.z0) * spec.fk.inv_dz).astype(np.int32), spec.fk.n_z - 1)
    gcur = f32(tab[row_off + lay, 1] + (z - (spec.z0 + lay * spec.fk.dz)) * tab[row_off + lay, 0])
    d = rng.normal(size=(3, L))
    d /= np.linalg.norm(d, axis=0)
    d[2, :64] = rng.uniform(-5e-7, 5e-7, 64)          # near-horizontal: gz * step
    d /= np.linalg.norm(d, axis=0)
    n_det = len(det.get("intensity_mus", ()))
    st0 = (rng.uniform(size=L) < 0.9, f32(rng.uniform(spec.x0, spec.x_max, L)),
           f32(rng.uniform(spec.y0, spec.y_max, L)), z, f32(d[0]), f32(d[1]), f32(d[2]),
           f32(np.where(rng.uniform(size=L) < 0.5, 0.0, rng.exponential(size=L))),
           i32(rng.integers(0, 40, L)), i32(np.zeros(L)), i32(np.zeros(L)),
           i32(rng.integers(0, 100, L)),
           np.zeros((spec.det.n_cols, n_det) if n_det else (1, 1), np.float32),
           f32(rng.exponential(0.05, L)), gcur)
    U = rng.uniform(size=(spec.K, spec.n_draws, L)).astype(np.float32)
    lane = {"k_row": torch.from_numpy(row_off.astype(np.int64)),
            "kw": torch.from_numpy(np.array(cells["gk_lane_w"])),
            "gtop": torch.from_numpy(np.array(cells["gk_gtop_lane"]))}
    for K in (1, spec.K):
        jst = tuple(jnp.asarray(a) for a in st0)
        for j in range(K):
            jst = fe(jnp.asarray(U[j]), jst)
        jnp_st = [np.asarray(a) for a in jst]
        ref = state_from_numpy(jnp_st[:14])
        ref = type(ref)(torch.cat([ref.f, torch.from_numpy(jnp_st[14])[None]]), ref.i)
        acc = torch.zeros((spec.det.n_cols, n_det), dtype=torch.float64) if n_det else None
        got = _twin_events(spec, st0, U, K, lane, acc)
        agree = compare_states(spec, got, ref, rtol=1e-5)
        assert agree["int_frac"] >= 0.995 and agree["float_frac"] >= 0.995, agree
        if n_det:
            want = torch.from_numpy(jnp_st[12].astype(np.float64))
            assert float(want.sum()) > 0
            assert torch.allclose(acc, want, rtol=1e-4, atol=1e-6 * float(want.abs().max()))
    # Gas deaths happened (kind 3 without Bernoulli absorption), and the
    # survivors carried their gcur up or down with them.
    pk, alive = got.i[PK], got.i[ALIVE] != 0
    assert int((pk == 3).sum()) > 20 and int((pk == 1).sum()) > 0 and int(alive.sum()) > 100
    assert float((got.f[GCUR] != torch.from_numpy(gcur))[alive].float().mean()) > 0.9
    assert float((got.f[TGAS] < torch.from_numpy(st0[13]))[alive].float().mean()) > 0.9


def test_fused_band_matches_jax():
    """tests/test_spectral.py:132-176's band (the step cloud, k = 4e-4, 4e-3
    and 2e-2 per m, weights 0.5 / 0.3 / 0.2) fused on both sides: every
    flux field within 4 combined sigma, closure within 1e-5, per_k empty
    and a stderr from the batches."""
    n = 1 << 13
    jdom, jkd, cfg = _bench3(JAX)
    jband = jspectral.run_band(band_integrator(JAX, jdom, jkd, dict(cfg, fastpath_unroll=1)),
                               jdom, jkd, JaxSource.directional(0.5, 0.0), n, 2, seed=7,
                               fuse_k=True, integrator_cache={})
    tdom, tkd, _ = _bench3(PORT)
    tband = run_band(band_integrator(PORT, tdom, tkd, cfg), tdom, tkd,
                     PhotonSource.directional(0.5, 0.0), n, 2, seed=7, mode="fused")
    assert tband.per_k == [] == jband.per_k
    sigma = float(np.sqrt(2 * 0.25 / (2 * n * 3)))
    for f in FIELDS:
        assert mean(tband, f) == pytest.approx(mean(jband, f), abs=4 * sigma), f
        se = mean(tband, f, stderr=True)
        assert np.isfinite(se) and se > 0, f
    assert sum(mean(tband, f) for f in FIELDS) == pytest.approx(1.0, abs=1e-5)


def _run(dom, kd, cfg_kw, n, batches=2, seed=3, source=None, mode="fused", **kw):
    integ = band_integrator(PORT, dom, kd, cfg_kw, **kw)
    return run_band(integ, dom, kd, source or PhotonSource.directional(0.5, 0.0), n, batches,
                    seed=seed, mode=mode, integrator_cache={})


def test_fused_beer_lambert():
    """tests/test_spectral.py:178-222: through a near-transparent cloud each
    k point is exact Beer-Lambert, so the band's transmission is sum_k w_k
    exp(-tau_k / mu0), at rel 5e-3; closure within 1e-5."""
    dom, kd = fks.beer_lambert(PORT)
    band = _run(dom, kd, dict(fks.CFG_KW, max_events=100), 20_000)
    expected = float(np.sum(np.array([0.6, 0.4]) * np.exp(-np.array([0.2, 2.0]) / 0.5)))
    assert mean(band, "flux_down") == pytest.approx(expected, rel=5e-3)
    assert sum(mean(band, f) for f in FIELDS) == pytest.approx(1.0, abs=1e-5)


def test_fused_volume_absorption_beer_lambert():
    """tests/test_spectral.py:225-283: the cloud in the bottom layer only and
    layered gas, so the direct beam crosses three gas layers in one step;
    the exact death layer puts each layer's absorption at its closed form
    A_l = sum_k w_k [T_k(top of l) - T_k(bottom of l)] / dz, within 5 sigma
    + 8e-3 per m, and the volume tally integrates to the absorbed flux."""
    layer_taus = np.array([[0.05, 1.5], [0.10, 0.3], [0.20, 0.1], [0.40, 0.05]])
    weights = np.array([0.6, 0.4])
    dz = 0.25
    dom, _ = fks.beer_lambert(PORT, cloud=(1e-3, 0.0, 0.0, 0.0))
    kd = KDistribution.create(np.asarray(dom.z_edges), layer_taus / dz, weights,
                              spectral_fraction=1.0)
    n = 40_000
    band = _run(dom, kd, dict(fks.CFG_KW, max_events=100, compute_volume_absorption=True), n)
    vol = np.asarray(band.mean.volume_absorption).reshape(4)
    expect = np.zeros(4)
    for k, w in enumerate(weights):
        tau_above = np.concatenate([np.cumsum(layer_taus[::-1, k])[::-1], [0.0]])
        t_at = np.exp(-tau_above / 0.5)
        expect += w * (t_at[1:] - t_at[:-1]) / dz
    sigma = np.sqrt(np.maximum(expect * dz, 1e-4) / (2 * n)) / dz
    assert np.all(np.abs(vol - expect) < 5 * sigma + 8e-3), (vol, expect)
    assert vol.sum() * dz == pytest.approx(mean(band, "flux_absorbed"), abs=1e-5)


def test_fused_c1_matches_traced():
    """tests/test_spectral.py:336-385: the production broadband class, a
    tabulated (C.1) cloud plus a k-distribution gas, fused (the table
    variant's twin) against the traced mode (the general kernel with each k
    point's optics): every flux field within 5 combined standard errors +
    5e-4, both detectors within 15%."""
    dom, kd, cfg = _c1_band(PORT)
    det = dict(intensity_mus=[1.0, 0.5], intensity_phis=[0.0, 0.0])
    n = 1 << 13
    fused = _run(dom, kd, cfg, n, batches=4, seed=7, **det)
    traced = _run(dom, kd, dict(cfg, use_fastpath=False, majorant_block_size=4), n,
                  batches=4, seed=5, mode="traced", **det)
    for f in FIELDS:
        se = np.hypot(mean(fused, f, True), mean(traced, f, True))
        assert abs(mean(fused, f) - mean(traced, f)) < 5 * se + 5e-4, f
    i_f = np.asarray(fused.mean.intensity).reshape(-1, 2).mean(0)
    i_g = np.asarray(traced.mean.intensity).reshape(-1, 2).mean(0)
    np.testing.assert_allclose(i_f, i_g, rtol=0.15)


def test_fused_detectors_match_baked():
    """The case grid of tests/fused_k_scenes.py (8 columns x 8 layers, the
    3 k points of its layered gas) with the I3RC detectors and Iwabuchi
    roulette: the fused band's weighted radiances and fluxes against the
    baked band's, within 5 combined standard errors."""
    tdom = fks.grid(PORT, 8, 1, 1.0)
    cfg = dict(fks.CFG_KW, use_russian_roulette_for_intensity=True, zeta_min=0.3)
    tkd = KDistribution.create(np.asarray(tdom.z_edges), fks.CASE_PROFILES.T.copy(),
                               fks.CASE_WEIGHTS, spectral_fraction=1.0)
    det = dict(intensity_mus=[1.0, 0.5, 0.5], intensity_phis=[0.0, 0.0, 180.0])
    n = 1 << 12
    fused = _run(tdom, tkd, cfg, n, batches=4, seed=11, **det)
    baked = _run(tdom, tkd, cfg, n, batches=4, seed=12, mode="baked", **det)
    i_f = np.asarray(fused.mean.intensity).reshape(-1, 3).mean(0)
    i_b = np.asarray(baked.mean.intensity).reshape(-1, 3).mean(0)
    se = np.hypot(np.asarray(fused.stderr.intensity).reshape(-1, 3),
                  np.asarray(baked.stderr.intensity).reshape(-1, 3)).mean(0)
    assert np.all(i_f > 0) and np.all(np.abs(i_f - i_b) < 5 * se + 1e-6), (i_f, i_b, se)
    for f in FIELDS:
        se = np.hypot(mean(fused, f, True), mean(baked, f, True))
        assert abs(mean(fused, f) - mean(baked, f)) < 5 * se, f


def test_fused_internal_source_closed_form():
    """An upward Lambertian internal source at mid-height of the Beer-Lambert
    scene (gas optical depths 0.2 / 2.0, weights 0.6 / 0.4): Fup is sum_k
    w_k 2 E3(tau_k / 2) = 0.58730, within 4 sigma.

    The JAX fused mode gives 0.9089 here (2 x 20,000 photons a k point):
    it starts every lane, at launch and refill, with the cumulative gas
    depth of the domain's top whatever the source
    (i3rc_tpu/integrators/fastpath.py:1029-1032, :2012, :2107-2108), so the
    first step of a lane that starts at mid-height sees (Gz(z2) - Gz(top))
    / uz <= 0 of gas: none.  The port starts gcur at Gz of the lane's own
    height."""
    dom, kd = fks.beer_lambert(PORT)
    n = 20_000
    src = PhotonSource.internal_flux(0.5, 0.5, 0.5, True)
    band = _run(dom, kd, dict(fks.CFG_KW, max_events=100), n, source=src)
    want = fks.internal_closed_form()
    assert want == pytest.approx(0.58730, abs=5e-6)
    sigma = np.sqrt(want * (1 - want) / (2 * n * 2))
    assert abs(mean(band, "flux_up") - want) < 4 * sigma, (mean(band, "flux_up"), want)
    assert sum(mean(band, f) for f in FIELDS) == pytest.approx(1.0, abs=1e-5)


def test_fused_quotas_and_partition():
    """A fused trace on the twin launches exactly each k point's quota
    (JAX's gk_budget) through the per-k FIFO refill, at a lane width raised
    to one CTA per k point (64 photons of 3 k points run at 768 lanes, the
    lanes past each quota dead from the start)."""
    from i3rc_tpu_torch.integrators.fastpath import launch_state, prologue_spec
    from i3rc_tpu_torch.kernels.event_block import block_buffers, fused_block

    integ = fks.case_integrator("flux_ssa0.99_ny1", "cpu")
    assert integ.n_k == 3
    for n, lanes in ((64, None), (5000, 800)):
        res = integ.batch_fn(PhotonSource.directional(0.5, 0.0), n, n_lanes=lanes)(
            batch_key(2, 1))
        total = float(res.mean_flux_up + res.mean_flux_down + res.mean_flux_absorbed)
        assert total == pytest.approx(1.0, abs=1e-5) and int(res.n_bad) == 0
    spec = event_spec(integ.geometry, fks.fused_plan(integ), integ.config, 5000, 800)
    assert spec.fk.lanes == 800 and np.diff(spec.fk.cta0.numpy()).tolist() == [2, 1, 1]
    assert spec.fk.quota.tolist() == [2500, 1500, 1000]
    pro = prologue_spec(integ.geometry, spec, integ.config, 5000)
    key, src = batch_key(2, 2), PhotonSource.directional(0.5, 0.0)
    st = launch_state(integ.geometry, src.sample(key, 800, "cpu"), 5000, gas_key=key,
                      spec=spec)
    assert st.f.shape == (9, 800) and int(st.i[ALIVE].sum()) == 800
    buf = block_buffers(spec, pro, st, spec.fk.launch_counts())
    assert buf.ctl[LAUNCHED_K::2].tolist() == [512, 256, 32]
    kb = 0
    while int(buf.ctl[2]) < 0:
        fused_block(spec, pro, st, buf, key, src, kb)
        kb += 1
    assert buf.ctl[LAUNCHED_K + (kb & 1)::2].tolist() == [2500, 1500, 1000]
    assert 0 <= int(buf.ctl[3]) < int(buf.ctl[2])


def test_auto_mode_and_refusals(monkeypatch):
    """mode="auto" runs an eligible band fused up to
    spectral.FUSED_AUTO_MAX_PHOTONS photons a band batch and baked above; a
    band without a gas-channel fastpath plan (a 3-D cloud that does not
    factor) falls back to the traced mode under "auto" and raises a
    ValueError that names the reason under "fused"; gas_k is validated as
    the JAX package validates it, and a fused integrator takes no optics
    override."""
    dom, kd = fks.beer_lambert(PORT)
    cfg = dict(fks.CFG_KW, max_events=100)
    band = _run(dom, kd, cfg, 512, mode="auto")
    assert band.per_k == []
    monkeypatch.setattr(spectral, "FUSED_AUTO_MAX_PHOTONS", 512 * kd.n_k - 1)
    band = _run(dom, kd, cfg, 512, mode="auto")
    assert len(band.per_k) == kd.n_k == 2
    monkeypatch.undo()
    rng = np.random.default_rng(3)
    ext = rng.uniform(0.5, 2.0, (3, 2, 4)) * 1e-3
    lumpy = PORT.Domain.create([0, 1.0, 2.0, 3.0], [0, 1.0, 2.0], np.linspace(0, 1.0, 5))
    lumpy = lumpy.add_component("cloud", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32),
                                fks.hg_table(PORT, 0.85, 16))
    auto = _run(lumpy, kd, cfg, 512, mode="auto")
    assert len(auto.per_k) == 2
    with pytest.raises(ValueError, match="gas-channel fastpath plan"):
        _run(lumpy, kd, cfg, 512, mode="fused")
    profiles = kd.absorption_profiles_on(np.asarray(dom.z_edges)).T
    gdom = _gas(PORT, dom, profiles[0])
    for bad, match in (((profiles[:, :3], kd.weights), r"\(n_k, n_z\)"),
                       ((profiles, [1.0, -1.0]), "weights must be > 0"),
                       ((-profiles, kd.weights), "non-negative")):
        with pytest.raises(ValueError, match=match):
            PORT.Integrator.create(gdom, device="cpu", gas_k=bad)
    fused = PORT.Integrator.create(gdom, config=PORT.Config(**cfg), device="cpu",
                                   gas_k=(profiles, kd.weights))
    tracer = fused.batch_tracer(512)
    src = PhotonSource.directional(0.5, 0.0)
    with pytest.raises(ValueError, match="optics override"):
        tracer(batch_key(1, 0), src.sample(batch_key(1, 0), 768, "cpu"), src, object())
