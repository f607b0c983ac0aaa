"""The gas channel on the port's fastpath against the JAX package.

The gas variant of the event block (``_build_pallas_block(gas=True)``,
i3rc_tpu/integrators/fastpath.py:665) carries each lane's remaining gas
optical depth ``tgas``: steps also stop at the gas segment faces, the gas
absorption competes with the collision and the crossing (:1361-1391), a gas
death pends as kind 3 (:1469-1470), chained collisions stay inside the gas
layer and pay their gas cost (:1622-1652), and the shadow rays of the
detectors add the gas segments (:1219-1233).  Here the port's planner, its
plain twin, the combined-medium slab and the gas slices are each held
against the JAX package (or the slab oracle) on the CPU.

Tolerances: the twin-vs-JAX event check is the one of
tests/test_torch_event_block.py (integer fields equal on >= 99.5% of lanes,
floats within 1e-5 relative on >= 99.5% of those; XLA and torch round log
and rsqrt differently in the last ulp).  The slices are Monte Carlo
estimates: fluxes within 4 sigma of the oracle or of the JAX run, radiances
within 12% at 2^14 photons (tests/test_fastpath.py:868).
"""

import importlib
import os
from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3rc_tpu.core.illumination import PhotonSource as JaxSource
from i3rc_tpu.integrators import fastpath as jfast
from i3rc_tpu.integrators.integrator import Integrator as JaxIntegrator
from i3rc_tpu.integrators.results import normalize_tallies as jax_normalize
from i3rc_tpu.integrators.wavefront import RawTallies as JaxRawTallies
from i3rc_tpu_torch import Integrator, PhotonSource, batch_key
from i3rc_tpu_torch.core.rng import (
    GAS_LAUNCH_BLOCK,
    STREAM_EVENT,
    STREAM_GAS,
    STREAM_LAUNCH,
    STREAM_REFILL,
    gas_thresholds,
    philox_uniforms,
    stream_uniforms,
)
from i3rc_tpu_torch.integrators.fastpath import (
    event_spec,
    launch_state,
    plan_from_jax,
    state_from_numpy,
)
from i3rc_tpu_torch.integrators.results import column_weights, normalize_tallies
from i3rc_tpu_torch.integrators.wavefront import RawTallies
from i3rc_tpu_torch.kernels.event_block import (
    TGAS,
    compare_states,
    event_block,
    event_block_reference,
)
from tests.disort_oracle import hg_slab_fluxes

torch.set_num_threads(2)
DET = dict(intensity_mus=[1.0, 0.5], intensity_phis=[0.0, 0.0])
L = 4096
GAS_EXT = 3e-4          # tests/test_fastpath.py:883
C1_PF = os.path.join(os.path.dirname(__file__), os.pardir, "i3rc_tpu", "models", "data",
                     "C.1_PF")


def host(pkg: str) -> SimpleNamespace:
    """One side's host layer (the port keeps its copies under the JAX
    package's module paths) and its gas-component helper."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    pf = mod("core.phase_functions")
    return SimpleNamespace(
        Domain=mod("core.optics").Domain, PhaseFunction=pf.PhaseFunction,
        PhaseFunctionTable=pf.PhaseFunctionTable, hg=pf.henyey_greenstein_coefficients,
        make_step_cloud=mod("models.step_cloud").make_step_cloud,
        gas=mod("integrators.spectral").domain_with_gas_component,
        cfg=mod("integrators.config").IntegratorConfig(
            use_ray_tracing=False, max_events=500, compute_volume_absorption=False))


JAX, PORT = host("i3rc_tpu"), host("i3rc_tpu_torch")
CFG = PORT.cfg


def _hg_table(h, g=0.85, n=64):
    return h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(g, n))], key=[1.0])


def gas_slab(h, tau_cloud=1.0, tau_gas=0.5, nz=8):
    """Uniform HG cloud slab plus a uniform gas (tests/test_external_validation.py:
    138-148)."""
    base = h.Domain.create([0, 500.0], [0, 500.0], np.linspace(0, 250, nz + 1))
    ext = np.full((1, 1, nz), tau_cloud / 250.0)
    base = base.add_component("cloud", ext, np.ones_like(ext),
                              np.zeros(ext.shape, np.int32), _hg_table(h))
    return h.gas(base, np.full(nz, tau_gas / 250.0))


def layered_gas():
    """Three gas layers: the gas chain has faces of its own."""
    return np.concatenate([np.full(16, 1e-3), np.full(8, 5e-4), np.full(8, 1e-4)])


def step_gas(h, ssa=1.0, profile=None):
    return h.gas(h.make_step_cloud(ssa), np.full(32, GAS_EXT) if profile is None else profile)


def gas_first(h, ssa=1.0):
    """The gas as component 0 and the cloud as component 1 (gas_idx 0)."""
    dom = h.gas(h.Domain.create([0, 250.0, 500.0], [0, 500.0], np.linspace(0, 250, 5)),
                np.full(4, 1e-3))
    ext = np.full((2, 1, 4), 2.0 / 250.0)
    ext[1] *= 0.5
    return dom.add_component("cloud", ext, np.full_like(ext, ssa),
                             np.zeros(ext.shape, np.int32), _hg_table(h))


def y_scene_gas(h, ssa=0.99):
    """Separable cloud varying along x, y and z (y is tracked) plus layered gas."""
    vx = np.array([1.0, 2.0, 2.0, 0.5])
    vy = np.array([1.0, 3.0, 1.0])
    vz = np.array([0.0, 0.02, 0.03, 0.0])
    ext = vx[:, None, None] * vy[None, :, None] * vz[None, None, :]
    dom = h.Domain.create(np.linspace(0, 300.0, 5), np.linspace(0, 200.0, 4),
                          np.linspace(0, 100.0, 5))
    dom = dom.add_component("c", ext, np.full_like(ext, ssa),
                            np.zeros(ext.shape, np.int32), _hg_table(h, n=48))
    return h.gas(dom, np.array([2e-3, 2e-3, 5e-3, 1e-3]))


# name -> (domain builder of one side, detector kwargs)
GAS_DOMAINS = {
    "slab": lambda h: (gas_slab(h), {}),
    "step": lambda h: (step_gas(h), {}),
    "step_absorbing_layered": lambda h: (step_gas(h, 0.99, layered_gas()), {}),
    "gas_first": lambda h: (gas_first(h), {}),
    "y_scene": lambda h: (y_scene_gas(h), {}),
    "step_detectors": lambda h: (step_gas(h), DET),
    "layered_detectors": lambda h: (step_gas(h, 1.0, layered_gas()), DET),
}


@pytest.mark.parametrize("name", sorted(GAS_DOMAINS))
def test_gas_plan_matches_jax(name):
    jdom, det = GAS_DOMAINS[name](JAX)
    jplan = JaxIntegrator.create(jdom, config=JAX.cfg, **det)._fast_plan
    tinteg = Integrator.create(GAS_DOMAINS[name](PORT)[0], config=CFG, device="cpu", **det)
    tplan = tinteg._fast_plan
    assert jplan is not None and jplan.gas_factor is not None
    assert tplan.gas_factor.thresholds == jplan.gas_factor.thresholds
    assert tplan.gas_factor.values == jplan.gas_factor.values
    for axis in ("fx", "fy", "fz"):
        jf, tf = getattr(jplan, axis), getattr(tplan, axis)
        assert tf.thresholds == jf.thresholds and tf.values == jf.values
    assert (tplan.gas_idx, tplan.ssa, tplan.hg_g, tplan.closed_shadow) == (
        jplan.gas_idx, jplan.ssa, jplan.hg_g, jplan.closed_shadow)
    assert tplan.gas_idx == (0 if name == "gas_first" else 1)
    assert plan_from_jax(jplan) == tplan
    spec = event_spec(tinteg.geometry, tplan, CFG)
    assert spec.gas and spec.chain == (0 if det else 3)
    if det:
        # The gas adds its own vertical segments to every shadow ray.
        gf = tplan.gas_factor
        assert len(spec.det.g_segs) == gf.n_ops + 1
        assert [v for _, _, v in spec.det.g_segs] == [np.float32(v) for v in gf.values]


def test_second_scatterer_has_no_plan():
    """A second component that scatters is not a gas: no fastpath plan on
    either side (tests/test_fastpath.py:483-488)."""
    def two_clouds(h):
        dom = h.Domain.create([0, 500.0], [0, 500.0], np.linspace(0, 250, 9))
        ext = np.full((1, 1, 8), 1 / 250.0)
        dom = dom.add_component("cloud", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32),
                                _hg_table(h))
        ext2 = np.linspace(1, 2, 8).reshape(1, 1, 8) / 250.0
        return dom.add_component("cloud2", ext2, np.ones_like(ext2),
                                 np.zeros(ext2.shape, np.int32), _hg_table(h))

    assert JaxIntegrator.create(two_clouds(JAX), config=JAX.cfg)._fast_plan is None
    assert Integrator.create(two_clouds(PORT), config=CFG, device="cpu")._fast_plan is None


def test_tabulated_cloud_with_gas_raises():
    """Tabulated (C.1) cloud plus gas: the JAX fastpath takes it with its
    cubic sampler; the port raises for ROADMAP item 15.  The C.1 table is
    read from its data file as i3rc_tpu/models/radar_cloud.py reads it."""
    raw = np.loadtxt(C1_PF)

    def c1_gas(h):
        table = h.PhaseFunctionTable.from_phase_functions(
            [h.PhaseFunction.from_tabulated(np.deg2rad(raw[:, 0]), raw[:, 1])], key=[1.0])
        dom = h.Domain.create([0, 500.0], [0, 500.0], np.linspace(0, 250, 5))
        ext = np.full((1, 1, 4), 2.0 / 250.0)
        dom = dom.add_component("cloud", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32),
                                table)
        return h.gas(dom, np.full(4, 0.5 / 250.0))

    jplan = JaxIntegrator.create(c1_gas(JAX), config=JAX.cfg)._fast_plan
    assert jplan is not None and jplan.gas_factor is not None and jplan.cubic is not None
    with pytest.raises(NotImplementedError, match="item 15"):
        Integrator.create(c1_gas(PORT), config=CFG, device="cpu")._fast_plan
    with pytest.raises(NotImplementedError, match="item 15"):
        plan_from_jax(jplan)


def test_fused_k_plan_raises():
    """A JAX plan with fused-k tables (GasKTables) is ROADMAP item 13b."""
    jplan = JaxIntegrator.create(step_gas(JAX), config=JAX.cfg)._fast_plan
    with pytest.raises(NotImplementedError, match="item 13b"):
        plan_from_jax(replace(jplan, gas_k=object()))


def test_gas_threshold_stream():
    """Launch thresholds come from STREAM_GAS at GAS_LAUNCH_BLOCK, disjoint
    from the event, refill and launch streams, and are Exp(1)."""
    key, n = batch_key(9, 4), 1 << 14
    tg = gas_thresholds(key, GAS_LAUNCH_BLOCK, n, "cpu")
    u = stream_uniforms(key, STREAM_GAS, GAS_LAUNCH_BLOCK, 1, n, "cpu")[0]
    assert torch.equal(tg, -torch.log(u.clamp(min=1.1754944e-38)))
    for stream in (STREAM_EVENT, STREAM_REFILL, STREAM_LAUNCH):
        other = stream_uniforms(key, stream, GAS_LAUNCH_BLOCK, 1, n, "cpu")[0]
        assert float((other == u).float().mean()) < 1e-3
    assert not torch.equal(gas_thresholds(key, 0, n, "cpu"), tg)
    assert float(tg.mean()) == pytest.approx(1.0, abs=4 / n ** 0.5)
    integ = Integrator.create(step_gas(PORT), config=CFG, device="cpu")
    batch = PhotonSource.directional(0.5, 0.0).sample(key, n, "cpu")
    assert torch.equal(launch_state(integ.geometry, batch, n, gas_key=key).f[TGAS], tg)
    assert float(launch_state(integ.geometry, batch, n).f[TGAS].abs().max()) == 0.0


def _jax_gas_event(dom, cfg, det, monkeypatch):
    """The JAX fast_event of the Pallas gas path, and its draw count (``dom``
    and ``cfg`` of the JAX package)."""
    jinteg = JaxIntegrator.create(dom, config=cfg, **det)
    captured = {}

    def record(fast_event, track_y, L_, K, **kw):
        captured.update(fe=fast_event, n_draws=kw["n_draws"], gas=kw["gas"],
                        n_det=kw["n_detectors"])
        return lambda seed2, st: st

    monkeypatch.setattr(jfast, "_build_pallas_block", record)
    jfast.make_fast_tracer(jinteg.geometry, jinteg._fast_plan,
                           replace(cfg, use_pallas_fastpath=True), 1 << 14, L)
    assert captured["gas"] and captured["n_det"] == len(det.get("intensity_mus", ()))
    return captured["fe"], captured["n_draws"], jinteg._fast_plan


def _random_state(spec, rng):
    """Random in-domain lanes with gas thresholds, in the JAX state order."""
    x = rng.uniform(spec.x0, spec.x_max, L)
    y = rng.uniform(spec.y0, spec.y_max, L)
    z = rng.uniform(spec.z0, spec.z_max, L)
    d = rng.normal(size=(3, L))
    d /= np.linalg.norm(d, axis=0)
    tau = np.where(rng.uniform(size=L) < 0.5, 0.0, rng.exponential(size=L))
    orders = rng.integers(0, 40, L)
    orders[:16] = spec.max_events - 1
    tgas = rng.exponential(0.3, L)
    f32 = lambda a: np.asarray(a, np.float32)
    i32 = lambda a: np.asarray(a, np.int32)
    return (rng.uniform(size=L) < 0.9, f32(x), f32(y), f32(z), f32(d[0]), f32(d[1]),
            f32(d[2]), f32(tau), i32(orders), np.zeros(L, np.int32), np.zeros(L, np.int32),
            i32(rng.integers(0, 100, L)), np.zeros((1, 1), np.float32), f32(tgas))


EVENT_CASES = {
    "step": lambda h, ssa: (step_gas(h, ssa), {}),
    "step_layered": lambda h, ssa: (step_gas(h, ssa, layered_gas()), {}),
    "y_scene": lambda h, ssa: (y_scene_gas(h, ssa), {}),
    "step_detectors": lambda h, ssa: (step_gas(h, ssa), DET),
    "layered_detectors": lambda h, ssa: (step_gas(h, ssa, layered_gas()), DET),
}


@pytest.mark.parametrize("case,ssa", [("step", 1.0), ("step", 0.99), ("y_scene", 0.99),
                                      ("step_detectors", 1.0), ("step_detectors", 0.99),
                                      ("layered_detectors", 1.0)])
def test_twin_matches_jax_gas_event(case, ssa, monkeypatch):
    """One event and one K = 8 block on the same state (tgas included) and
    uniforms; with detectors, the (contribution, column) records too."""
    jdom, det = EVENT_CASES[case](JAX, ssa)
    fe, n_draws, jplan = _jax_gas_event(jdom, JAX.cfg, det, monkeypatch)
    tinteg = Integrator.create(EVENT_CASES[case](PORT, ssa)[0], config=CFG, device="cpu",
                               **det)
    spec = event_spec(tinteg.geometry, plan_from_jax(jplan), CFG)
    assert spec.gas and spec.n_draws == n_draws
    assert spec.chain == (0 if det else 3)
    rng = np.random.default_rng(31)
    st0 = _random_state(spec, rng)
    U = rng.uniform(size=(spec.K, spec.n_draws, L)).astype(np.float32)
    n_det = len(det.get("intensity_mus", ()))
    for K in (1, spec.K):
        jst = tuple(jnp.asarray(a) for a in st0)
        jrecs = []
        for j in range(K):
            jst = fe(jnp.asarray(U[j]), jst,
                     det_sink=(lambda d, c, col: jrecs.append((np.asarray(c), np.asarray(col))))
                     if n_det else None)
        ref = state_from_numpy([np.asarray(a) for a in jst])
        got = state_from_numpy(st0)
        acc = torch.zeros((spec.det.n_cols, n_det), dtype=torch.float64) if n_det else None
        recs = [] if n_det else None
        event_block_reference(replace(spec, K=K), got, torch.from_numpy(U[:K]), acc, recs)
        agree = compare_states(spec, got, ref, rtol=1e-5)
        assert agree["int_frac"] >= 0.995 and agree["float_frac"] >= 0.995, agree
        if n_det:
            int_eq = (got.i == ref.i).all(dim=0).numpy()
            assert len(recs) == len(jrecs) == n_det * K
            n_ok = n_all = 0
            for (c, col), (w, jcol) in zip(recs, jrecs):
                c, col = c.numpy(), col.numpy()
                live = int_eq & ((c != 0) | (w != 0))
                ok = (col == jcol) & (np.abs(c - w) <= 1e-5 * np.abs(w))
                n_ok += int((ok & live).sum())
                n_all += int(live.sum())
            assert n_all > 100 and n_ok >= 0.995 * n_all, (n_ok, n_all)
    # The block did real work: exits both ways and gas deaths (kind 3 even
    # without Bernoulli absorption), and the gas thresholds were consumed.
    pk = got.i[2]
    assert int((pk == 1).sum()) > 0 and int((pk == 2).sum()) > 0 and int((pk == 3).sum()) > 0
    assert float((got.f[TGAS] < torch.from_numpy(st0[13])).float().mean()) > 0.5


def test_gas_slab_matches_oracle():
    """Cloud tau 1 plus gas tau 0.5 is an HG slab of tau 1.5 and ssa 1/1.5:
    the port's twin against the discrete-ordinates oracle at 4 sigma."""
    n = 1 << 16
    cfg = replace(CFG, max_events=2000)
    res = Integrator.create(gas_slab(PORT), config=cfg, device="cpu").batch_fn(
        PhotonSource.directional(0.5, 0.0), n, n_lanes=1 << 14)(batch_key(11, 0))
    r_ex, t_ex = hg_slab_fluxes(1.5, 1.0 / 1.5, 0.85, 0.5, n_legendre=64)
    sigma = np.sqrt(max(r_ex * (1 - r_ex), t_ex * (1 - t_ex)) / n)
    assert float(res.mean_flux_up) == pytest.approx(r_ex, abs=4 * sigma)
    assert float(res.mean_flux_down) == pytest.approx(t_ex, abs=4 * sigma)
    assert float(res.mean_flux_absorbed) == pytest.approx(1 - r_ex - t_ex, abs=4 * sigma)
    total = float(res.mean_flux_up + res.mean_flux_down + res.mean_flux_absorbed)
    assert total == pytest.approx(1.0, abs=1e-5) and int(res.n_bad) == 0


def _both(scene, det, n, lanes, seed):
    """(JAX XLA fastpath results, port results) on the same scene, each side
    built by ``scene(h)`` with its own classes."""
    jres = JaxIntegrator.create(scene(JAX), config=replace(JAX.cfg, fastpath_unroll=1),
                                **det).batch_fn(
        JaxSource.directional(0.5, 0.0), n, n_lanes=lanes)(jax.random.PRNGKey(seed))
    tres = Integrator.create(scene(PORT), config=CFG, device="cpu", **det).batch_fn(
        PhotonSource.directional(0.5, 0.0), n, n_lanes=lanes)(batch_key(seed, 0))
    return jres, tres


def test_gas_slice_matches_jax():
    """Step cloud plus a layered gas, ssa 0.99, 2^14 photons: Fup, Fdn and
    Fabs of the port within 4 sigma of the JAX XLA fastpath (sigma of the
    difference, sqrt(2 * 0.25 / n)); closure to 1e-5."""
    n = 1 << 14
    jres, tres = _both(lambda h: step_gas(h, 0.99, layered_gas()), {}, n, 1 << 12, 25)
    sigma = np.sqrt(2 * 0.25 / n)
    for field in ("mean_flux_up", "mean_flux_down", "mean_flux_absorbed"):
        assert float(getattr(tres, field)) == pytest.approx(
            float(getattr(jres, field)), abs=4 * sigma), field
    total = float(tres.mean_flux_up + tres.mean_flux_down + tres.mean_flux_absorbed)
    assert total == pytest.approx(1.0, abs=1e-5) and int(tres.n_bad) == 0
    assert float(tres.mean_flux_absorbed) > 0.1


def test_gas_radiance_slice_matches_jax():
    """Step cloud plus gas 3e-4 with two detectors, Iwabuchi off (the JAX
    Iwabuchi rule differs, ROADMAP Queue 3): radiance within 12% of the JAX
    XLA fastpath at 2^14 photons (tests/test_fastpath.py:875-900), the
    three-slot component layout, and closure."""
    n = 1 << 14
    jres, tres = _both(lambda h: step_gas(h, 1.0), DET, n, 1 << 12, 45)
    np.testing.assert_allclose(tres.mean_intensity.numpy(), np.asarray(jres.mean_intensity),
                               rtol=0.12)
    total = float(tres.mean_flux_up + tres.mean_flux_down + tres.mean_flux_absorbed)
    assert total == pytest.approx(1.0, abs=1e-5) and int(tres.n_bad) == 0
    # Slots: surface (black: zero), cloud (component 0), gas (component 1,
    # a pure absorber: zero).
    by = tres.intensity_by_component
    assert by.shape == (32, 1, 2, 3) == np.asarray(jres.intensity_by_component).shape
    assert float(by[..., 0].abs().max()) == 0.0 and float(by[..., 2].abs().max()) == 0.0
    assert torch.equal(by[..., 1], tres.intensity)


def test_normalize_two_components_matches_jax():
    """normalize_tallies with D = 2 and n_comp = 2 (the gas layout: three
    slots per detector), port vs JAX on the same raw tallies, to 1e-6."""
    rng = np.random.default_rng(8)
    nx, ny, nz, D, n_comp = 3, 2, 4, 2, 2
    cw = column_weights(np.array([0.0, 1.0, 2.5, 3.0]), np.array([0.0, 2.0, 3.0]))
    dz = np.array([0.5, 1.5, 1.0, 1.0], np.float32)
    by_comp = rng.uniform(0, 50, (nx * ny * D, n_comp + 1))
    by_comp[:, [0, 2]] = 0.0
    raw = dict(flux_up=rng.uniform(0, 100, nx * ny), flux_down=rng.uniform(0, 100, nx * ny),
               flux_absorbed=rng.uniform(0, 10, nx * ny),
               volume_absorption=rng.uniform(0, 5, nx * ny * nz),
               intensity=by_comp.sum(axis=1), intensity_by_component=by_comp.reshape(-1),
               intensity_excess=np.zeros(D * (n_comp + 1)))
    jres = jax_normalize(JaxRawTallies(
        **{k: jnp.asarray(v, jnp.float32) for k, v in raw.items()},
        n_photons=jnp.int32(3000), n_bad=jnp.int32(0), n_iterations=jnp.int32(0),
        n_lane_events=jnp.float32(0.0)), nx, ny, nz, D, n_comp, cw, dz)
    tres = normalize_tallies(RawTallies(
        **{k: torch.as_tensor(v, dtype=torch.float64) for k, v in raw.items()},
        n_photons=3000, n_bad=torch.tensor(0), n_iterations=0,
        n_lane_events=torch.tensor(0)), nx, ny, nz, D, n_comp, cw, dz)
    for name in ("flux_absorbed", "volume_absorption", "intensity",
                 "intensity_by_component", "mean_intensity"):
        np.testing.assert_allclose(getattr(tres, name).numpy(),
                                   np.asarray(getattr(jres, name)), rtol=1e-6, err_msg=name)
    assert tres.intensity_by_component.shape == (nx, ny, D, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("case,ssa", [("step", 1.0), ("step", 0.99), ("step_layered", 0.99),
                                      ("y_scene", 0.99), ("step_detectors", 1.0),
                                      ("layered_detectors", 0.99)])
def test_gas_kernel_matches_twin_on_gpu(case, ssa):
    """The CUDA gas variants against their twin on the same Philox draws:
    lane state bit for bit (8 rows), the accumulator to 1e-9 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    dom, det = EVENT_CASES[case](PORT, ssa)
    integ = Integrator.create(dom, config=CFG, device=dev, **det)
    spec = event_spec(integ.geometry, integ._fast_plan, CFG)
    st = state_from_numpy(_random_state(spec, np.random.default_rng(5)), device=dev)
    got, ref = st.clone(), st.clone()
    n_det = len(det.get("intensity_mus", ()))
    acc_k = torch.zeros((spec.det.n_cols, n_det), dtype=torch.float64,
                        device=dev) if n_det else None
    acc_t = acc_k.clone() if n_det else None
    key = batch_key(1, 2)
    event_block(spec, got, key, 3, acc_k)
    event_block_reference(spec, ref, philox_uniforms(key, 3, spec.K, spec.n_draws, L, dev),
                          acc_t)
    agree = compare_states(spec, got, ref, rtol=1e-4)
    assert agree["int_frac"] >= 0.999 and agree["float_frac"] == 1.0, agree
    if n_det:
        assert float((acc_k - acc_t).abs().max() / acc_t.abs().max()) <= 1e-9
