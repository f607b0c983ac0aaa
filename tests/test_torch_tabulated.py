"""The table modes of the port's fastpath against the JAX package: the plan,
the samplers, one event of the plain twin, and the radar-cloud model.

A phase function that is not exactly Henyey-Greenstein (a tabulated table,
a Legendre table such as the Dermendjian C.1's, isotropic scattering, or
several entries keyed per column) samples the scattering cosine from the
256-segment piecewise-cubic fit of its inverse CDF (``FastPlan.cubic``,
i3rc_tpu/integrators/fastpath.py:1573-1586), its detectors read the phase
value from the 512-segment log-space cubic (``fwd_cubic``, :1508-1520), and
a column plan with per-column properties reads each lane's ssa and table
entry from its column (``column_props``, :1330-1336).

Tolerances: plans and the cubic fits equal bit for bit; the twin's cosine
equal to the general kernel's plain sampler bit for bit; its log-cubic
phase value within 1 ulp of a float32 numpy evaluation of the JAX
coefficients; one event and one block of the twin against the JAX
``fast_event`` as tests/test_torch_column.py holds them (integer fields
equal on >= 99.5% of lanes, floats within 1e-5 relative on >= 99.5%; XLA
and torch round log and rsqrt differently in the last ulp).
"""

import importlib
import importlib.util
from dataclasses import replace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3rc_tpu.integrators import fastpath as jfast
from i3rc_tpu.integrators.config import IntegratorConfig as JaxConfig
from i3rc_tpu.integrators.integrator import Integrator as JaxIntegrator
from i3rc_tpu_torch import Integrator, IntegratorConfig
from i3rc_tpu_torch.integrators.fastpath import event_spec, plan_from_jax, state_from_numpy
from i3rc_tpu_torch.integrators.wavefront import sample_cos_scat
from i3rc_tpu_torch.kernels.event_block import (
    compare_states,
    cubic_cosine,
    event_block_reference,
    forward_phase,
    launch_refusal,
)
from tests.test_torch_column import _find

_spec = importlib.util.spec_from_file_location("tabulated_scenes",
                                               Path(__file__).with_name("tabulated_scenes.py"))
scenes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(scenes)

torch.set_num_threads(2)
L = 4096
JAX, PORT = scenes.host("i3rc_tpu"), scenes.host("i3rc_tpu_torch")
CFG_KW = dict(use_ray_tracing=False, max_events=2000, compute_volume_absorption=False)
DET2 = dict(intensity_mus=[0.5, -0.5], intensity_phis=[0.0, 0.0])
# The JAX package's gate scenes of its table modes (tests/test_fastpath.py),
# name -> (scene, Integrator.create keywords).
GATES = {
    "c1_slab": (scenes.c1_slab, {}),                                    # :199
    "c1_slab_detectors": (scenes.c1_slab, DET2),                        # :1065
    "c1_gas": (scenes.c1_gas_slab, {}),                                 # :530
    "c1_gas_detectors": (scenes.c1_gas_slab,
                         dict(intensity_mus=[1.0, 0.5], intensity_phis=[0.0, 0.0])),
    "column_props": (scenes.column_props_scene, {}),                    # :618
    "props_eligibility": (scenes.props_eligibility_scene, {}),          # :957
    "isotropic": (scenes.isotropic_slab, {}),
}


def sides(name: str, **cfg_kw):
    """(JAX integrator, port integrator on the CPU) of a gate scene."""
    scene, kw = GATES[name]
    jinteg = JaxIntegrator.create(scene(JAX), config=JaxConfig(**CFG_KW, **cfg_kw), **kw)
    tinteg = Integrator.create(scene(PORT), config=IntegratorConfig(**CFG_KW, **cfg_kw),
                               device="cpu", **kw)
    return jinteg, tinteg


def bits(a):
    return None if a is None else np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", sorted(GATES))
def test_plan_matches_jax(name):
    """fast_plan on both sides: the cubic fits bit for bit, the entries, the
    column table, ssa, K and the chain depth the same; plan_from_jax of the
    JAX plan is the port's plan; the spec is one the kernel launches."""
    jinteg, tinteg = sides(name)
    jp, tp = jinteg._fast_plan, tinteg._fast_plan
    assert jp is not None and tp is not None and jp.cubic is not None
    assert np.array_equal(bits(tp.cubic), bits(jp.cubic))
    assert (tp.fwd_cubic is None) == (jp.fwd_cubic is None) == (not jp.detectors)
    if jp.fwd_cubic is not None:
        assert np.array_equal(bits(tp.fwd_cubic), bits(jp.fwd_cubic))
        assert tp.fwd_cubic.shape == (512, 4)
    assert tp.cubic_entries == jp.cubic_entries and tp.column_props == jp.column_props
    assert tp.cubic.shape == (256 * jp.cubic_entries, 4)
    assert (tp.column_data is None) == (jp.column_data is None)
    if jp.column_data is not None:
        assert np.array_equal(bits(tp.column_data), bits(jp.column_data))
    assert tp.ssa == jp.ssa and tp.unroll == jp.unroll and tp.hg_g == jp.hg_g == 0.0
    assert plan_from_jax(jp) == tp
    spec = event_spec(tinteg.geometry, tp, tinteg.config)
    gas = jp.gas_factor is not None
    assert spec.chain == (0 if jp.detectors else (3 if gas else 2))
    assert spec.table and launch_refusal(spec) is None
    if name == "props_eligibility":
        assert jp.column_props and tp.ssa == pytest.approx(0.97)
        assert spec.pf_row[1 * 4 + 1] == 256 and int(spec.pf_row.sum()) == 256
        assert torch.equal(spec.column[:, 3][spec.column[:, 0] > 0],
                           torch.full((16,), float(np.float32(0.97))))


def test_hg_plans_keep_the_closed_form():
    """An exact-HG table keeps the HG inversion on both sides."""
    cfg = dict(use_ray_tracing=False, max_events=500, compute_volume_absorption=False)
    jp = JaxIntegrator.create(importlib.import_module("i3rc_tpu.models.step_cloud")
                              .make_step_cloud(1.0), config=JaxConfig(**cfg))._fast_plan
    tinteg = Integrator.create(importlib.import_module("i3rc_tpu_torch.models.step_cloud")
                               .make_step_cloud(1.0), config=IntegratorConfig(**cfg),
                               device="cpu")
    assert jp.cubic is None and tinteg._fast_plan.cubic is None
    spec = event_spec(tinteg.geometry, tinteg._fast_plan, tinteg.config)
    assert not spec.table and spec.pf_row is None and spec.fwd is None


def _u_grid(n: int = 1 << 14):
    rng = np.random.default_rng(5)
    u = rng.uniform(size=n).astype(np.float32)
    u[:6] = [0.0, np.float32(2.0 ** -24), 0.5, np.float32(1 - 2.0 ** -24), 1.0,
             np.float32(255.5 / 256)]
    return torch.from_numpy(u)


def test_cubic_sampler_equals_the_general_kernels():
    """The twin's cosine on every entry of a three-entry table (the
    column-properties scene) equals the general kernel's plain sampler
    (wavefront.sample_cos_scat, itself held against JAX) bit for bit."""
    tinteg = Integrator.create(scenes.column_props_scene(PORT),
                               config=IntegratorConfig(**CFG_KW), device="cpu")
    spec = event_spec(tinteg.geometry, tinteg._fast_plan, tinteg.config)
    tables = tinteg.tables
    assert tables.max_entries == 3 and spec.n_seg == tables.n_segments == 256
    assert torch.equal(spec.cubic, tables.inverse_cubic)
    u = _u_grid()
    for e in range(3):
        rows = torch.full(u.shape, e * spec.n_seg, dtype=torch.int32)
        got = cubic_cosine(spec, u, rows)
        want = sample_cos_scat(tables, torch.zeros_like(rows), torch.full_like(rows, e), u)
        assert torch.equal(got, want)
        assert float(got.min()) >= -1.0 and float(got.max()) <= 1.0
    # The single-entry fit of an isotropic table is mu = 2p - 1.
    iso = Integrator.create(scenes.isotropic_slab(PORT), config=IntegratorConfig(**CFG_KW),
                            device="cpu")
    ispec = event_spec(iso.geometry, iso._fast_plan, iso.config)
    assert torch.allclose(cubic_cosine(ispec, u), 2.0 * u - 1.0, atol=1e-6)


def test_forward_value_matches_numpy_of_jax_coefficients():
    """The log-cubic phase value at the photon-to-detector cosine, step by
    step against numpy with correctly rounded transcendentals: the angle
    (torch.acos) within 1 ulp of float32(arccos) in float64, and the value
    at that angle within 1 ulp of the JAX plan's coefficients evaluated in
    float32 (the twin's order of operations) and exponentiated in float64.
    (numpy's own float32 arccos and exp differ from torch's by up to 2
    ulp: neither is correctly rounded.)"""
    jinteg, tinteg = sides("c1_slab_detectors")
    spec = event_spec(tinteg.geometry, tinteg._fast_plan, tinteg.config)
    c = np.asarray(jinteg._fast_plan.fwd_cubic, np.float32)
    n = c.shape[0]
    proj = np.random.default_rng(9).uniform(-1, 1, 1 << 14).astype(np.float32)
    proj[:4] = [-1.0, 1.0, 0.0, np.float32(np.cos(np.float32(1e-3)))]
    tproj = torch.from_numpy(proj)
    ang = torch.acos(tproj).numpy()
    exact = np.arccos(proj.astype(np.float64)).astype(np.float32)
    assert np.all(np.abs(ang - exact) <= np.spacing(np.abs(exact)))
    f = np.float32
    pos = ang * f(n / np.pi)
    seg = np.clip(pos.astype(np.int32), 0, n - 1)
    t = pos - seg.astype(f)
    r = c[seg]
    poly = ((r[:, 3] * t + r[:, 2]) * t + r[:, 1]) * t + r[:, 0]
    want = np.exp(poly.astype(np.float64)).astype(f)
    got = forward_phase(spec, tproj).numpy()
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))
    assert np.all(np.isfinite(got)) and float(got.max()) > 100.0   # the forward peak


def _random_state(spec, rng, column=None):
    """Random lanes in the numpy JAX state order (with a column table, half
    of them inside their column's layer), and a gas threshold."""
    x = rng.uniform(spec.x0, spec.x_max, L).astype(np.float32)
    y = rng.uniform(spec.y0, spec.y_max, L).astype(np.float32)
    z = rng.uniform(spec.z0, spec.z_max, L)
    if column is not None:
        ix = np.clip(((x - np.float32(spec.x0)) * np.float32(spec.inv_dx)).astype(np.int64),
                     0, spec.n_x - 1)
        iy = np.clip(((y - np.float32(spec.y0)) * np.float32(spec.inv_dy)).astype(np.int64),
                     0, spec.n_y - 1)
        zb, zt = column[ix * spec.n_y + iy, 1:3].T
        z = np.where((rng.uniform(size=L) < 0.5) & (zt > zb), rng.uniform(zb, zt), z)
    d = rng.normal(size=(3, L))
    d /= np.linalg.norm(d, axis=0)
    tau = np.where(rng.uniform(size=L) < 0.5, 0.0, rng.exponential(size=L))
    orders = rng.integers(0, 40, L)
    orders[:16] = spec.max_events - 1
    f32 = lambda a: np.asarray(a, np.float32)
    i32 = lambda a: np.asarray(a, np.int32)
    return (rng.uniform(size=L) < 0.9, x, y, f32(z), f32(d[0]), f32(d[1]), f32(d[2]),
            f32(tau), i32(orders), np.zeros(L, np.int32), np.zeros(L, np.int32),
            i32(rng.integers(0, 100, L)), np.zeros((1, 1), np.float32),
            f32(rng.exponential(size=L)))


# name -> (gate scene, ssa override or None, chain depth)
EVENTS = {"c1_slab": ("c1_slab", 0.99, 2), "c1_gas": ("c1_gas", None, 3),
          "column_props": ("column_props", None, 2), "column_props_c0": ("column_props", None, 0),
          "c1_slab_detectors": ("c1_slab_detectors", None, 0)}


@pytest.mark.parametrize("case", sorted(EVENTS))
def test_twin_matches_jax_fast_event(case):
    """One event and one K-event block of the twin on the same state and
    draws as the JAX XLA fast_event of the same plan (the table modes never
    reach the Pallas kernel, fastpath.py:1709-1712); with detectors the
    (contribution, column) records too, on lanes whose integer state agrees."""
    name, ssa, chain = EVENTS[case]
    scene, kw = GATES[name]
    mk = (lambda h: scene(h, ssa=ssa)) if ssa is not None else scene
    jcfg = JaxConfig(**CFG_KW, fastpath_chain=chain, fastpath_unroll=4)
    jinteg = JaxIntegrator.create(mk(JAX), config=jcfg, **kw)
    jplan = jinteg._fast_plan
    tracer = jfast.make_fast_tracer(jinteg.geometry, jplan, jcfg, 1 << 14, L)
    fast_event = _find(tracer, "fast_event")
    assert fast_event is not None and jplan.cubic is not None
    cfg = IntegratorConfig(**CFG_KW, fastpath_chain=chain, fastpath_unroll=4)
    tinteg = Integrator.create(mk(PORT), config=cfg, device="cpu", **kw)
    spec = event_spec(tinteg.geometry, plan_from_jax(jplan), cfg)
    assert spec.chain == chain and spec.table
    rng = np.random.default_rng(29)
    st0 = _random_state(spec, rng, jplan.column_data)
    if not spec.gas:
        st0 = st0[:13]
    U = rng.uniform(size=(spec.K, spec.n_draws, L)).astype(np.float32)
    D = spec.det.n if spec.det is not None else 0
    for K in (1, spec.K):
        jst = tuple(jnp.asarray(a) for a in st0)
        jrecs = []
        for j in range(K):
            jst = fast_event(jnp.asarray(U[j]), jst, det_sink=(
                (lambda d, c, col: jrecs.append((np.asarray(c), np.asarray(col))))
                if D else None))
        jout = [np.asarray(a) for a in jst]
        ref = state_from_numpy(jout[:12] + [None] + jout[13:14])
        got = state_from_numpy(list(st0[:12]) + [None] + list(st0[13:14]))
        recs = []
        acc = torch.zeros((spec.det.n_cols, D), dtype=torch.float64) if D else None
        event_block_reference(replace(spec, K=K), got, torch.from_numpy(U[:K]), acc,
                              recs if D else None)
        agree = compare_states(spec, got, ref, rtol=1e-5)
        assert agree["int_frac"] >= 0.995 and agree["float_frac"] >= 0.995, agree
        if D:
            int_eq = (got.i == ref.i).all(dim=0).numpy()
            n_ok = n_all = 0
            for (c, col), (w, jcol) in zip(recs, jrecs):
                c, col = c.numpy(), col.numpy()
                live = int_eq & ((c != 0) | (w != 0))
                ok = (col == jcol) & (np.abs(c - w) <= 1e-5 * np.abs(w))
                n_ok += int((ok & live).sum())
                n_all += int(live.sum())
            assert len(recs) == len(jrecs) == D * K
            assert n_all > 100 and n_ok >= 0.995 * n_all, (n_ok, n_all)
    orders0 = int(torch.from_numpy(st0[8]).sum())
    assert int(got.i[1].sum()) > orders0                       # collisions happened
    assert (int((got.i[2] == 3).sum()) > 0) == (spec.absorbing or spec.gas)


def test_radar_model_matches_jax():
    """The port's radar-cloud scene and C.1 loaders give the JAX package's
    arrays bit for bit."""
    jr = importlib.import_module("i3rc_tpu.models.radar_cloud")
    tr = importlib.import_module("i3rc_tpu_torch.models.radar_cloud")
    for pf in ("hg", "c1", "c1_legendre"):
        jd, td = jr.make_radar_cloud(pf), tr.make_radar_cloud(pf)
        for e in ("x_edges", "y_edges", "z_edges"):
            assert np.array_equal(getattr(jd, e), getattr(td, e))
        jc, tc = jd.components[0], td.components[0]
        assert jc.name == tc.name and jc.extinction.shape == (640, 1, 54)
        for f in ("extinction", "single_scattering_albedo", "phase_function_index"):
            assert np.array_equal(getattr(jc, f), getattr(tc, f)), f
        for jpf, tpf in zip(jc.table.phase_functions, tc.table.phase_functions):
            for f in ("legendre_coefficients", "scattering_angle", "value"):
                a, b = getattr(jpf, f), getattr(tpf, f)
                assert (a is None) == (b is None) and (a is None or np.array_equal(a, b)), f
    ja, ta = jr.load_c1_tabulated(), tr.load_c1_tabulated()
    assert np.array_equal(ja.scattering_angle, ta.scattering_angle)
    assert np.array_equal(ja.value, ta.value)
