"""Column media on the port's fastpath against the JAX package.

Column media hold one homogeneous cloud layer [z_base, z_top) per (x, y)
column (the I3RC Landsat scene, 128 x 128 x 119 cells).  The JAX package
runs them on its XLA fastpath only: each event reads the lane's row of the
(n_cols, 3) column table (fastpath.py:1320-1345).  The port runs the same
event in the ``COL`` variant of the CUDA event block; here its planner, its
plain twin, the slice, the driver and the column-read probe (the TPU kernel
``pallas_column_loop``, benchmarks/column_read_probe.py:83) are held against
the JAX package on the CPU.

Each side builds its domain with its own classes from the same numpy
arrays.  The JAX planner gives column plans K = 32 (an XLA tuning the port
does not carry over; the kernel takes K in {1, 8, 16}), so every port-vs-JAX
comparison passes ``fastpath_unroll`` to both sides.

The JAX ``fast_event`` of a column plan never reaches ``_build_pallas_block``
(fastpath.py:1711), so the twin test takes it from the closure cells of the
tracer that ``make_fast_tracer`` returns.
"""

import importlib
import sys
from dataclasses import replace
from functools import lru_cache
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3rc_tpu.core.illumination import PhotonSource as JaxSource
from i3rc_tpu.integrators import fastpath as jfast
from i3rc_tpu.integrators.integrator import Integrator as JaxIntegrator
from i3rc_tpu.native import scalar_mc as native_mc
from i3rc_tpu.ops.gather import read_rows
from i3rc_tpu_torch import Integrator, PhotonSource, batch_key
from i3rc_tpu_torch.core.rng import philox_uniforms
from i3rc_tpu_torch.drivers.monte_carlo_driver import run_from_namelist
from i3rc_tpu_torch.integrators.fastpath import event_spec, plan_from_jax, state_from_numpy
from i3rc_tpu_torch.kernels import column_probe as cp
from i3rc_tpu_torch.kernels.event_block import (
    compare_states,
    event_block,
    event_block_reference,
)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
L = 4096


def host(pkg: str) -> SimpleNamespace:
    """One side's host layer: the port keeps its copies under the JAX
    package's module paths."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    pf = mod("core.phase_functions")
    return SimpleNamespace(
        Domain=mod("core.optics").Domain, PhaseFunction=pf.PhaseFunction,
        PhaseFunctionTable=pf.PhaseFunctionTable, hg=pf.henyey_greenstein_coefficients,
        IntegratorConfig=mod("integrators.config").IntegratorConfig,
        make_landsat_cloud=mod("models.landsat_cloud").make_landsat_cloud,
        write_landsat=mod("models.landsat_cloud").write_domains)


JAX, PORT = host("i3rc_tpu"), host("i3rc_tpu_torch")


def cfg(h, **kw):
    kw = {"use_ray_tracing": False, "max_events": 500, "compute_volume_absorption": False,
          "fastpath_unroll": 8, **kw}
    return h.IntegratorConfig(**kw)


def small_scene(h, ssa=1.0):
    """The 8 x 8 x 12 column scene of tests/test_fastpath.py:571-598: one
    layer from the base per column, an empty column at (0, 0)."""
    rng = np.random.default_rng(0)
    nx = ny = 8
    nz = 12
    v = rng.uniform(0.0, 0.05, (nx, ny))
    v[0, 0] = 0.0
    ntop = rng.integers(1, nz + 1, (nx, ny))
    ext = np.zeros((nx, ny, nz))
    for i in range(nx):
        for j in range(ny):
            ext[i, j, :ntop[i, j]] = v[i, j]
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.85, 32))], key=[1.0])
    dom = h.Domain.create(np.linspace(0, 240, nx + 1), np.linspace(0, 240, ny + 1),
                          np.linspace(0, 120, nz + 1))
    return dom.add_component("c", ext, np.where(ext > 0, ssa, 0.0),
                             np.zeros(ext.shape, np.int32), table)


def column_props_scene(h):
    """Per-column ssa and phase index (tests/test_fastpath.py:623-652): the
    5-field column plan of the JAX package."""
    rng = np.random.default_rng(7)
    nx, ny, nz = 8, 8, 10
    v = rng.uniform(0.01, 0.06, (nx, ny))
    ntop = rng.integers(1, nz + 1, (nx, ny))
    ssa_col = rng.uniform(0.9, 1.0, (nx, ny))
    pfi_col = rng.integers(0, 3, (nx, ny))
    layer = np.arange(nz)[None, None, :] < ntop[:, :, None]
    ext = np.where(layer, v[:, :, None], 0.0)
    ssa = np.where(layer, ssa_col[:, :, None], 0.0)
    pfi = np.where(layer, pfi_col[:, :, None], 0).astype(np.int32)
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(g, 32)) for g in (0.5, 0.7, 0.85)],
        key=[2.0, 6.0, 10.0])
    dom = h.Domain.create(np.linspace(0, 240, nx + 1), np.linspace(0, 240, ny + 1),
                          np.linspace(0, 120, nz + 1))
    return dom.add_component("mie", ext, ssa, pfi, table)


SCENES = {"small": small_scene, "landsat": lambda h, ssa=1.0: h.make_landsat_cloud(ssa)}


@lru_cache(maxsize=None)
def integrators(scene: str, ssa: float, chain: int = -1, unroll: int = 8):
    """(JAX integrator, port integrator on the CPU) for one configuration."""
    j = JaxIntegrator.create(SCENES[scene](JAX, ssa),
                             config=cfg(JAX, fastpath_chain=chain, fastpath_unroll=unroll))
    t = Integrator.create(SCENES[scene](PORT, ssa),
                          config=cfg(PORT, fastpath_chain=chain, fastpath_unroll=unroll),
                          device="cpu")
    return j, t


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plan_matches_jax(scene):
    """The port's column table equals the JAX planner's bit for bit; the rest
    of the plan is the trivial factors, HG g and the uniform ssa."""
    jinteg, tinteg = integrators(scene, 1.0)
    jplan, tplan = jinteg._fast_plan, tinteg._fast_plan
    assert jplan.column_data is not None and tplan.column_data is not None
    assert tplan.column_data.dtype == np.float32 and tplan.column_data.shape[1] == 3
    assert np.array_equal(tplan.column_data, jplan.column_data)
    assert (tplan.hg_g, tplan.ssa, tplan.unroll) == (jplan.hg_g, jplan.ssa, 8)
    assert plan_from_jax(jplan) == tplan
    spec = event_spec(tinteg.geometry, tplan, tinteg.config)
    assert spec.track_y and spec.col and spec.chain == 2
    assert spec.column.shape == (spec.n_x * spec.n_y, 4)
    assert torch.equal(spec.column[:, 3], torch.zeros(spec.n_x * spec.n_y))
    if scene == "landsat":
        assert tplan.column_data.shape == (128 * 128, 3)


def test_default_unroll_is_the_kernels():
    """Without fastpath_unroll the JAX planner picks K = 32 for column plans
    (fastpath.py:633-635); the port keeps K = 8, which the kernel takes."""
    jplan = JaxIntegrator.create(small_scene(JAX), config=cfg(JAX, fastpath_unroll=None))
    tplan = Integrator.create(small_scene(PORT), config=cfg(PORT, fastpath_unroll=None),
                              device="cpu")._fast_plan
    assert jplan._fast_plan.unroll == 32 and tplan.unroll == 8


def test_column_props_plans_raise_item_15():
    jplan = JaxIntegrator.create(column_props_scene(JAX), config=cfg(JAX))._fast_plan
    assert jplan is not None and jplan.column_props
    with pytest.raises(NotImplementedError, match="item 15"):
        Integrator.create(column_props_scene(PORT), config=cfg(PORT), device="cpu")._fast_plan
    with pytest.raises(NotImplementedError, match="item 15"):
        plan_from_jax(jplan)


def _find(fn, name, seen=None):
    """The function called ``name`` in the closure cells reachable from fn."""
    seen = set() if seen is None else seen
    if id(fn) in seen:
        return None
    seen.add(id(fn))
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            v = cell.cell_contents
        except ValueError:
            continue
        if callable(v) and getattr(v, "__name__", "") == name:
            return v
        if callable(v):
            found = _find(v, name, seen)
            if found is not None:
                return found
    return None


def _random_state(spec, rng, column):
    """Random lanes in the numpy JAX state order; half of them inside their
    column's cloud layer, so that collisions and chains happen."""
    x = rng.uniform(spec.x0, spec.x_max, L).astype(np.float32)
    y = rng.uniform(spec.y0, spec.y_max, L).astype(np.float32)
    ix = np.clip(((x - np.float32(spec.x0)) * np.float32(spec.inv_dx)).astype(np.int64),
                 0, spec.n_x - 1)
    iy = np.clip(((y - np.float32(spec.y0)) * np.float32(spec.inv_dy)).astype(np.int64),
                 0, spec.n_y - 1)
    _, zb, zt = column[ix * spec.n_y + iy].T
    z = np.where((rng.uniform(size=L) < 0.5) & (zt > zb), rng.uniform(zb, zt),
                 rng.uniform(spec.z0, spec.z_max, L))
    d = rng.normal(size=(3, L))
    d /= np.linalg.norm(d, axis=0)
    tau = np.where(rng.uniform(size=L) < 0.5, 0.0, rng.exponential(size=L))
    orders = rng.integers(0, 40, L)
    orders[:16] = spec.max_events - 1
    f32 = lambda a: np.asarray(a, np.float32)
    i32 = lambda a: np.asarray(a, np.int32)
    return (rng.uniform(size=L) < 0.9, x, y, f32(z), f32(d[0]), f32(d[1]), f32(d[2]),
            f32(tau), i32(orders), np.zeros(L, np.int32), np.zeros(L, np.int32),
            i32(rng.integers(0, 100, L)))


def test_jax_read_rows_is_exact():
    """JAX's column read (a factored one-hot matmul at "high" precision,
    i3rc_tpu/ops/gather.py:32) returns table[idx] exactly on the CPU, so the
    twin's plain table[idx] is the same read."""
    table = integrators("landsat", 1.0)[0]._fast_plan.column_data
    idx = np.random.default_rng(3).integers(0, table.shape[0], 1 << 14).astype(np.int32)
    got = np.asarray(read_rows(jnp.asarray(table), jnp.asarray(idx)))
    assert np.array_equal(got, table[idx])


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("ssa,chain", [(1.0, 2), (1.0, 0), (0.99, 2), (0.99, 0)])
def test_twin_matches_jax_fast_event(scene, ssa, chain):
    """One event and one K = 8 block on the same state and uniforms: every
    integer field equal on every lane, floats within 1e-5 relative to the
    field's magnitude on >= 99.5% of lanes (XLA's and torch's log and
    rsqrt differ in the last ulp, tests/test_torch_event_block.py)."""
    jinteg, tinteg = integrators(scene, ssa, chain)
    jplan = jinteg._fast_plan
    tracer = jfast.make_fast_tracer(jinteg.geometry, jplan, jinteg.config, 1 << 14, L)
    fast_event = _find(tracer, "fast_event")
    assert fast_event is not None
    spec = event_spec(tinteg.geometry, plan_from_jax(jplan), tinteg.config)
    assert spec.chain == chain and spec.absorbing == (ssa < 1.0)
    rng = np.random.default_rng(17)
    st0 = _random_state(spec, rng, jplan.column_data)
    U = rng.uniform(size=(spec.K, spec.n_draws, L)).astype(np.float32)
    for K in (1, spec.K):
        jst = tuple(jnp.asarray(a) for a in st0) + (jnp.zeros((1, 1), jnp.float32),)
        for j in range(K):
            jst = fast_event(jnp.asarray(U[j]), jst)
        ref = state_from_numpy([np.asarray(a) for a in jst])
        got = state_from_numpy(st0)
        event_block_reference(replace(spec, K=K), got, torch.from_numpy(U[:K]))
        agree = compare_states(spec, got, ref, rtol=1e-5)
        assert agree["int_frac"] == 1.0, agree
        assert agree["float_frac"] >= 0.995, agree
    pk = got.i[2]
    assert int((pk == 1).sum()) > 0 and int((pk == 2).sum()) > 0
    assert (int((pk == 3).sum()) > 0) == (ssa < 1.0)
    assert int(got.i[1].sum()) > int(torch.from_numpy(st0[8]).sum())   # collisions


def test_slice_matches_jax_column_fastpath():
    """The small scene, 2^15 photons on each side: Fup within 4 combined
    sigma of the JAX XLA column fastpath (K = 1 there, to keep its compile
    short), energy closed to 1e-5, no bad photons."""
    n, lanes = 1 << 15, 1 << 12
    jres = JaxIntegrator.create(small_scene(JAX), config=cfg(JAX, fastpath_unroll=1)).batch_fn(
        JaxSource.directional(0.5, 0.0), n, n_lanes=lanes)(jax.random.PRNGKey(9))
    tres = integrators("small", 1.0)[1].batch_fn(PhotonSource.directional(0.5, 0.0), n,
                                                 n_lanes=lanes)(batch_key(9, 0))
    jf, tf = float(jres.mean_flux_up), float(tres.mean_flux_up)
    sigma = np.sqrt(2 * jf * (1 - jf) / n)
    assert tf == pytest.approx(jf, abs=4 * sigma)
    assert float(tres.mean_flux_up + tres.mean_flux_down) == pytest.approx(1.0, abs=1e-5)
    assert int(tres.n_bad) == 0 and tres.flux_up.shape == (8, 8)


def test_landsat_absorbing_volume_tally():
    """Landsat at ssa 0.99 with heating rates (1.95M cells): the float64
    volume tally holds exactly the absorbed photons of the column tally, and
    the energy closes."""
    integ = Integrator.create(PORT.make_landsat_cloud(0.99),
                              config=cfg(PORT, compute_volume_absorption=True), device="cpu")
    src = PhotonSource.directional(0.5, 0.0)
    key = batch_key(4, 0)
    n = 1 << 11
    raw = integ.batch_tracer(n, n)(key, src.sample(key, n, "cpu"), src)
    assert raw.volume_absorption.shape == (128 * 128 * 119,)
    assert float(raw.flux_absorbed.sum()) > 0
    assert float(raw.volume_absorption.sum()) == float(raw.flux_absorbed.sum())
    total = raw.flux_up.sum() + raw.flux_down.sum() + raw.flux_absorbed.sum()
    assert float(total) == n and int(raw.n_bad) == 0


@pytest.mark.skipif(not native_mc.available(),
                    reason="native oracle not built (scripts/build_native.sh)")
def test_landsat_twin_matches_cpp_oracle():
    """The port on the full Landsat scene against the independent C++ scalar
    Monte Carlo (tests/test_external_validation.py:336): 2^13 port photons,
    2^15 oracle photons, Fup within 3 combined sigma."""
    n = 1 << 13
    res = integrators("landsat", 1.0)[1].batch_fn(PhotonSource.directional(0.5, 0.0), n)(
        batch_key(31, 0))
    dom = JAX.make_landsat_cloud(1.0)
    ext = np.asarray(dom.components[0].extinction, np.float64)
    ro = native_mc.trace(ext, np.ones_like(ext), 0.85, np.asarray(dom.x_edges),
                         np.asarray(dom.y_edges), np.asarray(dom.z_edges), 0.5, 0.0, 4 * n,
                         seed=33)
    fup_o = ro["flux_up"].sum() / (4 * n)
    sigma = np.sqrt(fup_o * (1 - fup_o) * (1.0 / n + 1.0 / (4 * n)))
    assert float(res.mean_flux_up) == pytest.approx(fup_o, abs=3 * sigma)
    assert int(res.n_bad) < 1e-3 * n


def test_landsat_driver(tmp_path, monkeypatch):
    """The port's driver runs the Landsat domain file that the port's
    models/landsat_cloud.write_domains writes (2 x 512 photons)."""
    PORT.write_landsat(str(tmp_path))
    (tmp_path / "run.nml").write_text(f"""
&radiativeTransfer
  solarFlux = 1., solarMu = 0.5, solarAzimuth = 0., surfaceAlbedo = 0.
/
&monteCarlo
  numPhotonsPerBatch = 512, numBatches = 2, iseed = 3
/
&algorithms
  useRayTracing = .false.
/
&fileNames
  domainFileName = "LandsatCloud_NonAbsorbing.opt",
  outputFluxFile = "landsatFluxes.out",
  outputNetcdfFile = "landsatOutput.nc"
/
""")
    monkeypatch.chdir(tmp_path)
    out = run_from_namelist("run.nml", quiet=True, device="cpu")
    (fup, _), (fdn, _), _ = out["mean_stats"]
    assert fup + fdn == pytest.approx(1.0, abs=1e-5) and 0.3 < fup < 0.7
    assert (tmp_path / "landsatFluxes.out").is_file() and (tmp_path / "landsatOutput.nc").is_file()


def _probe_module():
    """benchmarks/column_read_probe.py, imported by path (it imports JAX)."""
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        return importlib.import_module("column_read_probe")
    finally:
        sys.path.remove(str(ROOT / "benchmarks"))


def test_probe_twin_matches_jax_probe_read():
    """The probe twin's table read equals the probe's own XLA read
    (``xla_factored``, the factored one-hot, split at 128 rows) on the
    CPU, and its toy loop equals the loop restated in JAX on the same
    Philox uniforms (the TPU's PRNG cannot run here): x, y and acc bit for
    bit."""
    probe = _probe_module()
    rng = np.random.default_rng(5)
    table = rng.uniform(size=(probe.N_COLS, probe.M)).astype(np.float32)
    n = 4096
    x = rng.uniform(size=n).astype(np.float32)
    y = rng.uniform(size=n).astype(np.float32)
    idx = (np.clip((x * 128.0).astype(np.int32), 0, 127) * 128
           + np.clip((y * 128.0).astype(np.int32), 0, 127))
    want = np.asarray(probe.xla_factored(jnp.asarray(table), jnp.asarray(idx), 128))
    got = cp.table_read(torch.from_numpy(table), torch.from_numpy(x), torch.from_numpy(y))
    assert np.array_equal(got.numpy(), want)

    key = batch_key(8, 1)
    u = cp.probe_uniforms(key, 3, n, "cpu")
    jx, jy, jacc = jnp.asarray(x), jnp.asarray(y), jnp.zeros(n, jnp.float32)
    for j in range(cp.K):
        ix = jnp.clip((jx * 128.0).astype(jnp.int32), 0, 127)
        iy = jnp.clip((jy * 128.0).astype(jnp.int32), 0, 127)
        r = probe.xla_factored(jnp.asarray(table), ix * 128 + iy, 128)
        v, zb, zt, ss = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
        uj = jnp.asarray(u[j].numpy())
        jx = jx + (v - zb * 0.001 + zt * 0.001 + ss * 0.0) * 0.01 + uj * 0.001
        jx = jx - jnp.floor(jx)
        jy = jy + uj * 0.002 + v * 0.005
        jy = jy - jnp.floor(jy)
        jacc = jacc + v
    tx, ty = torch.from_numpy(x.copy()), torch.from_numpy(y.copy())
    acc = cp.column_probe(torch.from_numpy(table), tx, ty, key, 3)
    for a, b in ((tx, jx), (ty, jy), (acc, jacc)):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.cuda
@pytest.mark.parametrize("ssa,chain", [(1.0, 2), (0.99, 0)])
def test_column_kernel_matches_twin_on_gpu(ssa, chain):
    """The CUDA column variant against its twin on the same Philox draws:
    every state row bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    integ = Integrator.create(PORT.make_landsat_cloud(ssa),
                              config=cfg(PORT, fastpath_chain=chain), device=dev)
    spec = event_spec(integ.geometry, integ._fast_plan, integ.config)
    st = state_from_numpy(_random_state(spec, np.random.default_rng(5),
                                        integ._fast_plan.column_data), device=dev)
    got, ref = st.clone(), st.clone()
    key = batch_key(1, 2)
    event_block(spec, got, key, 3)
    event_block_reference(spec, ref, philox_uniforms(key, 3, spec.K, spec.n_draws, L, dev))
    assert torch.equal(got.f, ref.f) and torch.equal(got.i, ref.i)


@pytest.mark.cuda
def test_probe_kernel_matches_twin_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    g = torch.Generator().manual_seed(2)
    table = torch.rand((128 * 128, 4), generator=g).cuda()
    x, y = torch.rand(1 << 16, generator=g).cuda(), torch.rand(1 << 16, generator=g).cuda()
    key = batch_key(3, 4)
    rx, ry, racc = cp.column_probe_reference(table, x, y, cp.probe_uniforms(key, 5, x.numel(),
                                                                             x.device))
    acc = cp.column_probe(table, x, y, key, 5)
    assert torch.equal(x, rx) and torch.equal(y, ry) and torch.equal(acc, racc)
