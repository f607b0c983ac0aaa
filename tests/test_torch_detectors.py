"""Radiance detectors on the port's fastpath against the JAX package.

The detector variant of the event block (``_build_pallas_block`` with
``n_detectors > 0``, i3rc_tpu/integrators/fastpath.py:665) computes, at
every collision, P(photon -> detector) / (4 pi |mu_d|) x exp(-tau to the
boundary) with the closed-form shadow trace, optionally under Iwabuchi
roulette.  Here the port's planner, its plain twin, its normalization, the
whole radiance slice and the namelist driver are each held against the JAX
package on the CPU.

One deliberate difference: the JAX fastpath's Iwabuchi rule omits the
transmittance exp(-tau) when the phase value is below zeta
(fastpath.py:1544), which overestimates radiance (about 2.9x on the step
cloud).  The port contributes zeta / pi there with probability
(pf_pi / zeta) exp(-tau), the law of the general kernel's trace
(wavefront.py:1053-1061).  The event test rebuilds that rule from the JAX
records of a run without roulette and compares the port with it.
"""

import shutil
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3rc_tpu.core.illumination import PhotonSource as JaxSource
from i3rc_tpu.core.optics import Domain
from i3rc_tpu.core.phase_functions import (
    PhaseFunction,
    PhaseFunctionTable,
    henyey_greenstein_coefficients,
)
from i3rc_tpu.drivers.monte_carlo_driver import run_from_namelist as jax_run_from_namelist
from i3rc_tpu.integrators import fastpath as jfast
from i3rc_tpu.integrators.config import IntegratorConfig
from i3rc_tpu.integrators.integrator import Integrator as JaxIntegrator
from i3rc_tpu.integrators.results import normalize_tallies as jax_normalize
from i3rc_tpu.integrators.wavefront import RawTallies as JaxRawTallies
from i3rc_tpu.models.step_cloud import make_step_cloud, write_domains
from i3rc_tpu_torch import Integrator, PhotonSource, batch_key
from i3rc_tpu_torch.core.rng import philox_uniforms
from i3rc_tpu_torch.drivers.monte_carlo_driver import main as torch_driver_main
from i3rc_tpu_torch.integrators.fastpath import event_spec, plan_from_jax, state_from_numpy
from i3rc_tpu_torch.integrators.results import normalize_tallies
from i3rc_tpu_torch.integrators.wavefront import RawTallies
from i3rc_tpu_torch.kernels.event_block import (
    PI,
    compare_states,
    event_block,
    event_block_reference,
)

torch.set_num_threads(2)
CFG = IntegratorConfig(use_ray_tracing=False, max_events=500,
                       compute_volume_absorption=False)
# The I3RC detector set of examples/monteCarloDriver_stepCloud.nml and its
# anchors (BENCH_CASES.md case 2; tolerance of tests/test_fastpath.py:870).
DET = dict(intensity_mus=[1.0, 0.5, 0.5], intensity_phis=[0.0, 0.0, 180.0])
ANCHORS = [0.1285, 0.3285, 0.1800]
L = 4096
ROOT = Path(__file__).resolve().parents[1]


def y_axis_scene(ssa=1.0):
    """Separable scene whose only varying horizontal factor is fy (n_y > 1),
    so the closed shadow trace integrates along y."""
    vx = np.ones(4)
    vy = np.array([1.0, 3.0, 1.0])
    vz = np.array([0.0, 0.02, 0.03, 0.0])
    ext = vx[:, None, None] * vy[None, :, None] * vz[None, None, :]
    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(0.85, 48))], key=[1.0])
    dom = Domain.create(np.linspace(0, 300.0, 5), np.linspace(0, 200.0, 4),
                        np.linspace(0, 100.0, 5))
    return dom.add_component("c", ext, np.full_like(ext, ssa),
                             np.zeros(ext.shape, np.int32), table)


SCENES = {"step_cloud": make_step_cloud, "y_axis": y_axis_scene}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plan_matches_jax(scene):
    dom = SCENES[scene]()
    jplan = JaxIntegrator.create(dom, config=CFG, **DET)._fast_plan
    tinteg = Integrator.create(dom, config=CFG, device="cpu", **DET)
    tplan = tinteg._fast_plan
    assert jplan.closed_shadow and tplan.closed_shadow
    assert tplan.detectors == tuple(tuple(float(v) for v in d) for d in jplan.detectors)
    assert plan_from_jax(jplan) == tplan
    spec = event_spec(tinteg.geometry, tplan, CFG)
    assert spec.chain == 0 and spec.det.n == 3
    if scene == "y_axis":
        assert spec.det.h_axis == 1 and spec.det.col_y and spec.det.n_cols == 12
    else:
        assert spec.det.h_axis == 0 and spec.det.h_mode == (1, 2, 2)


def _jax_fast_event(dom, cfg, monkeypatch):
    """The JAX fast_event of the Pallas detector path, and its draw count."""
    jinteg = JaxIntegrator.create(dom, config=cfg, **DET)
    captured = {}

    def record(fast_event, track_y, L_, K, **kw):
        captured.update(fe=fast_event, n_draws=kw["n_draws"], n_det=kw["n_detectors"])
        return lambda seed2, st: st

    monkeypatch.setattr(jfast, "_build_pallas_block", record)
    jfast.make_fast_tracer(jinteg.geometry, jinteg._fast_plan,
                           replace(cfg, use_pallas_fastpath=True), 1 << 14, L)
    assert captured["n_det"] == 3
    return captured["fe"], captured["n_draws"]


def _random_state(spec, rng):
    """Random in-domain lanes: a numpy tuple in the JAX state order."""
    x = rng.uniform(spec.x0, spec.x_max, L)
    y = rng.uniform(spec.y0, spec.y_max, L)
    z = rng.uniform(spec.z0, spec.z_max, L)
    d = rng.normal(size=(3, L))
    d /= np.linalg.norm(d, axis=0)
    tau = np.where(rng.uniform(size=L) < 0.5, 0.0, rng.exponential(size=L))
    f32 = lambda a: np.asarray(a, np.float32)
    return (rng.uniform(size=L) < 0.9, f32(x), f32(y), f32(z), f32(d[0]), f32(d[1]),
            f32(d[2]), f32(tau), rng.integers(0, 40, L).astype(np.int32),
            np.zeros(L, np.int32), np.zeros(L, np.int32), rng.integers(0, 100, L).astype(np.int32))


def _run_jax(fe, st0, U, K):
    """K JAX events; per event the directions before it and the
    (contribution, column) records of its three detectors."""
    jst = tuple(jnp.asarray(a) for a in st0) + (jnp.zeros((1, 1), jnp.float32),)
    dirs, recs = [], []
    for j in range(K):
        dirs.append(np.stack([np.asarray(a) for a in jst[4:7]]))
        jst = fe(jnp.asarray(U[j]), jst,
                 det_sink=lambda d, c, col: recs.append((np.asarray(c), np.asarray(col))))
    return state_from_numpy([np.asarray(a) for a in jst]), dirs, recs


def _iwabuchi_reference(spec, dirs, exact, jax_iw, U):
    """The port's Iwabuchi rule from JAX records: the JAX contribution where
    pi * norm_pf > zeta, else zeta / pi with probability pi * exact / zeta
    (exact = norm_pf exp(-tau), from the run without roulette)."""
    det, g = spec.det, np.float32(spec.g)
    out = []
    for i, ((c_ex, _), (c_iw, _)) in enumerate(zip(exact, jax_iw)):
        j, d = divmod(i, det.n)
        proj = np.clip(dirs[j][0] * np.float32(det.dirs[d][0])
                       + dirs[j][1] * np.float32(det.dirs[d][1])
                       + dirs[j][2] * np.float32(det.dirs[d][2]), -1, 1)
        r = 1 / np.sqrt(np.maximum(1 + g * g - 2 * g * proj, np.float32(1e-12)))
        pf_pi = np.float32(PI) * (1 - g * g) * r ** 3 * np.float32(det.norm[d])
        u_iw = U[j, spec.bonus_draws + d]
        small = np.where(u_iw * np.float32(det.zeta) <= np.float32(PI) * c_ex,
                         np.float32(det.zeta_pi), np.float32(0.0))
        out.append(np.where(pf_pi <= det.zeta, small, c_iw))
    return out


@pytest.mark.parametrize("scene,ssa,iw", [
    ("step_cloud", 1.0, False), ("step_cloud", 1.0, True),
    ("step_cloud", 0.99, False), ("step_cloud", 0.99, True),
    ("y_axis", 1.0, False), ("y_axis", 0.99, True)])
def test_twin_matches_jax_detector_event(scene, ssa, iw, monkeypatch):
    """One event and one K = 8 block on the same state and uniforms.

    State: integer fields equal on >= 99.5% of lanes, floats within 1e-5 on
    >= 99.5% of those (the rounding of log and rsqrt differs by an ulp; see
    tests/test_torch_event_block.py).  Records: on lanes whose integer
    state agrees and where either side contributes, the exit column is
    equal and the contribution within 1e-5 relative on >= 99.5% of them.
    """
    dom = SCENES[scene](ssa)
    cfg = replace(CFG, use_russian_roulette_for_intensity=iw, zeta_min=0.3)
    fe, n_draws = _jax_fast_event(dom, cfg, monkeypatch)
    fe_exact = _jax_fast_event(dom, replace(cfg, use_russian_roulette_for_intensity=False),
                               monkeypatch)[0] if iw else None
    tinteg = Integrator.create(dom, config=cfg, device="cpu", **DET)
    spec = event_spec(tinteg.geometry, plan_from_jax(
        JaxIntegrator.create(dom, config=cfg, **DET)._fast_plan), cfg)
    assert spec.n_draws == n_draws == spec.bonus_draws + (3 if iw else 0)
    rng = np.random.default_rng(23)
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
        acc = torch.zeros((spec.det.n_cols, 3), dtype=torch.float64)
        recs = []
        event_block_reference(replace(spec, K=K), got, torch.from_numpy(U[:K]), acc, recs)
        agree = compare_states(spec, got, ref, rtol=1e-5)
        assert agree["int_frac"] >= 0.995 and agree["float_frac"] >= 0.995, agree
        int_eq = (got.i == ref.i).all(dim=0).numpy()
        assert len(recs) == len(jrecs) == 3 * K
        n_ok = n_all = 0
        for (c, col), w, (_, jcol) in zip(recs, want, jrecs):
            c, col = c.numpy(), col.numpy()
            live = int_eq & ((c != 0) | (w != 0))
            ok = (col == jcol) & (np.abs(c - w) <= 1e-5 * np.abs(w))
            n_ok += int((ok & live).sum())
            n_all += int(live.sum())
        assert n_all > 100 and n_ok >= 0.995 * n_all, (n_ok, n_all)
        # The accumulator is the tally of the records.
        flat = torch.zeros(spec.det.n_cols * 3, dtype=torch.float64)
        for i, (c, col) in enumerate(recs):
            flat.index_add_(0, col * 3 + i % 3, c.to(torch.float64))
        assert torch.allclose(acc.reshape(-1), flat, rtol=1e-12, atol=0.0)


def test_slice_matches_jax():
    """Step cloud, 3 detectors, 2^14 photons at 2^12 lanes: port vs the JAX
    XLA fastpath and the anchors, rtol 0.12 (radiance noise at 2^14 photons
    is 2-3%, tests/test_fastpath.py:868-870)."""
    n, lanes = 1 << 14, 1 << 12
    jres = JaxIntegrator.create(make_step_cloud(1.0), config=replace(CFG, fastpath_unroll=1),
                                **DET).batch_fn(JaxSource.directional(0.5, 0.0), n,
                                                n_lanes=lanes)(jax.random.PRNGKey(35))
    tres = Integrator.create(make_step_cloud(1.0), config=CFG, device="cpu", **DET).batch_fn(
        PhotonSource.directional(0.5, 0.0), n, n_lanes=lanes)(batch_key(35, 0))
    got = tres.mean_intensity.numpy()
    np.testing.assert_allclose(got, np.asarray(jres.mean_intensity), rtol=0.12)
    np.testing.assert_allclose(got, ANCHORS, rtol=0.12)
    assert float(tres.mean_flux_up + tres.mean_flux_down) == pytest.approx(1.0, abs=1e-5)
    assert int(tres.n_bad) == 0
    assert tres.intensity.shape == (32, 1, 3)
    assert tres.intensity_by_component.shape == (32, 1, 3, 2)
    # Black surface: component slot 0 stays zero; slot 1 is the intensity.
    assert float(tres.intensity_by_component[..., 0].abs().max()) == 0.0
    assert torch.equal(tres.intensity_by_component[..., 1], tres.intensity)


def test_normalize_matches_jax():
    """normalize_tallies with D = 3 and a nonzero clipped excess, port vs
    JAX on the same raw numpy tallies, to 1e-6."""
    rng = np.random.default_rng(4)
    nx, ny, nz, D, n_comp = 4, 3, 2, 3, 1
    xe = np.array([0.0, 1.0, 2.5, 3.0, 4.0])
    ye = np.array([0.0, 2.0, 3.0, 5.0])
    from i3rc_tpu_torch.integrators.results import column_weights
    cw, dz = column_weights(xe, ye), np.array([0.5, 1.5], np.float32)
    by_comp = rng.uniform(0, 50, (nx * ny * D, n_comp + 1))
    by_comp[:, 0] = 0.0
    raw = dict(flux_up=rng.uniform(0, 100, nx * ny), flux_down=rng.uniform(0, 100, nx * ny),
               flux_absorbed=rng.uniform(0, 10, nx * ny),
               volume_absorption=rng.uniform(0, 5, nx * ny * nz),
               intensity=by_comp.sum(axis=1), intensity_by_component=by_comp.reshape(-1),
               intensity_excess=np.abs(rng.normal(0, 3, D * (n_comp + 1))))
    n_photons = 4000
    jres = jax_normalize(JaxRawTallies(
        **{k: jnp.asarray(v, jnp.float32) for k, v in raw.items()},
        n_photons=jnp.int32(n_photons), n_bad=jnp.int32(0), n_iterations=jnp.int32(0),
        n_lane_events=jnp.float32(0.0)), nx, ny, nz, D, n_comp, cw, dz)
    tres = normalize_tallies(RawTallies(
        **{k: torch.as_tensor(v, dtype=torch.float64) for k, v in raw.items()},
        n_photons=n_photons, n_bad=torch.tensor(0), n_iterations=0,
        n_lane_events=torch.tensor(0)), nx, ny, nz, D, n_comp, cw, dz)
    for name in ("flux_up", "flux_down", "flux_absorbed", "volume_absorption",
                 "intensity", "intensity_by_component", "mean_intensity"):
        np.testing.assert_allclose(getattr(tres, name).numpy(),
                                   np.asarray(getattr(jres, name)), rtol=1e-6, err_msg=name)
    assert tres.intensity.shape == (nx, ny, D)


def _cut_namelist(dest: Path) -> Path:
    """The shipped step-cloud namelist with 8 batches of 512 photons."""
    text = (ROOT / "examples" / "monteCarloDriver_stepCloud.nml").read_text()
    cut = text.replace("numPhotonsPerBatch = 100000", "numPhotonsPerBatch = 512").replace(
        "numBatches = 16", "numBatches = 8")
    assert cut != text
    dest.mkdir()
    write_domains(str(dest))
    (dest / "run.nml").write_text(cut)
    return dest / "run.nml"


def test_driver_shipped_namelist(tmp_path, monkeypatch):
    """The shipped namelist (photon count cut) through the port's driver on
    the CPU writes stepCloudRads.out with the JAX driver's header and
    shape."""
    port, ref = _cut_namelist(tmp_path / "port"), _cut_namelist(tmp_path / "jax")
    monkeypatch.chdir(ref.parent)
    jax_run_from_namelist(ref.name, quiet=True)
    monkeypatch.chdir(port.parent)
    assert torch_driver_main([port.name, "--device", "cpu"]) == 0
    for name in ("stepCloudRads.out", "stepCloudFluxes.out", "stepCloudAbsorption.out",
                 "stepCloudOutput.nc"):
        assert (port.parent / name).is_file(), name
    got = (port.parent / "stepCloudRads.out").read_text().splitlines()
    want = (ref.parent / "stepCloudRads.out").read_text().splitlines()
    assert len(got) == len(want) == 12 + 3 * (1 + 32)
    assert [ln for ln in got if ln.startswith("!")] == [ln for ln in want if ln.startswith("!")]
    # Pixel rows: the same (x, y) columns, then radiance mean and stderr.
    data = lambda lines: [ln.rsplit(None, 2) for ln in lines if not ln.startswith("!")]
    assert [r[0] for r in data(got)] == [r[0] for r in data(want)]
    rows = np.array([[float(v) for v in r[1:]] for r in data(got)])
    assert rows.shape == (96, 2) and np.all(np.isfinite(rows)) and np.all(rows >= 0)
    shutil.rmtree(tmp_path / "jax")


@pytest.mark.cuda
@pytest.mark.parametrize("ssa,iw", [(1.0, True), (0.99, False)])
def test_detector_kernel_matches_twin_on_gpu(ssa, iw):
    """The CUDA detector variant against its twin on the same Philox draws:
    lane state bit for bit, the accumulator to 1e-9 relative (the kernel's
    atomics sum in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    cfg = replace(CFG, use_russian_roulette_for_intensity=iw)
    integ = Integrator.create(make_step_cloud(ssa), config=cfg, device=dev, **DET)
    spec = event_spec(integ.geometry, integ._fast_plan, cfg)
    st = state_from_numpy(_random_state(spec, np.random.default_rng(5)), device=dev)
    got, ref = st.clone(), st.clone()
    acc_k = torch.zeros((32, 3), dtype=torch.float64, device=dev)
    acc_t = torch.zeros_like(acc_k)
    key = batch_key(1, 2)
    event_block(spec, got, key, 3, acc_k)
    event_block_reference(spec, ref, philox_uniforms(key, 3, spec.K, spec.n_draws, L, dev),
                          acc_t)
    agree = compare_states(spec, got, ref, rtol=1e-4)
    assert agree["int_frac"] >= 0.999 and agree["float_frac"] == 1.0, agree
    assert float((acc_k - acc_t).abs().max() / acc_t.abs().max()) <= 1e-9
