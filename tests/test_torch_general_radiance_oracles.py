"""The general kernel's local estimate on the CPU: its deterministic parts
against the JAX package, and closed forms.

  * The exact transmittance trace (the DDA to the boundary, target 3e38)
    from seeded points along seeded detector directions, and the forward
    table lookup at seeded rows and angles, against JAX
    ``ops.dda.trace_extinction`` and ``wavefront._table_lookup`` on
    identical numpy inputs.  Statuses and exit cells equal; tau within 4
    float32 ulps per DDA step of tau and of the domain's extent times the
    largest extinction (XLA on the CPU contracts x + s * u into a fused
    multiply-add, the port rounds the product first, so positions differ by
    ulps of the extent: tests/test_torch_dda.py), exp(-tau) within that
    relative error; the interpolated phase values within 2 ulps of the
    value (the same contraction in (1 - f) a0 + f a1).
  * Single scattering (tests/test_integrator.py:111-155, max_events = 1):
    a thin slab's radiance I = ssa P(Theta) / (4 pi (mu + mu0)) (1 -
    exp(-tau (1/mu + 1/mu0))) up, its diffuse transmission down, in every
    transport mode with the exact trace and Iwabuchi roulette, and with
    ratio tracking: 4 batches of 2^16 photons, within 4 standard errors of
    the batch means plus 0.5% (the forward table's resolution, +0.2-0.3% on
    the JAX package).
  * Vacuum over Cox-Munk (tests/test_misc_features.py:184-227): every photon
    reaches the surface with weight 1 and leaves with transmission 1, so an
    upward detector reads R(sun -> detector)/pi exactly and a downward one
    0, in every mode (rtol 2e-3, atol 1e-7).
  * The estimate's ray count (``n_int_rays``, the bound's ray term on the
    card): D per estimating event, exactly, where the events can be
    counted (the single-scattering slab, the vacuum over Cox-Munk).
  * The step cloud's radiance triplet against the C++ local-estimation
    oracle (i3rc_tpu/native/scalar_mc.cc, as tests/test_external_validation
    .py:370-407), built here into a temporary directory; skipped only when
    it cannot be built.
"""

import importlib.util
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3rc_tpu.core.surface import cox_munk_brdf
from i3rc_tpu.integrators import wavefront as jwf
from i3rc_tpu.ops import dda as jdda
from i3rc_tpu_torch import (Domain, Integrator, IntegratorConfig, PhaseFunction,
                            PhaseFunctionTable, PhotonSource, SurfaceDescription, batch_key,
                            henyey_greenstein_coefficients, make_step_cloud)
from i3rc_tpu_torch.integrators import wavefront as twf
from i3rc_tpu_torch.ops import dda as tdda
from tests.general_cases import MODES
from tests.test_torch_dda import edges, field

torch.set_num_threads(2)


def test_exact_trace_and_forward_lookup_match_jax():
    xe, ye, ze = edges(True)
    ext = field((6, 5, 7))
    rng = np.random.default_rng(21)
    n = 768
    x = rng.uniform(xe[0], xe[-1], n).astype(np.float32)
    y = rng.uniform(ye[0], ye[-1], n).astype(np.float32)
    z = rng.uniform(ze[0], ze[-1], n).astype(np.float32)
    mu = rng.choice([-1.0, 1.0], n) * rng.uniform(0.05, 1.0, n)
    phi = rng.uniform(0.0, 2 * np.pi, n)
    s = np.sqrt(1 - mu * mu)
    u = [a.astype(np.float32) for a in (s * np.cos(phi), s * np.sin(phi), mu)]
    target = np.full(n, twf._TRACE_TARGET, np.float32)
    jg = jdda.GridGeometry.from_edges(xe, ye, ze, True, False)
    tg = tdda.GridGeometry.from_edges(xe, ye, ze, True, False)
    cells = [np.asarray(f(jnp.asarray(v))) for f, v in ((jg.locate_x, x), (jg.locate_y, y),
                                                         (jg.locate_z, z))]
    j = jdda.trace_extinction(jg, jnp.asarray(ext.ravel()), *map(jnp.asarray, (x, y, z, *cells,
                                                                              *u, target)),
                              jnp.ones(n, bool), 1024)
    steps = torch.zeros(n, dtype=torch.int32)
    t = tdda.trace_extinction(tg, torch.as_tensor(ext.ravel().copy()),
                              *map(torch.as_tensor, (x, y, z, *cells, *u, target)),
                              torch.ones(n, dtype=torch.bool), 1024, steps=steps)
    j, t = [np.asarray(a) for a in j], [b.numpy() for b in t]
    want = np.where(mu > 0, tdda.EXIT_TOP, tdda.EXIT_BOT)
    np.testing.assert_array_equal(j[7], t[7])
    np.testing.assert_array_equal(t[7], want)
    for k in (3, 4, 5):                       # the exit cell: its column and layer
        np.testing.assert_array_equal(j[k], t[k])
    # A step's tau is s * ext, s from positions within ulps of the domain's
    # extent: 4 such ulps times the largest extinction per step, plus tau's own.
    per_step = 4 * np.maximum(steps.numpy(), 1)
    tau_j, tau_t = j[6], t[6]
    pos_ulp = float(np.spacing(np.float32(max(xe[-1] - xe[0], ye[-1] - ye[0], ze[-1]))))
    tol = per_step * (pos_ulp * float(ext.max()) + np.spacing(np.abs(tau_j).astype(np.float32)))
    bad = np.abs(tau_j - tau_t) > tol
    assert not bad.any(), (tau_j[bad], tau_t[bad], steps.numpy()[bad])
    tj, tt = np.exp(-tau_j), torch.exp(-torch.as_tensor(tau_t)).numpy()
    assert np.all(np.abs(tj - tt) <= tj * tol + 2 * np.spacing(tj.astype(np.float32)))
    assert (tau_t > 0.0).mean() > 0.9 and steps.numpy().max() > 20

    # The lookup: 3 rows of 9001 steps, seeded rows and positions (the ends
    # and the last interval included).
    n_steps = 9001
    table = np.exp(rng.normal(0.0, 2.0, 3 * n_steps)).astype(np.float32)
    rows = rng.integers(0, 3, 4096).astype(np.int32) * n_steps
    pos = rng.uniform(-0.01, 1.01, 4096).astype(np.float32)
    pos[:3] = (0.0, 1.0, np.nextafter(np.float32(1.0), np.float32(0.0)))
    jv = np.asarray(jwf._table_lookup(jnp.asarray(table), jnp.asarray(rows), jnp.asarray(pos),
                                      n_steps))
    tv = twf.table_lookup(torch.as_tensor(table), torch.as_tensor(rows), torch.as_tensor(pos),
                          n_steps).numpy()
    scale = np.maximum(np.abs(jv), np.abs(tv)).astype(np.float32)
    assert np.all(np.abs(jv - tv) <= 2 * np.spacing(scale))


def hg_table(g):
    return PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(g, 64))], key=[1.0])


def slab(tau, g, n_layers=2):
    """tests/test_integrator.py slab_domain: 500 x 500 x 250 m, ssa 1."""
    dom = Domain.create([0.0, 500.0], [0.0, 500.0], np.linspace(0.0, 250.0, n_layers + 1))
    ext = np.full((1, 1, n_layers), tau / 250.0)
    return dom.add_component("cloud", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32),
                             hg_table(g))


def single_scattering(tau, mu0, g, mus, phis):
    """The first-order radiance of a thin conservative slab (tests/
    test_integrator.py:121-148)."""
    s0 = np.sqrt(1 - mu0 ** 2)
    d0 = np.array([s0, 0.0, -mu0])
    pf = PhaseFunction.from_legendre(henyey_greenstein_coefficients(g, 64))
    out = []
    for mu, phi in zip(mus, np.deg2rad(phis)):
        sd = np.sqrt(1 - mu ** 2)
        p = pf.values(np.array([np.arccos(d0 @ [sd * np.cos(phi), sd * np.sin(phi), mu])]))[0]
        if mu > 0:
            out.append(p / (4 * np.pi * (mu + mu0)) * (1 - np.exp(-tau * (1 / mu + 1 / mu0))))
        else:
            am = abs(mu)
            out.append(p / (4 * np.pi) / (mu0 - am) * (np.exp(-tau / mu0) - np.exp(-tau / am)))
    return np.array(out)


SINGLE = [(m, e) for m in sorted(MODES) for e in ("exact", "iwabuchi")] + [("woodcock", "ratio")]


@pytest.mark.parametrize("mode,est", SINGLE)
def test_single_scattering_closed_form(mode, est):
    tau, mu0, g = 0.2, 0.6, 0.5
    mus, phis = [0.8, 0.4, -0.7], [0.0, 120.0, 60.0]
    cfg = dict(max_events=1, use_fastpath=False, **MODES[mode])
    if est == "iwabuchi":
        cfg["use_russian_roulette_for_intensity"] = True
    elif est == "ratio":
        cfg.update(use_ratio_tracking_for_intensity=True, majorant_block_size=1)
    integ = Integrator.create(slab(tau, g), IntegratorConfig(**cfg), intensity_mus=mus,
                              intensity_phis=phis, device="cpu")
    assert integ.batch_tracer(1 << 16).spec.det.est == ("exact", "iwabuchi", "ratio").index(est)
    fn = integ.batch_fn(PhotonSource.directional(mu0, 0.0), 1 << 16)
    got = np.array([fn(batch_key(40, b)).mean_intensity.numpy() for b in range(4)], np.float64)
    want = single_scattering(tau, mu0, g, mus, phis)
    se = got.std(axis=0, ddof=1) / 2.0
    assert np.all(np.abs(got.mean(0) - want) <= 4 * se + 0.005 * want), (got.mean(0), want, se)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_vacuum_cox_munk_closed_form(mode):
    mu0, az0, wind, n_refr = 0.707, 30.0, 7.0, 1.34
    mus, phis = [0.707, 0.5, 0.9, -0.5], [30.0, 210.0, 75.0, 0.0]
    dom = Domain.create([0, 500.0], [0, 500.0], [0.0, 250.0])
    ext = np.full((1, 1, 1), 1e-12)
    dom = dom.add_component("vac", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32),
                            hg_table(0.85))
    integ = Integrator.create(dom, IntegratorConfig(use_fastpath=False, **MODES[mode]),
                              surface=SurfaceDescription.uniform([wind, n_refr],
                                                                 brdf_name="cox_munk"),
                              intensity_mus=mus, intensity_phis=phis, device="cpu")
    assert integ._fast_plan is None
    res = integ.compute(batch_key(7, 0), PhotonSource.directional(mu0, az0), 8192)
    params = np.array([[wind, n_refr]], np.float32)
    want = [float(cox_munk_brdf(params, np.array([-mu0], np.float32), np.array([m], np.float32),
                                np.array([np.deg2rad(az0)], np.float32),
                                np.array([np.deg2rad(p)], np.float32))[0]) / np.pi
            if m > 0 else 0.0 for m, p in zip(mus, phis)]
    np.testing.assert_allclose(res.mean_intensity.numpy().astype(np.float64), want, rtol=2e-3,
                               atol=1e-7)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_estimate_rays_count_the_estimating_events(mode):
    """n_int_rays is D rays per estimating event.  A thin conservative slab
    at max_events = 1: every physical collision estimates and then ends
    over the budget (counted bad), a null collision does neither, so rays
    = D n_bad.  A vacuum over Cox-Munk: every photon estimates at its one
    bottom hit, so rays = D n."""
    mus, phis = [0.8, 0.4, -0.7], [0.0, 120.0, 60.0]
    src = PhotonSource.directional(0.6, 0.0)
    integ = Integrator.create(slab(0.2, 0.5), IntegratorConfig(
        max_events=1, use_fastpath=False, **MODES[mode]), intensity_mus=mus,
        intensity_phis=phis, device="cpu")
    n, key = 4096, batch_key(41, 0)
    raw = integ.batch_tracer(n)(key, src.sample(key, n, "cpu"), src)
    assert int(raw.n_bad) > 100 and int(raw.n_int_rays) == 3 * int(raw.n_bad)
    assert int(raw.n_int_steps) >= int(raw.n_int_rays)
    dom = Domain.create([0, 500.0], [0, 500.0], [0.0, 250.0])
    ext = np.full((1, 1, 1), 1e-12)
    dom = dom.add_component("vac", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32),
                            hg_table(0.85))
    integ = Integrator.create(dom, IntegratorConfig(use_fastpath=False, **MODES[mode]),
                              surface=SurfaceDescription.uniform([7.0, 1.34],
                                                                 brdf_name="cox_munk"),
                              intensity_mus=mus, intensity_phis=phis, device="cpu")
    n = 2048
    raw = integ.batch_tracer(n)(key, src.sample(key, n, "cpu"), src)
    assert int(raw.n_bad) == 0 and int(raw.n_int_rays) == 3 * n


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """i3rc_tpu/native/scalar_mc's binding, loaded from a copy beside a
    library built here from scalar_mc.cc (the package directory stays as
    it is)."""
    src = Path(__file__).resolve().parents[1] / "i3rc_tpu" / "native"
    out = tmp_path_factory.mktemp("native")
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the native oracle")
    built = subprocess.run([cxx, "-O3", "-shared", "-fPIC", "-std=c++17",
                            str(src / "scalar_mc.cc"), "-o", str(out / "_scalar_mc.so")],
                           capture_output=True, text=True)
    if built.returncode != 0:
        pytest.skip(f"the native oracle does not build: {built.stderr[-300:]}")
    shutil.copy(src / "scalar_mc.py", out / "scalar_mc.py")
    spec = importlib.util.spec_from_file_location("scalar_mc_copy", out / "scalar_mc.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.available()
    return mod


def test_step_cloud_radiances_match_native_oracle(native):
    """The step cloud through the default configuration (ray tracing, the
    exact trace) against the oracle's independent local estimate, with the
    tolerance rule of tests/test_external_validation.py:397-403."""
    n, mus, phis = 1 << 13, [1.0, 0.5, 0.5], [0.0, 0.0, 180.0]
    integ = Integrator.create(make_step_cloud(1.0), IntegratorConfig(
        max_events=2000, compute_volume_absorption=False), intensity_mus=mus,
        intensity_phis=phis, device="cpu")
    assert integ._fast_plan is None and integ.batch_tracer(n).spec.mode == twf.RT
    res = integ.batch_fn(PhotonSource.directional(0.5, 0.0), n)(batch_key(31, 0))
    got = res.mean_intensity.numpy()
    tau = np.where(np.arange(32) < 16, 2.0, 18.0)
    ext = np.broadcast_to((tau / 250.0)[:, None, None], (32, 1, 32)).copy()
    n_o = 4 * n
    ro = native.trace(ext, np.ones_like(ext), 0.85, np.linspace(0, 500, 33), [0, 500.0],
                      np.linspace(0, 250, 33), 0.5, 0.0, n_o, seed=33, detector_mus=mus,
                      detector_phis=phis)
    want = ro["intensity"].sum(axis=0) / n_o
    for d in range(3):
        tol = 3.0 * max(float(want[d]) * 2.5 * np.sqrt(1.0 / n + 1.0 / n_o), 1e-4)
        assert abs(float(got[d]) - float(want[d])) <= tol, (d, got, want)
    assert ro["n_bad"] == 0 and int(res.n_bad) <= 1e-3 * n
