"""Reflecting surfaces on the port's fastpath: the BRDFs, the bounce, the
transparent-domain closed forms and the FIFO invariant.

* The four BRDFs of ``i3rc_tpu_torch/core/surface.py`` against
  ``i3rc_tpu.core.surface`` on a seeded grid of angles and parameters, in
  float32 (within 4 ulp on 98% of the grid, 2e-4 relative everywhere: see
  ``_assert_close_to_jax``), and ``SurfaceDescription`` (validation
  included) against the JAX class.
* ``resolve_surface``, the plain version of the kernel's surface stage,
  against a transcription of the JAX glue (i3rc_tpu/integrators/
  fastpath.py:1874-1981) built from the JAX BRDFs and ``_sincos_2pi`` on
  the same uniforms, for the albedo and each BRDF, with and without
  detectors.  One deliberate difference: the JAX surface-radiance Iwabuchi
  rule drops exp(-tau) in its small-phase case (fastpath.py:1950-1951, as
  at :1544 for collisions); the transcription rebuilds the rule with
  exp(-tau), which is what the port and tests/test_torch_detectors.py use.
* The transparent domain (tests/test_fastpath.py:1227): Fdn = 1 and Fup = A;
  the Cox-Munk Fup against its hemispheric midpoint expectation; the RPV
  radiance equal to R(sun -> d) / pi, the downward detector exactly 0.
* The FIFO invariant over a reflecting surface: every photon id below the
  budget is launched exactly once and ``launched`` ends at the budget.

The Integrator-level comparisons with the JAX package are in
tests/test_torch_surface_jax.py.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3rc_tpu.core import surface as jsurface
from i3rc_tpu.integrators.wavefront import _sincos_2pi as jax_sincos_2pi
from i3rc_tpu_torch import (
    Domain,
    Integrator,
    IntegratorConfig,
    PhaseFunction,
    PhaseFunctionTable,
    PhotonSource,
    SurfaceDescription,
    batch_key,
    henyey_greenstein_coefficients,
    make_step_cloud,
)
from i3rc_tpu_torch.core import surface as tsurface
from i3rc_tpu_torch.integrators import fastpath
from i3rc_tpu_torch.integrators.fastpath import event_spec, launch_state, prologue_spec
from i3rc_tpu_torch.kernels import event_block as eb
from i3rc_tpu_torch.kernels.event_block import (
    ALIVE,
    ORDERS,
    PK,
    UX,
    UY,
    UZ,
    X,
    Y,
    Z,
    LaneState,
    block_buffers,
    fused_block,
    resolve_surface,
    shadow_closed,
)
from i3rc_tpu_torch.utils.errors import ValidationError

torch.set_num_threads(2)
CFG = IntegratorConfig(use_ray_tracing=False, max_events=500, compute_volume_absorption=False)
BRDFS = {"lambertian": [0.3], "rpv": [0.2, 0.8, -0.1], "cox_munk": [8.0, 1.34],
         "ross_li": [0.2, 0.05, 0.02]}


def thin_domain():
    """Essentially transparent 1-cell domain (tests/test_fastpath.py:1227)."""
    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(0.85, 64))], key=[1.0])
    dom = Domain.create([0, 500.0], [0, 500.0], [0.0, 250.0])
    ext = np.full((1, 1, 1), 1e-9)
    return dom.add_component("thin", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32),
                             table)


# ---------------------------------------------------------------------------
# (a) the BRDFs and SurfaceDescription

def _ulps(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want))


def _assert_close_to_jax(got, want, name):
    """Within 4 float32 ulp on all but 2% of the values R > 1e-30 (XLA
    flushes subnormal results to zero, torch keeps them), and within 2e-4
    relative on all of them.  The operations and their order are
    the JAX ones, but the CPU libraries round a few apart: torch's
    AVX-512 float32 sqrt is not correctly rounded (sqrt(0.96121150) comes
    out 1 ulp low), and XLA's exp, cos and pow are its own approximations.  Cox-Munk divides such 1-ulp differences by small
    ones at the glint peak (2 - 2 dot_ir, 1 - cos^2 beta), up to ~1e-4
    relative there.  On the card the kernel and the plain version share
    libdevice, so ``chip_smoke.py`` phase 4d holds them to each other."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    keep = np.abs(want) > 1e-30
    err = _ulps(got, want)[keep]
    rel = (np.abs(got.astype(np.float64) - want) / np.abs(want))[keep]
    assert keep.mean() > 0.6 and np.isfinite(got).all()
    assert float((err > 4.0).mean()) <= 0.02, (name, float((err > 4.0).mean()))
    assert float(rel.max()) <= 2e-4, (name, float(rel.max()))


@pytest.mark.parametrize("name", sorted(BRDFS))
def test_brdf_matches_jax(name):
    """A seeded grid of arrival (mu_in < 0) and outgoing (mu_out > 0)
    directions and of parameters around the shipped ones: the port's BRDF
    against the JAX one (``_assert_close_to_jax``)."""
    rng = np.random.default_rng(11)
    n = 4096
    mu_in = -rng.uniform(0.02, 1.0, n).astype(np.float32)
    mu_out = rng.uniform(0.02, 1.0, n).astype(np.float32)
    phi_in = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    phi_out = rng.uniform(0.0, 2 * np.pi, n).astype(np.float32)
    base = np.asarray(BRDFS[name], np.float32)
    params = (base[None, :] * rng.uniform(0.7, 1.3, (n, base.size))).astype(np.float32)
    want = np.asarray(jsurface.BRDF_REGISTRY[name](
        jnp.asarray(params), *(jnp.asarray(a) for a in (mu_in, mu_out, phi_in, phi_out))))
    t = torch.from_numpy
    got = tsurface.BRDF_REGISTRY[name]([t(params[:, k]) for k in range(base.size)],
                                       *(t(a) for a in (mu_in, mu_out, phi_in, phi_out)))
    assert got.dtype == torch.float32
    _assert_close_to_jax(got.numpy(), want, name)
    # Uniform parameters as Python floats, as the event block passes them.
    got1 = tsurface.BRDF_REGISTRY[name]([float(v) for v in base], t(mu_in), t(mu_out),
                                        t(phi_in), t(phi_out))
    want1 = np.asarray(jsurface.BRDF_REGISTRY[name](
        jnp.asarray(base), *(jnp.asarray(a) for a in (mu_in, mu_out, phi_in, phi_out))))
    _assert_close_to_jax(got1.numpy(), want1, name)


@pytest.mark.parametrize("args,message", [
    (([[[0.3]]], [0.0, 1.0], [0.0, 1.0], "phong"), "unknown BRDF"),
    (([[0.3]], [0.0, 1.0], [0.0, 1.0]), "parameters must be"),
    (([[[0.3]], [[0.4]]], [0.0, 1.0], [0.0, 1.0]), "wrong length"),
    (([[[0.3], [0.4]]], [0.0, 1.0], [0.0, 0.0, 2.0]), "unique and increasing"),
    (([[[1.3]]], [0.0, 1.0], [0.0, 1.0]), "between 0 and 1"),
])
def test_surface_description_validation_matches_jax(args, message):
    for cls in (jsurface.SurfaceDescription, SurfaceDescription):
        with pytest.raises(ValidationError if cls is SurfaceDescription else Exception,
                           match=message):
            cls.create(*args)


def test_surface_description_matches_jax():
    for name, params in BRDFS.items():
        j = jsurface.SurfaceDescription.uniform(params, brdf_name=name)
        p = SurfaceDescription.uniform(params, brdf_name=name)
        assert p.is_uniform and j.is_uniform and p.n_parameters == j.n_parameters
        assert p.parameters.dtype == np.float32 and np.array_equal(p.parameters, j.parameters)
        assert np.array_equal(p.x_edges, j.x_edges) and np.array_equal(p.y_edges, j.y_edges)
    grid = np.random.default_rng(2).uniform(0.1, 0.9, (3, 2, 1))
    j = jsurface.SurfaceDescription.create(grid, [0.0, 1.0, 2.0, 3.0], [0.0, 5.0, 6.0])
    p = SurfaceDescription.create(grid, [0.0, 1.0, 2.0, 3.0], [0.0, 5.0, 6.0])
    assert not p.is_uniform and np.array_equal(p.parameters, j.parameters)
    x = np.array([0.5, 2.5, 4.0], np.float32)
    y = np.array([1.0, 5.5, 7.0], np.float32)
    mu = np.full(3, -0.5, np.float32)
    args = (x, y, mu, -mu, np.zeros(3, np.float32), np.ones(3, np.float32))
    assert np.array_equal(p.reflectance_host(*args), j.reflectance_host(*args))


def test_surface_and_albedo_exclude_each_other():
    with pytest.raises(ValidationError, match="only one surface"):
        Integrator.create(make_step_cloud(1.0), CFG, surface_albedo=0.2, device="cpu",
                          surface=SurfaceDescription.uniform([0.3]))


# ---------------------------------------------------------------------------
# (b) the bounce against the JAX glue

DETS = dict(intensity_mus=[0.5, -0.5, 0.8], intensity_phis=[40.0, 0.0, 200.0])


def layered_columns():
    """4 x 1 x 4 cells, ext = fx(x) fz(z): a cloud layer of vertical optical
    depth 0.3-1.2 between clear layers, so that shadow rays from the
    surface see a range of transmittances."""
    vx = np.array([0.5, 1.0, 2.0, 1.0])
    vz = np.array([0.0, 0.003, 0.003, 0.0])
    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(0.8, 48))], key=[1.0])
    dom = Domain.create(np.linspace(0, 400.0, 5), [0.0, 400.0], np.linspace(0, 400.0, 5))
    ext = vx[:, None, None] * vz[None, None, :] * np.ones((1, 1, 1))
    return dom.add_component("c", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32), table)


def _bounce_case(surface: dict, detectors: bool, iwabuchi: bool = False):
    """(spec, pro, state, buffers, u, u_iw) on ``layered_columns``: a random
    state whose lanes pend kind 0, 1 or 2 (hits at the bottom with
    downward unit directions), weights in [1, 3) on a BRDF plan."""
    cfg = replace(CFG, use_russian_roulette_for_intensity=iwabuchi, zeta_min=0.3)
    integ = Integrator.create(layered_columns(), cfg, device="cpu", **surface,
                              **(DETS if detectors else {}))
    geom = integ.geometry
    spec = event_spec(geom, integ._fast_plan, cfg)
    pro = prologue_spec(geom, spec, cfg, 1 << 20)
    rng = np.random.default_rng(5)
    n = 3000
    mu = -rng.uniform(0.05, 1.0, n)
    phi = rng.uniform(0.0, 2 * np.pi, n)
    s = np.sqrt(1 - mu * mu)
    f = np.zeros((8, n), np.float32)
    f[X] = rng.uniform(geom.x0, geom.x_max, n)
    f[Y] = rng.uniform(geom.y0, geom.y_max, n)
    f[Z] = np.float32(spec.z0) - np.float32(spec.nudge_z)
    f[UX], f[UY], f[UZ] = s * np.cos(phi), s * np.sin(phi), mu
    f[6] = rng.exponential(1.0, n)
    i = np.zeros((5, n), np.int32)
    i[PK] = rng.choice([0, 1, 2, 2], n)
    i[ALIVE] = np.where(i[PK] == 0, rng.integers(0, 2, n), 0)
    i[ORDERS] = rng.integers(0, 9, n)
    w = torch.from_numpy(rng.uniform(1.0, 3.0, n).astype(np.float32)) if spec.weighted else None
    st = LaneState(torch.from_numpy(f), torch.from_numpy(i), w)
    buf = block_buffers(spec, pro, st, 0)
    u = torch.from_numpy(rng.uniform(0, 1, (3, n)).astype(np.float32))
    u_iw = (torch.from_numpy(rng.uniform(0, 1, (len(DETS["intensity_mus"]), n))
                             .astype(np.float32)) if iwabuchi else None)
    return spec, pro, st, buf, u, u_iw


def _jax_bounce(spec, pro, st, u, u_iw):
    """fastpath.py:1874-1981 transcribed with the JAX BRDFs and
    _sincos_2pi (the shadow trace and the column from the port, which
    tests/test_torch_detectors.py holds to JAX); Iwabuchi with exp(-tau)
    in its small-phase case (see the module docstring)."""
    law, det = spec.surface, spec.det
    J = lambda t: jnp.asarray(t.numpy())
    x, y, z, ux, uy, uz = (J(st.f[r]) for r in (X, Y, Z, UX, UY, UZ))
    hit = J(st.i[PK]) == 2
    wgt = J(st.w) if st.w is not None else None
    mu_r = jnp.maximum(jnp.sqrt(J(u[1])), jnp.float32(1e-6))
    sin_r = jnp.sqrt(jnp.maximum(1.0 - J(u[1]), 0.0))
    sch, cch = jax_sincos_2pi(J(u[2]))
    if law.brdf:
        name = next(k for k, v in eb.BRDF_KINDS.items() if v == law.kind)
        fn, params = jsurface.BRDF_REGISTRY[name], jnp.asarray(law.params, jnp.float32)
        phi_in = jnp.arctan2(uy, ux)
        refl = jnp.maximum(fn(params, uz, mu_r, phi_in, jnp.float32(2.0 * np.pi) * J(u[2])),
                           0.0)
        revive = hit & (J(u[0]) < jnp.minimum(refl, 1.0))
    else:
        revive = hit & (J(u[0]) < jnp.float32(law.albedo))
    srf = None
    if det is not None:
        srf = np.zeros((det.n_cols, det.n))
        emit = hit if law.brdf else revive
        zs = torch.full_like(st.f[Z], float(np.float32(spec.z0) + np.float32(spec.nudge_z)))
        for d, (dx, dy, dz) in enumerate(det.dirs):
            if dz <= 0.0:
                continue
            tau_t, col = shadow_closed(spec, d, st.f[X], st.f[Y], zs)
            tau = J(tau_t)
            if law.brdf:
                npf = jnp.maximum(fn(params, uz, jnp.float32(dz), phi_in,
                                     jnp.float32(np.arctan2(dy, dx))), 0.0) \
                    * jnp.float32(1.0 / np.pi)
            else:
                npf = jnp.full_like(tau, jnp.float32(1.0 / np.pi))
            if det.iwabuchi:
                zeta = jnp.float32(det.zeta)
                pf_pi = jnp.float32(np.pi) * npf
                tmax = -jnp.log(zeta / jnp.maximum(pf_pi, jnp.float32(1.1754944e-38)))
                us = J(u_iw[d])
                small = jnp.where(us * zeta <= pf_pi * jnp.exp(-tau), det.zeta_pi, 0.0)
                large = jnp.where(tau <= tmax, npf * jnp.exp(-tau),
                                  jnp.where(us < jnp.exp(tmax - tau), det.zeta_pi, 0.0))
                contrib = jnp.where(pf_pi <= zeta, small, large)
            else:
                contrib = npf * jnp.exp(-tau)
            contrib = jnp.where(emit, contrib, 0.0)
            if wgt is not None:
                contrib = contrib * wgt
            np.add.at(srf[:, d], col.numpy(), np.asarray(contrib, np.float64))
    if wgt is not None:
        wgt = jnp.where(revive, wgt * jnp.maximum(refl, 1.0), wgt)
    out = dict(ux=jnp.where(revive, sin_r * cch, ux), uy=jnp.where(revive, sin_r * sch, uy),
               uz=jnp.where(revive, mu_r, uz),
               z=jnp.where(revive, jnp.float32(spec.z0) + jnp.float32(spec.nudge_z), z),
               orders=jnp.where(revive, J(st.i[ORDERS]) + 1, J(st.i[ORDERS])),
               alive=(J(st.i[ALIVE]) != 0) | revive, wgt=wgt)
    # The flush (fastpath.py:1735-1778): every exit at its column with the
    # pre-reflection weight, Fdn for the bottom hits.
    flux = np.zeros((pro.n_cols, pro.n_kinds))
    col = eb.flux_column(pro, st.f[X], st.f[Y]).numpy()
    w0 = np.ones(st.n_lanes) if st.w is None else st.w.numpy().astype(np.float64)
    pk = st.i[PK].numpy()
    for kind in range(1, pro.n_kinds + 1):
        np.add.at(flux[:, kind - 1], col[pk == kind], w0[pk == kind])
    return out, flux, srf


BOUNCES = [(dict(surface_albedo=0.4), False, False), (dict(surface_albedo=0.4), True, False),
           (dict(surface_albedo=0.4), True, True)] + [
    (dict(surface=SurfaceDescription.uniform(p, brdf_name=k)), det, det)
    for k, p in sorted(BRDFS.items()) for det in (False, True)]


@pytest.mark.parametrize("surface,detectors,iwabuchi", BOUNCES,
                         ids=[f"{s.get('surface', s) and getattr(s.get('surface'), 'brdf_name', 'albedo')}"
                              f"-det{int(d)}-iw{int(i)}" for s, d, i in BOUNCES])
def test_bounce_matches_jax_glue(surface, detectors, iwabuchi):
    spec, pro, st, buf, u, u_iw = _bounce_case(surface, detectors, iwabuchi)
    ref, flux, srf = _jax_bounce(spec, pro, st, u, u_iw)
    got = st.clone()
    resolve_surface(spec, pro, got, buf, u, u_iw)
    revive = np.asarray(ref["alive"]) & ~(st.i[ALIVE].numpy() != 0)
    assert revive.sum() > 20 and (st.i[PK] == 2).sum() > revive.sum()
    assert np.array_equal(got.i[ALIVE].numpy() != 0, np.asarray(ref["alive"]))
    assert np.array_equal(got.i[ORDERS].numpy(), np.asarray(ref["orders"]))
    assert int(got.i[PK].abs().max()) == 0
    for row, name in ((UX, "ux"), (UY, "uy"), (UZ, "uz"), (Z, "z")):
        np.testing.assert_allclose(got.f[row].numpy(), np.asarray(ref[name]), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    # Rows the bounce leaves alone: x, y, tau, tgas.
    for row in (X, Y, 6, 7):
        assert torch.equal(got.f[row], st.f[row])
    if spec.weighted:
        # w x max(R, 1): R to the BRDF's own tolerance (_assert_close_to_jax).
        # A lane that exited and stays dead takes weight 1 here, where the
        # JAX glue sets it at its refill (fastpath.py:2042-2043).
        ended = (st.i[PK] != 0).numpy() & ~revive
        np.testing.assert_allclose(got.w.numpy()[~ended], np.asarray(ref["wgt"])[~ended],
                                   rtol=2e-4)
        assert ended.sum() > 100 and bool((got.w[torch.from_numpy(ended)] == 1.0).all())
    np.testing.assert_allclose(buf.columns.numpy(), flux, rtol=1e-12)
    assert float(buf.columns[:, 0].sum()) > 0.0
    if detectors:
        # Detector 1 looks down: a surface emits upward only.
        assert float(np.abs(srf[:, 1]).max()) == 0.0 and float(srf.sum()) > 0.0
        np.testing.assert_allclose(buf.srf.numpy(), srf, rtol=2e-4 if spec.weighted else 1e-6,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# (c) the transparent domain

def _thin(n: int, source, **kw):
    integ = Integrator.create(thin_domain(), CFG, device="cpu", **kw)
    return integ.batch_fn(source, n, n_lanes=1 << 12)(batch_key(23, 0))


def test_transparent_albedo():
    """Every photon hits the bottom once: Fdn = 1; Fup = A (binomial)."""
    n, a = 1 << 14, 0.3
    res = _thin(n, PhotonSource.directional(0.5, 0.0), surface_albedo=a)
    assert float(res.mean_flux_down) == pytest.approx(1.0, abs=1e-6)
    assert float(res.mean_flux_up) == pytest.approx(a, abs=4 * np.sqrt(a * (1 - a) / n))
    assert int(res.n_bad) == 0


def test_transparent_cox_munk_matches_hemispheric_expectation():
    """E[Fup] = E_u1,u2[R(in -> sqrt(u1), 2 pi u2)] on a 256 x 256 midpoint
    grid of the same kernel (tests/test_fastpath.py:1275-1296), 6 sigma."""
    n = 1 << 14
    params = [8.0, 1.34]
    res = _thin(n, PhotonSource.directional(0.7, 30.0),
                surface=SurfaceDescription.uniform(params, brdf_name="cox_munk"))
    g = 256
    u1 = (np.arange(g) + 0.5) / g
    mu_o = torch.from_numpy(np.repeat(np.sqrt(u1), g).astype(np.float32))
    phi_o = torch.from_numpy(np.tile(2.0 * np.pi * u1, g).astype(np.float32))
    refl = tsurface.cox_munk_brdf(params, torch.full_like(mu_o, -0.7), mu_o,
                                  torch.full_like(mu_o, float(np.deg2rad(30.0))), phi_o)
    expect = float(refl.double().mean())
    sig = np.sqrt(max(expect * (1 + expect), 0.05) / n)
    assert float(res.mean_flux_up) == pytest.approx(expect, abs=6 * sig)
    assert float(res.mean_flux_down) == pytest.approx(1.0, abs=1e-4)
    assert int(res.n_bad) == 0


def test_transparent_rpv_radiance_is_closed_form():
    """Every bottom hit estimates R(in -> d) / pi with weight 1: on a
    transparent domain the up detector reads R(sun -> d) / pi; a downward
    detector reads 0 (tests/test_fastpath.py:1343-1370)."""
    surf = SurfaceDescription.uniform([0.2, 0.8, -0.1], brdf_name="rpv")
    res = _thin(1 << 14, PhotonSource.directional(0.7, 30.0), surface=surf,
                intensity_mus=[0.5, -0.5], intensity_phis=[40.0, 0.0])
    iv = res.mean_intensity.numpy()
    expect = float(surf.reflectance_host(
        np.float32([0.0]), np.float32([0.0]), np.float32([-0.7]), np.float32([0.5]),
        np.float32([np.deg2rad(30.0)]), np.float32([np.deg2rad(40.0)]))[0]) / np.pi
    assert iv[0] == pytest.approx(expect, rel=1e-3)
    assert iv[1] == 0.0
    by_comp = res.intensity_by_component.mean(dim=(0, 1)).numpy()
    assert by_comp[0, 0] == pytest.approx(iv[0], rel=1e-6) and by_comp[0, 1] < 1e-5 * iv[0]


# ---------------------------------------------------------------------------
# (e) the FIFO invariant over a reflecting surface

@pytest.mark.parametrize("mult", [1, 4, 96])
def test_every_photon_launched_once(mult, monkeypatch):
    """The trace's refills take the photon ids launched .. budget - 1 each
    exactly once, ``launched`` ends at the budget, and every photon ends
    once: Fup + (Fdn - revivals) = N for a conservative transparent slab."""
    lanes = 512
    n = mult * lanes
    taken, bounces = [], {"hits": 0, "revived": 0}
    orig_refill, orig_resolve = eb.refill, eb.resolve_surface

    def refill(spec, pro, st, launched, key, source, kb):
        dead = (st.i[ALIVE] == 0).to(torch.int64)
        ids = int(launched) + torch.cumsum(dead, 0) - dead
        out = orig_refill(spec, pro, st, launched, key, source, kb)
        taken.extend(ids[(dead != 0) & (ids < pro.n_photons)].tolist())
        return out

    def resolve(spec, pro, st, buf, u, u_iw=None):
        before = st.i[ALIVE].sum()
        bounces["hits"] += int((st.i[PK] == 2).sum())
        orig_resolve(spec, pro, st, buf, u, u_iw)
        bounces["revived"] += int(st.i[ALIVE].sum() - before)

    monkeypatch.setattr(eb, "refill", refill)
    monkeypatch.setattr(eb, "resolve_surface", resolve)
    ctls = []
    monkeypatch.setattr(fastpath, "fused_block",
                        lambda spec, pro, st, buf, *a: (eb.fused_block(spec, pro, st, buf, *a),
                                                        ctls.append(buf.ctl)))
    integ = Integrator.create(thin_domain(), CFG, device="cpu", surface_albedo=0.7)
    tracer = integ.batch_tracer(n, lanes)
    key = batch_key(8, mult)
    src = PhotonSource.directional(0.6, 10.0)
    raw = tracer(key, src.sample(key, lanes, "cpu"), src)
    assert sorted(taken) == list(range(lanes, n))
    assert int(ctls[-1][0]) == n and int(ctls[-1][1]) == n
    assert bounces["hits"] == int(raw.flux_down.sum()) and bounces["revived"] > 0
    assert int(raw.flux_up.sum()) + int(raw.flux_down.sum()) - bounces["revived"] == n
    assert int(raw.n_bad) == 0


def test_fused_block_runs_the_bounce_before_the_dead_counts():
    """The whole block over a reflecting surface: a lane that hit the bottom
    in the block and was revived counts alive in the next block's dead
    counts; no lane leaves the block pending kind 2."""
    integ = Integrator.create(thin_domain(), CFG, device="cpu", surface_albedo=0.9)
    spec = event_spec(integ.geometry, integ._fast_plan, CFG)
    lanes = 1000
    pro = prologue_spec(integ.geometry, spec, CFG, 10 * lanes)
    key = batch_key(3, 3)
    src = PhotonSource.directional(0.5, 0.0)
    st = launch_state(integ.geometry, src.sample(key, lanes, "cpu"), lanes)
    buf = block_buffers(spec, pro, st, lanes)
    for kb in range(3):
        fused_block(spec, pro, st, buf, key, src, kb)
        assert int((st.i[PK] == 2).sum()) == 0
        assert torch.equal(buf.dead[(kb + 1) & 1], eb.cta_dead_counts(st.i[ALIVE]))
    assert float(buf.columns[:, 1].sum()) > lanes and int(st.i[ORDERS].max()) >= 1
