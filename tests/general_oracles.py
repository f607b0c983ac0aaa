"""Closed forms for the general kernel's reflecting and multi-component
scenes, independent of the transport code, and the scenes they describe.

  * ``slab_over_albedo``: a homogeneous slab over a Lambertian surface, by
    adding the discrete-ordinates slab (tests/disort_oracle.py) to the
    surface.  The surface returns A times the downward flux isotropically;
    the slab reflects s and transmits t of an isotropic illumination, with
    s = 2 int R(mu) mu dmu and t = 2 int T(mu) mu dmu (a homogeneous slab is
    the same seen from below).  So Fup = R + T A t / (1 - A s) at the top
    and Fdn = T / (1 - A s) at the surface, where the Monte Carlo tallies
    every hit.
  * ``mixture``: two scattering components in the same cells act as one of
    extinction e1 + e2, single-scattering albedo (b1 + b2) / (e1 + e2) and
    Legendre coefficients (b1 chi1 + b2 chi2) / (b1 + b2), b = e * ssa.
  * ``clear_sky_brdf``: a transparent atmosphere over a gridded BRDF.  Every
    photon reaches the surface once at a uniformly distributed point, leaves
    it in a cosine-weighted direction with its weight times R, and exits at
    the top: the mean Fup is the area mean of the directional albedo
    rho(mu_in) = (1/pi) int int R mu dmu dphi, Fdn is 1, and the variance of
    one photon's Fup is the area mean of (1/pi) int int R^2 mu dmu dphi less
    the square of the mean.

The Monte Carlo side has a sampling error only; the quadratures here are
exact to ~1e-6 (32 and 64 Gauss nodes against 16 and 32 change them less).
"""

import importlib
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
from numpy.polynomial.legendre import leggauss

_spec = importlib.util.spec_from_file_location("disort_oracle",
                                               Path(__file__).with_name("disort_oracle.py"))
_oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_oracle)
slab_fluxes = _oracle.slab_fluxes

# HG g = 0.85 from 64 moments (the slab of tests/test_external_validation.py)
HG_CHI = 0.85 ** np.arange(1, 65)
# Rayleigh, P = 1 + P_2 / 2: chi_2 = 1/10
RAYLEIGH_CHI = np.zeros(64)
RAYLEIGH_CHI[1] = 0.1


def host(pkg: str) -> SimpleNamespace:
    """The classes of package ``pkg`` (i3rc_tpu or i3rc_tpu_torch) that the
    scenes are built with."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    pf = mod("core.phase_functions")
    return SimpleNamespace(
        pkg=pkg, Domain=mod("core.optics").Domain, PhaseFunction=pf.PhaseFunction,
        PhaseFunctionTable=pf.PhaseFunctionTable, hg=pf.henyey_greenstein_coefficients,
        Integrator=mod("integrators.integrator").Integrator,
        Source=mod("core.illumination").PhotonSource,
        Surface=mod("core.surface").SurfaceDescription,
        Config=mod("integrators.config").IntegratorConfig)


def _nodes(n: int):
    x, w = leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def slab_over_albedo(tau: float, omega: float, chi, mu0: float, albedo: float,
                     n_mu: int = 32) -> tuple[float, float]:
    """(Fup at the top, Fdn at the surface) of a homogeneous slab over a
    Lambertian surface of ``albedo``, illuminated along ``mu0``."""
    r0, t0 = slab_fluxes(tau, omega, chi, mu0)
    mu, w = _nodes(n_mu)
    rt = np.array([slab_fluxes(tau, omega, chi, m) for m in mu])
    s, t = 2.0 * np.sum(w * mu * rt[:, 0]), 2.0 * np.sum(w * mu * rt[:, 1])
    down = t0 / (1.0 - albedo * s)
    return r0 + albedo * down * t, down


def mixture(ext, ssa, chis) -> tuple[float, float, np.ndarray]:
    """(extinction, single-scattering albedo, chi) of components that share
    their cells."""
    ext, ssa = np.asarray(ext, float), np.asarray(ssa, float)
    b = ext * ssa
    chi = sum(bk * np.asarray(c, float) for bk, c in zip(b, chis)) / b.sum()
    return float(ext.sum()), float(b.sum() / ext.sum()), chi


def clear_sky_brdf(brdf_fn, params: np.ndarray, x_edges, y_edges, uz: float, phi_in: float,
                   n_mu: int = 64, n_phi: int = 128) -> tuple[float, float]:
    """(mean Fup, variance of one photon's Fup) over a transparent
    atmosphere: ``params`` (nx, ny, n_params) of ``brdf_fn`` on the cells of
    ``x_edges`` x ``y_edges``, the photons arriving with vertical direction
    cosine ``uz`` (< 0) and azimuth ``phi_in``."""
    mu, wm = _nodes(n_mu)
    phi = (np.arange(n_phi) + 0.5) * 2.0 * np.pi / n_phi
    m, p = np.meshgrid(mu, phi, indexing="ij")
    weight = (wm[:, None] * m * (2.0 / n_phi)).ravel()      # (1/pi) dmu dphi mu
    area = np.outer(np.diff(x_edges), np.diff(y_edges))
    area = area / area.sum()
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    mean = second = 0.0
    for ix in range(params.shape[0]):
        for iy in range(params.shape[1]):
            r = brdf_fn([t(np.full(m.size, v)) for v in params[ix, iy]],
                        t(np.full(m.size, uz)), t(m.ravel()), t(np.full(m.size, phi_in)),
                        t(p.ravel())).numpy()
            mean += area[ix, iy] * np.sum(weight * r)
            second += area[ix, iy] * np.sum(weight * r * r)
    return float(mean), float(second - mean * mean)


def hg_slab(h, tau: float, ssa: float, n_layers: int = 4):
    """The slab of tests/test_external_validation.py (500 m x 500 m x 250 m,
    HG g = 0.85 from 64 moments), built with the classes of ``h``."""
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.85, 64))], key=[1.0])
    ext = np.full((1, 1, n_layers), tau / 250.0)
    return h.Domain.create([0.0, 500.0], [0.0, 500.0], np.linspace(0.0, 250.0, n_layers + 1)) \
        .add_component("slab", ext, np.full_like(ext, ssa), np.zeros(ext.shape, np.int32), table)


# The two-component slab: HG g = 0.85 at ssa 0.95 (tau 0.8) and a tabulated
# Rayleigh component at ssa 0.8 (tau 0.4), in the same 4 layers.
MIXTURE = dict(tau=(0.8, 0.4), ssa=(0.95, 0.8))


def mixture_slab(h, n_layers: int = 4):
    """MIXTURE with the classes of ``h``; returns (domain, (tau, omega, chi))
    of the slab it acts as."""
    hg = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.85, 64))], key=[1.0])
    ang = np.linspace(0.0, np.pi, 721)
    ray = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_tabulated(ang, 0.75 * (1 + np.cos(ang) ** 2))], key=[0.0])
    dom = h.Domain.create([0.0, 500.0], [0.0, 500.0], np.linspace(0.0, 250.0, n_layers + 1))
    shape = (1, 1, n_layers)
    for name, tau, ssa, table in zip(("cloud", "haze"), MIXTURE["tau"], MIXTURE["ssa"],
                                     (hg, ray)):
        dom = dom.add_component(name, np.full(shape, tau / 250.0), np.full(shape, ssa),
                                np.zeros(shape, np.int32), table)
    return dom, mixture(MIXTURE["tau"], MIXTURE["ssa"], (HG_CHI, RAYLEIGH_CHI))


# A 2 x 2 RPV surface on cells of unequal size, so that a lookup that swaps
# or misplaces the cells changes the area mean.
RPV_PARAMS = np.array([[[0.1, 0.8, -0.1], [0.3, 0.7, 0.1]],
                       [[0.2, 0.9, 0.0], [0.05, 0.6, -0.2]]])
RPV_X, RPV_Y = [0.0, 150.0, 500.0], [0.0, 350.0, 500.0]


def clear_sky(h):
    """A transparent 500 m x 500 m x 250 m column (one cell, no extinction)
    over the RPV grid, with the classes of ``h``."""
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.85, 64))], key=[1.0])
    dom = h.Domain.create([0.0, 500.0], [0.0, 500.0], [0.0, 250.0]).add_component(
        "air", np.zeros((1, 1, 1)), np.ones((1, 1, 1)), np.zeros((1, 1, 1), np.int32), table)
    return dom, h.Surface.create(RPV_PARAMS, RPV_X, RPV_Y, brdf_name="rpv")
