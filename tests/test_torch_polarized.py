"""Polarized (Stokes-vector) transport on the port, run on the CPU (the
plain twin of the kernel PZ, ``polarized_block_reference``), against the
JAX package's own physics gates (tests/test_polarized.py) with their
tolerances: Rayleigh energy closure, the single-scattering Stokes oracle
(``_expected_single_scatter``, an independent geometric construction), the
dipole geometry of a Q-polarized beam, a circular source and two
components.  Photon counts are those of the JAX tests, but for the two
components' 100,000: Fup + Fdn of the Rayleigh slab spreads by 1.6e-3 at
60,000 photons (8 seeds), so each closure gate holds at 4 sigma or more.
tests/test_torch_polarized_jax.py holds the port against the JAX package
and its scalar kernel.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from i3rc_tpu_torch.core.rng import batch_key

torch.set_num_threads(2)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


scenes = _load("polarized_scenes")
_expected_single_scatter = _load("test_polarized")._expected_single_scatter
H = scenes.host("i3rc_tpu_torch")
N = 150_000
N_TWO_COMP = 100_000


def polarized(dom, max_events, **kw):
    return H.Polarized().create(dom, config=H.Config(**scenes.CFG_KW, max_events=max_events),
                                device="cpu", **kw)


def test_energy_closure():
    """Conservative Rayleigh slab: Fup + Fdn = 1 within 4e-3 (the weight
    multiplier has expectation 1 per event), no bad photon."""
    res = polarized(scenes.rayleigh_slab(H, 1.0), 200).compute(
        batch_key(0, 0), H.Source.directional(0.5, 0.0), N)
    assert float(res.mean_flux_up + res.mean_flux_down) == pytest.approx(1.0, abs=4e-3)
    assert int(res.n_bad) == 0


def test_single_scattering_stokes_oracle():
    """Thin Rayleigh slab, max_events = 1: Stokes radiances against the
    first-order solution in the detector meridian frame, the azimuth mirror
    U(phi) = -U(-phi), V = 0 (tests/test_polarized.py:185-226)."""
    tau, mu0 = 0.2, 0.6
    mus, phis = np.array([0.8, 0.4, 0.4, -0.7]), np.array([0.0, 60.0, 300.0, 0.0])
    res = polarized(scenes.rayleigh_slab(H, tau), 1, intensity_mus=mus,
                    intensity_phis=phis).compute(batch_key(3, 0),
                                                 H.Source.directional(mu0, 0.0), 4 * N)
    got = res.mean_intensity.numpy().astype(np.float64)
    d0 = np.array([np.sqrt(1 - mu0 ** 2), 0.0, -mu0])
    for i, (mu, phi) in enumerate(zip(mus, np.deg2rad(phis))):
        sd = np.sqrt(1 - mu ** 2)
        exp = _expected_single_scatter(tau, d0, np.array([sd * np.cos(phi), sd * np.sin(phi),
                                                          mu]))
        assert got[i, 0] == pytest.approx(exp[0], rel=0.02), (i, got[i], exp)
        assert got[i, 1] == pytest.approx(exp[1], abs=0.02 * exp[0]), (i, got[i], exp)
        assert got[i, 2] == pytest.approx(exp[2], abs=0.02 * exp[0]), (i, got[i], exp)
        assert abs(got[i, 3]) < 0.01 * exp[0]
    assert got[1, 0] == pytest.approx(got[2, 0], rel=0.03)
    assert got[1, 1] == pytest.approx(got[2, 1], abs=0.02 * got[1, 0])
    assert got[1, 2] == pytest.approx(-got[2, 2], abs=0.02 * got[1, 0])
    assert got[0, 1] < -0.1 * got[0, 0]


def test_dipole_geometry():
    """A Q-polarized vertical beam, single Rayleigh scattering: light toward
    d is fully polarized along the projected dipole axis, with intensity
    1 - (x.d)^2 (tests/test_polarized.py:458-516)."""
    mus, phis = np.array([0.6, 0.6, 0.6, -0.5]), np.array([0.0, 60.0, 135.0, 30.0])
    res = polarized(scenes.rayleigh_slab(H, 0.05), 1, intensity_mus=mus, intensity_phis=phis,
                    source_stokes=(1.0, 1.0, 0.0, 0.0)).compute(
        batch_key(2, 0), H.Source.directional(1.0, 0.0), 2 * N)
    got = res.mean_intensity.numpy().astype(np.float64)
    x_axis, z = np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0])
    dets = []
    for k, (mu, phi) in enumerate(zip(mus, np.deg2rad(phis))):
        sd = np.sqrt(1 - mu ** 2)
        det = np.array([sd * np.cos(phi), sd * np.sin(phi), mu])
        dets.append(det)
        p = x_axis - (x_axis @ det) * det
        assert np.linalg.norm(p) > 0.3
        p = p / np.linalg.norm(p)
        m1 = z - det * det[2]
        m1 = m1 / np.linalg.norm(m1)
        m2 = np.cross(det, m1)
        cpsi, spsi = p @ m1, p @ m2
        i_k, q_k, u_k, v_k = got[k]
        assert np.sqrt(q_k ** 2 + u_k ** 2) / i_k == pytest.approx(1.0, abs=0.03), (k, got[k])
        assert abs(v_k) < 0.02 * i_k
        assert q_k / i_k == pytest.approx(cpsi ** 2 - spsi ** 2, abs=0.04), (k, got[k])
        assert u_k / i_k == pytest.approx(2 * cpsi * spsi, abs=0.04), (k, got[k])
    dip = lambda k: 1.0 - (x_axis @ dets[k]) ** 2
    assert got[1, 0] / got[0, 0] == pytest.approx(dip(1) / dip(0), rel=0.06)


def test_circular_source_stays_circular():
    """A V = I source, single scattering near forward: V/I of the radiance
    stays above 0.5 (a4 > 0 there)."""
    res = polarized(scenes.rayleigh_slab(H, 0.2), 1, intensity_mus=[-0.9], intensity_phis=[0.0],
                    source_stokes=(1.0, 0.0, 0.0, 1.0)).compute(
        batch_key(9, 0), H.Source.directional(0.9, 0.0), N)
    s = res.mean_intensity[0].numpy()
    assert s[3] > 0.5 * s[0]


def test_two_components():
    """Rayleigh + a Mie cloud (tests/test_polarized.py:264-291): clean
    trace, V near 0 for an unpolarized source, closure with absorption."""
    mie = H.PhaseMatrixTable.from_phase_matrices([H.PhaseMatrix.from_mie(0.55, 1.33 + 0.0j, 0.8)],
                                                 [1.0])
    ray = H.PhaseMatrixTable.from_phase_matrices([H.PhaseMatrix.rayleigh()], [1.0])
    dom = H.Domain.create([0.0, 500.0], [0.0, 500.0], np.linspace(0.0, 250.0, 3))
    ext = np.full((1, 1, 2), 1.0 / 250.0)
    zeros = np.zeros(ext.shape, np.int32)
    dom = dom.add_component("rayleigh", 0.3 * ext, np.ones_like(ext), zeros, ray)
    dom = dom.add_component("cloud", ext, np.full_like(ext, 0.99), zeros, mie)
    res = polarized(dom, 200, intensity_mus=[0.5], intensity_phis=[0.0]).compute(
        batch_key(21, 0), H.Source.directional(0.5, 0.0), N_TWO_COMP)
    assert int(res.n_bad) == 0
    s = res.mean_intensity[0].numpy()
    assert s[0] > 0.0 and abs(s[3]) < 0.02 * s[0]
    closure = float(res.mean_flux_up + res.mean_flux_down + res.mean_flux_absorbed)
    assert closure == pytest.approx(1.0, abs=5e-3)
