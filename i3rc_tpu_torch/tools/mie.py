# Copy of the single-sphere series of i3rc_tpu/tools/mie.py (n_mie_terms,
# mie_coefficients, mie_cross_sections, mie_amplitudes): the port keeps its own
# host layer and imports nothing of i3rc_tpu.
"""Mie scattering: the single-sphere series that PhaseMatrix.from_mie needs.

Vectorized float64 NumPy re-implementation of the reference's Mie stack
(Tools/mieindsub.f): the an/bn coefficients (MIECALC), the Qext/Qscat
efficiencies (MIECROSS) and the complex scattering amplitudes S1, S2
(MIEANGLE's angular sums).  The rest of the JAX package's ``tools/`` (the
size-distribution tables of MakeMieTable, the physical-to-domain and
optical-to-domain converters) is ROADMAP item 20.
"""

from __future__ import annotations

import numpy as np


def n_mie_terms(x: float) -> int:
    """Wiscombe series length x + 4 x^(1/3) + 2 (mieindsub.f:102)."""
    return int(x + 4.0 * x ** 0.3334 + 2)


def mie_coefficients(x: float, m: complex, n_terms: int | None = None):
    """Mie an, bn for size parameter x and refractive index m (Im(m) <= 0).

    Mirrors MIECALC (mieindsub.f:83-142): the logarithmic derivative D by
    downward recurrence started 15 orders above, Riccati-Bessel psi/chi
    upward.  Returns complex arrays of length n_terms.
    """
    if n_terms is None:
        n_terms = n_mie_terms(x)
    mc = np.conj(m)          # the reference conjugates the incoming index
    y = mc * x
    nn = n_terms + 15
    d = np.zeros(nn + 1, dtype=np.complex128)
    for n in range(nn, 1, -1):
        d[n - 1] = n / y - 1.0 / (d[n] + n / y)

    n_idx = np.arange(1, n_terms + 1, dtype=np.float64)
    psi = np.empty(n_terms + 1)
    chi = np.empty(n_terms + 1)
    psi_m, psi_n = np.cos(x), np.sin(x)
    chi_m, chi_n = -np.sin(x), np.cos(x)
    a = np.empty(n_terms, dtype=np.complex128)
    b = np.empty(n_terms, dtype=np.complex128)
    for n in range(1, n_terms + 1):
        psi_n, psi_m = (2 * n - 1) / x * psi_n - psi_m, psi_n
        chi_n, chi_m = (2 * n - 1) / x * chi_n - chi_m, chi_n
        xi_n = complex(psi_n, -chi_n)
        xi_m = complex(psi_m, -chi_m)
        tmp = d[n] / mc + n / x
        a[n - 1] = (tmp * psi_n - psi_m) / (tmp * xi_n - xi_m)
        tmp = mc * d[n] + n / x
        b[n - 1] = (tmp * psi_n - psi_m) / (tmp * xi_n - xi_m)
    del psi, chi, n_idx
    return a, b


def mie_cross_sections(x: float, a: np.ndarray, b: np.ndarray):
    """(Qext, Qscat) efficiency factors (MIECROSS, mieindsub.f:147-169)."""
    n = np.arange(1, a.size + 1)
    qext = 2.0 / x**2 * np.sum((2 * n + 1) * (a.real + b.real))
    qscat = 2.0 / x**2 * np.sum((2 * n + 1) * (np.abs(a) ** 2 + np.abs(b) ** 2))
    return qext, qscat


def mie_amplitudes(a: np.ndarray, b: np.ndarray, mu: np.ndarray):
    """Scattering amplitudes (S1, S2) at each mu, vectorized.

    The angular sums of MIEANGLE (mieindsub.f:174-209) kept as complex
    amplitudes instead of collapsed to intensity — the phase-matrix
    elements (core/phase_matrices.PhaseMatrix.from_mie) need S1, S2
    separately (Bohren & Huffman sec. 4.4.4)."""
    n_terms = a.size
    s1 = np.zeros(mu.shape, dtype=np.complex128)
    s2 = np.zeros(mu.shape, dtype=np.complex128)
    pin = np.ones_like(mu)
    pim = np.zeros_like(mu)
    for n in range(1, n_terms + 1):
        taun = n * mu * pin - (n + 1) * pim
        c = (2 * n + 1) / (n * (n + 1))
        s1 += c * (a[n - 1] * pin + b[n - 1] * taun)
        s2 += c * (b[n - 1] * pin + a[n - 1] * taun)
        pin, pim = ((2 * n + 1) * mu * pin - (n + 1) * pim) / n, pin
    return s1, s2
