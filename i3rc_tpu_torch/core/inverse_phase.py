# Copy of i3rc_tpu/core/inverse_phase.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""Inverse (cumulative) phase functions: scattering angle as a function of CDF.

Re-implements Code/inversePhaseFunctions.f95.  For each phase function the
cumulative distribution is trapezoid-integrated in the cosine of the
scattering angle at the native angle grid (or Lobatto nodes for Legendre
storage), then the piecewise-quadratic CDF is inverted analytically at
n_steps uniformly spaced probabilities (inversePhaseFunctions.f95:118-170).

Fully vectorized over probability steps; the handful of table entries loop
in Python (setup-time only).
"""

from __future__ import annotations

import numpy as np

from i3rc_tpu_torch.core.phase_functions import PhaseFunction, PhaseFunctionTable
from i3rc_tpu_torch.core.quadrature import find_index, lobatto


def _mu_value_grid(pf: PhaseFunction):
    """Phase function on a mu-ascending grid (backscatter -> forward).

    Mirrors inversePhaseFunctions.f95:90-115: native angles for tabulated
    storage, Lobatto nodes for Legendre storage.

    Resolution note: the reference uses Lobatto nodes of order nMoments only
    (inversePhaseFunctions.f95:90-115).  For forward-peaked functions the
    trapezoid CDF over that coarse grid biases the sampled distribution —
    HG g=0.85 at 64 moments comes out with effective asymmetry 0.8518,
    shifting the I3RC step-cloud Fup by ~2e-3 (a documented reference
    approximation defect).  We oversample 16x (capped at 4096 nodes,
    effective-asymmetry error < 1e-5 at g=0.85) so the tabulated pipeline
    converges to the expansion's exact distribution; the elementwise
    fastpath's analytic HG inversion then agrees with it statistically.
    """
    if pf.stored_as_tabulated:
        mus = np.cos(pf.scattering_angle[::-1])
        values = pf.values(pf.scattering_angle)[::-1]
    else:
        n = min(max(16 * pf.n_moments, 128), 4096)
        mus, _ = lobatto(n)
        mus = np.clip(mus, -1.0, 1.0)
        values = pf.values(np.arccos(mus[::-1]))[::-1]
    return mus, values


def inverse_cdf_mu(pf: PhaseFunction, p: np.ndarray) -> np.ndarray:
    """Scattering-angle cosine at arbitrary CDF values p in [0, 1].

    p = 0 is backscatter (mu = -1), p = 1 exact forward (mu = +1).  This is
    the reference's analytic piecewise-quadratic inversion
    (inversePhaseFunctions.f95:139-168) evaluated in mu, before the acos —
    used both for the theta tables and the TPU kernel's piecewise-cubic fit
    of mu(p), which is smooth where theta(p) has a sqrt singularity at the
    forward peak.
    """
    mus, values = _mu_value_grid(pf)
    cdf = np.concatenate(([0.0], np.cumsum((mus[1:] - mus[:-1]) * 0.5 * (values[1:] + values[:-1]))))
    cdf = cdf / cdf[-1]
    idx = find_index(p, cdf)
    c0, c1 = cdf[idx], cdf[idx + 1]
    m0, m1 = mus[idx], mus[idx + 1]
    v0, v1 = values[idx], values[idx + 1]
    dc = c1 - c0
    flat_cdf = dc <= np.spacing(np.abs(c0) + 1.0)
    flat_val = np.abs(v0 - v1) <= np.spacing(np.abs(v0) + 1e-30)
    with np.errstate(divide="ignore", invalid="ignore"):
        mu_linear = m0 + (m1 - m0) * (p - c0) / dc
        radicand = np.maximum(((c1 - p) * v0**2 + (p - c0) * v1**2) / dc, 0.0)
        mu_general = m0 + (m1 - m0) / (v0 - v1) * (v0 - np.sqrt(radicand))
    mu = np.where(flat_cdf, m0, np.where(flat_val, mu_linear, mu_general))
    return np.clip(mu, -1.0, 1.0)


def inverse_phase_function(pf: PhaseFunction, n_steps: int) -> np.ndarray:
    """Scattering angle (radians) at n_steps CDF values uniform on [0, 1].

    Entry i corresponds to CDF = i / (n_steps - 1); entry 0 is pi
    (backscatter), the last entry is 0 (exact forward).
    Mirrors computeInversePhaseFunction (inversePhaseFunctions.f95:68-176).
    """
    mus, values = _mu_value_grid(pf)
    cdf = np.concatenate(([0.0], np.cumsum((mus[1:] - mus[:-1]) * 0.5 * (values[1:] + values[:-1]))))
    cdf = cdf / cdf[-1]

    p = np.arange(n_steps, dtype=np.float64) / (n_steps - 1)
    idx = find_index(p, cdf)
    c0, c1 = cdf[idx], cdf[idx + 1]
    m0, m1 = mus[idx], mus[idx + 1]
    v0, v1 = values[idx], values[idx + 1]

    dc = c1 - c0
    flat_cdf = dc <= np.spacing(np.abs(c0) + 1.0)
    flat_val = np.abs(v0 - v1) <= np.spacing(np.abs(v0) + 1e-30)

    with np.errstate(divide="ignore", invalid="ignore"):
        # Locally constant phase function: linear CDF inversion (:155-158).
        mu_linear = m0 + (m1 - m0) * (p - c0) / dc
        # General piecewise-quadratic inversion (:162-167).
        radicand = np.maximum(((c1 - p) * v0**2 + (p - c0) * v1**2) / dc, 0.0)
        mu_general = m0 + (m1 - m0) / (v0 - v1) * (v0 - np.sqrt(radicand))

    mu = np.where(flat_cdf, m0, np.where(flat_val, mu_linear, mu_general))
    angle = np.arccos(np.clip(mu, -1.0, 1.0))
    angle[-1] = 0.0  # CDF == 1 -> exact forward (:170)
    return angle


def inverse_phase_function_table(table: PhaseFunctionTable, n_steps: int) -> np.ndarray:
    """Inverse table for every entry: shape (n_entries, n_steps).

    Mirrors computeInversePhaseFuncTable (inversePhaseFunctions.f95:28-66).
    """
    return np.stack([inverse_phase_function(pf, n_steps) for pf in table.phase_functions])
