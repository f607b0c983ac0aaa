# Copy of i3rc_tpu/integrators/tables.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""Table construction for the transport kernel.

Builds the three tabulated forms the kernel gathers from on-chip:

  * inverse tables: scattering angle vs CDF per (component, table entry)
    (tabulateInversePhaseFunctions, monteCarloRadiativeTransfer.f95:1809-1861)
  * forward tables: phase value vs angle, equally spaced on [0, pi]
    (tabulateForwardPhaseFunctions, :1863-1923)
  * hybrid forward tables: Gaussian forward peak spliced continuously onto
    the original (computeHydridPhaseFunctions, :1925-2039)

Components can have different entry counts; arrays are padded to the max
(padding rows repeat the last entry and are never indexed because phase
indices are validated against each component's table).  Output is float32,
stacked (n_components, max_entries, n_steps).
"""

from __future__ import annotations

import numpy as np

from i3rc_tpu_torch.core.inverse_phase import inverse_phase_function_table
from i3rc_tpu_torch.core.optics import FlatOptics


def _pad_stack(mats, n_steps):
    max_entries = max(m.shape[0] for m in mats)
    out = np.zeros((len(mats), max_entries, n_steps), dtype=np.float32)
    for i, m in enumerate(mats):
        out[i, : m.shape[0]] = m
        if m.shape[0] < max_entries:
            out[i, m.shape[0]:] = m[-1]
    return out


def build_inverse_tables(optics: FlatOptics, n_steps: int) -> np.ndarray:
    """(n_components, max_entries, n_steps) scattering angles (radians)."""
    mats = [inverse_phase_function_table(t, n_steps) for t in optics.forward_tables]
    return _pad_stack(mats, n_steps)


def build_inverse_cubic(optics: FlatOptics, n_segments: int = 256,
                        samples_per_segment: int = 9) -> np.ndarray:
    """Piecewise-cubic fit of the inverse CDF in mu(p) for the TPU kernel.

    Returns (n_components, max_entries, n_segments, 4) coefficients c such
    that mu = c0 + c1 t + c2 t^2 + c3 t^3 with t = p * S - segment in [0, 1).
    Least-squares fit through samples of the reference's exact analytic
    inversion (core/inverse_phase.inverse_cdf_mu) per segment.

    Fitting mu(p) rather than interpolating theta(p) (the reference's 9001-
    point linear table, monteCarloRadiativeTransfer.f95:1390-1417) is the
    TPU-native form: mu(p) is smooth — theta(p) has a sqrt singularity at
    the forward peak — and the 4-coefficient row is a single fused one-hot
    matmul read instead of two serialized gathers from a 9001-point table.
    """
    from i3rc_tpu_torch.core.inverse_phase import inverse_cdf_mu

    s = n_segments
    m = samples_per_segment
    t = np.linspace(0.0, 1.0, m)
    design = np.stack([np.ones(m), t, t**2, t**3], axis=1)      # (m, 4)
    pinv = np.linalg.pinv(design)                                # (4, m)
    # Global sample grid: segment starts + local offsets.
    p = (np.arange(s)[:, None] + t[None, :]).reshape(-1) / s     # (s*m,)
    p = np.clip(p, 0.0, 1.0)

    per_comp, fits = [], {}
    for table in optics.forward_tables:
        # Components that share a table share its fit (the port's addition:
        # a domain of many components of one table fits it once).
        if id(table) not in fits:
            rows = []
            for pf in table.phase_functions:
                mu = inverse_cdf_mu(pf, p).reshape(s, m)         # (s, m)
                coeffs = mu @ pinv.T                              # (s, 4)
                rows.append(coeffs)
            fits[id(table)] = np.stack(rows)                      # (entries, s, 4)
        per_comp.append(fits[id(table)])
    max_entries = max(c.shape[0] for c in per_comp)
    out = np.zeros((len(per_comp), max_entries, s, 4), dtype=np.float32)
    for i, c in enumerate(per_comp):
        out[i, : c.shape[0]] = c
        if c.shape[0] < max_entries:
            out[i, c.shape[0]:] = c[-1]
    return out


def build_forward_tables(optics: FlatOptics, n_steps: int) -> np.ndarray:
    """(n_components, max_entries, n_steps) phase values on [0, pi]."""
    angles = np.linspace(0.0, np.pi, n_steps)
    mats = [t.values(angles).T for t in optics.forward_tables]  # (entries, steps)
    return _pad_stack(mats, n_steps)


def build_forward_cubic(optics: FlatOptics, n_segments: int = 512,
                        samples_per_segment: int = 9) -> np.ndarray:
    """Piecewise-cubic fit of LOG phase value vs scattering angle.

    Returns (n_components, max_entries, n_segments, 4) coefficients c such
    that log P = c0 + c1 t + c2 t^2 + c3 t^3 with t = theta/pi * S - segment
    in [0, 1).  Fitting log P keeps the Mie forward peak (orders of
    magnitude over a degree) within cubic reach; the kernel exponentiates
    after evaluation.  This is the fastpath's form of the general kernel's
    equally-spaced-in-angle forward value lookup (the reference's
    interpolation at the photon->detector angle,
    monteCarloRadiativeTransfer.f95:1487-1509): one 4-wide one-hot row
    read + exp per detector per collision instead of a serialized gather
    from the dense table.
    """
    s, m = n_segments, samples_per_segment
    t = np.linspace(0.0, 1.0, m)
    design = np.stack([np.ones(m), t, t**2, t**3], axis=1)      # (m, 4)
    pinv = np.linalg.pinv(design)                                # (4, m)
    theta = np.clip(((np.arange(s)[:, None] + t[None, :])
                     * (np.pi / s)).reshape(-1), 0.0, np.pi)     # (s*m,)

    per_comp, fits = [], {}
    for table in optics.forward_tables:
        if id(table) not in fits:                                # one fit a shared table
            vals = np.asarray(table.values(theta), dtype=np.float64).T
            logv = np.log(np.maximum(vals, 1e-30)).reshape(-1, s, m)
            fits[id(table)] = logv @ pinv.T                       # (entries, s, 4)
        per_comp.append(fits[id(table)])
    max_entries = max(c.shape[0] for c in per_comp)
    out = np.zeros((len(per_comp), max_entries, s, 4), dtype=np.float32)
    for i, c in enumerate(per_comp):
        out[i, : c.shape[0]] = c
        if c.shape[0] < max_entries:
            out[i, c.shape[0]:] = c[-1]
    return out


def hybridize(forward: np.ndarray, width_degrees: float) -> np.ndarray:
    """Replace each entry's forward peak with a continuous Gaussian.

    ``forward`` is (n_components, n_entries, n_steps) on the equally spaced
    angle grid.  For each entry, find the transition angle where a
    renormalized Gaussian exp(-(theta/width)^2) meets the original phase
    function, splice, and renormalize so the total integral stays 2
    (computeHydridPhaseFunctions + computeNormalization,
    monteCarloRadiativeTransfer.f95:1925-2023).

    The reference hunts+bisects for the sign change; here the difference
    d(t) = P0(t) * gauss[t] - orig[t] is evaluated for every candidate t at
    once (prefix sums give P0(t)) and the first sign change is selected.
    """
    n_comp, n_entries, n_steps = forward.shape
    angles = np.linspace(0.0, np.pi, n_steps)
    mus = np.cos(angles)
    width_rad = np.deg2rad(width_degrees)
    gauss = np.exp(-((angles / width_rad) ** 2))

    # Trapezoid panel integrals in mu (mu decreasing as angle increases):
    # panel[i] spans angles[i]..angles[i+1] with positive measure mus[i]-mus[i+1].
    d_mu = mus[:-1] - mus[1:]

    # lowerBound: first index past the Gaussian width (reference :1954).
    lower = int(np.searchsorted(angles, width_rad, side="right"))
    out = forward.copy()
    if lower >= n_steps - 2:
        return out

    for c in range(n_comp):
        for e in range(n_entries):
            vals = forward[c, e]
            gauss_panels = 0.5 * (gauss[:-1] + gauss[1:]) * d_mu
            orig_panels = 0.5 * (vals[:-1] + vals[1:]) * d_mu
            # integral_gauss(t) = integral of gauss over panels [0, t);
            # integral_orig(t) = integral of original over panels [t, end).
            cg = np.concatenate(([0.0], np.cumsum(gauss_panels)))
            co_total = orig_panels.sum()
            co = co_total - np.concatenate(([0.0], np.cumsum(orig_panels)))
            t = np.arange(lower, n_steps - 1)
            with np.errstate(divide="ignore", invalid="ignore"):
                p0 = np.where(co[t] >= 2.0, 1.0 / cg[t], (2.0 - co[t]) / cg[t])
            d = p0 * gauss[t] - vals[t]
            sign_change = np.nonzero(d[:-1] * d[1:] < 0.0)[0]
            if sign_change.size == 0:
                continue  # no root: keep the original (reference :1950, :1969)
            ti = t[sign_change[0]]
            p0_t = p0[sign_change[0]]
            out[c, e, : ti + 1] = p0_t * gauss[: ti + 1]
    return out.astype(np.float32)
