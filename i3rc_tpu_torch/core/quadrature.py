# Copy of i3rc_tpu/core/quadrature.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""Numeric utilities: Legendre polynomials, quadrature rules, table search.

Re-implements Code/numericUtilities.f95 (computeLobattoTerms :15-102,
computeGaussLegendreTerms :104-173, computeLegendrePolynomials :175-193,
findIndex :195-248) in vectorized float64 NumPy.  These run at setup time
(table construction), so they favor accuracy over device residency; the hot
path never calls them.

Design notes vs the reference:
  * The Newton iterations for quadrature nodes are vectorized over all roots
    at once instead of the reference's masked elementwise loop.
  * findIndex's hunt+bisect becomes ``np.searchsorted`` (same contract:
    table[i] <= value < table[i+1], clipped to valid interior indices).
"""

from __future__ import annotations

import numpy as np


def legendre_polynomials(max_l: int, mus: np.ndarray) -> np.ndarray:
    """Values of Legendre polynomials P_0..P_maxL at each mu.

    Returns array of shape (max_l + 1, len(mus)).
    Mirrors numericUtilities.f95:175-193 (upward recursion).
    """
    mus = np.asarray(mus, dtype=np.float64)
    out = np.empty((max_l + 1, mus.size), dtype=np.float64)
    out[0] = 1.0
    if max_l >= 1:
        out[1] = mus
    for l in range(1, max_l):
        out[l + 1] = ((2 * l + 1) * mus * out[l] - l * out[l - 1]) / (l + 1)
    return out


def gauss_legendre(n_terms: int):
    """Gauss-Legendre nodes and weights on (-1, 1).

    Vectorized Newton iteration on P_n from the Tricomi initial guess
    cos(pi (k - 1/4) / (n + 1/2)) — the same scheme as the reference
    (numericUtilities.f95:104-173) but iterating all roots at once; O(n^2),
    usable for the tens of thousands of nodes Mie-scale series need.
    Returns (mus ascending, weights).
    """
    n = int(n_terms)
    k = np.arange(1, n + 1, dtype=np.float64)
    x = np.cos(np.pi * (k - 0.25) / (n + 0.5))
    for _ in range(100):
        pn, pn1 = _legendre_last_two(n, x)
        dp = n * (x * pn - pn1) / (x**2 - 1.0)
        delta = pn / dp
        x = x - delta
        if np.all(np.abs(delta) <= 4.0 * np.spacing(np.abs(x) + 1e-3)):
            break
    pn, pn1 = _legendre_last_two(n, x)
    dp = n * (x * pn - pn1) / (x**2 - 1.0)
    weights = 2.0 / ((1.0 - x**2) * dp**2)
    return x[::-1].copy(), weights[::-1].copy()


def _legendre_last_two(m: int, x: np.ndarray):
    """(P_m(x), P_{m-1}(x)) by upward recursion without storing all orders."""
    pm1 = np.ones_like(x)   # P_0
    pm = x.copy()           # P_1
    for l in range(1, m):
        pm, pm1 = ((2 * l + 1) * x * pm - l * pm1) / (l + 1), pm
    return pm, pm1


def lobatto(n_terms: int):
    """Gauss-Lobatto nodes and weights on [-1, 1] (endpoints included).

    For n-point quadrature the interior nodes are the roots of P'_{n-1};
    weights are 2/(n(n-1) P_{n-1}(x)^2), endpoint weight 2/(n(n-1)).
    Mirrors numericUtilities.f95:15-102 (Newton iteration on P'), with
    initial guesses from the interlacing of P_{n-1}'s extrema with its
    Gauss-Legendre roots; O(n^2) total, usable for the thousands of nodes
    Mie-scale Legendre series need.  Returns (mus ascending, weights).
    """
    n = int(n_terms)
    if n < 2:
        raise ValueError("Lobatto quadrature needs at least 2 points")
    if n == 2:
        return np.array([-1.0, 1.0]), np.array([1.0, 1.0])
    m = n - 1
    gl_roots, _ = gauss_legendre(m)
    interior = 0.5 * (gl_roots[1:] + gl_roots[:-1])  # extrema interlace the roots
    for _ in range(50):
        pm, pm1 = _legendre_last_two(m, interior)
        dp = m * (interior * pm - pm1) / (interior**2 - 1.0)
        d2p = (2.0 * interior * dp - m * (m + 1) * pm) / (1.0 - interior**2)
        delta = dp / d2p
        interior = interior - delta
        if np.all(np.abs(delta) <= 4.0 * np.spacing(np.abs(interior))):
            break
    mus = np.concatenate(([-1.0], interior, [1.0]))
    pn1, _ = _legendre_last_two(m, mus)
    weights = 2.0 / (n * m * pn1**2)
    weights[0] = weights[-1] = 2.0 / (n * m)
    return mus, weights


def find_index(values, table):
    """Index i such that table[i] <= value < table[i+1] (0-based).

    Vectorized analog of numericUtilities.f95:195-248 (findIndex).  The
    reference clamps to [1, size-1] in 1-based indexing; here the result is
    clipped to [0, len(table) - 2] so the interval (i, i+1) is always valid.
    """
    table = np.asarray(table)
    idx = np.searchsorted(table, values, side="right") - 1
    return np.clip(idx, 0, table.size - 2)
