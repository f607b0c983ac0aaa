# Copy of i3rc_tpu/core/phase_functions.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""Scattering phase functions and tables.

Re-implements Code/scatteringPhaseFunctions.f95 (1,347 lines) as two frozen
dataclasses.  A phase function is stored either as Legendre expansion
coefficients (starting at P1; P0 == 1 is implied) or as angle-value pairs
(angles ascending over [0, pi], values normalized so the integral of P dmu
over [-1, 1] equals 2).  A table is an ordered collection keyed by a real
value (e.g. effective radius) with per-entry extinction and single-scattering
albedo — the file currency between the Mie tool, the domain objects, and the
integrator.

All math here is setup-time, vectorized float64 NumPy; the integrator bakes
tables into float32 device arrays (integrators/tables.py).

Reference parity notes:
  * Construction from moments warns if the expansion goes negative on an
    1801-point grid (scatteringPhaseFunctions.f95:210-223).
  * Tabulated values are renormalized at construction
    (normalizePhaseFunction, :1329-1345).
  * Evaluation synthesizes sum((2l+1) xi_l P_l(cos theta)) for Legendre
    storage (:478-496) and interpolates linearly in cos(theta) for tabulated
    storage (:497-526).
  * Legendre projection of tabulated functions uses Lobatto quadrature
    (:650-717).  The reference omits the quadrature weights in its matmul
    (an apparent defect); we apply them, which makes round-trip
    moments->values->moments exact to quadrature accuracy.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from i3rc_tpu_torch.core.quadrature import find_index, legendre_polynomials, lobatto
from i3rc_tpu_torch.utils.errors import Status

MIN_SCATTERING_ANGLE = 0.0
MAX_SCATTERING_ANGLE = np.pi
_NEGATIVITY_TEST_STEPS = 1801  # scatteringPhaseFunctions.f95:172


def _validate_ext_ssa(s: Status, extinction, single_scattering_albedo) -> None:
    s.fail_if(extinction < 0.0, "negative extinction supplied")
    s.fail_if(not (0.0 <= single_scattering_albedo <= 1.0),
              "single scattering albedo out of bounds")


def henyey_greenstein_coefficients(g: float, n_coefficients: int) -> np.ndarray:
    """HG moments xi_l = g**l for l = 1..n (planeParallel.f95:339-340)."""
    return np.asarray(g, dtype=np.float64) ** np.arange(1, n_coefficients + 1)


def henyey_greenstein_values(g: float, angles: np.ndarray) -> np.ndarray:
    """HG phase function values (1-g^2)/(1+g^2-2g cos)**1.5 (planeParallel.f95:351)."""
    return (1.0 - g * g) / (1.0 + g * g - 2.0 * g * np.cos(angles)) ** 1.5


def normalize_phase_function(angles: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Scale values so trapezoid integral of P dmu equals 2.

    Mirrors scatteringPhaseFunctions.f95:1329-1345 (integral taken in the
    cosine of the scattering angle).
    """
    mus = np.cos(angles)
    integral = -np.sum((mus[1:] - mus[:-1]) * 0.5 * (values[..., 1:] + values[..., :-1]), axis=-1)
    return values * 2.0 / integral[..., None]


@dataclass(frozen=True)
class PhaseFunction:
    """One scattering phase function in either representation.

    Exactly one of (legendre_coefficients) or (scattering_angle, value) is
    set; mirrors type phaseFunction, scatteringPhaseFunctions.f95:34-46.
    """

    legendre_coefficients: np.ndarray | None = None
    scattering_angle: np.ndarray | None = None
    value: np.ndarray | None = None
    extinction: float = 0.0
    single_scattering_albedo: float = 0.0
    description: str = ""

    # --- constructors -----------------------------------------------------
    @staticmethod
    def from_legendre(coefficients, extinction=0.0, single_scattering_albedo=0.0,
                      description="") -> "PhaseFunction":
        """Construct from Legendre moments xi_1.. (P0 == 1 implied).

        Mirrors newPhaseFunctionExpansion (scatteringPhaseFunctions.f95:164-225).
        """
        coefficients = np.atleast_1d(np.asarray(coefficients, dtype=np.float64))
        s = Status()
        if coefficients.size >= 1:
            s.fail_if(not (-1.0 <= coefficients[0] <= 1.0),
                      "asymmetry parameter (first moment) out of bounds")
        _validate_ext_ssa(s, extinction, single_scattering_albedo)
        s.check("PhaseFunction.from_legendre")
        pf = PhaseFunction(legendre_coefficients=coefficients, extinction=float(extinction),
                           single_scattering_albedo=float(single_scattering_albedo),
                           description=description)
        # Negativity sanity check on a fine expansion (reference :210-223).
        test_angles = np.linspace(0.0, np.pi, _NEGATIVITY_TEST_STEPS)
        test_values = pf.values(test_angles)
        s2 = Status()
        frac_negative = np.count_nonzero(test_values < 0.0) / test_values.size
        s2.warn_if(frac_negative > 0,
                   f"phase function coefficients give {100 * frac_negative:.0f}% "
                   "negative phase function values")
        s2.check("PhaseFunction.from_legendre")
        return pf

    @staticmethod
    def from_tabulated(scattering_angle, value, extinction=0.0,
                       single_scattering_albedo=0.0, description="") -> "PhaseFunction":
        """Construct from angle-value pairs; values are renormalized.

        Mirrors newPhaseFunctionTabulated (scatteringPhaseFunctions.f95:102-162).
        """
        scattering_angle = np.asarray(scattering_angle, dtype=np.float64)
        value = np.asarray(value, dtype=np.float64)
        s = Status()
        s.fail_if(scattering_angle.ndim != 1 or scattering_angle.size < 2,
                  "need at least two scattering angles")
        if scattering_angle.size >= 2:
            s.fail_if(bool(np.any(scattering_angle < MIN_SCATTERING_ANGLE)
                           | np.any(scattering_angle > MAX_SCATTERING_ANGLE + 1e-6)),
                      "scattering angle out of bounds")
            s.fail_if(abs(scattering_angle[0] - MIN_SCATTERING_ANGLE) > 1e-6,
                      "first scattering angle must be 0")
            s.fail_if(abs(scattering_angle[-1] - MAX_SCATTERING_ANGLE) > 1e-6,
                      "last scattering angle must be pi")
            s.fail_if(bool(np.any(np.diff(scattering_angle) <= 0.0)),
                      "scattering angles must be increasing and unique")
        s.fail_if(bool(np.any(value < 0.0)), "negative phase function values supplied")
        s.fail_if(scattering_angle.shape != value.shape,
                  "angle and value arrays must be the same length")
        _validate_ext_ssa(s, extinction, single_scattering_albedo)
        s.check("PhaseFunction.from_tabulated")
        return PhaseFunction(scattering_angle=scattering_angle,
                             value=normalize_phase_function(scattering_angle, value),
                             extinction=float(extinction),
                             single_scattering_albedo=float(single_scattering_albedo),
                             description=description)

    # --- representation queries -------------------------------------------
    @property
    def stored_as_legendre(self) -> bool:
        return self.legendre_coefficients is not None

    @property
    def stored_as_tabulated(self) -> bool:
        return self.value is not None

    @property
    def n_moments(self) -> int:
        return 0 if self.legendre_coefficients is None else self.legendre_coefficients.size

    @property
    def n_angles(self) -> int:
        return 0 if self.scattering_angle is None else self.scattering_angle.size

    # --- evaluation ---------------------------------------------------------
    def values(self, angles: np.ndarray) -> np.ndarray:
        """Phase function value at each scattering angle (radians).

        Mirrors getPhaseFunctionValues_one (scatteringPhaseFunctions.f95:446-529).
        """
        angles = np.asarray(angles, dtype=np.float64)
        if self.stored_as_legendre:
            max_l = self.n_moments
            if max_l == 0:
                return np.full(angles.shape, 0.5)  # isotropic: P0 only (:484-489)
            # Synthesis sum_l (2l+1) xi_l P_l(mu) accumulated with the two-term
            # recursion (no (max_l, n_angles) intermediate for Mie-scale series).
            mu = np.cos(angles.ravel())
            pm1 = np.ones_like(mu)
            pm = mu.copy()
            acc = pm1 + 3.0 * self.legendre_coefficients[0] * pm
            for l in range(1, max_l):
                pm, pm1 = ((2 * l + 1) * mu * pm - l * pm1) / (l + 1), pm
                acc += (2 * l + 3) * self.legendre_coefficients[l] * pm
            return acc.reshape(angles.shape)
        # Tabulated: interpolate linearly in cos(theta) (:497-526).
        native_mu = np.cos(self.scattering_angle)
        idx = find_index(angles.ravel(), self.scattering_angle)
        mu = np.cos(angles.ravel())
        d_mu = native_mu[idx + 1] - native_mu[idx]
        with np.errstate(divide="ignore", invalid="ignore"):
            w = 1.0 - (mu - native_mu[idx]) / d_mu
        w = np.where(np.abs(d_mu) < 1e-300, 1.0, w)
        out = w * self.value[idx] + (1.0 - w) * self.value[idx + 1]
        return out.reshape(angles.shape)

    def legendre_projection(self, max_l: int) -> np.ndarray:
        """Legendre moments xi_1..xi_maxL of this phase function.

        Mirrors getPhaseFunctionCoefficients (scatteringPhaseFunctions.f95:650-717):
        Lobatto quadrature at 2x the native angle count.  Unlike the reference
        we include the quadrature weights (see module docstring).
        """
        if self.stored_as_legendre:
            out = np.zeros(max_l)
            n = min(max_l, self.n_moments)
            out[:n] = self.legendre_coefficients[:n]
            return out
        n_nodes = max(2 * self.n_angles, max_l + 2)
        mus, weights = lobatto(n_nodes)
        p = legendre_polynomials(max_l, mus)
        vals = self.values(np.arccos(np.clip(mus, -1.0, 1.0)))
        return 0.5 * (p[1:] * weights) @ vals

    def with_optical(self, extinction=None, single_scattering_albedo=None) -> "PhaseFunction":
        kwargs = {}
        if extinction is not None:
            kwargs["extinction"] = float(extinction)
        if single_scattering_albedo is not None:
            kwargs["single_scattering_albedo"] = float(single_scattering_albedo)
        return replace(self, **kwargs)


@dataclass(frozen=True)
class PhaseFunctionTable:
    """Ordered set of phase functions keyed by a real value.

    Mirrors type phaseFunctionTable (scatteringPhaseFunctions.f95:48-58).
    """

    phase_functions: tuple = field(default_factory=tuple)
    key: np.ndarray = field(default_factory=lambda: np.zeros(0))
    description: str = ""

    @staticmethod
    def from_phase_functions(phase_functions, key, description="") -> "PhaseFunctionTable":
        """General constructor (newPhaseFunctionTableGeneral, :339-385)."""
        key = np.asarray(key, dtype=np.float64)
        s = Status()
        s.fail_if(key.size != len(phase_functions),
                  "number of phase functions and key values must match")
        s.fail_if(key.size > 1 and bool(np.any(np.diff(key) <= 0.0)),
                  "key values must be unique and increasing")
        s.check("PhaseFunctionTable")
        return PhaseFunctionTable(tuple(phase_functions), key, description)

    @staticmethod
    def from_tabulated(scattering_angle, values, key, extinction=None,
                       single_scattering_albedo=None, description="") -> "PhaseFunctionTable":
        """Shared-angle-grid constructor (newPhaseFunctionTableTabulated, :227-337).

        ``values`` has shape (n_angles, n_entries).
        """
        values = np.asarray(values, dtype=np.float64)
        n_entries = values.shape[1]
        ext = np.zeros(n_entries) if extinction is None else np.asarray(extinction, dtype=np.float64)
        ssa = np.zeros(n_entries) if single_scattering_albedo is None else np.asarray(
            single_scattering_albedo, dtype=np.float64)
        pfs = [
            PhaseFunction.from_tabulated(scattering_angle, values[:, i],
                                         extinction=ext[i], single_scattering_albedo=ssa[i])
            for i in range(n_entries)
        ]
        return PhaseFunctionTable.from_phase_functions(pfs, key, description)

    @property
    def n_entries(self) -> int:
        return len(self.phase_functions)

    @property
    def extinctions(self) -> np.ndarray:
        return np.array([p.extinction for p in self.phase_functions])

    @property
    def single_scattering_albedos(self) -> np.ndarray:
        return np.array([p.single_scattering_albedo for p in self.phase_functions])

    def values(self, angles: np.ndarray) -> np.ndarray:
        """Evaluate every entry: returns (n_angles, n_entries).

        Mirrors getPhaseFunctionValues_table (scatteringPhaseFunctions.f95:531-648).
        """
        angles = np.asarray(angles, dtype=np.float64)
        return np.stack([p.values(angles) for p in self.phase_functions], axis=-1)

    def element(self, i: int) -> PhaseFunction:
        """getElement analog (0-based)."""
        return self.phase_functions[i]
