# Copy of i3rc_tpu/core/phase_matrices.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""Polarized scattering: phase matrices and tables.

The reference's Wishlist (Wishlist.txt:20-31) asks for polarized radiative
transfer built from "a polarized extension of the phaseFunction and
phaseFunctionTable objects" — this module is that extension.  A
:class:`PhaseMatrix` stores the six independent elements of the scattering
matrix of a macroscopically isotropic, mirror-symmetric medium (randomly
oriented particles with a plane of symmetry — Hovenier's standard form,
which covers Rayleigh, spheres/Mie, and averaged aspherical ensembles):

    M(theta) = | a1  b1   0   0 |        a1 = P11   b1 = P12
               | b1  a2   0   0 |        a2 = P22   b2 = P34
               |  0   0  a3  b2 |        a3 = P33
               |  0   0 -b2  a4 |        a4 = P44

acting on Stokes vectors (I, Q, U, V) defined with respect to the
SCATTERING plane, Q > 0 meaning polarization parallel to the plane
(Bohren & Huffman sec. 3.3 / Hansen & Travis 1974 convention).  Elements
are tabulated on an ascending scattering-angle grid over [0, pi] and
normalized so that the integral of a1 over the sphere is 4 pi (i.e.
integral of a1 d(mu) = 2, the same normalization as PhaseFunction).

The scalar machinery is reused, not duplicated: ``scalar`` returns the
P11 element as a :class:`PhaseFunction` (the transport kernel samples
scattering angles from it and corrects the polarized intensity by a
Stokes weight — see integrators/polarized.py), and
:class:`PhaseMatrixTable` mirrors :class:`PhaseFunctionTable` so domains
accept either kind (core/optics.py validates through the common
``n_entries`` surface).

All math is setup-time float64 NumPy; the polarized integrator bakes
float32 device tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from i3rc_tpu_torch.core.phase_functions import (
    MAX_SCATTERING_ANGLE,
    MIN_SCATTERING_ANGLE,
    PhaseFunction,
    PhaseFunctionTable,
)
from i3rc_tpu_torch.utils.errors import Status


def rayleigh_matrix_values(angles: np.ndarray, depolarization: float = 0.0):
    """The six Rayleigh phase-matrix elements at each angle.

    Hansen & Travis (1974) eq. 2.15 with depolarization factor ``delta``:
    Delta = (1 - delta) / (1 + delta / 2), Delta' = (1 - 2 delta)/(1 - delta).
    Returns dict of a1, b1, a2, a3, a4, b2 (b2 identically zero).  With
    delta = 0 scattering at 90 degrees is 100% polarized perpendicular to
    the scattering plane (b1/a1 = -1), the classic single-scattering limit
    the tests pin.
    """
    d = float(depolarization)
    if not 0.0 <= d < 0.5:
        raise ValueError("depolarization factor must be in [0, 0.5)")
    big_delta = (1.0 - d) / (1.0 + d / 2.0)
    big_delta_p = (1.0 - 2.0 * d) / (1.0 - d) if d != 1.0 else 0.0
    mu = np.cos(np.asarray(angles, dtype=np.float64))
    a1 = big_delta * 0.75 * (1.0 + mu * mu) + (1.0 - big_delta)
    b1 = -big_delta * 0.75 * (1.0 - mu * mu)
    a2 = big_delta * 0.75 * (1.0 + mu * mu)
    a3 = big_delta * 1.5 * mu
    a4 = big_delta * big_delta_p * 1.5 * mu
    b2 = np.zeros_like(mu)
    return {"a1": a1, "b1": b1, "a2": a2, "a3": a3, "a4": a4, "b2": b2}


@dataclass(frozen=True)
class PhaseMatrix:
    """One scattering phase matrix, tabulated on an angle grid.

    ``a1`` is normalized like a phase function (integral over mu = 2); the
    other elements share its absolute scale.  ``extinction`` and
    ``single_scattering_albedo`` ride along exactly as on PhaseFunction.
    """

    scattering_angle: np.ndarray
    a1: np.ndarray
    b1: np.ndarray
    a2: np.ndarray
    a3: np.ndarray
    a4: np.ndarray
    b2: np.ndarray
    extinction: float = 0.0
    single_scattering_albedo: float = 0.0
    description: str = ""

    # --- constructors -----------------------------------------------------
    @staticmethod
    def from_elements(scattering_angle, a1, b1, a3, b2=None, a2=None,
                      a4=None, extinction=0.0, single_scattering_albedo=0.0,
                      description="") -> "PhaseMatrix":
        """Build from tabulated elements; a1 is renormalized (all elements
        scale together so the ratios — the physics — are preserved).

        Spherical-particle defaults: a2 = a1, a4 = a3, b2 = 0.
        """
        angle = np.asarray(scattering_angle, dtype=np.float64)
        a1 = np.asarray(a1, dtype=np.float64)
        s = Status()
        s.fail_if(angle.ndim != 1 or angle.size < 2,
                  "need at least two scattering angles")
        if angle.size >= 2:
            s.fail_if(abs(angle[0] - MIN_SCATTERING_ANGLE) > 1e-6,
                      "first scattering angle must be 0")
            s.fail_if(abs(angle[-1] - MAX_SCATTERING_ANGLE) > 1e-6,
                      "last scattering angle must be pi")
            s.fail_if(bool(np.any(np.diff(angle) <= 0.0)),
                      "scattering angles must be increasing and unique")
        s.fail_if(bool(np.any(a1 < 0.0)), "negative a1 (P11) values supplied")
        elems = {"a1": a1}
        elems["b1"] = np.asarray(b1, dtype=np.float64)
        elems["a3"] = np.asarray(a3, dtype=np.float64)
        elems["b2"] = (np.zeros_like(a1) if b2 is None
                       else np.asarray(b2, dtype=np.float64))
        elems["a2"] = a1.copy() if a2 is None else np.asarray(a2, dtype=np.float64)
        elems["a4"] = (elems["a3"].copy() if a4 is None
                       else np.asarray(a4, dtype=np.float64))
        for name, e in elems.items():
            s.fail_if(e.shape != angle.shape,
                      f"element {name} and angle arrays must be the same length")
        # |b1| <= a1 etc.: any physical scattering matrix satisfies these
        # (Hovenier & van der Mee inequalities); violations mean a data bug.
        tol = 1e-9 + 1e-9 * np.abs(a1)
        for name in ("b1", "a2", "a3", "a4", "b2"):
            s.fail_if(bool(np.any(np.abs(elems[name]) > a1 + tol)),
                      f"element {name} exceeds a1 somewhere: unphysical matrix")
        s.check("PhaseMatrix.from_elements")
        # Renormalize via the P11 machinery, scaling every element alike.
        mus = np.cos(angle)
        integral = -np.sum((mus[1:] - mus[:-1]) * 0.5 * (a1[1:] + a1[:-1]))
        scale = 2.0 / integral
        return PhaseMatrix(
            scattering_angle=angle,
            a1=a1 * scale, b1=elems["b1"] * scale, a2=elems["a2"] * scale,
            a3=elems["a3"] * scale, a4=elems["a4"] * scale,
            b2=elems["b2"] * scale,
            extinction=float(extinction),
            single_scattering_albedo=float(single_scattering_albedo),
            description=description)

    @staticmethod
    def rayleigh(depolarization: float = 0.0, n_angles: int = 181,
                 extinction: float = 0.0, single_scattering_albedo: float = 1.0,
                 description: str = "") -> "PhaseMatrix":
        """Analytic Rayleigh matrix (Hansen & Travis 1974 eq. 2.15)."""
        angles = np.linspace(0.0, np.pi, int(n_angles))
        e = rayleigh_matrix_values(angles, depolarization)
        return PhaseMatrix.from_elements(
            angles, e["a1"], e["b1"], e["a3"], b2=e["b2"], a2=e["a2"],
            a4=e["a4"], extinction=extinction,
            single_scattering_albedo=single_scattering_albedo,
            description=description or f"Rayleigh (delta={depolarization})")

    @staticmethod
    def from_mie(wavelength: float, refractive_index: complex, radius: float,
                 n_angles: int = 721, description: str = "") -> "PhaseMatrix":
        """Single-sphere Mie phase matrix from the amplitude functions.

        Bohren & Huffman sec. 4.4.4: S11 = (|S2|^2 + |S1|^2)/2,
        S12 = (|S2|^2 - |S1|^2)/2, S33 = Re(S2 S1*), S34 = Im(S2 S1*);
        spheres have S22 = S11 and S44 = S33.  Extinction and ssa come from
        the Mie cross-sections (per-particle, um^2 — same convention as
        tools/mie.mie_one).
        """
        from i3rc_tpu_torch.tools.mie import (
            mie_amplitudes,
            mie_coefficients,
            mie_cross_sections,
        )

        x = 2.0 * np.pi * radius / wavelength
        a, b = mie_coefficients(x, complex(refractive_index))
        qext, qscat = mie_cross_sections(x, a, b)
        geom = np.pi * radius ** 2
        angles = np.linspace(0.0, np.pi, int(n_angles))
        s1, s2 = mie_amplitudes(a, b, np.cos(angles))
        p11 = 0.5 * (np.abs(s2) ** 2 + np.abs(s1) ** 2)
        p12 = 0.5 * (np.abs(s2) ** 2 - np.abs(s1) ** 2)
        cross = s2 * np.conj(s1)
        return PhaseMatrix.from_elements(
            angles, p11, p12, np.real(cross), b2=np.imag(cross),
            extinction=geom * qext,
            single_scattering_albedo=float(qscat / qext) if qext > 0 else 0.0,
            description=description
            or f"Mie sphere r={radius} lambda={wavelength}")

    # --- queries ----------------------------------------------------------
    @property
    def n_angles(self) -> int:
        return self.scattering_angle.size

    @property
    def scalar(self) -> PhaseFunction:
        """The P11 element as a PhaseFunction (scattering-angle sampling)."""
        return PhaseFunction.from_tabulated(
            self.scattering_angle, self.a1, extinction=self.extinction,
            single_scattering_albedo=self.single_scattering_albedo,
            description=self.description)

    def values(self, angles: np.ndarray) -> dict:
        """All six elements linearly interpolated in cos(theta) at angles."""
        angles = np.asarray(angles, dtype=np.float64)
        native_mu = np.cos(self.scattering_angle)  # descending in angle
        mu = np.cos(angles)
        out = {}
        for name in ("a1", "b1", "a2", "a3", "a4", "b2"):
            # np.interp needs ascending x: native_mu is descending.
            out[name] = np.interp(mu, native_mu[::-1],
                                  getattr(self, name)[::-1])
        return out

    def degree_of_polarization(self, angles: np.ndarray) -> np.ndarray:
        """Single-scattering linear DoP of unpolarized light: -b1/a1."""
        v = self.values(angles)
        return -v["b1"] / np.maximum(v["a1"], 1e-300)


@dataclass(frozen=True)
class PhaseMatrixTable:
    """Ordered set of phase matrices keyed by a real value.

    The polarized analog of PhaseFunctionTable (the Wishlist's
    "phaseFunctionTable extension"); exposes the same ``n_entries`` /
    ``extinctions`` / ``single_scattering_albedos`` surface so
    Domain.add_component accepts either kind, plus ``scalar`` for the
    scalar integrators (they transport P11 and ignore polarization).
    """

    phase_matrices: tuple = field(default_factory=tuple)
    key: np.ndarray = field(default_factory=lambda: np.zeros(0))
    description: str = ""

    @staticmethod
    def from_phase_matrices(phase_matrices, key,
                            description="") -> "PhaseMatrixTable":
        key = np.asarray(key, dtype=np.float64)
        s = Status()
        s.fail_if(key.size != len(phase_matrices),
                  "number of phase matrices and key values must match")
        s.fail_if(key.size > 1 and bool(np.any(np.diff(key) <= 0.0)),
                  "key values must be unique and increasing")
        s.check("PhaseMatrixTable")
        return PhaseMatrixTable(tuple(phase_matrices), key, description)

    @property
    def n_entries(self) -> int:
        return len(self.phase_matrices)

    @property
    def extinctions(self) -> np.ndarray:
        return np.array([p.extinction for p in self.phase_matrices])

    @property
    def single_scattering_albedos(self) -> np.ndarray:
        return np.array([p.single_scattering_albedo for p in self.phase_matrices])

    @property
    def scalar(self) -> PhaseFunctionTable:
        """P11-only table for the scalar transport kernels."""
        return PhaseFunctionTable.from_phase_functions(
            [m.scalar for m in self.phase_matrices], self.key,
            description=self.description)

    def element(self, i: int) -> PhaseMatrix:
        return self.phase_matrices[i]
