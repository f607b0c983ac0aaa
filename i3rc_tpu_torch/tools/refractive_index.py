# Copy of i3rc_tpu/tools/refractive_index.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""Complex refractive index of water and ice vs wavelength and temperature.

Re-implements Tools/RefractiveIndex-IceAndWater.f (REFWAT :3, REFICE :430)
in vectorized NumPy.  Data tables (Hale & Querry 1972; Palmer & Williams
1974; Downing & Williams 1975; Ray 1972; Warren 1984) are extracted from the
reference's DATA statements by scripts/extract_refractive_data.py and
vendored as data/refractive_index.npz.

Semantics preserved exactly:
  * water: linear interpolation in wavelength up to 1000 um; beyond that the
    Ray (1972) Debye model with Cole-Cole spread, Saxton conductivity, and
    the three IR absorption-band corrections (REFWAT :340-418);
  * ice: linear in log(wavelength) for the real part and log-log for the
    imaginary part up to 167 um; beyond that additionally linear in
    temperature between the four Warren reference temperatures
    (REFICE :855-910).

Returns (n_real, n_imag) with n_imag >= 0 (absorption), i.e. the refractive
index is n_real - i * n_imag in the exp(-i w t) convention, matching the
RINDEX = CMPLX(MRE, -MIM) usage in MakeMieTable.f95:459.
"""

from __future__ import annotations

import os

import numpy as np

# The tables ship with the JAX package; they are read by path (data, not
# code).
DATA_PATH = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                                          "i3rc_tpu", "tools", "data", "refractive_index.npz"))
_DATA = np.load(DATA_PATH)

WATER_RANGE_UM = (0.2, 1.0e5)
ICE_RANGE_UM = (0.045, 8.6e6)


def refwat(wavelength_um, temperature_k=283.0):
    """Water complex index of refraction; vectorized over wavelength (um)."""
    wl = np.atleast_1d(np.asarray(wavelength_um, dtype=np.float64))
    if np.any((wl < WATER_RANGE_UM[0]) | (wl > WATER_RANGE_UM[1])):
        raise ValueError("refwat: wavelength outside 0.2 um - 10 cm")
    wtab = _DATA["water_wavelength"]
    rn = np.interp(wl, wtab, _DATA["water_real"])
    cn = np.interp(wl, wtab, _DATA["water_imag"])

    microwave = wl > 1000.0
    if np.any(microwave):
        rn_mw, cn_mw = _water_debye(wl[microwave], temperature_k)
        rn = _scatter_into(rn, microwave, rn_mw)
        cn = _scatter_into(cn, microwave, cn_mw)
    return rn, cn


def _scatter_into(base, mask, values):
    out = base.copy()
    out[mask] = values
    return out


def _water_debye(wl_um, t_k):
    """Ray (1972) Debye-region water dielectric model (REFWAT :345-418)."""
    tc = t_k - 273.15
    t1 = tc + 273.0
    t2 = tc - 25.0
    xl = wl_um / 10000.0  # cm
    sigma = 12.5664e8
    alpha = -16.8129 / t1 + 0.0609265
    es = 78.54 * (1.0 - 4.579e-3 * t2 + 1.19e-5 * t2**2 - 2.8e-8 * t2**3)
    e00 = 5.27137 + 0.0216474 * tc - 0.00131198 * tc**2
    lam_s = 0.00033836 * np.exp(2513.98 / t1)
    term = np.pi * alpha / 2
    sint, cost = np.sin(term), np.cos(term)
    xlrat = lam_s / xl
    powtrm = xlrat ** (1 - alpha)
    denom = 1.0 + 2 * powtrm * sint + xlrat ** (2 * (1 - alpha))
    er = e00 + (es - e00) * (1.0 + powtrm * sint) / denom
    ei = sigma * xl / 18.8496e10 + (es - e00) * powtrm * cost / denom
    m = np.sqrt(er - 1j * ei)
    rn = m.real
    cn = -m.imag

    # IR band corrections, Ray Eqn 8 / Table 2 (applied below 3000 um).
    def band(wl, center, beta, delta, gamma):
        return beta * np.exp(-np.abs(np.log10(wl / center) / delta) ** gamma)

    corr = np.where(wl_um <= 3000.0,
                    band(wl_um, 17.0, 0.39, 0.45, 1.3)
                    + band(wl_um, 62.0, 0.41, 0.35, 1.7)
                    + band(wl_um, 300.0, 0.25, 0.47, 3.0), 0.0)
    return rn, cn + corr


def refice(wavelength_um, temperature_k=243.0):
    """Ice complex index of refraction; vectorized over wavelength (um)."""
    wl = np.atleast_1d(np.asarray(wavelength_um, dtype=np.float64))
    if np.any((wl < ICE_RANGE_UM[0]) | (wl > ICE_RANGE_UM[1])):
        raise ValueError("refice: wavelength outside 0.045 um - 8.6 m")
    logwl = np.log(wl)
    wtab = _DATA["ice_wavelength"]
    rn = np.interp(logwl, np.log(wtab), _DATA["ice_real"])
    cn = np.exp(np.interp(logwl, np.log(wtab), np.log(np.abs(_DATA["ice_imag"]))))

    microwave = wl > 167.0
    if np.any(microwave):
        temref = _DATA["ice_temperatures"]  # descending: 272.16 ... 213.16
        tk = float(np.clip(temperature_k, temref[3], temref[0]))
        # Bracketing reference temperatures (REFICE :878-884).
        i = 1
        while i < 4 and tk < temref[i]:
            i += 1
        lt1, lt2 = i, i - 1  # tk in [temref[lt1], temref[lt2]]
        frac = (tk - temref[lt1]) / (temref[lt2] - temref[lt1])
        lw = np.log(wl[microwave])
        lwt = np.log(_DATA["ice_wavelength_t"])
        ret = _DATA["ice_real_t"]
        imt = np.log(np.abs(_DATA["ice_imag_t"]))
        r_lo = np.interp(lw, lwt, ret[:, lt1])
        r_hi = np.interp(lw, lwt, ret[:, lt2])
        c_lo = np.interp(lw, lwt, imt[:, lt1])
        c_hi = np.interp(lw, lwt, imt[:, lt2])
        rn = _scatter_into(rn, microwave, r_lo + frac * (r_hi - r_lo))
        cn = _scatter_into(cn, microwave, np.exp(c_lo + frac * (c_hi - c_lo)))
    return rn, cn


def refractive_index(particle_type: str, wavelength_um, temperature_k=None):
    """Dispatch by particle type ('W' water / 'I' ice); returns (n_re, n_im)."""
    p = particle_type.upper()
    if p == "W":
        return refwat(wavelength_um, temperature_k if temperature_k else 283.0)
    if p == "I":
        return refice(wavelength_um, temperature_k if temperature_k else 243.0)
    raise ValueError(f"refractive_index: unknown particle type '{particle_type}'")
