# Copy of i3rc_tpu/tools/optical_to_domain.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""SHDOM-style optical-properties file -> domain converter.

Re-implements Tools/OpticalPropertiesToDomain.f95: reads the tabulated-
phase-function ASCII property file ("T" header, grid dims, spacings +
z levels, phase functions as Legendre chi_l = (2l+1) xi_l series, then one
line per cell with indices/temperature/extinction/albedo/phase index) and
writes a single-"mixture"-component domain.  The chi -> xi conversion
divides by (2l+1) (OpticalPropertiesToDomain.f95:168-175).
"""

from __future__ import annotations

import sys

import numpy as np

from i3rc_tpu_torch.core.optics import Domain
from i3rc_tpu_torch.core.phase_functions import PhaseFunction, PhaseFunctionTable
from i3rc_tpu_torch.utils.errors import ValidationError


def read_shdom_property_file(path):
    """Parse the property file; returns a dict of fields."""
    with open(path) as f:
        text = f.read()
    first_newline = text.find("\n")
    if not text[:first_newline].strip().upper().startswith("T"):
        raise ValidationError(
            "this doesn't look like a tabulated phase function property file")
    # Numeric token stream after the first line (list-directed reads span
    # lines), Fortran D exponents accepted (the Python fallback of the JAX
    # package's native parser, i3rc_tpu/native/fastparse.py).
    numbers = np.array([float(t.replace("D", "e").replace("d", "e"))
                        for t in text[first_newline + 1:].split()], dtype=np.float64)
    cursor = [0]

    def take(n, conv=float):
        i = cursor[0]
        if i + n > numbers.size:
            raise StopIteration
        cursor[0] = i + n
        chunk = numbers[i:i + n]
        return [conv(v) for v in chunk]

    nx, ny, nz = take(3, int)
    delta_x, delta_y = take(2)
    z_levels = np.array(take(nz + 1))
    n_phase = take(1, int)[0]
    coeffs = []
    for _ in range(n_phase):
        n_l = take(1, int)[0]
        chi = np.array(take(n_l))
        coeffs.append(chi / (2 * np.arange(1, n_l + 1) + 1))  # chi -> xi (:172)

    extinct = np.zeros((nx, ny, nz))
    ssa = np.zeros((nx, ny, nz))
    pf_index = np.zeros((nx, ny, nz), np.int32)
    temps = np.zeros((nx, ny, nz))
    while True:
        try:
            i, j, k = take(3, int)
        except StopIteration:
            break
        t, e, w = take(3)
        p = take(1, int)[0]
        if not 1 <= p <= n_phase:
            raise ValidationError(f"phase function index out of range at "
                                  f"({i},{j},{k}): {p}")
        extinct[i - 1, j - 1, k - 1] = e
        ssa[i - 1, j - 1, k - 1] = w
        pf_index[i - 1, j - 1, k - 1] = p - 1
        temps[i - 1, j - 1, k - 1] = t
    return dict(nx=nx, ny=ny, nz=nz, delta_x=delta_x, delta_y=delta_y,
                z_levels=z_levels, coefficients=coeffs, extinction=extinct,
                ssa=ssa, phase_index=pf_index, temperatures=temps)


def optical_properties_to_domain(prop_file) -> Domain:
    p = read_shdom_property_file(prop_file)
    pfs = [PhaseFunction.from_legendre(c) for c in p["coefficients"]]
    table = PhaseFunctionTable.from_phase_functions(
        pfs, key=np.arange(1, len(pfs) + 1, dtype=np.float64))
    domain = Domain.create(p["delta_x"] * np.arange(p["nx"] + 1),
                           p["delta_y"] * np.arange(p["ny"] + 1),
                           p["z_levels"])
    return domain.add_component("mixture", p["extinction"], p["ssa"],
                                p["phase_index"], table)


def main(argv=None):
    """CLI: python -m i3rc_tpu_torch.tools.optical_to_domain <namelist.nml>."""
    from i3rc_tpu_torch.io.netcdf import write_domain
    from i3rc_tpu_torch.utils.namelist import read_namelist

    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m i3rc_tpu_torch.tools.optical_to_domain <namelist.nml>",
              file=sys.stderr)
        return 1
    fn = read_namelist(argv[0]).get("filenames", {})
    domain = optical_properties_to_domain(str(fn.get("propfilename", "")).strip())
    out = str(fn.get("outputfilename", "")).strip()
    write_domain(domain, out)
    print(f"Wrote domain to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
