# Copy of i3rc_tpu/models/radar_cloud.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""I3RC phase-1 case 2: radar-derived 2D cloud.

Re-implements I3RC-Examples/i3rcRadarCloud.f95: a 640x1x54 extinction field
from the millimeter cloud radar scene (Data/mmcr_tau_32km_020898, optical
depth per cell read top layer first, :107-114), with either the
Henyey-Greenstein g=0.85 or the Dermendjian C.1 phase function (tabulated
Data/C.1_PF or Legendre Data/C.1_leg_coef with the (2l+1) convention
division, :78-87), at single scattering albedo 1.0 or 0.99 -> four domains.

Note: the shipped Fortran generator references a type
(InversePhaseFunctionTable, :57) that no longer exists in its own codebase
and cannot compile; this copy restores the intended behavior.
"""

from __future__ import annotations

import os

import numpy as np

from i3rc_tpu_torch.core.optics import Domain
from i3rc_tpu_torch.core.phase_functions import (
    PhaseFunction,
    PhaseFunctionTable,
    henyey_greenstein_coefficients,
)

# The scene data ship with the JAX package; they are read by path (data, not
# an import).
DATA_DIR = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                                         "i3rc_tpu", "models", "data"))
N_COLUMNS = 640
N_LAYERS = 54
DELTA_X = 50.0
DELTA_Z = 45.0
G = 0.85
N_LEGENDRE = 299
N_SCATTERING_ANGLES = 1801
SSAS = {"non_absorbing": 1.0, "absorbing": 0.99}


def load_c1_tabulated(data_dir: str = DATA_DIR) -> PhaseFunction:
    """Dermendjian C.1 from angle-value pairs (degrees in the file)."""
    raw = np.loadtxt(os.path.join(data_dir, "C.1_PF"))
    return PhaseFunction.from_tabulated(np.deg2rad(raw[:, 0]), raw[:, 1])


def load_c1_legendre(data_dir: str = DATA_DIR) -> PhaseFunction:
    """C.1 Legendre moments from Data/C.1_leg_coef (xi_l, starting at l=0).

    The Fortran generator divides the file values by (2l+1)
    (i3rcRadarCloud.f95:85-87), but the shipped data file stores xi_l
    directly: expanded as-is it matches the tabulated C.1_PF to 5e-4
    relative, while the divided version is off by a factor of ~23 at wide
    angles.  The convention consistent with the data is used.
    """
    coeffs = np.loadtxt(os.path.join(data_dir, "C.1_leg_coef"))[1:N_LEGENDRE + 1]
    return PhaseFunction.from_legendre(coeffs)


def load_extinction(data_dir: str = DATA_DIR) -> np.ndarray:
    """Per-cell optical depth -> extinction; file rows are layers, top first.

    Fixed-width Fortran 640f8.3, but every field is whitespace-separated in
    the shipped data: a bulk token parse (as the JAX package's Python
    fallback parses them), with a fixed-width fallback.
    """
    path = os.path.join(data_dir, "mmcr_tau_32km_020898")
    with open(path) as f:
        text = f.read()
    try:
        vals = np.array([float(t.replace("D", "e").replace("d", "e"))
                         for t in text.split()], dtype=np.float64)
    except ValueError:
        vals = np.zeros(0)
    if vals.size == N_LAYERS * N_COLUMNS:
        tau = vals.reshape(N_LAYERS, N_COLUMNS)
    else:
        rows = [[float(l[i:i + 8]) for i in range(0, 8 * N_COLUMNS, 8)]
                for l in text.splitlines() if l.strip()]
        tau = np.array(rows)
    assert tau.shape == (N_LAYERS, N_COLUMNS), tau.shape
    return tau[::-1].T[:, None, :] / DELTA_Z   # -> (nx, 1, nz), bottom layer first


def make_radar_cloud(phase_function: str = "hg", single_scattering_albedo: float = 1.0,
                     data_dir: str = DATA_DIR) -> Domain:
    """phase_function is "hg" or "c1" (tabulated) or "c1_legendre"."""
    if phase_function == "hg":
        table = PhaseFunctionTable.from_phase_functions(
            [PhaseFunction.from_legendre(henyey_greenstein_coefficients(G, N_LEGENDRE))],
            key=[1.0], description=f"Henyey-Greenstein with g = {G}")
    elif phase_function == "c1":
        table = PhaseFunctionTable.from_phase_functions(
            [load_c1_tabulated(data_dir)], key=[1.0], description="Dermeindjian C1")
    elif phase_function == "c1_legendre":
        table = PhaseFunctionTable.from_phase_functions(
            [load_c1_legendre(data_dir)], key=[1.0], description="Dermeindjian C1")
    else:
        raise ValueError(f"unknown phase function '{phase_function}'")
    ext = load_extinction(data_dir)
    dom = Domain.create(
        np.linspace(0.0, DELTA_X * N_COLUMNS, N_COLUMNS + 1),
        np.array([0.0, DELTA_X * N_COLUMNS]),
        np.linspace(0.0, DELTA_Z * N_LAYERS, N_LAYERS + 1))
    return dom.add_component(f"cloud: {phase_function}", ext,
                             np.full_like(ext, single_scattering_albedo),
                             np.zeros(ext.shape, np.int32), table)


def write_domains(out_dir: str = ".", data_dir: str = DATA_DIR) -> list[str]:
    """The four domains the Fortran generator writes (i3rcRadarCloud.f95:138-155)."""
    from i3rc_tpu_torch.io.netcdf import write_domain

    paths = []
    for pf, pf_name in (("hg", "HG"), ("c1", "C1")):
        for label, suffix in (("non_absorbing", "NonAbsorbing"), ("absorbing", "Absorbing")):
            path = os.path.join(out_dir, f"RadarCloud_{pf_name}_{suffix}.opt")
            write_domain(make_radar_cloud(pf, SSAS[label], data_dir), path)
            paths.append(path)
    return paths
