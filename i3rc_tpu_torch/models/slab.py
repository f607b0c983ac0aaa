# Copy of i3rc_tpu/models/slab.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""Homogeneous slab builder: the planeParallel verification scene.

Re-implements createDomain from Example-Drivers/planeParallel.f95:299-379: a
uniform slab of given optical depth / albedo, with the phase function as a
Henyey-Greenstein Legendre series, HG angle-value pairs, or an entry read
from a phase-function-table file.
"""

from __future__ import annotations

import numpy as np

from i3rc_tpu_torch.core.optics import Domain
from i3rc_tpu_torch.core.phase_functions import (
    PhaseFunction,
    PhaseFunctionTable,
    henyey_greenstein_coefficients,
    henyey_greenstein_values,
)


def make_slab_domain(optical_depth: float, single_scattering_albedo: float = 1.0,
                     g: float = 0.85, use_moments: bool = True,
                     n_legendre_coefficients: int = 64, n_angles: int = 5000,
                     domain_size: float = 500.0, physical_thickness: float = 250.0,
                     n_layers: int = 1, n_x: int = 1, n_y: int = 1,
                     phase_function_table_file: str = "",
                     phase_function_table_index: int = 0) -> Domain:
    if phase_function_table_file:
        from i3rc_tpu_torch.io.netcdf import read_phase_function_table

        table = read_phase_function_table(phase_function_table_file)
        pf_index = phase_function_table_index
    elif use_moments:
        table = PhaseFunctionTable.from_phase_functions(
            [PhaseFunction.from_legendre(
                henyey_greenstein_coefficients(g, n_legendre_coefficients))],
            key=[1.0])
        pf_index = 0
    else:
        angles = np.linspace(0.0, np.pi, n_angles)
        table = PhaseFunctionTable.from_tabulated(
            angles, henyey_greenstein_values(g, angles)[:, None], key=[1.0])
        pf_index = 0

    dom = Domain.create(
        np.linspace(0.0, domain_size, n_x + 1),
        np.linspace(0.0, domain_size, n_y + 1),
        np.linspace(0.0, physical_thickness, n_layers + 1))
    ext = np.full((n_x, n_y, n_layers), optical_depth / physical_thickness)
    return dom.add_component(
        "cloud", ext, np.full_like(ext, single_scattering_albedo),
        np.full(ext.shape, pf_index, np.int32), table)
