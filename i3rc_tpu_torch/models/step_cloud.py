# Copy of i3rc_tpu/models/step_cloud.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""I3RC phase-1 case 1: the step cloud.

Re-implements I3RC-Examples/i3rcStepCloud.f95: a 0.5 km wide domain of 32
columns; the first 16 columns have optical depth 2, the second 16 have 18;
Henyey-Greenstein g = 0.85 phase function; two variants with single
scattering albedo 1.0 and 0.99 (i3rcStepCloud.f95:26-39).
"""

from __future__ import annotations

import numpy as np

from i3rc_tpu_torch.core.optics import Domain
from i3rc_tpu_torch.core.phase_functions import (
    PhaseFunction,
    PhaseFunctionTable,
    henyey_greenstein_coefficients,
)

DOMAIN_SIZE = 500.0
G = 0.85
N_COLUMNS = 32
N_LAYERS = 32
PHYSICAL_THICKNESS = 250.0
N_LEGENDRE = 64
SSAS = {"non_absorbing": 1.0, "absorbing": 0.99}


def make_step_cloud(single_scattering_albedo: float = 1.0) -> Domain:
    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(G, N_LEGENDRE))],
        key=[1.0], description=f"Henyey-Greenstein with g = {G}")
    tau = np.where(np.arange(N_COLUMNS) < N_COLUMNS // 2, 2.0, 18.0)
    ext = np.broadcast_to(tau[:, None, None] / PHYSICAL_THICKNESS,
                          (N_COLUMNS, 1, N_LAYERS)).copy()
    dom = Domain.create(
        np.linspace(0.0, DOMAIN_SIZE, N_COLUMNS + 1),
        np.array([0.0, DOMAIN_SIZE]),
        np.linspace(0.0, PHYSICAL_THICKNESS, N_LAYERS + 1))
    name = "cloud: non-absorbing" if single_scattering_albedo == 1.0 else "cloud: absorbing"
    return dom.add_component(name, ext,
                             np.full_like(ext, single_scattering_albedo),
                             np.zeros(ext.shape, np.int32), table)


def write_domains(out_dir: str = ".") -> list[str]:
    """Write both step-cloud domain files (i3rcStepCloud.f95:79-99)."""
    from i3rc_tpu_torch.io.netcdf import write_domain
    import os

    paths = []
    for label, file_name in (("non_absorbing", "StepCloud_NonAbsorbing.opt"),
                             ("absorbing", "StepCloud_Absorbing.opt")):
        path = os.path.join(out_dir, file_name)
        write_domain(make_step_cloud(SSAS[label]), path)
        paths.append(path)
    return paths
