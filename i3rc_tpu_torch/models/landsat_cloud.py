# Copy of i3rc_tpu/models/landsat_cloud.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""I3RC phase-1 case 4: Landsat-derived cloud field.

Re-implements I3RC-Examples/i3rcLandsatCloud.f95: 128x128 columns of optical
depth (Data/scene43.tau.128x128) and geometric thickness in km
(Data/scene43.dz.128x128) on a 30 m horizontal grid; each column's cloud
occupies nint(thickness/20m) layers of 20 m starting at the domain base
(200 m), with uniform extinction tau/(n_layers*20) (:100-104); HG g=0.85;
two albedos.
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
N_X = N_Y = 128
DELTA_XY = 30.0
DELTA_Z = 20
MAX_THICKNESS = 2380
N_LAYERS = (MAX_THICKNESS + DELTA_Z // 2) // DELTA_Z
G = 0.85
N_LEGENDRE = 299
BASE_HEIGHT = 200.0
SSAS = {"non_absorbing": 1.0, "absorbing": 0.99}


def _read_fixed(path: str, width: int = 7) -> np.ndarray:
    """Fixed-width Fortran 128f7.2 reader; rows are y, columns x.

    Bulk token parse when fields are whitespace-separated (true for the
    shipped data), fixed-width slicing otherwise.  The JAX package parses
    the tokens with its native helper; this copy parses them as its Python
    fallback does (i3rc_tpu/native/fastparse.py ``_parse_python``).
    """
    with open(path) as f:
        text = f.read()
    try:
        vals = np.array([float(t.replace("D", "e").replace("d", "e"))
                         for t in text.split()], dtype=np.float64)
    except ValueError:
        vals = np.zeros(0)
    if vals.size == N_Y * N_X:
        arr = vals.reshape(N_Y, N_X)
    else:
        rows = [[float(l[i:i + width]) for i in range(0, width * N_X, width)]
                for l in text.splitlines() if l.strip()]
        arr = np.array(rows)
    assert arr.shape == (N_Y, N_X), arr.shape
    return arr.T  # -> (x, y)


def make_landsat_cloud(single_scattering_albedo: float = 1.0,
                       data_dir: str = DATA_DIR) -> Domain:
    optical_depth = _read_fixed(os.path.join(data_dir, "scene43.tau.128x128"))
    thickness = _read_fixed(os.path.join(data_dir, "scene43.dz.128x128")) * 1000.0  # km->m

    n_cloud_layers = np.rint(thickness / DELTA_Z).astype(np.int32)  # per column
    ext = np.zeros((N_X, N_Y, N_LAYERS))
    layer = np.arange(N_LAYERS)[None, None, :]
    in_cloud = layer < n_cloud_layers[:, :, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        cell_ext = np.where(optical_depth > 0.0,
                            optical_depth / (n_cloud_layers * DELTA_Z), 0.0)
    ext = np.where(in_cloud, cell_ext[:, :, None], 0.0)

    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(G, N_LEGENDRE))],
        key=[1.0], description=f"Henyey-Greenstein with g = {G}")
    dom = Domain.create(
        DELTA_XY * np.arange(N_X + 1),
        DELTA_XY * np.arange(N_Y + 1),
        DELTA_Z * np.arange(N_LAYERS + 1) + BASE_HEIGHT)
    ssa = np.where(ext > 0.0, single_scattering_albedo, 0.0)
    name = "cloud: non-absorbing" if single_scattering_albedo == 1.0 else "cloud: absorbing"
    return dom.add_component(name, ext, ssa, np.zeros(ext.shape, np.int32), table)


def write_domains(out_dir: str = ".", data_dir: str = DATA_DIR) -> list[str]:
    from i3rc_tpu_torch.io.netcdf import write_domain

    paths = []
    for label, suffix in (("non_absorbing", "NonAbsorbing"), ("absorbing", "Absorbing")):
        path = os.path.join(out_dir, f"LandsatCloud_{suffix}.opt")
        write_domain(make_landsat_cloud(SSAS[label], data_dir), path)
        paths.append(path)
    return paths
