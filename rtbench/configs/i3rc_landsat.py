"""I3RC Phase 1 case 4: the Landsat scene 43 cloud field, at its published grid.

I3RC-Examples/i3rcLandsatCloud.f95:27-35, 100-104: 128 x 128 columns of
optical depth (Data/scene43.tau.128x128) and geometric thickness in km
(Data/scene43.dz.128x128) on a 30 m grid; each column's cloud fills
nint(thickness / 20 m) layers of 20 m from the domain's base at 200 m with a
uniform extinction tau / (layers x 20 m); 119 layers (2380 m); Henyey-
Greenstein g = 0.85 (299 Legendre moments); ssa 1.0 or 0.99 in the cloud;
a black surface; the sun at mu0 = 0.5, azimuth 0; maximum cross-section.
The two data files ship with the JAX package and are read here as data.
"""

import os

import numpy as np

SOURCE = ("I3RC Phase 1 case 4 Landsat scene43 (Cahalan et al. 2005, BAMS 86:1275); "
          "reference I3RC-Examples/i3rcLandsatCloud.f95:27-35,100-104")
REDUCED = []
ASSUMED = {"photons_per_batch": "each traffic mix's", "lanes": "each traffic mix's"}
SSAS = (1.0, 0.99)
G = 0.85
N_LEGENDRE = 299
MU0, PHI0 = 0.5, 0.0
N = 128
DELTA_XY, DELTA_Z, N_LAYERS, BASE = 30.0, 20.0, 119, 200.0
SETTINGS = {"use_ray_tracing": False, "max_events": 500}
COMPARE_BLOCK = (8, 8)
DATA = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir, "i3rc_tpu", "models",
                    "data")


def _read(name: str) -> np.ndarray:
    """A 128f7.2 field of the scene, rows y and columns x, as (x, y)."""
    with open(os.path.join(DATA, name)) as f:
        vals = np.array(f.read().split(), dtype=np.float64)
    return vals.reshape(N, N).T


def scene(ssa: float) -> dict:
    if ssa not in SSAS:
        raise ValueError(f"the Landsat scene is published at ssa {SSAS}, not {ssa}")
    tau = _read("scene43.tau.128x128")
    layers = np.rint(_read("scene43.dz.128x128") * 1000.0 / DELTA_Z)
    with np.errstate(divide="ignore", invalid="ignore"):
        cell_ext = np.where(tau > 0.0, tau / (layers * DELTA_Z), 0.0)
    ext = np.where(np.arange(N_LAYERS)[None, None, :] < layers[:, :, None],
                   cell_ext[:, :, None], 0.0)
    return {"x_edges": DELTA_XY * np.arange(N + 1), "y_edges": DELTA_XY * np.arange(N + 1),
            "z_edges": DELTA_Z * np.arange(N_LAYERS + 1) + BASE, "ext": ext,
            "ssa": np.where(ext > 0.0, ssa, 0.0), "g": G, "n_legendre": N_LEGENDRE,
            "mu0": MU0, "phi0": PHI0}
