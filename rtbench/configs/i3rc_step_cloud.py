"""I3RC Phase 1 case 1: the step cloud, at its published grid.

I3RC-Examples/i3rcStepCloud.f95:26-39: a domain 0.5 km wide and 0.25 km
deep of 32 x 1 x 32 cells; the first 16 columns have optical depth 2, the
other 16 optical depth 18; Henyey-Greenstein g = 0.85 (64 Legendre moments
in the domain file); single-scattering albedo 1.0 or 0.99; a black surface;
the sun at mu0 = 0.5, azimuth 0.  The algorithms are those of the shipped
namelist (examples/monteCarloDriver_stepCloud.nml): maximum cross-section
(useRayTracing = .false.), Iwabuchi roulette for the radiances at
zetaMin = 0.3, and the event budget of the benchmark rows (max_events 500).
"""

import numpy as np

SOURCE = ("I3RC Phase 1 case 1 step cloud (Cahalan et al. 2005, BAMS 86:1275); reference "
          "I3RC-Examples/i3rcStepCloud.f95:26-39 and Example-Drivers/monteCarloDriver.nml")
REDUCED = []
ASSUMED = {"photons_per_batch": "each traffic mix's", "lanes": "each traffic mix's"}
SSAS = (1.0, 0.99)
G = 0.85
N_LEGENDRE = 64
MU0, PHI0 = 0.5, 0.0
SETTINGS = {"use_ray_tracing": False, "max_events": 500,
            "use_russian_roulette_for_intensity": True, "zeta_min": 0.3}
# Columns pooled (x, y) for the column-by-column comparison.
COMPARE_BLOCK = (1, 1)


def scene(ssa: float) -> dict:
    if ssa not in SSAS:
        raise ValueError(f"the step cloud is published at ssa {SSAS}, not {ssa}")
    tau = np.where(np.arange(32) < 16, 2.0, 18.0)
    ext = np.broadcast_to(tau[:, None, None] / 250.0, (32, 1, 32)).copy()
    return {"x_edges": np.linspace(0.0, 500.0, 33), "y_edges": np.array([0.0, 500.0]),
            "z_edges": np.linspace(0.0, 250.0, 33), "ext": ext,
            "ssa": np.full_like(ext, ssa), "g": G, "n_legendre": N_LEGENDRE,
            "mu0": MU0, "phi0": PHI0}
