# Copy of i3rc_tpu/drivers/nml_common.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""Shared namelist-driver helpers (monteCarloDriver + broadband driver).

The reference drivers repeat the same parameter-block reads
(Example-Drivers/monteCarloDriver.f95:90-103); here the lookup and the
intensity-direction activation logic (:151-154) live in one place so the
drivers cannot drift.
"""

from __future__ import annotations

import numpy as np


def get(groups, group, name, default):
    """Case-normalized namelist lookup with a reference default."""
    return groups.get(group, {}).get(name, default)


def intensity_directions(intensity_mus, intensity_phis, want_radiances):
    """The reference's direction activation: nonzero mus count (:151-154).

    Returns (mus, phis, compute_intensity); validates that enough phis were
    supplied for the mus given (the reference arrays are equal-length) and
    fails with a namelist-level message instead of a downstream IndexError.
    """
    intensity_mus = np.atleast_1d(np.asarray(intensity_mus, dtype=np.float64))
    intensity_phis = np.atleast_1d(np.asarray(intensity_phis,
                                              dtype=np.float64))
    active = np.abs(intensity_mus) > 0.0
    compute = bool(active.any()) and bool(want_radiances)
    if not compute:
        return None, None, False
    if intensity_phis.size < intensity_mus.size:
        raise ValueError(
            f"intensityPhis has {intensity_phis.size} entries but "
            f"intensityMus has {intensity_mus.size}; supply one phi per mu")
    mus = intensity_mus[active]
    phis = intensity_phis[: intensity_mus.size][active]
    return mus, phis, True
