"""The system under test: the PyTorch and CUDA port, driven through its batch entry.

The benchmark hands the port the scene arrays it made itself and takes
back, per batch, the port's normalized ``Results``: the callable that
``parallel.mesh.run_batches`` loops over (``Integrator.batch_fn``), called
with ``batch_key(seed, b)`` for consecutive b.  It also reads the port's
kernel launch counters.  Nothing else of the port is used.
"""

from __future__ import annotations

import numpy as np


def integrator(scene: dict, settings: dict, traffic: dict, device):
    """The port's Integrator for the scene under the configuration's
    settings and the traffic's detectors and tallies, and its source."""
    from i3rc_tpu_torch import (Domain, Integrator, IntegratorConfig, PhaseFunction,
                                PhaseFunctionTable, PhotonSource,
                                henyey_greenstein_coefficients)

    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(scene["g"],
                                                                    scene["n_legendre"]))],
        key=[1.0])
    dom = Domain.create(scene["x_edges"], scene["y_edges"], scene["z_edges"]).add_component(
        "cloud", scene["ext"], scene["ssa"], np.zeros(scene["ext"].shape, np.int32), table)
    cfg = IntegratorConfig(**settings,
                           compute_volume_absorption=bool(traffic["volume_absorption"]))
    mus, phis = traffic["detector_mus"], traffic["detector_phis"]
    integ = Integrator.create(dom, cfg, device=device,
                              intensity_mus=mus or None, intensity_phis=phis or None)
    return integ, PhotonSource.directional(scene["mu0"], scene["phi0"])


def batch_fn(integ, source, traffic: dict):
    """``key -> Results`` of one batch of the traffic's photons."""
    return integ.batch_fn(source, int(traffic["photons_per_batch"]),
                          n_lanes=traffic.get("lanes"))


def batch_key(seed: int, b: int):
    from i3rc_tpu_torch import batch_key as key

    # The port's Philox key holds 32-bit words.
    return key(int(seed) & 0xFFFFFFFF, int(b) & 0xFFFFFFFF)


def launches() -> int | None:
    """Block launches so far, over the port's counters: each block of the
    trace loop is one launch of the fast event block (counted in exactly
    one of ``event_block.LAUNCH_COUNTERS``) or of the general block; None
    where the port no longer has these counters."""
    try:
        from i3rc_tpu_torch.kernels import event_block as eb
        from i3rc_tpu_torch.kernels import general_block as gb

        return (sum(int(getattr(eb.event_block, n)) for n in eb.LAUNCH_COUNTERS.values())
                + int(gb.general_block.launches))
    except (ImportError, AttributeError):
        return None
