"""Anchors of the reflecting-surface paths of ``chip_smoke.py``, computed with
the JAX package on the CPU.

Three configurations with no published value, each as ``chip_smoke.py``
drives it on the card (maximum cross-section, max_events 500, no Iwabuchi
roulette: the JAX fastpath's roulette drops exp(-tau) in one case, ROADMAP
Queue 3), and the glint row (bench.py:128-165: the scan's scene and
surface, flux only), whose published Fup is a TPU figure:

  glint    thin cirrus over Cox-Munk (5 m/s, 1.34), directional(0.707, 0):
           Fup, Fdn;

  albedo   the I3RC step cloud over a Lambertian surface of albedo 0.2,
           directional(0.5, 0): Fup, Fdn;
  rpv      the step cloud over RPV (0.2, 0.8, -0.1) with detectors at
           mu = (0.5, -0.5), phi = (40, 0) (tests/test_fastpath.py:1343):
           Fup and the two radiances, with the surface's share (slot 0);
  scan     examples/ocean_glint_radiance.py: thin cirrus (tau 0.2, HG
           g = 0.75 from 48 Legendre terms) over Cox-Munk (5 m/s, 1.34),
           13 upward detectors at mu = 0.707, phi = 0, 15, ..., 180,
           directional(0.707, 0): the radiances and Fup.

Each runs ``--batches`` batches of ``--photons`` photons; the anchor is the
mean over batches and its sigma the standard error of that mean.  Prints
one JSON object:

    JAX_PLATFORMS=cpu python tests/surface_anchors.py --photons 262144 --batches 8
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np

from i3rc_tpu import Domain, Integrator, PhaseFunction, SurfaceDescription
from i3rc_tpu.core.illumination import PhotonSource
from i3rc_tpu.core.phase_functions import PhaseFunctionTable, henyey_greenstein_coefficients
from i3rc_tpu.integrators.config import IntegratorConfig
from i3rc_tpu.models.step_cloud import make_step_cloud

CFG = IntegratorConfig(use_ray_tracing=False, max_events=500, compute_volume_absorption=False,
                       fastpath_unroll=1)
SCAN_PHIS = [float(p) for p in np.arange(0.0, 181.0, 15.0)]


def cirrus() -> Domain:
    """The glint scene of bench.py:128-165 and examples/ocean_glint_radiance.py."""
    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(0.75, 48))], key=[1.0])
    dom = Domain.create([0.0, 1000.0], [0.0, 1000.0], [0.0, 1000.0])
    ext = np.full((1, 1, 1), 0.2 / 1000.0)
    return dom.add_component("cirrus", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32),
                             table)


CASES = {
    "glint": (cirrus, dict(surface=SurfaceDescription.uniform([5.0, 1.34], brdf_name="cox_munk")),
              PhotonSource.directional(0.707, 0.0)),
    "albedo": (lambda: make_step_cloud(1.0), dict(surface_albedo=0.2),
               PhotonSource.directional(0.5, 0.0)),
    "rpv": (lambda: make_step_cloud(1.0),
            dict(surface=SurfaceDescription.uniform([0.2, 0.8, -0.1], brdf_name="rpv"),
                 intensity_mus=[0.5, -0.5], intensity_phis=[40.0, 0.0]),
            PhotonSource.directional(0.5, 0.0)),
    "scan": (cirrus, dict(surface=SurfaceDescription.uniform([5.0, 1.34],
                                                             brdf_name="cox_munk"),
                          intensity_mus=[0.707] * len(SCAN_PHIS), intensity_phis=SCAN_PHIS),
             PhotonSource.directional(0.707, 0.0)),
}


def anchor(name: str, photons: int, batches: int, lanes: int) -> dict:
    make, kw, src = CASES[name]
    integ = Integrator.create(make(), config=CFG, **kw)
    assert integ._fast_plan is not None, name
    fn = integ.batch_fn(src, photons, n_lanes=min(lanes, photons))
    rows = []
    t0 = time.perf_counter()
    for b in range(batches):
        r = fn(jax.random.PRNGKey(1000 + b))
        row = [float(r.mean_flux_up), float(r.mean_flux_down)]
        if integ.intensity is not None:
            row += list(np.asarray(r.mean_intensity, np.float64))
            row += list(np.asarray(r.intensity_by_component, np.float64)[..., 0].mean(axis=(0, 1)))
        assert int(r.n_bad) == 0, name
        rows.append(row)
    rows = np.asarray(rows)
    mean, sigma = rows.mean(axis=0), rows.std(axis=0, ddof=1) / np.sqrt(batches)
    d = integ.intensity.n_directions if integ.intensity is not None else 0
    names = ["fup", "fdn"] + [f"i{k}" for k in range(d)] + [f"srf{k}" for k in range(d)]
    return {"photons": photons * batches, "seconds": time.perf_counter() - t0,
            **{n: [float(m), float(s)] for n, m, s in zip(names, mean, sigma)}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--photons", type=int, default=1 << 18)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=1 << 16)
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args()
    out = {name: anchor(name, args.photons, args.batches, args.lanes)
           for name in args.cases.split(",")}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
