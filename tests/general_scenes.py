"""Scenes of the general-kernel tests, built with either package's classes
(``host(pkg)`` of tests/general_oracles.py), and the radiance cases that hold
the CUDA general event block with detectors against its plain version.

Imports neither jax nor the JAX package: ``chip_smoke.py`` and the tests
marked ``cuda`` load it on the card's machine.
"""

import importlib.util
from pathlib import Path

import numpy as np

_spec = importlib.util.spec_from_file_location("general_oracles",
                                               Path(__file__).with_name("general_oracles.py"))
_oracles = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_oracles)
host = _oracles.host


def step_cloud_32x8(h, ssa=0.99):
    """The 32 x 1 x 8 step cloud of tests/test_integrator.py:157."""
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.85, 64))], key=[1.0])
    ext = np.where(np.arange(32)[:, None, None] < 16, 2.0, 18.0) / 250.0 * np.ones((32, 1, 8))
    dom = h.Domain.create(np.linspace(0, 500, 33), [0.0, 500.0], np.linspace(0, 250, 9))
    return dom.add_component("cloud", ext, np.full_like(ext, ssa), np.zeros(ext.shape, np.int32),
                             table)


def two_component(h):
    """A seeded random 3-D domain: an HG cloud with two phase entries and a
    tabulated non-HG (Rayleigh) haze, ssa < 1, irregular x and z."""
    rng = np.random.default_rng(7)
    shape = (6, 5, 6)
    ext1 = rng.uniform(0.0, 0.06, shape) * (rng.uniform(size=shape) > 0.3)
    ext2 = rng.uniform(0.002, 0.01, shape)
    hg = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(g, 48)) for g in (0.85, 0.5)], key=[1.0, 2.0])
    ang = np.linspace(0.0, np.pi, 91)
    ray = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_tabulated(ang, 0.75 * (1 + np.cos(ang) ** 2))], key=[0.0])
    z = np.concatenate([[0.0], np.cumsum(rng.uniform(25.0, 60.0, shape[2]))])
    x = np.concatenate([[0.0], np.cumsum(rng.uniform(60.0, 140.0, shape[0]))])
    dom = h.Domain.create(x, np.linspace(0, 500.0, 6), z)
    dom = dom.add_component("cloud", ext1, rng.uniform(0.9, 1.0, shape),
                            rng.integers(0, 2, shape).astype(np.int32), hg)
    return dom.add_component("haze", ext2, np.full(shape, 0.9), np.zeros(shape, np.int32), ray)


def weight1_domain(h):
    """tests/test_serial_path.py:101-136's random 8^3 cloud, here at ssa 0.9."""
    rng = np.random.default_rng(3)
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.85, 32))], key=[1.0])
    ext = rng.uniform(0.0, 0.03, (8, 8, 8))
    ext[ext < 0.01] = 0.0
    dom = h.Domain.create(np.linspace(0, 800.0, 9), np.linspace(0, 800.0, 9),
                          np.linspace(0, 400.0, 9))
    return dom.add_component("c", ext, np.full_like(ext, 0.9), np.zeros(ext.shape, np.int32),
                             table)


RPV_GRID = np.array([[[0.1, 0.8, -0.1], [0.3, 0.7, 0.1]],
                     [[0.2, 0.9, 0.0], [0.05, 0.6, -0.2]]])


def rpv_grid(h):
    """A 2 x 2 gridded RPV surface under the step cloud."""
    return h.Surface.create(RPV_GRID, [0.0, 250.0, 500.0], [0.0, 250.0, 500.0],
                            brdf_name="rpv")


# The I3RC detector set (mu, phi): nadir and 60 degrees off nadir on either
# side of the sun's plane (BENCH_CASES.md case 2).
DET_MUS, DET_PHIS = [1.0, 0.5, 0.5], [0.0, 0.0, 180.0]
MODE_KW = {"rt": dict(use_ray_tracing=True), "maxcs": dict(use_ray_tracing=False),
           "woodcock": dict(use_ray_tracing=False, majorant_block_size=4)}
EST_KW = {"exact": {}, "iwabuchi": dict(use_russian_roulette_for_intensity=True),
          "ratio": dict(use_ratio_tracking_for_intensity=True, majorant_block_size=4)}

# Kernel-vs-plain radiance cases: (domain, mode, estimator, surface, extra
# config).  Together they fill the product of the estimators and the modes
# that have them (the exact trace and Iwabuchi roulette in all three, ratio
# tracking where block majorants exist: ray tracing and Woodcock) with the
# surface kinds (black, albedo, gridded RPV), cover every transport mode x
# optics x surface instantiation with detectors and the weight-1 class, and
# add hybrid phases and clipping.
RADIANCE_CASES = {
    "rt_exact_black": ("step", "rt", "exact", "black", {}),
    "rt_iwabuchi_albedo": ("step99", "rt", "iwabuchi", "albedo", {}),
    "rt_ratio_rpv": ("step", "rt", "ratio", "rpv", {}),
    "rt_exact_two_comp_rpv": ("two_comp", "rt", "exact", "rpv", {}),
    "rt_iwabuchi_two_comp": ("two_comp", "rt", "iwabuchi", "black",
                             dict(use_hybrid_phase_funs=True, num_orders_orig_phase_fun=1)),
    "maxcs_exact_albedo_hybrid_clip": ("step99", "maxcs", "exact", "albedo",
                                       dict(use_hybrid_phase_funs=True,
                                            num_orders_orig_phase_fun=1,
                                            limit_intensity_contributions=True,
                                            max_intensity_contribution=0.05)),
    "maxcs_iwabuchi_black": ("step", "maxcs", "iwabuchi", "black", {}),
    "maxcs_exact_two_comp_rpv": ("two_comp", "maxcs", "exact", "rpv", {}),
    "maxcs_iwabuchi_two_comp_clip": ("two_comp", "maxcs", "iwabuchi", "black",
                                     dict(limit_intensity_contributions=True,
                                          max_intensity_contribution=0.05)),
    "woodcock_ratio_black": ("step", "woodcock", "ratio", "black", {}),
    "woodcock_exact_albedo": ("step99", "woodcock", "exact", "albedo", {}),
    "woodcock_ratio_two_comp_rpv": ("two_comp", "woodcock", "ratio", "rpv", {}),
    "woodcock_iwabuchi_two_comp": ("two_comp", "woodcock", "iwabuchi", "black", {}),
    "woodcock_ratio_weight1": ("weight1", "woodcock", "ratio", "black",
                               dict(general_chain=2, compute_volume_absorption=False)),
    "rt_exact_albedo": ("step99", "rt", "exact", "albedo", {}),
    "rt_iwabuchi_rpv": ("step", "rt", "iwabuchi", "rpv", {}),
    "rt_ratio_black": ("two_comp", "rt", "ratio", "black", {}),
    "rt_ratio_albedo": ("step99", "rt", "ratio", "albedo", {}),
    "maxcs_exact_black": ("step", "maxcs", "exact", "black", {}),
    "maxcs_iwabuchi_albedo": ("step99", "maxcs", "iwabuchi", "albedo", {}),
    "maxcs_iwabuchi_rpv": ("step", "maxcs", "iwabuchi", "rpv", {}),
    "woodcock_exact_black": ("step", "woodcock", "exact", "black", {}),
    "woodcock_exact_rpv": ("two_comp", "woodcock", "exact", "rpv", {}),
    "woodcock_iwabuchi_albedo": ("step99", "woodcock", "iwabuchi", "albedo", {}),
    "woodcock_iwabuchi_rpv": ("step", "woodcock", "iwabuchi", "rpv", {}),
    "woodcock_ratio_albedo": ("two_comp", "woodcock", "ratio", "albedo", {}),
    "rt_exact_16_detectors": ("step", "rt", "exact", "black", {}),
}

# Sixteen detectors, twelve up and four down: every collision of the step
# cloud queues sixteen rays (the kernel's many-ray case: a CTA's queue deals
# far more rays than it has threads).
MANY_MUS = [1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.5, 0.5, 0.5, 0.5, -0.5, -0.7, -0.9, -0.3]
MANY_PHIS = [0.0, 0.0, 30.0, 60.0, 90.0, 120.0, 150.0, 180.0, 210.0, 240.0, 270.0, 300.0,
             0.0, 90.0, 180.0, 270.0]
CASE_DETECTORS = {"rt_exact_16_detectors": (MANY_MUS, MANY_PHIS)}


def radiance_case(h, name: str, device="cpu"):
    """The port's (or the JAX package's, without ``device``) integrator of
    one RADIANCE_CASES entry, with the I3RC detectors (or the case's own,
    CASE_DETECTORS)."""
    dom_name, mode, est, srf, extra = RADIANCE_CASES[name]
    dom = {"step": lambda: step_cloud_32x8(h, 1.0), "step99": lambda: step_cloud_32x8(h, 0.99),
           "two_comp": lambda: two_component(h), "weight1": lambda: weight1_domain(h)}[dom_name]()
    kw = dict(max_events=500, use_fastpath=False)
    for part in (MODE_KW[mode], EST_KW[est], extra):
        kw.update(part)
    mus, phis = CASE_DETECTORS.get(name, (DET_MUS, DET_PHIS))
    create = dict(intensity_mus=mus, intensity_phis=phis)
    if srf == "albedo":
        create["surface_albedo"] = 0.2
    elif srf == "rpv":
        create["surface"] = rpv_grid(h)
    if h.pkg == "i3rc_tpu_torch":
        create["device"] = device
    return h.Integrator.create(dom, config=h.Config(**kw), **create)
