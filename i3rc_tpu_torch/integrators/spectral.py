"""Broadband spectral loop over k-distributions, on a PyTorch device.

Port of ``i3rc_tpu/integrators/spectral.py``.  For each band the domain
gets a "Gas absorption" component whose 1-D extinction profile is the k
point's profile (ssa 0, isotropic phase: PhysicalPropertiesToDomain.f95:
330-347), and results accumulate as

    total = sum_bands spectral_fraction_b * sum_k w_bk * Results_bk.

The port runs the baked mode: one ``Integrator`` per k point, each taking
the gas-channel fastpath with the k point's profile baked into its plan.
On the card a k point only changes the event kernel's by-value parameter
block (``EventParams.gz``), so a k point costs no compile, and the JAX
package's fused/baked crossover (``BAKED_CROSSOVER_PHOTONS_PER_K``, which
prices a per-k Mosaic compile on the TPU, spectral.py:124-135) has no
counterpart: ``mode="auto"`` takes the baked mode whenever the baked plan
is a fastpath plan.

The JAX package's two switches ``bake_fastpath`` and ``fuse_k`` become one
``mode`` argument, the broadband namelist's ``spectralMode``: "baked" (the
default), "auto", "fused" or "traced".  Not ported yet, raising
NotImplementedError: the fused-k mode (every k point in one dispatch:
ROADMAP item 13b) and the traced mode (per-k optics through the general
kernel, and "auto" on workloads without a fastpath plan: ROADMAP item 16).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from i3rc_tpu_torch.core.k_distribution import KDistribution
from i3rc_tpu_torch.core.optics import Domain
from i3rc_tpu_torch.core.phase_functions import PhaseFunction, PhaseFunctionTable
from i3rc_tpu_torch.integrators.integrator import Integrator
from i3rc_tpu_torch.parallel.mesh import run_batches, tree_map

GAS_COMPONENT_NAME = "Gas absorption"
MODES = ("auto", "baked", "fused", "traced")
_FUSED = "fused-k spectral batching (GasKTables): ROADMAP item 13b"
_TRACED = "the traced spectral mode (per-k optics through the general kernel): ROADMAP item 16"


def domain_with_gas_component(domain: Domain, profile: np.ndarray) -> Domain:
    """Domain plus a horizontally uniform pure-absorption component."""
    gas_table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(np.zeros(1))], key=[0.0],
        description=GAS_COMPONENT_NAME)
    profile = np.asarray(profile, dtype=np.float64)
    return domain.add_component(GAS_COMPONENT_NAME, profile, np.zeros_like(profile),
                                np.zeros(profile.shape, np.int32), gas_table)


@dataclass(frozen=True)
class BandResult:
    """One band's weighted mean results over its k points, with details."""

    mean: object          # weighted tree of Results (and derived values) over k
    per_k: list           # BatchStats per k point
    wavelength_limits: tuple
    spectral_fraction: float
    # Standard error of the band mean, a tree matching ``mean``: the k
    # points are independent runs, so sqrt(sum_k (w_k se_k)^2)
    # (monteCarloDriver.f95:358-378).
    stderr: object


def run_band(integrator: Integrator, base_domain: Domain, kdist: KDistribution, source,
             n_photons_per_batch: int, n_batches: int, seed: int = 10, derive=None,
             mode: str = "baked", integrator_cache: dict | None = None,
             n_lanes: int | None = None) -> BandResult:
    """All k points of one band, each through its own baked integrator.

    ``integrator`` supplies the configuration, surface, detectors and
    device; ``base_domain`` is the domain without gas.  K point k runs
    ``n_batches`` batches of ``n_photons_per_batch`` photons with seed
    ``seed + 1000 * k``.  ``integrator_cache`` keeps the per-k integrators
    (and their tracers) across band runs.  ``mode`` is one of ``MODES``;
    "fused" and "traced" raise NotImplementedError (see the module
    docstring).
    """
    if mode not in MODES:
        raise ValueError(f"spectral mode must be one of {MODES}, got {mode!r}")
    if mode == "fused":
        raise NotImplementedError(f"spectral: {_FUSED}")
    cache = integrator_cache if integrator_cache is not None else {}
    profiles = kdist.absorption_profiles_on(np.asarray(base_domain.z_edges))

    def k_integrator(k: int) -> Integrator:
        """The band integrator's settings on the base domain plus k's gas."""
        # Entries keep (kdist, base_domain) alive, so that their id()s in
        # the key cannot be reused by other objects.
        ckey = (id(kdist), k, id(base_domain))
        if ckey not in cache:
            integ = Integrator.create(
                domain_with_gas_component(base_domain, profiles[:, k]),
                config=integrator.config, surface_albedo=integrator.surface.albedo,
                intensity_mus=integrator._intensity_mus,
                intensity_phis=integrator._intensity_phis, device=integrator.device)
            cache[ckey] = (integ, kdist, base_domain)
        return cache[ckey][0]

    if mode == "traced" or (mode == "auto" and k_integrator(0)._fast_plan is None):
        raise NotImplementedError(f"spectral: {_TRACED}")
    per_k, mean, var = [], None, None
    for k in range(kdist.n_k):
        stats = run_batches(k_integrator(k), source, n_photons_per_batch, n_batches,
                            seed=seed + 1000 * k, derive=derive, n_lanes=n_lanes)
        per_k.append(stats)
        w = float(kdist.weights[k])
        m_k = tree_map(lambda a: a * w, stats.mean)
        v_k = tree_map(lambda s: (s * w) ** 2, stats.stderr)
        mean = m_k if mean is None else tree_map(torch.add, mean, m_k)
        var = v_k if var is None else tree_map(torch.add, var, v_k)
    return BandResult(mean=mean, per_k=per_k, wavelength_limits=kdist.wavelength_limits,
                      spectral_fraction=kdist.spectral_fraction,
                      stderr=tree_map(torch.sqrt, var))


def run_broadband(base_domain: Domain, k_distributions, source, n_photons_per_batch: int,
                  n_batches: int, seed: int = 10, config=None, surface_albedo: float = 0.0,
                  intensity_mus=None, intensity_phis=None, band_domains=None, derive=None,
                  mode: str = "baked", integrator_cache: dict | None = None,
                  device="cuda", n_lanes: int | None = None):
    """The spectral loop over bands and their k points.

    ``band_domains`` optionally gives each band its own domain (per-band
    cloud optics); otherwise every band uses ``base_domain``.  Band b runs
    with seed ``seed + 100000 * b``.  Returns (broadband mean tree, [BandResult
    per band]); the broadband tree is the spectral-fraction-weighted sum of
    the band means.
    """
    results, broadband = [], None
    for b, kdist in enumerate(k_distributions):
        dom_b = band_domains[b] if band_domains is not None else base_domain
        # The band's settings, on its domain with the first k point's gas.
        integ = Integrator.create(
            domain_with_gas_component(
                dom_b, kdist.absorption_profiles_on(np.asarray(dom_b.z_edges))[:, 0]),
            config=config, surface_albedo=surface_albedo, intensity_mus=intensity_mus,
            intensity_phis=intensity_phis, device=device)
        band = run_band(integ, dom_b, kdist, source, n_photons_per_batch, n_batches,
                        seed=seed + 100000 * b, derive=derive, mode=mode,
                        integrator_cache=integrator_cache, n_lanes=n_lanes)
        results.append(band)
        contrib = tree_map(lambda a, f=band.spectral_fraction: a * f, band.mean)
        broadband = contrib if broadband is None else tree_map(torch.add, broadband, contrib)
    return broadband, results
