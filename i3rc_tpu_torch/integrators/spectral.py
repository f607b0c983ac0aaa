"""Broadband spectral loop over k-distributions, on a PyTorch device.

Port of ``i3rc_tpu/integrators/spectral.py``.  For each band the domain
gets a "Gas absorption" component whose 1-D extinction profile is the k
point's profile (ssa 0, isotropic phase: PhysicalPropertiesToDomain.f95:
330-347), and results accumulate as

    total = sum_bands spectral_fraction_b * sum_k w_bk * Results_bk.

The JAX package's two switches ``bake_fastpath`` and ``fuse_k`` become one
``mode`` argument, the broadband namelist's ``spectralMode``: "baked" (the
default), "auto", "fused" or "traced".

  * "baked": one ``Integrator`` per k point, each taking the gas-channel
    fastpath with the k point's profile baked into its plan.  On the card a
    k point only changes the event kernel's by-value parameter block
    (``EventParams.gz``), so a k point costs no compile.
  * "fused" (JAX spectral.py:193-227): one cached fused-k ``Integrator``
    (``gas_k``: every k point of the band in one trace, k a per-lane
    attribute; the fused-k variant of the gas kernel) runs ``n_batches``
    batches of ``n_photons_per_batch * n_k`` photons, so that
    ``n_photons_per_batch`` keeps its per-k meaning; each batch is a whole
    weighted band sample, so ``per_k`` is empty and the stderr comes from
    the batches.  A band without a gas-channel fastpath plan raises a
    ValueError that names why.
  * "traced" (and "auto" on a workload without a fastpath plan) runs every
    k point through the band integrator's general-kernel tracer with that k
    point's optics swapped in (``device_optics_from_flat`` of the domain
    with the k point's gas, the JAX package's optics override,
    spectral.py:273-280).
  * "auto" runs fused when the band can run it and a band batch,
    ``n_photons_per_batch * n_k`` photons, is at most
    ``FUSED_AUTO_MAX_PHOTONS`` (2^25); else baked when the baked plan is a
    fastpath plan; else traced.  The rule is what the card measured (NVIDIA
    H100 80GB HBM3, 700 W; chip_smoke.py phases 46-47, the two modes in
    turns in one process, photons/s the median of three band runs).  The
    fused kernel takes more device time for a band's photons (chain depth
    0: 24.3 against 20.4 ms for the bench band's 2 x 2^24, 20.5 against
    18.1 for its C.1 twin), but the per-batch set-up (the launch sample)
    comes once per band batch instead of once per k point.  So fused wins
    small band batches and baked large ones.  At 2 x 2^24 photons a band
    batch, fused over baked photons/s was 0.95-1.11 on the bench band (the
    step cloud, k = 4e-4 and 4e-3 per m, 2^18 lanes; five calls) and
    1.09-1.22 on the C.1 band (2^20 lanes); at 2 x 2^27, 0.83-0.88 and
    0.93-0.95 (two calls).
    The bench band is near its crossover at 2^25; the C.1 band's lies near
    1e8.  The JAX package's compile-cost crossover
    (``BAKED_CROSSOVER_PHOTONS_PER_K``, a per-k Mosaic compile on the TPU,
    spectral.py:107-185) has no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from i3rc_tpu_torch.core.k_distribution import KDistribution
from i3rc_tpu_torch.core.optics import Domain, flatten_optics
from i3rc_tpu_torch.core.phase_functions import PhaseFunction, PhaseFunctionTable
from i3rc_tpu_torch.integrators.integrator import Integrator, device_optics_from_flat
from i3rc_tpu_torch.parallel.mesh import run_batches, tree_map

GAS_COMPONENT_NAME = "Gas absorption"
MODES = ("auto", "baked", "fused", "traced")
# "auto" runs fused up to this many photons a band batch, baked above (see
# the module note).
FUSED_AUTO_MAX_PHOTONS = 1 << 25


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
    per_k: list           # BatchStats per k point (empty in the fused mode)
    wavelength_limits: tuple
    spectral_fraction: float
    # Standard error of the band mean, a tree matching ``mean``: the k
    # points are independent runs, so sqrt(sum_k (w_k se_k)^2)
    # (monteCarloDriver.f95:358-378); in the fused mode every batch is a
    # band sample, and the batches give it.
    stderr: object


def run_band(integrator: Integrator, base_domain: Domain, kdist: KDistribution, source,
             n_photons_per_batch: int, n_batches: int, seed: int = 10, derive=None,
             mode: str = "baked", integrator_cache: dict | None = None,
             n_lanes: int | None = None, mesh=None) -> BandResult:
    """All k points of one band, each through its own baked integrator, or
    (``mode="traced"``) through ``integrator``'s general kernel with the k
    point's optics, or (``mode="fused"``) all at once through one fused-k
    integrator.

    ``integrator`` supplies the configuration, surface, detectors and
    device (and, traced, the domain shape: ``base_domain`` plus a gas
    component); ``base_domain`` is the domain without gas.  K point k runs
    ``n_batches`` batches of ``n_photons_per_batch`` photons with seed
    ``seed + 1000 * k``; the fused mode runs ``n_batches`` batches of
    ``n_photons_per_batch * n_k`` with seed ``seed``.  ``integrator_cache``
    keeps the per-k and fused integrators (and their tracers) across band
    runs.  ``mode`` is one of ``MODES`` (see the module docstring).
    ``mesh`` spreads every k point's batches over its ranks
    (``parallel.mesh.run_batches``; default ``default_mesh``).
    """
    if mode not in MODES:
        raise ValueError(f"spectral mode must be one of {MODES}, got {mode!r}")
    cache = integrator_cache if integrator_cache is not None else {}
    profiles = kdist.absorption_profiles_on(np.asarray(base_domain.z_edges))

    def creation(gas_profile, **kw) -> Integrator:
        """The band integrator's settings on the base domain plus a gas."""
        return Integrator.create(
            domain_with_gas_component(base_domain, gas_profile),
            config=integrator.config, surface_albedo=integrator.surface.albedo,
            surface=integrator._surface_arg, intensity_mus=integrator._intensity_mus,
            intensity_phis=integrator._intensity_phis, device=integrator.device, **kw)

    def fused_integrator() -> Integrator:
        """The band's cached fused-k integrator, or a ValueError naming why
        the band cannot run fused."""
        ckey = ("fused", id(kdist), id(base_domain))
        if ckey not in cache:
            integ = creation(profiles[:, 0], gas_k=(profiles.T, kdist.weights))
            why = integ.fused_refusal()
            if why:
                raise ValueError(f"spectral mode fused: {why}")
            cache[ckey] = (integ, kdist, base_domain)
        return cache[ckey][0]

    if mode == "auto" and n_photons_per_batch * kdist.n_k <= FUSED_AUTO_MAX_PHOTONS:
        try:
            fused_integrator()
            mode = "fused"
        except ValueError:
            pass
    if mode == "fused":
        stats = run_batches(fused_integrator(), source, n_photons_per_batch * kdist.n_k,
                            n_batches, seed=seed, derive=derive, n_lanes=n_lanes, mesh=mesh)
        return BandResult(mean=stats.mean, per_k=[], wavelength_limits=kdist.wavelength_limits,
                          spectral_fraction=kdist.spectral_fraction, stderr=stats.stderr)

    def k_integrator(k: int) -> Integrator:
        """The baked integrator of k point k."""
        # Entries keep (kdist, base_domain) alive, so that their id()s in
        # the key cannot be reused by other objects.
        ckey = (id(kdist), k, id(base_domain))
        if ckey not in cache:
            cache[ckey] = (creation(profiles[:, k]), kdist, base_domain)
        return cache[ckey][0]

    traced = mode == "traced" or (mode == "auto" and k_integrator(0)._fast_plan is None)

    def k_stats(k: int):
        if not traced:
            return run_batches(k_integrator(k), source, n_photons_per_batch, n_batches,
                               seed=seed + 1000 * k, derive=derive, n_lanes=n_lanes,
                               mesh=mesh)
        optics_k = device_optics_from_flat(
            flatten_optics(domain_with_gas_component(base_domain, profiles[:, k])),
            integrator.config.majorant_block_size, integrator.device)
        return run_batches(integrator, source, n_photons_per_batch, n_batches,
                           seed=seed + 1000 * k, derive=derive, n_lanes=n_lanes,
                           optics_override=optics_k, mesh=mesh)

    per_k, mean, var = [], None, None
    for k in range(kdist.n_k):
        stats = k_stats(k)
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
                  surface=None, intensity_mus=None, intensity_phis=None, band_domains=None,
                  derive=None,
                  mode: str = "baked", integrator_cache: dict | None = None,
                  device="cuda", n_lanes: int | None = None, mesh=None):
    """The spectral loop over bands and their k points.

    ``band_domains`` optionally gives each band its own domain (per-band
    cloud optics); otherwise every band uses ``base_domain``.  The surface
    is ``surface_albedo`` or the ``SurfaceDescription`` ``surface``.  Band b runs
    with seed ``seed + 100000 * b``.  Returns (broadband mean tree, [BandResult
    per band]); the broadband tree is the spectral-fraction-weighted sum of
    the band means.  ``mesh`` goes to every band's ``run_band``.
    """
    results, broadband = [], None
    for b, kdist in enumerate(k_distributions):
        dom_b = band_domains[b] if band_domains is not None else base_domain
        # The band's settings, on its domain with the first k point's gas.
        integ = Integrator.create(
            domain_with_gas_component(
                dom_b, kdist.absorption_profiles_on(np.asarray(dom_b.z_edges))[:, 0]),
            config=config, surface_albedo=surface_albedo, surface=surface,
            intensity_mus=intensity_mus, intensity_phis=intensity_phis, device=device)
        band = run_band(integ, dom_b, kdist, source, n_photons_per_batch, n_batches,
                        seed=seed + 100000 * b, derive=derive, mode=mode,
                        integrator_cache=integrator_cache, n_lanes=n_lanes, mesh=mesh)
        results.append(band)
        contrib = tree_map(lambda a, f=band.spectral_fraction: a * f, band.mean)
        broadband = contrib if broadband is None else tree_map(torch.add, broadband, contrib)
    return broadband, results
