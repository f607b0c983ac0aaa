"""i3rc_tpu_torch — the 3-D Monte Carlo radiative transfer solver on PyTorch.

A port of ``i3rc_tpu`` (JAX/XLA/Pallas on a TPU) to PyTorch and hand-written
CUDA on an NVIDIA Hopper GPU.  The JAX package stays the reference; this
package keeps its own copies of the host modules it needs (domains, phase
tables, namelists, netCDF I/O, result writers, the I3RC scenes; each under
the JAX package's module path) and imports nothing of ``i3rc_tpu`` and never
``jax``.

Layer map:
  utils/        error policy, namelist reader
  core/         Philox random streams, photon sources, domains, phase
                functions, quadrature, k-distributions
  io/           netCDF domain and phase-table files
  models/       the I3RC step cloud and Landsat scenes
  ops/          grid geometry
  integrators/  the fastpath planner and trace loop, results, the Integrator
  kernels/      hand-written CUDA kernels, their plain PyTorch twins, the build
  csrc/         CUDA C++ sources (built with nvcc for sm_90a at first use)
  parallel/     batch statistics
  drivers/      the namelist drivers (monteCarloDriver analog, broadband)
"""

__version__ = "0.1.0"

_EXPORTS = {
    # The host layer: the port's copies of the JAX package's host modules.
    "Domain": "i3rc_tpu_torch.core.optics",
    "PhaseFunction": "i3rc_tpu_torch.core.phase_functions",
    "PhaseFunctionTable": "i3rc_tpu_torch.core.phase_functions",
    "henyey_greenstein_coefficients": "i3rc_tpu_torch.core.phase_functions",
    "KDistribution": "i3rc_tpu_torch.core.k_distribution",
    "IntegratorConfig": "i3rc_tpu_torch.integrators.config",
    "make_step_cloud": "i3rc_tpu_torch.models.step_cloud",
    "write_domains": "i3rc_tpu_torch.models.step_cloud",
    "make_landsat_cloud": "i3rc_tpu_torch.models.landsat_cloud",
    # The port.
    "PhotonSource": "i3rc_tpu_torch.core.illumination",
    "batch_key": "i3rc_tpu_torch.core.rng",
    "Integrator": "i3rc_tpu_torch.integrators.integrator",
    "Results": "i3rc_tpu_torch.integrators.results",
    "run_batches": "i3rc_tpu_torch.parallel.mesh",
    "run_band": "i3rc_tpu_torch.integrators.spectral",
    "run_broadband": "i3rc_tpu_torch.integrators.spectral",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    # Lazy exports keep `import i3rc_tpu_torch` light: torch loads only when
    # the integrator layer is touched.
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'i3rc_tpu_torch' has no attribute '{name}'")
