"""The user-facing Monte Carlo integrator, on a PyTorch device.

Port of ``i3rc_tpu/integrators/integrator.py:155-476`` for the fastpath
slice:

    integ = Integrator.create(domain, config=..., device="cuda")
    results = integ.compute(batch_key(seed, batch), source, n_photons)

``create`` flattens the domain once (host numpy, shared with the JAX
package) and validates the arguments; ``batch_fn`` builds the fastpath
tracer for one (source, photon count, lane count) and caches it.  Workloads
the fastpath cannot express would need the general wavefront kernel, which
is not ported yet: they raise NotImplementedError instead of falling back.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from i3rc_tpu_torch.core.optics import Domain, FlatOptics, flatten_optics
from i3rc_tpu_torch.integrators.config import IntegratorConfig
from i3rc_tpu_torch.utils.errors import Status
from i3rc_tpu_torch.core.illumination import PhotonSource
from i3rc_tpu_torch.core.rng import PhiloxKey
from i3rc_tpu_torch.integrators.fastpath import (
    OpticsFlags,
    fast_plan,
    lane_width,
    make_fast_tracer,
    optics_flags,
)
from i3rc_tpu_torch.integrators.results import Results, column_weights, normalize_tallies
from i3rc_tpu_torch.integrators.wavefront import IntensitySpec, SurfaceSpec
from i3rc_tpu_torch.ops.dda import GridGeometry

# ops/dda.py status codes of the exit directions.
_EXIT_TOP, _EXIT_BOT = 2, 3


def resolve_device(device) -> torch.device:
    """The torch device to run on; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch finds no CUDA device")
    return dev


@dataclass(frozen=True)
class Integrator:
    """Immutable radiative transfer solver for one domain on one device."""

    geometry: GridGeometry
    optics: OpticsFlags
    surface: SurfaceSpec
    intensity: IntensitySpec | None
    config: IntegratorConfig
    device: torch.device
    _flat: FlatOptics
    _col_weights: np.ndarray
    _dz: np.ndarray
    # The creation arguments the spectral loop re-uses for every k point.
    _intensity_mus: np.ndarray | None = None
    _intensity_phis: np.ndarray | None = None

    @staticmethod
    def create(domain: Domain, config: IntegratorConfig | None = None,
               surface_albedo: float = 0.0, intensity_mus=None, intensity_phis=None,
               device="cuda") -> "Integrator":
        """new_Integrator + specifyParameters in one constructor."""
        dev = resolve_device(device)
        config = (config or IntegratorConfig()).validate()
        s = Status()
        s.fail_if(not (0.0 <= surface_albedo <= 1.0), "surface albedo out of range")
        s.fail_if((intensity_mus is None) != (intensity_phis is None),
                  "both or neither of intensityMus and intensityPhis must be supplied")
        ispec = mus = phis = None
        if intensity_mus is not None:
            mus = np.atleast_1d(np.asarray(intensity_mus, dtype=np.float64))
            phis = np.atleast_1d(np.asarray(intensity_phis, dtype=np.float64))
            s.fail_if(mus.size != phis.size,
                      "intensityMus and intensityPhis must be the same length")
            s.fail_if(bool(np.any(np.abs(mus) > 1.0)), "intensityMus must be in [-1, 1]")
            s.fail_if(bool(np.any(np.abs(mus) < 1e-30)),
                      "intensityMus can't be 0 (directly sideways)")
            s.fail_if(bool(np.any((phis < 0.0) | (phis > 360.0))),
                      "intensityPhis must be between 0 and 360")
        s.check("Integrator.create")

        flat = flatten_optics(domain)
        geom = GridGeometry.from_edges(domain.x_edges, domain.y_edges, domain.z_edges,
                                       domain.xy_regularly_spaced,
                                       domain.z_regularly_spaced, device=dev)
        if intensity_mus is not None:
            phis_rad = np.deg2rad(phis)
            sin_t = np.sqrt(np.maximum(1.0 - mus ** 2, 0.0))
            ispec = IntensitySpec(
                directions=np.stack([sin_t * np.cos(phis_rad), sin_t * np.sin(phis_rad),
                                     mus]).astype(np.float32),
                abs_mu=np.abs(mus).astype(np.float32),
                exit_status=np.where(mus > 0, _EXIT_TOP, _EXIT_BOT).astype(np.int32),
                n_directions=mus.size)
        return Integrator(
            geometry=geom, optics=optics_flags(flat),
            surface=SurfaceSpec(albedo=float(surface_albedo)), intensity=ispec,
            config=config, device=dev, _flat=flat,
            _col_weights=column_weights(domain.x_edges, domain.y_edges),
            _dz=np.diff(np.asarray(domain.z_edges, dtype=np.float64)).astype(np.float32),
            _intensity_mus=mus, _intensity_phis=phis)

    @property
    def grid_shape(self):
        return (self.geometry.n_x, self.geometry.n_y, self.geometry.n_z)

    @property
    def _fast_plan(self):
        """The (host-side) fastpath plan, computed once per integrator."""
        if "_fast_plan_cache" not in self.__dict__:
            self.__dict__["_fast_plan_cache"] = fast_plan(
                self.geometry, self._flat, self.optics, self.surface,
                self.intensity, self.config)
        return self.__dict__["_fast_plan_cache"]

    def batch_tracer(self, n_photons: int, n_lanes: int | None = None):
        """The raw (key, PhotonBatch, source) -> RawTallies function."""
        plan = self._fast_plan
        if plan is None:
            raise NotImplementedError(
                "this workload needs the general wavefront kernel: ROADMAP item 16")
        return make_fast_tracer(self.geometry, plan, self.config, n_photons, n_lanes)

    def batch_fn(self, source: PhotonSource, n_photons: int,
                 n_lanes: int | None = None):
        """key -> Results for one batch; cached per (source, sizes)."""
        cache = self.__dict__.setdefault("_batch_fn_cache", {})
        lanes = lane_width(n_photons, n_lanes)
        cache_key = (source, int(n_photons), lanes)
        if cache_key not in cache:
            tracer = self.batch_tracer(n_photons, lanes)
            n_x, n_y, n_z = self.grid_shape
            n_dirs = self.intensity.n_directions if self.intensity else 0

            @torch.inference_mode()
            def run(key: PhiloxKey) -> Results:
                batch = source.sample(key, lanes, self.device)
                raw = tracer(key, batch, source)
                return normalize_tallies(raw, n_x, n_y, n_z, n_dirs,
                                         self.optics.n_components, self._col_weights,
                                         self._dz)

            cache[cache_key] = run
        return cache[cache_key]

    def compute(self, key: PhiloxKey, source: PhotonSource, n_photons: int) -> Results:
        """Trace one batch of photons and return normalized results.

        The computeRadiativeTransfer analog (:262-398).  ``key`` is the batch
        stream, e.g. ``rng.batch_key(seed, batch_index)``.
        """
        return self.batch_fn(source, n_photons)(key)
