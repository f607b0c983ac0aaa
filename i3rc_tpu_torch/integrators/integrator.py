"""The user-facing Monte Carlo integrator, on a PyTorch device.

Port of ``i3rc_tpu/integrators/integrator.py:155-476``:

    integ = Integrator.create(domain, config=..., device="cuda")
    results = integ.compute(batch_key(seed, batch), source, n_photons)

The surface is black by default, a Lambertian albedo with
``surface_albedo=A``, or a ``SurfaceDescription`` with ``surface=`` (a
uniform lambertian, rpv, cox_munk or ross_li BRDF, or a gridded one).

``create`` flattens the domain once (host numpy, shared with the JAX
package), validates the arguments and, as the JAX package does, turns on
super-voxel majorants of 8 cells on domains above 2^18 cells, and there,
with radiance detectors and no estimator chosen, ratio-tracking
transmittance (with the JAX package's I3RCWarning).  ``batch_tracer``
dispatches as the JAX package does: the fastpath when it has a plan, else
the general kernel (``wavefront.make_batch_tracer``; its packed optics,
inverse-CDF and, with detectors, forward phase tables are built at first
use).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, replace

import numpy as np
import torch

from i3rc_tpu_torch.core.optics import Domain, FlatOptics, flatten_optics
from i3rc_tpu_torch.core.surface import BRDF_REGISTRY, SurfaceDescription
from i3rc_tpu_torch.integrators.config import IntegratorConfig
from i3rc_tpu_torch.utils.errors import I3RCWarning, Status
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
from i3rc_tpu_torch.integrators.tables import (
    build_forward_tables,
    build_inverse_cubic,
    hybridize,
)
from i3rc_tpu_torch.integrators.wavefront import (
    ONEHOT_MAX_ROWS,
    DeviceOptics,
    DeviceTables,
    IntensitySpec,
    SurfaceSpec,
    make_batch_tracer,
)
from i3rc_tpu_torch.ops.dda import EXIT_BOT as _EXIT_BOT
from i3rc_tpu_torch.ops.dda import EXIT_TOP as _EXIT_TOP
from i3rc_tpu_torch.ops.dda import GridGeometry


def majorant_block_shape(grid_shape, block_size: int):
    """Per-axis block sizes: the largest divisor of each axis <= block_size;
    None for block_size 0 (one global majorant, :439)."""
    if block_size <= 0:
        return None

    def best_divisor(n):
        b = min(block_size, n)
        while n % b:
            b -= 1
        return b

    return tuple(best_divisor(n) for n in grid_shape)


def block_majorants(total_ext: np.ndarray, blocks) -> np.ndarray:
    """Per-super-voxel maximum extinction, flattened C-order."""
    nx, ny, nz = total_ext.shape
    bx, by, bz = blocks
    r = total_ext.reshape(nx // bx, bx, ny // by, by, nz // bz, bz)
    return r.max(axis=(1, 3, 5)).ravel()


def device_optics_from_flat(flat: FlatOptics, majorant_block_size: int = 0,
                            device="cpu") -> DeviceOptics:
    """Pack FlatOptics into the general kernel's device optics (JAX
    integrator.py:75-119): the packed per-cell row with the co-albedo, the
    block majorants, and the single-component uniformity flags (only cells
    with extinction count)."""
    n_cells = flat.total_ext.size
    n_comp = flat.n_components
    cell_matrix = np.concatenate([
        flat.total_ext.reshape(n_cells, 1),
        flat.cumulative_ext.reshape(n_cells, n_comp),
        1.0 - flat.ssa.reshape(n_cells, n_comp),
        flat.phase_index.reshape(n_cells, n_comp).astype(np.float32),
    ], axis=1).astype(np.float32)
    blocks = majorant_block_shape(flat.total_ext.shape, majorant_block_size)
    majorant = (block_majorants(flat.total_ext, blocks) if blocks
                else np.zeros(0, np.float32))
    flags = optics_flags(flat)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    return DeviceOptics(
        cell_matrix=t(cell_matrix), total_ext=t(flat.total_ext.ravel()),
        max_extinction=float(np.float32(flat.max_extinction)),
        block_majorant=t(majorant), n_components=n_comp,
        uniform_ssa=flags.uniform_ssa, uniform_phase_index=flags.uniform_phase_index)


def coarse_geometry(domain: Domain, blocks, device="cpu") -> GridGeometry:
    """Super-voxel grid geometry: every (bx, by, bz)-th fine edge."""
    bx, by, bz = blocks
    return GridGeometry.from_edges(
        np.asarray(domain.x_edges)[::bx], np.asarray(domain.y_edges)[::by],
        np.asarray(domain.z_edges)[::bz], domain.xy_regularly_spaced,
        domain.z_regularly_spaced, device=device)


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
    _surface_arg: SurfaceDescription | None = None
    # The super-voxel grid of Woodcock transport (majorant_block_size > 0).
    coarse_geometry: GridGeometry | None = None

    @staticmethod
    def create(domain: Domain, config: IntegratorConfig | None = None,
               surface_albedo: float = 0.0, surface: SurfaceDescription | None = None,
               intensity_mus=None, intensity_phis=None, device="cuda") -> "Integrator":
        """new_Integrator + specifyParameters in one constructor."""
        dev = resolve_device(device)
        config = (config or IntegratorConfig()).validate()
        s = Status()
        s.fail_if(surface is not None and surface_albedo != 0.0,
                  "only one surface specification can be provided")
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
        # Domains above the one-hot read regime default to super-voxel
        # Woodcock transport with blocks of 8 cells (JAX integrator.py:
        # 211-218); an explicit majorant_block_size wins.
        if config.majorant_block_size == 0 and flat.total_ext.size > ONEHOT_MAX_ROWS:
            config = replace(config, majorant_block_size=8)
        if (intensity_mus is not None and flat.total_ext.size > ONEHOT_MAX_ROWS
                and config.majorant_block_size > 0
                and not config.use_ratio_tracking_for_intensity
                and not config.use_russian_roulette_for_intensity):
            # Local estimation on large domains: ratio tracking unless an
            # estimator was chosen (JAX integrator.py:219-239).
            warnings.warn(
                "large domain with radiance detectors: enabling ratio-"
                "tracking transmittance (unbiased; set "
                "use_russian_roulette_for_intensity for the Iwabuchi "
                "estimator instead)", I3RCWarning, stacklevel=2)
            config = replace(config, use_ratio_tracking_for_intensity=True)
        blocks = majorant_block_shape(flat.total_ext.shape, config.majorant_block_size)
        if intensity_mus is not None:
            phis_rad = np.deg2rad(phis)
            sin_t = np.sqrt(np.maximum(1.0 - mus ** 2, 0.0))
            ispec = IntensitySpec(
                directions=np.stack([sin_t * np.cos(phis_rad), sin_t * np.sin(phis_rad),
                                     mus]).astype(np.float32),
                abs_mu=np.abs(mus).astype(np.float32),
                exit_status=np.where(mus > 0, _EXIT_TOP, _EXIT_BOT).astype(np.int32),
                n_directions=mus.size)
        if surface is not None:
            sspec = SurfaceSpec(
                brdf_fn=BRDF_REGISTRY[surface.brdf_name], brdf_name=surface.brdf_name,
                params=surface.parameters.reshape(-1, surface.n_parameters),
                x_edges=surface.x_edges, y_edges=surface.y_edges,
                n_xs=surface.parameters.shape[0], n_ys=surface.parameters.shape[1])
        else:
            sspec = SurfaceSpec(albedo=float(surface_albedo))
        return Integrator(
            geometry=geom, optics=optics_flags(flat), surface=sspec, intensity=ispec,
            config=config, device=dev, _flat=flat,
            _col_weights=column_weights(domain.x_edges, domain.y_edges),
            _dz=np.diff(np.asarray(domain.z_edges, dtype=np.float64)).astype(np.float32),
            _intensity_mus=mus, _intensity_phis=phis, _surface_arg=surface,
            coarse_geometry=coarse_geometry(domain, blocks, dev) if blocks else None)

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

    def _cached(self, name: str, build):
        if name not in self.__dict__:
            self.__dict__[name] = build()
        return self.__dict__[name]

    @property
    def device_optics(self) -> DeviceOptics:
        """The general kernel's packed optics, built at first use."""
        return self._cached("_device_optics", lambda: device_optics_from_flat(
            self._flat, self.config.majorant_block_size, self.device))

    @property
    def tables(self) -> DeviceTables:
        """The inverse-CDF cubic tables of every component and, with
        detectors, the forward phase tables (hybridized when the config
        asks for hybrid phase functions; JAX integrator.py:248-265), built
        at first use."""
        def build():
            cubic = build_inverse_cubic(self._flat)
            t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32).ravel(),
                                          device=self.device)
            fwd = fwd_orig = None
            n_fwd = 0
            if self.intensity is not None:
                cfg = self.config
                n_fwd = cfg.min_forward_table_size
                orig = build_forward_tables(self._flat, n_fwd)
                hybrid = (hybridize(orig, cfg.hybrid_phase_fun_width)
                          if cfg.use_hybrid_phase_funs and cfg.hybrid_phase_fun_width > 0.0
                          else orig)
                fwd, fwd_orig = t(hybrid), t(orig)
            return DeviceTables(
                inverse_cubic=torch.as_tensor(cubic.reshape(-1, 4), device=self.device),
                n_segments=cubic.shape[2], max_entries=cubic.shape[1], forward=fwd,
                forward_orig=fwd_orig, n_forward_steps=n_fwd)
        return self._cached("_tables", build)

    def general_tracer(self, n_photons: int, n_lanes: int | None = None):
        """The general kernel's (key, PhotonBatch, source, optics_override)
        -> RawTallies function, whether or not a fastpath plan exists."""
        return make_batch_tracer(self.geometry, self.device_optics, self.tables,
                                 self.surface, self.intensity, self.config, n_photons,
                                 n_lanes, coarse_geom=self.coarse_geometry)

    def batch_tracer(self, n_photons: int, n_lanes: int | None = None):
        """The raw (key, PhotonBatch, source[, optics_override]) -> RawTallies
        function: the fastpath when it has a plan, else the general kernel
        (JAX integrator.py:334-390); an optics override (the spectral loop's
        traced mode) always takes the general kernel."""
        plan = self._fast_plan
        if plan is None:
            return self.general_tracer(n_photons, n_lanes)
        fast = make_fast_tracer(self.geometry, plan, self.config, n_photons, n_lanes)
        general = []

        def trace(key, batch, source, optics_override=None):
            if optics_override is None:
                return fast(key, batch, source)
            if not general:
                general.append(self.general_tracer(n_photons, n_lanes))
            return general[0](key, batch, source, optics_override)

        return trace

    def batch_fn(self, source: PhotonSource, n_photons: int,
                 n_lanes: int | None = None):
        """(key[, optics_override]) -> Results for one batch; cached per
        (source, sizes).  The override swaps in other optics of the same
        shape (``device_optics_from_flat``) through the general kernel: the
        spectral loop's traced mode."""
        cache = self.__dict__.setdefault("_batch_fn_cache", {})
        lanes = lane_width(n_photons, n_lanes)
        cache_key = (source, int(n_photons), lanes)
        if cache_key not in cache:
            tracer = self.batch_tracer(n_photons, lanes)
            n_x, n_y, n_z = self.grid_shape
            n_dirs = self.intensity.n_directions if self.intensity else 0

            @torch.inference_mode()
            def run(key: PhiloxKey, optics_override: DeviceOptics | None = None) -> Results:
                batch = source.sample(key, lanes, self.device)
                raw = (tracer(key, batch, source) if optics_override is None
                       else tracer(key, batch, source, optics_override))
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
