"""Photon sources: vectorized samplers for initial positions and directions.

Port of ``i3rc_tpu/core/illumination.py`` (Code/monteCarloIllumination.f95).
The source is a declarative spec; ``sample(key, n, device)`` draws the whole
batch from the Philox stream of ``core/rng.py``.  All six reference
constructors are provided:

  directional        solar beam at fixed (mu, azimuth)       (:62-104)
  random_azimuth     fixed mu, random azimuth                (:106-146)
  flux_weighted      global-average flux weighting mu=sqrt(u)(:148-185)
  spotlight          all photons at one (x, y)               (:187-226)
  internal_flux      backward-MC hemispheric detector source (:228-327)
  internal_intensity backward-MC directional detector source (:329-424)

Positions are normalized to [0, 1] and scaled by the integrator, zenith is
the cosine mu (negative = down-going), azimuth in radians.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from i3rc_tpu_torch.utils.errors import Status
from i3rc_tpu_torch.core.rng import STREAM_LAUNCH, PhiloxKey, stream_uniforms

_TWO_PI = 2.0 * np.pi
_TOP_Z = float(np.float32(1.0 - 1.2e-7))  # 1 - spacing(1.), monteCarloIllumination.f95:96
_MIN_MU = float(np.float32(2.4e-38))      # 2 * tiny(mu) guard on vertical components

# Draw rows of one lane's source sample (rng.stream_uniforms layout).
_UX, _UY, _UMU, _UPHI, _UDX, _UDY = range(6)


@dataclass(frozen=True)
class PhotonBatch:
    """Structure-of-arrays photon initial conditions (positions in [0, 1])."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    mu: torch.Tensor
    phi: torch.Tensor

    @property
    def n_photons(self) -> int:
        return self.x.shape[0]


@dataclass(frozen=True)
class PhotonSource:
    """Declarative photon-source specification; ``sample`` draws a batch."""

    kind: str
    solar_mu: float = 0.5
    solar_azimuth: float = 0.0      # degrees, converted at sampling (reference contract)
    solar_x: float = 0.5
    solar_y: float = 0.5
    detector_x: float = 0.5
    detector_y: float = 0.5
    detector_z: float = 0.5
    detector_points_up: bool = True
    detector_mu: float = 1.0
    detector_phi: float = 0.0       # degrees
    delta_x: float = 0.0
    delta_y: float = 0.0

    # --- constructors -------------------------------------------------------
    @staticmethod
    def directional(solar_mu: float, solar_azimuth: float) -> "PhotonSource":
        s = Status()
        s.fail_if(not (0.0 <= solar_azimuth <= 360.0), "solarAzimuth out of bounds")
        s.fail_if(abs(solar_mu) > 1.0 or abs(solar_mu) < 1e-30, "solarMu out of bounds")
        s.check("PhotonSource.directional")
        return PhotonSource("directional", solar_mu=solar_mu, solar_azimuth=solar_azimuth)

    @staticmethod
    def random_azimuth(solar_mu: float) -> "PhotonSource":
        s = Status()
        s.fail_if(abs(solar_mu) > 1.0 or abs(solar_mu) < 1e-30, "solarMu out of bounds")
        s.check("PhotonSource.random_azimuth")
        return PhotonSource("random_azimuth", solar_mu=solar_mu)

    @staticmethod
    def flux_weighted() -> "PhotonSource":
        return PhotonSource("flux_weighted")

    @staticmethod
    def spotlight(solar_mu, solar_azimuth, solar_x, solar_y) -> "PhotonSource":
        s = Status()
        s.fail_if(not (0.0 <= solar_azimuth <= 360.0), "solarAzimuth out of bounds")
        s.fail_if(abs(solar_mu) > 1.0 or abs(solar_mu) < 1e-30, "solarMu out of bounds")
        s.fail_if(not (0.0 < solar_x <= 1.0 and 0.0 < solar_y <= 1.0),
                  "x and y positions must be between 0 and 1")
        s.check("PhotonSource.spotlight")
        return PhotonSource("spotlight", solar_mu=solar_mu, solar_azimuth=solar_azimuth,
                            solar_x=solar_x, solar_y=solar_y)

    @staticmethod
    def internal_flux(detector_x, detector_y, detector_z, detector_points_up,
                      delta_x=0.0, delta_y=0.0) -> "PhotonSource":
        s = Status()
        s.fail_if(not (0.0 < detector_x <= 1.0 and 0.0 < detector_y <= 1.0
                       and 0.0 < detector_z <= 1.0),
                  "x, y, z positions must be between 0 and 1")
        s.fail_if(detector_x + delta_x / 2 > 1.0 or detector_x - delta_x / 2 <= 0.0,
                  "finite detector extends past the x bounds")
        s.fail_if(detector_y + delta_y / 2 > 1.0 or detector_y - delta_y / 2 <= 0.0,
                  "finite detector extends past the y bounds")
        s.warn_if(detector_points_up and detector_z > 1.0 - 3e-7,
                  "detector is at the top of the domain pointed up")
        s.warn_if((not detector_points_up) and detector_z < 5e-38,
                  "detector is at the bottom of the domain pointed down")
        s.check("PhotonSource.internal_flux")
        return PhotonSource("internal_flux", detector_x=detector_x, detector_y=detector_y,
                            detector_z=detector_z, detector_points_up=detector_points_up,
                            delta_x=delta_x, delta_y=delta_y)

    @staticmethod
    def internal_intensity(detector_x, detector_y, detector_z, detector_mu, detector_phi,
                           delta_x=0.0, delta_y=0.0) -> "PhotonSource":
        s = Status()
        s.fail_if(not (0.0 < detector_x <= 1.0 and 0.0 < detector_y <= 1.0
                       and 0.0 < detector_z <= 1.0),
                  "x, y, z positions must be between 0 and 1")
        s.fail_if(not (0.0 <= detector_phi <= 360.0), "detectorPhi out of bounds")
        s.fail_if(abs(detector_mu) > 1.0 or abs(detector_mu) < 1e-30,
                  "detectorMu out of bounds")
        s.check("PhotonSource.internal_intensity")
        return PhotonSource("internal_intensity", detector_x=detector_x,
                            detector_y=detector_y, detector_z=detector_z,
                            detector_mu=detector_mu, detector_phi=detector_phi,
                            delta_x=delta_x, delta_y=delta_y)

    # --- sampling -------------------------------------------------------------
    def sample(self, key: PhiloxKey, n_photons: int, device,
               stream: int = STREAM_LAUNCH, block: int = 0,
               lanes: torch.Tensor | None = None) -> PhotonBatch:
        """Draw the initial conditions for a batch of n photons.

        Lane i's draws come from counter (i, block, group, stream) under
        ``key``; the trace loop's refill passes ``STREAM_REFILL`` and its
        block index.  ``lanes`` (n_photons lane indices) draws only those
        lanes' samples, in that order.
        """
        if self.kind not in ("directional", "random_azimuth", "flux_weighted",
                             "spotlight", "internal_flux", "internal_intensity"):
            raise ValueError(f"unknown photon source kind '{self.kind}'")
        n_groups = 2 if (self.delta_x > 0 or self.delta_y > 0) else 1
        u = stream_uniforms(key, stream, block, n_groups, n_photons, device, lanes)
        full = lambda v: torch.full((n_photons,), float(v), dtype=torch.float32,
                                    device=device)
        top = full(_TOP_Z)

        if self.kind == "directional":
            return PhotonBatch(u[_UX], u[_UY], top, full(-abs(self.solar_mu)),
                               full(np.deg2rad(self.solar_azimuth)))
        if self.kind == "random_azimuth":
            return PhotonBatch(u[_UX], u[_UY], top, full(-abs(self.solar_mu)),
                               u[_UPHI] * _TWO_PI)
        if self.kind == "flux_weighted":
            # mu = -sqrt(u) gives flux equally weighted in mu (:148-185).
            return PhotonBatch(u[_UX], u[_UY], top, -torch.sqrt(u[_UMU]),
                               u[_UPHI] * _TWO_PI)
        if self.kind == "spotlight":
            return PhotonBatch(full(self.solar_x), full(self.solar_y), top,
                               full(-abs(self.solar_mu)),
                               full(np.deg2rad(self.solar_azimuth)))
        x = full(self.detector_x)
        y = full(self.detector_y)
        if self.delta_x > 0:
            x = x + self.delta_x * (1.0 - 0.5 * u[_UDX])
        if self.delta_y > 0:
            y = y + self.delta_y * (1.0 - 0.5 * u[_UDY])
        if self.kind == "internal_flux":
            # Hemispheric source: mu = +-sqrt(u), clamped away from zero so
            # photons in extinction-free layers cannot travel forever
            # (monteCarloIllumination.f95:294-307).
            mu = torch.clamp(torch.sqrt(u[_UMU]), min=_MIN_MU)
            if not self.detector_points_up:
                mu = -mu
            z = (max(self.detector_z, 5e-38) if self.detector_points_up
                 else min(self.detector_z, 1.0 - 1.2e-7))
            return PhotonBatch(x, y, full(np.float32(z)), mu, u[_UPHI] * _TWO_PI)
        z = (max(self.detector_z, 5e-38) if self.detector_mu > 0
             else min(self.detector_z, 1.0 - 1.2e-7))
        return PhotonBatch(x, y, full(np.float32(z)), full(self.detector_mu),
                           full(np.deg2rad(self.detector_phi)))
