"""Surface reflection: uniform or gridded BRDF parameters with a kernel.

Port of ``i3rc_tpu/core/surface.py`` (Code/surfaceProperties.f95): a
surface is an x/y grid of BRDF parameter vectors, and the reflectance is a
kernel R(params, mu_in, mu_out, phi_in, phi_out).  The four registered
kernels are torch functions on float32 tensors that follow the JAX kernels
operation by operation: integer powers as the products ``jnp.power`` forms
(x**4 as (x*x)*(x*x)), float powers with ``torch.pow``, Smith's Lambda with
``torch.special.erfc``, and divisions by a constant as tensor-by-tensor
divisions (torch's CUDA division by a Python scalar multiplies by its
reciprocal).  The surface stage of the CUDA event block
(``csrc/fast_event_block.cuh`` ``brdf_reflectance``) evaluates the same
operations in the same order, so the kernel and this plain version agree.

Angles are the transport kernel's convention: mu_* are propagation-
direction z cosines (mu_in < 0 arriving at the bottom boundary), phi_* are
propagation azimuths in radians.  ``params`` is a sequence of float32
values (a uniform surface's vector) or of tensors broadcastable against
the angles.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from i3rc_tpu_torch.utils.errors import Status


def _f32(v) -> float:
    return float(np.float32(v))


PI = _f32(np.pi)
HALF_PI = _f32(np.pi / 2.0)
QUARTER_PI = _f32(np.pi / 4.0)
SQRT_PI = _f32(np.sqrt(np.float32(np.pi)))   # jnp.sqrt(jnp.pi), in float32


def _div(a, c: float):
    """a / c with c a float32 constant, as a true division."""
    return a / torch.full_like(a, c)


def _param(params, i: int, like):
    p = params[i]
    return p if isinstance(p, torch.Tensor) else torch.full_like(like, _f32(p))


def lambertian_brdf(params, mu_in, mu_out, phi_in, phi_out):
    """Lambertian albedo: reflectance = parameter 1 (surfaceProperties.f95:154-162)."""
    return _param(params, 0, mu_in) + torch.zeros_like(mu_out)


def rpv_brdf(params, mu_in, mu_out, phi_in, phi_out):
    """RPV BRDF with params = (rho0, k, theta_hg); returns directional reflectance."""
    rho0, k, theta = (_param(params, i, mu_in) for i in range(3))
    mu_i = torch.abs(mu_in)
    mu_r = torch.abs(mu_out)
    sin_i = torch.sqrt(torch.clamp(1.0 - mu_i * mu_i, min=0.0))
    sin_r = torch.sqrt(torch.clamp(1.0 - mu_r * mu_r, min=0.0))
    cos_dphi = torch.cos(phi_in - phi_out)
    cos_g = mu_i * mu_r + sin_i * sin_r * cos_dphi
    g_hg = (1.0 - theta * theta) / torch.pow(1.0 + theta * theta + 2.0 * theta * cos_g, 1.5)
    tan_i = sin_i / torch.clamp(mu_i, min=_f32(1e-6))
    tan_r = sin_r / torch.clamp(mu_r, min=_f32(1e-6))
    big_g = torch.sqrt(torch.clamp(tan_i * tan_i + tan_r * tan_r
                                   - 2.0 * tan_i * tan_r * cos_dphi, min=0.0))
    hot = 1.0 + (1.0 - rho0) / (1.0 + big_g)
    m = torch.pow(mu_i * mu_r * (mu_i + mu_r), k - 1.0)
    return rho0 * m * g_hg * hot


def _smith_lambda(mu, sigma):
    sin_t = torch.sqrt(torch.clamp(1.0 - mu * mu, min=_f32(1e-12)))
    a = torch.clamp(mu / (sin_t * sigma), min=_f32(1e-4))
    return 0.5 * (torch.exp(-a * a) / (a * SQRT_PI) - torch.special.erfc(a))


def cox_munk_brdf(params, mu_in, mu_out, phi_in, phi_out):
    """Cox-Munk ocean sun-glint BRDF; params = (wind_speed m/s, refractive index).

    Isotropic Gaussian wave slopes (Cox & Munk 1954), unpolarized Fresnel
    reflection off the tilted facet and Smith's shadowing factor; returns
    the reflectance factor pi * f_r (i3rc_tpu/core/surface.py:50-115).
    """
    wind, n_re = _param(params, 0, mu_in), _param(params, 1, mu_in)
    mu_i = torch.clamp(torch.abs(mu_in), min=_f32(1e-3))
    mu_r = torch.clamp(torch.abs(mu_out), min=_f32(1e-3))
    sin_i = torch.sqrt(torch.clamp(1.0 - mu_i * mu_i, min=0.0))
    sin_r = torch.sqrt(torch.clamp(1.0 - mu_r * mu_r, min=0.0))
    cos_dphi = torch.cos(phi_out - phi_in)
    dot_ir = sin_i * sin_r * cos_dphi - mu_i * mu_r
    v_norm = torch.sqrt(torch.clamp(2.0 - 2.0 * dot_ir, min=_f32(1e-12)))
    cos_beta = torch.clamp((mu_i + mu_r) / v_norm, _f32(1e-3), 1.0)
    cos_w = torch.clamp(0.5 * v_norm, _f32(1e-6), 1.0)
    cb2 = cos_beta * cos_beta
    tan2_beta = (1.0 - cb2) / cb2
    sigma2 = _f32(0.003) + _f32(0.00512) * wind
    slope_pdf = torch.exp(-tan2_beta / sigma2) / (PI * sigma2)
    sin_w = torch.sqrt(torch.clamp(1.0 - cos_w * cos_w, min=0.0))
    sin_t = torch.clamp(sin_w / n_re, 0.0, 1.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_s = (cos_w - n_re * cos_t) / (cos_w + n_re * cos_t)
    r_p = (n_re * cos_w - cos_t) / (n_re * cos_w + cos_t)
    fresnel = 0.5 * (r_s * r_s + r_p * r_p)
    f_r = slope_pdf * fresnel / (4.0 * mu_i * mu_r * (cb2 * cb2))
    sigma = torch.sqrt(sigma2)
    shadow = torch.reciprocal(1.0 + _smith_lambda(mu_i, sigma) + _smith_lambda(mu_r, sigma))
    return PI * f_r * shadow


def ross_li_brdf(params, mu_in, mu_out, phi_in, phi_out):
    """Li-Sparse-Ross-Thick (MODIS kernel) BRDF; params = (f_iso, f_vol, f_geo).

    RossThick + LiSparse-Reciprocal with h/b = 2, b/r = 1, clamped at 0; the
    hotspot at opposing propagation azimuths (i3rc_tpu/core/surface.py:118-158).
    """
    f_iso, f_vol, f_geo = (_param(params, i, mu_in) for i in range(3))
    mu_i = torch.clamp(torch.abs(mu_in), min=_f32(1e-3))
    mu_r = torch.clamp(torch.abs(mu_out), min=_f32(1e-3))
    sin_i = torch.sqrt(torch.clamp(1.0 - mu_i * mu_i, min=0.0))
    sin_r = torch.sqrt(torch.clamp(1.0 - mu_r * mu_r, min=0.0))
    cos_rel = -torch.cos(phi_out - phi_in)
    sin_rel = torch.sin(phi_out - phi_in)
    cos_xi = torch.clamp(mu_i * mu_r + sin_i * sin_r * cos_rel, -1.0, 1.0)
    xi = torch.arccos(cos_xi)
    k_vol = (((HALF_PI - xi) * cos_xi + torch.sin(xi)) / (mu_i + mu_r) - QUARTER_PI)
    tan_i = sin_i / mu_i
    tan_r = sin_r / mu_r
    sec_i = torch.reciprocal(mu_i)
    sec_r = torch.reciprocal(mu_r)
    d2 = torch.clamp(tan_i * tan_i + tan_r * tan_r - 2.0 * tan_i * tan_r * cos_rel, min=0.0)
    tts = tan_i * tan_r * sin_rel
    cos_t = torch.clamp(2.0 * torch.sqrt(d2 + tts * tts) / (sec_i + sec_r), -1.0, 1.0)
    t = torch.arccos(cos_t)
    overlap = _div((t - torch.sin(t) * cos_t) * (sec_i + sec_r), PI)
    k_geo = overlap - sec_i - sec_r + 0.5 * (1.0 + cos_xi) * sec_i * sec_r
    return torch.clamp(f_iso + f_vol * k_vol + f_geo * k_geo, min=0.0)


BRDF_REGISTRY = {"lambertian": lambertian_brdf, "rpv": rpv_brdf,
                 "cox_munk": cox_munk_brdf, "ross_li": ross_li_brdf}


@dataclass(frozen=True)
class SurfaceDescription:
    """x/y-gridded BRDF parameters (type surfaceDescription, surfaceProperties.f95:34-38)."""

    x_edges: np.ndarray            # (nx_s + 1,)
    y_edges: np.ndarray            # (ny_s + 1,)
    parameters: np.ndarray         # (nx_s, ny_s, n_params) float32
    brdf_name: str = "lambertian"

    @staticmethod
    def create(parameters, x_edges, y_edges, brdf_name="lambertian") -> "SurfaceDescription":
        """newSurfaceDescriptionXY analog (surfaceProperties.f95:60-96);
        ``parameters`` is (nx_s, ny_s, n_params), parameters innermost."""
        parameters = np.asarray(parameters, dtype=np.float32)
        x_edges = np.asarray(x_edges, dtype=np.float64)
        y_edges = np.asarray(y_edges, dtype=np.float64)
        s = Status()
        s.fail_if(brdf_name not in BRDF_REGISTRY,
                  f"unknown BRDF '{brdf_name}'; registered: {sorted(BRDF_REGISTRY)}")
        s.fail_if(parameters.ndim != 3, "parameters must be (nx, ny, n_params)")
        if parameters.ndim == 3:
            s.fail_if(parameters.shape[0] != x_edges.size - 1
                      or parameters.shape[1] != y_edges.size - 1,
                      "position vectors are the wrong length for the parameter grid")
        s.fail_if(bool(np.any(np.diff(x_edges) <= 0.0) | np.any(np.diff(y_edges) <= 0.0)),
                  "positions must be unique and increasing")
        if brdf_name == "lambertian" and parameters.ndim == 3:
            s.fail_if(bool(np.any((parameters[..., 0] < 0.0) | (parameters[..., 0] > 1.0))),
                      "Lambertian surface reflectance must be between 0 and 1")
        s.check("SurfaceDescription.create")
        return SurfaceDescription(x_edges, y_edges, parameters, brdf_name)

    @staticmethod
    def uniform(parameters, brdf_name="lambertian") -> "SurfaceDescription":
        """Horizontally uniform surface (newSurfaceUniform, surfaceProperties.f95:98-117)."""
        params = np.asarray(parameters, dtype=np.float32)[None, None, :]
        big = np.finfo(np.float32).max
        return SurfaceDescription.create(params, np.array([0.0, big]), np.array([0.0, big]),
                                         brdf_name)

    @property
    def n_parameters(self) -> int:
        return self.parameters.shape[-1]

    @property
    def is_uniform(self) -> bool:
        return self.parameters.shape[0] == 1 and self.parameters.shape[1] == 1

    def reflectance_host(self, x, y, mu_in, mu_out, phi_in, phi_out):
        """Host-side reference implementation (computeSurfaceReflectance analog)."""
        x0, x1 = self.x_edges[0], self.x_edges[-1]
        y0, y1 = self.y_edges[0], self.y_edges[-1]
        xp = x0 + np.mod(x - x0, x1 - x0)
        yp = y0 + np.mod(y - y0, y1 - y0)
        ix = np.clip(np.searchsorted(self.x_edges, xp, side="right") - 1, 0,
                     self.parameters.shape[0] - 1)
        iy = np.clip(np.searchsorted(self.y_edges, yp, side="right") - 1, 0,
                     self.parameters.shape[1] - 1)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        params = t(self.parameters[ix, iy])
        fn = BRDF_REGISTRY[self.brdf_name]
        return fn([params[..., k] for k in range(params.shape[-1])], t(mu_in), t(mu_out),
                  t(phi_in), t(phi_out)).numpy()
