"""The fields compared, their moments over batches, and the numbers that decide ``correct``.

Both sides give per batch the same fields, computed here from their
normalized per-column outputs: the upward, downward and absorbed flux and
each detector's radiance, per block of columns (the configuration's
``COMPARE_BLOCK``; 1 x 1 is column by column), and their domain means.  A
batch's fields are one float64 vector (``fields``), so that the window adds
each batch's moments in a few operations on the device.  Over a side's
batches the first and second moments give each field's mean and the
standard error of that mean (the I3RC contract: monteCarloDriver.f95:
358-378).  The comparison reads three numbers:

  z_domain       the largest |difference| / combined standard error over
                 the domain means (fluxes and radiances);
  chi2_blocks    the mean of that ratio squared over every block of every
                 field: about 1 when both sides estimate the same fields;
  var_excess     how far the variance of one batch's domain-mean upward or
                 downward flux, times the batch's photons, lies above the
                 variance of one photon's share in the reference, as a
                 share of the latter, less three standard errors of that
                 share, sqrt(2 / (B - 1)) over the program's B batches (the
                 larger of the two fluxes): under 0 when a batch holds as
                 many independent photons as it reports and both sides
                 carry the same weights, whatever B.  A batch whose photons
                 repeat others (lanes that share their random keys), or
                 that traces half its photons and takes the mean over
                 those, keeps its mean and reads about 1 more.

A pair of values with no spread on either side compares exactly: a
difference counts as infinitely far.
"""

from __future__ import annotations

import math

import torch

FLUXES = ("flux_up", "flux_down", "flux_absorbed")
PER_PHOTON = ("mean_flux_up", "mean_flux_down")
EXCESS_SIGMAS = 3.0


def pool(a: torch.Tensor, block) -> torch.Tensor:
    """Mean over blocks of (bx, by) columns of a (C, nx, ny) stack of fields."""
    bx, by = block
    c, nx, ny = a.shape
    if nx % bx or ny % by:
        raise ValueError(f"compare block {block} does not divide the grid {nx} x {ny}")
    return a.reshape(c, nx // bx, bx, ny // by, by).mean(dim=(2, 4))


def fields(flux_up, flux_down, flux_absorbed, intensity, block) -> torch.Tensor:
    """The compared fields of one batch as one float64 vector, from its
    (nx, ny) fluxes and (nx, ny, D) radiances, in the order of ``layout``."""
    f = torch.stack([flux_up, flux_down, flux_absorbed]).to(torch.float64)
    parts = [pool(f, block).reshape(-1), f.mean(dim=(1, 2))]
    if intensity.shape[-1]:
        i = intensity.to(torch.float64).permute(2, 0, 1)
        parts += [pool(i, block).reshape(-1), i.mean(dim=(1, 2))]
    return torch.cat(parts)


def layout(nx: int, ny: int, detectors: int, block) -> list:
    """[(name, shape)] of the pieces of ``fields``' vector, in order."""
    b = (nx // block[0], ny // block[1])
    out = [(name, b) for name in FLUXES] + [("mean_" + name, (1,)) for name in FLUXES]
    if detectors:
        out += [("intensity", (detectors, *b)), ("mean_intensity", (detectors,))]
    return out


class Moments:
    """Float64 first and second moments of a batch's field vector over
    batches, kept on the vector's device."""

    def __init__(self, pieces: list):
        self.pieces = pieces
        self.s1 = self.s2 = None
        self.n = 0

    def add(self, v: torch.Tensor) -> None:
        if self.s1 is None:
            self.s1, self.s2 = v.clone(), v * v
        else:
            self.s1.add_(v)
            self.s2.addcmul_(v, v)
        self.n += 1

    def summary(self) -> dict:
        """{field: (mean, variance of one batch's value)} on the CPU."""
        n = self.n
        m = self.s1.cpu() / n
        var = torch.clamp(self.s2.cpu() / n - m * m, min=0.0) * n / max(n - 1, 1)
        out, at = {}, 0
        for name, shape in self.pieces:
            k = math.prod(shape)
            out[name] = (m[at:at + k].reshape(shape), var[at:at + k].reshape(shape))
            at += k
        return out


def reference_moments(ref, block) -> Moments:
    nx, ny = ref.flux_up.shape[1:]
    mom = Moments(layout(nx, ny, ref.intensity.shape[-1], block))
    for b in range(ref.flux_up.shape[0]):
        mom.add(fields(ref.flux_up[b], ref.flux_down[b], ref.flux_absorbed[b],
                       ref.intensity[b], block))
    return mom


def _z(dm, se2):
    """|difference| over its standard error; 0 for two equal values with no
    spread, inf for two different ones."""
    z = torch.where(se2 > 0, dm.abs() / torch.sqrt(torch.where(se2 > 0, se2, 1.0)),
                    torch.zeros_like(dm))
    return torch.where((se2 <= 0) & (dm != 0), torch.full_like(dm, math.inf), z)


def compare(prog: Moments, ref: Moments) -> dict:
    """z_domain and chi2_blocks of the module docstring, program against
    reference."""
    p, r = prog.summary(), ref.summary()
    zd, chi, n_chi = 0.0, 0.0, 0
    for k in p:
        (mp, vp), (mr, vr) = p[k], r[k]
        z = _z(mp - mr, vp / prog.n + vr / ref.n)
        if k.startswith("mean_"):
            zd = max(zd, float(z.max()))
        else:
            counted = (vp > 0) | (vr > 0) | (mp != mr)
            chi += float((z[counted] ** 2).sum())
            n_chi += int(counted.sum())
    return {"z_domain": zd, "chi2_blocks": chi / n_chi if n_chi else 0.0}


def var_excess(prog: Moments, photons_per_batch: int, photon_var: dict) -> float:
    """var_excess of the module docstring: the program's batches of
    ``photons_per_batch`` photons against the reference's ``photon_var``."""
    p = prog.summary()
    margin = EXCESS_SIGMAS * math.sqrt(2.0 / max(prog.n - 1, 1))
    out = -math.inf
    for k in PER_PHOTON:
        ref_var = photon_var[k]
        v = float(p[k][1].reshape(-1)[0]) * photons_per_batch
        out = max(out, v / ref_var - 1.0 if ref_var > 0 else (0.0 if v == 0 else math.inf))
    return out - margin
