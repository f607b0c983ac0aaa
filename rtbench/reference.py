"""The plain reference: a vectorized Monte Carlo of the same scene in plain PyTorch.

It follows the algorithm of the photon-serial oracle of the test suite
(tests/reference_mc.py, after Integrators/monteCarloRadiativeTransfer.f95:
400-707), rewritten so that a pool of photons moves together, and uses
maximum cross-section (delta) tracking against the grid's largest extinction
in place of the voxel walk:

  * photons enter at the top of the domain, uniformly in x and y, in the
    direction of a directional source (mu0 < 0 going down, azimuth phi0);
  * a free path is drawn against the majorant; a flight that reaches the top
    or the bottom first leaves the domain there and is tallied in the column
    where it leaves (x and y are periodic); otherwise the point is a real
    collision with the probability ext / majorant, else a null collision;
  * at a real collision the weight is multiplied by the single-scattering
    albedo (the absorbed part tallied in the column), each detector receives
    the local estimate w p(cos) / (4 pi |mu_d|) exp(-tau) in the column
    where the ray toward it leaves the domain, Russian roulette keeps a
    weight below rr_w / 2 with the probability w / rr_w at rr_w, and the
    direction is redrawn from Henyey-Greenstein;
  * a black surface ends every photon that reaches the bottom.

The optical depth of a local estimate is exact: the ray is walked column
by column, and inside a column the depth is read from the column's
cumulative vertical depth.  Tallies are float64; the transport runs in
``dtype`` (float32 for the reference, bfloat16 for the benchmark's control).
The random stream is torch's own generator, seeded by the caller, and has
nothing in common with the program's.

Imports nothing but torch and math: no part of the program under test.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

FOUR_PI = 4.0 * math.pi
LANES = 1 << 22            # photons in flight at once
MAX_ORDERS = 500           # real collisions before a photon is dropped as bad
MAX_EVENTS = 20000         # events of any kind before a photon is dropped as bad
RR_WEIGHT = 1.0            # Russian roulette: a weight below half of it plays for it
ESTIMATE_CHUNK = 1 << 22   # local-estimate records queued before their rays are walked


@dataclass
class Scene:
    """What the benchmark hands both sides: regular grid edges, the
    extinction and single-scattering albedo per cell (nx, ny, nz), the
    Henyey-Greenstein asymmetry, the directional source and the detectors."""

    x_edges: list
    y_edges: list
    z_edges: list
    ext: torch.Tensor          # (nx, ny, nz), 1/length
    ssa: torch.Tensor          # (nx, ny, nz)
    g: float
    mu0: float                 # cosine of the solar zenith (> 0)
    phi0: float                # solar azimuth, degrees
    det_mus: tuple = ()
    det_phis: tuple = ()       # degrees


@dataclass
class RefResult:
    """Per-batch normalized fields, float64 on the CPU: flux_up, flux_down,
    flux_absorbed (B, nx, ny); intensity (B, nx, ny, D); the photons of each
    batch; the real collisions and the photons dropped (bad) over all; and
    the variance of one photon's share of the domain-mean upward and
    downward flux (``photon_var``, keyed "mean_flux_up", "mean_flux_down"):
    a photon adds its weight where it leaves, and one batch's domain mean
    is the sum of its photons' shares over its photons."""

    flux_up: torch.Tensor
    flux_down: torch.Tensor
    flux_absorbed: torch.Tensor
    intensity: torch.Tensor
    photons_per_batch: int
    collisions: int
    n_bad: int
    photon_var: dict

    @property
    def collisions_per_photon(self) -> float:
        return self.collisions / (self.photons_per_batch * self.flux_up.shape[0])


def _regular(edges) -> tuple[float, float, int]:
    e = torch.as_tensor(edges, dtype=torch.float64)
    d = e[1:] - e[:-1]
    if not torch.allclose(d, d[0].expand_as(d), rtol=1e-9, atol=0.0):
        raise ValueError("the reference takes regular grids only")
    return float(e[0]), float(d[0]), e.numel() - 1


class _Grid:
    def __init__(self, scene: Scene, dtype, device):
        self.x0, self.dx, self.nx = _regular(scene.x_edges)
        self.y0, self.dy, self.ny = _regular(scene.y_edges)
        self.z0, self.dz, self.nz = _regular(scene.z_edges)
        self.lx, self.ly = self.dx * self.nx, self.dy * self.ny
        self.ztop = self.z0 + self.dz * self.nz
        self.dtype, self.device = dtype, device
        ext = scene.ext.to(device=device, dtype=torch.float64)
        self.ext = ext.to(dtype).reshape(-1)
        self.ssa = scene.ssa.to(device=device, dtype=dtype).reshape(-1)
        self.absorbing = bool(((scene.ssa < 1.0) & (scene.ext > 0.0)).any())
        self.kmax = float(ext.max())
        # Cumulative vertical depth of each column at each z edge, (ncols, nz+1).
        cum = torch.cumsum(ext.reshape(-1, self.nz) * self.dz, dim=1)
        self.cum = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1).to(dtype)
        self.ncols = self.nx * self.ny

    def t(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def wrap(self, v, v0, length):
        return torch.remainder(v - v0, length) + v0

    def index(self, v, v0, d, n):
        return torch.clamp(torch.floor((v - v0) / d).to(torch.int64), 0, n - 1)

    def column(self, x, y):
        return (self.index(x, self.x0, self.dx, self.nx) * self.ny
                + self.index(y, self.y0, self.dy, self.ny))


def _depth_to(grid: _Grid, col, z):
    """The column's cumulative vertical optical depth from the bottom to z."""
    k = grid.index(z, grid.z0, grid.dz, grid.nz)
    base = grid.cum.reshape(-1)[col * (grid.nz + 1) + k]
    frac = (z - (grid.z0 + k.to(z.dtype) * grid.dz))
    return base + grid.ext[col * grid.nz + k] * frac


def _transmittance(grid: _Grid, x, y, z, dx, dy, dz):
    """exp(-tau) along (dx, dy, dz) from (x, y, z) to the domain's top
    (dz > 0) or bottom (dz < 0), and the column where the ray leaves."""
    n = x.numel()
    tau = torch.zeros(n, dtype=grid.dtype, device=grid.device)
    out_col = torch.zeros(n, dtype=torch.int64, device=grid.device)
    ix = grid.index(x, grid.x0, grid.dx, grid.nx)
    iy = grid.index(y, grid.y0, grid.dy, grid.ny)
    idx = torch.arange(n, device=grid.device)
    inf = float("inf")
    while idx.numel():
        col = ix * grid.ny + iy
        s_end = torch.where(dz > 0, (grid.ztop - z) / dz, (grid.z0 - z) / dz)
        xf = grid.x0 + (ix + (dx > 0).to(torch.int64)).to(grid.dtype) * grid.dx
        yf = grid.y0 + (iy + (dy > 0).to(torch.int64)).to(grid.dtype) * grid.dy
        sx = torch.where(dx != 0, (xf - x) / torch.where(dx != 0, dx, 1.0), inf)
        sy = torch.where(dy != 0, (yf - y) / torch.where(dy != 0, dy, 1.0), inf)
        sx = torch.clamp(sx, min=0.0)
        sy = torch.clamp(sy, min=0.0)
        step = torch.minimum(torch.minimum(sx, sy), s_end)
        done = step >= s_end
        z_new = torch.where(done, torch.where(dz > 0, grid.t(grid.ztop), grid.t(grid.z0)),
                            z + dz * step)
        z_new = torch.clamp(z_new, grid.z0, grid.ztop)
        dtau = torch.abs(_depth_to(grid, col, z_new) - _depth_to(grid, col, z)) / torch.abs(dz)
        tau[idx] += dtau
        out_col[idx] = col
        keep = ~done
        cx = keep & (sx <= step)
        cy = keep & (sy <= step)
        # Crossing an x (y) face: the next column (periodic), the position on
        # the face it shares with the column left.
        ix = torch.where(cx, torch.remainder(ix + torch.where(dx > 0, 1, -1), grid.nx), ix)
        iy = torch.where(cy, torch.remainder(iy + torch.where(dy > 0, 1, -1), grid.ny), iy)
        x = torch.where(cx, grid.x0 + (ix + (dx < 0).to(torch.int64)).to(grid.dtype) * grid.dx,
                        x + dx * step)
        y = torch.where(cy, grid.y0 + (iy + (dy < 0).to(torch.int64)).to(grid.dtype) * grid.dy,
                        y + dy * step)
        # A ray that crosses neither face (it left at the end) is done.
        keep = keep & (cx | cy)
        sel = torch.nonzero(keep).flatten()
        idx, x, y, z, dx, dy, dz = (a[sel] for a in (idx, x, y, z_new, dx, dy, dz))
        ix, iy = ix[sel], iy[sel]
    return torch.exp(-tau.to(torch.float64)), out_col


def trace(scene: Scene, photons_per_batch: int, batches: int, seed: int,
          dtype=torch.float32, device="cpu") -> RefResult:
    """Trace ``batches`` batches of ``photons_per_batch`` photons through the
    scene; per-batch fields normalized as the I3RC reference normalizes them
    (per photon per column: each column's tally over the batch's photons
    over the number of columns).  Photons past ``MAX_ORDERS`` real collisions
    or ``MAX_EVENTS`` events of any kind are dropped and counted bad."""
    dev = torch.device(device)
    grid = _Grid(scene, dtype, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    D = len(scene.det_mus)
    B, ncols = int(batches), grid.ncols
    up = torch.zeros(B * ncols, dtype=torch.float64, device=dev)
    down = torch.zeros_like(up)
    absorbed = torch.zeros_like(up)
    inten = torch.zeros(B * ncols * max(D, 1), dtype=torch.float64, device=dev)
    det = None
    if D:
        mus = torch.tensor(scene.det_mus, dtype=torch.float64)
        phis = torch.deg2rad(torch.tensor(scene.det_phis, dtype=torch.float64))
        st = torch.sqrt(torch.clamp(1.0 - mus ** 2, min=0.0))
        det = torch.stack([st * torch.cos(phis), st * torch.sin(phis), mus], dim=1)
    g = scene.g
    total = B * int(photons_per_batch)
    launched = 0
    collisions = 0
    n_bad = 0
    sin0 = math.sqrt(max(1.0 - scene.mu0 ** 2, 0.0))
    phi0 = math.radians(scene.phi0)
    u0 = (sin0 * math.cos(phi0), sin0 * math.sin(phi0), -abs(scene.mu0))
    rec = []            # queued local-estimate records
    rec_n = 0
    # Sums over photons of the weight each leaves with, and of its square,
    # at the top and at the bottom.
    leave_sums = torch.zeros(4, dtype=torch.float64, device=dev)

    def rand(n):
        return torch.rand(n, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def launch(n):
        nonlocal launched
        ids = torch.arange(launched, launched + n, device=dev)
        launched += n
        x = grid.x0 + rand(n) * grid.lx
        y = grid.y0 + rand(n) * grid.ly
        z = torch.full((n,), grid.ztop, dtype=dtype, device=dev)
        full = lambda v: torch.full((n,), v, dtype=dtype, device=dev)
        return {"x": x, "y": y, "z": z, "ux": full(u0[0]), "uy": full(u0[1]),
                "uz": full(u0[2]), "w": full(1.0),
                "orders": torch.zeros(n, dtype=torch.int32, device=dev),
                "events": torch.zeros(n, dtype=torch.int32, device=dev),
                "batch": torch.div(ids, photons_per_batch, rounding_mode="floor")}

    def flush_estimates():
        nonlocal rec, rec_n
        if not rec:
            return
        r = {k: torch.cat([a[k] for a in rec]) for k in rec[0]}
        rec, rec_n = [], 0
        n = r["w"].numel()
        for d in range(D):
            dvec = det[d]
            dx, dy, dz = (grid.t(float(v)).expand(n) for v in dvec)
            cos = (r["ux"] * dx + r["uy"] * dy + r["uz"] * dz).to(torch.float64)
            p = (1.0 - g * g) / torch.clamp(1.0 + g * g - 2.0 * g * cos, min=1e-30) ** 1.5
            trans, col = _transmittance(grid, r["x"], r["y"], r["z"], dx, dy, dz)
            contrib = r["w"].to(torch.float64) * p / (FOUR_PI * abs(float(dvec[2]))) * trans
            inten.index_add_(0, (r["batch"] * ncols + col) * D + d, contrib)

    st = launch(min(LANES, total))
    while st["w"].numel():
        n = st["w"].numel()
        x, y, z, ux, uy, uz, w = (st[k] for k in ("x", "y", "z", "ux", "uy", "uz", "w"))
        s = -torch.log(torch.clamp(1.0 - rand(n), min=1e-30)) / grid.kmax
        s_exit = torch.where(uz > 0, (grid.ztop - z) / torch.where(uz > 0, uz, 1.0),
                             torch.where(uz < 0, (grid.z0 - z) / torch.where(uz < 0, uz, 1.0),
                                         float("inf")))
        leave = s >= s_exit
        xe = grid.wrap(x + ux * s_exit, grid.x0, grid.lx)
        ye = grid.wrap(y + uy * s_exit, grid.y0, grid.ly)
        cole = st["batch"] * ncols + grid.column(xe, ye)
        w64 = w.to(torch.float64)
        top, bot = leave & (uz > 0), leave & (uz < 0)
        up.index_add_(0, cole[top], w64[top])
        down.index_add_(0, cole[bot], w64[bot])
        wt, wb = w64[top], w64[bot]
        leave_sums += torch.stack([wt.sum(), (wt * wt).sum(), wb.sum(), (wb * wb).sum()])
        # The others move to the tentative collision.
        x = grid.wrap(x + ux * s, grid.x0, grid.lx)
        y = grid.wrap(y + uy * s, grid.y0, grid.ly)
        z = torch.clamp(z + uz * s, grid.z0, grid.ztop)
        col = grid.column(x, y)
        cell = col * grid.nz + grid.index(z, grid.z0, grid.dz, grid.nz)
        real = ~leave & (rand(n) * grid.kmax < grid.ext[cell])
        alive = ~leave
        st["events"] = st["events"] + 1
        st["orders"] = st["orders"] + real.to(torch.int32)
        collisions += int(real.sum())
        if grid.absorbing:
            a = grid.ssa[cell]
            dep = torch.where(real, w64 * (1.0 - a.to(torch.float64)), 0.0)
            absorbed.index_add_(0, st["batch"] * ncols + col, dep)
            w = torch.where(real, w * a, w)
        if D:
            sel = torch.nonzero(real).flatten()
            if sel.numel():
                rec.append({"x": x[sel], "y": y[sel], "z": z[sel], "ux": ux[sel],
                            "uy": uy[sel], "uz": uz[sel], "w": w[sel],
                            "batch": st["batch"][sel]})
                rec_n += sel.numel()
                if rec_n >= ESTIMATE_CHUNK:
                    flush_estimates()
        # Russian roulette on the weight.
        low = real & (w < RR_WEIGHT / 2)
        survive = rand(n) * RR_WEIGHT < w
        alive = alive & ~(low & ~survive)
        w = torch.where(low & survive, torch.full_like(w, RR_WEIGHT), w)
        # Henyey-Greenstein scattering at real collisions.
        xi = rand(n)
        if abs(g) > 1e-6:
            frac = (1.0 - g * g) / (1.0 - g + 2.0 * g * xi)
            cost = (1.0 + g * g - frac * frac) / (2.0 * g)
        else:
            cost = 1.0 - 2.0 * xi
        cost = torch.clamp(cost, -1.0, 1.0)
        sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
        phi = rand(n) * (2.0 * math.pi)
        cphi, sphi = torch.cos(phi), torch.sin(phi)
        tz = torch.sqrt(torch.clamp(1.0 - uz * uz, min=0.0))
        polar = tz < 1e-5
        tz_safe = torch.where(polar, torch.ones_like(tz), tz)
        nx_ = torch.where(polar, sint * cphi,
                          sint * (ux * uz * cphi - uy * sphi) / tz_safe + ux * cost)
        ny_ = torch.where(polar, sint * sphi,
                          sint * (uy * uz * cphi + ux * sphi) / tz_safe + uy * cost)
        nz_ = torch.where(polar, torch.sign(uz) * cost, -sint * cphi * tz + uz * cost)
        norm = torch.sqrt(nx_ * nx_ + ny_ * ny_ + nz_ * nz_)
        ux = torch.where(real, nx_ / norm, ux)
        uy = torch.where(real, ny_ / norm, uy)
        uz = torch.where(real, nz_ / norm, uz)
        over = alive & ((st["orders"] > MAX_ORDERS) | (st["events"] > MAX_EVENTS)
                        | ~torch.isfinite(x + y + z + ux + uy + uz))
        n_bad += int(over.sum())
        alive = alive & ~over
        keep = torch.nonzero(alive).flatten()
        st = {"x": x[keep], "y": y[keep], "z": z[keep], "ux": ux[keep], "uy": uy[keep],
              "uz": uz[keep], "w": w[keep], "orders": st["orders"][keep],
              "events": st["events"][keep], "batch": st["batch"][keep]}
        # Refill the pool from the photons not yet launched.
        room = LANES - keep.numel()
        if launched < total and room >= LANES // 4:
            new = launch(min(room, total - launched))
            st = {k: torch.cat([st[k], new[k]]) for k in st}
    flush_estimates()
    norm = ncols / float(photons_per_batch)
    shape = (B, grid.nx, grid.ny)
    m = leave_sums.cpu() / total
    photon_var = {"mean_flux_up": float(m[1] - m[0] * m[0]),
                  "mean_flux_down": float(m[3] - m[2] * m[2])}
    return RefResult(
        flux_up=(up * norm).reshape(shape).cpu(), flux_down=(down * norm).reshape(shape).cpu(),
        flux_absorbed=(absorbed * norm).reshape(shape).cpu(),
        intensity=(inten * norm).reshape(B, grid.nx, grid.ny, max(D, 1))[..., :D].cpu(),
        photons_per_batch=int(photons_per_batch), collisions=collisions, n_bad=n_bad,
        photon_var=photon_var)
