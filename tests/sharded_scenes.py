"""Scenes, rank worlds and kernel-vs-twin checks of the x-sharded tracer.

Imports no JAX: ``tests/test_torch_sharded_*.py`` build each side's domains
with ``host("i3rc_tpu")`` / ``host("i3rc_tpu_torch")``, and ``chip_smoke.py``
and ``tests/test_torch_sharded_cuda.py`` load this file on the card's
machine.

  * ``scene(name, h, n_dev)``: the cases of ``tests/test_sharded_domain.py``
    (the absorbing Landsat scene, the reflecting random field, its volume
    absorption and radiance detectors, the two-component tabulated scene)
    and the scene of ``__graft_entry__.py:127-156``;
  * ``run_world(n, job, args)``: ``job(mesh, *args)`` on every rank of a
    gloo world of n processes (``torch.multiprocessing`` spawn, a store on
    a localhost port), each rank's return value back in rank order;
  * ``capture_states`` / ``trace_states`` / ``block_vs_twin`` /
    ``sb_vs_twin``: the inputs of a whole block (SD, SB) and of SB at a
    mid-flight and a tail block of a trace (on a world of one, or on each
    rank of a mesh), and the block's kernels, or SB alone, against their
    plain versions from the same input.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import pickle
import tempfile
import time
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import torch

SCENES = ("landsat", "reflecting", "volume", "detectors", "multi_tab")


def host(pkg: str) -> SimpleNamespace:
    """One side's host layer: the port keeps its copies under the JAX
    package's module paths."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    pf = mod("core.phase_functions")
    return SimpleNamespace(
        Domain=mod("core.optics").Domain, PhaseFunction=pf.PhaseFunction,
        PhaseFunctionTable=pf.PhaseFunctionTable, hg=pf.henyey_greenstein_coefficients,
        make_landsat_cloud=mod("models.landsat_cloud").make_landsat_cloud,
        load_c1_tabulated=mod("models.radar_cloud").load_c1_tabulated)


def random_field(h, seed: int = 3, ssa: float = 0.95):
    """tests/test_sharded_domain.py:_random_absorbing_domain: 16 x 4 x 6
    cells of U[0, 0.02] extinction, HG 0.7."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = 16, 4, 6
    ext = rng.uniform(0.0, 0.02, (nx, ny, nz))
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.7, 32))], key=[1.0])
    dom = h.Domain.create(np.linspace(0, 480, nx + 1), np.linspace(0, 120, ny + 1),
                          np.linspace(0, 180, nz + 1))
    return dom.add_component("c", ext, np.full_like(ext, ssa), np.zeros(ext.shape, np.int32),
                             table)


def multi_tab(h):
    """tests/test_sharded_domain.py:138-170: a C.1 cloud and a second
    (Legendre, g = 0.1/3) component over 16 x 4 x 6 cells."""
    rng = np.random.default_rng(11)
    nx, ny, nz = 16, 4, 6
    cloud = rng.uniform(0.0, 0.02, (nx, ny, nz))
    cloud[cloud < 0.004] = 0.0
    c1 = h.PhaseFunctionTable.from_phase_functions([h.load_c1_tabulated()], key=[1.0])
    ray = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(np.array([0.0, 0.1]))], key=[1.0])
    dom = h.Domain.create(np.linspace(0, 480, nx + 1), np.linspace(0, 120, ny + 1),
                          np.linspace(0, 180, nz + 1))
    dom = dom.add_component("cloud", cloud, np.full_like(cloud, 0.95),
                            np.zeros(cloud.shape, np.int32), c1)
    return dom.add_component("rayleigh", np.full(nz, 2e-3), np.ones(nz), np.zeros(nz, np.int32),
                             ray)


def graft(h, n_dev: int):
    """__graft_entry__.py:127-156: 2 n_dev x 4 x 4 cells, HG 0.7 at ssa 0.9
    and a uniform C.1 layer."""
    rng = np.random.default_rng(0)
    nx, ny, nz = 2 * n_dev, 4, 4
    ext = rng.uniform(0.0, 0.02, (nx, ny, nz))
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.7, 16))], key=[1.0])
    dom = h.Domain.create(np.linspace(0, 60.0 * nx, nx + 1), np.linspace(0, 240, ny + 1),
                          np.linspace(0, 200, nz + 1))
    dom = dom.add_component("c", ext, np.full_like(ext, 0.9), np.zeros(ext.shape, np.int32),
                            table)
    c1 = h.PhaseFunctionTable.from_phase_functions([h.load_c1_tabulated()], key=[1.0])
    return dom.add_component("aerosol", np.full(nz, 2e-3), np.ones(nz), np.zeros(nz, np.int32),
                             c1)


def scene(name: str, h, n_dev: int = 2) -> dict:
    """The domain, the source (mu0, phi0) and the tracer's keywords of a
    case; ``n_dev`` sizes the graft scene only."""
    src = (0.6, 30.0)
    if name == "landsat":
        return dict(domain=h.make_landsat_cloud(0.99), src=(0.5, 0.0), kw={})
    if name == "reflecting":
        return dict(domain=random_field(h), src=src, kw=dict(surface_albedo=0.4))
    if name == "volume":
        return dict(domain=random_field(h), src=src, kw=dict(compute_volume_absorption=True))
    if name == "detectors":
        return dict(domain=random_field(h), src=src,
                    kw=dict(surface_albedo=0.4, intensity_mus=[1.0, 0.6, -0.5],
                            intensity_phis=[0.0, 45.0, 0.0]))
    if name == "multi_tab":
        return dict(domain=multi_tab(h), src=src,
                    kw=dict(intensity_mus=[1.0, -0.5], intensity_phis=[0.0, 0.0]))
    if name == "graft":
        return dict(domain=graft(h, n_dev), src=(0.5, 0.0),
                    kw=dict(surface_albedo=0.3, intensity_mus=[1.0, 0.5],
                            intensity_phis=[0.0, 60.0], compute_volume_absorption=True))
    raise KeyError(name)


def summary(raw) -> dict:
    """A RawTallies as numpy arrays and numbers."""
    a = lambda t: t.detach().cpu().numpy()
    return dict(flux_up=a(raw.flux_up), flux_down=a(raw.flux_down),
                flux_absorbed=a(raw.flux_absorbed), volume=a(raw.volume_absorption),
                intensity=a(raw.intensity), by_component=a(raw.intensity_by_component),
                n_photons=int(raw.n_photons), n_bad=int(raw.n_bad),
                migrations=float(raw.n_lane_events), n_iterations=int(raw.n_iterations))


def trace_cases(mesh, names, n_photons: int, lanes: int, seed: int, unroll: int = 8) -> dict:
    """A rank's job: every named scene through ``trace_sharded`` on the
    mesh; per case the summary, this rank's cell rows and its cubic rows."""
    from i3rc_tpu_torch import PhotonSource
    from i3rc_tpu_torch.parallel.sharded_domain import shard_plan, trace_sharded

    h = host("i3rc_tpu_torch")
    out = {}
    for k, name in enumerate(names):
        sc = scene(name, h, mesh.size)
        src = PhotonSource.directional(*sc["src"])
        t0 = time.perf_counter()
        raw = trace_sharded(sc["domain"], src, n_photons, mesh, n_lanes_per_shard=lanes,
                            seed=seed + k, unroll=unroll, **sc["kw"])
        seconds = time.perf_counter() - t0
        spec = shard_plan(sc["domain"], mesh, unroll=unroll,
                          intensity_mus=sc["kw"].get("intensity_mus"),
                          intensity_phis=sc["kw"].get("intensity_phis"))
        out[name] = dict(summary(raw), rows=int(spec.cells.shape[0]),
                         cell_bytes=spec.cells.numel() * spec.cells.element_size(),
                         seconds=seconds)
    return out


# Sources that are not uniform in x (PhotonSource's constructor and its
# arguments): a spotlight, and an internal flux source whose delta_x spreads
# its x over (0.45, 0.65] of the domain, across the slabs of two ranks.
NON_UNIFORM_SOURCES = {
    "spotlight": ("spotlight", (0.6, 30.0, 0.3, 0.5)),
    "internal": ("internal_flux", (0.25, 0.5, 0.6, True, 0.4, 0.0)),
}


def photon_source(name: str, pkg: str = "i3rc_tpu_torch"):
    """A source of ``NON_UNIFORM_SOURCES`` built with one side's class."""
    kind, args = NON_UNIFORM_SOURCES[name]
    cls = importlib.import_module(f"{pkg}.core.illumination").PhotonSource
    return getattr(cls, kind)(*args)


def source_cases(mesh, scene_name: str, sources, n_photons: int, lanes: int,
                 seed: int) -> dict:
    """A rank's job: the scene through the sharded tracer once for each named
    source of ``NON_UNIFORM_SOURCES``; per source the summary and this
    rank's budget (its photons of the batch)."""
    from i3rc_tpu_torch.parallel.sharded_domain import ShardedTrace

    sc = scene(scene_name, host("i3rc_tpu_torch"), mesh.size)
    out = {}
    for name in sources:
        tr = ShardedTrace.create(sc["domain"], photon_source(name), n_photons, mesh,
                                 n_lanes_per_shard=lanes, seed=seed, **sc["kw"])
        while tr.running():
            tr.block()
        out[name] = dict(summary(tr.finish()), budget=tr.budget)
    return out


def x_uniform_digest(device, n_photons: int = 1 << 16, lanes: int = 1 << 14,
                     seed: int = 3) -> str:
    """The volume scene's x-uniform (directional) sharded trace on a world of
    one: its flux and volume tallies (unit counts, so their float64 sums do
    not depend on the order of the adds), n_bad, migrations and blocks, as
    one SHA-256 digest (16 hex digits)."""
    import hashlib

    from i3rc_tpu_torch import PhotonSource
    from i3rc_tpu_torch.parallel.mesh import Mesh
    from i3rc_tpu_torch.parallel.sharded_domain import trace_sharded

    sc = scene("volume", host("i3rc_tpu_torch"))
    raw = trace_sharded(sc["domain"], PhotonSource.directional(*sc["src"]), n_photons,
                        Mesh(None, 0, 1, torch.device(device)), n_lanes_per_shard=lanes,
                        seed=seed, **sc["kw"])
    s = summary(raw)
    d = hashlib.sha256()
    for k in ("flux_up", "flux_down", "flux_absorbed", "volume"):
        d.update(np.ascontiguousarray(s[k], np.float64).tobytes())
    d.update(repr((s["n_bad"], s["migrations"], s["n_iterations"])).encode())
    return d.hexdigest()[:16]


def _rank_main(rank: int, n: int, port: int, device: str, job, args, out_dir: str) -> None:
    import torch.distributed as dist

    from i3rc_tpu_torch.parallel.mesh import default_mesh

    torch.set_num_threads(1)
    store = dist.TCPStore("127.0.0.1", port, is_master=False, timeout=timedelta(seconds=300))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n,
                            timeout=timedelta(seconds=300))
    try:
        res = job(default_mesh(device=device), *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def start_world(n: int, job, args=(), device: str = "cpu"):
    """Spawn a gloo world of ``n`` processes running ``job(mesh, *args)``;
    ``join_world`` waits for it.  This process holds the world's store on
    a port the system picks (no other world or client socket can take it
    between a choice and a bind)."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    out = tempfile.TemporaryDirectory()
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    ctx = mp.start_processes(_rank_main, args=(n, store.port, device, job, args, out.name),
                             nprocs=n, join=False, start_method="spawn")
    return n, ctx, out, store


def join_world(world, timeout: float = 600.0) -> list:
    """The results of a started world in rank order.  Raises if a rank
    fails or the world outlives ``timeout`` seconds (its processes are then
    killed)."""
    n, ctx, out, _store = world
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {n} ranks outlived {timeout} s")
        results = []
        for r in range(n):
            with open(os.path.join(out.name, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        out.cleanup()


def run_world(n: int, job, args=(), device: str = "cpu", timeout: float = 600.0) -> list:
    """``job(mesh, *args)`` on each rank of a gloo world of ``n`` spawned
    processes; their results in rank order."""
    return join_world(start_world(n, job, args, device), timeout)


def slab(h, levels: int = 3, tau: float = 2.0):
    """tests/test_checkpoint.py's slab: one column, HG 0.85, ssa 0.99."""
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.85, 32))], key=[1.0])
    dom = h.Domain.create([0, 500.0], [0, 500.0], np.linspace(0, 250.0, levels))
    ext = np.full((1, 1, levels - 1), tau / 250.0)
    return dom.add_component("cloud", ext, np.full_like(ext, 0.99),
                             np.zeros(ext.shape, np.int32), table)


def domain_means(res):
    return {"fup": res.mean_flux_up, "fdn": res.mean_flux_down,
            "fabs": res.mean_flux_absorbed}


def batches_job(mesh, n_photons: int, n_batches: int, seed: int, offset: int = 0,
                chunk: int | None = None) -> dict:
    """A rank's job: ``run_batches`` of the slab (maximum cross-section,
    albedo 0.1) on the mesh: the summed moments' leaves and the count."""
    from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource
    from i3rc_tpu_torch.parallel.mesh import run_batches, tree_leaves

    integ = Integrator.create(slab(host("i3rc_tpu_torch")), IntegratorConfig(
        use_ray_tracing=False), surface_albedo=0.1, device=mesh.device)
    s1, s2, n = run_batches(integ, PhotonSource.directional(0.5, 0.0), n_photons, n_batches,
                            seed=seed, derive=domain_means, mesh=mesh, batch_offset=offset,
                            chunk_batches=chunk, _return_sums=True)
    return {"s1": [a.numpy() for a in tree_leaves(s1)],
            "s2": [a.numpy() for a in tree_leaves(s2)], "n_batches": n, "rank": mesh.rank,
            "size": mesh.size}


def driver_job(mesh, namelist: str, workdir: str) -> dict:
    """A rank's job: the namelist driver from ``workdir/rank<r>`` (its
    outputs relative), with the default mesh (the initialized world)."""
    from i3rc_tpu_torch.drivers.monte_carlo_driver import run_from_namelist

    here = os.path.join(workdir, f"rank{mesh.rank}")
    os.makedirs(here, exist_ok=True)
    os.chdir(here)
    drv = run_from_namelist(namelist, quiet=True, device=str(mesh.device))
    out = {"n_devices": drv["cfg"]["n_devices"], "files": sorted(os.listdir(here)),
           "mean_stats": drv["mean_stats"], "num_batches": drv["cfg"]["num_batches"]}
    if "out.nc" in out["files"]:
        from scipy.io import netcdf_file

        with netcdf_file("out.nc", "r") as nc:
            out["processors"] = int(nc.Number_of_processors_used)
    return out


# ---------------------------------------------------------------------------
# The block's kernels against their plain versions

def capture_states(tr, tail_alive: float = 0.15) -> dict:
    """Wrap a ShardedTrace's kernels so that its run keeps the inputs of a
    whole block (SD, and with detectors SB after it) at a mid-flight block
    (the third) and the first tail block (at most ``tail_alive`` of the
    lanes alive), and SB's inputs at the first block with rays in flight
    past the second and the first tail one: {"block": [(kb, plan,
    ShardState, RayPool, ShardBuffers)], "sb": [(kb, RayPool,
    ShardBuffers)]}, filled as the trace runs."""
    from i3rc_tpu_torch.kernels import sharded_block as sb

    lanes = tr.state.i.shape[1]
    keep = {"block": [], "sb": []}
    sd_fn, sb_fn = tr.event_block, tr.shadow_block

    def want(kind, live):
        got = keep[kind]
        return (not got and tr.kb >= 2) or (len(got) == 1 and live <= tail_alive * lanes)

    def sd(spec_, st, pool, bufs, plan, key, kb, source, albedo):
        if want("block", int((st.i[sb.ALIVE] != 0).sum())):
            keep["block"].append((kb, plan, st.clone(), pool.clone(), bufs.clone()))
        sd_fn(spec_, st, pool, bufs, plan, key, kb, source, albedo)

    def shadow(spec_, pool, bufs, acc_int, acc_byc):
        live = int(((pool.i[sb.QALIVE] != 0) & (pool.i[sb.QTAG] == 0)).sum())
        if live and want("sb", live):
            keep["sb"].append((tr.kb, pool.clone(), bufs.clone()))
        sb_fn(spec_, pool, bufs, acc_int, acc_byc)

    tr.event_block, tr.shadow_block = sd, shadow
    return keep


def trace_states(sc: dict, n_photons: int, lanes: int, device, seed: int = 7,
                 tail_alive: float = 0.15, unroll: int = 8, mesh=None, source=None) -> dict:
    """Trace a scene on ``mesh`` (by default a world of one on ``device``)
    and keep the block's and SB's inputs as ``capture_states`` does:
    {"spec", "key", "source", "albedo", "block": [...], "sb": [...], "raw":
    RawTallies}; ``source`` (by default the scene's directional one) is the
    refill's (a source queue for a source not uniform in x).  Every rank of
    the mesh calls it."""
    from i3rc_tpu_torch import PhotonSource
    from i3rc_tpu_torch.parallel.mesh import default_mesh
    from i3rc_tpu_torch.parallel.sharded_domain import ShardedTrace

    mesh = mesh or default_mesh(device=device)
    tr = ShardedTrace.create(sc["domain"], source or PhotonSource.directional(*sc["src"]),
                             n_photons, mesh, n_lanes_per_shard=lanes, unroll=unroll, seed=seed,
                             **sc["kw"])
    keep = capture_states(tr, tail_alive)
    while tr.running():
        tr.block()
    return dict(spec=tr.spec, key=tr.key, source=tr.refill, albedo=tr.albedo,
                block=keep["block"], sb=keep["sb"], raw=tr.finish())


def run_block(spec, key, source, albedo, kept, plain: bool) -> tuple:
    """One whole block from a kept input, on copies: SD, and with detectors
    SB, through the kernels or (``plain``) their plain versions.
    Returns (state, pool, buffers, acc_int, acc_byc)."""
    from i3rc_tpu_torch.kernels import sharded_block as sb

    kb, plan, st0, pool0, bufs0 = kept
    st, pool, bufs = st0.clone(), pool0.clone(), bufs0.clone()
    n = spec.nx_loc * spec.n_y * spec.n_dirs
    acc = lambda k: torch.zeros(k, dtype=torch.float64, device=st.f.device)
    acc_int, acc_byc = acc(n), acc(n * (spec.n_comp + 1))
    sd = sb.sharded_block_reference if plain else sb.sharded_event_block
    sd(spec, st, pool, bufs, plan, key, kb, source, albedo)
    if spec.n_dirs:
        shadow_block(spec, pool, bufs, acc_int, acc_byc, plain)
    return st, pool, bufs, acc_int, acc_byc


def shadow_block(spec, pool, bufs, acc_int, acc_byc, plain: bool) -> None:
    """SB's launch, or (``plain``) its plain version: SR's steps, then SP's
    pack."""
    from i3rc_tpu_torch.kernels import sharded_block as sb

    if plain:
        sb.shadow_advance_reference(spec, pool, acc_int, acc_byc)
        sb.shadow_pack_reference(spec, pool, bufs)
    else:
        sb.shadow_block(spec, pool, bufs, acc_int, acc_byc)


def widened(pool, bufs, m: int) -> tuple:
    """``pool``'s slots repeated ``m`` times, with copies of ``bufs`` whose
    free-slot list and look-back records are sized for it: a pool of ``m``
    times the slots (and tiles) for SB alone."""
    from i3rc_tpu_torch.kernels import sharded_block as sb

    big = sb.RayPool(pool.f.repeat(1, m).contiguous(), pool.i.repeat(1, m).contiguous())
    b = bufs.clone()
    n_tiles = -(-big.n_rays // sb.CTA_THREADS)
    return big, dataclasses.replace(
        b, free_q=torch.zeros(big.n_rays, dtype=torch.int32, device=b.free_q.device),
        status=torch.zeros(2, n_tiles, sb.STATUS_INTS, dtype=torch.int32, device=b.free_q.device))


def _pool_parts(pool, bufs) -> dict:
    """What SB leaves that its plain version must equal bit for bit: the
    pool, the filled prefixes of the rays' send buffer and of the sent-slot
    list, the free-slot list (by the counts), the counts vector."""
    from i3rc_tpu_torch.kernels import sharded_block as sb

    row = bufs.counts[bufs.rank].tolist()
    out = {"pool_f": pool.f, "pool_i": pool.i, "counts": bufs.counts,
           "free_q": bufs.free_q[:row[sb.FREE_Q]]}
    for k in range(2):
        out[f"send_q{k}"] = bufs.send_q[k, :min(row[sb.WAIT_Q + k], bufs.cap)]
        out[f"tag_q{k}"] = bufs.tag_q[k, :min(row[sb.WAIT_Q + k], bufs.cap)]
    return out


def _block_parts(spec, st, pool, bufs, kb: int) -> dict:
    """What a block leaves that its plain version must equal bit for bit:
    the lane state, the pool, the filled prefixes of the send buffers, the
    free-slot and sent-slot lists and the next inboxes (by the counts and
    the plan), the tiles' counts, the counts vector, the flux tallies."""
    from i3rc_tpu_torch.kernels import sharded_block as sb

    npar = (kb + 1) & 1
    row = bufs.counts[bufs.rank].tolist()
    out = {"f": st.f, "i": st.i, "pool_f": pool.f, "pool_i": pool.i, "counts": bufs.counts,
           "tiles": bufs.tiles[npar], "columns": bufs.columns, "vol": bufs.vol}
    for k in range(2):
        out[f"send_ph{k}"] = bufs.send_ph[npar, k, :min(row[sb.WAIT_PH + k], bufs.cap)]
    if spec.n_dirs:
        out.update(_pool_parts(pool, bufs))
    return out


def block_vs_twin(spec, key, source, albedo, kept) -> dict:
    """A whole block (SD, then SB) against its plain version from the same
    input: whether everything it leaves agrees bit for bit (the radiance
    tallies within 1e-9 of their sum: SB adds in another order),
    the first parts that differ, and the block's counts (the plain
    version's): live lanes, lane-events, collisions, photons and rays
    tagged to migrate, rays drained, steps, escapes."""
    from i3rc_tpu_torch.kernels import sharded_block as sb

    kb, plan, st0, pool0, bufs0 = kept
    got = run_block(spec, key, source, albedo, kept, plain=False)
    ref = run_block(spec, key, source, albedo, kept, plain=True)
    gp, rp = _block_parts(spec, *got[:3], kb), _block_parts(spec, *ref[:3], kb)
    differ = [k for k in rp if gp[k].shape != rp[k].shape or not torch.equal(gp[k], rp[k])]
    err = max([float((g - r).abs().max()) for g, r in zip(got[3:], ref[3:]) if r.numel()],
              default=0.0)
    tally = float(ref[3].abs().sum())
    st, pool = ref[0], ref[1]
    return {"bit_equal": not differ, "parts_differing": differ[:6],
            "max_abs_err": float((got[0].f - st.f).abs().max()),
            "tally_abs_err": err, "tally_sum": tally,
            "tally_ok": err <= 1e-9 * max(1.0, tally),
            "live": int((st0.i[sb.ALIVE] != 0).sum()),
            "lane_events": int((st.i[sb.EVCT] - st0.i[sb.EVCT]).sum()),
            "collisions": int((st.i[sb.ORDERS] - st0.i[sb.ORDERS]).clamp(min=0).sum()),
            "tagged": int((st.i[sb.TAG] != 0).sum()),
            "sent": sum(plan.sent_ph), "received": sum(plan.n_rx_ph), "refilled": plan.n_new,
            "rays_tagged": int((pool.i[sb.QTAG] != 0).sum()) if spec.n_dirs else 0,
            "rays": int(((pool0.i[sb.QALIVE] != 0) & (pool0.i[sb.QTAG] == 0)).sum())
            if spec.n_dirs else 0,
            "steps": int((pool.i[sb.QSTEPS] - pool0.i[sb.QSTEPS]).sum()) if spec.n_dirs else 0,
            "kb": kb}


def shadow_census(pool0, pool) -> dict:
    """The rays in flight of ``pool0``, the steps they took, the rays that
    escaped and those tagged to migrate, by ``pool`` after SB's work."""
    from i3rc_tpu_torch.kernels import sharded_block as sb

    q0, q = pool0.i, pool.i
    return {"rays": int(((q0[sb.QALIVE] != 0) & (q0[sb.QTAG] == 0)).sum()),
            "steps": int((q[sb.QSTEPS] - q0[sb.QSTEPS]).sum()),
            "escapes": int(((q0[sb.QALIVE] != 0) & (q[sb.QALIVE] == 0)).sum()),
            "tagged": int(((q[sb.QTAG] != 0) & (q0[sb.QTAG] == 0)).sum())}


def sb_vs_twin(spec, pool0, bufs0) -> dict:
    """One SB launch against SR's and then SP's plain versions from the
    same pool, buffers and zeroed tallies: the pool, the packed rows and
    slots, the free slots and the counts bit for bit; the tallies' largest
    absolute difference
    (the kernel adds in another order); the launch's census (the plain
    version's rays, steps, escapes and tagged rays, its packed rows and
    free slots) and, on the card, the kernel's own counts of its ray loop
    (``shadow_ray_use``: rays, steps, thread slots, CTAs)."""
    from i3rc_tpu_torch.kernels import sharded_block as sb

    n = spec.nx_loc * spec.n_y * spec.n_dirs
    dev = pool0.f.device
    acc = lambda k: torch.zeros(k, dtype=torch.float64, device=dev)
    got, ref = (pool0.clone(), bufs0.clone()), (pool0.clone(), bufs0.clone())
    g_acc, r_acc = (acc(n), acc(n * (spec.n_comp + 1))), (acc(n), acc(n * (spec.n_comp + 1)))
    use = sb.shadow_ray_use(dev).clone() if dev.type == "cuda" else None
    shadow_block(spec, *got, *g_acc, plain=False)
    if use is not None:
        use = dict(zip(sb.SHADOW_USE, (sb.shadow_ray_use(dev) - use).tolist()))
    shadow_block(spec, *ref, *r_acc, plain=True)
    gp, rp = _pool_parts(*got), _pool_parts(*ref)
    differ = [k for k in rp if gp[k].shape != rp[k].shape or not torch.equal(gp[k], rp[k])]
    err = max(float((g - r).abs().max()) for g, r in zip(g_acc, r_acc))
    row = ref[1].counts[ref[1].rank].tolist()
    out = {"bit_equal": not differ, "parts_differing": differ[:6], "tally_abs_err": err,
           "tally_sum": float(r_acc[0].sum()), "n_bins": n * (spec.n_comp + 2),
           "rows": sum(min(row[sb.WAIT_Q + k], ref[1].cap) for k in range(2)),
           "free": row[sb.FREE_Q], **shadow_census(pool0, ref[0])}
    if use is not None:
        out["use"] = use
    return out


def states_vs_twins(st: dict) -> list:
    """``block_vs_twin`` on each kept block input and ``sb_vs_twin`` on each
    kept SB input of a rank (``trace_states``' result): one record each,
    with its kernel ("SD": the whole block; "SB") and state ("mid",
    "tail")."""
    args = (st["spec"], st["key"], st["source"], st["albedo"])
    out = [dict(block_vs_twin(*args, kept), kernel="SD", state=tag)
           for tag, kept in zip(("mid", "tail"), st["block"])]
    return out + [dict(sb_vs_twin(st["spec"], pool, bufs), kernel="SB", state=tag, kb=kb)
                  for tag, (kb, pool, bufs) in zip(("mid", "tail"), st["sb"])]


def twin_check_job(mesh, name: str, n_photons: int, lanes: int, seed: int = 7) -> dict:
    """A rank's job: trace a scene on the mesh keeping the block's and SB's
    inputs, then hold the kernels against their plain versions on this
    rank's states (its half slab, one face of it inside the domain)."""
    st = trace_states(scene(name, host("i3rc_tpu_torch"), mesh.size), n_photons, lanes,
                      mesh.device, seed=seed, mesh=mesh)
    return {"rank": mesh.rank, "nx_loc": st["spec"].nx_loc, "checks": states_vs_twins(st)}
