#!/usr/bin/env python3
"""Census of the fastpath's surface stage, from its plain PyTorch version.

Runs one whole batch of each reflecting-surface path of ``chip_smoke.py``
through the plain twin of the block (``fused_block_reference``), with the
lane alive flags at the start of each block's K events recorded and, before
each block's surface stage (``resolve_surface``), its census taken
(``kernels.event_block.surface_census``): the block's exits, bottom hits and
revived lanes; the warps (in lane order and compacted) and CTAs that hold
an exit; the distinct flux bins of a CTA; the float64 atomics of the
tallies into device memory as a warp issues them (one a warp and bin, the
stage's first design: a launch of its own over the lanes) and as a CTA's
shared-memory sum issues them (one a CTA and bin), each with the most that
fall on one address; with detectors the emits per upward detector and the
lane use of the per-hit detector loop, one lane per thread in lane order,
compacted onto the threads that ran the events, and with a warp's (hit,
detector) pairs dealt to all its threads.  Summed over the batch's blocks
(the same-address counts: the largest of any block); the lane uses are the
batch's (work over slots).

Paths (``chip_smoke.py`` phases 21-24 and 50, the photons and lanes divided
by ``--scale``): ``glint``, the glint row (thin cirrus over Cox-Munk, 2^27
photons at 2^18 lanes); ``albedo``, the step cloud over an albedo of 0.2
(2^24); ``rpv``, the step cloud over RPV with 2 detectors (2^24);
``scan``, the 13-detector ocean-glint scan (2^24); ``fk_albedo``, the
bench band fused (2 k points of 2^20 photons) over an albedo of 0.2.  Runs
on the CPU (the default) or the card; writes every number to ``--out``:

    python3 benchmarks/torch_surface_census.py --scale 64 --out build/surface_census.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource,  # noqa: E402
                            SurfaceDescription, batch_key, make_step_cloud)
from i3rc_tpu_torch.integrators.fastpath import lane_width  # noqa: E402
from i3rc_tpu_torch.kernels import event_block as eb  # noqa: E402

PATHS = ("glint", "albedo", "rpv", "scan", "fk_albedo")
ATOMIC_KEYS = ("warp", "cta")


def path_scene(name: str, dev):
    """(integrator, source, photons, lanes) of a surface path at full size."""
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                           compute_volume_absorption=False)
    sun, src = PhotonSource.directional(0.707, 0.0), PhotonSource.directional(0.5, 0.0)
    cox = SurfaceDescription.uniform([5.0, 1.34], brdf_name="cox_munk")
    make = lambda dom, **kw: Integrator.create(dom, cfg, device=dev, **kw)
    if name == "glint":
        return make(cs.glint_scene(), surface=cox), sun, cs.GLINT_PHOTONS, cs.L_CHECK
    if name == "albedo":
        return make(make_step_cloud(1.0), surface_albedo=0.2), src, cs.SURFACE_PHOTONS, cs.L_CHECK
    if name == "rpv":
        rpv = SurfaceDescription.uniform(cs.SURFACE_BRDFS["rpv"], brdf_name="rpv")
        return (make(make_step_cloud(1.0), surface=rpv, intensity_mus=cs.RPV_DET_MUS,
                     intensity_phis=cs.RPV_DET_PHIS), src, cs.SURFACE_PHOTONS, cs.L_CHECK)
    if name == "scan":
        return (make(cs.glint_scene(), surface=cox, intensity_mus=[cs.SCAN_MU] * len(cs.SCAN_PHIS),
                     intensity_phis=cs.SCAN_PHIS), sun, cs.SURFACE_PHOTONS, cs.L_CHECK)
    if name == "fk_albedo":
        sc = cs.fk_path_scene("50_albedo", dev)
        return sc.fused, sc.src, sc.n * sc.kd.n_k, sc.lanes
    raise ValueError(name)


def add(total: dict, c: dict) -> None:
    """Sum a block's census into the batch's; same-address counts and the
    largest bins of a CTA take the maximum; lane uses sum work and slots."""
    for k in ("hits", "revived", "warps_lane_order", "warps_compacted", "ctas",
              "emitting_hits"):
        total[k] = total.get(k, 0) + c.get(k, 0)
    for k, v in c["exits"].items():
        total.setdefault("exits", {})[k] = total.get("exits", {}).get(k, 0) + v
    b = total.setdefault("bins_per_cta", {"sum": 0, "max": 0})
    b["sum"] += c["bins_per_cta"]["sum"]
    b["max"] = max(b["max"], c["bins_per_cta"]["max"])
    for tally, a in c["atomics"].items():
        t = total.setdefault("atomics", {}).setdefault(tally, {})
        for k in ATOMIC_KEYS:
            t[k] = t.get(k, 0) + a[k]
            t[f"{k}_same_address"] = max(t.get(f"{k}_same_address", 0), a[f"{k}_same_address"])
    for d, n in c.get("emits", {}).items():
        total.setdefault("emits", {})[d] = total.get("emits", {}).get(d, 0) + n
    # Lane uses: accumulate work and slots (work / use) per layout.
    for k in ("bounce_lane_order", "bounce_compacted", "loop_lane_order", "loop_compacted",
              "loop_dealt"):
        use = c.get(k)
        if use:
            work = c["hits"] if k.startswith("bounce") else c["emitting_hits"] * len(c["emits"])
            w, s = total.setdefault("_use", {}).get(k, (0, 0.0))
            total["_use"][k] = (w + work, s + work / use)


def finish(total: dict) -> dict:
    for k, (w, s) in total.pop("_use", {}).items():
        total[k] = w / s if s else None
    return total


def census_path(name: str, dev, scale: int, seed: int = 700) -> dict:
    integ, src, n, L = path_scene(name, dev)
    n = n // scale
    L = lane_width(n, max(L // scale, eb.CTA_THREADS), integ.n_k)
    tracer = integ.batch_tracer(n, L)
    key = batch_key(cs.SEED, seed)
    total = {"photons": n, "lanes": L, "blocks": 0}
    entry = {}
    real_events, real_resolve = eb.event_block_reference, eb.resolve_surface

    def events(spec, state, u, acc=None, *a, **kw):
        entry["alive"] = state.i[eb.ALIVE].clone()
        return real_events(spec, state, u, acc, *a, **kw)

    def resolve(spec, pro, st, buf, u, u_iw=None):
        add(total, eb.surface_census(spec, pro, st, buf, u, u_iw, entry.get("alive")))
        total["blocks"] += 1
        return real_resolve(spec, pro, st, buf, u, u_iw)

    eb.event_block_reference, eb.resolve_surface = events, resolve
    try:
        raw = tracer(key, src.sample(key, L, dev), src)
    finally:
        eb.event_block_reference, eb.resolve_surface = real_events, real_resolve
    total["fdn_tally"] = float(raw.flux_down.sum())
    return finish(total)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=64,
                    help="divide each path's photons and lanes by this")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", default=str(ROOT / "build" / "surface_census.json"))
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_surface_census: torch finds no CUDA device", file=sys.stderr)
        return 2
    out = {"device": str(dev), "scale": args.scale, "paths": {}}
    for name in args.paths.split(","):
        t0 = time.perf_counter()
        rec = census_path(name, dev, args.scale)
        rec["seconds"] = time.perf_counter() - t0
        out["paths"][name] = rec
        at = rec.get("atomics", {})
        print(f"[surface-census] path={name} photons={rec['photons']} lanes={rec['lanes']} "
              f"blocks={rec['blocks']} exits={rec.get('exits')} hits={rec.get('hits')} "
              f"revived={rec.get('revived')} warps_lane_order={rec.get('warps_lane_order')} "
              f"warps_compacted={rec.get('warps_compacted')} ctas={rec.get('ctas')} "
              f"bins_per_cta={rec.get('bins_per_cta')} "
              + " ".join(f"atomics_{k}={v}" for k, v in at.items())
              + f" emits={rec.get('emits')} "
              + " ".join(f"{k}={rec.get(k)}" for k in (
                  "bounce_lane_order", "bounce_compacted", "loop_lane_order",
                  "loop_compacted", "loop_dealt"))
              + f" seconds={rec['seconds']:.1f}", flush=True)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
