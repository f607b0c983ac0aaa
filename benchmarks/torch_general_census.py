#!/usr/bin/env python3
"""Warp census of the general event block G, from its plain PyTorch version.

Runs ``general_block_reference`` (kernels/general_block.py) with its record
hook on two general-kernel paths and asks, for every recorded block, how
the warps of three lane orders would use their 32 lanes
(``census_orders``): (a) the first design's identity order, thread l runs
lane l; (b) each CTA's live lanes compacted after the refill; (c) the
compacted lanes grouped by the key of the kernel's lane order
(``lane_keys``) into 2, 4 or 8 buckets; and, where the kernel gives a
CTA several tiles of 256 lanes (a block under half alive), the compaction
over them (``compact_tiles``).  A warp makes an event's trip while any of
its lanes is alive, and its DDA loop runs as long as its longest lane's.
The census sees the warps' lane use only: not how many CTAs a launch
holds, nor the latency of a CTA's slowest warp, which set the card's time
(PERF.md, section 6).

Scenes, built as ``chip_smoke.py`` builds them: the step cloud through
``IntegratorConfig()`` (ray tracing) and Landsat general (Woodcock on
8-cell super-voxels, the weight-1 class).  States: the launch state, a
mid-flight state (block 1) and the tail state (budget spent, at most 15%
of lanes alive), at ``--lanes`` lanes and 4 wavefronts of photons (the
states of ``chip_smoke.py`` phase 26); with ``--batch``, also every block
of one whole batch of ``--batch-photons-per-lane`` wavefronts summed (the
paths of phases 27 and 28: 16 and 2).

The modelled cost of a warp-event trip is EVENT_WEIGHT + the longest
lane's DDA steps, in units of one DDA step: EVENT_WEIGHT is the ratio of
an event's operations (its draws, free path and classification, and a
collision's) to a DDA step's, from ``chip_smoke.py``'s OPS_PER_G*.  The
predicted factor of an order is its modelled cost over the identity
order's.  Device-independent; runs on the CPU (``--device cpu``, the
default) or the card.  Writes every number to ``--out``:

    python3 benchmarks/torch_general_census.py --lanes 65536 --batch \\
        --out build/general_census.json
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

from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource,  # noqa: E402
                            batch_key, make_landsat_cloud, make_step_cloud)
from i3rc_tpu_torch.kernels import general_block as gb  # noqa: E402

SEED = 2024
# (OPS_PER_GEVENT + OPS_PER_GCOLLISION) / OPS_PER_GSTEP of chip_smoke.py:
# (260 + 120) / 45, a collision counted at every event.
EVENT_WEIGHT = 380 / 45
SUMMED = ("trips", "warp_steps", "lane_steps", "lane_events", "sparse_trips")


def scene(name: str, device):
    """The integrator of a census scene (chip_smoke.general_scene's)."""
    if name == "rt_step_cloud":
        return Integrator.create(make_step_cloud(1.0), device=device)
    if name == "woodcock_landsat":
        cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                               compute_volume_absorption=False, use_fastpath=False)
        return Integrator.create(make_landsat_cloud(1.0), cfg, device=device)
    raise ValueError(name)


def model(c: dict) -> float:
    """The modelled cost of a census, in DDA steps."""
    return EVENT_WEIGHT * c["trips"] + c["warp_steps"]


def summary(census: dict) -> dict:
    """Each order's census with its predicted factor against the identity
    order: the modelled cost's, the DDA loop's alone (warp_steps)."""
    base = census["identity"]
    out = {}
    for name, c in census.items():
        out[name] = dict(c, model_factor=model(c) / model(base) if model(base) else float("nan"),
                         dda_factor=c["warp_steps"] / base["warp_steps"]
                         if base["warp_steps"] else float("nan"))
    return out


def add(total: dict, census: dict) -> None:
    for name, c in census.items():
        t = total.setdefault(name, dict.fromkeys(SUMMED, 0))
        t["sparse_trips"] += round(c["sparse_share"] * c["trips"]) if c["trips"] else 0
        for k in SUMMED[:-1]:
            t[k] += c[k]


def finish(total: dict) -> dict:
    out = {}
    for name, t in total.items():
        out[name] = dict(t, dda_efficiency=t["lane_steps"] / (32 * t["warp_steps"])
                         if t["warp_steps"] else float("nan"),
                         event_efficiency=t["lane_events"] / (32 * t["trips"])
                         if t["trips"] else float("nan"),
                         sparse_share=t["sparse_trips"] / t["trips"] if t["trips"] else float("nan"))
    return summary(out)


def trace(integ, n: int, L: int, seed: int, device):
    """Blocks of one trace from the launch state, each recorded; yields
    (kb, alive share at entry, launched at entry, census) until the trace
    ends."""
    tracer = integ.general_tracer(n, L)
    spec, tables, opt = tracer.spec, integ.tables, integ.device_optics
    var = gb.variant(spec, opt)
    src = PhotonSource.directional(0.5, 0.0)
    key = batch_key(SEED, seed)
    st = gb.launch_state(spec, src.sample(key, L, device), n)
    buf = gb.general_buffers(spec, st, min(L, n))
    kb = 0
    while True:
        alive = float(st.i[gb.ALIVE].float().mean())
        launched = int(buf.ctl[kb & 1])
        rec = {}
        gb.general_block_reference(spec, var, opt, tables, st, buf, key, src, kb, record=rec)
        yield kb, alive, launched, gb.census_orders(spec, opt, rec)
        kb += 1
        if int(buf.ctl[gb.DONE]) >= 0:
            return


def states(name: str, L: int, device) -> dict:
    """The census of the launch, mid-flight and tail states (phase 26's:
    4 wavefronts of photons)."""
    n = 4 * L
    out = {}
    for kb, alive, launched, census in trace(scene(name, device), n, L, 600, device):
        if kb == 0:
            out["first"] = dict(kb=kb, alive=alive, orders=summary(census))
        elif kb == 1:
            out["mid"] = dict(kb=kb, alive=alive, orders=summary(census))
        if launched >= n and alive <= 0.15:
            out["tail"] = dict(kb=kb, alive=alive, orders=summary(census))
            break
    return out


def batch(name: str, L: int, per_lane: int, device) -> dict:
    """Every block of one whole batch of ``per_lane`` wavefronts, summed."""
    total, blocks, drain = {}, 0, 0
    n = per_lane * L
    for kb, alive, launched, census in trace(scene(name, device), n, L, 700, device):
        add(total, census)
        blocks += 1
        drain += launched >= n
    return dict(photons=n, blocks=blocks, drain_blocks=drain, orders=finish(total))


def show(tag: str, orders: dict) -> None:
    for name, c in orders.items():
        print(f"[census] {tag} order={name} trips={c['trips']} warp_steps={c['warp_steps']} "
              f"lane_steps={c['lane_steps']} lane_events={c['lane_events']} "
              f"dda_efficiency={c['dda_efficiency']:.4f} "
              f"event_efficiency={c['event_efficiency']:.4f} "
              f"sparse_share={c['sparse_share']:.4f} model_factor={c['model_factor']:.4f} "
              f"dda_factor={c['dda_factor']:.4f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=1 << 16)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--scenes", default="rt_step_cloud,woodcock_landsat")
    ap.add_argument("--batch", action="store_true", help="also one whole batch per scene")
    ap.add_argument("--batch-photons-per-lane", default="rt_step_cloud=16,woodcock_landsat=2",
                    help="wavefronts of photons per whole batch, per scene")
    ap.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    ap.add_argument("--out", default=str(ROOT / "build" / "general_census.json"))
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    per_lane = {k: int(v) for k, v in (s.split("=") for s in
                                       args.batch_photons_per_lane.split(","))}
    result = {"lanes": args.lanes, "device": args.device, "event_weight": EVENT_WEIGHT,
              "scenes": {}}
    for name in args.scenes.split(","):
        t0 = time.perf_counter()
        rec = {"states": states(name, args.lanes, args.device)}
        for state, r in rec["states"].items():
            show(f"scene={name} state={state} kb={r['kb']} alive={r['alive']:.4f}", r["orders"])
        if args.batch:
            rec["batch"] = batch(name, args.lanes, per_lane[name], args.device)
            b = rec["batch"]
            show(f"scene={name} state=batch photons={b['photons']} blocks={b['blocks']} "
                 f"drain_blocks={b['drain_blocks']}", b["orders"])
        rec["seconds"] = time.perf_counter() - t0
        result["scenes"][name] = rec
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
