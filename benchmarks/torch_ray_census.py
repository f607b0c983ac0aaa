#!/usr/bin/env python3
"""Ray census of the detector-ray kernels, from their plain PyTorch versions.

Runs one whole batch of each radiance path of ``chip_smoke.py`` through the
plain twin of its kernel with the record hook (``general_block_reference``
for G with the estimate stage, ``polarized_block_reference`` for PZ), every
block recording its detector rays (event j, lane, detector, cost: DDA steps
on G, ratio-tracking rounds on PZ), and asks for every block how long the
warps would take on those rays under three designs of the estimate stage
(``kernels.general_block.ray_census``): (i) ``serial``, the first design,
a lane traces its D rays of an event itself and its warp waits for the
largest sum; (ii) ``warp``, the rays of a warp's lanes traced 32 at a time
by its threads in push order; (iii) ``cta_by_detector``, a CTA's rays
grouped by detector, 32 at a time; (iv) ``warp_pull``, a warp's rays
pulled by whichever thread is free (a lower bound).  The slots are the kernel's: G's lane
order (``lane_order`` with the kernel's T and, in ray tracing on one tile,
its key buckets), PZ's thread l on lane l.  Summed over the batch's blocks;
the predicted factor of a design is (i)'s warp cost over its own.  The
census bounds the gain of the ray stage only, and sees neither the event
loop nor the card's latencies (PERF.md, section 6).

Paths (``chip_smoke.py``'s scenes, the photons and lanes divided by
``--scale``): (a) the step cloud through ``IntegratorConfig()`` with the
I3RC detectors, the exact trace and Iwabuchi roulette (2^22 photons at
2^20 lanes); (b) ``bench.py:249-271``, Woodcock (2^22 at 2^16); (c)
Landsat(0.99) with 2 detectors, ratio tracking in the weight-1 class
(2^21 at 2^20); PZ on the Mie step cloud (3 detectors, 2^22 at 2^20) and
the bench row (2 detectors, 2^23 at 2^16).  Runs on the CPU (the default)
or the card; writes every number to ``--out``:

    python3 benchmarks/torch_ray_census.py --scale 64 --out build/ray_census.json
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
from i3rc_tpu_torch import IntegratorConfig, PhotonSource, batch_key  # noqa: E402
from i3rc_tpu_torch.kernels import general_block as gb  # noqa: E402

DESIGNS = ("serial", "warp", "cta_by_detector", "warp_pull")
PATHS = ("a_exact", "a_iwabuchi", "b", "c", "pz_mie", "pz_bench")


def general_path(name: str, dev):
    """(integrator, photons, lanes) of a G radiance path at full size."""
    if name == "a_exact":
        return cs.step_cloud_radiance(dev, IntegratorConfig()), cs.RAD_GENERAL_PHOTONS, 1 << 20
    if name == "a_iwabuchi":
        cfg = IntegratorConfig(use_russian_roulette_for_intensity=True, zeta_min=0.3)
        return cs.step_cloud_radiance(dev, cfg), cs.RAD_GENERAL_PHOTONS, 1 << 20
    if name == "b":
        return (cs.step_cloud_radiance(dev, cs.woodcock_bench_config()), cs.RAD_GENERAL_PHOTONS,
                cs.RAD_WOODCOCK_LANES)
    return cs.landsat_radiance(dev), cs.LANDSAT_RAD_PHOTONS, 1 << 20


def add(total: dict, c: dict) -> None:
    total["rays"] = total.get("rays", 0) + c["rays"]
    total["cost"] = total.get("cost", 0) + c["cost"]
    for k in DESIGNS:
        t = total.setdefault(k, {"warp_cost": 0, "rounds": 0})
        t["warp_cost"] += c[k]["warp_cost"]
        t["rounds"] += c[k]["rounds"]


def finish(total: dict) -> dict:
    for k in DESIGNS:
        t = total[k]
        t["efficiency"] = total["cost"] / (32 * t["warp_cost"]) if t["warp_cost"] else None
        t["factor"] = total["serial"]["warp_cost"] / t["warp_cost"] if t["warp_cost"] else None
    return total


def census_general(name: str, dev, scale: int) -> dict:
    integ, n, L = general_path(name, dev)
    n, L = n // scale, max(L // scale, gb.CTA_THREADS)
    tracer = integ.general_tracer(n, L)
    spec, opt, tables = tracer.spec, integ.device_optics, integ.tables
    var = gb.variant(spec, opt)
    src = PhotonSource.directional(0.5, 0.0)
    key = batch_key(cs.SEED, 700)
    st = gb.launch_state(spec, src.sample(key, L, dev), n)
    buf = gb.general_buffers(spec, st, min(L, n))
    total, kb = {"photons": n, "lanes": L, "blocks": 0}, 0
    while int(buf.ctl[gb.DONE]) < 0 and kb < 2000:
        rec = {}
        gb.general_block_reference(spec, var, opt, tables, st, buf, key, src, kb, record=rec)
        alive0 = rec["entry"].i[gb.ALIVE] != 0
        T = gb.cta_tiles(L, int(alive0.sum()))
        if spec.mode == gb.RT and T == 1:
            order = gb.lane_order(alive0, gb.lane_keys(spec, opt, rec["entry"]), gb.KEY_BUCKETS)
        else:
            order = gb.lane_order(alive0, tiles=T)
        if rec["rays"].shape[1]:
            add(total, gb.ray_census(rec["rays"], order, T * gb.CTA_THREADS))
        kb += 1
    total["blocks"] = kb
    total["int_steps"] = int(buf.int_steps.sum())
    return finish(total)


def census_polarized(name: str, dev, scale: int) -> dict:
    from i3rc_tpu_torch.integrators import polarized as pz

    sc = cs.pz_scene("53_mie" if name == "pz_mie" else "52_bench", dev)
    n, L = sc.n // scale, max(sc.lanes // scale, gb.CTA_THREADS)
    spec = sc.integ.spec(n)
    key = batch_key(cs.SEED, 710)
    st = pz.launch_state(spec, sc.src.sample(key, L, dev), n)
    buf = pz.polarized_buffers(spec, st, min(L, n))
    order = gb.identity_order(L, dev)
    total, kb = {"photons": n, "lanes": L, "blocks": 0}, 0
    while int(buf.ctl[pz.DONE]) < 0 and kb < 4000:
        rec = {}
        pz.polarized_block_reference(spec, st, buf, key, sc.src, kb, record=rec)
        if rec["rays"].shape[1]:
            add(total, gb.ray_census(rec["rays"], order))
        kb += 1
    total["blocks"] = kb
    total["rounds_row"] = int(st.i[pz.ROUNDS].sum())
    return finish(total)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=64,
                    help="divide each path's photons and lanes by this")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", default=str(ROOT / "build" / "ray_census.json"))
    args = ap.parse_args()
    dev = torch.device(args.device)
    out = {"device": str(dev), "scale": args.scale, "paths": {}}
    for name in args.paths.split(","):
        t0 = time.perf_counter()
        with torch.inference_mode():
            c = (census_polarized if name.startswith("pz") else census_general)(
                name, dev, args.scale)
        c["seconds"] = time.perf_counter() - t0
        out["paths"][name] = c
        print(json.dumps({"path": name, **c}), flush=True)
    p = Path(args.out)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
