#!/usr/bin/env python3
"""A/B of the PyTorch/CUDA port's marching detector block (K3-M, K3-M+S) and
sharded block (SD) against another tree's design, on the card, in one call.

* march: this checkout's event-block library and the one built from the
  other tree's ``i3rc_tpu_torch/csrc`` (``--parent``; built side by side by
  ``benchmarks/torch_event_block_ab.py``'s ``build_all``; the other
  library's parameter block must be a prefix of this one's), in turns
  (other, this, this, other), on ``chip_smoke.py`` phase 57's paths: the
  3-D scene with three detectors (K3-M, 2^22 photons) and the scene over
  RPV with two (K3-M+S, 2^21), both at 2^20 lanes.  Per build and round one
  batch under the profiler: the block kernel's and the surface stage's
  device ms summed over the batch.  And the mid-flight and tail blocks of
  ``tests/march_scenes.py`` ``trace_states`` at the same photons and lanes:
  each build's device ms a launch (``chip_smoke.device_block_ms``), its
  result checked bit for bit against the plain version (tallies within
  1e-9) in its first round.
* sharded: this tree and the other, each in a fresh process, in turns
  (other, this, this, other): the whole Landsat scene (2^22 photons)
  through ``trace_sharded`` on one NCCL rank (2^20 lanes) and on two gloo
  ranks sharing the card (2^20 lanes a rank, half the slab each):
  photons/s (the set-up included) and blocks; on the one rank the block
  loop's host ms a block, and a profiled loop: SD's device ms a trace,
  every kernel's (the device's busy time) and the device's idle share over
  the unprofiled loop's wall time.
* lookback: SD's launch split (this tree only): a copy of
  ``csrc/sharded_event_block.cu`` whose look-back reads each predecessor's
  record once without waiting for it (its ranks are wrong: for timing
  only), against this build, in turns, on the mid-flight and tail blocks of
  the whole Landsat scene on one rank (2^22 photons, 2^20 lanes): the
  difference is the launch's wait on the tiles below it.

Every number names the card (``nvidia-smi`` name and power limit).  Usage,
from the root of the checkout, the other tree unpacked with ``git
archive`` into a directory that ``.gitignore`` lists:

    mkdir -p build/ab/parent && git archive <commit> | tar -x -C build/ab/parent
    python3 scripts/torch_redesign_ab.py --parent build/ab/parent
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke as cs  # noqa: E402
from benchmarks import torch_event_block_ab as ab  # noqa: E402

MARCH_ROUNDS = 2                # of (other, this, this, other)
SHARD_ROUNDS = 1
SHARD_PHOTONS = 1 << 22
SHARD_LANES = 1 << 20


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def batch_device_ms(run) -> dict:
    """One batch under the profiler: the marching block kernel's and the
    surface stage's device ms summed over it."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    found = prof.key_averages()
    ms = lambda k: sum(e.self_device_time_total for e in found if k in e.key) / 1e3
    return {"block_ms": ms("fast_event_block_kernel_march"),
            "stage_ms": ms("fast_event_block_surface_kernel_march")}


def march_ab(parent_csrc: Path) -> dict:
    import march_scenes as ms
    from i3rc_tpu_torch import batch_key
    from i3rc_tpu_torch.kernels.event_block import fused_block

    builds = ab.build_all({"other": str(parent_csrc)})
    dev = torch.device("cuda", 0)
    out = {}
    for name in ("3d", "3d_rpv"):
        sc = cs.march_path_scene(name, dev)
        key = batch_key(cs.SEED, 960)
        ab.use(builds["this"])
        spec, pro, states = ms.trace_states(sc.integ, sc.src, sc.n, sc.lanes, key)
        tracer = sc.integ.batch_tracer(sc.n, sc.lanes)
        bkey = batch_key(cs.SEED, 1020)
        run = lambda: tracer(bkey, sc.src.sample(bkey, sc.lanes, "cuda"), sc.src)
        rec = {b: {"batch": [], "mid": [], "tail": []} for b in builds}
        for r in range(MARCH_ROUNDS):
            for b in ("other", "this", "this", "other"):
                ab.use(builds[b])
                run()
                rec[b]["batch"].append(batch_device_ms(run))
                for state, st, buf, kb in states:
                    if state == "launch":
                        continue
                    if r == 0 and not rec[b][state]:
                        v = ms.block_vs_twin(spec, pro, st, buf, key, sc.src, kb)
                        if not (v["bit_equal"] and v["acc_rel_err"] <= 1e-9):
                            raise RuntimeError(f"march {name} {state} build {b}: {v}")
                    run_k = lambda s, bb, kb=kb: fused_block(spec, pro, s, bb, key, sc.src, kb)
                    rec[b][state].append(cs.device_block_ms(run_k, st, buf.clone, 10))
        ab.use(builds["this"])
        mean = lambda v: sum(v) / len(v)
        out[name] = {b: {"batch_block_ms": mean([x["block_ms"] for x in v["batch"]]),
                         "batch_stage_ms": mean([x["stage_ms"] for x in v["batch"]]),
                         "mid_ms": mean(v["mid"]), "tail_ms": mean(v["tail"]),
                         "batches": v["batch"]} for b, v in rec.items()}
        print(json.dumps({"march": name, **{b: {k: v for k, v in x.items() if k != "batches"}
                                            for b, x in out[name].items()}}), flush=True)
    return out


# A fresh process in a tree: Landsat through trace_sharded on one NCCL rank
# (unprofiled, then profiled) and on two gloo ranks sharing the card.
SHARD_JOB = textwrap.dedent("""
    import json, sys, time, torch, torch.distributed as dist
    sys.path.insert(0, "tests")
    import sharded_scenes as ss
    from i3rc_tpu_torch import PhotonSource
    from i3rc_tpu_torch.kernels import sharded_block as sb
    from i3rc_tpu_torch.parallel.mesh import default_mesh
    from i3rc_tpu_torch.parallel.sharded_domain import ShardedTrace, trace_sharded
    N, L = {photons}, {lanes}
    sb.build()
    sc = ss.scene("landsat", ss.host("i3rc_tpu_torch"), 2)
    src = PhotonSource.directional(*sc["src"])
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    mesh = default_mesh(device=torch.device("cuda", 0))
    trace_sharded(sc["domain"], src, 1 << 18, mesh, n_lanes_per_shard=L, seed=5, **sc["kw"])
    def trace(profile=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = ShardedTrace.create(sc["domain"], src, N, mesh, n_lanes_per_shard=L, seed=7,
                                 **sc["kw"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if profile is not None:
            profile.__enter__()
        while tr.running():
            tr.block()
        torch.cuda.synchronize()
        if profile is not None:
            profile.__exit__(None, None, None)
        t2 = time.perf_counter()
        raw = tr.finish()
        torch.cuda.synchronize()
        return raw, time.perf_counter() - t0, t2 - t1, tr.kb
    raw, seconds, loop, blocks = trace()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    trace(prof)
    found = prof.key_averages()
    sd_ms = sum(e.self_device_time_total for e in found
                if "sharded_event_block_kernel" in e.key) / 1e3
    busy_ms = sum(e.self_device_time_total for e in found) / 1e3
    dist.destroy_process_group()
    one = dict(photons_per_s=N / seconds, seconds=seconds, loop_seconds=loop, blocks=blocks,
               host_ms_per_block=1e3 * loop / blocks, sd_ms=sd_ms, busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / (1e3 * loop), n_bad=int(raw.n_bad),
               fup=float(raw.flux_up.sum()) / N)
    ranks = ss.join_world(ss.start_world(2, ss.trace_cases, (["landsat"], N, L, 7),
                                         device="cuda:0"), timeout=900)
    sec = max(r["landsat"]["seconds"] for r in ranks)
    blocks2 = max(r["landsat"]["n_iterations"] for r in ranks) // 8
    two = dict(photons_per_s=N / sec, seconds=sec, blocks=blocks2,
               ms_per_block_with_setup=1e3 * sec / blocks2)
    print("RESULT " + json.dumps(dict(one_rank=one, two_ranks=two)))
""")


def sharded_ab(parent: Path) -> dict:
    trees = {"other": parent.resolve(), "this": ROOT}
    code = SHARD_JOB.format(photons=SHARD_PHOTONS, lanes=SHARD_LANES)
    rec = {b: [] for b in trees}
    for _ in range(SHARD_ROUNDS):
        for b in ("other", "this", "this", "other"):
            res = subprocess.run([sys.executable, "-c", code], cwd=trees[b], text=True,
                                 capture_output=True, timeout=1200,
                                 env=dict(os.environ, PYTHONPATH=str(trees[b])))
            lines = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
            if res.returncode != 0 or not lines:
                raise RuntimeError(f"sharded {b}: {res.stderr[-3000:]}")
            rec[b].append(json.loads(lines[-1][7:]))
            print(json.dumps({"sharded": b, **rec[b][-1]}), flush=True)
    return rec


# The look-back's wait on a tile below (csrc/sharded_event_block.cu
# look_back), and the copy's: read the record once, as an inclusive prefix.
LOOKBACK_WAIT = ("        do {\n          fl = st[0];\n        } while ((fl >> 2) != epoch || "
                 "(fl & 3) == 0);", "        fl = 2;")


def lookback_split() -> dict:
    import sharded_scenes as ss
    import i3rc_tpu_torch.kernels.build as kbuild
    from i3rc_tpu_torch.kernels import sharded_block as sb

    own = sb.build()
    copy = ROOT / "build" / "ab" / "lookback_no_wait" / "csrc"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(kbuild.CSRC, copy)
    src = (copy / "sharded_event_block.cu").read_text()
    if LOOKBACK_WAIT[0] not in src:
        raise RuntimeError("the look-back's wait is not where this script expects it")
    (copy / "sharded_event_block.cu").write_text(src.replace(*LOOKBACK_WAIT))
    here, kbuild.CSRC = kbuild.CSRC, copy
    try:
        no_wait = kbuild.build("sharded_event_block", ("sharded_event_block.cu",))
    finally:
        kbuild.CSRC = here
    sb.declare(no_wait.lib)
    dev = torch.device("cuda", 0)
    st = ss.trace_states(ss.scene("landsat", ss.host("i3rc_tpu_torch"), 2), SHARD_PHOTONS,
                         SHARD_LANES, dev)
    spec, key, source, albedo = st["spec"], st["key"], st["source"], st["albedo"]
    rec = {}
    for tag, (kb, plan, s0, pool0, bufs0) in zip(("mid", "tail"), st["block"]):
        x0 = cs._BlockInput(s0, pool0, bufs0)
        run = lambda s, _, kb=kb, plan=plan: sb.sharded_event_block(
            spec, s.st, s.pool, s.bufs, plan, key, kb, source, albedo)
        times = {"this": [], "no_wait": []}
        for _ in range(2):
            for b in ("this", "no_wait", "no_wait", "this"):
                sb.build = lambda b=b: own if b == "this" else no_wait
                times[b].append(cs.device_block_ms(run, x0, lambda: None, 5,
                                                   kernel="sharded_event_block"))
        sb.build = lambda: own
        rec[tag] = {b: sum(v) / len(v) for b, v in times.items()}
        print(json.dumps({"lookback": tag, "kb": kb, **rec[tag]}), flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the other tree (git archive of a commit)")
    ap.add_argument("--parts", default="march,sharded,lookback")
    ap.add_argument("--out", default="build/redesign_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    parent = Path(args.parent)
    out = {"card": card()}
    print(json.dumps(out), flush=True)
    parts = args.parts.split(",")
    if "march" in parts:
        out["march"] = march_ab(parent / "i3rc_tpu_torch" / "csrc")
    if "sharded" in parts:
        out["sharded"] = sharded_ab(parent)
    if "lookback" in parts:
        out["lookback"] = lookback_split()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
