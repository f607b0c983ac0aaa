#!/usr/bin/env python3
"""A/B of the PyTorch/CUDA port's marching detector block (K3-M, K3-M+S) and
sharded tracer's kernels against another tree's design, on the card, in one
call.

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
* smarch: the marching surface stage S-M
  (``fast_event_block_surface_kernel_march``) of this checkout against the
  other tree's, the same two libraries in turns, on K3-M+S's path (the
  scene over RPV, 2^21 photons, 2^20 lanes): per round one batch under the
  profiler (the block kernel's and the stage's device ms summed over it)
  and the stage's device ms a launch on the mid-flight and tail blocks
  (the profiler's time of the stage's kernel in a whole block's launch),
  each build's result first held against the plain version; and this
  build's ray loop on the same blocks (rays, steps, thread slots, runs).
  ``--build NAME=CSRC`` adds another copy of ``csrc`` to the turns (a
  design tried beside this one; its parameter block a prefix of this one's).
* probe: the column-read probe (``csrc/column_read_probe.cu``) of this
  checkout and of the other tree, each built alone, and copies of this
  one (with an empty loop, without the table read, without the Philox
  call, and with the row read past the L1), in turns, at phase 19's
  2^17 lanes: device ms a launch (CUDA events around 20 launches queued
  behind a spin kernel, and the profiler's time of the kernel), the real
  builds first held bit for bit against the plain version.
* sharded: this tree and the other, each in a fresh process, in turns
  (other, this, this, other): the scene of ``__graft_entry__.py:127-156``
  (2^22 photons, two detectors) through ``ShardedTrace`` on one NCCL rank
  (2^20 lanes) and on two gloo ranks sharing the card (2^20 lanes a rank,
  half the slab each): photons/s (the set-up included), blocks, the
  radiance and n_bad; and a profiled trace: the shadow-ray kernels'
  device ms a trace (SR's and SP's, or SB's: whichever the tree has), SD's
  and every kernel's (the device's busy time), summed over the ranks.
* lookback: SD's launch split: a copy of ``csrc/sharded_event_block.cu``
  whose look-back reads each predecessor's record once without waiting for
  it (its ranks are wrong: for timing only), and the other tree's SD where
  its library takes this tree's parameter block, against this build, in
  turns, on the mid-flight and tail blocks of the whole Landsat scene on
  one rank (2^22 photons, 2^20 lanes): the difference to the first is the
  launch's wait on the tiles below it.
* sbsplit: SB's launch split the same way (this tree only), on the graft
  scene's mid-flight and tail blocks on one rank: a copy without its waits
  on other CTAs (the look-back's, and the pack's on the tiles other CTAs
  traced), a copy whose ray loop deals no ray (the flags, the queue and
  the pack alone), one without the pack and one with neither (for timing
  only).
* sbtiles: SB's run of tiles a CTA (this tree only), on the same blocks:
  copies whose launch takes runs of 1, 2 or 4 tiles (more CTAs than one
  wave: each CTA tracing its own run), and one whose CTAs trace their own
  runs of 8 tiles (no cooperative launch), against this build (8 tiles,
  the traced tiles spread over the pool), in turns; each copy's result is
  held against the plain version first.

Every number names the card (``nvidia-smi`` name and power limit).  Usage,
from the root of the checkout, the other tree unpacked with ``git
archive`` into a directory that ``.gitignore`` lists:

    mkdir -p build/ab/parent && git archive <commit> | tar -x -C build/ab/parent
    python3 scripts/torch_redesign_ab.py --parent build/ab/parent
"""

from __future__ import annotations

import argparse
import ctypes
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


def stage_launch_ms(run, s0, new_buf, n: int) -> float:
    """Mean device ms a launch of the marching surface stage's kernel in
    ``run(state, buffers)`` (a whole block over a surface) over n fresh
    copies, from the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            run(s0.clone(), new_buf())
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if "fast_event_block_surface_kernel_march" in e.key]
    launches = sum(e.count for e in found)
    if launches == 0:
        raise RuntimeError("the profiler shows no marching surface stage")
    return sum(e.self_device_time_total for e in found) / launches / 1e3


def march_ab(parent_csrc: Path, scenes=("3d", "3d_rpv"), stage: bool = False,
             extra: dict | None = None) -> dict:
    import march_scenes as ms
    from i3rc_tpu_torch import batch_key
    from i3rc_tpu_torch.kernels import event_block as eb
    from i3rc_tpu_torch.kernels.event_block import fused_block

    builds = ab.build_all({"other": str(parent_csrc), **(extra or {})})
    turns = ["other", "this", *(extra or {})]
    dev = torch.device("cuda", 0)
    out = {}
    for name in scenes:
        sc = cs.march_path_scene(name, dev)
        key = batch_key(cs.SEED, 960)
        ab.use(builds["this"])
        spec, pro, states = ms.trace_states(sc.integ, sc.src, sc.n, sc.lanes, key)
        tracer = sc.integ.batch_tracer(sc.n, sc.lanes)
        bkey = batch_key(cs.SEED, 1020)
        run = lambda: tracer(bkey, sc.src.sample(bkey, sc.lanes, "cuda"), sc.src)
        rec = {b: {"batch": [], "mid": [], "tail": []} for b in builds}
        for r in range(MARCH_ROUNDS):
            for b in turns + turns[::-1]:
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
                    rec[b][state].append(stage_launch_ms(run_k, st, buf.clone, 10) if stage
                                         else cs.device_block_ms(run_k, st, buf.clone, 10))
        ab.use(builds["this"])
        mean = lambda v: sum(v) / len(v)
        what = "stage_" if stage else ""
        out[name] = {b: {"batch_block_ms": mean([x["block_ms"] for x in v["batch"]]),
                         "batch_stage_ms": mean([x["stage_ms"] for x in v["batch"]]),
                         f"{what}mid_ms": mean(v["mid"]), f"{what}tail_ms": mean(v["tail"]),
                         "batches": v["batch"]} for b, v in rec.items()}
        if stage:
            # This build's stage: its ray loop and runs on the same blocks.
            for state, st, buf, kb in states[1:]:
                use = eb.march_ray_use(dev)
                use.zero_()
                fused_block(spec, pro, st.clone(), buf.clone(), key, sc.src, kb)
                got = dict(zip(eb.MARCH_USE, use.tolist()))
                out[name]["this"][f"{state}_ray_use"] = {
                    k: got[k] for k in eb.MARCH_USE if k.startswith("surface_")}
            out[name]["this"]["runs"] = eb.surface_march_runs(pro, spec, sc.lanes, dev)
        print(json.dumps({"march": name, **{b: {k: v for k, v in x.items() if k != "batches"}
                                            for b, x in out[name].items()}}), flush=True)
    return out


# The probe's copies: (tree, edits of its column_read_probe.cu) by name:
# its event loop run 0 times, its row read replaced by a float4 of the index,
# its Philox call by a hash, and its row read past the L1 (ld.global.cg).
OLD_LOOP = ("  for (int j = 0; j < PROBE_K; ++j) {", "  for (int j = 0; j < 0; ++j) {")
OLD_NO_READ = ("const float4 r = __ldg(table + ix * PROBE_N + iy);",
               "const float4 r = make_float4(xs, ys, (float)ix, (float)iy);")
OLD_NO_PHILOX = ("philox4x32_10((uint32_t)lane, kb, (uint32_t)j, STREAM_EVENT, k0, k1, w);",
                 "w[0] = (uint32_t)lane * 2654435761u + (uint32_t)j;")
OLD_LDCG = ("const float4 r = __ldg(table + ix * PROBE_N + iy);",
            "const float4 r = __ldcg(table + ix * PROBE_N + iy);")
PROBE_COPIES = {"this": ("this", []), "other": ("other", []), "empty": ("this", [OLD_LOOP]),
                "no_read": ("this", [OLD_NO_READ]), "no_philox": ("this", [OLD_NO_PHILOX]),
                "ldcg": ("this", [OLD_LDCG])}
PROBE_REAL = ("this", "other", "ldcg")     # held to the plain version
PROBE_BUILD = textwrap.dedent("""
    import sys
    from pathlib import Path
    import i3rc_tpu_torch.kernels.build as kb
    kb.CSRC = Path(sys.argv[1])
    kb.build(sys.argv[2], ("column_read_probe.cu",))
""")


def probe_builds(parent: Path) -> dict:
    """{name: library} of PROBE_COPIES, each the probe's source alone in a
    copy of its tree's csrc, compiled in parallel child processes."""
    import i3rc_tpu_torch.kernels.build as kbuild

    trees = {"this": kbuild.CSRC, "other": parent / "i3rc_tpu_torch" / "csrc"}
    dirs = {}
    for name, (tree, edits) in PROBE_COPIES.items():
        copy = ROOT / "build" / "ab" / f"probe_{name}" / "csrc"
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(trees[tree], copy)
        src = (copy / "column_read_probe.cu").read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"probe {name}: the code to replace is not there")
            src = src.replace(old, new)
        (copy / "column_read_probe.cu").write_text(src)
        dirs[name] = copy
    procs = {n: subprocess.Popen([sys.executable, "-c", PROBE_BUILD, str(d), f"probe_{n}"],
                                 cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)))
             for n, d in dirs.items()}
    libs = {}
    for n, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"probe build {n} failed")
        here, kbuild.CSRC = kbuild.CSRC, dirs[n]
        try:
            built = kbuild.build(f"probe_{n}", ("column_read_probe.cu",))
        finally:
            kbuild.CSRC = here
        fn = built.lib.i3rc_column_read_probe
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                                               ctypes.c_uint, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[n] = built
    return libs


def probe_ab(parent: Path) -> dict:
    from i3rc_tpu_torch import batch_key
    from i3rc_tpu_torch.kernels import column_probe as cp

    libs = probe_builds(parent)
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(cs.SEED)
    table = torch.rand((cp.N_SIDE ** 2, 4), generator=g).to(dev)
    x0 = torch.rand(cs.PROBE_LANES, generator=g).to(dev)
    y0 = torch.rand(cs.PROBE_LANES, generator=g).to(dev)
    key = batch_key(cs.SEED, 700)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(name, x, y, acc):
        rc = libs[name].lib.i3rc_column_read_probe(
            x.data_ptr(), y.data_ptr(), acc.data_ptr(), table.data_ptr(), cs.PROBE_LANES,
            key.seed & 0xFFFFFFFF, key.batch & 0xFFFFFFFF, 0, stream)
        if rc != 0:
            raise RuntimeError(f"probe {name}: CUDA error {rc}")

    tx, ty, tacc = cp.column_probe_reference(table, x0, y0,
                                             cp.probe_uniforms(key, 0, cs.PROBE_LANES, dev))
    for name in PROBE_REAL:
        x, y, acc = x0.clone(), y0.clone(), torch.empty_like(x0)
        launch(name, x, y, acc)
        torch.cuda.synchronize()
        if not (torch.equal(x, tx) and torch.equal(y, ty) and torch.equal(acc, tacc)):
            raise RuntimeError(f"probe {name} differs from the plain version")
    n = 20
    times = {b: {"events": [], "profiler": []} for b in libs}
    order = list(libs)
    for _ in range(2):
        for b in order + order[::-1]:
            x, y, acc = x0.clone(), y0.clone(), torch.empty_like(x0)
            launch(b, x, y, acc)
            times[b]["events"].append(cs.queued_ms(lambda: launch(b, x, y, acc), n))
            times[b]["profiler"].append(cs.profiled_ms(lambda: launch(b, x, y, acc), n,
                                                       "column_read_probe_kernel"))
    mean = lambda v: sum(v) / len(v)
    out = {b: {k: mean(v) for k, v in t.items()} for b, t in times.items()}
    print(json.dumps({"probe": out}), flush=True)
    return out


# A rank's job in a tree (written beside the build, importable by the
# spawned ranks): the graft scene's trace on the mesh, unprofiled, then
# profiled.
SHARD_RANK_JOB = textwrap.dedent("""
    import time
    import torch

    RAY_KERNELS = ("shadow_advance_kernel", "shadow_pack_kernel", "shadow_block_kernel")

    def graft_job(mesh, photons, lanes, seed):
        import sharded_scenes as ss
        from i3rc_tpu_torch import PhotonSource
        from i3rc_tpu_torch.parallel.sharded_domain import ShardedTrace
        sc = ss.scene("graft", ss.host("i3rc_tpu_torch"), 2)
        src = PhotonSource.directional(*sc["src"])

        def trace(prof=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr = ShardedTrace.create(sc["domain"], src, photons, mesh, n_lanes_per_shard=lanes,
                                     seed=seed, **sc["kw"])
            if prof is not None:
                prof.__enter__()
            while tr.running():
                tr.block()
            torch.cuda.synchronize()
            if prof is not None:
                prof.__exit__(None, None, None)
            raw = tr.finish()
            torch.cuda.synchronize()
            return raw, time.perf_counter() - t0, tr.kb

        raw, seconds, blocks = trace()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        trace(prof)
        found = prof.key_averages()
        ms = lambda keys: sum(e.self_device_time_total for e in found
                              if any(k in e.key for k in keys)) / 1e3
        return dict(seconds=seconds, blocks=blocks, rays_ms=ms(RAY_KERNELS),
                    sd_ms=ms(("sharded_event_block_kernel",)), busy_ms=ms(("",)),
                    n_bad=int(raw.n_bad), n=int(raw.n_photons),
                    intensity=(raw.intensity.reshape(-1, 2).sum(0) / raw.n_photons).tolist())
""")
# A fresh process in a tree: the graft scene on one NCCL rank, then on two
# gloo ranks sharing the card.
SHARD_JOB = textwrap.dedent("""
    import json, torch, torch.distributed as dist
    import sharded_scenes as ss
    import shard_rank_job as job
    from i3rc_tpu_torch.kernels import sharded_block as sb
    from i3rc_tpu_torch.parallel.mesh import default_mesh
    N, L = {photons}, {lanes}
    sb.build()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    mesh = default_mesh(device=torch.device("cuda", 0))
    job.graft_job(mesh, 1 << 18, L, 5)
    one = job.graft_job(mesh, N, L, 7)
    dist.destroy_process_group()
    ranks = ss.join_world(ss.start_world(2, job.graft_job, (N, L, 7), device="cuda:0"),
                          timeout=900)
    sec = max(r["seconds"] for r in ranks)
    two = dict(seconds=sec, blocks=max(r["blocks"] for r in ranks),
               rays_ms=sum(r["rays_ms"] for r in ranks), sd_ms=sum(r["sd_ms"] for r in ranks),
               busy_ms=sum(r["busy_ms"] for r in ranks), n_bad=ranks[0]["n_bad"],
               intensity=ranks[0]["intensity"])
    for r in (one, two):
        r["photons_per_s"] = N / r["seconds"]
    print("RESULT " + json.dumps(dict(one_rank=one, two_ranks=two)))
""")


def sharded_ab(parent: Path) -> dict:
    trees = {"other": parent.resolve(), "this": ROOT}
    code = SHARD_JOB.format(photons=SHARD_PHOTONS, lanes=SHARD_LANES)
    jobs = ROOT / "build" / "ab" / "shard_job"
    jobs.mkdir(parents=True, exist_ok=True)
    (jobs / "shard_rank_job.py").write_text(SHARD_RANK_JOB)
    rec = {b: [] for b in trees}
    for _ in range(SHARD_ROUNDS):
        for b in ("other", "this", "this", "other"):
            path = os.pathsep.join(map(str, (trees[b], trees[b] / "tests", jobs)))
            res = subprocess.run([sys.executable, "-c", code], cwd=trees[b], text=True,
                                 capture_output=True, timeout=1200,
                                 env=dict(os.environ, PYTHONPATH=path))
            lines = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
            if res.returncode != 0 or not lines:
                raise RuntimeError(f"sharded {b}: {res.stderr[-3000:]}")
            rec[b].append(json.loads(lines[-1][7:]))
            print(json.dumps({"sharded": b, **rec[b][-1]}), flush=True)
    return rec


# The look-back's wait on a record below (csrc/sharded_event_block.cu
# look_back, SD's and SB's), and the copy's: read the record once, as an
# inclusive prefix.
LOOKBACK_WAIT = ("      for (;;) {\n        fl = ld_acquire(rec + LB_FLAG);\n"
                 "        if ((fl >> 2) == epoch && (fl & 3) != 0) break;\n"
                 "        __nanosleep(64);\n      }", "      fl = 2;")


# SB's waits on other CTAs, each read once (for timing only): its
# look-back's and its pack's on the tiles other CTAs traced.
SB_NO_WAIT = [LOOKBACK_WAIT, ("    while (ld_acquire(done) != p.epoch) __nanosleep(64);", "")]
# SB's ray loop left out: no ray of the queue is dealt; SB's pack left out:
# the CTA ends after its ray loop and tallies (the last run resets the
# tickets).  For timing only.
NO_RAY_LOOP = ("  const int n = qn[0];\n", "  const int n = 0;\n")
NO_PACK = ("  const int s0 = run * T * CTA_THREADS;\n",
           "  if (run == n_runs - 1 && t == 0) p.ctl[0] = 0;\n  return;\n"
           "  const int s0 = run * T * CTA_THREADS;\n")
# SB's run of tiles a CTA, as the launch picks it (one wave, at most
# SB_MAX_TILES), and its traced tiles spread over the pool while the grid
# fits one wave; the copies' fixed length, and each CTA tracing its own run.
SB_RUN = "  int T = fit < SB_MAX_TILES ? fit : SB_MAX_TILES;\n"
SB_SPREAD = "  int interleave = runs <= wave;\n"
SB_TILES = {"tiles1": [(SB_RUN, "  int T = 1;\n")], "tiles2": [(SB_RUN, "  int T = 2;\n")],
            "tiles4": [(SB_RUN, "  int T = 4;\n")],
            "own8": [(SB_SPREAD, "  int interleave = 0;\n")]}


def copy_build(name: str, edits, csrc: Path | None = None) -> object:
    """The sharded library built from a copy of ``csrc`` (this tree's by
    default) whose ``sharded_event_block.cu`` has each (old, new) of
    ``edits`` replaced, its C interface declared (SD's alone where the
    library has no SB)."""
    import i3rc_tpu_torch.kernels.build as kbuild
    from i3rc_tpu_torch.kernels import sharded_block as sb

    copy = ROOT / "build" / "ab" / name / "csrc"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(csrc or kbuild.CSRC, copy)
    src = (copy / "sharded_event_block.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: the code to replace is not where this script expects it")
        src = src.replace(old, new)
    (copy / "sharded_event_block.cu").write_text(src)
    here, kbuild.CSRC = kbuild.CSRC, copy
    try:
        built = kbuild.build("sharded_event_block", ("sharded_event_block.cu",))
    finally:
        kbuild.CSRC = here
    if hasattr(built.lib, "i3rc_shadow_block"):
        sb.declare(built.lib)
    else:
        lib = built.lib
        lib.i3rc_sharded_params_size.restype = ctypes.c_int
        lib.i3rc_sharded_event_block.argtypes = [ctypes.c_void_p] * 4
        lib.i3rc_sharded_event_block.restype = ctypes.c_int
        if lib.i3rc_sharded_params_size() != ctypes.sizeof(sb._ShardParams):
            raise RuntimeError(f"{name}: the library's ShardParams differs from this tree's")
    return built


def in_turns(builds: dict, run, x0, new_acc, kernel: str) -> dict:
    """Mean device ms of ``run`` under each build, in turns (this, the
    others, the others, this), twice."""
    from i3rc_tpu_torch.kernels import sharded_block as sb

    own = builds["this"]
    times = {b: [] for b in builds}
    order = ["this"] + [b for b in builds if b != "this"]
    for _ in range(2):
        for b in order + order[::-1]:
            sb.build = lambda b=b: builds[b]
            times[b].append(cs.device_block_ms(run, x0, new_acc, 5, kernel=kernel))
    sb.build = lambda: own
    return {b: sum(v) / len(v) for b, v in times.items()}


def lookback_split(parent: Path) -> dict:
    import sharded_scenes as ss
    from i3rc_tpu_torch.kernels import sharded_block as sb

    builds = {"this": sb.build(), "no_wait": copy_build("lookback_no_wait", [LOOKBACK_WAIT])}
    try:
        builds["other"] = copy_build("lookback_other", [], parent / "i3rc_tpu_torch" / "csrc")
    except RuntimeError as e:
        print(json.dumps({"lookback_other": str(e)[:300]}), flush=True)
    dev = torch.device("cuda", 0)
    st = ss.trace_states(ss.scene("landsat", ss.host("i3rc_tpu_torch"), 2), SHARD_PHOTONS,
                         SHARD_LANES, dev)
    spec, key, source, albedo = st["spec"], st["key"], st["source"], st["albedo"]
    rec = {}
    for tag, (kb, plan, s0, pool0, bufs0) in zip(("mid", "tail"), st["block"]):
        x0 = cs._BlockInput(s0, pool0, bufs0)
        run = lambda s, _, kb=kb, plan=plan: sb.sharded_event_block(
            spec, s.st, s.pool, s.bufs, plan, key, kb, source, albedo)
        rec[tag] = in_turns(builds, run, x0, lambda: None, "sharded_event_block")
        print(json.dumps({"lookback": tag, "kb": kb, **rec[tag]}), flush=True)
    return rec


def shadow_split() -> dict:
    """SB's launch split (this tree only), on the graft scene's mid-flight
    and tail blocks on one rank (its two-rank form, the whole domain;
    2^22 photons, 2^20 slots): this build against a copy that does not wait
    on other CTAs (its look-back over the runs below, its pack on the tiles
    other CTAs traced: the launch's waits), a copy whose ray loop deals no
    ray (the flags, the queue and the pack alone), one without the pack
    (the flags and the ray loop) and one with neither, in turns."""
    from i3rc_tpu_torch.kernels import sharded_block as sb

    return shadow_in_turns({"this": sb.build(), "no_wait": copy_build("sb_no_wait", SB_NO_WAIT),
                            "no_ray_loop": copy_build("sb_no_ray_loop", [NO_RAY_LOOP]),
                            "no_pack": copy_build("sb_no_pack", [NO_PACK]),
                            "flags_only": copy_build("sb_flags_only", [NO_RAY_LOOP, NO_PACK])},
                           "shadow_split", check=())


def shadow_tiles() -> dict:
    """SB's run of tiles a CTA (this tree only), on the blocks of
    ``shadow_split``: this build against the copies of ``SB_TILES``, in
    turns, each copy's result held against the plain version first."""
    from i3rc_tpu_torch.kernels import sharded_block as sb

    builds = {"this": sb.build(), **{k: copy_build(f"sb_{k}", e) for k, e in SB_TILES.items()}}
    return shadow_in_turns(builds, "shadow_tiles", check=tuple(SB_TILES))


def shadow_in_turns(builds: dict, label: str, check: tuple) -> dict:
    """SB's device ms a launch under each build, in turns, on the graft
    scene's mid-flight and tail blocks on one rank, beside the block's rays
    and steps and the launch's ray loop; the builds of ``check`` first held
    against the plain version (bit for bit, tallies within 1e-9)."""
    import sharded_scenes as ss
    from i3rc_tpu_torch.kernels import sharded_block as sb

    own = builds["this"]
    dev = torch.device("cuda", 0)
    st = ss.trace_states(ss.scene("graft", ss.host("i3rc_tpu_torch"), 2), SHARD_PHOTONS,
                         SHARD_LANES, dev)
    spec = st["spec"]
    n = spec.nx_loc * spec.n_y * spec.n_dirs
    acc = lambda: tuple(torch.zeros(k, dtype=torch.float64, device=dev)
                        for k in (n, n * (spec.n_comp + 1)))
    run = lambda x, a: sb.shadow_block(spec, x.pool, x.bufs, *a)
    rec = {}
    for tag, (kb, pool, bufs) in zip(("mid", "tail"), st["sb"]):
        for b in check:
            sb.build = lambda b=b: builds[b]
            v = ss.sb_vs_twin(spec, pool, bufs)
            sb.build = lambda: own
            if not (v["bit_equal"] and v["tally_abs_err"] <= 1e-9 * max(1.0, v["tally_sum"])):
                raise RuntimeError(f"{label} {tag} build {b}: {v}")
        r = ss.sb_vs_twin(spec, pool, bufs)
        rec[tag] = in_turns(builds, run, cs._BlockInput(None, pool, bufs), acc, "shadow_block")
        rec[tag].update(kb=kb, rays=r["rays"], steps=r["steps"], use=r["use"])
        print(json.dumps({label: tag, **rec[tag]}), flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the other tree (git archive of a commit)")
    ap.add_argument("--parts", default="march,sharded,lookback")
    ap.add_argument("--out", default="build/redesign_ab.json")
    ap.add_argument("--build", action="append", default=[], metavar="NAME=CSRC",
                    help="smarch: another copy of csrc to time beside this tree's and the "
                         "other's (its parameter block a prefix of this one's)")
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
    if "smarch" in parts:
        extra = dict(b.split("=", 1) for b in args.build)
        out["smarch"] = march_ab(parent / "i3rc_tpu_torch" / "csrc", ("3d_rpv",), stage=True,
                                 extra=extra)
    if "probe" in parts:
        out["probe"] = probe_ab(parent)
    if "sharded" in parts:
        out["sharded"] = sharded_ab(parent)
    if "lookback" in parts:
        out["lookback"] = lookback_split(parent)
    if "sbsplit" in parts:
        out["sbsplit"] = shadow_split()
    if "sbtiles" in parts:
        out["sbtiles"] = shadow_tiles()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
