#!/usr/bin/env python3
"""A/B of event-block kernel builds of the PyTorch/CUDA port on the same inputs.

Builds the event-block library from this checkout's ``i3rc_tpu_torch/csrc``
("this") and from each source directory given with ``--build NAME=DIR``
(for example a parent commit's ``i3rc_tpu_torch/csrc`` unpacked with ``git
archive``, or a copy with one line changed), all in parallel.  Then, in one
process, it runs every build on identical inputs, alternating the builds
(A B ... B A A B ...) so that a drift of the card's clock falls on all:

* blocks: one K-event block at 2^18 lanes on the "full" and "tail" states of
  ``chip_smoke.block_states``: flux (K1) and detectors (K3) on the step
  cloud at K = 8, the column variant on Landsat at K = 32 and 8.  Per build
  and round the median of 21 launches on fresh copies of the state (CUDA
  events); each build's result must equal the plain twin's on every state
  row (detector accumulators within 1e-9 relative).
* batches: the event kernel's device time summed over one whole batch
  (``chip_smoke.batch_kernel_time``): the radiance batch (2^24 photons; by
  the profiler and by CUDA events) and the Landsat batch (2^23) at K = 8
  and 32 (by CUDA events).
* broadband: phase 13 of ``chip_smoke.py`` (``broadband_slice``) per build.

A build whose library lacks a variant (an older one without K = 32 for
column media) is left out of that case.  Needs a CUDA device and nvcc.
Writes every number to ``--out`` (``build/event_block_ab.json``).  Run
from the repository root:

    python3 benchmarks/torch_event_block_ab.py --build parent=build/ab/parent/csrc
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import i3rc_tpu_torch.kernels.build as kbuild  # noqa: E402
import i3rc_tpu_torch.kernels.event_block as eb  # noqa: E402

ROUNDS = 4
LAUNCHES = 21
# (case, block_states arguments): K1 and K3 at the separable K, the column
# variant at the planner's K and at the K before it.
BLOCK_CASES = [("flux_K8", dict(ssa=1.0)),
               ("detectors_K8", dict(ssa=1.0, detectors=True)),
               ("column_K32_chain2", dict(ssa=1.0, chain=2, K=32)),
               ("column_K32_chain0_ssa0.99", dict(ssa=0.99, chain=0, K=32)),
               ("column_K8_chain2", dict(ssa=1.0, chain=2, K=8))]

_BUILD_ONE = ("import sys; from pathlib import Path; "
              "import i3rc_tpu_torch.kernels.build as kb; kb.CSRC = Path(sys.argv[1]); "
              "import i3rc_tpu_torch.kernels.event_block as eb; eb.build()")


def build_all(dirs: dict) -> dict:
    """{name: Built}: this checkout's library and one per source directory,
    the others compiled in child processes while this one compiles."""
    procs = {name: subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(d)], cwd=ROOT)
             for name, d in dirs.items()}
    built = {"this": eb.build()}
    for name, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"build {name} failed")
    own = kbuild.CSRC
    for name, d in dirs.items():
        kbuild.CSRC = Path(d)
        try:
            built[name] = eb.build.__wrapped__()      # the cached library of that build
        finally:
            kbuild.CSRC = own
    return built


def use(built) -> None:
    """Make ``event_block`` launch through the given library."""
    eb.build = lambda: built


def runs(built, make) -> bool:
    """Whether the build launches the case (an older library refuses some
    variants before launching anything)."""
    use(built)
    try:
        make()
        return True
    except RuntimeError as e:
        if "CUDA error 1" not in str(e):       # cudaErrorInvalidValue: not built
            raise
        return False


def median_ms(run, s0, new_acc) -> float:
    times = []
    for _ in range(LAUNCHES):
        s, acc = s0.clone(), new_acc()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run(s, acc)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def order(names: list, r: int) -> list:
    return names if r % 2 == 0 else names[::-1]


def block_ab(builds: dict, dev, card: str, cases) -> list:
    from i3rc_tpu_torch.core.rng import philox_uniforms
    from i3rc_tpu_torch.kernels.event_block import EVCT, event_block, event_block_reference

    out = []
    for case, kw in BLOCK_CASES:
        if cases and case not in cases:
            continue
        use(builds["this"])
        spec, key, new_acc, states = cs.block_states(dev=dev, **kw)
        for state, s0, kb in states:
            ref, acc_t = s0.clone(), new_acc()
            event_block_reference(spec, ref, philox_uniforms(key, kb, spec.K, spec.n_draws,
                                                             s0.n_lanes, dev), acc_t)
            run = lambda s, a: event_block(spec, s, key, kb, a)
            names = []
            for name, built in builds.items():
                got, acc_k = s0.clone(), new_acc()
                if not runs(built, lambda: run(got, acc_k)):
                    continue
                torch.cuda.synchronize()
                cs.check(torch.equal(got.f, ref.f) and torch.equal(got.i, ref.i),
                         f"{case} {state}: build {name} differs from the twin")
                if acc_t is not None:
                    err = float((acc_k - acc_t).abs().max() / acc_t.abs().max().clamp(min=1e-300))
                    cs.check(err <= 1e-9, f"{case} {state}: build {name} accumulator {err}")
                names.append(name)
            ms = {n: [] for n in names}
            for r in range(ROUNDS):
                for name in order(names, r):
                    use(builds[name])
                    median_ms(run, s0, new_acc)         # warm-up of this build
                    ms[name].append(median_ms(run, s0, new_acc))
            rec = {"case": case, "state": state, "alive": float(s0.i[0].float().mean()),
                   "lane_events": int((ref.i[EVCT] - s0.i[EVCT]).sum()), "K": spec.K,
                   "chain": spec.chain, "ms": ms}
            out.append(rec)
            for name in names:
                cs.say("ab block", case=case, state=state, alive=f"{rec['alive']:.4f}",
                       lane_events=rec["lane_events"], build=name, bit_equal=True,
                       ms=",".join(f"{t:.4f}" for t in ms[name]),
                       ms_median=f"{statistics.median(ms[name]):.4f}", card=json.dumps(card))
    use(builds["this"])
    return out


def batch_ab(builds: dict, card: str, cases) -> list:
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, batch_key,
                                make_landsat_cloud, make_step_cloud)

    src = PhotonSource.directional(0.5, 0.0)
    rad = Integrator.create(make_step_cloud(1.0), cs.radiance_config(),
                            intensity_mus=cs.DET_MUS, intensity_phis=cs.DET_PHIS,
                            device="cuda")
    flux = IntegratorConfig(use_ray_tracing=False, max_events=500,
                            compute_volume_absorption=False)
    land = {K: Integrator.create(make_landsat_cloud(1.0), replace(flux, fastpath_unroll=K),
                                 device="cuda") for K in (8, 32)}
    # The profiler also times the radiance batch (269 blocks), beside the
    # CUDA events; a Landsat batch at K = 8 (1600 blocks) is too many for it.
    batch_cases = [c for c in [("radiance_K8", rad, cs.SLICE_PHOTONS, 320, True),
                               ("landsat_K8", land[8], cs.LANDSAT_PHOTONS, 520, False),
                               ("landsat_K32", land[32], cs.LANDSAT_PHOTONS, 520, False)]
                   if not cases or c[0] in cases]
    out = []
    for case, integ, n, seed, profile in batch_cases:
        key = batch_key(cs.SEED, seed)
        tracer = integ.batch_tracer(n, cs.L_CHECK)
        batch = lambda: tracer(key, src.sample(key, cs.L_CHECK, "cuda"), src)
        names = [name for name, built in builds.items()
                 if runs(built, lambda: integ.batch_tracer(1 << 10, 1 << 10)(
                     key, src.sample(key, 1 << 10, "cuda"), src))]
        use(builds["this"])
        batch()                                         # warm-up
        recs = {name: [] for name in names}
        for r in range(2):
            for name in order(names, r):
                use(builds[name])
                recs[name].append(cs.batch_kernel_time(batch, profile))
        for name in names:
            bks = recs[name]
            out.append({"case": case, "build": name, "batches": bks})
            cs.say("ab batch", case=case, build=name, photons=n,
                   kernel_ms=",".join(f"{bk['kernel_ms']:.3f}" for bk in bks),
                   kernel_ms_from=bks[0]["kernel_ms_from"],
                   events_ms=",".join(f"{bk['events_ms']:.3f}" for bk in bks),
                   launches=bks[0]["launches"],
                   lane_events=bks[0]["lane_events"], bound_ms=f"{bks[0]['bound'][0]:.3f}",
                   card=json.dumps(card))
    use(builds["this"])
    return out


def broadband_ab(builds: dict, dev, card: str) -> list:
    names = list(builds)
    out = []
    for r in range(2):
        for name in order(names, r):
            use(builds[name])
            cs.say("ab broadband", build=name, round=r)
            out.append({"build": name, "launches": cs.broadband_slice(dev, card)})
    use(builds["this"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build", action="append", default=[], metavar="NAME=DIR",
                    help="another csrc directory to build and compare")
    ap.add_argument("--parts", default="blocks,batches,broadband",
                    help="comma-separated subset of blocks, batches, broadband")
    ap.add_argument("--cases", default="",
                    help="comma-separated block and batch case names (default: all)")
    ap.add_argument("--out", default=str(ROOT / "build" / "event_block_ab.json"),
                    help="JSON file for every number")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_event_block_ab: torch finds no CUDA device", file=sys.stderr)
        return 2
    dirs = dict(b.split("=", 1) for b in args.build)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    builds = build_all(dirs)
    cs.say("ab builds", builds=",".join(builds), card=json.dumps(card))
    dev = torch.device("cuda", 0)
    parts = args.parts.split(",")
    cases = set(filter(None, args.cases.split(",")))
    result = {"card": card, "builds": {k: str(v) for k, v in dirs.items()}}
    if "blocks" in parts:
        result["blocks"] = block_ab(builds, dev, card, cases)
    if "batches" in parts:
        result["batches"] = batch_ab(builds, card, cases)
    if "broadband" in parts:
        result["broadband"] = broadband_ab(builds, dev, card)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1, default=str))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
