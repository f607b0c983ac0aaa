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
* batches: the block kernel's device time (prologue and events, one launch
  per block) summed over one whole batch (``chip_smoke.batch_kernel_time``):
  the flux, gas-flux and radiance batches (2^24 photons; by the profiler
  and by CUDA events) and the Landsat batch (2^23) at K = 8 and 32 (by CUDA
  events).
* broadband: phase 13 of ``chip_smoke.py`` (``broadband_slice``) per build.
* general: the general event block G (``general_event_block.cu``) of each
  build on the mid-flight and tail states of ``chip_smoke.py`` phase 26's
  step-cloud and Landsat-general rows (device ms per launch, each build
  bit-equal to the twin), then G's device time summed over one batch of
  phase 27 (the step cloud by ray tracing, 2^24 photons at 2^20 lanes) and
  of phase 28 (Landsat general, 2^21), by the profiler.  A build of
  another commit's ``csrc`` (PR 9's, without the detector set) runs here if
  its parameter block is a prefix of this checkout's (the detectors'
  fields were appended): its library is built from the sources it has and
  given the flux cases only.
* estimate: G with detectors (its ``general_estimate`` stage) of each
  build on ``chip_smoke.py`` phase 32's path (a) scene (the step cloud
  through the default configuration with the I3RC detectors, 2^22 photons
  at 2^20 lanes): its mid-flight and tail blocks (device ms per launch,
  each build's state bit-equal to the twin's; the tallies too for this
  checkout's build) and one batch by the profiler.  A copy of ``csrc``
  whose estimate stage adds nothing to the tallies (the ``tally_add``
  calls of ``general_estimate`` removed: a build for this measurement
  only) gives the tally's share.  The other builds' lane state and
  estimate steps are held to the twin's; their tallies and ray counts are
  not (an earlier commit's build has no ray counts).
* rates: the end-to-end photons/s of the four slices (step-cloud flux and
  radiance, broadband, Landsat, timed as ``chip_smoke.py`` phases 5, 9, 13
  and 16 time them) and of the two general paths (phases 27 and 28, with
  G's device ms over one more batch of each by the profiler) of this
  checkout and of each whole tree given with ``--tree NAME=DIR`` (another
  commit unpacked with ``git archive``), each measurement in a fresh
  process with that tree's own package and kernels, the trees alternating
  (A B B A), since a rate drifts with a process's age.  ``--cases`` picks
  rates by name too (flux, radiance, broadband, landsat,
  general_step_cloud, general_landsat).

The builds must share this checkout's C interface (a copy of ``csrc`` with
the line under test changed); a build whose library refuses a variant, or
whose block differs from the twin's (a constant K of 8 on a K = 32 plan),
is left out of that block case.  The batches have no such check: give them
only the builds that fit their cases (``--cases``).  The block times are
CUDA-event times around the Python call, so they also hold the host's
building of the parameter block, the same for every build; the batch times
are the kernel's own.  Needs a CUDA device and nvcc.  Writes every number
to ``--out`` (``build/event_block_ab.json``).  Run from the repository
root:

    python3 benchmarks/torch_event_block_ab.py --build minctas=build/ab/minctas/csrc
    python3 benchmarks/torch_event_block_ab.py --parts rates --tree parent=build/ab/parent
    python3 benchmarks/torch_event_block_ab.py --parts general --build compact=build/ab/compact/csrc
    python3 benchmarks/torch_event_block_ab.py --parts estimate --build notally=build/ab/notally/csrc
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import i3rc_tpu_torch.kernels.build as kbuild  # noqa: E402
import i3rc_tpu_torch.kernels.event_block as eb  # noqa: E402
import i3rc_tpu_torch.kernels.general_block as gb  # noqa: E402

ROUNDS = 4
LAUNCHES = 21
# (case, block_states arguments): K1, K2 and K3 at the separable K, the column
# variant at the planner's K and at the K before it.
BLOCK_CASES = [("flux_K8", dict(ssa=1.0)),
               ("gas_K8", dict(ssa=1.0, gas=np.full(32, 3e-4))),
               ("detectors_K8", dict(ssa=1.0, detectors=True)),
               ("column_K32_chain2", dict(ssa=1.0, chain=2, K=32)),
               ("column_K32_chain0_ssa0.99", dict(ssa=0.99, chain=0, K=32)),
               ("column_K8_chain2", dict(ssa=1.0, chain=2, K=8))]

_GENERAL_SOURCES = ("general_event_block.cu", "general_event_block_det.cu")


def general_library():
    """The general library of ``kbuild.CSRC`` from the sources it has, its C
    function declared as ``general_block.build`` declares it; another
    commit's parameter block must be a prefix of this checkout's."""
    import ctypes

    built = kbuild.build("general_event_block",
                         tuple(s for s in _GENERAL_SOURCES if (kbuild.CSRC / s).exists()))
    lib, vp, ci = built.lib, ctypes.c_void_p, ctypes.c_int
    lib.i3rc_general_params_size.restype = ci
    lib.i3rc_general_event_block.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    lib.i3rc_general_event_block.restype = ci
    if lib.i3rc_general_params_size() > ctypes.sizeof(gb._GeneralParams):
        raise RuntimeError(f"{kbuild.CSRC}: its GeneralParams is not a prefix of this one")
    return built


_BUILD_FNS = {"event_block": eb.build, "general_block": general_library}
_BUILD_ONE = ("import sys; from pathlib import Path; sys.path.insert(0, {root!r}); "
              "import i3rc_tpu_torch.kernels.build as kb; kb.CSRC = Path(sys.argv[1]); "
              "import benchmarks.torch_event_block_ab as ab; ab._BUILD_FNS[{module!r}]()")


def build_all(dirs: dict, module: str = "event_block") -> dict:
    """{name: Built}: this checkout's library of ``module`` (event_block or
    general_block) and one per source directory, the others compiled in
    child processes while this one compiles."""
    code = _BUILD_ONE.format(root=str(ROOT), module=module)
    procs = {name: subprocess.Popen([sys.executable, "-c", code, str(Path(d).resolve())],
                                    cwd=ROOT) for name, d in dirs.items()}
    built = {"this": eb.build() if module == "event_block" else gb.build()}
    for name, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"build {name} failed")
    own = kbuild.CSRC
    for name, d in dirs.items():
        kbuild.CSRC = Path(d).resolve()
        try:
            # The cached library of that build.
            built[name] = eb.build.__wrapped__() if module == "event_block" else general_library()
        finally:
            kbuild.CSRC = own
    return built


def use(built, module=eb) -> None:
    """Make ``event_block`` (or ``general_block``) launch through the given
    library."""
    module.build = lambda: built


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
                same = torch.equal(got.f, ref.f) and torch.equal(got.i, ref.i)
                cs.check(same or name != "this", f"{case} {state}: differs from the twin")
                if not same:
                    # A build whose switch does not fit the case (a constant
                    # K of 8 on a K = 32 plan) is left out of it.
                    cs.say("ab block", case=case, state=state, build=name, bit_equal=False,
                           note="left out of this case")
                    continue
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
    from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component

    step = Integrator.create(make_step_cloud(1.0), flux, device="cuda")
    gas = Integrator.create(domain_with_gas_component(make_step_cloud(1.0), np.full(32, 4e-4)),
                            flux, device="cuda")
    # The profiler also times the step-cloud batches (88-269 blocks), beside
    # the CUDA events; a Landsat batch at K = 8 (1600 blocks) is too many for it.
    batch_cases = [c for c in [("flux_K8", step, cs.SLICE_PHOTONS, 110, True),
                               ("gas_K8", gas, cs.SLICE_PHOTONS, 420, True),
                               ("radiance_K8", rad, cs.SLICE_PHOTONS, 320, True),
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
            out.append({"build": name, "launches": cs.broadband_slice(dev, card)[0]})
    use(builds["this"])
    return out


def general_ab(builds: dict, dev, card: str, cases) -> dict:
    """G of each build: blocks on phase 26's mid-flight and tail states of
    the step cloud and Landsat general, then one batch of each path, the
    builds alternating."""
    from i3rc_tpu_torch import batch_key

    out = {"blocks": [], "batches": []}
    names = list(builds)
    for row, name in enumerate(cs.GENERAL_TIMED):
        if cases and name not in cases:
            continue
        use(builds["this"], gb)
        sc = cs.general_scene(name, dev)
        integ, src, n, L = sc.integ, sc.src, sc.n, sc.lanes
        tracer = integ.general_tracer(n, L)
        spec, tables, opt = tracer.spec, integ.tables, integ.device_optics
        var = gb.variant(spec, opt)
        key = batch_key(cs.SEED, 900 + row)
        st = gb.launch_state(spec, src.sample(key, L, dev), n)
        buf = gb.general_buffers(spec, st, min(L, n))
        gb.general_block(spec, var, opt, tables, st, buf, key, src, 0)
        states, kb = [("mid", st.clone(), buf.clone(), 1)], 1
        while not (int(buf.ctl[kb & 1]) >= n and float(st.i[gb.ALIVE].float().mean()) <= 0.15):
            gb.general_block(spec, var, opt, tables, st, buf, key, src, kb)
            kb += 1
        states.append(("tail", st.clone(), buf.clone(), kb))
        for state, s0, b0, kb_s in states:
            sr, br = s0.clone(), b0.clone()
            gb.general_block_reference(spec, var, opt, tables, sr, br, key, src, kb_s)
            run = lambda s, b: gb.general_block(spec, var, opt, tables, s, b, key, src, kb_s)
            for bname in names:
                use(builds[bname], gb)
                sk, bk = s0.clone(), b0.clone()
                run(sk, bk)
                torch.cuda.synchronize()
                cs.check(torch.equal(sk.f, sr.f) and torch.equal(sk.i, sr.i)
                         and torch.equal(bk.dead, br.dead) and torch.equal(bk.ctl, br.ctl),
                         f"G {name} {state}: build {bname} differs from the twin")
            ms = {b: [] for b in names}
            for r in range(ROUNDS):
                for bname in order(names, r):
                    use(builds[bname], gb)
                    ms[bname].append(cs.general_block_ms(run, lambda: (s0.clone(), b0.clone()),
                                                         10)[1])
            out["blocks"].append({"scene": name, "state": state, "ms": ms,
                                  "alive": float(s0.i[gb.ALIVE].float().mean())})
            for bname in names:
                cs.say("ab general-block", scene=name, state=state, build=bname,
                       alive=f"{out['blocks'][-1]['alive']:.4f}", bit_equal=True,
                       device_ms=",".join(f"{t:.4f}" for t in ms[bname]),
                       device_ms_median=f"{statistics.median(ms[bname]):.4f}",
                       card=json.dumps(card))
        # One batch of the path (phase 27 or 28) per build and round.
        bn = cs.GENERAL_PHOTONS if name == "rt_step_cloud" else cs.LANDSAT_GENERAL_PHOTONS
        bkey = batch_key(cs.SEED, 910 + row)
        tracer = integ.general_tracer(bn, cs.GENERAL_LANES)
        batch = lambda: tracer(bkey, src.sample(bkey, cs.GENERAL_LANES, "cuda"), src)
        batch()
        torch.cuda.synchronize()
        recs = {b: [] for b in names}
        for r in range(2):
            for bname in order(names, r):
                use(builds[bname], gb)
                pb = cs.profile_batch(batch, "general_event_block_kernel")
                recs[bname].append({"block_ms": pb["block_ms"],
                                    "launches": pb["block_launches"], "host_ms": pb["wall_ms"],
                                    "fup": float(pb["raw"].flux_up.sum()) / bn})
        for bname in names:
            out["batches"].append({"scene": name, "build": bname, "photons": bn,
                                   "batches": recs[bname]})
            cs.say("ab general-batch", scene=name, build=bname, photons=bn,
                   kernel_ms=",".join(f"{r['block_ms']:.3f}" for r in recs[bname]),
                   launches=recs[bname][0]["launches"],
                   host_ms=",".join(f"{r['host_ms']:.3f}" for r in recs[bname]),
                   fup=",".join(f"{r['fup']:.6f}" for r in recs[bname]), card=json.dumps(card))
    use(builds["this"], gb)
    return out


def estimate_ab(builds: dict, dev, card: str) -> dict:
    """G with detectors of each build: path (a)'s mid-flight and tail blocks
    (chip_smoke.py phase 32's scene), then one batch of path (a), the
    builds alternating; every build's lane state bit-equal to the twin's,
    this checkout's tallies within 1e-9 of the twin's too."""
    from i3rc_tpu_torch import Integrator, PhotonSource, batch_key, make_step_cloud

    out = {"blocks": [], "batches": []}
    names = list(builds)
    use(builds["this"], gb)
    src = PhotonSource.directional(0.5, 0.0)
    n, L = cs.RAD_GENERAL_PHOTONS, cs.GENERAL_LANES
    integ = Integrator.create(make_step_cloud(1.0), device=dev, intensity_mus=cs.DET_MUS,
                              intensity_phis=cs.DET_PHIS)
    tracer = integ.general_tracer(n, L)
    spec, tables, opt = tracer.spec, integ.tables, integ.device_optics
    var = gb.variant(spec, opt)
    key = batch_key(cs.SEED, 990)
    st = gb.launch_state(spec, src.sample(key, L, dev), n)
    buf = gb.general_buffers(spec, st, min(L, n))
    gb.general_block(spec, var, opt, tables, st, buf, key, src, 0)
    states, kb = [("mid", st.clone(), buf.clone(), 1)], 1
    while not (int(buf.ctl[kb & 1]) >= n and float(st.i[gb.ALIVE].float().mean()) <= 0.15):
        gb.general_block(spec, var, opt, tables, st, buf, key, src, kb)
        kb += 1
    states.append(("tail", st.clone(), buf.clone(), kb))
    for state, s0, b0, kb_s in states:
        sr, br = s0.clone(), b0.clone()
        gb.general_block_reference(spec, var, opt, tables, sr, br, key, src, kb_s)
        run = lambda s, b: gb.general_block(spec, var, opt, tables, s, b, key, src, kb_s)
        for bname in names:
            use(builds[bname], gb)
            sk, bk = s0.clone(), b0.clone()
            run(sk, bk)
            torch.cuda.synchronize()
            cs.check(torch.equal(sk.f, sr.f) and torch.equal(sk.i, sr.i)
                     and torch.equal(bk.int_steps, br.int_steps),
                     f"G+estimate {state}: build {bname} differs from the twin")
            if bname == "this":
                err = float((bk.intensity - br.intensity).abs().max()) / float(br.intensity.max())
                cs.check(err <= 1e-9 and torch.equal(bk.int_rays, br.int_rays),
                         f"G+estimate {state}: tallies {err:.2e} or ray counts differ")
        ms = {b: [] for b in names}
        for r in range(ROUNDS):
            for bname in order(names, r):
                use(builds[bname], gb)
                ms[bname].append(cs.general_block_ms(run, lambda: (s0.clone(), b0.clone()),
                                                     10)[1])
        out["blocks"].append({"state": state, "ms": ms,
                              "alive": float(s0.i[gb.ALIVE].float().mean())})
        for bname in names:
            cs.say("ab estimate-block", state=state, build=bname,
                   alive=f"{out['blocks'][-1]['alive']:.4f}",
                   device_ms=",".join(f"{t:.4f}" for t in ms[bname]),
                   device_ms_median=f"{statistics.median(ms[bname]):.4f}", card=json.dumps(card))
    bkey = batch_key(cs.SEED, 995)
    batch = lambda: tracer(bkey, src.sample(bkey, L, "cuda"), src)
    batch()
    torch.cuda.synchronize()
    recs = {b: [] for b in names}
    for r in range(2):
        for bname in order(names, r):
            use(builds[bname], gb)
            pb = cs.profile_batch(batch, "general_event_block_kernel")
            recs[bname].append({"block_ms": pb["block_ms"], "launches": pb["block_launches"],
                                "host_ms": pb["wall_ms"]})
    for bname in names:
        out["batches"].append({"build": bname, "photons": n, "batches": recs[bname]})
        cs.say("ab estimate-batch", build=bname, photons=n,
               kernel_ms=",".join(f"{r['block_ms']:.3f}" for r in recs[bname]),
               launches=recs[bname][0]["launches"],
               host_ms=",".join(f"{r['host_ms']:.3f}" for r in recs[bname]),
               card=json.dumps(card))
    use(builds["this"], gb)
    return out


# One fresh process per measurement: the slices' photons/s, with the
# package and the kernels of the tree the process runs in.
_RATES = r"""
import json, statistics, sys, time
import numpy as np, torch
from i3rc_tpu_torch import (Integrator, IntegratorConfig, KDistribution, PhotonSource,
                            batch_key, make_landsat_cloud, make_step_cloud, run_band)
from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component

L, N, SEED = 1 << 18, 1 << 24, 2024
CASES = set(filter(None, sys.argv[1].split(","))) if len(sys.argv) > 1 else set()
want = lambda case: not CASES or case in CASES
src = PhotonSource.directional(0.5, 0.0)
flux = IntegratorConfig(use_ray_tracing=False, max_events=500, compute_volume_absorption=False)

def median_rate(fn, n, warm, seed0):
    for w in range(warm):
        float(fn(batch_key(SEED, seed0 + 100 + w)).mean_flux_up)
    torch.cuda.synchronize()
    times, fups = [], []
    for b in range(3):
        t0 = time.perf_counter()
        fups.append(float(fn(batch_key(SEED, seed0 + b)).mean_flux_up))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"photons_per_s": n / statistics.median(times), "seconds": times,
            "fup": sum(fups) / 3}

def general_ms(fn, seed):
    # G's device time summed over one batch, by the profiler.
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        float(fn(batch_key(SEED, seed)).mean_flux_up)
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if "general_event_block_kernel" in e.key]
    return sum(e.self_device_time_total for e in found) / 1e3, sum(e.count for e in found)

out = {}
t0 = time.perf_counter()
if want("flux"):
    out["flux"] = median_rate(Integrator.create(make_step_cloud(1.0), IntegratorConfig(
        use_ray_tracing=False, max_events=500), device="cuda").batch_fn(src, N, n_lanes=L),
        N, 2, 0)
out["first_batch_after_s"] = time.perf_counter() - t0
if want("radiance"):
    rad = IntegratorConfig(use_ray_tracing=False, max_events=500,
                           compute_volume_absorption=False,
                           use_russian_roulette_for_intensity=True, zeta_min=0.3)
    out["radiance"] = median_rate(Integrator.create(
        make_step_cloud(1.0), rad, intensity_mus=[1.0, 0.5, 0.5],
        intensity_phis=[0.0, 0.0, 180.0], device="cuda").batch_fn(src, N, n_lanes=L), N, 1, 310)
if want("broadband"):
    dom = make_step_cloud(1.0)
    z = np.asarray(dom.z_edges)
    kd = KDistribution.create(z, np.broadcast_to([[4e-4, 4e-3]], (32, 2)).copy(), [0.7, 0.3],
                              wavelength_limits=(2.6, 2.8), spectral_fraction=1.0)
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                           compute_volume_absorption=False, majorant_block_size=16)
    integ = Integrator.create(domain_with_gas_component(dom, kd.absorption_profiles_on(z)[:, 0]),
                              cfg, device="cuda")
    cache = {}
    run = lambda seed: run_band(integ, dom, kd, src, N, 2, seed=seed,
                                derive=lambda r: {"fup": r.mean_flux_up}, integrator_cache=cache,
                                n_lanes=L)
    float(run(5).mean["derived"]["fup"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fup = float(run(6).mean["derived"]["fup"])
    dt = time.perf_counter() - t0
    out["broadband"] = {"photons_per_s": 2 * 2 * N / dt, "seconds": [dt], "fup": fup}
if want("landsat"):
    n_land = 1 << 23
    out["landsat"] = median_rate(Integrator.create(make_landsat_cloud(1.0), flux, device="cuda")
                                 .batch_fn(src, n_land, n_lanes=L), n_land, 1, 510)
# The general kernel's paths (chip_smoke.py phases 27 and 28) at the default
# width: the step cloud through IntegratorConfig() (ray tracing), Landsat
# with the fastpath off (Woodcock on 8-cell super-voxels, weight-1 class).
general = {"general_step_cloud": (Integrator.create(make_step_cloud(1.0), device="cuda"), N),
           "general_landsat": (Integrator.create(make_landsat_cloud(1.0), IntegratorConfig(
               use_ray_tracing=False, max_events=500, compute_volume_absorption=False,
               use_fastpath=False), device="cuda"), 1 << 21)}
for case, (integ, n) in general.items():
    if want(case):
        fn = integ.batch_fn(src, n)
        out[case] = median_rate(fn, n, 1, 700)
        ms = [general_ms(fn, 720 + k) for k in range(2)]
        out[case].update(g_ms=[m[0] for m in ms], g_launches=[m[1] for m in ms])
print("RATES " + json.dumps(out))
"""


def rates_ab(trees: dict, card: str, cases) -> list:
    """Each tree's rates from a fresh process, twice, alternating."""
    names = list(trees)
    out = []
    for r in range(2):
        for name in order(names, r):
            env = dict(os.environ, PYTHONPATH=str(trees[name]))
            done = subprocess.run([sys.executable, "-c", _RATES, ",".join(sorted(cases))],
                                  cwd=trees[name], env=env, capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"rates of tree {name} failed:\n{done.stderr[-4000:]}")
            line = next(ln for ln in done.stdout.splitlines() if ln.startswith("RATES "))
            rec = json.loads(line[len("RATES "):])
            out.append({"tree": name, "round": r, **rec})
            cs.say("ab rates", tree=name, round=r,
                   **{f"{k}_photons_per_s": f"{v['photons_per_s']:.4e}"
                      for k, v in rec.items() if isinstance(v, dict)},
                   **{f"{k}_fup": f"{v['fup']:.6f}" for k, v in rec.items()
                      if isinstance(v, dict)},
                   **{f"{k}_g_ms": ",".join(f"{m:.3f}" for m in v["g_ms"])
                      for k, v in rec.items() if isinstance(v, dict) and "g_ms" in v},
                   first_batch_after_s=f"{rec['first_batch_after_s']:.1f}",
                   card=json.dumps(card))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build", action="append", default=[], metavar="NAME=DIR",
                    help="another csrc directory to build and compare")
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help="another checkout's root, for the rates part")
    ap.add_argument("--parts", default="blocks,batches,broadband",
                    help="comma-separated subset of blocks, batches, broadband, general, "
                         "estimate, rates")
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
    parts = args.parts.split(",")
    result = {"card": card, "builds": {k: str(v) for k, v in dirs.items()}}
    cases = set(filter(None, args.cases.split(",")))
    if "rates" in parts:
        trees = {"this": ROOT, **{k: Path(v).resolve()
                                  for k, v in (t.split("=", 1) for t in args.tree)}}
        result["rates"] = rates_ab(trees, card, cases)
    if set(parts) & {"blocks", "batches", "broadband"}:
        builds = build_all(dirs)
        cs.say("ab builds", builds=",".join(builds), card=json.dumps(card))
    dev = torch.device("cuda", 0)
    if set(parts) & {"general", "estimate"}:
        gbuilds = build_all(dirs, "general_block")
        cs.say("ab general builds", builds=",".join(gbuilds), card=json.dumps(card))
    if "general" in parts:
        result["general"] = general_ab(gbuilds, dev, card, cases)
    if "estimate" in parts:
        result["estimate"] = estimate_ab(gbuilds, dev, card)
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
