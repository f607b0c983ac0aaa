#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the CUDA kernels from i3rc_tpu_torch/csrc (printing ptxas registers,
resident CTAs per SM and a SASS census), checks the event block's flux,
radiance-detector, gas-channel and column variants bit for bit against their
plain PyTorch twins on a full and a tail state, the whole block of the trace
loop (prologue + events, one launch) against its plain version on mid-flight
states of every variant and source kind, plans past the old reach of the
kernel (9 detectors, K = 4), and the column-read probe, then drives the
port's paths — the
I3RC step-cloud flux run, the step-cloud run with the three radiance
detectors of examples/monteCarloDriver_stepCloud.nml, each through
``Integrator.batch_fn`` and the namelist driver, the cloud + gas slab against
the discrete-ordinates oracle, the broadband k-distribution loop and
examples/broadbandDriver.nml through the broadband driver, the I3RC Landsat
scene (flux, absorbing with heating rates, and through the namelist driver),
the column-read probe loop, and reflecting surfaces (the glint row's
Cox-Munk ocean under thin cirrus, the step cloud over an albedo and over RPV
with detectors, the 13-detector ocean-glint scan, an albedo through the
namelist driver; each BRDF and the whole block with the surface stage
against their plain versions first), and the general kernel (its block
against its plain version on every scene its paths run, at their photons
and lanes, which together launch every instantiation: ray tracing, maximum
cross-section and Woodcock, one and two components, black, albedo and
gridded BRDF surfaces and the weight-1 class; then the step cloud through
the default configuration, Landsat with the fastpath off against the
Landsat fastpath, Beer-Lambert, the slab oracle and the closed forms of
tests/general_oracles.py (a slab over an albedo, two components in the
same cells, a gridded BRDF under a clear sky), the ray-tracing namelist
through the driver and a traced spectral band), and radiance on the
general kernel (its local-estimate stage against its plain version on every
estimator x mode x surface and the weight-1 class, then the step cloud's
detectors through the default configuration, exact and with Iwabuchi
roulette, bench.py's Woodcock radiance row, Landsat with 2 detectors by
ratio tracking, vacuum over Cox-Munk and the radiance namelist with ray
tracing) — and checks the physics.
Every phase prints one line; any failed check raises and the script exits
nonzero.  Run from the repository root:

    python3 chip_smoke.py

Needs a CUDA device (exits nonzero without one) and nvcc (CUDA_HOME or
PATH).  Imports nothing of jax or the JAX package.  The last line is a JSON
object naming the device.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
import time
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ANCHOR_FUP = 0.58054            # tests/test_external_validation.py:227
# Radiance of the I3RC detector set (mu, phi) = (1, 0), (0.5, 0), (0.5, 180)
# on the step cloud (BENCH_CASES.md case 2).  Two runs of the JAX package
# differ by 0.3% (PERF_NOTES.md:32), so the gate allows 1% + 5 sigma.
DET_MUS, DET_PHIS = [1.0, 0.5, 0.5], [0.0, 0.0, 180.0]
ANCHOR_I = [0.1285, 0.3285, 0.1800]
SEED = 2024
L_CHECK = 1 << 18               # lanes of the kernel-vs-twin check and the slice
SLICE_PHOTONS = 1 << 24
SLAB_PHOTONS = 1 << 22          # photons of the gas-slab oracle check
GAS_EXT = 3e-4                  # uniform gas of the kernel check (tests/test_fastpath.py:883)
# Three gas layers over the step cloud's 32 (tests/test_torch_gas.py): the gas
# chain has interior faces, so the merged step face and the chain window's
# clipping at gas faces run on both sides of the comparison.
LAYERED_GAS = np.concatenate([np.full(16, 1e-3), np.full(8, 5e-4), np.full(8, 1e-4)])
GAS_DET_MUS, GAS_DET_PHIS = [1.0, 0.5], [0.0, 0.0]
# Broadband Fup of the JAX package on the bench row's configuration
# (bench.py:274-337; BENCH_r05.json:5, baked mode; the fused mode gave 0.4039).
ANCHOR_BROADBAND_FUP = 0.4040
# Landsat case-4 flux (bench.py:168-190, BENCH_r05.json): a JAX-era Monte
# Carlo figure over 2^23 photons, rounded to 4 digits.
ANCHOR_LANDSAT_FUP = 0.5149
LANDSAT_PHOTONS = 1 << 23
PROBE_LANES = 1 << 17           # the TPU probe's L (benchmarks/column_read_probe.py:40)
PROBE_LOOP = 16                 # its events per run: two launches of K = 8
# Reflecting surfaces.  The glint row of bench.py:128-165: thin cirrus over a
# Cox-Munk ocean, 2^27 photons; its Fup is a JAX-era Monte Carlo figure over
# 2^27 photons printed to 4 digits (BENCH_r05.json).
GLINT_PHOTONS = 1 << 27
ANCHOR_GLINT_FUP = 0.0627
SURFACE_PHOTONS = 1 << 24
SURFACE_BRDFS = {"lambertian": [0.3], "rpv": [0.2, 0.8, -0.1], "cox_munk": [5.0, 1.34],
                 "ross_li": [0.2, 0.05, 0.02]}
RPV_DET_MUS, RPV_DET_PHIS = [0.5, -0.5], [40.0, 0.0]      # tests/test_fastpath.py:1343
SCAN_MU, SCAN_PHIS = 0.707, [15.0 * k for k in range(13)]  # examples/ocean_glint_radiance.py
# (mean, sigma of the mean) of the JAX package on the CPU, 2^21 photons each
# (16 batches of 2^17 at 2^16 lanes, XLA fastpath at K = 1, no roulette):
#   JAX_PLATFORMS=cpu python tests/surface_anchors.py --photons 131072 \
#       --batches 16 --lanes 65536
ANCHORS_ALBEDO = {"fup": (0.628901, 0.000235)}             # step cloud, A = 0.2
ANCHORS_RPV = {"fup": (0.670082, 0.000276), "i0": (0.29095, 0.000553),
               "i1": (0.182272, 0.000533)}                  # step cloud, RPV, 2 detectors
ANCHORS_SCAN = {"fup": (0.062082, 0.000335)} | {           # cirrus, Cox-Munk, 13 detectors
    f"i{k}": v for k, v in enumerate(
        [(0.119849, 0.000134), (0.076494, 0.000123), (0.028092, 0.000097),
         (0.014063, 0.000076), (0.01017, 0.000063), (0.008091, 0.000052),
         (0.006702, 0.000041), (0.005736, 0.000033), (0.005056, 0.000033),
         (0.004588, 0.000041), (0.004259, 0.000037), (0.004053, 0.000026),
         (0.00399, 0.000022)])}

# The least time the card could take for a kernel's work (the bound in each
# kernels entry): the larger of its bytes over the memory rate and its
# operations over the peak rate of their unit.  H100 SXM: 3.35 TB/s, 67e12
# FP32 operations/s (every integer and float instruction counted as one
# operation at that rate, which only lowers the bound), and 4.18e12
# special-function operations/s (16 per clock per SM x 132 SMs x 1.98 GHz:
# the reciprocal, square root, log and exp steps of logf, expf, sqrtf and
# IEEE division).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# Operations that the data needs, counted by hand from the kernel sources
# (fast_event_block.cuh, column_read_probe.cu): (ALU operations, special-
# function operations) per alive lane-event and per collision (an `orders`
# increment: the scattering draws, one Philox4x32-10 call of ~100 integer
# operations, the HG inverse and rotation, ~70 ALU and 6 SFU, the next free
# path's logf), plus per detector and collision the shadow ray and phase
# value.  A crossing reads no draw: it carries its tau.  A face distance or
# a collision distance in column media is one IEEE division (one SFU step).
OPS_PER_EVENT = {                  # the step: where-chains, faces, distances
    "flux": (120, 3),              # K1: x, z faces (1 x threshold)
    "detectors": (120, 3),         # K3: the same step
    "gas": (160, 3),               # K2: + the gas chain and its faces
    "gas_detectors": (160, 3),
    "column": (110, 5),            # P1 in the event block: row index, 3 faces, s_col
    "probe": (120, 0),             # P1 probe: one Philox call and ~20 ALU per event
}
OPS_PER_COLLISION = {"flux": (180, 7), "detectors": (180, 7), "gas": (190, 7),
                     "gas_detectors": (190, 7), "column": (180, 8), "probe": (0, 0)}
OPS_PER_DETECTOR = (70, 4)         # HG phase value (1/sqrt), shadow z segments, exp, log
STATE_ROWS = 13                    # x, y, z, ux, uy, uz, tau, tgas; alive, orders, pk, bad, evct
# The surface stage (fast_event_block.cuh resolve_surface): per bottom hit a
# Philox call (~100 integer operations), the flux column, the revive test
# and the cosine-weighted direction (two square roots, the azimuth
# polynomial); per BRDF evaluation (a hit's R, and one per upward detector
# and hit) the arithmetic of Cox-Munk, RPV or Ross-Li (divisions, square
# roots, exp, erfc, pow or acos steps); per upward detector and emitting hit
# the shadow ray from the surface (OPS_PER_DETECTOR).  Bytes: every lane's
# pk read; per hit x, y, ux, uy, uz and the weight read, z, the direction,
# orders, alive, pk and the weight written.
OPS_PER_HIT = (170, 4)
OPS_PER_BRDF = (150, 30)
BYTES_PER_HIT = 52


def state_bytes(spec, n_lanes: int, n_live: int) -> int:
    """Bytes that one block needs to move: the alive flag and tau of every
    lane read once; the rows a variant keeps (y and tgas only where it
    tracks them) of each live lane read once and written once; the
    detector accumulator read and written; the column table read once."""
    rows = STATE_ROWS - (not spec.track_y) - (not spec.gas)
    n = 8 * n_lanes + n_live * (2 * rows * 4 - 8)
    if spec.det is not None:
        n += 2 * 8 * spec.det.n_cols * spec.det.n
    if spec.col:
        n += spec.column.numel() * 4
    return n


def bound_ms(variant: str, lane_events: int, n_bytes: int, collisions: int = 0,
             detectors: int = 0, hits: int = 0, brdf_evals: int = 0, emits: int = 0,
             extra_bytes: int = 0) -> tuple[float, str]:
    """(least ms, what bounds it) for ``lane_events`` alive lane-events and
    ``collisions`` collisions of the variant that move ``n_bytes`` of
    device memory; over a reflecting surface (``bounce_work``) plus its
    ``hits`` bottom hits, ``brdf_evals`` BRDF evaluations, ``emits`` surface
    shadow rays and ``extra_bytes``."""
    (ea, es), (ca, cs) = OPS_PER_EVENT[variant], OPS_PER_COLLISION[variant]
    alu = lane_events * ea + collisions * (ca + detectors * OPS_PER_DETECTOR[0])
    sfu = lane_events * es + collisions * (cs + detectors * OPS_PER_DETECTOR[1])
    alu += hits * OPS_PER_HIT[0] + brdf_evals * OPS_PER_BRDF[0] + emits * OPS_PER_DETECTOR[0]
    sfu += hits * OPS_PER_HIT[1] + brdf_evals * OPS_PER_BRDF[1] + emits * OPS_PER_DETECTOR[1]
    n_bytes += extra_bytes
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(alu / FP32_OPS_PER_S, sfu / SFU_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bounce_work(spec, n_lanes: int, hits: int) -> dict:
    """bound_ms's surface keywords for ``hits`` bottom hits of a block or a
    batch over ``n_lanes`` lanes (every hit counted as emitting: exact for a
    BRDF, an upper estimate for an albedo, which emits from revived lanes)."""
    if not spec.reflecting:
        return {}
    up = sum(1 for d in spec.det.dirs if d[2] > 0) if spec.det is not None else 0
    return dict(hits=hits, brdf_evals=hits * (1 + up) if spec.surface.brdf else 0,
                emits=hits * up, extra_bytes=4 * n_lanes + BYTES_PER_HIT * hits)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def ctas_per_sm(registers: int, threads: int = 256) -> int:
    """Resident CTAs of ``threads`` threads per SM that the registers allow
    (65,536 per SM, allocated per warp in units of 256, at most 64 warps
    and 2048 threads), the limit that binds these kernels."""
    per_warp = -(-registers * 32 // 256) * 256
    return min(65536 // per_warp, 64) // (threads // 32)


# Event-block instantiations by template arguments (CHAIN, ABS, TY, DET, IW,
# GAS, COL, SLICES, DCAP), for the SASS census: the ones the main paths
# launch, then the detector tally of more than 751 bins and the Iwabuchi
# variant sized for 16 detectors, which only the checks run.
CENSUS = {"flux_chain2": "ILi2ELb0ELb0ELb0ELb0ELb0ELb0ELb0ELi8EE",
          "gas_chain3": "ILi3ELb0ELb0ELb0ELb0ELb1ELb0ELb0ELi8EE",
          "column_chain2": "ILi2ELb0ELb1ELb0ELb0ELb0ELb1ELb0ELi8EE",
          "detectors_iwabuchi": "ILi0ELb0ELb0ELb1ELb1ELb0ELb0ELb1ELi8EE",
          "gas_detectors": "ILi0ELb0ELb0ELb1ELb0ELb1ELb0ELb1ELi8EE",
          "detectors_iwabuchi_wide": "ILi0ELb0ELb0ELb1ELb1ELb0ELb0ELb0ELi8EE",
          "detectors_iwabuchi_16": "ILi0ELb0ELb0ELb1ELb1ELb0ELb0ELb1ELi16EE"}
# Opcode families counted per instantiation (static counts of the listing,
# not of a run): "all" is every instruction; IMAD.HI and IMAD.WIDE are the
# 32 x 32 -> 64 bit multiplies of Philox, which issue at half the FP32 rate.
SASS_OPS = ("all", "MUFU", "IMAD", "IMAD.HI", "IMAD.WIDE", "FFMA", "FMUL", "FADD", "LDG",
            "ATOMS", "CAS", "SHFL", "MATCH", "BAR", "ATOMG", "RED")


def sass_census(library: Path) -> dict:
    """Per CENSUS instantiation, the count of each SASS_OPS opcode family in
    ``cuobjdump -sass`` of the library; {"cuobjdump": "absent"} without it."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    if not tool.exists():
        return {"cuobjdump": "absent"}
    sass = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = next((k for k, v in CENSUS.items()
                         if f"fast_event_block_kernel{v}" in line), None)
            if name:
                counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name and (m := re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                                      line)):
            op = m[1]
            for fam in SASS_OPS:
                if (fam == "all" or op == fam or op.startswith(fam + ".")
                        or (fam == "CAS" and "CAS" in op)):
                    counts[name][fam] += 1
    return counts


def ptxas_by_variant(log: str) -> dict:
    """Per kernel variant (flux, detectors, gas, gas_detectors, column_flux,
    probe): instantiations, their most registers, their stack-frame and
    spill-store bytes and the resident CTAs per SM those registers allow,
    from ptxas -v."""
    out = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*fast_event_block_kernelILi\d+"
                      r"ELb\dELb\dELb(\d)ELb\dELb(\d)ELb(\d)E", line)
        probe = "Compiling entry function" in line and "column_read_probe_kernel" in line
        if m or probe:
            name = "probe" if probe else (
                ("gas_" if m[2] == "1" else "") + ("column_" if m[3] == "1" else "")
                + ("detectors" if m[1] == "1" else "flux"))
            n, r, b = out.get(name, (0, 0, 0))
            out[name] = (n + 1, r, b)
        elif "Compiling entry function" in line:
            name = None
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                                      line)):
            n, r, b = out[name]
            out[name] = (n, r, b + int(m[1]) + int(m[2]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            n, r, b = out[name]
            out[name] = (n, max(r, int(m[1])), b)
    return {k: f"{n}x/{r}regs/{b}B/{ctas_per_sm(r)}cta" for k, (n, r, b) in sorted(out.items())}


def ptxas_of_census(log: str) -> dict:
    """Per CENSUS instantiation: its registers, the resident CTAs per SM they
    allow, and its stack-frame and spill-store bytes, from ptxas -v."""
    out = {}
    lines = log.splitlines()
    for name, mangled in CENSUS.items():
        at = next((k for k, ln in enumerate(lines) if "Compiling entry function" in ln
                   and f"fast_event_block_kernel{mangled}" in ln), None)
        if at is None:
            continue
        text = "\n".join(lines[at:at + 4])
        regs = re.search(r"Used (\d+) registers", text)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", text)
        if regs and frame:
            out[name] = dict(registers=int(regs[1]), ctas_per_sm=ctas_per_sm(int(regs[1])),
                             stack_bytes=int(frame[1]), spill_store_bytes=int(frame[2]))
    return out


def _load_tests_module(name: str):
    """A helper module of tests/ that imports neither jax nor the JAX
    package, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def radiance_config():
    """The shipped namelist's algorithms: Iwabuchi roulette at zeta_min 0.3."""
    from i3rc_tpu_torch import IntegratorConfig

    return IntegratorConfig(use_ray_tracing=False, max_events=500,
                            compute_volume_absorption=False,
                            use_russian_roulette_for_intensity=True, zeta_min=0.3)


def variant(spec) -> str:
    """The bound's name for the event-block variant a spec runs."""
    if spec.col:
        return "column"
    if spec.gas:
        return "gas_detectors" if spec.det is not None else "gas"
    return "detectors" if spec.det is not None else "flux"


def block_states(ssa: float, dev, detectors: bool = False, gas=None, chain=None, K=None,
                 n_detectors: int = 0):
    """Two lane states of a scene at L = 2^18 for timing one K-event block:
    "full", a mid-flight state whose dead lanes took fresh photons as the
    trace loop's refill gives them (every lane alive at entry), and "tail",
    the same state advanced by the kernel without refill until at most 15%
    of lanes are alive.  With ``detectors`` the scene carries the step
    cloud's detectors.  With ``gas``, a gas extinction profile over the
    cloud's 32 layers, the scene carries that gas, at the planner's auto
    chain depth (3), or with the two detectors GAS_DET_* and no roulette.
    With ``chain`` (-1 for the auto depth) the scene is the Landsat cloud,
    run by the column variant at that chain depth and at ``K`` events per
    block (None: the planner's).  With ``n_detectors`` the step cloud
    carries that many detectors, an azimuth scan at mu = 0.5 with the
    roulette; without ``chain``, ``K`` is the separable plan's K.  Returns (spec, key, a maker of fresh
    accumulators (None without detectors), [(name, state, block index)])."""
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, batch_key,
                                make_landsat_cloud, make_step_cloud)
    from i3rc_tpu_torch.integrators.fastpath import event_spec, launch_state, renormalize
    from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component
    from i3rc_tpu_torch.kernels.event_block import ALIVE, ORDERS, PK, event_block

    flux_cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                                compute_volume_absorption=False)
    if gas is not None:
        dom = domain_with_gas_component(make_step_cloud(ssa), gas)
        det = dict(intensity_mus=GAS_DET_MUS, intensity_phis=GAS_DET_PHIS) if detectors else {}
        integ = Integrator.create(dom, flux_cfg, device=dev, **det)
    elif detectors:
        mus, phis = DET_MUS, DET_PHIS
        if n_detectors:
            mus = [0.5] * n_detectors
            phis = [360.0 * d / n_detectors for d in range(n_detectors)]
        integ = Integrator.create(make_step_cloud(ssa), radiance_config(),
                                  intensity_mus=mus, intensity_phis=phis, device=dev)
    elif chain is not None:
        integ = Integrator.create(make_landsat_cloud(ssa),
                                  IntegratorConfig(use_ray_tracing=False, max_events=500,
                                                   fastpath_chain=chain, fastpath_unroll=K),
                                  device=dev)
    else:
        integ = Integrator.create(make_step_cloud(ssa),
                                  IntegratorConfig(use_ray_tracing=False, max_events=500,
                                                   fastpath_unroll=K),
                                  device=dev)
    spec = event_spec(integ.geometry, integ._fast_plan, integ.config)
    check(spec.gas == (gas is not None) and (spec.det is not None) == detectors
          and spec.col == (chain is not None), f"spec {spec}")
    new_acc = lambda: (torch.zeros((spec.det.n_cols, spec.det.n), dtype=torch.float64,
                                   device=dev) if detectors else None)
    src = PhotonSource.directional(0.5, 0.0)
    launch = lambda k: launch_state(integ.geometry, src.sample(k, L_CHECK, dev), L_CHECK,
                                    gas_key=k if gas is not None else None)
    key = batch_key(SEED, 7)
    st = launch(key)
    scratch = new_acc()
    kb = 0

    def advance():
        nonlocal kb
        renormalize(st)
        event_block(spec, st, key, kb, scratch)
        kb += 1

    for _ in range(2):
        advance()
    full = st.clone()
    fresh = launch(batch_key(SEED, 8))
    dead = full.i[ALIVE] == 0
    full.f[:, dead] = fresh.f[:, dead]
    full.i[ALIVE, dead], full.i[ORDERS, dead] = 1, 0
    full.i[PK] = 0
    renormalize(full)
    kb_full = kb
    while float(st.i[ALIVE].float().mean()) > 0.15:
        check(kb < 400, "the tail state never came below 15% alive")
        advance()
    renormalize(st)
    return spec, key, new_acc, [("full", full, kb_full), ("tail", st, kb)]


def time_block_ms(run, s0, new_acc, n: int) -> float:
    """Mean CUDA-event time of ``run(state, acc)`` over n fresh copies of s0
    (``new_acc`` makes the second argument: an accumulator, or the buffers
    of a whole block)."""
    total = 0.0
    for _ in range(n):
        s, acc_s = s0.clone(), new_acc()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run(s, acc_s)
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / n


def device_block_ms(run, s0, new_acc, n: int) -> float:
    """Mean device time of the block kernel in ``run(state, acc)`` over n
    fresh copies of s0, from torch.profiler: the kernel's own time, without
    the host's work between the first event and the launch (building the
    parameter block), which the CUDA-event time of time_block_ms includes
    on an idle device.  Over a reflecting surface the surface stage's kernel
    counts in."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    # The profiler now and then drops device records of a trace: take the
    # mean over the launches it shows, from a trace that shows half of them.
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                run(s0.clone(), new_acc())
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if "fast_event_block" in e.key]
        launches = sum(e.count for e in found if "fast_event_block_kernel" in e.key)
        if 2 * launches >= n:
            break
    check(0 < launches <= n, f"the profiler shows {launches} block kernels for {n} launches")
    return sum(e.self_device_time_total for e in found) / launches / 1e3


def kernel_vs_twin(ssa: float, dev, detectors: bool = False, gas=None, chain=None, K=None,
                   n_detectors: int = 0):
    """One K-event block, kernel vs twin, on the two states of block_states
    (same arguments).  With ``detectors`` the (n_cols, D) accumulators are
    compared too (relative to their largest bin).  Returns (spec, one dict
    per state: alive share and live lanes at entry, lane-events and
    collisions of the block, bit_equal, errors, kernel ms by CUDA events and
    by the profiler (device_ms), twin ms, bound)."""
    from i3rc_tpu_torch.core.rng import philox_uniforms
    from i3rc_tpu_torch.kernels.event_block import (ALIVE, EVCT, ORDERS, event_block,
                                                     event_block_reference)

    spec, key, new_acc, states = block_states(ssa, dev, detectors, gas, chain, K, n_detectors)
    n_twin = 5 if spec.K <= 8 else 2
    out = []
    for name, s0, kb_s in states:
        def run_kernel(s, a):
            event_block(spec, s, key, kb_s, a)

        def run_twin(s, a):
            event_block_reference(spec, s, philox_uniforms(key, kb_s, spec.K, spec.n_draws,
                                                           L_CHECK, dev), a)

        got, ref = s0.clone(), s0.clone()
        acc_k, acc_t = new_acc(), new_acc()
        run_kernel(got, acc_k)
        run_twin(ref, acc_t)
        torch.cuda.synchronize()
        live = int(s0.i[ALIVE].sum())
        r = {"state": name, "alive": live / L_CHECK, "live": live,
             "lane_events": int((ref.i[EVCT] - s0.i[EVCT]).sum()),
             "collisions": int((ref.i[ORDERS] - s0.i[ORDERS]).sum()),
             "bit_equal": torch.equal(got.f, ref.f) and torch.equal(got.i, ref.i),
             "max_abs_err": float((got.f - ref.f).abs().max())}
        if detectors:
            check(name == "tail" or float(acc_t.sum()) > 0.0,
                  "the detector block contributed nothing")
            scale = float(acc_t.abs().max())
            r["acc_abs_err"] = float((acc_k - acc_t).abs().max())
            r["acc_rel_err"] = r["acc_abs_err"] / scale if scale > 0 else r["acc_abs_err"]

        time_block_ms(run_kernel, s0, new_acc, 2)
        r["kernel_ms"] = time_block_ms(run_kernel, s0, new_acc, 20)
        r["device_ms"] = device_block_ms(run_kernel, s0, new_acc, 20)
        r["twin_ms"] = time_block_ms(run_twin, s0, new_acc, n_twin)
        r["bound"] = bound_ms(variant(spec), r["lane_events"], state_bytes(spec, L_CHECK, live),
                              r["collisions"], spec.det.n if detectors else 0)
        out.append(r)
    return spec, out


def check_block(what: str, r: dict) -> None:
    """Every state row bit for bit; the detector accumulator within 1e-9
    relative (only the order of its sum may differ)."""
    check(r["bit_equal"], f"{what} {r['state']}: kernel and twin differ {r}")
    if "acc_rel_err" in r:
        check(r["acc_rel_err"] <= 1e-9, f"{what} {r['state']}: accumulator {r}")


def block_fields(spec, r: dict, card: str) -> dict:
    """The say() fields of one timed block."""
    out = dict(state=r["state"], alive=f"{r['alive']:.4f}", live=r["live"], lanes=L_CHECK,
               K=spec.K, chain=spec.chain, bit_equal=r["bit_equal"],
               max_abs_err=f"{r['max_abs_err']:.3e}")
    if "acc_rel_err" in r:
        out["acc_rel_err"] = f"{r['acc_rel_err']:.3e}"
    out.update(lane_events=r["lane_events"], collisions=r["collisions"],
               kernel_ms=f"{r['kernel_ms']:.4f}", kernel_device_ms=f"{r['device_ms']:.4f}",
               twin_ms=f"{r['twin_ms']:.4f}",
               bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1], card=json.dumps(card))
    return out


def batch_fields(bk: dict, card: str) -> dict:
    """The say() fields of batch_kernel_time's record."""
    return dict(launches=bk["launches"], kernel_ms=f"{bk['kernel_ms']:.3f}",
                kernel_ms_from=bk["kernel_ms_from"], events_ms=f"{bk['events_ms']:.3f}",
                live_lanes=bk["live"],
                lane_events=bk["lane_events"], collisions=bk["collisions"],
                bound_ms=f"{bk['bound'][0]:.3f}", bound_by=bk["bound"][1],
                blocks=bk["blocks"], budget_spent_at_block=bk["spent_at"],
                drain_blocks=bk["blocks"] - bk["spent_at"], card=json.dumps(card))


# GPU clock cycles of the spin queued before each timed launch (~1 ms).
SPIN_CYCLES = 2_000_000
# What the prologue moves per lane besides the event loop's rows: alive, pk
# and the direction read, the direction written.
PROLOGUE_BYTES_PER_LANE = 8 * 4


def batch_kernel_time(run_batch, profile: bool = True) -> dict:
    """One batch: the block kernel's device time (prologue and events, one
    launch per block, and over a reflecting surface the surface stage's
    kernel after it) summed over the batch, from torch.profiler
    key_averages() (``profile``; its post-processing grows too slow for a
    batch of a thousand blocks and more), and from CUDA events around each
    launch.  Each launch is queued behind a ~1 ms spin kernel, so that the
    host's work between the first event and the launch falls inside the
    spin, not between the events.  Also the launches, the blocks of the
    trace and the block at whose entry the budget was spent (the rest is the
    drain), the lanes alive after each refill, and, from the batch's
    RawTallies.n_lane_events, lane-events; collisions (the growth of
    ``orders``, with the refills' resets added back: exact but for the one
    block in which the budget runs out); and the batch's bound.
    ``kernel_ms`` is the profiler's sum where it shows device time, else the
    events' sum."""
    import i3rc_tpu_torch.integrators.fastpath as fp
    from i3rc_tpu_torch.kernels.event_block import ALIVE, DONE, ORDERS, SPENT

    orig = fp.fused_block
    rec = []

    def bracketed(spec, pro, st, buf, key, source, kb):
        dead = st.i[ALIVE] == 0
        n_dead = dead.sum(dtype=torch.int64)
        dead_orders = (st.i[ORDERS] * dead).sum(dtype=torch.int64)
        orders = st.i[ORDERS].sum(dtype=torch.int64)
        launched = buf.ctl[kb & 1].clone()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        orig(spec, pro, st, buf, key, source, kb)
        b.record()
        taken = buf.ctl[(kb + 1) & 1] - launched
        reset = dead_orders * taken // n_dead.clamp(min=1)
        rec.append((spec, a, b, st.n_lanes - n_dead + taken,
                    st.i[ORDERS].sum(dtype=torch.int64) - orders + reset, st.n_lanes, buf))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fp.fused_block = bracketed
    try:
        if profile:
            with torch.profiler.profile(activities=acts) as prof:
                raw = run_batch()
                torch.cuda.synchronize()
        else:
            raw = run_batch()
            torch.cuda.synchronize()
    finally:
        fp.fused_block = orig
    prof_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if "fast_event_block" in e.key) if profile else 0
    spec = rec[0][0]
    lives = torch.stack([r[3] for r in rec]).tolist()
    collisions = int(torch.stack([r[4] for r in rec]).sum())
    events = int(raw.n_lane_events)
    n_bytes = sum(state_bytes(spec, r[5], n) + PROLOGUE_BYTES_PER_LANE * r[5]
                  for r, n in zip(rec, lives))
    events_ms = sum(r[1].elapsed_time(r[2]) for r in rec)
    kernel_ms, source = (prof_us / 1e3, "profiler") if prof_us else (events_ms, "cuda-events")
    ctl = rec[-1][6].ctl.tolist()
    # Over a reflecting surface: the bottom hits, as the Fdn tally counts them
    # (exact over an albedo; weighted, so an upper estimate, under a BRDF).
    # Their revivals grow `orders` too: the collision count holds them.
    hits = int(raw.flux_down.sum()) if spec.reflecting else 0
    return {"spec": spec, "launches": len(rec), "kernel_ms": kernel_ms,
            "kernel_ms_from": source,
            "events_ms": events_ms, "live": sum(lives), "collisions": collisions,
            "lane_events": events, "blocks": raw.n_iterations // spec.K,
            "spent_at": ctl[SPENT] if ctl[SPENT] >= 0 else ctl[DONE], "hits": hits,
            "launched": max(ctl[0], ctl[1]),
            "bound": bound_ms(variant(spec), events, n_bytes, collisions,
                              spec.det.n if spec.det is not None else 0,
                              **bounce_work(spec, rec[0][5] * len(rec), hits))}


def profile_batch(run_batch, block_name: str = "fast_event_block_kernel") -> dict:
    """One batch under torch.profiler with nothing else in its way: the host
    time to a synchronize, the device's busy time (every kernel's own time)
    and idle share over the batch; and over the trace loop alone, from the
    first block kernel's start to the last one's end on the device's
    timeline (the batch's set-up, the launch sample in torch, lies before
    it): the device kernels in that span, per block launch, and the
    device's idle share there."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        raw = run_batch()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end
               > e.time_range.start and "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    blocks = [e for e in kernels if block_name in e.name]
    surface = [e for e in kernels if "fast_event_block_surface_kernel" in e.name]
    check(len(blocks) > 0, "the profiler shows no block kernel on the device")
    us = lambda es: sum(e.time_range.end - e.time_range.start for e in es)
    start, end = min(e.time_range.start for e in blocks), max(e.time_range.end for e in blocks)
    loop = [e for e in kernels if start <= e.time_range.start <= end]
    return {"raw": raw, "wall_ms": wall_ms, "busy_ms": us(kernels) / 1e3,
            "idle_share": 1.0 - us(kernels) / 1e3 / wall_ms, "kernels": len(kernels),
            "block_ms": us(blocks) / 1e3, "block_launches": len(blocks),
            "surface_ms": us(surface) / 1e3, "surface_launches": len(surface),
            "loop_ms": (end - start) / 1e3, "loop_kernels": len(loop),
            "loop_idle_share": 1.0 - us(loop) / (end - start)}


def profile_fields(pb: dict, K: int, card: str) -> dict:
    """The say() fields of profile_batch's record."""
    n = pb["block_launches"]
    return dict(blocks=pb["raw"].n_iterations // K, block_launches=n,
                device_kernels=pb["kernels"], setup_kernels=pb["kernels"] - pb["loop_kernels"],
                loop_kernels_per_block=f"{pb['loop_kernels'] / n:.3f}",
                host_ms=f"{pb['wall_ms']:.3f}", host_ms_per_block=f"{pb['wall_ms'] / n:.4f}",
                device_busy_ms=f"{pb['busy_ms']:.3f}", block_kernel_ms=f"{pb['block_ms']:.3f}",
                surface_kernel_ms=f"{pb['surface_ms']:.3f}",
                surface_launches=pb["surface_launches"],
                device_idle_share=f"{pb['idle_share']:.4f}", loop_ms=f"{pb['loop_ms']:.3f}",
                loop_device_idle_share=f"{pb['loop_idle_share']:.4f}", card=json.dumps(card))


# ---------------------------------------------------------------------------
# The whole block (prologue + events) against its plain version

SOURCE_KINDS = ("directional", "random_azimuth", "flux_weighted", "spotlight",
                "internal_flux", "internal_intensity")


def photon_source(kind: str):
    from i3rc_tpu_torch import PhotonSource

    return {"directional": lambda: PhotonSource.directional(0.5, 0.0),
            "random_azimuth": lambda: PhotonSource.random_azimuth(0.6),
            "flux_weighted": PhotonSource.flux_weighted,
            "spotlight": lambda: PhotonSource.spotlight(0.5, 30.0, 0.3, 0.6),
            "internal_flux": lambda: PhotonSource.internal_flux(0.4, 0.5, 0.7, False,
                                                                delta_x=0.2, delta_y=0.1),
            "internal_intensity": lambda: PhotonSource.internal_intensity(
                0.4, 0.5, 0.7, -0.8, 45.0)}[kind]()


def fused_vs_reference(name: str, integ, source, dev, card: str, timed: bool = False,
                       phase: str = "4b fused-block-vs-plain"):
    """One whole block of the trace loop, kernel against plain version, at
    L = 2^18 on a state two blocks into a trace (pending exits of every kind
    the plan has, dead lanes) with a budget that covers half of the dead
    lanes, so that the FIFO rank decides which of them take a photon.  All
    13 state rows, the flux and volume tallies, the control state (launched,
    loop end, budget) and the next block's dead counts must be equal bit
    for bit, the detector accumulator within 1e-9 relative.  Over a
    reflecting surface the block ends with the bounce of its bottom hits
    (counted as ``hits``, ``revived``): the lane weight of a BRDF plan is
    compared too, and the surface radiance accumulator as the detector one.
    A BRDF plan may differ where the kernel's libdevice and torch's CUDA
    functions round a reflectance apart: then at most 1e-4 L lanes may
    differ and every tally must hold within 1e-6 relative (the differing
    lanes are printed).  Returns a dict with the check's counts and, when
    ``timed``, the fused kernel's ms, the kernel's ms for the K events alone
    on the same lanes, the plain version's ms (CUDA events, fresh copies)
    and the bound."""
    from i3rc_tpu_torch import batch_key
    from i3rc_tpu_torch.integrators.fastpath import event_spec, launch_state, prologue_spec
    from i3rc_tpu_torch.kernels import event_block as eb
    from i3rc_tpu_torch.kernels.event_block import (ALIVE, EVCT, ORDERS, PK, block_buffers,
                                                     event_block, flush, fused_block,
                                                     fused_block_reference, refill,
                                                     renormalize)

    geom, cfg = integ.geometry, integ.config
    spec = event_spec(geom, integ._fast_plan, cfg)
    key = batch_key(SEED, 40)
    st = launch_state(geom, source.sample(key, L_CHECK, dev), L_CHECK,
                      gas_key=key if spec.gas else None, weighted=spec.weighted)
    pro = prologue_spec(geom, spec, cfg, 100 * L_CHECK)
    buf = block_buffers(spec, pro, st, L_CHECK)
    kb = 2
    for k in range(kb):
        fused_block(spec, pro, st, buf, key, source, k)
    launched = int(buf.ctl[kb & 1])
    dead0 = st.i[ALIVE] == 0
    n_dead = int(dead0.sum())
    pending = {k: int((st.i[PK] == k).sum()) for k in (1, 2, 3)}
    if spec.reflecting:
        # The surface stage tallies every exit of its block: none pends.
        check(n_dead > 1000 and not any(pending.values()),
              f"{name}: state {n_dead} dead, pending {pending}")
    else:
        check(n_dead > 1000 and pending[1] + pending[2] > 0
              and (pending[3] > 0) == pro.deaths,
              f"{name}: state {n_dead} dead, pending {pending}")
    pro = replace(pro, n_photons=launched + n_dead // 2)
    buf = block_buffers(spec, pro, st, launched, kb)

    run_kernel = lambda s, b: fused_block(spec, pro, s, b, key, source, kb)
    run_plain = lambda s, b: fused_block_reference(spec, pro, s, b, key, source, kb)
    got_st, got, ref_st, ref = st.clone(), buf.clone(), st.clone(), buf.clone()
    run_kernel(got_st, got)
    bounce = {"hits": 0, "revived": 0}
    exits = dict(pending)          # the exits the block tallies
    resolve = eb.resolve_surface

    def counted(spec_, pro_, s, b, u, u_iw=None):
        alive = int(s.i[ALIVE].sum())
        exits.update({k: int((s.i[PK] == k).sum()) for k in (1, 2, 3)})
        bounce["hits"] += exits[2]
        resolve(spec_, pro_, s, b, u, u_iw)
        bounce["revived"] += int(s.i[ALIVE].sum()) - alive

    eb.resolve_surface = counted
    try:
        run_plain(ref_st, ref)
    finally:
        eb.resolve_surface = resolve
    torch.cuda.synchronize()
    slot = (kb + 1) & 1
    taken = int(ref.ctl[slot]) - launched
    rows = lambda a: torch.cat([a.f, a.i.float()] + ([a.w[None]] if a.w is not None else []))
    lane_diff = (rows(got_st) != rows(ref_st)).any(dim=0)
    n_diff = int(lane_diff.sum())
    err = float((got_st.f - ref_st.f).abs().max())
    tallies = {"columns": (got.columns, ref.columns), "vol": (got.vol, ref.vol)}
    same = {"state": n_diff == 0, "ctl": torch.equal(got.ctl, ref.ctl),
            "dead": torch.equal(got.dead[slot], ref.dead[slot])}
    same.update({k: torch.equal(a, b) for k, (a, b) in tallies.items()})
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))
    acc_rel = {k: rel(a, b) for k, a, b in (("acc", got.acc, ref.acc), ("srf", got.srf, ref.srf))
               if b is not None}
    for k, v in acc_rel.items():
        check(float(getattr(ref, k).sum()) > 0 and v <= 1e-9 + (1e-6 if spec.weighted else 0.0),
              f"{name}: {k} accumulator {v}")
    if spec.weighted and not all(same.values()):
        # The stated rule for BRDF plans: few lanes, tallies within 1e-6.
        dead_off = int((got.dead[slot] - ref.dead[slot]).abs().sum())
        check(n_diff <= 1e-4 * L_CHECK and same["ctl"] and dead_off <= n_diff
              and all(rel(a, b) <= 1e-6 for a, b in tallies.values() if b.numel()),
              f"{name}: fused kernel and plain version differ beyond the BRDF rule: {same}, "
              f"{n_diff} lanes, max abs error {err}")
    else:
        check(all(same.values()), f"{name}: fused kernel and plain version differ: {same}, "
                                  f"{n_diff} lanes, max abs error {err}")
    check(taken == n_dead // 2, f"{name}: taken {taken}")
    check(exits[1] + exits[2] > 0 and (exits[3] > 0) == pro.deaths, f"{name}: exits {exits}")
    if not spec.weighted:
        # Unit counts: the exits pending at entry, or over a reflecting
        # surface the block's own.
        flushed = [exits[k] for k in range(1, pro.n_kinds + 1)]
        check(ref.columns.sum(dim=0).tolist() == flushed, f"{name}: flux tally {flushed}")
        check(not pro.vol_tally or float(ref.vol.sum()) == exits[3], f"{name}: volume tally")
    check(not spec.reflecting or (bounce["hits"] > 0 and bounce["revived"] > 0),
          f"{name}: bounce {bounce}")
    ran = ref_st.i[EVCT] > st.i[EVCT]
    r = {"name": name, "max_abs_err": err, "lane_events": int((ref_st.i[EVCT] - st.i[EVCT]).sum()),
         "collisions": int((ref_st.i[ORDERS] - torch.where(dead0 & ran, 0, st.i[ORDERS])).sum())
         - bounce["revived"],
         "live": int((~dead0).sum()) + taken, "differing_lanes": n_diff, **bounce}
    fields = dict(case=name, source=source.kind, lanes=L_CHECK, K=spec.K, chain=spec.chain,
                  dead_at_entry=n_dead, taken=taken,
                  flushed=",".join(str(exits[k]) for k in (1, 2, 3)),
                  volume_tally=pro.vol_tally, bit_equal=all(same.values()),
                  differing_lanes=n_diff, max_abs_err=f"{err:.3e}")
    if spec.reflecting:
        fields.update(surface=spec.surface.kind, hits=bounce["hits"],
                      hit_share=f"{bounce['hits'] / L_CHECK:.4f}", revived=bounce["revived"])
    fields.update({f"{k}_rel_err": f"{v:.3e}" for k, v in acc_rel.items()})
    if timed:
        ms = lambda run, n, s0=st: time_block_ms(run, s0, buf.clone, n)
        ms(run_kernel, 2)
        r["kernel_ms"], r["twin_ms"] = ms(run_kernel, 20), ms(run_plain, 3)
        # The K events alone on the same lanes (the state after the plain
        # prologue, prologue off): the difference is the prologue's cost,
        # and over a reflecting surface the bounce's.
        after, spare = st.clone(), buf.clone()
        renormalize(after)
        flush(pro, spare.columns, spare.vol, after)
        refill(spec, pro, after, spare.ctl[kb & 1].clone(), key, source, kb)
        events_only = lambda s, b: event_block(spec, s, key, kb, b.acc)
        ms(events_only, 2, after)
        r["events_ms"] = ms(events_only, 20, after)
        r["device_ms"] = device_block_ms(run_kernel, st, buf.clone, 20)
        r["events_device_ms"] = device_block_ms(events_only, after, buf.clone, 20)
        n_bytes = state_bytes(spec, L_CHECK, r["live"]) + PROLOGUE_BYTES_PER_LANE * L_CHECK
        r["bound"] = bound_ms(variant(spec), r["lane_events"], n_bytes, r["collisions"],
                              spec.det.n if spec.det is not None else 0,
                              **bounce_work(spec, L_CHECK, r["hits"]))
        fields.update(lane_events=r["lane_events"], collisions=r["collisions"],
                      fused_kernel_ms=f"{r['kernel_ms']:.4f}",
                      events_only_ms=f"{r['events_ms']:.4f}",
                      fused_device_ms=f"{r['device_ms']:.4f}",
                      events_only_device_ms=f"{r['events_device_ms']:.4f}",
                      plain_ms=f"{r['twin_ms']:.4f}",
                      bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1])
    say(phase, **fields, card=json.dumps(card))
    return r


def fused_block_checks(dev, card: str) -> dict:
    """Phase 4b: the fused block of every variant, with and without the
    volume tally, and of every source kind; returns the timed records by
    variant name."""
    from i3rc_tpu_torch import Integrator, IntegratorConfig, make_landsat_cloud, make_step_cloud
    from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component

    flux = IntegratorConfig(use_ray_tracing=False, max_events=500,
                            compute_volume_absorption=False)
    vol = replace(flux, compute_volume_absorption=True)
    make = lambda dom, cfg, **kw: Integrator.create(dom, cfg, device=dev, **kw)
    directional = photon_source("directional")
    timed = {}
    timed["flux"] = fused_vs_reference("flux", make(make_step_cloud(1.0), flux), directional,
                                       dev, card, timed=True)
    for kind in SOURCE_KINDS[1:]:
        fused_vs_reference(f"flux-absorbing-volume-{kind}", make(make_step_cloud(0.9), vol),
                           photon_source(kind), dev, card)
    uniform = domain_with_gas_component(make_step_cloud(1.0), np.full(32, GAS_EXT))
    timed["gas"] = fused_vs_reference("gas", make(uniform, flux), directional, dev, card,
                                      timed=True)
    layered = domain_with_gas_component(make_step_cloud(0.99), LAYERED_GAS)
    fused_vs_reference("gas-layered-volume", make(layered, vol), photon_source("flux_weighted"),
                       dev, card)
    timed["detectors"] = fused_vs_reference(
        "detectors", make(make_step_cloud(1.0), radiance_config(), intensity_mus=DET_MUS,
                          intensity_phis=DET_PHIS), directional, dev, card, timed=True)
    timed["gas_detectors"] = fused_vs_reference(
        "gas-detectors", make(uniform, flux, intensity_mus=GAS_DET_MUS,
                              intensity_phis=GAS_DET_PHIS), directional, dev, card, timed=True)
    timed["column"] = fused_vs_reference("column", make(make_landsat_cloud(1.0), flux),
                                         directional, dev, card, timed=True)
    fused_vs_reference("column-absorbing-volume", make(make_landsat_cloud(0.99), vol),
                       photon_source("random_azimuth"), dev, card)
    return timed


def glint_scene():
    """Thin cirrus (tau 0.2, HG g = 0.75 from 48 Legendre terms) in a 1 km
    cube: the glint row's scene (bench.py:128-165)."""
    from i3rc_tpu_torch import (Domain, PhaseFunction, PhaseFunctionTable,
                                henyey_greenstein_coefficients)

    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(0.75, 48))], key=[1.0])
    dom = Domain.create([0.0, 1000.0], [0.0, 1000.0], [0.0, 1000.0])
    ext = np.full((1, 1, 1), 0.2 / 1000.0)
    return dom.add_component("cirrus", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32),
                             table)


def brdf_kernel_checks(dev, card: str) -> dict:
    """Phase 4d: each BRDF through the kernel's own ``brdf_reflectance``
    against core/surface.py's torch function on the card, at 2^16 seeded
    angles (arrivals mu < 0, outgoing mu > 0): the values that differ and
    the largest difference in float32 ulp.  Returns {name: (differing,
    max ulp)}."""
    from i3rc_tpu_torch.core.surface import BRDF_REGISTRY
    from i3rc_tpu_torch.kernels.event_block import BRDF_KINDS, SurfaceLaw, kernel_brdf_reflectance

    g = torch.Generator().manual_seed(SEED)
    n = 1 << 16
    rnd = lambda lo, hi: (lo + (hi - lo) * torch.rand(n, generator=g)).to(dev)
    angles = (-rnd(0.001, 1.0), rnd(0.001, 1.0), rnd(-np.pi, np.pi), rnd(0.0, 2 * np.pi))
    out = {}
    for name, params in SURFACE_BRDFS.items():
        law = SurfaceLaw(kind=BRDF_KINDS[name], params=tuple(float(np.float32(v)) for v in params))
        got = kernel_brdf_reflectance(law, *angles)
        want = BRDF_REGISTRY[name](law.params, *angles)
        torch.cuda.synchronize()
        differ = ~((got == want) | (torch.isnan(got) & torch.isnan(want)))
        ulp = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) - want.abs()
        max_ulp = float(((got.double() - want.double()).abs() / ulp.double())[differ].max()) \
            if bool(differ.any()) else 0.0
        check(bool(torch.isfinite(got).all()), f"{name}: the kernel's BRDF is not finite")
        out[name] = (int(differ.sum()), max_ulp)
        say("4d brdf-kernel-vs-torch", brdf=name, values=n, differing=out[name][0],
            max_ulp=f"{max_ulp:.1f}", card=json.dumps(card))
    return out


def surfaced_tail_ms(integ, source, dev) -> tuple[float, float]:
    """(device ms, alive share) of one whole surfaced block at L = 2^18 on a
    tail state: a trace of 2 L photons run until the budget is spent and at
    most 15% of lanes are alive, then the next block on fresh copies."""
    from i3rc_tpu_torch import batch_key
    from i3rc_tpu_torch.integrators.fastpath import event_spec, launch_state, prologue_spec
    from i3rc_tpu_torch.kernels.event_block import ALIVE, block_buffers, fused_block

    spec = event_spec(integ.geometry, integ._fast_plan, integ.config)
    key = batch_key(SEED, 41)
    pro = prologue_spec(integ.geometry, spec, integ.config, 2 * L_CHECK)
    st = launch_state(integ.geometry, source.sample(key, L_CHECK, dev), L_CHECK,
                      weighted=spec.weighted)
    buf = block_buffers(spec, pro, st, L_CHECK)
    kb = 0
    while int(buf.ctl[kb & 1]) < pro.n_photons or float(st.i[ALIVE].float().mean()) > 0.15:
        check(kb < 2000, "the surfaced tail state never came below 15% alive")
        fused_block(spec, pro, st, buf, key, source, kb)
        kb += 1
    alive = float(st.i[ALIVE].float().mean())
    check(alive > 0.0, "the surfaced tail state has no live lane")
    ms = device_block_ms(lambda s, b: fused_block(spec, pro, s, b, key, source, kb), st,
                         buf.clone, 20)
    return ms, alive


def surface_block_checks(dev, card: str) -> tuple[dict, dict]:
    """Phase 4d: the whole block over a reflecting surface, kernel against
    plain version (fused_vs_reference): a Lambertian albedo on the flux
    (thin cirrus, and the absorbing step cloud with the volume tally),
    detector, gas and column variants, and each BRDF on the flux and
    detector variants over the cirrus, whose lanes mostly reach the surface
    (at least 10% hit it in the block).  Returns the timed records (the
    glint row's Cox-Munk flux block and the RPV radiance block of phase 23,
    each with its tail) and the largest state error by variant."""
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, SurfaceDescription,
                                make_landsat_cloud, make_step_cloud)
    from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component

    flux = IntegratorConfig(use_ray_tracing=False, max_events=500,
                            compute_volume_absorption=False)
    vol = replace(flux, compute_volume_absorption=True)
    make = lambda dom, cfg, **kw: Integrator.create(dom, cfg, device=dev, **kw)
    directional, sun = photon_source("directional"), PhotonSource.directional(0.707, 0.0)
    phase = "4d surface-block-vs-plain"
    err = {"flux": 0.0, "detectors": 0.0}
    timed = {}

    def run(name, integ, src, key=None, **kw):
        r = fused_vs_reference(name, integ, src, dev, card, phase=phase, **kw)
        err["detectors" if integ.intensity is not None else "flux"] = max(
            err["detectors" if integ.intensity is not None else "flux"], r["max_abs_err"])
        if "glint" in name:
            check(r["hits"] >= 0.10 * L_CHECK, f"{name}: {r['hits']} bottom hits in the block")
        if key:
            r["tail_ms"], r["tail_alive"] = surfaced_tail_ms(integ, src, dev)
            say(phase, case=name, state="tail", alive=f"{r['tail_alive']:.4f}",
                fused_device_ms=f"{r['tail_ms']:.4f}", card=json.dumps(card))
            timed[key] = r
        return r

    run("albedo-flux-glint", make(glint_scene(), flux, surface_albedo=0.3), sun)
    run("albedo-flux-absorbing-volume", make(make_step_cloud(0.99), vol, surface_albedo=0.2),
        directional)
    run("albedo-detectors", make(make_step_cloud(1.0), radiance_config(), surface_albedo=0.3,
                                 intensity_mus=DET_MUS, intensity_phis=DET_PHIS), directional)
    gas = domain_with_gas_component(make_step_cloud(1.0), np.full(32, GAS_EXT))
    run("albedo-gas", make(gas, flux, surface_albedo=0.2), directional)
    run("albedo-column", make(make_landsat_cloud(1.0), flux, surface_albedo=0.2), directional)
    for name, params in SURFACE_BRDFS.items():
        surf = SurfaceDescription.uniform(params, brdf_name=name)
        run(f"{name}-flux-glint", make(glint_scene(), flux, surface=surf), sun,
            key="flux" if name == "cox_munk" else None, timed=name == "cox_munk")
        run(f"{name}-detectors-glint", make(glint_scene(), radiance_config(), surface=surf,
                                            intensity_mus=[SCAN_MU, 0.5, -0.5],
                                            intensity_phis=[0.0, 90.0, 0.0]), sun)
    rpv = SurfaceDescription.uniform(SURFACE_BRDFS["rpv"], brdf_name="rpv")
    run("rpv-detectors-step", make(make_step_cloud(1.0), flux, surface=rpv,
                                   intensity_mus=RPV_DET_MUS, intensity_phis=RPV_DET_PHIS),
        directional, key="detectors", timed=True)
    return timed, err


class LaunchWatch:
    """Wraps fastpath.fused_block while in use, keeping the buffers of each
    trace, for the photons each trace launched (``launched``)."""

    def __enter__(self):
        import i3rc_tpu_torch.integrators.fastpath as fp

        self.fp, self.orig, self.bufs = fp, fp.fused_block, []

        def watched(spec, pro, st, buf, *args):
            self.orig(spec, pro, st, buf, *args)
            if not self.bufs or self.bufs[-1] is not buf:
                self.bufs.append(buf)

        fp.fused_block = watched
        return self

    def __exit__(self, *exc):
        self.fp.fused_block = self.orig

    def launched(self) -> list[int]:
        return [max(b.ctl.tolist()[:2]) for b in self.bufs]


def surface_path(tag: str, integ, src, n: int, card: str, seed0: int, counter: str,
                 profile_kernels: bool = True):
    """One reflecting-surface path through ``Integrator.batch_fn`` at 2^18
    lanes: a warm-up, then three timed batches (host seconds to a
    synchronize, median photons/s), each with n_bad = 0 and every photon of
    its budget launched; then one batch under the profiler alone and one
    with each launch timed (the kernel's device time beside its bound).
    Only the ``counter`` kernel may launch.  ``profile_kernels`` False times
    the launches by CUDA events alone (batch_kernel_time).  Returns (the
    three batches' Results, launches, the batch-kernel record, the rate's
    say() fields)."""
    from i3rc_tpu_torch import batch_key
    from i3rc_tpu_torch.kernels import event_block as eb

    fn = integ.batch_fn(src, n, n_lanes=L_CHECK)
    fn(batch_key(SEED, seed0))
    torch.cuda.synchronize()
    eb.reset_launch_counters()
    results, times = [], []
    with LaunchWatch() as watch:
        for b in range(3):
            t0 = time.perf_counter()
            res = fn(batch_key(SEED, seed0 + 1 + b))
            n_bad = int(res.n_bad)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(n_bad == 0, f"{tag}: n_bad={n_bad}")
            results.append(res)
    check(watch.launched() == [n] * 3, f"{tag}: launched {watch.launched()} of {n}")
    counts = {name: getattr(eb.event_block, name) for name in eb.LAUNCH_COUNTERS.values()}
    launches = counts.pop(counter)
    check(launches > 0 and not any(counts.values()),
          f"{tag}: launches {launches} of {counter}, others {counts}")
    key = batch_key(SEED, seed0 + 10)
    tracer = integ.batch_tracer(n, L_CHECK)
    batch = lambda: tracer(key, src.sample(key, L_CHECK, "cuda"), src)
    K = integ._fast_plan.unroll
    pb = profile_batch(batch)
    say(f"{tag}-profile", photons=n, **profile_fields(pb, K, card))
    bk = batch_kernel_time(batch, profile=profile_kernels)
    check(bk["launched"] == n, f"{tag}: the timed batch launched {bk['launched']} of {n}")
    say(f"{tag}-batch-kernel", photons=n, hits=bk["hits"], **batch_fields(bk, card))
    # The surface stage on its own: its device time over the profiled batch
    # (the same key, so the same photons) beside the bound of its work alone,
    # the bottom hits' bytes and operations (bounce_work).
    spec = bk["spec"]
    stage = bound_ms(variant(spec), 0, 0, **bounce_work(spec, L_CHECK * pb["surface_launches"],
                                                         bk["hits"]))
    bk["stage"] = {"ms": pb["surface_ms"], "launches": pb["surface_launches"], "bound": stage}
    say(f"{tag}-surface-stage", photons=n, launches=pb["surface_launches"],
        kernel_ms_per_batch=f"{pb['surface_ms']:.3f}", hits=bk["hits"],
        bound_ms=f"{stage[0]:.4f}", bound_by=stage[1], card=json.dumps(card))
    rate = n / sorted(times)[1]
    return results, launches, bk, dict(seconds=",".join(f"{t:.4f}" for t in times),
                                       photons_per_s=f"{rate:.4e}")


def gate_anchor(tag: str, what: str, values: list, anchor: tuple, n: int) -> str:
    """Mean of the three batches against a JAX-CPU anchor (mean, sigma) within
    5 sigma combined; the port's sigma is the larger of the batches' spread
    and the binomial sigma sqrt(m (1 - m) / 3n).  Returns the say() text."""
    m = float(np.mean(values))
    spread = float(np.std(values, ddof=1) / np.sqrt(len(values)))
    sig = max(spread, (max(m * (1 - m), 0.0) / (len(values) * n)) ** 0.5)
    comb = (sig ** 2 + anchor[1] ** 2) ** 0.5
    check(abs(m - anchor[0]) <= 5 * comb,
          f"{tag} {what}: {m} vs {anchor[0]} (5 sigma = {5 * comb:.2e})")
    return f"{m:.6f}({anchor[0]}+-{5 * comb:.1e})"


def surface_paths(out: Path, card: str) -> dict:
    """Phases 21-25: the five reflecting-surface paths at full width; returns
    the glint row's and the RPV radiance path's launches and batch records."""
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, SurfaceDescription,
                                make_step_cloud)

    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                           compute_volume_absorption=False)
    sun, src = PhotonSource.directional(0.707, 0.0), PhotonSource.directional(0.5, 0.0)
    cox = SurfaceDescription.uniform([5.0, 1.34], brdf_name="cox_munk")
    rec = {}

    # 21. the glint row: thin cirrus over Cox-Munk, flux, 2^27 photons
    integ = Integrator.create(glint_scene(), cfg, surface=cox, device="cuda")
    res, launches, bk, rate = surface_path("21 glint", integ, sun, GLINT_PHOTONS, card, 800,
                                           "surface_launches", profile_kernels=False)
    fups = [float(r.mean_flux_up) for r in res]
    m = float(np.mean(fups))
    spread = float(np.std(fups, ddof=1) / np.sqrt(3))
    sig = max(spread, (m * (1 - m) / (3 * GLINT_PHOTONS)) ** 0.5)
    gate = 5 * (sig ** 2 + 3 * sig ** 2) ** 0.5 + 5e-5     # the anchor: one batch of 2^27
    check(abs(m - ANCHOR_GLINT_FUP) <= gate, f"glint Fup {m} vs {ANCHOR_GLINT_FUP} ({gate:.2e})")
    say("21 glint", photons=GLINT_PHOTONS, lanes=L_CHECK, fup=f"{m:.6f}",
        fdn=f"{float(np.mean([float(r.mean_flux_down) for r in res])):.6f}",
        anchor=ANCHOR_GLINT_FUP, gate=f"{gate:.2e}", launches=launches, **rate,
        card=json.dumps(card))
    rec["flux"] = (launches, bk)

    # 22. the step cloud over a Lambertian albedo of 0.2, flux
    integ = Integrator.create(make_step_cloud(1.0), cfg, surface_albedo=0.2, device="cuda")
    res, launches, _, rate = surface_path("22 albedo", integ, src, SURFACE_PHOTONS, card, 820,
                                          "surface_launches")
    say("22 albedo", photons=SURFACE_PHOTONS, albedo=0.2, fup=gate_anchor(
        "albedo", "Fup", [float(r.mean_flux_up) for r in res], ANCHORS_ALBEDO["fup"],
        SURFACE_PHOTONS), launches=launches, **rate, card=json.dumps(card))

    # 23. the step cloud over RPV with two detectors
    rpv = SurfaceDescription.uniform(SURFACE_BRDFS["rpv"], brdf_name="rpv")
    integ = Integrator.create(make_step_cloud(1.0), cfg, surface=rpv, intensity_mus=RPV_DET_MUS,
                              intensity_phis=RPV_DET_PHIS, device="cuda")
    res, launches, bk, rate = surface_path("23 rpv-radiance", integ, src, SURFACE_PHOTONS, card,
                                           840, "detector_surface_launches")
    gates = {"fup": gate_anchor("rpv", "Fup", [float(r.mean_flux_up) for r in res],
                                ANCHORS_RPV["fup"], SURFACE_PHOTONS)}
    for d in range(2):
        gates[f"i{d}"] = gate_anchor("rpv", f"I{d}", [float(r.mean_intensity[d]) for r in res],
                                     ANCHORS_RPV[f"i{d}"], SURFACE_PHOTONS)
    slot0 = torch.stack([r.intensity_by_component[..., 0].mean(dim=(0, 1)) for r in res]).mean(0)
    check(float(slot0[1]) == 0.0, f"rpv: the downward detector's surface slot {slot0}")
    say("23 rpv-radiance", photons=SURFACE_PHOTONS, **gates,
        surface_slot=",".join(f"{float(v):.3e}" for v in slot0), launches=launches, **rate,
        card=json.dumps(card))
    rec["detectors"] = (launches, bk)

    # 24. examples/ocean_glint_radiance.py: 13 upward detectors over Cox-Munk
    integ = Integrator.create(glint_scene(), cfg, surface=cox,
                              intensity_mus=[SCAN_MU] * len(SCAN_PHIS),
                              intensity_phis=SCAN_PHIS, device="cuda")
    res, launches, _, rate = surface_path("24 ocean-glint-scan", integ, sun, SURFACE_PHOTONS,
                                          card, 860, "detector_surface_launches")
    scan = [gate_anchor("scan", f"I{d}", [float(r.mean_intensity[d]) for r in res],
                        ANCHORS_SCAN[f"i{d}"], SURFACE_PHOTONS) for d in range(len(SCAN_PHIS))]
    say("24 ocean-glint-scan", photons=SURFACE_PHOTONS, detectors=len(SCAN_PHIS),
        fup=gate_anchor("scan", "Fup", [float(r.mean_flux_up) for r in res],
                        ANCHORS_SCAN["fup"], SURFACE_PHOTONS),
        radiance=";".join(scan), launches=launches, **rate, card=json.dumps(card))

    # 25. phase 7's flux namelist with surfaceAlbedo = 0.2 through the driver
    from i3rc_tpu_torch.drivers.monte_carlo_driver import run_from_namelist
    from i3rc_tpu_torch.kernels import event_block as eb

    nml = out / "stepcloud_albedo.nml"
    nml.write_text((out / "stepcloud_flux.nml").read_text()
                   .replace("surfaceAlbedo = 0.", "surfaceAlbedo = 0.2")
                   .replace("stepCloudFluxes.out", "albedoFluxes.out")
                   .replace("stepCloudAbsorption.out", "albedoAbsorption.out")
                   .replace("stepCloudOutput.nc", "albedoOutput.nc"))
    outputs = ("albedoFluxes.out", "albedoAbsorption.out", "albedoOutput.nc")
    for name in outputs:
        (out / name).unlink(missing_ok=True)
    eb.reset_launch_counters()
    t0 = time.perf_counter()
    drv = run_from_namelist(str(nml), quiet=True, device="cuda")
    t_drv = time.perf_counter() - t0
    for name in outputs:
        check((out / name).is_file(), f"the albedo driver did not write {name}")
    (fup, fup_e), _, _ = drv["mean_stats"]
    comb = (fup_e ** 2 + ANCHORS_ALBEDO["fup"][1] ** 2) ** 0.5
    check(abs(fup - ANCHORS_ALBEDO["fup"][0]) <= 5 * comb, f"albedo driver Fup {fup} +- {fup_e}")
    check(eb.event_block.surface_launches > 0, "the albedo driver launched no surfaced kernel")
    say("25 albedo-driver", batches=drv["cfg"]["num_batches"], photons=drv["cfg"]["num_photons"],
        fup=f"{fup:.6f}", stderr=f"{fup_e:.1e}", anchor=ANCHORS_ALBEDO["fup"][0],
        seconds=f"{t_drv:.2f}", launches=eb.event_block.surface_launches, card=json.dumps(card))
    return rec


def reach_checks(dev, card: str) -> None:
    """Phase 4c: plans the card used to refuse, each against its twin on the
    full and tail states: 9 detectors with the roulette (the variant sized
    for 16), and K = 4 on the separable flux plan."""
    spec, results = kernel_vs_twin(1.0, dev, detectors=True, n_detectors=9)
    check(spec.det.n == 9 and spec.det.iwabuchi, f"detector count {spec.det.n}")
    for r in results:
        check_block("9 detectors", r)
        say("4c reach", detectors=spec.det.n, iwabuchi=True, n_draws=spec.n_draws,
            **block_fields(spec, r, card))
    spec, results = kernel_vs_twin(0.99, dev, K=4)
    check(spec.K == 4 and spec.chain == 2, f"K {spec.K}")
    for r in results:
        check_block("K = 4", r)
        say("4c reach", **block_fields(spec, r, card))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, batch_key,
                                make_step_cloud, write_domains)
    from i3rc_tpu_torch.core.rng import philox4x32, philox_uniforms
    from i3rc_tpu_torch.drivers.monte_carlo_driver import run_from_namelist
    from i3rc_tpu_torch.kernels import event_block as eb

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card and toolchain
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    card = smi
    say("1 card", torch=torch.__version__, cuda=torch.version.cuda,
        device=json.dumps(torch.cuda.get_device_name(0)), smi=json.dumps(smi))

    # 2. build: the fast and the general libraries, every nvcc process together,
    # from the checkout's sources (a cached library brings its build's log)
    from concurrent.futures import ThreadPoolExecutor

    from i3rc_tpu_torch.kernels import general_block as gb

    with ThreadPoolExecutor(1) as pool:
        general_built = pool.submit(gb.build)
        built = eb.build()
        gbuilt = general_built.result()
    gptx = ptxas_general(gbuilt.log)
    check(len(gptx) == 26, f"general kernel instantiations {sorted(gptx)}")
    say("2 build-general", seconds=f"{gbuilt.seconds:.1f}", library=gbuilt.path.name,
        instantiations=len(gptx),
        **{k: "{registers}regs/{stack_bytes}Bstack/{spill_store_bytes}Bspill/{ctas_per_sm}cta"
           .format(**v) for k, v in sorted(gptx.items())})
    # <= 64 registers keeps 4 CTAs of 256 threads on an SM; the flux
    # instantiations spill nothing.
    for name, v in gptx.items():
        check(v.get("registers", 256) <= 64 and v.get("ctas_per_sm", 0) == 4,
              f"general {name}: {v}")
        if not name.endswith("_det"):
            check(v.get("spill_store_bytes", 1) == 0, f"general {name} spills: {v}")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", built.log)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", built.log))
    say("2 build", seconds=f"{built.seconds:.1f}", library=built.path.name,
        max_registers=max(regs) if regs else "n/a", spill_store_bytes=spills,
        **ptxas_by_variant(built.log))
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ptxas.log").write_text(built.log + gbuilt.log)
    census = sass_census(built.path)
    ptxas = ptxas_of_census(built.log)
    for name, ops in census.items():
        say("2 sass", instantiation=name, **ptxas.get(name, {}),
            **(ops if isinstance(ops, dict) else {"ops": ops}))
    if "cuobjdump" not in census:
        for name in CENSUS:
            check(name in census, f"{name} not found in the cuobjdump listing")
        for name in ("detectors_iwabuchi", "gas_detectors", "detectors_iwabuchi_16"):
            # No compare-and-swap loop: the detector tally has no fp64 shared-
            # memory atomic.  What shared atomics there are, are the
            # prologue's int32 counts, which the flux variant has too.
            check(all(census[name][op] == census["flux_chain2"][op] for op in ("CAS", "ATOMS")),
                  f"{name}: SASS {census[name]}")

    # 3. Philox: known answer, and the kernel's draws equal the torch stream
    kat = eb.kernel_philox_bits(0, 0, 0, 0, 0, 1, dev)[0].tolist()
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    kat_torch = [int(w) for w in philox4x32(zero, zero, zero, zero, 0, 0)]
    expect = [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    check(kat == expect and kat_torch == expect, f"Philox known answer: {kat} {kat_torch}")
    for nd in (9, 12):
        ku = eb.kernel_philox_uniforms(batch_key(SEED, 3), 11, 8, nd, L_CHECK, dev)
        tu = philox_uniforms(batch_key(SEED, 3), 11, 8, nd, L_CHECK, dev)
        check(torch.equal(ku, tu), f"kernel Philox draws differ from torch (n_draws={nd})")
    say("3 philox", known_answer="ok", bit_equal_draws=2 * 8 * L_CHECK)

    # 4. kernel vs twin on one K-event block at L = 2^18, on a full and a
    # tail state: every state row bit for bit
    flux_timed, max_err = None, 0.0
    for ssa in (1.0, 0.99):
        spec, results = kernel_vs_twin(ssa, dev)
        for r in results:
            check_block(f"flux ssa={ssa}", r)
            max_err = max(max_err, r["max_abs_err"])
            say("4 kernel-vs-twin", ssa=ssa, **block_fields(spec, r, card))
        flux_timed = flux_timed or results[0]

    # 4b. the whole block of the trace loop (prologue + K events, one launch)
    # against its plain version, every variant and source kind
    fused = fused_block_checks(dev, card)

    # 4c. plans past the kernel's old reach: 9 detectors, K = 4
    reach_checks(dev, card)

    # 4d. reflecting surfaces: the kernel's BRDFs against core/surface.py, and
    # the whole block with the surface stage against its plain version
    brdf_diff = brdf_kernel_checks(dev, card)
    surf_timed, surf_err = surface_block_checks(dev, card)

    # 5. the slice: step cloud, 2^24 photons at 2^18 lanes
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500)
    src = PhotonSource.directional(0.5, 0.0)
    eb.reset_launch_counters()
    flux_integ = Integrator.create(make_step_cloud(1.0), cfg, device="cuda")
    fn = flux_integ.batch_fn(src, SLICE_PHOTONS, n_lanes=L_CHECK)
    for w in range(2):
        fn(batch_key(SEED, 100 + w))
    torch.cuda.synchronize()
    fups, times = [], []
    for b in range(3):
        t0 = time.perf_counter()
        res = fn(batch_key(SEED, b))
        fup, fdn = float(res.mean_flux_up), float(res.mean_flux_down)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(abs(fup + fdn - 1.0) < 1e-5, f"closure Fup+Fdn={fup + fdn}")
        check(int(res.n_bad) == 0, f"n_bad={int(res.n_bad)}")
        fups.append(fup)
    launches_slice = eb.event_block.launches
    check(launches_slice > 0, "the slice launched no event-block kernel")
    fup = sum(fups) / len(fups)
    sigma = (ANCHOR_FUP * (1 - ANCHOR_FUP) / (3 * SLICE_PHOTONS)) ** 0.5
    check(abs(fup - ANCHOR_FUP) <= max(5 * sigma, 1e-3), f"step-cloud Fup {fup}")
    rate = SLICE_PHOTONS / sorted(times)[1]
    say("5 slice", photons=SLICE_PHOTONS, lanes=L_CHECK, fup=f"{fup:.6f}",
        anchor=ANCHOR_FUP, sigma=f"{sigma:.2e}",
        seconds=",".join(f"{t:.4f}" for t in times), photons_per_s=f"{rate:.4e}",
        launches=launches_slice, card=json.dumps(card))
    # One more batch under the profiler alone (launches per block, the
    # device's idle share), and one with each launch timed (the kernel's
    # device time over the batch beside its bound).
    key = batch_key(SEED, 110)
    tracer = flux_integ.batch_tracer(SLICE_PHOTONS, L_CHECK)
    flux_batch = lambda: tracer(key, src.sample(key, L_CHECK, "cuda"), src)
    say("5 slice-profile", photons=SLICE_PHOTONS, **profile_fields(profile_batch(flux_batch),
                                                                  8, card))
    flux_bk = batch_kernel_time(flux_batch)
    say("5 slice-batch-kernel", photons=SLICE_PHOTONS, **batch_fields(flux_bk, card))

    # 6. absorbing variant: closure with the absorbed flux
    before = eb.event_block.launches
    res = Integrator.create(make_step_cloud(0.99), cfg, device="cuda").batch_fn(
        src, 1 << 22, n_lanes=L_CHECK)(batch_key(SEED, 200))
    parts = [float(res.mean_flux_up), float(res.mean_flux_down),
             float(res.mean_flux_absorbed)]
    check(abs(sum(parts) - 1.0) < 1e-5, f"absorbing closure {parts}")
    check(int(res.n_bad) == 0, f"absorbing n_bad={int(res.n_bad)}")
    check(eb.event_block.launches > before, "absorbing run launched no kernel")
    say("6 absorbing", fup=f"{parts[0]:.6f}", fdn=f"{parts[1]:.6f}",
        fabs=f"{parts[2]:.6f}", launches=eb.event_block.launches - before)

    # 7. the driver on a flux-only namelist
    write_domains(str(out))
    nml = out / "stepcloud_flux.nml"
    nml.write_text(textwrap.dedent(f"""
    &radiativeTransfer
      solarFlux = 1., solarMu = 0.5, solarAzimuth = 0., surfaceAlbedo = 0.
    /
    &monteCarlo
      numPhotonsPerBatch = {1 << 20}, numBatches = 16, iseed = 10
    /
    &algorithms
      useRayTracing = .false.
    /
    &fileNames
      domainFileName = "{out}/StepCloud_NonAbsorbing.opt",
      outputFluxFile = "{out}/stepCloudFluxes.out",
      outputAbsProfFile = "{out}/stepCloudAbsorption.out",
      outputNetcdfFile = "{out}/stepCloudOutput.nc"
    /
    &output
      reportAbsorptionProfile = .true.
    /
    """))
    before = eb.event_block.launches
    t0 = time.perf_counter()
    drv = run_from_namelist(str(nml), quiet=True, device="cuda")
    t_drv = time.perf_counter() - t0
    for name in ("stepCloudFluxes.out", "stepCloudAbsorption.out", "stepCloudOutput.nc"):
        check((out / name).is_file(), f"driver did not write {name}")
    m, e = drv["mean_stats"][0]
    check(abs(m - ANCHOR_FUP) <= 5 * e, f"driver Fup {m} +- {e}")
    check(eb.event_block.launches > before, "driver launched no kernel")
    say("7 driver", batches=drv["cfg"]["num_batches"], photons=drv["cfg"]["num_photons"],
        fup=f"{m:.6f}", stderr=f"{e:.2e}", seconds=f"{t_drv:.2f}",
        launches=eb.event_block.launches - before)

    # 8. detector variant vs twin: 3 detectors, Iwabuchi, one K-event block on
    # a full and a tail state, with and without absorption
    det_timed, det_err = None, 0.0
    for ssa in (1.0, 0.99):
        spec, results = kernel_vs_twin(ssa, dev, detectors=True)
        for r in results:
            check_block(f"detectors ssa={ssa}", r)
            det_err = max(det_err, r["max_abs_err"], r["acc_abs_err"])
            say("8 detector-kernel-vs-twin", ssa=ssa, detectors=spec.det.n,
                iwabuchi=spec.det.iwabuchi, n_draws=spec.n_draws, **block_fields(spec, r, card))
        det_timed = det_timed or results[0]

    # 9. the radiance slice: step cloud + 3 detectors, 2^24 photons at 2^18 lanes
    eb.reset_launch_counters()
    rad_integ = Integrator.create(make_step_cloud(1.0), radiance_config(),
                                  intensity_mus=DET_MUS, intensity_phis=DET_PHIS, device="cuda")
    fn = rad_integ.batch_fn(src, SLICE_PHOTONS, n_lanes=L_CHECK)
    fn(batch_key(SEED, 300))
    torch.cuda.synchronize()
    intens, times = [], []
    for b in range(3):
        t0 = time.perf_counter()
        res = fn(batch_key(SEED, 310 + b))
        i_b = res.mean_intensity.cpu()
        closure = float(res.mean_flux_up + res.mean_flux_down)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(abs(closure - 1.0) < 1e-5, f"radiance closure Fup+Fdn={closure}")
        check(int(res.n_bad) == 0, f"radiance n_bad={int(res.n_bad)}")
        check(bool(torch.isfinite(res.intensity).all()) and res.intensity.shape == (32, 1, 3),
              f"radiance field {tuple(res.intensity.shape)}")
        intens.append(i_b)
    launches_rad = eb.event_block.detector_launches
    check(launches_rad > 0, "the radiance slice launched no detector kernel")
    check(eb.event_block.launches == 0, "the radiance slice launched the flux kernel")
    stack = torch.stack(intens).double()
    i_mean, i_sigma = stack.mean(0), stack.std(0) / len(intens) ** 0.5
    for d, anchor in enumerate(ANCHOR_I):
        check(abs(float(i_mean[d]) - anchor) <= 0.01 * anchor + 5 * float(i_sigma[d]),
              f"detector {d}: I = {float(i_mean[d])} +- {float(i_sigma[d])}, anchor {anchor}")
    rad_rate = SLICE_PHOTONS / sorted(times)[1]
    say("9 radiance", photons=SLICE_PHOTONS, lanes=L_CHECK,
        intensity=",".join(f"{float(v):.5f}" for v in i_mean),
        sigma=",".join(f"{float(v):.1e}" for v in i_sigma),
        anchor=",".join(map(str, ANCHOR_I)), seconds=",".join(f"{t:.4f}" for t in times),
        photons_per_s=f"{rad_rate:.4e}", launches=launches_rad, card=json.dumps(card))
    # The detector kernel's device time over one more whole batch, beside its bound.
    key = batch_key(SEED, 320)
    tracer = rad_integ.batch_tracer(SLICE_PHOTONS, L_CHECK)
    rad_batch = lambda: tracer(key, src.sample(key, L_CHECK, "cuda"), src)
    say("9 radiance-profile", photons=SLICE_PHOTONS, **profile_fields(profile_batch(rad_batch),
                                                                     8, card))
    rad_bk = batch_kernel_time(rad_batch)
    say("9 radiance-batch-kernel", photons=SLICE_PHOTONS, **batch_fields(rad_bk, card))

    # 10. the driver on the shipped radiance namelist, unmodified, run from the
    # directory that holds the domain files (its paths are relative)
    shipped = "monteCarloDriver_stepCloud.nml"
    shutil.copy(ROOT / "examples" / shipped, out / shipped)
    outputs = ("stepCloudRads.out", "stepCloudFluxes.out", "stepCloudAbsorption.out",
               "stepCloudOutput.nc")
    for name in outputs:
        (out / name).unlink(missing_ok=True)
    eb.reset_launch_counters()
    cwd = os.getcwd()
    os.chdir(out)
    try:
        t0 = time.perf_counter()
        drv = run_from_namelist(shipped, quiet=True, device="cuda")
        t_drv = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    for name in outputs:
        check((out / name).is_file(), f"driver did not write {name}")
    i_m = drv["stats"].mean["derived"]["mean_intensity"]
    i_e = drv["stats"].stderr["derived"]["mean_intensity"]
    for d, anchor in enumerate(ANCHOR_I):
        check(abs(float(i_m[d]) - anchor) <= 0.01 * anchor + 5 * float(i_e[d]),
              f"driver detector {d}: I = {float(i_m[d])} +- {float(i_e[d])}")
    (fup, _), (fdn, _), _ = drv["mean_stats"]
    check(abs(fup + fdn - 1.0) < 1e-5, f"driver closure {fup + fdn}")
    check(eb.event_block.detector_launches > 0, "radiance driver launched no detector kernel")
    say("10 radiance-driver", namelist=shipped, batches=drv["cfg"]["num_batches"],
        photons=drv["cfg"]["num_photons"],
        intensity=",".join(f"{float(v):.5f}" for v in i_m),
        stderr=",".join(f"{float(v):.1e}" for v in i_e), seconds=f"{t_drv:.2f}",
        launches=eb.event_block.detector_launches, card=json.dumps(card))

    # 11. gas-channel variants vs twin: one K-event block, flux at chain depth
    # 3 and the two-detector variant, ssa 1 and 0.99, on a uniform gas; then
    # both on the layered gas, whose interior faces the photons cross
    gas_ms, gas_err = gas_kernel_checks(dev, card)

    # 12. cloud (tau 1, HG 0.85) + gas (tau 0.5) over an 8-layer slab against
    # the discrete-ordinates oracle of the combined medium
    # (tests/test_external_validation.py:152)
    gas_slab_oracle(dev)

    # 13. the broadband slice at the bench row's size (bench.py:274-337): step
    # cloud, one band of k = 4e-4 and 4e-3 (weights 0.7 / 0.3), baked mode,
    # 2 batches of 2^24 photons per k point
    bb_launches, gas_bk = broadband_slice(dev, card)

    # 14. examples/broadbandDriver.nml, unmodified, through the port's driver
    # from a directory holding the inputs that examples/make_broadband_inputs.py
    # writes (its paths are relative)
    launches_gas_det = broadband_driver(out / "broadband", card)

    # 15. column variant vs twin: one K-event block from a mid-flight Landsat
    # state, ssa 1 at the auto chain depth (2), ssa 0.99 at depth 2 and 0
    col_timed = column_kernel_checks(dev, card)

    # 16. the Landsat flux slice at full size (bench.py:168-190): 2^23
    # photons at 2^18 lanes, median of 3 after a warm-up
    launches_col, col_bk = landsat_slice(card)

    # 17. Landsat at ssa 0.99 with heating rates (1.95M-cell volume tally)
    landsat_absorbing()

    # 18. the Landsat domain file the port writes, through the namelist driver
    landsat_driver(out / "landsat", card)

    # 19. the column-read probe: its loop (two launches of K = 8 events at
    # 2^17 lanes), then the kernel against its twin on the same draws
    probe = probe_checks(dev, card)

    # 21-25. reflecting surfaces at full width: the glint row (Cox-Munk under
    # thin cirrus, 2^27 photons), the step cloud over an albedo of 0.2, the
    # step cloud over RPV with two detectors, the 13-detector ocean-glint
    # scan, and the albedo through the namelist driver
    surf_paths = surface_paths(out, card)

    # 26-31. the general kernel: against its plain version on every
    # transport mode, optics, surface and the weight-1 class, then its paths
    g_timed, g_err = general_kernel_vs_twin(dev, card, gptx)
    g_rec = general_paths(out, card)

    # 32-37. the general kernel's local estimate: against its plain version
    # on every estimator x mode x surface and the weight-1 class (f), then
    # the default configuration's radiance (a), bench.py's Woodcock radiance
    # row (b), Landsat with 2 detectors (c), vacuum over Cox-Munk (d) and the
    # shipped radiance namelist with ray tracing through the driver (e)
    e_timed, e_err = radiance_kernel_vs_twin(dev, card, gptx)
    e_rec = radiance_paths(out, card)

    # 20. results: every kernel with its launches on its path, its error
    # against its twin, its device time from the profiler (one block of K
    # events, prologue off, on the full state; events_ms is the CUDA-event
    # time of the same launch, which on an idle device includes the host's
    # building of the parameter block), the twin's and the least time the
    # card could take; beside them the whole block's device time on a
    # mid-flight state (fused_ms, with the K events alone on the same lanes,
    # its plain version's and its bound) and the kernel's device time over one
    # batch of the main path with that batch's bound.  No single PyTorch
    # call computes a transport event or the probe's dependent read loop,
    # so library_ms is null throughout.  The surfaced entries are the whole
    # block over a reflecting surface (prologue, K events, surface stage) on
    # a mid-flight state, their max_abs_err the largest state difference to
    # the plain version in phase 4d.
    print(smi)
    source = "i3rc_tpu_torch/csrc/fast_event_block.cu"
    gas_source = "i3rc_tpu_torch/csrc/fast_event_block_gas.cu"

    def entry(name, src, replaces, launches, err, ms, plain, bound, events_ms, whole=None,
              batch=None):
        e = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
             "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
             "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
             "events_ms": events_ms}
        if whole is not None:
            e.update(fused_ms=whole["device_ms"], fused_events_only_ms=whole["events_device_ms"],
                     fused_plain_ms=whole["twin_ms"],
                     fused_bound_ms=whole["bound"][0],
                     max_abs_err=max(err, whole["max_abs_err"]))
        if batch is not None:
            e.update(batch_ms=batch["kernel_ms"], batch_launches=batch["launches"],
                     batch_bound_ms=batch["bound"][0])
        return e

    timed = lambda r: (r["device_ms"], r["twin_ms"], r["bound"], r["kernel_ms"])
    print(json.dumps({"kernels": [
        entry("fast_event_block", source, "i3rc_tpu/integrators/fastpath.py:665",
              launches_slice, max_err, *timed(flux_timed), fused["flux"], flux_bk),
        entry("fast_event_block_detectors", source,
              "i3rc_tpu/integrators/fastpath.py:665 (n_detectors>0)", launches_rad, det_err,
              *timed(det_timed), fused["detectors"], rad_bk),
        entry("fast_event_block_gas", gas_source,
              "i3rc_tpu/integrators/fastpath.py:665 (gas=True)", bb_launches, gas_err[False],
              *gas_ms[False], fused["gas"], gas_bk),
        entry("fast_event_block_gas_detectors", gas_source,
              "i3rc_tpu/integrators/fastpath.py:665 (gas=True)", launches_gas_det,
              gas_err[True], *gas_ms[True], fused["gas_detectors"]),
        entry("fast_event_block_column", "i3rc_tpu_torch/csrc/fast_event_block_col.cu",
              "benchmarks/column_read_probe.py:83 (in the column event of "
              "i3rc_tpu/integrators/fastpath.py:1320)", launches_col, 0.0, *col_timed,
              fused["column"], col_bk),
        entry("column_read_probe", "i3rc_tpu_torch/csrc/column_read_probe.cu",
              "benchmarks/column_read_probe.py:83", *probe)] + [
        surface_entry(f"fast_event_block{sfx}_surface", source, kind, surf_paths[kind],
                      surf_timed[kind], surf_err[kind], brdf_diff)
        for sfx, kind in (("", "flux"), ("_detectors", "detectors"))] + [
        general_entry(g_timed, g_err, g_rec), estimate_entry(e_timed, e_err, e_rec)]},
        allow_nan=False))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def surface_entry(name: str, source: str, kind: str, path: tuple, whole: dict, err: float,
                  brdf_diff: dict) -> dict:
    """The kernels-line entry of the event block over a reflecting surface:
    launches on its phase-21 (flux) or phase-23 (detectors) path, the whole
    block's device time, plain time and bound (phase 4d), its tail, and the
    batch's kernel time beside its bound."""
    launches, bk = path
    return {"name": name, "route": "cuda", "source": source,
            "replaces": "i3rc_tpu/integrators/fastpath.py:665"
                        + (" (n_detectors>0)" if kind == "detectors" else "")
                        + " with the surface glue of :1874-1981",
            "launches": launches, "max_abs_err": err, "ms": whole["device_ms"],
            "plain_ms": whole["twin_ms"], "bound_ms": whole["bound"][0],
            "bound_by": whole["bound"][1], "library_ms": None,
            "events_ms": whole["kernel_ms"], "fused_events_only_ms": whole["events_device_ms"],
            "tail_ms": whole["tail_ms"], "batch_ms": bk["kernel_ms"],
            "batch_launches": bk["launches"], "batch_bound_ms": bk["bound"][0],
            "surface_stage_ms": bk["stage"]["ms"],
            "surface_stage_launches": bk["stage"]["launches"],
            "surface_stage_bound_ms": bk["stage"]["bound"][0],
            "brdf_values_differing": {k: v[0] for k, v in brdf_diff.items()}}


def gas_kernel_checks(dev, card: str):
    """Phase 11; returns ({detectors: (kernel device ms, twin ms, bound, kernel
    event ms)}, {detectors: max error}) with the times of the uniform gas at
    ssa 1 on the full state."""
    gas_ms = {}
    gas_err = {False: 0.0, True: 0.0}
    uniform = np.full(32, GAS_EXT)
    cases = [(False, 1.0, "uniform"), (False, 0.99, "uniform"), (True, 1.0, "uniform"),
             (True, 0.99, "uniform"), (False, 0.99, "layered"), (True, 1.0, "layered")]
    for detectors, ssa, gas in cases:
        profile = uniform if gas == "uniform" else LAYERED_GAS
        spec, results = kernel_vs_twin(ssa, dev, detectors=detectors, gas=profile)
        what = f"gas={gas} detectors={detectors} ssa={ssa}"
        check(spec.chain == (0 if detectors else 3), f"{what}: chain depth {spec.chain}")
        check(len(spec.gz.thresholds) == (0 if gas == "uniform" else 2),
              f"{what}: gas faces {spec.gz.thresholds}")
        for r in results:
            check_block(what, r)
            gas_err[detectors] = max(gas_err[detectors], r["max_abs_err"],
                                     r.get("acc_abs_err", 0.0))
            say("11 gas-kernel-vs-twin", gas=gas, gas_faces=len(spec.gz.thresholds),
                detectors=spec.det.n if detectors else 0, ssa=ssa, n_draws=spec.n_draws,
                **block_fields(spec, r, card))
        gas_ms.setdefault(detectors, (results[0]["device_ms"], results[0]["twin_ms"],
                                      results[0]["bound"], results[0]["kernel_ms"]))
    return gas_ms, gas_err


def column_kernel_checks(dev, card: str):
    """Phase 15; returns (kernel device ms, twin ms, bound, kernel event ms) of
    ssa 1 at the auto depth and the planner's K (32) on the full state.  The column variant at chain
    depth 2 and 0, K = 32 and 8, must equal its twin bit for bit on all 13
    state rows on both states."""
    out = None
    for ssa, chain, K in ((1.0, -1, None), (0.99, 2, None), (0.99, 0, None), (1.0, 2, 8),
                          (0.99, 0, 8)):
        spec, results = kernel_vs_twin(ssa, dev, chain=chain, K=K)
        what = f"column ssa={ssa} chain={spec.chain} K={spec.K}"
        check(spec.chain == (2 if chain < 0 else chain), f"{what}: chain depth")
        check(spec.K == (K or 32), f"{what}: K")
        for r in results:
            check_block(what, r)
            say("15 column-kernel-vs-twin", ssa=ssa, n_draws=spec.n_draws,
                columns=spec.n_x * spec.n_y, **block_fields(spec, r, card))
        out = out or (results[0]["device_ms"], results[0]["twin_ms"], results[0]["bound"],
                      results[0]["kernel_ms"])
    return out


def landsat_slice(card: str) -> tuple[int, dict]:
    """Phase 16, at the planner's K (32); returns the column-kernel launches of
    the three timed batches and the record of the kernel's device time over
    one more batch (after one under the profiler alone); then three batches
    at K = 8 for the record."""
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, batch_key,
                                make_landsat_cloud)
    from i3rc_tpu_torch.kernels import event_block as eb

    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                           compute_volume_absorption=False)
    n = LANDSAT_PHOTONS
    src = PhotonSource.directional(0.5, 0.0)
    integ = Integrator.create(make_landsat_cloud(1.0), cfg, device="cuda")
    check(integ._fast_plan.unroll == 32, f"Landsat K {integ._fast_plan.unroll}")
    fn = integ.batch_fn(src, n, n_lanes=L_CHECK)
    # Warm-up: one batch through the raw tracer, for its event count.
    key = batch_key(SEED, 500)
    raw = integ.batch_tracer(n, L_CHECK)(key, src.sample(key, L_CHECK, "cuda"), src)
    events = int(raw.n_lane_events) / n
    torch.cuda.synchronize()

    def timed_batches(fn, seed0: int):
        """Three batches: their Fup and host seconds, each gated on closure."""
        fups, times = [], []
        for b in range(3):
            t0 = time.perf_counter()
            res = fn(batch_key(SEED, seed0 + b))
            fup, fdn, n_bad = float(res.mean_flux_up), float(res.mean_flux_down), int(res.n_bad)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(abs(fup + fdn - 1.0) < 1e-5, f"Landsat closure Fup+Fdn={fup + fdn}")
            check(n_bad < 1e-3 * n, f"Landsat n_bad={n_bad}")
            fups.append(fup)
        return fups, times

    eb.reset_launch_counters()
    fups, times = timed_batches(fn, 510)
    launches = eb.event_block.column_launches
    check(launches > 0, "the Landsat slice launched no column kernel")
    check(eb.event_block.launches == eb.event_block.detector_launches
          == eb.event_block.gas_launches == eb.event_block.gas_detector_launches == 0,
          "the Landsat slice launched a kernel other than the column kernel")
    fup = sum(fups) / len(fups)
    sigma_port = (fup * (1 - fup) / (3 * n)) ** 0.5
    sigma_ref = (ANCHOR_LANDSAT_FUP * (1 - ANCHOR_LANDSAT_FUP) / n) ** 0.5
    gate = 5 * (sigma_port ** 2 + sigma_ref ** 2) ** 0.5 + 5e-5
    check(abs(fup - ANCHOR_LANDSAT_FUP) <= gate,
          f"Landsat Fup {fup} vs {ANCHOR_LANDSAT_FUP} (gate {gate:.2e})")
    t_med = sorted(times)[1]
    blocks = launches / 3
    say("16 landsat", photons=n, lanes=L_CHECK, fup=f"{fup:.6f}", anchor=ANCHOR_LANDSAT_FUP,
        gate=f"{gate:.2e}", seconds=",".join(f"{t:.4f}" for t in times),
        photons_per_s=f"{n / t_med:.4e}", blocks_per_batch=f"{blocks:.1f}",
        ms_per_block=f"{1e3 * t_med / blocks:.3f}", events_per_photon=f"{events:.1f}",
        K=integ._fast_plan.unroll, launches=launches, card=json.dumps(card))
    key = batch_key(SEED, 520)
    tracer = integ.batch_tracer(n, L_CHECK)
    land_batch = lambda: tracer(key, src.sample(key, L_CHECK, "cuda"), src)
    say("16 landsat-profile", photons=n, **profile_fields(profile_batch(land_batch),
                                                         integ._fast_plan.unroll, card))
    col_bk = batch_kernel_time(land_batch)
    say("16 landsat-batch-kernel", photons=n, K=integ._fast_plan.unroll,
        **batch_fields(col_bk, card))
    # At K = 8, the column K before the planner took the JAX K, for the record:
    # timed as at K = 32, median of 3 after a warm-up.
    fn8 = Integrator.create(make_landsat_cloud(1.0), replace(cfg, fastpath_unroll=8),
                            device="cuda").batch_fn(src, n, n_lanes=L_CHECK)
    float(fn8(batch_key(SEED, 530)).mean_flux_up)
    torch.cuda.synchronize()
    before = eb.event_block.column_launches
    fups8, times8 = timed_batches(fn8, 531)
    fup8 = sum(fups8) / len(fups8)
    check(abs(fup8 - ANCHOR_LANDSAT_FUP) <= gate, f"Landsat K=8 Fup {fup8} (gate {gate:.2e})")
    blocks8 = (eb.event_block.column_launches - before) / 3
    t8 = sorted(times8)[1]
    say("16 landsat-k8", photons=n, K=8, fup=f"{fup8:.6f}",
        seconds=",".join(f"{t:.4f}" for t in times8), photons_per_s=f"{n / t8:.4e}",
        blocks_per_batch=f"{blocks8:.1f}", ms_per_block=f"{1e3 * t8 / blocks8:.3f}",
        card=json.dumps(card))
    return launches, col_bk


def landsat_absorbing() -> None:
    """Phase 17: the raw volume tally holds exactly the absorbed photons."""
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, batch_key,
                                make_landsat_cloud)
    from i3rc_tpu_torch.kernels import event_block as eb

    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                           compute_volume_absorption=True)
    n = 1 << 22
    src = PhotonSource.directional(0.5, 0.0)
    key = batch_key(SEED, 600)
    integ = Integrator.create(make_landsat_cloud(0.99), cfg, device="cuda")
    eb.reset_launch_counters()
    raw = integ.batch_tracer(n, L_CHECK)(key, src.sample(key, L_CHECK, "cuda"), src)
    up, dn, ab = (float(v.sum()) for v in (raw.flux_up, raw.flux_down, raw.flux_absorbed))
    vol = float(raw.volume_absorption.sum())
    n_bad = int(raw.n_bad)
    check(eb.event_block.column_launches > 0, "the absorbing Landsat run launched no kernel")
    check(raw.volume_absorption.shape == (128 * 128 * 119,),
          f"volume tally {tuple(raw.volume_absorption.shape)}")
    check(vol == ab and ab > 0, f"volume tally {vol} vs absorbed {ab}")
    check(abs((up + dn + ab) / n - 1.0) < 1e-5, f"absorbing Landsat closure {up, dn, ab}")
    check(n_bad < 1e-3 * n, f"absorbing Landsat n_bad={n_bad}")
    say("17 landsat-absorbing", photons=n, fup=f"{up / n:.6f}", fdn=f"{dn / n:.6f}",
        fabs=f"{ab / n:.6f}", volume_sum=f"{vol:.0f}", absorbed_sum=f"{ab:.0f}",
        launches=eb.event_block.column_launches)


def landsat_driver(land_dir: Path, card: str) -> None:
    """Phase 18: the shipped step-cloud namelist's flux settings, the domain
    file swapped for the Landsat file the port writes, no radiance, 4 x
    2^20 photons."""
    from i3rc_tpu_torch.drivers.monte_carlo_driver import run_from_namelist
    from i3rc_tpu_torch.kernels import event_block as eb
    from i3rc_tpu_torch.models.landsat_cloud import write_domains as write_landsat

    land_dir.mkdir(parents=True, exist_ok=True)
    write_landsat(str(land_dir))
    text = (ROOT / "examples" / "monteCarloDriver_stepCloud.nml").read_text()
    swaps = [("intensityMus = 1., .5, .5\n", ""), ("intensityPhis = 0., 0., 180.\n", ""),
             ('outputRadFile = "stepCloudRads.out",\n', ""),
             ("numPhotonsPerBatch = 100000", f"numPhotonsPerBatch = {1 << 20}"),
             ("numBatches = 16", "numBatches = 4"),
             ("StepCloud_NonAbsorbing.opt", "LandsatCloud_NonAbsorbing.opt"),
             ("stepCloud", "landsat")]
    for old, new in swaps:
        check(old in text, f"namelist lacks {old!r}")
        text = text.replace(old, new)
    (land_dir / "landsat.nml").write_text(text)
    outputs = ("landsatFluxes.out", "landsatAbsorption.out", "landsatOutput.nc")
    for name in outputs:
        (land_dir / name).unlink(missing_ok=True)
    eb.reset_launch_counters()
    cwd = os.getcwd()
    os.chdir(land_dir)
    try:
        t0 = time.perf_counter()
        drv = run_from_namelist("landsat.nml", quiet=True, device="cuda")
        t_drv = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    for name in outputs:
        check((land_dir / name).is_file(), f"Landsat driver did not write {name}")
    (fup, fup_e), (fdn, _), _ = drv["mean_stats"]
    check(abs(fup + fdn - 1.0) < 1e-5, f"Landsat driver closure {fup + fdn}")
    n_drv = drv["cfg"]["num_photons"]
    gate = 5 * (ANCHOR_LANDSAT_FUP * (1 - ANCHOR_LANDSAT_FUP) * (1 / n_drv + 1 / LANDSAT_PHOTONS)
                ) ** 0.5 + 5e-5
    check(abs(fup - ANCHOR_LANDSAT_FUP) <= gate, f"Landsat driver Fup {fup} (gate {gate:.2e})")
    check(eb.event_block.column_launches > 0, "the Landsat driver launched no column kernel")
    say("18 landsat-driver", batches=drv["cfg"]["num_batches"],
        photons=drv["cfg"]["num_photons"], fup=f"{fup:.5f}", stderr=f"{fup_e:.1e}",
        seconds=f"{t_drv:.2f}", launches=eb.event_block.column_launches,
        card=json.dumps(card))


def probe_checks(dev, card: str):
    """Phase 19; returns (launches, max abs error, ms, twin ms, bound, ms) of
    one launch at 2^17 lanes (CUDA events around 20 queued launches: no host
    work falls between them, so the event time is the device's)."""
    from i3rc_tpu_torch import batch_key
    from i3rc_tpu_torch.kernels import column_probe as cp

    g = torch.Generator().manual_seed(SEED)
    table = torch.rand((cp.N_SIDE ** 2, 4), generator=g).to(dev)
    x0 = torch.rand(PROBE_LANES, generator=g).to(dev)
    y0 = torch.rand(PROBE_LANES, generator=g).to(dev)
    key = batch_key(SEED, 700)
    # The probe's loop: LOOP events in launches of K.
    cp.column_probe.launches = 0
    x, y = x0.clone(), y0.clone()
    for kb in range(PROBE_LOOP // cp.K):
        acc = cp.column_probe(table, x, y, key, kb)
    torch.cuda.synchronize()
    launches = cp.column_probe.launches
    check(launches == PROBE_LOOP // cp.K, f"probe launches {launches}")
    check(bool(torch.isfinite(acc).all()) and float(acc.min()) >= 0.0, "probe acc")
    # Kernel vs twin on the same draws.
    kx, ky = x0.clone(), y0.clone()
    kacc = cp.column_probe(table, kx, ky, key, 0)
    tx, ty, tacc = cp.column_probe_reference(table, x0, y0,
                                             cp.probe_uniforms(key, 0, PROBE_LANES, dev))
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in ((kx, tx), (ky, ty), (kacc, tacc)))
    check(torch.equal(kx, tx) and torch.equal(ky, ty) and torch.equal(kacc, tacc),
          f"probe kernel and twin differ (max abs error {err})")

    def time_ms(fn, n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        xs, ys = x0.clone(), y0.clone()
        fn(xs, ys)
        torch.cuda.synchronize()
        a.record()
        for _ in range(n):
            fn(xs, ys)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    u = cp.probe_uniforms(key, 0, PROBE_LANES, dev)
    k_ms = time_ms(lambda xs, ys: cp.column_probe(table, xs, ys, key, 0), 20)
    p_ms = time_ms(lambda xs, ys: cp.column_probe_reference(table, xs, ys, u), 5)
    lane_events = PROBE_LANES * cp.K
    bound = bound_ms("probe", lane_events, PROBE_LANES * 5 * 4 + table.numel() * 4)
    say("19 probe", lanes=PROBE_LANES, K=cp.K, loop=PROBE_LOOP, bit_equal=True,
        kernel_ms=f"{k_ms:.4f}", twin_ms=f"{p_ms:.4f}",
        ns_per_lane_event=f"{1e6 * k_ms / lane_events:.4f}", launches=launches,
        card=json.dumps(card))
    return launches, err, k_ms, p_ms, bound, k_ms


def gas_slab_oracle(dev) -> None:
    """Phase 12."""
    from i3rc_tpu_torch import (Domain, Integrator, IntegratorConfig, PhaseFunction,
                                PhaseFunctionTable, PhotonSource, batch_key,
                                henyey_greenstein_coefficients)
    from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component
    from i3rc_tpu_torch.kernels import event_block as eb

    oracle = _load_tests_module("disort_oracle")
    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(0.85, 64))], key=[1.0])
    slab = Domain.create([0, 500.0], [0, 500.0], np.linspace(0, 250.0, 9))
    ext = np.full((1, 1, 8), 1.0 / 250.0)
    slab = slab.add_component("cloud", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32),
                              table)
    slab = domain_with_gas_component(slab, np.full(8, 0.5 / 250.0))
    n_slab = SLAB_PHOTONS
    eb.reset_launch_counters()
    integ = Integrator.create(slab, IntegratorConfig(use_ray_tracing=False, max_events=2000,
                                                     compute_volume_absorption=False),
                              device=dev)
    res = integ.batch_fn(PhotonSource.directional(0.5, 0.0), n_slab, n_lanes=L_CHECK)(
        batch_key(SEED, 400))
    parts = [float(res.mean_flux_up), float(res.mean_flux_down),
             float(res.mean_flux_absorbed)]
    check(eb.event_block.gas_launches > 0, "the gas slab launched no gas kernel")
    r_ex, t_ex = oracle.hg_slab_fluxes(1.5, 1.0 / 1.5, 0.85, 0.5, n_legendre=64)
    sigma = (max(r_ex * (1 - r_ex), t_ex * (1 - t_ex)) / n_slab) ** 0.5
    for got, want, name in zip(parts, (r_ex, t_ex, 1.0 - r_ex - t_ex), ("Fup", "Fdn", "Fabs")):
        check(abs(got - want) <= 4 * sigma, f"gas slab {name} {got} vs oracle {want}")
    check(abs(sum(parts) - 1.0) < 1e-5, f"gas slab closure {parts}")
    check(int(res.n_bad) == 0, f"gas slab n_bad={int(res.n_bad)}")
    say("12 gas-slab-oracle", photons=n_slab, fup=f"{parts[0]:.6f}", fdn=f"{parts[1]:.6f}",
        fabs=f"{parts[2]:.6f}", oracle=f"{r_ex:.6f},{t_ex:.6f},{1 - r_ex - t_ex:.6f}",
        sigma=f"{sigma:.2e}", launches=eb.event_block.gas_launches)


def broadband_slice(dev, card: str) -> tuple[int, dict]:
    """Phase 13; returns the gas-kernel launches of the timed run and the
    record of the gas kernel's device time over one more batch of the first
    k point (after one under the profiler alone)."""
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, KDistribution, PhotonSource,
                                make_step_cloud, run_band)
    from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component
    from i3rc_tpu_torch.kernels import event_block as eb

    dom = make_step_cloud(1.0)
    z = np.asarray(dom.z_edges)
    kd = KDistribution.create(z, np.broadcast_to([[4e-4, 4e-3]], (32, 2)).copy(), [0.7, 0.3],
                              wavelength_limits=(2.6, 2.8), spectral_fraction=1.0)
    src = PhotonSource.directional(0.5, 0.0)
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                           compute_volume_absorption=False, majorant_block_size=16)
    integ = Integrator.create(domain_with_gas_component(dom, kd.absorption_profiles_on(z)[:, 0]),
                              cfg, device=dev)
    derive = lambda r: {"fup": r.mean_flux_up, "fdn": r.mean_flux_down,
                        "fabs": r.mean_flux_absorbed, "n_bad": r.n_bad}
    cache = {}
    n_batches = 2
    run = lambda seed: run_band(integ, dom, kd, src, SLICE_PHOTONS, n_batches, seed=seed,
                                derive=derive, integrator_cache=cache,
                                n_lanes=L_CHECK)
    float(run(5).mean["derived"]["fup"])          # warm-up
    torch.cuda.synchronize()
    eb.reset_launch_counters()
    t0 = time.perf_counter()
    band = run(6)
    m = {k: float(v) for k, v in band.mean["derived"].items()}
    dt = time.perf_counter() - t0
    launches = eb.event_block.gas_launches
    check(launches > 0, "the broadband slice launched no gas kernel")
    check(eb.event_block.launches == eb.event_block.detector_launches
          == eb.event_block.gas_detector_launches == 0,
          "the broadband slice launched a kernel other than the gas kernel")
    check(abs(m["fup"] + m["fdn"] + m["fabs"] - 1.0) < 1e-5, f"broadband closure {m}")
    check(m["n_bad"] == 0, f"broadband n_bad {m['n_bad']}")
    # Binomial sigma of the band mean: sqrt(sum_k w_k^2 F_k (1 - F_k) / N_k).
    n_k = SLICE_PHOTONS * n_batches
    per_k = [float(st.mean["derived"]["fup"]) for st in band.per_k]
    sigma = sum(w * w * f * (1 - f) / n_k for w, f in zip(kd.weights, per_k)) ** 0.5
    check(abs(m["fup"] - ANCHOR_BROADBAND_FUP) <= 5 * sigma + 3e-4,
          f"broadband Fup {m['fup']} vs {ANCHOR_BROADBAND_FUP} (sigma {sigma:.2e})")
    n_traced = n_k * kd.n_k
    rate = n_traced / dt
    say("13 broadband", photons=n_traced, lanes=L_CHECK, fup=f"{m['fup']:.6f}",
        fdn=f"{m['fdn']:.6f}", fabs=f"{m['fabs']:.6f}",
        fup_per_k=",".join(f"{f:.6f}" for f in per_k), anchor=ANCHOR_BROADBAND_FUP,
        sigma=f"{sigma:.2e}", seconds=f"{dt:.4f}", photons_per_s=f"{rate:.4e}",
        blocks_per_batch=f"{launches / (kd.n_k * n_batches):.1f}", launches=launches,
        card=json.dumps(card))
    from i3rc_tpu_torch import batch_key

    key = batch_key(SEED, 420)
    tracer = integ.batch_tracer(SLICE_PHOTONS, L_CHECK)
    gas_batch = lambda: tracer(key, src.sample(key, L_CHECK, dev), src)
    say("13 broadband-profile", photons=SLICE_PHOTONS, k_point=0,
        **profile_fields(profile_batch(gas_batch), 8, card))
    gas_bk = batch_kernel_time(gas_batch)
    say("13 broadband-batch-kernel", photons=SLICE_PHOTONS, k_point=0,
        **batch_fields(gas_bk, card))
    return launches, gas_bk


def broadband_driver(bb_dir: Path, card: str) -> int:
    """Phase 14; returns the gas-detector kernel launches of the driver run."""
    from i3rc_tpu_torch.kernels import event_block as eb

    (bb_dir / "examples").mkdir(parents=True, exist_ok=True)
    subprocess.run([sys.executable, str(ROOT / "examples" / "make_broadband_inputs.py"),
                    str(bb_dir / "examples")], check=True, capture_output=True)
    shutil.copy(ROOT / "examples" / "broadbandDriver.nml", bb_dir / "broadbandDriver.nml")
    bb_outputs = ("broadband_flux.out", "broadband_rad.out")
    for name in bb_outputs:
        (bb_dir / name).unlink(missing_ok=True)
    from i3rc_tpu_torch.drivers.broadband_driver import run_from_namelist as run_broadband_nml

    eb.reset_launch_counters()
    cwd = os.getcwd()
    os.chdir(bb_dir)
    try:
        t0 = time.perf_counter()
        drv = run_broadband_nml("broadbandDriver.nml", quiet=True, device="cuda")
        t_drv = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    for name in bb_outputs:
        check((bb_dir / name).is_file(), f"broadband driver did not write {name}")
    (fup, fup_e), (fdn, _), (fabs, _) = drv["mean_stats"]
    check(abs(fup + fdn + fabs - 1.0) < 1e-5, f"broadband driver closure {fup + fdn + fabs}")
    rad = drv["radiance"][0]
    check(rad.shape == (32, 1, 2) and bool((rad > 0).all()) and bool(np.isfinite(rad).all()),
          f"broadband radiance {rad.shape}")
    launches_gas_det = eb.event_block.gas_detector_launches
    check(launches_gas_det > 0, "the broadband driver launched no gas-detector kernel")
    check(eb.event_block.launches == eb.event_block.detector_launches == 0,
          "the broadband driver launched a kernel without the gas channel")
    say("14 broadband-driver", namelist="broadbandDriver.nml", bands=drv["cfg"]["num_bands"],
        photons=drv["cfg"]["num_photons"], fup=f"{fup:.5f}", stderr=f"{fup_e:.1e}",
        fdn=f"{fdn:.5f}", fabs=f"{fabs:.5f}",
        intensity=",".join(f"{float(v):.5f}" for v in rad.mean(axis=(0, 1))),
        seconds=f"{t_drv:.2f}", launches=launches_gas_det, card=json.dumps(card))
    return launches_gas_det


# ---------------------------------------------------------------------------
# The general kernel G (csrc/general_event_block.cuh): ray tracing, maximum
# cross-section and Woodcock, against its plain version and on its paths

GENERAL_PHOTONS = 1 << 24           # the step cloud through the default config
GENERAL_LANES = 1 << 20             # the default wavefront width (fastpath.DEFAULT_LANES)
LANDSAT_GENERAL_PHOTONS = 1 << 21   # bench.py:193-215's row
GENERAL_SLAB_PHOTONS = 1 << 20
# Operations per DDA step (face distances, the extinction load, the overshoot
# test, the corner guard, the wraps), per lane-event (Philox groups of the
# draws, the free path's logf, the classification), per collision (the
# component pick, the cubic inverse CDF, the rotation and its renormalization:
# two square roots, a reciprocal, an rsqrt, and the acceptance's division).
OPS_PER_GSTEP = (45, 0)
OPS_PER_GEVENT = (260, 2)
OPS_PER_GCOLLISION = (120, 6)
GSTATE_ROWS = 15                    # x, y, z, ux, uy, uz, w; alive, ix, iy, iz, order, bad, evct, xing


def general_bound(steps: int, lane_events: int, collisions: int, n_bytes: int, rays: int = 0):
    """(least ms, what bounds it) of general-kernel work: DDA steps (the
    estimate's rays' included), lane-events, collisions, the estimate's
    rays (collision x detector; OPS_PER_GRAY) and ``n_bytes`` of device
    memory."""
    alu = steps * OPS_PER_GSTEP[0] + lane_events * OPS_PER_GEVENT[0] \
        + collisions * OPS_PER_GCOLLISION[0] + rays * OPS_PER_GRAY[0]
    sfu = steps * OPS_PER_GSTEP[1] + lane_events * OPS_PER_GEVENT[1] \
        + collisions * OPS_PER_GCOLLISION[1] + rays * OPS_PER_GRAY[1]
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(alu / FP32_OPS_PER_S, sfu / SFU_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def general_table_bytes(integ, tracer) -> int:
    """The optics and tables one block reads at least once: the extinction,
    the packed rows (general optics), the majorants, the cubic table."""
    opt, spec = integ.device_optics, tracer.spec
    n = opt.total_ext.numel() * 4 + opt.block_majorant.numel() * 4
    if not opt.uniform:
        n += opt.cell_matrix.numel() * 4
    n += integ.tables.inverse_cubic.numel() * 4
    return n + 2 * 8 * 3 * spec.geom.n_x * spec.geom.n_y


def ptxas_general(log: str) -> dict:
    """Per general-kernel instantiation (mode, uniform, reflecting, weight-1,
    detectors): registers, stack and spill bytes and CTAs per SM, from
    ptxas -v.  ptxas prints a kernel's own "Function properties" (its stack
    frame and spills) right after "Compiling entry function", then its
    registers, then the properties of the noinline functions it calls; only
    the kernel's own are read."""
    out, name, own = {}, None, False
    modes = {"0": "rt", "1": "maxcs", "2": "woodcock"}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*general_event_block_kernelILi(\d)"
                      r"ELb(\d)ELb(\d)ELb(\d)ELb(\d)E", line)
        if m:
            name = (modes[m[1]] + ("_uniform" if m[2] == "1" else "_general")
                    + ("_reflecting" if m[3] == "1" else "") + ("_weight1" if m[4] == "1" else "")
                    + ("_det" if m[5] == "1" else ""))
            out[name], own = {}, False
        elif "Compiling entry function" in line:
            name = None
        elif name and "Function properties for" in line:
            own = "general_event_block_kernel" in line
        elif name and own and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                                              r"stores", line)):
            out[name].update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name].update(registers=int(m[1]), ctas_per_sm=ctas_per_sm(int(m[1])))
    return out


def general_instantiation(spec, var) -> str:
    """The kernel instantiation a (spec, variant) launches, named as
    ptxas_general names it."""
    return ({0: "rt", 1: "maxcs", 2: "woodcock"}[spec.mode]
            + ("_uniform" if var.uniform else "_general")
            + ("_reflecting" if spec.surface_kind else "") + ("_weight1" if var.bernoulli else "")
            + ("_det" if spec.det is not None else ""))


def two_component_domain():
    """A seeded random 3-D field of two components: an HG cloud and a
    tabulated non-HG (Rayleigh-like) component, ssa < 1, irregular x and z
    (faces and cells from the edge arrays)."""
    from i3rc_tpu_torch import (Domain, PhaseFunction, PhaseFunctionTable,
                                henyey_greenstein_coefficients)

    rng = np.random.default_rng(5)
    nx, ny, nz = 12, 10, 14
    ext1 = rng.uniform(0.0, 0.08, (nx, ny, nz)) * (rng.uniform(size=(nx, ny, nz)) > 0.3)
    ext2 = rng.uniform(0.002, 0.02, (nx, ny, nz))
    hg = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(g, 64))
         for g in (0.85, 0.6)], key=[1.0, 2.0])
    ang = np.linspace(0.0, np.pi, 181)
    ray = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_tabulated(ang, 0.75 * (1 + np.cos(ang) ** 2))], key=[0.0])
    z = np.concatenate([[0.0], np.cumsum(rng.uniform(10.0, 30.0, nz))])
    x = np.concatenate([[0.0], np.cumsum(rng.uniform(30.0, 70.0, nx))])
    dom = Domain.create(x, np.linspace(0, 500.0, ny + 1), z)
    check(not dom.xy_regularly_spaced and not dom.z_regularly_spaced, "irregular grid")
    dom = dom.add_component("cloud", ext1, rng.uniform(0.95, 1.0, ext1.shape),
                            rng.integers(0, 2, ext1.shape).astype(np.int32), hg)
    return dom.add_component("haze", ext2, np.full(ext2.shape, 0.9),
                             np.zeros(ext2.shape, np.int32), ray)


# The closed forms of phase 29 (tests/general_oracles.py): a slab over a
# Lambertian albedo, two components in the same cells over black and over
# the albedo, a gridded RPV surface under a transparent atmosphere.
ORACLE_ALBEDO = 0.6
ORACLE_MODES = {"rt": dict(use_ray_tracing=True), "maxcs": dict(use_ray_tracing=False),
                "woodcock": dict(use_ray_tracing=False, majorant_block_size=16)}


def traced_band(dev):
    """Phase 31's band: band 0 of examples/broadbandDriver.nml's inputs
    (examples/make_broadband_inputs.py: k = 2e-4, 2e-3, weights 0.8, 0.2)
    over the step cloud, flux only.  Returns (cloud domain, k-distribution,
    the integrator of k point 0, the device optics of k point 1)."""
    from i3rc_tpu_torch import Integrator, IntegratorConfig, KDistribution, make_step_cloud
    from i3rc_tpu_torch.core.optics import flatten_optics
    from i3rc_tpu_torch.integrators.integrator import device_optics_from_flat
    from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component

    dom = make_step_cloud(1.0)
    z = np.asarray(dom.z_edges)
    kd = KDistribution.create(z, np.broadcast_to([[2e-4, 2e-3]], (32, 2)).copy(), [0.8, 0.2],
                              wavelength_limits=(0.5, 0.7), spectral_fraction=0.9)
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                           compute_volume_absorption=False, majorant_block_size=16)
    profiles = kd.absorption_profiles_on(z)
    integ = Integrator.create(domain_with_gas_component(dom, profiles[:, 0]), cfg, device=dev)
    optics_k1 = device_optics_from_flat(
        flatten_optics(domain_with_gas_component(dom, profiles[:, 1])),
        cfg.majorant_block_size, dev)
    return dom, kd, integ, optics_k1


def general_scene(name: str, dev) -> SimpleNamespace:
    """(integ, src, n, lanes, optics) of one general-kernel scene: the rows
    of phase 26, which include every scene that phases 27-31 drive, built
    here for both (``optics``: an override of the integrator's optics)."""
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource,
                                SurfaceDescription, make_landsat_cloud, make_step_cloud)

    oracles = _load_tests_module("general_oracles")
    port = oracles.host("i3rc_tpu_torch")
    src = PhotonSource.directional(0.5, 0.0)
    L = L_CHECK
    scene = lambda integ, n, lanes, src=src, optics=None: SimpleNamespace(
        integ=integ, src=src, n=n, lanes=lanes, optics=optics)
    mode = name.split("_")[0]
    if name == "rt_step_cloud":
        # phases 27 and 30: the default configuration (ray tracing)
        return scene(Integrator.create(make_step_cloud(1.0), device=dev), 4 * GENERAL_LANES,
                     GENERAL_LANES)
    if name.endswith("two_comp"):
        cfg = IntegratorConfig(use_ray_tracing=mode == "rt", use_fastpath=False, max_events=500,
                               majorant_block_size=2 if mode == "woodcock" else 0)
        return scene(Integrator.create(two_component_domain(), cfg, device=dev), 4 * L, L)
    if name == "maxcs_albedo":
        cfg = IntegratorConfig(use_ray_tracing=False, use_fastpath=False, max_events=500,
                               compute_volume_absorption=False)
        return scene(Integrator.create(make_step_cloud(0.99), cfg, surface_albedo=0.2,
                                       device=dev), 4 * L, L)
    if name == "rt_rpv_grid":
        params = np.array([[[0.1, 0.8, -0.1], [0.3, 0.7, 0.1]],
                           [[0.2, 0.9, 0.0], [0.05, 0.6, -0.2]]], np.float32)
        srf = SurfaceDescription.create(params, [0.0, 250.0, 500.0], [0.0, 0.5, 1.0],
                                        brdf_name="rpv")
        return scene(Integrator.create(make_step_cloud(1.0), IntegratorConfig(max_events=500),
                                       surface=srf, device=dev), 4 * L, L)
    if name == "woodcock_weight1":
        cfg = IntegratorConfig(use_ray_tracing=False, use_fastpath=False, max_events=500,
                               compute_volume_absorption=False, majorant_block_size=8)
        return scene(Integrator.create(make_landsat_cloud(0.99), cfg, device=dev), 4 * L, L)
    if name == "woodcock_landsat":
        # phase 28: bench.py:193-215's row (fastpath off, 2^21 photons);
        # block majorants on 8-cell super-voxels by the create-time rule
        cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                               compute_volume_absorption=False, use_fastpath=False)
        n = LANDSAT_GENERAL_PHOTONS
        return scene(Integrator.create(make_landsat_cloud(1.0), cfg, device=dev), n,
                     min(n, GENERAL_LANES))
    n = GENERAL_SLAB_PHOTONS
    if name == "maxcs_beer_lambert":
        # phase 29: bench.py:396-420's ssa 0 slab
        cfg = IntegratorConfig(use_ray_tracing=False, max_events=100)
        return scene(Integrator.create(oracles.hg_slab(port, 1.0, 0.0), cfg, device=dev), n, n,
                     src=PhotonSource.directional(0.8, 0.0))
    if name in ("rt_slab", "woodcock_slab"):
        # phase 29: the slab oracle, conservative tau 1 in ray tracing, tau 2
        # at ssa 0.99 on 16-cell super-voxels
        tau, ssa = (1.0, 1.0) if mode == "rt" else (2.0, 0.99)
        cfg = IntegratorConfig(max_events=2000, compute_volume_absorption=False,
                               use_fastpath=False, **ORACLE_MODES[mode])
        return scene(Integrator.create(oracles.hg_slab(port, tau, ssa, 1), cfg,
                                       device=dev), n, n)
    cfg = IntegratorConfig(max_events=2000, compute_volume_absorption=False,
                           use_fastpath=False, **ORACLE_MODES[mode])
    if name == "woodcock_albedo_slab":
        return scene(Integrator.create(oracles.hg_slab(port, 1.0, 0.9), cfg,
                                       surface_albedo=ORACLE_ALBEDO, device=dev), n, n)
    if name.endswith(("_mixture", "_mixture_albedo")):
        albedo = ORACLE_ALBEDO if name.endswith("albedo") else 0.0
        return scene(Integrator.create(oracles.mixture_slab(port)[0], cfg, surface_albedo=albedo,
                                       device=dev), n, n)
    if name == "maxcs_rpv_clear":
        dom, srf = oracles.clear_sky(port)
        return scene(Integrator.create(dom, cfg, surface=srf, device=dev), n, n)
    if name == "woodcock_band_k1":
        # phase 31: the traced band's second k point, through the optics
        # override
        _, _, integ, optics_k1 = traced_band(dev)
        return scene(integ, 1 << 22, GENERAL_LANES, optics=optics_k1)
    raise ValueError(name)


# Phase 26's rows and the instantiation each launches: the scenes of
# phases 27-31 and the oracle scenes, together every instantiation.
GENERAL_ROWS = {
    "rt_step_cloud": "rt_uniform", "maxcs_two_comp": "maxcs_general",
    "woodcock_two_comp": "woodcock_general", "rt_two_comp": "rt_general",
    "maxcs_albedo": "maxcs_uniform_reflecting", "rt_rpv_grid": "rt_uniform_reflecting",
    "woodcock_weight1": "woodcock_uniform_weight1",
    "woodcock_landsat": "woodcock_uniform_weight1", "maxcs_beer_lambert": "maxcs_uniform",
    "rt_slab": "rt_uniform", "woodcock_slab": "woodcock_uniform",
    "woodcock_albedo_slab": "woodcock_uniform_reflecting", "rt_mixture": "rt_general",
    "rt_mixture_albedo": "rt_general_reflecting",
    "maxcs_mixture_albedo": "maxcs_general_reflecting",
    "woodcock_mixture_albedo": "woodcock_general_reflecting",
    "maxcs_rpv_clear": "maxcs_general_reflecting", "woodcock_band_k1": "woodcock_general"}


# Phase 26's rows whose mid-flight and tail blocks are timed and censused
# (the paths of phases 27 and 28), and the row of each transport mode whose
# mid-flight state gives the sparse states.
GENERAL_TIMED = ("rt_step_cloud", "woodcock_landsat")
GENERAL_SPARSE = ("rt_step_cloud", "maxcs_two_comp", "woodcock_landsat")
# Live lanes of a sparse state's tiles of 256 lanes, tile c taking entry
# c % 7; the last tile, 156 lanes, is partial.
SPARSE_LIVE = (0, 1, 31, 32, 33, 256, 97)
SPARSE_CUT = 100


def sparse_state(spec, mid, launch, launched: int, kb: int, seed: int):
    """(state, buffers) built by hand from a mid-flight state ``mid``: its
    first L - SPARSE_CUT lanes, tile c with SPARSE_LIVE[c % 7] live lanes at
    seeded random slots (at most the tile's lanes), a slot made live whose
    lane is dead in ``mid`` taking its photon from the launch state
    ``launch``; ``launched`` photons launched at entry of block ``kb``."""
    from i3rc_tpu_torch.kernels import general_block as gb

    L = mid.n_lanes - SPARSE_CUT
    rng = np.random.default_rng(seed)
    live = np.zeros(L, bool)
    for c in range(-(-L // gb.CTA_THREADS)):
        lo, hi = c * gb.CTA_THREADS, min(L, (c + 1) * gb.CTA_THREADS)
        k = min(SPARSE_LIVE[c % len(SPARSE_LIVE)], hi - lo)
        live[lo + rng.choice(hi - lo, k, replace=False)] = True
    live_t = torch.as_tensor(live, device=mid.f.device)
    f, i = mid.f[:, :L].clone(), mid.i[:, :L].clone()
    fresh = live_t & (i[gb.ALIVE] == 0)
    f[:, fresh] = launch.f[:, :L][:, fresh]
    for r in (gb.IX, gb.IY, gb.IZ, gb.ORDER):
        i[r] = torch.where(fresh, launch.i[r, :L], i[r])
    i[gb.ALIVE] = live_t.to(torch.int32)
    st = gb.GeneralState(f.contiguous(), i.contiguous())
    return st, gb.general_buffers(spec, st, launched, kb)


def census_fields(spec, opt, rec: dict) -> dict:
    """say() fields of the warp census of one recorded block: the identity
    order of the first design, the compaction per tile, the grouped order
    and, on a block under half alive, the compaction over the kernel's
    tiles (kernels/general_block.py census_orders)."""
    from i3rc_tpu_torch.kernels import general_block as gb

    out = {}
    for order, c in gb.census_orders(spec, opt, rec, buckets=(gb.KEY_BUCKETS,)).items():
        out[f"census_{order}"] = (f"trips={c['trips']},warp_steps={c['warp_steps']},"
                                  f"dda_eff={c['dda_efficiency']:.4f},"
                                  f"event_eff={c['event_efficiency']:.4f},"
                                  f"sparse={c['sparse_share']:.4f}")
    return out


def general_kernel_vs_twin(dev, card: str, built: dict) -> tuple[dict, float]:
    """Phase 26: one block of G against general_block_reference on the
    launch state (every lane alive, the first block), a mid-flight state
    (refills running; rows of more photons than lanes) and a tail state
    (budget spent, at most 15% of lanes alive) of every row of
    GENERAL_ROWS, at the photons and lanes its path runs, and on two sparse
    states per transport mode (``sparse_state``: tiles of 0 to 256 live
    lanes and a partial last tile, with the budget spent and with 300
    photons left): the lane state, the control state and the dead counts
    bit for bit, the float64 tallies within 1e-9 of their largest entry.
    Every instantiation of ``built`` is a row's.  The mid-flight and tail
    blocks of the GENERAL_TIMED rows are timed (profiler device time, CUDA
    events; the twin by CUDA events) and their warp census printed.
    Returns ({"<row> <state>": timing}, the largest tally difference)."""
    from i3rc_tpu_torch import batch_key
    from i3rc_tpu_torch.kernels import general_block as gb

    flux_built = {k for k in built if not k.endswith("_det")}
    check(set(GENERAL_ROWS.values()) == flux_built,
          f"rows miss instantiations {sorted(flux_built - set(GENERAL_ROWS.values()))}")
    timed, worst = {}, 0.0
    for row, (name, inst) in enumerate(GENERAL_ROWS.items()):
        sc = general_scene(name, dev)
        integ, src, n, L = sc.integ, sc.src, sc.n, sc.lanes
        tracer = integ.general_tracer(n, L)
        spec, tables = tracer.spec, integ.tables
        opt = integ.device_optics if sc.optics is None else sc.optics
        var = gb.variant(spec, opt)
        check(general_instantiation(spec, var) == inst,
              f"{name}: launches {general_instantiation(spec, var)}, not {inst}")
        key = batch_key(SEED, 600 + row)
        st = gb.launch_state(spec, src.sample(key, L, dev), n)
        buf = gb.general_buffers(spec, st, min(L, n))
        kb = 0

        def advance():
            nonlocal kb
            gb.general_block(spec, var, opt, tables, st, buf, key, src, kb)
            kb += 1

        states = [("first", st.clone(), buf.clone(), kb)]
        advance()
        if n > L:
            states.append(("mid", st.clone(), buf.clone(), kb))
            if name in GENERAL_SPARSE:
                for tag, left in (("sparse", 0), ("sparse_refill", 300)):
                    states.append((tag, *sparse_state(spec, states[1][1], states[0][1],
                                                      n - left, kb, 610 + row), kb))
        while not (int(buf.ctl[kb & 1]) >= n
                   and float(st.i[gb.ALIVE].float().mean()) <= 0.15):
            check(kb < 600, f"{name}: the tail state never came")
            advance()
        states.append(("tail", st.clone(), buf.clone(), kb))
        for state, s0, b0, kb_s in states:
            sk, bk, sr, br = s0.clone(), b0.clone(), s0.clone(), b0.clone()
            gb.general_block(spec, var, opt, tables, sk, bk, key, src, kb_s)
            t0 = time.perf_counter()
            gb.general_block_reference(spec, var, opt, tables, sr, br, key, src, kb_s)
            torch.cuda.synchronize()
            twin_s = time.perf_counter() - t0
            scale = max(float(br.columns.abs().max()), 1.0)
            err = float((bk.columns - br.columns).abs().max()) / scale
            if spec.vol:
                err = max(err, float((bk.vol - br.vol).abs().max())
                          / max(float(br.vol.abs().max()), 1.0))
            bit = (torch.equal(sk.f, sr.f) and torch.equal(sk.i, sr.i)
                   and torch.equal(bk.ctl, br.ctl) and torch.equal(bk.dead, br.dead))
            n_diff = int(((sk.f != sr.f).any(0) | (sk.i != sr.i).any(0)).sum())
            check(bit and err <= 1e-9,
                  f"G {name} {state}: kernel and twin differ on {n_diff} lanes, tallies {err:.2e}"
                  f" ctl {bk.ctl.tolist()} {br.ctl.tolist()}")
            worst = max(worst, err)
            live = int(s0.i[gb.ALIVE].sum())
            d = lambda r: int((sr.i[r] - s0.i[r]).sum())
            steps, events = d(gb.XING), d(gb.EVCT)
            # Collisions: every lane-event that did not end its photon.
            taken = int(br.ctl[(kb_s + 1) & 1] - b0.ctl[kb_s & 1])
            ended = live + taken - int(sr.i[gb.ALIVE].sum())
            n_bytes = 8 * s0.n_lanes + (live + taken) * 2 * GSTATE_ROWS * 4 \
                + general_table_bytes(integ, tracer)
            bound = general_bound(steps, events, max(events - ended, 0), n_bytes)
            fields = dict(scene=name, instantiation=inst, state=state, photons=n,
                          lanes=s0.n_lanes, alive=f"{live / s0.n_lanes:.4f}",
                          n_draws=var.n_draws, bit_equal=bit, tally_rel_err=f"{err:.2e}",
                          lane_events=events, dda_steps=steps, twin_ms=f"{1e3 * twin_s:.3f}",
                          bound_ms=f"{bound[0]:.4f}", bound_by=bound[1])
            if name in GENERAL_TIMED and state in ("mid", "tail"):
                run = lambda s, b: gb.general_block(spec, var, opt, tables, s, b, key, src, kb_s)
                new = lambda: (s0.clone(), b0.clone())
                ms = general_block_ms(run, new, 10)
                fields.update(kernel_ms=f"{ms[0]:.4f}", kernel_device_ms=f"{ms[1]:.4f}")
                timed[f"{name} {state}"] = {"device_ms": ms[1], "events_ms": ms[0],
                                            "twin_ms": 1e3 * twin_s, "bound": bound}
                rec = {}
                gb.general_block_reference(spec, var, opt, tables, s0.clone(), b0.clone(), key,
                                           src, kb_s, record=rec)
                fields.update(census_fields(spec, opt, rec))
            say("26 general-kernel-vs-twin", **fields, card=json.dumps(card))
    return timed, worst


def general_block_ms(run, new, n: int) -> tuple[float, float]:
    """(CUDA-event ms, profiler device ms) of one G launch, mean of n on fresh
    copies made by ``new``."""
    total = 0.0
    for k in range(n + 1):
        s, b = new()
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run(s, b)
        e.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(e) if k else 0.0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    # The profiler now and then drops a trace's device records (as in
    # device_block_ms): the mean over the launches shown, from a trace that
    # shows half of them.
    for _ in range(3):
        copies = [new() for _ in range(n)]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for s, b in copies:
                run(s, b)
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if "general_event_block_kernel" in e.key]
        launches = sum(e.count for e in found)
        if 2 * launches >= n:
            break
    check(0 < launches <= n, f"the profiler shows {launches} G launches for {n}")
    return total / n, sum(e.self_device_time_total for e in found) / launches / 1e3


def general_batch_record(integ, src, n: int, lanes: int, seed: int, card: str, tag: str,
                         profile: bool = True, optics=None) -> dict:
    """One more batch of a general path: its device kernels under the
    profiler (G's time summed over the batch, launches, idle share) and the
    bound of the batch's work (DDA steps, lane-events, collisions counted
    from the batch's tallies).  ``optics``: the batch runs those optics
    through the general kernel (the traced spectral mode)."""
    from i3rc_tpu_torch import batch_key

    key = batch_key(SEED, seed)
    tracer = integ.general_tracer(n, lanes)
    run_batch = lambda: (tracer(key, src.sample(key, lanes, "cuda"), src) if optics is None
                         else tracer(key, src.sample(key, lanes, "cuda"), src, optics))
    pb = profile_batch(run_batch, "general_event_block_kernel") if profile else None
    if pb is None:
        raw = run_batch()
        torch.cuda.synchronize()
    else:
        raw = pb["raw"]
    steps = int(raw.n_dda_steps)
    events = int(raw.n_lane_events)
    launches = raw.n_iterations // tracer.spec.K
    n_bytes = n * 2 * GSTATE_ROWS * 4 + 8 * lanes * launches
    # With detectors: the estimate's DDA steps and rays (D per physical
    # collision and estimating surface event, counted per lane), the two
    # per-lane counters and the radiance tallies.
    det = tracer.spec.det
    int_steps = int(raw.n_int_steps) if det is not None else 0
    rays = int(raw.n_int_rays) if det is not None else 0
    if det is not None:
        n_bytes += 16 * lanes * launches + 16 * raw.intensity.numel()
    bound = general_bound(steps + int_steps, events, max(events - n, 0), n_bytes, rays)
    rec = {"bound": bound, "launches": launches, "raw": raw, "steps": steps, "events": events,
           "int_steps": int_steps, "rays": rays}
    fields = dict(photons=n, lanes=lanes, blocks=launches, lane_events=events, dda_steps=steps,
                  estimate_steps=int_steps, estimate_rays=rays, bound_ms=f"{bound[0]:.3f}", bound_by=bound[1])
    if pb is not None:
        rec.update(kernel_ms=pb["block_ms"], idle=pb["idle_share"])
        fields.update(block_launches=pb["block_launches"],
                      kernel_ms_per_batch=f"{pb['block_ms']:.3f}",
                      kernel_ms_per_block=f"{pb['block_ms'] / max(pb['block_launches'], 1):.4f}",
                      host_ms=f"{pb['wall_ms']:.3f}", device_kernels=pb["kernels"],
                      device_idle_share=f"{pb['idle_share']:.4f}",
                      loop_device_idle_share=f"{pb['loop_idle_share']:.4f}")
    say(f"{tag}-batch", **fields, card=json.dumps(card))
    return rec


def timed_general_batches(fn, n: int, seed0: int, n_batches: int, closure: bool = True,
                          bad_max: int = 0):
    """Batches of a general path: their Results, host seconds, each gated on
    finite fields, n_bad and (``closure``: conservative) Fup + Fdn = 1."""
    out, times = [], []
    for b in range(n_batches):
        t0 = time.perf_counter()
        res = fn(batch_key_(seed0 + b))
        fup, fdn, n_bad = float(res.mean_flux_up), float(res.mean_flux_down), int(res.n_bad)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(all(bool(torch.isfinite(t).all()) for t in (res.flux_up, res.flux_down,
                                                          res.flux_absorbed)),
              "general path: non-finite fluxes")
        if closure:
            # A bad photon leaves the budget unclosed by its weight (1).
            check(abs(fup + fdn - 1.0) < 1e-5 + n_bad / n, f"general closure Fup+Fdn={fup + fdn}")
        check(n_bad <= bad_max, f"general n_bad={n_bad} (limit {bad_max})")
        out.append(res)
    return out, times


def batch_key_(b: int):
    from i3rc_tpu_torch import batch_key

    return batch_key(SEED, b)


def general_oracle_checks() -> list[str]:
    """Phase 29's closed forms (tests/general_oracles.py), 8 batches of
    GENERAL_SLAB_PHOTONS each: a slab over a Lambertian albedo (Woodcock),
    two components in the same cells over black (ray tracing) and over the
    albedo (every mode), each flux within 4 standard errors of the batch
    means; then one batch of the gridded RPV surface under a clear sky
    (maximum cross-section, whose exits come from a 1e30 m jump there): Fup
    within 5 sigma of the closed form, sigma from its per-photon variance,
    and Fdn = 1.  Returns the result fields."""
    from i3rc_tpu_torch.core.surface import rpv_brdf

    oracles = _load_tests_module("general_oracles")
    _, (ext, omega, chi) = oracles.mixture_slab(oracles.host("i3rc_tpu_torch"))
    out = []
    for row, name in enumerate(("woodcock_albedo_slab", "rt_mixture", "rt_mixture_albedo",
                                "maxcs_mixture_albedo", "woodcock_mixture_albedo")):
        sc = general_scene(name, "cuda")
        albedo = ORACLE_ALBEDO if "albedo" in name else 0.0
        r, d = (oracles.slab_over_albedo(1.0, 0.9, oracles.HG_CHI, 0.5, albedo)
                if name == "woodcock_albedo_slab"
                else oracles.slab_over_albedo(ext, omega, chi, 0.5, albedo))
        expect = (r, d, 1.0 - r - (1.0 - albedo) * d)
        fn = sc.integ.batch_fn(sc.src, sc.n)
        vals = []
        for b in range(8):
            res = fn(batch_key_(770 + 10 * row + b))
            check(int(res.n_bad) <= 1e-3 * sc.n, f"{name} n_bad {int(res.n_bad)}")
            vals.append([float(res.mean_flux_up), float(res.mean_flux_down),
                         float(res.mean_flux_absorbed)])
        vals = np.array(vals)
        se = vals.std(axis=0, ddof=1) / 8 ** 0.5
        for k, what in enumerate(("Fup", "Fdn", "Fabs")):
            check(abs(vals[:, k].mean() - expect[k]) <= 4 * se[k],
                  f"{name} {what} {vals[:, k].mean()} vs {expect[k]} (se {se[k]:.2e})")
        out.append(f"{name}=" + ",".join(f"{v:.6f}" for v in vals.mean(0)) + "/"
                   + ",".join(f"{v:.6f}" for v in expect) + "(se "
                   + ",".join(f"{v:.1e}" for v in se) + ")")
    sc = general_scene("maxcs_rpv_clear", "cuda")
    mean, var = oracles.clear_sky_brdf(rpv_brdf, oracles.RPV_PARAMS, oracles.RPV_X,
                                       oracles.RPV_Y, -0.5, 0.0)
    res = sc.integ.batch_fn(sc.src, sc.n)(batch_key_(790))
    sigma = (var / sc.n) ** 0.5
    fup, fdn = float(res.mean_flux_up), float(res.mean_flux_down)
    check(abs(fup - mean) <= 5 * sigma and abs(fdn - 1.0) <= 1e-9,
          f"clear-sky RPV Fup {fup} vs {mean} (sigma {sigma:.2e}), Fdn {fdn}")
    return out + [f"maxcs_rpv_clear={fup:.6f}/{mean:.6f}(sigma {sigma:.1e})"]


def general_paths(out: Path, card: str) -> dict:
    """Phases 27-31: the general kernel's paths, each driven with the launch
    counts set to 0 just before it and read just after.  Returns the
    launches and the batch record of the step-cloud path."""
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, make_landsat_cloud,
                                run_band)
    from i3rc_tpu_torch.drivers.monte_carlo_driver import run_from_namelist
    from i3rc_tpu_torch.kernels import event_block as eb
    from i3rc_tpu_torch.kernels import general_block as gb

    src = PhotonSource.directional(0.5, 0.0)
    rec = {}

    # 27. the step cloud through the default config (ray tracing), 2^24
    # photons at the default width, median of 3 after a warm-up
    integ = general_scene("rt_step_cloud", "cuda").integ
    check(integ._fast_plan is None and integ.config.use_ray_tracing, "default config")
    fn = integ.batch_fn(src, GENERAL_PHOTONS)
    fn(batch_key_(700))
    torch.cuda.synchronize()
    gb.reset_launch_counters()
    eb.reset_launch_counters()
    # Ray tracing loses ~4e-5 of its photons to a non-positive DDA step (a
    # collision point that rounds onto a face), as the JAX package does
    # (4.2e-5 on the CPU): the reference's rule, counted in n_bad.
    res, times = timed_general_batches(fn, GENERAL_PHOTONS, 701, 3,
                                       bad_max=int(1e-3 * GENERAL_PHOTONS))
    launches = gb.general_block.launches
    check(launches > 0 and gb.general_block.mode_launches["ray_tracing"] == launches,
          f"the step cloud ran {gb.general_block.mode_launches}")
    check(eb.event_block.launches == 0, "the general path launched the fast kernel")
    fup = sum(float(r.mean_flux_up) for r in res) / 3
    sigma = (ANCHOR_FUP * (1 - ANCHOR_FUP) / (3 * GENERAL_PHOTONS)) ** 0.5
    check(abs(fup - ANCHOR_FUP) <= max(5 * sigma, 1e-3), f"general step-cloud Fup {fup}")
    t = sorted(times)[1]
    say("27 general-step-cloud", photons=GENERAL_PHOTONS, lanes=GENERAL_LANES, mode="ray_tracing",
        fup=f"{fup:.6f}", anchor=ANCHOR_FUP, sigma=f"{sigma:.2e}",
        n_bad=",".join(str(int(r.n_bad)) for r in res),
        seconds=",".join(f"{x:.4f}" for x in times), photons_per_s=f"{GENERAL_PHOTONS / t:.4e}",
        launches=launches, blocks_per_batch=f"{launches / 3:.1f}", card=json.dumps(card))
    rec["step_cloud"] = general_batch_record(integ, src, GENERAL_PHOTONS, GENERAL_LANES, 710,
                                             card, "27 general-step-cloud")
    rec["launches"] = launches

    # 28. Landsat through the general kernel (bench.py:193-215: fastpath off,
    # 2^21 photons): Woodcock on 8-cell super-voxels, the weight-1 class;
    # against the port's own Landsat fastpath on the card
    sc = general_scene("woodcock_landsat", "cuda")
    integ, n = sc.integ, sc.n
    check(integ.config.majorant_block_size == 8, "Landsat block majorants")
    fn = integ.batch_fn(src, n)
    fn(batch_key_(720))
    torch.cuda.synchronize()
    gb.reset_launch_counters()
    res, times = timed_general_batches(fn, n, 721, 4, bad_max=int(1e-3 * n))
    launches = gb.general_block.launches
    check(launches > 0 and gb.general_block.mode_launches["woodcock"] == launches,
          f"Landsat general ran {gb.general_block.mode_launches}")
    fups = np.array([float(r.mean_flux_up) for r in res])
    fast_cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                                compute_volume_absorption=False)
    fast_fn = Integrator.create(make_landsat_cloud(1.0), fast_cfg, device="cuda").batch_fn(
        src, n, n_lanes=L_CHECK)
    fast = np.array([float(fast_fn(batch_key_(730 + b)).mean_flux_up) for b in range(4)])
    se = (fups.var(ddof=1) / 4 + fast.var(ddof=1) / 4) ** 0.5
    check(abs(fups.mean() - fast.mean()) <= 5 * se,
          f"Landsat general Fup {fups.mean()} vs fastpath {fast.mean()} (se {se:.2e})")
    t = sorted(times)[1]
    say("28 general-landsat", photons=n, lanes=sc.lanes, mode="woodcock",
        weight1=True, fup=f"{fups.mean():.6f}", fastpath_fup=f"{fast.mean():.6f}",
        combined_se=f"{se:.2e}", n_bad=",".join(str(int(r.n_bad)) for r in res),
        seconds=",".join(f"{x:.4f}" for x in times), photons_per_s=f"{n / t:.4e}",
        launches=launches, blocks_per_batch=f"{launches / 4:.1f}", card=json.dumps(card))
    rec["landsat"] = general_batch_record(integ, src, n, sc.lanes, 740, card,
                                          "28 general-landsat")

    # 29. Beer-Lambert through the general kernel (bench.py:396-420: an
    # ssa 0 slab, maximum cross-section), the slab oracle in ray tracing
    # (conservative, tau 1) and on 16-cell super-voxels (tau 2, ssa 0.99),
    # then the closed forms of tests/general_oracles.py
    oracle = _load_tests_module("disort_oracle")
    gb.reset_launch_counters()
    sc = general_scene("maxcs_beer_lambert", "cuda")
    r = sc.integ.batch_fn(sc.src, sc.n)(batch_key_(750))
    n = sc.n
    expect = float(np.exp(-1.0 / 0.8))
    sig = (expect * (1 - expect) / n) ** 0.5
    check(abs(float(r.mean_flux_down) - expect) <= 5 * sig,
          f"Beer-Lambert Fdn {float(r.mean_flux_down)} vs {expect}")
    slab_out = [f"beer_lambert={float(r.mean_flux_down):.6f}/{expect:.6f}"]
    for name, tau, ssa in (("rt_slab", 1.0, 1.0), ("woodcock_slab", 2.0, 0.99)):
        sc = general_scene(name, "cuda")
        r = sc.integ.batch_fn(sc.src, n)(batch_key_(751))
        r_ex, t_ex = oracle.hg_slab_fluxes(tau, ssa, 0.85, 0.5, n_legendre=64)
        sig = (max(r_ex * (1 - r_ex), t_ex * (1 - t_ex)) / n) ** 0.5
        got = (float(r.mean_flux_up), float(r.mean_flux_down), float(r.mean_flux_absorbed))
        for g_, w_, what in zip(got, (r_ex, t_ex, 1 - r_ex - t_ex), ("Fup", "Fdn", "Fabs")):
            check(abs(g_ - w_) <= 4 * sig, f"slab tau={tau} ssa={ssa} {what} {g_} vs {w_}")
        check(int(r.n_bad) <= 1e-3 * n, f"slab n_bad {int(r.n_bad)}")
        slab_out.append(f"tau{tau}_ssa{ssa}={got[0]:.6f},{got[1]:.6f},{got[2]:.6f}/"
                        f"{r_ex:.6f},{t_ex:.6f},{1 - r_ex - t_ex:.6f}")
    slab_sc = sc
    slab_out += general_oracle_checks()
    modes = gb.general_block.mode_launches
    check(min(modes.values()) > 0, f"the slabs ran {modes}")
    say("29 general-slabs", photons=n, results=";".join(slab_out), launches=json.dumps(modes))
    general_batch_record(slab_sc.integ, src, n, slab_sc.lanes, 752, card,
                         "29 general-slab-woodcock")

    # 30. the step-cloud flux namelist with useRayTracing = .true. through the driver
    nml = out / "stepcloud_raytracing.nml"
    nml.write_text(textwrap.dedent(f"""
    &radiativeTransfer
      solarFlux = 1., solarMu = 0.5, solarAzimuth = 0., surfaceAlbedo = 0.
    /
    &monteCarlo
      numPhotonsPerBatch = {1 << 20}, numBatches = 8, iseed = 10
    /
    &algorithms
      useRayTracing = .true.
    /
    &fileNames
      domainFileName = "{out}/StepCloud_NonAbsorbing.opt",
      outputFluxFile = "{out}/stepCloudRTFluxes.out",
      outputAbsProfFile = "{out}/stepCloudRTAbsorption.out",
      outputNetcdfFile = "{out}/stepCloudRTOutput.nc"
    /
    &output
      reportAbsorptionProfile = .true.
    /
    """))
    gb.reset_launch_counters()
    t0 = time.perf_counter()
    drv = run_from_namelist(str(nml), quiet=True, device="cuda")
    t_drv = time.perf_counter() - t0
    m, e = drv["mean_stats"][0]
    check(abs(m - ANCHOR_FUP) <= 5 * e + 1e-3, f"ray-tracing driver Fup {m} +- {e}")
    check(gb.general_block.mode_launches["ray_tracing"] > 0, "the driver ran no G kernel")
    nc = out / "stepCloudRTOutput.nc"
    check(nc.is_file() and b"Ray_tracing" in nc.read_bytes(), "netCDF Algorithm attribute")
    say("30 general-driver", batches=drv["cfg"]["num_batches"], photons=drv["cfg"]["num_photons"],
        fup=f"{m:.6f}", stderr=f"{e:.2e}", seconds=f"{t_drv:.2f}",
        photons_per_s=f"{drv['cfg']['num_photons'] / t_drv:.4e}",
        launches=gb.general_block.launches,
        launches_per_batch=f"{gb.general_block.launches / drv['cfg']['num_batches']:.1f}",
        card=json.dumps(card))

    # 31. run_band(mode="traced") on band 0 of examples/broadbandDriver.nml's
    # inputs over the step cloud, flux only: per-k optics through one tracer
    dom, kd, band_integ, optics_k1 = traced_band("cuda")
    derive = lambda r: {"fup": r.mean_flux_up, "fdn": r.mean_flux_down,
                        "fabs": r.mean_flux_absorbed}
    gb.reset_launch_counters()
    eb.reset_launch_counters()
    t0 = time.perf_counter()
    band = run_band(band_integ, dom, kd, src, 1 << 22, 2, seed=12, derive=derive, mode="traced")
    mb = {k: float(v) for k, v in band.mean["derived"].items()}
    dt = time.perf_counter() - t0
    check(gb.general_block.launches > 0 and eb.event_block.gas_launches == 0,
          "the traced band ran no G kernel, or the gas kernel")
    check(abs(sum(mb.values()) - 1.0) < 1e-3, f"traced band closure {mb}")
    baked = run_band(band_integ, dom, kd, src, 1 << 22, 2, seed=13, derive=derive,
                     mode="baked")
    fb = float(baked.mean["derived"]["fup"])
    se = (float(band.stderr["derived"]["fup"]) ** 2
          + float(baked.stderr["derived"]["fup"]) ** 2) ** 0.5
    check(abs(mb["fup"] - fb) <= 5 * se + 5e-4, f"traced band Fup {mb['fup']} vs baked {fb}")
    n_band = 2 * 2 * (1 << 22)
    say("31 general-traced-band", photons=n_band, fup=f"{mb['fup']:.6f}",
        fdn=f"{mb['fdn']:.6f}", fabs=f"{mb['fabs']:.6f}", baked_fup=f"{fb:.6f}",
        seconds=f"{dt:.3f}", photons_per_s=f"{n_band / dt:.4e}",
        launches=gb.general_block.launches, card=json.dumps(card))
    general_batch_record(band_integ, src, 1 << 22, GENERAL_LANES, 760, card,
                         "31 general-traced-band-k1", optics=optics_k1)
    return rec


def general_entry(timed: dict, err: float, rec: dict) -> dict:
    """The kernels-line entry of G: launches on the phase-27 path, its
    largest tally difference to the plain version (the lane state is bit-
    equal), the step cloud's mid-flight block's device time beside the
    twin's and the bound (phase 26), the tail's and Landsat general's
    blocks, and the step-cloud and Landsat batches' kernel time and
    bound."""
    sc, land = rec["step_cloud"], rec["landsat"]
    mid = timed["rt_step_cloud mid"]
    blocks = {k.replace(" ", "_") + "_ms": v["device_ms"] for k, v in timed.items()}
    return {"name": "general_event_block", "route": "cuda",
            "source": "i3rc_tpu_torch/csrc/general_event_block.cu",
            "replaces": "none: XLA in i3rc_tpu/integrators/wavefront.py:657 (no TPU kernel)",
            "launches": rec["launches"], "max_abs_err": err, "ms": mid["device_ms"],
            "plain_ms": mid["twin_ms"], "bound_ms": mid["bound"][0],
            "bound_by": mid["bound"][1], "library_ms": None,
            "events_ms": mid["events_ms"], **blocks, "batch_ms": sc.get("kernel_ms"),
            "batch_launches": sc["launches"], "batch_bound_ms": sc["bound"][0],
            "landsat_batch_ms": land.get("kernel_ms"), "landsat_batch_launches": land["launches"],
            "landsat_batch_bound_ms": land["bound"][0]}


# ---------------------------------------------------------------------------
# The general kernel's local estimate: G's general_estimate stage (the DET
# instantiations, csrc/general_event_block_det.cu) against its plain version,
# and its paths

RAD_GENERAL_PHOTONS = 1 << 22       # paths (a) and (b)
LANDSAT_RAD_PHOTONS = 1 << 21       # bench.py:218-246's row
LANDSAT_DET_MUS, LANDSAT_DET_PHIS = [1.0, 0.5], [0.0, 0.0]
# Absorbing Landsat's fluxes on the fastpath (phase 17, one batch of 2^22
# photons; PERF.md section 6): path (c)'s flux gate.
ANCHOR_LANDSAT_ABS = (0.424425, 0.404671, 0.170904)
ANCHOR_LANDSAT_ABS_PHOTONS = 1 << 22
# Operations per ray of the estimate (one collision x detector): the
# projection, acosf (~15 ALU, a square root), the division by pi, the
# linear lookup, the phase over 4 pi |mu_d|, expf, the tally's two
# red.global.add.f64; a ray's DDA steps count as OPS_PER_GSTEP each.
OPS_PER_GRAY = (60, 4)
# Phase 32's radiance cases (tests/general_scenes.py RADIANCE_CASES, every
# DET instantiation) run at RAD_CASE_LANES lanes and 4x the photons.
RAD_CASE_LANES = 1 << 16
RAD_WOODCOCK_LANES = 1 << 16        # path (b): bench.py:249-271's wavefront
COX_MUNK_PHOTONS = 1 << 20          # path (d)
# Path (c) may lose this share of its photons (n_bad): the chained class
# counts a bad or over-long estimate ray as well as a bad flight.
LANDSAT_RAD_BAD_SHARE = 1e-3


def step_cloud_radiance(dev, cfg=None):
    """Paths (a) and (b): the 32 x 1 x 32 step cloud with the I3RC
    detectors under ``cfg`` (default: IntegratorConfig())."""
    from i3rc_tpu_torch import Integrator, IntegratorConfig, make_step_cloud

    return Integrator.create(make_step_cloud(1.0), cfg or IntegratorConfig(), device=dev,
                             intensity_mus=DET_MUS, intensity_phis=DET_PHIS)


def woodcock_bench_config():
    """Path (b), bench.py:249-271: the fastpath off, 16-cell super-voxels
    (Woodcock), the exact trace."""
    from i3rc_tpu_torch import IntegratorConfig

    return IntegratorConfig(use_ray_tracing=False, max_events=500,
                            compute_volume_absorption=False, use_fastpath=False,
                            majorant_block_size=16)


def landsat_radiance(dev, iwabuchi: bool = False):
    """Path (c), bench.py:218-246: Landsat at ssa 0.99 with 2 detectors
    (the create-time rule turns ratio tracking on: the weight-1 class), or
    with Iwabuchi roulette (the exact trace, not chained)."""
    from i3rc_tpu_torch import Integrator, IntegratorConfig, make_landsat_cloud

    cfg = dict(use_ray_tracing=False, max_events=500, compute_volume_absorption=False)
    if iwabuchi:
        cfg["use_russian_roulette_for_intensity"] = True
    return Integrator.create(make_landsat_cloud(0.99), IntegratorConfig(**cfg), device=dev,
                             intensity_mus=LANDSAT_DET_MUS, intensity_phis=LANDSAT_DET_PHIS)


def cox_munk_vacuum():
    """Path (d), tests/test_misc_features.py:184-227: a vacuum over a
    uniform Cox-Munk surface (wind 7 m/s, n 1.34), the sun at mu0 0.707 and
    30 degrees, four detectors.  Returns (make(mode, dev), source, the
    closed form R(sun -> detector)/pi and 0 for the downward one)."""
    from i3rc_tpu_torch import (Domain, Integrator, IntegratorConfig, PhaseFunction,
                                PhaseFunctionTable, PhotonSource, SurfaceDescription,
                                henyey_greenstein_coefficients)
    from i3rc_tpu_torch.core.surface import cox_munk_brdf

    mu0, az0, wind, n_refr = 0.707, 30.0, 7.0, 1.34
    mus, phis = [0.707, 0.5, 0.9, -0.5], [30.0, 210.0, 75.0, 0.0]
    dom = Domain.create([0, 500.0], [0, 500.0], [0.0, 250.0])
    ext = np.full((1, 1, 1), 1e-12)
    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(0.85, 64))], key=[1.0])
    dom = dom.add_component("vac", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32), table)
    f32 = lambda v: torch.tensor([v], dtype=torch.float32)
    want = np.array([float(cox_munk_brdf([f32(wind), f32(n_refr)], f32(-mu0), f32(m),
                                         f32(np.deg2rad(az0)), f32(np.deg2rad(p)))[0]) / np.pi
                     if m > 0 else 0.0 for m, p in zip(mus, phis)])
    make = lambda mode, dev: Integrator.create(
        dom, IntegratorConfig(use_fastpath=False, **ORACLE_MODES[mode]), device=dev,
        surface=SurfaceDescription.uniform([wind, n_refr], brdf_name="cox_munk"),
        intensity_mus=mus, intensity_phis=phis)
    return make, PhotonSource.directional(mu0, az0), want


def radiance_kernel_vs_twin(dev, card: str, built: dict) -> tuple[dict, float]:
    """Phase 32 (f): one block of G with detectors against
    general_block_reference on the launch, a mid-flight and a tail state of
    every case of tests/general_scenes.py RADIANCE_CASES (every estimator in
    every mode that has it over black, albedo and gridded RPV surfaces,
    hybrid phases, clipping, the weight-1 class) at RAD_CASE_LANES lanes,
    and of each radiance path's own scene, built as the path builds it, at
    its photons and lanes: (a) the step cloud through the default
    configuration with the I3RC detectors, 2^22 photons at 2^20 lanes; (b)
    its Woodcock bench row at 2^16 lanes; (c) Landsat's chained ratio
    tracking, 2^21 photons at 2^20 lanes; (d) the vacuum over Cox-Munk in
    each mode, 2^20 photons.  The lane state, the control state, the dead
    counts and the estimate steps and rays bit for bit, the float64 tallies
    within 1e-9 of their largest entry.  The instantiations
    launched are checked by name against ``built`` (ptxas: every DET one).
    Path (a)'s mid-flight and tail blocks are timed (profiler device time,
    CUDA events; the twin by CUDA events).  Returns ({"<state>": timing} of
    path (a)'s scene, the largest tally difference)."""
    from i3rc_tpu_torch import PhotonSource, batch_key
    from i3rc_tpu_torch.kernels import general_block as gb

    scenes = _load_tests_module("general_scenes")
    port = scenes.host("i3rc_tpu_torch")
    sun = PhotonSource.directional(0.5, 0.0)
    rows = {"path_a": (lambda: step_cloud_radiance(dev), RAD_GENERAL_PHOTONS, GENERAL_LANES, sun)}
    rows.update({name: (lambda name=name: scenes.radiance_case(port, name, dev),
                        4 * RAD_CASE_LANES, RAD_CASE_LANES, sun)
                 for name in scenes.RADIANCE_CASES})
    rows["path_b"] = (lambda: step_cloud_radiance(dev, woodcock_bench_config()),
                      RAD_GENERAL_PHOTONS, RAD_WOODCOCK_LANES, sun)
    rows["path_c"] = (lambda: landsat_radiance(dev), LANDSAT_RAD_PHOTONS,
                      min(LANDSAT_RAD_PHOTONS, GENERAL_LANES), sun)
    make_cm, cm_src, _ = cox_munk_vacuum()
    for mode in ORACLE_MODES:
        rows[f"path_d_{mode}"] = (lambda mode=mode: make_cm(mode, dev), COX_MUNK_PHOTONS,
                                  COX_MUNK_PHOTONS, cm_src)
    seen, timed, worst = set(), {}, 0.0
    for row, (name, (make, n, L, src)) in enumerate(rows.items()):
        integ = make()
        tracer = integ.general_tracer(n, L)
        spec, opt, tables = tracer.spec, integ.device_optics, integ.tables
        var = gb.variant(spec, opt)
        inst = general_instantiation(spec, var)
        check(inst in built, f"{name}: {inst} is not in the ptxas list")
        seen.add(inst)
        key = batch_key(SEED, 800 + row)
        st = gb.launch_state(spec, src.sample(key, L, dev), n)
        buf = gb.general_buffers(spec, st, min(L, n))
        kb = 0
        states = [("launch", st.clone(), buf.clone(), kb)]
        gb.general_block(spec, var, opt, tables, st, buf, key, src, kb)
        kb += 1
        states.append(("mid", st.clone(), buf.clone(), kb))
        while not (int(buf.ctl[kb & 1]) >= n and float(st.i[gb.ALIVE].float().mean()) <= 0.15):
            check(kb < 800, f"{name}: the tail state never came")
            gb.general_block(spec, var, opt, tables, st, buf, key, src, kb)
            kb += 1
        states.append(("tail", st.clone(), buf.clone(), kb))
        for state, s0, b0, kb_s in states:
            sk, bk, sr, br = s0.clone(), b0.clone(), s0.clone(), b0.clone()
            gb.general_block(spec, var, opt, tables, sk, bk, key, src, kb_s)
            t0 = time.perf_counter()
            gb.general_block_reference(spec, var, opt, tables, sr, br, key, src, kb_s)
            torch.cuda.synchronize()
            twin_s = time.perf_counter() - t0
            err = 0.0
            for what in ("columns", "vol", "intensity", "by_component", "excess"):
                a, b = getattr(bk, what), getattr(br, what)
                if b.numel():
                    err = max(err, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300))
            bit = (torch.equal(sk.f, sr.f) and torch.equal(sk.i, sr.i)
                   and torch.equal(bk.ctl, br.ctl) and torch.equal(bk.dead, br.dead)
                   and torch.equal(bk.int_steps, br.int_steps)
                   and torch.equal(bk.int_rays, br.int_rays))
            n_diff = int(((sk.f != sr.f).any(0) | (sk.i != sr.i).any(0)).sum())
            check(bit and err <= 1e-9,
                  f"G+estimate {name} {state}: kernel and twin differ on {n_diff} lanes, "
                  f"tallies {err:.2e}")
            worst = max(worst, err)
            live = int(s0.i[gb.ALIVE].sum())
            d = lambda r: int((sr.i[r] - s0.i[r]).sum())
            steps, events = d(gb.XING), d(gb.EVCT)
            int_steps = int((br.int_steps - b0.int_steps).sum())
            rays = int((br.int_rays - b0.int_rays).sum())
            taken = int(br.ctl[(kb_s + 1) & 1] - b0.ctl[kb_s & 1])
            collisions = max(events - (live + taken - int(sr.i[gb.ALIVE].sum())), 0)
            # the dead counts, the live lanes' state in and out, the per-lane
            # estimate steps and rays in and out, the tables
            n_bytes = 8 * s0.n_lanes + (live + taken) * 2 * GSTATE_ROWS * 4 \
                + 16 * s0.n_lanes + general_table_bytes(integ, tracer)
            bound = general_bound(steps + int_steps, events, collisions, n_bytes, rays=rays)
            fields = dict(case=name, instantiation=inst, estimator=gb.EST_NAMES[spec.det.est],
                          state=state, lanes=s0.n_lanes, alive=f"{live / s0.n_lanes:.4f}",
                          bit_equal=bit, tally_rel_err=f"{err:.2e}", lane_events=events,
                          dda_steps=steps, estimate_steps=int_steps, estimate_rays=rays,
                          twin_ms=f"{1e3 * twin_s:.3f}", bound_ms=f"{bound[0]:.4f}",
                          bound_by=bound[1])
            if name == "path_a" and state in ("mid", "tail"):
                run = lambda s, b: gb.general_block(spec, var, opt, tables, s, b, key, src, kb_s)
                ms = general_block_ms(run, lambda: (s0.clone(), b0.clone()), 10)
                fields.update(kernel_ms=f"{ms[0]:.4f}", kernel_device_ms=f"{ms[1]:.4f}")
                timed[state] = {"device_ms": ms[1], "events_ms": ms[0],
                                "twin_ms": 1e3 * twin_s, "bound": bound}
            say("32 general-estimate-vs-twin", **fields, card=json.dumps(card))
    det_built = {k for k in built if k.endswith("_det")}
    check(seen == det_built, f"phase 32 misses instantiations {sorted(det_built - seen)}")
    return timed, worst


def radiance_batches(fn, n: int, seed0: int, n_batches: int, closure: bool, bad_max: int):
    """Batches of a radiance path: per batch the mean radiances (host numpy)
    and fluxes, the host seconds and n_bad, each gated on finite fields and
    n_bad (and, for ``closure``, on Fup + Fdn = 1 less the bad photons)."""
    intens, fluxes, times, bads = [], [], [], []
    for b in range(n_batches):
        t0 = time.perf_counter()
        res = fn(batch_key_(seed0 + b))
        i_b = res.mean_intensity.double().cpu().numpy()
        f_b = [float(res.mean_flux_up), float(res.mean_flux_down), float(res.mean_flux_absorbed)]
        n_bad = int(res.n_bad)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(res.intensity).all()) and np.isfinite(f_b).all(),
              "radiance path: non-finite fields")
        check(n_bad <= bad_max, f"radiance path n_bad={n_bad} (limit {bad_max})")
        if closure:
            check(abs(f_b[0] + f_b[1] - 1.0) < 1e-5 + n_bad / n, f"radiance closure {f_b}")
        intens.append(i_b)
        fluxes.append(f_b)
        bads.append(n_bad)
    return np.array(intens), np.array(fluxes), times, bads


def gate_step_cloud_radiance(tag: str, intens: np.ndarray) -> tuple:
    """The I3RC anchors within 1% + 5 sigma (phase 9's gate), sigma from the
    batches' spread."""
    mean, sigma = intens.mean(0), intens.std(0, ddof=1) / intens.shape[0] ** 0.5
    for d, anchor in enumerate(ANCHOR_I):
        check(abs(mean[d] - anchor) <= 0.01 * anchor + 5 * sigma[d],
              f"{tag} detector {d}: I = {mean[d]} +- {sigma[d]}, anchor {anchor}")
    return mean, sigma


def radiance_paths(out: Path, card: str) -> dict:
    """Phases 33-37, the general kernel's radiance paths, each driven with
    the launch counts set to 0 just before it and read just after.  Returns
    the launches and batch record of path (a)."""
    from i3rc_tpu_torch import IntegratorConfig, PhotonSource
    from i3rc_tpu_torch.drivers.monte_carlo_driver import run_from_namelist
    from i3rc_tpu_torch.integrators.wavefront import EXACT, IWABUCHI, RATIO
    from i3rc_tpu_torch.kernels import event_block as eb
    from i3rc_tpu_torch.kernels import general_block as gb

    src = PhotonSource.directional(0.5, 0.0)
    n = RAD_GENERAL_PHOTONS
    rec = {}

    # 33 (a). the default configuration's radiance: the step cloud through
    # IntegratorConfig() (ray tracing, the exact trace), 2^22 photons at the
    # default 2^20 lanes, 3 batches after a warm-up; then with the shipped
    # namelist's Iwabuchi roulette (zeta_min 0.3)
    for tag, cfg in (("exact", IntegratorConfig()),
                     ("iwabuchi", IntegratorConfig(use_russian_roulette_for_intensity=True,
                                                   zeta_min=0.3))):
        integ = step_cloud_radiance("cuda", cfg)
        spec = integ.general_tracer(n).spec
        check(integ._fast_plan is None and spec.mode == 0
              and spec.det.est == (EXACT if tag == "exact" else IWABUCHI), f"(a) {tag} plan")
        fn = integ.batch_fn(src, n)
        fn(batch_key_(900))
        torch.cuda.synchronize()
        gb.reset_launch_counters()
        eb.reset_launch_counters()
        intens, fl, times, bads = radiance_batches(fn, n, 901, 3, True, int(1e-3 * n))
        launches = gb.general_block.det_launches
        check(launches > 0 and launches == gb.general_block.launches
              and gb.general_block.mode_launches["ray_tracing"] == launches
              and eb.event_block.launches + eb.event_block.detector_launches == 0,
              f"path (a) {tag} ran {gb.general_block.mode_launches}")
        mean, sigma = gate_step_cloud_radiance(f"(a) {tag}", intens)
        t = sorted(times)[1]
        say(f"33 radiance-default-{tag}", photons=n, lanes=GENERAL_LANES,
            intensity=",".join(f"{v:.5f}" for v in mean),
            sigma=",".join(f"{v:.1e}" for v in sigma), anchor=",".join(map(str, ANCHOR_I)),
            fup=f"{fl[:, 0].mean():.6f}", n_bad=",".join(map(str, bads)),
            seconds=",".join(f"{x:.4f}" for x in times),
            photons_per_s=f"{n / t:.4e}", launches=launches,
            blocks_per_batch=f"{launches / 3:.1f}", card=json.dumps(card))
        r = general_batch_record(integ, src, n, GENERAL_LANES, 910, card,
                                 f"33 radiance-default-{tag}")
        if tag == "exact":
            rec["a"], rec["launches"] = r, launches
        else:
            rec["a_iwabuchi"] = r

    # 34 (b). bench.py:249-271: the step cloud with the fastpath off on
    # 16-cell super-voxels (Woodcock, the exact trace), 3 detectors
    integ = step_cloud_radiance("cuda", woodcock_bench_config())
    check(integ.general_tracer(n).spec.mode == 2, "(b) Woodcock")
    fn = integ.batch_fn(src, n, n_lanes=RAD_WOODCOCK_LANES)
    fn(batch_key_(920))
    torch.cuda.synchronize()
    gb.reset_launch_counters()
    # Woodcock loses ~3e-6 of its photons to a tentative collision that
    # rounds onto a block face (a non-positive DDA step), as ray tracing does.
    intens, fl, times, bads = radiance_batches(fn, n, 921, 3, True, int(1e-3 * n))
    launches = gb.general_block.det_launches
    check(launches > 0 and gb.general_block.mode_launches["woodcock"] == launches,
          f"path (b) ran {gb.general_block.mode_launches}")
    mean, sigma = gate_step_cloud_radiance("(b)", intens)
    say("34 radiance-woodcock-bench", photons=n, lanes=RAD_WOODCOCK_LANES,
        intensity=",".join(f"{v:.5f}" for v in mean), sigma=",".join(f"{v:.1e}" for v in sigma),
        n_bad=",".join(map(str, bads)),
        seconds=",".join(f"{x:.4f}" for x in times),
        photons_per_s=f"{n / sorted(times)[1]:.4e}", launches=launches, card=json.dumps(card))
    rec["b"] = general_batch_record(integ, src, n, RAD_WOODCOCK_LANES, 930, card,
                                    "34 radiance-woodcock-bench")

    # 35 (c). bench.py:218-246: Landsat at ssa 0.99 with 2 detectors: the
    # create-time rule turns ratio tracking on, the weight-1 class runs;
    # fluxes against the fastpath's absorbing Landsat, radiances against the
    # same scene with Iwabuchi roulette (an independent estimator: exact
    # trace, not chained)
    nl = LANDSAT_RAD_PHOTONS
    bad_max = int(LANDSAT_RAD_BAD_SHARE * nl)
    integ = landsat_radiance("cuda")
    spec = integ.general_tracer(nl).spec
    check(integ.config.use_ratio_tracking_for_intensity and spec.det.est == RATIO
          and spec.chained, "(c) ratio tracking, the weight-1 class")
    fn = integ.batch_fn(src, nl)
    fn(batch_key_(940))
    torch.cuda.synchronize()
    gb.reset_launch_counters()
    intens, fl, times, bads = radiance_batches(fn, nl, 941, 4, False, bad_max)
    launches = gb.general_block.det_launches
    check(launches > 0 and gb.general_block.mode_launches["woodcock"] == launches,
          f"path (c) ran {gb.general_block.mode_launches}")
    f_mean, f_se = fl.mean(0), fl.std(0, ddof=1) / 2.0
    for k, what in enumerate(("Fup", "Fdn", "Fabs")):
        a = ANCHOR_LANDSAT_ABS[k]
        se = (f_se[k] ** 2 + a * (1 - a) / ANCHOR_LANDSAT_ABS_PHOTONS) ** 0.5
        check(abs(f_mean[k] - a) <= 5 * se, f"(c) {what} {f_mean[k]} vs {a} (se {se:.2e})")
    iw = landsat_radiance("cuda", iwabuchi=True)
    check(not iw.general_tracer(nl).spec.chained and iw.general_tracer(nl).spec.det.est == IWABUCHI,
          "(c) Iwabuchi reference")
    iw_int, _, iw_times, iw_bads = radiance_batches(iw.batch_fn(src, nl), nl, 951, 4, False,
                                                    bad_max)
    i_mean, i_se = intens.mean(0), intens.std(0, ddof=1) / 2.0
    w_mean, w_se = iw_int.mean(0), iw_int.std(0, ddof=1) / 2.0
    for d in range(2):
        se = (i_se[d] ** 2 + w_se[d] ** 2) ** 0.5
        check(abs(i_mean[d] - w_mean[d]) <= 5 * se,
              f"(c) detector {d}: ratio {i_mean[d]} vs Iwabuchi {w_mean[d]} (se {se:.2e})")
    say("35 radiance-landsat", photons=nl, lanes=min(nl, GENERAL_LANES), estimator="ratio",
        weight1=True, fluxes=",".join(f"{v:.6f}" for v in f_mean),
        flux_se=",".join(f"{v:.1e}" for v in f_se),
        anchor=",".join(map(str, ANCHOR_LANDSAT_ABS)),
        intensity=",".join(f"{v:.5f}" for v in i_mean), se=",".join(f"{v:.1e}" for v in i_se),
        iwabuchi_intensity=",".join(f"{v:.5f}" for v in w_mean),
        iwabuchi_se=",".join(f"{v:.1e}" for v in w_se), n_bad=",".join(map(str, bads)),
        iwabuchi_n_bad=",".join(map(str, iw_bads)), n_bad_limit=bad_max,
        seconds=",".join(f"{x:.4f}" for x in times),
        photons_per_s=f"{nl / sorted(times)[1]:.4e}",
        iwabuchi_photons_per_s=f"{nl / sorted(iw_times)[1]:.4e}", launches=launches,
        card=json.dumps(card))
    rec["c"] = general_batch_record(integ, src, nl, min(nl, GENERAL_LANES), 960, card,
                                    "35 radiance-landsat")

    # 36 (d). vacuum over Cox-Munk (tests/test_misc_features.py:184-227):
    # I = R(sun -> detector)/pi exactly, 0 downward, in every mode
    make_cm, cm_src, want = cox_munk_vacuum()
    got_modes = []
    gb.reset_launch_counters()
    for mode in ORACLE_MODES:
        got = make_cm(mode, "cuda").batch_fn(cm_src, COX_MUNK_PHOTONS)(batch_key_(970))
        got = got.mean_intensity.double().cpu().numpy()
        check(np.allclose(got, want, rtol=2e-3, atol=1e-7), f"(d) {mode}: {got} vs {want}")
        got_modes.append(f"{mode}=" + ",".join(f"{v:.6f}" for v in got))
    check(min(gb.general_block.mode_launches.values()) > 0
          and gb.general_block.det_launches == gb.general_block.launches,
          f"(d) ran {gb.general_block.mode_launches}")
    say("36 radiance-vacuum-cox-munk", photons=COX_MUNK_PHOTONS,
        want=",".join(f"{v:.6f}" for v in want), results=";".join(got_modes), launches=gb.general_block.det_launches)

    # 37 (e). the shipped step-cloud namelist with useRayTracing = .true.
    # through the driver, from the directory holding the domain files
    shipped = ROOT / "examples" / "monteCarloDriver_stepCloud.nml"
    text = shipped.read_text()
    check("useRayTracing = .false." in text, "the shipped namelist's algorithm line")
    nml = out / "monteCarloDriver_stepCloud_raytracing.nml"
    nml.write_text(text.replace("useRayTracing = .false.", "useRayTracing = .true.").replace(
        '"stepCloud', '"stepCloudRT'))
    gb.reset_launch_counters()
    cwd = os.getcwd()
    os.chdir(out)
    try:
        t0 = time.perf_counter()
        drv = run_from_namelist(nml.name, quiet=True, device="cuda")
        t_drv = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    for name in ("stepCloudRTRads.out", "stepCloudRTOutput.nc"):
        check((out / name).is_file(), f"driver did not write {name}")
    i_m = drv["stats"].mean["derived"]["mean_intensity"]
    i_e = drv["stats"].stderr["derived"]["mean_intensity"]
    for d, anchor in enumerate(ANCHOR_I):
        check(abs(float(i_m[d]) - anchor) <= 0.01 * anchor + 5 * float(i_e[d]),
              f"(e) detector {d}: I = {float(i_m[d])} +- {float(i_e[d])}")
    check(gb.general_block.det_launches > 0
          and gb.general_block.mode_launches["ray_tracing"] == gb.general_block.launches,
          "the ray-tracing radiance driver ran no G estimate")
    check(b"Ray_tracing" in (out / "stepCloudRTOutput.nc").read_bytes(), "netCDF Algorithm")
    say("37 radiance-driver-raytracing", batches=drv["cfg"]["num_batches"],
        photons=drv["cfg"]["num_photons"], intensity=",".join(f"{float(v):.5f}" for v in i_m),
        stderr=",".join(f"{float(v):.1e}" for v in i_e), seconds=f"{t_drv:.2f}",
        launches=gb.general_block.det_launches, card=json.dumps(card))
    return rec


def estimate_entry(timed: dict, err: float, rec: dict) -> dict:
    """The kernels-line entry of G with the estimate stage: launches on path
    (a) (exact trace), its largest tally difference to the plain version
    (the lane state is bit-equal), path (a)'s mid-flight block's device time
    beside the twin's and the bound (phase 32), its tail block, and the
    batches' kernel time and bound of paths (a), (b) and (c)."""
    mid = timed["mid"]
    a = rec["a"]
    return {"name": "general_event_block_estimate", "route": "cuda",
            "source": "i3rc_tpu_torch/csrc/general_event_block_det.cu",
            "replaces": "none: XLA in i3rc_tpu/integrators/wavefront.py:884 "
                        "(intensity_contribution; no TPU kernel)",
            "launches": rec["launches"], "max_abs_err": err, "ms": mid["device_ms"],
            "plain_ms": mid["twin_ms"], "bound_ms": mid["bound"][0],
            "bound_by": mid["bound"][1], "library_ms": None, "events_ms": mid["events_ms"],
            "tail_ms": timed["tail"]["device_ms"], "batch_ms": a.get("kernel_ms"),
            "batch_launches": a["launches"], "batch_bound_ms": a["bound"][0],
            **{f"{k}_batch_ms": rec[k].get("kernel_ms") for k in ("a_iwabuchi", "b", "c")},
            **{f"{k}_batch_bound_ms": rec[k]["bound"][0] for k in ("a_iwabuchi", "b", "c")}}


if __name__ == "__main__":
    sys.exit(main())
