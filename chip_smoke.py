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
tracing), and the table modes of the fastpath (phase functions that are not
exactly HG: all 88 table instantiations against their plain version on small
cases and on each path's own scene, then the C.1 step cloud's flux and its
radiance, Landsat with per-column ssa and table entries, the bench band over
a C.1 cloud, the isotropic slab against the oracle, each against the general
kernel or the oracle, and the radar cloud on the general kernel), and
fused-k spectral batching (every k point of a band in one trace: all 56
fused-k instantiations against their plain version on small cases and on
each path's own scene, then the bench band at full width and its C.1 twin
in turns with the baked band, the three I3RC detectors, heating rates, an
internal source against its closed form and the band over an albedo), and
polarized transport (the polarized event block against its plain version
on its four instantiations, then the bench row's Rayleigh atmosphere with
2 Stokes detectors against the JAX package's degree of polarization, a
Mie step cloud with the I3RC detectors and the polarized namelist through
the driver), and the marching shadow trace of a plan whose x and y factors
both vary (its 48 instantiations and the surface stage's against their
plain version on small cases and on their paths' scenes, the step cloud's
closed trace against the marching one, a 3-D separable scene's radiance
against the general kernel's exact trace, and the same scene over RPV),
and the plane-parallel verification driver (the shipped namelist, copies
against the discrete-ordinates slab on the general kernel and the
fastpath, and in radiance mode), and multi-device runs (the x-sharded
tracer's block, its kernels SD and SB, against its plain version;
run_batches on a
world of one NCCL rank and on two gloo ranks that share the card; a resume
finished in a second process; the x-sharded tracer over two ranks on the
whole Landsat scene and on __graft_entry__.py's detector scene), and the
kernels' reach (every runtime-depth instantiation of the event block, the
general kernel's estimate stage at 300 components and 32 detectors and SD's
refill from a source queue against their plain versions; the main path at
collision-chain depth 4 and 6, the gas step cloud and Landsat past depth 3;
32 detectors and 300 components on the general kernel; a sharded spotlight
and internal source over two gloo ranks and one NCCL rank; the monteCarlo
driver with --profile) — and checks the physics.
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
PHILOX_REPS = 20                # phase 3's repeats of each kernel-vs-torch draw check
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
    # P1 probe, per event in units of the 67e12 rate, written out: the draw's
    # Philox word 0 (19 32 x 32 -> 64-bit multiplies, IMAD.WIDE at half the
    # FP32 instruction rate: 4 units each, 76; 19 three-way xors, LOP3: 2
    # each, 38), to_unit (a shift and a product: 4), the row index (two
    # products, four clamps, the address: 14) and the advance and wrap (18
    # float adds and products: 36): 168; on the conversion pipe (16 a clock
    # an SM, SFU_OPS_PER_S) one I2F, two F2I and two FRND.  The key
    # schedule runs on the warp's uniform datapath.  The first count,
    # OPS_PER_EVENT_PROBE_BEFORE, left out the multiplies' half rate.
    "probe": (168, 5),
    # FK: K1's step (no gas faces) + the endpoint read (clip, layer, Gz
    # linear in it: ~15 ALU), the gas depth's division and the death test.
    # The read's 8-byte row comes from the k table, a few KB that stay in
    # L1: state_bytes counts the table once, as it counts the other tables
    # (the death layer's binary search, only at a gas death with the volume
    # tally, is not on a timed path).
    "fused_k": (140, 4),
    "fused_k_detectors": (140, 4),
}
OPS_PER_EVENT_PROBE_BEFORE = (120, 0)   # one Philox call and ~20 ALU an event, at 67e12
OPS_PER_COLLISION = {"flux": (180, 7), "detectors": (180, 7), "gas": (190, 7),
                     "gas_detectors": (190, 7), "column": (180, 8), "probe": (0, 0),
                     "fused_k": (180, 7), "fused_k_detectors": (180, 7)}
OPS_PER_DETECTOR = (70, 4)         # HG phase value (1/sqrt), shadow z segments, exp, log
# Table variants (tables.build_inverse_cubic, build_forward_cubic) in place
# of HG: per sampled cosine the cubic (clamp, segment, 3 multiply-adds,
# clip: ~10 ALU, its row one 16-byte load) for the HG inversion (two IEEE
# divisions, ~8 ALU); per detector ray the forward read (acos: ~15 ALU and
# one SFU step; 3 multiply-adds; exp: one SFU step) for HG's value (a
# reciprocal square root, ~8 ALU).  The tables count once in a block's bytes
# (state_bytes).
OPS_CUBIC, OPS_HG_INVERSE = (10, 0), (8, 2)
OPS_FORWARD, OPS_HG_VALUE = (18, 2), (8, 1)
STATE_ROWS = 13                    # x, y, z, ux, uy, uz, tau, tgas; alive, orders, pk, bad, evct
# (a fused-k plan's lanes carry one more, gcur: state_bytes adds it)
# The surface stage (fast_event_block.cu fast_event_block_surface_kernel): per bottom hit a
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
# The marching shadow trace (fast_event_block.cuh shadow_march, K3-M): per
# ray (a collision or emitting hit x detector) the phase value (HG: a
# reciprocal square root; TAB: the forward fit, OPS_FORWARD for
# OPS_HG_VALUE), the exp of the estimate and the bin, ~30 ALU and 3 SFU
# steps, in place of OPS_PER_DETECTOR's closed trace; per segment step the
# three where-chains of the extinction and the product, the faces of the z
# chain and of the x and y chains the ray moves along, three products by
# reciprocals, the minimum and the clamp, the optical depth's product and
# sum, the nudged or advanced position on each axis, two wraps and the exit
# test: ~70 ALU, no SFU step (no division).  The steps are the twin's count
# of this run's rays (event_block.march_census).
OPS_PER_MARCH_RAY = (30, 3)
OPS_PER_MARCH_STEP = (70, 0)


def state_bytes(spec, n_lanes: int, n_live: int) -> int:
    """Bytes that one block needs to move: the alive flag and tau of every
    lane read once; the rows a variant keeps (y and tgas only where it
    tracks them) of each live lane read once and written once; the
    detector accumulator read and written; the column table and a table
    variant's cubic fits and entry rows read once."""
    rows = STATE_ROWS - (not spec.track_y) - (not spec.gas) + spec.fused
    n = 8 * n_lanes + n_live * (2 * rows * 4 - 8)
    if spec.det is not None:
        n += 2 * 8 * spec.det.n_cols * spec.det.n
    tables = [spec.column, spec.cubic, spec.fwd, spec.pf_row]
    if spec.fused:
        tables += [spec.fk.table, spec.fk.weight, spec.fk.gtop, spec.fk.quota, spec.fk.cta0,
                   spec.fk.cta_k]
    for t in tables:
        if t is not None:
            n += t.numel() * t.element_size()
    return n


def bound_ms(variant: str, lane_events: int, n_bytes: int, collisions: int = 0,
             detectors: int = 0, hits: int = 0, brdf_evals: int = 0, emits: int = 0,
             extra_bytes: int = 0, table: bool = False, march: dict | None = None
             ) -> tuple[float, str]:
    """(least ms, what bounds it) for ``lane_events`` alive lane-events and
    ``collisions`` collisions of the variant that move ``n_bytes`` of
    device memory; over a reflecting surface (``bounce_work``) plus its
    ``hits`` bottom hits, ``brdf_evals`` BRDF evaluations, ``emits`` surface
    shadow rays and ``extra_bytes``.  A ``table`` variant samples each
    cosine from the cubic (OPS_CUBIC for OPS_HG_INVERSE) and takes each
    detector ray's phase value from the forward fit (OPS_FORWARD for
    OPS_HG_VALUE).  ``march``, a plan with the marching shadow trace: the
    ``rays`` and ``steps`` of event_block.march_census (collision and surface
    rays both; pass detectors=0 and no emits), each ray at OPS_PER_MARCH_RAY
    and each step at OPS_PER_MARCH_STEP."""
    (ea, es), (ca, cs) = OPS_PER_EVENT[variant], OPS_PER_COLLISION[variant]
    da, ds = OPS_PER_DETECTOR
    if table:
        ca, cs = ca + OPS_CUBIC[0] - OPS_HG_INVERSE[0], cs + OPS_CUBIC[1] - OPS_HG_INVERSE[1]
        da, ds = da + OPS_FORWARD[0] - OPS_HG_VALUE[0], ds + OPS_FORWARD[1] - OPS_HG_VALUE[1]
    alu = lane_events * ea + collisions * (ca + detectors * da)
    sfu = lane_events * es + collisions * (cs + detectors * ds)
    alu += hits * OPS_PER_HIT[0] + brdf_evals * OPS_PER_BRDF[0] + emits * OPS_PER_DETECTOR[0]
    sfu += hits * OPS_PER_HIT[1] + brdf_evals * OPS_PER_BRDF[1] + emits * OPS_PER_DETECTOR[1]
    if march is not None:
        ra, rs = OPS_PER_MARCH_RAY
        if table:
            ra, rs = ra + OPS_FORWARD[0] - OPS_HG_VALUE[0], rs + OPS_FORWARD[1] - OPS_HG_VALUE[1]
        alu += march["rays"] * ra + march["steps"] * OPS_PER_MARCH_STEP[0]
        sfu += march["rays"] * rs + march["steps"] * OPS_PER_MARCH_STEP[1]
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


_T0 = time.perf_counter()


def say(phase: str, **kv) -> None:
    """One phase's line: its name, the script's seconds so far (t), then
    the fields."""
    print(f"[{phase}] t={time.perf_counter() - _T0:.1f} "
          + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


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
# GAS, COL, SLICES, DCAP, TAB, FK), for the SASS census: the ones the main paths
# launch, then the detector tally of more than 751 bins and the Iwabuchi
# variant sized for 16 detectors, which only the checks run; then the table
# variants of the paths (f)-(j) (phases 38-43), the fused-k variants of
# phases 46-48, and K3-M (fast_event_block_kernel_march, phases 55-57).
CENSUS = {"flux_chain2": "ILi2ELb0ELb0ELb0ELb0ELb0ELb0ELb0ELi8ELb0ELb0EE",
          "gas_chain3": "ILi3ELb0ELb0ELb0ELb0ELb1ELb0ELb0ELi8ELb0ELb0EE",
          "column_chain2": "ILi2ELb0ELb1ELb0ELb0ELb0ELb1ELb0ELi8ELb0ELb0EE",
          "detectors_iwabuchi": "ILi0ELb0ELb0ELb1ELb1ELb0ELb0ELb1ELi8ELb0ELb0EE",
          "gas_detectors": "ILi0ELb0ELb0ELb1ELb0ELb1ELb0ELb1ELi8ELb0ELb0EE",
          "detectors_iwabuchi_wide": "ILi0ELb0ELb0ELb1ELb1ELb0ELb0ELb0ELi8ELb0ELb0EE",
          "detectors_iwabuchi_16": "ILi0ELb0ELb0ELb1ELb1ELb0ELb0ELb1ELi16ELb0ELb0EE",
          "table_flux_chain2": "ILi2ELb0ELb0ELb0ELb0ELb0ELb0ELb0ELi8ELb1ELb0EE",
          "table_detectors_iwabuchi": "ILi0ELb0ELb0ELb1ELb1ELb0ELb0ELb1ELi8ELb1ELb0EE",
          "table_gas_chain3": "ILi3ELb0ELb0ELb0ELb0ELb1ELb0ELb0ELi8ELb1ELb0EE",
          "table_column_chain2": "ILi2ELb1ELb1ELb0ELb0ELb0ELb1ELb0ELi8ELb1ELb0EE",
          "fused_k_flux": "ILi0ELb0ELb0ELb0ELb0ELb1ELb0ELb0ELi8ELb0ELb1EE",
          "fused_k_detectors_iwabuchi": "ILi0ELb0ELb0ELb1ELb1ELb1ELb0ELb1ELi8ELb0ELb1EE",
          "table_fused_k_flux": "ILi0ELb0ELb0ELb0ELb0ELb1ELb0ELb0ELi8ELb1ELb1EE",
          # K3-M (fast_event_block_kernel_march): phase 57's variant
          "march_detectors": "_marchILi0ELb1ELb1ELb1ELb0ELb0ELb0ELb1ELi8ELb0ELb0EE",
          "march_detectors_iwabuchi": "_marchILi0ELb0ELb1ELb1ELb1ELb0ELb0ELb1ELi8ELb0ELb0EE"}
# ptxas_by_variant of the HG sets as the build without table variants gave
# them (NVIDIA H100 80GB HBM3 machine's nvcc; chip_smoke.py phase 2 before
# ROADMAP item 15): adding the table variants leaves them as they were.
HG_PTXAS = {"column_flux": "8x/66regs/448B/3cta", "detectors": "24x/64regs/1344B/4cta",
            "flux": "16x/64regs/932B/4cta", "gas_detectors": "24x/64regs/1440B/4cta",
            "gas_flux": "16x/61regs/932B/4cta", "probe": "1x/28regs/0B/8cta"}
# The same of the table sets, as the build before the fused-k variants gave
# them on the same machine's nvcc: the fused-k variants leave every HG and
# table set as it was.
TAB_PTXAS = {"table_column_flux": "8x/64regs/448B/4cta",
             "table_detectors": "24x/64regs/1416B/4cta", "table_flux": "16x/62regs/920B/4cta",
             "table_gas_detectors": "24x/64regs/1424B/4cta",
             "table_gas_flux": "16x/61regs/932B/4cta"}
# The fused-k sets as the build before the surface stage's CTA sums gave
# them (built beside this checkout's in one call on the same machine's
# nvcc): the redesign leaves them as they were.
FK_PTXAS = {"fused_k_detectors": "24x/77regs/1560B/3cta", "fused_k_flux": "4x/64regs/236B/4cta",
            "table_fused_k_detectors": "24x/64regs/1516B/4cta",
            "table_fused_k_flux": "4x/64regs/236B/4cta"}
# The surface stage's kernel as it was built before its CTA sums, as
# PTXAS_FMT prints it.
SURFACE_BEFORE_PTXAS = {"surface": "48regs/48Bstack/0Bspill/5cta",
                        "surface_fused_k": "48regs/48Bstack/0Bspill/5cta"}
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
            if "column_read_probe_kernel" in line:
                name = "probe"
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
    fused_k_flux, fused_k_detectors, probe, the table variants table_*, and
    the runtime-depth ones deep_*): instantiations, their most registers,
    their stack-frame and spill-store bytes and the resident CTAs per SM
    those registers allow, from ptxas -v."""
    out = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*fast_event_block_kernelILi(n?)\d+"
                      r"ELb\dELb\dELb(\d)ELb\dELb(\d)ELb(\d)ELb\dELi\d+ELb(\d)ELb(\d)E", line)
        probe = "Compiling entry function" in line and "column_read_probe_kernel" in line
        if m or probe:
            name = "probe" if probe else (
                ("deep_" if m[1] else "") + ("table_" if m[5] == "1" else "")
                + ("fused_k_" if m[6] == "1" else "gas_" if m[3] == "1" else "")
                + ("column_" if m[4] == "1" else "")
                + ("detectors" if m[2] == "1" else "flux"))
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


def ptxas_march(log: str) -> dict:
    """Per set of K3-M instantiations (fast_event_block_kernel_march, HG
    "march_detectors" and table "table_march_detectors"): their count, most
    registers, the resident CTAs per SM those allow, and their summed
    stack-frame and spill-store bytes, from ptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*fast_event_block_kernel_marchILi\d+"
                      r"(?:ELb\d){7}ELi\d+ELb(\d)ELb\dEEv", line)
        if m:
            name = ("table_" if m[1] == "1" else "") + "march_detectors"
            out.setdefault(name, dict(count=0, registers=0, stack_bytes=0,
                                      spill_store_bytes=0))["count"] += 1
        elif "Compiling entry function" in line:
            name = None
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                                      line)):
            out[name]["stack_bytes"] += int(m[1])
            out[name]["spill_store_bytes"] += int(m[2])
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = max(out[name]["registers"], int(m[1]))
    for v in out.values():
        v["ctas_per_sm"] = ctas_per_sm(v["registers"])
    return out


def ptxas_surface(log: str) -> dict:
    """Per instantiation of the surface stage's kernel
    (fast_event_block_surface_kernel: "surface" and "surface_fused_k"; and
    fast_event_block_surface_kernel_march, "surface_march"): its registers,
    the resident CTAs per SM they allow, and its stack-frame and
    spill-store bytes."""
    out, lines = {}, log.splitlines()
    for at, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\w*fast_event_block_surface_kernel"
                      r"(?:ILb(\d)E|_march)", line)
        if not m:
            continue
        text = "\n".join(lines[at:at + 4])
        regs = re.search(r"Used (\d+) registers", text)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", text)
        if regs and frame:
            out["surface_march" if m[1] is None else
                "surface_fused_k" if m[1] == "1" else "surface"] = dict(
                registers=int(regs[1]), ctas_per_sm=ctas_per_sm(int(regs[1])),
                stack_bytes=int(frame[1]), spill_store_bytes=int(frame[2]))
    return out


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
    if spec.fused:
        return "fused_k_detectors" if spec.det is not None else "fused_k"
    if spec.gas:
        return "gas_detectors" if spec.det is not None else "gas"
    return "detectors" if spec.det is not None else "flux"


def block_states(ssa: float, dev, detectors: bool = False, gas=None, chain=None, K=None,
                 n_detectors: int = 0, step_chain: int = -1):
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
    roulette; without ``chain``, ``K`` is the separable plan's K, and
    ``step_chain`` the flux and gas scenes' chain depth (-1: auto).  Returns (spec, key, a maker of fresh
    accumulators (None without detectors), [(name, state, block index)])."""
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, batch_key,
                                make_landsat_cloud, make_step_cloud)
    from i3rc_tpu_torch.integrators.fastpath import event_spec, launch_state, renormalize
    from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component
    from i3rc_tpu_torch.kernels.event_block import ALIVE, ORDERS, PK, event_block

    flux_cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                                compute_volume_absorption=False, fastpath_chain=step_chain)
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
                                                   fastpath_unroll=K, fastpath_chain=step_chain),
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


# The profiler's traces (traced): all taken, those that showed fewer than
# half of their launches, and those that showed none (printed at the end).
PROFILER_TRACES = {"taken": 0, "short": 0, "empty": 0}


def traced(launch, n: int, kernel: str, counted: str):
    """The profiler's records of the kernels named ``kernel`` over n calls of
    ``launch()``, and the launches of those named ``counted`` among them.
    The profiler now and then drops device records of a trace: the records
    are those of the first of up to three traces that shows half of the n
    launches; PROFILER_TRACES counts the short ones."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                launch()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if kernel in e.key]
        launches = sum(e.count for e in found if counted in e.key)
        PROFILER_TRACES["taken"] += 1
        if 2 * launches >= n:
            break
        PROFILER_TRACES["short"] += 1
        PROFILER_TRACES["empty"] += launches == 0
    return found, launches


def device_block_ms(run, s0, new_acc, n: int, kernel: str = "fast_event_block") -> float:
    """Mean device time of the block kernel in ``run(state, acc)`` over n
    fresh copies of s0, from torch.profiler: the kernel's own time, without
    the host's work between the first event and the launch (building the
    parameter block), which the CUDA-event time of time_block_ms includes
    on an idle device.  Over a reflecting surface the surface stage's kernel
    counts in.  ``kernel`` names the kernels' family."""
    found, launches = traced(lambda: run(s0.clone(), new_acc()), n, kernel, f"{kernel}_kernel")
    check(0 < launches <= n, f"the profiler shows {launches} block kernels for {n} launches")
    return sum(e.self_device_time_total for e in found) / launches / 1e3


def queued_ms(launch, n: int) -> float:
    """Device ms a call of ``launch()``: CUDA events around n calls queued
    behind a spin kernel (~1 ms), so that the host's work of each call falls
    inside the spin and the events time the device alone."""
    launch()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES * max(1, n // 20))
    a.record()
    for _ in range(n):
        launch()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def profiled_ms(launch, n: int, kernel: str) -> float:
    """Mean device ms a launch of the kernels named ``kernel`` over n calls
    of ``launch()``, from the profiler (traced)."""
    found, launches = traced(launch, n, kernel, kernel)
    check(launches > 0, f"the profiler shows no {kernel} in {n} calls")
    return sum(e.self_device_time_total for e in found) / launches / 1e3


def kernel_vs_twin(ssa: float, dev, detectors: bool = False, gas=None, chain=None, K=None,
                   n_detectors: int = 0, step_chain: int = -1):
    """One K-event block, kernel vs twin, on the two states of block_states
    (same arguments).  With ``detectors`` the (n_cols, D) accumulators are
    compared too (relative to their largest bin).  Returns (spec, one dict
    per state: alive share and live lanes at entry, lane-events and
    collisions of the block, bit_equal, errors, kernel ms by CUDA events and
    by the profiler (device_ms), twin ms, bound)."""
    from i3rc_tpu_torch.core.rng import philox_uniforms
    from i3rc_tpu_torch.kernels.event_block import (ALIVE, EVCT, ORDERS, event_block,
                                                     event_block_reference)

    spec, key, new_acc, states = block_states(ssa, dev, detectors, gas, chain, K, n_detectors,
                                              step_chain)
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


def batch_kernel_time(run_batch, profile: bool = True, march: dict | None = None) -> dict:
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
    events' sum.  ``march``: the batch's marching census (march_batch_census),
    which the bound counts in place of the closed trace's rays."""
    import i3rc_tpu_torch.integrators.fastpath as fp
    from i3rc_tpu_torch.kernels.event_block import ALIVE, DONE, ORDERS, SPENT

    orig = fp.fused_block
    rec = []

    def bracketed(spec, pro, st, buf, key, source, kb):
        dead = st.i[ALIVE] == 0
        n_dead = dead.sum(dtype=torch.int64)
        dead_orders = (st.i[ORDERS] * dead).sum(dtype=torch.int64)
        orders = st.i[ORDERS].sum(dtype=torch.int64)
        launched = launched_now(spec, buf, kb).clone()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        orig(spec, pro, st, buf, key, source, kb)
        b.record()
        taken = launched_now(spec, buf, kb + 1) - launched
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
            "launched": int(max(launched_now(spec, rec[-1][6], k) for k in (0, 1))),
            "bound": bound_ms(variant(spec), events, n_bytes, collisions,
                              spec.det.n if spec.det is not None and march is None else 0,
                              **dict(bounce_work(spec, rec[0][5] * len(rec), hits),
                                     **({"emits": 0} if march and spec.reflecting else {})),
                              table=spec.table, march=march)}


def launched_now(spec, buf, kb: int):
    """Photons launched as block kb reads it: a fused-k trace's sum over its
    k points."""
    from i3rc_tpu_torch.kernels.event_block import LAUNCHED_K

    return buf.ctl[LAUNCHED_K + (kb & 1)::2].sum() if spec.fused else buf.ctl[kb & 1]


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

    stage_in = []

    def counted(spec_, pro_, s, b, u, u_iw=None):
        alive = int(s.i[ALIVE].sum())
        exits.update({k: int((s.i[PK] == k).sum()) for k in (1, 2, 3)})
        bounce["hits"] += exits[2]
        if timed:
            stage_in.append((s.clone(), b.clone(), u, u_iw))
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
        if spec.reflecting:
            # The surface stage's kernel alone over the same launches, its
            # plain version (resolve_surface) on the state it takes, and the
            # bound of the block's bounce.
            r["stage_device_ms"] = device_block_ms(run_kernel, st, buf.clone, 20,
                                                   "fast_event_block_surface")
            s_in, b_in, u_s, u_iw = stage_in[0]
            r["stage_plain_ms"] = time_block_ms(lambda s_, b_: resolve(spec, pro, s_, b_, u_s,
                                                                       u_iw), s_in, b_in.clone, 5)
            r["stage_bound"] = bound_ms(variant(spec), 0, 0,
                                        **bounce_work(spec, L_CHECK, r["hits"]))
            fields.update(stage_device_ms=f"{r['stage_device_ms']:.4f}",
                          stage_plain_ms=f"{r['stage_plain_ms']:.4f}",
                          stage_bound_ms=f"{r['stage_bound'][0]:.4f}",
                          stage_bound_by=r["stage_bound"][1])
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


def surfaced_tail_ms(integ, source, dev) -> tuple:
    """(device ms, alive share, the surface stage's kernel's device ms, the
    stage's bound, the whole block's bound) of one whole surfaced block at
    L = 2^18 on a tail state: a trace of 2 L photons run until the budget is
    spent and at most 15% of lanes are alive, then the next block on fresh
    copies; the bounds of its bounce (bounce_work of its bottom hits) and of
    the whole block (its events and the bounce)."""
    from i3rc_tpu_torch import batch_key
    from i3rc_tpu_torch.integrators.fastpath import event_spec, launch_state, prologue_spec
    from i3rc_tpu_torch.kernels import event_block as eb
    from i3rc_tpu_torch.kernels.event_block import (ALIVE, EVCT, ORDERS, PK, block_buffers,
                                                     fused_block)

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
    stage_ms = device_block_ms(lambda s, b: fused_block(spec, pro, s, b, key, source, kb), st,
                               buf.clone, 20, "fast_event_block_surface")
    # The block's bottom hits and revivals, from the plain version's stage,
    # and its lane-events and collisions: the bounds of the stage and of the
    # whole block (as fused_vs_reference counts them).
    hits, resolve = [], eb.resolve_surface

    def counted(sp, pr, s, b, *u):
        n0 = int(s.i[ALIVE].sum())
        hits.append(int((s.i[PK] == 2).sum()))
        resolve(sp, pr, s, b, *u)
        hits.append(int(s.i[ALIVE].sum()) - n0)

    ref = st.clone()
    eb.resolve_surface = counted
    try:
        eb.fused_block_reference(spec, pro, ref, buf.clone(), key, source, kb)
    finally:
        eb.resolve_surface = resolve
    dead0 = st.i[ALIVE] == 0
    ran = ref.i[EVCT] > st.i[EVCT]
    events = int((ref.i[EVCT] - st.i[EVCT]).sum())
    collisions = int((ref.i[ORDERS] - torch.where(dead0 & ran, 0, st.i[ORDERS])).sum()) - hits[1]
    n_bytes = state_bytes(spec, L_CHECK, int(ran.sum())) + PROLOGUE_BYTES_PER_LANE * L_CHECK
    whole = bound_ms(variant(spec), events, n_bytes, collisions,
                     spec.det.n if spec.det is not None else 0,
                     **bounce_work(spec, L_CHECK, hits[0]))
    bound = bound_ms(variant(spec), 0, 0, **bounce_work(spec, L_CHECK, hits[0]))
    return ms, alive, stage_ms, bound, whole


def surface_block_checks(dev, card: str) -> tuple[dict, dict]:
    """Phase 4d: the whole block over a reflecting surface, kernel against
    plain version (fused_vs_reference): a Lambertian albedo on the flux
    (thin cirrus, and the absorbing step cloud with the volume tally),
    detector, gas and column variants, and each BRDF on the flux and
    detector variants over the cirrus, whose lanes mostly reach the surface
    (at least 10% hit it in the block), and the 13-detector scan of phase
    24; then both instantiations of the surface stage after the event
    variants (surface_stage_checks).  Returns the timed records (the
    glint row's Cox-Munk flux block and the RPV radiance block of phase 23,
    each with its tail and its surface stage's kernel alone; "cases": how
    many cases surface_stage_checks ran) and the largest state
    error by variant."""
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
            (r["tail_ms"], r["tail_alive"], r["tail_stage_ms"], r["tail_stage_bound"],
             r["tail_bound"]) = surfaced_tail_ms(integ, src, dev)
            say(phase, case=name, state="tail", alive=f"{r['tail_alive']:.4f}",
                fused_device_ms=f"{r['tail_ms']:.4f}", bound_ms=f"{r['tail_bound'][0]:.4f}",
                bound_by=r["tail_bound"][1], stage_device_ms=f"{r['tail_stage_ms']:.4f}",
                stage_bound_ms=f"{r['tail_stage_bound'][0]:.4f}", card=json.dumps(card))
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
    cox = SurfaceDescription.uniform(SURFACE_BRDFS["cox_munk"], brdf_name="cox_munk")
    run("cox_munk-scan-glint", make(glint_scene(), flux, surface=cox,
                                    intensity_mus=[SCAN_MU] * len(SCAN_PHIS),
                                    intensity_phis=SCAN_PHIS), sun)
    timed["cases"] = surface_stage_checks(dev, card)
    return timed, err


def surface_stage_checks(dev, card: str) -> int:
    """Phase 4d: both instantiations of the surface stage's kernel (FK or
    not) after the event variants, against the plain version.  Every seventh
    case of tests/surface_scenes.py (the table cases, their HG twins and the
    fused-k cases, each over one of the five surfaces in turn; the test file
    runs them all) and the 13-detector scan of phase 24, at TABLE_CASE_LANES
    lanes and 4x the photons, each on its launch, mid-flight and tail
    states: every lane-state row and the lane weight, the control state and
    the dead counts bit for bit, the flux, volume, detector and
    surface-radiance tallies within 1e-9, no exit pending after the block.
    Returns the cases that ran."""
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, SurfaceDescription,
                                batch_key)

    ss = _load_tests_module("surface_scenes")
    src = PhotonSource.directional(0.5, 0.0)
    cases = {name: (lambda n=name: ss.case_integrator(n, dev), fused)
             for name, (_, _, _, fused) in list(ss.surface_cases().items())[::7]}
    cox = SurfaceDescription.uniform(SURFACE_BRDFS["cox_munk"], brdf_name="cox_munk")
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                           compute_volume_absorption=False)
    cases["scan_13_detectors"] = (lambda: Integrator.create(
        glint_scene(), cfg, surface=cox, intensity_mus=[SCAN_MU] * len(SCAN_PHIS),
        intensity_phis=SCAN_PHIS, device=dev), False)
    kinds, n_states, worst = set(), 0, 0.0
    for name, (make, fused) in cases.items():
        key = batch_key(SEED, 1300)
        spec, pro, states = ss.trace_states(make(), src, 4 * TABLE_CASE_LANES,
                                            TABLE_CASE_LANES, key, fused)
        check(spec.reflecting, f"4d {name}: no reflecting surface")
        for state, st, buf, kb in states:
            r = ss.block_vs_twin(spec, pro, st, buf, key, src, kb)
            check(r["bit_equal"] and r["tally_rel_err"] <= 1e-9 and r["pending_after"] == 0,
                  f"4d {name} {state}: {r}")
            worst = max(worst, r["tally_rel_err"])
            n_states += 1
        kinds.add((spec.fused, spec.surface.kind, spec.table, spec.det is not None))
    check({k[0] for k in kinds} == {False, True} and len({k[1] for k in kinds}) == 5,
          f"4d: the cases ran {sorted(kinds)}")
    say("4d surface-stage-vs-plain", cases=len(cases), states=n_states,
        kinds=len(kinds), bit_equal=True, tally_rel_err=f"{worst:.3e}", card=json.dumps(card))
    return len(cases)


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
    surface_stage_record(tag, pb, bk, n, L_CHECK, card)
    rate = n / sorted(times)[1]
    return results, launches, bk, dict(seconds=",".join(f"{t:.4f}" for t in times),
                                       photons_per_s=f"{rate:.4e}")


def surface_stage_record(tag: str, pb: dict, bk: dict, n: int, lanes: int, card: str) -> dict:
    """The surface stage on its own over one batch: its kernel's device time
    from the profiled batch ``pb`` (the same key as batch_kernel_time's
    ``bk``, so the same photons) beside the bound of its work alone, the
    bottom hits' bytes and operations (bounce_work).  Stored in
    bk["stage"]."""
    spec = bk["spec"]
    stage = bound_ms(variant(spec), 0, 0, **bounce_work(spec, lanes * pb["surface_launches"],
                                                         bk["hits"]))
    bk["stage"] = {"ms": pb["surface_ms"], "launches": pb["surface_launches"], "bound": stage}
    say(f"{tag}-surface-stage", photons=n, launches=pb["surface_launches"],
        kernel_ms_per_batch=f"{pb['surface_ms']:.3f}",
        us_per_launch=f"{1e3 * pb['surface_ms'] / max(pb['surface_launches'], 1):.2f}",
        hits=bk["hits"], bound_ms=f"{stage[0]:.4f}", bound_by=stage[1], card=json.dumps(card))
    return bk


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
    res, launches, bk, rate = surface_path("22 albedo", integ, src, SURFACE_PHOTONS, card, 820,
                                           "surface_launches")
    rec["albedo"] = (launches, bk)
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
    res, launches, bk, rate = surface_path("24 ocean-glint-scan", integ, sun, SURFACE_PHOTONS,
                                           card, 860, "detector_surface_launches")
    rec["scan"] = (launches, bk)
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


# ---------------------------------------------------------------------------
# 64-68. The kernels' reach (ROADMAP item 22) and the profiler (item 20):
# collision chains past depth 3 (the event block's runtime-depth variant,
# csrc/fast_event_block_deep.cu), more than 16 detectors (G+E), more than
# 254 components with detectors (G's 16-bit tally slot), the sharded
# tracer's sources that are not uniform in x (SD's refill from a source
# queue), and the drivers' --profile.

DEEP_DEPTHS = (4, 6)                # the main path's runtime depths (K1), beside depth 2
DEEP_BATCHES = 2                    # batches of SLICE_PHOTONS a depth
DEEP_GAS_PHOTONS = 1 << 22          # K2 at depth 4 against its auto depth 3, a batch
WIDE_PHOTONS, WIDE_BATCHES = 1 << 20, 4     # 32 detectors on G+E
COMP_N = 300                        # components of the split step cloud
COMP_PHOTONS, COMP_BATCHES = 1 << 20, 4     # 300 components against one, each side
SOURCE_PHOTONS = 1 << 21            # the sharded spotlight and internal source on Landsat
SOURCE_LANES = 1 << 20
# The runtime-depth instantiations a set (chip_smoke.ptxas_by_variant).
DEEP_SETS = {"deep_flux": 4, "deep_gas_flux": 4, "deep_table_flux": 4,
             "deep_table_gas_flux": 4, "deep_column_flux": 2, "deep_table_column_flux": 2}
# The x-uniform sharded trace's digest as the tree before the source queue
# gave it on the card (tests/test_torch_reach_cuda.py X_UNIFORM_CARD).
X_UNIFORM_DIGEST = "f01d19b6b571c187"


def reach_kernel_vs_twin(dev, card: str) -> dict:
    """Phase 64: every runtime-depth instantiation against its plain version
    (tests/reach_scenes.py deep_cases: the whole block at a launch, a
    mid-flight and a tail state, bit for bit); G+E with 300 components and
    with 32 detectors against its plain version (launch and mid-flight
    blocks at 2^16 lanes); SD's refill from a source queue (a spotlight and
    an internal source on Landsat, a world of one) against its plain
    version; and the x-uniform sharded trace's digest against the tree
    before the source queue."""
    from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource, batch_key
    from i3rc_tpu_torch.models.step_cloud import make_step_cloud

    rs, ss = _load_tests_module("reach_scenes"), _sharded_scenes()
    err = {"flux": 0.0, "gas": 0.0, "column": 0.0}
    seen = set()
    for name in sorted(rs.deep_cases()):
        rows = rs.deep_vs_twin(name, dev, TABLE_CASE_LANES)
        kind = "column" if name.startswith("col_") else "gas" if "gas_" in name else "flux"
        for r in rows:
            check(r["bit_equal"] and r["acc_rel_err"] == 0.0, f"64 deep {name} {r['state']}: {r}")
            err[kind] = max(err[kind], r["max_abs_err"])
            seen.add(r["instantiation"])
        say("64 deep-vs-twin", case=name, chain=rows[0]["chain"],
            instantiation=rows[0]["instantiation"], states=len(rows), bit_equal=True,
            lane_events=sum(r["lane_events"] for r in rows), lanes=TABLE_CASE_LANES,
            card=json.dumps(card))
    check(len(seen) == sum(DEEP_SETS.values()) and all(i.startswith("ILin1E") for i in seen),
          f"64 runtime-depth instantiations {sorted(seen)}")
    h = rs.host("i3rc_tpu_torch")
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500, compute_volume_absorption=False)
    src = PhotonSource.directional(0.5, 0.0)
    ge_err = 0.0
    for tag, dom, (mus, phis) in (
            ("components_300", rs.split_components(h, make_step_cloud(1.0), COMP_N),
             (DET_MUS, DET_PHIS)),
            ("detectors_32", make_step_cloud(1.0), rs.scan(32))):
        integ = Integrator.create(dom, cfg, intensity_mus=mus, intensity_phis=phis, device=dev)
        check(integ._fast_plan is None, f"64 {tag}: a fastpath plan")
        for state in ("launch", "mid"):
            r = rs.general_vs_twin(integ, src, RAD_CASE_LANES, batch_key(SEED, 64), state)
            check(r["lanes_differ"] == 0 and r["equal"] and r["tally_rel_err"] <= 1e-9
                  and r["rays"] > 0, f"64 G+E {tag} {state}: {r}")
            check(tag != "components_300" or r["top_slot"] > 255, f"64 G+E slots {r}")
            ge_err = max(ge_err, r["max_abs_err"])
            say("64 general-vs-twin", case=tag, state=state, lanes=RAD_CASE_LANES, **r,
                card=json.dumps(card))
    sd = {"err": 0.0, "tally_err": 0.0}
    sc = ss.scene("landsat", ss.host("i3rc_tpu_torch"), 2)
    for name in sorted(ss.NON_UNIFORM_SOURCES):
        st = ss.trace_states(sc, 1 << 18, 1 << 16, dev, source=ss.photon_source(name))
        raw = st["raw"]
        total = float(raw.flux_up.sum() + raw.flux_down.sum() + raw.flux_absorbed.sum())
        check(len(st["block"]) == 2 and total + int(raw.n_bad) == 1 << 18,
              f"64 SD {name}: {len(st['block'])} states, {total} + {int(raw.n_bad)}")
        for r in ss.states_vs_twins(st):
            _twin_record(sd, r, f"64 SD {name}")
            say("64 source-queue-vs-twin", source=name, **_twin_fields(r), card=json.dumps(card))
    digest = ss.x_uniform_digest(dev)
    check(digest == X_UNIFORM_DIGEST, f"64 x-uniform sharded digest {digest}")
    say("64 x-uniform-sharded", digest=digest, unchanged=True, card=json.dumps(card))
    return {"err": err, "ge_err": ge_err, "sd_err": sd["err"]}


def _batches(fn, seed0: int, n_batches: int) -> tuple[list, list]:
    """n batches of ``fn``: their Results and host seconds."""
    from i3rc_tpu_torch import batch_key

    out, times = [], []
    for b in range(n_batches):
        t0 = time.perf_counter()
        res = fn(batch_key(SEED, seed0 + b))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        out.append(res)
    return out, times


def deep_paths(card: str) -> dict:
    """Phase 65: the runtime-depth variant on its paths at full width.  The
    main path (the step cloud, K1, 2^24 photons at 2^18 lanes) at chain depth
    2 (the templated instantiation), 4 and 6: closure within 1e-5, n_bad 0,
    Fup within 5 sigma (floor 1e-3) of the anchor, the kernel's device ms a
    batch; the gas step cloud (K2) at its auto depth 3 and at 4, and Landsat
    (COL, 2^23) at depth 2 and 4, each pair within 5 combined sigma; then
    one block of each runtime-depth kernel against its plain version at
    2^18 lanes, full and tail (K1 at 4 and 6, K2 at 4 and 6, COL at 4),
    timed.  Each path's launch counts are set to 0 just before it runs."""
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, batch_key,
                                make_landsat_cloud, make_step_cloud)
    from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component
    from i3rc_tpu_torch.kernels import event_block as eb

    dev = torch.device("cuda", 0)
    src = PhotonSource.directional(0.5, 0.0)
    rec = {"launches": {}, "batch": {}, "timed": {}, "chain": {}}

    def path(tag, dom, depth, n, n_batches, seed0, counter, timed=True, profile=True):
        cfg = IntegratorConfig(use_ray_tracing=False, max_events=500, fastpath_chain=depth,
                               compute_volume_absorption=False)
        integ = Integrator.create(dom, cfg, device="cuda")
        fn = integ.batch_fn(src, n, n_lanes=L_CHECK)
        fn(batch_key(SEED, seed0 + 9))
        torch.cuda.synchronize()
        eb.reset_launch_counters()
        res, times = _batches(fn, seed0, n_batches)
        launches = getattr(eb.event_block, counter)
        check(launches > 0, f"65 {tag} depth {depth}: no {counter}")
        parts = np.array([[float(r.mean_flux_up), float(r.mean_flux_down),
                           float(r.mean_flux_absorbed)] for r in res])
        for r, pr in zip(res, parts):
            check(abs(pr.sum() - 1.0) < 1e-5, f"65 {tag} depth {depth} closure {pr}")
            check(int(r.n_bad) < 1e-3 * n, f"65 {tag} depth {depth} n_bad {int(r.n_bad)}")
        bk = None
        if timed:
            key = batch_key(SEED, seed0 + 8)
            tracer = integ.batch_tracer(n, L_CHECK)
            bk = batch_kernel_time(lambda: tracer(key, src.sample(key, L_CHECK, "cuda"), src),
                                   profile=profile)
        out = {"fluxes": parts.mean(0), "n": n * n_batches, "launches": launches,
               "photons_per_s": n / sorted(times)[len(times) // 2], "bk": bk}
        say("65 deep-path", path=tag, depth=depth, photons=n, batches=n_batches, lanes=L_CHECK,
            fup=f"{out['fluxes'][0]:.6f}", fdn=f"{out['fluxes'][1]:.6f}",
            fabs=f"{out['fluxes'][2]:.6f}", launches=launches, counter=counter,
            photons_per_s=f"{out['photons_per_s']:.4e}",
            **({} if bk is None else dict(batch_kernel_ms=f"{bk['kernel_ms']:.3f}",
                                          batch_bound_ms=f"{bk['bound'][0]:.3f}",
                                          batch_launches=bk["launches"])),
            card=json.dumps(card))
        return out

    def agree(tag, a, b, what=(0, 1, 2)):
        for k in what:
            p = (a["fluxes"][k] + b["fluxes"][k]) / 2
            sigma = np.sqrt(max(p * (1 - p), 1e-4) * (1 / a["n"] + 1 / b["n"]))
            check(abs(a["fluxes"][k] - b["fluxes"][k]) <= 5 * sigma,
                  f"65 {tag}: {a['fluxes']} against {b['fluxes']} (sigma {sigma:.2e})")

    # K1: the main path at depth 2, 4 and 6
    k1 = {d: path("step_cloud", make_step_cloud(1.0), d, SLICE_PHOTONS, DEEP_BATCHES, 650 + 10 * d,
                  "deep_launches" if d > 3 else "launches") for d in (2, *DEEP_DEPTHS)}
    sigma = (ANCHOR_FUP * (1 - ANCHOR_FUP) / (DEEP_BATCHES * SLICE_PHOTONS)) ** 0.5
    for d, r in k1.items():
        check(abs(r["fluxes"][0] - ANCHOR_FUP) <= max(5 * sigma, 1e-3), f"65 K1 depth {d} {r}")
    rec["launches"]["flux"], rec["chain"]["flux"] = k1[4]["launches"], 4
    rec["batch"]["flux"] = {d: r["bk"] for d, r in k1.items()}
    # K2: the gas step cloud at its auto depth 3 and at 4
    gas_dom = domain_with_gas_component(make_step_cloud(0.99), LAYERED_GAS)
    k2 = {d: path("gas_step_cloud", gas_dom, d, DEEP_GAS_PHOTONS, DEEP_BATCHES, 700 + 10 * d,
                  "deep_gas_launches" if d > 3 else "gas_launches") for d in (3, 4)}
    agree("K2 depth 4 against 3", k2[4], k2[3])
    rec["launches"]["gas"], rec["chain"]["gas"] = k2[4]["launches"], 4
    rec["batch"]["gas"] = {d: r["bk"] for d, r in k2.items()}
    # COL: Landsat at depth 2 and 4 (K = 32)
    land = make_landsat_cloud(1.0)
    col = {d: path("landsat", land, d, LANDSAT_PHOTONS, DEEP_BATCHES, 750 + 10 * d,
                   "deep_column_launches" if d > 3 else "column_launches", profile=False)
           for d in (2, 4)}
    agree("COL depth 4 against 2", col[4], col[2], (0,))
    rec["launches"]["column"], rec["chain"]["column"] = col[4]["launches"], 4
    rec["batch"]["column"] = {d: r["bk"] for d, r in col.items()}
    # One block of each runtime-depth kernel against its plain version, timed.
    for kind, kw in (("flux", dict(ssa=1.0)), ("gas", dict(ssa=0.99, gas=LAYERED_GAS)),
                     ("column", dict(ssa=1.0, chain=4))):
        for depth in ((4,) if kind == "column" else DEEP_DEPTHS):
            args = dict(kw) if kind == "column" else dict(kw, step_chain=depth)
            ssa = args.pop("ssa")
            spec, results = kernel_vs_twin(ssa, dev, **args)
            check(spec.chain == depth, f"65 {kind} spec chain {spec.chain}")
            for r in results:
                check_block(f"65 {kind} depth {depth}", r)
                say("65 deep-kernel-vs-twin", kind=kind, **block_fields(spec, r, card))
            if depth == 4:
                rec["timed"][kind] = results
    return rec


def general_reach_paths(card: str) -> dict:
    """Phase 66: G+E past the event block's reach at full width.  The step
    cloud with 32 detectors (the three I3RC directions and a scan of 29;
    no fastpath plan, so the general kernel's estimate stage runs it; exact
    estimator, WIDE_BATCHES x 2^20 photons at 2^20 lanes): the I3RC
    directions within 1% + 5 standard errors of their anchors, and G's
    device ms a batch (the profiler); the step cloud split into 300
    components of equal optics against the one-component cloud (each
    COMP_BATCHES x 2^20, both on G+E): each detector within 5 combined
    standard errors, weight in the slots past 255, and G's device ms a
    batch of each."""
    from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource, batch_key
    from i3rc_tpu_torch.kernels import general_block as gb
    from i3rc_tpu_torch.models.step_cloud import make_step_cloud
    from i3rc_tpu_torch.parallel.mesh import run_batches

    rs = _load_tests_module("reach_scenes")
    h = rs.host("i3rc_tpu_torch")
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500, compute_volume_absorption=False)
    src = PhotonSource.directional(0.5, 0.0)
    derive = lambda r: {"I": r.intensity.mean(dim=(0, 1)), "fup": r.mean_flux_up,
                        "fdn": r.mean_flux_down}
    out = {}
    mus, phis = rs.scan(32)
    integ = Integrator.create(make_step_cloud(1.0), cfg, intensity_mus=mus, intensity_phis=phis,
                              device="cuda")
    check(integ._fast_plan is None, "66 32 detectors: a fastpath plan")
    gb.reset_launch_counters()
    t0 = time.perf_counter()
    st = run_batches(integ, src, WIDE_PHOTONS, WIDE_BATCHES, seed=SEED, n_lanes=GENERAL_LANES,
                     derive=derive)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = gb.general_block.det_launches
    check(launches > 0, "66 32 detectors: no G+E launch")
    mean, err = st.mean["derived"]["I"].cpu().numpy(), st.stderr["derived"]["I"].cpu().numpy()
    fup, fdn = float(st.mean["derived"]["fup"]), float(st.mean["derived"]["fdn"])
    check(abs(fup + fdn - 1.0) < 1e-5, f"66 32 detectors closure {fup + fdn}")
    for d, anchor in enumerate(ANCHOR_I):
        check(abs(mean[d] - anchor) <= 0.01 * anchor + 5 * err[d],
              f"66 32 detectors: I[{d}] {mean[d]} +- {err[d]}, anchor {anchor}")
    fn = integ.batch_fn(src, WIDE_PHOTONS, n_lanes=GENERAL_LANES)
    found, _ = traced(lambda: fn(batch_key(SEED, 666)), 1, "general_event_block_kernel",
                      "general_event_block_kernel")
    batch_ms = sum(e.self_device_time_total for e in found) / 1e3
    check(batch_ms > 0.0, "66 32 detectors: the profiler shows no G+E time")
    out["wide"] = {"launches": launches, "batch_ms": batch_ms,
                   "photons_per_s": WIDE_BATCHES * WIDE_PHOTONS / seconds}
    say("66 detectors-32", photons=WIDE_PHOTONS, batches=WIDE_BATCHES, lanes=GENERAL_LANES,
        route="G+E", fup=f"{fup:.6f}", i3rc=",".join(f"{v:.5f}" for v in mean[:3]),
        i3rc_stderr=",".join(f"{v:.1e}" for v in err[:3]), launches=launches,
        g_device_ms_per_batch=f"{batch_ms:.3f}", photons_per_s=f"{out['wide']['photons_per_s']:.4e}",
        card=json.dumps(card))
    res = {}
    # The one-component cloud has a fastpath plan (K3): it runs on G+E too.
    general = replace(cfg, use_fastpath=False)
    for tag, dom in (("one", make_step_cloud(1.0)),
                     ("split", rs.split_components(h, make_step_cloud(1.0), COMP_N))):
        integ = Integrator.create(dom, general, intensity_mus=DET_MUS, intensity_phis=DET_PHIS,
                                  device="cuda")
        split = {}

        def keep(r):
            split["byc"] = r.intensity_by_component
            return derive(r)

        gb.reset_launch_counters()
        st = run_batches(integ, src, COMP_PHOTONS, COMP_BATCHES, seed=SEED + 1,
                         n_lanes=GENERAL_LANES, derive=keep)
        check(gb.general_block.det_launches > 0, f"66 {tag}: no G+E launch")
        fn = integ.batch_fn(src, COMP_PHOTONS, n_lanes=GENERAL_LANES)
        found, _ = traced(lambda: fn(batch_key(SEED, 667)), 1, "general_event_block_kernel",
                          "general_event_block_kernel")
        res[tag] = (st.mean["derived"]["I"].cpu().numpy(), st.stderr["derived"]["I"].cpu().numpy(),
                    split["byc"], sum(e.self_device_time_total for e in found) / 1e3)
    (a, ea, _, ms_one), (b, eb_, byc, ms_split) = res["one"], res["split"]
    check(np.all(np.abs(a - b) <= 5 * np.hypot(ea, eb_)), f"66 300 components {b} vs {a}")
    high = float(byc[..., 256:].abs().sum())
    check(byc.shape[-1] == COMP_N + 1 and high > 0.0, f"66 slots past 255: {high}")
    out["components"] = {"one": a.tolist(), "split": b.tolist(), "one_ms": ms_one,
                         "split_ms": ms_split}
    say("66 components-300", photons=COMP_PHOTONS, batches=COMP_BATCHES,
        one=",".join(f"{v:.5f}" for v in a), split=",".join(f"{v:.5f}" for v in b),
        stderr=",".join(f"{v:.1e}" for v in np.hypot(ea, eb_)),
        weight_past_slot_255=f"{high:.4e}", g_device_ms_per_batch_one=f"{ms_one:.3f}",
        g_device_ms_per_batch_split=f"{ms_split:.3f}", card=json.dumps(card))
    return out


def chip_source_job(mesh) -> dict:
    """A rank's job in phase 67: the spotlight and the internal source on
    the Landsat scene through trace_sharded (source_cases), with SD's
    launches counted."""
    ss = _sharded_scenes()
    from i3rc_tpu_torch.kernels import sharded_block as sb

    sb.reset_launch_counters()
    t0 = time.perf_counter()
    out = ss.source_cases(mesh, "landsat", sorted(ss.NON_UNIFORM_SOURCES), SOURCE_PHOTONS,
                          SOURCE_LANES, SEED)
    torch.cuda.synchronize()
    return {"cases": out, "sd": sb.sharded_event_block.launches,
            "seconds": time.perf_counter() - t0, "rank": mesh.rank}


def sharded_source_paths(card: str) -> dict:
    """Phase 67: the sharded tracer with a spotlight and an internal source
    spread across both slabs, on Landsat at 2^21 photons: two gloo ranks
    sharing the card (spawned, alone on it), then one NCCL rank; each
    launches n photons in all (sum(flux) + n_bad == n), and its fluxes
    agree with the unsharded port (COL) within 5 combined sigma."""
    import torch.distributed as dist

    from i3rc_tpu_torch import Integrator, IntegratorConfig, make_landsat_cloud
    from i3rc_tpu_torch.parallel.mesh import default_mesh

    ss = _sharded_scenes()
    torch.cuda.synchronize()
    two = ss.join_world(ss.start_world(2, chip_source_job, (), device="cuda:0"), timeout=600)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        one = [chip_source_job(default_mesh(device=torch.device("cuda", 0)))]
    finally:
        dist.destroy_process_group()
    integ = Integrator.create(make_landsat_cloud(0.99),
                              IntegratorConfig(use_ray_tracing=False, max_events=500,
                                               compute_volume_absorption=False), device="cuda")
    n = SOURCE_PHOTONS
    rec = {"sd": {"two": sum(r["sd"] for r in two), "one": one[0]["sd"]}}
    for name in sorted(ss.NON_UNIFORM_SOURCES):
        res = integ.batch_fn(ss.photon_source(name), n, n_lanes=L_CHECK)(batch_key_(670))
        ref = [float(res.mean_flux_up), float(res.mean_flux_down), float(res.mean_flux_absorbed)]
        for world, ranks in (("two_gloo", two), ("one_nccl", one)):
            a = ranks[0]["cases"][name]
            got = [float(a[k].sum()) / n for k in ("flux_up", "flux_down", "flux_absorbed")]
            budgets = [r["cases"][name]["budget"] for r in ranks]
            check(sum(budgets) == n and a["n_photons"] == n
                  and int(round(sum(got) * n)) + a["n_bad"] == n,
                  f"67 {name} {world}: budgets {budgets}, {got}, n_bad {a['n_bad']}")
            check(name != "spotlight" or len(ranks) == 1 or sorted(budgets) == [0, n],
                  f"67 spotlight budgets {budgets}")
            for g, p in zip(got, ref):
                sigma = np.sqrt(max(p * (1 - p), 1e-4) * 2 / n)
                check(abs(g - p) <= 5 * sigma, f"67 {name} {world}: {got} against {ref}")
            say("67 sharded-source", source=name, world=world, photons=n, budgets=budgets,
                fup=f"{got[0]:.6f}", fdn=f"{got[1]:.6f}", fabs=f"{got[2]:.6f}",
                unsharded=",".join(f"{v:.6f}" for v in ref), n_bad=a["n_bad"],
                migrations=int(a["migrations"]), sd_launches=sum(r["sd"] for r in ranks),
                seconds=f"{max(r['seconds'] for r in ranks):.2f}", card=json.dumps(card))
            check(sum(r["sd"] for r in ranks) > 0, f"67 {world}: no SD launch")
    return rec


def profile_driver(out: Path, card: str) -> dict:
    """Phase 68: the monteCarlo driver with --profile on the shipped
    step-cloud namelist (from the directory that holds its domains): the
    printed table names the event block with device time above 0."""
    prof = out / "profile"
    shutil.rmtree(prof, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "i3rc_tpu_torch.drivers.monte_carlo_driver", "--profile",
         str(prof), str(ROOT / "examples" / "monteCarloDriver_stepCloud.nml")],
        cwd=out, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True,
        timeout=600)
    check(proc.returncode == 0, f"68 --profile driver failed: {proc.stderr[-2000:]}")
    table = [ln for ln in proc.stderr.splitlines() if ln.startswith("#")]
    row = next((ln for ln in table if "event block (K1" in ln), "")
    ms = re.search(r"([0-9.]+) ms", row)
    check(bool(ms) and float(ms[1]) > 0.0, f"68 --profile table: {table}")
    say("68 profile", rows=len(table) - 1, event_block_ms=ms[1],
        header=json.dumps(table[0] if table else ""), seconds=f"{time.perf_counter() - t0:.1f}",
        card=json.dumps(card))
    return {"event_block_ms": float(ms[1]), "table": table}


def deep_entry(kind: str, checks: dict, rec: dict) -> dict:
    """The kernels-line entry of a runtime-depth kernel (K1, K2 or COL at
    depth 4): launches on its phase-65 path (counts set to 0 just before
    it), the largest difference to its plain version (phases 64-65), one
    block's device time at 2^18 lanes (full; the tail beside it), its plain
    version's time and bound, and its batch's device time beside the batch
    at the templated depth (2; K2's auto 3)."""
    full, tail = rec["timed"][kind]
    batches = rec["batch"][kind]
    deep = batches[rec["chain"][kind]]
    shallow_depth = min(batches)
    return {"name": {"flux": "fast_event_block_deep", "gas": "fast_event_block_gas_deep",
                     "column": "fast_event_block_column_deep"}[kind],
            "route": "cuda", "source": "i3rc_tpu_torch/csrc/fast_event_block_deep.cu",
            "replaces": {
                "flux": "i3rc_tpu/integrators/fastpath.py:665 (fastpath_chain > 3, :1283-1286)",
                "gas": "i3rc_tpu/integrators/fastpath.py:665 (gas=True, fastpath_chain > 3)",
                "column": "benchmarks/column_read_probe.py:83 (the column event of "
                          "i3rc_tpu/integrators/fastpath.py:1320, fastpath_chain > 3)"}[kind],
            "launches": rec["launches"][kind],
            "max_abs_err": max(checks["err"][kind], full["max_abs_err"], tail["max_abs_err"]),
            "ms": full["device_ms"], "plain_ms": full["twin_ms"], "bound_ms": full["bound"][0],
            "bound_by": full["bound"][1], "library_ms": None, "chain": rec["chain"][kind],
            "tail_ms": tail["device_ms"], "tail_plain_ms": tail["twin_ms"],
            "tail_bound_ms": tail["bound"][0],
            "batch_ms": deep["kernel_ms"], "batch_bound_ms": deep["bound"][0],
            "batch_launches": deep["launches"], "templated_chain": shallow_depth,
            "templated_batch_ms": batches[shallow_depth]["kernel_ms"]}


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
    from i3rc_tpu_torch.kernels import polarized_block as pb
    from i3rc_tpu_torch.kernels import sharded_block as sdb

    with ThreadPoolExecutor(3) as pool:
        general_built = pool.submit(gb.build)
        polarized_built = pool.submit(pb.build)
        sharded_built = pool.submit(sdb.build)
        built = eb.build()
        gbuilt = general_built.result()
        pbuilt = polarized_built.result()
        sbuilt = sharded_built.result()
    sptx = ptxas_sharded(sbuilt.log)
    say("2 build-sharded", seconds=f"{sbuilt.seconds:.1f}", library=sbuilt.path.name,
        **{k: PTXAS_FMT.format(**v) for k, v in sorted(sptx.items())})
    # SD (the whole block) and SB (the shadow rays): both built, neither
    # spilling.
    check(sorted(sptx) == ["SB", "SD"], f"sharded kernels {sorted(sptx)}")
    for name, v in sptx.items():
        check(v.get("spill_store_bytes", 1) == 0 and v.get("ctas_per_sm", 0) >= 1,
              f"sharded {name}: {v}")
    pptx = ptxas_polarized(pbuilt.log)
    say("2 build-polarized", seconds=f"{pbuilt.seconds:.1f}", library=pbuilt.path.name,
        instantiations=len(pptx),
        **{k: PTXAS_FMT.format(**v) + f"(before:{BEFORE_QUEUE_PTXAS['pz_' + k]})"
           for k, v in sorted(pptx.items())})
    # PZ: the four instantiations, each at 3 CTAs per SM or more, none
    # spilling.
    check(sorted(pptx) == sorted(pb.VARIANTS), f"PZ instantiations {sorted(pptx)}")
    for name, v in pptx.items():
        check(v.get("ctas_per_sm", 0) >= 3, f"PZ {name}: {v}")
        check(v.get("spill_store_bytes", 1) == 0, f"PZ {name} spills: {v}")
    gptx = ptxas_general(gbuilt.log)
    check(len(gptx) == 26, f"general kernel instantiations {sorted(gptx)}")
    say("2 build-general", seconds=f"{gbuilt.seconds:.1f}", library=gbuilt.path.name,
        instantiations=len(gptx),
        **{k: PTXAS_FMT.format(**v)
           + (f"(before:{BEFORE_QUEUE_PTXAS[k]})" if k in BEFORE_QUEUE_PTXAS else "")
           for k, v in sorted(gptx.items())})
    # <= 64 registers keeps 4 CTAs of 256 threads on an SM; the flux
    # instantiations spill nothing.
    for name, v in gptx.items():
        check(v.get("registers", 256) <= 64 and v.get("ctas_per_sm", 0) == 4,
              f"general {name}: {v}")
        if not name.endswith("_det"):
            check(v.get("spill_store_bytes", 1) == 0, f"general {name} spills: {v}")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", built.log)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", built.log))
    n_inst = len(re.findall(r"Compiling entry function '\w*fast_event_block_kernelILi",
                            built.log))
    by_variant = ptxas_by_variant(built.log)
    march_ptx = ptxas_march(built.log)
    stage_ptx = ptxas_surface(built.log)
    say("2 build", seconds=f"{built.seconds:.1f}", library=built.path.name,
        instantiations=n_inst, max_registers=max(regs) if regs else "n/a",
        spill_store_bytes=spills, **by_variant,
        **{k: "{count}x/{registers}regs/{stack_bytes}Bstack/{spill_store_bytes}Bspill/"
              "{ctas_per_sm}cta".format(**v) for k, v in march_ptx.items()},
        **{k: PTXAS_FMT.format(**v) + f"(before:{SURFACE_BEFORE_PTXAS.get(k, 'none')})"
           for k, v in stage_ptx.items()})
    # 88 HG instantiations, their 88 table twins and the 2 x 28 fused-k ones
    # (and the 20 runtime-depth ones, DEEP_SETS);
    # the HG sets compile to what they were before the table variants, the
    # table sets to what they were before the fused-k ones, and the fused-k
    # sets to what they were before the surface stage's redesign (registers,
    # stack and spill bytes, CTAs per SM, as phase 2 printed them in the
    # last call without).  The surface stage's two instantiations: no spill,
    # and the 5 CTAs per SM they had.
    check(n_inst == 232 + sum(DEEP_SETS.values()), f"event-block instantiations: {n_inst}")
    # The runtime-depth variant (csrc/fast_event_block_deep.cu): its 20
    # instantiations, none spilling; the sets above stay as they were.
    for name, count in DEEP_SETS.items():
        v = by_variant.get(name, "")
        check(v.startswith(f"{count}x/"), f"runtime-depth set {name}: {v}")
    # K3-M: the 24 detector instantiations of each of HG and TAB again, with
    # the marching trace (MARCH); none spills.  The surface stage's third
    # instantiation is its marching one.
    check(sorted(march_ptx) == ["march_detectors", "table_march_detectors"]
          and all(v["count"] == 24 and v["spill_store_bytes"] == 0 for v in march_ptx.values()),
          f"K3-M instantiations {march_ptx}")
    check(sorted(stage_ptx) == ["surface", "surface_fused_k", "surface_march"],
          f"surface stage {stage_ptx}")
    for name, v in stage_ptx.items():
        check((v["ctas_per_sm"] >= 5 or name == "surface_march") and v["spill_store_bytes"] == 0,
              f"surface stage {name}: {v}")
    for name, want in {**HG_PTXAS, **TAB_PTXAS, **FK_PTXAS}.items():
        check(by_variant.get(name) == want, f"set {name}: {by_variant.get(name)}, was {want}")
    for name in ("fused_k_flux", "fused_k_detectors", "table_fused_k_flux",
                 "table_fused_k_detectors"):
        check(by_variant.get(name, "").startswith("4x/" if name.endswith("flux") else "24x/"),
              f"fused-k set {name}: {by_variant.get(name)}")
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ptxas.log").write_text(built.log + gbuilt.log + pbuilt.log + sbuilt.log)
    census = sass_census(built.path)
    ptxas = ptxas_of_census(built.log)
    for name, ops in census.items():
        say("2 sass", instantiation=name, **ptxas.get(name, {}),
            **(ops if isinstance(ops, dict) else {"ops": ops}))
    if "cuobjdump" not in census:
        for name in (*CENSUS, "probe"):
            check(name in census, f"{name} not found in the cuobjdump listing")
        for name in ("detectors_iwabuchi", "gas_detectors", "detectors_iwabuchi_16",
                     "table_detectors_iwabuchi", "march_detectors_iwabuchi"):
            # No compare-and-swap loop: the detector tally has no fp64 shared-
            # memory atomic.  What shared atomics there are, are the
            # prologue's int32 counts, which the flux variant has too, and
            # in K3-M the ray queue's int32 slot counts (march_push).
            ops = ("CAS",) if name.startswith("march") else ("CAS", "ATOMS")
            check(all(census[name][op] == census["flux_chain2"][op] for op in ops),
                  f"{name}: SASS {census[name]}")

    # 3. Philox: known answer, and the kernel's draws equal the torch stream
    kat = eb.kernel_philox_bits(0, 0, 0, 0, 0, 1, dev)[0].tolist()
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    kat_torch = [int(w) for w in philox4x32(zero, zero, zero, zero, 0, 0)]
    expect = [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    check(kat == expect and kat_torch == expect, f"Philox known answer: {kat} {kat_torch}")
    # Each check PHILOX_REPS times: a driver's run once saw n_draws = 9
    # differ, which 120 repeats on fresh builds never showed again.
    for nd in (9, 12) * PHILOX_REPS:
        ku = eb.kernel_philox_uniforms(batch_key(SEED, 3), 11, 8, nd, L_CHECK, dev)
        tu = philox_uniforms(batch_key(SEED, 3), 11, 8, nd, L_CHECK, dev)
        if not torch.equal(ku, tu):
            # say which side is wrong: both against the same stream on the CPU
            ref = philox_uniforms(batch_key(SEED, 3), 11, 8, nd, L_CHECK, "cpu")
            bad = (ku != tu).nonzero()[:4].tolist()
            check(False, f"kernel Philox draws differ from torch (n_draws={nd}): "
                  f"{int((ku != tu).sum())} of {ku.numel()} differ, first (event, draw, lane) "
                  f"{bad}; kernel differs from the CPU stream at {int((ku.cpu() != ref).sum())},"
                  f" torch on the card at {int((tu.cpu() != ref).sum())}")
    say("3 philox", known_answer="ok", checks=2 * PHILOX_REPS,
        bit_equal_draws=PHILOX_REPS * (9 + 12) * 8 * L_CHECK)

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
    broadband_driver(out / "broadband", card)

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

    # 38-44. the table modes (ROADMAP item 15): every table instantiation
    # against its plain version (small cases and each path's own scene),
    # then (f) the C.1 step cloud's flux (K1-T), (g) its radiance (K3-T,
    # exact and Iwabuchi), (h) Landsat with per-column ssa and table entries
    # (COL-P), (i) the bench band over the C.1 cloud (K2-T), (j) the
    # isotropic slab against the oracle, and the radar cloud on G
    t_checks = table_kernel_vs_twin(dev, card, built.log)
    t_rec = table_paths(out, card)

    # 45-50. fused-k spectral batching (ROADMAP item 13b): every fused-k
    # instantiation against its plain version (small cases and each path's
    # own scene), then the bench band fused at full width (46) and the C.1
    # band (47), each against the baked band, the three I3RC detectors (48),
    # heating rates (49), an internal source against its closed form and the
    # bench band over an albedo (50)
    fk_checks = fused_k_kernel_vs_twin(dev, card, built.log)
    fk_rec = fused_k_paths(card)

    # 51-54. polarized transport (ROADMAP item 17): PZ against its plain
    # version on every instantiation (small cases and each path's own
    # scene), then the bench row's Rayleigh atmosphere (52, at the bench's
    # lanes and the port's), the Mie step cloud with the I3RC detectors (53)
    # and the polarized namelist through the driver (54)
    pz_checks = polarized_kernel_vs_twin(dev, card, pptx)
    pz_rec = polarized_paths(out, card)

    # 55-58. the marching shadow trace (ROADMAP item 10b) and the
    # plane-parallel driver (item 18): K3-M and K3-M+S against their plain
    # version (55), the step cloud's closed trace against the marching one
    # (56), a 3-D separable scene with radiance detectors against G's exact
    # trace, and K3-M+S's path over RPV (57), and the shipped planeParallel
    # namelist with copies against the slab oracle on G and K1 and in
    # radiance mode on G+E and K3 (58)
    m_checks = march_kernel_vs_twin(dev, card)
    m_rec = march_paths(card)
    plane_parallel_runs(out, card)

    # 59-63. multi-device runs (ROADMAP item 19): the whole block (SD's
    # launch, then SB's) and SB alone against their plain versions on a
    # mid-flight and a tail state of the surface, volume and detector scenes
    # on a world of one, and of the flux (Landsat) and graft scenes on each
    # rank of the main path's two (59), rank 0's launches timed; the two ranks
    # run alone on the card before this process's runs; run_batches on a world of one NCCL
    # rank (bit for bit against no mesh) and on two gloo ranks sharing the
    # card (1e-12) (60); a resume finished in a second process, exactly
    # (61); the x-sharded tracer over two ranks at full width: the whole
    # Landsat scene against the unsharded fastpath (62) and the graft scene
    # (two components, an albedo, 2 detectors, heating rates) against G+E
    # (63), SD and SB counted on that path, with the host ms a block and
    # the device's idle share
    sd_checks = sharded_kernel_vs_twin(dev, card)
    sd_rec = mesh_paths(out, card)

    # 64-68. the kernels' reach (ROADMAP item 22) and the profiler (item
    # 20): every runtime-depth instantiation, G+E past 255 components and
    # at 32 detectors, SD's refill from a source queue, each against its
    # plain version, and the x-uniform sharded trace unchanged (64); the
    # runtime-depth variant on the main path at chain depth 4 and 6 (K1),
    # on the gas step cloud (K2) and on Landsat (COL) (65); 32 detectors
    # and 300 components on G+E (66); the sharded spotlight and internal
    # source over two gloo ranks and one NCCL rank (67); the monteCarlo
    # driver with --profile (68)
    reach_checks_ = reach_kernel_vs_twin(dev, card)
    deep_rec = deep_paths(card)
    ge_reach = general_reach_paths(card)
    src_rec = sharded_source_paths(card)
    prof_rec = profile_driver(out, card)

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
    say("20 profiler-traces", **PROFILER_TRACES)
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
              "i3rc_tpu/integrators/fastpath.py:665 (gas=True)",
              fk_rec["gas_detectors_baked"],
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
        stage_entry(surf_paths, fk_rec["albedo"], surf_timed, surf_err)] + [
        general_entry(g_timed, g_err, g_rec),
        dict(estimate_entry(e_timed, max(e_err, reach_checks_["ge_err"]), e_rec),
             detectors_32_batch_ms=ge_reach["wide"]["batch_ms"],
             detectors_32_launches=ge_reach["wide"]["launches"])] + [
        table_entry(kind, f"i3rc_tpu_torch/csrc/{src}", replaces, t_rec[kind], t_checks)
        for kind, src, replaces in (
            ("flux", "fast_event_block_tab.cu",
             "i3rc_tpu/integrators/fastpath.py:665 (table mode, fastpath.py:1573)"),
            ("detectors", "fast_event_block_tab.cu",
             "i3rc_tpu/integrators/fastpath.py:665 (n_detectors>0, table mode, "
             "fastpath.py:1508)"),
            ("gas", "fast_event_block_tab_gas.cu",
             "i3rc_tpu/integrators/fastpath.py:665 (gas=True, table mode)"),
            ("column", "fast_event_block_col.cu",
             "benchmarks/column_read_probe.py:83 (column_props, "
             "i3rc_tpu/integrators/fastpath.py:1330)"))] + [
        fused_k_entry(kind, f"i3rc_tpu_torch/csrc/{src}", replaces, fk_rec[kind], fk_checks)
        for kind, src, replaces in (
            ("fused_k", "fast_event_block_fk.cu",
             "i3rc_tpu/integrators/fastpath.py:665 (gas=True; fused-k, XLA in "
             "fastpath.py:1409-1470)"),
            ("table_fused_k", "fast_event_block_tab_fk.cu",
             "i3rc_tpu/integrators/fastpath.py:665 (gas=True, table mode; fused-k, XLA in "
             "fastpath.py:1409-1470)"))] + [polarized_entry(pz_checks, pz_rec)] + [
        march_entry(kind, m_checks, m_rec) for kind in ("march", "march_surface")] + [
        march_stage_entry(m_checks, m_rec)] + [
        dict(sharded_entry(kind, sd_checks, sd_rec),
             **({"source_queue_max_abs_err": reach_checks_["sd_err"],
                 "source_queue_launches": src_rec["sd"]["two"] + src_rec["sd"]["one"]}
                if kind == "SD" else {}))
        for kind in ("SD", "SB")] + [
        deep_entry(kind, reach_checks_, deep_rec) for kind in ("flux", "gas", "column")]},
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
            "tail_ms": whole["tail_ms"], "tail_bound_ms": whole["tail_bound"][0],
            "batch_ms": bk["kernel_ms"],
            "batch_launches": bk["launches"], "batch_bound_ms": bk["bound"][0],
            "surface_stage_ms": bk["stage"]["ms"],
            "surface_stage_launches": bk["stage"]["launches"],
            "surface_stage_bound_ms": bk["stage"]["bound"][0],
            "brdf_values_differing": {k: v[0] for k, v in brdf_diff.items()}}


def stage_entry(paths: dict, fk_albedo: tuple, timed: dict, err: dict) -> dict:
    """The kernels-line entry of the surface stage S
    (fast_event_block_surface_kernel): its launches on the glint row (phase
    21: one after each surfaced block); its device ms a launch, full
    (mid-flight) and tail (phase 4d, the glint row's Cox-Munk flux block),
    beside its plain version (resolve_surface, on the card) and the bound of
    the block's bounce (bounce_work); and per batch its time on each
    surface path (phases 21-24 and 50, by the profiler) beside its bound."""
    w = timed["flux"]
    batch = {name: {"stage_ms": bk["stage"]["ms"], "launches": bk["stage"]["launches"],
                    "bound_ms": bk["stage"]["bound"][0]}
             for name, (_, bk) in {**paths, "fk_albedo": fk_albedo}.items()}
    return {"name": "fast_event_block_surface_stage", "route": "cuda",
            "source": "i3rc_tpu_torch/csrc/fast_event_block.cu",
            "replaces": "i3rc_tpu/integrators/fastpath.py:665 with the surface glue of "
                        ":1874-1981 (the bounce of a block's bottom hits and its tallies)",
            "launches": paths["flux"][0], "max_abs_err": max(err.values()),
            "ms": w["stage_device_ms"], "plain_ms": w["stage_plain_ms"],
            "bound_ms": w["stage_bound"][0], "bound_by": w["stage_bound"][1],
            "library_ms": None, "tail_ms": w["tail_stage_ms"],
            "tail_bound_ms": w["tail_stage_bound"][0],
            "cases_vs_plain": timed["cases"], "batch": batch}


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
    one launch at 2^17 lanes: ms the profiler's device time of the kernel,
    the last the CUDA-event time of 20 launches queued behind a spin kernel
    (queued_ms; 20 calls timed without the spin, calls_ms, measure the
    host's calls, not the device)."""
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
    # A partial last CTA: 2^16 + 77 lanes.
    n_odd = (1 << 16) + 77
    ox, oy = x0[:n_odd].clone(), y0[:n_odd].clone()
    oacc = cp.column_probe(table, ox, oy, key, 1)
    rx, ry, racc = cp.column_probe_reference(table, x0[:n_odd], y0[:n_odd],
                                             cp.probe_uniforms(key, 1, n_odd, dev))
    check(torch.equal(ox, rx) and torch.equal(oy, ry) and torch.equal(oacc, racc),
          f"probe kernel and twin differ at {n_odd} lanes")

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
    calls_ms = time_ms(lambda xs, ys: cp.column_probe(table, xs, ys, key, 0), 20)
    p_ms = time_ms(lambda xs, ys: cp.column_probe_reference(table, xs, ys, u), 5)
    xs, ys = x0.clone(), y0.clone()
    run = lambda: cp.column_probe(table, xs, ys, key, 0)
    k_ms = queued_ms(run, 20)
    dev_ms = profiled_ms(run, 20, "column_read_probe_kernel")
    lane_events = PROBE_LANES * cp.K
    n_bytes = PROBE_LANES * 5 * 4 + table.numel() * 4
    bound = bound_ms("probe", lane_events, n_bytes)
    before = OPS_PER_EVENT["probe"]
    OPS_PER_EVENT["probe"] = OPS_PER_EVENT_PROBE_BEFORE
    try:
        bound_before = bound_ms("probe", lane_events, n_bytes)
    finally:
        OPS_PER_EVENT["probe"] = before
    say("19 probe", lanes=PROBE_LANES, K=cp.K, loop=PROBE_LOOP, bit_equal=True,
        device_ms=f"{dev_ms:.4f}", queued_ms=f"{k_ms:.4f}", calls_ms=f"{calls_ms:.4f}",
        twin_ms=f"{p_ms:.4f}", ns_per_lane_event=f"{1e6 * dev_ms / lane_events:.4f}",
        bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
        bound_before_ms=f"{bound_before[0]:.4f}", launches=launches, card=json.dumps(card))
    return launches, err, dev_ms, p_ms, bound, k_ms


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


def broadband_driver(bb_dir: Path, card: str) -> None:
    """Phase 14: the shipped namelist (spectralMode = "auto", 1e5 photons a
    k point: fused), then its seconds against the same namelist baked, after
    a warm-up, in turns (auto, baked, baked, auto, auto, baked; the median
    of each mode's three)."""
    from i3rc_tpu_torch.kernels import event_block as eb

    (bb_dir / "examples").mkdir(parents=True, exist_ok=True)
    subprocess.run([sys.executable, str(ROOT / "examples" / "make_broadband_inputs.py"),
                    str(bb_dir / "examples")], check=True, capture_output=True)
    shipped = (ROOT / "examples" / "broadbandDriver.nml").read_text()
    check('spectralMode = "auto"' in shipped, "broadbandDriver.nml: spectralMode is not auto")
    (bb_dir / "broadbandDriver.nml").write_text(shipped)
    (bb_dir / "broadbandDriver_baked.nml").write_text(
        shipped.replace('spectralMode = "auto"', 'spectralMode = "baked"'))
    bb_outputs = ("broadband_flux.out", "broadband_rad.out")
    for name in bb_outputs:
        (bb_dir / name).unlink(missing_ok=True)
    from i3rc_tpu_torch.drivers.broadband_driver import run_from_namelist as run_broadband_nml

    def drive(nml: str):
        cwd = os.getcwd()
        os.chdir(bb_dir)
        try:
            t0 = time.perf_counter()
            drv = run_broadband_nml(nml, quiet=True, device="cuda")
            return drv, time.perf_counter() - t0
        finally:
            os.chdir(cwd)

    eb.reset_launch_counters()
    drv, t_drv = drive("broadbandDriver.nml")
    launches = eb.event_block.fused_k_detector_launches
    for name in bb_outputs:
        check((bb_dir / name).is_file(), f"broadband driver did not write {name}")
    (fup, fup_e), (fdn, _), (fabs, _) = drv["mean_stats"]
    check(abs(fup + fdn + fabs - 1.0) < 1e-5, f"broadband driver closure {fup + fdn + fabs}")
    rad = drv["radiance"][0]
    check(rad.shape == (32, 1, 2) and bool((rad > 0).all()) and bool(np.isfinite(rad).all()),
          f"broadband radiance {rad.shape}")
    check(all(b.per_k == [] for b in drv["bands"]), "auto did not run the namelist fused")
    check(launches > 0, "the broadband driver (auto) launched no fused-k detector kernel")
    check(eb.event_block.launches == eb.event_block.detector_launches
          == eb.event_block.gas_detector_launches == 0,
          "the broadband driver launched a kernel without the fused-k gas channel")
    drive("broadbandDriver_baked.nml")                     # warm-up
    times = {"auto": [], "baked": []}
    for rep_ in range(6):
        mode = ("auto", "baked")[(rep_ + rep_ // 2) % 2]     # a, b, b, a, a, b
        d, dt = drive("broadbandDriver.nml" if mode == "auto" else "broadbandDriver_baked.nml")
        check(all((b.per_k == []) == (mode == "auto") for b in d["bands"]), f"14 {mode}: per_k")
        times[mode].append(dt)
    say("14 broadband-driver", namelist="broadbandDriver.nml", mode="auto (fused)",
        bands=drv["cfg"]["num_bands"],
        photons=drv["cfg"]["num_photons"], fup=f"{fup:.5f}", stderr=f"{fup_e:.1e}",
        fdn=f"{fdn:.5f}", fabs=f"{fabs:.5f}",
        intensity=",".join(f"{float(v):.5f}" for v in rad.mean(axis=(0, 1))),
        seconds=f"{t_drv:.2f}", launches=launches,
        auto_seconds=",".join(f"{t:.4f}" for t in times["auto"]),
        baked_seconds=",".join(f"{t:.4f}" for t in times["baked"]),
        auto_over_baked_seconds=f"{sorted(times['auto'])[1] / sorted(times['baked'])[1]:.3f}",
        card=json.dumps(card))


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
    from i3rc_tpu_torch.kernels.general_block import ray_flush_counter

    key = batch_key(SEED, seed)
    tracer = integ.general_tracer(n, lanes)
    run_batch = lambda: (tracer(key, src.sample(key, lanes, "cuda"), src) if optics is None
                         else tracer(key, src.sample(key, lanes, "cuda"), src, optics))
    flushes = ray_flush_counter("cuda")
    flushes.zero_()
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
    # per-lane counters and the radiance tallies; the ray queues' flushes.
    det = tracer.spec.det
    int_steps = int(raw.n_int_steps) if det is not None else 0
    rays = int(raw.n_int_rays) if det is not None else 0
    n_flushes = int(flushes[0])
    if det is not None:
        n_bytes += 16 * lanes * launches + 16 * raw.intensity.numel()
    bound = general_bound(steps + int_steps, events, max(events - n, 0), n_bytes, rays)
    rec = {"bound": bound, "launches": launches, "raw": raw, "steps": steps, "events": events,
           "int_steps": int_steps, "rays": rays, "flushes": n_flushes}
    fields = dict(photons=n, lanes=lanes, blocks=launches, lane_events=events, dda_steps=steps,
                  estimate_steps=int_steps, estimate_rays=rays, bound_ms=f"{bound[0]:.3f}", bound_by=bound[1])
    if det is not None:
        fields.update(ray_flushes=n_flushes,
                      ray_flushes_per_block=f"{n_flushes / max(launches, 1):.1f}")
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
# The general kernel's local estimate: G's estimate stage (the DET
# instantiations, csrc/general_event_block_det.cu: each estimate a record in
# the CTA's ray queue, traced by the CTA after its lanes' events) against its
# plain version, and its paths

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


# ---------------------------------------------------------------------------
# The table modes of the fastpath (ROADMAP item 15): the table variants of
# the event block (TAB: the cubic inverse-CDF sampler, the log-cubic phase
# value, per-column ssa and table entries) against their plain version, and
# their paths (f)-(j); the radar cloud on G

TABLE_LANES = 1 << 20                # paths (f), (g), (i), (j): the default width
TABLE_CASE_LANES = (1 << 13) + 77    # phase 38's small cases (a partial last CTA)
C1_PHOTONS = 1 << 24                 # path (f)
C1_RAD_PHOTONS = 1 << 22             # path (g): 8 batches a side
ISO_PHOTONS = 1 << 22                # path (j)
RADAR_PHOTONS = 1 << 20              # the radar row: 4 batches, 2^22 photons

def table_path_scene(name: str, dev) -> SimpleNamespace:
    """The scene of a table path, built as its phase drives it and as phase
    38 holds its kernel to the plain version: integ, photons, lanes, source,
    and the HG sibling's integrator (the same extinction with the step
    cloud's or Landsat's HG table) for the per-batch comparison."""
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, make_landsat_cloud,
                                make_step_cloud)
    from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component

    ts = _load_tests_module("tabulated_scenes")
    h = ts.host("i3rc_tpu_torch")
    src = PhotonSource.directional(0.5, 0.0)
    flux = IntegratorConfig(use_ray_tracing=False, max_events=500,
                            compute_volume_absorption=False)
    if name == "f_c1_step_cloud":
        return SimpleNamespace(
            integ=Integrator.create(ts.c1_step_cloud(h), flux, device=dev), n=C1_PHOTONS,
            lanes=TABLE_LANES, src=src,
            hg=Integrator.create(make_step_cloud(1.0), flux, device=dev))
    if name.startswith("g_c1_radiance"):
        cfg = radiance_config() if name.endswith("iwabuchi") else replace(
            radiance_config(), use_russian_roulette_for_intensity=False)
        det = dict(intensity_mus=DET_MUS, intensity_phis=DET_PHIS)
        return SimpleNamespace(
            integ=Integrator.create(ts.c1_step_cloud(h), cfg, device=dev, **det),
            n=C1_RAD_PHOTONS, lanes=TABLE_LANES, src=src,
            hg=Integrator.create(make_step_cloud(1.0), cfg, device=dev, **det))
    if name.startswith("h_landsat_props"):
        return SimpleNamespace(
            integ=Integrator.create(ts.landsat_props(h, conservative=name.endswith("1.0")),
                                    flux, device=dev),
            n=LANDSAT_PHOTONS, lanes=L_CHECK, src=src,
            hg=Integrator.create(make_landsat_cloud(1.0 if name.endswith("1.0") else 0.99),
                                 flux, device=dev))
    if name == "i_c1_band_k0":
        kd, cfg = table_band()
        z = np.asarray(make_step_cloud(1.0).z_edges)
        gas = kd.absorption_profiles_on(z)[:, 0]
        return SimpleNamespace(
            integ=Integrator.create(domain_with_gas_component(ts.c1_step_cloud(h), gas), cfg,
                                    device=dev),
            n=SLICE_PHOTONS, lanes=TABLE_LANES, src=src,
            hg=Integrator.create(domain_with_gas_component(make_step_cloud(1.0), gas), cfg,
                                 device=dev))
    if name == "j_isotropic":
        return SimpleNamespace(
            integ=Integrator.create(ts.isotropic_slab(h, 1.0), replace(flux, max_events=2000),
                                    device=dev),
            n=ISO_PHOTONS, lanes=TABLE_LANES, src=src, hg=None)
    raise ValueError(name)


TABLE_PATH_SCENES = ("f_c1_step_cloud", "g_c1_radiance_iwabuchi", "g_c1_radiance_exact",
                     "h_landsat_props_0.99", "h_landsat_props_1.0", "i_c1_band_k0",
                     "j_isotropic")
# The mid-flight state of these scenes times each variant (the kernels line).
TABLE_TIMED = {"flux": "f_c1_step_cloud", "detectors": "g_c1_radiance_iwabuchi",
               "gas": "i_c1_band_k0", "column": "h_landsat_props_0.99"}


def table_band():
    """The bench row's band (bench.py:274-337, chip_smoke phase 13): one band
    of k = 4e-4 and 4e-3 per m (weights 0.7 / 0.3) over the step cloud's 32
    layers, and its configuration."""
    from i3rc_tpu_torch import IntegratorConfig, KDistribution, make_step_cloud

    z = np.asarray(make_step_cloud(1.0).z_edges)
    kd = KDistribution.create(z, np.broadcast_to([[4e-4, 4e-3]], (32, 2)).copy(), [0.7, 0.3],
                              wavelength_limits=(2.6, 2.8), spectral_fraction=1.0)
    return kd, IntegratorConfig(use_ray_tracing=False, max_events=500,
                                compute_volume_absorption=False, majorant_block_size=16)


def table_kernel_vs_twin(dev, card: str, log: str) -> dict:
    """Phase 38: every table instantiation against the plain version.  The
    small cases of tests/tabulated_scenes.py table_cases (at
    TABLE_CASE_LANES lanes, 4x the photons) and each path's own scene at its
    photons and lanes, each on its launch, mid-flight and tail states: every
    lane-state row, the flux and volume tallies, the control state and the
    dead counts bit for bit, the detector accumulators within 1e-9.  The
    instantiations they launch must be exactly the table instantiations of
    the build.  The mid-flight and tail blocks of each path's scene are
    timed: the kernel's device time (profiler), the plain version's (CUDA
    events) and the bound.  Returns the timed records by scene and the
    largest state difference by variant."""
    from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource, batch_key
    from i3rc_tpu_torch.kernels.event_block import fused_block, fused_block_reference

    ts = _load_tests_module("tabulated_scenes")
    h = ts.host("i3rc_tpu_torch")
    src = PhotonSource.directional(0.5, 0.0)
    # The templated table instantiations (the runtime-depth ones, ILin1E,
    # are phase 64's).
    built = set(re.findall(r"Compiling entry function '\w*fast_event_block_kernel"
                           r"(ILi\d\w+?ELb1ELb0EE)v", log))
    seen, err, n_states, timed = {}, {}, 0, {}

    def hold(tag, spec, pro, states, key, source):
        nonlocal n_states
        for state, st, buf, kb in states:
            r = ts.block_vs_twin(spec, pro, st, buf, key, source, kb)
            check(r["bit_equal"] and r["acc_rel_err"] <= 1e-9, f"38 {tag} {state}: {r}")
            n_states += 1
            v = "table_" + variant(spec)
            err[v] = max(err.get(v, 0.0), r["max_abs_err"])
            seen.setdefault(ts.instantiation(spec), []).append(tag)
            yield state, st, buf, kb, r

    for name, (build, cfg, kw) in ts.table_cases().items():
        integ = Integrator.create(build(h), IntegratorConfig(**cfg), device=dev, **kw)
        key = batch_key(SEED, 900)
        spec, pro, states = ts.trace_states(integ, src, 4 * TABLE_CASE_LANES, TABLE_CASE_LANES,
                                            key)
        check(spec.table, f"38 {name}: not a table plan")
        for _ in hold(name, spec, pro, states, key, src):
            pass
    n_cases = n_states
    for name in TABLE_PATH_SCENES:
        sc = table_path_scene(name, dev)
        key = batch_key(SEED, 910)
        spec, pro, states = ts.trace_states(sc.integ, sc.src, sc.n, sc.lanes, key)
        for state, st, buf, kb, r in hold(name, spec, pro, states, key, sc.src):
            fields = dict(scene=name, state=state, lanes=sc.lanes, photons=sc.n, K=spec.K,
                          chain=spec.chain, kb=kb, live=r["live"], bit_equal=r["bit_equal"],
                          max_abs_err=f"{r['max_abs_err']:.3e}",
                          acc_rel_err=f"{r['acc_rel_err']:.3e}",
                          instantiation=ts.instantiation(spec))
            if state != "launch":
                run_k = lambda s, b: fused_block(spec, pro, s, b, key, sc.src, kb)
                run_p = lambda s, b: fused_block_reference(spec, pro, s, b, key, sc.src, kb)
                r["device_ms"] = device_block_ms(run_k, st, buf.clone, 20)
                r["twin_ms"] = time_block_ms(run_p, st, buf.clone, 2)
                n_bytes = (state_bytes(spec, sc.lanes, r["live"])
                           + PROLOGUE_BYTES_PER_LANE * sc.lanes)
                r["bound"] = bound_ms(variant(spec), r["lane_events"], n_bytes, r["collisions"],
                                      spec.det.n if spec.det is not None else 0, table=True)
                timed[(name, state)] = r
                fields.update(lane_events=r["lane_events"], collisions=r["collisions"],
                              device_ms=f"{r['device_ms']:.4f}", plain_ms=f"{r['twin_ms']:.4f}",
                              bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1])
            say("38 table-block-vs-plain", **fields, card=json.dumps(card))
    check(len(built) == 88 and set(seen) == built,
          f"38: table instantiations run {sorted(seen)}, built {sorted(built)}")
    say("38 table-block-vs-plain", cases=len(ts.table_cases()), case_states=n_cases,
        path_states=n_states - n_cases, instantiations=len(seen), bit_equal=True,
        max_abs_err=f"{max(err.values()):.3e}", card=json.dumps(card))
    return {"timed": timed, "err": err}


def table_path_counts(expect: str) -> int:
    """The launches of the table variant ``expect`` since the counters were
    reset; no other event-block variant and no G launch."""
    from i3rc_tpu_torch.kernels import event_block as eb
    from i3rc_tpu_torch.kernels import general_block as gb

    counts = {n: getattr(eb.event_block, n) for n in eb.LAUNCH_COUNTERS.values()}
    launches = counts.pop(expect)
    check(launches > 0 and not any(counts.values()) and gb.general_block.launches == 0,
          f"launches of {expect}: {launches}, others {counts}, G {gb.general_block.launches}")
    return launches


def reset_counts() -> None:
    from i3rc_tpu_torch.kernels import event_block as eb
    from i3rc_tpu_torch.kernels import general_block as gb

    eb.reset_launch_counters()
    gb.reset_launch_counters()


def table_batches(tag: str, sc, card: str, seed: int, profile: bool = True) -> dict:
    """One more batch of a table path and one of its HG sibling (the same
    extinction, the HG table) at the same photons and lanes, the block
    kernel's device time over each (batch_kernel_time) beside its bound."""
    from i3rc_tpu_torch import batch_key

    key = batch_key(SEED, seed)
    out = {}
    for side, integ in (("table", sc.integ), ("hg", sc.hg)):
        if integ is None:
            continue
        tracer = integ.batch_tracer(sc.n, sc.lanes)
        run = lambda: tracer(key, sc.src.sample(key, sc.lanes, "cuda"), sc.src)
        run()
        bk = batch_kernel_time(run, profile)
        check(bk["spec"].table == (side == "table"), f"{tag}: the {side} batch's plan")
        out[side] = bk
        say(f"{tag}-batch-kernel", side=side, photons=sc.n, lanes=sc.lanes,
            **batch_fields(bk, card))
    return out


def table_paths(out: Path, card: str) -> dict:
    """Phases 39-44: the table paths (f)-(j) through Integrator.batch_fn or
    run_band, each driven with the launch counts set to 0 just before it
    and read just after (the table variant, no other, no G), each against
    an independent estimate (the general kernel on the same scene, or the
    slab oracle), with one more batch of the table variant and of its HG
    sibling timed; then the radar cloud on G.  Returns per variant the
    path's launches and batch records."""
    from i3rc_tpu_torch import Integrator, PhotonSource, make_step_cloud, run_band
    from i3rc_tpu_torch.kernels import general_block as gb

    ts = _load_tests_module("tabulated_scenes")
    h = ts.host("i3rc_tpu_torch")
    src = PhotonSource.directional(0.5, 0.0)
    rec = {}

    # 39. (f) the C.1 step cloud, flux: 3 x 2^24 photons at 2^20 lanes (K1-T,
    # chain 2) against G on the same scene (maximum cross-section), 2 x 2^24
    sc = table_path_scene("f_c1_step_cloud", "cuda")
    fn = sc.integ.batch_fn(src, sc.n, n_lanes=sc.lanes)
    fn(batch_key_(950))
    torch.cuda.synchronize()
    reset_counts()
    fups, times = [], []
    for b in range(3):
        t0 = time.perf_counter()
        res = fn(batch_key_(951 + b))
        fup, fdn = float(res.mean_flux_up), float(res.mean_flux_down)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(abs(fup + fdn - 1.0) < 1e-5 and int(res.n_bad) == 0,
              f"39 (f): closure {fup + fdn}, n_bad {int(res.n_bad)}")
        fups.append(fup)
    launches = table_path_counts("table_launches")
    g_integ = Integrator.create(ts.c1_step_cloud(h), replace(sc.integ.config, use_fastpath=False),
                                device="cuda")
    check(g_integ._fast_plan is None, "39: the G twin has a fastpath plan")
    gfn = g_integ.batch_fn(src, sc.n, n_lanes=sc.lanes)
    g_fups = [float(gfn(batch_key_(960 + b)).mean_flux_up) for b in range(2)]
    f_m, g_m = float(np.mean(fups)), float(np.mean(g_fups))
    sigma = (f_m * (1 - f_m) * (1 / (3 * sc.n) + 1 / (2 * sc.n))) ** 0.5
    check(abs(f_m - g_m) <= 4 * sigma, f"39 (f): Fup {f_m} vs G {g_m} (sigma {sigma:.2e})")
    say("39 table-c1-step-cloud", photons=sc.n, lanes=sc.lanes, fup=f"{f_m:.6f}",
        fup_general=f"{g_m:.6f}", sigma=f"{sigma:.2e}",
        seconds=",".join(f"{t:.4f}" for t in times),
        photons_per_s=f"{sc.n / sorted(times)[1]:.4e}", launches=launches, card=json.dumps(card))
    rec["flux"] = (launches, table_batches("39 table-c1-step-cloud", sc, card, 965))

    # 40. (g) the same scene with the three I3RC detectors, exact and Iwabuchi
    # (zeta 0.3): 8 x 2^22 photons (K3-T, the forward fit) against G with its
    # estimate stage on the same scene and estimator, 8 x 2^22
    for est in ("iwabuchi", "exact"):
        sc = table_path_scene(f"g_c1_radiance_{est}", "cuda")
        fn = sc.integ.batch_fn(src, sc.n, n_lanes=sc.lanes)
        fn(batch_key_(970))
        torch.cuda.synchronize()
        reset_counts()
        f_i, times = [], []
        for b in range(8):
            t0 = time.perf_counter()
            res = fn(batch_key_(971 + b))
            f_i.append(res.mean_intensity.double().cpu().numpy())
            closure = float(res.mean_flux_up + res.mean_flux_down)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(abs(closure - 1.0) < 1e-5 and int(res.n_bad) == 0
                  and bool(torch.isfinite(res.intensity).all()), f"40 (g) {est}: {closure}")
        launches = table_path_counts("table_detector_launches")
        g_integ = Integrator.create(ts.c1_step_cloud(h),
                                    replace(sc.integ.config, use_fastpath=False), device="cuda",
                                    intensity_mus=DET_MUS, intensity_phis=DET_PHIS)
        gfn = g_integ.batch_fn(src, sc.n, n_lanes=sc.lanes)
        g_i = [gfn(batch_key_(980 + b)).mean_intensity.double().cpu().numpy()
               for b in range(8)]
        f_i, g_i = np.array(f_i), np.array(g_i)
        se = np.sqrt(f_i.var(0, ddof=1) / 8 + g_i.var(0, ddof=1) / 8)
        check(np.all(np.abs(f_i.mean(0) - g_i.mean(0)) <= 5 * se) and np.all(f_i.mean(0) > 0),
              f"40 (g) {est}: I {f_i.mean(0)} vs G {g_i.mean(0)} (se {se})")
        say("40 table-c1-radiance", estimator=est, photons=8 * sc.n, lanes=sc.lanes,
            intensity=",".join(f"{v:.5f}" for v in f_i.mean(0)),
            intensity_general=",".join(f"{v:.5f}" for v in g_i.mean(0)),
            combined_se=",".join(f"{v:.1e}" for v in se),
            seconds=",".join(f"{t:.4f}" for t in times),
            photons_per_s=f"{sc.n / sorted(times)[4]:.4e}", launches=launches,
            card=json.dumps(card))
        if est == "iwabuchi":
            rec["detectors"] = (launches, table_batches("40 table-c1-radiance", sc, card, 985))

    # 41. (h) Landsat with per-column ssa (U[0.99, 1]) and three HG-Legendre
    # entries by optical-depth tercile, and its conservative twin: 2^23
    # photons, K = 32 (COL-P) against G on the same scene, Fup, Fdn and Fabs
    # within 5 combined sigma, n_bad < 1e-3 n
    for ssa in ("0.99", "1.0"):
        sc = table_path_scene(f"h_landsat_props_{ssa}", "cuda")
        plan = sc.integ._fast_plan
        check(plan.column_props and plan.cubic_entries == 3 and plan.unroll == 32,
              f"41: plan K {plan.unroll}, entries {plan.cubic_entries}")
        fn = sc.integ.batch_fn(src, sc.n, n_lanes=sc.lanes)
        fn(batch_key_(1000))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = fn(batch_key_(1001))
        parts = np.array([float(res.mean_flux_up), float(res.mean_flux_down),
                          float(res.mean_flux_absorbed)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_bad = int(res.n_bad)
        check(n_bad < 1e-3 * sc.n and abs(parts.sum() - 1.0) <= 1e-5 + n_bad / sc.n,
              f"41 (h) {ssa}: {parts}, n_bad {n_bad}")
        check((parts[2] > 0) == (ssa == "0.99"), f"41 (h) {ssa}: absorbed {parts[2]}")
        launches = table_path_counts("table_column_launches")
        g_integ = Integrator.create(ts.landsat_props(h, conservative=ssa == "1.0"),
                                    replace(sc.integ.config, use_fastpath=False), device="cuda")
        g_res = g_integ.batch_fn(src, sc.n, n_lanes=GENERAL_LANES)(batch_key_(1010))
        g_parts = np.array([float(g_res.mean_flux_up), float(g_res.mean_flux_down),
                            float(g_res.mean_flux_absorbed)])
        check(int(g_res.n_bad) < 1e-3 * sc.n, f"41 (h) {ssa}: G n_bad {int(g_res.n_bad)}")
        p = np.maximum(0.5 * (parts + g_parts), 1e-6)
        sigma = np.sqrt(p * (1 - p) * 2 / sc.n)
        check(np.all(np.abs(parts - g_parts) <= 5 * sigma),
              f"41 (h) {ssa}: {parts} vs G {g_parts} (sigma {sigma})")
        say("41 table-landsat-props", ssa=ssa, photons=sc.n, lanes=sc.lanes, K=plan.unroll,
            fluxes=",".join(f"{v:.6f}" for v in parts),
            fluxes_general=",".join(f"{v:.6f}" for v in g_parts),
            sigma=",".join(f"{v:.1e}" for v in sigma), n_bad=n_bad,
            n_bad_general=int(g_res.n_bad), seconds=f"{dt:.4f}",
            photons_per_s=f"{sc.n / dt:.4e}", launches=launches, card=json.dumps(card))
        if ssa == "0.99":
            rec["column"] = (launches, table_batches("41 table-landsat-props", sc, card, 1015,
                                                     profile=False))

    # 42. (i) the bench row's band over the C.1 step cloud, baked (K2-T, chain
    # 3): 2 k x 2 x 2^24 photons at 2^20 lanes, band Fup against the traced
    # mode (G with each k point's optics) within 5 combined sigma
    kd, cfg = table_band()
    dom = ts.c1_step_cloud(h)
    sc = table_path_scene("i_c1_band_k0", "cuda")
    derive = lambda r: {"fup": r.mean_flux_up, "fdn": r.mean_flux_down,
                        "fabs": r.mean_flux_absorbed, "n_bad": r.n_bad}
    cache = {}
    band = lambda mode, seed: run_band(sc.integ, dom, kd, src, SLICE_PHOTONS, 2, seed=seed,
                                       derive=derive, integrator_cache=cache, mode=mode,
                                       n_lanes=TABLE_LANES)
    band("baked", 1020)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    baked = band("baked", 1021)
    m = {k: float(v) for k, v in baked.mean["derived"].items()}
    dt = time.perf_counter() - t0
    launches = table_path_counts("table_gas_launches")
    check(abs(m["fup"] + m["fdn"] + m["fabs"] - 1.0) < 1e-5 and m["n_bad"] == 0,
          f"42 (i): {m}")
    traced = band("traced", 1022)
    mt = {k: float(v) for k, v in traced.mean["derived"].items()}
    n_k = 2 * SLICE_PHOTONS
    per_k = [float(s.mean["derived"]["fup"]) for s in baked.per_k]
    sigma = (2 * sum(w * w * f * (1 - f) / n_k for w, f in zip(kd.weights, per_k))) ** 0.5
    # The traced mode's G loses a few photons to its face rule (n_bad: the
    # band's weighted mean per batch), as phases 27-31 allow.
    check(abs(m["fup"] - mt["fup"]) <= 5 * sigma and mt["n_bad"] < 1e-3 * SLICE_PHOTONS,
          f"42 (i): band Fup {m['fup']} vs traced {mt['fup']} (sigma {sigma:.2e}), "
          f"n_bad {mt['n_bad']}")
    say("42 table-c1-band", photons=n_k * kd.n_k, lanes=TABLE_LANES, fup=f"{m['fup']:.6f}",
        fdn=f"{m['fdn']:.6f}", fabs=f"{m['fabs']:.6f}", fup_traced=f"{mt['fup']:.6f}",
        n_bad_traced=f"{mt['n_bad']:.1f}", sigma=f"{sigma:.2e}", seconds=f"{dt:.4f}",
        photons_per_s=f"{n_k * kd.n_k / dt:.4e}",
        launches=launches, card=json.dumps(card))
    rec["gas"] = (launches, table_batches("42 table-c1-band", sc, card, 1025))

    # 43. (j) the isotropic slab (tau 1, ssa 1, mu0 0.5; the cubic is exact):
    # 2^22 photons, R and T within 4 sigma of the discrete-ordinates oracle
    oracle = _load_tests_module("disort_oracle")
    sc = table_path_scene("j_isotropic", "cuda")
    reset_counts()
    res = sc.integ.batch_fn(src, sc.n, n_lanes=sc.lanes)(batch_key_(1030))
    r_t = [float(res.mean_flux_up), float(res.mean_flux_down)]
    launches = table_path_counts("table_launches")
    r_ex, t_ex = oracle.slab_fluxes(1.0, 1.0, [0.0], 0.5)
    for got, want, what in zip(r_t, (r_ex, t_ex), ("R", "T")):
        sigma = (want * (1 - want) / sc.n) ** 0.5
        check(abs(got - want) <= 4 * sigma, f"43 (j): {what} {got} vs oracle {want}")
    check(abs(sum(r_t) - 1.0) < 1e-5 and int(res.n_bad) == 0, f"43 (j): {r_t}")
    say("43 table-isotropic-slab", photons=sc.n, lanes=sc.lanes, r=f"{r_t[0]:.6f}",
        t=f"{r_t[1]:.6f}", oracle=f"{r_ex:.6f},{t_ex:.6f}",
        sigma=f"{(r_ex * (1 - r_ex) / sc.n) ** 0.5:.2e}", launches=launches,
        card=json.dumps(card))

    # 44. the I3RC radar cloud (640 x 1 x 54) with the C.1 table on G (not
    # separable, not one layer a column): 4 x 2^20 photons at 2^20 lanes,
    # Fup and its standard error, gated on closure and n_bad < 1e-3 n
    from i3rc_tpu_torch.models.radar_cloud import make_radar_cloud

    integ = Integrator.create(make_radar_cloud("c1"),
                              replace(table_band()[1], max_events=2000), device="cuda")
    check(integ._fast_plan is None, "44: the radar cloud has a fastpath plan")
    fn = integ.batch_fn(src, RADAR_PHOTONS, n_lanes=GENERAL_LANES)
    fn(batch_key_(1040))
    torch.cuda.synchronize()
    reset_counts()
    res, times = timed_general_batches(fn, RADAR_PHOTONS, 1041, 4,
                                       bad_max=int(1e-3 * RADAR_PHOTONS))
    launches = gb.general_block.launches
    check(launches > 0, "44: the radar cloud launched no G")
    fups = np.array([float(r.mean_flux_up) for r in res])
    say("44 radar-cloud-c1-general", photons=4 * RADAR_PHOTONS, lanes=GENERAL_LANES,
        fup=f"{fups.mean():.6f}", stderr=f"{fups.std(ddof=1) / 2:.2e}",
        fdn=f"{np.mean([float(r.mean_flux_down) for r in res]):.6f}",
        n_bad=",".join(str(int(r.n_bad)) for r in res),
        seconds=",".join(f"{t:.4f}" for t in times),
        photons_per_s=f"{RADAR_PHOTONS / sorted(times)[1]:.4e}", launches=launches,
        card=json.dumps(card))
    return rec


def table_entry(kind: str, source: str, replaces: str, path: tuple, checks: dict) -> dict:
    """The kernels-line entry of a table variant: launches on its path, its
    largest state difference to the plain version (phase 38), its device
    time, plain time and bound on its path's mid-flight block, and one
    batch of the path beside the batch of its HG sibling."""
    launches, bks = path
    r = checks["timed"][(TABLE_TIMED[kind], "mid")]
    tail = checks["timed"][(TABLE_TIMED[kind], "tail")]
    e = {"name": "fast_event_block_table" + ("" if kind == "flux" else f"_{kind}"),
         "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
         "max_abs_err": checks["err"].get("table_" + kind, 0.0), "ms": r["device_ms"],
         "plain_ms": r["twin_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
         "library_ms": None, "tail_ms": tail["device_ms"], "tail_bound_ms": tail["bound"][0],
         "batch_ms": bks["table"]["kernel_ms"], "batch_launches": bks["table"]["launches"],
         "batch_bound_ms": bks["table"]["bound"][0]}
    if "hg" in bks:
        e["hg_batch_ms"] = bks["hg"]["kernel_ms"]
    return e


# ---------------------------------------------------------------------------
# Fused-k spectral batching (ROADMAP item 13b): the fused-k variants of the
# gas event block (FK: every k point of a band in one trace, HG and table)
# against their plain version, and their paths

FK_PHOTONS = 1 << 21                 # phases 48-49: per k point and batch, 8 batches
FK_SMALL_PHOTONS = 1 << 20           # phase 50: per k point and batch, 2 batches
# Phase 49's layered gas, two k points over the step cloud's 32 layers in 4
# blocks (tests/test_spectral.py:286-313), weights 0.6 / 0.4.
FK_HEATING_GAS = np.stack([np.repeat([2e-3, 1e-3, 5e-4, 2e-4], 8),
                           np.repeat([8e-2, 3e-2, 1.5e-2, 8e-3], 8)])
# The paths of phases 46-50 by name (fk_path_scene builds each).
FK_PATHS = ("46_bench", "47_c1_band", "48_detectors_iwabuchi", "48_detectors_exact",
            "49_heating", "50_internal", "50_albedo")
# The mid-flight state of these scenes times each variant (the kernels line).
FK_TIMED = {"fused_k": "46_bench", "table_fused_k": "47_c1_band"}


def fk_path_scene(name: str, dev) -> SimpleNamespace:
    """The scene of a fused-k path as its phase drives it and as phase 45
    holds its kernel to the plain version: the base domain, the band, the
    configuration and creation keywords, the source, photons per k point and
    batch, batches and lanes, the fused-k integrator, and the band integrator
    (the domain with k point 0's gas) that run_band takes."""
    from i3rc_tpu_torch import Integrator, IntegratorConfig, KDistribution, PhotonSource
    from i3rc_tpu_torch import make_step_cloud
    from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component

    fks = _load_tests_module("fused_k_scenes")
    h = fks.host("i3rc_tpu_torch")
    kd, cfg = table_band()
    src = PhotonSource.directional(0.5, 0.0)
    kw, n, batches, lanes = {}, SLICE_PHOTONS, 2, L_CHECK
    dom = make_step_cloud(1.0)
    if name == "47_c1_band":
        dom, lanes = _load_tests_module("tabulated_scenes").c1_step_cloud(h), TABLE_LANES
    elif name.startswith("48_detectors"):
        cfg = radiance_config() if name.endswith("iwabuchi") else replace(
            radiance_config(), use_russian_roulette_for_intensity=False)
        kw, n, batches = dict(intensity_mus=DET_MUS, intensity_phis=DET_PHIS), FK_PHOTONS, 8
    elif name == "49_heating":
        dom = make_step_cloud(0.99)
        kd = KDistribution.create(np.asarray(dom.z_edges), FK_HEATING_GAS.T.copy(), [0.6, 0.4],
                                  spectral_fraction=1.0)
        cfg, n, batches = replace(cfg, compute_volume_absorption=True), FK_PHOTONS, 8
    elif name == "50_internal":
        dom, kd = fks.beer_lambert(h)
        cfg = IntegratorConfig(use_ray_tracing=False, max_events=100,
                               compute_volume_absorption=False)
        src, n = PhotonSource.internal_flux(0.5, 0.5, 0.5, True), FK_SMALL_PHOTONS
    elif name == "50_albedo":
        kw, n = dict(surface_albedo=0.2), FK_SMALL_PHOTONS
    elif name != "46_bench":
        raise ValueError(name)
    profiles = kd.absorption_profiles_on(np.asarray(dom.z_edges))
    baked = [Integrator.create(domain_with_gas_component(dom, profiles[:, k]), cfg, device=dev,
                               **kw) for k in range(kd.n_k)]
    return SimpleNamespace(
        name=name, dom=dom, kd=kd, cfg=cfg, kw=kw, src=src, n=n, batches=batches, lanes=lanes,
        fused=fks.with_k(h, dom, profiles.T, kd.weights, config=cfg, device=dev, **kw),
        band=baked[0], baked=baked)


def fused_k_kernel_vs_twin(dev, card: str, log: str) -> dict:
    """Phase 45: every fused-k instantiation against the plain version.  The
    small cases of tests/fused_k_scenes.py fk_cases (at TABLE_CASE_LANES
    lanes, 4x the photons: a partial last CTA; every source of refills,
    the exact death layer, the surface stage, an internal source) and each
    path's own scene at its photons and lanes, each on its launch,
    mid-flight and tail states: every lane-state row (gcur included), the
    per-k control state and the dead counts bit for bit, the flux, volume
    and detector tallies within 1e-9.  The instantiations they launch must
    be exactly the fused-k instantiations of the build.  The mid-flight and
    tail blocks of phases 46-47's scenes are timed: the kernel's device
    time (profiler), the plain version's (CUDA events) and the bound.
    Returns the timed records by scene and the largest state difference by
    variant."""
    from i3rc_tpu_torch import batch_key
    from i3rc_tpu_torch.kernels.event_block import PK, fused_block, fused_block_reference

    fks = _load_tests_module("fused_k_scenes")
    h = fks.host("i3rc_tpu_torch")
    built = set(re.findall(r"Compiling entry function '\w*fast_event_block_kernel(ILi\w+?ELb1EE)v",
                           log))
    seen, err, n_states, timed = {}, {}, 0, {}

    def hold(tag, integ, src, n, lanes, key):
        nonlocal n_states
        spec, pro, states = fks.trace_states(integ, src, n, lanes, key)
        check(spec.fused, f"45 {tag}: not a fused-k plan")
        for state, st, buf, kb in states:
            r = fks.block_vs_twin(spec, pro, st, buf, key, src, kb)
            check(r["bit_equal"] and r["tally_rel_err"] <= 1e-9, f"45 {tag} {state}: {r}")
            n_states += 1
            v = ("table_" if spec.table else "") + "fused_k"
            err[v] = max(err.get(v, 0.0), r["max_abs_err"])
            seen.setdefault(fks.instantiation(spec), []).append(tag)
            yield spec, pro, state, st, buf, kb, r

    for name, (_, _, _, kind) in fks.fk_cases().items():
        integ = fks.case_integrator(name, dev)
        for _ in hold(name, integ, fks.source(h, kind), 4 * TABLE_CASE_LANES, TABLE_CASE_LANES,
                      batch_key(SEED, 1100)):
            pass
    n_cases = n_states
    for name in FK_PATHS:
        sc = fk_path_scene(name, dev)
        n = sc.n * sc.kd.n_k
        key = batch_key(SEED, 1110)
        for spec, pro, state, st, buf, kb, r in hold(name, sc.fused, sc.src, n, sc.lanes, key):
            fields = dict(scene=name, state=state, lanes=spec.fk.lanes, photons=n,
                          k_points=spec.fk.n_k, kb=kb, live=r["live"], bit_equal=r["bit_equal"],
                          max_abs_err=f"{r['max_abs_err']:.3e}",
                          tally_rel_err=f"{r['tally_rel_err']:.3e}",
                          instantiation=fks.instantiation(spec))
            if state != "launch" and name in FK_TIMED.values():
                run_k = lambda s_, b_: fused_block(spec, pro, s_, b_, key, sc.src, kb)
                run_p = lambda s_, b_: fused_block_reference(spec, pro, s_, b_, key, sc.src, kb)
                r["device_ms"] = device_block_ms(run_k, st, buf.clone, 20)
                r["twin_ms"] = time_block_ms(run_p, st, buf.clone, 2)
                n_bytes = (state_bytes(spec, spec.fk.lanes, r["live"])
                           + PROLOGUE_BYTES_PER_LANE * spec.fk.lanes)
                r["bound"] = bound_ms(variant(spec), r["lane_events"], n_bytes, r["collisions"],
                                      table=spec.table)
                timed[(name, state)] = r
                fields.update(lane_events=r["lane_events"], collisions=r["collisions"],
                              device_ms=f"{r['device_ms']:.4f}", plain_ms=f"{r['twin_ms']:.4f}",
                              bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1])
            say("45 fused-k-block-vs-plain", **fields, card=json.dumps(card))
    check(len(built) == 56 and set(seen) == built,
          f"45: fused-k instantiations run {sorted(seen)}, built {sorted(built)}")
    say("45 fused-k-block-vs-plain", cases=len(fks.fk_cases()), case_states=n_cases,
        path_states=n_states - n_cases, instantiations=len(seen), bit_equal=True,
        max_abs_err=f"{max(err.values()):.3e}", card=json.dumps(card))
    return {"timed": timed, "err": err}


def _band_stats(band, keys=("fup", "fdn", "fabs", "n_bad")) -> dict:
    return {k: float(band.mean["derived"][k]) for k in keys}


def fk_band_rates(tag: str, sc, counter: str, n: int, batches: int, seed: int,
                  cache: dict) -> dict:
    """The band of ``sc`` fused and baked at ``n`` photons a k point and
    ``batches`` batches, after a warm-up of each, in turns (fused, baked,
    baked, fused, fused, baked), each run with the launch counts set to 0
    just before it and read just after (the fused mode launches its fused-k
    variant only, the baked one the gas variant only); closure within 1e-5
    and n_bad 0 on every run; photons/s of each mode the median of its
    three (the measurements ``spectral.FUSED_AUTO_MAX_PHOTONS`` rests on)."""
    from i3rc_tpu_torch import run_band

    derive = lambda r: {"fup": r.mean_flux_up, "fdn": r.mean_flux_down,
                        "fabs": r.mean_flux_absorbed, "n_bad": r.n_bad}
    band = lambda mode, s_: run_band(sc.band, sc.dom, sc.kd, sc.src, n, batches, seed=s_,
                                     derive=derive, integrator_cache=cache, mode=mode,
                                     n_lanes=sc.lanes)
    out = {}
    for mode in ("fused", "baked"):
        band(mode, seed)                            # warm-up
    for rep_ in range(6):
        mode = ("fused", "baked")[(rep_ + rep_ // 2) % 2]      # f, b, b, f, f, b
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        b = band(mode, seed + 1 + rep_)
        m = _band_stats(b)
        dt = time.perf_counter() - t0
        launches = table_path_counts(counter if mode == "fused" else counter.replace(
            "fused_k_launches", "gas_launches"))
        check(abs(m["fup"] + m["fdn"] + m["fabs"] - 1.0) < 1e-5 and m["n_bad"] == 0,
              f"{tag} {mode}: {m}")
        check((b.per_k == []) == (mode == "fused"), f"{tag} {mode}: per_k")
        if mode not in out:
            out[mode] = dict(band=b, m=m, launches=launches, times=[])
        out[mode]["times"].append(dt)
    for o in out.values():
        o["seconds"] = sorted(o["times"])[1]
        o["rate"] = n * sc.kd.n_k * batches / o["seconds"]
    return out


def fk_band_pair(tag: str, sc, card: str, counter: str, seed: int) -> dict:
    """Phases 46-47: fk_band_rates at the path's size; Fup of the fused band
    within 5 combined sigma of the baked band's (the binomial sigma of the
    band mean from the baked per-k Fup, for either mode); one more batch of
    each timed per launch (batch_kernel_time: the fused batch beside the
    baked batches of both k points); then fk_band_rates at 8 times the
    photons a k point, above spectral.FUSED_AUTO_MAX_PHOTONS a band batch,
    where "auto" takes the baked mode."""
    from i3rc_tpu_torch import batch_key
    from i3rc_tpu_torch.integrators import spectral

    cache = {}
    out = fk_band_rates(tag, sc, counter, sc.n, sc.batches, seed, cache)
    per_k = [float(st.mean["derived"]["fup"]) for st in out["baked"]["band"].per_k]
    sigma = sum(w * w * f * (1 - f) / (sc.n * sc.batches)
                for w, f in zip(sc.kd.weights, per_k)) ** 0.5
    f_f, f_b = out["fused"]["m"]["fup"], out["baked"]["m"]["fup"]
    check(abs(f_f - f_b) <= 5 * 2 ** 0.5 * sigma,
          f"{tag}: fused Fup {f_f} vs baked {f_b} (sigma {sigma:.2e})")
    key = batch_key(SEED, seed + 10)
    check(sc.lanes >= 256 * sc.kd.n_k, f"{tag}: {sc.lanes} lanes")
    bks = []
    for integ, n in [(sc.fused, sc.n * sc.kd.n_k)] + [(b_, sc.n) for b_ in sc.baked]:
        tracer = integ.batch_tracer(n, sc.lanes)
        run = lambda tr=tracer, d=integ.device: tr(key, sc.src.sample(key, sc.lanes, d), sc.src)
        run()
        bks.append(batch_kernel_time(run))
    bk, baked_bks = bks[0], bks[1:]
    say(f"{tag}-batch-kernel", side="fused", photons=sc.n * sc.kd.n_k, **batch_fields(bk, card))
    for k, b_ in enumerate(baked_bks):
        say(f"{tag}-batch-kernel", side="baked", k_point=k, photons=sc.n,
            **batch_fields(b_, card))
    say(tag, photons=sc.n * sc.kd.n_k * sc.batches, lanes=sc.lanes,
        fup=f"{f_f:.6f}", fdn=f"{out['fused']['m']['fdn']:.6f}",
        fabs=f"{out['fused']['m']['fabs']:.6f}", fup_baked=f"{f_b:.6f}",
        sigma=f"{sigma:.2e}", seconds=",".join(f"{t:.4f}" for t in out["fused"]["times"]),
        photons_per_s=f"{out['fused']['rate']:.4e}",
        baked_seconds=",".join(f"{t:.4f}" for t in out["baked"]["times"]),
        baked_photons_per_s=f"{out['baked']['rate']:.4e}",
        fused_over_baked=f"{out['fused']['rate'] / out['baked']['rate']:.3f}",
        launches=out["fused"]["launches"], baked_launches=out["baked"]["launches"],
        batch_kernel_ms=f"{bk['kernel_ms']:.3f}",
        baked_batch_kernel_ms=f"{sum(b_['kernel_ms'] for b_ in baked_bks):.3f}",
        card=json.dumps(card))
    large = fk_band_rates(tag, sc, counter, 8 * sc.n, sc.batches, seed + 20, cache)
    n_band = 8 * sc.n * sc.kd.n_k
    check(sc.n * sc.kd.n_k <= spectral.FUSED_AUTO_MAX_PHOTONS < n_band,
          f"{tag}: the two sizes do not straddle FUSED_AUTO_MAX_PHOTONS")
    say(f"{tag}-large", photons_per_band_batch=n_band, batches=sc.batches, lanes=sc.lanes,
        auto_takes="baked",
        fup=f"{large['fused']['m']['fup']:.6f}", fup_baked=f"{large['baked']['m']['fup']:.6f}",
        seconds=",".join(f"{t:.4f}" for t in large["fused"]["times"]),
        photons_per_s=f"{large['fused']['rate']:.4e}",
        baked_seconds=",".join(f"{t:.4f}" for t in large["baked"]["times"]),
        baked_photons_per_s=f"{large['baked']['rate']:.4e}",
        fused_over_baked=f"{large['fused']['rate'] / large['baked']['rate']:.3f}",
        card=json.dumps(card))
    return dict(out, sigma=sigma, batch=bk, baked_batches=baked_bks, large=large)


def fk_band_means(sc, mode: str, seed: int, derive) -> tuple:
    """(mean, stderr) of the derived tree of a band of ``sc`` in ``mode``."""
    from i3rc_tpu_torch import run_band

    b = run_band(sc.band, sc.dom, sc.kd, sc.src, sc.n, sc.batches, seed=seed, derive=derive,
                 mode=mode, integrator_cache={}, n_lanes=sc.lanes)
    return b.mean["derived"], b.stderr["derived"], b


def fused_k_paths(card: str) -> dict:
    """Phases 46-50: the fused-k paths through run_band(mode="fused"), each
    driven with the launch counts set to 0 just before it and read just
    after, each against the baked band on the same scene (or a closed
    form).  Returns per variant the path's launches and records."""
    rec = {}
    # 46. the bench row at full width (bench.py:274-337): the step cloud, k =
    # 4e-4 and 4e-3 (weights 0.7 / 0.3), 2 fused batches of 2 x 2^24 photons
    # at phase 13's lanes; Fup within 5 combined sigma of the baked band and
    # within 5 sigma + 3e-4 of the JAX anchor 0.4040
    sc = fk_path_scene("46_bench", "cuda")
    r = fk_band_pair("46 fused-k-bench-band", sc, card, "fused_k_launches", 1120)
    f_f = r["fused"]["m"]["fup"]
    check(abs(f_f - ANCHOR_BROADBAND_FUP) <= 5 * r["sigma"] + 3e-4,
          f"46: fused Fup {f_f} vs {ANCHOR_BROADBAND_FUP} (sigma {r['sigma']:.2e})")
    rec["fused_k"] = r

    # 47. the production broadband class: phase 42's band over the C.1 step
    # cloud, fused (the table variant), against the baked K2-T band
    sc = fk_path_scene("47_c1_band", "cuda")
    rec["table_fused_k"] = fk_band_pair("47 fused-k-c1-band", sc, card,
                                        "table_fused_k_launches", 1140)

    # 48. the step cloud + the bench band with the three I3RC detectors,
    # exact and Iwabuchi: 8 x 2^21 photons per k point, fused against baked
    # (the band's weighted detectors) within 5 combined standard errors
    derive = lambda r_: {"i": r_.mean_intensity, "fup": r_.mean_flux_up,
                         "fdn": r_.mean_flux_down, "fabs": r_.mean_flux_absorbed}
    for est in ("iwabuchi", "exact"):
        sc = fk_path_scene(f"48_detectors_{est}", "cuda")
        reset_counts()
        mf, sf, bf = fk_band_means(sc, "fused", 1150, derive)
        launches = table_path_counts("fused_k_detector_launches")
        reset_counts()
        mb, sb, _ = fk_band_means(sc, "baked", 1160, derive)
        baked_launches = table_path_counts("gas_detector_launches")
        i_f, i_b = mf["i"].double().cpu().numpy(), mb["i"].double().cpu().numpy()
        se = np.sqrt(sf["i"].double().cpu().numpy() ** 2 + sb["i"].double().cpu().numpy() ** 2)
        check(np.all(np.abs(i_f - i_b) <= 5 * se) and np.all(i_f > 0) and bf.per_k == [],
              f"48 {est}: I {i_f} vs baked {i_b} (se {se})")
        closure = float(mf["fup"] + mf["fdn"] + mf["fabs"])
        check(abs(closure - 1.0) < 1e-5, f"48 {est}: closure {closure}")
        say("48 fused-k-detectors", estimator=est, photons=sc.n * sc.kd.n_k * sc.batches,
            lanes=sc.lanes, intensity=",".join(f"{v:.5f}" for v in i_f),
            intensity_baked=",".join(f"{v:.5f}" for v in i_b),
            combined_se=",".join(f"{v:.1e}" for v in se), launches=launches,
            baked_launches=baked_launches, card=json.dumps(card))
        if est == "iwabuchi":
            rec["fused_k_detectors"] = launches
            rec["gas_detectors_baked"] = baked_launches

    # 49. heating rates: the absorbing step cloud (ssa 0.99) and two k points
    # of layered gas with the volume tally (gas deaths at their exact layer),
    # 8 x 2^21 photons per k point; the layer profile of the absorption
    # within 5 combined standard errors of the baked band's
    sc = fk_path_scene("49_heating", "cuda")
    derive = lambda r_: {"profile": r_.absorbed_profile, "fabs": r_.mean_flux_absorbed}
    reset_counts()
    mf, sf, _ = fk_band_means(sc, "fused", 1170, derive)
    launches = table_path_counts("fused_k_launches")
    mb, sb, _ = fk_band_means(sc, "baked", 1180, derive)
    p_f, p_b = mf["profile"].double().cpu().numpy(), mb["profile"].double().cpu().numpy()
    se = np.sqrt(sf["profile"].double().cpu().numpy() ** 2
                 + sb["profile"].double().cpu().numpy() ** 2)
    check(np.all(np.abs(p_f - p_b) <= 5 * se) and np.all(p_f > 0),
          f"49: profile {p_f} vs baked {p_b} (se {se})")
    worst = float(np.max(np.abs(p_f - p_b) / se))
    say("49 fused-k-heating", photons=sc.n * sc.kd.n_k * sc.batches, lanes=sc.lanes, layers=len(p_f),
        fabs=f"{float(mf['fabs']):.6f}", fabs_baked=f"{float(mb['fabs']):.6f}",
        worst_layer_sigmas=f"{worst:.2f}", launches=launches, card=json.dumps(card))

    # 50. the internal source of the Beer-Lambert scene (an upward Lambertian
    # source at mid-height; the JAX fused mode starts its lanes at the top's
    # gas depth and gives 0.9089): Fup = sum_k w_k 2 E3(tau_k / 2) within 4
    # sigma; and the bench band over a Lambertian albedo of 0.2, fused
    # against baked within 5 combined sigma
    fks = _load_tests_module("fused_k_scenes")
    sc = fk_path_scene("50_internal", "cuda")
    derive = lambda r_: {"fup": r_.mean_flux_up, "fdn": r_.mean_flux_down,
                         "fabs": r_.mean_flux_absorbed, "n_bad": r_.n_bad}
    reset_counts()
    mf, _, _ = fk_band_means(sc, "fused", 1190, derive)
    launches = table_path_counts("fused_k_launches")
    want = fks.internal_closed_form()
    n_total = sc.n * sc.kd.n_k * sc.batches
    sigma = (want * (1 - want) / n_total) ** 0.5
    fup = float(mf["fup"])
    check(abs(fup - want) <= 4 * sigma, f"50: internal source Fup {fup} vs {want}")
    say("50 fused-k-internal-source", photons=n_total, fup=f"{fup:.6f}",
        closed_form=f"{want:.6f}", sigma=f"{sigma:.2e}", launches=launches,
        card=json.dumps(card))
    sc = fk_path_scene("50_albedo", "cuda")
    reset_counts()
    mf, _, _ = fk_band_means(sc, "fused", 1200, derive)
    launches = table_path_counts("fused_k_surface_launches")
    mb, _, bb = fk_band_means(sc, "baked", 1210, derive)
    per_k = [float(st.mean["derived"]["fup"]) for st in bb.per_k]
    sigma = sum(w * w * f * (1 - f) / (sc.n * sc.batches)
                for w, f in zip(sc.kd.weights, per_k)) ** 0.5
    check(abs(float(mf["fup"]) - float(mb["fup"])) <= 5 * 2 ** 0.5 * sigma
          and float(mf["n_bad"]) == 0, f"50: albedo Fup {mf} vs baked {mb}")
    say("50 fused-k-albedo", photons=sc.n * sc.kd.n_k * sc.batches, albedo=0.2,
        fup=f"{float(mf['fup']):.6f}", fup_baked=f"{float(mb['fup']):.6f}",
        sigma=f"{sigma:.2e}", launches=launches, card=json.dumps(card))
    # The surface stage's share of one fused band batch over the albedo.
    from i3rc_tpu_torch import batch_key
    from i3rc_tpu_torch.integrators.fastpath import lane_width

    n = sc.n * sc.kd.n_k
    lanes = lane_width(n, sc.lanes, sc.kd.n_k)
    key = batch_key(SEED, 1220)
    tracer = sc.fused.batch_tracer(n, lanes)
    batch = lambda: tracer(key, sc.src.sample(key, lanes, "cuda"), sc.src)
    pb = profile_batch(batch)
    bk = batch_kernel_time(batch)
    say("50 fused-k-albedo-batch-kernel", photons=n, hits=bk["hits"], **batch_fields(bk, card))
    rec["albedo"] = (launches, surface_stage_record("50 fused-k-albedo", pb, bk, n, lanes,
                                                    card))
    return rec


def fused_k_entry(kind: str, source: str, replaces: str, rec: dict, checks: dict) -> dict:
    """The kernels-line entry of a fused-k variant: launches on its path
    (phase 46 or 47, the fused band), its largest state difference to the
    plain version (phase 45), its device time, plain time and bound on its
    path's mid-flight block, and one fused batch of the path beside the
    baked batches of its gas sibling over both k points (K2 or K2-T) and
    the two modes' photons/s."""
    r = checks["timed"][(FK_TIMED[kind], "mid")]
    tail = checks["timed"][(FK_TIMED[kind], "tail")]
    bk = rec["batch"]
    return {"name": f"fast_event_block_{'tab_' if kind.startswith('table') else ''}fused_k",
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": rec["fused"]["launches"], "max_abs_err": checks["err"].get(kind, 0.0),
            "ms": r["device_ms"], "plain_ms": r["twin_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None, "tail_ms": tail["device_ms"],
            "tail_bound_ms": tail["bound"][0], "batch_ms": bk["kernel_ms"],
            "batch_launches": bk["launches"], "batch_bound_ms": bk["bound"][0],
            "baked_batch_ms": sum(b["kernel_ms"] for b in rec["baked_batches"]),
            "photons_per_s": rec["fused"]["rate"], "baked_photons_per_s": rec["baked"]["rate"]}


# ---------------------------------------------------------------------------
# Polarized transport (ROADMAP item 17): the polarized event block PZ
# (csrc/polarized_event_block.cuh) against its plain version, and its paths

PZ_BENCH_PHOTONS = 1 << 23          # bench.py:340-377's row
PZ_BENCH_LANES = 1 << 16            # the bench row's lanes
# Detector 0's degree of polarization on the bench row (BENCH_r05.json,
# "DoP(94deg)=0.715"): a physics value of the JAX package, not a speed.
ANCHOR_PZ_DOP = 0.715
PZ_STEP_PHOTONS = 1 << 22           # the Mie step cloud
PZ_STEP_LANES = 1 << 20
# Closure of a batch: the Stokes weight ratio I / a1 has expectation 1, not
# value 1, so Fup + Fdn (+ Fabs) of a conservative scene spreads about 1
# (per photon std 0.39 on the tau-1 Rayleigh slab, 0.27 on the Mie step
# cloud: the port's CPU twin, 8 batches each); 1e-3 is >= 5 sigma at these
# batches.
PZ_CLOSURE_TOL = 1e-3
# Operations (ALU, SFU) by hand from csrc/polarized_event_block.cuh: per
# lane-event two Philox4x32-10 calls (~200 integer operations), the free
# path's logf, the exit division, the wraps' fmodf and the cell's three
# locates (true divisions); per collision the component pick, the chi
# rotation (sincos polynomial), the cubic, acosf and the division by pi,
# the matrix interpolation, I / a1 and 1 / I, the renormalizations' two
# square roots and two reciprocals; per estimate ray the rotations, acosf,
# the matrix and the prefactor's division; per ratio-tracking round half a
# Philox call, logf, the wraps, the locates, the ratio and the roulette's
# division.
OPS_PER_PZ_EVENT = (300, 6)
OPS_PER_PZ_COLLISION = (200, 10)
OPS_PER_PZ_RAY = (140, 7)
OPS_PER_PZ_ROUND = (120, 6)
PZ_STATE_ROWS = 19                  # 13 float, 6 int32


# ptxas of the sets with detectors, and of PZ's, as the build before the
# estimate stages traced their rays from the CTAs' ray queues gave them
# (registers / stack / spill stores / CTAs per SM; NVIDIA H100 80GB HBM3
# machine's nvcc, its phase 2): phase 2 prints each beside this build's.
BEFORE_QUEUE_PTXAS = {
    "maxcs_general_det": "64regs/448Bstack/556Bspill/4cta",
    "maxcs_general_reflecting_det": "64regs/512Bstack/636Bspill/4cta",
    "maxcs_uniform_det": "64regs/448Bstack/516Bspill/4cta",
    "maxcs_uniform_reflecting_det": "64regs/496Bstack/588Bspill/4cta",
    "rt_general_det": "64regs/448Bstack/812Bspill/4cta",
    "rt_general_reflecting_det": "64regs/512Bstack/852Bspill/4cta",
    "rt_uniform_det": "64regs/448Bstack/812Bspill/4cta",
    "rt_uniform_reflecting_det": "64regs/496Bstack/804Bspill/4cta",
    "woodcock_general_det": "64regs/464Bstack/712Bspill/4cta",
    "woodcock_general_reflecting_det": "64regs/512Bstack/772Bspill/4cta",
    "woodcock_uniform_det": "64regs/448Bstack/692Bspill/4cta",
    "woodcock_uniform_reflecting_det": "64regs/496Bstack/740Bspill/4cta",
    "woodcock_uniform_weight1_det": "64regs/448Bstack/692Bspill/4cta",
    "pz_flux": "72regs/56Bstack/0Bspill/3cta",
    "pz_detectors": "75regs/64Bstack/0Bspill/3cta",
    "pz_lambertian": "72regs/56Bstack/0Bspill/3cta",
    "pz_detectors_lambertian": "80regs/64Bstack/0Bspill/3cta",
}
PTXAS_FMT = "{registers}regs/{stack_bytes}Bstack/{spill_store_bytes}Bspill/{ctas_per_sm}cta"


def ptxas_polarized(log: str) -> dict:
    """Per PZ instantiation (flux, detectors, lambertian, detectors_
    lambertian): registers, the kernel's own stack and spill bytes, CTAs
    per SM (ptxas_general's reading)."""
    from i3rc_tpu_torch.kernels.polarized_block import VARIANTS

    out, name, own = {}, None, False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*polarized_event_block_kernelILb(\d)ELb(\d)E",
                      line)
        if m:
            name = VARIANTS[int(m[1]) + 2 * int(m[2])]
            out[name], own = {}, False
        elif "Compiling entry function" in line:
            name = None
        elif name and "Function properties for" in line:
            own = "polarized_event_block_kernel" in line
        elif name and own and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                                              r"stores", line)):
            out[name].update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name].update(registers=int(m[1]), ctas_per_sm=ctas_per_sm(int(m[1])))
    return out


def pz_bound(lane_events: int, collisions: int, rays: int, rounds: int, n_bytes: int):
    """(least ms, what bounds it) of PZ's work: lane-events, collisions,
    estimate rays and ratio-tracking rounds (OPS_PER_PZ_*), and ``n_bytes``
    of device memory."""
    work = ((lane_events, OPS_PER_PZ_EVENT), (collisions, OPS_PER_PZ_COLLISION),
            (rays, OPS_PER_PZ_RAY), (rounds, OPS_PER_PZ_ROUND))
    alu = sum(n * ops[0] for n, ops in work)
    sfu = sum(n * ops[1] for n, ops in work)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(alu / FP32_OPS_PER_S, sfu / SFU_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pz_block_bytes(spec, n_lanes: int, n_live: int) -> int:
    """Bytes one block needs to move: every lane's alive flag read; the 19
    rows of each live lane read once and written once (its alive flag
    counted once); the optics, the cubic, the matrix table and the detector
    rows read once; each float64 tally written once."""
    n = 4 * n_lanes + n_live * (2 * PZ_STATE_ROWS * 4 - 4)
    for t in (spec.total_ext, spec.cells, spec.cubic, spec.matrix, spec.det):
        n += t.numel() * t.element_size()
    g = spec.geom
    return n + 8 * g.n_x * g.n_y * (3 + 4 * spec.n_dirs)


def pz_block_counts(st0, st) -> dict:
    """Device scalars of one block from the lane state before and after:
    live lanes, lane-events, collisions (order grows by one a collision; a
    refilled lane restarts at 0), estimate rays and ratio-tracking rounds."""
    from i3rc_tpu_torch.integrators import polarized as pz

    events = st.i[pz.EVCT] - st0.i[pz.EVCT]
    refilled = (st0.i[pz.ALIVE] == 0) & (events > 0)
    grow = lambda row: (st.i[row] - st0.i[row]).sum(dtype=torch.int64)
    return {"live": (events > 0).sum(), "lane_events": events.sum(dtype=torch.int64),
            "collisions": st.i[pz.ORDER].sum(dtype=torch.int64)
            - (st0.i[pz.ORDER] * ~refilled).sum(dtype=torch.int64),
            "rays": grow(pz.RAYS), "rounds": grow(pz.ROUNDS)}


def pz_batch_time(integ, src, n: int, lanes: int, key, profile: bool = True) -> dict:
    """One batch with each PZ launch bracketed by CUDA events behind a ~1 ms
    spin (batch_kernel_time's method): the kernel's device time over the
    batch (the profiler's where it shows device time, else the events'),
    the launches, blocks, and the batch's lane-events, collisions, rays and
    rounds and its bound (per block: pz_block_bytes of the block's live
    lanes)."""
    import i3rc_tpu_torch.kernels.polarized_block as pbm

    orig = pbm._launch
    rec = []
    flushes = pbm.ray_flush_counter("cuda")
    flushes.zero_()

    def bracketed(spec, st, buf, key_, source, kb):
        st0 = st.clone()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        orig(spec, st, buf, key_, source, kb)
        b.record()
        rec.append((spec, a, b, st.n_lanes, pz_block_counts(st0, st)))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    pbm._launch = bracketed
    try:
        tracer = integ.batch_tracer(n, lanes)
        run = lambda: tracer(key, src.sample(key, lanes, integ.device), src)
        if profile:
            with torch.profiler.profile(activities=acts) as prof:
                raw = run()
                torch.cuda.synchronize()
        else:
            raw = run()
            torch.cuda.synchronize()
    finally:
        pbm._launch = orig
    prof_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if "polarized_event_block" in e.key) if profile else 0
    spec = rec[0][0]
    tot = {k: sum(int(r[4][k]) for r in rec) for k in rec[0][4]}
    n_bytes = sum(pz_block_bytes(spec, r[3], int(r[4]["live"])) for r in rec)
    events_ms = sum(r[1].elapsed_time(r[2]) for r in rec)
    kernel_ms, source = (prof_us / 1e3, "profiler") if prof_us else (events_ms, "cuda-events")
    return {"raw": raw, "launches": len(rec), "blocks": raw["n_blocks"], "kernel_ms": kernel_ms,
            "kernel_ms_from": source, "events_ms": events_ms, "flushes": int(flushes[0]), **tot,
            "bound": pz_bound(tot["lane_events"], tot["collisions"], tot["rays"],
                              tot["rounds"], n_bytes)}


def pz_batch_fields(bk: dict, card: str) -> dict:
    return dict(launches=bk["launches"], blocks=bk["blocks"], kernel_ms=f"{bk['kernel_ms']:.3f}",
                kernel_ms_from=bk["kernel_ms_from"], events_ms=f"{bk['events_ms']:.3f}",
                live_lanes=bk["live"], lane_events=bk["lane_events"],
                collisions=bk["collisions"], rays=bk["rays"], rounds=bk["rounds"],
                ray_flushes=bk["flushes"],
                ray_flushes_per_block=f"{bk['flushes'] / max(bk['launches'], 1):.1f}",
                bound_ms=f"{bk['bound'][0]:.3f}", bound_by=bk["bound"][1], card=json.dumps(card))


def pz_scene(name: str, dev) -> SimpleNamespace:
    """The scenes of phases 52-53 on the port: the bench row's Rayleigh
    atmosphere with its 2 detectors (max_events 200) and the Mie step cloud
    with the shipped namelist's 3 detectors (the default max_events)."""
    from i3rc_tpu_torch.integrators.polarized import PolarizedIntegrator

    pzs = _load_tests_module("polarized_scenes")
    h = pzs.host("i3rc_tpu_torch")
    if name == "52_bench":
        integ = PolarizedIntegrator.create(
            pzs.bench_scene(h), config=h.Config(**pzs.CFG_KW, max_events=200), device=dev,
            **pzs.BENCH_DETECTORS)
        return SimpleNamespace(integ=integ, src=h.Source.directional(0.5, 0.0),
                               n=PZ_BENCH_PHOTONS, lanes=PZ_BENCH_LANES)
    integ = PolarizedIntegrator.create(pzs.mie_step_cloud(h), config=h.Config(**pzs.CFG_KW),
                                       device=dev, intensity_mus=DET_MUS, intensity_phis=DET_PHIS)
    return SimpleNamespace(integ=integ, src=h.Source.directional(0.5, 0.0), n=PZ_STEP_PHOTONS,
                           lanes=PZ_STEP_LANES)


def polarized_kernel_vs_twin(dev, card: str, built: dict) -> dict:
    """Phase 51: PZ against its plain version, bit for bit.  The small cases
    of tests/polarized_scenes.py pz_cases (TABLE_CASE_LANES lanes, 4x the
    photons: every instantiation, one and two components, a polarized
    source, the event budget) and phases 52-53's scenes at their photons
    and lanes, each on its launch, mid-flight and tail states: every state
    row, the control state and the dead counts bit for bit, the tallies
    within 1e-9.  The instantiations run must be the four built.  The
    mid-flight and tail blocks of the path scenes are timed: the kernel's
    device time (profiler), the plain version's (CUDA events) and the
    bound.  Returns the timed records and the largest state difference."""
    from i3rc_tpu_torch import batch_key
    from i3rc_tpu_torch.integrators.polarized import polarized_block_reference
    from i3rc_tpu_torch.kernels.polarized_block import polarized_block, variant

    pzs = _load_tests_module("polarized_scenes")
    seen, timed, err, n_states = set(), {}, 0.0, 0

    def hold(tag, integ, src, n, lanes, key):
        nonlocal err, n_states
        spec, states = pzs.trace_states(integ, src, n, lanes, key)
        for state, st, buf, kb in states:
            r = pzs.block_vs_twin(spec, st, buf, key, src, kb)
            check(r["bit_equal"] and r["tally_abs_err"] <= 1e-9, f"51 {tag} {state}: {r}")
            err = max(err, r["max_abs_err"])
            n_states += 1
            seen.add(variant(spec))
            yield spec, state, st, buf, kb, r

    for name in pzs.pz_cases():
        integ, src = pzs.case_integrator(name, dev)
        for _ in hold(name, integ, src, 4 * TABLE_CASE_LANES, TABLE_CASE_LANES,
                      batch_key(SEED, 1300)):
            pass
    n_cases = n_states
    for name in ("52_bench", "53_mie_step_cloud"):
        sc = pz_scene(name, dev)
        key = batch_key(SEED, 1310)
        for spec, state, st, buf, kb, r in hold(name, sc.integ, sc.src, sc.n, sc.lanes, key):
            fields = dict(scene=name, state=state, lanes=sc.lanes, photons=sc.n, kb=kb,
                          live=r["live"], bit_equal=r["bit_equal"],
                          tally_abs_err=f"{r['tally_abs_err']:.3e}", instantiation=variant(spec))
            if state != "launch":
                run_k = lambda s_, b_: polarized_block(spec, s_, b_, key, sc.src, kb)
                run_p = lambda s_, b_: polarized_block_reference(spec, s_, b_, key, sc.src, kb)
                r["device_ms"] = device_block_ms(run_k, st, buf.clone, 20, "polarized_event_block")
                r["twin_ms"] = time_block_ms(run_p, st, buf.clone, 1)
                r["bound"] = pz_bound(r["lane_events"], r["collisions"], r["rays"], r["rounds"],
                                      pz_block_bytes(spec, sc.lanes, r["live"]))
                timed[(name, state)] = r
                fields.update(lane_events=r["lane_events"], collisions=r["collisions"],
                              rays=r["rays"], rounds=r["rounds"],
                              device_ms=f"{r['device_ms']:.4f}", plain_ms=f"{r['twin_ms']:.2f}",
                              bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1])
            say("51 polarized-block-vs-plain", **fields, card=json.dumps(card))
    check(seen == set(built), f"51: PZ instantiations run {sorted(seen)}, built {sorted(built)}")
    say("51 polarized-block-vs-plain", cases=len(pzs.pz_cases()), case_states=n_cases,
        path_states=n_states - n_cases, instantiations=len(seen), bit_equal=True,
        max_abs_err=f"{err:.3e}", card=json.dumps(card))
    return {"timed": timed, "err": err}


def pz_closure(res) -> float:
    return float(res.mean_flux_up + res.mean_flux_down + res.mean_flux_absorbed)


def polarized_paths(out: Path, card: str) -> dict:
    """Phases 52-54: the bench row's scene (at its lanes and at the port's
    lane_width), the Mie step cloud, and the polarized namelist through the
    driver, each driven with PZ's launch counts set to 0 just before it and
    read just after.  Returns the records of the kernels line."""
    from i3rc_tpu_torch import batch_key
    from i3rc_tpu_torch.drivers.monte_carlo_driver import run_from_namelist
    from i3rc_tpu_torch.integrators.fastpath import lane_width
    from i3rc_tpu_torch.kernels import polarized_block as pb

    rec = {}
    # 52. bench.py:340-377: 2^23 photons at 2^16 lanes (the bench's) and at
    # lane_width; photons/s median of 3 after a warm-up; closure and n_bad
    # every batch; detector 0's DoP over 4 batches against the JAX value
    sc = pz_scene("52_bench", "cuda")
    for tag, lanes in (("bench_lanes", sc.lanes), ("port_lanes", lane_width(sc.n))):
        fn = sc.integ.batch_fn(sc.src, sc.n, n_lanes=lanes)
        fn(batch_key(SEED, 1400))
        torch.cuda.synchronize()
        pb.reset_launch_counters()
        dops, times = [], []
        for b in range(4):
            t0 = time.perf_counter()
            res = fn(batch_key(SEED, 1401 + b))
            c, bad = pz_closure(res), int(res.n_bad)
            dops.append(float(res.degree_of_polarization[0]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(abs(c - 1.0) <= PZ_CLOSURE_TOL + bad / sc.n and bad == 0,
                  f"52 {tag}: closure {c}, n_bad {bad}")
            check(bool(torch.isfinite(res.intensity).all())
                  and tuple(res.intensity.shape) == (1, 1, 2, 4), f"52 {tag}: intensity")
        launches = pb.polarized_block.launches
        check(launches > 0 and pb.polarized_block.variant_launches["detectors"] == launches,
              f"52 {tag}: PZ launches {pb.polarized_block.variant_launches}")
        dop, dop_se = float(np.mean(dops)), float(np.std(dops, ddof=1) / 2.0)
        check(abs(dop - ANCHOR_PZ_DOP) <= 5 * dop_se + 0.005,
              f"52 {tag}: DoP {dop} +- {dop_se} vs {ANCHOR_PZ_DOP}")
        rate = sc.n / float(np.median(times[:3]))
        rec[tag] = {"launches": launches, "rate": rate, "dop": dop}
        say("52 polarized-bench", lanes=lanes, photons=sc.n, batches=4,
            fup=f"{float(res.mean_flux_up):.6f}", closure=f"{c:.6f}", dop=f"{dop:.5f}",
            dop_se=f"{dop_se:.1e}", anchor=ANCHOR_PZ_DOP,
            stokes0=",".join(f"{float(v):.5f}" for v in res.mean_intensity[0]),
            seconds=",".join(f"{t:.4f}" for t in times), photons_per_s=f"{rate:.4e}",
            launches=launches, card=json.dumps(card))
        bk = pz_batch_time(sc.integ, sc.src, sc.n, lanes, batch_key(SEED, 1410))
        rec[tag]["batch"] = bk
        say("52 polarized-bench-batch-kernel", lanes=lanes, photons=sc.n,
            **pz_batch_fields(bk, card))

    # 53. the Mie step cloud (32 x 1 x 32, tau 2 / 18, a 10 um drop at 0.67
    # um) with the 3 I3RC detectors: 3 batches of 2^22 photons at 2^20 lanes
    sc = pz_scene("53_mie_step_cloud", "cuda")
    fn = sc.integ.batch_fn(sc.src, sc.n, n_lanes=sc.lanes)
    fn(batch_key(SEED, 1500))
    torch.cuda.synchronize()
    pb.reset_launch_counters()
    times, fups, stokes = [], [], []
    for b in range(3):
        t0 = time.perf_counter()
        res = fn(batch_key(SEED, 1501 + b))
        c, bad = pz_closure(res), int(res.n_bad)
        fups.append(float(res.mean_flux_up))
        stokes.append(res.mean_intensity.double().cpu().numpy())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(abs(c - 1.0) <= PZ_CLOSURE_TOL + bad / sc.n and bad == 0,
              f"53: closure {c}, n_bad {bad}")
        check(bool(torch.isfinite(res.intensity).all())
              and tuple(res.intensity.shape) == (32, 1, 3, 4), "53: intensity")
    launches = pb.polarized_block.launches
    check(launches > 0 and pb.polarized_block.variant_launches["detectors"] == launches,
          f"53: PZ launches {pb.polarized_block.variant_launches}")
    rate = sc.n / float(np.median(times))
    st = np.stack(stokes)
    rec["step"] = {"launches": launches, "rate": rate}
    say("53 polarized-mie-step-cloud", photons=sc.n, lanes=sc.lanes, batches=3,
        fup=f"{np.mean(fups):.6f}", closure=f"{c:.6f}",
        stokes=";".join(",".join(f"{v:.5f}" for v in d) for d in st.mean(0)),
        stokes_se=";".join(",".join(f"{v:.1e}" for v in d)
                           for d in st.std(0, ddof=1) / np.sqrt(3)),
        seconds=",".join(f"{t:.4f}" for t in times), photons_per_s=f"{rate:.4e}",
        launches=launches, card=json.dumps(card))
    bk = pz_batch_time(sc.integ, sc.src, sc.n, sc.lanes, batch_key(SEED, 1510))
    rec["step"]["batch"] = bk
    say("53 polarized-mie-step-cloud-batch-kernel", photons=sc.n, **pz_batch_fields(bk, card))

    # 54. the polarized namelist of tests/test_polarized.py:380-433 through
    # the port's driver on the card: Stokes ASCII and netCDF outputs
    from scipy.io import netcdf_file

    from i3rc_tpu_torch.io.netcdf import write_domain

    pzs = _load_tests_module("polarized_scenes")
    d = out / "polarized"
    d.mkdir(parents=True, exist_ok=True)
    write_domain(pzs.rayleigh_slab(pzs.host("i3rc_tpu_torch"), 0.5), str(d / "ray.dom"))
    nml = d / "polarized.nml"
    nml.write_text(textwrap.dedent(f"""
    &radiativeTransfer
      solarFlux = 1., solarMu = 0.6, solarAzimuth = 0., surfaceAlbedo = 0.2,
      intensityMus = 0.8, 0.4,  intensityPhis = 0., 120.,
    /
    &monteCarlo
      numPhotonsPerBatch = 4000, numBatches = 4, iseed = 3
    /
    &algorithms
      useRayTracing = .false., polarized = .true.,
    /
    &fileNames
      domainFileName = "{d}/ray.dom",
      outputFluxFile = "{d}/pflux.out",
      outputRadFile = "{d}/prad.out",
      outputNetcdfFile = "{d}/pol.nc"
    /
    &output
    /
    """))
    pb.reset_launch_counters()
    t0 = time.perf_counter()
    drv = run_from_namelist(str(nml), quiet=True, device="cuda")
    t_drv = time.perf_counter() - t0
    check((d / "pflux.out").is_file() and "Stokes" in (d / "prad.out").read_text(),
          "54: the driver wrote no Stokes radiance file")
    mean, err_ = drv["radiance"]
    check(mean.shape == (1, 1, 2, 4) and np.all(mean[..., 0] > 0) and np.all(err_[..., 0] >= 0),
          f"54: radiance {mean}")
    with netcdf_file(str(d / "pol.nc"), "r", mmap=False) as nc:
        dims = nc.variables["intensity"].dimensions
    check(dims == ("stokes", "direction", "y", "x"), f"54: netCDF intensity {dims}")
    check(pb.polarized_block.variant_launches["detectors_lambertian"] > 0,
          f"54: the driver launched {pb.polarized_block.variant_launches}")
    (fup, _), (fdn, _), _ = drv["mean_stats"]
    say("54 polarized-driver", batches=drv["cfg"]["num_batches"],
        photons=drv["cfg"]["num_photons"], fup=f"{fup:.5f}", fdn=f"{fdn:.5f}",
        stokes0=",".join(f"{float(v):.5f}" for v in mean[0, 0, 0]), seconds=f"{t_drv:.2f}",
        launches=pb.polarized_block.launches, card=json.dumps(card))
    return rec


def polarized_entry(checks: dict, rec: dict) -> dict:
    """The kernels-line entry of PZ: launches on its main path (phase 52 at
    the bench's lanes), its largest state difference to the plain version
    (phase 51), its device time, plain time and bound on the bench scene's
    mid-flight block (and tail), and one batch of the bench row and of the
    Mie step cloud beside their bounds."""
    r = checks["timed"][("52_bench", "mid")]
    tail = checks["timed"][("52_bench", "tail")]
    step = checks["timed"][("53_mie_step_cloud", "mid")]
    b, s = rec["bench_lanes"], rec["step"]
    return {"name": "polarized_event_block", "route": "cuda",
            "source": "i3rc_tpu_torch/csrc/polarized_event_block.cu",
            "replaces": "no TPU kernel: XLA in i3rc_tpu/integrators/polarized.py:455 and :328",
            "launches": b["launches"], "max_abs_err": checks["err"], "ms": r["device_ms"],
            "plain_ms": r["twin_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None, "tail_ms": tail["device_ms"], "tail_bound_ms": tail["bound"][0],
            "batch_ms": b["batch"]["kernel_ms"], "batch_launches": b["batch"]["launches"],
            "batch_bound_ms": b["batch"]["bound"][0], "photons_per_s": b["rate"],
            "step_cloud_ms": step["device_ms"], "step_cloud_plain_ms": step["twin_ms"],
            "step_cloud_bound_ms": step["bound"][0],
            "step_cloud_batch_ms": s["batch"]["kernel_ms"],
            "step_cloud_batch_bound_ms": s["batch"]["bound"][0],
            "step_cloud_photons_per_s": s["rate"]}



# ---------------------------------------------------------------------------
# The marching shadow trace (ROADMAP item 10b): the detector block K3 and its
# surface stage on a plan whose x and y factors both vary (K3-M, K3-M+S)
# against their plain version, the closed trace against the marching one, a
# 3-D separable scene against G's exact trace; and the plane-parallel driver
# (ROADMAP item 18)

MARCH_PHOTONS = 1 << 22             # phases 56-57: a batch
MARCH_LANES = 1 << 20
MARCH_BATCHES = 4                   # phase 57, each side
MARCH_SRF_PHOTONS = 1 << 21         # K3-M+S's path: the 3-D scene over RPV
# A marching path may lose this share of its photons (n_bad): a photon past
# the max_events budget of 500 scattering orders and surface bounces
# (march_scenes.CFG_KW) ends as bad; over RPV, 1 of 6.3e6 reached it.
MARCH_BAD_SHARE = 1e-5
PP_PHOTONS = 1 << 22                # phase 58's copies of the shipped namelist
PP_BATCHES = 8
PP_RAD_PHOTONS = 1 << 21            # its radiance copies
PP_RAD_BATCHES = 4
# Fup of the shipped planeParallel namelist's slab (tau 1, HG 0.85,
# conservative, mu0 0.5, black surface) by discrete ordinates
# (tests/disort_oracle.py hg_slab_fluxes; tests/test_external_validation.py:256).
ANCHOR_SLAB_FUP = 0.164878


def march_path_scene(name: str, dev) -> SimpleNamespace:
    """The marching paths' scenes (tests/march_scenes.py separable_3d: HG,
    ssa 0.95, the exact estimator): "3d", phase 57's, with
    march_scenes.DETECTORS at MARCH_PHOTONS; "3d_rpv", the same over the
    RPV surface with the two upward detectors at MARCH_SRF_PHOTONS (K3-M+S);
    both at MARCH_LANES lanes."""
    from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource

    ms = _load_tests_module("march_scenes")
    h = ms.host("i3rc_tpu_torch")
    cfg = IntegratorConfig(**ms.CFG_KW)
    if name == "3d":
        integ = Integrator.create(ms.separable_3d(h), cfg, device=dev, **ms.DETECTORS)
        n = MARCH_PHOTONS
    else:
        integ = Integrator.create(ms.separable_3d(h), cfg, device=dev,
                                  **ms._srf.surface_kw(h, "rpv"), **ms.UP_DETECTORS)
        n = MARCH_SRF_PHOTONS
    return SimpleNamespace(integ=integ, n=n, lanes=MARCH_LANES,
                           src=PhotonSource.directional(0.5, 0.0))


def march_block_bound(spec, r: dict, lanes: int, census: dict) -> tuple:
    """The bound of one K3-M or K3-M+S block (march_scenes.block_vs_twin's
    work, the twin's census of its marching rays and steps)."""
    n_bytes = state_bytes(spec, lanes, r["live"]) + PROLOGUE_BYTES_PER_LANE * lanes
    work = dict(bounce_work(spec, lanes, r["hits"]), emits=0) if spec.reflecting else {}
    return bound_ms(variant(spec), r["lane_events"], n_bytes, r["collisions"], 0, **work,
                    table=spec.table, march=census)


def march_kernel_vs_twin(dev, card: str) -> dict:
    """Phase 55: K3-M and K3-M+S against their plain version, bit for bit.
    The cases of tests/march_scenes.py march_cases (HG and table, Iwabuchi on
    and off, absorbing and conservative, over black, an albedo and RPV with
    upward detectors; LANES lanes, 4x the photons) and the two path scenes
    at their photons and lanes, each on its launch, mid-flight and tail
    states: every lane-state row, the lane weight, the control state and
    the dead counts bit for bit (over black the flux tallies too), the
    detector, surface-radiance (and, over a surface, flux) tallies within
    1e-9.  The path scenes' mid-flight and tail blocks are timed: the
    kernels' device time (profiler; over RPV the event kernel and the
    surface stage), the plain version's (CUDA events) and the bound, with
    the twin's census of the block's marching rays and steps."""
    from i3rc_tpu_torch import PhotonSource, batch_key
    from i3rc_tpu_torch.kernels.event_block import (MARCH_USE, fused_block,
                                                     fused_block_reference, march_census,
                                                     march_ray_use)

    ms = _load_tests_module("march_scenes")
    src = PhotonSource.directional(0.5, 0.0)
    err, timed, seen = {"march": 0.0, "march_surface": 0.0}, {}, set()
    n_states = 0

    def hold(tag, spec, pro, states, key, source):
        nonlocal n_states
        check(spec.det is not None and spec.det.march_steps > 0, f"55 {tag}: not a marching plan")
        for state, st, buf, kb in states:
            with march_census() as cen:
                r = ms.block_vs_twin(spec, pro, st, buf, key, source, kb)
            check(r["bit_equal"] and r["acc_rel_err"] <= 1e-9, f"55 {tag} {state}: {r}")
            kind = "march_surface" if spec.reflecting else "march"
            err[kind] = max(err[kind], r["max_abs_err"])
            seen.add(ms.instantiation(spec) + ("+S" if spec.reflecting else ""))
            n_states += 1
            yield state, st, buf, kb, r, cen

    for name in ms.march_cases():
        integ = ms.case_integrator(name, dev)
        key = batch_key(SEED, 950)
        spec, pro, states = ms.trace_states(integ, src, 4 * ms.LANES, ms.LANES, key)
        for _ in hold(name, spec, pro, states, key, src):
            pass
    n_cases = n_states
    for name in ("3d", "3d_rpv"):
        sc = march_path_scene(name, dev)
        key = batch_key(SEED, 960)
        spec, pro, states = ms.trace_states(sc.integ, sc.src, sc.n, sc.lanes, key)
        for state, st, buf, kb, r, cen in hold(name, spec, pro, states, key, sc.src):
            fields = dict(scene=name, state=state, lanes=sc.lanes, photons=sc.n, kb=kb,
                          live=r["live"], bit_equal=r["bit_equal"],
                          max_abs_err=f"{r['max_abs_err']:.3e}",
                          acc_rel_err=f"{r['acc_rel_err']:.3e}", march_steps=spec.det.march_steps,
                          rays=cen["rays"], ray_steps=cen["steps"],
                          warp_steps=cen["warp_steps"], most_steps=cen["most"],
                          unfinished=cen["unfinished"], instantiation=ms.instantiation(spec))
            if state != "launch":
                run_k = lambda s, b: fused_block(spec, pro, s, b, key, sc.src, kb)
                run_p = lambda s, b: fused_block_reference(spec, pro, s, b, key, sc.src, kb)
                use = march_ray_use(dev)
                use.zero_()
                r["device_ms"] = device_block_ms(run_k, st, buf.clone, 20)
                r["ray_use"] = dict(zip(MARCH_USE, use.tolist()))
                r["twin_ms"] = time_block_ms(run_p, st, buf.clone, 2)
                r["bound"] = march_block_bound(spec, r, sc.lanes, cen)
                r["census"] = dict(cen)
                if spec.reflecting:
                    r["stage"] = stage_vs_plain(spec, pro, st, buf, key, sc.src, kb, sc.lanes)
                    su = r["stage"]["ray_use"]
                    check(su["rays"] == r["stage"]["census"]["rays"]
                          and su["steps"] == r["stage"]["census"]["steps"]
                          and su["runs"] == r["stage"]["shape"]["runs"],
                          f"55 {name} {state}: S-M's ray loop {su} vs the plain version's "
                          f"{r['stage']['census']}, runs {r['stage']['shape']}")
                    say("55 march-surface-stage", scene=name, state=state, lanes=sc.lanes,
                        **stage_fields(r["stage"]), card=json.dumps(card))
                timed[(name, state)] = r
                fields.update(lane_events=r["lane_events"], collisions=r["collisions"],
                              hits=r["hits"], **ray_loop_fields(r["ray_use"], cen),
                              device_ms=f"{r['device_ms']:.4f}",
                              plain_ms=f"{r['twin_ms']:.4f}", bound_ms=f"{r['bound'][0]:.4f}",
                              bound_by=r["bound"][1])
            say("55 march-block-vs-plain", **fields, card=json.dumps(card))
    say("55 march-block-vs-plain", cases=len(ms.march_cases()), case_states=n_cases,
        path_states=n_states - n_cases, instantiations=len(seen),
        bit_equal=True, max_abs_err=",".join(f"{k}:{v:.3e}" for k, v in err.items()),
        card=json.dumps(card))
    return {"timed": timed, "err": err}


def stage_vs_plain(spec, pro, st, buf, key, source, kb: int, lanes: int) -> dict:
    """The marching surface stage S-M (fast_event_block_surface_kernel_march)
    of one block alone: its device ms a launch (the profiler's time of the
    stage's kernel in the whole block's launch), its plain version's
    (resolve_surface on the stage's input, CUDA events), the bound of its
    work (bounce_work of the block's bottom hits and the marching census of
    its rays), its launch shape (T tiles a run, runs, one wave's CTAs), its
    ray loop as the kernel counted it, and the census of the same input
    (surface_census at the kernel's T: the queue's rays, steps and modeled
    lane use)."""
    from i3rc_tpu_torch.kernels import event_block as eb

    seen = []
    real = eb.resolve_surface

    def grab(*args):
        seen.append((args[2].clone(), args[3].clone(), *args[4:]))
        return real(*args)

    eb.resolve_surface = grab
    try:
        eb.fused_block_reference(spec, pro, st.clone(), buf.clone(), key, source, kb)
    finally:
        eb.resolve_surface = real
    check(len(seen) == 1, "55: the plain block ran no surface stage")
    s_in, b_in, u, u_iw = seen[0]
    shape = eb.surface_march_runs(pro, spec, lanes, s_in.f.device)
    run = lambda s, b: eb.fused_block(spec, pro, s, b, key, source, kb)
    ms = profiled_ms(lambda: run(st.clone(), buf.clone()), 10,
                     "fast_event_block_surface_kernel_march")
    use = eb.march_ray_use(s_in.f.device)
    use.zero_()
    run(st.clone(), buf.clone())
    got = dict(zip(eb.MARCH_USE, use.tolist()))
    plain = time_block_ms(lambda s, b: eb.resolve_surface(spec, pro, s, b, u, u_iw), s_in,
                          b_in.clone, 3)
    with eb.march_census() as cen:
        eb.resolve_surface(spec, pro, s_in.clone(), b_in.clone(), u, u_iw)
    hits = int((s_in.i[eb.PK] == 2).sum())
    bound = bound_ms(variant(spec), 0, 0, **dict(bounce_work(spec, lanes, hits), emits=0),
                     table=spec.table, march=cen)
    census = eb.surface_census(spec, pro, s_in, b_in, u, u_iw, tiles=shape["tiles"])
    return {"ms": ms, "plain_ms": plain, "bound": bound, "hits": hits, "shape": shape,
            "ray_use": {k[len("surface_"):]: v for k, v in got.items()
                        if k.startswith("surface_")},
            "census": dict(cen), "queue": census["queue"]}


def stage_fields(r: dict) -> dict:
    """The say() fields of stage_vs_plain's record."""
    use, qu = r["ray_use"], r["queue"]
    return dict(stage_device_ms=f"{r['ms']:.4f}", stage_plain_ms=f"{r['plain_ms']:.4f}",
                stage_bound_ms=f"{r['bound'][0]:.4f}", stage_bound_by=r["bound"][1],
                hits=r["hits"], tiles=r["shape"]["tiles"], runs=r["shape"]["runs"],
                wave=r["shape"]["wave"], kernel_runs=use["runs"], kernel_rays=use["rays"],
                kernel_steps=use["steps"], kernel_slots=use["slots"],
                kernel_lane_use=f"{use['steps'] / max(use['slots'], 1):.3f}",
                census_rays=qu["rays"]["sum"], census_steps=qu["steps"],
                census_slots=qu["slots"], census_lane_use=f"{qu['lane_use'] or 0.0:.3f}",
                census_flushes=qu["flushes"], max_rays_a_run=qu["rays"]["max"])


def ray_loop_fields(use: dict, cen: dict) -> dict:
    """K3-M's ray loop as the kernel counted it (``event_block.march_ray_use``:
    the queue's rays, their segment steps, the warp trips' thread slots) and
    the lane use a loop of one lane a thread would have had on the same
    rays (the twin's census: every step of a warp's longest ray, detector
    after detector, at each event)."""
    return dict(queue_rays=use["rays"], queue_flushes=use["flushes"],
                ray_loop_lane_use=f"{use['steps'] / max(use['slots'], 1):.3f}",
                per_lane_loop_lane_use=f"{cen['steps'] / max(32 * cen['warp_steps'], 1):.3f}")


def march_batch_census(run_batch) -> dict:
    """The marching census (rays, steps) of one batch, counted by the plain
    version of every block of the same batch (same key: bit-equal to the
    kernels' run), the plain batch's host seconds, and apart the rays and
    steps of the surface stage's own marching (``surface``: those of the
    plain version's resolve_surface) with, over the batch, its census's
    queue (surface_census at the kernel's run length: emitting hits, the
    CTAs' runs and flushes, and the modeled thread slots of its ray loop)."""
    import i3rc_tpu_torch.integrators.fastpath as fp
    from i3rc_tpu_torch.kernels import event_block as eb

    orig, orig_surface = fp.fused_block, eb.resolve_surface
    surface = {"rays": 0, "steps": 0}
    queue = {"emitting_hits": 0, "runs": 0, "flushes": 0, "steps": 0, "slots": 0, "tiles": 0}

    def resolve(*args):
        spec, pro, st = args[:3]
        if spec.det is not None and spec.det.march_steps:
            T = eb.surface_march_runs(pro, spec, st.n_lanes, st.f.device)["tiles"]
            qu = eb.surface_census(*args, tiles=T)["queue"]
            queue["tiles"] = T
            queue["emitting_hits"] += qu["emitting_hits"]["sum"]
            for k in ("runs", "flushes", "steps", "slots"):
                queue[k] += qu[k]
        with eb.march_census() as c:
            orig_surface(*args)
        for k in surface:
            surface[k] += c[k]

    fp.fused_block, eb.resolve_surface = eb.fused_block_reference, resolve
    try:
        with eb.march_census() as cen:
            t0 = time.perf_counter()
            run_batch()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        fp.fused_block, eb.resolve_surface = orig, orig_surface
    return dict(cen, plain_seconds=seconds, surface=dict(surface, queue=queue))


def closed_vs_march(card: str) -> dict:
    """Phase 56: the step cloud's closed plan against the same plan with
    the marching trace of 24 steps (tests/test_fastpath.py:994-1030), one
    batch of MARCH_PHOTONS at MARCH_LANES lanes on the same key, the three
    detectors of tests/test_fastpath.py:1007-1008: the flux tallies bitwise
    equal (the shadow trace draws no random numbers), the radiance sum within
    rtol 2e-4 and each column within rtol 0.02, atol 1e-3 of the largest.
    The marching batch launches K3-M (the march counter), the closed one
    not.  y is not tracked here: the marching trace without fy."""
    from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource, make_step_cloud
    from i3rc_tpu_torch.integrators.fastpath import make_fast_tracer
    from i3rc_tpu_torch.kernels import event_block as eb

    ms = _load_tests_module("march_scenes")
    integ = Integrator.create(make_step_cloud(1.0), IntegratorConfig(**ms.CFG_KW),
                              device="cuda", **ms.CLOSED_VS_MARCH_DETECTORS)
    src = PhotonSource.directional(0.5, 0.0)
    key = batch_key_(970)
    raws, fields = {}, {}
    for tag, plan in zip(("closed", "march"), ms.closed_and_marching(integ)):
        tracer = make_fast_tracer(integ.geometry, plan, integ.config, MARCH_PHOTONS, MARCH_LANES)
        tracer(key, src.sample(key, MARCH_LANES, "cuda"), src)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        raws[tag] = tracer(key, src.sample(key, MARCH_LANES, "cuda"), src)
        torch.cuda.synchronize()
        fields[f"{tag}_seconds"] = f"{time.perf_counter() - t0:.4f}"
        fields[f"{tag}_launches"] = eb.event_block.detector_launches
        check(eb.event_block.march_launches == (eb.event_block.detector_launches
                                                if tag == "march" else 0)
              and eb.event_block.detector_launches > 0, f"56 {tag}: launches")
        check(int(raws[tag].n_bad) == 0, f"56 {tag}: n_bad {int(raws[tag].n_bad)}")
    cmp = ms.compare_closed_and_marching(raws["closed"], raws["march"])
    check(cmp["ok"], f"56 closed vs marching: {cmp}")
    say("56 march-vs-closed", photons=MARCH_PHOTONS, lanes=MARCH_LANES,
        shadow_steps=ms.CLOSED_VS_MARCH_STEPS, flux_bit_equal=cmp["flux_bit_equal"],
        radiance_sum_rel=f"{cmp['sum_rel']:.3e}", max_column_diff=f"{cmp['max_col_diff']:.3e}",
        **fields, card=json.dumps(card))
    return cmp


def march_paths(card: str) -> dict:
    """Phases 56-57.  57: the 3-D separable scene (march_path_scene "3d":
    both horizontal factors vary, so the planner takes the marching trace)
    at MARCH_PHOTONS a batch and MARCH_LANES lanes, MARCH_BATCHES batches
    with the launch counts set to 0 just before and read just after (K3-M
    alone), its radiance against the same scene on G's exact trace (G+E,
    IntegratorConfig(): ray tracing), MARCH_BATCHES batches, within 4
    combined standard errors; photons/s, one batch under the profiler (the
    device's idle share), one with each launch timed beside its bound (the
    twin's census of the same batch's marching steps; those two batches of
    half the path's photons); then K3-M+S's path, the scene over RPV
    ("3d_rpv", three batches and one timed)."""
    from i3rc_tpu_torch import Integrator, IntegratorConfig
    from i3rc_tpu_torch.kernels import event_block as eb
    from i3rc_tpu_torch.kernels import general_block as gb

    ms = _load_tests_module("march_scenes")
    rec = {"closed_vs_march": closed_vs_march(card), "launches": {}, "batch": {}}
    sc = march_path_scene("3d", "cuda")
    plan = sc.integ._fast_plan
    check(plan is not None and not plan.closed_shadow and 0 < plan.shadow_steps <= 24,
          f"57: the plan {plan and (plan.closed_shadow, plan.shadow_steps)}")
    fn = sc.integ.batch_fn(sc.src, sc.n, n_lanes=sc.lanes)
    fn(batch_key_(980))
    torch.cuda.synchronize()
    reset_counts()
    intens, fl, times, bads = radiance_batches(fn, sc.n, 981, MARCH_BATCHES, False,
                                               int(MARCH_BAD_SHARE * sc.n))
    launches = eb.event_block.march_launches
    check(launches > 0 and launches == eb.event_block.detector_launches
          and gb.general_block.launches == 0, f"57: K3-M launches {launches}")
    rec["launches"]["march"] = launches
    h = ms.host("i3rc_tpu_torch")
    g_integ = Integrator.create(ms.separable_3d(h), IntegratorConfig(), device="cuda",
                                **ms.DETECTORS)
    check(g_integ._fast_plan is None, "57: G's side has a fastpath plan")
    gfn = g_integ.batch_fn(sc.src, sc.n, n_lanes=sc.lanes)
    gfn(batch_key_(990))
    torch.cuda.synchronize()
    reset_counts()
    g_intens, g_fl, g_times, g_bad = radiance_batches(gfn, sc.n, 991, MARCH_BATCHES, False,
                                                      int(1e-3 * sc.n))
    check(gb.general_block.det_launches > 0, "57: G+E did not launch")
    m, s = intens.mean(0), intens.std(0, ddof=1) / MARCH_BATCHES ** 0.5
    gm, gs = g_intens.mean(0), g_intens.std(0, ddof=1) / MARCH_BATCHES ** 0.5
    z = np.abs(m - gm) / np.sqrt(s ** 2 + gs ** 2)
    check(bool(np.all(z <= 4.0)), f"57: K3-M {m} +- {s} vs G+E {gm} +- {gs}")
    rate = sc.n / sorted(times)[len(times) // 2]
    say("57 march-3d-radiance", photons=sc.n, lanes=sc.lanes, batches=MARCH_BATCHES,
        shadow_steps=plan.shadow_steps, intensity=",".join(f"{v:.5f}" for v in m),
        sigma=",".join(f"{v:.1e}" for v in s), g_intensity=",".join(f"{v:.5f}" for v in gm),
        g_sigma=",".join(f"{v:.1e}" for v in gs), z=",".join(f"{v:.2f}" for v in z),
        fup=f"{fl[:, 0].mean():.6f}", g_fup=f"{g_fl[:, 0].mean():.6f}",
        n_bad=",".join(map(str, bads)), g_n_bad=",".join(map(str, g_bad)),
        seconds=",".join(f"{t:.4f}" for t in times),
        g_seconds=",".join(f"{t:.4f}" for t in g_times), photons_per_s=f"{rate:.4e}",
        g_photons_per_s=f"{sc.n / sorted(g_times)[len(g_times) // 2]:.4e}",
        launches=launches, card=json.dumps(card))
    for name, counter in (("3d", "march"), ("3d_rpv", "march_surface")):
        if name == "3d_rpv":
            sc = march_path_scene(name, "cuda")
            fn = sc.integ.batch_fn(sc.src, sc.n, n_lanes=sc.lanes)
            fn(batch_key_(1010))
            torch.cuda.synchronize()
            reset_counts()
            bads = radiance_batches(fn, sc.n, 1011, 3, False, int(MARCH_BAD_SHARE * sc.n))[3]
            rec["launches"][counter] = eb.event_block.march_surface_launches
            check(rec["launches"][counter] > 0
                  and eb.event_block.detector_surface_launches == rec["launches"][counter],
                  f"57 {name}: K3-M+S launches {rec['launches'][counter]}")
            say("57 march-3d_rpv", photons=sc.n, batches=3, n_bad=",".join(map(str, bads)),
                launches=rec["launches"][counter], card=json.dumps(card))
        # The timed batch is half the path's: its plain census (every block
        # of the batch by the plain version) took 64 s for 2^22 photons on
        # the card's host (PR 21), the script's longest phase.
        key, n_timed = batch_key_(1020), sc.n // 2
        tracer = sc.integ.batch_tracer(n_timed, sc.lanes)
        run = lambda: tracer(key, sc.src.sample(key, sc.lanes, "cuda"), sc.src)
        run()
        pb = profile_batch(run)
        cen = march_batch_census(run)
        use = eb.march_ray_use("cuda")
        use.zero_()
        bk = batch_kernel_time(run, march=cen)
        bk.update(idle=pb["idle_share"], census=cen,
                  ray_use=dict(zip(eb.MARCH_USE, use.tolist())))
        if name == "3d_rpv":
            # K3-M+S split: the marching surface stage's own launches, device
            # ms of the profiled batch and bound (its bounce, bounce_work of
            # the batch's bottom hits, and its own marching rays and steps).
            spec = bk["spec"]
            work = dict(bounce_work(spec, sc.lanes * pb["surface_launches"], bk["hits"]),
                        emits=0)
            bk["stage"] = dict(ms=pb["surface_ms"], launches=pb["surface_launches"],
                               block_ms=pb["block_ms"], census=cen["surface"],
                               bound=bound_ms(variant(spec), 0, 0, **work, table=spec.table,
                                              march=cen["surface"]))
            use, qu = bk["ray_use"], cen["surface"]["queue"]
            check(use["surface_rays"] == cen["surface"]["rays"]
                  and use["surface_steps"] == cen["surface"]["steps"],
                  f"57 {name}: S-M's ray loop {use} vs the plain version's {cen['surface']}")
            say("57 march-3d_rpv-stage", photons=n_timed, stage_launches=pb["surface_launches"],
                stage_ms=f"{pb['surface_ms']:.3f}", block_ms=f"{pb['block_ms']:.3f}",
                stage_bound_ms=f"{bk['stage']['bound'][0]:.3f}",
                stage_bound_by=bk["stage"]["bound"][1], hits=bk["hits"],
                stage_rays=cen["surface"]["rays"], stage_steps=cen["surface"]["steps"],
                kernel_rays=use["surface_rays"], kernel_steps=use["surface_steps"],
                kernel_slots=use["surface_slots"], kernel_runs=use["surface_runs"],
                kernel_lane_use=f"{use['surface_steps'] / max(use['surface_slots'], 1):.3f}",
                census_tiles=qu["tiles"], census_emitting_hits=qu["emitting_hits"],
                census_runs=qu["runs"], census_flushes=qu["flushes"],
                census_slots=qu["slots"],
                census_lane_use=f"{qu['steps'] / max(qu['slots'], 1):.3f}",
                card=json.dumps(card))
        rec["batch"][counter] = bk
        say(f"57 march-{name}-profile", photons=n_timed,
            **profile_fields(pb, sc.integ._fast_plan.unroll, card))
        say(f"57 march-{name}-batch-kernel", photons=n_timed, rays=cen["rays"],
            ray_steps=cen["steps"], warp_steps=cen["warp_steps"], unfinished=cen["unfinished"],
            **ray_loop_fields(bk["ray_use"], cen),
            plain_batch_seconds=f"{cen['plain_seconds']:.3f}", **batch_fields(bk, card))
    return rec


def plane_parallel_runs(out: Path, card: str) -> dict:
    """Phase 58: the plane-parallel verification driver
    (i3rc_tpu_torch/drivers/plane_parallel.py).  The shipped
    examples/planeParallel.nml unmodified through ``python -m`` (G: ray
    tracing), held as tests/test_drivers.py:14-25 holds it (closure within
    2e-3, 0.12 < Fup < 0.21); a copy at PP_PHOTONS x PP_BATCHES photons with
    ray tracing (G) and without (K1), each's Fup within 4 standard errors of
    the batch mean of the discrete-ordinates slab's ANCHOR_SLAB_FUP; a
    radiance copy (two detectors) with ray tracing (G+E) and without (K3,
    the closed trace), the two within 5 combined standard errors.  Each run
    with the launch counts set to 0 just before it and read just after;
    each run's wall seconds."""
    from i3rc_tpu_torch.drivers.plane_parallel import run_from_namelist as run_pp
    from i3rc_tpu_torch.kernels import event_block as eb
    from i3rc_tpu_torch.kernels import general_block as gb

    pp = out / "plane_parallel"
    pp.mkdir(parents=True, exist_ok=True)
    shipped = ROOT / "examples" / "planeParallel.nml"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "i3rc_tpu_torch.drivers.plane_parallel",
                           str(shipped)], cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    t_cli = time.perf_counter() - t0
    check(proc.returncode == 0, f"58 the shipped namelist: {proc.stderr[-2000:]}")
    row = proc.stdout.strip().splitlines()[-1].split()
    fup, fdn = float(row[4]), float(row[5])
    check(abs(fup + fdn - 1.0) < 2e-3 and 0.12 < fup < 0.21, f"58 shipped: {row}")
    say("58 plane-parallel-shipped", namelist=shipped.name, fup=f"{fup:.5f}", fdn=f"{fdn:.5f}",
        fup_err=row[6], seconds=f"{t_cli:.2f}", card=json.dumps(card))
    text = shipped.read_text()
    big = (text.replace("numPhotonsPerBatch = 10000,", f"numPhotonsPerBatch = {PP_PHOTONS},")
               .replace("numBatches = 4,", f"numBatches = {PP_BATCHES},"))
    no_rt = lambda t: t.replace("useRayTracing = T,", "useRayTracing = F,")
    check(big != text and no_rt(big) != big, "58: the namelist copies")
    rec = {}
    for tag, body in (("ray-tracing", big), ("max-cross-section", no_rt(big))):
        path = pp / f"{tag}.nml"
        path.write_text(body)
        reset_counts()
        t0 = time.perf_counter()
        res = run_pp(str(path), quiet=True, device="cuda")
        seconds = time.perf_counter() - t0
        g_launches, k1 = gb.general_block.launches, eb.event_block.launches
        check((g_launches > 0 and k1 == 0) if tag == "ray-tracing" else (k1 > 0 and g_launches == 0),
              f"58 {tag}: G {g_launches}, K1 {k1}")
        sigma = res["flux_up_err"] / PP_BATCHES ** 0.5
        check(abs(res["flux_up"] - ANCHOR_SLAB_FUP) <= 4 * sigma,
              f"58 {tag}: Fup {res['flux_up']} +- {sigma}, oracle {ANCHOR_SLAB_FUP}")
        check(abs(res["flux_up"] + res["flux_down"] - 1.0) < 2e-3, f"58 {tag}: closure {res}")
        rec[tag] = dict(res, seconds=seconds)
        say("58 plane-parallel-oracle", run=tag, photons=PP_PHOTONS, batches=PP_BATCHES,
            fup=f"{res['flux_up']:.6f}", sigma=f"{sigma:.2e}", oracle=ANCHOR_SLAB_FUP,
            z=f"{(res['flux_up'] - ANCHOR_SLAB_FUP) / sigma:.2f}", fdn=f"{res['flux_down']:.6f}",
            kernel="G" if tag == "ray-tracing" else "K1", launches=g_launches or k1,
            seconds=f"{seconds:.2f}", card=json.dumps(card))
    rad = (text.replace("numPhotonsPerBatch = 10000,", f"numPhotonsPerBatch = {PP_RAD_PHOTONS},")
               .replace("  surfaceAlbedo = 0.0,",
                        "  surfaceAlbedo = 0.0,\n  intensityMus = 1., 0.5,\n"
                        "  intensityPhis = 0., 0.,"))
    check("intensityMus" in rad and f"numBatches = {PP_RAD_BATCHES}," in rad, "58: radiance copy")
    rads = {}
    for tag, body in (("radiance-ray-tracing", rad), ("radiance-max-cross-section", no_rt(rad))):
        path = pp / f"{tag}.nml"
        path.write_text(body)
        reset_counts()
        t0 = time.perf_counter()
        res = run_pp(str(path), quiet=True, device="cuda")
        seconds = time.perf_counter() - t0
        launches = (gb.general_block.det_launches if tag == "radiance-ray-tracing"
                    else eb.event_block.detector_launches)
        check(launches > 0 and bool(np.all(np.isfinite(res["radiance"])))
              and bool(np.all(res["radiance"] > 0.0)), f"58 {tag}: {res}, launches {launches}")
        rads[tag] = res
        say("58 plane-parallel-radiance", run=tag, photons=PP_RAD_PHOTONS, batches=PP_RAD_BATCHES,
            radiance=",".join(f"{v:.6f}" for v in res["radiance"]),
            error=",".join(f"{v:.2e}" for v in res["radiance_err"]),
            kernel="G+E" if tag == "radiance-ray-tracing" else "K3", launches=launches,
            seconds=f"{seconds:.2f}", card=json.dumps(card))
    a, b = rads["radiance-ray-tracing"], rads["radiance-max-cross-section"]
    # The driver's error is the batches' RMS about their mean: / sqrt(n - 1)
    # for the standard error of the mean.
    sig = np.sqrt(a["radiance_err"] ** 2 + b["radiance_err"] ** 2) / (PP_RAD_BATCHES - 1) ** 0.5
    check(bool(np.all(np.abs(a["radiance"] - b["radiance"]) <= 5 * sig)),
          f"58 radiance G+E {a} vs K3 {b}")
    rec["radiance"] = rads
    return rec


def march_entry(kind: str, checks: dict, rec: dict) -> dict:
    """The kernels-line entry of K3-M ("march": the detector block with the
    marching trace, on phase 57's path) or K3-M+S ("march_surface": that
    block and the surface stage over RPV): launches on its path, its largest
    state difference to the plain version (phase 55), the device time, plain
    time and bound of its path scene's mid-flight and tail blocks, and one
    batch of its path beside the batch's bound; K3-M+S's also split, the
    marching surface stage's own launches, device ms and bound a batch
    beside the block kernel's ms."""
    scene = "3d" if kind == "march" else "3d_rpv"
    r, tail = checks["timed"][(scene, "mid")], checks["timed"][(scene, "tail")]
    bk = rec["batch"][kind]
    surface = kind == "march_surface"
    stage = {}
    if surface:
        st = bk["stage"]
        stage = {"batch_stage_launches": st["launches"], "batch_stage_ms": st["ms"],
                 "batch_stage_bound_ms": st["bound"][0], "batch_block_ms": st["block_ms"]}
    return {"name": "fast_event_block_detectors_march" + ("_surface" if surface else ""),
            "route": "cuda", "source": "i3rc_tpu_torch/csrc/fast_event_block.cuh",
            "replaces": "i3rc_tpu/integrators/fastpath.py:1061 (shadow_trace, XLA inside the "
                        "path of :665" + (", with the surface glue of :1874-1981)" if surface
                                          else ")"),
            "launches": rec["launches"][kind], "max_abs_err": checks["err"][kind],
            "ms": r["device_ms"], "plain_ms": r["twin_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None, "tail_ms": tail["device_ms"],
            "tail_bound_ms": tail["bound"][0], "batch_ms": bk["kernel_ms"],
            "batch_launches": bk["launches"], "batch_bound_ms": bk["bound"][0],
            "batch_march_steps": bk["census"]["steps"], "batch_rays": bk["census"]["rays"],
            "batch_idle_share": bk["idle"],
            "batch_ray_loop_lane_use": bk["ray_use"]["steps"] / max(bk["ray_use"]["slots"], 1),
            **stage}


def march_stage_entry(checks: dict, rec: dict) -> dict:
    """The kernels-line entry of S-M, the marching surface stage
    (fast_event_block_surface_kernel_march, launched after each K3-M block
    over a surface): its launches on K3-M+S's path (phase 57), its largest
    state difference (phase 55's, the whole surfaced block's), its device
    ms a launch on the path scene's mid-flight and tail blocks (phase 55),
    its plain version's (resolve_surface), its bound, its ray loop's lane
    use, and per batch its ms beside its bound (phase 57)."""
    mid = checks["timed"][("3d_rpv", "mid")]["stage"]
    tail = checks["timed"][("3d_rpv", "tail")]["stage"]
    st = rec["batch"]["march_surface"]["stage"]
    use = mid["ray_use"]
    return {"name": "fast_event_block_surface_stage_march", "route": "cuda",
            "source": "i3rc_tpu_torch/csrc/fast_event_block.cu",
            "replaces": "i3rc_tpu/integrators/fastpath.py:1874-1981 (the surface glue in the "
                        "path of :665, its shadow ray the marching shadow_trace of :1061)",
            "launches": rec["launches"]["march_surface"],
            "max_abs_err": checks["err"]["march_surface"], "ms": mid["ms"],
            "plain_ms": mid["plain_ms"], "bound_ms": mid["bound"][0],
            "bound_by": mid["bound"][1], "library_ms": None, "tail_ms": tail["ms"],
            "tail_bound_ms": tail["bound"][0], "tiles_a_run": mid["shape"]["tiles"],
            "runs": mid["shape"]["runs"],
            "ray_loop_lane_use": use["steps"] / max(use["slots"], 1),
            "batch_ms": st["ms"], "batch_launches": st["launches"],
            "batch_bound_ms": st["bound"][0]}


# ---------------------------------------------------------------------------
# Multi-device runs (ROADMAP item 19): run_batches over torch.distributed
# ranks, exact resume, and the x-sharded domain tracer with its kernels, SD
# (csrc/sharded_event_block.cu sharded_event_block_kernel: the whole block,
# K events a lane and the glue around them) and SB (shadow_block_kernel: K
# cell-DDA steps of each shadow ray in flight, then the rays' pack).  The
# card is one H100: two gloo ranks share cuda:0 (gloo's buffers staged
# through pinned host memory), and a world of one NCCL rank checks NCCL.

SHARD_PHOTONS = 1 << 22             # Landsat and the graft scene over two ranks
SHARD_LANES = 1 << 20               # lanes (and shadow-ray slots) a rank
MESH_PHOTONS = 1 << 20              # run_batches on the step cloud (K1)
MESH_BATCHES = 8
GE_PHOTONS = 1 << 19                # G+E on the graft scene: 16 batches
# Phase 59's world-of-one scenes (tests/sharded_scenes.py) by what they
# cover: photons and lanes of the trace whose mid-flight and tail states it
# checks.  The flux scene (Landsat) and the graft scene (two components, an
# albedo, 2 detectors, the volume tally) are checked on the main path's
# two ranks at its shapes, in chip_world_job.
SHARD_CASES = {"surface": ("reflecting", 1 << 18, 1 << 16), "volume": ("volume", 1 << 18, 1 << 16),
               "detectors_3": ("detectors", 1 << 18, 1 << 16)}
# Operations per SD lane-event: two Philox4x32-10 calls (~200 integer
# operations), the flight (four face distances, comparisons, moves, wraps,
# the cell index: ~100), with 4 IEEE divisions and a share of logf (SFU
# steps); per SR ray step: three face distances (3 divisions), the cell
# index, the optical depth, the moves and the wrap (~60).
OPS_PER_SD_EVENT = (300, 5)
OPS_PER_SR_STEP = (60, 3)
SD_STATE_ROWS = 16                  # 7 float and 9 int rows a lane (+ D prefactors)
SR_STATE_ROWS = 9                   # 5 float and 4 int rows a ray


def _sharded_scenes():
    """tests/sharded_scenes.py, importable by name (spawned ranks import it)."""
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import sharded_scenes

    return sharded_scenes


def ptxas_sharded(log: str) -> dict:
    """SD's and SB's registers, own stack and spill bytes, CTAs per SM."""
    out, name, own = {}, None, False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function "
                      r"'\w*(sharded_event_block|shadow_block)_kernel", line)
        if m:
            name = {"sharded_event_block": "SD", "shadow_block": "SB"}[m[1]]
            out[name], own = {}, False
        elif "Compiling entry function" in line:
            name = None
        elif name and "Function properties for" in line:
            own = "_kernel" in line
        elif name and own and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                                              r"stores", line)):
            out[name].update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name].update(registers=int(m[1]), ctas_per_sm=ctas_per_sm(int(m[1])))
    return out


def sd_bound(lane_events: int, launches: int, lanes: int, n_dirs: int, table_bytes: int):
    """(least ms, what bounds it) of SD's work, the whole block: the
    lane-events' operations; every lane's four flags (alive, tag, pending,
    exit) read each launch, each live lane's state read and written once a
    launch (a live lane runs at most K events a launch, so lane_events / K
    lane-launches at least), the tables once."""
    K = 8
    n_bytes = launches * lanes * 16 + (lane_events // K) * (SD_STATE_ROWS + n_dirs) * 8 \
        + table_bytes
    alu, sfu = (lane_events * o for o in OPS_PER_SD_EVENT)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(alu / FP32_OPS_PER_S, sfu / SFU_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sb_bound(steps: int, launches: int, slots: int, escapes: int, rows: int, free: int):
    """(least ms, what bounds it) of SB's work (SR's and SP's of the same
    launches, the flags read once): the steps' operations; every slot's two
    flags read each launch, each moving ray's state read and written once a
    launch (steps / K ray-launches at least), two float64 adds an escape,
    each packed row (six floats and its slot) and each free slot's index
    written."""
    K = 8
    n_bytes = (launches * slots * 8 + (steps // K) * SR_STATE_ROWS * 8 + escapes * 16
               + rows * 28 + free * 4)
    alu, sfu = (steps * o for o in OPS_PER_SR_STEP)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(alu / FP32_OPS_PER_S, sfu / SFU_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sharded_kernel_vs_twin(dev, card: str) -> dict:
    """59. The whole block (SD's launch, then SB's) against its plain
    version, and SB alone against its plain version (SR's steps, then SP's
    pack), bit for bit (the radiance tallies within 1e-9 of their sum), at
    a mid-flight and a tail state of a trace of the surface, volume and
    three-detector scenes on a world of one on the card (its slab the whole
    domain)."""
    ss = _sharded_scenes()

    h = ss.host("i3rc_tpu_torch")
    out = {"err": 0.0, "tally_err": 0.0}
    for case, (name, photons, lanes) in SHARD_CASES.items():
        st = ss.trace_states(ss.scene(name, h, 2), photons, lanes, dev)
        check(len(st["block"]) == 2 and (not st["spec"].n_dirs or len(st["sb"]) == 2),
              f"59 {case}: states block {[k[0] for k in st['block']]} sb {len(st['sb'])}")
        for r in ss.states_vs_twins(st):
            _twin_record(out, r, f"59 {case}")
            say(f"59 sharded-{r['kernel']}-vs-twin", scene=name, case=case, ranks=1,
                lanes=lanes, **_twin_fields(r), card=json.dumps(card))
    return out


def _twin_record(out: dict, r: dict, what: str) -> None:
    """Check one kernel-vs-twin record and keep its largest difference."""
    if r["kernel"] == "SD":
        check(r["bit_equal"] and r["tally_ok"], f"{what} block {r['state']}: {r}")
        out["err"] = max(out["err"], r["max_abs_err"])
        out["tally_err"] = max(out["tally_err"], r["tally_abs_err"])
    else:
        check(r["bit_equal"] and r["tally_abs_err"] <= 1e-9 * max(1.0, r["tally_sum"])
              and (r["use"]["rays"], r["use"]["steps"]) == (r["rays"], r["steps"]),
              f"{what} SB {r['state']}: {r}")
        out["tally_err"] = max(out["tally_err"], r["tally_abs_err"])


def _twin_fields(r: dict) -> dict:
    if r["kernel"] == "SD":
        return dict(state=r["state"], kb=r["kb"], live=r["live"], lane_events=r["lane_events"],
                    collisions=r["collisions"], tagged=r["tagged"], sent=r["sent"],
                    received=r["received"], refilled=r["refilled"],
                    rays_tagged=r["rays_tagged"], bit_equal=r["bit_equal"],
                    parts_differing=",".join(r["parts_differing"]) or "none",
                    tally_abs_err=f"{r['tally_abs_err']:.2e}")
    return dict(state=r["state"], kb=r["kb"], rays=r["rays"], steps=r["steps"],
                escapes=r["escapes"], tagged=r["tagged"], bit_equal=r["bit_equal"],
                tally_abs_err=f"{r['tally_abs_err']:.2e}", bins=r["n_bins"],
                runs=r["use"]["runs"], kernel_rays=r["use"]["rays"],
                kernel_steps=r["use"]["steps"],
                ray_loop_lane_use=f"{r['use']['steps'] / max(r['use']['slots'], 1):.3f}")


def _step_cloud_batches(mesh=None, offset: int = 0, n_batches: int = MESH_BATCHES, chunk=None,
                        sums: bool = False):
    """run_batches of the step cloud (K1) with domain means, on the mesh."""
    from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource, make_step_cloud
    from i3rc_tpu_torch.parallel.mesh import run_batches

    integ = Integrator.create(make_step_cloud(1.0), IntegratorConfig(use_ray_tracing=False,
                                                                     max_events=500),
                              device=mesh.device if mesh else "cuda")
    derive = lambda res: {"fup": res.mean_flux_up, "fdn": res.mean_flux_down}
    return run_batches(integ, PhotonSource.directional(0.5, 0.0), MESH_PHOTONS, n_batches,
                       seed=SEED, derive=derive, mesh=mesh, batch_offset=offset,
                       chunk_batches=chunk, _return_sums=sums)


def _sharded_run(ss, name: str, mesh, profile: bool) -> dict:
    """One trace of a scene (its two-rank form) over the mesh.  Unprofiled:
    the trace (trace_sharded's steps: the set-up of its ShardedTrace, the
    block loop, the finish), its summary, wall seconds, the block loop's
    wall seconds and blocks.  Profiled:
    the same trace through its ShardedTrace, this rank's SD and SB device
    ms and every device kernel's (the device's busy time), the counts of
    the bound (lane-events, ray steps, escapes, packed rows and free slots,
    blocks), SB's ray loop as the kernel counted it over the trace, and the
    block's and SB's inputs at a mid-flight and a tail block ("_states":
    trace_states' dict without the tallies)."""
    from i3rc_tpu_torch import PhotonSource
    from i3rc_tpu_torch.kernels import sharded_block as sb
    from i3rc_tpu_torch.parallel.sharded_domain import ShardedTrace

    sc = ss.scene(name, ss.host("i3rc_tpu_torch"), 2)
    kw = sc["kw"]
    src = PhotonSource.directional(*sc["src"])
    torch.cuda.synchronize()
    if not profile:
        t0 = time.perf_counter()
        tr = ShardedTrace.create(sc["domain"], src, SHARD_PHOTONS, mesh,
                                 n_lanes_per_shard=SHARD_LANES, seed=SEED, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        while tr.running():
            tr.block()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        raw = tr.finish()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        spec = tr.spec
        return dict(ss.summary(raw), seconds=seconds, loop_seconds=t2 - t1,
                    blocks_unprofiled=tr.kb, host_ms_per_block=1e3 * (t2 - t1) / max(tr.kb, 1),
                    cell_bytes=spec.cells.numel() * spec.cells.element_size(),
                    rows=int(spec.cells.shape[0]), n_dirs=spec.n_dirs)
    tr = ShardedTrace.create(sc["domain"], src, SHARD_PHOTONS, mesh,
                             n_lanes_per_shard=SHARD_LANES, seed=SEED, **kw)
    spec = tr.spec
    # Per SB launch, on the device: escapes, packed rows, free slots.
    work = []
    shadow = tr.shadow_block

    def counted(spec_, pool, bufs, acc_int, acc_byc):
        before = (pool.i[sb.QALIVE] != 0).sum()
        shadow(spec_, pool, bufs, acc_int, acc_byc)
        row = bufs.counts[bufs.rank]
        work.append(torch.stack([before - (pool.i[sb.QALIVE] != 0).sum(),
                                 row[sb.WAIT_Q:sb.WAIT_Q + 2].clamp(max=bufs.cap).sum(),
                                 row[sb.FREE_Q]]))

    tr.shadow_block = counted
    keep = ss.capture_states(tr)
    use0 = sb.shadow_ray_use(mesh.device).clone()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        while tr.running():
            tr.block()
        torch.cuda.synchronize()
    use = dict(zip(sb.SHADOW_USE, (sb.shadow_ray_use(mesh.device) - use0).tolist()))
    tr.finish()
    found = prof.key_averages()
    ms = lambda k: sum(e.self_device_time_total for e in found if k in e.key) / 1e3
    cnt = lambda k: sum(e.count for e in found if k in e.key)
    tables = sum(t.numel() * 4 for t in (spec.cells, spec.cubic, spec.fwd, spec.det))
    escapes, rows, free = (torch.stack(work).sum(0).tolist() if work else [0, 0, 0])
    return {"sd_ms": ms("sharded_event_block_kernel"), "sb_ms": ms("shadow_block_kernel"),
            "device_ms_total": sum(e.self_device_time_total for e in found) / 1e3,
            "sd_seen": cnt("sharded_event_block_kernel"),
            "sb_seen": cnt("shadow_block_kernel"),
            "lane_events": int(tr.state.i[sb.EVCT].sum()), "blocks": tr.kb,
            "steps": int(tr.pool.i[sb.QSTEPS].sum()) if spec.n_dirs else 0,
            "escapes": escapes, "rows": rows, "free": free, "sb_use": use,
            "table_bytes": tables,
            "_states": dict(spec=spec, key=tr.key, source=tr.refill, albedo=tr.albedo,
                            block=keep["block"], sb=keep["sb"])}


class _BlockInput:
    """A kept block input's state (None for SB's), pool and buffers, as
    device_block_ms and time_block_ms take a state: ``clone`` gives fresh
    copies."""

    def __init__(self, st, pool, bufs):
        self.st, self.pool, self.bufs = st, pool, bufs

    def clone(self) -> "_BlockInput":
        return _BlockInput(self.st and self.st.clone(), self.pool.clone(), self.bufs.clone())


def _time_mid_launches(mesh, states: dict, checks: list) -> dict:
    """Rank 0 times the block's launches on the main path (profiler; 2^20
    lanes, its half slab) while the other ranks wait at a barrier, so that
    the card runs these launches alone: SD's whole block at the Landsat
    trace's mid-flight and tail blocks, SB's launch at the graft trace's;
    beside each its plain version's time (CUDA events; SB's: SR's and then SP's) and
    its bound from the launch's counts (SB's: sb_bound, and apart the
    bounds of its steps and of its pack), and SB's ray loop as the kernel
    counted it in phase 59's launch of the same input.  The other ranks
    return {}."""
    import torch.distributed as dist

    from i3rc_tpu_torch.kernels import sharded_block as sb

    timed = {}
    if mesh.rank == 0:
        got = {(c["scene"], c["kernel"], c["state"]): c for c in checks}
        st = states["landsat"]
        spec, key, source, albedo = st["spec"], st["key"], st["source"], st["albedo"]
        tables = sum(t.numel() * 4 for t in (spec.cells, spec.cubic, spec.fwd, spec.det))
        for tag, (kb, plan, s0, pool0, bufs0) in zip(("mid", "tail"), st["block"]):
            run = lambda s, _, kb=kb, plan=plan: sb.sharded_event_block(
                spec, s.st, s.pool, s.bufs, plan, key, kb, source, albedo)
            plain = lambda s, _, kb=kb, plan=plan: sb.sharded_block_reference(
                spec, s.st, s.pool, s.bufs, plan, key, kb, source, albedo)
            x0 = _BlockInput(s0, pool0, bufs0)
            r = got[("landsat", "SD", tag)]
            timed[f"SD_{tag}"] = dict(
                ms=device_block_ms(run, x0, lambda: None, 5, kernel="sharded_event_block"),
                plain_ms=time_block_ms(plain, x0, lambda: None, 2),
                bound=sd_bound(r["lane_events"], 1, SHARD_LANES, spec.n_dirs, tables), kb=kb)
        spec = states["graft"]["spec"]
        n = spec.nx_loc * spec.n_y * spec.n_dirs
        acc = lambda: tuple(torch.zeros(k, dtype=torch.float64, device=mesh.device)
                            for k in (n, n * (spec.n_comp + 1)))
        ss = _sharded_scenes()
        run = lambda x, a: sb.shadow_block(spec, x.pool, x.bufs, *a)
        for tag, (kb, pool, bufs) in zip(("mid", "tail"), states["graft"]["sb"]):
            r = got[("graft", "SB", tag)]
            x0 = _BlockInput(None, pool, bufs)
            timed[f"SB_{tag}"] = dict(
                ms=device_block_ms(run, x0, acc, 5, kernel="shadow_block"),
                plain_ms=time_block_ms(lambda x, a: ss.shadow_block(spec, x.pool, x.bufs, *a,
                                                                    plain=True), x0, acc, 3),
                bound=sb_bound(r["steps"], 1, pool.n_rays, r["escapes"], r["rows"], r["free"]),
                sr_bound=sb_bound(r["steps"], 1, pool.n_rays, r["escapes"], 0, 0),
                sp_bound=sb_bound(0, 1, pool.n_rays, 0, r["rows"], r["free"]),
                use=r["use"], kb=kb)
    dist.barrier(group=mesh.group)
    return timed


def chip_world_job(mesh) -> dict:
    """A rank's job in phases 59 and 60-63 (two gloo ranks on cuda:0):
    run_batches on the mesh; the full-width Landsat scene and the graft
    scene through trace_sharded with SD's and SB's launches counted (the
    main path); each once more under the profiler, keeping the block's and
    SB's inputs at a mid-flight and a tail block; those blocks against
    their plain version on this rank's half slab (59, at the main path's
    shapes), and rank 0's launches timed alone."""
    ss = _sharded_scenes()
    from i3rc_tpu_torch.kernels import sharded_block as sb
    from i3rc_tpu_torch.parallel.mesh import tree_leaves

    s1, s2, n = _step_cloud_batches(mesh, sums=True)
    out = {"rank": mesh.rank, "backend": mesh.backend, "device": str(mesh.device),
           "batches": {"s1": [a.numpy() for a in tree_leaves(s1)],
                       "s2": [a.numpy() for a in tree_leaves(s2)], "n": n}}
    sb.reset_launch_counters()
    for name in ("landsat", "graft"):
        out[name] = _sharded_run(ss, name, mesh, profile=False)
    out["launches"] = {"SD": sb.sharded_event_block.launches, "SB": sb.shadow_block.launches}
    states, out["checks"] = {}, []
    for name in ("landsat", "graft"):
        out[name].update(_sharded_run(ss, name, mesh, profile=True))
        st = states[name] = out[name].pop("_states")
        out[name]["nx_loc"] = st["spec"].nx_loc
        out["checks"] += [dict(r, scene=name) for r in ss.states_vs_twins(st)]
    out["timed"] = _time_mid_launches(mesh, states, out["checks"])
    return out


def mesh_paths(out: Path, card: str) -> dict:
    """59 (the main path's shapes) and 60-63: the two gloo ranks sharing
    the card run alone first (this process waits); then run_batches on a
    world of one NCCL rank, the one-rank traces of both scenes, a resume
    in a second process and the unsharded references, each alone on the
    card."""
    import torch.distributed as dist

    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, make_landsat_cloud,
                                make_step_cloud)
    from i3rc_tpu_torch.parallel import checkpoint as ckpt
    from i3rc_tpu_torch.parallel.mesh import default_mesh, run_batches, tree_leaves

    ss = _sharded_scenes()
    torch.cuda.synchronize()
    ranks = ss.join_world(ss.start_world(2, chip_world_job, (), device="cuda:0"), timeout=900)

    # 59 (cont.). The whole block and SB against their plain versions on each
    # rank's half slab of the main path's traces (2^20 lanes a rank,
    # interior x faces)
    twin = {"err": 0.0, "tally_err": 0.0}
    for r in ranks:
        check(r["landsat"]["nx_loc"] == 64 and r["graft"]["nx_loc"] == 2,
              f"59 rank {r['rank']} slabs {r['landsat']['nx_loc']}, {r['graft']['nx_loc']}")
        got = sorted((c["scene"], c["kernel"], c["state"]) for c in r["checks"])
        check(got == sorted((sc, k, t) for sc, k in (("landsat", "SD"), ("graft", "SD"),
                                                       ("graft", "SB"))
                            for t in ("mid", "tail")), f"59 rank {r['rank']} states {got}")
        for c in r["checks"]:
            _twin_record(twin, c, f"59 rank {r['rank']} {c['scene']}")
            check(c["state"] != "mid" or c["tagged"] > 0,
                  f"59 rank {r['rank']} {c['scene']} {c['kernel']} mid: no migrant tagged")
            fields = {}
            t = ranks[0]["timed"].get(f"{c['kernel']}_{c['state']}")
            if r["rank"] == 0 and t and t["kb"] == c["kb"] and (
                    c["scene"] == ("landsat" if c["kernel"] == "SD" else "graft")):
                fields = dict(device_ms=f"{t['ms']:.4f}", plain_ms=f"{t['plain_ms']:.3f}",
                              bound_ms=f"{t['bound'][0]:.4f}", bound_by=t["bound"][1])
            say(f"59 sharded-{c['kernel']}-vs-twin", scene=c["scene"], ranks=2, rank=r["rank"],
                nx_loc=r[c["scene"]]["nx_loc"], lanes=SHARD_LANES, **_twin_fields(c), **fields,
                card=json.dumps(card))
    check(set(ranks[0]["timed"]) == {"SD_mid", "SD_tail", "SB_mid", "SB_tail"},
          f"59 timed {sorted(ranks[0]['timed'])}")
    for tag in ("mid", "tail"):
        t = ranks[0]["timed"][f"SB_{tag}"]
        say("59 sharded-SB-launch", scene="graft", ranks=2, rank=0, state=tag, kb=t["kb"],
            lanes=SHARD_LANES, device_ms=f"{t['ms']:.4f}", runs=t["use"]["runs"],
            sr_bound_ms=f"{t['sr_bound'][0]:.4f}", sp_bound_ms=f"{t['sp_bound'][0]:.4f}",
            ray_loop_lane_use=f"{t['use']['steps'] / max(t['use']['slots'], 1):.3f}",
            card=json.dumps(card))

    # 60. a world of one NCCL rank against no mesh: the same bits; the
    # one-rank traces of 62 and 63 (no exchange, no other process)
    plain = _step_cloud_batches(sums=True)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = default_mesh(device=torch.device("cuda", 0))
        check(mesh.backend == "nccl" and mesh.size == 1, f"NCCL mesh {mesh}")
        nccl = _step_cloud_batches(mesh, sums=True)
        one = {}
        for name in ("landsat", "graft"):
            one[name] = _sharded_run(ss, name, mesh, profile=False)
            one[name].update(_sharded_run(ss, name, mesh, profile=True))
            one[name].pop("_states")
    finally:
        dist.destroy_process_group()
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(plain[0]) + tree_leaves(plain[1]),
                                                   tree_leaves(nccl[0]) + tree_leaves(nccl[1])))
    check(same and plain[2] == nccl[2], "60 NCCL world of one differs from run_batches")
    fup = float(plain[0]["derived"]["fup"]) / plain[2]
    say("60 mesh-nccl", backend="nccl", ranks=1, batches=plain[2], photons=MESH_PHOTONS,
        fup=f"{fup:.6f}", bit_equal=same, card=json.dumps(card))

    # 60 (cont.). two gloo ranks sharing the card against no mesh: 1e-12
    g = ranks[0]["batches"]
    rel = max(float(np.max(np.abs(a - b.numpy()) / np.maximum(np.abs(b.numpy()), 1e-300)))
              for a, b in zip(g["s1"] + g["s2"], tree_leaves(plain[0]) + tree_leaves(plain[1]))
              if a.size)
    check(g["n"] == MESH_BATCHES and rel <= 1e-12, f"60 gloo ranks: n {g['n']}, rel {rel}")
    say("60 mesh-gloo", backend=ranks[0]["backend"], ranks=2, device=ranks[0]["device"],
        batches=g["n"], max_rel_diff=f"{rel:.2e}", card=json.dumps(card))

    # 61. exact resume: half the batches here, the rest in a fresh process
    ck = out / "resume.npz"
    ck.unlink(missing_ok=True)
    integ = Integrator.create(make_step_cloud(1.0), IntegratorConfig(use_ray_tracing=False,
                                                                     max_events=500),
                              device="cuda")
    src = PhotonSource.directional(0.5, 0.0)
    ckpt.run_batches_resumable(integ, src, MESH_PHOTONS, MESH_BATCHES // 2, seed=SEED,
                               checkpoint_path=str(ck), chunk_batches=2)
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(ROOT)!r})
        from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource, make_step_cloud
        from i3rc_tpu_torch.parallel import checkpoint as ckpt
        offsets = []
        run = ckpt.run_batches
        def counted(*a, **kw):
            offsets.append(kw["batch_offset"])
            return run(*a, **kw)
        ckpt.run_batches = counted
        integ = Integrator.create(make_step_cloud(1.0), IntegratorConfig(use_ray_tracing=False,
                                  max_events=500), device="cuda")
        st = ckpt.run_batches_resumable(integ, PhotonSource.directional(0.5, 0.0),
                                        {MESH_PHOTONS}, {MESH_BATCHES}, seed={SEED},
                                        checkpoint_path={str(ck)!r}, chunk_batches=2)
        print(json.dumps({{"offsets": offsets, "n": st.n_batches,
                          "flux_up": [float(v).hex() for v in st.mean.flux_up.flatten()],
                          "se": [float(v).hex() for v in st.stderr.flux_up.flatten()]}}))
    """)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONHASHSEED="4321"))
    check(res.returncode == 0, f"61 the resuming process failed: {res.stderr[-2000:]}")
    got = json.loads(res.stdout.strip().splitlines()[-1])
    single = run_batches(integ, src, MESH_PHOTONS, MESH_BATCHES, seed=SEED, chunk_batches=2)
    exact = ([float.fromhex(v) for v in got["flux_up"]] == single.mean.flux_up.flatten().tolist()
             and [float.fromhex(v) for v in got["se"]] == single.stderr.flux_up.flatten().tolist())
    check(got["offsets"] == [4, 6] and got["n"] == MESH_BATCHES and exact,
          f"61 resume: offsets {got['offsets']}, exact {exact}")
    say("61 resume", batches=MESH_BATCHES, first_process=MESH_BATCHES // 2,
        second_process_offsets=",".join(map(str, got["offsets"])), exact=exact,
        seconds=f"{time.perf_counter() - t0:.1f}", card=json.dumps(card))

    # The unsharded references of 62 and 63.
    land = Integrator.create(make_landsat_cloud(0.99), IntegratorConfig(
        use_ray_tracing=False, max_events=500, compute_volume_absorption=False), device="cuda")
    res = land.batch_fn(src, SHARD_PHOTONS, n_lanes=1 << 18)(batch_key_(700))
    land_ref = {"fup": float(res.mean_flux_up), "fabs": float(res.mean_flux_absorbed)}
    sc = ss.scene("graft", ss.host("i3rc_tpu_torch"), 2)
    ge = Integrator.create(sc["domain"], IntegratorConfig(
        use_ray_tracing=False, use_fastpath=False, max_events=500,
        compute_volume_absorption=True), surface_albedo=sc["kw"]["surface_albedo"],
        intensity_mus=sc["kw"]["intensity_mus"], intensity_phis=sc["kw"]["intensity_phis"],
        device="cuda")
    ge_st = run_batches(ge, PhotonSource.directional(*sc["src"]), GE_PHOTONS, 16, seed=SEED,
                        derive=lambda r: {"i": r.intensity.mean(dim=(0, 1)),
                                          "fup": r.mean_flux_up})

    # 62. Landsat, whole (128 x 128 columns, ssa 0.99), over two ranks
    r0 = ranks[0]["landsat"]
    n = r0["n_photons"]
    tot = r0["flux_up"].sum() + r0["flux_down"].sum() + r0["flux_absorbed"].sum()
    check(tot + r0["n_bad"] == n == SHARD_PHOTONS, f"62 conservation {tot} + {r0['n_bad']}")
    whole_bytes = 128 * 128 * 119 * 4 * 4
    check(all(r["landsat"]["cell_bytes"] * 2 == whole_bytes for r in ranks),
          f"62 cell bytes {[r['landsat']['cell_bytes'] for r in ranks]}")
    got = {"fup": r0["flux_up"].sum() / n, "fabs": r0["flux_absorbed"].sum() / n}
    for k in ("fup", "fabs"):
        p = land_ref[k]
        sigma = (p * (1 - p) * (1.0 / n + 1.0 / SHARD_PHOTONS)) ** 0.5
        check(abs(got[k] - p) <= 5 * sigma, f"62 Landsat {k}: {got[k]} vs {p} (sigma {sigma})")
    rec = {"landsat": _shard_record(ranks, "landsat"), "graft": _shard_record(ranks, "graft"),
           "one": {k: _shard_record([one], k) for k in ("landsat", "graft")},
           "launches": {k: sum(r["launches"][k] for r in ranks) for k in ("SD", "SB")},
           "twin": twin, "timed": ranks[0]["timed"]}
    o = one["landsat"]
    n1 = o["n_photons"]
    tot1 = o["flux_up"].sum() + o["flux_down"].sum() + o["flux_absorbed"].sum()
    check(tot1 + o["n_bad"] == n1 and abs(o["flux_up"].sum() / n1 - land_ref["fup"])
          <= 5 * (2 * land_ref["fup"] * (1 - land_ref["fup"]) / n1) ** 0.5,
          f"62 one NCCL rank: {tot1} + {o['n_bad']}, Fup {o['flux_up'].sum() / n1}")
    say("62 sharded-landsat-one-rank", ranks=1, backend="nccl", photons=n1,
        lanes_a_rank=SHARD_LANES, fup=f"{o['flux_up'].sum() / n1:.6f}",
        fabs=f"{o['flux_absorbed'].sum() / n1:.6f}", n_bad=o["n_bad"],
        migrations=int(o["migrations"]), **_shard_fields(rec["one"]["landsat"]),
        card=json.dumps(card))
    say("62 sharded-landsat", ranks=2, backend=ranks[0]["backend"],
        exchange="device buffers" if ranks[0]["backend"] == "nccl" else "pinned host staging",
        photons=n,
        lanes_a_rank=SHARD_LANES, fup=f"{got['fup']:.6f}", fabs=f"{got['fabs']:.6f}",
        unsharded_fup=f"{land_ref['fup']:.6f}", unsharded_fabs=f"{land_ref['fabs']:.6f}",
        n_bad=r0["n_bad"], migrations=int(r0["migrations"]),
        cell_bytes_a_rank=",".join(str(r["landsat"]["cell_bytes"]) for r in ranks),
        whole_cell_bytes=whole_bytes, **_shard_fields(rec["landsat"]), card=json.dumps(card))

    # 63. the graft scene (two components, albedo 0.3, 2 detectors, volume)
    r0 = ranks[0]["graft"]
    n = r0["n_photons"]
    i_sh = r0["intensity"].reshape(-1, 2).sum(axis=0) / n
    i_ge = ge_st.mean["derived"]["i"].cpu().numpy()
    se = ge_st.stderr["derived"]["i"].cpu().numpy()
    scale = GE_PHOTONS * ge_st.n_batches / n
    check(np.all(i_sh > 0) and r0["n_bad"] <= 0.01 * n and r0["volume"].sum() > 0,
          f"63 graft: I {i_sh}, n_bad {r0['n_bad']}")
    check(np.all(np.abs(i_sh - i_ge) <= 5 * se * np.sqrt(1.0 + scale)),
          f"63 graft radiance {i_sh} vs G+E {i_ge} +- {se}")
    say("63 sharded-graft", ranks=2, photons=n, lanes_a_rank=SHARD_LANES,
        intensity=",".join(f"{v:.5f}" for v in i_sh),
        ge_intensity=",".join(f"{v:.5f}" for v in i_ge), ge_stderr=",".join(f"{v:.1e}" for v in se),
        n_bad=r0["n_bad"], migrations=int(r0["migrations"]), **_shard_fields(rec["graft"]),
        card=json.dumps(card))
    o = one["graft"]
    i_one = o["intensity"].reshape(-1, 2).sum(axis=0) / o["n_photons"]
    check(o["n_bad"] <= 0.01 * o["n_photons"]
          and np.all(np.abs(i_one - i_ge) <= 5 * se * np.sqrt(1.0 + scale)),
          f"63 graft on one NCCL rank: I {i_one} vs G+E {i_ge} +- {se}, n_bad {o['n_bad']}")
    say("63 sharded-graft-one-rank", ranks=1, backend="nccl", photons=o["n_photons"],
        lanes_a_rank=SHARD_LANES, intensity=",".join(f"{v:.5f}" for v in i_one),
        n_bad=o["n_bad"], **_shard_fields(rec["one"]["graft"]), card=json.dumps(card))
    say("62-63 launches", **rec["launches"])
    check(all(rec["launches"][k] > 0 for k in ("SD", "SB")),
          f"the sharded path launched {rec['launches']}")
    return rec


def _shard_record(ranks: list, name: str) -> dict:
    """The ranks' trace of a scene (two ranks, or one): photons/s (the
    slowest rank's wall time, the trace's set-up included), host ms a block
    (the slowest rank's block loop over its blocks), SD's and SB's device
    ms (every rank's kernels) and the bounds, SB's launches and its ray
    loop's lane use over the trace, and the device's idle share over the
    block loop (one minus every rank's device time of the profiled loop
    over the slowest rank's unprofiled loop)."""
    rs = [r[name] for r in ranks]
    n = rs[0]["n_photons"]
    sd_launches = sum(r["blocks"] for r in rs)
    sd = sd_bound(sum(r["lane_events"] for r in rs), sd_launches, SHARD_LANES, rs[0]["n_dirs"],
                  sum(r["table_bytes"] for r in rs))
    tot = lambda k: sum(r[k] for r in rs)
    sbb = sb_bound(tot("steps"), sd_launches if rs[0]["n_dirs"] else 0, SHARD_LANES,
                   tot("escapes"), tot("rows"), tot("free"))
    use = {k: sum(r["sb_use"][k] for r in rs) for k in rs[0]["sb_use"]}
    seconds = max(r["seconds"] for r in rs)
    return {"photons_per_s": n / seconds, "seconds": seconds,
            "loop_seconds": max(r["loop_seconds"] for r in rs),
            "host_ms_per_block": max(r["host_ms_per_block"] for r in rs),
            "idle_share": 1.0 - sum(r["device_ms_total"] for r in rs)
            / (1e3 * max(r["loop_seconds"] for r in rs)),
            "sd_ms": tot("sd_ms"), "sb_ms": tot("sb_ms"),
            "sd_bound": sd, "sb_bound": sbb, "blocks": rs[0]["blocks"],
            "sb_lane_use": use["steps"] / max(use["slots"], 1), "sb_launches": tot("sb_seen"),
            "lane_events": sum(r["lane_events"] for r in rs),
            "steps": sum(r["steps"] for r in rs)}


def _shard_fields(rec: dict) -> dict:
    return dict(photons_per_s=f"{rec['photons_per_s']:.4e}", seconds=f"{rec['seconds']:.3f}",
                loop_seconds=f"{rec['loop_seconds']:.3f}", blocks=rec["blocks"],
                host_ms_per_block=f"{rec['host_ms_per_block']:.3f}",
                device_idle_share=f"{rec['idle_share']:.4f}",
                sd_device_ms=f"{rec['sd_ms']:.3f}",
                sd_bound_ms=f"{rec['sd_bound'][0]:.3f}", sd_bound_by=rec["sd_bound"][1],
                sb_device_ms=f"{rec['sb_ms']:.3f}", sb_bound_ms=f"{rec['sb_bound'][0]:.3f}",
                sb_bound_by=rec["sb_bound"][1], sb_launches=rec["sb_launches"],
                sb_ray_loop_lane_use=f"{rec['sb_lane_use']:.3f}",
                lane_events=rec["lane_events"], ray_steps=rec["steps"])


def sharded_entry(kind: str, checks: dict, rec: dict) -> dict:
    """The kernels-line entry of SD (the whole block) or SB (the shadow
    rays' steps and pack, which merged SR and SP): launches on the sharded
    path (both ranks, phases 62-63), the largest difference to the plain
    version (59, both the world of one and the two ranks: SD's the block's
    state, SB's its tallies), rank 0's launches on the main path (SD on
    Landsat, SB on graft; 2^20 lanes, half the slab) timed alone at a
    mid-flight (``ms``) and a tail block, the plain version's time and the
    bound; beside them the per-trace device time of the path on two ranks
    sharing the card and on one rank alone, each with its bound, the host
    ms a block and the device's idle share; SB's ray loop's lane use and
    its runs of tiles."""
    t, tail = rec["timed"][f"{kind}_mid"], rec["timed"][f"{kind}_tail"]
    name = "landsat" if kind == "SD" else "graft"
    k = kind.lower()
    two, one = rec[name], rec["one"][name]
    err = {"SD": "err", "SB": "tally_err"}[kind]
    out = {"name": {"SD": "sharded_event_block", "SB": "shadow_block"}[kind], "route": "cuda",
           "source": "i3rc_tpu_torch/csrc/sharded_event_block.cu",
           "replaces": "none: XLA, i3rc_tpu/parallel/sharded_domain.py:" + {
               "SD": "230 (event) and the glue of the body at :373",
               "SB": "464 (the shadow rays' K steps) and :358 (pack_send of the shadow rays, "
                     ":529-557)"}[kind],
           "launches": rec["launches"][kind],
           "max_abs_err": max(checks[err], rec["twin"][err]),
           "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
           "bound_by": t["bound"][1], "library_ms": None,
           "tail_ms": tail["ms"], "tail_plain_ms": tail["plain_ms"],
           "tail_bound_ms": tail["bound"][0],
           "batch_ms": two[f"{k}_ms"], "batch_bound_ms": two[f"{k}_bound"][0],
           "photons_per_s": two["photons_per_s"],
           "one_rank_batch_ms": one[f"{k}_ms"], "one_rank_batch_bound_ms": one[f"{k}_bound"][0],
           "one_rank_photons_per_s": one["photons_per_s"],
           "host_ms_per_block": two["host_ms_per_block"], "idle_share": two["idle_share"],
           "one_rank_host_ms_per_block": one["host_ms_per_block"],
           "one_rank_idle_share": one["idle_share"]}
    if kind == "SB":
        lane_use = lambda u: u["steps"] / max(u["slots"], 1)
        out.update(merged=["shadow_advance (SR)", "shadow_pack (SP)"],
                   ray_loop_lane_use=lane_use(t["use"]), runs=t["use"]["runs"],
                   tail_ray_loop_lane_use=lane_use(tail["use"]),
                   batch_ray_loop_lane_use=two["sb_lane_use"],
                   one_rank_batch_ray_loop_lane_use=one["sb_lane_use"])
    return out


if __name__ == "__main__":
    sys.exit(main())
