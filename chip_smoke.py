#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the CUDA kernels from i3rc_tpu_torch/csrc, checks the event block's
flux, radiance-detector, gas-channel and column variants and the column-read
probe against their plain PyTorch twins, then drives the port's paths — the
I3RC step-cloud flux run, the step-cloud run with the three radiance
detectors of examples/monteCarloDriver_stepCloud.nml, each through
``Integrator.batch_fn`` and the namelist driver, the cloud + gas slab against
the discrete-ordinates oracle, the broadband k-distribution loop and
examples/broadbandDriver.nml through the broadband driver, the I3RC Landsat
scene (flux, absorbing with heating rates, and through the namelist driver)
and the column-read probe loop — and checks the physics.  Every phase prints
one line; any failed check raises and the script exits nonzero.  Run from
the repository root:

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
from pathlib import Path

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
# Operations per alive lane-event, counted by hand from the kernel sources
# (fast_event_block.cuh, column_read_probe.cu) for the variant each phase
# times: (ALU operations, special-function operations).  A Philox4x32-10
# call is ~100 integer operations; a rotation ~60 ALU and 5 SFU (two square
# roots, one reciprocal square root, two divisions of the HG inverse); a
# free path one logf; a face distance one division.
OPS_PER_EVENT = {
    "flux": (630, 21),             # K1, chain 2: 3 Philox calls, 3 rotations, 3 logf
    "detectors": (650, 24),        # K3, 3 detectors with Iwabuchi, chain 0
    "gas": (680, 27),              # K2 flux, chain 3: 3 Philox calls, 4 rotations
    "gas_detectors": (450, 19),    # K2, 2 detectors, chain 0
    "column": (640, 23),           # P1 in the event block, chain 2: + one row read
    "probe": (120, 0),             # P1 probe: one Philox call and ~20 ALU per event
}
STATE_BYTES_PER_LANE = 2 * 13 * 4  # the 13 state rows, read once and written once


def bound_ms(variant: str, lane_events: int, n_bytes: int) -> tuple[float, str]:
    """(least ms, what bounds it) for ``lane_events`` alive lane-events of the
    variant that move ``n_bytes`` of device memory."""
    alu, sfu = OPS_PER_EVENT[variant]
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(lane_events * alu / FP32_OPS_PER_S, lane_events * sfu / SFU_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def ptxas_by_variant(log: str) -> dict:
    """Per kernel variant (flux, detectors, gas, gas_detectors, column_flux,
    probe): instantiations, their most registers and their spill-store
    bytes, from ptxas -v."""
    out = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*fast_event_block_kernelILi\d+ELi\d+"
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
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            n, r, b = out[name]
            out[name] = (n, r, b + int(m[1]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            n, r, b = out[name]
            out[name] = (n, max(r, int(m[1])), b)
    return {k: f"{n}x/{r}regs/{b}B" for k, (n, r, b) in sorted(out.items())}


def _load_tests_module(name: str):
    """A numpy-only helper module of tests/, loaded by path."""
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


def kernel_vs_twin(ssa: float, dev, detectors: bool = False, gas=None, chain=None):
    """One K-event block from a mid-flight step-cloud state: kernel vs twin.
    With ``detectors`` the block runs the detector variant and the (n_cols,
    D) accumulators are compared too (relative to their largest bin).  With
    ``gas``, a gas extinction profile over the cloud's 32 layers, the scene
    carries that gas, at the planner's auto chain depth (3), or with the
    two detectors GAS_DET_* and no roulette.  With ``chain`` (-1 for the
    auto depth) the scene is the Landsat cloud, run by the column variant
    at that chain depth.  Returns (agreement, kernel ms, twin ms, spec,
    alive lane-events of the block, the two states as equal or not)."""
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, batch_key,
                                make_landsat_cloud, make_step_cloud)
    from i3rc_tpu_torch.core.rng import philox_uniforms
    from i3rc_tpu_torch.integrators.fastpath import event_spec, launch_state, renormalize
    from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component
    from i3rc_tpu_torch.kernels.event_block import (compare_states, event_block,
                                                     event_block_reference)

    flux_cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                                compute_volume_absorption=False)
    if gas is not None:
        dom = domain_with_gas_component(make_step_cloud(ssa), gas)
        det = dict(intensity_mus=GAS_DET_MUS, intensity_phis=GAS_DET_PHIS) if detectors else {}
        integ = Integrator.create(dom, flux_cfg, device=dev, **det)
    elif detectors:
        integ = Integrator.create(make_step_cloud(ssa), radiance_config(),
                                  intensity_mus=DET_MUS, intensity_phis=DET_PHIS,
                                  device=dev)
    elif chain is not None:
        integ = Integrator.create(make_landsat_cloud(ssa),
                                  IntegratorConfig(use_ray_tracing=False, max_events=500,
                                                   fastpath_chain=chain), device=dev)
    else:
        integ = Integrator.create(make_step_cloud(ssa),
                                  IntegratorConfig(use_ray_tracing=False, max_events=500),
                                  device=dev)
    spec = event_spec(integ.geometry, integ._fast_plan, integ.config)
    check(spec.gas == (gas is not None) and (spec.det is not None) == detectors
          and spec.col == (chain is not None), f"spec {spec}")
    new_acc = lambda: (torch.zeros((spec.det.n_cols, spec.det.n), dtype=torch.float64,
                                   device=dev) if detectors else None)
    key = batch_key(SEED, 7)
    st = launch_state(integ.geometry,
                      PhotonSource.directional(0.5, 0.0).sample(key, L_CHECK, dev), L_CHECK,
                      gas_key=key if gas is not None else None)
    acc = new_acc()
    for kb in range(4):            # advance to mid-flight with the kernel
        renormalize(st)
        event_block(spec, st, key, kb, acc)
    renormalize(st)
    kb = 4

    def run_kernel(s, a):
        event_block(spec, s, key, kb, a)

    def run_twin(s, a):
        event_block_reference(spec, s, philox_uniforms(key, kb, spec.K, spec.n_draws,
                                                       L_CHECK, dev), a)

    got, ref = st.clone(), st.clone()
    acc_k, acc_t = new_acc(), new_acc()
    run_kernel(got, acc_k)
    run_twin(ref, acc_t)
    torch.cuda.synchronize()
    agree = compare_states(spec, got, ref, rtol=1e-4)
    bit_equal = torch.equal(got.f, ref.f) and torch.equal(got.i, ref.i)
    events = int((ref.i[4] - st.i[4]).sum())
    if detectors:
        check(float(acc_t.sum()) > 0.0, "the detector block contributed nothing")
        agree["acc_rel_err"] = float((acc_k - acc_t).abs().max() / acc_t.abs().max())
        agree["acc_abs_err"] = float((acc_k - acc_t).abs().max())

    def time_ms(fn, n):
        total = 0.0
        for _ in range(n):
            s, acc_s = st.clone(), new_acc()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn(s, acc_s)
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
        return total / n

    time_ms(run_kernel, 2)
    time_ms(run_twin, 1)
    return agree, time_ms(run_kernel, 20), time_ms(run_twin, 5), spec, events, bit_equal


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

    # 2. build
    built = eb.build()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", built.log)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", built.log))
    say("2 build", seconds=f"{built.seconds:.1f}", library=built.path.name,
        max_registers=max(regs) if regs else "n/a", spill_store_bytes=spills,
        **ptxas_by_variant(built.log))

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

    # 4. kernel vs twin on one K-event block at L = 2^18
    kernel_ms, plain_ms, max_err = None, None, 0.0
    for ssa in (1.0, 0.99):
        agree, k_ms, p_ms, spec, events, _ = kernel_vs_twin(ssa, dev)
        check(agree["int_frac"] >= 0.999, f"ssa={ssa}: integer agreement {agree}")
        check(agree["float_frac"] == 1.0, f"ssa={ssa}: float agreement {agree}")
        max_err = max(max_err, agree["max_abs_err"])
        if kernel_ms is None:
            kernel_ms, plain_ms = k_ms, p_ms
            flux_bound = bound_ms("flux", events, L_CHECK * STATE_BYTES_PER_LANE)
        say("4 kernel-vs-twin", ssa=ssa, lanes=L_CHECK, K=spec.K, chain=spec.chain,
            int_agree=f"{agree['int_frac']:.6f}", float_agree=f"{agree['float_frac']:.6f}",
            max_abs_err=f"{agree['max_abs_err']:.3e}", lane_events=events,
            kernel_ms=f"{k_ms:.4f}", twin_ms=f"{p_ms:.4f}", card=json.dumps(card))

    # 5. the slice: step cloud, 2^24 photons at 2^18 lanes
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500)
    src = PhotonSource.directional(0.5, 0.0)
    eb.reset_launch_counters()
    fn = Integrator.create(make_step_cloud(1.0), cfg, device="cuda").batch_fn(
        src, SLICE_PHOTONS, n_lanes=L_CHECK)
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
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
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

    # 8. detector variant vs twin: 3 detectors, Iwabuchi, one K-event block
    det_ms, det_plain_ms, det_err = None, None, 0.0
    for ssa in (1.0, 0.99):
        agree, k_ms, p_ms, spec, events, _ = kernel_vs_twin(ssa, dev, detectors=True)
        check(agree["int_frac"] >= 0.999, f"detectors ssa={ssa}: integer agreement {agree}")
        check(agree["float_frac"] == 1.0, f"detectors ssa={ssa}: float agreement {agree}")
        check(agree["acc_rel_err"] <= 1e-9, f"detectors ssa={ssa}: accumulator {agree}")
        det_err = max(det_err, agree["max_abs_err"], agree["acc_abs_err"])
        if det_ms is None:
            det_ms, det_plain_ms = k_ms, p_ms
            # + the (n_cols, D) float64 accumulator, read and written once.
            det_bound = bound_ms("detectors", events, L_CHECK * STATE_BYTES_PER_LANE
                                 + 2 * 8 * spec.det.n_cols * spec.det.n)
        say("8 detector-kernel-vs-twin", ssa=ssa, lanes=L_CHECK, K=spec.K, chain=spec.chain,
            detectors=spec.det.n, iwabuchi=spec.det.iwabuchi, n_draws=spec.n_draws,
            int_agree=f"{agree['int_frac']:.6f}", float_agree=f"{agree['float_frac']:.6f}",
            max_abs_err=f"{agree['max_abs_err']:.3e}",
            acc_rel_err=f"{agree['acc_rel_err']:.3e}", lane_events=events,
            kernel_ms=f"{k_ms:.4f}", twin_ms=f"{p_ms:.4f}", card=json.dumps(card))

    # 9. the radiance slice: step cloud + 3 detectors, 2^24 photons at 2^18 lanes
    eb.reset_launch_counters()
    fn = Integrator.create(make_step_cloud(1.0), radiance_config(), intensity_mus=DET_MUS,
                           intensity_phis=DET_PHIS, device="cuda").batch_fn(
        src, SLICE_PHOTONS, n_lanes=L_CHECK)
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
    bb_launches = broadband_slice(dev, card)

    # 14. examples/broadbandDriver.nml, unmodified, through the port's driver
    # from a directory holding the inputs that examples/make_broadband_inputs.py
    # writes (its paths are relative)
    launches_gas_det = broadband_driver(out / "broadband", card)

    # 15. column variant vs twin: one K-event block from a mid-flight Landsat
    # state, ssa 1 at the auto chain depth (2), ssa 0.99 at depth 2 and 0
    col_ms, col_plain_ms, col_bound = column_kernel_checks(dev, card)

    # 16. the Landsat flux slice at full size (bench.py:168-190): 2^23
    # photons at 2^18 lanes, median of 3 after a warm-up
    launches_col = landsat_slice(card)

    # 17. Landsat at ssa 0.99 with heating rates (1.95M-cell volume tally)
    landsat_absorbing()

    # 18. the Landsat domain file the port writes, through the namelist driver
    landsat_driver(out / "landsat", card)

    # 19. the column-read probe: its loop (two launches of K = 8 events at
    # 2^17 lanes), then the kernel against its twin on the same draws
    probe = probe_checks(dev, card)

    # 20. results: every kernel with its launches on its path, its error
    # against its twin, its time, the twin's and the least time the card
    # could take.  No single PyTorch call computes a transport event or the
    # probe's dependent read loop, so library_ms is null throughout.
    print(smi)
    source = "i3rc_tpu_torch/csrc/fast_event_block.cu"
    gas_source = "i3rc_tpu_torch/csrc/fast_event_block_gas.cu"
    entry = lambda name, src, replaces, launches, err, ms, plain, bound: {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}
    print(json.dumps({"kernels": [
        entry("fast_event_block", source, "i3rc_tpu/integrators/fastpath.py:665",
              launches_slice, max_err, kernel_ms, plain_ms, flux_bound),
        entry("fast_event_block_detectors", source,
              "i3rc_tpu/integrators/fastpath.py:665 (n_detectors>0)", launches_rad, det_err,
              det_ms, det_plain_ms, det_bound),
        entry("fast_event_block_gas", gas_source,
              "i3rc_tpu/integrators/fastpath.py:665 (gas=True)", bb_launches, gas_err[False],
              *gas_ms[False]),
        entry("fast_event_block_gas_detectors", gas_source,
              "i3rc_tpu/integrators/fastpath.py:665 (gas=True)", launches_gas_det,
              gas_err[True], *gas_ms[True]),
        entry("fast_event_block_column", "i3rc_tpu_torch/csrc/fast_event_block_col.cu",
              "benchmarks/column_read_probe.py:83 (in the column event of "
              "i3rc_tpu/integrators/fastpath.py:1320)", launches_col, 0.0, col_ms,
              col_plain_ms, col_bound),
        entry("column_read_probe", "i3rc_tpu_torch/csrc/column_read_probe.cu",
              "benchmarks/column_read_probe.py:83", *probe)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def gas_kernel_checks(dev, card: str):
    """Phase 11; returns ({detectors: (kernel ms, twin ms, bound)}, {detectors:
    max error}) with the times of the uniform gas at ssa 1."""
    gas_ms = {}
    gas_err = {False: 0.0, True: 0.0}
    uniform = np.full(32, GAS_EXT)
    cases = [(False, 1.0, "uniform"), (False, 0.99, "uniform"), (True, 1.0, "uniform"),
             (True, 0.99, "uniform"), (False, 0.99, "layered"), (True, 1.0, "layered")]
    for detectors, ssa, gas in cases:
        profile = uniform if gas == "uniform" else LAYERED_GAS
        agree, k_ms, p_ms, spec, events, _ = kernel_vs_twin(ssa, dev, detectors=detectors,
                                                          gas=profile)
        what = f"gas={gas} detectors={detectors} ssa={ssa}"
        check(spec.chain == (0 if detectors else 3), f"{what}: chain depth {spec.chain}")
        check(len(spec.gz.thresholds) == (0 if gas == "uniform" else 2),
              f"{what}: gas faces {spec.gz.thresholds}")
        check(agree["int_frac"] >= 0.999, f"{what}: integer agreement {agree}")
        check(agree["float_frac"] == 1.0, f"{what}: float agreement {agree}")
        errs = [agree["max_abs_err"]]
        if detectors:
            check(agree["acc_rel_err"] <= 1e-9, f"{what}: accumulator {agree}")
            errs.append(agree["acc_abs_err"])
        gas_err[detectors] = max(gas_err[detectors], *errs)
        n_bytes = L_CHECK * STATE_BYTES_PER_LANE + (
            2 * 8 * spec.det.n_cols * spec.det.n if detectors else 0)
        gas_ms.setdefault(detectors, (k_ms, p_ms, bound_ms(
            "gas_detectors" if detectors else "gas", events, n_bytes)))
        say("11 gas-kernel-vs-twin", gas=gas, gas_faces=len(spec.gz.thresholds),
            detectors=spec.det.n if detectors else 0, ssa=ssa, lanes=L_CHECK, K=spec.K,
            chain=spec.chain, n_draws=spec.n_draws,
            int_agree=f"{agree['int_frac']:.6f}", float_agree=f"{agree['float_frac']:.6f}",
            max_abs_err=f"{agree['max_abs_err']:.3e}",
            acc_rel_err=f"{agree['acc_rel_err']:.3e}" if detectors else "n/a",
            lane_events=events, kernel_ms=f"{k_ms:.4f}", twin_ms=f"{p_ms:.4f}",
            card=json.dumps(card))
    return gas_ms, gas_err


def column_kernel_checks(dev, card: str):
    """Phase 15; returns (kernel ms, twin ms, bound) of ssa 1 at the auto depth.
    The column variant must equal its twin bit for bit on all 13 state rows."""
    out = None
    for ssa, chain in ((1.0, -1), (0.99, 2), (0.99, 0)):
        agree, k_ms, p_ms, spec, events, bit_equal = kernel_vs_twin(ssa, dev, chain=chain)
        what = f"column ssa={ssa} chain={spec.chain}"
        check(spec.chain == (2 if chain < 0 else chain), f"{what}: chain depth")
        check(bit_equal, f"{what}: kernel and twin differ {agree}")
        if out is None:
            # + the padded column table, read once.
            out = (k_ms, p_ms, bound_ms("column", events, L_CHECK * STATE_BYTES_PER_LANE
                                        + spec.column.numel() * 4))
        say("15 column-kernel-vs-twin", ssa=ssa, lanes=L_CHECK, K=spec.K, chain=spec.chain,
            n_draws=spec.n_draws, columns=spec.n_x * spec.n_y, bit_equal=bit_equal,
            lane_events=events, kernel_ms=f"{k_ms:.4f}", twin_ms=f"{p_ms:.4f}",
            card=json.dumps(card))
    return out


def landsat_slice(card: str) -> int:
    """Phase 16; returns the column-kernel launches of the three timed batches."""
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, batch_key,
                                make_landsat_cloud)
    from i3rc_tpu_torch.kernels import event_block as eb

    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                           compute_volume_absorption=False)
    n = LANDSAT_PHOTONS
    src = PhotonSource.directional(0.5, 0.0)
    integ = Integrator.create(make_landsat_cloud(1.0), cfg, device="cuda")
    fn = integ.batch_fn(src, n, n_lanes=L_CHECK)
    # Warm-up: one batch through the raw tracer, for its event count.
    key = batch_key(SEED, 500)
    raw = integ.batch_tracer(n, L_CHECK)(key, src.sample(key, L_CHECK, "cuda"), src)
    events = int(raw.n_lane_events) / n
    torch.cuda.synchronize()
    eb.reset_launch_counters()
    fups, times = [], []
    for b in range(3):
        t0 = time.perf_counter()
        res = fn(batch_key(SEED, 510 + b))
        fup, fdn, n_bad = float(res.mean_flux_up), float(res.mean_flux_down), int(res.n_bad)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(abs(fup + fdn - 1.0) < 1e-5, f"Landsat closure Fup+Fdn={fup + fdn}")
        check(n_bad < 1e-3 * n, f"Landsat n_bad={n_bad}")
        fups.append(fup)
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
        launches=launches, card=json.dumps(card))
    return launches


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
    """Phase 19; returns (launches, max abs error, ms, twin ms, bound) of one
    launch at 2^17 lanes."""
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
    return launches, err, k_ms, p_ms, bound


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


def broadband_slice(dev, card: str) -> int:
    """Phase 13; returns the gas-kernel launches of the timed run."""
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
    return launches


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


if __name__ == "__main__":
    sys.exit(main())
