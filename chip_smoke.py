#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the CUDA kernel from i3rc_tpu_torch/csrc, checks its flux and
radiance-detector variants against their plain PyTorch twin, then drives
the port's paths — the I3RC step-cloud flux run and the step-cloud run with
the three radiance detectors of examples/monteCarloDriver_stepCloud.nml,
each through ``Integrator.batch_fn`` and the namelist driver — and checks
the physics.  Every phase prints one line; any failed check raises and the
script exits nonzero.  Run from the repository root:

    python3 chip_smoke.py

Needs a CUDA device (exits nonzero without one) and nvcc (CUDA_HOME or
PATH).  Never imports jax.  The last line is a JSON object naming the device.
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


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def radiance_config():
    """The shipped namelist's algorithms: Iwabuchi roulette at zeta_min 0.3."""
    from i3rc_tpu_torch import IntegratorConfig

    return IntegratorConfig(use_ray_tracing=False, max_events=500,
                            compute_volume_absorption=False,
                            use_russian_roulette_for_intensity=True, zeta_min=0.3)


def kernel_vs_twin(ssa: float, dev, detectors: bool = False):
    """One K-event block from a mid-flight step-cloud state: kernel vs twin.
    With ``detectors`` the block runs the detector variant and the (n_cols,
    D) accumulators are compared too (relative to their largest bin)."""
    from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, batch_key,
                                make_step_cloud)
    from i3rc_tpu_torch.core.rng import philox_uniforms
    from i3rc_tpu_torch.integrators.fastpath import event_spec, launch_state, renormalize
    from i3rc_tpu_torch.kernels.event_block import (compare_states, event_block,
                                                     event_block_reference)

    if detectors:
        integ = Integrator.create(make_step_cloud(ssa), radiance_config(),
                                  intensity_mus=DET_MUS, intensity_phis=DET_PHIS,
                                  device=dev)
    else:
        integ = Integrator.create(make_step_cloud(ssa),
                                  IntegratorConfig(use_ray_tracing=False, max_events=500),
                                  device=dev)
    spec = event_spec(integ.geometry, integ._fast_plan, integ.config)
    new_acc = lambda: (torch.zeros((spec.det.n_cols, spec.det.n), dtype=torch.float64,
                                   device=dev) if detectors else None)
    key = batch_key(SEED, 7)
    st = launch_state(integ.geometry,
                      PhotonSource.directional(0.5, 0.0).sample(key, L_CHECK, dev), L_CHECK)
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
    return agree, time_ms(run_kernel, 20), time_ms(run_twin, 5), spec


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
        max_registers=max(regs) if regs else "n/a", spill_store_bytes=spills)

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
        agree, k_ms, p_ms, spec = kernel_vs_twin(ssa, dev)
        check(agree["int_frac"] >= 0.999, f"ssa={ssa}: integer agreement {agree}")
        check(agree["float_frac"] == 1.0, f"ssa={ssa}: float agreement {agree}")
        max_err = max(max_err, agree["max_abs_err"])
        if kernel_ms is None:
            kernel_ms, plain_ms = k_ms, p_ms
        say("4 kernel-vs-twin", ssa=ssa, lanes=L_CHECK, K=spec.K, chain=spec.chain,
            int_agree=f"{agree['int_frac']:.6f}", float_agree=f"{agree['float_frac']:.6f}",
            max_abs_err=f"{agree['max_abs_err']:.3e}", kernel_ms=f"{k_ms:.4f}",
            twin_ms=f"{p_ms:.4f}", card=json.dumps(card))

    # 5. the slice: step cloud, 2^24 photons at 2^18 lanes
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500)
    src = PhotonSource.directional(0.5, 0.0)
    eb.event_block.launches = eb.event_block.detector_launches = 0
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
        agree, k_ms, p_ms, spec = kernel_vs_twin(ssa, dev, detectors=True)
        check(agree["int_frac"] >= 0.999, f"detectors ssa={ssa}: integer agreement {agree}")
        check(agree["float_frac"] == 1.0, f"detectors ssa={ssa}: float agreement {agree}")
        check(agree["acc_rel_err"] <= 1e-9, f"detectors ssa={ssa}: accumulator {agree}")
        det_err = max(det_err, agree["max_abs_err"], agree["acc_abs_err"])
        if det_ms is None:
            det_ms, det_plain_ms = k_ms, p_ms
        say("8 detector-kernel-vs-twin", ssa=ssa, lanes=L_CHECK, K=spec.K, chain=spec.chain,
            detectors=spec.det.n, iwabuchi=spec.det.iwabuchi, n_draws=spec.n_draws,
            int_agree=f"{agree['int_frac']:.6f}", float_agree=f"{agree['float_frac']:.6f}",
            max_abs_err=f"{agree['max_abs_err']:.3e}",
            acc_rel_err=f"{agree['acc_rel_err']:.3e}", kernel_ms=f"{k_ms:.4f}",
            twin_ms=f"{p_ms:.4f}", card=json.dumps(card))

    # 9. the radiance slice: step cloud + 3 detectors, 2^24 photons at 2^18 lanes
    eb.event_block.launches = eb.event_block.detector_launches = 0
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
    eb.event_block.launches = eb.event_block.detector_launches = 0
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

    # 11. results
    print(smi)
    source = "i3rc_tpu_torch/csrc/fast_event_block.cu"
    print(json.dumps({"kernels": [
        {"name": "fast_event_block", "route": "cuda", "source": source,
         "replaces": "i3rc_tpu/integrators/fastpath.py:665",
         "launches": launches_slice, "max_abs_err": max_err,
         "ms": kernel_ms, "plain_ms": plain_ms},
        {"name": "fast_event_block_detectors", "route": "cuda", "source": source,
         "replaces": "i3rc_tpu/integrators/fastpath.py:665 (n_detectors>0)",
         "launches": launches_rad, "max_abs_err": det_err,
         "ms": det_ms, "plain_ms": det_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
