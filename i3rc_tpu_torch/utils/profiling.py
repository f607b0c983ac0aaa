"""Profiler integration: a ``torch.profiler`` trace of a run and a per-kernel
device-time table.

Port of ``i3rc_tpu/utils/profiling.py``.  The reference records only coarse
setup and total wall-clock (`cpu_time`, Example-Drivers/monteCarloDriver.f95:
255-259).  The JAX package traces a run with ``jax.profiler`` and buckets the
xplane's HLO categories; here ``profile_run`` traces a run with
``torch.profiler`` (the drivers' ``--profile DIR``) into a Chrome trace under
DIR, and ``profile_report`` sums the newest trace's device time by kernel:
the hand-written kernels by name, every other device kernel (torch's own ops,
copies, fills) as "torch glue".

The profiler now and then drops the device records of a trace (chip_smoke.py
``traced``): on the card a run whose trace shows no kernel is traced again,
up to three times, and the report names the traces taken and dropped; a run
whose every trace is empty is reported as such, never as an empty table.  On
the CPU there is no device: the table lists the host's self time by torch op
and says so.
"""

from __future__ import annotations

import glob
import json
import os
import re
import time

import torch

# The port's kernels by the name the profiler gives them, the first pattern
# that matches deciding (the general kernel's last template flag is DET).
KERNELS = (
    (re.compile(r"fast_event_block_surface_kernel_march"), "S-M (marching surface stage)"),
    (re.compile(r"fast_event_block_surface_kernel"), "S (surface stage)"),
    (re.compile(r"fast_event_block_kernel_march"), "K3-M (event block, marching trace)"),
    (re.compile(r"fast_event_block_kernel"), "event block (K1, K2, K3, COL)"),
    (re.compile(r"general_event_block_kernel<[^>]*\btrue>"), "G+E (general block, detectors)"),
    (re.compile(r"general_event_block_kernel"), "G (general block)"),
    (re.compile(r"polarized_event_block_kernel"), "PZ (polarized block)"),
    (re.compile(r"sharded_event_block_kernel"), "SD (sharded block)"),
    (re.compile(r"shadow_block_kernel"), "SB (sharded shadow rays)"),
    (re.compile(r"column_read_probe"), "column-read probe"),
)
GLUE = "torch glue"
TRIES = 3                      # traces of a run on the card before it is reported empty
SIDECAR = "profile_run.json"   # the traces taken and dropped, beside the traces


def kernel_label(name: str) -> str:
    """The table's row of a device kernel's name."""
    for pattern, label in KERNELS:
        if pattern.search(name):
            return label
    return GLUE


def _device_kernels(events: list) -> list:
    return [e for e in events if e.get("cat") == "kernel" and "dur" in e]


def _load(path: str) -> list:
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def profile_run(run, trace_dir: str, device="cuda"):
    """``run()`` under ``torch.profiler``, its Chrome trace written under
    ``trace_dir``; returns what ``run()`` returns.  On a CUDA device a trace
    that shows no kernel is taken again, up to ``TRIES`` runs in all."""
    on_card = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    taken = dropped = 0
    out = path = None
    for _ in range(TRIES if on_card else 1):
        if on_card:
            torch.cuda.synchronize(device)
        with torch.profiler.profile(activities=acts) as prof:
            out = run()
            if on_card:
                torch.cuda.synchronize(device)
        path = os.path.join(trace_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-"
                                       f"{os.getpid()}-{taken}.json")
        prof.export_chrome_trace(path)
        taken += 1
        if not on_card or _device_kernels(_load(path)):
            break
        dropped += 1
    with open(os.path.join(trace_dir, SIDECAR), "w") as f:
        json.dump({"trace": os.path.basename(path), "device": str(device), "taken": taken,
                   "dropped": dropped}, f)
    return out


def latest_trace(trace_dir: str) -> str | None:
    paths = glob.glob(os.path.join(trace_dir, "**", "trace-*.json"), recursive=True)
    return max(paths, key=os.path.getmtime) if paths else None


def _host_self_us(events: list) -> dict:
    """Self time (us) of each torch op on the host: its duration less that
    of the ops nested in it on the same thread."""
    ops = sorted((e for e in events if e.get("cat") == "cpu_op" and "dur" in e),
                 key=lambda e: (e.get("pid"), e.get("tid"), e["ts"], -e["dur"]))
    out, stack = {}, []
    for e in ops:
        while stack and (stack[-1][0] != (e.get("pid"), e.get("tid"))
                         or stack[-1][1] + stack[-1][2] <= e["ts"]):
            stack.pop()
        if stack:
            parent = stack[-1][3]
            out[parent] = out.get(parent, 0.0) - e["dur"]
        out[e["name"]] = out.get(e["name"], 0.0) + e["dur"]
        stack.append(((e.get("pid"), e.get("tid")), e["ts"], e["dur"], e["name"]))
    return out


def profile_report(trace_dir: str) -> str:
    """The device-time table of the newest trace under ``trace_dir``: a row
    per kernel of the port and one for the torch glue; on a CPU run the host's
    self time by torch op."""
    path = latest_trace(trace_dir)
    if path is None:
        return f"# no torch.profiler trace found under {trace_dir}"
    side = {}
    if os.path.exists(os.path.join(trace_dir, SIDECAR)):
        with open(os.path.join(trace_dir, SIDECAR)) as f:
            side = json.load(f)
    events = _load(path)
    kernels = _device_kernels(events)
    tries = (f"; traces taken {side['taken']}, dropped {side['dropped']}"
             if side.get("trace") == os.path.basename(path) else "")
    on_card = side.get("device", "cuda").startswith("cuda")
    if not kernels and on_card:
        return (f"# {os.path.basename(path)}: the profiler recorded no device kernel"
                f"{tries}: no device-time table")
    if kernels:
        by = {}
        for e in kernels:
            label = kernel_label(e["name"])
            us, n = by.get(label, (0.0, 0))
            by[label] = (us + float(e["dur"]), n + 1)
        total = sum(us for us, _ in by.values()) or 1.0
        lines = [f"# device time by kernel ({os.path.basename(path)}; total "
                 f"{total / 1e3:.3f} ms{tries})"]
        for label, (us, n) in sorted(by.items(), key=lambda kv: -kv[1][0]):
            lines.append(f"#   {label:<40s} x{n:<7d} {us / 1e3:10.3f} ms  "
                         f"{100 * us / total:5.1f}%")
        return "\n".join(lines)
    host = _host_self_us(events)
    total = sum(host.values()) or 1.0
    lines = [f"# host time by torch op ({os.path.basename(path)}; a CPU run: no device, "
             f"these are the host's self times; total {total / 1e3:.3f} ms)"]
    for name, us in sorted(host.items(), key=lambda kv: -kv[1])[:12]:
        lines.append(f"#   {name:<40s} {us / 1e3:10.3f} ms  {100 * us / total:5.1f}%")
    return "\n".join(lines)
