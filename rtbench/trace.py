"""The traced run: a profiler trace of part of the window and what it says.

The name patterns of the port's kernels, the "torch glue" bucket for every
other device operation and the retaking of a trace that lost its device
records are copied from the port's ``utils/profiling.py`` (``KERNELS``,
``GLUE``, ``TRIES``), so that a later change to the port cannot move the
yardstick.  The trace is read from the Chrome trace the profiler exports,
never from ``key_averages()``, which takes minutes over thousands of
launches.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field

import torch

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
TRIES = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "rtbench.batch"     # the benchmark's own span around each batch


def kernel_label(name: str) -> str:
    for pattern, label in KERNELS:
        if pattern.search(name):
            return label
    return GLUE


@dataclass
class Trace:
    """What the readers of the per-layer metrics get from a traced window."""

    batches: int
    batch_ms: list                      # each traced batch's time (CUDA events)
    photons_per_batch: int
    device_s: dict                      # label -> device seconds in the window
    busy_s: float
    window_s: float
    idle_by_host: dict                  # host op -> idle device seconds
    launches: int | None                # block launches over the traced batches
    work: dict = field(default_factory=dict)   # the least-work inputs (run.py)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events: list) -> dict:
    """Device seconds by label, busy and window seconds, and idle seconds
    by the host op running then, from a Chrome trace's events."""
    spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == SPAN]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not spans or not dev:
        return {}
    t0 = min(e["ts"] for e in spans)
    t1 = max(max(e["ts"] + e["dur"] for e in spans), max(e["ts"] + e["dur"] for e in dev))
    by = {}
    for e in dev:
        label = kernel_label(e["name"]) if e["cat"] == "kernel" else GLUE
        by[label] = by.get(label, 0.0) + e["dur"] * 1e-6
    busy = _union([(max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in dev
                   if e["ts"] + e["dur"] > t0 and e["ts"] < t1])
    tid = spans[0].get("tid")
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") in ("cpu_op", "user_annotation") and "dur" in e
                   and e.get("tid") == tid), key=lambda h: (h[0], -h[1]))
    idle = {}
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    # Host ops on one thread nest: sweep the gaps' midpoints in order with a
    # stack of the ops open there; its top is the innermost.
    stack, i = [], 0
    for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (s + e)
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "host (no torch op)"
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    return {"device_s": by, "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "window_s": (t1 - t0) * 1e-6, "idle_by_host": idle}


def capture(run, trace_dir: str) -> dict:
    """``run()`` under ``torch.profiler`` (CPU and CUDA), its trace written
    to ``trace_dir/trace.json`` and reduced; a trace with no device record
    is taken again, ``TRIES`` runs in all.  Returns the reduction and what
    ``run()`` returned, under "run" (the last run's)."""
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for _ in range(TRIES):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            ran = run()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            out = reduce(json.load(f).get("traceEvents", []))
        os.remove(path)
        out["run"] = ran
        if out.get("device_s"):
            break
    return out


def breakdown(tr: dict) -> dict:
    """The ten device labels and the ten host ops behind idle time that
    took most seconds."""
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(tr.get("device_s", {})),
            "idle_gaps": top(tr.get("idle_by_host", {}))}
