"""What else moved while a window ran: the host's speed, the card's clocks.

The rates of a host-bound cell move with the speed at which the host runs
the port's Python.  A run records, beside its result, what could move it
from one process to the next: this process's share of a CPU over the
window, the time of a fixed pure-Python loop before and after the window,
and the card's clocks, temperature, power and throttle reasons read as the
window closes.  (The load of other processes is not recorded: the chip's
sandbox reports no load average and no CPU ticks of others.)  Nothing here
is a metric; it only reads.
"""

from __future__ import annotations

import subprocess
import time

GPU_FIELDS = ("clocks.sm", "clocks.max.sm", "temperature.gpu", "power.draw",
              "clocks_throttle_reasons.active")
PROBE_LOOPS = 200_000


def probe_ms() -> float:
    """Milliseconds of a fixed pure-Python loop: the host's speed at this
    process's kind of work."""
    t = time.perf_counter()
    s = 0
    for i in range(PROBE_LOOPS):
        s += i & 7
    return 1e3 * (time.perf_counter() - t)


def snapshot() -> dict:
    return {"wall": time.perf_counter(), "own_cpu": time.process_time(),
            "probe_ms": probe_ms()}


def between(a: dict, b: dict) -> dict:
    """What the host did from snapshot ``a`` to snapshot ``b``."""
    return {"probe_ms_before": a["probe_ms"], "probe_ms_after": b["probe_ms"],
            "own_cpu_pct": 100.0 * (b["own_cpu"] - a["own_cpu"]) / (b["wall"] - a["wall"])}


def gpu() -> dict:
    """The card's clocks (MHz), temperature (C), power draw (W) and active
    throttle reasons, from nvidia-smi; empty where it cannot be read."""
    try:
        p = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(GPU_FIELDS)}",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        vals = [v.strip() for v in p.stdout.strip().splitlines()[0].split(",")]
    except (OSError, IndexError, subprocess.SubprocessError):
        return {}
    if p.returncode != 0 or len(vals) != len(GPU_FIELDS):
        return {}
    out = {}
    for k, v in zip(GPU_FIELDS, vals):
        try:
            out[k] = float(v) if not v.startswith("0x") else v
        except ValueError:
            out[k] = v
    return out
