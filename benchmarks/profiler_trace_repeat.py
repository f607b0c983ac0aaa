#!/usr/bin/env python3
"""Repeat ``chip_smoke.py`` phase 11 and count the profiler's short traces.

Phase 11 checks the gas-channel event block (K2) against its plain version
on six cases and times each block with ``chip_smoke.device_block_ms``: up
to three ``torch.profiler`` traces of 20 launches, the first that shows at
least half of them.  Once all three traces showed no block launch at all.
This script builds the kernels, runs the phase ``--reps`` times in one
process, and prints for each repeat the traces taken, the short ones
(fewer than half the launches) and the empty ones, then one JSON line with
the totals.  Needs a CUDA device and nvcc.  Run from the repository root:

    python3 benchmarks/profiler_trace_repeat.py --reps 12
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import i3rc_tpu_torch.kernels.event_block as eb  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_trace_repeat: torch finds no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    eb.build()
    dev = torch.device("cuda", 0)
    failed = 0
    for rep in range(args.reps):
        before = dict(cs.PROFILER_TRACES)
        try:
            cs.gas_kernel_checks(dev, card)
        except AssertionError as e:
            failed += 1
            print(f"[repeat {rep}] failed: {e}", flush=True)
        print(f"[repeat {rep}] " + " ".join(
            f"{k}={cs.PROFILER_TRACES[k] - before[k]}" for k in before), flush=True)
    print(json.dumps(dict(reps=args.reps, failed_phases=failed, card=card, **cs.PROFILER_TRACES)))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
