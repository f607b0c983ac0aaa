"""The readings the limits of ``correct`` are set from, on the card.

    python3 rtbench/control.py --workload <name> --seeds 1,2,3 [--program [--fault F] --seconds 20]

``--program`` reads sound runs: the whole of ``run.run_cell`` on each seed in
one process (the lower readings); with ``--fault`` (a name of
``faults.FAULTS``) the same run with that fault planted under the timed
path (the upper reading of ``var_excess``, from ``half``).  Without it, the
control: the plain
reference in bfloat16, the nearest precision below the float32 that the
port computes in, put in the program's place at the cell's photons a batch
for the cell's ``control_batches`` batches, and compared with the float32
reference exactly as a run compares the program (the upper readings).  One
JSON line per seed.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rtbench import cells, faults, run, stats  # noqa: E402


def control_checks(cell: cells.Cell, seed: int, device) -> dict:
    """The comparison's numbers with the bfloat16 reference in the
    program's place."""
    scene = cell.config.scene(cell.traffic["ssa"])
    n = int(cell.traffic["photons_per_batch"])
    ref_mom, ref = run.reference_moments(cell, scene, seed, device)
    ctl_mom, ctl = run.reference_moments(cell, scene, seed + 1, device, dtype=torch.bfloat16,
                                         photons_per_batch=n,
                                         batches=cell.cell["control_batches"])
    out = stats.compare(ctl_mom, ref_mom)
    out["control_bad"] = ctl.n_bad
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rtbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    seconds = args.seconds or cells.benchmark()["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if args.program:
            out = run.run_cell(cell, seed, seconds, False, t_start=t,
                               program=faults.FAULTS.get(args.fault))
            rec = {k: c["value"] for k, c in out["checks"].items()}
            rec.update(correct=out["correct"], failed=out["failed"],
                       attempted=out["attempted"], metrics=out["metrics"])
        else:
            rec = control_checks(cell, seed, "cuda")
        kind = ("program" if not args.fault else args.fault) if args.program else "control"
        rec.update(workload=args.workload, seed=seed, kind=kind,
                   seconds=time.perf_counter() - t)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
