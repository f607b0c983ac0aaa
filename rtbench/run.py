"""The port's benchmark: one cell, one run.

    python3 rtbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Builds the cell named in ``BENCHMARK.json`` (its configuration's scene, its
traffic mix), builds the port's integrator on the card and warms it up with
one batch, then runs whole batches back to back through the port's batch
entry (``Integrator.batch_fn``, the callable ``parallel.mesh.run_batches``
loops over) until ``--seconds`` have passed, summing each batch's fields'
float64 moments on the card.  After the window the plain reference
(``reference.py``) traces the same scene and the comparison of
``stats.py`` decides ``correct``.  The last line of standard output is one
JSON object: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics from a profiler trace of part of the window
(``--trace 1``), with the host's speed and the card's clocks over the
window under "host" (``host.py``).  The numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.

Exits nonzero, printing no result, without a card, with fewer cards than
the cell asks for, without the port, or when JAX or the JAX package was
loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if __name__ == "__main__":
    # One process with few threads: the host's part of the window is the
    # Python loop that launches the kernels, and idle thread pools only
    # take cores from it.
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(_var, "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rtbench import cells, host, port, reference, stats, trace, work  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "i3rc_tpu")
TRACE_SECONDS = 1.0        # the traced part of a --trace 1 window
WARMUP_BATCH = 0xFFFFFFFF  # a batch index the window never reaches


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def reference_seed(seed: int) -> int:
    return (int(seed) * 6364136223846793005 + 1442695040888963407) % (1 << 63)


def ref_scene(scene: dict, traffic: dict) -> reference.Scene:
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    return reference.Scene(
        x_edges=list(scene["x_edges"]), y_edges=list(scene["y_edges"]),
        z_edges=list(scene["z_edges"]), ext=t(scene["ext"]), ssa=t(scene["ssa"]),
        g=scene["g"], mu0=scene["mu0"], phi0=scene["phi0"],
        det_mus=tuple(traffic["detector_mus"]), det_phis=tuple(traffic["detector_phis"]))


def reference_moments(cell: cells.Cell, scene: dict, seed: int, device, dtype=torch.float32,
                      photons_per_batch: int | None = None, batches: int | None = None):
    """The reference's moments of the compared fields and its run."""
    r = cell.cell["reference"]
    ref = reference.trace(ref_scene(scene, cell.traffic),
                          photons_per_batch or r["photons_per_batch"], batches or r["batches"],
                          reference_seed(seed), dtype=dtype, device=device)
    return stats.reference_moments(ref, cell.config.COMPARE_BLOCK), ref


class Clock:
    """Batch-end stamps: CUDA events on the card, the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: float | None = None, program=None, batches: int | None = None) -> dict:
    """One run of the cell: set-up, warm-up, window, reference, comparison.
    The result is the last line's object, with the numbers compared under
    "checks".  For the tests and ``control.py``: ``program(fn, integ, source,
    traffic)`` stands in for the port's batch function ``fn``, and
    ``batches`` makes the window that many batches in place of
    ``seconds``."""
    t_start = T_START if t_start is None else t_start
    traffic = cell.traffic
    n = int(traffic["photons_per_batch"])
    scene = cell.config.scene(traffic["ssa"])
    integ, source = port.integrator(scene, cell.config.SETTINGS, traffic, device)
    fn = port.batch_fn(integ, source, traffic)
    if program is not None:
        fn = program(fn, integ, source, traffic)
    block = cell.config.COMPARE_BLOCK
    fields = lambda r: stats.fields(r.flux_up, r.flux_down, r.flux_absorbed, r.intensity, block)
    clock = Clock(device)
    fields(fn(port.batch_key(seed, WARMUP_BATCH)))
    clock.sync()
    setup_s = time.perf_counter() - t_start

    nx, ny = np.asarray(scene["ext"]).shape[:2]
    mom = stats.Moments(stats.layout(nx, ny, len(traffic["detector_mus"]), block))
    zero = lambda: torch.zeros((), dtype=torch.int64, device=device)
    n_bad, repeated = zero(), zero()
    batch_ms, raised = [], 0
    state = {"b": 0, "last": None, "prev": None}

    def one_batch():
        b = state["b"]
        state["b"] += 1
        try:
            with torch.profiler.record_function(trace.SPAN):
                res = fn(port.batch_key(seed, b))
                f = fields(res)
                mom.add(f)
                n_bad.add_(res.n_bad)
                if state["prev"] is not None:
                    repeated.add_((f == state["prev"]).all())
                state["prev"] = f
        except RuntimeError as err:
            print(f"batch {b} raised: {err}", file=sys.stderr)
            return False
        now = clock.stamp()
        batch_ms.append((state["last"], now))
        state["last"] = now
        return True

    tr, part = None, {}
    if traced:
        # The traced part of the window: its batches count in the run as
        # every other batch; the window's clock starts after it.
        def traced_part():
            nonlocal raised
            first, l0 = state["b"], port.launches()
            state["last"] = clock.stamp()
            t = time.perf_counter()
            while time.perf_counter() - t < TRACE_SECONDS or state["b"] - first < 3:
                raised += not one_batch()
            l1 = port.launches()
            return {"first": first, "batches": state["b"] - first,
                    "launches": None if l0 is None or l1 is None else l1 - l0}
        tr = trace.capture(traced_part, os.path.join(cells.ROOT, "build", "rtbench", "trace"))
        part = tr.get("run", {})
    clock.sync()
    first_timed, first_ms = state["b"], len(batch_ms)
    before = host.snapshot()
    t0 = time.perf_counter()
    state["last"] = clock.stamp()
    while (state["b"] - first_timed < batches if batches is not None
           else time.perf_counter() - t0 < seconds):
        raised += not one_batch()
    clock.sync()
    wall = time.perf_counter() - t0
    card = host.gpu() if clock.cuda else {}
    host_state = dict(host.between(before, host.snapshot()), **card)
    times = [clock.ms(a, b) for a, b in batch_ms]
    attempted = state["b"] * n
    failed = int(n_bad) + raised * n
    peak = torch.cuda.max_memory_allocated() if clock.cuda else 0
    del fn, integ
    if clock.cuda:
        torch.cuda.empty_cache()

    ref_mom, ref = reference_moments(cell, scene, seed, device)
    checks = {}
    if mom.n >= 2:
        checks = stats.compare(mom, ref_mom)
        checks["var_excess"] = stats.var_excess(mom, n, ref.photon_var)
    # Exact: no batch gives back the fields of the batch before it.
    checks["batches_repeated"] = int(repeated)
    limits = cell.cell["limits"]
    correct = (raised == 0 and mom.n >= 2 and set(checks) == set(limits)
               and all(checks[k] <= limits[k] for k in limits))
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed}
    if not traced:
        values = {"photons_per_s": (state["b"] - first_timed - raised) * n / wall,
                  "batch_ms_p95": float(np.percentile(times[first_ms:], 95)),
                  "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                          for m in cell.end_to_end}
    dev_name = torch.cuda.get_device_name(0) if clock.cuda else "cpu"
    out["device"] = {"platform": "gpu" if clock.cuda else "cpu", "kind": dev_name,
                     "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        first, nb = part.get("first", 0), part.get("batches", 0)
        d = len(traffic["detector_mus"])
        optics, tallies = work.scene_bytes(
            int(np.asarray(scene["ext"]).size),
            bool(np.any((np.asarray(scene["ssa"]) < 1) & (np.asarray(scene["ext"]) > 0))),
            int(np.asarray(scene["ext"]).shape[0] * np.asarray(scene["ext"]).shape[1]), d)
        ctx = trace.Trace(
            batches=nb, batch_ms=times[first:first + nb], photons_per_batch=n,
            device_s=tr.get("device_s", {}), busy_s=tr.get("busy_s", 0.0),
            window_s=tr.get("window_s", 0.0), idle_by_host=tr.get("idle_by_host", {}),
            launches=part.get("launches"),
            work={"collisions_per_photon": ref.collisions_per_photon, "detectors": d,
                  "optics_bytes": optics, "tally_bytes": tallies,
                  "power_limit_w": work.power_limit_w() if clock.cuda else None})
        metrics = {}
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["metrics"] = metrics
        out["device"]["busy_s"] = ctx.busy_s
        out["device"]["window_s"] = ctx.window_s
        out["breakdown"] = trace.breakdown(tr)
        out["roofline"] = work.roofline_detail(ctx)
    out["host"] = host_state
    out["reference"] = {"photons": ref.photons_per_batch * ref.flux_up.shape[0],
                        "collisions_per_photon": ref.collisions_per_photon,
                        "n_bad": ref.n_bad, "program_batches": mom.n}
    num = lambda v: v if math.isfinite(v) else str(v)
    out["checks"] = {k: {"value": num(checks.get(k, math.nan)), "limit": limits[k]}
                     for k in limits}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"rtbench: the cell needs {cell.chips} CUDA device(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"rtbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
