"""The least work a batch needs, counted from the scene, and the card's peaks.

A kernel's roofline share is the least time the card could take for the
work of the batches it ran, over the kernel's summed device time.  The work
is counted from the scene, not from what a kernel happens to do, so that
the share reads the same whatever implements it, and only work that the
kernel itself does is charged to it: per photon its exit tally (the
source's draws run before the kernel, in the batch's set-up); per real
collision its free path, its Henyey-Greenstein draw and rotation; per real
collision and detector one local estimate.  The collisions per photon are
the plain reference's own count on the same scene in the same run.
Segment crossings, null collisions and the voxel steps of an estimate's
ray are left out: an implementation need not make them.  The bytes are the
scene's optics read once and the tallies written once.

The costs are instructions a thread issues, counted apart by the pipe that
runs them, (INT32, FP32, special-function), after the port's bring-up gate
(chip_smoke.py ``OPS_PER_*``, counted by hand from the kernel sources):

  a Philox4x32-10 call: 10 rounds of two 32 x 32 -> 64-bit multiplies
    (IMAD.WIDE.U32) and two three-way xors (LOP3), 40 integer
    instructions; the key schedule runs on the warp's uniform datapath
    (chip_smoke.py's probe count writes the same out);
  per collision (OPS_PER_COLLISION["flux"], (180, 7), whose ~100 integer
    operations were the Philox call's multiplies and xors unfused): one
    Philox call (40, 0, 0), and the HG inverse, the rotation and the next
    free path's logf, ~80 float instructions and 7 special-function steps
    (a reciprocal, sine and cosine, two square roots, a reciprocal of the
    transverse norm, the log): (40, 80, 7);
  per estimate (chip_smoke.py OPS_PER_GRAY, (60, 4)): the projection,
    acosf (~15 instructions and a square root), the division by pi, the
    phase value over 4 pi |mu_d| and expf, ~56 float instructions and 4
    special-function steps, and the tally's address and its two float64
    atomics, 4 integer instructions: (4, 56, 4); it is the smaller of the
    port's two estimate counts (OPS_PER_DETECTOR is (70, 4)) and leaves out
    the ray's steps;
  per photon: the exit's position and wrap (~8 float instructions) and
    its column's index and tally address (~8 integer): (8, 8, 0).

Peaks of one NVIDIA H100 SXM at its boost clock of 1.98 GHz and 132 SMs
(the data sheet): per SM and clock, 128 FP32 lanes, 64 INT32 lanes, 16
special-function lanes, and four schedulers that each issue one warp
instruction (128 thread instructions); 3.35e12 bytes/s of HBM3.  The least
time is the largest of each pipe's instructions over its rate, all the
instructions over the issue rate, and the bytes over the memory rate, all
at the full power limit of 700 W; the card's own limit is read beside each
share.
"""

from __future__ import annotations

import subprocess

SMS, CLOCK_HZ = 132, 1.98e9
INT32_PER_S = 64 * SMS * CLOCK_HZ
FP32_PER_S = 128 * SMS * CLOCK_HZ
SFU_PER_S = 16 * SMS * CLOCK_HZ
ISSUE_PER_S = 128 * SMS * CLOCK_HZ
HBM_BYTES_PER_S = 3.35e12
PHILOX = (40, 0, 0)
OPS_PER_PHOTON = (8, 8, 0)
OPS_PER_COLLISION = (PHILOX[0], 80, 7)
OPS_PER_ESTIMATE = (4, 56, 4)


def least_seconds(photons: float, collisions: float, detectors: int, optics_bytes: int,
                  tally_bytes: int, batches: int) -> tuple[float, str]:
    """(least seconds, what bounds them: "int32", "fp32", "sfu", "issue" or
    "bytes") for ``batches`` batches holding ``photons`` photons and
    ``collisions`` real collisions in all, each batch reading
    ``optics_bytes`` and writing ``tally_bytes``."""
    ops = [photons * p + collisions * (c + detectors * e)
           for p, c, e in zip(OPS_PER_PHOTON, OPS_PER_COLLISION, OPS_PER_ESTIMATE)]
    times = {"int32": ops[0] / INT32_PER_S, "fp32": ops[1] / FP32_PER_S,
             "sfu": ops[2] / SFU_PER_S, "issue": sum(ops) / ISSUE_PER_S,
             "bytes": batches * (optics_bytes + tally_bytes) / HBM_BYTES_PER_S}
    by = max(times, key=times.get)
    return times[by], by


def scene_bytes(n_cells: int, absorbing: bool, n_cols: int, detectors: int) -> tuple[int, int]:
    """(optics bytes read, tally bytes written) a batch: a float32
    extinction per cell (and an albedo where the cloud absorbs); a float64
    upward, downward and absorbed flux per column and a radiance per column
    and detector."""
    return n_cells * 4 * (2 if absorbing else 1), n_cols * 8 * (3 + detectors)


def power_limit_w() -> float | None:
    """The card's power limit in watts, from nvidia-smi; None if unread."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def traced_least(ctx) -> tuple[float, str]:
    """The least seconds, and what bounds them, of the traced batches'
    work (a ``trace.Trace``)."""
    w = ctx.work
    photons = ctx.batches * ctx.photons_per_batch
    return least_seconds(photons, photons * w["collisions_per_photon"], w["detectors"],
                         w["optics_bytes"], w["tally_bytes"], ctx.batches)


def roofline_pct(ctx, label: str) -> float | None:
    """The least time of the traced work over the summed device time of the
    kernels under ``label``, in percent; None where they did not run."""
    t = ctx.device_s.get(label, 0.0)
    if ctx.batches == 0 or t <= 0.0:
        return None
    return 100.0 * traced_least(ctx)[0] / t


def roofline_detail(ctx) -> dict:
    """Beside the shares: the least seconds, what bounds them, and the
    card's power limit."""
    if ctx.batches == 0:
        return {}
    least, by = traced_least(ctx)
    return {"least_s": least, "bound_by": by, "power_limit_w": ctx.work.get("power_limit_w")}
