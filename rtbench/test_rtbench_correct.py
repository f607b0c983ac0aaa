"""What decides ``correct``: sound runs pass, broken ones and the control do not.

On the CPU each cell runs at test size through the whole of a run but the
look for a card: the port's plain twins in place of its kernels, the
window, the reference and the comparison with the committed limits.  The
program broken underneath (``faults.py``) must come out not correct, once
per fault the cell can have (one card: there is no exchange between cards
to leave out), and by the check that is there to catch it:

  unchanged   batches_repeated (exact, limit 0);
  lost        z_domain or chi2_blocks;
  half        var_excess, which needs a few hundred batches: on the CPU
              for the step cloud's cells, whose batches the plain twins
              run in a fraction of a second; on the card (marked ``cuda``)
              at the cell's own size for the Landsat cells, whose batches
              take seconds on the CPU.

The control, the plain reference in bfloat16 in the program's place, must
come out not correct too: on the card (marked ``cuda``) at the cell's own
size, where the limits hold; on the CPU it is held against the reference
in float32 at a size the CPU holds.
"""

import dataclasses

import pytest
import torch

from rtbench import cells, control, faults, run, stats

SIZES = {"step_cloud.flux": {}, "step_cloud.radiance": {},
         "landsat.flux": {"photons": 1 << 10, "lanes": 1 << 8, "block": (64, 64),
                          "ref_photons": 1 << 11, "ref_batches": 16},
         "landsat.radiance": {"photons": 1 << 9, "lanes": 1 << 8, "block": (64, 64),
                              "ref_photons": 1 << 11, "ref_batches": 16}}
BATCHES = 8
CAUGHT_BY = {"unchanged": ("batches_repeated",), "lost": ("z_domain", "chi2_blocks"),
             "half": ("var_excess",)}
# The half fault on the CPU: many small batches.
HALF_SIZES = {"step_cloud.flux": {"photons": 1 << 8, "lanes": 1 << 8},
              "step_cloud.radiance": {"photons": 1 << 7, "lanes": 1 << 7}}
HALF_BATCHES = 256
SEED = 2**31 + 101


def failing(out) -> set:
    return {k for k, c in out["checks"].items()
            if not (isinstance(c["value"], (int, float)) and c["value"] <= c["limit"])}


@pytest.mark.parametrize("name", sorted(SIZES))
def test_a_sound_run_is_correct_and_each_fault_is_not(name, tiny):
    cell = tiny(name, **SIZES[name])
    sound = run.run_cell(cell, SEED, 0.0, False, device="cpu", batches=BATCHES)
    assert sound["correct"], sound["checks"]
    for fault in ("unchanged", "lost"):
        out = run.run_cell(cell, SEED, 0.0, False, device="cpu", batches=BATCHES,
                           program=faults.FAULTS[fault])
        assert not out["correct"], (fault, out["checks"])
        assert failing(out) & set(CAUGHT_BY[fault]), (fault, out["checks"])


@pytest.mark.parametrize("name", sorted(HALF_SIZES))
def test_half_a_batch_is_not_correct_on_the_cpu(name, tiny):
    cell = tiny(name, **HALF_SIZES[name])
    sound = run.run_cell(cell, SEED, 0.0, False, device="cpu", batches=HALF_BATCHES)
    assert sound["correct"], sound["checks"]
    out = run.run_cell(cell, SEED, 0.0, False, device="cpu", batches=HALF_BATCHES,
                       program=faults.half)
    assert not out["correct"] and "var_excess" in failing(out), out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(set(SIZES) - set(HALF_SIZES)))
def test_half_a_batch_is_not_correct_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the half fault at the cell's own size")
    cell = cells.load(name)
    out = run.run_cell(cell, SEED, cells.benchmark()["run_seconds"], False,
                       program=faults.half)
    assert not out["correct"] and "var_excess" in failing(out), out["checks"]


@pytest.mark.parametrize("name", ["step_cloud.flux", "step_cloud.radiance"])
def test_the_control_is_far_from_the_reference_at_test_size(name, tiny):
    """The committed limits are for the cell's own size (the card's test
    below); at a size the CPU holds, the control reads several times what
    the reference in float32 reads against itself."""
    cell = tiny(name, photons=1 << 15, ref_photons=1 << 15, ref_batches=16)
    cell = dataclasses.replace(cell, cell=dict(cell.cell, control_batches=8))
    seed = 2**31 + 7
    ctl = control.control_checks(cell, seed, "cpu")
    scene = cell.config.scene(cell.traffic["ssa"])
    ref_mom, _ = run.reference_moments(cell, scene, seed, "cpu")
    f32_mom, _ = run.reference_moments(cell, scene, seed + 1, "cpu",
                                       photons_per_batch=1 << 15, batches=8)
    sound = stats.compare(f32_mom, ref_mom)
    assert ctl["chi2_blocks"] > 3 * sound["chi2_blocks"], (ctl, sound)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SIZES))
def test_the_control_is_not_correct_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's own size")
    cell = cells.load(name)
    checks = control.control_checks(cell, 2**31 + 7, "cuda")
    limits = cell.cell["limits"]
    assert any(checks[k] > 3 * limits[k] for k in checks if k in limits), checks
