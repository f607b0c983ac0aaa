"""The marching shadow trace of the fast event block on the card: one whole
block of the CUDA kernels with a plan whose x and y factors both vary (K3-M:
the detector block's shadow rays by ``shadow_march``; over a reflecting
surface its surface stage too, K3-M+S) against the plain version
(``fused_block_reference``) at the launch, mid-flight and tail states of
every case of ``tests/march_scenes.py`` march_cases: HG and table,
Iwabuchi on and off, absorbing and conservative, black, an albedo and RPV.
Every lane-state row, the lane weight, the control state and the dead
counts bit for bit; the tallies within 1e-9 of their largest bin (the
kernels add them in another order, K3-M its queued rays in the order the
CTA's threads pull them).  Over black, the rays K3-M's queue traced are the
plain version's rays, with the same segment steps.  The marching surface
stage (S-M) takes runs of tiles a CTA: it is held to the plain version at
lane counts of one tile a run, of two tiles a run past one wave of CTAs, and
past one wave of runs of the most tiles, each with a partial last tile, and
its ray loop's rays and steps are the plain version's.  Then the step cloud's closed plan
against the same plan made to march, and the plane-parallel driver on
``cuda``.

Marked ``cuda``: skipped without a card; imports no JAX, so it runs on the
card's machine with ``--noconftest``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource, batch_key, make_step_cloud
from i3rc_tpu_torch.kernels import event_block as eb

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("march_scenes",
                                               Path(__file__).with_name("march_scenes.py"))
_scenes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_scenes)
CASES = _scenes.march_cases()
SRC = PhotonSource.directional(0.5, 0.0)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_march_block_matches_reference_on_gpu(case):
    dev = need_card()
    integ = _scenes.case_integrator(case, dev)
    key = batch_key(41, 1)
    lanes = _scenes.LANES
    spec, pro, states = _scenes.trace_states(integ, SRC, 4 * lanes, lanes, key)
    assert spec.det.march_steps > 0 and [s[0] for s in states] == ["launch", "mid", "tail"]
    for name, st, buf, kb in states:
        r = _scenes.block_vs_twin(spec, pro, st, buf, key, SRC, kb)
        assert r["bit_equal"], (name, r)
        assert r["acc_rel_err"] <= 1e-9, (name, r)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(c for c in CASES if "ssa" in c))
def test_queued_rays_are_the_plain_versions_rays(case):
    """K3-M traces its rays from the CTAs' queues: at the mid-flight state
    the rays the kernel's loop traced, and their segment steps, are the
    plain version's (its census), each ray once."""
    dev = need_card()
    integ = _scenes.case_integrator(case, dev)
    key = batch_key(41, 1)
    spec, pro, states = _scenes.trace_states(integ, SRC, 4 * _scenes.LANES, _scenes.LANES, key)
    name, st, buf, kb = states[1]
    with eb.march_census() as cen:
        eb.fused_block_reference(spec, pro, st.clone(), buf.clone(), key, SRC, kb)
    use = eb.march_ray_use(dev)
    use.zero_()
    eb.fused_block(spec, pro, st.clone(), buf.clone(), key, SRC, kb)
    got = dict(zip(eb.MARCH_USE, use.tolist()))
    assert cen["rays"] > 0 and got["rays"] == cen["rays"], (got, cen)
    assert got["steps"] == cen["steps"] and got["slots"] >= got["steps"], (got, cen)


# (surfaced case, lanes): one tile a run, two a run, past a wave of runs of
# the most tiles; each lane count leaves a partial last tile.
STAGE_RUNS = [(c, size) for c in sorted(c for c in CASES if "ssa" not in c)
              for size in ("one_tile", "two_tiles")] + [
    ("hg_iw_rpv", "past_a_wave"), ("tab_exact_rpv", "past_a_wave")]


@pytest.mark.cuda
@pytest.mark.parametrize("case,size", STAGE_RUNS)
def test_surface_stage_runs_of_tiles_on_gpu(case, size):
    """S-M's runs of T tiles: at the launch, mid-flight and tail states of a
    trace at the lane count of ``size`` (from the stage's wave on this card),
    the whole surfaced block bit-equal to the plain version (tallies within
    1e-9); at the mid-flight state the stage's runs are its launch shape's,
    and the rays and steps of both ray loops, K3-M's and S-M's, are the plain
    version's."""
    dev = need_card()
    integ = _scenes.case_integrator(case, dev)
    from i3rc_tpu_torch.integrators.fastpath import event_spec, prologue_spec

    spec = event_spec(integ.geometry, integ._fast_plan, integ.config)
    pro = prologue_spec(integ.geometry, spec, integ.config, 1)
    wave = eb.surface_march_runs(pro, spec, 256, dev)["wave"]
    most = eb.SURFACE_MAX_TILES
    tiles = {"one_tile": 32, "two_tiles": wave + 3, "past_a_wave": most * wave + 3}[size]
    lanes = tiles * 256 + 77
    shape = eb.surface_march_runs(pro, spec, lanes, dev)
    want_t = {"one_tile": 1, "two_tiles": 2, "past_a_wave": most}[size]
    assert shape["tiles"] == want_t and shape["runs"] == -(-(tiles + 1) // want_t), shape
    assert (shape["runs"] > shape["wave"]) == (size == "past_a_wave"), shape
    key = batch_key(47, 3)
    spec, pro, states = _scenes.trace_states(integ, SRC, lanes, lanes, key)
    for name, st, buf, kb in states:
        r = _scenes.block_vs_twin(spec, pro, st, buf, key, SRC, kb)
        assert r["bit_equal"] and r["acc_rel_err"] <= 1e-9, (name, r)
    name, st, buf, kb = states[1]
    with eb.march_census() as cen:
        eb.fused_block_reference(spec, pro, st.clone(), buf.clone(), key, SRC, kb)
    use = eb.march_ray_use(dev)
    use.zero_()
    eb.fused_block(spec, pro, st.clone(), buf.clone(), key, SRC, kb)
    got = dict(zip(eb.MARCH_USE, use.tolist()))
    assert got["surface_runs"] == shape["runs"], (got, shape)
    assert got["surface_rays"] > 0 and got["rays"] + got["surface_rays"] == cen["rays"]
    assert got["steps"] + got["surface_steps"] == cen["steps"], (got, cen)
    assert got["surface_slots"] >= got["surface_steps"], got


@pytest.mark.cuda
def test_closed_and_marching_plans_agree_on_gpu():
    """tests/test_fastpath.py:994-1030 on the card: same key, flux tallies
    bitwise equal, radiance at the JAX test's tolerances; only the marching
    batch counts in the march counter."""
    from i3rc_tpu_torch.integrators.fastpath import make_fast_tracer

    dev = need_card()
    integ = Integrator.create(make_step_cloud(1.0), IntegratorConfig(**_scenes.CFG_KW),
                              device=dev, **_scenes.CLOSED_VS_MARCH_DETECTORS)
    n, lanes = 1 << 16, 1 << 14
    key = batch_key(43, 2)
    raws = []
    for plan in _scenes.closed_and_marching(integ):
        eb.reset_launch_counters()
        tracer = make_fast_tracer(integ.geometry, plan, integ.config, n, lanes)
        raws.append(tracer(key, SRC.sample(key, lanes, dev), SRC))
        assert eb.event_block.march_launches == (
            0 if plan.closed_shadow else eb.event_block.detector_launches)
    cmp = _scenes.compare_closed_and_marching(*raws)
    assert cmp["ok"], cmp


@pytest.mark.cuda
def test_plane_parallel_driver_runs_on_gpu():
    """The shipped namelist through the driver on cuda: closure and the
    reflectance window of tests/test_drivers.py:14-25."""
    from i3rc_tpu_torch.drivers.plane_parallel import run_from_namelist

    need_card()
    out = run_from_namelist(str(ROOT / "examples" / "planeParallel.nml"), quiet=True,
                            device="cuda")
    assert out["flux_up"] + out["flux_down"] == pytest.approx(1.0, abs=2e-3)
    assert 0.12 < out["flux_up"] < 0.21 and np.isfinite(out["flux_up_err"])
