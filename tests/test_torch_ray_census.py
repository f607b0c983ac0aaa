"""The detector-ray census of the estimate stages, on the CPU.

The kernels G (with radiance detectors) and PZ trace their local estimates'
rays from each CTA's ray queue (csrc/general_event_block.cuh,
csrc/polarized_event_block.cuh).  Their plain twins record each ray's cost
with a ``record`` dict (``general_block_reference``: DDA steps;
``polarized_block_reference``: ratio-tracking rounds), and
``kernels.general_block.ray_census`` scores the designs of the estimate
stage on a recorded block.  Tested here:

  * ``ray_census`` on hand-made rays, against counts done by hand;
  * a recorded block of path (a) (the step cloud through
    ``IntegratorConfig()`` with the I3RC detectors) and of the Mie step
    cloud on PZ: the rays' steps and rounds sum, lane by lane, to the
    twin's ``int_steps`` and ``ROUNDS`` row, one ray per (estimate,
    detector);
  * the twins' state and tallies with ``record=`` are those without;
  * G's launch refuses more components than the record's tally-slot field
    holds.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource, batch_key, make_step_cloud
from i3rc_tpu_torch.integrators import polarized as pz
from i3rc_tpu_torch.kernels import general_block as gb

torch.set_num_threads(2)
SRC = PhotonSource.directional(0.5, 0.0)
DET_MUS, DET_PHIS = [1.0, 0.5, 0.5], [0.0, 0.0, 180.0]


def _scenes():
    spec = importlib.util.spec_from_file_location(
        "polarized_scenes", Path(__file__).with_name("polarized_scenes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rays(rows):
    """int64 (4, n) from (event j, lane, detector, cost) tuples."""
    return torch.tensor(rows, dtype=torch.int64).T.contiguous()


def test_hand_counted_designs():
    """Two warps (64 slots, one CTA of 64).  Event 0: lane 0 rays (5, 1),
    lane 1 (2, 2), lane 33 (7, 0); event 1: lane 0 (1, 1).
      serial: trips (0, warp 0) max(6, 4) = 6, (0, warp 1) 7, (1, warp 0) 2;
      warp: warp 0's six rays in one round, longest 5; warp 1's two, 7;
      cta_by_detector: all eight rays in one round, longest 7;
      warp_pull: warp 0 max(ceil(12 / 32), 5) = 5, warp 1 max(1, 7) = 7."""
    r = rays([(0, 0, 0, 5), (0, 0, 1, 1), (0, 1, 0, 2), (0, 1, 1, 2), (0, 33, 0, 7),
              (0, 33, 1, 0), (1, 0, 0, 1), (1, 0, 1, 1)])
    c = gb.ray_census(r, gb.identity_order(64), cta_slots=64)
    assert c["rays"] == 8 and c["cost"] == 19
    assert (c["serial"]["warp_cost"], c["serial"]["rounds"]) == (15, 3)
    assert (c["warp"]["warp_cost"], c["warp"]["rounds"]) == (12, 2)
    assert (c["cta_by_detector"]["warp_cost"], c["cta_by_detector"]["rounds"]) == (7, 1)
    assert (c["warp_pull"]["warp_cost"], c["warp_pull"]["rounds"]) == (12, 2)
    assert c["serial"]["efficiency"] == pytest.approx(19 / (32 * 15))


def test_hand_counted_rounds_of_32():
    """One event, lanes 0-19 of warp 0, two detectors, every ray of cost 1
    but lane 17's second (9).  serial: max lane sum 10; warp: 40 rays in
    push order, round 1 the first 32 (1), round 2 the last 8 with ray 35
    (9); cta_by_detector: the 20 detector-0 rays and 12 detector-1 rays (1),
    then detector 1 of lanes 12-19 (9); warp_pull: max(ceil(48 / 32), 9)."""
    r = rays([(0, lane, d, 9 if (lane, d) == (17, 1) else 1)
              for lane in range(20) for d in range(2)])
    c = gb.ray_census(r, gb.identity_order(256))
    assert c["cost"] == 48
    assert c["serial"]["warp_cost"] == 10 and c["serial"]["rounds"] == 1
    assert c["warp"]["warp_cost"] == 10 and c["warp"]["rounds"] == 2
    assert c["cta_by_detector"]["warp_cost"] == 10 and c["cta_by_detector"]["rounds"] == 2
    assert c["warp_pull"]["warp_cost"] == 9


def test_slots_follow_the_order():
    """A compacted order puts lanes 40 and 70 on one warp: their rays share
    its rounds, and a lane the order does not place is refused."""
    alive = torch.zeros(256, dtype=torch.bool)
    alive[[40, 70]] = True
    order = gb.lane_order(alive)
    r = rays([(0, 40, 0, 3), (0, 70, 0, 4)])
    c = gb.ray_census(r, order)
    assert c["serial"]["rounds"] == 1 and c["serial"]["warp_cost"] == 4
    with pytest.raises(ValueError):
        gb.ray_census(rays([(0, 41, 0, 1)]), order)


def general_block_pair(lanes=1024, photons=4096, blocks=2):
    """Path (a)'s scene on the CPU: ``blocks`` blocks of the twin with the
    record, and a copy of each block run without it."""
    integ = Integrator.create(make_step_cloud(1.0), IntegratorConfig(), device="cpu",
                              intensity_mus=DET_MUS, intensity_phis=DET_PHIS)
    tracer = integ.general_tracer(photons, lanes)
    spec, opt, tables = tracer.spec, integ.device_optics, integ.tables
    var = gb.variant(spec, opt)
    key = batch_key(2024, 7)
    st = gb.launch_state(spec, SRC.sample(key, lanes, "cpu"), photons)
    buf = gb.general_buffers(spec, st, min(lanes, photons))
    out = []
    for kb in range(blocks):
        s0, b0 = st.clone(), buf.clone()
        rec = {}
        gb.general_block_reference(spec, var, opt, tables, st, buf, key, SRC, kb, record=rec)
        s1, b1 = s0.clone(), b0.clone()
        gb.general_block_reference(spec, var, opt, tables, s1, b1, key, SRC, kb)
        out.append((s0, b0, st.clone(), buf.clone(), s1, b1, rec))
    return spec, out


def test_general_rays_sum_to_int_steps():
    spec, blocks = general_block_pair()
    D = spec.det.n
    for s0, b0, st, buf, s1, b1, rec in blocks:
        j, lane, d, steps = rec["rays"]
        assert rec["rays"].shape[1] > 0
        per_lane = torch.zeros(st.n_lanes, dtype=torch.int64).index_add_(0, lane, steps)
        assert torch.equal(per_lane, (buf.int_steps - b0.int_steps).long())
        rays_lane = torch.zeros(st.n_lanes, dtype=torch.int64).index_add_(
            0, lane, torch.ones_like(lane))
        assert torch.equal(rays_lane, (buf.int_rays - b0.int_rays).long())
        assert bool(((d >= 0) & (d < D)).all()) and bool(((j >= 0) & (j < spec.K)).all())
        # each estimate traces its D rays, detector by detector
        assert torch.equal(d.view(-1, D), torch.arange(D).expand(d.numel() // D, D))
        c = gb.ray_census(rec["rays"], gb.identity_order(st.n_lanes))
        assert c["cost"] == int(steps.sum())
        assert c["serial"]["warp_cost"] >= c["warp_pull"]["warp_cost"] > 0


def test_ray_record_slot_field_bounds_the_components():
    """The kernel's ray record keeps the tally slot (comp + 1) in 16 bits:
    with detectors 255 components and more run (the 8-bit field refused
    them), and only past 65534 is a plan refused before a launch."""
    from types import SimpleNamespace

    integ = Integrator.create(make_step_cloud(1.0), IntegratorConfig(), device="cpu",
                              intensity_mus=DET_MUS, intensity_phis=DET_PHIS)
    spec, opt = integ.general_tracer(4096, 1024).spec, integ.device_optics
    var = gb.variant(spec, opt)
    assert gb.launch_refusal(spec, var, opt) is None
    for n in (254, 255, 300, 65534):
        assert gb.launch_refusal(spec, var, SimpleNamespace(n_components=n)) is None
    assert "65534 components" in gb.launch_refusal(spec, var,
                                                   SimpleNamespace(n_components=65535))


def test_general_record_changes_nothing():
    _, blocks = general_block_pair(blocks=1)
    for s0, b0, st, buf, s1, b1, rec in blocks:
        assert torch.equal(st.f, s1.f) and torch.equal(st.i, s1.i)
        for name in ("columns", "vol", "ctl", "dead", "intensity", "by_component", "excess",
                     "int_steps", "int_rays"):
            assert torch.equal(getattr(buf, name), getattr(b1, name)), name


@pytest.fixture(scope="module")
def mie_blocks():
    pzs = _scenes()
    h = pzs.host("i3rc_tpu_torch")
    integ = pz.PolarizedIntegrator.create(pzs.mie_step_cloud(h), config=h.Config(**pzs.CFG_KW),
                                          device="cpu", intensity_mus=DET_MUS,
                                          intensity_phis=DET_PHIS)
    lanes, photons = 1024, 4096
    spec = integ.spec(photons)
    src = h.Source.directional(0.5, 0.0)
    key = batch_key(2024, 8)
    st = pz.launch_state(spec, src.sample(key, lanes, "cpu"), photons)
    buf = pz.polarized_buffers(spec, st, min(lanes, photons))
    out = []
    for kb in range(2):
        s0, b0 = st.clone(), buf.clone()
        rec = {}
        pz.polarized_block_reference(spec, st, buf, key, src, kb, record=rec)
        s1, b1 = s0.clone(), b0.clone()
        pz.polarized_block_reference(spec, s1, b1, key, src, kb)
        out.append((s0, st.clone(), buf.clone(), s1, b1, rec))
    return spec, out


def test_polarized_rays_sum_to_rounds(mie_blocks):
    spec, blocks = mie_blocks
    for s0, st, buf, s1, b1, rec in blocks:
        j, lane, d, rounds = rec["rays"]
        assert rec["rays"].shape[1] > 0
        per_lane = torch.zeros(st.n_lanes, dtype=torch.int64).index_add_(0, lane, rounds)
        assert torch.equal(per_lane, (st.i[pz.ROUNDS] - s0.i[pz.ROUNDS]).long())
        n_rays = torch.zeros(st.n_lanes, dtype=torch.int64).index_add_(
            0, lane, torch.ones_like(lane))
        assert torch.equal(n_rays, (st.i[pz.RAYS] - s0.i[pz.RAYS]).long())
        assert bool((rounds >= 1).all()) and bool(((d >= 0) & (d < spec.n_dirs)).all())
        c = gb.ray_census(rec["rays"], gb.identity_order(st.n_lanes))
        assert c["cost"] == int(rounds.sum())


def test_polarized_record_changes_nothing(mie_blocks):
    _, blocks = mie_blocks
    for s0, st, buf, s1, b1, rec in blocks:
        assert torch.equal(st.f, s1.f) and torch.equal(st.i, s1.i)
        for name in ("columns", "intensity", "ctl", "dead"):
            assert torch.equal(getattr(buf, name), getattr(b1, name)), name
