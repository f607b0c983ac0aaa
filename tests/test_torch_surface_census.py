"""``surface_census`` (kernels/event_block.py), the count of the fastpath's
surface stage, against counts taken directly, lane by lane, on the states
that the plain block hands its surface stage: one column (every exit of a
CTA in one of two bins), an albedo over the absorbing step cloud (deaths and
the volume tally), RPV with one upward and one downward detector (only the
upward one emits) and a fused-k band over an albedo; and over the marching
shadow trace (tests/march_scenes.py, RPV and an albedo with two upward
detectors) the marching stage's runs of tiles, their emitting hits and
rays, the flushes of its queue and the lane use of its queue-dealt ray loop,
against counts taken run by run and a warp-by-warp model of the loop.  Also:
the census changes nothing, and its revived lanes are those resolve_surface
revives.
"""

import importlib.util
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from i3rc_tpu_torch import (Domain, Integrator, IntegratorConfig, PhaseFunction,
                            PhaseFunctionTable, PhotonSource, SurfaceDescription, batch_key,
                            henyey_greenstein_coefficients, make_step_cloud)
from i3rc_tpu_torch.integrators.fastpath import (event_spec, lane_width, launch_state,
                                                 prologue_spec)
from i3rc_tpu_torch.kernels import event_block as eb
from i3rc_tpu_torch.kernels.event_block import (ALIVE, PK, X, Y, block_buffers, flux_column,
                                                fused_block, surface_census)

torch.set_num_threads(2)
_spec = importlib.util.spec_from_file_location("march_scenes",
                                               Path(__file__).with_name("march_scenes.py"))
ms = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ms)
CFG = IntegratorConfig(use_ray_tracing=False, max_events=500, compute_volume_absorption=False)
LANES = 1000                      # 4 CTAs, the last one partial
SRC = PhotonSource.directional(0.6, 0.0)


def one_column():
    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(0.75, 32))], key=[1.0])
    dom = Domain.create([0.0, 1000.0], [0.0, 1000.0], [0.0, 1000.0])
    ext = np.full((1, 1, 1), 0.3 / 1000.0)
    return dom.add_component("cirrus", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32),
                             table)


def stage_inputs(integ, n_photons: int, blocks: int = 3, fused: bool = False):
    """The inputs of the surface stage of each of the first ``blocks``
    blocks of a trace on the CPU: (spec, pro, state, buffers, u, u_iw,
    alive at the start of the events), copies taken as resolve_surface is
    called."""
    geom, cfg = integ.geometry, integ.config
    key = batch_key(5, 2)
    if fused:
        from dataclasses import replace

        lanes = lane_width(n_photons, LANES, integ.n_k)
        spec = event_spec(geom, replace(integ._fast_plan, gas_k=integ._gas_k), cfg, n_photons,
                          lanes)
    else:
        lanes = LANES
        spec = event_spec(geom, integ._fast_plan, cfg)
    pro = prologue_spec(geom, spec, cfg, n_photons)
    st = launch_state(geom, SRC.sample(key, lanes, "cpu"), n_photons,
                      gas_key=key if spec.gas else None, weighted=spec.weighted, spec=spec)
    buf = block_buffers(spec, pro, st, spec.fk.launch_counts() if fused else lanes)
    seen, entry = [], {}
    real_events, real_resolve = eb.event_block_reference, eb.resolve_surface

    def events(spec_, s, u, acc=None, *a, **kw):
        entry["alive"] = s.i[ALIVE].clone()
        return real_events(spec_, s, u, acc, *a, **kw)

    def resolve(spec_, pro_, s, b, u, u_iw=None):
        seen.append((spec_, pro_, s.clone(), b.clone(), u, u_iw, entry["alive"]))
        return real_resolve(spec_, pro_, s, b, u, u_iw)

    eb.event_block_reference, eb.resolve_surface = events, resolve
    try:
        for kb in range(blocks):
            fused_block(spec, pro, st, buf, key, SRC, kb)
    finally:
        eb.event_block_reference, eb.resolve_surface = real_events, real_resolve
    return seen


def direct(spec, pro, st, entry_alive):
    """The census's flux counts, lane by lane: exits by kind, the warps in
    lane order and compacted, the CTAs holding an exit, the (warp, bin) and
    (CTA, bin) adds with the most on one bin."""
    pk = st.i[PK].tolist()
    col = flux_column(pro, st.f[X], st.f[Y]).tolist()
    alive = entry_alive.tolist()
    slot, rank = [], {}
    for lane, a in enumerate(alive):
        c = lane // 256
        slot.append(rank.get(c, 0))
        rank[c] = rank.get(c, 0) + (a != 0)
    exits = Counter(k for k in pk if k)
    lanes = [i for i, k in enumerate(pk) if k]
    keys = {i: col[i] * pro.n_kinds + pk[i] - 1 for i in lanes if pk[i] <= pro.n_kinds}
    by_warp = {(i // 32, k) for i, k in keys.items()}
    by_cta = {(i // 256, k) for i, k in keys.items()}
    return {"exits": {k: exits.get(k, 0) for k in (1, 2, 3)},
            "warps_lane_order": len({i // 32 for i in lanes}),
            "warps_compacted": len({(i // 256, slot[i] // 32) for i in lanes}),
            "ctas": len({i // 256 for i in lanes}),
            "warp": len(by_warp), "warp_same": max(Counter(k for _, k in by_warp).values()),
            "cta": len(by_cta), "cta_same": max(Counter(k for _, k in by_cta).values()),
            "bins_max": max(Counter(c for c, _ in by_cta).values())}


def check_flux(c: dict, d: dict) -> None:
    for k in ("exits", "warps_lane_order", "warps_compacted", "ctas"):
        assert c[k] == d[k], (k, c[k], d[k])
    a = c["atomics"]["columns"]
    assert (a["warp"], a["warp_same_address"]) == (d["warp"], d["warp_same"])
    assert (a["cta"], a["cta_same_address"]) == (d["cta"], d["cta_same"])
    assert c["bins_per_cta"] == {"sum": d["cta"], "max": d["bins_max"]}


def test_one_column_every_exit_shares_a_bin():
    """One column: a CTA's exits fall on at most its two bins (up, down), so
    the CTA sums take one add per CTA and kind; the warps take one per warp
    and kind, and the most on one address is the warps holding it."""
    integ = Integrator.create(one_column(), CFG, device="cpu", surface_albedo=0.5)
    for spec, pro, st, buf, u, u_iw, alive in stage_inputs(integ, 4 * LANES):
        c = surface_census(spec, pro, st, buf, u, u_iw, alive)
        d = direct(spec, pro, st, alive)
        check_flux(c, d)
        assert c["bins_per_cta"]["max"] <= 2 and c["hits"] == d["exits"][2] > 0
        hit = st.i[PK] == 2
        assert c["revived"] == int((hit & (u[0] < 0.5)).sum())
        warps = Counter((lane // 32) for lane in hit.nonzero()[:, 0].tolist())
        assert c["bounce_lane_order"] == pytest.approx(c["hits"] / (32 * len(warps)))


def test_albedo_over_absorbing_step_cloud():
    """Deaths pend as kind 3 and each adds to the volume tally: one atomic a
    death in both designs, the most on one (column, cell) bin counted."""
    cfg = IntegratorConfig(use_ray_tracing=False, max_events=500,
                           compute_volume_absorption=True)
    integ = Integrator.create(make_step_cloud(0.99), cfg, device="cpu", surface_albedo=0.2)
    deaths = 0
    for spec, pro, st, buf, u, u_iw, alive in stage_inputs(integ, 4 * LANES, blocks=4):
        c = surface_census(spec, pro, st, buf, u, u_iw, alive)
        d = direct(spec, pro, st, alive)
        check_flux(c, d)
        dead = (st.i[PK] == 3).nonzero()[:, 0].tolist()
        col = flux_column(pro, st.f[X], st.f[Y])
        iz = torch.clamp(((st.f[2] - pro.z0) * pro.inv_dz_cell).long(), 0, pro.n_z - 1)
        bins = Counter(int(col[i]) * pro.n_z + int(iz[i]) for i in dead)
        v = c["atomics"]["vol"]
        assert v["warp"] == v["cta"] == len(dead)
        assert v["cta_same_address"] == (max(bins.values()) if dead else 0)
        deaths += len(dead)
    assert deaths > 0


def test_rpv_only_the_upward_detector_emits():
    """RPV with an upward and a downward detector: every hit emits toward
    the upward one only; the loop's lane use one lane per thread is the
    hits over 32 x the warps holding one, and dealing the pairs of a warp
    to its threads gains nothing with one upward detector."""
    rpv = SurfaceDescription.uniform([0.2, 0.8, -0.1], brdf_name="rpv")
    integ = Integrator.create(make_step_cloud(1.0), CFG, device="cpu", surface=rpv,
                              intensity_mus=[0.5, -0.5], intensity_phis=[40.0, 0.0])
    for spec, pro, st, buf, u, u_iw, alive in stage_inputs(integ, 4 * LANES):
        c = surface_census(spec, pro, st, buf, u, u_iw, alive)
        check_flux(c, direct(spec, pro, st, alive))
        hit = st.i[PK] == 2
        assert list(c["emits"]) == [0] and c["emits"][0] == c["emitting_hits"] == c["hits"] > 0
        comp = Counter()
        for cta in range(-(-LANES // 256)):
            ran = alive[cta * 256:(cta + 1) * 256].nonzero()[:, 0]
            for slot, lane in enumerate(ran.tolist()):
                if hit[cta * 256 + lane]:
                    comp[(cta, slot // 32)] += 1
        assert c["loop_compacted"] == pytest.approx(c["hits"] / (32 * len(comp)))
        assert c["loop_dealt"] == pytest.approx(c["loop_compacted"])
        assert c["atomics"]["srf"]["cta"] <= c["atomics"]["srf"]["warp"]


def test_fused_k_band_over_an_albedo():
    """A fused-k band (two k points over the step cloud's layers) over an
    albedo: the census runs on the fused plan's blocks of whole CTAs."""
    from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component

    profiles = np.stack([np.full(32, 4e-4), np.full(32, 4e-3)])
    integ = Integrator.create(domain_with_gas_component(make_step_cloud(1.0), profiles[0]), CFG,
                              device="cpu", surface_albedo=0.2,
                              gas_k=(profiles, np.array([0.7, 0.3])))
    n = 0
    for spec, pro, st, buf, u, u_iw, alive in stage_inputs(integ, 8 * LANES, fused=True):
        assert spec.fused
        c = surface_census(spec, pro, st, buf, u, u_iw, alive)
        check_flux(c, direct(spec, pro, st, alive))
        n += c["hits"]
    assert n > 0


def test_census_changes_nothing_and_counts_what_resolve_revives():
    integ = Integrator.create(one_column(), CFG, device="cpu", surface_albedo=0.7)
    for spec, pro, st, buf, u, u_iw, alive in stage_inputs(integ, 4 * LANES, blocks=2):
        before = (st.clone(), buf.clone())
        c = surface_census(spec, pro, st, buf, u, u_iw, alive)
        assert torch.equal(st.f, before[0].f) and torch.equal(st.i, before[0].i)
        assert torch.equal(buf.columns, before[1].columns)
        n0 = int(st.i[ALIVE].sum())
        eb.resolve_surface(spec, pro, st, buf, u, u_iw)
        assert c["revived"] == int(st.i[ALIVE].sum()) - n0


def test_census_refuses_an_exit_on_a_lane_that_did_not_run():
    integ = Integrator.create(one_column(), CFG, device="cpu", surface_albedo=0.5)
    spec, pro, st, buf, u, u_iw, alive = stage_inputs(integ, 4 * LANES, blocks=1)[0]
    with pytest.raises(ValueError, match="did not run"):
        surface_census(spec, pro, st, buf, u, u_iw, torch.zeros_like(alive))


def plain_trips(rays: list) -> int:
    """Warp trips of one flush's rays (their steps, in deal order) dealt to
    eight warps of 32 threads, warp by warp and thread by thread: the rule
    of event_block.queue_trips."""
    n, nxt, trips = len(rays), 0, 0
    rem = [[0] * 32 for _ in range(8)]
    more = [[n > 0] * 32 for _ in range(8)]
    need, done, left = [True] * 8, [False] * 8, [False] * 8
    while True:
        for w in range(8):
            if need[w] and not done[w]:
                for t in range(32):
                    if rem[w][t] == 0 and more[w][t]:
                        more[w][t] = nxt < n
                        if nxt < n:
                            rem[w][t] = rays[nxt]
                        nxt += 1
                done[w] = not any(rem[w])
                left[w] = any(more[w])
        running = [not done[w] and any(rem[w]) for w in range(8)]
        if not any(running):
            return trips
        for w in range(8):
            need[w] = False
            if running[w]:
                trips += 1
                rem[w] = [v - 1 if v else 0 for v in rem[w]]
                busy = sum(1 for v in rem[w] if v)
                need[w] = busy == 0 or (left[w] and busy <= eb.MARCH_REFILL_AT)


@pytest.mark.parametrize("case", ["hg_iw_rpv", "tab_iw_albedo"])
def test_marching_stage_runs_and_queue(case):
    """The marching stage's queue on a marching plan over a surface: per run
    of T tiles the emitting hits (every hit under RPV, the revived ones over
    an albedo) and rays (x the two upward detectors), counted lane by lane;
    the flushes (at most SURFACE_QUEUE - 256 records queued after a round of
    256 exits); the rays' steps equal to the plain stage's marching census;
    and the ray loop's thread slots equal to plain_trips on each flush's rays
    (record by record toward detector 0, then toward detector 1)."""
    integ = ms.case_integrator(case, "cpu")
    for spec, pro, st, buf, u, u_iw, alive in stage_inputs(integ, 4 * LANES, blocks=2):
        assert spec.det.march_steps > 0
        with eb.march_census(lane_steps=True) as cen:
            eb.resolve_surface(spec, pro, st.clone(), buf.clone(), u, u_iw)
        steps = cen["lane_steps"]
        emit = steps[0] > 0
        assert len(steps) == 2 and torch.equal(emit, steps[1] > 0)
        for T in (1, 2, eb.SURFACE_MAX_TILES):
            c = surface_census(spec, pro, st, buf, u, u_iw, alive, tiles=T)
            q = c["queue"]
            per_run = 256 * T
            lanes = emit.nonzero()[:, 0].tolist()
            hits = Counter(i // per_run for i in lanes)
            assert q["runs"] == -(-LANES // per_run) and q["tiles"] == T
            assert q["emitting_hits"] == {"sum": len(lanes), "max": max(hits.values())}
            assert q["rays"] == {"sum": 2 * len(lanes), "max": 2 * max(hits.values())}
            assert c["emitting_hits"] == len(lanes) and q["steps"] == cen["steps"]
            # The flushes, run by run: exits in lane order, rounds of 256.
            exits = (st.i[PK] != 0).nonzero()[:, 0].tolist()
            slots = flushes = 0
            for r in range(q["runs"]):
                ran = [i for i in exits if i // per_run == r]
                queue = []
                for k in range(0, len(ran), 256):
                    queue += [i for i in ran[k:k + 256] if emit[i]]
                    if len(queue) > eb.SURFACE_QUEUE - 256 or k + 256 >= len(ran):
                        if queue:
                            rays = [int(s[i]) for s in steps for i in queue]
                            slots += 32 * plain_trips(rays)
                            flushes += 1
                        queue = []
            assert q["flushes"] == flushes and q["slots"] == slots, (q, flushes, slots)
            assert 0.0 < q["lane_use"] <= 1.0 and c["loop_queue"] == q["lane_use"]
