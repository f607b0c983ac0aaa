"""Scenes of fused-k spectral batching (every k point of a band in one trace,
k a per-lane attribute), built with either package's classes (``host(pkg)``
of tests/general_oracles.py): small cases that together launch every
fused-k instantiation of the event block, the whole-block comparison of the
kernel with its plain version, and the band scene of the JAX package's
gate tests (tests/test_spectral.py:178-222) that ``chip_smoke.py`` and the
CPU tests drive.

Imports neither jax nor the JAX package: ``chip_smoke.py`` and the tests
marked ``cuda`` load it on the card's machine.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np


def _load(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_tab = _load("tabulated_scenes")
host = _tab.host
CFG_KW = _tab.CFG_KW
DET_SETS = _tab.DET_SETS
# The kernel's template arguments a spec launches (the FK flag included).
instantiation = _tab.instantiation

# Three k points over the 8 layers of the case grid (per m), bottom-heavy and
# with a clear layer, so that a step crosses layers of different gas.
CASE_PROFILES = np.array([[2e-3, 1e-3, 1e-3, 5e-4, 0.0, 2e-4, 2e-4, 1e-4],
                          [2e-2, 1e-2, 5e-3, 5e-3, 0.0, 2e-3, 1e-3, 1e-3],
                          [4e-4, 4e-4, 2e-4, 2e-4, 0.0, 1e-4, 1e-4, 1e-4]])
CASE_WEIGHTS = np.array([0.5, 0.3, 0.2])


def _mod(h, name):
    return importlib.import_module(f"{h.pkg}.{name}")


def hg_table(h, g: float = 0.85, n: int = 32):
    return h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(g, n))], key=[1.0])


def grid(h, nx: int = 8, ny: int = 1, ssa: float = 1.0, table: bool = False, nz: int = 8):
    """tabulated_scenes.c1_grid's separable cloud (the x halves of layers 1 ..
    nz - 2 of a 500 x 500 x 400 m box), with the C.1 table (``table``) or
    HG 0.85, and no gas."""
    dom = _tab.c1_grid(h, nx, ny, ssa, False, nz)
    if table:
        return dom
    comp = dom.components[0]
    base = h.Domain.create(dom.x_edges, dom.y_edges, dom.z_edges)
    return base.add_component("cloud: HG", comp.extinction, comp.single_scattering_albedo,
                              comp.phase_function_index, hg_table(h))


def with_k(h, dom, profiles, weights, **kw):
    """A fused-k integrator of ``h`` on ``dom`` plus the gas of k point 0,
    tracing every k point of (profiles (n_k, n_z), weights)."""
    gas = _mod(h, "integrators.spectral").domain_with_gas_component
    return h.Integrator.create(gas(dom, np.asarray(profiles)[0]),
                               gas_k=(np.asarray(profiles), np.asarray(weights)), **kw)


def fk_cases() -> dict:
    """Small fused-k scenes that together launch every fused-k
    instantiation: name -> (domain constructor of a host, config keywords,
    Integrator.create keywords, source kind).  Flux and detectors (exact,
    Iwabuchi sized for 8 and for 16; a tally of <= 751 bins in the warps'
    slices and a wide one), each HG or C.1, absorbing or not, y tracked or
    not; the absorbing ones with the volume tally (the exact death layer).
    Then the surface stage (an albedo under flux and under detectors) and
    an internal source, whose lanes start at their own height."""
    cases = {}
    for table in (False, True):
        t = "tab_" if table else ""
        for ssa in (1.0, 0.99):
            for ny in (1, 4):
                tag = f"ssa{ssa}_ny{ny}"
                vol = ssa < 1.0
                cases[f"{t}flux_{tag}"] = (
                    lambda h, s=ssa, y=ny, tb=table: grid(h, 8, y, s, tb),
                    dict(CFG_KW, compute_volume_absorption=vol), {}, "directional")
                for est, (mus, phis, iw) in DET_SETS.items():
                    for wide in (False, True):
                        nx = (512 if ny == 1 else 128) if wide else 8
                        cfg = dict(CFG_KW, use_russian_roulette_for_intensity=iw, zeta_min=0.3,
                                   compute_volume_absorption=vol)
                        cases[f"{t}det_{est}{'_wide' if wide else ''}_{tag}"] = (
                            lambda h, s=ssa, y=ny, n=nx, tb=table: grid(h, n, y, s, tb), cfg,
                            dict(intensity_mus=mus, intensity_phis=phis), "directional")
    cases["flux_albedo"] = (lambda h: grid(h, 8, 1, 0.99), dict(CFG_KW), dict(surface_albedo=0.3),
                            "directional")
    cases["det_albedo"] = (lambda h: grid(h, 8, 1, 1.0), dict(CFG_KW),
                           dict(surface_albedo=0.3, intensity_mus=[1.0, 0.5],
                                intensity_phis=[0.0, 0.0]), "directional")
    cases["flux_internal_volume"] = (lambda h: grid(h, 8, 1, 0.99),
                                     dict(CFG_KW, compute_volume_absorption=True), {},
                                     "internal_flux")
    return cases


def source(h, kind: str):
    """The photon source of a case."""
    return {"directional": lambda: h.Source.directional(0.5, 0.0),
            "internal_flux": lambda: h.Source.internal_flux(0.4, 0.5, 0.45, True)}[kind]()


def case_integrator(name: str, dev):
    """The fused-k integrator of fk_cases()[name] on the port."""
    build, cfg, kw, _ = fk_cases()[name]
    h = host("i3rc_tpu_torch")
    return with_k(h, build(h), CASE_PROFILES, CASE_WEIGHTS, config=h.Config(**cfg),
                  device=dev, **kw)


def fused_plan(integ):
    """The plan a fused-k integrator traces: its gas-channel plan with its
    gas_k attached."""
    from dataclasses import replace

    return replace(integ._fast_plan, gas_k=integ._gas_k)


def trace_states(integ, source, n_photons: int, lanes: int, key, tail_alive: float = 0.15,
                 max_blocks: int = 2000):
    """(spec, pro, [(name, state, buffers, kb)]) of one fused-k trace: the
    launch state, the state after two blocks ("mid") and the first state
    after every k's quota is launched with at most ``tail_alive`` of the
    lanes alive ("tail"), advanced by ``fused_block`` (the kernel on a
    card)."""
    from i3rc_tpu_torch.integrators.fastpath import (event_spec, launch_state, lane_width,
                                                     prologue_spec)
    from i3rc_tpu_torch.kernels.event_block import ALIVE, SPENT, block_buffers, fused_block

    geom, cfg = integ.geometry, integ.config
    lanes = lane_width(n_photons, lanes, integ.n_k)
    spec = event_spec(geom, fused_plan(integ), cfg, n_photons, lanes)
    pro = prologue_spec(geom, spec, cfg, n_photons)
    st = launch_state(geom, source.sample(key, lanes, integ.device), n_photons,
                      gas_key=key, weighted=spec.weighted, spec=spec)
    buf = block_buffers(spec, pro, st, spec.fk.launch_counts())
    out = [("launch", st.clone(), buf.clone(), 0)]
    for kb in range(max_blocks):
        if kb == 2:
            out.append(("mid", st.clone(), buf.clone(), kb))
        if kb > 2 and int(buf.ctl[SPENT]) >= 0 and \
                float((st.i[ALIVE] != 0).float().mean()) <= tail_alive:
            out.append(("tail", st.clone(), buf.clone(), kb))
            break
        fused_block(spec, pro, st, buf, key, source, kb)
    else:
        raise AssertionError("the trace never reached its tail")
    return spec, pro, out


def block_vs_twin(spec, pro, st0, buf0, key, source, kb: int) -> dict:
    """One whole block (prologue, K events, surface stage) of the kernel
    against ``fused_block_reference`` from the same state: whether every
    lane-state row (gcur included), the per-k control state and the dead
    counts agree bit for bit, and the largest relative difference of the
    flux, volume and detector tallies (each lane's exit carries its k's
    weight, and their float64 sums run in another order on the card), with
    the block's lanes that ran, lane-events and collisions."""
    import torch

    from i3rc_tpu_torch.kernels.event_block import fused_block, fused_block_reference

    got_st, got = st0.clone(), buf0.clone()
    ref_st, ref = st0.clone(), buf0.clone()
    fused_block(spec, pro, got_st, got, key, source, kb)
    fused_block_reference(spec, pro, ref_st, ref, key, source, kb)
    slot = (kb + 1) & 1
    tally_err = 0.0
    for a, b in ((got.columns, ref.columns), (got.vol, ref.vol), (got.acc, ref.acc),
                 (got.srf, ref.srf)):
        if b is not None and b.numel():
            scale = max(float(b.abs().max()), 1e-300)
            tally_err = max(tally_err, float((a - b).abs().max()) / scale)
    same = all(torch.equal(a, b) for a, b in (
        (got_st.f, ref_st.f), (got_st.i, ref_st.i), (got.ctl, ref.ctl),
        (got.dead[slot], ref.dead[slot])))
    ran = ref_st.i[4] > st0.i[4]
    dead0 = st0.i[0] == 0
    collisions = ref_st.i[1].sum() - (st0.i[1] * ~(dead0 & ran)).sum()
    return {"bit_equal": same, "tally_rel_err": tally_err,
            "max_abs_err": float((got_st.f - ref_st.f).abs().max()),
            "live": int(ran.sum()), "lane_events": int((ref_st.i[4] - st0.i[4]).sum()),
            "collisions": int(collisions), "kb": kb}


def beer_lambert(h, cloud=(1e-3, 1e-3, 1e-3, 1e-3), taus=(0.2, 2.0), weights=(0.6, 0.4)):
    """tests/test_spectral.py:178-222: a near-transparent HG cloud (tau 1e-3)
    in 4 layers of a 1 m box, and a band of uniform gas of optical depth
    ``taus``: (base domain, KDistribution)."""
    dom = h.Domain.create([0, 1.0], [0, 1.0], np.linspace(0, 1.0, 5))
    ext = np.asarray(cloud, np.float64).reshape(1, 1, 4)
    dom = dom.add_component("cloud", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32),
                            hg_table(h, 0.85, 16))
    z = np.asarray(dom.z_edges)
    kd = _mod(h, "core.k_distribution").KDistribution.create(
        z, np.broadcast_to(np.asarray(taus)[None, :], (4, len(taus))).copy(), list(weights),
        spectral_fraction=1.0)
    return dom, kd


def internal_closed_form(taus=(0.2, 2.0), weights=(0.6, 0.4)) -> float:
    """Fup of an upward Lambertian source at mid-height of the Beer-Lambert
    scene, where the cloud is negligible: sum_k w_k 2 E3(tau_k / 2)."""
    from scipy.special import expn

    return float(sum(w * 2.0 * expn(3, t / 2.0) for t, w in zip(taus, weights)))
