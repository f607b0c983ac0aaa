"""Scenes of the table modes of the fastpath (phase functions that are not
exactly Henyey-Greenstein), built with either package's classes
(``host(pkg)`` of tests/general_oracles.py): the JAX package's own gate
scenes (tests/test_fastpath.py) and the full-width scenes that
``chip_smoke.py`` drives.

Imports neither jax nor the JAX package: ``chip_smoke.py`` and the tests
marked ``cuda`` load it on the card's machine.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np

_spec = importlib.util.spec_from_file_location("general_oracles",
                                               Path(__file__).with_name("general_oracles.py"))
_oracles = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_oracles)
host = _oracles.host

# The entries of the column-properties scenes (tests/test_fastpath.py:618-668).
PROPS_G = (0.5, 0.7, 0.85)


def _mod(h, name):
    return importlib.import_module(f"{h.pkg}.{name}")


def c1_table(h):
    """The Dermendjian C.1 table of the radar case, one tabulated entry."""
    c1 = _mod(h, "models.radar_cloud").load_c1_tabulated()
    return h.PhaseFunctionTable.from_phase_functions([c1], key=[1.0])


def c1_slab(h, nz: int = 4, ssa: float = 1.0):
    """tests/test_fastpath.py:199: a C.1 slab of optical depth 2 over 250 m."""
    dom = h.Domain.create([0, 500.0], [0, 500.0], np.linspace(0, 250, nz + 1))
    ext = np.full((1, 1, nz), 2.0 / 250.0)
    return dom.add_component("cloud", ext, np.full_like(ext, ssa),
                             np.zeros(ext.shape, np.int32), c1_table(h))


def c1_gas_slab(h, nz: int = 4):
    """tests/test_fastpath.py:490-530: the C.1 slab plus a uniform gas of
    optical depth 0.5 (the production broadband shape)."""
    gas = _mod(h, "integrators.spectral").domain_with_gas_component
    return gas(c1_slab(h, nz), np.full(nz, 0.5 / 250.0))


def isotropic_slab(h, tau: float = 1.0, ssa: float = 1.0, nz: int = 4):
    """A slab of optical depth tau with isotropic scattering (g = 0: the
    planner takes the cubic, which is exact here, mu = 2p - 1)."""
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.0, 8))], key=[1.0])
    dom = h.Domain.create([0, 500.0], [0, 500.0], np.linspace(0, 250, nz + 1))
    ext = np.full((1, 1, nz), tau / 250.0)
    return dom.add_component("cloud", ext, np.full_like(ext, ssa),
                             np.zeros(ext.shape, np.int32), table)


def _props_table(h, gs=PROPS_G, n_legendre: int = 32):
    return h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(g, n_legendre)) for g in gs],
        key=[2.0 + 4.0 * k for k in range(len(gs))])


def column_props_scene(h):
    """tests/test_fastpath.py:618: 8 x 8 x 10 columns of one layer each from
    the base, per-column ssa in U[0.9, 1] and one of three HG entries."""
    rng = np.random.default_rng(7)
    nx = ny = 8
    nz = 10
    v = rng.uniform(0.01, 0.06, (nx, ny))
    v[1, 1] = 0.0
    ntop = rng.integers(1, nz + 1, (nx, ny))
    ssa_col = rng.uniform(0.9, 1.0, (nx, ny))
    pfi_col = rng.integers(0, 3, (nx, ny))
    ext = np.zeros((nx, ny, nz))
    ssa = np.zeros((nx, ny, nz))
    pfi = np.zeros((nx, ny, nz), np.int32)
    for i in range(nx):
        for j in range(ny):
            ext[i, j, :ntop[i, j]] = v[i, j]
            ssa[i, j, :ntop[i, j]] = ssa_col[i, j]
            pfi[i, j, :ntop[i, j]] = pfi_col[i, j]
    dom = h.Domain.create(np.linspace(0, 240, nx + 1), np.linspace(0, 240, ny + 1),
                          np.linspace(0, 120, nz + 1))
    return dom.add_component("mie", ext, ssa, pfi, _props_table(h))


def props_eligibility_scene(h):
    """tests/test_fastpath.py:957: 4 x 4 x 4, two layers, ssa 0.97, entry 1
    in column (1, 1) of a two-entry table."""
    nx = ny = nz = 4
    ext = np.zeros((nx, ny, nz))
    ssa = np.zeros((nx, ny, nz))
    pfi = np.zeros((nx, ny, nz), np.int32)
    ext[:, :, :2] = 0.02
    ssa[:, :, :2] = 0.97
    pfi[1, 1, :2] = 1
    dom = h.Domain.create(np.linspace(0, 120, nx + 1), np.linspace(0, 120, ny + 1),
                          np.linspace(0, 60, nz + 1))
    return dom.add_component("mie", ext, ssa, pfi, _props_table(h, (0.5, 0.8), 16))


def c1_step_cloud(h, ssa: float = 1.0):
    """The I3RC step cloud's extinction (32 x 1 x 32, optical depth 2 and
    18) with the C.1 table in place of HG."""
    base = _mod(h, "models.step_cloud").make_step_cloud(ssa)
    comp = base.components[0]
    dom = h.Domain.create(base.x_edges, base.y_edges, base.z_edges)
    return dom.add_component("cloud: C.1", comp.extinction, comp.single_scattering_albedo,
                             comp.phase_function_index, c1_table(h))


def landsat_props(h, conservative: bool = False, seed: int = 11):
    """The I3RC Landsat extinction (128 x 128 x 119) with per-column
    properties: an ssa from a seeded U[0.99, 1] (1 everywhere when
    ``conservative``) and one of three HG-Legendre entries (g = 0.5, 0.7,
    0.85) keyed by the tercile of the column's optical depth."""
    base = _mod(h, "models.landsat_cloud").make_landsat_cloud(1.0)
    ext = base.components[0].extinction
    dz = np.diff(np.asarray(base.z_edges, np.float64))
    tau = (ext * dz[None, None, :]).sum(axis=2)
    cloudy = tau > 0.0
    edges = np.quantile(tau[cloudy], [1.0 / 3.0, 2.0 / 3.0])
    pfi_col = np.searchsorted(edges, tau, side="right").astype(np.int32)
    rng = np.random.default_rng(seed)
    ssa_col = np.ones(tau.shape) if conservative else rng.uniform(0.99, 1.0, tau.shape)
    ssa = np.repeat(ssa_col[:, :, None], ext.shape[2], axis=2)
    pfi = np.repeat(pfi_col[:, :, None], ext.shape[2], axis=2)
    dom = h.Domain.create(base.x_edges, base.y_edges, base.z_edges)
    return dom.add_component("cloud: Landsat, per-column properties", ext, ssa, pfi,
                             _props_table(h, PROPS_G, 299))


def c1_grid(h, nx: int = 8, ny: int = 1, ssa: float = 1.0, gas: bool = False, nz: int = 8):
    """A separable C.1 cloud: extinction 0.004 / 0.02 per m in the x halves
    of layers 1 .. nz - 2 of a 500 x 500 x 400 m box, ``ny`` y columns (a
    slab in y: tracked when ny > 1), with a layered gas when ``gas``."""
    fx = np.where(np.arange(nx) < nx // 2, 0.004, 0.02)
    fz = np.zeros(nz)
    fz[1:nz - 1] = 1.0
    ext = fx[:, None, None] * np.ones((1, ny, 1)) * fz[None, None, :]
    dom = h.Domain.create(np.linspace(0, 500.0, nx + 1), np.linspace(0, 500.0, ny + 1),
                          np.linspace(0, 400.0, nz + 1))
    dom = dom.add_component("cloud: C.1", ext, np.full_like(ext, ssa),
                            np.zeros(ext.shape, np.int32), c1_table(h))
    if not gas:
        return dom
    profile = np.concatenate([np.full(nz // 2, 1e-3), np.full(nz - nz // 2, 2e-4)])
    return _mod(h, "integrators.spectral").domain_with_gas_component(dom, profile)


def c1_columns(h, ssa: float = 1.0):
    """The column-properties scene's columns with the single C.1 entry and
    a uniform ssa: a single-entry table in column media."""
    dom = column_props_scene(h)
    comp = dom.components[0]
    ext = comp.extinction
    base = h.Domain.create(dom.x_edges, dom.y_edges, dom.z_edges)
    return base.add_component("cloud: C.1", ext, np.where(ext > 0.0, ssa, 0.0),
                              np.zeros(ext.shape, np.int32), c1_table(h))


CFG_KW = dict(use_ray_tracing=False, max_events=500, compute_volume_absorption=False)
# Detector sets: exact (2), Iwabuchi sized for 8 (3), Iwabuchi sized for 16 (9).
DET_SETS = {"exact": ([0.5, -0.5], [0.0, 30.0], False),
            "iw": ([1.0, 0.5, 0.5], [0.0, 0.0, 180.0], True),
            "iw16": ([0.5] * 9, [40.0 * d for d in range(9)], True)}


def table_cases() -> dict:
    """Small scenes that together run every table instantiation of the event
    block: name -> (domain builder of a host, config keywords, Integrator.create
    keywords).  Flux at chain depth 0-3, detectors (exact, Iwabuchi sized for
    8 and for 16 detectors; a tally of <= 751 bins in the warps' slices, and
    a wide one of 1024 and more), each absorbing or not, y tracked or not, with and
    without the gas channel; column media at chain 0-3, absorbing or not
    (per-column properties at even depths, the single C.1 entry at odd)."""
    cases = {}
    for gas in (False, True):
        for ssa in (1.0, 0.99):
            for ny in (1, 4):
                tag = f"{'gas_' if gas else ''}ssa{ssa}_ny{ny}"
                for chain in range(4):
                    cases[f"flux_c{chain}_{tag}"] = (
                        lambda h, s=ssa, y=ny, g=gas: c1_grid(h, 8, y, s, g),
                        dict(CFG_KW, fastpath_chain=chain), {})
                for est, (mus, phis, iw) in DET_SETS.items():
                    for wide in (False, True):
                        nx = (512 if ny == 1 else 128) if wide else 8
                        cfg = dict(CFG_KW, use_russian_roulette_for_intensity=iw, zeta_min=0.3)
                        cases[f"det_{est}{'_wide' if wide else ''}_{tag}"] = (
                            lambda h, s=ssa, y=ny, g=gas, n=nx: c1_grid(h, n, y, s, g), cfg,
                            dict(intensity_mus=mus, intensity_phis=phis))
    for ssa in (1.0, 0.9):
        for chain in range(4):
            if chain % 2 == 0:
                build = (lambda h: column_props_scene(h)) if ssa < 1.0 else (
                    lambda h: _conservative(column_props_scene(h), h))
            else:
                build = lambda h, s=ssa: c1_columns(h, s)
            cases[f"col_c{chain}_ssa{ssa}"] = (build, dict(CFG_KW, fastpath_chain=chain), {})
    return cases


def _conservative(dom, h):
    """The domain with every ssa set to 1 (its table entries kept)."""
    comp = dom.components[0]
    base = h.Domain.create(dom.x_edges, dom.y_edges, dom.z_edges)
    return base.add_component(comp.name, comp.extinction, np.ones_like(comp.extinction),
                              comp.phase_function_index, comp.table)


# The detector tally's slices fit the CTA's default shared memory up to this
# many bins (fast_event_block.cuh hist_room).
SLICE_BINS = 751


def instantiation(spec) -> str:
    """The template arguments (CHAIN, ABS, TY, DET, IW, GAS, COL, SLICES,
    DCAP, TAB, FK) of the event-block kernel a spec launches, as they appear
    in its mangled name."""
    det = spec.det
    iw = det is not None and det.iwabuchi
    slices = det is not None and det.n_cols * det.n <= SLICE_BINS
    dcap = 16 if iw and det.n > 8 else 8
    b = lambda v: f"Lb{int(bool(v))}E"
    return (f"ILi{spec.chain}E{b(spec.absorbing)}{b(spec.track_y)}{b(det is not None)}{b(iw)}"
            f"{b(spec.gas)}{b(spec.col)}{b(slices)}Li{dcap}E{b(spec.table)}{b(spec.fused)}E")


def trace_states(integ, source, n_photons: int, lanes: int, key, tail_alive: float = 0.15,
                 max_blocks: int = 2000):
    """(spec, pro, [(name, state, buffers, kb)]): the launch state, the state
    after two blocks ("mid") and the first state after the budget is spent
    with at most ``tail_alive`` of the lanes alive ("tail") of one trace of
    ``n_photons`` at ``lanes`` lanes, advanced by ``fused_block`` (the
    kernel on a card)."""
    from i3rc_tpu_torch.integrators.fastpath import event_spec, launch_state, prologue_spec
    from i3rc_tpu_torch.kernels.event_block import (ALIVE, SPENT, block_buffers,
                                                     fused_block)

    geom, cfg = integ.geometry, integ.config
    spec = event_spec(geom, integ._fast_plan, cfg)
    pro = prologue_spec(geom, spec, cfg, n_photons)
    dev = integ.device
    st = launch_state(geom, source.sample(key, lanes, dev), n_photons,
                      gas_key=key if spec.gas else None, weighted=spec.weighted)
    buf = block_buffers(spec, pro, st, min(lanes, n_photons))
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
    lane-state row, the flux and volume tallies, the control state and the
    dead counts agree bit for bit, the largest relative difference of the
    detector accumulators (their float64 sums run in another order), and
    the block's lanes that ran, lane-events and collisions."""
    import torch

    from i3rc_tpu_torch.kernels.event_block import fused_block, fused_block_reference

    got_st, got = st0.clone(), buf0.clone()
    ref_st, ref = st0.clone(), buf0.clone()
    fused_block(spec, pro, got_st, got, key, source, kb)
    fused_block_reference(spec, pro, ref_st, ref, key, source, kb)
    slot = (kb + 1) & 1
    acc_err = 0.0
    for a, b in ((got.acc, ref.acc), (got.srf, ref.srf)):
        if b is not None:
            scale = max(float(b.abs().max()), 1e-300)
            acc_err = max(acc_err, float((a - b).abs().max()) / scale)
    same = all(torch.equal(a, b) for a, b in (
        (got_st.f, ref_st.f), (got_st.i, ref_st.i), (got.columns, ref.columns),
        (got.vol, ref.vol), (got.ctl, ref.ctl), (got.dead[slot], ref.dead[slot])))
    # The block's work, from the plain version: lanes that ran (alive after
    # the refill), lane-events, and collisions (the growth of `orders`, a
    # refilled lane's count restarting at 0).
    ran = ref_st.i[4] > st0.i[4]
    dead0 = st0.i[0] == 0
    collisions = ref_st.i[1].sum() - (st0.i[1] * ~(dead0 & ran)).sum()
    return {"bit_equal": same, "acc_rel_err": acc_err,
            "max_abs_err": float((got_st.f - ref_st.f).abs().max()),
            "live": int(ran.sum()), "lane_events": int((ref_st.i[4] - st0.i[4]).sum()),
            "collisions": int(collisions), "kb": kb}
