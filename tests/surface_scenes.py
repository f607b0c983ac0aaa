"""Scenes over reflecting surfaces for the fast event block's surface stage
(``fast_event_block_surface_kernel``, launched after the block's events,
FK or not), built with the port's classes: every case of
tests/tabulated_scenes.py table_cases (the table instantiations of the
event kernel), the same scenes with the Henyey-Greenstein table (the HG
ones) and the fused-k cases of tests/fused_k_scenes.py (the fused-k ones),
each over one of the five surfaces in turn (an albedo and the four uniform
BRDFs), so that together they put the stage after every event-kernel
instantiation, over every surface kind; and the whole-block comparison of
the kernels with their plain version.

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
_fk = _load("fused_k_scenes")
host = _tab.host
instantiation = _tab.instantiation
# The surfaces in turn: name -> Integrator.create keywords of the port.
SURFACES = ("albedo", "lambertian", "rpv", "cox_munk", "ross_li")
BRDF_PARAMS = {"lambertian": [0.3], "rpv": [0.2, 0.8, -0.1], "cox_munk": [5.0, 1.34],
               "ross_li": [0.1, 0.05, 0.02]}
LANES = (1 << 13) + 77           # a partial last CTA


def surface_kw(h, name: str) -> dict:
    if name == "albedo":
        return dict(surface_albedo=0.3)
    return dict(surface=h.Surface.uniform(BRDF_PARAMS[name], brdf_name=name))


def as_hg(h, dom):
    """The domain with its cloud's table replaced by HG g = 0.85 and its ssa
    made uniform (the least of the cloud's, so that an absorbing case stays
    absorbing), its extinction and gas component kept: the HG twin of a
    table case."""
    cloud = dom.components[0]
    ext = np.asarray(cloud.extinction)
    ssa = np.asarray(cloud.single_scattering_albedo)
    base = h.Domain.create(dom.x_edges, dom.y_edges, dom.z_edges)
    base = base.add_component("cloud: HG", ext, np.where(ext > 0.0, ssa[ext > 0.0].min(), 0.0),
                              np.zeros(ext.shape, np.int32), _fk.hg_table(h))
    for comp in dom.components[1:]:
        flat = (lambda a: np.asarray(a).reshape(-1)) if comp.horizontally_uniform else np.asarray
        base = base.add_component(comp.name, flat(comp.extinction),
                                  flat(comp.single_scattering_albedo),
                                  flat(comp.phase_function_index), comp.table, comp.z_level_base)
    return base


def surface_cases() -> dict:
    """name -> (domain builder of a host, config keywords, Integrator.create
    keywords, fused): the table cases, their HG twins and the fused-k cases
    (not those that already carry a surface or an internal source), the
    surface kind of each case the next of SURFACES."""
    cases, k = {}, 0
    for table in (True, False):
        for name, (build, cfg, kw) in _tab.table_cases().items():
            srf = SURFACES[k % len(SURFACES)]
            make = build if table else (lambda h, b=build: as_hg(h, b(h)))
            cases[f"{'tab' if table else 'hg'}_{name}_{srf}"] = (make, cfg, dict(kw, _srf=srf),
                                                                 False)
            k += 1
    for name, (build, cfg, kw, kind) in _fk.fk_cases().items():
        if kind != "directional" or "surface_albedo" in kw:
            continue
        srf = SURFACES[k % len(SURFACES)]
        cases[f"fk_{name}_{srf}"] = (build, cfg, dict(kw, _srf=srf), True)
        k += 1
    return cases


def case_integrator(name: str, dev):
    """The port's integrator of surface_cases()[name]."""
    build, cfg, kw, fused = surface_cases()[name]
    h = host("i3rc_tpu_torch")
    kw = dict(kw)
    kw.update(surface_kw(h, kw.pop("_srf")))
    if fused:
        return _fk.with_k(h, build(h), _fk.CASE_PROFILES, _fk.CASE_WEIGHTS,
                          config=h.Config(**cfg), device=dev, **kw)
    return h.Integrator.create(build(h), config=h.Config(**cfg), device=dev, **kw)


def trace_states(integ, source, n_photons: int, lanes: int, key, fused: bool):
    """(spec, pro, [(name, state, buffers, kb)]) of one trace of the case:
    its launch, mid-flight and tail states (fused_k_scenes.trace_states for
    a fused-k case, tabulated_scenes.trace_states for the others)."""
    mod = _fk if fused else _tab
    return mod.trace_states(integ, source, n_photons, lanes, key)


def block_vs_twin(spec, pro, st0, buf0, key, source, kb: int) -> dict:
    """One whole block (prologue, K events, surface stage) of the kernel
    against ``fused_block_reference`` from the same state: whether every
    lane-state row, the lane weight of a BRDF plan, the control state and
    the next block's dead counts agree bit for bit, and the largest relative
    difference of the flux, volume, detector and surface-radiance tallies
    (float64 sums in another order), with the block's bottom hits."""
    import torch

    from i3rc_tpu_torch.kernels.event_block import PK, fused_block, fused_block_reference

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
    pairs = [(got_st.f, ref_st.f), (got_st.i, ref_st.i), (got.ctl, ref.ctl),
             (got.dead[slot], ref.dead[slot])]
    if ref_st.w is not None:
        pairs.append((got_st.w, ref_st.w))
    same = all(torch.equal(a, b) for a, b in pairs)
    return {"bit_equal": same, "tally_rel_err": tally_err,
            "max_abs_err": float((got_st.f - ref_st.f).abs().max()),
            "srf_sum": float(ref.srf.sum()) if ref.srf is not None else None,
            "pending_after": int((got_st.i[PK] != 0).sum()), "kb": kb}
