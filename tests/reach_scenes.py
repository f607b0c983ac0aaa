"""Scenes of the kernels' reach, built with either package's classes
(``host(pkg)`` of tests/general_oracles.py): collision chains past depth 3
(the event block's runtime-depth variant), more than 16 radiance detectors
(the general kernel's estimate stage, G+E), more than 254 components with
detectors (G's ray record's 16-bit tally slot), and the sharded tracer's
sources that are not uniform in x (tests/sharded_scenes.py
``NON_UNIFORM_SOURCES``).

Imports neither jax nor the JAX package: ``chip_smoke.py`` and the tests
marked ``cuda`` load it on the card's machine.
"""

import importlib.util
from pathlib import Path

import numpy as np

_spec = importlib.util.spec_from_file_location("tabulated_scenes",
                                               Path(__file__).with_name("tabulated_scenes.py"))
ts = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ts)
host = ts.host

CFG_KW = ts.CFG_KW
# The step cloud's I3RC detectors (tests/test_torch_detectors.py) and the
# azimuth scans that widen them past the event block's 16.
I3RC_MUS, I3RC_PHIS = [1.0, 0.5, 0.5], [0.0, 0.0, 180.0]


def scan(n: int) -> tuple[list, list]:
    """The first n (<= 32) of 32 detector directions: the three I3RC ones,
    then an azimuth scan of 29 at mu = 0.7 and 0.3 in turn (the 13-direction
    scan widened to 32); a set of n is a prefix of the set of 32."""
    mus = I3RC_MUS + [0.7 if k % 2 == 0 else 0.3 for k in range(29)]
    phis = I3RC_PHIS + [360.0 * k / 29 for k in range(29)]
    return mus[:n], phis[:n]


def hg_table(h, g: float = 0.85):
    """One exact HG entry (the planner detects it: the HG variants)."""
    return h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(g, 48))], key=[1.0])


def grid(h, table, nx: int = 8, ny: int = 1, ssa: float = 1.0, gas: bool = False):
    """``tabulated_scenes.c1_grid``'s separable cloud with the given table:
    extinction 0.004 / 0.02 per m in the x halves of layers 1-6 of a 500 x
    500 x 400 m box, ``ny`` y columns, a layered gas when ``gas``."""
    nz = 8
    fx = np.where(np.arange(nx) < nx // 2, 0.004, 0.02)
    fz = np.zeros(nz)
    fz[1:nz - 1] = 1.0
    ext = fx[:, None, None] * np.ones((1, ny, 1)) * fz[None, None, :]
    dom = h.Domain.create(np.linspace(0, 500.0, nx + 1), np.linspace(0, 500.0, ny + 1),
                          np.linspace(0, 400.0, nz + 1))
    dom = dom.add_component("cloud", ext, np.full_like(ext, ssa),
                            np.zeros(ext.shape, np.int32), table)
    if not gas:
        return dom
    profile = np.concatenate([np.full(nz // 2, 1e-3), np.full(nz - nz // 2, 2e-4)])
    return ts._mod(h, "integrators.spectral").domain_with_gas_component(dom, profile)


def hg_columns(h, ssa: float):
    """The column-properties scene's columns with one HG entry and a uniform
    ssa: the HG column variant."""
    ext = ts.column_props_scene(h).components[0].extinction
    dom = ts.column_props_scene(h)
    base = h.Domain.create(dom.x_edges, dom.y_edges, dom.z_edges)
    return base.add_component("cloud", ext, np.where(ext > 0.0, ssa, 0.0),
                              np.zeros(ext.shape, np.int32), hg_table(h))


def deep_cases() -> dict:
    """Small scenes that together run every runtime-depth instantiation of
    the event block: name -> (domain builder of a host, config keywords,
    Integrator.create keywords).  Flux at chain depth 4, 5 or 6, HG or
    table (C.1), absorbing or not, y tracked or not, with and without the
    gas channel (16); column media, HG or table, absorbing or not (4)."""
    cases = {}
    k = 0
    for tab in (False, True):
        for gas in (False, True):
            for ssa in (1.0, 0.99):
                for ny in (1, 4):
                    chain = 4 + k % 3
                    k += 1
                    name = (f"{'tab_' if tab else 'hg_'}{'gas_' if gas else ''}ssa{ssa}_ny{ny}"
                            f"_c{chain}")
                    cases[name] = (
                        lambda h, t=tab, s=ssa, y=ny, g=gas: grid(
                            h, ts.c1_table(h) if t else hg_table(h), 8, y, s, g),
                        dict(CFG_KW, fastpath_chain=chain), {})
    cases["col_hg_ssa1.0_c4"] = (lambda h: hg_columns(h, 1.0),
                                 dict(CFG_KW, fastpath_chain=4), {})
    cases["col_hg_ssa0.9_c6"] = (lambda h: hg_columns(h, 0.9),
                                 dict(CFG_KW, fastpath_chain=6), {})
    cases["col_props_ssa1.0_c5"] = (lambda h: ts._conservative(ts.column_props_scene(h), h),
                                    dict(CFG_KW, fastpath_chain=5), {})
    cases["col_props_c4"] = (lambda h: ts.column_props_scene(h),
                             dict(CFG_KW, fastpath_chain=4), {})
    return cases


def deep_instantiation(spec) -> str:
    """The template arguments of the event-block kernel a spec launches, as
    in its mangled name: ``tabulated_scenes.instantiation``, with CHAIN
    -1 (``ILin1E``) past depth 3."""
    name = ts.instantiation(spec)
    return name.replace(f"ILi{spec.chain}E", "ILin1E", 1) if spec.chain > 3 else name


def split_components(h, dom, n: int):
    """The domain with its one component split into ``n`` components of
    equal optics: each 1/n of the extinction, the same albedo, phase index
    and table, so the physics is the one component's."""
    comp = dom.components[0]
    out = h.Domain.create(dom.x_edges, dom.y_edges, dom.z_edges)
    for c in range(n):
        out = out.add_component(f"{comp.name} {c}", comp.extinction / n,
                                comp.single_scattering_albedo, comp.phase_function_index,
                                comp.table)
    return out


def deep_vs_twin(name: str, device, lanes: int, seed: int = 21) -> list:
    """A case of ``deep_cases`` at ``lanes`` lanes and four times as many
    photons: the whole block (prologue, K events) of the kernel against its
    plain version at the launch, a mid-flight and a tail state
    (``tabulated_scenes.block_vs_twin``), each result with the case's
    instantiation and chain depth."""
    from i3rc_tpu_torch import PhotonSource, batch_key

    build, cfg, kw = deep_cases()[name]
    h = host("i3rc_tpu_torch")
    integ = h.Integrator.create(build(h), h.Config(**cfg), device=device, **kw)
    src = PhotonSource.directional(0.6, 30.0)
    key = batch_key(seed, 3)
    spec, pro, states = ts.trace_states(integ, src, 4 * lanes, lanes, key)
    return [dict(ts.block_vs_twin(spec, pro, st, buf, key, src, kb), state=state,
                 instantiation=deep_instantiation(spec), chain=spec.chain)
            for state, st, buf, kb in states]


def general_vs_twin(integ, source, lanes: int, key, state: str = "mid") -> dict:
    """One block of the general kernel G (with detectors, its estimate
    stage) against its plain version from the launch or a mid-flight state
    (two blocks in): the lanes whose state differs, whether the control
    state, dead counts and each lane's estimate steps and rays are equal,
    the float64 tallies' largest difference relative to their largest
    entry, and the estimate tally's highest component slot with weight."""
    import torch

    from i3rc_tpu_torch.kernels import general_block as gb

    tracer = integ.general_tracer(4 * lanes, lanes)
    spec, opt, tables = tracer.spec, integ.device_optics, integ.tables
    var = gb.variant(spec, opt)
    st = gb.launch_state(spec, source.sample(key, lanes, integ.device), 4 * lanes)
    buf = gb.general_buffers(spec, st, lanes)
    kb = 0
    if state == "mid":
        for kb in range(2):
            gb.general_block(spec, var, opt, tables, st, buf, key, source, kb)
        kb = 2
    ref_st, ref_buf = st.clone(), buf.clone()
    gb.general_block(spec, var, opt, tables, st, buf, key, source, kb)
    gb.general_block_reference(spec, var, opt, tables, ref_st, ref_buf, key, source, kb)
    if integ.device.type == "cuda":
        torch.cuda.synchronize(integ.device)
    rel = lambda a, b: (0.0 if a.numel() == 0 else
                        float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300))
    equal = all(torch.equal(getattr(buf, n), getattr(ref_buf, n))
                for n in ("ctl", "dead", "int_steps", "int_rays"))
    tally = max(rel(getattr(buf, n), getattr(ref_buf, n))
                for n in ("columns", "intensity", "by_component", "excess"))
    byc = ref_buf.by_component.reshape(-1, opt.n_components + 1)
    used = (byc.abs().sum(0) > 0).nonzero()
    return {"lanes_differ": int(((st.f != ref_st.f).any(0) | (st.i != ref_st.i).any(0)).sum()),
            "equal": equal, "tally_rel_err": tally,
            "max_abs_err": float((st.f - ref_st.f).abs().max()),
            "rays": int(ref_buf.int_rays.sum()), "steps": int(ref_buf.int_steps.sum()),
            "top_slot": int(used.max()) if used.numel() else -1,
            "n_components": opt.n_components, "n_dirs": spec.det.n if spec.det is not None else 0}
