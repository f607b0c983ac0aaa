"""Scenes of polarized (Stokes-vector) transport, built with either
package's classes (``host(pkg)``): the Rayleigh slab of the JAX package's
tests (tests/test_polarized.py:39-46), small cases that together launch
every instantiation of the polarized event block PZ, and the whole-block
comparison of the kernel with its plain version.

Imports neither jax nor the JAX package: ``chip_smoke.py`` and the tests
marked ``cuda`` load it on the card's machine.
"""

import importlib
from types import SimpleNamespace

import numpy as np

# The port's polarized path runs these; a config of the JAX package takes
# the same keywords (tests/test_polarized.py uses IntegratorConfig()).
CFG_KW = dict(use_ray_tracing=False, compute_volume_absorption=False)


def host(pkg: str) -> SimpleNamespace:
    """The classes of one package (``i3rc_tpu`` or ``i3rc_tpu_torch``)."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    pm = mod("core.phase_matrices")
    return SimpleNamespace(
        pkg=pkg, Domain=mod("core.optics").Domain, PhaseMatrix=pm.PhaseMatrix,
        PhaseMatrixTable=pm.PhaseMatrixTable, rayleigh_values=pm.rayleigh_matrix_values,
        Config=mod("integrators.config").IntegratorConfig,
        Source=mod("core.illumination").PhotonSource,
        Polarized=lambda: mod("integrators.polarized").PolarizedIntegrator)


def rayleigh_slab(h, tau, ssa=1.0, depol=0.0, n_layers=2, thickness=250.0):
    """A homogeneous Rayleigh slab of optical depth tau over 500 m x 500 m."""
    tab = h.PhaseMatrixTable.from_phase_matrices(
        [h.PhaseMatrix.rayleigh(depolarization=depol)], [1.0])
    dom = h.Domain.create([0.0, 500.0], [0.0, 500.0], np.linspace(0.0, thickness, n_layers + 1))
    ext = np.full((1, 1, n_layers), tau / thickness)
    return dom.add_component("rayleigh", ext, np.full_like(ext, ssa),
                             np.zeros(ext.shape, np.int32), tab)


def two_component(h, nx=1, ssa=0.99):
    """Rayleigh under a Mie cloud of two phase entries (tests/test_polarized.py
    :266-291 on an nx x 1 x 4 grid; with nx > 1 the cloud varies in x)."""
    mie = h.PhaseMatrixTable.from_phase_matrices(
        [h.PhaseMatrix.from_mie(0.55, 1.33 + 0.0j, r, n_angles=181) for r in (0.8, 2.0)],
        [1.0, 2.0])
    ray = h.PhaseMatrixTable.from_phase_matrices([h.PhaseMatrix.rayleigh()], [1.0])
    dom = h.Domain.create(np.linspace(0.0, 500.0, nx + 1), [0.0, 500.0],
                          np.linspace(0.0, 250.0, 5))
    ext = np.full((nx, 1, 4), 1.0 / 250.0)
    ext[:, :, 2:] *= np.linspace(0.2, 3.0, nx)[:, None, None]
    idx = np.zeros(ext.shape, np.int32)
    idx[:, :, 1::2] = 1
    dom = dom.add_component("rayleigh", 0.3 * np.ones_like(ext) / 250.0, np.ones_like(ext),
                            np.zeros(ext.shape, np.int32), ray)
    return dom.add_component("cloud", ext, np.full_like(ext, ssa), idx, mie)


def bench_scene(h):
    """The bench row's Rayleigh atmosphere (bench.py:340-377): depolarization
    0.03, 1 x 1 x 8 cells over 1 km x 1 km x 8 km, tau 0.4."""
    tab = h.PhaseMatrixTable.from_phase_matrices(
        [h.PhaseMatrix.rayleigh(depolarization=0.03)], [1.0])
    dom = h.Domain.create([0.0, 1000.0], [0.0, 1000.0], np.linspace(0.0, 8000.0, 9))
    ext = np.full((1, 1, 8), 0.4 / 8000.0)
    return dom.add_component("rayleigh", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32),
                             tab)


BENCH_DETECTORS = dict(intensity_mus=[0.9, 0.5], intensity_phis=[0.0, 0.0])


def mie_step_cloud(h):
    """The I3RC step cloud (32 x 1 x 32 cells over 0.5 km x 0.25 km, tau 2
    and 18 halves, ssa 1; models/step_cloud.py) with the single-sphere Mie
    phase matrix of a 10 um water drop at 0.67 um in place of HG."""
    from_module = importlib.import_module(f"{h.pkg}.models.step_cloud")
    base = from_module.make_step_cloud(1.0)
    (c,) = base.components
    tab = h.PhaseMatrixTable.from_phase_matrices(
        [h.PhaseMatrix.from_mie(0.67, 1.33 + 0.0j, 10.0)], [1.0])
    dom = h.Domain.create(base.x_edges, base.y_edges, base.z_edges)
    return dom.add_component("cloud: Mie 10 um", c.extinction, c.single_scattering_albedo,
                             c.phase_function_index, tab)


# Sixteen detectors, twelve up and four down (tests/general_scenes.py
# MANY_MUS): every collision on the Mie step cloud queues sixteen rays.
MANY_DETECTORS = dict(
    intensity_mus=[1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.5, 0.5, 0.5, 0.5,
                   -0.5, -0.7, -0.9, -0.3],
    intensity_phis=[0.0, 0.0, 30.0, 60.0, 90.0, 120.0, 150.0, 180.0, 210.0, 240.0, 270.0,
                    300.0, 0.0, 90.0, 180.0, 270.0])


# name: (domain, create keywords, config keywords, source (mu, azimuth)).
# Together: every instantiation (flux, detectors, Lambertian, both), one
# and two components, a polarized source, the event budget, the x wrap,
# and sixteen detectors on the Mie step cloud.
def pz_cases() -> dict:
    return {
        "flux_slab": (lambda h: rayleigh_slab(h, 1.0), {}, {"max_events": 200}, (0.5, 0.0)),
        "flux_two_comp_3d": (lambda h: two_component(h, nx=6), {}, {"max_events": 200},
                             (0.6, 30.0)),
        "det_depol": (lambda h: rayleigh_slab(h, 0.4, depol=0.03, n_layers=8),
                      dict(intensity_mus=[0.9, 0.5, -0.6], intensity_phis=[0.0, 0.0, 120.0]),
                      {"max_events": 200}, (0.5, 0.0)),
        "det_two_comp": (lambda h: two_component(h, nx=3),
                         dict(intensity_mus=[0.5, -0.8], intensity_phis=[0.0, 45.0]),
                         {"max_events": 200}, (0.5, 10.0)),
        "det_circular_single": (lambda h: rayleigh_slab(h, 0.2),
                                dict(intensity_mus=[-0.9, 0.7], intensity_phis=[0.0, 90.0],
                                     source_stokes=(1.0, 0.0, 0.0, 1.0)),
                                {"max_events": 1}, (0.9, 0.0)),
        "lamb_slab": (lambda h: rayleigh_slab(h, 0.5, ssa=0.95), dict(surface_albedo=0.3),
                      {"max_events": 200}, (0.6, 0.0)),
        "det_lamb": (lambda h: rayleigh_slab(h, 0.1),
                     dict(surface_albedo=0.8, intensity_mus=[0.6, -0.7],
                          intensity_phis=[0.0, 0.0]), {"max_events": 100}, (0.6, 0.0)),
        "det_16_mie_step_cloud": (mie_step_cloud, MANY_DETECTORS, {}, (0.5, 0.0)),
        "det_lamb_dipole": (lambda h: two_component(h, nx=2),
                            dict(surface_albedo=0.5, intensity_mus=[0.6, 0.6, -0.5],
                                 intensity_phis=[0.0, 135.0, 30.0],
                                 source_stokes=(1.0, 1.0, 0.0, 0.0)),
                            {"max_events": 200}, (1.0, 0.0)),
    }


def case_integrator(name: str, dev):
    """The port's PolarizedIntegrator of pz_cases()[name] on ``dev``, and its source."""
    build, kw, cfg, (mu, az) = pz_cases()[name]
    h = host("i3rc_tpu_torch")
    integ = h.Polarized().create(build(h), config=h.Config(**CFG_KW, **cfg), device=dev, **kw)
    return integ, h.Source.directional(mu, az)


def trace_states(integ, source, n_photons: int, lanes: int, key, tail_alive: float = 0.15,
                 max_blocks: int = 4000):
    """(spec, [(name, state, buffers, kb)]) of one polarized trace: the
    launch state, the state after two blocks ("mid") and the first state
    after the budget is spent with at most ``tail_alive`` of the lanes
    alive ("tail"), advanced by ``polarized_block`` (the kernel on a card)."""
    from i3rc_tpu_torch.integrators import polarized as pz
    from i3rc_tpu_torch.kernels.event_block import SPENT
    from i3rc_tpu_torch.kernels.polarized_block import polarized_block

    spec = integ.spec(n_photons)
    st = pz.launch_state(spec, source.sample(key, lanes, integ.device), n_photons)
    buf = pz.polarized_buffers(spec, st, min(lanes, n_photons))
    out = [("launch", st.clone(), buf.clone(), 0)]
    for kb in range(max_blocks):
        if kb == 2:
            out.append(("mid", st.clone(), buf.clone(), kb))
        if kb > 2 and int(buf.ctl[SPENT]) >= 0 and \
                float((st.i[pz.ALIVE] != 0).float().mean()) <= tail_alive:
            out.append(("tail", st.clone(), buf.clone(), kb))
            break
        polarized_block(spec, st, buf, key, source, kb)
    else:
        raise AssertionError("the trace never reached its tail")
    return spec, out


def block_vs_twin(spec, st0, buf0, key, source, kb: int) -> dict:
    """One block of the kernel against ``polarized_block_reference`` from the
    same state, with the tallies zeroed first: whether every lane-state row,
    the control state and the dead counts agree bit for bit, the largest
    absolute difference of the float64 tallies (their sums run in another
    order on the card), and the block's live lanes, lane-events, collisions
    and estimate rays and rounds."""
    import torch

    from i3rc_tpu_torch.integrators import polarized as pz
    from i3rc_tpu_torch.kernels.polarized_block import polarized_block

    zero = buf0.clone()
    zero.columns.zero_()
    zero.intensity.zero_()
    got_st, got = st0.clone(), zero.clone()
    ref_st, ref = st0.clone(), zero.clone()
    polarized_block(spec, got_st, got, key, source, kb)
    pz.polarized_block_reference(spec, ref_st, ref, key, source, kb)
    slot = (kb + 1) & 1
    tally_err = max(float((a - b).abs().max()) if b.numel() else 0.0
                    for a, b in ((got.columns, ref.columns), (got.intensity, ref.intensity)))
    same = all(torch.equal(a, b) for a, b in (
        (got_st.f, ref_st.f), (got_st.i, ref_st.i), (got.ctl, ref.ctl),
        (got.dead[slot], ref.dead[slot])))
    diff = lambda row: int((ref_st.i[row] - st0.i[row]).sum())
    events = ref_st.i[pz.EVCT] - st0.i[pz.EVCT]
    refilled = (st0.i[pz.ALIVE] == 0) & (events > 0)
    return {"bit_equal": same, "tally_abs_err": tally_err,
            "max_abs_err": float((got_st.f - ref_st.f).abs().max()),
            "rows_differing": [r for r in range(13) if not torch.equal(got_st.f[r], ref_st.f[r])]
            + [13 + r for r in range(6) if not torch.equal(got_st.i[r], ref_st.i[r])],
            "live": int((events > 0).sum()), "lane_events": int(events.sum()),
            "collisions": int(ref_st.i[pz.ORDER].sum() - (st0.i[pz.ORDER] * ~refilled).sum()),
            "rays": diff(pz.RAYS), "rounds": diff(pz.ROUNDS), "kb": kb}
