"""The port's general kernel on its own (the plain version of the general
event block on the CPU; the CUDA kernel in the tests marked ``cuda``):

  * the discrete-ordinates oracle (tests/disort_oracle.py hg_slab_fluxes)
    for the conservative and the absorbing slabs of
    tests/test_external_validation.py:82-115, in ray tracing, maximum
    cross-section and on super-voxel majorants: within 4 binomial sigma;
  * Beer-Lambert (bench.py:396-420's ssa 0 slab): Fdn within 5 sigma of
    exp(-tau / mu0);
  * closure: a conservative scene over a black surface without roulette
    leaks nothing, Fup + Fdn = 1 within 1e-5 (float32 column sums) with
    n_bad = 0;
  * the dispatch, the variants' draws, the refusals (radiance detectors on
    a workload without a fastpath plan name ROADMAP item 16b), the FIFO
    refill (every photon of the budget launched once), the netCDF record of
    ray tracing.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from i3rc_tpu_torch import (Domain, Integrator, IntegratorConfig, PhaseFunction,
                            PhaseFunctionTable, PhotonSource, batch_key,
                            henyey_greenstein_coefficients, make_step_cloud)
from i3rc_tpu_torch.drivers.monte_carlo_driver import run_from_namelist
from i3rc_tpu_torch.kernels import general_block as gb
from i3rc_tpu_torch.models.step_cloud import write_domains

torch.set_num_threads(2)
# The oracle by path: the CUDA-marked tests run without the conftest, where
# a "tests" package elsewhere on the path can shadow this directory.
_spec = importlib.util.spec_from_file_location("disort_oracle",
                                               Path(__file__).with_name("disort_oracle.py"))
_oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_oracle)
hg_slab_fluxes = _oracle.hg_slab_fluxes
SRC = PhotonSource.directional(0.5, 0.0)


def slab(tau: float, ssa: float, n_layers: int = 1) -> Domain:
    """tests/test_external_validation.py's slab (models/slab.py): 500 m x
    500 m x 250 m, HG g = 0.85 from 64 moments."""
    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(0.85, 64))], key=[1.0])
    ext = np.full((1, 1, n_layers), tau / 250.0)
    return Domain.create([0.0, 500.0], [0.0, 500.0], np.linspace(0.0, 250.0, n_layers + 1)) \
        .add_component("slab", ext, np.full_like(ext, ssa), np.zeros(ext.shape, np.int32), table)


MODES = {"rt": dict(use_ray_tracing=True),
         "maxcs": dict(use_ray_tracing=False),
         "woodcock": dict(use_ray_tracing=False, majorant_block_size=16)}


@pytest.mark.parametrize("tau,ssa,mu0,mode", [
    (1.0, 1.0, 0.5, "rt"), (1.0, 1.0, 0.5, "maxcs"), (1.0, 1.0, 0.5, "woodcock"),
    (2.0, 0.99, 0.5, "woodcock"), (1.0, 0.9, 1.0, "rt"), (1.0, 0.9, 0.5, "maxcs"),
])
def test_slab_matches_the_oracle(tau, ssa, mu0, mode):
    n = 1 << 14
    cfg = IntegratorConfig(max_events=2000, compute_volume_absorption=False,
                           use_fastpath=False, **MODES[mode])
    integ = Integrator.create(slab(tau, ssa, 4), cfg, device="cpu")
    res = integ.batch_fn(PhotonSource.directional(mu0, 0.0), n)(batch_key(3, 0))
    r_ex, t_ex = hg_slab_fluxes(tau, ssa, 0.85, mu0, n_legendre=64)
    sigma = np.sqrt(max(r_ex * (1 - r_ex), t_ex * (1 - t_ex)) / n)
    assert float(res.mean_flux_up) == pytest.approx(r_ex, abs=4 * sigma)
    assert float(res.mean_flux_down) == pytest.approx(t_ex, abs=4 * sigma)
    assert float(res.mean_flux_absorbed) == pytest.approx(1 - r_ex - t_ex, abs=4 * sigma)
    assert int(res.n_bad) <= 1e-3 * n


def test_beer_lambert():
    n = 1 << 15
    integ = Integrator.create(slab(1.0, 0.0, 4), IntegratorConfig(use_ray_tracing=False,
                                                                  max_events=100),
                              device="cpu")
    assert integ._fast_plan is None
    res = integ.batch_fn(PhotonSource.directional(0.8, 0.0), n)(batch_key(7, 0))
    expect = float(np.exp(-1.0 / 0.8))
    sigma = np.sqrt(expect * (1 - expect) / n)
    assert float(res.mean_flux_down) == pytest.approx(expect, abs=5 * sigma)
    assert float(res.mean_flux_up) == 0.0
    # Every photon either crosses or is absorbed in the slab, by weight.
    assert float(res.mean_flux_down + res.mean_flux_absorbed) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_closure_without_loss(mode):
    cfg = IntegratorConfig(max_events=2000, use_fastpath=False, **MODES[mode])
    integ = Integrator.create(make_step_cloud(1.0), cfg, device="cpu")
    var = gb.variant(integ.batch_tracer(2048, 1024).spec, integ.device_optics)
    assert var.uniform and not var.rr and not var.bernoulli
    res = integ.batch_fn(SRC, 2048, n_lanes=1024)(batch_key(4, 0))
    assert float(res.mean_flux_up + res.mean_flux_down) == pytest.approx(1.0, abs=1e-5)
    assert int(res.n_bad) == 0 and float(res.mean_flux_absorbed) == 0.0
    # The volume tally (on by default) holds exactly the absorbed flux.
    assert float(res.volume_absorption.sum()) == 0.0


def test_every_photon_of_the_budget_is_launched_once():
    """The FIFO refill at 4 wavefronts of photons: the trace ends with the
    budget spent, every photon accounted for by an exit or a death (weight
    1 over a black surface without roulette), and the loop's end flag set."""
    cfg = IntegratorConfig(use_ray_tracing=False, use_fastpath=False, max_events=2000,
                           majorant_block_size=4, general_chain=2,
                           compute_volume_absorption=False)
    integ = Integrator.create(make_step_cloud(0.9), cfg, device="cpu")
    tracer = integ.batch_tracer(4 * 512 + 37, 512)
    assert gb.variant(tracer.spec, integ.device_optics).bernoulli
    raw = tracer(batch_key(9, 0), SRC.sample(batch_key(9, 0), 512, "cpu"), SRC)
    total = float(raw.flux_up.sum() + raw.flux_down.sum() + raw.flux_absorbed.sum())
    assert total + int(raw.n_bad) == 4 * 512 + 37
    assert raw.n_iterations % gb.GENERAL_K == 0


def test_variant_draws_follow_the_jax_layout():
    """The draws a variant takes, in wavefront.py:1189-1197's order."""
    def draws(dom, surface_albedo=0.0, **kw):
        integ = Integrator.create(dom, IntegratorConfig(use_fastpath=False, **kw),
                                  surface_albedo=surface_albedo, device="cpu")
        return gb.variant(integ.batch_tracer(64).spec, integ.device_optics).draws

    assert draws(make_step_cloud(1.0)) == ("tau", "scat", "chi")
    assert draws(make_step_cloud(0.99), use_ray_tracing=False) == \
        ("tau", "scat", "chi", "accept", "rr")
    assert draws(make_step_cloud(1.0), surface_albedo=0.2, use_ray_tracing=False) == \
        ("tau", "scat", "chi", "accept", "srf_mu", "srf_phi", "rr")
    assert draws(make_step_cloud(0.9), use_ray_tracing=False, majorant_block_size=4,
                 general_chain=2, compute_volume_absorption=False) == \
        ("tau", "scat", "chi", "accept", "abs")


def test_detectors_without_a_fastpath_plan_name_item_16b():
    integ = Integrator.create(make_step_cloud(1.0), IntegratorConfig(), device="cpu",
                              intensity_mus=[1.0], intensity_phis=[0.0])
    assert integ._fast_plan is None
    with pytest.raises(NotImplementedError, match="item 16b"):
        integ.batch_tracer(1024)


def test_cpu_tensors_run_the_plain_version():
    """On the CPU the wrapper runs general_block_reference and launches
    nothing; the kernel refuses nothing a plan gives it."""
    integ = Integrator.create(make_step_cloud(1.0), device="cpu")
    tracer = integ.batch_tracer(1024, 256)
    spec, opt = tracer.spec, integ.device_optics
    var = gb.variant(spec, opt)
    assert gb.launch_refusal(spec, var, opt) is None
    gb.reset_launch_counters()
    key = batch_key(2, 0)
    st = gb.launch_state(spec, SRC.sample(key, 256, "cpu"), 1024)
    buf = gb.general_buffers(spec, st, 256)
    ref_st, ref_buf = st.clone(), buf.clone()
    gb.general_block(spec, var, opt, integ.tables, st, buf, key, SRC, 0)
    gb.general_block_reference(spec, var, opt, integ.tables, ref_st, ref_buf, key, SRC, 0)
    assert torch.equal(st.f, ref_st.f) and torch.equal(st.i, ref_st.i)
    assert torch.equal(buf.columns, ref_buf.columns) and gb.general_block.launches == 0


def test_driver_runs_ray_tracing_and_records_it(tmp_path):
    write_domains(str(tmp_path))
    nml = tmp_path / "rt.nml"
    nml.write_text(f"""
&radiativeTransfer
  solarFlux = 1., solarMu = 0.5, solarAzimuth = 0.
/
&monteCarlo
  numPhotonsPerBatch = 1024, numBatches = 2, iseed = 3
/
&algorithms
  useRayTracing = .true.
/
&fileNames
  domainFileName = "{tmp_path}/StepCloud_NonAbsorbing.opt",
  outputFluxFile = "{tmp_path}/f.out", outputNetcdfFile = "{tmp_path}/o.nc"
/
""")
    out = run_from_namelist(str(nml), quiet=True, device="cpu")
    (fup, _), (fdn, _), _ = out["mean_stats"]
    assert out["cfg"]["use_ray_tracing"] and fup + fdn == pytest.approx(1.0, abs=2e-3)
    with netcdf_file(str(tmp_path / "o.nc"), "r", mmap=False) as nc:
        assert nc.Algorithm == b"Ray_tracing"


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


# Live lanes of a sparse state's tiles of 256 lanes, tile c taking entry c % 7.
SPARSE_LIVE = (0, 1, 31, 32, 33, 256, 97)


def sparse(spec, st, launched: int, kb: int):
    """A state built from ``st``: tile c of 256 lanes keeps SPARSE_LIVE[c %
    7] of its lanes alive at seeded slots (the last tile is partial), the
    others dead; its buffers with ``launched`` photons launched."""
    L = st.n_lanes
    rng = np.random.default_rng(7)
    live = np.zeros(L, bool)
    for c in range(-(-L // 256)):
        lo, hi = 256 * c, min(L, 256 * (c + 1))
        live[lo + rng.choice(hi - lo, min(SPARSE_LIVE[c % 7], hi - lo), replace=False)] = True
    out = st.clone()
    out.i[gb.ALIVE] = torch.as_tensor(live, device=st.f.device).to(torch.int32)
    return out, gb.general_buffers(spec, out, launched, kb)


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["mid", "sparse", "sparse_refill"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_general_kernel_matches_reference_on_gpu(mode, state):
    """One block of the CUDA kernel against its plain version, two blocks
    into a trace of the absorbing step cloud over an albedo (``mid``), and
    on that state made sparse: tiles of 0, 1, 31, 32, 33, 256 and 97 live
    lanes and a partial last tile, with the budget spent (the kernel runs
    several tiles a CTA) and with 300 photons left to refill.  The lane
    state, control state and dead counts bit for bit, the tallies within
    1e-9."""
    dev = need_card()
    cfg = IntegratorConfig(max_events=500, use_fastpath=False, **MODES[mode])
    integ = Integrator.create(make_step_cloud(0.99), cfg, surface_albedo=0.2, device=dev)
    L = (1 << 14) + 77
    tracer = integ.batch_tracer(4 * L, L)
    spec, opt, tables = tracer.spec, integ.device_optics, integ.tables
    var = gb.variant(spec, opt)
    key = batch_key(5, 1)
    st = gb.launch_state(spec, SRC.sample(key, L, dev), 4 * L)
    buf = gb.general_buffers(spec, st, L)
    for kb in range(2):
        gb.general_block(spec, var, opt, tables, st, buf, key, SRC, kb)
    if state != "mid":
        st, buf = sparse(spec, st, 4 * L - (300 if state == "sparse_refill" else 0), 2)
    ref_st, ref_buf = st.clone(), buf.clone()
    gb.general_block(spec, var, opt, tables, st, buf, key, SRC, 2)
    gb.general_block_reference(spec, var, opt, tables, ref_st, ref_buf, key, SRC, 2)
    torch.cuda.synchronize()
    assert torch.equal(st.f, ref_st.f) and torch.equal(st.i, ref_st.i)
    assert torch.equal(buf.ctl, ref_buf.ctl) and torch.equal(buf.dead, ref_buf.dead)
    scale = float(ref_buf.columns.abs().max())
    assert float((buf.columns - ref_buf.columns).abs().max()) <= 1e-9 * scale
