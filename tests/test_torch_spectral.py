"""The broadband k-distribution loop and driver of the port against the JAX
package.

``i3rc_tpu_torch.integrators.spectral`` runs the baked mode: one gas-channel
integrator per k point, k point k seeded ``seed + 1000 k``, band b seeded
``seed + 100000 b``, band stderr sqrt(sum_k (w_k se_k)^2).  Held here against
the JAX baked loop (``run_band(bake_fastpath=True)``, the XLA fastpath at
unroll 1; the port's ``run_band`` runs baked by default) on a small cloud slab, and the broadband driver on the
transparent-slab scene of tests/test_drivers.py:118, whose transmission is
closed-form.  The fused-k mode is not ported and raises; the traced mode
runs the general kernel, radiance detectors included.

Tolerances: band and broadband fluxes within 4 sigma of the JAX run, sigma
of the difference of two independent weighted means; the driver's
transmission within 1e-2 relative of the closed form (~4 sigma at 2 x 20000
photons per k point).  Each side builds its domains, k-distributions and
configuration with its own classes from the same numpy arrays.
"""

import importlib
import os
import subprocess
import sys
import textwrap
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from i3rc_tpu.core.illumination import PhotonSource as JaxSource
from i3rc_tpu.drivers.broadband_driver import run_from_namelist as jax_run_bb
from i3rc_tpu.integrators import spectral as jspectral
from i3rc_tpu_torch import Integrator, PhotonSource, run_band, run_broadband
from i3rc_tpu_torch.drivers.broadband_driver import main as bb_main
from i3rc_tpu_torch.drivers.broadband_driver import run_from_namelist as run_bb
from i3rc_tpu_torch.integrators.spectral import domain_with_gas_component

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NZ, N, BATCHES, SEED = 4, 1 << 13, 2, 21
Z = np.linspace(0, 250.0, NZ + 1)


def host(pkg: str) -> SimpleNamespace:
    """One side's host layer: the port keeps its copies under the JAX
    package's module paths."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    pf, kd = mod("core.phase_functions"), mod("core.k_distribution")
    h = SimpleNamespace(
        Domain=mod("core.optics").Domain, PhaseFunction=pf.PhaseFunction,
        PhaseFunctionTable=pf.PhaseFunctionTable, hg=pf.henyey_greenstein_coefficients,
        KDistribution=kd.KDistribution, write_k_distribution=kd.write_k_distribution,
        write_domain=mod("io.netcdf").write_domain,
        cfg=mod("integrators.config").IntegratorConfig(
            use_ray_tracing=False, max_events=500, compute_volume_absorption=False))
    h.kds = [h.KDistribution.create(
                 Z, np.broadcast_to([[0.2 / 250, 1.0 / 250]], (NZ, 2)).copy(), [0.6, 0.4],
                 wavelength_limits=(0.5, 0.7), spectral_fraction=0.7),
             h.KDistribution.create(
                 Z, np.broadcast_to([[0.05 / 250, 2.0 / 250]], (NZ, 2)).copy(), [0.5, 0.5],
                 wavelength_limits=(1.5, 1.7), spectral_fraction=0.3)]
    return h


JAX, PORT = host("i3rc_tpu"), host("i3rc_tpu_torch")
CFG, KDS = PORT.cfg, PORT.kds


def _table(h, n=64):
    return h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(0.85, n))], key=[1.0])


def cloud_slab(h=PORT):
    dom = h.Domain.create([0, 500.0], [0, 500.0], Z)
    ext = np.full((1, 1, NZ), 2.0 / 250.0)
    return dom.add_component("cloud", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32),
                             _table(h))


def means(res):
    return {"fup": res.mean_flux_up, "fdn": res.mean_flux_down,
            "fabs": res.mean_flux_absorbed}


@pytest.fixture(scope="module")
def jax_broadband():
    """The JAX baked broadband loop over both bands (XLA fastpath, unroll 1)."""
    return jspectral.run_broadband(
        cloud_slab(JAX), JAX.kds, JaxSource.directional(0.5, 0.0), N, BATCHES, seed=SEED,
        config=replace(JAX.cfg, fastpath_unroll=1), bake_fastpath=True, derive=means)


def _sigma(kds, n):
    """Sigma of the difference of two weighted mean fluxes (F(1-F) <= 1/4)."""
    var = sum((kd.spectral_fraction * w) ** 2 * 0.25 / n for kd in kds for w in kd.weights)
    return (2 * var) ** 0.5


def _band_integrator(kd):
    return Integrator.create(domain_with_gas_component(cloud_slab(),
                                                       kd.absorption_profiles_on(Z)[:, 0]),
                             config=CFG, device="cpu")


def test_run_band_matches_jax_and_stderr(jax_broadband):
    """Band 0 through the port's run_band (baked) against the JAX band; its
    stderr is exactly sqrt(sum_k (w_k se_k)^2) of its per-k statistics."""
    kd = KDS[0]
    band = run_band(_band_integrator(kd), cloud_slab(), kd, PhotonSource.directional(0.5, 0.0),
                    N, BATCHES, seed=SEED, derive=means)
    jband = jax_broadband[1][0]
    sigma = _sigma([replace(kd, spectral_fraction=1.0)], N * BATCHES)
    for k in ("fup", "fdn", "fabs"):
        assert float(band.mean["derived"][k]) == pytest.approx(
            float(jband.mean["derived"][k]), abs=4 * sigma), k
    d = band.mean["derived"]
    assert float(d["fup"] + d["fdn"] + d["fabs"]) == pytest.approx(1.0, abs=1e-5)
    assert len(band.per_k) == kd.n_k
    for k in ("fup", "fdn", "fabs"):
        want = sum((w * st.stderr["derived"][k]) ** 2
                   for w, st in zip(kd.weights, band.per_k)) ** 0.5
        assert float(band.stderr["derived"][k]) == pytest.approx(float(want), rel=1e-12)
        mean = sum(w * st.mean["derived"][k] for w, st in zip(kd.weights, band.per_k))
        assert float(band.mean["derived"][k]) == pytest.approx(float(mean), rel=1e-12)
    assert band.wavelength_limits == kd.wavelength_limits


def test_run_broadband_matches_jax(jax_broadband):
    """Both bands: the broadband mean is the spectral-fraction-weighted sum of
    the band means, and agrees with the JAX broadband within 4 sigma."""
    cache = {}
    bb, bands = run_broadband(cloud_slab(), KDS, PhotonSource.directional(0.5, 0.0), N,
                              BATCHES, seed=SEED, config=CFG, derive=means,
                              integrator_cache=cache, device="cpu")
    jbb = jax_broadband[0]
    sigma = _sigma(KDS, N * BATCHES)
    for k in ("fup", "fdn", "fabs"):
        assert float(bb["derived"][k]) == pytest.approx(float(jbb["derived"][k]),
                                                        abs=4 * sigma), k
        want = sum(b.spectral_fraction * b.mean["derived"][k] for b in bands)
        assert float(bb["derived"][k]) == pytest.approx(float(want), rel=1e-12)
    assert bb["results"].flux_up.shape == (1, 1)
    # One cached integrator per (band, k point), with the k point's gas baked.
    plans = [v[0]._fast_plan for v in cache.values()]
    assert len(plans) == 4 and all(p.gas_factor is not None for p in plans)
    # (to the float32 rounding of the component fractions the planner reads)
    assert sorted(p.gas_factor.values[0] for p in plans) == pytest.approx(sorted(
        float(v) for kd in KDS for v in kd.absorption_profiles[0]), rel=1e-5)


def test_unported_modes_raise():
    """An unknown mode still raises; the fused mode (ROADMAP item 13b) runs:
    64 photons a k point trace as one band sample at the fused lane width
    (a CTA per k point), closing, with no per-k statistics."""
    kd = KDS[0]
    integ = _band_integrator(kd)
    src = PhotonSource.directional(0.5, 0.0)
    band = run_band(integ, cloud_slab(), kd, src, 64, 2, mode="fused", derive=means)
    d = band.mean["derived"]
    assert band.per_k == [] and band.wavelength_limits == kd.wavelength_limits
    assert float(d["fup"] + d["fdn"] + d["fabs"]) == pytest.approx(1.0, abs=1e-5)
    assert int(band.mean["results"].n_photons) == 64 * kd.n_k
    with pytest.raises(ValueError, match="spectral mode"):
        run_band(integ, cloud_slab(), kd, src, 64, 2, mode="warp")


def test_traced_band_radiance_matches_jax():
    """run_band(mode="traced") with two detectors: each k point's optics
    through the band integrator's general kernel, its local estimate
    included, against the JAX package's traced band (the step cloud 32 x 8
    on 4-cell super-voxels with a gas of k = 2e-4 and 2e-3): each k point's
    mean radiances within 4 combined standard errors of the batch means."""
    from tests.general_cases import JAX as JH
    from tests.general_cases import PORT as TH
    from tests.general_scenes import step_cloud_32x8

    z = np.asarray(step_cloud_32x8(TH).z_edges)
    det = dict(intensity_mus=[1.0, 0.5], intensity_phis=[0.0, 180.0])
    cfg = dict(use_ray_tracing=False, max_events=500, compute_volume_absorption=False,
               majorant_block_size=4)
    derive = lambda r: {"rad": r.mean_intensity}
    bands = {}
    for h in (JH, TH):
        kd_mod = importlib.import_module(f"{h.pkg}.core.k_distribution")
        kd = kd_mod.KDistribution.create(z, np.broadcast_to([[2e-4, 2e-3]], (8, 2)).copy(),
                                         [0.8, 0.2], wavelength_limits=(0.5, 0.7),
                                         spectral_fraction=0.9)
        spec = importlib.import_module(f"{h.pkg}.integrators.spectral")
        dom = step_cloud_32x8(h, 1.0)
        gas = spec.domain_with_gas_component(dom, kd.absorption_profiles_on(z)[:, 0])
        src = h.Source.directional(0.5, 0.0)
        if h.pkg == "i3rc_tpu":
            integ = h.Integrator.create(gas, config=h.Config(**cfg, use_queued_intensity=False),
                                        **det)
            bands[h.pkg] = spec.run_band(integ, dom, kd, src, 1024, 4, seed=5, derive=derive)
        else:
            integ = h.Integrator.create(gas, config=h.Config(**cfg), device="cpu", **det)
            bands[h.pkg] = run_band(integ, dom, kd, src, 1024, 4, seed=5, derive=derive,
                                    mode="traced", n_lanes=1024)
    jb, tb = bands["i3rc_tpu"], bands["i3rc_tpu_torch"]
    assert len(tb.per_k) == len(jb.per_k) == 2
    for js, ts in zip(jb.per_k, tb.per_k):
        jm, je = (np.asarray(js.mean["derived"]["rad"]), np.asarray(js.stderr["derived"]["rad"]))
        tm, te = ts.mean["derived"]["rad"].numpy(), ts.stderr["derived"]["rad"].numpy()
        assert np.all(tm > 0.0) and np.all(np.abs(jm - tm) <= 4 * np.hypot(je, te)), (jm, tm)


# The transparent-slab scene of tests/test_drivers.py:118.
TAUS = {0: np.array([0.2, 2.0]), 1: np.array([0.05, 0.8])}
WEIGHTS = {0: np.array([0.6, 0.4]), 1: np.array([0.5, 0.5])}
FRACTIONS = {0: 0.7, 1: 0.3}


def _transparent_inputs(tmp_path, mode="auto", algorithms="useRayTracing = .false., "
                                                          "maxEvents = 100", photons=20000):
    dom = PORT.Domain.create([0, 1.0], [0, 1.0], np.linspace(0, 1.0, 5))
    ext = np.full((1, 1, 4), 1e-3)
    dom = dom.add_component("cloud", ext, np.ones_like(ext), np.zeros(ext.shape, np.int32),
                            _table(PORT, 16))
    PORT.write_domain(dom, str(tmp_path / "slab.dom"))
    z = np.linspace(0.0, 1.0, 5)
    for b in (0, 1):
        kd = PORT.KDistribution.create(z, np.broadcast_to(TAUS[b][None, :], (4, 2)).copy(),
                                       WEIGHTS[b], wavelength_limits=(0.5 + b, 0.7 + b),
                                       spectral_fraction=FRACTIONS[b])
        PORT.write_k_distribution(kd, str(tmp_path / f"band{b}.kd"))
    nml = tmp_path / "bb.nml"
    nml.write_text(textwrap.dedent(f"""
    &radiativeTransfer
      solarFlux = 1., solarMu = 0.5, solarAzimuth = 0.,
      intensityMus = 1.0, 0.5, intensityPhis = 0., 0.,
    /
    &monteCarlo
      numPhotonsPerBatch = {photons}, numBatches = 2, iseed = 7
    /
    &algorithms
      {algorithms}
    /
    &fileNames
      domainFileName = "{tmp_path}/slab.dom",
      outputFluxFile = "{tmp_path}/bb_flux.out",
      outputRadFile = "{tmp_path}/bb_rad.out",
      outputAbsProfFile = "{tmp_path}/bb_prof.out",
      outputNetcdfFile = "{tmp_path}/bb.nc"
    /
    &output
      reportAbsorptionProfile = .true.
    /
    &spectral
      kDistributionFiles = "{tmp_path}/band0.kd", "{tmp_path}/band1.kd",
      spectralMode = "{mode}"
    /
    """))
    return str(nml)


@pytest.mark.parametrize("mode", ["auto", "baked"])
def test_broadband_driver_transparent_slab(tmp_path, mode):
    """Closed-form broadband transmission T = sum_b f_b sum_k w_bk
    exp(-tau_bk / mu0), closure, the absorption profile integrating to Fabs,
    and the four output files; "auto" runs this small band fused, "baked"
    one integrator per k point."""
    assert bb_main([_transparent_inputs(tmp_path, mode=mode), "--device", "cpu"]) == 0
    for f in ("bb_flux.out", "bb_rad.out", "bb_prof.out", "bb.nc"):
        assert (tmp_path / f).is_file(), f
    out = run_bb(_transparent_inputs(tmp_path, mode=mode), quiet=True, device="cpu")
    assert all((band.per_k == []) == (mode == "auto") for band in out["bands"])
    expected = sum(FRACTIONS[b] * np.sum(WEIGHTS[b] * np.exp(-TAUS[b] / 0.5)) for b in (0, 1))
    assert float(out["flux_down"][0].mean()) == pytest.approx(expected, rel=1e-2)
    m = out["mean_stats"]
    assert m[0][0] + m[1][0] + m[2][0] == pytest.approx(1.0, abs=1e-5)
    assert float(out["profile"][0].sum()) * 0.25 == pytest.approx(m[2][0], rel=1e-3)
    assert len(out["bands"]) == 2 and out["cfg"]["num_photons"] == 20000 * 2 * 4
    for band in out["bands"]:
        se = float(band.stderr["results"].flux_down.mean())
        assert np.isfinite(se) and se > 0
    assert 0 < m[1][1] < 0.1
    assert out["radiance"][0].shape == (1, 1, 2)
    header = (tmp_path / "bb_flux.out").read_text().splitlines()
    assert header[0].startswith("!   I3RC Monte Carlo")


@pytest.mark.parametrize("nml,error", [
    ("&radiativeTransfer\n  solarMu = 0.5\n/\n&fileNames\n  domainFileName = "
     "\"nonexistent.dom\"\n/\n", "kDistributionFiles"),
    ("&fileNames\n  domainFileName = \"nonexistent.dom\"\n/\n&spectral\n  "
     "kDistributionFiles = \"x.kd\", spectralMode = \"warp\"\n/\n", "spectralMode"),
    ("&spectral\n  kDistributionFiles = \"a.kd\", \"b.kd\",\n  bandDomainFiles = "
     "\"d.dom\"\n/\n", "bandDomainFiles"),
])
def test_broadband_driver_validation_matches_jax(tmp_path, nml, error):
    """Namelist errors raise before any file is read, with the JAX driver's
    messages."""
    path = tmp_path / "bad.nml"
    path.write_text(nml)
    with pytest.raises(ValueError, match=error) as got:
        run_bb(str(path), quiet=True, device="cpu")
    with pytest.raises(ValueError, match=error) as want:
        jax_run_bb(str(path), quiet=True)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode,algorithms", [
    ("fused", "useRayTracing = .false., maxEvents = 100"),
])
def test_broadband_driver_unported_modes_raise(tmp_path, mode, algorithms):
    """spectralMode = "fused" (ROADMAP item 13b) runs the namelist: each band
    in one fused trace, the transmission within 1e-2 of the closed form,
    closure, the radiance file, and the photon count of the other modes."""
    out = run_bb(_transparent_inputs(tmp_path, mode=mode, algorithms=algorithms),
                 quiet=True, device="cpu")
    expected = sum(FRACTIONS[b] * np.sum(WEIGHTS[b] * np.exp(-TAUS[b] / 0.5)) for b in (0, 1))
    assert float(out["flux_down"][0].mean()) == pytest.approx(expected, rel=1e-2)
    m = out["mean_stats"]
    assert m[0][0] + m[1][0] + m[2][0] == pytest.approx(1.0, abs=1e-5)
    assert all(band.per_k == [] for band in out["bands"])
    assert out["cfg"]["num_photons"] == 20000 * 2 * 4 and out["cfg"]["spectral_mode"] == "fused"
    assert (tmp_path / "bb_rad.out").is_file() and np.isfinite(out["radiance"][0]).all()


@pytest.mark.parametrize("mode,algorithms", [
    ("traced", "useRayTracing = .false."),
    ("auto", "useRayTracing = .true."),       # no fastpath plan: the traced mode
])
def test_broadband_driver_traced_radiance(tmp_path, mode, algorithms):
    """The broadband driver's traced mode with the namelist's two detectors:
    the general kernel's local estimate per k point, bb_rad.out written,
    the transmission within 1e-2 of the closed form, closure, and finite
    radiances (the transparent slab's are of order 1e-5, and its phase
    function from 16 moments has negative values, so they can be too)."""
    out = run_bb(_transparent_inputs(tmp_path, mode=mode, algorithms=algorithms),
                 quiet=True, device="cpu")
    assert (tmp_path / "bb_rad.out").is_file()
    expected = sum(FRACTIONS[b] * np.sum(WEIGHTS[b] * np.exp(-TAUS[b] / 0.5)) for b in (0, 1))
    assert float(out["flux_down"][0].mean()) == pytest.approx(expected, rel=1e-2)
    m = out["mean_stats"]
    assert m[0][0] + m[1][0] + m[2][0] == pytest.approx(1.0, abs=1e-5)
    rad = out["radiance"][0]
    assert rad.shape == (1, 1, 2) and np.isfinite(rad).all() and np.abs(rad).max() < 1e-3


def test_spectral_modules_do_not_import_jax():
    code = textwrap.dedent("""
        import sys
        import i3rc_tpu_torch.integrators.spectral
        import i3rc_tpu_torch.drivers.broadband_driver
        from i3rc_tpu_torch import run_band, run_broadband
        print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "i3rc_tpu")))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
