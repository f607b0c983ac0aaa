"""The port's host tools (``i3rc_tpu_torch/tools/``, copies of the JAX
package's ``tools/``) against the originals on the repo's data: the
refractive index of water and ice (equal), Mie tables (within 1e-6
relative; the code is the same, so they come out equal), the physical- and
optical-properties to domain converters (equal domain arrays), and each
tool's ``main`` on a namelist (the same file content, read back by each
side's reader).
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ROOT / "examples" / "tools"
SIDES = ("i3rc_tpu", "i3rc_tpu_torch")


def side(pkg: str, module: str):
    import importlib

    return importlib.import_module(f"{pkg}.{module}")


def assert_same_table(a, b, rtol: float = 0.0):
    assert a.n_entries == b.n_entries
    np.testing.assert_allclose(b.key, a.key, rtol=rtol, atol=0)
    np.testing.assert_allclose(b.extinctions, a.extinctions, rtol=rtol, atol=0)
    np.testing.assert_allclose(b.single_scattering_albedos, a.single_scattering_albedos,
                               rtol=rtol, atol=0)
    for pa, pb in zip(a.phase_functions, b.phase_functions):
        np.testing.assert_allclose(pb.legendre_coefficients, pa.legendre_coefficients,
                                   rtol=rtol, atol=0)


def assert_same_domain(a, b):
    for edges in ("x_edges", "y_edges", "z_edges"):
        assert np.array_equal(getattr(a, edges), getattr(b, edges)), edges
    assert tuple(a.component_names) == tuple(b.component_names)
    for ca, cb in zip(a.components, b.components):
        for f in ("extinction", "single_scattering_albedo", "phase_function_index"):
            assert np.array_equal(getattr(ca, f), getattr(cb, f)), f
        assert ca.z_level_base == cb.z_level_base
        assert_same_table(ca.table, cb.table)


@pytest.mark.parametrize("particle", ["W", "I"])
def test_refractive_index_equals_the_original(particle):
    j, t = (side(p, "tools.refractive_index") for p in SIDES)
    wl = np.array([0.25, 0.5, 0.675, 2.13, 10.6, 150.0, 400.0, 2000.0, 1.0e4])
    for temp in (None, 253.0, 268.0):
        if particle == "W" and temp is not None and temp < 260.0:
            continue
        a = j.refractive_index(particle, wl, temp)
        b = t.refractive_index(particle, wl, temp)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


MIE_CASES = {
    "water_center": dict(wavelen1=0.67, particle_type="W", alpha=7.0, n_retab=3, s_retab=1.0,
                         e_retab=3.0, max_radius=6.0),
    "water_averaged": dict(wavelen1=2.10, wavelen2=2.16, particle_type="W", avg_flag="A",
                           delta_wave=0.03, alpha=7.0, n_retab=1, s_retab=2.0,
                           max_radius=6.0),
    "aerosol_lognormal": dict(wavelen1=0.675, particle_type="A",
                              refraction_index=complex(1.45, -0.01), density=2.0,
                              dist_flag="L", alpha=0.7, n_retab=-3, s_retab=0.1,
                              e_retab=0.6, max_radius=3.0),
}


@pytest.mark.parametrize("case", sorted(MIE_CASES))
def test_make_mie_table_equals_the_original(case):
    j, t = (side(p, "tools.mie") for p in SIDES)
    assert_same_table(j.make_mie_table(**MIE_CASES[case]), t.make_mie_table(**MIE_CASES[case]),
                      rtol=1e-6)
    for dist, alpha in (("G", 7.0), ("L", 0.7)):
        args = (dist, 1.0, np.linspace(1, 20, 40), 9.0, alpha)
        for x, y in zip(j.make_size_distribution(*args), t.make_size_distribution(*args)):
            np.testing.assert_allclose(y, x, rtol=1e-6)


def test_mie_one_and_planck_helpers_equal_the_originals():
    j, t = (side(p, "tools.mie") for p in SIDES)
    for x, y in zip(j.mie_one(0.67, complex(1.33, -1e-8), 5.0, 64),
                    t.mie_one(0.67, complex(1.33, -1e-8), 5.0, 64)):
        np.testing.assert_allclose(y, x, rtol=1e-6)
    a, b = j.mie_coefficients(12.0, 1.33 + 0j)
    mu = np.linspace(-1, 1, 7)
    assert np.array_equal(j.mie_intensity(a, b, mu), t.mie_intensity(a, b, mu))
    for name in ("planck_radiation", "effective_blackbody_temp", "planck_weighting_wavelengths",
                 "get_center_wavelength"):
        args = (2.13, 5700.0) if name == "planck_radiation" else (0.4, 0.8)
        np.testing.assert_allclose(getattr(t, name)(*args), getattr(j, name)(*args), rtol=1e-6)


def test_physical_to_domain_equals_the_original(tmp_path):
    lwc = tmp_path / "tiny.lwc"
    lwc.write_text("2 parameter LWC\n2 1 2\n0.1 0.1\n0.5 0.6 0.7\n285.0 284.0 283.0\n"
                   "1 1 1 0.3 3.5\n2 1 1 0.2 3.0\n1 1 2 0.1 2.5\n")
    doms = []
    for pkg in SIDES:
        table = side(pkg, "tools.mie").make_mie_table(0.67, particle_type="W", alpha=7.0,
                                                      n_retab=3, s_retab=2.0, e_retab=4.0,
                                                      max_radius=6.0)
        doms.append(side(pkg, "tools.physical_to_domain").physical_properties_to_domain(
            str(lwc), [table], other_heights=[0.0, 1.0], other_temps=[288.0, 282.0],
            rayleigh_wavelength=0.67))
    assert_same_domain(*doms)


def test_optical_to_domain_equals_the_original():
    doms = [side(pkg, "tools.optical_to_domain").optical_properties_to_domain(
        str(TOOLS / "les_stcu_w213.prp")) for pkg in SIDES]
    assert doms[0].grid_shape == doms[1].grid_shape
    assert_same_domain(*doms)


def _run_main(pkg: str, module: str, nml: Path, workdir: Path, capsys) -> str:
    """The tool's main on a namelist from ``workdir``; its stdout."""
    import os

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        assert side(pkg, f"tools.{module}").main([str(nml)]) == 0
    finally:
        os.chdir(cwd)
    return capsys.readouterr().out


def test_each_main_writes_the_same_file(tmp_path, capsys):
    """mie (a 2-entry table), then physical_to_domain on the cloud-and-dust
    particle file with the molecular absorption, then optical_to_domain,
    each run by both sides in a directory of its own; the files read back
    by each side's reader give equal tables and domains."""
    mie_nml = ("&mie_table_input\n WAVELEN1=2.13, WAVELEN2=2.13, AVGFLAG='C', PARTYPE='{p}',\n"
               " {extra} DISTFLAG='{d}', ALPHA={a}, NRETAB=2, SRETAB={s}, ERETAB={e},\n"
               " MAXRADIUS={m}, phaseFunctionTableFile='{out}'\n/\n")
    outs = {}
    for pkg in SIDES:
        wd = tmp_path / pkg
        wd.mkdir()
        for name, kw in (("cloud", dict(p="W", extra="", d="G", a=7.0, s=4.0, e=8.0, m=10.0)),
                         ("dust", dict(p="A", extra="RINDEX=(1.45,-0.010), PARDENS=2.0,",
                                       d="L", a=0.7, s=0.5, e=1.0, m=5.0))):
            nml = wd / f"mie_{name}.nml"
            nml.write_text(mie_nml.format(out=f"{name}_w2.13_mie.phasetab", **kw))
            assert "Mie table" in _run_main(pkg, "mie", nml, wd, capsys)
        shutil.copy(TOOLS / "cloud_dust.part", wd)
        shutil.copy(TOOLS / "molec_abs_w213.dat", wd)
        shutil.copy(TOOLS / "cloudAndDust_to_domain.nml", wd)
        assert "Wrote domain" in _run_main(pkg, "physical_to_domain",
                                           wd / "cloudAndDust_to_domain.nml", wd, capsys)
        (wd / "optical.nml").write_text(f"&fileNames\n PropFileName='{TOOLS}/les_stcu_w213.prp',"
                                        "\n outputFileName='les_stcu_w213.dom'\n/\n")
        assert "Wrote domain" in _run_main(pkg, "optical_to_domain", wd / "optical.nml", wd,
                                           capsys)
        outs[pkg] = wd
    for reader in SIDES:
        io = side(reader, "io.netcdf")
        for name in ("cloud", "dust"):
            assert_same_table(*(io.read_phase_function_table(
                str(outs[p] / f"{name}_w2.13_mie.phasetab")) for p in SIDES))
        for name in ("mixture.dom", "les_stcu_w213.dom"):
            assert_same_domain(*(io.read_domain(str(outs[p] / name)) for p in SIDES))
