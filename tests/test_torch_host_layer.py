"""The port's own host layer: it imports nothing of the JAX package, and its
copies of the JAX package's host modules give what the originals give.

The port keeps copies of the host modules it needs (domains, phase tables,
quadrature, k-distributions, the integrator configuration, namelists,
netCDF I/O, result writers, the I3RC scenes) under the JAX package's module
paths.  A subprocess shows that driving the port loads neither ``jax`` nor
any ``i3rc_tpu`` module; a scan of the sources shows that none names one;
the rest holds each copy against its original on the same inputs.
"""

import dataclasses
import importlib
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def side(pkg: str, module: str):
    """The module of one side: the port keeps its copies under the JAX
    package's module paths."""
    return importlib.import_module(f"{pkg}.{module}")


SIDES = ("i3rc_tpu", "i3rc_tpu_torch")


def test_port_loads_no_jax_package_module():
    """Drive the port (the step cloud and a small column scene through
    ``Integrator.compute``, both drivers imported, ``chip_smoke`` imported as
    a module) and list what of jax and the JAX package is loaded: nothing."""
    code = textwrap.dedent("""
        import importlib.util, sys
        import numpy as np
        import torch
        torch.set_num_threads(2)
        from i3rc_tpu_torch import (Domain, Integrator, IntegratorConfig, PhaseFunction,
                                    PhaseFunctionTable, PhotonSource, batch_key,
                                    henyey_greenstein_coefficients, make_step_cloud)
        import i3rc_tpu_torch.drivers.broadband_driver
        import i3rc_tpu_torch.drivers.monte_carlo_driver
        cfg = IntegratorConfig(use_ray_tracing=False, compute_volume_absorption=False)
        src = PhotonSource.directional(0.5, 0.0)
        res = Integrator.create(make_step_cloud(1.0), cfg, device="cpu").compute(
            batch_key(1, 0), src, 2048)
        assert abs(float(res.mean_flux_up + res.mean_flux_down) - 1.0) < 1e-5
        ext = np.zeros((4, 4, 6))
        ext[:, :, :3] = np.linspace(0.01, 0.05, 16).reshape(4, 4, 1)
        table = PhaseFunctionTable.from_phase_functions(
            [PhaseFunction.from_legendre(henyey_greenstein_coefficients(0.85, 32))],
            key=[1.0])
        dom = Domain.create(np.linspace(0, 120, 5), np.linspace(0, 120, 5),
                            np.linspace(0, 60, 7)).add_component(
            "c", ext, np.where(ext > 0, 1.0, 0.0), np.zeros(ext.shape, np.int32), table)
        integ = Integrator.create(dom, cfg, device="cpu")
        assert integ._fast_plan.column_data is not None
        res = integ.compute(batch_key(2, 0), src, 2048)
        assert abs(float(res.mean_flux_up + res.mean_flux_down) - 1.0) < 1e-5
        spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "i3rc_tpu")))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_port_sources_name_no_jax_package_module():
    pattern = re.compile(r"^\s*(import\s+i3rc_tpu\b(?!_torch)|from\s+i3rc_tpu(\.|\s))",
                         re.MULTILINE)
    files = sorted((ROOT / "i3rc_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert offenders == []


@pytest.mark.parametrize("scene,ssa", [("step_cloud", 1.0), ("step_cloud", 0.99),
                                       ("landsat_cloud", 1.0), ("landsat_cloud", 0.99)])
def test_scenes_equal_the_originals(scene, ssa):
    make = f"make_{scene}"
    jdom, tdom = (getattr(side(pkg, f"models.{scene}"), make)(ssa) for pkg in SIDES)
    for edges in ("x_edges", "y_edges", "z_edges"):
        assert np.array_equal(getattr(jdom, edges), getattr(tdom, edges))
    (jc,), (tc,) = jdom.components, tdom.components
    for name in ("extinction", "single_scattering_albedo", "phase_function_index"):
        a, b = getattr(jc, name), getattr(tc, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    jpf, tpf = jc.table.phase_functions[0], tc.table.phase_functions[0]
    assert np.array_equal(jpf.legendre_coefficients, tpf.legendre_coefficients)


@pytest.mark.parametrize("g,n", [(0.85, 64), (0.85, 299), (-0.3, 16)])
def test_phase_tables_equal_the_originals(g, n):
    coeffs = [side(pkg, "core.phase_functions").henyey_greenstein_coefficients(g, n)
              for pkg in SIDES]
    assert np.array_equal(*coeffs)
    tables = []
    for pkg, c in zip(SIDES, coeffs):
        pf = side(pkg, "core.phase_functions")
        tables.append(pf.PhaseFunctionTable.from_phase_functions(
            [pf.PhaseFunction.from_legendre(c), pf.PhaseFunction.from_legendre(c[:8])],
            key=[1.0, 2.0]))
    jt, tt = tables
    assert np.array_equal(jt.key, tt.key)
    for a, b in zip(jt.phase_functions, tt.phase_functions):
        assert np.array_equal(a.legendre_coefficients, b.legendre_coefficients)


def test_config_defaults_equal_the_originals():
    jcfg, tcfg = (side(pkg, "integrators.config").IntegratorConfig() for pkg in SIDES)
    names = [f.name for f in dataclasses.fields(jcfg)]
    assert names == [f.name for f in dataclasses.fields(tcfg)]
    for name in names:
        assert getattr(jcfg, name) == getattr(tcfg, name), name


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "examples").glob("*.nml")))
def test_namelists_parse_as_the_originals(name):
    jnml, tnml = (side(pkg, "utils.namelist").read_namelist(str(ROOT / "examples" / name))
                  for pkg in SIDES)
    assert jnml and jnml == tnml


@pytest.mark.parametrize("writer,reader", [SIDES, SIDES[::-1]])
def test_domain_files_cross_read(tmp_path, writer, reader):
    """A domain written by one side's write_domain reads back through the
    other side's read_domain with the arrays the writer's own read_domain
    gives, bit for bit."""
    dom = side(writer, "models.step_cloud").make_step_cloud(0.99)
    path = str(tmp_path / "dom.opt")
    side(writer, "io.netcdf").write_domain(dom, path)
    own = side(writer, "io.netcdf").read_domain(path)
    back = side(reader, "io.netcdf").read_domain(path)
    assert type(back).__module__.startswith(reader + ".")
    for edges in ("x_edges", "y_edges", "z_edges"):
        assert np.array_equal(getattr(own, edges), getattr(back, edges))
        assert np.allclose(getattr(dom, edges), getattr(back, edges), rtol=1e-6)
    (c,), (b,) = own.components, back.components
    for name in ("extinction", "single_scattering_albedo", "phase_function_index"):
        x, y = getattr(c, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert np.array_equal(c.table.key, b.table.key)
    assert np.array_equal(c.table.phase_functions[0].legendre_coefficients,
                          b.table.phase_functions[0].legendre_coefficients)


def test_phase_function_tables_equal_the_originals():
    """The copies of integrators/tables.py and core/inverse_phase.py give the
    originals' tables on the same optics (the step cloud's HG entry and a
    tabulated Rayleigh entry): the inverse angle tables, the forward tables
    and their hybrid, and the cubic fits."""
    outs = []
    for pkg in SIDES:
        pf, o = side(pkg, "core.phase_functions"), side(pkg, "core.optics")
        ang = np.linspace(0.0, np.pi, 91)
        table = pf.PhaseFunctionTable.from_phase_functions(
            [pf.PhaseFunction.from_legendre(pf.henyey_greenstein_coefficients(0.85, 64)),
             pf.PhaseFunction.from_tabulated(ang, 0.75 * (1 + np.cos(ang) ** 2))],
            key=[1.0, 2.0])
        ext = np.full((2, 1, 2), 0.01)
        dom = o.Domain.create([0.0, 1.0, 2.0], [0.0, 1.0], [0.0, 1.0, 2.0]).add_component(
            "c", ext, np.ones_like(ext), np.array([[[0, 1]], [[1, 0]]], np.int32), table)
        flat = o.flatten_optics(dom)
        t = side(pkg, "integrators.tables")
        fwd = t.build_forward_tables(flat, 1801)
        outs.append([t.build_inverse_tables(flat, 1801), fwd, t.hybridize(fwd, 7.0),
                     t.build_inverse_cubic(flat), t.build_forward_cubic(flat)])
    for a, b in zip(*outs):
        assert a.shape == b.shape and np.array_equal(a, b)
