"""The port's copies of the phase-matrix host layer against the JAX
package's originals: ``core/phase_matrices.py``, the single-sphere Mie
series of ``tools/mie.py``, the phase-matrix netCDF layer, and the host-side
helpers of ``integrators/polarized.py`` (the baked matrix table, the
detectors' meridian frames, the initial frame).  The same numpy inputs go
through both packages; the float64 host math must agree exactly (the copies
run the same numpy operations), the float32 tables exactly, and the torch
initial frame to 4 float32 ulp of JAX's (torch's CPU sqrt may round 1 ulp
off on this machine's vector path).
"""

import importlib

import numpy as np
import pytest
import torch

from i3rc_tpu.core.phase_matrices import PhaseMatrix as JPM
from i3rc_tpu.utils.errors import ValidationError as JValidationError
from i3rc_tpu_torch.core.phase_matrices import PhaseMatrix
from i3rc_tpu_torch.utils.errors import ValidationError

SIDES = ("i3rc_tpu", "i3rc_tpu_torch")


def side(pkg: str, module: str):
    return importlib.import_module(f"{pkg}.{module}")


def elements(m):
    return [m.scattering_angle, m.a1, m.b1, m.a2, m.a3, m.a4, m.b2]


def assert_same_matrix(a, b):
    for x, y in zip(elements(a), elements(b)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert (a.extinction, a.single_scattering_albedo, a.description) == \
        (b.extinction, b.single_scattering_albedo, b.description)


@pytest.mark.parametrize("depol", [0.0, 0.03, 0.1])
def test_rayleigh_values_equal_the_originals(depol):
    ang = np.linspace(0.0, np.pi, 37)
    j, t = (side(p, "core.phase_matrices").rayleigh_matrix_values(ang, depol) for p in SIDES)
    assert sorted(j) == sorted(t)
    for k in j:
        assert np.array_equal(j[k], t[k]), k
    assert_same_matrix(JPM.rayleigh(depol, n_angles=91), PhaseMatrix.rayleigh(depol, n_angles=91))


def test_mie_equals_the_original():
    """One sphere (the 3-D polarized scene's: 10 um water at 0.67 um), its
    series and its matrix."""
    jm, tm = (side(p, "tools.mie") for p in SIDES)
    x = 2.0 * np.pi * 10.0 / 0.67
    assert jm.n_mie_terms(x) == tm.n_mie_terms(x)
    ja, jb = jm.mie_coefficients(x, 1.33 + 0.0j)
    ta, tb = tm.mie_coefficients(x, 1.33 + 0.0j)
    assert np.array_equal(ja, ta) and np.array_equal(jb, tb)
    assert jm.mie_cross_sections(x, ja, jb) == tm.mie_cross_sections(x, ta, tb)
    mu = np.cos(np.linspace(0.0, np.pi, 19))
    for a, b in zip(jm.mie_amplitudes(ja, jb, mu), tm.mie_amplitudes(ta, tb, mu)):
        assert np.array_equal(a, b)
    assert_same_matrix(JPM.from_mie(0.67, 1.33 + 0j, 10.0, n_angles=361),
                       PhaseMatrix.from_mie(0.67, 1.33 + 0j, 10.0, n_angles=361))


BAD_ELEMENTS = {
    "b1_exceeds_a1": lambda ang: (ang, np.ones_like(ang), 2.0 * np.ones_like(ang),
                                  np.ones_like(ang)),
    "reversed_angles": lambda ang: (ang[::-1], np.ones_like(ang), np.zeros_like(ang),
                                    np.ones_like(ang)),
    "negative_a1": lambda ang: (ang, -np.ones_like(ang), np.zeros_like(ang),
                                np.zeros_like(ang)),
    "a3_exceeds_a1": lambda ang: (ang, np.ones_like(ang), np.zeros_like(ang),
                                  1.5 * np.ones_like(ang)),
    "one_angle": lambda ang: (ang[:1], np.ones(1), np.zeros(1), np.ones(1)),
}


@pytest.mark.parametrize("case", sorted(BAD_ELEMENTS))
def test_from_elements_validation_messages_equal(case):
    args = BAD_ELEMENTS[case](np.linspace(0.0, np.pi, 19))
    with pytest.raises(JValidationError) as j:
        JPM.from_elements(*args)
    with pytest.raises(ValidationError) as t:
        PhaseMatrix.from_elements(*args)
    assert j.value.messages == t.value.messages and t.value.messages


def test_table_scalar_equals_the_original():
    """PhaseMatrixTable and its P11 PhaseFunctionTable (what the scalar paths
    and the polarized sampler read)."""
    tabs = [pm.PhaseMatrixTable.from_phase_matrices(
        [pm.PhaseMatrix.rayleigh(0.03), pm.PhaseMatrix.from_mie(0.55, 1.33 + 0j, 0.8,
                                                                n_angles=181)],
        [1.0, 2.0], description="mix") for pm in (side(p, "core.phase_matrices")
                                                  for p in SIDES)]
    j, t = tabs
    assert np.array_equal(j.key, t.key) and j.n_entries == t.n_entries == 2
    assert np.array_equal(j.extinctions, t.extinctions)
    assert np.array_equal(j.single_scattering_albedos, t.single_scattering_albedos)
    js, ts = j.scalar, t.scalar
    assert type(ts).__module__ == "i3rc_tpu_torch.core.phase_functions"
    for a, b in zip(js.phase_functions, ts.phase_functions):
        assert np.array_equal(a.scattering_angle, b.scattering_angle)
        assert np.array_equal(a.value, b.value)
    ang = np.linspace(0.0, np.pi, 7)
    for a, b in zip(j.phase_matrices, t.phase_matrices):
        assert np.array_equal(a.degree_of_polarization(ang), b.degree_of_polarization(ang))


def matrix_domain(pkg: str):
    pm, o = side(pkg, "core.phase_matrices"), side(pkg, "core.optics")
    tab = pm.PhaseMatrixTable.from_phase_matrices(
        [pm.PhaseMatrix.rayleigh(n_angles=361),
         pm.PhaseMatrix.from_mie(0.55, 1.33 + 0.0j, 0.8, n_angles=361)], [1.0, 2.0])
    ext = np.full((2, 1, 2), 1 / 250.0)
    return o.Domain.create([0, 250.0, 500.0], [0, 500.0], np.linspace(0, 250.0, 3)).add_component(
        "mix", ext, np.full_like(ext, 0.99), np.array([[[0, 1]], [[1, 0]]], np.int32), tab)


@pytest.mark.parametrize("writer,reader", [SIDES, SIDES[::-1]])
def test_phase_matrix_domain_files_cross_read(tmp_path, writer, reader):
    """The cross-read of tests/test_torch_host_layer.py for a domain of phase
    matrices: written by one side, read back by the other into a
    PhaseMatrixTable of that side equal to the writer's own reading."""
    path = str(tmp_path / "pol.nc")
    side(writer, "io.netcdf").write_domain(matrix_domain(writer), path)
    own = side(writer, "io.netcdf").read_domain(path)
    back = side(reader, "io.netcdf").read_domain(path)
    (c,), (b,) = own.components, back.components
    assert type(b.table).__module__ == f"{reader}.core.phase_matrices"
    assert b.table.n_entries == 2 and np.array_equal(c.table.key, b.table.key)
    for name in ("extinction", "single_scattering_albedo", "phase_function_index"):
        assert np.array_equal(getattr(c, name), getattr(b, name)), name
    for m0, m1 in zip(c.table.phase_matrices, b.table.phase_matrices):
        for x, y in zip(elements(m0), elements(m1)):
            assert np.array_equal(x, y)


def test_polarized_host_helpers_equal_the_originals():
    """_bake_matrix_tables (float32, exactly), _meridian_basis (float32,
    exactly: numpy on both sides) and _initial_frame (float32, torch against
    jnp: 4 ulp, and the pole fallback exactly)."""
    import jax.numpy as jnp

    jp = side("i3rc_tpu", "integrators.polarized")
    tp = side("i3rc_tpu_torch", "integrators.polarized")
    jt = jp._bake_matrix_tables(matrix_domain("i3rc_tpu"), 257)
    tt = tp._bake_matrix_tables(matrix_domain("i3rc_tpu_torch"), 257)
    assert (jt["n_fwd"], jt["max_entries"]) == (tt["n_fwd"], tt["max_entries"])
    assert np.array_equal(np.asarray(jt["packed"]), tt["packed"])
    rng = np.random.default_rng(5)
    mus = np.concatenate([[1.0, -1.0, 5e-4], rng.uniform(-1, 1, 13)])
    phis = np.deg2rad(rng.uniform(0, 360, mus.size))
    st = np.sqrt(1 - mus ** 2)
    dirs = np.stack([st * np.cos(phis), st * np.sin(phis), mus])
    for a, b in zip(jp._meridian_basis(dirs), tp._meridian_basis(dirs)):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    u = rng.normal(size=(3, 4096)).astype(np.float32)
    u /= np.linalg.norm(u, axis=0)
    u[:, :2] = [[0.0, 0.0], [0.0, 0.0], [1.0, -1.0]]       # the poles
    je = [np.asarray(c) for c in jp._initial_frame(*(jnp.asarray(c) for c in u))]
    te = [c.numpy() for c in tp._initial_frame(*(torch.from_numpy(c) for c in u))]
    for a, b in zip(je, te):
        assert np.array_equal(a[:2], b[:2])
        np.testing.assert_allclose(b, a, rtol=4 * 2.0 ** -23, atol=4 * 2.0 ** -24)
