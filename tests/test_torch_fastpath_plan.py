"""The port's fastpath planner against the JAX planner, field by field.

Each side builds its domain and configuration with its own classes from the
same numpy arrays."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from i3rc_tpu.integrators.integrator import Integrator as JaxIntegrator
from i3rc_tpu_torch.integrators.fastpath import plan_from_jax
from i3rc_tpu_torch.integrators.integrator import Integrator

torch.set_num_threads(2)


def host(pkg: str) -> SimpleNamespace:
    """One side's host layer: the port keeps its copies under the JAX
    package's module paths."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    pf = mod("core.phase_functions")
    return SimpleNamespace(
        Domain=mod("core.optics").Domain, PhaseFunction=pf.PhaseFunction,
        PhaseFunctionTable=pf.PhaseFunctionTable, hg=pf.henyey_greenstein_coefficients,
        make_step_cloud=mod("models.step_cloud").make_step_cloud,
        cfg=mod("integrators.config").IntegratorConfig(use_ray_tracing=False,
                                                        max_events=500))


JAX, PORT = host("i3rc_tpu"), host("i3rc_tpu_torch")


def _hg_domain(h, ext, g=0.7, ssa=1.0, sizes=(300.0, 200.0, 100.0)):
    table = h.PhaseFunctionTable.from_phase_functions(
        [h.PhaseFunction.from_legendre(h.hg(g, 48))], key=[1.0])
    nx, ny, nz = ext.shape
    dom = h.Domain.create(np.linspace(0, sizes[0], nx + 1), np.linspace(0, sizes[1], ny + 1),
                          np.linspace(0, sizes[2], nz + 1))
    return dom.add_component("c", ext, np.full_like(ext, ssa),
                             np.zeros(ext.shape, np.int32), table)


def separable_3d(h):
    """A separable scene with structure along x, y and z (zero layers too)."""
    vx = np.array([1.0, 1.0, 2.0, 2.0, 0.5, 0.5])
    vy = np.array([1.0, 3.0, 3.0, 1.0])
    vz = np.array([0.0, 0.01, 0.02, 0.02, 0.0])
    return _hg_domain(h, vx[:, None, None] * vy[None, :, None] * vz[None, None, :], ssa=0.95)


def slab(h):
    """The tau-1 HG slab that i3rc_tpu/models/slab.py builds (make_slab_domain(1.0)),
    here with 48 Legendre terms."""
    return _hg_domain(h, np.full((1, 1, 1), 1.0 / 250.0), g=0.85,
                      sizes=(500.0, 500.0, 250.0))


DOMAINS = {
    "step_cloud": lambda h: h.make_step_cloud(1.0),
    "step_cloud_absorbing": lambda h: h.make_step_cloud(0.99),
    "slab": slab,
    "separable_3d": separable_3d,
}


@pytest.mark.parametrize("name", sorted(DOMAINS))
def test_plan_matches_jax(name):
    jplan = JaxIntegrator.create(DOMAINS[name](JAX), config=JAX.cfg)._fast_plan
    tplan = Integrator.create(DOMAINS[name](PORT), config=PORT.cfg, device="cpu")._fast_plan
    assert jplan is not None and tplan is not None
    for axis in ("fx", "fy", "fz"):
        jf, tf = getattr(jplan, axis), getattr(tplan, axis)
        assert tf.thresholds == jf.thresholds and tf.values == jf.values
    assert (tplan.hg_g, tplan.unroll, tplan.ssa) == (jplan.hg_g, jplan.unroll, jplan.ssa)
    assert plan_from_jax(jplan) == tplan
    if name == "separable_3d":
        assert tplan.fy.n_ops > 0 and tplan.fz.n_ops > 0


def test_non_separable_field_has_no_plan():
    ext = np.random.default_rng(0).uniform(0.001, 0.02, (5, 4, 3))
    assert JaxIntegrator.create(_hg_domain(JAX, ext), config=JAX.cfg)._fast_plan is None
    integ = Integrator.create(_hg_domain(PORT, ext), config=PORT.cfg, device="cpu")
    assert integ._fast_plan is None
    with pytest.raises(NotImplementedError, match="item 16"):
        integ.batch_tracer(1024)


@pytest.mark.parametrize("kwargs,item", [
    # fx and fy both vary: the JAX planner takes the marching shadow trace.
    (dict(intensity_mus=[1.0, 0.5], intensity_phis=[0.0, 0.0]), "item 10b"),
    (dict(surface_albedo=0.3), "item 11"),
])
def test_out_of_slice_plans_raise(kwargs, item):
    dom = separable_3d if "intensity_mus" in kwargs else lambda h: h.make_step_cloud(1.0)
    jplan = JaxIntegrator.create(dom(JAX), config=JAX.cfg, **kwargs)._fast_plan
    assert jplan is not None          # the JAX fastpath takes these
    assert not getattr(jplan, "closed_shadow", False)
    integ = Integrator.create(dom(PORT), config=PORT.cfg, device="cpu", **kwargs)
    with pytest.raises(NotImplementedError, match=item):
        integ._fast_plan
    with pytest.raises(NotImplementedError, match=item):
        plan_from_jax(jplan)
