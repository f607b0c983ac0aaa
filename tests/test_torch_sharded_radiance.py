"""Radiance detectors on the x-sharded domain tracer, on the CPU in gloo
worlds of 2 and 4 ranks (the twins of SD and SB): the reflecting random
field of tests/test_sharded_domain.py with three detectors (mu 1, 0.6,
-0.5; phi 0, 45, 0: the slanted one's shadow rays cross slab faces) over
an albedo of 0.4.

Per detector the domain-mean radiance agrees with the port's unsharded
general kernel (G and its estimate) and with JAX ``trace_sharded`` on a
mesh of 4 CPU devices within 5 combined standard errors
(``sharded_reference.check_radiance``); the split by slot sums to the
total and the surface feeds the upward detectors only.
"""

import pytest

import sharded_reference as ref

NAME = "detectors"


@pytest.fixture(scope="module")
def runs():
    return ref.radiance_runs(NAME, 31)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_radiance_against_jax_and_unsharded(runs, n_dev):
    ref.check_radiance(runs, NAME, n_dev)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_radiance_split_by_slot(runs, n_dev):
    ref.check_split(runs, NAME, n_dev)
