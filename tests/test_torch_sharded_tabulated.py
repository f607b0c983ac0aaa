"""Radiance on the x-sharded domain tracer with two components, one of them
tabulated: tests/test_sharded_domain.py's C.1 cloud and Legendre
component (detectors mu 1 and -0.5), on the CPU in gloo worlds of 2 and
4 ranks (the twins of SD and SB).  The component pick by cumulative
extinction and the replicated cubic inverse-CDF and log-cubic forward
fits of both tables: per detector against the port's unsharded general
kernel and JAX ``trace_sharded`` within 5 combined standard errors, and
both scatterers' slots filled.
"""

import pytest

import sharded_reference as ref

NAME = "multi_tab"


@pytest.fixture(scope="module")
def runs():
    return ref.radiance_runs(NAME, 41)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_radiance_against_jax_and_unsharded(runs, n_dev):
    ref.check_radiance(runs, NAME, n_dev)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_radiance_split_by_slot(runs, n_dev):
    ref.check_split(runs, NAME, n_dev)
