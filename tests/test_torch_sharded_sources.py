"""The x-sharded tracer with sources that are not uniform in x: a spotlight
(every photon in one rank's slab) and an internal flux source whose
``delta_x`` spreads its x over (0.45, 0.65] of the domain, across the slabs
of two ranks (tests/sharded_scenes.py ``NON_UNIFORM_SOURCES``).  The batch
is drawn once for all ranks and each rank's refill takes its own photons
(parallel/sharded_domain.py ``source_queue``).  On a gloo world of two ranks
(the plain versions of SD and SB): the ranks launch n photons in all
(``sum(flux) + n_bad == n`` exactly), a spotlight's all on one rank, and
the fluxes agree with the JAX package's unsharded trace within 5 combined
binomial standard errors; JAX's own sharded tracer puts such a source in
every slab (ROADMAP Queue 3, "Sharded sources"), so it is not the
reference.  The x-uniform trace of a world of one gives the digest of its
tallies that the tree before the source queue gave (sharded_scenes.py
``x_uniform_digest``).
"""

import jax
import numpy as np
import pytest

import sharded_scenes as ss

PHOTONS, LANES = 1 << 13, 1 << 11
JAX_PHOTONS = 1 << 14
SOURCES = sorted(ss.NON_UNIFORM_SOURCES)
X_UNIFORM_DIGEST = "f01d19b6b571c187"


@pytest.fixture(scope="module")
def runs():
    world = ss.start_world(2, ss.source_cases, ("volume", SOURCES, PHOTONS, LANES, 5))
    from i3rc_tpu.integrators.config import IntegratorConfig
    from i3rc_tpu.integrators.integrator import Integrator

    sc = ss.scene("volume", ss.host("i3rc_tpu"))
    integ = Integrator.create(sc["domain"], IntegratorConfig(
        use_ray_tracing=False, max_events=500, use_fastpath=False,
        compute_volume_absorption=True))
    jax_ref = {}
    for k, name in enumerate(SOURCES):
        r = integ.compute(jax.random.PRNGKey(7 + k), ss.photon_source(name, "i3rc_tpu"),
                          JAX_PHOTONS)
        jax_ref[name] = {"fup": float(r.mean_flux_up), "fdn": float(r.mean_flux_down),
                         "fabs": float(r.mean_flux_absorbed)}
    return {"ranks": ss.join_world(world, timeout=600), "jax": jax_ref}


@pytest.mark.parametrize("name", SOURCES)
def test_every_photon_is_launched_once(runs, name):
    a, b = (r[name] for r in runs["ranks"])
    assert a["budget"] + b["budget"] == PHOTONS
    if name == "spotlight":
        assert sorted((a["budget"], b["budget"])) == [0, PHOTONS]   # x = 0.3: rank 0's slab
    else:
        assert min(a["budget"], b["budget"]) > PHOTONS // 10      # spread over both slabs
    total = a["flux_up"].sum() + a["flux_down"].sum() + a["flux_absorbed"].sum()
    assert total + a["n_bad"] == a["n_photons"] == PHOTONS
    assert a["n_bad"] == 0 and a["migrations"] > 0
    assert np.array_equal(a["flux_up"], b["flux_up"]) and np.array_equal(a["volume"], b["volume"])


@pytest.mark.parametrize("name", SOURCES)
def test_fluxes_match_the_jax_unsharded_trace(runs, name):
    r = runs["ranks"][0][name]
    got = {"fup": r["flux_up"].sum() / PHOTONS, "fdn": r["flux_down"].sum() / PHOTONS,
           "fabs": r["flux_absorbed"].sum() / PHOTONS}
    for k, p in runs["jax"][name].items():
        sigma = np.sqrt(max(p * (1.0 - p), 1e-3) * (1.0 / PHOTONS + 1.0 / JAX_PHOTONS))
        assert abs(got[k] - p) <= 5 * sigma, (name, k, got[k], p, sigma)


def test_x_uniform_trace_is_unchanged():
    assert ss.x_uniform_digest("cpu") == X_UNIFORM_DIGEST
