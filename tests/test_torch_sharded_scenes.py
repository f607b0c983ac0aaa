"""The x-sharded domain tracer on the reflecting random field of
tests/test_sharded_domain.py:71-110 (16 x 4 x 6 cells, HG 0.7, ssa 0.95,
a Lambertian surface of albedo 0.4) and on its volume absorption (black
surface), on the CPU in gloo worlds of 2 and 4 ranks (the twins of SD).

The domain-mean fluxes agree with JAX ``trace_sharded`` on a mesh of 4 CPU
devices and with the port's unsharded general kernel within 4 combined
binomial standard errors; with the volume tally each column's cells sum to
its absorbed flux exactly, the absorbed profile agrees with the unsharded
one within 5 sigma + 5e-4 a layer (tests/test_sharded_domain.py:199-227's
gate), and photons are conserved exactly.
"""

import numpy as np
import pytest

import sharded_reference as ref
import sharded_scenes as ss

NAMES = ["reflecting", "volume"]
NX, NY, NZ, DZ = 16, 4, 6, 30.0


@pytest.fixture(scope="module")
def runs():
    worlds = {n: ss.start_world(n, ss.trace_cases, (NAMES, ref.PHOTONS, ref.LANES, 21))
              for n in (2, 4)}
    jx = {name: ref.jax_trace(name) for name in NAMES}
    un = {name: ref.unsharded(name) for name in NAMES}
    return {"worlds": {n: ss.join_world(w, timeout=600) for n, w in worlds.items()},
            "jax": jx, "unsharded": un}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n_dev", [2, 4])
def test_fluxes_against_jax_and_unsharded(runs, name, n_dev):
    got = ref.fluxes(runs["worlds"][n_dev][0][name])
    jx = ref.fluxes(runs["jax"][name])
    un = runs["unsharded"][name]
    for k in ("fup", "fabs"):
        p = float(un[k][0])
        assert abs(got[k] - jx[k]) < 4 * ref.flux_sigma(p, ref.PHOTONS, ref.PHOTONS), (k, got, jx)
        assert abs(got[k] - p) < 4 * ref.flux_sigma(p, ref.PHOTONS, un["n_photons"]), (k, got, p)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_reflecting_counts_every_hit(runs, n_dev):
    s = runs["worlds"][n_dev][0]["reflecting"]
    total = s["flux_up"].sum() + s["flux_down"].sum() + s["flux_absorbed"].sum()
    # Fdn counts every bottom hit (a revived photon can hit again): the
    # tallies exceed the photons, never fall short.
    assert total + s["n_bad"] >= s["n_photons"]
    assert s["n_bad"] < 0.001 * s["n_photons"] + 2 and s["migrations"] > 0


@pytest.mark.parametrize("n_dev", [2, 4])
def test_volume_absorption(runs, n_dev):
    s = runs["worlds"][n_dev][0]["volume"]
    n = s["n_photons"]
    vol = s["volume"].reshape(NX, NY, NZ)
    assert np.array_equal(vol.sum(axis=-1), s["flux_absorbed"].reshape(NX, NY))
    assert s["flux_up"].sum() + s["flux_down"].sum() + s["flux_absorbed"].sum() + s["n_bad"] == n
    prof_sh = vol.sum(axis=(0, 1)) / n
    mean, _ = runs["unsharded"]["volume"]["profile"]
    prof_ref = mean * DZ / (NX * NY)
    sigma = np.sqrt(prof_ref.clip(min=1e-4) / n)
    np.testing.assert_array_less(np.abs(prof_sh - prof_ref), 5 * sigma + 5e-4)
    jx = runs["jax"]["volume"]
    prof_jx = jx["volume"].reshape(NX, NY, NZ).sum(axis=(0, 1)) / jx["n_photons"]
    np.testing.assert_array_less(np.abs(prof_sh - prof_jx), 5 * sigma * np.sqrt(2) + 5e-4)


def test_rank_states_cross_interior_faces():
    """Each rank of a gloo world of 2 keeps SD's and SB's inputs at a
    mid-flight and a tail block of the graft scene (2 of its 4 x cells a
    rank) and holds each launch against its twin; the mid-flight launches
    tag photons and shadow rays for migration at faces that, on one side of
    each slab, lie inside the domain (a world of one sends its migrants to
    itself across the domain's own x edges)."""
    ranks = ss.run_world(2, ss.twin_check_job, ("graft", 1 << 12, 1 << 10, 3), timeout=300)
    for r in ranks:
        assert r["nx_loc"] == 2
        got = {(c["kernel"], c["state"]): c for c in r["checks"]}
        assert sorted(got) == [("SB", "mid"), ("SB", "tail"), ("SD", "mid"), ("SD", "tail")]
        assert all(c["bit_equal"] for c in r["checks"])
        assert got[("SD", "mid")]["tagged"] > 0 and got[("SB", "mid")]["tagged"] > 0

