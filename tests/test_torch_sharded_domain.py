"""The x-sharded domain tracer (``i3rc_tpu_torch/parallel/sharded_domain.py``)
on the absorbing I3RC Landsat scene, on the CPU: gloo worlds of 2 and 4
ranks (spawned processes) run the plain twins of SD and SB.

Each rank holds n_cells / n_ranks rows of the cell matrix; photons migrate;
``sum(flux) + n_bad == n_photons`` holds exactly; the domain-mean fluxes
agree with JAX ``trace_sharded`` on a mesh of 4 CPU devices and with the
port's unsharded ``Integrator`` within 4 combined binomial standard errors
(tests/test_sharded_domain.py's gate).  ``shardable`` agrees with JAX's.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

import sharded_reference as ref
import sharded_scenes as ss
from i3rc_tpu_torch.parallel.mesh import Mesh
from i3rc_tpu_torch.parallel.sharded_domain import shardable

NAMES = ["landsat"]


@pytest.fixture(scope="module")
def runs():
    """The 2- and 4-rank worlds run while this process traces the JAX and
    unsharded references."""
    worlds = {n: ss.start_world(n, ss.trace_cases, (NAMES, ref.PHOTONS, ref.LANES, 11))
              for n in (2, 4)}
    jx = {name: ref.jax_trace(name) for name in NAMES}
    # The port's fastpath (COL) on the CPU twin: two batches of 2048.
    un = {"landsat": ref.unsharded("landsat", 2048, 2, use_fastpath=True)}
    return {"worlds": {n: ss.join_world(w, timeout=600) for n, w in worlds.items()},
            "jax": jx, "unsharded": un}


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_shardable_agrees_with_jax(n_dev):
    from i3rc_tpu.parallel.sharded_domain import shardable as jax_shardable

    jmesh = JaxMesh(np.array(jax.devices()[:n_dev]), axis_names=("shard",))
    tmesh = Mesh(None, 0, n_dev, None)
    for name in ("landsat", "reflecting", "multi_tab"):
        t = ss.scene(name, ss.host("i3rc_tpu_torch"))["domain"]
        j = ss.scene(name, ss.host("i3rc_tpu"))["domain"]
        assert shardable(t, tmesh) == jax_shardable(j, jmesh)
    # An irregular z grid cannot shard on either side.
    for pkg, fn, mesh in (("i3rc_tpu", jax_shardable, jmesh), ("i3rc_tpu_torch", shardable,
                                                                 tmesh)):
        h = ss.host(pkg)
        dom = h.Domain.create(np.linspace(0, 480, 17), np.linspace(0, 120, 5),
                              np.array([0.0, 10.0, 40.0, 100.0]))
        dom = dom.add_component("c", np.full((16, 4, 3), 0.01), np.ones((16, 4, 3)),
                                np.zeros((16, 4, 3), np.int32),
                                h.PhaseFunctionTable.from_phase_functions(
                                    [h.PhaseFunction.from_legendre(h.hg(0.7, 32))], key=[1.0]))
        assert not fn(dom, mesh)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_each_rank_holds_its_slab(runs, n_dev):
    n_cells = 128 * 128 * 119
    per = [r["landsat"] for r in runs["worlds"][n_dev]]
    assert [p["rows"] for p in per] == [n_cells // n_dev] * n_dev
    assert sum(p["cell_bytes"] for p in per) == n_cells * 4 * 4


@pytest.mark.parametrize("n_dev", [2, 4])
def test_photons_conserved_and_migrate(runs, n_dev):
    for r in runs["worlds"][n_dev]:
        s = r["landsat"]
        total = s["flux_up"].sum() + s["flux_down"].sum() + s["flux_absorbed"].sum()
        assert total + s["n_bad"] == s["n_photons"] == ref.PHOTONS
        assert s["migrations"] > 0
        assert s["n_bad"] < 0.001 * s["n_photons"] + 2
    # Every rank returns the same whole-domain tallies.
    a, b = runs["worlds"][n_dev][0]["landsat"], runs["worlds"][n_dev][-1]["landsat"]
    assert np.array_equal(a["flux_up"], b["flux_up"]) and a["n_bad"] == b["n_bad"]


@pytest.mark.parametrize("n_dev", [2, 4])
def test_landsat_against_jax_and_unsharded(runs, n_dev):
    got = ref.fluxes(runs["worlds"][n_dev][0]["landsat"])
    jx = ref.fluxes(runs["jax"]["landsat"])
    un = runs["unsharded"]["landsat"]
    for k in ("fup", "fabs"):
        p = jx[k]
        assert abs(got[k] - jx[k]) < 4 * ref.flux_sigma(p, ref.PHOTONS, ref.PHOTONS), (k, got, jx)
        assert abs(got[k] - float(un[k][0])) < 4 * ref.flux_sigma(p, ref.PHOTONS,
                                                                   un["n_photons"]), (k, got, un)
