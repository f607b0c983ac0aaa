"""Batches over torch.distributed ranks (``i3rc_tpu_torch/parallel/mesh.py``).

Worlds of 1, 2 and 4 gloo ranks (spawned processes, a localhost store)
run the same batches: batch b draws from the key (seed, b) on whichever
rank runs it, so their float64 moments agree to 1e-12 relative (the sums
run in another order).  ``batch_offset`` chunks sum to the single pass;
``n_batches`` rounds up to a multiple of the ranks; ``default_mesh`` is a
world of one without a process group; the port agrees with JAX
``run_batches`` on a mesh of 4 devices within 5 combined standard errors;
and the namelist driver under a 2-rank world writes its files once (rank
0) and records 2 devices.
"""

import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import sharded_scenes as ss
from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource
from i3rc_tpu_torch.parallel.mesh import Mesh, default_mesh, run_batches, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
N, B, SEED = 512, 8, 3


def port_integ():
    return Integrator.create(ss.slab(ss.host("i3rc_tpu_torch")),
                             IntegratorConfig(use_ray_tracing=False), surface_albedo=0.1,
                             device="cpu")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Worlds of 1, 2 and 4 ranks of 8 batches (4 with 5 asked: rounded
    to 8), and a 2-rank world of the namelist driver, started together."""
    from i3rc_tpu_torch.models.step_cloud import write_domains

    tmp = tmp_path_factory.mktemp("worlds")
    write_domains(str(tmp))
    nml = tmp / "run.nml"
    nml.write_text(textwrap.dedent(f"""
        &radiativeTransfer
          solarFlux = 1., solarMu = 0.5, solarAzimuth = 0., surfaceAlbedo = 0.
        /
        &monteCarlo
          numPhotonsPerBatch = 256, numBatches = 3, iseed = 10
        /
        &algorithms
          useRayTracing = .false.
        /
        &fileNames
          domainFileName = "{tmp}/StepCloud_NonAbsorbing.opt",
          outputFluxFile = "fluxes.out",
          outputNetcdfFile = "out.nc"
        /
    """))
    started = {n: ss.start_world(n, ss.batches_job, (N, 5 if n == 4 else B, SEED))
               for n in (1, 2, 4)}
    started["driver"] = ss.start_world(2, ss.driver_job, (str(nml), str(tmp / "work")))
    return {k: ss.join_world(w, timeout=600) for k, w in started.items()}


@pytest.fixture(scope="module")
def single_pass():
    return run_batches(port_integ(), PhotonSource.directional(0.5, 0.0), N, B, seed=SEED,
                       derive=ss.domain_means, _return_sums=True)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_worlds_give_the_same_moments(worlds, single_pass, n):
    s1, s2, nb = single_pass
    for r in worlds[n]:
        assert r["size"] == n and r["n_batches"] == B
        for got, want in zip(r["s1"] + r["s2"], tree_leaves(s1) + tree_leaves(s2)):
            np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=0.0)


def test_batch_offset_chunks_sum_to_the_single_pass(single_pass):
    integ, src = port_integ(), PhotonSource.directional(0.5, 0.0)
    a1, a2, na = run_batches(integ, src, N, 3, seed=SEED, derive=ss.domain_means,
                             _return_sums=True)
    b1, b2, nb = run_batches(integ, src, N, 5, seed=SEED, derive=ss.domain_means,
                             batch_offset=3, _return_sums=True)
    s1, s2, n = single_pass
    assert (na, nb, n) == (3, 5, B)
    for x, y, want in zip(tree_leaves(a1) + tree_leaves(a2), tree_leaves(b1) + tree_leaves(b2),
                          tree_leaves(s1) + tree_leaves(s2)):
        np.testing.assert_allclose((x + y).numpy(), want.numpy(), rtol=1e-12, atol=0.0)
    # In chunks of 4 batches, the same sums bit for bit as two offset runs.
    c1, _, _ = run_batches(integ, src, N, B, seed=SEED, derive=ss.domain_means,
                           chunk_batches=4, _return_sums=True)
    d1, _, _ = run_batches(integ, src, N, 4, seed=SEED, derive=ss.domain_means,
                           _return_sums=True)
    e1, _, _ = run_batches(integ, src, N, 4, seed=SEED, derive=ss.domain_means,
                           batch_offset=4, _return_sums=True)
    for c, d, e in zip(tree_leaves(c1), tree_leaves(d1), tree_leaves(e1)):
        assert torch.equal(c, d + e)


def test_n_batches_rounds_up_to_the_ranks(worlds):
    # 5 batches over 4 ranks run 8 (monteCarloDriver.f95:268-271), and a
    # run asks at least 2.
    assert all(r["n_batches"] == 8 for r in worlds[4])
    st = run_batches(port_integ(), PhotonSource.directional(0.5, 0.0), N, 1, seed=SEED)
    assert st.n_batches == 2


def test_default_mesh_without_a_group_is_a_world_of_one():
    m = default_mesh(device="cpu")
    assert isinstance(m, Mesh) and (m.group, m.rank, m.size) == (None, 0, 1)
    assert m.device == torch.device("cpu") and m.backend is None


def test_default_mesh_without_a_card_raises(monkeypatch):
    # Like every other entry point of the port, a mesh defaults to cuda and
    # raises without a card; only device="cpu" gives the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from i3rc_tpu_torch.parallel.mesh import initialize_multihost

    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_multihost()
    m = default_mesh(device="cpu")
    assert (m.group, m.rank, m.size, m.device) == (None, 0, 1, torch.device("cpu"))


def test_against_jax_run_batches_on_a_mesh_of_four():
    """Domain-mean fluxes of the port and of JAX on a mesh of 4 CPU
    devices, 16 batches of 512 photons each side, within 5 combined
    standard errors (JAX's fastpath at K = 1: the same physics, a ~10x
    shorter XLA compile on this CPU)."""
    from i3rc_tpu.integrators.config import IntegratorConfig as JaxConfig
    from i3rc_tpu.integrators.integrator import Integrator as JaxIntegrator
    from i3rc_tpu.core.illumination import PhotonSource as JaxSource
    from i3rc_tpu.parallel.mesh import default_mesh as jax_mesh
    from i3rc_tpu.parallel.mesh import run_batches as jax_run_batches

    jinteg = JaxIntegrator.create(ss.slab(ss.host("i3rc_tpu")),
                                  config=JaxConfig(use_ray_tracing=False, fastpath_unroll=1),
                                  surface_albedo=0.1)
    jst = jax_run_batches(jinteg, JaxSource.directional(0.5, 0.0), N, 16, seed=SEED,
                          mesh=jax_mesh(jax.devices()[:4]), derive=ss.domain_means,
                          derive_token="fluxes")
    tst = run_batches(port_integ(), PhotonSource.directional(0.5, 0.0), N, 16, seed=SEED + 1,
                      derive=ss.domain_means)
    for k in ("fup", "fdn", "fabs"):
        jm, js = float(jst.mean["derived"][k]), float(jst.stderr["derived"][k])
        tm, ts = float(tst.mean["derived"][k]), float(tst.stderr["derived"][k])
        assert abs(jm - tm) < 5 * np.hypot(js, ts), (k, jm, js, tm, ts)


def test_driver_under_two_ranks_writes_once(worlds):
    r0, r1 = worlds["driver"]
    assert r0["n_devices"] == r1["n_devices"] == 2
    assert r0["files"] == ["fluxes.out", "out.nc"] and r1["files"] == []
    # Batches round up to the ranks; both ranks hold the reduced means.
    assert r0["num_batches"] == r1["num_batches"] == 4
    assert r0["mean_stats"] == r1["mean_stats"]
    assert r0["processors"] == 2


def test_multi_device_modules_import_no_jax():
    """The new modules and chip_smoke.py load no jax and nothing of the JAX
    package (a fresh interpreter)."""
    import subprocess
    import sys

    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, "tests")
        import chip_smoke
        import sharded_scenes
        import i3rc_tpu_torch.parallel.checkpoint
        import i3rc_tpu_torch.parallel.mesh
        import i3rc_tpu_torch.parallel.sharded_domain
        import i3rc_tpu_torch.kernels.sharded_block
        import i3rc_tpu_torch.drivers.broadband_driver
        print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "i3rc_tpu")))
    """)
    out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True,
                         text=True, timeout=300, cwd=ROOT).stdout.strip()
    assert out == "[]"
