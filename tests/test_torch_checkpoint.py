"""Checkpoint and exact resume of the port's batch runs
(``i3rc_tpu_torch/parallel/checkpoint.py``).

A resumable run equals the single pass bit for bit; a resume in a fresh
interpreter continues from the file (it runs only the batches left); a
change of seed, photon count, grid, source, surface, configuration,
detectors or lane count restarts, and a file of a longer run is refused.  The JAX package's
fingerprint holds the salted ``hash(source)``
(``i3rc_tpu/parallel/checkpoint.py:27-31``): two interpreters with other
``PYTHONHASHSEED`` values give two fingerprints, so there a resume in a fresh
process restarts without a word.  The port's content digest is the same in
every interpreter; the last two tests state both.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from i3rc_tpu_torch import Domain, Integrator, IntegratorConfig, PhotonSource
from i3rc_tpu_torch.core.phase_functions import (
    PhaseFunction,
    PhaseFunctionTable,
    henyey_greenstein_coefficients,
)
from i3rc_tpu_torch.parallel import checkpoint as ckpt
from i3rc_tpu_torch.parallel.mesh import run_batches, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
SRC = PhotonSource.directional(0.5, 0.0)
N = 512          # photons a batch
B = 8            # batches


def slab(levels: int = 3, tau: float = 2.0):
    """tests/test_checkpoint.py's slab: HG 0.85, ssa 0.99, over an albedo."""
    table = PhaseFunctionTable.from_phase_functions(
        [PhaseFunction.from_legendre(henyey_greenstein_coefficients(0.85, 32))], key=[1.0])
    dom = Domain.create([0, 500.0], [0, 500.0], np.linspace(0, 250.0, levels))
    ext = np.full((1, 1, levels - 1), tau / 250.0)
    return dom.add_component("cloud", ext, np.full_like(ext, 0.99),
                             np.zeros(ext.shape, np.int32), table)


def make_integ(levels: int = 3, albedo: float = 0.1, max_events: int = 1000, mus=None):
    return Integrator.create(slab(levels), IntegratorConfig(use_ray_tracing=False,
                                                            max_events=max_events),
                             surface_albedo=albedo, intensity_mus=mus,
                             intensity_phis=None if mus is None else [0.0] * len(mus),
                             device="cpu")


@pytest.fixture(scope="module")
def integ():
    return make_integ()


def derive(res):
    return {"fup": res.mean_flux_up, "fabs": res.mean_flux_absorbed}


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_resumable_equals_single_pass(integ, tmp_path):
    """Chunks of 2 with a checkpoint after each equal run_batches in chunks
    of 2 bit for bit, and the one-chunk pass to float64 rounding."""
    ck = str(tmp_path / "run.npz")
    got = ckpt.run_batches_resumable(integ, SRC, N, B, seed=5, derive=derive,
                                     checkpoint_path=ck, chunk_batches=2)
    ref = run_batches(integ, SRC, N, B, seed=5, derive=derive, chunk_batches=2)
    assert got.n_batches == B and same(got.mean, ref.mean) and same(got.stderr, ref.stderr)
    whole = run_batches(integ, SRC, N, B, seed=5, derive=derive)
    for a, b in zip(tree_leaves(got.mean), tree_leaves(whole.mean)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-15)
    s1, s2, done = ckpt.load_checkpoint(ck, ckpt.fingerprint(integ, SRC, N, 5, derive))
    assert done == B
    assert float(s1["derived"]["fup"]) == pytest.approx(B * float(got.mean["derived"]["fup"]))


def test_resume_in_a_subprocess_continues(integ, tmp_path):
    """Stop after half the batches here; a fresh interpreter (another
    PYTHONHASHSEED) finishes from the file, running only the batches left,
    and its result equals the single pass exactly."""
    ck = str(tmp_path / "half.npz")
    ckpt.run_batches_resumable(integ, SRC, N, B // 2, seed=5, derive=derive,
                               checkpoint_path=ck, chunk_batches=2)
    out = tmp_path / "resumed.json"
    code = textwrap.dedent(f"""
        import json, sys, torch
        sys.path.insert(0, {str(ROOT / 'tests')!r})
        from test_torch_checkpoint import SRC, N, B, derive, make_integ
        from i3rc_tpu_torch.parallel import checkpoint as ckpt
        offsets = []
        run = ckpt.run_batches
        def counted(*a, **kw):
            offsets.append(kw["batch_offset"])
            return run(*a, **kw)
        ckpt.run_batches = counted
        st = ckpt.run_batches_resumable(make_integ(), SRC, N, B, seed=5, derive=derive,
                                        checkpoint_path={ck!r}, chunk_batches=2)
        json.dump({{"offsets": offsets, "n": st.n_batches,
                   "fup": float(st.mean["derived"]["fup"]).hex(),
                   "fup_se": float(st.stderr["derived"]["fup"]).hex(),
                   "flux_up": [float(v).hex() for v in st.mean["results"].flux_up.flatten()]}},
                  open({str(out)!r}, "w"))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONHASHSEED="12345")
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=300, cwd=ROOT)
    got = json.loads(out.read_text())
    assert got["offsets"] == [4, 6] and got["n"] == B
    ref = run_batches(integ, SRC, N, B, seed=5, derive=derive, chunk_batches=2)
    assert float.fromhex(got["fup"]) == float(ref.mean["derived"]["fup"])
    assert float.fromhex(got["fup_se"]) == float(ref.stderr["derived"]["fup"])
    assert [float.fromhex(v) for v in got["flux_up"]] == ref.mean["results"].flux_up.flatten(
    ).tolist()


@pytest.mark.parametrize("change", ["seed", "photons", "grid", "source", "albedo", "config",
                                    "detectors", "n_lanes"])
def test_changed_run_restarts(integ, tmp_path, change):
    """A checkpoint of another seed, photon count, grid, source, surface
    albedo, integrator configuration, detector set or lane count is not
    resumed: the run starts over from batch 0 and equals its own single
    pass."""
    ck = str(tmp_path / "fp.npz")
    ckpt.run_batches_resumable(integ, SRC, N, 2, seed=5, checkpoint_path=ck, chunk_batches=2)
    run = dict(integrator=integ, source=SRC, n_photons_per_batch=N, seed=5)
    kw = {}
    if change == "seed":
        run["seed"] = 6
    elif change == "photons":
        run["n_photons_per_batch"] = N + 64
    elif change == "grid":
        run["integrator"] = make_integ(levels=4)
    elif change == "source":
        run["source"] = PhotonSource.directional(0.6, 0.0)
    elif change == "albedo":
        run["integrator"] = make_integ(albedo=0.2)
    elif change == "config":
        run["integrator"] = make_integ(max_events=500)
    elif change == "detectors":
        run["integrator"] = make_integ(mus=[1.0, 0.5])
    else:
        kw["n_lanes"] = 256
    fp = ckpt.fingerprint(run["integrator"], run["source"], run["n_photons_per_batch"],
                          run["seed"], **kw)
    assert fp != ckpt.fingerprint(integ, SRC, N, 5)
    assert ckpt.load_checkpoint(ck, fp) is None
    offsets = []

    def counted(*a, **k):
        offsets.append(k["batch_offset"])
        return run_batches(*a, **k)

    orig, ckpt.run_batches = ckpt.run_batches, counted
    try:
        got = ckpt.run_batches_resumable(run["integrator"], run["source"],
                                         run["n_photons_per_batch"], 4, seed=run["seed"],
                                         checkpoint_path=ck, chunk_batches=2, **kw)
    finally:
        ckpt.run_batches = orig
    ref = run_batches(run["integrator"], run["source"], run["n_photons_per_batch"], 4,
                      seed=run["seed"], chunk_batches=2, **kw)
    assert offsets == [0, 2] and got.n_batches == 4 and same(got.mean, ref.mean)


def test_longer_checkpoint_is_refused(integ, tmp_path):
    """A file that holds more batches of the run than asked for is not
    returned as the shorter run's result."""
    ck = str(tmp_path / "long.npz")
    ckpt.run_batches_resumable(integ, SRC, N, 4, seed=5, checkpoint_path=ck, chunk_batches=2)
    with pytest.raises(ValueError, match="holds 4 batches"):
        ckpt.run_batches_resumable(integ, SRC, N, 2, seed=5, checkpoint_path=ck)


def _fingerprints(code: str, seeds=("1", "2")) -> list:
    out = []
    for s in seeds:
        env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONHASHSEED=s, JAX_PLATFORMS="cpu")
        out.append(subprocess.run([sys.executable, "-c", code], check=True, env=env,
                                  capture_output=True, text=True, timeout=300,
                                  cwd=ROOT).stdout.strip())
    return out


def test_jax_fingerprint_differs_between_interpreters():
    """The reference fault the port does not copy: JAX's fingerprint of one
    run in two interpreters with other PYTHONHASHSEED values."""
    code = textwrap.dedent("""
        from types import SimpleNamespace
        from i3rc_tpu.core.illumination import PhotonSource
        from i3rc_tpu.parallel.checkpoint import _fingerprint
        g = SimpleNamespace(geometry=SimpleNamespace(n_x=1, n_y=1, n_z=2))
        print(_fingerprint(g, PhotonSource.directional(0.5, 0.0), 512, 5).tolist())
    """)
    a, b = _fingerprints(code)
    assert a != b


def test_port_fingerprint_is_the_same_in_every_interpreter(integ):
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, "tests")
        from test_torch_checkpoint import SRC, N, make_integ
        from i3rc_tpu_torch.parallel.checkpoint import fingerprint
        print(fingerprint(make_integ(), SRC, N, 5))
    """)
    a, b = _fingerprints(code)
    assert a == b == ckpt.fingerprint(integ, SRC, N, 5)
