"""SB's plain version on the CPU (``kernels/sharded_block.py``): the shadow
rays of a rank's pool, K cell-DDA steps of each ray in flight
(``shadow_advance_reference``), at a mid-flight and a tail block of the
detector and graft scenes of ``tests/sharded_scenes.py`` on a world of one.
Rays do not interact: each ray run alone to its escape, its tag or its K-th
step, in a shuffled order (what the kernel's queue does), leaves the pool
bit for bit as the plain version does, with the radiance tallies within
1e-12 relative (only the order of the float64 sums differs), and its census
(rays, steps, escapes, tagged rays, counted ray by ray) equals
``sharded_scenes.shadow_census`` of the plain version's pool.  The pack's
free slots, sent slots and counts are held against the pool in
``tests/test_torch_sharded_block.py``.

Imports no JAX.
"""

import numpy as np
import pytest
import torch

import sharded_scenes as ss
from i3rc_tpu_torch.kernels import sharded_block as sb

PHOTONS, LANES = 1 << 10, 512
STATES = ("mid", "tail")


@pytest.fixture(scope="module", params=["detectors", "graft"])
def kept(request):
    """A trace of the scene on a world of one on the CPU, with SB's inputs
    at its mid-flight and its first tail block."""
    st = ss.trace_states(ss.scene(request.param, ss.host("i3rc_tpu_torch"), 1), PHOTONS, LANES,
                         "cpu")
    assert len(st["sb"]) == 2, [kb for kb, _, _ in st["sb"]]
    return st


def per_ray(spec, pool0, seed: int):
    """Each ray in flight of ``pool0``, in a shuffled order, run alone
    (``shadow_step`` on a pool of its one slot) to its escape, its tag or
    its K-th step: the pool and tallies this leaves, and its census."""
    pool = pool0.clone()
    n = spec.nx_loc * spec.n_y * spec.n_dirs
    acc_int = torch.zeros(n, dtype=torch.float64)
    acc_byc = torch.zeros(n * (spec.n_comp + 1), dtype=torch.float64)
    live = ((pool0.i[sb.QALIVE] != 0) & (pool0.i[sb.QTAG] == 0)).nonzero()[:, 0]
    order = np.random.default_rng(seed).permutation(live.numel())
    census = {"rays": live.numel(), "steps": 0, "escapes": 0, "tagged": 0}
    for r in live[torch.as_tensor(order, dtype=torch.long)].tolist():
        one = sb.RayPool(pool.f[:, r:r + 1].clone(), pool.i[:, r:r + 1].clone())
        for _ in range(spec.K):
            sb.shadow_step(spec, one, acc_int, acc_byc)
            census["steps"] += 1
            if one.i[sb.QALIVE, 0] == 0 or one.i[sb.QTAG, 0] != 0:
                break
        census["escapes"] += int(one.i[sb.QALIVE, 0] == 0)
        census["tagged"] += int(one.i[sb.QTAG, 0] != 0)
        pool.f[:, r], pool.i[:, r] = one.f[:, 0], one.i[:, 0]
    return pool, acc_int, acc_byc, census


@pytest.mark.parametrize("state", STATES)
def test_rays_in_any_order_equal_the_plain_version(kept, state):
    spec = kept["spec"]
    _, pool0, _ = kept["sb"][STATES.index(state)]
    pool, acc_int, acc_byc, census = per_ray(spec, pool0, seed=11)
    ref = pool0.clone()
    n = spec.nx_loc * spec.n_y * spec.n_dirs
    r_int = torch.zeros(n, dtype=torch.float64)
    r_byc = torch.zeros(n * (spec.n_comp + 1), dtype=torch.float64)
    sb.shadow_advance_reference(spec, ref, r_int, r_byc)
    assert census["rays"] > 0 and census["escapes"] > 0
    assert census == ss.shadow_census(pool0, ref), census
    assert census["steps"] >= census["rays"] and census["steps"] <= spec.K * census["rays"]
    assert torch.equal(pool.f, ref.f) and torch.equal(pool.i, ref.i)
    for got, want in ((acc_int, r_int), (acc_byc, r_byc)):
        assert float(want.sum()) > 0.0
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().sum())
