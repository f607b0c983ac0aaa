"""Independent photon batches and their statistics, on one device.

Port of ``i3rc_tpu/parallel/mesh.py:56-212`` for a single device.  Batch b
always uses the Philox key (seed, b), so results do not depend on how
batches are grouped.  First and second moments accumulate in float64 on the
device; the reference's statistical contract is
mean = sum(x)/n, stderr = sqrt((sum(x^2)/n - mean^2)/(n-1))
(monteCarloDriver.f95:358-378).  Spreading batches over several devices
with torch.distributed is ROADMAP item 19.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, is_dataclass, replace

import torch

from i3rc_tpu_torch.core.rng import batch_key


def tree_map(fn, *trees):
    """Apply fn leafwise over matching dicts / dataclasses of tensors."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(tr[k] for tr in trees)) for k in t}
    if is_dataclass(t):
        return replace(t, **{f.name: tree_map(fn, *(getattr(tr, f.name) for tr in trees))
                             for f in fields(t)})
    return fn(*trees)


@dataclass(frozen=True)
class BatchStats:
    """Mean and standard error over independent batches, per output field."""

    mean: object    # tree matching the per-batch result
    stderr: object
    n_batches: int

    def scaled(self, solar_flux: float) -> "BatchStats":
        """Scale by the incident solar flux (monteCarloDriver.f95:358-377)."""
        scale = lambda a: a * solar_flux
        return BatchStats(tree_map(scale, self.mean), tree_map(scale, self.stderr),
                          self.n_batches)


def run_batches(integrator, source, n_photons_per_batch: int, n_batches: int,
                seed: int = 10, derive=None, n_lanes: int | None = None,
                chunk_batches: int | None = None, optics_override=None) -> BatchStats:
    """Run independent photon batches and reduce their moments.

    ``derive``, if given, maps a per-batch Results to an extra tree whose
    moments accumulate alongside (e.g. domain means, whose standard error is
    not derivable from per-pixel moments, monteCarloDriver.f95:300-305); the
    stats trees are then dicts {"results": ..., "derived": ...}.

    ``chunk_batches`` bounds how many batches run between host reductions:
    each chunk's moments are copied to the host and summed there in float64,
    which gives the same sums as one pass.  ``optics_override`` (general-
    kernel optics of the integrator's shape) runs every batch with those
    optics: the spectral loop's traced mode.
    """
    n_batches = max(int(n_batches), 2)
    fn = integrator.batch_fn(source, n_photons_per_batch, n_lanes=n_lanes)
    chunk = int(chunk_batches) if chunk_batches else n_batches
    s1 = s2 = None
    for start in range(0, n_batches, chunk):
        c1 = c2 = None
        for b in range(start, min(start + chunk, n_batches)):
            res = (fn(batch_key(seed, b)) if optics_override is None
                   else fn(batch_key(seed, b), optics_override))
            out = res if derive is None else {"results": res, "derived": derive(res)}
            x = tree_map(lambda a: a.to(torch.float64), out)
            sq = tree_map(torch.square, x)
            c1 = x if c1 is None else tree_map(torch.add, c1, x)
            c2 = sq if c2 is None else tree_map(torch.add, c2, sq)
        c1, c2 = (tree_map(lambda a: a.cpu(), c) for c in (c1, c2))
        s1 = c1 if s1 is None else tree_map(torch.add, s1, c1)
        s2 = c2 if s2 is None else tree_map(torch.add, s2, c2)
    return stats_from_sums(s1, s2, n_batches)


def stats_from_sums(sum1, sum2, n_batches: int) -> BatchStats:
    """Mean + stderr from accumulated first/second moments (:358-378)."""
    mean = tree_map(lambda a: a / n_batches, sum1)
    stderr = tree_map(
        lambda a, b: torch.sqrt(torch.clamp(b / n_batches - torch.square(a / n_batches),
                                            min=0.0) / (n_batches - 1)),
        sum1, sum2)
    return BatchStats(mean=mean, stderr=stderr, n_batches=n_batches)
