"""Independent photon batches and their statistics over torch.distributed ranks.

Port of ``i3rc_tpu/parallel/mesh.py:35-212``.  The reference's distributed
backend is one MPI module: static batch partitioning across ranks,
independent random streams per batch and one MPI_REDUCE(SUM) of the moment
accumulators (Code/multipleProcesses_mpi.f95; monteCarloDriver.f95:264-348).
Here:

  * ranks             -> the ranks of a ``torch.distributed`` process group,
                         held with the rank's device in a ``Mesh`` (the JAX
                         package's 1-D ``"batch"`` mesh); NCCL between GPUs,
                         gloo on the CPU or between processes that share one
                         GPU (its buffers staged through host memory)
  * (iseed, batch)    -> the Philox key (seed, b) of global batch b, so a
                         batch draws the same numbers whatever the rank count
  * sumAcrossProcesses-> one ``all_reduce(SUM)`` of the float64 first and
                         second moments per chunk of batches
  * MasterProc I/O    -> ``mesh.rank == 0`` writes (the drivers)

Like the reference (monteCarloDriver.f95:268-271), the number of batches is
rounded up to divide evenly among ranks.  First and second moments
accumulate in float64; the statistical contract is mean = sum(x)/n, stderr =
sqrt((sum(x^2)/n - mean^2)/(n-1)) (monteCarloDriver.f95:358-378).

Not ported, on purpose: ``rng_impl`` (the TPU's ``rbg`` generator) and
``derive_token`` (a key for the XLA executable cache); PyTorch runs eagerly
and has no executable to reuse.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields, is_dataclass, replace

import torch
import torch.distributed as dist

from i3rc_tpu_torch.core.rng import batch_key
from i3rc_tpu_torch.integrators.integrator import resolve_device


def tree_map(fn, *trees):
    """Apply fn leafwise over matching dicts / dataclasses of tensors."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(tr[k] for tr in trees)) for k in t}
    if is_dataclass(t):
        return replace(t, **{f.name: tree_map(fn, *(getattr(tr, f.name) for tr in trees))
                             for f in fields(t)})
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a tree in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_from_leaves(template, leaves):
    """A tree shaped like ``template`` holding ``leaves`` in ``tree_leaves``'
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


@dataclass(frozen=True)
class Mesh:
    """A 1-D world of ranks: the process group (None for a world of one
    without ``torch.distributed``), this process's rank and the world's
    size, and the device this rank computes on."""

    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)


def _device(device) -> torch.device:
    """``device``, by default the current CUDA device: like every other entry
    point of the port, a mesh runs on the card unless the caller asks for
    the CPU, and raises when torch finds no card
    (``integrators.integrator.resolve_device``)."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_mesh(group=None, device=None) -> Mesh:
    """The world of ``group`` (by default the initialized default group), or
    with no group a world of one, on ``device`` (by default the current CUDA
    device; without a card only ``device="cpu"`` gives a mesh)."""
    dev = _device(device)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(None, 0, 1, dev)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), dev)


def initialize_multihost(device=None, **kwargs) -> Mesh:
    """Join the default process group and return its mesh: the
    initializeProcesses analog (multipleProcesses_mpi.f95:26-39).

    ``init_process_group`` reads torchrun's ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` unless ``kwargs`` name the
    ``init_method``, ``rank`` and ``world_size``.  On CUDA the rank takes
    ``cuda:LOCAL_RANK`` and NCCL; on the CPU gloo.  Output should be written
    by rank 0 alone (the MasterProc convention).
    """
    dev = _device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend="nccl" if dev.type == "cuda" else "gloo", **kwargs)
    return default_mesh(device=dev)


def all_reduce_sum(mesh: Mesh, flat: torch.Tensor) -> torch.Tensor:
    """The sum over the mesh's ranks of a 1-D tensor, returned on the CPU.
    NCCL sums on the rank's device; gloo on the CPU.  A world without a
    group returns it as it is, on the CPU."""
    if mesh.group is None:
        return flat.cpu()
    if mesh.backend == "nccl":
        buf = flat.to(mesh.device)
        dist.all_reduce(buf, group=mesh.group)
        return buf.cpu()
    buf = flat.cpu().clone()
    dist.all_reduce(buf, group=mesh.group)
    return buf


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
                chunk_batches: int | None = None, optics_override=None,
                mesh: Mesh | None = None, batch_offset: int = 0,
                _return_sums: bool = False) -> BatchStats:
    """Run independent photon batches over the mesh's ranks and reduce
    their moments.

    ``n_batches`` is rounded up to a multiple of the rank count; rank r runs
    global batches ``batch_offset + r * per_rank + i`` (per chunk of
    batches, from the chunk's offset), batch b with the key (seed, b), so
    the result does not depend on how many ranks run it.  ``mesh`` defaults
    to ``default_mesh`` on the integrator's device.

    ``derive``, if given, maps a per-batch Results to an extra tree whose
    moments accumulate alongside (e.g. domain means, whose standard error is
    not derivable from per-pixel moments, monteCarloDriver.f95:300-305); the
    stats trees are then dicts {"results": ..., "derived": ...}.

    ``chunk_batches`` bounds how many batches a rank runs between
    reductions: each chunk's float64 moments are summed over the ranks by
    one ``all_reduce`` and then on the host, which gives the same sums as one
    pass.  ``optics_override`` (general-kernel optics of the integrator's
    shape) runs every batch with those optics: the spectral loop's traced
    mode.  ``_return_sums`` returns (sum1, sum2, n_batches), the summed
    moments on the CPU, and takes ``n_batches`` as given (a resume's chunk).
    """
    mesh = mesh or default_mesh(device=integrator.device)
    n_dev = mesh.size
    if not _return_sums:
        n_batches = max(int(n_batches), 2)
    per_dev = -(-int(n_batches) // n_dev)  # round up to divide evenly (:268-271)
    n_batches = per_dev * n_dev
    fn = integrator.batch_fn(source, n_photons_per_batch, n_lanes=n_lanes)
    chunk = int(chunk_batches) if chunk_batches else per_dev
    s1 = s2 = None
    for start in range(0, per_dev, chunk):
        take = min(chunk, per_dev - start)
        first = batch_offset + start * n_dev + mesh.rank * take
        c1 = c2 = None
        for b in range(first, first + take):
            res = (fn(batch_key(seed, b)) if optics_override is None
                   else fn(batch_key(seed, b), optics_override))
            out = res if derive is None else {"results": res, "derived": derive(res)}
            x = tree_map(lambda a: a.to(torch.float64), out)
            sq = tree_map(torch.square, x)
            c1 = x if c1 is None else tree_map(torch.add, c1, x)
            c2 = sq if c2 is None else tree_map(torch.add, c2, sq)
        # sumAcrossProcesses: one all_reduce of both moments' leaves.
        leaves = tree_leaves(c1) + tree_leaves(c2)
        flat = all_reduce_sum(mesh, torch.cat([a.reshape(-1) for a in leaves]))
        parts = iter(torch.split(flat, [a.numel() for a in leaves]))
        sums = [p.reshape(a.shape) for p, a in zip(parts, leaves)]
        half = len(leaves) // 2
        c1, c2 = tree_from_leaves(c1, sums[:half]), tree_from_leaves(c2, sums[half:])
        s1 = c1 if s1 is None else tree_map(torch.add, s1, c1)
        s2 = c2 if s2 is None else tree_map(torch.add, s2, c2)
    if _return_sums:
        return s1, s2, n_batches
    return stats_from_sums(s1, s2, n_batches)


def stats_from_sums(sum1, sum2, n_batches: int) -> BatchStats:
    """Mean + stderr from accumulated first/second moments (:358-378)."""
    mean = tree_map(lambda a: a / n_batches, sum1)
    stderr = tree_map(
        lambda a, b: torch.sqrt(torch.clamp(b / n_batches - torch.square(a / n_batches),
                                            min=0.0) / (n_batches - 1)),
        sum1, sum2)
    return BatchStats(mean=mean, stderr=stderr, n_batches=n_batches)
