"""Batch-level checkpoint and exact resume of long Monte Carlo runs.

Port of ``i3rc_tpu/parallel/checkpoint.py``.  Batches are independent and
batch b always draws from the Philox key (seed, b), so the accumulated
float64 first and second moments and the number of finished batches are a
complete checkpoint: ``run_batches_resumable`` runs batches in chunks,
replaces an ``.npz`` file atomically after each chunk and, started again,
continues from the file.  The resumed result equals the single pass.

The file carries a fingerprint of the run: a SHA-256 over everything that
decides its batches: the seed, the photons per batch, the grid's edges, the
optics, the source's fields, the integrator's configuration, its surface,
its detector directions and spectral k tables, the name of ``derive`` and
``run_batches``' other arguments (``n_lanes``, ``optics_override``).  A file
of another run is ignored and the run starts over; a file that holds more
batches than the run asks for is refused.  The JAX
package's fingerprint holds the salted ``hash(source)``
(``i3rc_tpu/parallel/checkpoint.py:27-31``), which differs between two
interpreters, so there a resume in a fresh process restarts without a word;
this digest is the same in every process.

On a mesh every rank reads the file, and rank 0 alone writes it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os

import numpy as np
import torch

from i3rc_tpu_torch.parallel.mesh import (all_reduce_sum, default_mesh, run_batches,
                                          stats_from_sums, tree_leaves, tree_map)


def _feed(h, obj) -> None:
    """Hash ``obj`` by content: arrays and tensors by dtype, shape and
    bytes, dataclasses and mappings field by field, functions by name."""
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        h.update(str(("array", arr.dtype.str, arr.shape)).encode())
        h.update(arr.tobytes())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        h.update(f"<{type(obj).__qualname__}>".encode())
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _feed(h, getattr(obj, f.name))
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            h.update(repr(k).encode())
            _feed(h, obj[k])
    elif isinstance(obj, (list, tuple)):
        h.update(f"<{len(obj)}>".encode())
        for v in obj:
            _feed(h, v)
    elif callable(obj):
        h.update(f"{getattr(obj, '__module__', '')}.{getattr(obj, '__qualname__', '')}".encode())
    else:
        h.update(repr(obj).encode())


def fingerprint(integrator, source, n_photons_per_batch: int, seed: int, derive=None,
                **kwargs) -> str:
    """Hex SHA-256 of what decides a run's batches: the seed, the photons
    per batch, the grid's edges, the flattened optics, the source, the
    integrator's configuration, surface, detectors and k tables, the name
    of ``derive`` and the other arguments of ``run_batches``."""
    h = hashlib.sha256()
    g = integrator.geometry
    flat = integrator._flat
    _feed(h, [int(seed), int(n_photons_per_batch), g.x_edges, g.y_edges, g.z_edges,
              flat.total_ext, flat.cumulative_ext, flat.ssa, flat.phase_index,
              dataclasses.asdict(source), integrator.config, integrator.surface.albedo]
          + [getattr(integrator, k, None) for k in ("_surface_arg", "_intensity_mus",
                                                     "_intensity_phis", "_gas_k")]
          + [derive, kwargs])
    return h.hexdigest()


def _spec(tree):
    """A JSON description of a tree's nodes (dicts and the port's dataclasses)."""
    if isinstance(tree, dict):
        return {"dict": {k: _spec(v) for k, v in tree.items()}}
    if dataclasses.is_dataclass(tree):
        return {"class": f"{type(tree).__module__}:{type(tree).__qualname__}",
                "fields": {f.name: _spec(getattr(tree, f.name))
                           for f in dataclasses.fields(tree)}}
    return None


def _build(spec, leaves):
    if spec is None:
        return next(leaves)
    if "dict" in spec:
        return {k: _build(v, leaves) for k, v in spec["dict"].items()}
    module, name = spec["class"].split(":")
    if not module.startswith("i3rc_tpu_torch."):
        raise ValueError(f"checkpoint names a class outside the package: {spec['class']}")
    cls = getattr(importlib.import_module(module), name)
    return cls(**{k: _build(v, leaves) for k, v in spec["fields"].items()})


def save_checkpoint(path: str, sum1, sum2, batches_done: int, fp: str) -> None:
    """Write the moments, the batches done and the fingerprint to ``path``
    (a temporary file, then an atomic replace)."""
    l1, l2 = tree_leaves(sum1), tree_leaves(sum2)
    payload = {f"s1_{i}": a.cpu().numpy() for i, a in enumerate(l1)}
    payload.update({f"s2_{i}": a.cpu().numpy() for i, a in enumerate(l2)})
    payload["batches_done"] = np.int64(batches_done)
    payload["fingerprint"] = np.array(fp)
    payload["tree"] = np.array(json.dumps(_spec(sum1)))
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, fp: str):
    """(sum1, sum2, batches_done) from ``path``, or None when the file is
    absent or holds another run (another fingerprint)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        if str(data["fingerprint"]) != fp:
            return None
        spec = json.loads(str(data["tree"]))
        n = sum(1 for k in data.files if k.startswith("s1_"))
        s1 = _build(spec, iter(torch.from_numpy(data[f"s1_{i}"]) for i in range(n)))
        s2 = _build(spec, iter(torch.from_numpy(data[f"s2_{i}"]) for i in range(n)))
        return s1, s2, int(data["batches_done"])


def run_batches_resumable(integrator, source, n_photons_per_batch: int, n_batches: int,
                          seed: int = 10, mesh=None, derive=None, checkpoint_path: str = "",
                          chunk_batches: int = 0, **kwargs):
    """``run_batches`` with a moment checkpoint after every chunk of
    ``chunk_batches`` batches (rounded up to the ranks) and exact resume
    from ``checkpoint_path``; ``kwargs`` go to ``run_batches``."""
    mesh = mesh or default_mesh(device=integrator.device)
    n_dev = mesh.size
    chunk = max(int(chunk_batches) or n_dev, n_dev)
    chunk = -(-chunk // n_dev) * n_dev
    n_batches = max(int(n_batches), 2)
    n_batches = -(-n_batches // n_dev) * n_dev

    fp = fingerprint(integrator, source, n_photons_per_batch, seed, derive, **kwargs)
    sum1 = sum2 = None
    done = 0
    if checkpoint_path:
        state = load_checkpoint(checkpoint_path, fp)
        if state is not None:
            sum1, sum2, done = state
        if done > n_batches:
            raise ValueError(f"{checkpoint_path} holds {done} batches of this run, more than "
                             f"the {n_batches} asked for")
        # Every rank must resume from the same batch: the square of the sum
        # of the ranks' counts equals n_dev times the sum of their squares
        # only when they are all equal.
        seen = all_reduce_sum(mesh, torch.tensor([done, done * done], dtype=torch.float64))
        if float(seen[0]) ** 2 != n_dev * float(seen[1]):
            raise RuntimeError(f"ranks disagree on the checkpoint's batches ({checkpoint_path})")

    while done < n_batches:
        todo = min(chunk, n_batches - done)
        c1, c2, _ = run_batches(integrator, source, n_photons_per_batch, todo, seed=seed,
                                mesh=mesh, derive=derive, batch_offset=done,
                                _return_sums=True, **kwargs)
        if sum1 is None:
            sum1, sum2 = c1, c2
        else:
            sum1 = tree_map(torch.add, sum1, c1)
            sum2 = tree_map(torch.add, sum2, c2)
        done += todo
        if checkpoint_path and mesh.rank == 0:
            save_checkpoint(checkpoint_path, sum1, sum2, done, fp)
    return stats_from_sums(sum1, sum2, done)
