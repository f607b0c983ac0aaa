"""Faults planted under the timed path, for the checks that ``correct`` must fail.

Each is ``fault(fn, integ, source, traffic) -> fn'``, which ``run.run_cell``
takes as its ``program``: ``fn`` is the port's batch function.

  unchanged   a batch returns the state it had (the first batch's fields,
              again and again);
  half        half of each batch traced, the mean taken over that half:
              the mean stays, a batch holds half the independent photons
              it reports, as when half of the lanes repeat the other
              half's random keys;
  lost        an answer altered where it is produced: the upward flux of
              the first half of the columns (in x) lost.
"""

import dataclasses

from rtbench import port


def unchanged(fn, integ, source, traffic):
    first = []

    def f(key):
        if not first:
            first.append(fn(key))
        return first[0]
    return f


def half(fn, integ, source, traffic):
    return port.batch_fn(integ, source,
                         dict(traffic, photons_per_batch=traffic["photons_per_batch"] // 2))


def lost(fn, integ, source, traffic):
    def f(key):
        r = fn(key)
        up = r.flux_up.clone()
        up[: up.shape[0] // 2] = 0.0
        return dataclasses.replace(r, flux_up=up)
    return f


FAULTS = {f.__name__: f for f in (unchanged, half, lost)}
