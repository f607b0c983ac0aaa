"""Helpers of the benchmark's own tests: its cells cut to a size the CPU runs in seconds."""

import dataclasses
import types

import pytest

from rtbench import cells


def tiny_cell(name: str, photons: int = 1 << 12, lanes: int = 1 << 10,
              ref_photons: int = 1 << 13, ref_batches: int = 32, block=None) -> cells.Cell:
    """The cell ``name`` with its photons, lanes and reference cut to test
    size, and with ``block`` its columns pooled more coarsely (a few
    photons a column a batch make no normal mean); its limits as
    committed."""
    c = cells.load(name)
    if block is not None:
        attrs = {k: v for k, v in vars(c.config).items() if not k.startswith("__")}
        c = dataclasses.replace(c, config=types.SimpleNamespace(**dict(attrs,
                                                                         COMPARE_BLOCK=block)))
    return dataclasses.replace(
        c, traffic=dict(c.traffic, photons_per_batch=photons, lanes=lanes),
        cell=dict(c.cell, reference=dict(photons_per_batch=ref_photons, batches=ref_batches)))


@pytest.fixture
def tiny():
    return tiny_cell
