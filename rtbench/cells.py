"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``):
each names a configuration and a traffic mix.  Everything else is found by
name, so that a later cell, configuration, mix or metric is new files and
new entries, never an edit:

  rtbench/configs/<config>.py     the scene and the integrator's settings
  rtbench/traffic/<traffic>.json  photons a batch, lanes, detectors, albedo
  rtbench/cells/<workload>.json   the reference's size and the limits of
                                  the comparison that decides ``correct``
  rtbench/metrics/<metric>.py     the reader of one per-layer metric
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    config: ModuleType
    traffic_name: str
    traffic: dict
    cell: dict
    chips: int
    end_to_end: list
    per_layer: list       # the per-layer metrics whose reader this cell runs


def _module(path: Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(f"rtbench_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def metric_reader(name: str, here: Path = HERE):
    """The ``read(ctx)`` of ``rtbench/metrics/<name>.py``."""
    return _module(here / "metrics" / f"{name}.py").read


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell named ``workload`` of ``BENCHMARK.json`` with its parts."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[workload]
    return Cell(
        name=workload, config_name=w["config"],
        config=_module(here / "configs" / f"{w['config']}.py"),
        traffic_name=w["traffic"], traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        cell=_json(here / "cells" / f"{workload}.json"), chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)])
