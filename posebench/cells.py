"""Finds a cell's parts by name.

A cell is one entry of BENCHMARK.json's `workloads`: it names a
configuration and a traffic mix. Everything else is found from those
names, so that a later change adds a configuration, a mix, a cell or a
per-layer metric by adding files and entries, and edits none:

  configs/<config>.json          the configuration as it is served
  traffic/<mix>.json             the traffic mix's parameters
  limits/<cell>.json             the limits of the numbers `correct` compares
  layer_metrics/<metric>.py      a per-layer metric: read(record) -> number
                                 or None (nothing to read)
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list        # BENCHMARK.json's metric entries
    per_layer: list


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(name: str, root: str = ROOT, here: str = HERE) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its parts from here."""
    bench = _read(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"posebench: no workload {name!r} in BENCHMARK.json")
    config = _read(os.path.join(here, "configs", entry["config"] + ".json"))
    return Cell(name=name, chips=entry["chips"], config=config,
                traffic=_read(os.path.join(here, "traffic", entry["traffic"] + ".json")),
                limits=_read(os.path.join(here, "limits", name + ".json")),
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def reader(metric: str, here: str = HERE):
    """The read(record) function of layer_metrics/<metric>.py."""
    path = os.path.join(here, "layer_metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"posebench.layer_metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
