"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the file its entry names (``configs/<name>.json``);
- its architecture: the module ``arch/<model_type>.py`` that the file's
  ``model_type`` names (``arch/__init__.py``): the program's configuration
  and weights, the plain reference and the work counts;
- a traffic mix: ``traffic/<traffic>.json``, whose ``generator`` names a
  module ``generators/<generator>.py`` with ``build(params, seed, vocab,
  max_context, block_tokens)``;
- a metric: ``metrics/<name>.py`` with ``read(run) -> float or None``
  (``records.Run``); None leaves the metric out of the result;
- a cell's correctness limits: ``cells/<cell>.json``.

A later benchmark adds a cell, a configuration, an architecture, a mix or a
metric by adding files and entries; nothing here names one.
"""

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List

from . import arch as arch_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Metric:
    name: str
    unit: str
    path: str

    def read(self, run):
        return _load_module(self.path, "h100bench_metric_" + self.name.replace(".", "_")).read(run)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic_params: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    arch: Any = field(init=False)  # arch/<model_type>.py

    def __post_init__(self):
        self.arch = arch_mod.find(self.config.get("model_type"))

    def traffic(self, seed: int):
        gen = _load_module(os.path.join(HERE, "generators", self.traffic_params["generator"] + ".py"),
                           "h100bench_generator_" + self.traffic_params["generator"])
        return gen.build(self.traffic_params, seed, self.config["vocab_size"],
                         self.config["max_context"], self.config["block_tokens"])


def load(path: str = os.path.join(ROOT, "BENCHMARK.json")) -> dict:
    return _json(path)


def _metrics(entries: List[dict], cell: str) -> List[Metric]:
    return [Metric(m["name"], m["unit"], os.path.join(HERE, "metrics", m["name"] + ".py"))
            for m in entries if "workloads" not in m or cell in m["workloads"]]


def cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=w["chips"],
        config=_json(os.path.join(root, conf["file"])),
        traffic_params=_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(HERE, "cells", name + ".json")),
        end_to_end=_metrics(bench["end_to_end"], name),
        per_layer=_metrics(bench["per_layer"], name),
    )
