"""Where the benchmark's pieces live, found by name.

`BENCHMARK.json` at the root of the checkout names the cells, the
configurations, the traffic mixes and the metrics. Each has files of its
own under `benchmark/`:
  - a cell: `workloads/<cell>.json` (the limits its correctness check
    compares against),
  - a configuration: `configs/<config>.json` (the model as it is run, the
    rule that draws its weights, its FLOPs a frame, and its `family`:
    `arctic_sf` where the key is absent),
  - a model family: `families/<family>.py` (the port's model and step, the
    plain reference's, the MSDA calls a step makes and the model that the
    FLOPs are counted on; the interface is `families/__init__.py`'s),
  - a traffic mix: `traffic/<traffic>.json` (the loop, the batch, the
    split, the synthetic root),
  - a metric: `metrics/<metric>.py`, a reader with `read(readings)`.
A later cell, configuration, mix or metric is a new file and a new entry,
never an edit here. So is a configuration of another model family: it
brings its module `families/<family>.py`, its own plain reference (under
`reference/` or `families/`, importing nothing of the port), its
configuration, traffic and cell files, and the entries that name them.
"""

from __future__ import annotations

import functools
import glob
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

#: the checkout's root (the parent of this package)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the family of a configuration that names none
DEFAULT_FAMILY = "arctic_sf"


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of `workloads` with the files it names."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    root: str = ROOT

    @property
    def family(self):
        """The module of the configuration's family."""
        return family(self.config, self.root)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json with its configuration,
    traffic, limits and the metrics it reports. Raises KeyError for an
    unknown cell."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    here = os.path.join(root, "benchmark")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = _json(os.path.join(here, "traffic", f"{entry['traffic']}.json"))
    cell_file = _json(os.path.join(here, "workloads", f"{name}.json"))
    for key in ("config", "traffic"):
        if cell_file.get(key, entry[key]) != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} {cell_file[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")

    def reports(metric: dict, e2e_names) -> bool:
        if "workloads" in metric:
            return name in metric["workloads"]
        return metric.get("moves", metric["name"]) in e2e_names

    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, e2e_names)]
    family(config, root)  # an unknown family fails here, before any set-up
    return Cell(name, entry, config, traffic, dict(cell_file.get("limits", {})), e2e, per_layer,
                root)


def family(config: dict, root: str = ROOT):
    """The module `benchmark/families/<family>.py` of `root` that the
    configuration names (`arctic_sf` where it names none). Raises
    ValueError for an unknown family, naming those there are."""
    name = config.get("family", DEFAULT_FAMILY)
    here = os.path.join(root, "benchmark", "families")
    path = os.path.join(here, f"{name}.py")
    if not os.path.isfile(path):
        known = sorted(os.path.splitext(os.path.basename(p))[0]
                       for p in glob.glob(os.path.join(here, "*.py")))
        raise ValueError(f"no model family {name!r}; families: "
                         f"{[k for k in known if k != '__init__']}")
    return _load(path, "benchmark_family_" + name)


@functools.lru_cache(maxsize=None)
def _load(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: str = ROOT) -> Callable:
    """`read` of `benchmark/metrics/<metric>.py`."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[dict], readings, root: str = ROOT) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader finds something
    to read (a reader that finds nothing returns None and the metric is
    left out)."""
    out = {}
    for m in metrics:
        value: Optional[float] = reader(m["name"], root)(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
