"""What `BENCHMARK.json` names, found by name in files of their own.

A configuration is the JSON file its entry names; a traffic mix is
`traffic/<name>.json`; the loop a mix drives is `modes/<mode>.py`; a metric
is read by `metrics/<name>.py`; a db's genome recipe is
`recipes/<recipe>.py`.  A later cell, configuration, mix, metric or
recipe is a new file and a new entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: pathlib.Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """BENCHMARK.json and the files it names."""

    def __init__(self, path: pathlib.Path = ROOT / "BENCHMARK.json"):
        self.doc = load_json(path)

    def workload(self, name: str) -> dict:
        for wl in self.doc["workloads"]:
            if wl["name"] == name:
                return wl
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_file(self, name: str) -> pathlib.Path:
        for cfg in self.doc["configs"]:
            if cfg["name"] == name:
                return ROOT / cfg["file"]
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The metrics a run of `workload` reports: the end-to-end ones
        untraced, the per-layer ones traced."""
        group = self.doc["per_layer"] if trace else self.doc["end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def mode(name: str):
    return _module(HERE / "modes" / f"{name}.py", f"benchmark_mode_{name}")


def reader(metric: str):
    return _module(HERE / "metrics" / f"{metric}.py",
                   "benchmark_metric_" + metric.replace(".", "_"))


def recipe_file(name: str) -> pathlib.Path:
    return HERE / "recipes" / f"{name}.py"


def recipe(name: str):
    return _module(recipe_file(name), f"benchmark_recipe_{name}")
