"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix.  A
configuration is the JSON file its ``configs`` entry gives, which names
its generator (``gen/<generator>.py``) and its plain reference
(``reference/<reference>.py``).  A mix is ``mixes/<traffic>.json``.  A
per-layer metric is ``metrics/<name>.py``, with ``read(run)``.  Adding any
of them is adding a file and an entry: nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Spec:
    """The benchmark as ``BENCHMARK.json`` describes it."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.here = os.path.join(root, "benchmark")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, workload: dict) -> dict:
        """The cell's configuration file, as a dict."""
        for c in self.data["configs"]:
            if c["name"] == workload["config"]:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {workload['config']!r} in BENCHMARK.json")

    def mix(self, workload: dict) -> dict:
        with open(os.path.join(self.here, "mixes",
                               f"{workload['traffic']}.json")) as f:
            return json.load(f)

    def metrics(self, workload: dict, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``traced`` its per-layer
        ones: those whose ``workloads`` name it, or that have none."""
        group = self.data["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if workload["name"] in m.get("workloads", [workload["name"]])]

    def reader(self, metric: dict):
        """The per-layer metric's ``read(run)``, from its own file."""
        return _load(os.path.join(self.here, "metrics",
                                  f"{metric['name']}.py"),
                     "benchmark.metrics." + metric["name"]).read

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py`` of this benchmark: a generator or a
        reference."""
        if self.here == HERE:
            return importlib.import_module(f"benchmark.{kind}.{name}")
        return _load(os.path.join(self.here, kind, f"{name}.py"),
                     f"benchmark.{kind}.{name}")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
