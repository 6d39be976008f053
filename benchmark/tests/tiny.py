"""Tiny sizes of the cells' configurations and mixes, for the CPU.

A configuration's tiny sizes are ``tiny_sizes/configs/<config>.json``,
laid over its file; a cell's changes to its mix, where it needs any, are
``tiny_sizes/mixes/<cell>.json``.  A cell added later brings its own
files: nothing here changes.  ``spare.json`` declares the cells kept out
of ``BENCHMARK.json`` for now, which the tests run all the same.
"""

import json
import os

from benchmark.spec import Spec

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "tiny_sizes")


def sizes(config: str) -> dict:
    """The tiny sizes of configuration ``config``; raises where it has
    none, rather than run a configuration at its full size here."""
    with open(os.path.join(HERE, "configs", f"{config}.json")) as f:
        return json.load(f)


def config(workload: str) -> dict:
    return sizes(spec().workload(workload)["config"])


def mix(workload: str) -> dict:
    path = os.path.join(HERE, "mixes", f"{workload}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def spec() -> Spec:
    """``BENCHMARK.json`` with the cells of ``spare.json`` added, as they
    would be declared: cells kept ready but out of the benchmark, which
    the tests run as they run its own."""
    out = Spec()
    with open(os.path.join(HERE, "spare.json")) as f:
        spare = json.load(f)
    have = {w["name"] for w in out.data["workloads"]}
    for w in spare["workloads"]:
        if w["name"] in have:
            continue
        out.data["workloads"].append(w)
        for m in out.data["per_layer"]:
            if m["name"] in spare["also_in"].get(w["name"], ()):
                m["workloads"] = [*m["workloads"], w["name"]]
    names = {m["name"] for m in out.data["per_layer"]}
    out.data["per_layer"] += [m for m in spare["per_layer"]
                              if m["name"] not in names]
    return out


def cells() -> list[str]:
    """Every cell the tests run: the benchmark's and the spare ones."""
    return [w["name"] for w in spec().data["workloads"]]
