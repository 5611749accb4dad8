"""BENCHMARK.json and the files it names, found by name.

A cell `<config>.<traffic>` is an entry of BENCHMARK.json's `workloads`;
its configuration is `configs/<config>.json`, its traffic
`traffic/<traffic>.json`, what belongs to the pair alone (the check's
sample and limits, the frozen work counts) `workloads/<cell>.json`, and
each metric's reader `metrics/<metric>.py`. Adding a cell, a configuration
or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(root, *parts) -> dict:
    with open(os.path.join(root, os.path.basename(BENCH_DIR), *parts)) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    """A metric without `workloads` is reported in every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    data: dict
    end_to_end: tuple
    per_layer: tuple


def find_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of the checkout `root`'s BENCHMARK.json with its
    files and metrics; KeyError for a cell BENCHMARK.json does not list."""
    bench = load_benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    return Cell(name=name, chips=int(entry["chips"]),
                config=_load_json(root, "configs", f"{entry['config']}.json"),
                traffic=_load_json(root, "traffic", f"{entry['traffic']}.json"),
                data=_load_json(root, "workloads", f"{name}.json"),
                end_to_end=tuple(m for m in bench["end_to_end"] if applies(m, name)),
                per_layer=tuple(m for m in bench["per_layer"] if applies(m, name)))


def load_reader(metric: str, root: str = ROOT):
    """The module `metrics/<metric>.py` of the checkout `root`, which
    defines `read(ctx)`: the metric's value, or None where its run has
    nothing to read."""
    path = os.path.join(root, os.path.basename(BENCH_DIR), "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "rmcl_bench.metrics." + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
