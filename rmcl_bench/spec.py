"""BENCHMARK.json and the files it names, found by name.

A cell `<config>.<traffic>` is an entry of BENCHMARK.json's `workloads`;
its configuration is `configs/<config>.json`, its traffic
`traffic/<traffic>.json`, what belongs to the pair alone (the check's
sample and limits, the frozen work counts) `workloads/<cell>.json`, and
each metric's reader `metrics/<metric>.py`. A configuration's volume
`generator` and a traffic mix's `entry` that the harness does not hold
itself (`inputs.VOLUMES`, `entries.ENTRIES`) are the modules
`volumes/<generator>.py` and `entrypoints/<entry>.py`. Adding a cell, a
configuration, a volume source, an entry point or a metric adds files and
entries; no file here changes.
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
    root: str = ROOT


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
                per_layer=tuple(m for m in bench["per_layer"] if applies(m, name)),
                root=root)


class UnknownName(LookupError):
    """A volume generator or entry point that neither the harness nor the
    checkout's files define."""


def _path(folder: str, name: str, root: str) -> str:
    return os.path.join(root, os.path.basename(BENCH_DIR), folder, f"{name}.py")


def _load_module(folder: str, name: str, root: str):
    spec = importlib.util.spec_from_file_location(
        f"rmcl_bench.{folder}." + name.replace(".", "_").replace("-", "_"),
        _path(folder, name, root))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, root: str = ROOT):
    """The module `metrics/<metric>.py` of the checkout `root`, which
    defines `read(ctx)`: the metric's value, or None where its run has
    nothing to read."""
    return _load_module("metrics", metric, root)


def load_named(folder: str, name: str, root: str, builtin: dict):
    """`builtin[name]`, else the `make` of the module `<folder>/<name>.py`
    of the checkout `root`; UnknownName, listing the names known to both,
    where neither has it."""
    if name in builtin:
        return builtin[name]
    path = _path(folder, name, root)
    if not os.path.isfile(path):
        d = os.path.dirname(path)
        files = [f[:-3] for f in (os.listdir(d) if os.path.isdir(d) else ()) if f.endswith(".py")]
        raise UnknownName(f"{folder}: no {name!r}; known: "
                          + ", ".join(sorted(builtin) + sorted(files)))
    return _load_module(folder, name, root).make
