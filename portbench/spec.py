"""Finds each part of a cell by the name that ``BENCHMARK.json`` gives it.

- a configuration: the ``file`` of its entry in ``configs``;
- a traffic mix: ``traffic/<mix>.json``;
- an application and its plain reference: ``apps/<app>.py`` and
  ``reference/<app>.py``, named by the configuration's ``app``;
- a metric, end-to-end or per-layer: ``metrics/<metric>.py``, whose
  ``read(world)`` returns the metric's value, or None where the run has
  nothing to read.

A new cell, configuration, mix or metric is a new file and a new entry:
no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _entry(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _entry(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _entry(bench["configs"], name, "configuration")
    with open(root / entry["file"]) as fh:
        cfg = json.load(fh)
    if cfg.get("name") != name:
        raise ValueError(f"{entry['file']} names {cfg.get('name')!r}, not "
                         f"{name!r}")
    return cfg


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` under the benchmark's folder, loaded once."""
    key = f"portbench._{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    if key not in sys.modules:
        path = HERE / kind / f"{name}.py"
        found = importlib.util.spec_from_file_location(key, path)
        if found is None or not path.is_file():
            raise FileNotFoundError(f"no {kind} file {path}")
        mod = importlib.util.module_from_spec(found)
        sys.modules[key] = mod
        try:
            found.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def metrics(bench: dict, section: str, cell_name: str) -> List[dict]:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    this cell reports: those without ``workloads`` and those that list
    it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell_name in m["workloads"]]
