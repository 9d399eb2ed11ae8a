"""Tiny copies of the benchmark's configurations for tests on the CPU:
the same cells, traffic and code, at sizes a test run holds."""

from __future__ import annotations

import copy
import json

from portbench import spec

SIZES = {"cholesky-16k": {"N": 64, "b": 16, "nb": 4},
         "gemm2d-8k": {"N": 64, "b": 16, "nb": 4}}
# a device mailbox on the CPU is a file: keep it small
MIX = {"mailbox_bytes": 1 << 20, "timeout_s": 120}


def bench(tmp_path, sizes=SIZES) -> dict:
    """``BENCHMARK.json`` with each configuration's file swapped for a
    tiny copy under ``tmp_path``."""
    out = copy.deepcopy(spec.benchmark())
    for entry in out["configs"]:
        cfg = spec.config(out, entry["name"])
        cfg.update(sizes.get(entry["name"], {}))
        path = tmp_path / f"{entry['name']}.json"
        path.write_text(json.dumps(cfg))
        entry["file"] = str(path)
    return out
