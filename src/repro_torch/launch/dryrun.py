"""Dry run: trace every (arch × shape × mesh) cell on the meta device.

The port of ``repro.launch.dryrun``. It proves the distribution config is
coherent without hardware: each cell's step (train: loss, grads and the
optimizer update; prefill; decode) runs on ``meta`` tensors from
``launch/specs.py`` under ``torch.utils.flop_counter.FlopCounterMode``,
with the batch axes and sequence sharding set as the reference's
``run_cell`` sets them, on a logical mesh (``launch/mesh.py``). Nothing is
allocated and no kernel runs: on the meta device the model takes its plain
versions. One JSON per cell, with the reference's keys where they carry
over (arch, shape, kind, mesh, status, seq_len, global_batch, n_params,
n_active_params, n_chips) and, under ``per_device``:

- ``flops``: the traced total over ``n_chips``, an even split
  (``flops_split``); ``flops_total`` is the whole step's. The count is
  FlopCounterMode's: the matrix products (the plain attention's included,
  every key chunk of it, masked or not), forward, recompute and backward;
- ``argument_bytes``: the sum over every argument leaf of its sanitized
  shard's bytes;
- ``temp_bytes``, ``bytes_accessed``, ``collective_bytes`` and
  ``hlo_lines`` are null, with a ``reason``: XLA's compiled program gives
  them to the reference, and the port has no such program (collectives
  come with a multi-process executor).

``--mesh 1x1`` is one H100: its ``fits_80gb`` compares ``argument_bytes``
with 80 GB, a lower bound on the memory the step needs.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k \
        [--multi-pod | --mesh 1x1] [--seq N --global-batch B]
    python -m repro_torch.launch.dryrun --all [--multi-pod]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs.base import SHAPES, shapes_for
from ..configs.registry import all_archs, get_config
from ..dist.ctx import launch_mesh
from ..dist.sharding import map_tree, shard_bytes
from ..serve.decode import make_prefill_step, make_serve_step
from ..train.train_step import make_train_step
from .mesh import Mesh, make_production_mesh
from .specs import input_specs

HBM_BYTES = 80e9   # one H100's device memory

_NO_XLA = ("XLA's compiled program gives these to the reference; the port "
           "traces on the meta device and has no compiled program or HLO, "
           "and no collectives until a multi-process executor")


def make_mesh(kind: str) -> Mesh:
    """The logical mesh of a cell kind: "pod" (16, 16), "multi" (2, 16,
    16) or "1x1" (one H100)."""
    if kind == "1x1":
        return Mesh((1, 1), ("data", "model"), "meta")
    return make_production_mesh(multi_pod=kind == "multi", device="meta")


def argument_bytes(args, specs, mesh) -> int:
    """Sum over the argument tensors of their sanitized shards' bytes (the
    decode cache's host-int position counts none)."""
    total = []
    map_tree(lambda s, x: total.append(
        shard_bytes(x, s, mesh) if isinstance(x, torch.Tensor) else 0),
        specs, args)
    return sum(total)


def trace_flops(cfg, kind: str, args) -> int:
    """FLOPs of one step of ``kind`` on the meta arguments ``args``."""
    with FlopCounterMode(display=False) as counter:
        if kind == "train":
            make_train_step(cfg)(*args)
        elif kind == "prefill":
            make_prefill_step(cfg)(*args)
        else:
            make_serve_step(cfg)(*args)
    return counter.get_total_flops()


def run_cell(arch: str, shape_name: str, mesh_kind: str = "pod", *,
             seq: int = 0, global_batch: int = 0, trace: bool = True,
             cfg=None) -> dict:
    """One cell's JSON record. ``seq``/``global_batch`` override the
    shape's; ``trace=False`` leaves out the step's trace (specs and bytes
    only: ``flops`` null); ``cfg`` stands in for the arch's config (a
    reduced one)."""
    cfg = cfg or get_config(arch)
    cells = {c.name: c for c in shapes_for(cfg)}
    if shape_name not in cells:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": "long_500k needs sub-quadratic attention "
                          "(full-attention arch)"}
    cell = cells[shape_name]
    cell = dataclasses.replace(cell, seq_len=seq or cell.seq_len,
                               global_batch=global_batch or cell.global_batch)
    mesh = make_mesh(mesh_kind)
    t0 = time.time()
    with launch_mesh(mesh, global_batch=cell.global_batch,
                     seq_len=0 if cell.kind == "decode" else cell.seq_len):
        args, arg_specs = input_specs(cfg, cell, mesh)
        nbytes = argument_bytes(args, arg_specs, mesh)
        flops = trace_flops(cfg, cell.kind, args) if trace else None
    n_chips = mesh.size
    result = {
        "arch": arch, "shape": shape_name, "kind": cell.kind,
        "mesh": dict(mesh.shape), "status": "ok",
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "trace_s": round(time.time() - t0, 2),
        "per_device": {
            "flops": None if flops is None else flops / n_chips,
            "flops_total": flops,
            "flops_split": "even: the traced total over n_chips",
            "argument_bytes": nbytes,
            "temp_bytes": None, "bytes_accessed": None,
            "collective_bytes": None, "reason": _NO_XLA,
        },
        "n_chips": int(n_chips),
        "hlo_lines": None,
    }
    if mesh_kind == "1x1":
        result["fits_80gb"] = nbytes <= HBM_BYTES
        result["fits_note"] = ("argument bytes against 80 GB: a lower "
                               "bound, activations and temporaries not "
                               "counted")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", choices=("pod", "1x1"), default="pod",
                    help="1x1: one H100")
    ap.add_argument("--seq", type=int, default=0,
                    help="override the shape's sequence length")
    ap.add_argument("--global-batch", type=int, default=0,
                    help="override the shape's global batch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="dryrun_out")
    args = ap.parse_args(argv)

    kind = "multi" if args.multi_pod else args.mesh
    os.makedirs(args.out_dir, exist_ok=True)
    if args.all:
        cells = [(arch, cell.name) for arch in all_archs() for cell in SHAPES]
    else:
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        tag = kind
        if args.seq or args.global_batch:
            tag += f"_s{args.seq or 'x'}_b{args.global_batch or 'x'}"
        out = os.path.join(args.out_dir, f"{arch}__{shape}__{tag}.json")
        if os.path.exists(out):
            print(f"[skip existing] {out}", flush=True)
            continue
        print(f"[dryrun] {arch} x {shape} ({tag}) ...", flush=True)
        try:
            result = run_cell(arch, shape, kind, seq=args.seq,
                              global_batch=args.global_batch)
        except Exception as e:  # recorded, sweep continues
            result = {"arch": arch, "shape": shape, "status": "error",
                      "error": repr(e),
                      "trace": traceback.format_exc()[-3000:]}
            failures += 1
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
        pd = result.get("per_device", {})
        print(f"  -> {result['status']} ({result.get('trace_s', '-')}s; "
              f"{pd.get('argument_bytes', 0) / 1e9:.2f} GB arguments a "
              f"device)", flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
