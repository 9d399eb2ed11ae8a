"""Checkpointing with atomic publish and asynchronous writes.

The port of ``repro.train.checkpoint``, with its on-disk layout and leaf
names, so that each package restores the other's checkpoints. One
directory per step, ``<dir>/step_<n>/``, holding

  manifest.json        {"step", "leaves": {name: {file, shape, dtype}}}
  arrays/<a__b>.npy    one full array per leaf (name "a/b" -> "a__b")

Leaf names join the tree's keys with "/" (``train/tree.py``): dict keys
in sorted order, as JAX flattens a dict, NamedTuple field names and list
indices. bfloat16, which numpy cannot store, is written as its bytes
(uint8, the last axis doubled) with dtype "bfloat16" in the manifest; the
bits move through torch's own views, so no ``ml_dtypes`` is needed.

Durability: writes go to a temp dir, fsync'd, then atomically renamed;
``latest_step`` only ever sees complete checkpoints. Every save first
copies the tree to host memory: the port's optimizer updates parameters in
place, so the next step cannot change a snapshot being written.
``AsyncCheckpointer.wait`` drains the writes in flight (quiesce before
shutdown, the completion protocol's rule). One device: ``restore`` places
every leaf on the device it is given (re-sharding onto a mesh waits for
the port's sharding).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .tree import leaf_paths, tree_map, unflatten


def _snapshot(tree) -> Any:
    """Host copies of every leaf, taken now."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _as_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array to store, the manifest's dtype name)."""
    if leaf.dtype == torch.bfloat16:
        t = leaf.contiguous()
        t = t.reshape(1) if t.dim() == 0 else t
        return t.view(torch.uint8).numpy(), "bfloat16"
    arr = leaf.numpy()
    return arr, str(arr.dtype)


def _write(ckpt_dir: str, step: int, host_tree: Any) -> None:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in leaf_paths(host_tree):
        fname = name.replace("/", "__") + ".npy"
        arr, dtype = _as_numpy(leaf)
        np.save(os.path.join(tmp, "arrays", fname), arr)
        manifest["leaves"][name] = {"file": fname,
                                    "shape": list(leaf.shape),
                                    "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish


def save(ckpt_dir: str, step: int, tree: Any, *, blocking: bool = True
         ) -> Optional[threading.Thread]:
    """Write a checkpoint of ``tree`` (of tensors) as it is now; returns
    the writer thread when non-blocking."""
    host_tree = _snapshot(tree)
    if blocking:
        _write(ckpt_dir, step, host_tree)
        return None
    t = threading.Thread(target=_write, args=(ckpt_dir, step, host_tree),
                         daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load_leaf(final: str, meta: dict) -> torch.Tensor:
    arr = np.load(os.path.join(final, "arrays", meta["file"]))
    if meta["dtype"] == "bfloat16" and arr.dtype == np.uint8:
        return torch.from_numpy(arr).view(torch.bfloat16).reshape(
            meta["shape"])
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like: Any, device=None) -> Any:
    """The checkpoint in the structure of ``like`` (a tree of tensors, on
    any device, ``meta`` included), each leaf cast to its ``like`` leaf's
    dtype and placed on ``device`` (default: that leaf's device)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for name, ref in leaf_paths(like):
        t = _load_leaf(final, manifest["leaves"][name])
        leaves.append(t.to(device=ref.device if device is None else device,
                           dtype=ref.dtype))
    return unflatten(like, leaves)


class AsyncCheckpointer:
    """Double-buffered async writer with quiesce-on-exit (the host-level use
    of the completion-detection idea: never shut down with writes in
    flight). ``save`` returns once the tree is copied to host memory."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._inflight: list[threading.Thread] = []

    def save(self, step: int, tree: Any) -> None:
        self._inflight = [t for t in self._inflight if t.is_alive()]
        host_tree = _snapshot(tree)  # snapshot before async

        def write_then_gc():
            _write(self.ckpt_dir, step, host_tree)
            self._gc()

        t = threading.Thread(target=write_then_gc, daemon=True)
        t.start()
        self._inflight.append(t)

    def wait(self) -> None:
        for t in self._inflight:
            t.join()
        self._inflight.clear()
        self._gc()  # writers may publish out of order; settle retention here

    def _gc(self) -> None:
        if not os.path.isdir(self.ckpt_dir):
            return
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)


__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
