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
shutdown, the completion protocol's rule). ``restore`` places every leaf
on the device it is given.

From rank processes that each hold a part of each leaf of the tree (the
pipelined trainer's stages, ``train_step.pipeline_shard``: rows; the
tensor-parallel shards, ``tensor_parallel.shard_boxes``: a box, one slice
per dim, or a list of column boxes for Mamba-2's head-aligned leaves),
``save_from_ranks`` writes the same directory, byte for byte,
with no tensor on the wire: rank 0 writes the manifest and every leaf's
file, sized, as a memory map; after a barrier each rank writes its own
parts into those files (a part several ranks hold, by one of them);
after another rank 0 publishes the directory. ``restore(..., rows=)``
reads only a rank's own parts, so a checkpoint restores onto any mesh.
``RankCheckpointer`` is ``AsyncCheckpointer``'s interface over it
(blocking: the ranks meet in its barriers).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

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
    _publish(tmp, final, manifest)


def _publish(tmp: str, final: str, manifest: dict) -> None:
    """Write the manifest into ``tmp`` and rename it to ``final``."""
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


def _stored(leaf: torch.Tensor) -> Tuple[np.dtype, tuple, str]:
    """(numpy dtype, shape, manifest dtype name) of ``leaf``'s file, from
    its dtype and shape alone (any device, ``meta`` included)."""
    if leaf.dtype == torch.bfloat16:
        shape = tuple(leaf.shape) or (1,)
        return np.dtype(np.uint8), (*shape[:-1], 2 * shape[-1]), "bfloat16"
    dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
    return dtype, tuple(leaf.shape), str(dtype)


def _box(place, leaf, bf16: bool) -> tuple:
    """The index of a rank's ``leaf`` in its whole leaf's stored array:
    ``place`` is a row along dim 0 (an int: the leaf's length of rows from
    there) or a box (a tuple of slices, one per dim); a bfloat16 leaf's
    last dim is stored as twice as many bytes."""
    if isinstance(place, int):
        place = (slice(place, place + leaf.shape[0]),) if leaf.dim() else ()
    if bf16 and len(place) == max(leaf.dim(), 1):
        last = place[-1]
        if last.start is not None or last.stop is not None:
            place = (*place[:-1], slice(2 * (last.start or 0),
                                        None if last.stop is None
                                        else 2 * last.stop))
    return place


def _parts(place, leaf, bf16: bool) -> list:
    """(the index in the whole leaf's stored array, the columns of the
    rank's stored array or None for all of it) of each part of a rank's
    ``leaf`` at ``place``: one for a row or a box (``_box``); one per
    column box for a list of them (Mamba-2's head-aligned leaves, joined
    on the last dim: ``layers.take_box``), a bfloat16 leaf's columns
    counted in bytes."""
    if not isinstance(place, list):
        return [(_box(place, leaf, bf16), None)]
    out, at = [], 0
    for box in place:
        width = (box[-1].stop - box[-1].start) * (2 if bf16 else 1)
        out.append((_box(box, leaf, bf16), slice(at, at + width)))
        at += width
    return out


def save_from_ranks(ckpt_dir: str, step: int, tree: Any, *, like: Any,
                    rows: dict, group=None, writes=None,
                    written=None) -> None:
    """Write a checkpoint of the whole tree ``like`` (its names, shapes and
    dtypes; any device, ``meta`` included) from the ranks of ``group``,
    each writing the leaves of its ``tree`` (a part of ``like``'s, the
    same names; None writes nothing) at ``rows[name]``, where the leaf
    lies in the whole one: the row along dim 0 where it starts, or its box
    (a tuple of slices, or a list of column boxes). With ``writes`` (a set
    of leaf names) the rank writes those leaves only: a part several ranks
    hold is written by one of them. Every rank of ``group`` calls it; it returns once the
    checkpoint is published. Ranks that hold the same part may both write
    it (the same bytes). ``written`` (a function of no arguments) is
    called once this rank's parts are written, before the publish."""
    group = dist.group.WORLD if group is None else group
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    lead = dist.get_rank(group) == 0
    host = {} if tree is None else {
        name: leaf.detach().to("cpu", copy=True)
        for name, leaf in leaf_paths(tree) if writes is None or name in writes}
    manifest = {"step": step, "leaves": {}}
    if lead:
        # a write of this step that died before its publish left its parts
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(os.path.join(tmp, "arrays"))
    for name, leaf in leaf_paths(like):
        dtype, shape, dname = _stored(leaf)
        fname = name.replace("/", "__") + ".npy"
        if lead:
            np.lib.format.open_memmap(os.path.join(tmp, "arrays", fname),
                                      mode="w+", dtype=dtype, shape=shape
                                      ).flush()
        manifest["leaves"][name] = {"file": fname,
                                    "shape": list(leaf.shape),
                                    "dtype": dname}
    dist.barrier(group)
    for name, leaf in host.items():
        arr, dname = _as_numpy(leaf)
        out = np.load(os.path.join(tmp, "arrays",
                                   manifest["leaves"][name]["file"]),
                      mmap_mode="r+")
        for index, cols in _parts(rows[name], leaf, dname == "bfloat16"):
            out[index] = arr if cols is None else arr[..., cols]
        out.flush()
        del out
    if written is not None:
        written()
    dist.barrier(group)
    if lead:
        _publish(tmp, final, manifest)
    dist.barrier(group)


class RankCheckpointer:
    """``AsyncCheckpointer``'s interface for a tree held in parts by rank
    processes: ``save`` is ``save_from_ranks`` (blocking), after which
    rank 0 keeps the ``keep`` latest steps; ``wait`` has nothing to
    drain. ``writes`` False: this rank holds a copy another rank writes
    (it still meets the others in the barriers); a set of leaf names: it
    writes those leaves only. ``written`` is ``save_from_ranks``' hook
    between this rank's writes and the publish."""

    def __init__(self, ckpt_dir: str, keep: int = 3, *, like: Any,
                 rows: dict, group=None, writes=True):
        self.ckpt_dir, self.keep = ckpt_dir, keep
        self.like, self.rows, self.group = like, rows, group
        self.writes = writes
        self.written = None

    def save(self, step: int, tree: Any) -> None:
        save_from_ranks(self.ckpt_dir, step,
                        tree if self.writes is not False else None,
                        like=self.like, rows=self.rows, group=self.group,
                        writes=None if self.writes is True else self.writes,
                        written=self.written)
        group = dist.group.WORLD if self.group is None else self.group
        if dist.get_rank(group) == 0:
            _prune(self.ckpt_dir, self.keep)

    def wait(self) -> None:
        pass


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load_leaf(final: str, meta: dict, place=None,
               ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The leaf's array, or the part of it at ``place`` (``_box``'s, of
    ``ref``'s shape; read from a memory map)."""
    path = os.path.join(final, "arrays", meta["file"])
    shape = list(meta["shape"])
    bf16 = meta["dtype"] == "bfloat16"
    if place is None:
        arr = np.load(path)
    else:
        stored = np.load(path, mmap_mode="r")
        arr = np.concatenate([np.array(stored[index]) for index, _
                              in _parts(place, ref, bf16)], axis=-1)
        shape = list(ref.shape)
    if bf16 and arr.dtype == np.uint8:
        return torch.from_numpy(arr).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like: Any, device=None,
            rows: Optional[dict] = None) -> Any:
    """The checkpoint in the structure of ``like`` (a tree of tensors, on
    any device, ``meta`` included), each leaf cast to its ``like`` leaf's
    dtype and placed on ``device`` (default: that leaf's device). With
    ``rows`` (``{leaf name: row or box}``, as ``save_from_ranks`` takes
    them), ``like`` is a rank's part of the tree and each leaf of it with
    a shape reads only its part from there: a checkpoint restores onto
    any mesh."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for name, ref in leaf_paths(like):
        meta = manifest["leaves"][name]
        part = rows is not None and ref.dim() > 0
        t = _load_leaf(final, meta, rows[name] if part else None, ref)
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

        def write_then_prune():
            _write(self.ckpt_dir, step, host_tree)
            _prune(self.ckpt_dir, self.keep)

        t = threading.Thread(target=write_then_prune, daemon=True)
        t.start()
        self._inflight.append(t)

    def wait(self) -> None:
        for t in self._inflight:
            t.join()
        self._inflight.clear()
        # writers may publish out of order; settle retention here
        _prune(self.ckpt_dir, self.keep)


def _prune(ckpt_dir: str, keep: int) -> None:
    """Delete all but the ``keep`` latest complete checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[: -keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


__all__ = ["AsyncCheckpointer", "RankCheckpointer", "latest_step",
           "restore", "save", "save_from_ranks"]
