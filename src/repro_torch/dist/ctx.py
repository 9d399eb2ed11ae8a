"""Ambient mesh/sharding context — model code stays mesh-agnostic.

The port of ``repro.dist.ctx``. Launchers (``repro_torch.launch.*``) pick
a mesh and declare two global policies: which mesh axes shard the batch
(``set_batch_axes``) and whether the sequence dim is sharded between
layers (``set_seq_shard``). Model code never sees the mesh; it calls
``annotate(x, spec)`` at layout boundaries, the reference's sites, which
returns ``x`` itself, with or without a mesh: a port mesh is logical (one
device), so a layout constraint moves nothing. The layout a spec would
give is ``sanitize_spec``'s (the dry run's argument bytes,
``named_shardings``' placements). What the mesh does change is read
through ``data_rows()`` (the MoE's dispatch rows).

On a mesh of ranks (``Mesh(..., group=)``), each rank installs its own
mesh: ``get_mesh()`` is the rank's, with its ``coords``; ``batch_axes()``
are the global batch's axes as on a logical mesh; ``data_rows()`` is 1,
since a rank holds only its own rows of the global batch (one dispatch
row); ``annotate`` still returns its input.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from .sharding import Axes, P, batch_axis

_state = {"mesh": None, "batch_axes": None, "seq_shard": False}


def get_mesh():
    """The mesh installed by ``use_mesh``, or None outside any context."""
    return _state["mesh"]


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Install ``mesh`` as the ambient mesh (re-entrant, restores on
    exit)."""
    prev = _state["mesh"]
    _state["mesh"] = mesh
    try:
        yield mesh
    finally:
        _state["mesh"] = prev


@contextlib.contextmanager
def suspend_annotations() -> Iterator[None]:
    """Run a region with ``annotate`` as the identity and ``data_rows()``
    1 (the ambient mesh hidden), as the reference's pipelined train step
    traces its model code inside a ``shard_map``."""
    prev = _state["mesh"]
    _state["mesh"] = None
    try:
        yield
    finally:
        _state["mesh"] = prev


@contextlib.contextmanager
def launch_mesh(mesh, *, global_batch: int, seq_len: int = 0) -> Iterator:
    """``use_mesh(mesh)`` with the launchers' policies: the batch axes of
    ``global_batch`` (``sharding.batch_axis``) and sequence sharding when
    the model axis divides ``seq_len`` (0: off, as for decode); the
    previous policies are restored on exit. Without a mesh, nothing."""
    if mesh is None:
        yield None
        return
    prev = _state["batch_axes"], _state["seq_shard"]
    set_batch_axes(batch_axis(mesh, global_batch))
    set_seq_shard(bool(seq_len) and seq_len % mesh.shape["model"] == 0)
    try:
        with use_mesh(mesh):
            yield mesh
    finally:
        _state["batch_axes"], _state["seq_shard"] = prev


def set_batch_axes(axes: Axes) -> None:
    """Declare the mesh axes the global batch shards over (e.g. ("pod",
    "data")), as computed by :func:`repro_torch.dist.sharding.batch_axis`."""
    _state["batch_axes"] = axes


def batch_axes() -> Axes:
    return _state["batch_axes"]


def set_seq_shard(on: bool) -> None:
    """Enable sequence parallelism for inter-layer activations."""
    _state["seq_shard"] = bool(on)


def seq_shard() -> bool:
    return _state["seq_shard"]


def data_rows() -> int:
    """Number of data-parallel rows = product of the batch-axis sizes (the
    R in the MoE [R, T, D] row decomposition); 1 with no mesh/batch axes,
    and on a mesh of ranks, where this rank's batch is its own row."""
    mesh, axes = _state["mesh"], _state["batch_axes"]
    if mesh is None or axes is None or mesh.group is not None:
        return 1
    names = axes if isinstance(axes, tuple) else (axes,)
    rows = 1
    for name in names:
        rows *= mesh.shape.get(name, 1)
    return rows


def act_spec() -> P:
    """Layout of inter-layer activations [B, S, D]: batch over the batch
    axes, sequence over "model" when sequence parallelism is on, D whole."""
    return P(batch_axes(), "model" if _state["seq_shard"] else None, None)


def annotate(x: torch.Tensor, spec: P) -> torch.Tensor:
    """``x`` itself. The reference constrains ``x`` to ``spec`` (sanitized
    against its shape) on the ambient mesh; on the port's one device the
    constraint has nothing to move, with or without a mesh."""
    return x


__all__ = ["act_spec", "annotate", "batch_axes", "data_rows", "get_mesh",
           "launch_mesh", "seq_shard", "set_batch_axes", "set_seq_shard",
           "suspend_annotations", "use_mesh"]
