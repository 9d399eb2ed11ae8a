"""Meshes: named axes and their sizes, logical or laid on rank processes.

The port of ``repro.launch.mesh``. A mesh without a process group is
logical: it names the axes a deployment would shard over and their sizes,
and every shard of every axis lives on ``device``, the way the block
executor stacks every shard on one device. Sharding changes layout, not
values, so what a logical mesh changes is the work: the MoE's dispatch
rows (``dist.ctx.data_rows``), the decode cache's head count
(``dist.sharding.kv_head_pad``) and the pipeline's stage count (the
``"pipe"`` axis).

``Mesh(..., group=)`` lays the mesh on the rank processes of a
``torch.distributed`` group, one process per mesh coordinate, as
``jax.sharding.Mesh(np.array(devs).reshape(shape), names)`` places
devices: rank r sits at r's row-major position over ``axis_names``. Each rank knows its ``coords``, the process group of its
line along each axis (``groups``, ``line``) and the world's transport
(``DeviceTensorTransport`` or gloo's ``TensorTransport``) over the whole
group. Every axis runs on ranks: the pipe and data axes
for the pipelined trainer, the data and model axes for tensor-parallel
serving and training of every family (``dist.tensor_parallel``: each
rank holds its shard of the weights, of the optimizer state and of the
decode cache and exchanges partial products over ``groups["model"]``).
What a model axis > 1 on ranks does not run refuses where it is called:
the pipelined trainer (the reference's pipelined launcher runs with a
model axis of 1), Adafactor over Mamba-2's column pieces
(``train_step.check_ranked_training``) and what the axis does not
divide (``tensor_parallel.check_tp``).

Single pod: (16, 16) = 256 chips, axes ("data", "model").
Multi-pod:  (2, 16, 16) = 512 chips, axes ("pod", "data", "model") — the
"pod" axis is pure data parallelism across pods.

Building a mesh touches no device: ``device`` is only named.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """``axis_names`` and their sizes over ``device``. ``shape`` maps each
    name to its size, in axis order, as jax's ``mesh.shape`` does;
    ``size`` is the number of devices (logical ones, or ranks).

    With ``group`` (a ``torch.distributed`` group spanning the whole
    world, one rank per mesh coordinate) the mesh is laid on the ranks:
    ``coords`` are this rank's coordinates, ``line[axis]`` the global ranks
    along its line of ``axis`` (in coordinate order) and ``groups[axis]``
    that line's process group, made by one ``dist.new_group`` per line of
    every axis, in the same order on every rank (gloo hangs otherwise);
    ``transport`` carries the model path's exchanges: the world's
    (``dist.ranks.tensor_transport``: through the ranks' device mailboxes
    in a world on the device transport, else gloo). Raises
    ``ValueError`` before any collective when the mesh's size is not the
    world's."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 device="cuda", group=None):
        sizes, axis_names = tuple(int(s) for s in sizes), tuple(axis_names)
        if len(sizes) != len(axis_names) or any(s < 1 for s in sizes):
            raise ValueError(f"mesh sizes {sizes} over axes {axis_names}")
        self.axis_names: Tuple[str, ...] = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, sizes))
        self.size: int = math.prod(sizes)
        self.device = torch.device(device)
        self.group = group
        self.coords: Optional[Dict[str, int]] = None
        self.line: Dict[str, List[int]] = {}
        self.groups: Dict[str, object] = {}
        self.transport = None
        if group is not None:
            self._lay_on(group)

    def _lay_on(self, group) -> None:
        from ..dist.ranks import tensor_transport

        world = dist.get_world_size(group)
        if self.size != world or world != dist.get_world_size():
            raise ValueError(
                f"a mesh of {self.size} devices {self.shape} on ranks needs "
                f"a group of the whole world of {self.size} processes, got "
                f"{world} of {dist.get_world_size()}")
        sizes = tuple(self.shape.values())
        rank = dist.get_rank(group)
        self.coords = dict(zip(self.axis_names,
                               map(int, np.unravel_index(rank, sizes))))
        where = np.arange(self.size).reshape(sizes)
        for i, name in enumerate(self.axis_names):
            for line in np.moveaxis(where, i, -1).reshape(-1, sizes[i]):
                ranks = [dist.get_global_rank(group, int(r)) for r in line]
                pg = dist.new_group(ranks)
                if rank in line:
                    self.line[name], self.groups[name] = ranks, pg
        self.transport = tensor_transport(self.device)

    def rank_of(self, **coords: int) -> int:
        """The global rank at ``coords`` (this rank's own on the axes left
        out), on a mesh of ranks."""
        at = {**self.coords, **coords}
        pos = int(np.ravel_multi_index([at[a] for a in self.axis_names],
                                       tuple(self.shape.values())))
        return dist.get_global_rank(self.group, pos)

    def __repr__(self) -> str:
        where = (f"device={self.device}" if self.group is None else
                 f"ranks, coords={self.coords}, device={self.device}")
        return f"Mesh({self.shape}, {where})"


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device)


def make_host_mesh(model: int = 2, data: int = 2, device="cuda") -> Mesh:
    """A small ("data", "model") mesh (tests)."""
    return Mesh((data, model), ("data", "model"), device)


def make_dev_mesh(n_devices: int, model: int = 0, device="cuda",
                  group=None) -> Mesh:
    """The launchers' mesh of ``n_devices`` devices, as the JAX package's
    launchers pick it: the production mesh from 256 on, else (n / model,
    model) over ("data", "model") with model = min(4, n) unless given;
    logical, or on ``group``'s ranks when given."""
    if n_devices >= 256 and not model and group is None:
        return make_production_mesh(device=device)
    model = model or max(1, min(4, n_devices))
    if n_devices % model:
        raise ValueError(f"model axis {model} does not divide {n_devices} "
                         "devices")
    return Mesh((n_devices // model, model), ("data", "model"), device,
                group=group)


def make_pipeline_mesh(stages: int, n_devices: int, device="cuda",
                       group=None) -> Mesh:
    """The pipelined trainer's ("pipe", "data", "model") mesh of
    (stages, n / stages, 1), on ``group``'s ranks when given."""
    if stages < 1 or n_devices % stages:
        raise ValueError(f"{stages} stages do not divide {n_devices} "
                         "devices")
    return Mesh((stages, n_devices // stages, 1), ("pipe", "data", "model"),
                device, group=group)


__all__ = ["Mesh", "make_dev_mesh", "make_host_mesh", "make_pipeline_mesh",
           "make_production_mesh"]
