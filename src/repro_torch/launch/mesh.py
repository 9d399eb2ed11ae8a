"""Logical meshes: named axes and their sizes over one torch device.

The port of ``repro.launch.mesh``. There is one card, so a mesh here is
logical: it names the axes a deployment would shard over and their sizes,
and every shard of every axis lives on ``device``, the way the block
executor stacks every shard on one device. Sharding changes layout, not
values, so what a mesh changes on one device is the work: the MoE's
dispatch rows (``dist.ctx.data_rows``), the decode cache's head count
(``dist.sharding.kv_head_pad``) and the pipeline's stage count (the
``"pipe"`` axis). Placing shards on ranks waits for a multi-process
executor.

Single pod: (16, 16) = 256 chips, axes ("data", "model").
Multi-pod:  (2, 16, 16) = 512 chips, axes ("pod", "data", "model") — the
"pod" axis is pure data parallelism across pods.

Building a mesh touches no device: ``device`` is only named.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch


class Mesh:
    """``axis_names`` and their sizes over one device. ``shape`` maps each
    name to its size, in axis order, as jax's ``mesh.shape`` does;
    ``size`` is the number of logical devices."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 device="cuda"):
        sizes, axis_names = tuple(int(s) for s in sizes), tuple(axis_names)
        if len(sizes) != len(axis_names) or any(s < 1 for s in sizes):
            raise ValueError(f"mesh sizes {sizes} over axes {axis_names}")
        self.axis_names: Tuple[str, ...] = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, sizes))
        self.size: int = math.prod(sizes)
        self.device = torch.device(device)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device)


def make_host_mesh(model: int = 2, data: int = 2, device="cuda") -> Mesh:
    """A small ("data", "model") mesh (tests)."""
    return Mesh((data, model), ("data", "model"), device)


def make_dev_mesh(n_devices: int, model: int = 0, device="cuda") -> Mesh:
    """The launchers' mesh of ``n_devices`` logical devices, as the JAX
    package's launchers pick it: the production mesh from 256 on, else
    (n / model, model) over ("data", "model") with model = min(4, n)
    unless given."""
    if n_devices >= 256 and not model:
        return make_production_mesh(device=device)
    model = model or max(1, min(4, n_devices))
    if n_devices % model:
        raise ValueError(f"model axis {model} does not divide {n_devices} "
                         "devices")
    return Mesh((n_devices // model, model), ("data", "model"), device)


def make_pipeline_mesh(stages: int, n_devices: int, device="cuda") -> Mesh:
    """The pipelined trainer's ("pipe", "data", "model") mesh of
    (stages, n / stages, 1)."""
    if stages < 1 or n_devices % stages:
        raise ValueError(f"{stages} stages do not divide {n_devices} "
                         "devices")
    return Mesh((stages, n_devices // stages, 1), ("pipe", "data", "model"),
                device)


__all__ = ["Mesh", "make_dev_mesh", "make_host_mesh", "make_pipeline_mesh",
           "make_production_mesh"]
