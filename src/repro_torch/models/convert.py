"""Parameters of the JAX package's models as the port's tensors.

``repro.models.transformer.init_params(cfg, key)`` returns a pytree of
arrays; given as numpy arrays (``jax.tree.map(np.asarray, params)``) it
becomes the port's dict of tensors with the same tree, names, shapes and
values, so both packages then compute the same function. bfloat16 arrays
(numpy's ``ml_dtypes`` type) keep their bits. Optimizer states convert
too (``opt_state_from_reference``), and ``to_numpy`` turns the port's
trees back into numpy arrays. On a mesh of ranks with a model axis a rank
carries across only its shard (``shard_params_from_reference``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_tensor(a, device="cuda") -> torch.Tensor:
    """One numpy array as a tensor on ``device``, bit for bit."""
    a = np.array(a)                 # a writable copy torch may own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_reference(tree: Any, device="cuda") -> Any:
    """A (nested dict / list / tuple / NamedTuple) tree of numpy arrays as
    tensors."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(params_from_reference(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_reference(v, device) for v in tree)
    return to_tensor(tree, device)


def opt_state_from_reference(state: Any, device="cuda") -> Any:
    """``repro``'s optimizer state (its ``AdamWState`` or
    ``AdafactorState``, leaves as numpy arrays) as the port's state of the
    same name, the fields' trees as tensors."""
    from ..train import optimizer

    cls = getattr(optimizer, type(state).__name__)
    return cls(**{f: params_from_reference(getattr(state, f), device)
                  for f in cls._fields})


def to_numpy(tree: Any) -> Any:
    """The other way: a tree of tensors as numpy arrays, in the same
    structure (NamedTuples kept). bfloat16 comes out as float32, exactly
    (numpy has no bfloat16 of its own)."""
    from ..train.tree import tree_map

    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(one, tree)


def shard_params_from_reference(cfg, tree: Any, mesh, device="cuda") -> Any:
    """This rank's shard of ``repro``'s parameters on a mesh of ranks with
    a model axis: each numpy leaf sliced by
    ``dist.tensor_parallel.shard_params`` before it is copied, so only the
    shard becomes a tensor on ``device``."""
    from ..dist.tensor_parallel import shard_params

    return params_from_reference(shard_params(cfg, tree, mesh), device)
