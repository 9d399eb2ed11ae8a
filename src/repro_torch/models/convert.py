"""Parameters of the JAX package's models as the port's tensors.

``repro.models.transformer.init_params(cfg, key)`` returns a pytree of
arrays; given as numpy arrays (``jax.tree.map(np.asarray, params)``) it
becomes the port's dict of tensors with the same tree, names, shapes and
values, so both packages then compute the same function. bfloat16 arrays
(numpy's ``ml_dtypes`` type) keep their bits.
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
    """A (nested dict / list / tuple) tree of numpy arrays as tensors."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_reference(v, device) for v in tree)
    return to_tensor(tree, device)
