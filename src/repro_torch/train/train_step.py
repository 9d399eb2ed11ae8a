"""Train step: loss -> grads -> optimizer update (+ metrics).

The port of ``repro.train.train_step``. Gradients come from autograd over
``lm_loss`` (``models/transformer.py``); the update writes the parameters
and optimizer state in place (``train/optimizer.py``).

Gradient accumulation (``REPRO_MICROBATCH=k`` or the ``microbatches``
argument) splits the global batch into k sequential microbatches: the
activations shrink ~k x for one f32 params-sized accumulator; compute is
unchanged. The losses are averaged and the f32 sum of the gradients
divided by k, as the reference's scan does.
"""

from __future__ import annotations

import os
import torch

from ..configs.base import ModelConfig
from ..models.transformer import init_params, lm_loss
from .optimizer import make_optimizer
from .tree import leaves, unflatten


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, grads): ``lm_loss`` and its gradient with respect to every
    parameter, a tree like ``params`` (the parameters' dtypes). The
    parameters themselves are left as they are (no ``.grad``)."""
    with torch.enable_grad():
        live = [t.detach().requires_grad_() for t in leaves(params)]
        loss = lm_loss(cfg, unflatten(params, live), batch)
        # a parameter the loss does not reach (the embedding of a model
        # fed embeds) gets zeros, as in JAX
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), unflatten(params, grads)


def grad_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in JAX's order) of sum(g²) in f32."""
    total = None
    for g in leaves(grads):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4,
                    microbatches: int | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``; ``batch`` is a dict of tensors on the
    parameters' device, split along its first axis into the microbatches.
    The parameters and optimizer state are updated in place."""
    _, update = make_optimizer(cfg.optimizer)
    mb = microbatches or int(os.environ.get("REPRO_MICROBATCH", "1"))

    def grads_of(params, batch):
        if mb <= 1:
            return loss_and_grads(cfg, params, batch)
        split = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
                 for k, v in batch.items()}
        acc, losses = None, []
        for i in range(mb):
            loss, g = loss_and_grads(cfg, params,
                                     {k: v[i] for k, v in split.items()})
            losses.append(loss)
            g = [t.float() for t in leaves(g)]
            acc = g if acc is None else [a + b for a, b in zip(acc, g)]
        return (torch.stack(losses).mean(),
                unflatten(params, [t / mb for t in acc]))

    def train_step(params, opt_state, batch):
        with torch.profiler.record_function("train_step.grads"):
            loss, grads = grads_of(params, batch)
            gnorm = grad_norm(grads)
        with torch.profiler.record_function("train_step.update"):
            params, opt_state = update(params, grads, opt_state, lr=lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_pipeline_train_step(cfg: ModelConfig, mesh=None, **kwargs):
    """The pipeline-parallel train step waits for the port's pipeline
    (ROADMAP A9)."""
    raise NotImplementedError(
        "make_pipeline_train_step: the pipeline is not ported yet (ROADMAP "
        "A9); use make_train_step")


def init_train_state(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """(params, optimizer state) of ``cfg``: ``init_params`` from ``seed``
    on ``device`` and the config's optimizer's initial state."""
    init_opt, _ = make_optimizer(cfg.optimizer)
    params = init_params(cfg, seed=seed, device=device)
    return params, init_opt(params)


__all__ = ["grad_norm", "init_train_state", "loss_and_grads",
           "make_pipeline_train_step", "make_train_step"]
