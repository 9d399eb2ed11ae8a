"""Train step: loss -> grads -> optimizer update (+ metrics).

The port of ``repro.train.train_step``. Gradients come from autograd over
``lm_loss`` (``models/transformer.py``); the update writes the parameters
and optimizer state in place (``train/optimizer.py``).

Gradient accumulation (``REPRO_MICROBATCH=k`` or the ``microbatches``
argument) splits the global batch into k sequential microbatches: the
activations shrink ~k x for one f32 params-sized accumulator; compute is
unchanged. The losses are averaged and the f32 sum of the gradients
divided by k, as the reference's scan does.

``make_pipeline_train_step`` trains the dense family stage-parallel on a
mesh's ``"pipe"`` axis (``dist/pipeline.py``): the same loss, its layer
stack run as stages over microbatches.
"""

from __future__ import annotations

import functools
import os

import torch

from ..configs.base import ModelConfig
from ..dist.ctx import suspend_annotations
from ..dist.pipeline import pipeline_apply, split_microbatches
from ..models.transformer import (_head, _scan_segment, dtype_of,
                                  init_params, layer_kinds, lm_loss,
                                  next_token_loss, unstack)
from .optimizer import make_optimizer
from .tree import leaves, unflatten


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, grads): ``lm_loss`` and its gradient with respect to every
    parameter, a tree like ``params`` (the parameters' dtypes). The
    parameters themselves are left as they are (no ``.grad``)."""
    return value_and_grads(functools.partial(lm_loss, cfg), params, batch)


def value_and_grads(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``, as ``loss_and_grads``
    takes them."""
    with torch.enable_grad():
        live = [t.detach().requires_grad_() for t in leaves(params)]
        loss = loss_fn(unflatten(params, live), batch)
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

    return _train_step(cfg, grads_of, lr)


def _train_step(cfg: ModelConfig, grads_of, lr: float):
    """``train_step(params, opt_state, batch)``: ``grads_of(params,
    batch)``'s loss and gradients, their norm, and the config's optimizer
    update in place."""
    _, update = make_optimizer(cfg.optimizer)

    def train_step(params, opt_state, batch):
        with torch.profiler.record_function("train_step.grads"):
            loss, grads = grads_of(params, batch)
            gnorm = grad_norm(grads)
        with torch.profiler.record_function("train_step.update"):
            params, opt_state = update(params, grads, opt_state, lr=lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_pipeline_loss(cfg: ModelConfig, mesh, *, n_micro: int,
                       axis: str = "pipe"):
    """``loss(params, batch)``: ``lm_loss`` with the dense layer stack run
    stage-parallel over ``mesh.shape[axis]`` equal stages and ``n_micro``
    microbatches (``pipeline_apply``). The embedding, the cast to the
    compute dtype, the final norm and the head run outside the pipeline,
    and the loss is the masked mean log-likelihood over the re-assembled
    batch. Each stage is ``_scan_segment`` over its layers, checkpointed
    under grad as the sequential forward is; every stacked leaf is unbound
    once (``unstack``), and the stages take consecutive runs of its
    layers. Only the dense family; a non-dense family or layers that do
    not split into equal stages raise ``ValueError``."""
    kinds = layer_kinds(cfg)
    if set(kinds) != {"dense"}:
        raise ValueError(
            f"pipeline parallelism supports the dense family for now, "
            f"got segments {sorted(kinds)} (family {cfg.family!r})")
    n_stages = mesh.shape[axis]
    n_layers = kinds["dense"]
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers do not split into {n_stages} equal stages")
    per = n_layers // n_stages

    def stage_fn(stage_layers, x):
        return _scan_segment(cfg, "dense", stage_layers, x)[0]

    def loss_fn(params, batch):
        with suspend_annotations():   # the pipeline owns the layout
            tokens = batch.get("tokens")
            x = (params["embed"][tokens] if batch.get("embeds") is None
                 else batch["embeds"])
            x = x.to(dtype_of(cfg.compute_dtype))
            layers = unstack(params["dense"])
            stages = [layers[s * per:(s + 1) * per]
                      for s in range(n_stages)]
            ys = pipeline_apply(stage_fn, stages,
                                split_microbatches(x, n_micro), mesh=mesh,
                                axis=axis)
            logits = _head(cfg, params, ys.reshape(x.shape))
        return next_token_loss(logits, batch["labels"])

    return loss_fn


def make_pipeline_train_step(cfg: ModelConfig, mesh, *, lr: float = 3e-4,
                             n_micro: int, axis: str = "pipe"):
    """Pipeline-parallel train step over a ("pipe", "data", "model") mesh:
    ``train_step(params, opt_state, batch)`` as ``make_train_step``'s, with
    the loss of ``make_pipeline_loss``. Gradients flow back through the
    pipeline by autograd; the same bodies in the same microbatch order as
    the sequential ``lm_loss``, so the loss is the sequential one up to the
    rounding of per-microbatch products."""
    return _train_step(cfg, functools.partial(
        value_and_grads, make_pipeline_loss(cfg, mesh, n_micro=n_micro,
                                            axis=axis)), lr)


def init_train_state(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """(params, optimizer state) of ``cfg``: ``init_params`` from ``seed``
    on ``device`` and the config's optimizer's initial state."""
    init_opt, _ = make_optimizer(cfg.optimizer)
    params = init_params(cfg, seed=seed, device=device)
    return params, init_opt(params)


__all__ = ["grad_norm", "init_train_state", "loss_and_grads",
           "make_pipeline_loss", "make_pipeline_train_step",
           "make_train_step", "value_and_grads"]
