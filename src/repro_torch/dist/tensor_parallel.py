"""Tensor parallelism on rank processes: the ``"model"`` axis of a mesh of
ranks (``launch.mesh.Mesh(..., group=)``) for serving the dense and vlm
families.

The JAX package has no counterpart: its launchers place the weights and
the decode cache by ``param_specs``/``cache_specs`` on a mesh of devices
and GSPMD inserts the collectives. Here each rank process holds its own
shard and the model code calls the collectives of Megatron-style tensor
parallelism, over ``mesh.groups["model"]`` through ``mesh.transport``
(gloo over pinned host memory):

- column-parallel products (``wq``, ``wk``, ``wv``, ``w_gate``, ``w_in``,
  and ``lm_head`` or a tied ``embed.T`` on the vocabulary) take their
  replicated input as it is: the identity;
- a row-parallel product (``wo``, ``w_out``) gives each rank a partial
  sum, all-reduced by :func:`row_product`;
- the vocab-sharded ``embed`` is looked up by :func:`vocab_embed`: each
  rank takes the rows of the tokens in its range, zeros elsewhere, and an
  all-reduce sums them (exact: one term is nonzero);
- the vocab-sharded logits are gathered by :func:`vocab_gather` (greedy
  argmax and the returned ``[B, V]`` read all of them).

With no mesh of ranks with a model axis > 1 in the context every one of
them is the identity, so the one-process and logical-mesh paths are bit for
bit what they were. The model code takes its head counts from the local
weights' shapes.

Rounding. ``TensorTransport.all_reduce`` sums in f32 only. The
one-process bf16 product sums all of its terms in the matmul's f32
accumulator and rounds once to bf16. A rank's partial over its slice of
the contraction, rounded to bf16 before the sum, would round once more
per partial (2^-8 relative; on yi-6b's 32 layers at full width the
prefill logits then moved 2.2e-2 of their largest from the one-process
run's, past the 2e-2 bf16 gate, on the H100). So :func:`row_product`
forms the partial in f32 from the bf16 operands (their products are exact
in f32: the one-process accumulation, split by ranks), sums the partials
in f32 and rounds once: the result differs from the one-process product
only by the order of the f32 sums, as in f32 compute. The partial runs as
an f32 product (TF32 off), the price of the one rounding.

Shards. :func:`shard_params` slices a full parameter tree by
``param_specs`` sanitized against the mesh (what ``named_shardings``
reads), :func:`shard_cache` a full decode cache by ``cache_specs``.
Where ``kv_head_pad`` > 1 the specs split ``wk``/``wv`` inside a KV head
(starcoder2-3b's 2 KV heads of 128 over a model axis of 4: 64 columns),
which GSPMD reshards and explicit tensor parallelism cannot use: each rank
holds instead the whole KV head its query heads read, the one the padded
cache layout (``repeat_interleave(pad)``) puts in its head shard, and
writes it into its own cache shard, unpadded on the rank. The placements
``named_shardings`` gives stay those of ``repro`` (values, not DTensors:
real DTensors need NCCL with one card per rank, ROADMAP A8b).
:func:`init_shard_params` draws the weights leaf by leaf from the one
seeded generator and keeps only the rank's shard, so no rank holds the
whole model (yi-6b is 24.2 GB in f32); the values are bit for bit the
slices of ``init_params(cfg, seed=seed)``.

What a model axis on ranks does not run yet raises ``ValueError`` naming
its ROADMAP item (:func:`check_tp`): the moe family (A8d2), MLA (A8d3),
the ssm and hybrid families (A8d4), encdec (A8d5); under grad the
collectives raise (training with a model axis, A8d6).
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

from ..configs.base import ModelConfig
from .ctx import get_mesh
from .sharding import (P, cache_specs, kv_head_pad, map_tree, param_specs,
                       sanitize_specs)

# what the model axis on ranks does not run yet, and the ROADMAP item that
# ports it
UNPORTED = {"moe": "moe expert parallelism on ranks (ROADMAP A8d2)",
            "mla": "MLA on ranks (ROADMAP A8d3)",
            "ssm": "the ssm and hybrid heads on ranks (ROADMAP A8d4)",
            "hybrid": "the ssm and hybrid heads on ranks (ROADMAP A8d4)",
            "encdec": "encdec cross-attention on ranks (ROADMAP A8d5)"}
TRAINING = ("training with a model axis on ranks (the backward of the "
            "tensor-parallel collectives) is ROADMAP A8d6")


def unported(cfg: ModelConfig) -> List[str]:
    """What of ``cfg`` a model axis on ranks does not run yet, each with
    its ROADMAP item; empty for the dense and vlm families."""
    out = []
    if cfg.family in UNPORTED:
        out.append(UNPORTED[cfg.family])
    if cfg.attention == "mla":
        out.append(UNPORTED["mla"])
    return out


def check_tp(cfg: ModelConfig, model: int) -> None:
    """Raise ``ValueError`` unless a model axis of ``model`` ranks can
    serve ``cfg``: a dense or vlm config whose query heads, padded KV heads
    (``kv_head_pad``), vocabulary and d_ff the axis divides."""
    if model == 1:
        return
    missing = unported(cfg)
    if missing:
        raise ValueError(f"{cfg.name} ({cfg.family}) on a model axis of "
                         f"{model} ranks: " + "; ".join(missing))
    hkv = max(cfg.n_kv_heads, 1) * kv_head_pad(cfg, model)
    for what, n in (("query heads", cfg.n_heads),
                    ("KV heads (padded)", hkv),
                    ("vocabulary", cfg.vocab_size), ("d_ff", cfg.d_ff)):
        if n % model:
            raise ValueError(f"{cfg.name} on a model axis of {model} ranks: "
                             f"its {n} {what} do not divide over the axis")


def tp_mesh():
    """The ambient mesh when it lies on ranks with a model axis > 1 (the
    collectives run), else None (they are the identity)."""
    mesh = get_mesh()
    if mesh is None or mesh.group is None or mesh.shape.get("model", 1) == 1:
        return None
    return mesh


def require(cfg: ModelConfig) -> None:
    """Under a ranked model axis, :func:`check_tp` of ``cfg``."""
    mesh = tp_mesh()
    if mesh is not None:
        check_tp(cfg, mesh.shape["model"])


def _no_grad(t: torch.Tensor) -> None:
    if t.requires_grad:
        raise RuntimeError(TRAINING)


def _sum_f32(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group in f32, in ``t``'s dtype."""
    _no_grad(t)
    f = t.float() if t.dtype != torch.float32 else t
    mesh.transport.all_reduce(f, mesh.groups["model"])
    return f if f is t else f.to(t.dtype)


def row_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a row-parallel weight (``wo``, ``w_out``): the product
    itself on one process; under tensor parallelism this rank's partial
    over its slice of the contraction, formed in f32 from ``x``'s and
    ``w``'s values, summed over the model group in f32 and rounded to
    ``x``'s dtype once."""
    mesh = tp_mesh()
    if mesh is None:
        return x @ w
    _no_grad(x)
    return _sum_f32(mesh, x.float() @ w.float()).to(x.dtype)


def vocab_embed(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]`` of a vocab-sharded ``embed`` (this rank's rows):
    the tokens in the rank's range looked up, zeros elsewhere, summed over
    the model group."""
    mesh = tp_mesh()
    if mesh is None:
        return embed[tokens]
    rows = embed.shape[0]
    local = tokens - mesh.coords["model"] * rows
    hit = (local >= 0) & (local < rows)
    x = torch.where(hit[..., None], embed[local.clamp(0, rows - 1)],
                    torch.zeros((), dtype=embed.dtype, device=embed.device))
    return _sum_f32(mesh, x)


def vocab_gather(logits: torch.Tensor) -> torch.Tensor:
    """The logits of every rank's vocabulary slice [..., V / model],
    concatenated in the model axis's order: [..., V]."""
    mesh = tp_mesh()
    if mesh is None:
        return logits
    _no_grad(logits)
    return torch.cat(mesh.transport.all_gather(logits, mesh.groups["model"]),
                     dim=-1)


# ------------------------------------------------------------------ shards

def param_shard_specs(cfg: ModelConfig, mesh) -> Any:
    """``param_specs`` of ``mesh``'s model axis sanitized against the mesh:
    the specs ``named_shardings`` turns into placements."""
    from ..models.transformer import abstract_params

    return sanitize_specs(param_specs(cfg, model_axis=mesh.shape["model"]),
                          abstract_params(cfg), mesh)


def _span(entry, mesh) -> Tuple[int, int]:
    """(this rank's index, the count of shards) along one spec entry: the
    row-major position of its coordinates over the entry's axes."""
    names = entry if isinstance(entry, tuple) else (entry,)
    at, n = 0, 1
    for a in names:
        at, n = at * mesh.shape[a] + mesh.coords[a], n * mesh.shape[a]
    return at, n


def shard_index(spec: P, shape, mesh) -> tuple:
    """The slices of this rank's shard of a leaf of ``shape`` under the
    sanitized ``spec``."""
    idx = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            idx.append(slice(None))
            continue
        at, n = _span(entry, mesh)
        size = dim // n
        idx.append(slice(at * size, (at + 1) * size))
    return tuple(idx)


def _kv_head_index(cfg: ModelConfig, shape, mesh) -> tuple:
    """Where ``kv_head_pad`` > 1: the columns of ``wk``/``wv`` [..., d,
    Hkv·hd] of the KV heads this rank's padded cache heads hold."""
    model, hd = mesh.shape["model"], cfg.head_dim
    pad = kv_head_pad(cfg, model)
    per = cfg.n_kv_heads * pad // model        # padded heads a rank holds
    first = mesh.coords["model"] * per
    lo, hi = first // pad, (first + per - 1) // pad + 1
    return (slice(None),) * (len(shape) - 1) + (slice(lo * hd, hi * hd),)


def _param_index(cfg: ModelConfig, path, spec: P, shape, mesh) -> tuple:
    if path[-1] in ("wk", "wv") and kv_head_pad(cfg,
                                                mesh.shape["model"]) > 1:
        return _kv_head_index(cfg, shape, mesh)
    return shard_index(spec, shape, mesh)


def _walk(tree, specs, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, specs[k], fn, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, specs)


def shard_params(cfg: ModelConfig, params: Any, mesh) -> Any:
    """This rank's shard of the full parameter tree ``params`` (tensors or
    numpy arrays): each leaf sliced by its sanitized ``param_specs`` entry
    on ``mesh``'s coordinates, ``wk``/``wv`` by their KV heads where
    ``kv_head_pad`` > 1. Slices are views of ``params``' leaves."""
    check_tp(cfg, mesh.shape["model"])
    return _walk(params, param_shard_specs(cfg, mesh),
                 lambda path, leaf, spec: leaf[_param_index(
                     cfg, path, spec, leaf.shape, mesh)])


def init_shard_params(cfg: ModelConfig, mesh, *, seed: int = 0,
                      device="cuda") -> Any:
    """This rank's shard of ``init_params(cfg, seed=seed, device=device)``,
    drawn leaf by leaf from the same generator and kept as soon as each
    leaf is drawn: bit for bit the slices :func:`shard_params` takes, with
    at most one whole leaf in memory."""
    from ..models.transformer import init_params

    check_tp(cfg, mesh.shape["model"])
    specs = param_shard_specs(cfg, mesh)

    def keep(path, leaf):
        spec = specs
        for k in path:
            spec = spec[k]
        return leaf[_param_index(cfg, path, spec, leaf.shape,
                                 mesh)].clone()

    return init_params(cfg, seed=seed, device=device, keep=keep)


def cache_shard_specs(cfg: ModelConfig, cache, mesh, global_batch: int
                      ) -> Any:
    """``cache_specs`` of the full decode cache ``cache`` (meta or real)
    sanitized against ``mesh``, the batch over ``batch_axis``."""
    from .sharding import batch_axis

    return sanitize_specs(
        cache_specs(cfg, cache, batch_axis(mesh, global_batch),
                    model_axis=mesh.shape["model"]), cache, mesh)


def shard_cache(cfg: ModelConfig, cache, mesh) -> Any:
    """This rank's shard of the full decode cache ``cache`` (built with
    ``kv_head_pad(cfg, model)``): every leaf sliced by its sanitized
    ``cache_specs`` entry (heads on ``"model"``, the batch on its axes), as
    a copy; ``pos`` kept."""
    check_tp(cfg, mesh.shape["model"])
    batch = cache.layers["dense"][0].shape[1]
    specs = cache_shard_specs(cfg, cache, mesh, batch)
    return type(cache)(pos=cache.pos, layers=map_tree(
        lambda leaf, spec: leaf[shard_index(spec, leaf.shape,
                                            mesh)].clone(),
        cache.layers, specs.layers))


def init_shard_cache(cfg: ModelConfig, mesh, global_batch: int,
                     max_seq: int, dtype=torch.bfloat16, *,
                     device="cuda") -> Any:
    """This rank's shard of ``init_cache(cfg, global_batch, max_seq,
    dtype, kv_head_pad=kv_head_pad(cfg, model))``, zeros, made at its own
    size (the whole cache is never built)."""
    from ..models.transformer import init_cache

    check_tp(cfg, mesh.shape["model"])
    pad = kv_head_pad(cfg, mesh.shape["model"])
    whole = init_cache(cfg, global_batch, max_seq, dtype, device="meta",
                       kv_head_pad=pad)
    specs = cache_shard_specs(cfg, whole, mesh, global_batch)
    return type(whole)(pos=0, layers=map_tree(
        lambda leaf, spec: torch.zeros(
            local_shape(spec, leaf.shape, mesh), dtype=dtype, device=device),
        whole.layers, specs.layers))


def local_shape(spec: P, shape, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a leaf of ``shape`` under the
    sanitized ``spec``."""
    return tuple(dim if entry is None else dim // _span(entry, mesh)[1]
                 for dim, entry in zip(shape, spec))


__all__ = ["TRAINING", "UNPORTED", "cache_shard_specs", "check_tp",
           "init_shard_cache", "init_shard_params", "local_shape",
           "param_shard_specs", "require", "row_product", "shard_cache",
           "shard_index", "shard_params", "tp_mesh",
           "unported", "vocab_embed", "vocab_gather"]
