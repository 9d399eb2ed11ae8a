"""Tensor parallelism on rank processes: the ``"model"`` axis of a mesh of
ranks (``launch.mesh.Mesh(..., group=)``) for serving and training every
family: dense, vlm and moe (GQA or MLA attention), ssm (Mamba-2), hybrid
(Mamba-2 with the shared attention block) and encdec (cross-attention).

The JAX package has no counterpart: its launchers place the weights and
the decode cache by ``param_specs``/``cache_specs`` on a mesh of devices
and GSPMD inserts the collectives. Here each rank process holds its own
shard and the model code calls the collectives of Megatron-style tensor
parallelism, over ``mesh.groups["model"]`` through ``mesh.transport``
(gloo over pinned host memory):

- column-parallel products (``wq``, ``wk``, ``wv``, MLA's ``wq_b`` and
  ``wkv_b``, ``w_gate``, ``w_in``, the shared experts' ``shared_w_gate``
  and ``shared_w_in``, Mamba-2's ``w_in``, and a vocab-sharded
  ``lm_head`` or tied ``embed.T``) take their replicated input as it is:
  the identity in the forward, and where training reaches them
  (attention, the FFN, the experts, the Mamba-2 mixer, the head) through
  :func:`copy_to_model`, whose backward sums the input's gradient over
  the group (Megatron's f);
- a row-parallel product (``wo``, the cross-attention's ``wo``,
  ``w_out``, ``shared_w_out``, Mamba-2's ``w_out``) gives each rank a
  partial sum, all-reduced by :func:`row_product` (Megatron's g: its
  backward is the identity);
- Mamba-2's gated RMSNorm normalises over the whole d_inner, which the
  heads split: :func:`group_rms_norm` sums each rank's f32 squares over
  the model group (one [T, 1] all-reduce) and divides by the whole width;
  the sum feeds every rank's outputs, so its backward sums the gradient
  of the squares over the group too (one more [T, 1] all-reduce);
- the experts (``models/moe.py``): every rank routes every token of its
  dispatch row with the whole router (each rank of a model group holds
  the same tokens, so no all-to-all), scatters the slots of its own
  experts (or, where the axis does not divide the experts, every slot
  into its slice of each expert's hidden dim), and its f32 combine is a
  partial summed over the group by :func:`sum_partials`, with the shared
  experts' partial in the same collective;
- the embedding and the head (:func:`embed_lookup`, :func:`head_logits`,
  :func:`gather_logits`) take one of two layouts, as ``param_specs``
  shards ``embed`` (:func:`vocab_sharded`). Where the axis divides the
  vocabulary, ``embed`` [V / model, d] and ``lm_head`` [d, V / model]
  (or the tied ``embed.T``) are split on it: a rank looks up the tokens
  in its range, zeros elsewhere, and an all-reduce sums them (exact: one
  term is nonzero; under grad each token's gradient lands in the rank's
  own rows), and its logits [..., V / model] are gathered (greedy argmax,
  the returned ``[B, V]`` and the loss read all of them; under grad each
  rank takes its own slice of the gathered gradient). Elsewhere (seamless-
  m4t-large-v2's 256 206 on 4 ranks) they are split on d_model: ``embed``
  [V, d / model] and ``lm_head`` [d / model, V] (a tied ``embed.T`` the
  same rows). A rank looks up its d-slice of every token's row and the
  slices are gathered on the last dim (exact: the one-process rows; under
  grad the rank takes its slice of the gradient, no sum); the head is
  row-parallel: the normed hidden state enters through its rank's d-slice,
  whose backward all-gathers the slices' gradients (whole on every rank:
  [T, d / model] in the compute dtype to each peer, where ``copy_to_model``
  and a slice would all-reduce [T, d] in f32), and the rank's f32 partial
  [..., V], formed from the operands' values, is summed over the group in
  f32 and rounded once, as :func:`row_product`'s; a prefill sums the last
  position's partial only ([B, V], not [B, S, V]).

With no mesh of ranks with a model axis > 1 in the context every one of
them is the identity (the group norm the plain ``rms_norm``, the head the
one-process product), so the one-process and logical-mesh paths are bit
for bit what they were. The model code takes its head, expert and Mamba-2
sizes from the local weights' shapes.

Rounding. The transports' ``all_reduce`` sums in f32 only. The
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
reads), :func:`shard_cache` a full decode cache by ``cache_specs``. Four
layouts of the specs explicit tensor parallelism cannot use, where each
rank holds other parts than its spec's shard (the placements
``named_shardings`` gives stay those of ``repro``: values, not DTensors;
real DTensors need NCCL with one card per rank, ROADMAP A8b):

- where ``kv_head_pad`` > 1 the specs split ``wk``/``wv`` inside a KV
  head (starcoder2-3b's 2 KV heads of 128 over a model axis of 4: 64
  columns), which GSPMD reshards: each rank holds instead the whole KV
  head its query heads read, the one the padded cache layout
  (``repeat_interleave(pad)``) puts in its head shard, and writes it into
  its own cache shard, unpadded on the rank;
- the router [L, d, E] is whole on every rank (the specs shard E, or d):
  a gathered or all-reduced router product need not be bit for bit the
  one-process product, and a near tie would then flip a top-k choice, so
  each rank routes with the one-process call on the same operands;
- MLA's ``wq_a`` and ``wkv_a`` (the specs shard their ``q_lora`` and
  ``kv_lora + rope`` columns, which ``q_ln`` and ``kv_ln`` normalise
  over) and its latent cache [L, B, S, r] / [L, B, S, rope] (the specs
  shard its sequence) are whole on every rank, and every rank writes the
  same latents; the heads of ``wq_b``, ``wkv_b`` and ``wo`` split;
- Mamba-2 is head-aligned (``mamba2.head_columns``, beside the packing
  it cuts): the specs cut the packed ``w_in`` [L, d, z | x | B | C | dt]
  and the conv's ``conv_w`` and conv state [.., x | B | C] into
  contiguous blocks, and replicate ``a_log``, ``d_skip``, ``dt_bias``
  and ``norm_w``; a rank holds instead the z, x and dt columns of its
  heads, the B and C columns of the groups they read (``n_groups /
  model`` of them where the axis divides the groups, else the one group
  its heads read), its heads' slices of the vectors and of the SSM state
  [L, B, nh, N, P] (as the spec has it), and ``w_out``'s rows of its
  heads (the spec's shard).

:func:`init_shard_params` draws each leaf as the rank's box of it (a list
of column boxes for Mamba-2's packed leaves) from the one seeded generator
(``init_params(shard=)``), so no rank holds the whole model (yi-6b is
24.2 GB in f32) nor a whole leaf drawn piece by piece (an expert stack of
grok-1-314b is 25.8 GB in bf16): the values are bit for bit the slices of
``init_params(cfg, seed=seed)``.

Training. Every rank computes the whole loss from the whole logits, so
the gradient of every replicated activation is whole on every rank, and
each sharded weight's gradient is its own slice of the one-process
gradient. A leaf that several ranks of a model line hold and that the
sharded region reads (:func:`box_holders`; qwen3's ``q_norm``/``k_norm``
on head-sharded q and k, a KV head replicated ``kv_head_pad`` times, the
MoE's whole router, which each rank reads for its own slots only), and a
column piece of a Mamba-2 leaf that several ranks hold
(:func:`column_holders`: the B and C columns of ``w_in``, ``conv_w`` and
``conv_b`` of a group whose heads the axis splits, mamba2-1.3b's and
zamba2-1.2b's one group on every rank), gets on each rank the gradient of
that rank's heads or slots only: the trainer (``train.train_step``) sums
it over its holders. :func:`sum_partials`, the MoE's combine and shared
experts' sum, is Megatron's g (its backward the identity on each stacked
partial), and the MoE's input enters through f. MLA's ``wq_a``,
``wkv_a``, ``q_ln`` and ``kv_ln`` are whole on every rank and feed the
head-sharded ``wq_b``/``wkv_b``: their outputs, the latents, enter the
heads through one f (:func:`copy_all_to_model`), so the gradients of
those leaves and of the attention's input come out whole on every rank
and nothing else is summed. All sums stay in f32 (or wider), in the
backward as in the forward. Under ``remat`` the checkpointed blocks run
their forward collectives again in the backward, on every rank in the
same order.

What a model axis on ranks does not run raises ``ValueError``
(:func:`check_tp`): heads, widths or SSM groups the axis does not divide.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, List, Tuple

import torch

from ..configs.base import ModelConfig
from ..models.layers import rms_norm, take_box
from ..train.tree import leaf_paths, unflatten
from .ctx import get_mesh
from .sharding import (P, cache_specs, kv_head_pad, map_tree, param_specs,
                       sanitize_specs)

def vocab_sharded(cfg: ModelConfig, model: int) -> bool:
    """Whether a model axis of ``model`` ranks splits the embedding and the
    head on the vocabulary (it divides it), or else on d_model:
    ``param_specs``' rule for ``embed`` (``lm_head`` [d, V] falls to its
    rows by ``_matmul_spec`` where V does not divide)."""
    return cfg.vocab_size % model == 0


def check_tp(cfg: ModelConfig, model: int) -> None:
    """Raise ``ValueError`` unless a model axis of ``model`` ranks can
    serve and train ``cfg``: the axis must divide its vocabulary or else
    its d_model (:func:`vocab_sharded`); its query heads and padded KV
    heads (``kv_head_pad``; GQA; encdec's KV heads unpadded, as its cross
    cache is), and the dense d_ff of a family with dense FFNs; for the moe
    family its experts (or else the expert d_ff) and the shared experts'
    d_ff; for Mamba-2 (ssm, hybrid) its heads, and its groups or the axis
    the groups."""
    if model == 1:
        return
    from ..models.transformer import layer_kinds

    sizes = []
    if not vocab_sharded(cfg, model):
        sizes.append(("columns of d_model (the embedding and head split "
                      f"them: its vocabulary of {cfg.vocab_size} does not "
                      "divide either)", cfg.d_model))
    if cfg.family != "ssm":
        sizes.append(("query heads", cfg.n_heads))
    if cfg.family == "encdec":
        sizes.append(("KV heads", cfg.n_kv_heads))
    elif cfg.attention not in ("mla", "none"):
        sizes.append(("KV heads (padded)", max(cfg.n_kv_heads, 1)
                      * kv_head_pad(cfg, model)))
    if "dense" in layer_kinds(cfg) or cfg.family in ("hybrid", "encdec"):
        sizes.append(("d_ff", cfg.d_ff))
    if cfg.moe is not None:
        m = cfg.moe
        if m.n_experts % model:
            sizes.append((f"expert d_ff (its {m.n_experts} experts do not "
                          "divide)", m.d_ff))
        if m.n_shared_experts:
            sizes.append(("shared experts' d_ff",
                          m.d_ff * m.n_shared_experts))
    if cfg.ssm is not None:
        g = cfg.ssm.n_groups
        if g % model and model % g:
            raise ValueError(f"{cfg.name} on a model axis of {model} ranks: "
                             f"its {g} SSM groups neither divide the axis "
                             "nor are divided by it")
        sizes.append(("SSM heads", cfg.ssm.n_heads(cfg.d_model)))
    for what, n in sizes:
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


def _wide(t: torch.Tensor) -> torch.dtype:
    """The dtype a sum of ``t`` runs in: f32, or ``t``'s if wider."""
    return torch.promote_types(t.dtype, torch.float32)


class _Sum(torch.autograd.Function):
    """Megatron's g: ``t`` summed over the model group, in place; the
    backward is the identity."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mark_dirty(t)
        mesh.transport.all_reduce(t, mesh.groups["model"])
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sum(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group in f32 (or wider), in ``t``'s
    dtype: in place where ``t`` is already that wide. Under grad the
    sum's backward is the identity (:class:`_Sum`)."""
    f = t if t.dtype == _wide(t) else t.to(_wide(t))
    f = _Sum.apply(f, mesh)
    return f if f.dtype == t.dtype else f.to(t.dtype)


class _Copy(torch.autograd.Function):
    """Megatron's f: the identity; the backward sums a copy of the input's
    gradient over the model group (:func:`_sum`)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(ctx.mesh, g.to(_wide(g), copy=True)).to(g.dtype), None


class _Both(torch.autograd.Function):
    """``t`` summed over the model group, in place, where every rank's
    ``t`` feeds every rank's outputs (Megatron's g in the forward, f in
    the backward): the backward sums the gradient over the group too.
    ``t`` is f32 or wider."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        ctx.mark_dirty(t)
        mesh.transport.all_reduce(t, mesh.groups["model"])
        return t

    @staticmethod
    def backward(ctx, g):
        return _sum(ctx.mesh, g.clone()), None


class _Slice(torch.autograd.Function):
    """This rank's slice [..., n / model] of a replicated ``x`` [..., n]
    (the input of the d_model-sharded head); the backward gathers every
    rank's slice of the gradient: whole on every rank."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        n = x.shape[-1] // mesh.shape["model"]
        return x[..., mesh.coords["model"] * n:
                 (mesh.coords["model"] + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(ctx.mesh.transport.all_gather(
            g.contiguous(), ctx.mesh.groups["model"]), dim=-1), None


class _Gather(torch.autograd.Function):
    """Every rank's [..., n] (its vocabulary's logits, or its d-slice of
    the embedding's rows), concatenated on the last dim; the backward
    takes this rank's slice of the gradient, with no sum."""

    @staticmethod
    def forward(ctx, logits, mesh):
        ctx.lo, ctx.n = mesh.coords["model"] * logits.shape[-1], \
            logits.shape[-1]
        return torch.cat(mesh.transport.all_gather(logits,
                                                   mesh.groups["model"]),
                         dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.n], None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x``, a replicated activation entering column-parallel products
    (the attention's input and the cross-attention's source, the FFN's
    input, a vocab-sharded head's input, the Mamba-2 mixer's input). Under
    tensor parallelism, Megatron's f: the
    identity, whose backward sums the gradient of ``x`` over the model
    group, each rank holding the part that flowed through its own
    columns. ``x`` itself otherwise."""
    mesh = tp_mesh()
    return x if mesh is None else _Copy.apply(x, mesh)


def copy_all_to_model(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``xs`` (one dtype, one shape but the last dim) entering
    column-parallel products together: Megatron's f on their concatenation,
    so that the backward sums their gradients over the model group in one
    all-reduce. ``xs`` themselves without tensor parallelism."""
    mesh = tp_mesh()
    if mesh is None:
        return xs
    both = _Copy.apply(torch.cat(xs, dim=-1), mesh)
    return tuple(both.split([x.shape[-1] for x in xs], dim=-1))


def group_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
                   ) -> torch.Tensor:
    """``rms_norm(x, w)`` over the whole last dim of which ``x`` [..., n]
    is this rank's slice (Mamba-2's gated norm over d_inner, its heads
    split): the f32 (or wider) sum of squares summed over the model group
    in one [..., 1] all-reduce and divided by ``n`` times the axis. Under
    grad the sum's backward sums the squares' gradient over the group
    (:class:`_Both`: each rank's squares scale every rank's outputs);
    ``w``, split as ``x`` is, keeps its own gradient. ``rms_norm`` itself
    on one process."""
    mesh = tp_mesh()
    if mesh is None:
        return rms_norm(x, w, eps)
    f = x.to(_wide(x))
    squares = _Both.apply((f * f).sum(dim=-1, keepdim=True), mesh)
    f = f * torch.rsqrt(squares / (x.shape[-1] * mesh.shape["model"]) + eps)
    return (f * w.to(f.dtype)).to(x.dtype)


def row_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a row-parallel weight (``wo``, ``w_out``): the product
    itself on one process; under tensor parallelism this rank's partial
    over its slice of the contraction, formed in f32 from ``x``'s and
    ``w``'s values, summed over the model group in f32 and rounded to
    ``x``'s dtype once. Under grad the sum's backward is the identity
    (Megatron's g): the output's gradient reaches each rank's partial."""
    mesh = tp_mesh()
    if mesh is None:
        return x @ w
    return _sum(mesh, x.float() @ w.float()).to(x.dtype)


def sum_partials(*parts: torch.Tensor) -> List[torch.Tensor]:
    """f32 partials of one shape summed over the model group in one
    all-reduce (each its own sum: stacked, reduced, split): the MoE's
    combine and its shared experts' ``w_out`` product. Under grad the
    sum's backward is the identity on each partial (Megatron's g). The
    identity without tensor parallelism."""
    mesh = tp_mesh()
    if mesh is None:
        return list(parts)
    both = _sum(mesh, torch.stack(parts) if len(parts) > 1
                    else parts[0][None])
    return list(both.unbind(0))


def embed_lookup(cfg: ModelConfig, embed: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]`` of this rank's ``embed`` (:func:`vocab_sharded`).
    Split on the vocabulary: the tokens in the rank's range looked up,
    zeros elsewhere, summed over the model group; under grad the sum's
    backward is the identity, and the masked lookup's own backward puts
    each token's gradient into the rank's rows (none where the token lies
    in another rank's range). Split on d_model: the rank's d-slice of
    every token's row in the compute dtype (the cast the caller makes),
    the slices gathered on the last dim (bit for bit the one-process
    lookup); under grad the rank takes its slice of the gradient
    (:class:`_Gather`)."""
    mesh = tp_mesh()
    if mesh is None:
        return embed[tokens]
    if not vocab_sharded(cfg, mesh.shape["model"]):
        return _Gather.apply(embed[tokens].to(getattr(torch,
                                                      cfg.compute_dtype)),
                             mesh)
    rows = embed.shape[0]
    local = tokens - mesh.coords["model"] * rows
    hit = (local >= 0) & (local < rows)
    x = torch.where(hit[..., None], embed[local.clamp(0, rows - 1)],
                    torch.zeros((), dtype=embed.dtype, device=embed.device))
    return _sum(mesh, x)


def head_logits(cfg: ModelConfig, x: torch.Tensor, head: torch.Tensor
                ) -> torch.Tensor:
    """The head's product of the normed hidden state ``x`` [..., d] (every
    rank's) and this rank's ``head`` (``lm_head`` or a tied ``embed.T``):
    ``x @ head`` in ``x``'s dtype on one process and split on the
    vocabulary (``x`` entering through :func:`copy_to_model`), the rank's
    logits [..., V / model]; split on d_model, the rank's f32 partial
    [..., V] of its d-slice of ``x`` (:class:`_Slice`: under grad the
    slices' gradients are gathered) and its rows of the head, formed from
    the operands' values. :func:`gather_logits` makes them whole."""
    mesh = tp_mesh()
    if mesh is None or vocab_sharded(cfg, mesh.shape["model"]):
        return copy_to_model(x) @ head.to(x.dtype)
    return _Slice.apply(x, mesh).float() @ head.float()


def gather_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """The whole logits [..., V] from :func:`head_logits`' (of the
    positions wanted: a prefill passes its last). Split on the vocabulary:
    every rank's slice, concatenated in the model axis's order; under grad
    the backward takes this rank's slice of the incoming gradient and sums
    nothing: every rank of the model group computes the whole loss from
    the same logits, so each already holds their whole gradient, and the
    loss the ranks train is that one loss, not its sum over the ranks.
    Split on d_model: the f32 partials summed over the model group and
    rounded once to the compute dtype (Megatron's g: under grad the
    gradient reaches each rank's partial as it is). ``logits`` itself on
    one process."""
    mesh = tp_mesh()
    if mesh is None:
        return logits
    if vocab_sharded(cfg, mesh.shape["model"]):
        return _Gather.apply(logits, mesh)
    return _sum(mesh, logits.contiguous()).to(getattr(torch,
                                                      cfg.compute_dtype))


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


# leaves every rank holds whole where the specs shard them (the module's
# docstring): the router, and MLA's down-projections
WHOLE = {"router", "wq_a", "wkv_a"}
# Mamba-2's leaves laid out by heads (``mamba2.head_columns``); ``w_out``
# takes its spec's rows
SSM_LEAVES = {"w_in", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias",
              "norm_w"}


def _head_columns(cfg: ModelConfig, mesh, leaf: str
                  ) -> List[Tuple[int, int]]:
    """This rank's column ranges of a Mamba-2 leaf (``mamba2.head_columns``:
    the model code owns the packed layout)."""
    from ..models.mamba2 import head_columns

    return head_columns(cfg.ssm, cfg.d_model, mesh.shape["model"],
                        mesh.coords["model"], leaf)


def _column_boxes(base: tuple, cols: List[Tuple[int, int]]):
    """``base``'s box with its last dim cut to each of ``cols``: one box, or
    a list of them to be joined on the last dim (``layers.take_box``)."""
    boxes = [base[:-1] + (slice(lo, hi),) for lo, hi in cols]
    return boxes[0] if len(boxes) == 1 else boxes


def _param_index(cfg: ModelConfig, path, spec: P, shape, mesh):
    if path[-1] in WHOLE:
        return (slice(None),) * len(shape)
    if path[-1] in ("wk", "wv") and kv_head_pad(cfg,
                                                mesh.shape["model"]) > 1:
        return _kv_head_index(cfg, shape, mesh)
    if "mamba" in path and path[-1] in SSM_LEAVES:
        return _column_boxes((slice(None),) * len(shape),
                             _head_columns(cfg, mesh, path[-1]))
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
    ``kv_head_pad`` > 1, Mamba-2's leaves by heads (``mamba2.head_columns``).
    Slices are views of ``params``' leaves, Mamba-2's joined column boxes
    copies."""
    check_tp(cfg, mesh.shape["model"])
    return _walk(params, param_shard_specs(cfg, mesh),
                 lambda path, leaf, spec: take_box(leaf, _param_index(
                     cfg, path, spec, leaf.shape, mesh)))


def _at(mesh, model: int):
    """``mesh`` seen from model coordinate ``model`` of this rank's line:
    what the index functions read (``shape``, ``coords``)."""
    return SimpleNamespace(shape=mesh.shape,
                           coords={**mesh.coords, "model": model})


def _factor_box(box, factor: str, ndim: int):
    """The box of Adafactor's ``factor`` ("vr" or "vc") of a parameter of
    ``ndim`` dims whose box is ``box``, as ``optimizer.opt_state_specs``
    derives the factors' specs: a row factor drops the last dim's entry, a
    column factor the second last; a vector's vr is its box, its vc (a [1]
    placeholder) whole. A box of column pieces (a list) gives its pieces'
    factor boxes where the factor keeps the columns (a matrix's vc, a
    vector's vr), else the one box they share."""
    if isinstance(box, list):
        boxes = [_factor_box(b, factor, ndim) for b in box]
        return boxes if factor == ("vc" if ndim >= 2 else "vr") \
            else boxes[0]
    if ndim < 2:
        return box if factor == "vr" else (slice(None),)
    return box[:-1] if factor == "vr" else box[:-2] + box[-1:]


def shard_boxes(cfg: ModelConfig, tree: Any, mesh, model: int = None
                ) -> dict:
    """``{leaf name: box}`` of ``tree``, a whole parameter tree or a tree
    that holds whole parameter trees (the optimizer's state, ``{"params",
    "opt"}``; any device, ``meta`` included): each parameter leaf's box is
    this rank's (or model coordinate ``model``'s) box of the whole leaf
    (``shard_params``' index: a tuple of slices); AdamW's moments take
    their parameter's box, Adafactor's factors ``vr``/``vc`` theirs
    (:func:`_factor_box`); every other leaf (the optimizer's step) is
    whole. The ranked checkpoint writes and reads these boxes."""
    from ..models.transformer import abstract_params

    check_tp(cfg, mesh.shape["model"])
    specs = param_shard_specs(cfg, mesh)
    shapes = {name: tuple(leaf.shape)
              for name, leaf in leaf_paths(abstract_params(cfg))}
    at = mesh if model is None else _at(mesh, model)
    out = {}
    for name, leaf in leaf_paths(tree):
        keys = tuple(name.split("/"))
        for i in range(len(keys)):     # a parameter's path ends its name
            spec = specs
            for k in keys[i:]:
                spec = spec.get(k) if isinstance(spec, dict) else None
            if spec is not None and not isinstance(spec, dict):
                shape = shapes["/".join(keys[i:])]
                box = _param_index(cfg, keys[i:], spec, shape, at)
                if i and keys[i - 1] in ("vr", "vc"):
                    box = _factor_box(box, keys[i - 1], len(shape))
                out[name] = box
                break
        else:
            out[name] = (slice(None),) * leaf.dim()
    return out


def box_holders(cfg: ModelConfig, tree: Any, mesh, model: int = None
                ) -> dict:
    """``{leaf name: the model coordinates of the rank's line that hold the
    same box of it}`` (``shard_boxes``), seen from this rank or from model
    coordinate ``model``: every coordinate for a leaf the model axis
    replicates, the ``kv_head_pad`` ranks of one KV head for ``wk``/``wv``
    where it is > 1, this coordinate alone for a leaf it shards."""
    n = mesh.shape["model"]
    boxes = [shard_boxes(cfg, tree, mesh, c) for c in range(n)]
    mine = boxes[mesh.coords["model"] if model is None else model]
    return {name: tuple(c for c in range(n) if boxes[c][name] == box)
            for name, box in mine.items()}


def owned(cfg: ModelConfig, tree: Any, mesh) -> set:
    """The names of the leaves of ``tree`` of which this rank is the first
    of its model line to hold its box (``box_holders``): each leaf has one
    owner a model line, where the ranked step's |g| counts it and, on data
    rank 0, the ranked checkpoint writes it. A Mamba-2 leaf of column
    pieces is every rank's own: its shared B and C columns are written by
    each holder (the same bits, after the holders' gradient sum) and
    counted in |g| by their first holder alone (:func:`owned_columns`)."""
    me = mesh.coords["model"]
    return {name for name, h in box_holders(cfg, tree, mesh).items()
            if h[0] == me}


def column_holders(cfg: ModelConfig, tree: Any, mesh, model: int = None
                   ) -> dict:
    """``{leaf name: [(lo, hi, holders), ...]}`` of the leaves of ``tree``
    whose box is a list of column boxes (Mamba-2's head-aligned leaves,
    ``shard_boxes``), seen from this rank or from model coordinate
    ``model``: each piece's columns [lo, hi) in the rank's joined leaf and
    the model coordinates of its line whose box holds the same columns of
    the whole leaf (``box_holders`` compares whole boxes, which differ
    between ranks there): the B and C columns of a group the axis splits
    the heads of are held by each rank that reads it."""
    n = mesh.shape["model"]
    boxes = [shard_boxes(cfg, tree, mesh, c) for c in range(n)]
    mine = boxes[mesh.coords["model"] if model is None else model]
    out = {}
    for name, box in mine.items():
        if not isinstance(box, list):
            continue
        pieces, at = [], 0
        for piece in box:
            width = piece[-1].stop - piece[-1].start
            pieces.append((at, at + width, tuple(
                c for c in range(n) if piece in boxes[c][name])))
            at += width
        out[name] = pieces
    return out


def owned_columns(cfg: ModelConfig, tree: Any, mesh) -> dict:
    """``{leaf name: [(lo, hi), ...]}``: of each leaf of
    :func:`column_holders`, the columns of this rank's joined leaf of
    which it is the first holder in its model line; the ranked step's |g|
    counts those columns of the leaf only, so that a shared piece counts
    once."""
    me = mesh.coords["model"]
    return {name: [(lo, hi) for lo, hi, h in pieces if h[0] == me]
            for name, pieces in column_holders(cfg, tree, mesh).items()}


def shard_tree(cfg: ModelConfig, tree: Any, mesh) -> Any:
    """This rank's part of ``tree`` (as ``shard_boxes`` reads it): each
    leaf's box, a view (on ``meta``, its shape)."""
    boxes = shard_boxes(cfg, tree, mesh)
    return unflatten(tree, [take_box(leaf, boxes[name])
                            for name, leaf in leaf_paths(tree)])


def init_shard_params(cfg: ModelConfig, mesh, *, seed: int = 0,
                      device="cuda") -> Any:
    """This rank's shard of ``init_params(cfg, seed=seed, device=device)``,
    each leaf drawn as the rank's box of it from the same generator: bit
    for bit the slices :func:`shard_params` takes, with no whole leaf in
    memory beyond one piece of a piecewise draw (``layers.DRAW``)."""
    from ..models.transformer import init_params

    check_tp(cfg, mesh.shape["model"])
    specs = param_shard_specs(cfg, mesh)

    def shard(path, shape):
        spec = specs
        for k in path:
            spec = spec[k]
        return _param_index(cfg, path, spec, shape, mesh)

    return init_params(cfg, seed=seed, device=device, shard=shard)


def cache_shard_specs(cfg: ModelConfig, cache, mesh, global_batch: int
                      ) -> Any:
    """``cache_specs`` of the full decode cache ``cache`` (meta or real)
    sanitized against ``mesh``, the batch over ``batch_axis``."""
    from .sharding import batch_axis

    return sanitize_specs(
        cache_specs(cfg, cache, batch_axis(mesh, global_batch),
                    model_axis=mesh.shape["model"]), cache, mesh)


def _cache_index(cfg: ModelConfig, key: str, spec: P, shape, mesh):
    """This rank's part of a leaf of the cache's segment ``key``: its
    sanitized spec's slices, with MLA's latents whole over the sequence
    (every rank writes the same latents; the spec puts the sequence on
    ``"model"``) and the Mamba-2 conv state [L, B, d_conv-1, conv_dim] its
    x, B and C columns (``mamba2.head_columns``; the spec's contiguous
    block)."""
    if cfg.attention == "mla":
        spec = P(*(None if e == "model" else e for e in spec))
    if key == "ssm" and len(shape) == 4:
        return _column_boxes(
            shard_index(P(*list(spec)[:-1], None), shape, mesh),
            _head_columns(cfg, mesh, "conv"))
    return shard_index(spec, shape, mesh)


def _cache_batch(cache) -> int:
    """The batch of a decode cache: dim 1 of a segment's first leaf ([L,
    B, ...])."""
    return next(iter(cache.layers.values()))[0].shape[1]


def _map_cache(cfg: ModelConfig, cache, specs, mesh, fn) -> Any:
    """``fn(leaf, this rank's index of it)`` over the cache's leaves."""
    return {key: map_tree(lambda leaf, spec, key=key: fn(
        leaf, _cache_index(cfg, key, spec, leaf.shape, mesh)), sub,
        specs.layers[key]) for key, sub in cache.layers.items()}


def shard_cache(cfg: ModelConfig, cache, mesh) -> Any:
    """This rank's shard of the full decode cache ``cache`` (built with
    ``kv_head_pad(cfg, model)``): every leaf sliced by its sanitized
    ``cache_specs`` entry (KV heads and SSM heads on ``"model"``, the batch
    on its axes; MLA's latents whole over the sequence; the conv state by
    ``mamba2.head_columns``), as a copy; ``pos`` kept."""
    check_tp(cfg, mesh.shape["model"])
    specs = cache_shard_specs(cfg, cache, mesh, _cache_batch(cache))
    return type(cache)(pos=cache.pos, layers=_map_cache(
        cfg, cache, specs, mesh,
        lambda leaf, index: take_box(leaf, index).clone()))


def init_shard_cache(cfg: ModelConfig, mesh, global_batch: int,
                     max_seq: int, dtype=torch.bfloat16, *,
                     device="cuda") -> Any:
    """This rank's shard of ``init_cache(cfg, global_batch, max_seq,
    dtype, kv_head_pad=kv_head_pad(cfg, model))``, zeros, made at its own
    size (the whole cache is never built). For encdec the cross cache
    ``enc_out`` is zeros of ``max_seq`` encoder positions, as the serve
    launcher makes it."""
    from ..models.transformer import init_cache

    check_tp(cfg, mesh.shape["model"])
    pad = kv_head_pad(cfg, mesh.shape["model"])
    enc_out = None
    if cfg.family == "encdec":
        enc_out = tuple(torch.empty(
            (cfg.n_layers, global_batch, cfg.n_kv_heads, max_seq,
             cfg.head_dim), dtype=dtype, device="meta") for _ in range(2))
    whole = init_cache(cfg, global_batch, max_seq, dtype, enc_out=enc_out,
                       device="meta", kv_head_pad=pad)
    specs = cache_shard_specs(cfg, whole, mesh, global_batch)
    return type(whole)(pos=0, layers=_map_cache(
        cfg, whole, specs, mesh, lambda leaf, index: torch.zeros(
            take_box(leaf, index).shape, dtype=dtype, device=device)))


__all__ = ["box_holders", "cache_shard_specs", "check_tp", "column_holders",
           "copy_all_to_model", "copy_to_model", "embed_lookup",
           "gather_logits", "group_rms_norm", "head_logits",
           "init_shard_cache", "init_shard_params", "owned", "owned_columns",
           "param_shard_specs", "require", "row_product", "shard_boxes",
           "shard_cache", "shard_index", "shard_params", "shard_tree",
           "sum_partials", "tp_mesh", "vocab_sharded"]
