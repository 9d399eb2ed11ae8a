"""Train step: loss -> grads -> optimizer update (+ metrics).

The port of ``repro.train.train_step``. Gradients come from autograd over
``lm_loss`` (``models/transformer.py``); the update writes the parameters
and optimizer state in place (``train/optimizer.py``).

Gradient accumulation (``REPRO_MICROBATCH=k`` or the ``microbatches``
argument) splits the global batch into k sequential microbatches: the
activations shrink ~k x for one f32 params-sized accumulator; compute is
unchanged. The losses are averaged and the f32 sum of the gradients
divided by k, as the reference's scan does.

On a ("data", "model") mesh of ranks (``make_train_step(cfg, mesh=)``,
``launch.mesh.make_dev_mesh(n, group=)``) the model axis is tensor
parallel (``dist/tensor_parallel.py``) and the data axis data parallel:
each rank holds, differentiates and updates only its shard of the
parameters and of the optimizer state (``tensor_parallel.shard_boxes``),
takes its rows of the global batch, and after the backward sums every
gradient over its data group and each leaf that several ranks of its
model line hold and the sharded region reads over those holders (and
each column piece of a Mamba-2 leaf that several of them hold); |g|
counts each leaf and piece once. Every family (dense, vlm, moe with MLA,
ssm, hybrid, encdec), with AdamW, or Adafactor
(``optimizer.ranked_adafactor_update``: its statistics that span the
shards summed over the model group, a column piece that several ranks
hold counted once).

``make_pipeline_train_step`` trains the dense family stage-parallel on a
mesh's ``"pipe"`` axis (``dist/pipeline.py``): the same loss, its layer
stack run as stages over microbatches. On a mesh of ranks
(``launch.mesh.Mesh(..., group=)``) the pipe and data axes are rank
processes (one per mesh coordinate): each rank holds, differentiates and
updates only its own leaves (``pipeline_shard``), takes its own rows of
the global batch, and the ranks meet in the pipeline's hand-offs and in
f32 all-reduces (the data group's gradients and mask count, the tied
embedding's two stages, the gradient norm, Adafactor's statistics that
average over the layers the stages split) through the mesh's
transport.
"""

from __future__ import annotations

import functools
import os

import torch

from ..configs.base import ModelConfig
from ..dist.ctx import suspend_annotations, use_mesh
from ..dist.pipeline import (pipeline_apply, refuse_model_axis,
                             split_microbatches)
from ..dist.tensor_parallel import (box_holders, check_tp, column_holders,
                                    owned, owned_columns, shard_boxes)
from ..models.transformer import (TP_AHEAD, TP_REGIONS, _head,
                                  _scan_segment,
                                  abstract_params, dtype_of, init_params,
                                  layer_kinds, lm_loss, next_token_loss,
                                  unstack)
from .optimizer import Shard, make_optimizer, ranked_adafactor_update
from .tree import leaf_paths, leaves, tree_map, unflatten


def loss_and_grads(cfg: ModelConfig, params, batch, count=None):
    """(loss, grads): ``lm_loss`` (over ``count`` labels where given) and
    its gradient with respect to every parameter, a tree like ``params``
    (the parameters' dtypes). The parameters themselves are left as they
    are (no ``.grad``)."""
    return value_and_grads(functools.partial(lm_loss, cfg, count=count),
                           params, batch)


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
                    microbatches: int | None = None, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``; ``batch`` is a dict of tensors on the
    parameters' device, split along its first axis into the microbatches.
    The parameters and optimizer state are updated in place.

    On a ("data", "model") mesh of ranks (``mesh.group`` set), the ranked
    step: ``params`` and ``opt_state`` are this rank's shards, ``batch``
    the global batch, of which each microbatch's rows split over the data
    axis (``ranked_grads``); every rank returns the global loss and |g|.
    A config the model axis cannot train raises ``ValueError``
    (``check_ranked_training``)."""
    mb = microbatches or int(os.environ.get("REPRO_MICROBATCH", "1"))
    if mesh is not None and mesh.group is not None:
        return ranked_train_step(cfg, mesh, lr=lr, microbatches=mb)

    def grads_of(params, batch):
        if mb <= 1:
            return loss_and_grads(cfg, params, batch)
        return _accumulate(cfg, params, _split(batch, mb), lambda b: b)

    return _train_step(cfg, grads_of, lr)


def _split(batch, mb: int) -> list:
    """The ``mb`` microbatches of ``batch``: consecutive runs of its rows."""
    split = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
             for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(mb)]


def _accumulate(cfg: ModelConfig, params, parts: list, rows,
                count=lambda part: None):
    """(the mean loss, the f32 mean gradient) over the microbatches
    ``parts``, each taken at ``rows(part)`` over ``count(part)`` labels."""
    acc, losses = None, []
    for part in parts:
        loss, g = loss_and_grads(cfg, params, rows(part), count(part))
        losses.append(loss)
        g = [t.float() for t in leaves(g)]
        acc = g if acc is None else [a + b for a, b in zip(acc, g)]
    return (torch.stack(losses).mean(),
            unflatten(params, [t / len(parts) for t in acc]))


def check_ranked_training(cfg: ModelConfig, model: int) -> None:
    """Raise ``ValueError`` unless a model axis of ``model`` ranks trains
    ``cfg``: every family, with AdamW or Adafactor, on an axis
    ``check_tp`` passes. Without a model axis there is nothing to
    check."""
    if model > 1:
        check_tp(cfg, model)


def _region(name: str) -> bool:
    """Whether parameter ``name`` lies in the sharded region
    (``TP_REGIONS``: read between ``copy_to_model`` and a ``row_product``
    or the experts' sum; not ``TP_AHEAD``, read before the f), matched on
    the subtrees between the segment and the leaf."""
    keys = name.split("/")
    return bool(TP_REGIONS & set(keys[1:-1])) and keys[-1] not in TP_AHEAD


def replica_leaves(cfg: ModelConfig, mesh, model: int = None) -> dict:
    """``{parameter name: holders}`` of the parameters of the sharded
    region (``_region``) that several ranks of a model line hold
    (``box_holders``, seen from this rank or model coordinate ``model``):
    a KV head that ``kv_head_pad`` replicates, qwen3's ``q_norm`` and
    ``k_norm``, the MoE's router and ``router_bias``. A holder's gradient
    of such a leaf is its own heads' or slots' part."""
    return {name: h for name, h in box_holders(
        cfg, abstract_params(cfg), mesh, model).items()
        if len(h) > 1 and _region(name)}


def replica_columns(cfg: ModelConfig, mesh, model: int = None) -> dict:
    """``{parameter name: [(lo, hi, holders), ...]}``: the column pieces
    of the sharded region's Mamba-2 leaves that several ranks of a model
    line hold (``column_holders``, seen from this rank or model
    coordinate ``model``; [lo, hi) in the rank's joined leaf): the B and
    C columns of ``w_in``, ``conv_w`` and ``conv_b`` of a group whose
    heads the axis splits. A holder's gradient of such a piece is its own
    heads' part."""
    out = {}
    for name, pieces in column_holders(cfg, abstract_params(cfg), mesh,
                                       model).items():
        shared = [p for p in pieces if len(p[2]) > 1]
        if shared and _region(name):
            out[name] = shared
    return out


def _replica_groups(cfg: ModelConfig, mesh) -> dict:
    """``{parameter name or (name, lo, hi): process group}``: each of
    ``replica_leaves`` and each column piece of ``replica_columns`` with
    the group of its holders. One ``new_group`` per holder set and data
    coordinate, made on every rank in the same order."""
    every = []
    for c in range(mesh.shape["model"]):
        held = replica_leaves(cfg, mesh, c)
        held.update({(name, lo, hi): h for name, pieces
                     in replica_columns(cfg, mesh, c).items()
                     for lo, hi, h in pieces})
        every.append(held)
    sets = sorted({h for held in every for h in held.values()})
    mine = every[mesh.coords["model"]]
    groups = {}
    for d in range(mesh.shape["data"]):
        for h in sets:
            pg = torch.distributed.new_group(
                [mesh.rank_of(data=d, model=c) for c in h])
            if d == mesh.coords["data"] and mesh.coords["model"] in h:
                groups[h] = pg
    return {key: groups[h] for key, h in mine.items()}


def ranked_grads(cfg: ModelConfig, mesh, *, microbatches: int = 1):
    """``grads_of(params, batch) -> (loss, grads)`` on a ("data", "model")
    mesh of ranks: ``params`` is this rank's shard, ``batch`` the global
    batch. Each of the ``microbatches`` consecutive runs of its rows (the
    one-process step's microbatches) splits over the data axis
    (``_data_rows``); the rank's loss on its rows divides by the
    microbatch's global label count (``lm_loss``'s ``count``, read off the
    global batch every rank holds), and the mean over microbatches of the
    losses, summed over the data group, is the global loss. After the
    backward each gradient (f32 when accumulated) is summed over the data
    group (kind ``"grad"``), then each leaf of the sharded region that
    several ranks of the model line hold over its holders (kind
    ``"replica"``: the KV heads ``kv_head_pad`` replicates, qwen3's
    ``q_norm``/``k_norm``), and each Mamba-2 column piece that several
    hold (the B and C columns of a shared group), all in f32, each in its
    dtype after: every holder then has the same bits."""
    net = mesh.transport
    replicas = _replica_groups(cfg, mesh)
    pieces = {}
    for key, pg in replicas.items():
        if isinstance(key, tuple):
            pieces.setdefault(key[0], []).append((key[1], key[2], pg))

    def columns(g, name):
        for lo, hi, pg in pieces.get(name, ()):
            g[..., lo:hi] = reduce(g[..., lo:hi].contiguous(), pg,
                                   "replica")
        return g

    def reduce(g, pg, kind):
        if g.dtype == torch.float32:
            return net.all_reduce(g, pg, kind)
        return net.all_reduce(g.float(), pg, kind).to(g.dtype)

    def kept(part):
        return (part["labels"] >= 0).float().sum()

    def grads_of(params, batch):
        with use_mesh(mesh):
            loss, grads = _accumulate(
                cfg, params, _split(batch, microbatches),
                lambda part: _data_rows(mesh, part), kept) \
                if microbatches > 1 else \
                loss_and_grads(cfg, params, _data_rows(mesh, batch),
                               kept(batch))
        if mesh.shape["data"] > 1:       # (a bf16 leaf's f32 copy else)
            grads = tree_map(lambda g: reduce(g, mesh.groups["data"],
                                              "grad"), grads)
        grads = unflatten(grads, [
            reduce(g, replicas[name], "replica") if name in replicas
            else columns(g, name) for name, g in leaf_paths(grads)])
        return net.all_reduce(loss.float(), mesh.groups["data"]), grads

    return grads_of


def adafactor_shards(cfg: ModelConfig, mesh) -> dict:
    """``{parameter name: optimizer.Shard}`` of this rank on a model axis:
    the whole leaf's shape, the dims its box (``shard_boxes``; each of a
    Mamba-2 leaf's column pieces) cuts, whether it is the owner of its box
    (``owned``), which alone counts it in the ranked Adafactor's sums, and
    of a leaf of column pieces the columns it counts (``owned_columns``:
    a B or C column that several ranks hold counts on its first
    holder)."""
    like = abstract_params(cfg)
    boxes, once = shard_boxes(cfg, like, mesh), owned(cfg, like, mesh)
    cols = owned_columns(cfg, like, mesh)
    out = {}
    for name, leaf in leaf_paths(like):
        box, shape = boxes[name], tuple(leaf.shape)
        out[name] = Shard(shape, frozenset(
            d for piece in (box if isinstance(box, list) else [box])
            for d, cut in enumerate(piece)
            if cut.indices(shape[d])[:2] != (0, shape[d])), name in once,
            cols.get(name))
    return out


def pipeline_adafactor_shards(cfg: ModelConfig, mesh,
                              axis: str = "pipe") -> dict:
    """``{parameter name: optimizer.Shard}`` of this stage rank: each of
    its leaves of the layer stack split along the layers (dim 0) over the
    pipe axis, counted by every stage (each holds its own layers); every
    other leaf whole."""
    like = dict(leaf_paths(abstract_params(cfg)))
    split = frozenset({0}) if mesh.shape[axis] > 1 else frozenset()
    return {name: Shard(tuple(like[name].shape),
                        split if "dense" in name.split("/") else frozenset(),
                        True)
            for name, _ in leaf_paths(pipeline_shard(
                cfg, abstract_params(cfg), mesh, axis))}


def _squares(g: torch.Tensor, piece: int = 1 << 26) -> torch.Tensor:
    """sum(g²) in f32, over pieces of ``piece`` elements: a bf16 leaf's
    f32 square is not formed whole (an expert bank of grok-1-314b's is
    3.2 GB a rank of 4)."""
    return sum(torch.sum(torch.square(c.float()))
               for c in g.reshape(-1).split(piece))


def ranked_train_step(cfg: ModelConfig, mesh, *, lr: float = 3e-4,
                      microbatches: int = 1):
    """``make_train_step``'s step on a ("data", "model") mesh of ranks:
    ``ranked_grads``' loss and gradients, |g| global (each leaf's sum of
    squares counted on the first rank of its model line that holds its
    box, a Mamba-2 leaf's columns on the first that holds each piece,
    ``owned_columns``; then summed over the model group), and the config's
    optimizer on
    each rank's own shards: AdamW alone, Adafactor with its statistics
    that span the shards summed over the model group (transport kind
    ``"adafactor"``). Raises ``ValueError`` for what the model axis does
    not train (``check_ranked_training``) or another mesh than ("data",
    "model")."""
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError(f"the ranked step trains on a ('data', 'model') "
                         f"mesh, got {mesh.shape}")
    check_ranked_training(cfg, mesh.shape["model"])
    like = abstract_params(cfg)
    once, cols = owned(cfg, like, mesh), owned_columns(cfg, like, mesh)
    update = None
    if cfg.optimizer == "adafactor":
        update = functools.partial(
            ranked_adafactor_update, shards=adafactor_shards(cfg, mesh),
            reduce=lambda t: mesh.transport.all_reduce(
                t, mesh.groups["model"], "adafactor"))

    def counted(name, g):
        if name not in cols:
            return [g] if name in once else []
        return [g[..., lo:hi] for lo, hi in cols[name]]

    def norm(grads):
        sq = sum((_squares(part) for name, g in leaf_paths(grads)
                  for part in counted(name, g)),
                 torch.zeros((), device=mesh.device))
        return torch.sqrt(mesh.transport.all_reduce(sq,
                                                    mesh.groups["model"]))

    return _train_step(cfg, ranked_grads(cfg, mesh,
                                         microbatches=microbatches), lr, norm,
                       update)


def _train_step(cfg: ModelConfig, grads_of, lr: float, norm=grad_norm,
                update=None):
    """``train_step(params, opt_state, batch)``: ``grads_of(params,
    batch)``'s loss and gradients, their ``norm``, and ``update`` (the
    config's optimizer's by default) in place."""
    update = update or make_optimizer(cfg.optimizer)[1]

    def train_step(params, opt_state, batch):
        with torch.profiler.record_function("train_step.grads"):
            loss, grads = grads_of(params, batch)
            gnorm = norm(grads)
        with torch.profiler.record_function("train_step.update"):
            params, opt_state = update(params, grads, opt_state, lr=lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def _pipeline_split(cfg: ModelConfig, mesh, axis: str) -> int:
    """Layers per stage; raises ``ValueError`` for a non-dense family or
    layers that do not split into equal stages."""
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
    return n_layers // n_stages


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
    not split into equal stages raise ``ValueError``.

    On a mesh of ranks (``mesh.group`` set) ``loss`` runs this rank's
    part: ``params`` is its own tree (``pipeline_shard``), and it takes
    its own contiguous rows of ``batch`` along the ``"data"`` axis, split
    into the ``n_micro`` microbatches. Stage 0 embeds and casts; the last
    stage applies the final norm and the head and returns its rows' masked
    log-likelihood sum over the *global* mask count (all-reduced over the
    data group first); every other stage returns ``pipeline_apply``'s 0-d
    anchor. The sum of the last stage's returns over the data group is the
    loss, and the sum of every rank's gradients over its data group the
    gradient (``pipeline_grads`` does both)."""
    per = _pipeline_split(cfg, mesh, axis)
    n_stages = mesh.shape[axis]
    if mesh.group is not None:
        refuse_model_axis(mesh)
        return _ranked_loss(cfg, mesh, n_micro, axis)

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


def _data_rows(mesh, batch):
    """This rank's contiguous rows of every tensor of ``batch`` along the
    mesh's ``"data"`` axis."""
    n, d = mesh.shape.get("data", 1), mesh.coords.get("data", 0)
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"batch {rows} does not split over data axis {n}")
    lo, hi = d * rows // n, (d + 1) * rows // n
    return {k: v[lo:hi] for k, v in batch.items()}


def _ranked_loss(cfg: ModelConfig, mesh, n_micro: int, axis: str):
    """``make_pipeline_loss``'s loss on this rank of a mesh of ranks."""
    s, last = mesh.coords[axis], mesh.shape[axis] - 1
    compute = dtype_of(cfg.compute_dtype)

    def stage_fn(stage_layers, x):
        return _scan_segment(cfg, "dense", stage_layers, x)[0]

    def loss_fn(params, batch):
        batch = _data_rows(mesh, batch)
        labels = batch["labels"]
        with suspend_annotations():   # the pipeline owns the layout
            if s == 0:
                tokens = batch.get("tokens")
                x = (params["embed"][tokens] if batch.get("embeds") is None
                     else batch["embeds"]).to(compute)
            else:
                x = torch.empty((*labels.shape, cfg.d_model), dtype=compute,
                                device="meta")
            ys = pipeline_apply(stage_fn, unstack(params["dense"]),
                                split_microbatches(x, n_micro), mesh=mesh,
                                axis=axis)
            if s != last:
                return ys
            logits = _head(cfg, params, ys.reshape(x.shape))
        count = mesh.transport.all_reduce((labels >= 0).float().sum(),
                                          mesh.groups["data"])
        return next_token_loss(logits, labels, count)

    return loss_fn


def _stage_keys(cfg: ModelConfig, stage: int, n_stages: int) -> set:
    """The parameters besides the layer stack that ``stage`` holds: the
    embedding on the first stage (and on the last when the head is tied to
    it), the final norm and the head on the last."""
    keys = {"embed"} if stage == 0 else set()
    if stage == n_stages - 1:
        keys |= {"final_norm", "embed" if cfg.tie_embeddings else "lm_head"}
    return keys


def pipeline_shard(cfg: ModelConfig, tree, mesh, axis: str = "pipe"):
    """This rank's part of ``tree``, a parameter tree or a tree that holds
    parameter-shaped dicts (the optimizer's state, ``{"params", "opt"}``):
    in each of those dicts, its stage's consecutive run of the stacked
    ``"dense"`` layers (cloned) and the keys ``_stage_keys`` gives it;
    every other leaf (the optimizer's step; Adafactor's column factor of
    a stacked leaf of 2 dims or fewer, which spans the layers:
    ``_stacked``) whole."""
    s, n_stages = mesh.coords[axis], mesh.shape[axis]
    per = _pipeline_split(cfg, mesh, axis)
    keys = _stage_keys(cfg, s, n_stages)

    def take(node, factor=None):
        if isinstance(node, dict) and "dense" in node:
            return {k: (tree_map(lambda t: t[s * per:(s + 1) * per].clone()
                                 if _stacked(factor, t) else t.clone(), v)
                        if k == "dense" else v)
                    for k, v in node.items() if k == "dense" or k in keys}
        if isinstance(node, dict):
            return {k: take(v, factor) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(take(v, k) for k, v in
                                zip(node._fields, node)))
        return node

    return take(tree)


def _stacked(factor, t) -> bool:
    """Whether a leaf of the layer stack runs along the layers on dim 0:
    all do but Adafactor's column factor (``factor`` "vc") of a parameter
    of 2 dims or fewer, [d] or a [1] placeholder."""
    return not (factor == "vc" and t.dim() < 2)


def pipeline_rows(cfg: ModelConfig, tree, mesh, axis: str = "pipe"
                  ) -> dict:
    """``{leaf name: row}`` of a ``pipeline_shard`` tree: where each leaf
    starts along dim 0 of the whole one (the stage's first layer for the
    stacked ``"dense"`` leaves, 0 for whole leaves), as the ranked
    checkpoint writes and reads them."""
    first = mesh.coords[axis] * _pipeline_split(cfg, mesh, axis)
    return {name: first if "dense" in keys and _stacked(
        "vc" if "vc" in keys else None, t) else 0
        for name, t in leaf_paths(tree) for keys in [name.split("/")]}


def pipeline_grads(cfg: ModelConfig, mesh, *, n_micro: int,
                   axis: str = "pipe"):
    """``grads_of(params, batch) -> (loss, grads)`` on a mesh of ranks
    (``make_pipeline_loss``'s ranked loss): ``params`` is this rank's own
    tree (``pipeline_shard``), ``batch`` the global batch. After the
    backward each gradient is summed over the rank's data group, and a
    tied embedding's two contributions between the first and the last
    stage, all in f32 (in the gradient's dtype after); the loss goes from
    the last stage's data group to every rank of its pipe line."""
    loss_fn = make_pipeline_loss(cfg, mesh, n_micro=n_micro, axis=axis)
    s, last = mesh.coords[axis], mesh.shape[axis] - 1
    net = mesh.transport
    tied = None
    if cfg.tie_embeddings and last:
        # one group per data line, on every rank in the same order
        for d in range(mesh.shape.get("data", 1)):
            pg = torch.distributed.new_group(
                [mesh.rank_of(**{axis: 0, "data": d}),
                 mesh.rank_of(**{axis: last, "data": d})])
            if d == mesh.coords.get("data", 0):
                tied = pg

    def reduce(g, pg):
        if g.dtype == torch.float32:
            return net.all_reduce(g, pg)
        return net.all_reduce(g.float(), pg).to(g.dtype)

    def grads_of(params, batch):
        loss, grads = value_and_grads(loss_fn, params, batch)
        grads = tree_map(lambda g: reduce(g, mesh.groups["data"]), grads)
        if tied is not None:
            grads["embed"] = reduce(grads["embed"], tied)
        loss = loss.float()
        if s == last:
            net.all_reduce(loss, mesh.groups["data"])
        net.broadcast(loss, mesh.line[axis][last], mesh.groups[axis])
        return loss, grads

    return grads_of


def make_pipeline_train_step(cfg: ModelConfig, mesh, *, lr: float = 3e-4,
                             n_micro: int, axis: str = "pipe"):
    """Pipeline-parallel train step over a ("pipe", "data", "model") mesh:
    ``train_step(params, opt_state, batch)`` as ``make_train_step``'s, with
    the loss of ``make_pipeline_loss``. Gradients flow back through the
    pipeline by autograd; the same bodies in the same microbatch order as
    the sequential ``lm_loss``, so the loss is the sequential one up to the
    rounding of per-microbatch products.

    On a mesh of ranks (``mesh.group`` set): ``params`` and
    ``opt_state`` are this rank's own (``pipeline_shard``), ``batch`` the
    global batch; the loss and gradients are ``pipeline_grads``', and |g|
    is global (each rank's sum of squares all-reduced over its pipe group,
    a tied embedding counted once). Every rank updates its own leaves:
    AdamW alone, Adafactor with the statistics of a stacked leaf that
    average over the layers the stages split (the column factor and the
    row mean of a [L, d] leaf, the clip of a leaf the layer loop does not
    slice) summed over the pipe group (``ranked_adafactor_update`` with
    ``pipeline_adafactor_shards``, transport kind ``"adafactor"``); the
    data replicas compute the same statistics."""
    if mesh.group is None:
        return _train_step(cfg, functools.partial(
            value_and_grads, make_pipeline_loss(cfg, mesh, n_micro=n_micro,
                                                axis=axis)), lr)
    refuse_model_axis(mesh)
    update = None
    if cfg.optimizer == "adafactor":
        update = functools.partial(
            ranked_adafactor_update,
            shards=pipeline_adafactor_shards(cfg, mesh, axis),
            reduce=lambda t: mesh.transport.all_reduce(
                t, mesh.groups[axis], "adafactor"))
    s, last = mesh.coords[axis], mesh.shape[axis] - 1
    twice = cfg.tie_embeddings and last and s == last   # stage 0 counts it

    def norm(grads):
        sq = sum((torch.sum(torch.square(g.float()))
                  for name, g in leaf_paths(grads)
                  if not (twice and name == "embed")),
                 torch.zeros((), device=mesh.device))
        return torch.sqrt(mesh.transport.all_reduce(sq, mesh.groups[axis]))

    return _train_step(cfg, pipeline_grads(cfg, mesh, n_micro=n_micro,
                                           axis=axis), lr, norm, update)


def init_train_state(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """(params, optimizer state) of ``cfg``: ``init_params`` from ``seed``
    on ``device`` and the config's optimizer's initial state."""
    init_opt, _ = make_optimizer(cfg.optimizer)
    params = init_params(cfg, seed=seed, device=device)
    return params, init_opt(params)


__all__ = ["adafactor_shards", "check_ranked_training", "grad_norm",
           "init_train_state",
           "loss_and_grads", "make_pipeline_loss",
           "make_pipeline_train_step", "make_train_step",
           "pipeline_adafactor_shards", "pipeline_grads",
           "pipeline_rows", "pipeline_shard", "ranked_grads",
           "ranked_train_step", "replica_columns", "replica_leaves",
           "value_and_grads"]
