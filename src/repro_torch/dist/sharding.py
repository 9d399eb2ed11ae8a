"""Tree-path-driven sharding rules: param/cache PartitionSpecs + sanitizing.

The port of ``repro.dist.sharding``. Params are plain trees (see
``models/transformer.py``); sharding attaches here by *leaf name*, never
inside model code:

- matmul weights are tensor-parallel on the "model" axis — column-parallel
  (last dim) by default, row-parallel (dim -2) for the output projections
  ``wo``/``w_out``/``shared_w_out``; whichever of the two dims the model
  axis actually divides wins;
- the embedding shards its vocab dim (falling back to d_model for
  non-divisible vocabularies);
- MoE expert banks are expert-parallel when n_experts divides the model
  axis (deepseek: 256/16) and shard the expert hidden dim otherwise
  (grok: 8 experts, d_ff/16);
- norms, biases, and other small vectors replicate.

Decode caches shard KV heads on "model" when the architecture has enough of
them; an arch with fewer KV heads than the model axis replicates them up to
the axis (``kv_head_pad``) so the cache keeps head sharding, and only when
no even replication exists does the sequence-dim fallback remain.

``sanitize_spec`` reconciles an intended spec with a concrete shape and
mesh: axis names the mesh lacks are dropped, and a dim that cannot divide
the assigned axis product drops names rightmost-first (so a ("pod", "data")
batch entry degrades to "pod" before replicating).

The port keeps its own ``PartitionSpec`` (``P``): a sequence of entries,
each None, an axis name or a tuple of names, whose ``tuple()`` equals that
of jax's spec with the same entries. On one device a spec is layout, not
value: ``named_shardings`` turns each sanitized spec into the DTensor
placements a multi-process run would give the leaf, one per mesh axis.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Sequence, Tuple, Union

from ..configs.base import ModelConfig

Axes = Union[None, str, Tuple[str, ...]]


class PartitionSpec:
    """One entry per tensor dim: None (whole), an axis name, or a tuple of
    names (sharded over their product). Shorter than the tensor's rank
    means the trailing dims are whole."""

    __slots__ = ("_entries",)

    def __init__(self, *entries: Axes):
        self._entries = tuple(tuple(e) if isinstance(e, list) else e
                              for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        return (isinstance(other, PartitionSpec)
                and self._entries == other._entries)

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"P{self._entries!r}" if len(self) != 1 else \
            f"P({self._entries[0]!r})"


P = PartitionSpec

# leaf names that always replicate (norm scales, small biases, SSM scalars)
_REPLICATED = {
    "final_norm", "enc_norm", "ln", "ln1", "ln2", "ln_cross",
    "q_ln", "kv_ln", "q_norm", "k_norm", "norm_w",
    "router_bias", "conv_b", "a_log", "d_skip", "dt_bias",
}

# output projections: row-parallel (prefer sharding dim -2)
_ROW_PARALLEL = {"wo", "w_out", "shared_w_out"}


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple)) and not isinstance(
        tree, PartitionSpec)


def map_tree(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``): dicts, NamedTuples, lists and tuples are nodes, a
    ``PartitionSpec`` and anything else a leaf, None stays None (an empty
    subtree, as in JAX)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_node(tree):
        out = [map_tree(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def spec_leaves(tree) -> list:
    """The specs of a spec tree in flattening order (dict keys sorted, as
    JAX flattens a dict); None subtrees hold none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    if _is_node(tree):
        return [s for v in tree for s in spec_leaves(v)]
    return [tree]


def _matmul_spec(shape: Sequence[int], model_axis: int,
                 *, prefer_last: bool = True) -> P:
    """Shard one of the two trailing matmul dims on "model" — the preferred
    dim if it divides, the other as fallback, the preferred regardless if
    neither does (sanitize_specs drops it against a concrete mesh later)."""
    nd = len(shape)
    dims = (-1, -2) if prefer_last else (-2, -1)
    pick = dims[0]
    for d in dims:
        if shape[d] % model_axis == 0:
            pick = d
            break
    entries = [None] * nd
    entries[pick] = "model"
    return P(*entries)


def param_specs(cfg: ModelConfig, *, model_axis: int = 16) -> Any:
    """PartitionSpec tree matching ``transformer.abstract_params(cfg)``
    (taken on the meta device: nothing is allocated)."""
    from ..models import transformer as tfm

    def rule(keys, leaf):
        name = keys[-1]
        nd = leaf.dim()
        shape = tuple(leaf.shape)
        if name in _REPLICATED or nd <= 1:
            return P()
        if name == "embed":
            vocab, _ = shape
            return P("model", None) if vocab % model_axis == 0 \
                else P(None, "model")
        if "moe" in keys[:-1] and nd == 4 and name in ("w_in", "w_out",
                                                       "w_gate"):
            # stacked expert banks [L, E, d, f] / [L, E, f, d]
            if shape[1] % model_axis == 0:            # expert parallelism
                return P(None, "model", None, None)
            return _matmul_spec(shape, model_axis,
                                prefer_last=name != "w_out")
        if name == "router":
            # [L, d, E]: shard experts when possible, else the input dim
            return _matmul_spec(shape, model_axis)
        return _matmul_spec(shape, model_axis,
                            prefer_last=name not in _ROW_PARALLEL)

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + (k,)) for k, v in tree.items()}
        return rule(keys, tree)

    return walk(tfm.abstract_params(cfg), ())


def kv_head_pad(cfg: ModelConfig, model_axis: int) -> int:
    """Replication factor lifting the KV-head dim to the model axis.

    GQA repeats KV heads across the query-head group anyway, so replicating
    each head ``r`` times (cache laid out as ``repeat_interleave(kv, r,
    heads)``) changes no attention output while making the head dim
    divisible by the model axis, so head sharding survives. Returns 1 when
    the cache already shards (Hkv % axis == 0) or no even replication
    exists (axis % Hkv != 0, or the padded group would not divide the
    query heads). The replicated cache is ``r``x larger."""
    hkv = max(cfg.n_kv_heads, 1)
    if hkv % model_axis == 0 or model_axis % hkv != 0:
        return 1
    if cfg.n_heads % model_axis != 0:
        return 1
    return model_axis // hkv


def cache_specs(cfg: ModelConfig, cache: Any, batch_axes: Axes, *,
                model_axis: int = 16) -> Any:
    """Spec tree matching a ``transformer.DecodeCache`` (of meta tensors or
    real ones): KV caches [L, B, Hkv, S, hd] shard heads on "model" when
    Hkv divides the model axis and fall back to sharding the sequence dim
    otherwise; MLA latent caches [L, B, S, r] and SSM states shard their
    large inner dims."""
    bn = batch_axes
    mla = cfg.attention == "mla"

    def attn_rule(leaf):
        nd = leaf.dim()
        if nd == 5:                        # [L, B, Hkv, S, hd]
            if leaf.shape[2] % model_axis == 0:
                return P(None, bn, "model", None, None)
            return P(None, bn, None, "model", None)  # seq fallback
        if nd == 4 and mla:                # MLA latents [L, B, S, r]
            return P(None, bn, "model", None)
        return P(*([None] * max(nd - 1, 0)), bn) if nd else P()

    def ssm_rule(leaf):
        nd = leaf.dim()
        if nd == 5:                        # [L, B, nh, N, hd]: shard heads
            return P(None, bn, "model", None, None)
        if nd == 4:                        # conv [L, B, d_conv-1, conv_dim]
            return P(None, bn, None, "model")
        return P()

    layers = {key: map_tree(ssm_rule if key == "ssm" else attn_rule, sub)
              for key, sub in cache.layers.items()}
    return type(cache)(pos=P(), layers=layers)


def sanitize_spec(spec: P, shape: Sequence[int],
                  axis_sizes: Dict[str, int]) -> P:
    """Reconcile ``spec`` with a concrete ``shape``: pad to the shape's
    rank, drop axis names missing from ``axis_sizes``, and for each dim
    drop names rightmost-first until the dim divides the assigned product.
    Single-name tuples collapse to the bare name."""
    entries = list(spec)[: len(shape)]
    entries += [None] * (len(shape) - len(entries))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        names = [n for n in (entry if isinstance(entry, tuple) else (entry,))
                 if n in axis_sizes]
        while names and dim % math.prod(axis_sizes[n] for n in names) != 0:
            names.pop()
        if not names:
            out.append(None)
        elif len(names) == 1:
            out.append(names[0])
        else:
            out.append(tuple(names))
    return P(*out)


def _shape(x) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's, () for a host scalar (the decode
    cache's ``pos``)."""
    return tuple(getattr(x, "shape", ()))


def sanitize_specs(specs: Any, abstract: Any, mesh) -> Any:
    """Tree-wide :func:`sanitize_spec` of a spec tree against the matching
    tree of tensors (meta or real) and a mesh (anything with ``shape``,
    axis name -> size)."""
    sizes = dict(mesh.shape)
    return map_tree(lambda s, x: sanitize_spec(s, _shape(x), sizes), specs,
                    abstract)


def placements(mesh, spec: P) -> tuple:
    """The DTensor placements of one sanitized spec on ``mesh``, one per
    mesh axis: ``Shard(d)`` where the spec names that axis at dim d,
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                dim_of[name] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.axis_names)


def named_shardings(mesh, specs: Any) -> Any:
    """Spec tree -> tree of placements on ``mesh`` (what a launcher would
    hand ``distribute_tensor``); on one device they describe the layout
    and move nothing."""
    return map_tree(lambda s: placements(mesh, s), specs)


def shard_bytes(leaf, spec: P, mesh) -> int:
    """Bytes of one device's shard of ``leaf`` under its sanitized
    ``spec``: the leaf's bytes over the product of the axis sizes the spec
    names."""
    sizes = dict(mesh.shape)
    n = math.prod(_shape(leaf)) * leaf.element_size()
    split = math.prod(sizes[name] for entry in spec if entry is not None
                      for name in (entry if isinstance(entry, tuple)
                                   else (entry,)))
    return n // split


def batch_axis(mesh, global_batch: int) -> Axes:
    """The mesh axes the global batch shards over: all data-parallel axes
    present in the mesh (("pod", "data") order), degraded rightmost-first
    until the batch divides — None when it cannot shard at all."""
    axes = [a for a in ("pod", "data") if a in mesh.shape]
    while axes and global_batch % math.prod(mesh.shape[a] for a in axes) != 0:
        axes.pop()
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


__all__ = ["P", "PartitionSpec", "batch_axis", "cache_specs", "kv_head_pad",
           "map_tree", "named_shardings", "param_specs", "placements",
           "sanitize_spec", "sanitize_specs", "shard_bytes", "spec_leaves"]
