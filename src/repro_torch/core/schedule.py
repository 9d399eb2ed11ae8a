"""Lowering a block-PTG to per-wavefront index tables, and running them on
one device — the port of the JAX package's ``repro.core.schedule``.

The host runtime executes the PTG asynchronously; the block executor runs
the *schedule produced by parallel discovery* (``discovery.discover``) as
data: per-(wavefront, task-type) index tables and a per-wavefront exchange
plan. One generic executor then runs *any* block PTG (GEMM, Cholesky, ...):

    wavefront w:  for each task type t:
                      gather operand blocks by table -> one batched body
                      call over the wavefront's tasks of type t -> scatter
                  exchange: the blocks crossing shards at w
                      (all messages of a (src, dst) pair ride one buffer —
                      the paper's *large AM* batching)

Everything up to the executors is host-side numpy, and equal array for
array to the JAX package's lowering (``tests/test_torch_schedule.py``):
the tables, the dense (all_to_all) and sparse (ppermute-round) exchange
plans, the segment plans and their stacked tables, ``comm_stats`` and
``plan_lowering``. The lowering policies keep the JAX package's names, so
a plan reads the same in both packages.

The executors differ from the JAX package's in one respect: there is one
device, so every shard's store lies stacked on it as
``[n_shards, n_slots, b0, b1]`` (the JAX package's layout, sharded there
over a mesh axis) and each exchange becomes an on-device index copy:

- dense: ``local[d, recv[d, s, m]] = local[s, send[s, d, m]]``, the
  all_to_all;
- sparse: for each round, ``local[dst, recv[dst]] = local[src, send[src]]``
  over the round's active (src, dst) pairs, the ppermute.

Every buffer of a wavefront is gathered before any of them lands, and the
scan lowerings walk the same stacked, padded tables as the JAX package's
``lax.scan`` bodies, so their padding is exercised.

Contract (checked at build time):
- every task writes exactly one block, owned by the task's shard
  ("owner computes" — the paper's 2D GEMM mapping rule);
- a block that crosses shards has exactly one writer (single assignment for
  communicated data; local blocks may be read-modify-written freely);
- operand reads always see the value produced at a strictly earlier
  wavefront (guaranteed by the leveling, re-checked here);
- within one (wavefront, task type, shard) no two real tasks write the same
  slot, so a batched scatter has one writer per real slot.

Padding goes to a *trash slot*: padded gathers read it, padded bodies write
it back, padded messages land in the receiver's trash. Real slots are never
aliased with trash, so garbage cannot contaminate results. Several padded
writes may hit the trash slot in one scatter; which one wins is left
undefined, which is harmless because only padded tasks read trash.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .discovery import (PTG, CommPattern, WavefrontSchedule, discover,
                        discover_local, segment_runs, union_pattern)

logger = logging.getLogger(__name__)

K = Hashable
B = Hashable  # block id


@dataclass(frozen=True)
class SparseRound:
    """One ``ppermute`` round of a sparse exchange: a partial permutation of
    shards, each active pair carrying up to ``width`` blocks.

    ``send[s]`` — the slots shard s contributes (trash-padded to ``width``);
    ``recv[d]`` — where shard d's arrivals land (trash for non-receivers:
    ppermute delivers zeros there, which the trash slot absorbs)."""

    perm: Tuple[Tuple[int, int], ...]   # active (src, dst) pairs
    send: np.ndarray                    # [n_shards, width]
    recv: np.ndarray                    # [n_shards, width]

    @property
    def width(self) -> int:
        return self.send.shape[-1]

    @property
    def wire_slots(self) -> int:
        """Block slots actually crossing the wire: only active pairs
        transmit in a collective permute."""
        return len(self.perm) * self.width


@dataclass(frozen=True)
class BlockPTGSpec:
    """Application -> executor contract for a block-structured PTG.

    ``ptg`` answers the edge/mapping queries; ``seeds`` are the
    zero-indegree roots in program order; ``block_of`` / ``operands`` /
    ``owner`` tie tasks to the block store. When ``views`` is set (one
    lazily derived per-shard view, ``repro_torch.ptg.Graph.local_views``),
    discovery runs in local mode (:func:`~repro_torch.core.discovery
    .discover_local`) and the other callables are expected to dispatch
    into the views — no global edge dicts exist anywhere in the lowering.
    Invariant: a spec with and without ``views`` over the same graph lowers
    to the identical program."""

    ptg: PTG
    seeds: Sequence[K]
    n_shards: int
    block_shape: Tuple[int, int]
    block_of: Callable[[K], B]            # block written by task k
    operands: Callable[[K], Sequence[B]]  # blocks read by k (fixed arity per type)
    owner: Callable[[B], int]             # shard owning block b
    dtype: torch.dtype = torch.float32
    views: Optional[Sequence] = None      # per-shard lazy views (local mode)


@dataclass
class BlockProgram:
    """Host-built schedule-as-data, ready to lower."""

    spec: BlockPTGSpec
    schedule: WavefrontSchedule
    slot_of: Dict[B, Tuple[int, int]]       # block -> (owner shard, slot)
    halo_slot: Dict[Tuple[int, B], int]     # (shard, block) -> halo copy slot
    n_slots: int                            # incl. trash slot (last)
    types: List[str]
    arity: Dict[str, int]
    # tables[w][t] = (ops_idx [n_shards, T, arity], out_idx [n_shards, T])
    tables: List[Dict[str, Tuple[np.ndarray, np.ndarray]]]
    # exchange[w] = (send_idx [src, dst, M], recv_idx [dst, src, M]) — the
    # dense (all_to_all) lowering, padded to wavefront w's own width M.
    exchange: List[Tuple[np.ndarray, np.ndarray]]
    # patterns[w]: the wavefront's *data-carrying* comm pattern (control-only
    # edges already dropped) — drives the sparse/dense choice.
    patterns: List[CommPattern]
    # sparse_exchange[w]: ppermute-round lowering of the same plan.
    sparse_exchange: List[List[SparseRound]]

    def __post_init__(self):
        # memo for host-side lowering products (stacked scan tables, segment
        # plans, halo splits) — executors rebuild O(W·n·T) numpy tables
        # otherwise on every construction of the same program.
        self._cache: Dict[Tuple, object] = {}

    # ------------------------------------------------------------ packing

    @property
    def trash(self) -> int:
        """The padding slot (always the last): padded gathers read it,
        padded writes and padded message arrivals land in it — real slots
        are never aliased with it, so garbage cannot contaminate results."""
        return self.n_slots - 1

    def pack(self, blocks: Dict[B, object], device="cuda") -> torch.Tensor:
        """Store layout: {block id: array} -> a ``[n_shards, n_slots, b0,
        b1]`` tensor on ``device``, each block placed at its owner's slot
        (``slot_of``); unset slots — halo copies, trash — are zero. Blocks
        may be numpy arrays or tensors on any device (tensors already on
        ``device`` never pass through the host). Inverse of
        :meth:`unpack`."""
        b0, b1 = self.spec.block_shape
        out = torch.zeros((self.spec.n_shards, self.n_slots, b0, b1),
                          dtype=self.spec.dtype, device=device)
        for blk, arr in blocks.items():
            s, slot = self.slot_of[blk]
            out[s, slot] = torch.as_tensor(arr)
        return out

    def unpack(self, packed: torch.Tensor) -> Dict[B, torch.Tensor]:
        """Every block's *owned* copy out of the packed
        ``[n_shards, n_slots, b0, b1]`` tensor, as views on its device
        (halo copies are ignored)."""
        return {blk: packed[s, slot] for blk, (s, slot) in self.slot_of.items()}

    # ------------------------------------------------------------- stats

    def lowered_pattern(self, w: int, comm: str = "auto",
                        density_threshold: float = 0.5) -> str:
        """The collective wavefront ``w``'s exchange lowers to under policy
        ``comm``: "all_to_all", "ppermute", or "none" (nothing crosses).

        "auto" takes the fused all_to_all when the pair set is dense enough
        (>= ``density_threshold`` of possible pairs) or when the ppermute
        rounds would put at least as many slots on the wire; otherwise the
        sparse rounds win — Cholesky's panel broadcasts, pipeline hand-offs.
        """
        if comm not in ("dense", "sparse", "auto"):
            raise ValueError(f"unknown comm policy {comm!r}")
        pat = self.patterns[w]
        if pat.total == 0:
            return "none"
        if comm == "dense":
            return "all_to_all"
        if comm == "sparse":
            return "ppermute"
        n = self.spec.n_shards
        dense_wire = n * n * self.exchange[w][0].shape[-1]
        sparse_wire = sum(r.wire_slots for r in self.sparse_exchange[w])
        if pat.density >= density_threshold or sparse_wire >= dense_wire:
            return "all_to_all"
        return "ppermute"

    # ------------------------------------------------------- segmentation

    def comm_signature(self, w: int, comm: str = "auto",
                       density_threshold: float = 0.5) -> Tuple:
        """Hashable comm signature of wavefront ``w`` under policy ``comm``
        (see :meth:`CommPattern.signature`): the segmentation key of the
        segmented-scan lowering. Wavefronts sharing a signature share a scan
        body — same collective, identical static ppermute rounds."""
        return self.patterns[w].signature(
            self.lowered_pattern(w, comm, density_threshold))

    def _segment_plan(self, comm: str, density_threshold: float,
                      cover: str = "exact"
                      ) -> Tuple[List[Tuple[int, int]], List[Tuple]]:
        if cover not in ("exact", "union"):
            raise ValueError(f"unknown signature cover {cover!r}")
        key = ("segments", comm, density_threshold, cover)
        if key not in self._cache:
            W = len(self.tables)
            if cover == "exact":
                sigs = [self.comm_signature(w, comm, density_threshold)
                        for w in range(W)]
            else:
                # union cover: group maximal runs of sparse-class wavefronts
                # (ppermute or silent) and give the whole run the *union*
                # pattern's static rounds — every wavefront in the run can
                # ride them (inactive pairs ship trash), so a fragmented run
                # still folds into one scan. Dense (all_to_all) wavefronts
                # keep their own class.
                choices = [self.lowered_pattern(w, comm, density_threshold)
                           for w in range(W)]
                cls = ["dense" if c == "all_to_all" else "sparse"
                       for c in choices]
                sigs: List[Tuple] = [()] * W
                for (s, e) in segment_runs(cls):
                    if cls[s] == "dense":
                        sig: Tuple = ("all_to_all",)
                    else:
                        union = union_pattern(
                            [self.patterns[w] for w in range(s, e)])
                        sig = (("ppermute", union.round_perms())
                               if union.total else ("none",))
                    for w in range(s, e):
                        sigs[w] = sig
            self._cache[key] = (segment_runs(sigs), sigs)
        return self._cache[key]  # type: ignore[return-value]

    def segments(self, comm: str = "auto",
                 density_threshold: float = 0.5,
                 cover: str = "exact") -> List[Tuple[int, int]]:
        """Partition the wavefront sequence into maximal ``[start, stop)``
        runs of equal comm signature — the segmented-scan executor walks
        one scan per run, with tables padded to each run's own
        ``T_max``/``M_max`` (never a global maximum).

        ``cover="exact"`` keys runs on each wavefront's own signature;
        ``cover="union"`` coarsens sparse runs to the union permutation
        cover (:func:`~repro_torch.core.discovery.union_pattern`), trading trash
        padding for far fewer segments on fragmented schedules."""
        return self._segment_plan(comm, density_threshold, cover)[0]

    def _union_rounds(self, w: int, perms: Tuple) -> List[SparseRound]:
        """Realize wavefront ``w``'s exchange on the union cover's static
        ``perms``: each pair active at ``w`` ships its slots in the (single)
        union round containing it; pairs inactive at ``w`` pad with trash.
        Per-pair slot lists are rebuilt from the dense ``exchange[w]``
        tables (send and recv are aligned by message index)."""
        key = ("urounds", w, perms)
        if key in self._cache:
            return self._cache[key]  # type: ignore[return-value]
        n, trash = self.spec.n_shards, self.trash
        send, recv = self.exchange[w]            # [src, dst, M], [dst, src, M]
        covered = {p for perm in perms for p in perm}
        missing = set(self.patterns[w].pair_counts) - covered
        if missing:
            raise ValueError(
                f"union cover does not span wavefront {w}'s pairs "
                f"{sorted(missing)} — messages would be dropped")
        rounds: List[SparseRound] = []
        for perm in perms:
            pair_slots = {}
            for src, dst in perm:
                ss = [int(x) for x in send[src, dst] if x != trash]
                rs = [int(x) for x in recv[dst, src] if x != trash]
                if len(ss) != len(rs):
                    raise ValueError(
                        f"wavefront {w}: pair {(src, dst)} sends "
                        f"{len(ss)} slots but lands {len(rs)}")
                if ss:
                    pair_slots[(src, dst)] = (ss, rs)
            width = max((len(v[0]) for v in pair_slots.values()), default=0)
            r_send = np.full((n, width), trash, np.int32)
            r_recv = np.full((n, width), trash, np.int32)
            for (src, dst), (ss, rs) in pair_slots.items():
                for m in range(len(ss)):
                    r_send[src, m] = ss[m]
                    r_recv[dst, m] = rs[m]
            rounds.append(SparseRound(tuple(perm), r_send, r_recv))
        self._cache[key] = rounds
        return rounds

    def _rounds_for(self, w: int, sig: Tuple,
                    cover: str) -> List[SparseRound]:
        """The ppermute rounds wavefront ``w`` contributes to a segment with
        signature ``sig``: its own exact rounds, or its realization on the
        segment's union cover."""
        if cover == "union":
            return self._union_rounds(w, sig[1])
        return self.sparse_exchange[w]

    def comm_stats(self, *, comm: str = "dense",
                   density_threshold: float = 0.5,
                   segmented: bool = False,
                   cover: str = "exact") -> dict:
        """Bytes on the wire per wavefront under lowering policy ``comm``
        ("dense" | "sparse" | "auto").

        ``real_bytes`` is the payload (cross-shard data blocks, one copy per
        (src, dst) pair); ``padded_bytes`` is the *wasted* wire (trash-slot
        padding the chosen collective ships on top); ``wire_efficiency`` =
        real / (real + padded).

        ``segmented=True`` accounts the segmented-scan lowering instead:
        each wavefront ships its *segment's* padded shape (per-segment
        ``M_max`` for all_to_all runs, per-round segment-max widths for
        ppermute runs), and the result gains ``n_segments`` plus a
        per-segment breakdown. ``cover="union"`` accounts
        the union-cover coarsening (see :meth:`segments`): every wavefront
        of a sparse run ships the *union* rounds, so the inactive
        (pair, wavefront) slots show up as ``padded_bytes`` — the padding
        is never hidden from the wire-efficiency trajectory.
        """
        b0, b1 = self.spec.block_shape
        block_bytes = b0 * b1 * self.spec.dtype.itemsize
        n = self.spec.n_shards
        seg_wire: Dict[int, int] = {}
        seg_rows: List[dict] = []
        if segmented:
            runs, sigs = self._segment_plan(comm, density_threshold, cover)
            for (s, e) in runs:
                sig = sigs[s]
                if sig[0] == "all_to_all":
                    m_seg = max(self.exchange[w][0].shape[-1]
                                for w in range(s, e))
                    wire_w = n * n * m_seg
                elif sig[0] == "ppermute":
                    per_w = {w: self._rounds_for(w, sig, cover)
                             for w in range(s, e)}
                    widths = [max(per_w[w][r].width for w in range(s, e))
                              for r in range(len(sig[1]))]
                    wire_w = sum(len(p) * wd
                                 for p, wd in zip(sig[1], widths))
                else:
                    wire_w = 0
                for w in range(s, e):
                    seg_wire[w] = wire_w
                real_seg = sum(self.patterns[w].total for w in range(s, e))
                seg_rows.append({
                    "start": s, "stop": e, "wavefronts": e - s,
                    "pattern": sig[0],
                    "rounds": (len(sig[1]) if sig[0] == "ppermute"
                               else (1 if sig[0] == "all_to_all" else 0)),
                    "density": float(np.mean(
                        [self.patterns[w].density for w in range(s, e)])),
                    "real_bytes": real_seg * block_bytes,
                    "padded_bytes": (wire_w * (e - s) - real_seg)
                    * block_bytes,
                })
        per_wave = []
        for w, (send, _) in enumerate(self.exchange):
            real = self.patterns[w].total
            choice = self.lowered_pattern(w, comm, density_threshold)
            if segmented:
                wire = seg_wire[w]
            elif choice == "all_to_all":
                wire = n * n * send.shape[-1]
            elif choice == "ppermute":
                wire = sum(r.wire_slots for r in self.sparse_exchange[w])
            else:
                wire = 0
            per_wave.append({
                "pattern": choice,
                "real_blocks": real,
                "wire_blocks": wire,
                "padded_blocks": wire - real,
                "pairs": self.patterns[w].n_pairs,
                "density": self.patterns[w].density,
                "rounds": (len(self.sparse_exchange[w])
                           if choice == "ppermute" else
                           (1 if choice == "all_to_all" else 0)),
            })
        real_bytes = sum(w["real_blocks"] for w in per_wave) * block_bytes
        padded_bytes = sum(w["padded_blocks"] for w in per_wave) * block_bytes
        total = real_bytes + padded_bytes
        out = {
            "comm": comm,
            "block_bytes": block_bytes,
            "wavefronts": len(self.exchange),
            "real_bytes": real_bytes,
            "padded_bytes": padded_bytes,
            "total_wire_bytes": total,
            "wire_efficiency": real_bytes / total if total else 1.0,
            "per_wavefront": per_wave,
        }
        if segmented:
            out["segmented"] = True
            out["cover"] = cover
            out["n_segments"] = len(seg_rows)
            out["segments"] = seg_rows
        return out

    # ----------------------------------------------------------- lowering

    def _split_tables(self, w: int) -> Tuple[dict, Optional[dict]]:
        """Split ``tables[w]`` into (halo-independent, halo-dependent) parts
        wrt the arrivals of wavefront ``w - 1``'s exchange — the slot-level
        refinement of ``WavefrontSchedule.halo_split`` (control-only edges
        carry no block, so a message-level "dependent" task may still be
        slot-independent). Returns ``(tables[w], None)`` when nothing
        arrives. Memoized: both overlap lowerings (unrolled and segmented
        scan) share the split."""
        key = ("split", w)
        if key in self._cache:
            return self._cache[key]  # type: ignore[return-value]
        if w == 0 or self.patterns[w - 1].total == 0:
            self._cache[key] = (self.tables[w], None)
            return self.tables[w], None
        n = self.spec.n_shards
        recv_prev = self.exchange[w - 1][1]          # [dst, src, M]
        arriving = [set(recv_prev[s].ravel().tolist()) - {self.trash}
                    for s in range(n)]
        indep_tbl: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        dep_tbl: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for t, (ops, out) in self.tables[w].items():
            rows: Dict[bool, List[List[int]]] = {False: [], True: []}
            for s in range(n):
                split: Dict[bool, List[int]] = {False: [], True: []}
                for i in range(out.shape[1]):
                    if out[s, i] == self.trash:
                        continue
                    dep = any(int(o) in arriving[s] for o in ops[s, i])
                    split[dep].append(i)
                for d in (False, True):
                    rows[d].append(split[d])
            for d, tbl in ((False, indep_tbl), (True, dep_tbl)):
                T = max(len(r) for r in rows[d])
                if T == 0:
                    continue
                o_np = np.full((n, T, ops.shape[-1]), self.trash, np.int32)
                u_np = np.full((n, T), self.trash, np.int32)
                for s in range(n):
                    for j, i in enumerate(rows[d][s]):
                        o_np[s, j] = ops[s, i]
                        u_np[s, j] = out[s, i]
                tbl[t] = (o_np, u_np)
        self._cache[key] = (indep_tbl, dep_tbl)
        return indep_tbl, dep_tbl

    def _stack_tables(self, tabs: Dict[str, np.ndarray], prefix: str,
                      tbl_list: Sequence[Dict[str, Tuple[np.ndarray,
                                                         np.ndarray]]]):
        """Stack per-wavefront compute tables into shard-major arrays
        ``tabs[f"{t}:{prefix}ops"] [n, L, T_max, ar]`` (padded with trash to
        the *list's* own per-type T_max — never a global maximum)."""
        L, n = len(tbl_list), self.spec.n_shards
        for t in self.types:
            T = max((tbl[t][0].shape[1] for tbl in tbl_list if t in tbl),
                    default=0)
            if T == 0:
                continue
            ops = np.full((L, n, T, self.arity[t]), self.trash, np.int32)
            out = np.full((L, n, T), self.trash, np.int32)
            for j, tbl in enumerate(tbl_list):
                if t in tbl:
                    o, u = tbl[t]
                    ops[j, :, : o.shape[1]] = o
                    out[j, :, : u.shape[1]] = u
            tabs[f"{t}:{prefix}ops"] = np.swapaxes(ops, 0, 1).copy()
            tabs[f"{t}:{prefix}out"] = np.swapaxes(out, 0, 1).copy()

    def _stack_exchange(self, tabs: Dict[str, np.ndarray],
                        ws: Sequence[int], m_pad: int):
        """Stack the all_to_all exchange tables of wavefronts ``ws`` into
        shard-major ``tabs["send"/"recv"] [n, L, n, m_pad]`` (trash-padded)
        — shared by the dense scan (all wavefronts, global M_max) and the
        segmented scan (one run, the run's own M_max)."""
        n = self.spec.n_shards
        send = np.full((len(ws), n, n, m_pad), self.trash, np.int32)
        recv = np.full((len(ws), n, n, m_pad), self.trash, np.int32)
        for j, w in enumerate(ws):
            s_i, r_i = self.exchange[w]
            send[j, :, :, : s_i.shape[-1]] = s_i
            recv[j, :, :, : r_i.shape[-1]] = r_i
        tabs["send"] = np.swapaxes(send, 0, 1).copy()
        tabs["recv"] = np.swapaxes(recv, 0, 1).copy()

    def _dense_scan_tables(self) -> Tuple[Dict[str, np.ndarray], int]:
        """Memoized global stacking for the pure dense scan: tables padded
        to global T_max per type, exchanges to the global M_max."""
        key = ("dense_scan_tables",)
        if key in self._cache:
            return self._cache[key]  # type: ignore[return-value]
        M_max = max((e[0].shape[-1] for e in self.exchange), default=0)
        # shard-major [n_shards, W, ...], the JAX package's layout
        tabs_np: Dict[str, np.ndarray] = {}
        self._stack_tables(tabs_np, "", self.tables)
        if M_max:
            self._stack_exchange(tabs_np, range(len(self.tables)), M_max)
        self._cache[key] = (tabs_np, M_max)
        return self._cache[key]  # type: ignore[return-value]

    def _segment_tables(self, comm: str, density_threshold: float,
                        overlap: bool, cover: str = "exact"
                        ) -> List[Tuple[int, int, Tuple,
                                        Dict[str, np.ndarray]]]:
        """Memoized per-segment stacked tables for the segmented-scan
        lowering: ``[(start, stop, signature, tabs)]``, with compute tables
        padded to the segment's T_max and exchange tables to the segment's
        M_max (all_to_all) / per-round max widths (ppermute).

        ``overlap=True`` stores the halo split instead: the segment head's
        exact (indep, dep) tables under ``h:*`` keys plus stacked splits for
        the scanned tail — wavefront w-1's arrivals land *between* w's
        halo-independent and -dependent compute.

        ``cover="union"`` stacks each sparse segment's exchange from the
        union cover's rounds (:meth:`_rounds_for`) instead of each
        wavefront's own — same table shapes, same scan body, just more
        trash padding where a pair sits a wavefront out."""
        key = ("seg_tables", comm, density_threshold, overlap, cover)
        if key in self._cache:
            return self._cache[key]  # type: ignore[return-value]
        runs, sigs = self._segment_plan(comm, density_threshold, cover)
        n, trash = self.spec.n_shards, self.trash
        segs = []
        for (s, e) in runs:
            sig, L = sigs[s], e - s
            tabs: Dict[str, np.ndarray] = {}
            if not overlap:
                self._stack_tables(tabs, "", self.tables[s:e])
            else:
                splits = [self._split_tables(w) for w in range(s, e)]
                for t, (o, u) in splits[0][0].items():
                    tabs[f"h:{t}:iops"], tabs[f"h:{t}:iout"] = o, u
                for t, (o, u) in (splits[0][1] or {}).items():
                    tabs[f"h:{t}:dops"], tabs[f"h:{t}:dout"] = o, u
                if L > 1:
                    self._stack_tables(tabs, "i", [sp[0] for sp in splits[1:]])
                    self._stack_tables(tabs, "d",
                                       [sp[1] or {} for sp in splits[1:]])
            if sig[0] == "all_to_all":
                m_seg = max(self.exchange[w][0].shape[-1] for w in range(s, e))
                self._stack_exchange(tabs, range(s, e), m_seg)
            elif sig[0] == "ppermute":
                per_w = {w: self._rounds_for(w, sig, cover)
                         for w in range(s, e)}
                for r in range(len(sig[1])):
                    wr = max(per_w[w][r].width for w in range(s, e))
                    snd = np.full((L, n, wr), trash, np.int32)
                    rcv = np.full((L, n, wr), trash, np.int32)
                    for j, w in enumerate(range(s, e)):
                        rnd = per_w[w][r]
                        snd[j, :, : rnd.width] = rnd.send
                        rcv[j, :, : rnd.width] = rnd.recv
                    tabs[f"send{r}"] = np.swapaxes(snd, 0, 1).copy()
                    tabs[f"recv{r}"] = np.swapaxes(rcv, 0, 1).copy()
            segs.append((s, e, sig, tabs))
        self._cache[key] = segs
        return segs

    # ----------------------------------------------- lowering: executors

    def executor(
        self,
        bodies: Dict[str, Callable[..., torch.Tensor]],
        *,
        device="cuda",
        scan: bool = True,
        comm: Optional[str] = None,
        overlap: bool = False,
        density_threshold: float = 0.5,
        cover: str = "exact",
    ) -> "BlockExecutor":
        """Build the executor of this program on one device.

        ``bodies[t](*operands) -> out`` is *batched*: each operand is a
        ``[N, b0, b1]`` tensor holding one block per task, and the body
        returns the ``N`` output blocks (the JAX package vmaps a per-block
        body; here the batch dimension is written out). Three lowerings,
        chosen by the same policy arguments as the JAX package's executor:

        - ``scan=False`` **unrolls**: each wavefront's exchange takes its
          own collective class under policy ``comm`` ("dense" | "sparse" |
          "auto"; default "auto"), with per-wavefront padding;
        - ``scan=True, comm="dense"`` (the ``scan`` default) is the **pure
          dense scan**: every wavefront walks the tables padded to global
          maxima, every exchange the global all_to_all table;
        - ``scan=True, comm="sparse"|"auto"`` (or dense with ``overlap``)
          is the **segmented scan**: runs of equal comm signature
          (:meth:`segments`), each walking its own padded tables; with
          ``cover="union"`` the sparse runs take the union permutation
          cover first.

        ``overlap=True`` keeps the JAX package's double-buffered order:
        wavefront w's exchange is gathered, w+1's halo-independent tasks
        run, the buffers land, then the halo-dependent tasks run.

        All variants are numerically identical: the same bodies over the
        same operand values, in a dependency-respecting order. Index tables
        move to ``device`` once, here, as int64.
        """
        if comm is None:
            comm = "dense" if scan else "auto"
        if comm not in ("dense", "sparse", "auto"):
            raise ValueError(f"unknown comm policy {comm!r}")
        if cover not in ("exact", "union"):
            raise ValueError(f"unknown signature cover {cover!r}")
        ex = BlockExecutor(self, bodies, torch.device(device))
        if scan:
            if comm == "dense" and not overlap:
                ex._run = self._dense_scan_run(ex)
                ex.mode = "dense_scan"
            else:
                ex._run = self._segmented_scan_run(
                    ex, comm=comm, overlap=overlap,
                    density_threshold=density_threshold, cover=cover)
                ex.mode = "segmented_scan"
        else:
            ex._run = self._unrolled_run(
                ex, comm=comm, overlap=overlap,
                density_threshold=density_threshold)
            ex.mode = "unrolled"
        return ex

    def _dense_scan_run(self, ex: "BlockExecutor"):
        """One walk over all wavefronts, tables padded to global maxima,
        every exchange the dense table padded to the global M_max."""
        tabs_np, M_max = self._dense_scan_tables()
        tabs = ex.put(tabs_np)

        def run(local):
            for j in range(len(self.tables)):
                ex.compute(local, ex.row_tables(tabs, j))
                if M_max:
                    ex.land(local, ex.issue_dense(
                        local, tabs["send"][:, j], tabs["recv"][:, j]))

        return run

    def _segmented_scan_run(self, ex: "BlockExecutor", *, comm, overlap,
                            density_threshold, cover="exact"):
        """One walk per run of equal comm signature, each over the run's
        own padded tables (:meth:`_segment_tables`). With ``overlap`` a
        segment's head wavefront uses its exact (indep, dep) split and the
        in-flight buffers carry across segment boundaries, as in the JAX
        package's double-buffered segmented scan."""
        segs = []
        for (s, e, sig, tabs_np) in self._segment_tables(
                comm, density_threshold, overlap, cover):
            tabs = ex.put(tabs_np)
            rounds = (ex.rounds([(perm, tabs[f"send{r}"], tabs[f"recv{r}"])
                                 for r, perm in enumerate(sig[1])])
                      if sig[0] == "ppermute" else [])
            segs.append((e - s, sig, tabs, rounds))

        def issue(local, sig, tabs, rounds, j):
            if sig[0] == "all_to_all":
                return ex.issue_dense(local, tabs["send"][:, j],
                                      tabs["recv"][:, j])
            return [(dst, recv[:, j], local[src, send[:, j]])
                    for src, dst, send, recv in rounds]

        def head(tabs, kind):
            return {t: (tabs[f"h:{t}:{kind}ops"], tabs[f"h:{t}:{kind}out"])
                    for t in self.types if f"h:{t}:{kind}ops" in tabs}

        def run(local):
            for L, sig, tabs, rounds in segs:
                for j in range(L):
                    ex.compute(local, ex.row_tables(tabs, j))
                    ex.land(local, issue(local, sig, tabs, rounds, j))

        def run_overlap(local):
            pending: list = []
            for L, sig, tabs, rounds in segs:
                # head wavefront: exact split; lands the previous segment's
                # in-flight buffers between its indep and dep compute
                ex.compute(local, head(tabs, "i"))
                ex.land(local, pending)
                ex.compute(local, head(tabs, "d"))
                pending = issue(local, sig, tabs, rounds, 0)
                for j in range(1, L):
                    ex.compute(local, ex.row_tables(tabs, j - 1, "i"))
                    ex.land(local, pending)
                    ex.compute(local, ex.row_tables(tabs, j - 1, "d"))
                    pending = issue(local, sig, tabs, rounds, j)
            ex.land(local, pending)       # W-1 never sends; safety net

        return run_overlap if overlap else run

    def _unrolled_run(self, ex: "BlockExecutor", *, comm, overlap,
                      density_threshold):
        """Every wavefront with its own exact tables and its own collective
        class; with ``overlap`` the landing of wavefront w's exchange is
        deferred past w+1's halo-independent compute."""
        W = len(self.tables)
        choices = [self.lowered_pattern(w, comm, density_threshold)
                   for w in range(W)]
        tables = [ex.put(tbl) for tbl in self.tables]
        splits = ([tuple(ex.put(part or {}) for part in self._split_tables(w))
                   for w in range(W)] if overlap else None)
        exchanges = []
        for w in range(W):
            if choices[w] == "all_to_all":
                exchanges.append(("dense", ex.put(self.exchange[w])))
            elif choices[w] == "ppermute":
                exchanges.append(("sparse", ex.rounds(
                    [(rnd.perm, ex.index(rnd.send), ex.index(rnd.recv))
                     for rnd in self.sparse_exchange[w]])))
            else:
                exchanges.append(("none", None))

        def issue(local, w):
            kind, plan = exchanges[w]
            if kind == "dense":
                return ex.issue_dense(local, plan[0], plan[1])
            if kind == "sparse":
                return [(dst, recv, local[src, send])
                        for src, dst, send, recv in plan]
            return []

        def run(local):
            pending: list = []
            for w in range(W):
                if overlap and pending:
                    indep, dep = splits[w]
                    ex.compute(local, indep)
                    ex.land(local, pending)
                    ex.compute(local, dep)
                else:
                    ex.land(local, pending)
                    ex.compute(local, tables[w])
                pending = issue(local, w)
            ex.land(local, pending)       # W-1 never sends; safety net

        return run

    def plan_lowering(
        self,
        *,
        unroll_cap: int = 64,
        comm: str = "auto",
        overlap: bool = True,
        segment_cap: Optional[int] = None,
        density_threshold: float = 0.5,
    ) -> dict:
        """Decide how :meth:`auto_executor` lowers this program — returned
        as data so tests and benchmarks can assert on the policy itself.

        - depth <= ``unroll_cap``: **unrolled** (per-wavefront collective
          choice, exact padding);
        - deeper, and the comm signatures form <= ``segment_cap`` (default
          ``unroll_cap``) runs: **segmented scan** — the caller's ``comm`` /
          ``overlap`` preference is preserved;
        - deeper and genuinely dense (no wavefront lowers to ppermute, no
          overlap asked): **pure dense scan** — there is no sparsity to
          keep, so take the single dense walk;
        - deeper and too fragmented to segment exactly, but the **union
          permutation cover** fits the cap *and* its honestly-accounted
          wire efficiency still beats what the pure dense scan would ship:
          **union-cover scan** (``mode="union_cover"``) — fragmented runs
          fold into scans over the union rounds, trash-padding the inactive
          (pair, wavefront) slots;
        - otherwise: **dense scan** with ``discards=True`` — the caller's
          preference is dropped, which :meth:`auto_executor` reports loudly
          instead of silently.
        """
        W = self.schedule.n_wavefronts
        cap = unroll_cap if segment_cap is None else segment_cap
        plan = {"comm": comm, "overlap": overlap, "n_wavefronts": W,
                "discards": False, "cover": "exact"}
        if W <= unroll_cap:
            plan.update(mode="unrolled",
                        reason=f"depth {W} <= unroll_cap {unroll_cap}")
            return plan
        if comm == "dense" and not overlap:
            plan.update(mode="dense_scan", reason="dense lowering requested")
            return plan
        runs, _ = self._segment_plan(comm, density_threshold)
        plan["n_segments"] = len(runs)
        sparse_any = any(
            self.lowered_pattern(w, comm, density_threshold) == "ppermute"
            for w in range(W))
        if not sparse_any and not overlap:
            plan.update(mode="dense_scan",
                        reason="genuinely dense: no wavefront lowers to "
                               "ppermute under this policy")
        elif len(runs) <= cap:
            plan.update(mode="segmented_scan",
                        reason=f"{len(runs)} segments <= "
                               f"segment_cap {cap}")
        else:
            # exact signatures fragment; before discarding the sparse wire,
            # try the union permutation cover, keeping it only when the
            # padding it adds still undercuts the dense scan's.
            uruns, _ = self._segment_plan(comm, density_threshold, "union")
            ustats = self.comm_stats(comm=comm,
                                     density_threshold=density_threshold,
                                     segmented=True, cover="union")
            n = self.spec.n_shards
            m_max = max((e[0].shape[-1] for e in self.exchange), default=0)
            scan_wire = W * n * n * m_max
            real = sum(p.total for p in self.patterns)
            eff_dense_scan = real / scan_wire if scan_wire else 1.0
            plan["n_segments_union"] = len(uruns)
            plan["wire_efficiency_union"] = ustats["wire_efficiency"]
            plan["wire_efficiency_dense_scan"] = eff_dense_scan
            if (len(uruns) <= cap
                    and ustats["wire_efficiency"] > eff_dense_scan):
                plan.update(
                    mode="union_cover", cover="union",
                    reason=f"exact comm signatures too fragmented "
                           f"({len(runs)} segments > segment_cap {cap}); "
                           f"union cover folds them into {len(uruns)} "
                           f"segments at wire efficiency "
                           f"{ustats['wire_efficiency']:.3f} > dense scan's "
                           f"{eff_dense_scan:.3f}")
            else:
                why = (f"union cover still fragmented ({len(uruns)} "
                       f"segments > segment_cap {cap})"
                       if len(uruns) > cap else
                       f"union cover wire efficiency "
                       f"{ustats['wire_efficiency']:.3f} <= dense scan's "
                       f"{eff_dense_scan:.3f}")
                plan.update(mode="dense_scan", discards=True,
                            reason=f"comm signatures too fragmented: "
                                   f"{len(runs)} segments > segment_cap "
                                   f"{cap}, and {why}")
        return plan

    def auto_executor(
        self,
        bodies: Dict[str, Callable[..., torch.Tensor]],
        *,
        device="cuda",
        unroll_cap: int = 64,
        density_threshold: float = 0.5,
        comm: str = "auto",
        overlap: bool = True,
        segment_cap: Optional[int] = None,
    ) -> "BlockExecutor":
        """The default lowering policy, shared by every consumer (the linalg
        apps, Task-Bench) — see :meth:`plan_lowering`: shallow schedules
        unroll with per-wavefront sparse/dense exchange choice and overlap;
        deeper schedules keep the sparse exchange through the segmented scan
        (coarsened to the union permutation cover when the exact signatures
        fragment but the cover's wire still beats the dense scan's); only
        genuinely dense or hopelessly fragmented schedules take the pure
        dense scan. When that last fallback discards the caller's
        ``comm``/``overlap`` preference it is logged loudly."""
        plan = self.plan_lowering(
            unroll_cap=unroll_cap, comm=comm, overlap=overlap,
            segment_cap=segment_cap, density_threshold=density_threshold)
        if plan["mode"] == "unrolled":
            return self.executor(bodies, device=device, scan=False,
                                 comm=comm, overlap=overlap,
                                 density_threshold=density_threshold)
        if plan["mode"] in ("segmented_scan", "union_cover"):
            return self.executor(bodies, device=device, scan=True, comm=comm,
                                 overlap=overlap,
                                 density_threshold=density_threshold,
                                 cover=plan["cover"])
        if plan["discards"]:
            logger.warning(
                "auto_executor: depth %d > unroll_cap %d and %s; falling "
                "back to the pure dense scan and DISCARDING the caller's "
                "comm=%r/overlap=%r preference (raise segment_cap to force "
                "the segmented scan, or pass comm='dense' to silence this)",
                plan["n_wavefronts"], unroll_cap, plan["reason"],
                comm, overlap)
        return self.executor(bodies, device=device, scan=True, comm="dense")


class BlockExecutor:
    """A :class:`BlockProgram` lowered onto one device: the index tables,
    moved there once as int64, and the wavefront walk of one lowering.

    Calling it runs the program on a packed store
    (``BlockProgram.pack``) and returns a new store; the input is left
    as it is. ``calls[t]`` counts the batched body calls of type ``t`` and
    ``max_batch[t]`` the largest batch one of them took, over every call
    of this executor.
    """

    def __init__(self, prog: BlockProgram,
                 bodies: Dict[str, Callable[..., torch.Tensor]],
                 device: torch.device):
        self.prog = prog
        self.bodies = bodies
        self.device = device
        self.mode = ""
        self.calls: Dict[str, int] = defaultdict(int)
        self.max_batch: Dict[str, int] = defaultdict(int)
        n = prog.spec.n_shards
        self._rows = torch.arange(n, device=device).view(n, 1)
        self._run: Optional[Callable[[torch.Tensor], None]] = None

    def index(self, x) -> torch.Tensor:
        """A host index table as an int64 tensor on the device."""
        return torch.as_tensor(np.asarray(x, dtype=np.int64),
                               device=self.device)

    def put(self, tree):
        """:meth:`index` over a dict / tuple / list of tables."""
        if isinstance(tree, dict):
            return {k: self.put(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(self.put(v) for v in tree)
        return self.index(tree)

    def row_tables(self, tabs: Dict[str, torch.Tensor], j: int,
                   prefix: str = ""):
        """Step ``j`` of stacked shard-major tables ``[n, L, ...]``."""
        return {t: (tabs[f"{t}:{prefix}ops"][:, j],
                    tabs[f"{t}:{prefix}out"][:, j])
                for t in self.prog.types if f"{t}:{prefix}ops" in tabs}

    def compute(self, local: torch.Tensor, tbl) -> None:
        """One wavefront's compute, in place: for each type in
        ``prog.types`` order, gather ``local[s, ops[s, i, a]]`` for every
        shard at once, make one body call over the ``n·T`` tasks, and
        scatter the results to ``local[s, out[s, i]]``. A later type sees
        an earlier type's writes."""
        n, _, b0, b1 = local.shape
        for t in self.prog.types:
            if t not in tbl:
                continue
            ops_idx, out_idx = tbl[t]            # [n, T, arity], [n, T]
            T = out_idx.shape[1]
            if T == 0:
                continue
            ops = [local[self._rows, ops_idx[:, :, a]].reshape(n * T, b0, b1)
                   for a in range(ops_idx.shape[2])]
            res = self.bodies[t](*ops)
            self.calls[t] += 1
            self.max_batch[t] = max(self.max_batch[t], n * T)
            local[self._rows, out_idx] = res.reshape(n, T, b0, b1).to(
                local.dtype)

    def rounds(self, rounds):
        """Device form of ppermute rounds ``[(perm, send [n, ...], recv
        [n, ...])]``: only a round's active sources send and only its
        destinations land, so their rows are selected once, here. Returns
        ``[(src [P, 1], dst [P, 1], send rows, recv rows)]``."""
        out = []
        for perm, send, recv in rounds:
            src = self.index([p[0] for p in perm])
            dst = self.index([p[1] for p in perm])
            out.append((src[:, None], dst[:, None], send[src], recv[dst]))
        return out

    def issue_dense(self, local, send, recv):
        """Gather one all_to_all exchange: ``send [src, dst, M]`` slots,
        landing at ``recv [dst, src, M]``. Returns the pending landings."""
        rows = self._rows.view(-1, 1, 1)
        buf = local[rows, send]                  # [src, dst, M, b0, b1]
        return [(rows, recv, buf.transpose(0, 1))]

    @staticmethod
    def land(local, pending) -> None:
        """Land gathered buffers: ``local[rows, slots] = buf``."""
        for rows, slots, buf in pending:
            local[rows, slots] = buf.to(local.dtype)

    @torch.no_grad()
    def __call__(self, blocks) -> torch.Tensor:
        spec = self.prog.spec
        local = torch.as_tensor(blocks).to(self.device, spec.dtype,
                                           copy=True)
        want = (spec.n_shards, self.prog.n_slots, *spec.block_shape)
        if tuple(local.shape) != want:
            raise ValueError(f"store has shape {tuple(local.shape)}, the "
                             f"program packs {want}")
        self._run(local)
        return local


def build_block_program(spec: BlockPTGSpec, *,
                        validate: bool = False) -> BlockProgram:
    """Discover the schedule and build all index tables (host side, numpy).

    When ``spec.views`` is set (the lazy per-shard derivation,
    ``repro_torch.ptg.Graph.to_block_spec(lazy=True)``), discovery runs in local
    mode: shard ``s`` expands through ``views[s]`` only, and every later
    per-task query dispatches to the owning shard's view — the schedule and
    all lowered tables are built from the union of per-shard views without
    the global edge dicts ever existing.

    ``validate=True`` additionally runs ``PTG.check_consistency`` over every
    discovered task (mutual-inverse in/out edges + mapping stability) —
    recommended for hand-written specs; :mod:`repro_torch.ptg` graphs carry the
    guarantee by construction."""
    ptg, n = spec.ptg, spec.n_shards
    if spec.views is not None:
        sched = discover_local(spec.views, n, validate=validate)
    else:
        sched = discover(ptg, spec.seeds, n, validate=validate)
    sched.validate(ptg)

    # --- slot assignment: owned blocks first, then halo copies, then trash.
    owned: List[List[B]] = [[] for _ in range(n)]
    seen: set = set()
    all_tasks = [k for s in sched.shards for wf in s.wavefronts for k in wf]
    for k in all_tasks:
        for blk in list(spec.operands(k)) + [spec.block_of(k)]:
            if blk not in seen:
                seen.add(blk)
                owned[spec.owner(blk) % n].append(blk)
    for k in all_tasks:  # "owner computes" rule
        if spec.owner(spec.block_of(k)) % n != ptg.mapping(k) % n:
            raise ValueError(
                f"task {k!r} writes block {spec.block_of(k)!r} it does not own")

    halo_needed: Dict[int, List[B]] = defaultdict(list)
    writer_count: Dict[B, int] = defaultdict(int)
    messaged: set = set()
    for k in all_tasks:
        writer_count[spec.block_of(k)] += 1
        s = ptg.mapping(k) % n
        for blk in spec.operands(k):
            if spec.owner(blk) % n != s and blk not in halo_needed[s]:
                halo_needed[s].append(blk)
                messaged.add(blk)
    for blk in messaged:
        if writer_count[blk] > 1:
            raise ValueError(
                f"block {blk!r} crosses shards but has {writer_count[blk]} "
                "writers (communicated blocks must be single-assignment)")

    # Every remote read must be fed by a *direct* in-dep edge from the
    # block's writer — that edge is what carries the payload (the AM). A
    # remote read with no such edge would never be delivered.
    for k in all_tasks:
        s = ptg.mapping(k) % n
        producers = {spec.block_of(d) for d in ptg.in_deps(k)}
        for blk in spec.operands(k):
            if spec.owner(blk) % n != s and blk not in producers:
                raise ValueError(
                    f"task {k!r} reads remote block {blk!r} but no in-dep "
                    "produces it (missing send edge in the PTG)")

    slot_of: Dict[B, Tuple[int, int]] = {}
    halo_slot: Dict[Tuple[int, B], int] = {}
    counts = []
    for s in range(n):
        slot = 0
        for blk in owned[s]:
            slot_of[blk] = (s, slot)
            slot += 1
        for blk in halo_needed[s]:
            halo_slot[(s, blk)] = slot
            slot += 1
        counts.append(slot)
    n_slots = max(counts) + 1  # + trash
    trash = n_slots - 1

    def local_slot(s: int, blk: B) -> int:
        os_, slot = slot_of[blk]
        return slot if os_ == s else halo_slot[(s, blk)]

    # --- task type metadata
    types = sorted({ptg.type_of(k) for k in all_tasks})
    arity: Dict[str, int] = {}
    for k in all_tasks:
        t = ptg.type_of(k)
        a = len(spec.operands(k))
        if arity.setdefault(t, a) != a:
            raise ValueError(f"type {t!r} has inconsistent arity")

    # --- per-wavefront compute tables
    W = sched.n_wavefronts
    tables: List[Dict[str, Tuple[np.ndarray, np.ndarray]]] = []
    for w in range(W):
        by_shard_type: Dict[str, List[List[K]]] = defaultdict(
            lambda: [[] for _ in range(n)])
        for s in range(n):
            for k in sched.shards[s].wavefronts[w]:
                by_shard_type[ptg.type_of(k)][s].append(k)
        tbl: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for t, rows in by_shard_type.items():
            T = max(len(r) for r in rows)
            if T == 0:
                continue
            ops = np.full((n, T, arity[t]), trash, np.int32)
            out = np.full((n, T), trash, np.int32)
            for s in range(n):
                outs = [local_slot(s, spec.block_of(k)) for k in rows[s]]
                if len(set(outs)) != len(outs):
                    # a batched scatter would leave the winner undefined
                    raise ValueError(
                        f"wavefront {w} type {t!r} shard {s}: duplicate "
                        "output slots")
                for i, k in enumerate(rows[s]):
                    for j, blk in enumerate(spec.operands(k)):
                        ops[s, i, j] = local_slot(s, blk)
                    out[s, i] = outs[i]
            tbl[t] = (ops, out)
        tables.append(tbl)

    # --- per-wavefront exchange tables, lowered from the schedule's fused
    # per-(src, dst) communication plan ("large AMs")
    exchange: List[Tuple[np.ndarray, np.ndarray]] = []
    patterns: List[CommPattern] = []
    sparse_exchange: List[List[SparseRound]] = []
    for w in range(W):
        groups = sched.comm_plan(w)
        per_pair: Dict[Tuple[int, int], List[B]] = {}
        for (src, dst), msgs in groups.items():
            # Only data-carrying edges ride the wire (control-only edges are
            # implied by wavefront ordering). Multiple consumers of a block
            # on the same dst share one copy. Slot order is the stable sort
            # key: unique per block on its owner, integer-cheap, identical
            # across Python versions (repr ties are neither).
            blks = sorted(
                {spec.block_of(m.src_task) for m in msgs
                 if spec.block_of(m.src_task) in set(spec.operands(m.dst_task))},
                key=lambda blk: slot_of[blk][1])
            if blks:
                per_pair[(src, dst)] = blks
        M = max((len(v) for v in per_pair.values()), default=0)
        send = np.full((n, n, M), trash, np.int32)   # [src, dst, m]
        recv = np.full((n, n, M), trash, np.int32)   # [dst, src, m]
        for (src, dst), blks in per_pair.items():
            for m, blk in enumerate(blks):
                send[src, dst, m] = local_slot(src, blk)
                recv[dst, src, m] = halo_slot[(dst, blk)]
        exchange.append((send, recv))

        # the same plan as ppermute rounds (sparse lowering)
        pattern = CommPattern(
            level=w, n_shards=n,
            pair_counts={p: len(b) for p, b in sorted(per_pair.items())})
        patterns.append(pattern)
        rounds: List[SparseRound] = []
        for perm in pattern.rounds():
            width = max(len(per_pair[p]) for p in perm)
            r_send = np.full((n, width), trash, np.int32)
            r_recv = np.full((n, width), trash, np.int32)
            for src, dst in perm:
                for m, blk in enumerate(per_pair[(src, dst)]):
                    r_send[src, m] = local_slot(src, blk)
                    r_recv[dst, m] = halo_slot[(dst, blk)]
            rounds.append(SparseRound(tuple(perm), r_send, r_recv))
        sparse_exchange.append(rounds)

    return BlockProgram(spec, sched, slot_of, halo_slot, n_slots, types,
                        arity, tables, exchange, patterns, sparse_exchange)
