"""Deterministic, restart-safe data pipeline (numpy only).

The port's own copy of ``repro.train.data``: the same classes, and bit for
bit the same batches (numpy arrays; the training loop moves them to its
device).

Sources:
- `SyntheticLM`: seeded on (seed, step) so any rank at any restart point
  regenerates the same batch — no data state in checkpoints beyond `step`.
- `PackedBinaryDataset`: memory-mapped uint32 token file (the standard
  pre-tokenized format), sequence-packed, sharded by (host, step).

Both yield {tokens, labels} with next-token labels; -100-style masking uses
label -1 (ignored by lm_loss).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, embed_dim: Optional[int] = None,
                 encdec: bool = False, learnable: bool = False):
        self.vocab, self.seq, self.batch = vocab_size, seq_len, global_batch
        self.seed = seed
        self.embed_dim = embed_dim
        self.encdec = encdec
        self.learnable = learnable

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        if self.learnable:
            # arithmetic progressions mod vocab: next-token is a simple
            # learnable function -> loss visibly drops in a few steps
            start = rng.integers(0, self.vocab, (self.batch, 1))
            stride = rng.integers(1, 7, (self.batch, 1))
            idx = np.arange(self.seq + 1)[None, :]
            toks = ((start + stride * idx) % self.vocab).astype(np.int32)
        else:
            toks = rng.integers(0, self.vocab,
                                (self.batch, self.seq + 1), dtype=np.int32)
        out: Dict[str, np.ndarray] = {}
        if self.embed_dim and not self.encdec:
            out["embeds"] = rng.standard_normal(
                (self.batch, self.seq, self.embed_dim)).astype(np.float32)
        else:
            out["tokens"] = toks[:, :-1]
        if self.encdec:
            out["enc_embeds"] = rng.standard_normal(
                (self.batch, self.seq, self.embed_dim)).astype(np.float32)
            out["tokens"] = toks[:, :-1]
        out["labels"] = toks[:, 1:]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PackedBinaryDataset:
    """uint32 token stream on disk; batches are deterministic in step."""

    def __init__(self, path: str, seq_len: int, global_batch: int):
        self.tokens = np.memmap(path, dtype=np.uint32, mode="r")
        self.seq, self.batch = seq_len, global_batch
        self.n_seqs = (len(self.tokens) - 1) // seq_len
        if self.n_seqs < global_batch:
            raise ValueError("dataset smaller than one global batch")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        idx = (np.arange(self.batch) + step * self.batch) % self.n_seqs
        starts = idx * self.seq
        toks = np.stack([self.tokens[s:s + self.seq + 1] for s in starts])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    @staticmethod
    def write(path: str, tokens: np.ndarray) -> None:
        tokens.astype(np.uint32).tofile(path)
