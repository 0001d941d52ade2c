"""KG -> token batches: the MapSDI output feeding the LM application layer.

The paper's §6 names "development of applications on top of MapSDI" as the
goal; here the application is LM training over the integrated knowledge
graph. A deduplicated KG (a 5-column int32 triple ``Table``:
``(s_tmpl, s_val, pred, o_tmpl, o_val)``) is linearized into a token
stream: each triple becomes ``[BOT, s..., SEP, p..., SEP, o..., EOT]``
where every int32 code is factored into base-``radix`` digit tokens
(vocab-independent, reversible). The stream wraps cyclically so any
(seq_len, batch) grid is always fillable.

The module is numpy only, a copy of the JAX package's: ``linearize_kg``
reads the port's KG back to the host (``Table.to_codes``), and a batch
comes back as numpy arrays, which the caller moves to its device.

Determinism + elasticity: a batch is a pure function of
``(stream, step, shard_id, n_shards, weights)``. The cursor state is an
integer, checkpointed with the train state; after an elastic restart with
a different shard count, every shard recomputes its offsets from the same
formula — no rewinding, no duplicate/missing examples.

Straggler mitigation: :meth:`rebalance` takes per-shard weights from the
:class:`~repro_torch.distributed.fault.StragglerMonitor` and re-apportions
the per-step token budget (slow hosts get fewer rows; totals preserved).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.relalg import Table

# special tokens (reserved low ids)
PAD, BOT, EOT, SEP = 0, 1, 2, 3
N_SPECIAL = 4


# ---------------------------------------------------------------------------
# triple linearization
# ---------------------------------------------------------------------------

def _digits(codes: np.ndarray, radix: int, width: int) -> np.ndarray:
    """[N] int -> [N, width] base-radix digit tokens (offset by specials)."""
    out = np.empty(codes.shape + (width,), dtype=np.int32)
    c = codes.astype(np.int64)
    for i in range(width - 1, -1, -1):
        out[..., i] = c % radix
        c = c // radix
    return out + N_SPECIAL


def linearize_kg(kg: Table, vocab_size: int, seed: int = 0) -> np.ndarray:
    """KG triples -> 1-D int32 token stream (shuffled, deterministic)."""
    codes = kg.to_codes()                       # [n, 5] valid rows only
    if codes.shape[0] == 0:
        return np.array([BOT, EOT], dtype=np.int32)
    radix = max(2, vocab_size - N_SPECIAL)
    maxc = max(int(codes.max()), 1)
    width = 1
    while radix ** width <= maxc:
        width += 1
    rng = np.random.default_rng(seed)
    codes = codes[rng.permutation(codes.shape[0])]
    n = codes.shape[0]
    s = _digits(codes[:, 1], radix, width)      # subject value
    p = _digits(codes[:, 2], radix, width)      # predicate
    o = _digits(codes[:, 4], radix, width)      # object value
    sep = np.full((n, 1), SEP, np.int32)
    bot = np.full((n, 1), BOT, np.int32)
    eot = np.full((n, 1), EOT, np.int32)
    rows = np.concatenate([bot, s, sep, p, sep, o, eot], axis=1)
    return rows.reshape(-1).astype(np.int32)


# ---------------------------------------------------------------------------
# deterministic, elastic, weighted batcher
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KGTokenPipeline:
    """Deterministic cyclic batcher over a token stream.

    ``batch(step)`` -> {tokens, labels, loss_mask} of shape
    [global_batch, seq_len]; ``shard_batch(step, shard, n_shards)`` returns
    that shard's rows only (what one host materializes)."""

    stream: np.ndarray
    seq_len: int
    global_batch: int
    weights: Optional[np.ndarray] = None     # per-shard row weights

    def __post_init__(self):
        if self.stream.ndim != 1:
            raise ValueError("stream must be 1-D")
        if len(self.stream) < self.seq_len + 1:
            reps = (self.seq_len + 1) // max(len(self.stream), 1) + 1
            self.stream = np.tile(self.stream, reps)

    # -- row addressing ------------------------------------------------------
    def _row_offset(self, step: int, row: int) -> int:
        """Start position of (step, row) in the cyclic stream: rows advance
        by seq_len tokens; steps advance by global_batch rows."""
        idx = (step * self.global_batch + row) * self.seq_len
        return idx % (len(self.stream) - self.seq_len)

    def _take(self, off: int) -> np.ndarray:
        return self.stream[off:off + self.seq_len + 1]

    # -- public API -----------------------------------------------------------
    def rows_for_shard(self, shard: int, n_shards: int) -> Tuple[int, int]:
        """[start, stop) row range owned by ``shard``, after weighting."""
        if self.global_batch % n_shards:
            raise ValueError(f"global_batch {self.global_batch} "
                             f"not divisible by {n_shards} shards")
        if self.weights is None:
            per = self.global_batch // n_shards
            return shard * per, (shard + 1) * per
        w = np.asarray(self.weights, dtype=np.float64)
        if w.shape != (n_shards,):
            raise ValueError("weights shape mismatch")
        raw = w / w.sum() * self.global_batch
        counts = np.floor(raw).astype(int)
        # distribute the remainder to the largest fractional parts
        rem = self.global_batch - counts.sum()
        order = np.argsort(-(raw - counts))
        counts[order[:rem]] += 1
        starts = np.concatenate([[0], np.cumsum(counts)])
        return int(starts[shard]), int(starts[shard + 1])

    def rebalance(self, weights: Sequence[float]) -> None:
        self.weights = np.asarray(weights, dtype=np.float64)

    def shard_batch(self, step: int, shard: int, n_shards: int
                    ) -> Dict[str, np.ndarray]:
        lo, hi = self.rows_for_shard(shard, n_shards)
        rows = [self._take(self._row_offset(step, r)) for r in range(lo, hi)]
        grid = np.stack(rows) if rows else \
            np.zeros((0, self.seq_len + 1), np.int32)
        return self._to_batch(grid)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rows = [self._take(self._row_offset(step, r))
                for r in range(self.global_batch)]
        return self._to_batch(np.stack(rows))

    def _to_batch(self, grid: np.ndarray) -> Dict[str, np.ndarray]:
        tokens = grid[:, :-1].astype(np.int32)
        labels = grid[:, 1:].astype(np.int32)
        mask = (labels != PAD).astype(np.float32)
        return {"tokens": tokens, "labels": labels, "loss_mask": mask}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


# ---------------------------------------------------------------------------
# synthetic LM batches (smoke tests / dry-run stand-ins that need values)
# ---------------------------------------------------------------------------

def random_lm_batch(rng: np.random.Generator, cfg, batch: int, seq: int,
                    vit_dim: int = 1024) -> Dict[str, np.ndarray]:
    """Value-bearing batch for a reduced config (family aware)."""
    out: Dict[str, np.ndarray] = {}
    if cfg.family == "vlm":
        text = seq - cfg.n_prepend
        out["tokens"] = rng.integers(
            0, cfg.vocab_size, (batch, text)).astype(np.int32)
        out["labels"] = rng.integers(
            0, cfg.vocab_size, (batch, text)).astype(np.int32)
        out["patches"] = rng.normal(
            0, 1, (batch, cfg.n_prepend, vit_dim)).astype(np.float32)
    elif cfg.family == "encdec":
        out["tokens"] = rng.integers(
            0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        out["labels"] = rng.integers(
            0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        out["frames"] = rng.normal(
            0, 1, (batch, cfg.n_enc_frames, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(
            0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        out["labels"] = rng.integers(
            0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return out
