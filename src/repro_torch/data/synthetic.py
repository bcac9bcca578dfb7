"""Deterministic synthetic LM data + packed-corpus pipeline (copy of
``repro.data.synthetic``; numpy only, so batches are byte-identical).

Production posture:
  * fully deterministic given (seed, step) — a restored checkpoint resumes
    the exact token stream (the iterator state is just the step counter);
  * host-sharded: each process materializes only its slice of the global
    batch (``process_index/process_count``);
  * layout-aware: applies the zigzag permutation the SP attention layer
    expects, and emits the matching ``positions`` array;
  * ``PackedDataset`` packs variable-length documents from a token corpus
    into fixed-length rows with proper next-token labels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.zigzag import zigzag_device_order

__all__ = ["SyntheticConfig", "SyntheticDataset", "PackedDataset", "apply_layout"]


def apply_layout(tokens, labels, seq_len: int, sp_degree: int, layout: str):
    """Permute (tokens, labels) to the SP layout; return (tokens, labels, positions)."""
    positions = np.arange(seq_len, dtype=np.int32)
    if layout == "zigzag" and sp_degree > 1 and seq_len % (2 * sp_degree) == 0:
        order = zigzag_device_order(sp_degree)
        C = seq_len // (2 * sp_degree)
        idx = np.concatenate([np.arange(c * C, (c + 1) * C) for c in order])
        tokens = tokens[:, idx]
        labels = labels[:, idx]
        positions = positions[idx]
    positions = np.broadcast_to(positions[None], tokens.shape).copy()
    return tokens, labels, positions


@dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    layout: str = "contig"
    sp_degree: int = 1


class SyntheticDataset:
    """Zipf-distributed random tokens with a learnable bigram structure.

    The "structure" (token t+1 correlated with token t) gives optimizers a
    learnable signal so convergence tests are meaningful, not just noise.
    """

    def __init__(self, cfg: SyntheticConfig, process_index: int = 0, process_count: int = 1):
        assert cfg.global_batch % process_count == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // process_count
        self.process_index = process_index
        self.step = 0

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, state):
        self.step = int(state["step"])

    def _rng(self, step):
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 97 + self.process_index
        )

    def __iter__(self):
        return self

    def __next__(self):
        cfg = self.cfg
        rng = self._rng(self.step)
        self.step += 1
        B, S, V = self.local_batch, cfg.seq_len, cfg.vocab_size
        # zipf-ish marginal + deterministic bigram drift
        base = rng.zipf(1.3, size=(B, S + 1)) % V
        shift = (np.arange(S + 1)[None, :] * 7) % 13
        seq = ((base + shift) % V).astype(np.int32)
        tokens, labels = seq[:, :-1], seq[:, 1:]
        tokens, labels, positions = apply_layout(
            tokens, labels, S, cfg.sp_degree, cfg.layout
        )
        return {
            "tokens": tokens,
            "labels": labels,
            "positions": positions,
        }


class PackedDataset:
    """Pack a flat token corpus (np.int32 array with EOS separators) into
    fixed-length training rows, deterministic and host-sharded."""

    def __init__(
        self,
        corpus: np.ndarray,
        *,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        layout: str = "contig",
        sp_degree: int = 1,
        process_index: int = 0,
        process_count: int = 1,
    ):
        assert global_batch % process_count == 0
        self.corpus = np.asarray(corpus, np.int32)
        self.seq_len = seq_len
        self.local_batch = global_batch // process_count
        self.global_batch = global_batch
        self.seed = seed
        self.layout = layout
        self.sp_degree = sp_degree
        self.process_index = process_index
        self.step = 0
        n_rows = (len(self.corpus) - 1) // seq_len
        self.n_rows = n_rows
        order_rng = np.random.default_rng(seed)
        self.row_order = order_rng.permutation(n_rows)

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, state):
        self.step = int(state["step"])

    def __iter__(self):
        return self

    def __next__(self):
        S = self.seq_len
        rows = []
        for i in range(self.local_batch):
            global_row = (
                self.step * self.global_batch
                + self.process_index * self.local_batch
                + i
            ) % self.n_rows
            r = self.row_order[global_row]
            rows.append(self.corpus[r * S : r * S + S + 1])
        self.step += 1
        seq = np.stack(rows)
        tokens, labels = seq[:, :-1], seq[:, 1:]
        tokens, labels, positions = apply_layout(
            tokens, labels, S, self.sp_degree, self.layout
        )
        return {"tokens": tokens, "labels": labels, "positions": positions}
