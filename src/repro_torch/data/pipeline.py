"""Data pipeline for personal-LLM fine-tuning (counterpart of
``repro.data.pipeline``).

The paper's setting is a small personal corpus iterated for several
epochs — what makes the activation cache pay off.
:class:`SyntheticPersonalCorpus` is a deterministic synthetic next-token
corpus with class structure (:func:`glue_like_task` sizes one as the
paper's GLUE subsets), and :class:`DataPipeline` shuffles it into
batches keyed by stable sequence ids (the activation cache's keys). Both
are numpy, drawn exactly as the reference draws them, so the two
packages see the same tokens in the same order for the same seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class SyntheticPersonalCorpus:
    """Deterministic synthetic next-token corpus with class structure."""

    vocab: int
    seq_len: int
    n_sequences: int
    n_classes: int = 4
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # class-conditional bigram rules (sparse, peaked)
        self._start = rng.integers(0, self.vocab, size=self.n_classes)
        self._shift = rng.integers(1, max(2, self.vocab // 2), size=self.n_classes)
        self._noise = 0.1
        toks = np.empty((self.n_sequences, self.seq_len), np.int32)
        cls = np.arange(self.n_sequences) % self.n_classes
        for i in range(self.n_sequences):
            c = cls[i]
            t = np.empty(self.seq_len, np.int32)
            t[0] = (self._start[c] + i) % self.vocab
            for j in range(1, self.seq_len):
                if rng.random() < self._noise:
                    t[j] = rng.integers(0, self.vocab)
                else:
                    t[j] = (t[j - 1] + self._shift[c]) % self.vocab
            toks[i] = t
        self.tokens = toks
        self.classes = cls.astype(np.int32)

    def __len__(self) -> int:
        return self.n_sequences

    def batch(self, ids: np.ndarray) -> dict:
        toks = self.tokens[ids]
        return {"seq_ids": ids.astype(np.int32), "tokens": toks[:, :-1].copy(),
                "labels": toks[:, 1:].copy()}


# the paper's GLUE subsets (approximate train sizes)
_GLUE_SIZES = {"mrpc": 3_668, "stsb": 5_749, "sst2": 67_349, "qnli": 104_743}


def glue_like_task(name: str, vocab: int, seq_len: int, scale: float = 1.0, seed: int = 0):
    """A :class:`SyntheticPersonalCorpus` of the named GLUE subset's size
    (``mrpc``, ``stsb``/``sts-b``, ``sst2``/``sst-2``, ``qnli``) times
    ``scale``, at least 8 sequences, 4 classes."""
    name = name.lower().replace("-", "")
    n = max(8, int(_GLUE_SIZES[name] * scale))
    return SyntheticPersonalCorpus(vocab, seq_len, n, n_classes=4, seed=seed)


@dataclass
class DataPipeline:
    corpus: SyntheticPersonalCorpus
    global_batch: int
    shuffle: bool = True
    seed: int = 0
    drop_remainder: bool = True

    def _order(self, epoch_idx: int) -> np.ndarray:
        n = len(self.corpus)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch_idx).shuffle(order)
        end = n - (n % self.global_batch) if self.drop_remainder else n
        return order[:end]

    def epoch(self, epoch_idx: int) -> Iterator[dict]:
        order = self._order(epoch_idx)
        for i in range(0, len(order), self.global_batch):
            yield self.corpus.batch(order[i: i + self.global_batch])

    def epoch_order(self, epoch_idx: int) -> list:
        """Per-batch sequence-id arrays of ``epoch_idx``, without building
        the token batches (the ``seq_ids`` :meth:`epoch` yields, in order)."""
        order = self._order(epoch_idx)
        return [order[i: i + self.global_batch].astype(np.int32)
                for i in range(0, len(order), self.global_batch)]

    def steps_per_epoch(self) -> int:
        return len(self.corpus) // self.global_batch

    @staticmethod
    def microbatches(batch: dict, n_micro: int) -> dict:
        """(B, ...) -> (n_micro, B/n_micro, ...) for pipelined execution
        (numpy arrays or tensors)."""

        def f(x):
            b = x.shape[0]
            if b % n_micro:
                raise ValueError(f"batch {b} not divisible by {n_micro} micro-batches")
            return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))

        return {k: f(v) for k, v in batch.items()}

    @staticmethod
    def dp_microbatches(batch: dict, n_micro: int, dp: int = 1) -> dict:
        """Micro-batch layout of the hybrid DP x PP trainer.

        (B, ...) -> (n_micro, mb, ...) with mb = B/n_micro, dim 1 split
        in contiguous chunks over ``dp`` ranks: dp rank ``r`` of micro
        ``m`` owns samples ``[m·mb + r·mb/dp, m·mb + (r+1)·mb/dp)``, the
        order the activation cache's keys follow. Raises ``ValueError``
        on indivisibility, before any compute."""
        B = next(iter(batch.values())).shape[0]
        if n_micro < 1 or dp < 1:
            raise ValueError(f"n_micro={n_micro} and dp={dp} must be >= 1")
        if B % (n_micro * dp):
            raise ValueError(
                f"global batch {B} must be divisible by n_micro×dp = "
                f"{n_micro}×{dp}; adjust --batch/--micro/--dp"
            )
        return DataPipeline.microbatches(batch, n_micro)
