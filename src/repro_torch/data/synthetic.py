"""Synthetic datasets.

1. ``EmotionDataset`` — a CARER-shaped 6-class emotion corpus (paper §V).
   The real CARER set is not redistributable in this offline container
   (DESIGN.md §10); we generate short "texts" whose token statistics carry a
   learnable class signal: each class has a band of characteristic tokens
   mixed with a shared common band, plus class-specific bigram structure.

2. ``lm_stream`` — an order-2 Markov token stream with induction structure,
   a learnable next-token task for the LM-family architectures.
"""
from __future__ import annotations

import dataclasses

import numpy as np

N_CLASSES = 6
CLASS_NAMES = ("sadness", "joy", "love", "anger", "fear", "surprise")


@dataclasses.dataclass
class EmotionDataset:
    tokens: np.ndarray   # (N, seq) int32
    labels: np.ndarray   # (N,) int32

    def __len__(self):
        return len(self.labels)

    def subset(self, idx: np.ndarray) -> "EmotionDataset":
        return EmotionDataset(self.tokens[idx], self.labels[idx])


def make_emotion_dataset(n_examples: int, seq_len: int = 128,
                         vocab_size: int = 30_522, seed: int = 0,
                         class_skew: np.ndarray | None = None) -> EmotionDataset:
    """CARER-like: ~16k train examples of <=128 tokens, 6 unbalanced classes."""
    rng = np.random.default_rng(seed)
    if class_skew is None:
        # CARER's empirical class imbalance (joy/sadness dominate)
        class_skew = np.array([0.29, 0.34, 0.08, 0.14, 0.11, 0.04])
    labels = rng.choice(N_CLASSES, size=n_examples, p=class_skew / class_skew.sum())

    band = 400                      # tokens per class-specific band
    common_lo = N_CLASSES * band + 10
    common_hi = min(vocab_size, common_lo + 4000)
    tokens = np.empty((n_examples, seq_len), np.int32)
    cls_tok = 1                     # [CLS]-like id
    for c in range(N_CLASSES):
        idx = np.where(labels == c)[0]
        if idx.size == 0:
            continue
        n = idx.size
        lengths = rng.integers(8, seq_len, size=n)
        # 35% class-band tokens, rest common band
        is_class = rng.random((n, seq_len)) < 0.35
        class_band = rng.integers(10 + c * band, 10 + (c + 1) * band, size=(n, seq_len))
        common = rng.integers(common_lo, common_hi, size=(n, seq_len))
        seqs = np.where(is_class, class_band, common).astype(np.int32)
        # bigram signal: class-band tokens are followed by (t + c) mod band
        seqs[:, 1:] = np.where(is_class[:, :-1],
                               10 + c * band + (seqs[:, :-1] - 10 - c * band + c + 1) % band,
                               seqs[:, 1:])
        mask = np.arange(seq_len)[None, :] >= lengths[:, None]
        seqs[mask] = 0              # pad id
        seqs[:, 0] = cls_tok
        tokens[idx] = seqs
    return EmotionDataset(tokens=tokens, labels=labels.astype(np.int32))


def lm_stream(n_tokens: int, vocab_size: int, seed: int = 0,
              n_states: int = 64) -> np.ndarray:
    """Order-2 Markov stream over a vocab subset — learnable LM data."""
    rng = np.random.default_rng(seed)
    v = min(vocab_size, 1024)
    # sparse transition table: each (a, b) context has 4 likely successors
    succ = rng.integers(0, v, size=(n_states, n_states, 4))
    a = b = 0
    out = np.empty(n_tokens, np.int32)
    # vectorized-ish generation in chunks
    for i in range(n_tokens):
        c = succ[a % n_states, b % n_states, rng.integers(0, 4)]
        out[i] = c
        a, b = b, int(c)
    return out


def lm_batches(stream: np.ndarray, batch: int, seq: int, seed: int = 0):
    """Yield {tokens, targets} batches from a token stream forever."""
    rng = np.random.default_rng(seed)
    n = len(stream) - seq - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        toks = np.stack([stream[s:s + seq] for s in starts])
        tgts = np.stack([stream[s + 1:s + seq + 1] for s in starts])
        yield {"tokens": toks, "targets": tgts}
