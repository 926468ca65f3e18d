"""The federated cells' data, made from the seed: a CARER-shaped 6-class
emotion corpus, its non-IID split over the clients, and each client's
shuffled batches.

Copied, frozen, from the program's ``data/synthetic.py``
(``make_emotion_dataset``), ``data/partition.py`` (``dirichlet_partition``)
and ``data/loader.py`` (``ClassificationLoader``'s batch order), so that the
corpus is the benchmark's own and the reference works the program's split
and batch order out again without importing the program.
"""
from __future__ import annotations

from typing import List

import numpy as np

N_CLASSES = 6
CARER_SKEW = (0.29, 0.34, 0.08, 0.14, 0.11, 0.04)   # joy and sadness dominate


def emotion_corpus(n_examples: int, seq_len: int, vocab_size: int, seed: int):
    """(tokens (N, seq) int32, labels (N,) int32): class bands of 400 tokens
    mixed 35 % into a common band, a class bigram, lengths 8..seq-1 padded
    with 0, the first token 1 ([CLS])."""
    rng = np.random.default_rng(seed)
    skew = np.asarray(CARER_SKEW)
    labels = rng.choice(N_CLASSES, size=n_examples, p=skew / skew.sum())
    band = 400
    common_lo = N_CLASSES * band + 10
    common_hi = min(vocab_size, common_lo + 4000)
    tokens = np.empty((n_examples, seq_len), np.int32)
    for c in range(N_CLASSES):
        idx = np.where(labels == c)[0]
        if idx.size == 0:
            continue
        n = idx.size
        lengths = rng.integers(8, seq_len, size=n)
        is_class = rng.random((n, seq_len)) < 0.35
        class_band = rng.integers(10 + c * band, 10 + (c + 1) * band, size=(n, seq_len))
        common = rng.integers(common_lo, common_hi, size=(n, seq_len))
        seqs = np.where(is_class, class_band, common).astype(np.int32)
        seqs[:, 1:] = np.where(is_class[:, :-1],
                               10 + c * band + (seqs[:, :-1] - 10 - c * band + c + 1) % band,
                               seqs[:, 1:])
        seqs[np.arange(seq_len)[None, :] >= lengths[:, None]] = 0
        seqs[:, 0] = 1
        tokens[idx] = seqs
    return tokens, labels.astype(np.int32)


def dirichlet_split(labels: np.ndarray, n_clients: int, alpha: float, seed: int,
                    min_per_client: int = 8) -> List[np.ndarray]:
    """Each class's examples split over the clients by Dirichlet(alpha)
    shares, drawn again until every client holds ``min_per_client``."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    for _ in range(100):
        parts: List[list] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet([alpha] * n_clients)
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for client, chunk in enumerate(np.split(idx, cuts)):
                parts[client].extend(chunk.tolist())
        if min(len(p) for p in parts) >= min_per_client:
            return [np.array(sorted(p), np.int64) for p in parts]
    raise RuntimeError("no split gave every client min_per_client examples")


def batch_rows(n_examples: int, batch: int, seed: int, n_batches: int) -> List[np.ndarray]:
    """The first ``n_batches`` batches' row indices of a client's loader:
    a permutation per epoch (seeded by (seed, epoch)), whole batches only."""
    out, epoch, pos = [], 0, 0
    order = np.random.default_rng(np.random.SeedSequence([seed, 0])).permutation(n_examples)
    for _ in range(n_batches):
        if pos + batch > len(order):
            epoch += 1
            order = np.random.default_rng(
                np.random.SeedSequence([seed, epoch])).permutation(n_examples)
            pos = 0
        out.append(order[pos:pos + batch])
        pos += batch
    return out
