"""Minimal batching loader over in-memory datasets."""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import EmotionDataset


class ClassificationLoader:
    """Shuffled epoch iterator yielding {tokens, label} dicts.

    Counter-based shuffling (epoch -> permutation seed) so the full iterator
    state is two integers — exact training resume (CheckpointManager)."""

    def __init__(self, ds: EmotionDataset, batch_size: int, seed: int = 0,
                 drop_last: bool = True):
        self.ds = ds
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        self._pos = 0
        self._order = self._perm(0)

    def _perm(self, epoch: int) -> np.ndarray:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch])).permutation(len(self.ds))

    def __len__(self):
        return len(self.ds) // self.batch_size

    def next_batch(self) -> dict:
        b = self.batch_size
        if self._pos + b > len(self._order):
            self._epoch += 1
            self._order = self._perm(self._epoch)
            self._pos = 0
        idx = self._order[self._pos:self._pos + b]
        self._pos += b
        return {"tokens": self.ds.tokens[idx], "label": self.ds.labels[idx]}

    def state(self) -> tuple:
        return (self._epoch, self._pos)

    def restore(self, state) -> None:
        self._epoch, self._pos = int(state[0]), int(state[1])
        self._order = self._perm(self._epoch)

    def all_batches(self):
        for i in range(len(self)):
            idx = np.arange(i * self.batch_size, (i + 1) * self.batch_size)
            yield {"tokens": self.ds.tokens[idx], "label": self.ds.labels[idx]}
