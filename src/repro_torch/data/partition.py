"""Non-IID client data partitioning (paper §II: clients' datasets are
Non-IID) — label-Dirichlet allocation, the standard FL benchmark split."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float = 0.5,
                        seed: int = 0, min_per_client: int = 8) -> List[np.ndarray]:
    """Allocate example indices to clients with per-class Dirichlet weights.

    alpha -> 0: each client sees few classes (highly non-IID);
    alpha -> inf: IID.  Retries until every client has min_per_client items.
    """
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
    raise RuntimeError("could not satisfy min_per_client; lower it or raise alpha")


def iid_partition(n_examples: int, n_clients: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n_examples)
    return [np.sort(chunk) for chunk in np.array_split(idx, n_clients)]
