"""Eqs. 6-9: dataset-size-weighted FedAvg of the full LoRA adapter lists,
aggregating each A and each B matrix separately, then re-splitting at every
client's (heterogeneous) cut point.  Port of the synchronous part of
``src/repro/core/aggregation.py``; the staleness-discounted, anchored and
hierarchical forms come with the async and population slices (ROADMAP
Queue A, items 8 and 9).

The weighted sum keeps the reference's operand order: it starts from the
first client's weighted leaf and adds the others in client order, in f32.
"""
from __future__ import annotations

from typing import Any, List, Sequence

from repro_torch.core import lora as lora_lib
from repro_torch.tree import tree_map

PyTree = Any


def normalize_weights(weights: Sequence[float]) -> List[float]:
    ws = [float(w) for w in weights]
    if any(w < 0 for w in ws):
        raise ValueError("aggregation weights must be non-negative")
    total = sum(ws)
    if total <= 0.0:
        raise ValueError("aggregation weights must sum to > 0")
    return [w / total for w in ws]


def aggregate_full_weighted(full_loras: Sequence[PyTree],
                            weights: Sequence[float]) -> PyTree:
    """Leaf-wise convex combination of same-structure full adapter trees
    with explicit (not necessarily normalized) non-negative weights."""
    if len(full_loras) != len(weights):
        raise ValueError("one weight per adapter tree required")
    ws = normalize_weights(weights)

    def wsum(*leaves):
        acc = ws[0] * leaves[0].float()
        for w, leaf in zip(ws[1:], leaves[1:]):
            acc = acc + w * leaf.float()
        return acc.to(leaves[0].dtype)

    return tree_map(wsum, *full_loras)


def aggregate_full(full_loras: Sequence[PyTree], data_sizes: Sequence[int]) -> PyTree:
    """Eqs. 6-7: A_n = sum_u |D_u|/|D| * A_n^u ; B_n likewise (separately)."""
    if len(full_loras) != len(data_sizes):
        raise ValueError("one data size per client required")
    return aggregate_full_weighted(full_loras, [float(d) for d in data_sizes])


def aggregation_round(client_loras: Sequence[PyTree],
                      server_loras: Sequence[PyTree],
                      cuts: Sequence[int],
                      data_sizes: Sequence[int]):
    """One full aggregation phase (Alg. 1 lines 17-30).

    1. assemble R_f^u = {R_c^u, R_s^u}           (Eq. 5)
    2. aggregate A_n / B_n separately            (Eqs. 6-8)
    3. re-split at each client's own cut point   (Eq. 9)

    Returns (new_client_loras, new_server_loras, aggregated_full).
    """
    fulls = [lora_lib.assemble_full(c, s, k)
             for c, s, k in zip(client_loras, server_loras, cuts)]
    agg = aggregate_full(fulls, data_sizes)
    new_clients, new_servers = [], []
    for cut in cuts:
        c, s = lora_lib.split_lora(agg, cut)
        new_clients.append(c)
        new_servers.append(s)
    return new_clients, new_servers, agg
