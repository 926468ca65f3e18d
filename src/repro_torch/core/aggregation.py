"""Eqs. 6-9: dataset-size-weighted FedAvg of the full LoRA adapter lists,
aggregating each A and each B matrix separately, then re-splitting at every
client's (heterogeneous) cut point.  Port of ``src/repro/core/aggregation.py``
with the async policy layer of the event engine: polynomial staleness
discounting of the Eq. 6-8 weights (:func:`staleness_weights`) and the
anchored merge of a contributor buffer into the standing global adapters
(:func:`merge_into_global`), and the two-tier edge/cloud forms of both
(:func:`hierarchical_aggregate`, :func:`anchored_hierarchical_aggregate`).

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


def staleness_discount(staleness: int, alpha: float) -> float:
    """Polynomial staleness discount ``(1 + s)^-alpha``; ``alpha = 0``
    disables discounting (the ``buffered`` policy)."""
    if staleness < 0:
        raise ValueError("staleness must be >= 0")
    if alpha < 0:
        raise ValueError("staleness_alpha must be >= 0")
    return float((1.0 + staleness) ** (-alpha))


def staleness_weights(data_sizes: Sequence[int], staleness: Sequence[int],
                      alpha: float) -> List[float]:
    """Eq. 6-8 dataset-size weights, discounted per contributor by its
    staleness and renormalized to sum to one."""
    if len(data_sizes) != len(staleness):
        raise ValueError("one staleness value per contributor required")
    raw = [float(d) * staleness_discount(s, alpha)
           for d, s in zip(data_sizes, staleness)]
    return normalize_weights(raw)


def composed_staleness_discount(client_staleness: int, edge_staleness: int,
                                alpha: float) -> float:
    """Two-tier discount ``(1+s_c)^-alpha * (1+s_e)^-alpha``: the flat
    discount is the ``s_e = 0`` case."""
    return (staleness_discount(client_staleness, alpha)
            * staleness_discount(edge_staleness, alpha))


def hierarchical_aggregate(full_loras: Sequence[PyTree],
                           weights: Sequence[float],
                           cells: Sequence[Sequence[int]]):
    """Two-tier Eq. 6-8: each edge cell partially merges its members'
    full-depth adapters with the members' data-size weights, then the cloud
    merges the edge summaries weighted by each cell's total data mass.

    ``cells`` holds member INDICES into ``full_loras`` (a partition of the
    contributors; cells with no contributing member may be omitted).  The
    two-level weighted mean telescopes to the flat Eq. 6-8 weighted mean —
    total client weight is conserved (to float tolerance, since each tier
    normalizes in float32) — which the property tests pin down.

    Returns ``(aggregated_full, edge_summaries, edge_weights)`` so callers
    can keep per-edge partials (for staleness bookkeeping or edge-local
    serving) alongside the cloud adapter.
    """
    if len(full_loras) != len(weights):
        raise ValueError("one weight per adapter tree required")
    idx_seen = [i for cell in cells for i in cell]
    if len(set(idx_seen)) != len(idx_seen):
        raise ValueError("edge cells must not share contributors")
    if set(idx_seen) != set(range(len(full_loras))):
        raise ValueError("edge cells must cover every contributor exactly "
                         "once")
    summaries, cell_masses = [], []
    for cell in cells:
        if not cell:
            continue
        cell_w = [float(weights[i]) for i in cell]
        summaries.append(aggregate_full_weighted(
            [full_loras[i] for i in cell], cell_w))
        cell_masses.append(sum(cell_w))
    agg = aggregate_full_weighted(summaries, cell_masses)
    return agg, summaries, cell_masses


def merge_into_global(global_full: PyTree, contrib_fulls: Sequence[PyTree],
                      contrib_weights: Sequence[float],
                      anchor_weight: float) -> PyTree:
    """Async commit: fold a buffer of contributor adapters into the standing
    global adapters.  ``anchor_weight`` is the data mass NOT represented in
    the buffer, so a full-cohort zero-staleness commit is exact Eq. 6-8
    FedAvg."""
    if anchor_weight < 0:
        raise ValueError("anchor_weight must be >= 0")
    if not contrib_fulls:
        raise ValueError("need at least one contribution to merge")
    return aggregate_full_weighted(
        [global_full] + list(contrib_fulls),
        [float(anchor_weight)] + [float(w) for w in contrib_weights])


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


def anchored_hierarchical_aggregate(global_full: PyTree,
                                    contrib_fulls: Sequence[PyTree],
                                    contrib_weights: Sequence[float],
                                    cells: Sequence[Sequence[int]],
                                    cell_absent_mass: Sequence[float]):
    """Two-tier anchored merge for sampled cohorts at population scale.

    Each edge cell merges its CONTRIBUTING members (indices into
    ``contrib_fulls``) with the standing global anchoring that cell's
    absent data mass, then the cloud merges the cell summaries by total
    cell mass — the O(cohort) counterpart of folding every absent client's
    (untouched == global) adapters through :func:`hierarchical_aggregate`.
    Because each absent member's tree IS the global, both tiers telescope
    to the same weighted mean; the aggregation property tests pin the
    float-tolerance equivalence and the exact degenerate cases (no absent
    mass, or no contributors at all).

    Returns ``(aggregated_full, summaries, cell_masses)`` like
    :func:`hierarchical_aggregate`; cells with neither contributors nor
    absent mass are skipped.
    """
    if len(cells) != len(cell_absent_mass):
        raise ValueError("one absent-mass entry per cell required")
    idx_seen = [i for cell in cells for i in cell]
    if len(set(idx_seen)) != len(idx_seen):
        raise ValueError("edge cells must not share contributors")
    if set(idx_seen) != set(range(len(contrib_fulls))):
        raise ValueError("edge cells must cover every contributor exactly "
                         "once")
    summaries, cell_masses = [], []
    for cell, absent in zip(cells, cell_absent_mass):
        absent = float(absent)
        if absent < 0:
            raise ValueError("cell_absent_mass must be >= 0")
        ws = [float(contrib_weights[i]) for i in cell]
        if absent > 0:
            summaries.append(aggregate_full_weighted(
                [global_full] + [contrib_fulls[i] for i in cell],
                [absent] + ws))
        elif cell:
            summaries.append(aggregate_full_weighted(
                [contrib_fulls[i] for i in cell], ws))
        else:
            continue
        cell_masses.append(absent + sum(ws))
    agg = aggregate_full_weighted(summaries, cell_masses)
    return agg, summaries, cell_masses
