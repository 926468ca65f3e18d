"""Two-tier edge/cloud topology for hierarchical aggregation commits.

A population-scale fleet does not sync every adapter straight to the cloud:
clients are arranged into EDGE CELLS (SplitLLM's hierarchical split
learning), each cell partially merges its members' adapters — the members'
transfers contend inside the cell's own medium — and only the merged
summaries travel the edge<->cloud backhaul.  This module owns the TIMING
side of that story; the weight math lives in
:func:`repro.core.aggregation.hierarchical_aggregate`.

``EdgeTopology`` is a pure description (which uid belongs to which cell,
the per-cell medium capacity, the backhaul rate); ``edge_commit_legs``
prices one direction of a hierarchical commit through a ``NetworkPlane``.
Both the per-object ``FederationClock`` and the vectorized
``PopulationClock`` route through the SAME helper, so their commit
timelines agree bit-for-bit by construction.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.net.plane import NetworkPlane, shared_finish_times

__all__ = ["EdgeTopology", "edge_commit_legs"]


@dataclasses.dataclass(frozen=True)
class EdgeTopology:
    """Assignment of clients to edge cells.

    cells               cell -> tuple of member uids (a partition)
    backhaul_mbps       edge<->cloud summary link rate (per cell, dedicated)
    cell_capacity_mbps  per-cell shared-medium capacity for the members'
                        adapter syncs; None = members use their own
                        dedicated links (or the plane's cell capacity when
                        the plane itself is a shared medium)
    """
    cells: Tuple[Tuple[int, ...], ...]
    backhaul_mbps: float = 1000.0
    cell_capacity_mbps: Optional[float] = None

    def __post_init__(self):
        if not self.cells or any(not c for c in self.cells):
            raise ValueError("every edge cell needs at least one member")
        flat = [u for cell in self.cells for u in cell]
        if len(set(flat)) != len(flat):
            raise ValueError("edge cells must not share members")
        if self.backhaul_mbps <= 0:
            raise ValueError("backhaul_mbps must be > 0")
        if self.cell_capacity_mbps is not None \
                and self.cell_capacity_mbps <= 0:
            raise ValueError("cell_capacity_mbps must be > 0 when set")

    @classmethod
    def grouped(cls, n_clients: int, n_cells: int, *,
                backhaul_mbps: float = 1000.0,
                cell_capacity_mbps: Optional[float] = None) -> "EdgeTopology":
        """Contiguous block partition of ``n_clients`` uids into
        ``n_cells`` cells (the location-clustering stand-in: neighbours
        share an edge server)."""
        if not 1 <= n_cells <= n_clients:
            raise ValueError("need 1 <= n_cells <= n_clients")
        bounds = [n_clients * c // n_cells for c in range(n_cells + 1)]
        cells = tuple(tuple(range(bounds[c], bounds[c + 1]))
                      for c in range(n_cells))
        return cls(cells=cells, backhaul_mbps=backhaul_mbps,
                   cell_capacity_mbps=cell_capacity_mbps)

    @classmethod
    def kmeans(cls, coords, n_cells: int, *, seed: int = 0,
               n_iter: int = 50, backhaul_mbps: float = 1000.0,
               cell_capacity_mbps: Optional[float] = None) -> "EdgeTopology":
        """Location-based cell assignment: seeded Lloyd k-means over
        per-client planar coordinates (clients attach to the nearest edge
        server), replacing the contiguous-block stand-in.

        Fully deterministic for a given ``(coords, n_cells, seed)``:
        centroids initialize from a seeded no-replacement draw, the
        nearest-centroid assignment breaks distance ties toward the
        lowest cell index, and a cell emptied by an update is re-seeded
        with the point farthest from its assigned centroid (taken only
        from cells that keep another member, so no cell ever empties).
        Iteration stops when the assignment is stable or after
        ``n_iter`` rounds.  Memory is O(n * n_cells) for the distance
        matrix — fine for the 10^4-cell-count products this serves.
        """
        pts = np.asarray(coords, dtype=np.float64)
        if pts.ndim != 2 or pts.shape[0] < 1:
            raise ValueError("coords must be an (n, d) array")
        n = pts.shape[0]
        if not 1 <= n_cells <= n:
            raise ValueError("need 1 <= n_cells <= n_clients")
        rng = np.random.default_rng(seed)
        cent = pts[np.sort(rng.choice(n, size=n_cells, replace=False))]
        assign = np.full(n, -1)
        for _ in range(n_iter):
            d2 = ((pts[:, None, :] - cent[None, :, :]) ** 2).sum(axis=2)
            new = d2.argmin(axis=1)         # ties -> lowest cell index
            for c in range(n_cells):
                if not (new == c).any():
                    sizes = np.bincount(new, minlength=n_cells)
                    movable = sizes[new] > 1
                    far = int(np.where(movable, d2[np.arange(n), new],
                                       -1.0).argmax())
                    new[far] = c
            if (new == assign).all():
                break
            assign = new
            for c in range(n_cells):
                cent[c] = pts[assign == c].mean(axis=0)
        cells = tuple(tuple(int(u) for u in np.flatnonzero(assign == c))
                      for c in range(n_cells))
        return cls(cells=cells, backhaul_mbps=backhaul_mbps,
                   cell_capacity_mbps=cell_capacity_mbps)

    @property
    def n_cells(self) -> int:
        return len(self.cells)

    def cell_of(self) -> Dict[int, int]:
        """uid -> cell index map."""
        return {u: c for c, cell in enumerate(self.cells) for u in cell}

    def backhaul_s(self, nbytes: float) -> float:
        """One summary transfer over the edge<->cloud backhaul."""
        return float(nbytes) * 8.0 / (self.backhaul_mbps * 1e6)


def edge_commit_legs(topo: EdgeTopology, network: NetworkPlane,
                     contributors: Sequence[int], t: float,
                     bytes_fn, summary_bytes: float,
                     direction: str) -> Tuple[Dict[int, float], float]:
    """One direction of a hierarchical commit's adapter syncs.

    up:    every contributor ships its adapter to its edge (contending in
           the cell's own medium), each cell merges when its LAST member
           upload lands, then ships ONE ``summary_bytes`` summary up the
           backhaul.  Returns ``({uid: member_finish}, cloud_merge_instant)``
           — the cloud merge waits for the slowest cell summary.
    down:  the cloud ships the merged summary down every participating
           cell's backhaul at ``t``, then each edge redistributes to its
           members.  Returns ``({uid: member_finish}, last_member_finish)``.

    All member transfers start simultaneously (``t`` for up, the cell's
    summary arrival for down) — the sync-barrier case, where every
    activation transfer has already completed and the syncs only contend
    with each other inside their cell.
    """
    if direction not in ("up", "down"):
        raise KeyError(f"unknown commit leg direction {direction!r}")
    members = set(contributors)
    cap = topo.cell_capacity_mbps
    if cap is None and network.shared:
        # the plane's medium is shared; each edge cell gets its own medium
        # of the same capacity for the commit syncs
        cap = network.capacity_mbps
    links = network.uplinks if direction == "up" else network.downlinks
    fin: Dict[int, float] = {}
    barrier = t
    for cell in topo.cells:
        active = [u for u in cell if u in members]
        if not active:
            continue
        if direction == "up":
            t0 = t
        else:
            # cloud -> edge summary first, then edge -> members
            t0 = t + topo.backhaul_s(summary_bytes)
        reqs = [(u, t0, float(bytes_fn(u))) for u in active]
        if cap is not None:
            fins = shared_finish_times(cap, links, reqs)
        else:
            fins = [links[u].finish_time(t0, b) for u, t0, b in reqs]
        for u, f in zip(active, fins):
            fin[u] = f
        cell_done = max(fin[u] for u in active)
        if direction == "up":
            # edge merge at the last member upload, then one summary
            # up the backhaul
            cell_done = cell_done + topo.backhaul_s(summary_bytes)
        barrier = max(barrier, cell_done)
    return fin, barrier
