"""Time-resolved memory ledger: who holds how many bytes, when.

The byte math is the repo's existing ``core/memory_model`` accounting —
weights + LoRA adapters + optimizer state as STATIC per-track bases, and
training activations as a TRANSIENT delta that appears while a track is
actually computing.  The ledger records activation deltas as
``(t, +bytes)`` / ``(t, -bytes)`` event pairs at the span boundaries the
DES already produces, so

  * ``peak_memory(uid)``   = client base + max running activation sum,
  * ``server_peak()``      = server base + max concurrent server stacks,
  * ``fleet_curve()``      = the paper's memory-vs-time story, and
  * ``report()``           quantifies the Table-I footprint reduction
                           against the local full-model fine-tune
                           baseline (the 79% claim) as a first-class
                           artifact.

Peaks are computed lazily with one ``lexsort`` per track: at equal
times, negative deltas sort first (an activation released at instant t
frees its bytes before the next one lands), so back-to-back rounds do
not inflate the peak.

Construction is two-layer: ``__init__`` takes raw per-uid byte arrays
(pure NumPy — the DES-level tests run without jax), and
``from_model`` computes those arrays from a ``ModelConfig`` + cut
assignment via ``core.memory_model`` (imported lazily).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["MemoryLedger", "SERVER_TRACK"]

SERVER_TRACK = -1  # ledger track id for the (single) server


class MemoryLedger:
    """Per-device / per-server byte accounting over simulated time."""

    def __init__(self, client_base, client_act, server_act,
                 server_base: float, local_baseline: float = 0.0):
        """``client_base[u]`` static bytes held by client u (weights +
        adapters + optimizer); ``client_act[u]`` transient activation
        bytes while u computes; ``server_act[u]`` transient server-side
        activation bytes while u's stack is being served;
        ``server_base`` static server bytes; ``local_baseline`` the
        local full-model fine-tune footprint the paper compares against.
        """
        self.client_base = np.asarray(client_base, dtype=np.float64)
        self.client_act = np.asarray(client_act, dtype=np.float64)
        self.server_act = np.asarray(server_act, dtype=np.float64)
        if not (len(self.client_base) == len(self.client_act)
                == len(self.server_act)):
            raise ValueError("per-client byte arrays must align")
        self.server_base = float(server_base)
        self.local_baseline = float(local_baseline)
        # track -> parallel (t, delta) event lists; SERVER_TRACK = server
        self._t: Dict[int, List[float]] = {}
        self._d: Dict[int, List[float]] = {}
        # optional cut -> (client_base, client_act, server_act) resolver,
        # installed by from_model so control-plane migrations can re-size
        # a client without the caller redoing the byte math
        self._cut_bytes = None

    @classmethod
    def from_model(cls, cfg, cuts, batch: int, seq_len: int, *,
                   dtype_bytes: int = 4) -> "MemoryLedger":
        """Byte arrays from the repo's memory model at a cut assignment."""
        from repro_torch.core.memory_model import (
            activation_bytes_training, model_bytes, optimizer_bytes)
        mb = model_bytes(cfg)
        cuts = [int(c) for c in cuts]
        n = len(cuts)
        client_base = np.empty(n)
        client_act = np.empty(n)
        server_act = np.empty(n)
        for i, cut in enumerate(cuts):
            lora_b = mb.lora_layers(0, cut)
            client_base[i] = (mb.embed + mb.layers(0, cut) + lora_b
                              + optimizer_bytes(lora_b))
            # client activations exclude the head/logits term (it lives
            # server-side), mirroring memory_model.client_memory
            full = activation_bytes_training(cfg, cut, batch, seq_len,
                                             dtype_bytes)
            head = (activation_bytes_training(cfg, 0, batch, seq_len,
                                              dtype_bytes))
            client_act[i] = full - head
            server_act[i] = activation_bytes_training(
                cfg, mb.n_layers - cut, batch, seq_len, dtype_bytes)
        # static server bytes mirror server_memory("ours"): ONE full model
        # + U stored adapter sets, one of which is in optimizer state
        lora_full = mb.lora() + mb.lora_extra
        server_base = (mb.params() + n * lora_full
                       + optimizer_bytes(lora_full))
        # local fine-tune baseline: full model + full-depth adapters +
        # optimizer + full-depth activations, all on the device
        full_lora = mb.lora()
        local = (mb.params() + full_lora + optimizer_bytes(full_lora)
                 + activation_bytes_training(cfg, mb.n_layers, batch,
                                             seq_len, dtype_bytes))
        self = cls(client_base, client_act, server_act, server_base,
                   local_baseline=local)

        def _cut_bytes(cut: int):
            lora_b = mb.lora_layers(0, cut)
            base = (mb.embed + mb.layers(0, cut) + lora_b
                    + optimizer_bytes(lora_b))
            act = (activation_bytes_training(cfg, cut, batch, seq_len,
                                             dtype_bytes)
                   - activation_bytes_training(cfg, 0, batch, seq_len,
                                               dtype_bytes))
            sact = activation_bytes_training(cfg, mb.n_layers - cut, batch,
                                             seq_len, dtype_bytes)
            return base, act, sact

        self._cut_bytes = _cut_bytes
        return self

    # ------------------------------------------------------------- recording
    def _push(self, track: int, t0: float, t1: float, nbytes: float) -> None:
        if nbytes == 0.0 or t1 <= t0:
            return
        ts = self._t.setdefault(track, [])
        ds = self._d.setdefault(track, [])
        ts.append(float(t0))
        ds.append(float(nbytes))
        ts.append(float(t1))
        ds.append(-float(nbytes))

    def client_span(self, u: int, t0: float, t1: float) -> None:
        """Client ``u`` holds its activations over ``[t0, t1]``."""
        self._push(int(u), t0, t1, float(self.client_act[int(u)]))

    def client_span_bulk(self, uids, t0, t1) -> None:
        """Vectorized ``client_span`` over aligned arrays."""
        u = np.asarray(uids, dtype=np.int64)
        a = np.asarray(t0, dtype=np.float64)
        b = np.asarray(t1, dtype=np.float64)
        act = self.client_act[u]
        for ui, ai, bi, vi in zip(u.tolist(), a.tolist(), b.tolist(),
                                  act.tolist()):
            if vi != 0.0 and bi > ai:
                ts = self._t.setdefault(ui, [])
                ds = self._d.setdefault(ui, [])
                ts.append(ai)
                ds.append(vi)
                ts.append(bi)
                ds.append(-vi)

    def server_span(self, uids, t0: float, t1: float) -> None:
        """The server holds the listed clients' stacks over ``[t0, t1]``."""
        total = float(self.server_act[np.asarray(uids, dtype=np.int64)].sum())
        self._push(SERVER_TRACK, t0, t1, total)

    def cohort_span(self, t0: float, t1: float, nbytes: float) -> None:
        """Cohort-resident adapter + optimizer bytes (population-scale
        training): the server materializes per-client slots only for the
        SAMPLED clients, from the wave start until the commit that folds
        them back into the standing global.  Priced as a transient
        server-track delta — the static ``server_base`` keeps the eager
        all-clients figure, so the gap between base and base+cohort curve
        IS the memory the cohort store saves."""
        self._push(SERVER_TRACK, t0, t1, float(nbytes))

    def set_cut(self, u: int, new_cut: int) -> None:
        """Control-plane migration moved client ``u`` to ``new_cut``:
        re-size the static base and the transient spans going FORWARD
        (past spans already carry their recorded deltas).  Only available
        on ledgers built via :meth:`from_model` (raw-array ledgers have
        no model to re-price against)."""
        if self._cut_bytes is None:
            raise RuntimeError("set_cut needs a from_model ledger")
        base, act, sact = self._cut_bytes(int(new_cut))
        u = int(u)
        self.client_base[u] = float(base)
        self.client_act[u] = float(act)
        self.server_act[u] = float(sact)

    # --------------------------------------------------------------- reading
    def _track_events(self, track: int) -> Tuple[np.ndarray, np.ndarray]:
        ts = np.asarray(self._t.get(track, ()), dtype=np.float64)
        ds = np.asarray(self._d.get(track, ()), dtype=np.float64)
        if ts.size:
            # at time ties, releases (negative deltas) land first so
            # adjacent rounds do not double-count
            order = np.lexsort((ds, ts))
            ts, ds = ts[order], ds[order]
        return ts, ds

    def peak_memory(self, uid: int) -> float:
        """Peak bytes client ``uid`` held: static base + max running
        activation sum (base alone when it never computed)."""
        _, ds = self._track_events(int(uid))
        base = float(self.client_base[int(uid)])
        if not ds.size:
            return base
        return base + float(np.cumsum(ds).max())

    def server_peak(self) -> float:
        """Peak server bytes: static base + max concurrent stacks."""
        _, ds = self._track_events(SERVER_TRACK)
        if not ds.size:
            return self.server_base
        return self.server_base + float(np.cumsum(ds).max())

    def curve(self, track: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(t, bytes)`` step curve for one track (base + running sum)."""
        ts, ds = self._track_events(int(track))
        base = (self.server_base if track == SERVER_TRACK
                else float(self.client_base[int(track)]))
        return ts, base + np.cumsum(ds)

    def fleet_curve(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(t, bytes)`` total fleet memory over time: every device's
        base plus the merged running activation sum across all tracks
        (server included)."""
        all_t = [v for v in self._t.values() for v in v]
        all_d = [v for v in self._d.values() for v in v]
        static = float(self.client_base.sum()) + self.server_base
        ts = np.asarray(all_t, dtype=np.float64)
        ds = np.asarray(all_d, dtype=np.float64)
        if not ts.size:
            return ts, ds + static
        order = np.lexsort((ds, ts))
        return ts[order], static + np.cumsum(ds[order])

    def report(self) -> dict:
        """The Table-I artifact: per-device peaks, server peak, fleet
        peak, and the reduction against local full-model fine-tuning."""
        peaks = {int(u): self.peak_memory(u)
                 for u in sorted(self._t) if u != SERVER_TRACK}
        # an idle client still holds its static base — the worst-client
        # figure covers the whole fleet, not just the tracks with events
        worst = float(self.client_base.max()) if len(self.client_base) else 0.0
        if peaks:
            worst = max(worst, max(peaks.values()))
        _, fleet = self.fleet_curve()
        out = {
            "client_peaks_bytes": peaks,
            "worst_client_peak_bytes": worst,
            "server_peak_bytes": self.server_peak(),
            "fleet_peak_bytes": float(fleet.max()) if fleet.size else
            float(self.client_base.sum()) + self.server_base,
            "local_baseline_bytes": self.local_baseline,
        }
        if self.local_baseline > 0 and worst > 0:
            out["client_reduction_vs_local"] = 1.0 - worst / self.local_baseline
        return out

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        return {
            "client_base": self.client_base.tolist(),
            "client_act": self.client_act.tolist(),
            "server_act": self.server_act.tolist(),
            "server_base": self.server_base,
            "local_baseline": self.local_baseline,
            "events": [[int(k), self._t[k], self._d[k]]
                       for k in sorted(self._t)],
        }

    def load_state_dict(self, st: dict) -> None:
        self.client_base = np.asarray(st["client_base"], dtype=np.float64)
        self.client_act = np.asarray(st["client_act"], dtype=np.float64)
        self.server_act = np.asarray(st["server_act"], dtype=np.float64)
        self.server_base = float(st["server_base"])
        self.local_baseline = float(st["local_baseline"])
        self._t = {int(k): [float(x) for x in ts]
                   for k, ts, _ in st["events"]}
        self._d = {int(k): [float(x) for x in ds]
                   for k, _, ds in st["events"]}
