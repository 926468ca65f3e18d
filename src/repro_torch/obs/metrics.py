"""Counters / gauges / histograms for the federation hot paths.

A registry is a flat dict keyed by ``name`` or ``name|k=v,k=v`` (labels
sorted, so any call order lands on the same series).  Histograms keep
only ``(count, sum, min, max)`` — O(1) per observation, and
``observe_bulk`` folds a whole NumPy array in four reductions so the
vectorized population kernels pay a handful of ufunc calls per round
regardless of fleet size (the bench_population 1.5x criterion).

Everything is JSON-able: ``summary()`` is the dict that
``benchmarks/run.py`` stamps into artifacts; ``state_dict`` /
``load_state_dict`` round-trip through the simulator snapshot.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = ["MetricsRegistry"]


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    return name + "|" + ",".join(f"{k}={labels[k]}" for k in sorted(labels))


class MetricsRegistry:
    """Flat, label-aware metrics store (counters, gauges, histograms)."""

    def __init__(self):
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        # name -> [count, sum, min, max]
        self._hists: Dict[str, List[float]] = {}

    # ------------------------------------------------------------- recording
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        """Add ``value`` to a monotonic counter."""
        k = _key(name, labels)
        self._counters[k] = self._counters.get(k, 0.0) + float(value)

    def gauge(self, name: str, value: float, **labels) -> None:
        """Set a last-value-wins gauge."""
        self._gauges[_key(name, labels)] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        """Fold one sample into a (count, sum, min, max) histogram."""
        v = float(value)
        h = self._hists.get(_key(name, labels))
        if h is None:
            self._hists[_key(name, labels)] = [1.0, v, v, v]
        else:
            h[0] += 1.0
            h[1] += v
            h[2] = min(h[2], v)
            h[3] = max(h[3], v)

    def observe_bulk(self, name: str, values, **labels) -> None:
        """Fold a whole array of samples in O(1) registry ops (the
        vectorized-kernel path — four NumPy reductions, no Python loop)."""
        v = np.asarray(values, dtype=np.float64)
        if v.size == 0:
            return
        h = self._hists.get(_key(name, labels))
        if h is None:
            self._hists[_key(name, labels)] = [float(v.size), float(v.sum()),
                                               float(v.min()), float(v.max())]
        else:
            h[0] += float(v.size)
            h[1] += float(v.sum())
            h[2] = min(h[2], float(v.min()))
            h[3] = max(h[3], float(v.max()))

    # --------------------------------------------------------------- reading
    def counter_value(self, name: str, **labels) -> float:
        return self._counters.get(_key(name, labels), 0.0)

    def gauge_value(self, name: str, **labels) -> float:
        return self._gauges.get(_key(name, labels), float("nan"))

    def hist_stats(self, name: str, **labels) -> dict:
        h = self._hists.get(_key(name, labels))
        if h is None:
            return {"count": 0, "sum": 0.0}
        return {"count": int(h[0]), "sum": h[1], "mean": h[1] / h[0],
                "min": h[2], "max": h[3]}

    def summary(self) -> dict:
        """JSON-able snapshot: every series, keys sorted."""
        return {
            "counters": {k: self._counters[k]
                         for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k] for k in sorted(self._gauges)},
            "histograms": {k: {"count": int(h[0]), "sum": h[1],
                               "mean": h[1] / h[0], "min": h[2], "max": h[3]}
                           for k, h in sorted(self._hists.items())},
        }

    def to_json(self) -> str:
        import json
        return json.dumps(self.summary(), sort_keys=True)

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        return {"counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "hists": {k: list(h) for k, h in self._hists.items()}}

    def load_state_dict(self, st: dict) -> None:
        self._counters = {str(k): float(v)
                          for k, v in st["counters"].items()}
        self._gauges = {str(k): float(v) for k, v in st["gauges"].items()}
        self._hists = {str(k): [float(x) for x in h]
                       for k, h in st["hists"].items()}
