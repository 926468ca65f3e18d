"""Classification metrics for the CARER-style evaluation (accuracy, macro-F1)
plus wall-clock-indexed training curves.

Round-indexed curves cannot compare the sync barrier against the async
aggregation policies: a "round" is a global barrier under ``sync`` but a
per-client local notion under ``buffered``/``staleness``.  The helpers below
index everything by simulated wall-clock seconds instead — step-interpolate
ragged per-policy traces onto a common grid, smooth per-serve losses, and
read off time-to-target, so the three policies are directly comparable.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def accuracy(pred: np.ndarray, gold: np.ndarray) -> float:
    return float((pred == gold).mean())


def macro_f1(pred: np.ndarray, gold: np.ndarray, n_classes: int | None = None) -> float:
    n_classes = n_classes or int(max(pred.max(), gold.max())) + 1
    f1s = []
    for c in range(n_classes):
        tp = float(np.sum((pred == c) & (gold == c)))
        fp = float(np.sum((pred == c) & (gold != c)))
        fn = float(np.sum((pred != c) & (gold == c)))
        if tp + fp + fn == 0:
            continue
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1s.append(2 * prec * rec / (prec + rec) if prec + rec else 0.0)
    return float(np.mean(f1s)) if f1s else 0.0


# ---------------------------------------------------------------------------
# Wall-clock-indexed curves (continuous-time engine)
# ---------------------------------------------------------------------------

def wallclock_curve(events: Sequence[Tuple], t_index: int = 0,
                    v_index: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    """Sort ragged ``(time, ..., value)`` event tuples (e.g. the simulator's
    per-serve ``loss_events``) into a time-ordered (t, v) pair of arrays."""
    if not events:
        return np.empty(0), np.empty(0)
    rows = sorted(events, key=lambda e: e[t_index])
    t = np.asarray([r[t_index] for r in rows], np.float64)
    v = np.asarray([r[v_index] for r in rows], np.float64)
    return t, v


def running_mean(values: np.ndarray, window: int) -> np.ndarray:
    """Trailing mean over the last ``window`` samples (shorter at the head) —
    smooths noisy per-serve losses into a comparable trajectory.

    >>> running_mean(np.array([4.0, 2.0, 6.0, 0.0]), 2).tolist()
    [4.0, 3.0, 4.0, 3.0]
    """
    if window < 1:
        raise ValueError("window must be >= 1")
    v = np.asarray(values, np.float64)
    if v.size == 0:
        return v
    c = np.cumsum(np.insert(v, 0, 0.0))
    n = np.minimum(np.arange(1, v.size + 1), window)
    lo = np.arange(1, v.size + 1) - n
    return (c[np.arange(1, v.size + 1)] - c[lo]) / n


def step_interp(t: np.ndarray, v: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Right-continuous step interpolation: at grid point g, the most recent
    value with t_i <= g (NaN before the first sample)."""
    t, v, grid = (np.asarray(a, np.float64) for a in (t, v, grid))
    if t.size == 0:
        return np.full(grid.shape, np.nan)
    idx = np.searchsorted(t, grid, side="right") - 1
    out = np.where(idx >= 0, v[np.clip(idx, 0, v.size - 1)], np.nan)
    return out


def align_curves(curves: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 n_points: int = 200):
    """Resample every policy's (t, v) trace onto one shared wall-clock grid
    spanning the union of their time ranges.  Returns (grid, {name: values})."""
    ts = [np.asarray(t) for t, _ in curves.values() if len(t)]
    if not ts:
        return np.empty(0), {k: np.empty(0) for k in curves}
    lo = min(float(t[0]) for t in ts)
    hi = max(float(t[-1]) for t in ts)
    grid = np.linspace(lo, hi, n_points)
    return grid, {name: step_interp(t, v, grid)
                  for name, (t, v) in curves.items()}


def time_to_target(t: np.ndarray, v: np.ndarray, target: float, *,
                   smooth: int = 1, mode: str = "le") -> float:
    """First wall-clock instant at which the (optionally smoothed) curve
    reaches ``target`` — ``mode="le"`` for losses, ``"ge"`` for accuracy.
    Returns ``float("inf")`` when the target is never reached (including
    an empty curve), so callers can ``min()``/sort/compare without a None
    guard.

    >>> time_to_target(np.array([1.0, 2.0]), np.array([0.9, 0.4]), 0.5)
    2.0
    >>> time_to_target(np.array([1.0, 2.0]), np.array([0.9, 0.8]), 0.5)
    inf
    """
    t = np.asarray(t, np.float64)
    vv = running_mean(np.asarray(v, np.float64), smooth)
    if mode == "le":
        hit = np.nonzero(vv <= target)[0]
    elif mode == "ge":
        hit = np.nonzero(vv >= target)[0]
    else:
        raise KeyError(f"unknown mode {mode!r}")
    return float(t[hit[0]]) if hit.size else float("inf")


def time_weighted_mean(t: np.ndarray, v: np.ndarray, t_end: float) -> float:
    """Time-average of a right-continuous step signal: ``v[i]`` holds on
    ``[t[i], t[i+1])`` and the last value holds until ``t_end``.  Used to
    summarize control-plane trajectories (e.g. the mean assigned cut over a
    run, weighting each assignment by how long it was in force)."""
    t = np.asarray(t, np.float64)
    v = np.asarray(v, np.float64)
    if t.size == 0:
        raise ValueError("need at least one sample")
    if t_end < t[-1]:
        raise ValueError("t_end must not precede the last sample")
    edges = np.append(t, t_end)
    durs = np.diff(edges)
    total = float(durs.sum())
    if total <= 0.0:
        return float(v[-1])
    return float((durs * v).sum() / total)


def weighted_f1(pred: np.ndarray, gold: np.ndarray, n_classes: int | None = None) -> float:
    n_classes = n_classes or int(max(pred.max(), gold.max())) + 1
    total, acc = 0, 0.0
    for c in range(n_classes):
        support = int(np.sum(gold == c))
        if not support:
            continue
        tp = float(np.sum((pred == c) & (gold == c)))
        fp = float(np.sum((pred == c) & (gold != c)))
        fn = float(np.sum((pred != c) & (gold == c)))
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        acc += support * f1
        total += support
    return acc / total if total else 0.0
