"""Checkpoint manager: rotation, best-metric retention, resume.  Port of
``src/repro/checkpointing/manager.py``, rewired to the port's writer.

Used by the federated simulator (whole-fleet adapter/optimizer state).
Files are the trees of checkpoint.py.

``PeriodicSnapshotter`` layers a simulated-time snapshot cadence on top:
the Simulator calls ``maybe_save(now, state_fn)`` from the clock's tick
callback, and a snapshot is written whenever ``now`` crosses the next
``every_s`` boundary — atomically (tmp + rename, via ``checkpoint.save``)
and with bounded retention (``keep_last`` rotation).
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

from repro_torch.checkpointing.checkpoint import load, save

PyTree = Any


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3,
                 keep_best: int = 1, metric_mode: str = "max"):
        self.dir = directory
        self.keep_last = keep_last
        self.keep_best = keep_best
        self.metric_mode = metric_mode
        os.makedirs(directory, exist_ok=True)
        self._index_path = os.path.join(directory, "index.json")
        self._index = {"steps": {}, "best": []}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    # ------------------------------------------------------------------ io
    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.ckpt")

    def _flush_index(self):
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._index, f)
        os.replace(tmp, self._index_path)

    def save(self, step: int, state: PyTree,
             metric: Optional[float] = None) -> str:
        path = self._path(step)
        save(path, state)
        self._index["steps"][str(step)] = {"path": path, "metric": metric}
        self._rotate(metric, step)
        self._flush_index()
        return path

    def _rotate(self, metric: Optional[float], step: int):
        # best list
        if metric is not None:
            best = self._index["best"]
            best.append([metric, step])
            rev = self.metric_mode == "max"
            best.sort(key=lambda x: x[0], reverse=rev)
            self._index["best"] = best[: self.keep_best]
        protected = {s for _, s in self._index["best"]}
        steps = sorted(int(s) for s in self._index["steps"])
        to_keep = set(steps[-self.keep_last:]) | protected
        for s in steps:
            if s not in to_keep:
                rec = self._index["steps"].pop(str(s))
                if os.path.exists(rec["path"]):
                    os.remove(rec["path"])

    # ------------------------------------------------------------------ read
    def latest_step(self) -> Optional[int]:
        steps = [int(s) for s in self._index["steps"]]
        return max(steps) if steps else None

    def best_step(self) -> Optional[int]:
        return self._index["best"][0][1] if self._index["best"] else None

    def restore(self, step: Optional[int] = None, device="cuda") -> PyTree:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        return load(self._index["steps"][str(step)]["path"], device=device)

    def all_steps(self):
        return sorted(int(s) for s in self._index["steps"])


class PeriodicSnapshotter:
    """Periodic mid-flight snapshot policy over a :class:`CheckpointManager`.

    ``every_s`` is SIMULATED seconds (the federation clock's timeline, not
    wall time): the first snapshot lands at the first tick at or past
    ``every_s``, the next at the following multiple, and so on.  Writes are
    atomic and rotated (``keep_last``); the snapshot counter continues from
    whatever the directory already holds, so a resumed run extends the same
    snapshot series instead of clobbering it.

    Taking a snapshot is a pure read of the run state — attaching a
    snapshotter can never perturb the simulated timeline (the kill-and-
    resume tests depend on exactly this).
    """

    def __init__(self, directory: str, every_s: float, *, keep_last: int = 3):
        if every_s <= 0:
            raise ValueError("every_s must be > 0")
        self.manager = CheckpointManager(directory, keep_last=keep_last)
        self.every_s = float(every_s)
        self.next_due = float(every_s)
        self._count = self.manager.latest_step() or 0

    def due(self, now: float) -> bool:
        """True when simulated instant ``now`` has crossed the next boundary."""
        return now >= self.next_due

    def fast_forward(self, now: float) -> None:
        """Advance the cadence past ``now`` without writing — call after
        restoring a snapshot so a resumed run continues the original
        schedule instead of re-snapshotting its own resume point."""
        while self.next_due <= now:
            self.next_due += self.every_s

    def maybe_save(self, now: float, state_fn: Callable[[], PyTree]
                   ) -> Optional[str]:
        """Snapshot if due; returns the written path (or None).  ``state_fn``
        is only invoked when a snapshot is actually taken."""
        if not self.due(now):
            return None
        self._count += 1
        while self.next_due <= now:
            self.next_due += self.every_s
        return self.manager.save(self._count, state_fn())


def load_snapshot(path: str, device="cuda") -> PyTree:
    """Load a snapshot from a checkpoint FILE or a snapshot DIRECTORY (the
    directory form resolves to the latest rotated snapshot via the index)."""
    if os.path.isdir(path):
        return CheckpointManager(path).restore(device=device)
    return load(path, device=device)
