"""Order statistics as the benchmark states them."""
from __future__ import annotations

import math
import time
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value that at least
    q % of the values do not exceed."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


class Clock:
    """Laps of a set-up on the host's clock, for the log line."""

    def __init__(self):
        self._t = time.perf_counter()
        self.log = ""

    def lap(self, what: str) -> None:
        t = time.perf_counter()
        self.log += f"{', ' if self.log else ''}{what} {t - self._t:.2f} s"
        self._t = t
