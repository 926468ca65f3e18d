"""Unified observability plane: span tracer + metrics registry + memory
ledger, zero-overhead when disabled.

``Observability`` is the bundle the engines carry; the recorders in
``repro_torch.obs.des`` turn finished DES results into spans/metrics/ledger
entries without touching the engines' arithmetic.  See
docs/observability.md for the span taxonomy and the ledger -> Table I
mapping.
"""
from repro_torch.obs.des import (Observability, record_async_bulk,
                                 record_commit, record_round_arrays,
                                 record_sync_wave)
from repro_torch.obs.ledger import SERVER_TRACK, MemoryLedger
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import TRACK_PIDS, Span, Tracer

__all__ = ["MemoryLedger", "MetricsRegistry", "Observability",
           "SERVER_TRACK", "Span", "TRACK_PIDS", "Tracer",
           "record_async_bulk", "record_commit", "record_round_arrays",
           "record_sync_wave"]
