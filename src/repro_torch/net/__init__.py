"""The network plane (``repro_torch.net``): per-client wireless rate processes
and shared-medium contention, as one engine-facing subsystem.

Public API:

* :class:`LinkModel` and its processes (:class:`ConstantLink`,
  :class:`TraceLink`, :class:`GilbertElliottLink`) — each answers
  ``finish_time(t_start, nbytes)`` exactly, by integrating the
  instantaneous rate over time (see ``links.py`` for the contract);
* :class:`SharedCell` — the exact processor-sharing integrator for one
  direction of a contended cell, with version-stamped re-timing of
  in-flight transfers (see ``plane.py``);
* :class:`NetworkPlane` — the facade the engines talk to (dedicated
  finishes, cell factories, scheduling predictions, snapshot state);
* :func:`shared_finish_times` — batch contention resolution when every
  start time is known up front;
* bundled measured-style bandwidth traces (:func:`bundled_trace`).

See ``docs/architecture.md`` for where the plane sits in the data flow.
"""
from repro_torch.net.links import (BUNDLED_TRACES, ConstantLink,
                                   GilbertElliottLink, LinkModel, TraceLink,
                                   bundled_trace, bundled_trace_path)
from repro_torch.net.plane import NetworkPlane, SharedCell, shared_finish_times

__all__ = ["BUNDLED_TRACES", "ConstantLink", "GilbertElliottLink",
           "LinkModel", "NetworkPlane", "SharedCell", "TraceLink",
           "bundled_trace", "bundled_trace_path", "shared_finish_times"]
