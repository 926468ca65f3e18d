"""The adaptive control plane (``repro_torch.control``): the setup-phase cut
assignment (``core.partition``) made LIVE.

At every aggregation commit boundary the loop samples per-client telemetry
(:class:`TelemetryStore` — EWMA link rates from the network plane,
realized serve spans, mutable memory budgets), asks a :class:`Controller`
policy whether this is a moment to re-solve (``static`` never /
``periodic`` every K commits / ``reactive`` hysteresis + hard memory
triggers), re-solves the (cut, rank, batch) assignment on the live-rate
Eq. 10-12 makespan (:func:`solve_assignment`), prices the migration
through the live links, and applies accepted changes in place
(:class:`ControlLoop`).  See ``docs/architecture.md`` for the data flow
and ``docs/paper_map.md`` for the paper-equation mapping.
"""
from repro_torch.control.controller import (CONTROLLERS, Controller,
                                            PeriodicController, ReactiveController,
                                            StaticController, make_controller)
from repro_torch.control.loop import ControlLoop, ReassignEvent
from repro_torch.control.solver import (Assignment, predicted_span, predicted_times,
                                        solve_assignment)
from repro_torch.control.telemetry import ClientSample, TelemetryStore

__all__ = ["Assignment", "CONTROLLERS", "ClientSample", "ControlLoop",
           "Controller", "PeriodicController", "ReactiveController",
           "ReassignEvent", "StaticController", "TelemetryStore",
           "make_controller", "predicted_span", "predicted_times",
           "solve_assignment"]
