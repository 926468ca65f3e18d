"""Grouped run configuration for the federated simulator.

Five PRs of accreted knobs left the original ``FedRunConfig`` a flat
25-field struct validated by one hand-written cross-product matrix.  This
module regroups the knobs by OWNING SUBSYSTEM:

    EngineConfig    server engine + round clock       (fed/engine.py)
    AggConfig       aggregation policy + transport    (core/aggregation.py)
    NetConfig       network plane                     (repro/net)
    ControlConfig   adaptive control plane            (repro/control)
    FleetConfig     fleet size, cohort sampling,      (fed/population.py,
                    edge topology, stragglers          fed/fleet.py)
    ObsConfig       tracing + metrics + memory ledger (repro/obs)

Each group owns its intra-group knob rules in ``validate()``;
:func:`validate_run_config` keeps only the genuinely CROSS-group matrix
(engine mode x aggregation policy, engine mode x link dynamics, ...).

``FedRunConfig`` composes the groups.  Every pre-existing flat keyword
still constructs (``FedRunConfig(engine="event", agg_policy="buffered")``)
and every pre-existing flat attribute still reads/writes
(``run.agg_policy``), but both emit ``DeprecationWarning`` and route into
the owning group — the grouped form is the API:

    FedRunConfig(engine=EngineConfig(mode="event"),
                 agg=AggConfig(policy="buffered", interval=1),
                 fleet=FleetConfig(sampling="pareto", rate=0.25))
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Tuple

from repro_torch.core.scheduling import ONLINE_DISCIPLINES, SCHEDULERS

__all__ = ["AggConfig", "ControlConfig", "EngineConfig", "FedRunConfig",
           "FleetConfig", "LINK_MODELS", "NetConfig", "ObsConfig",
           "SAMPLING_POLICIES", "validate_run_config"]

# mirrored from fed.engine.AGG_POLICIES / control.CONTROLLERS to keep this
# module import-light (no engine/control import at config time)
AGG_POLICIES = ("sync", "buffered", "staleness")
CONTROLLERS = ("static", "periodic", "reactive")
LINK_MODELS = ("constant", "trace", "gilbert", "custom")
SAMPLING_POLICIES = ("full", "uniform", "pareto")


def _deprecated(msg: str) -> None:
    warnings.warn(msg, DeprecationWarning, stacklevel=3)


# ===========================================================================
# Sub-configs, one per owning subsystem
# ===========================================================================

@dataclasses.dataclass(frozen=True, eq=False)
class EngineConfig:
    """Server engine + round clock knobs (fed/engine.py)."""
    mode: str = "analytic"              # analytic (Eq. 10-12) | event (DES)
    scheduler: str = "ours"             # ours | fifo | wf | bw | optimal
    cohort_chunk: int = 1               # clients per batched server dispatch
    chunk_efficiency: float = 1.0       # k>1 chunk cost vs summed sequential
    slots: int = 1                      # concurrent server executors
    deadline: Optional[float] = None    # per-round straggler cut (event only)
    cohort_impl: str = "vmap"           # vmap (padded, traced cuts) | ragged
                                        # (cut-grouped concat, static cuts)
    fused_lora: bool = False            # route adapted projections through
                                        # the Pallas kernels (LoRAConfig.impl
                                        # thread; replaces set_fused_lora)

    def validate(self) -> None:
        if self.mode not in ("analytic", "event"):
            raise KeyError(f"unknown engine {self.mode!r}")
        if self.scheduler not in SCHEDULERS:
            raise KeyError(f"unknown scheduling policy {self.scheduler!r}")
        if self.cohort_impl not in ("vmap", "ragged"):
            raise KeyError(f"unknown cohort impl {self.cohort_impl!r}")
        if self.cohort_chunk < 1 or self.slots < 1:
            raise ValueError("cohort_chunk and server_slots must be >= 1")
        if not 0.0 < self.chunk_efficiency <= 1.0:
            raise ValueError("chunk_efficiency must be in (0, 1]")
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError("round_deadline must be > 0 when set")
        if self.mode == "analytic" and (self.chunk_efficiency != 1.0
                                        or self.slots != 1
                                        or self.deadline is not None):
            raise ValueError("chunk_efficiency / server_slots / "
                             "round_deadline model the event-driven round "
                             "clock; set engine mode='event' to use them")

    def __eq__(self, other):
        # legacy shim: ``run.engine`` used to be the mode STRING; comparing
        # the group against a string compares the mode (with a warning)
        # instead of silently returning False.
        if isinstance(other, str):
            _deprecated("comparing EngineConfig to a string compares "
                        "engine.mode; read run.engine.mode instead")
            return self.mode == other
        if isinstance(other, EngineConfig):
            return dataclasses.astuple(self) == dataclasses.astuple(other)
        return NotImplemented


@dataclasses.dataclass(frozen=True, eq=True)
class AggConfig:
    """Aggregation policy + transport knobs (core/aggregation.py, engine)."""
    policy: str = "sync"                # sync | buffered | staleness
    interval: int = 5                   # sync: commit every I barriers
    buffer_k: Optional[int] = None      # async commit threshold
    max_inflight: int = 1               # async: rounds past the last commit
    staleness_alpha: Optional[float] = None  # (1+s)^-alpha exponent
    transport: str = "nominal"          # nominal | plane

    def validate(self) -> None:
        if self.policy not in AGG_POLICIES:
            raise KeyError(f"unknown aggregation policy {self.policy!r}")
        if self.transport not in ("nominal", "plane"):
            raise KeyError(f"unknown aggregation transport "
                           f"{self.transport!r}")
        if self.interval < 1:
            raise ValueError("agg_interval must be >= 1")
        if self.max_inflight < 1:
            raise ValueError("max_inflight_rounds must be >= 1")
        if self.staleness_alpha is not None and self.staleness_alpha < 0:
            raise ValueError("staleness_alpha must be >= 0")
        if self.buffer_k is not None and self.buffer_k < 1:
            raise ValueError("agg_buffer_k must be >= 1 when set")
        if self.policy != "staleness" and self.staleness_alpha is not None:
            raise ValueError("staleness_alpha is only read by "
                             "agg_policy='staleness'")
        if self.policy == "sync":
            if self.buffer_k is not None:
                raise ValueError("agg_buffer_k is the ASYNC commit "
                                 "threshold; sync commits every "
                                 "agg_interval barriers")
            if self.max_inflight != 1:
                raise ValueError("sync aggregation is a barrier: "
                                 "max_inflight_rounds must be 1")
        elif self.interval != 1:
            raise ValueError("async commit cadence is agg_buffer_k uploads, "
                             "not rounds; set agg_interval=1 (the sync-only "
                             "knob would be silently ignored otherwise)")


@dataclasses.dataclass(frozen=True, eq=True)
class NetConfig:
    """Network-plane knobs (repro/net)."""
    link_model: str = "constant"        # constant | trace | gilbert | custom
    traces: Optional[Sequence] = None   # per-client traces / CSV paths
    shared: bool = False                # concurrent transfers split a cell
    capacity_mbps: Optional[float] = None   # cell capacity per direction
    quantize: bool = False              # int8+EF on the wireless links

    def validate(self) -> None:
        if self.link_model not in LINK_MODELS:
            raise KeyError(f"unknown link model {self.link_model!r}")
        if (self.link_model == "trace") != (self.traces is not None):
            raise ValueError("link_traces and link_model='trace' go "
                             "together: traces drive exactly that model")
        if self.shared:
            if self.capacity_mbps is None or self.capacity_mbps <= 0:
                raise ValueError("shared_medium needs "
                                 "medium_capacity_mbps > 0")
        elif self.capacity_mbps is not None:
            raise ValueError("medium_capacity_mbps is only read with "
                             "shared_medium=True")


@dataclasses.dataclass(frozen=True, eq=True)
class ControlConfig:
    """Adaptive control-plane knobs (repro/control)."""
    policy: str = "static"              # static | periodic | reactive
    resolve_every: int = 1              # periodic-only: commits per re-solve
    hysteresis: Optional[float] = None  # reactive-only band

    def validate(self) -> None:
        if self.policy not in CONTROLLERS:
            raise KeyError(f"unknown controller {self.policy!r}")
        if self.resolve_every < 1:
            raise ValueError("resolve_every must be >= 1")
        if self.policy != "periodic" and self.resolve_every != 1:
            raise ValueError("resolve_every is the PERIODIC controller's "
                             "cadence; other controllers would silently "
                             "ignore it")
        if self.hysteresis is not None:
            if self.policy != "reactive":
                raise ValueError("hysteresis is only read by "
                                 "controller='reactive'")
            if self.hysteresis <= 0:
                raise ValueError("hysteresis must be > 0 when set")


@dataclasses.dataclass(frozen=True, eq=True)
class FleetConfig:
    """Fleet shape: size, per-round cohort sampling, edge topology, and
    straggler behavior (fed/population.py, fed/fleet.py).

    ``sampling`` replaces the old scalar ``participation`` fraction with a
    POLICY: "full" enumerates every client, "uniform" samples
    ``round(rate * n)`` clients uniformly (the legacy behavior), "pareto"
    biases the same-size draw toward high-capability clients with
    rank-Pareto weights (Jung et al. 2024) so a population-scale fleet
    serves bounded, convergence-efficient cohorts.

    ``edge_cells > 1`` arranges the fleet into a two-tier topology: each
    edge cell partially merges its members' adapters (through its own
    shared cell under plane-routed transport) and the cloud merges the
    edge summaries.  ``cell_assignment`` picks how clients map to cells:
    "blocks" partitions uids into contiguous ranges (the synthetic
    stand-in), "kmeans" clusters per-client coordinates
    (``EdgeTopology.kmeans``; needs a fleet that carries coords, e.g.
    ``FleetSpec.population()``).
    """
    size: Optional[int] = None          # expected fleet size (None = infer)
    sampling: str = "full"              # full | uniform | pareto
    rate: float = 1.0                   # cohort fraction for uniform/pareto
    pareto_alpha: float = 1.16          # rank-bias exponent (pareto only)
    edge_cells: int = 1                 # >1 = two-tier edge/cloud topology
    cell_assignment: str = "blocks"     # blocks | kmeans (client->cell map)
    edge_capacity_mbps: Optional[float] = None  # per-edge cell capacity
    backhaul_mbps: float = 1000.0       # edge<->cloud summary link rate
    population_threshold: int = 4096    # SoA vectorized path at/above this
    straggler_prob: float = 0.0         # per-client chance of a slow round
    straggler_slowdown: float = 3.0     # compute slowdown when straggling

    def validate(self) -> None:
        if self.sampling not in SAMPLING_POLICIES:
            raise KeyError(f"unknown sampling policy {self.sampling!r}")
        if not 0.0 < self.rate <= 1.0:
            raise ValueError("participation rate must be in (0, 1]")
        if self.sampling == "full" and self.rate != 1.0:
            raise ValueError("sampling='full' enumerates every client; a "
                             "partial rate needs sampling='uniform' or "
                             "'pareto'")
        if self.pareto_alpha <= 0:
            raise ValueError("pareto_alpha must be > 0")
        if self.size is not None and self.size < 1:
            raise ValueError("fleet size must be >= 1 when set")
        if self.edge_cells < 1:
            raise ValueError("edge_cells must be >= 1")
        if self.cell_assignment not in ("blocks", "kmeans"):
            raise KeyError(f"unknown cell assignment "
                           f"{self.cell_assignment!r}")
        if self.cell_assignment != "blocks" and self.edge_cells < 2:
            raise ValueError("cell_assignment is only read with "
                             "edge_cells > 1")
        if self.edge_capacity_mbps is not None:
            if self.edge_cells < 2:
                raise ValueError("edge_capacity_mbps is only read with "
                                 "edge_cells > 1")
            if self.edge_capacity_mbps <= 0:
                raise ValueError("edge_capacity_mbps must be > 0 when set")
        if self.backhaul_mbps <= 0:
            raise ValueError("backhaul_mbps must be > 0")
        if self.population_threshold < 1:
            raise ValueError("population_threshold must be >= 1")
        if not 0.0 <= self.straggler_prob <= 1.0:
            raise ValueError("straggler_prob must be in [0, 1]")
        if self.straggler_slowdown < 1.0:
            raise ValueError("straggler_slowdown must be >= 1")


@dataclasses.dataclass(frozen=True, eq=True)
class ObsConfig:
    """Observability-plane knobs (repro/obs): span tracing, metrics,
    and the time-resolved memory ledger.  All sinks default OFF — a run
    with the default ``ObsConfig`` carries no observability state and
    pays zero overhead on the hot paths."""
    trace: bool = False                 # record spans (Perfetto export)
    metrics: bool = False               # counters/gauges/histograms
    memory_ledger: bool = False         # time-resolved byte accounting
    trace_dir: Optional[str] = None     # write trace JSON here at run end
    max_events: Optional[int] = None    # span ring-buffer bound

    @property
    def enabled(self) -> bool:
        return self.trace or self.metrics or self.memory_ledger

    def validate(self) -> None:
        if self.trace_dir is not None and not self.trace:
            raise ValueError("trace_dir is where the span tracer writes "
                             "its export; set obs trace=True to record one")
        if self.max_events is not None:
            if not self.trace:
                raise ValueError("max_events bounds the span ring buffer; "
                                 "set obs trace=True to record spans")
            if self.max_events < 1:
                raise ValueError("max_events must be >= 1 when set")


# ===========================================================================
# FedRunConfig: the composed run config + flat-kwarg compatibility shims
# ===========================================================================

# legacy flat kwarg/attribute -> (group field, attribute inside the group)
_FLAT_SHIMS = {
    "scheduler": ("engine", "scheduler"),
    "cohort_chunk": ("engine", "cohort_chunk"),
    "chunk_efficiency": ("engine", "chunk_efficiency"),
    "server_slots": ("engine", "slots"),
    "round_deadline": ("engine", "deadline"),
    "agg_policy": ("agg", "policy"),
    "agg_interval": ("agg", "interval"),
    "agg_buffer_k": ("agg", "buffer_k"),
    "max_inflight_rounds": ("agg", "max_inflight"),
    "staleness_alpha": ("agg", "staleness_alpha"),
    "agg_transport": ("agg", "transport"),
    "link_model": ("net", "link_model"),
    "link_traces": ("net", "traces"),
    "shared_medium": ("net", "shared"),
    "medium_capacity_mbps": ("net", "capacity_mbps"),
    "quantize_activations": ("net", "quantize"),
    "controller": ("control", "policy"),
    "resolve_every": ("control", "resolve_every"),
    "hysteresis": ("control", "hysteresis"),
    "straggler_prob": ("fleet", "straggler_prob"),
    "straggler_slowdown": ("fleet", "straggler_slowdown"),
}


@dataclasses.dataclass(init=False)
class FedRunConfig:
    """One federated run: training knobs at the top level, subsystem knobs
    grouped by owner (see the module docstring for the map).  Legacy flat
    kwargs and attributes still work with a ``DeprecationWarning``."""
    # -- training / run-level knobs ------------------------------------------
    scheme: str = "ours"            # ours | sfl | sl
    rounds: int = 50
    batch_size: int = 16
    seq_len: int = 128
    lr: float = 1e-5
    alpha: float = 0.5              # dirichlet non-IID concentration
    seed: int = 0
    eval_every: int = 5             # sync: barrier rounds; async: commits
    target_accuracy: Optional[float] = None
    # -- mid-flight checkpoint / resume (docs/checkpointing.md) --------------
    snapshot_every: Optional[float] = None
    snapshot_dir: Optional[str] = None
    resume_from: Optional[str] = None
    preempt_at: Optional[float] = None
    # -- subsystem groups ----------------------------------------------------
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    agg: AggConfig = dataclasses.field(default_factory=AggConfig)
    net: NetConfig = dataclasses.field(default_factory=NetConfig)
    control: ControlConfig = dataclasses.field(default_factory=ControlConfig)
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)

    def __init__(self, **kwargs):
        cls = type(self)
        fields = {f.name: f for f in dataclasses.fields(cls)}
        # defaults first
        for f in fields.values():
            if f.default is not dataclasses.MISSING:
                object.__setattr__(self, f.name, f.default)
            else:
                object.__setattr__(self, f.name, f.default_factory())
        flats = {}
        for name, val in kwargs.items():
            if name == "engine" and isinstance(val, str):
                # legacy FedRunConfig(engine="event")
                _deprecated("FedRunConfig(engine=<str>) is deprecated; pass "
                            "engine=EngineConfig(mode=...)")
                flats["__engine_mode"] = val
            elif name in fields:
                setattr(self, name, val)
            elif name in _FLAT_SHIMS or name == "participation":
                _deprecated(f"flat FedRunConfig kwarg {name!r} is "
                            f"deprecated; use the grouped sub-configs")
                flats[name] = val
            else:
                raise TypeError(f"unknown FedRunConfig kwarg {name!r}")
        # route legacy flat kwargs into their owning groups
        if "__engine_mode" in flats:
            self.engine = dataclasses.replace(
                self.engine, mode=flats.pop("__engine_mode"))
        if "participation" in flats:
            self.participation = flats.pop("participation")  # property shim
        for name, val in flats.items():
            group, attr = _FLAT_SHIMS[name]
            setattr(self, group,
                    dataclasses.replace(getattr(self, group), **{attr: val}))

    # -- legacy scalar participation <-> sampling-policy bridge --------------
    @property
    def participation(self) -> float:
        _deprecated("run.participation is deprecated; read "
                    "run.fleet.sampling / run.fleet.rate")
        return self.fleet.rate if self.fleet.sampling != "full" else 1.0

    @participation.setter
    def participation(self, value: float) -> None:
        value = float(value)
        if not 0.0 < value <= 1.0:
            raise ValueError("participation must be in (0, 1]")
        if value >= 1.0:
            self.fleet = dataclasses.replace(self.fleet, sampling="full",
                                             rate=1.0)
        else:
            self.fleet = dataclasses.replace(self.fleet, sampling="uniform",
                                             rate=value)


def _make_flat_shim(name: str, group: str, attr: str):
    def _get(self):
        _deprecated(f"run.{name} is deprecated; read run.{group}.{attr}")
        return getattr(getattr(self, group), attr)

    def _set(self, value):
        _deprecated(f"run.{name} is deprecated; write run.{group} = "
                    f"dataclasses.replace(run.{group}, {attr}=...)")
        setattr(self, group,
                dataclasses.replace(getattr(self, group), **{attr: value}))

    return property(_get, _set)


for _name, (_group, _attr) in _FLAT_SHIMS.items():
    setattr(FedRunConfig, _name, _make_flat_shim(_name, _group, _attr))
del _name, _group, _attr


# ===========================================================================
# Cross-group validation matrix
# ===========================================================================

def validate_run_config(run: FedRunConfig,
                        n_clients: Optional[int] = None) -> None:
    """Validate a run config: each group's own rules via its ``validate()``,
    then the genuinely cross-group matrix.  Every knob combination is
    either meaningful or rejected — nothing is silently ignored.  Enum
    membership raises KeyError; range and cross-knob violations raise
    ValueError."""
    if run.scheme not in ("ours", "sfl", "sl"):
        raise KeyError(f"unknown scheme {run.scheme!r}")
    if run.rounds < 1 or run.eval_every < 1:
        raise ValueError("rounds and eval_every must be >= 1")
    if run.batch_size < 1 or run.seq_len < 1:
        raise ValueError("batch_size and seq_len must be >= 1")
    if run.lr <= 0 or run.alpha <= 0:
        raise ValueError("lr and alpha must be > 0")
    # ---- per-group rules (each subsystem owns its own knob matrix) ----
    run.engine.validate()
    run.agg.validate()
    run.net.validate()
    run.control.validate()
    run.fleet.validate()
    run.obs.validate()
    # ---- mid-flight checkpoint / resume knob ownership ----
    if run.snapshot_every is not None and run.snapshot_every <= 0:
        raise ValueError("snapshot_every must be > 0 when set")
    if (run.snapshot_every is None) != (run.snapshot_dir is None):
        raise ValueError("snapshot_every and snapshot_dir go together: the "
                         "cadence needs a directory and vice versa")
    if run.preempt_at is not None and run.preempt_at <= 0:
        raise ValueError("preempt_at must be > 0 when set")
    # ---- analytic engine: no in-flight state, no time-varying links ----
    if run.engine.mode == "analytic":
        if run.agg.policy != "sync" or run.agg.max_inflight != 1:
            raise ValueError("async federation (agg.policy, max_inflight) "
                             "needs the continuous-time clock; set engine "
                             "mode='event'")
        if run.net.link_model in ("trace", "gilbert") or run.net.shared:
            raise ValueError("time-varying / contended links are integrated "
                             "by the event engines; the closed form needs "
                             "constant rates — set engine mode='event' "
                             "(link_model='custom' is allowed under "
                             "analytic iff every link is constant-rate)")
        if run.control.policy != "static":
            raise ValueError("online re-assignment observes telemetry at "
                             "the event clock's commit boundaries; the "
                             "closed form has none — set engine "
                             "mode='event'")
        if (run.snapshot_every is not None or run.resume_from is not None
                or run.preempt_at is not None):
            raise ValueError("mid-flight snapshots, resume and preemption "
                             "are event-clock notions (the closed form has "
                             "no in-flight state); set engine mode='event'")
        if run.obs.enabled:
            raise ValueError("observability (obs trace/metrics/"
                             "memory_ledger) instruments the event clock's "
                             "spans; the closed form has no events — set "
                             "engine mode='event'")
    else:   # event
        if run.scheme != "ours":
            # the DES models the paper's single shared-server queue; sfl
            # (concurrent submodels) and sl (strictly sequential) keep
            # their own closed-form time models
            raise ValueError("engine mode='event' only models scheme='ours'")
    # ---- async aggregation: continuous pacing, no per-round notions ----
    if run.agg.policy != "sync":
        if run.engine.deadline is not None:
            raise ValueError("round_deadline is a synchronous notion; async "
                             "policies bound lag via max_inflight_rounds")
        if run.fleet.sampling != "full":
            raise ValueError("per-round cohort sampling is a synchronous "
                             "notion; async policies pace every client "
                             "continuously (set fleet sampling='full')")
        if run.engine.scheduler not in ONLINE_DISCIPLINES:
            raise ValueError(f"scheduler {run.engine.scheduler!r} has no "
                             "online form; async policies re-sort a live "
                             f"queue (choose from "
                             f"{sorted(ONLINE_DISCIPLINES)})")
        if run.target_accuracy is not None:
            raise ValueError("target_accuracy early-stop is defined on "
                             "barrier rounds; not supported under async "
                             "aggregation policies")
        if run.fleet.edge_cells > 1:
            raise ValueError("two-tier hierarchical aggregation commits at "
                             "sync barriers; async edge aggregation is not "
                             "modeled — set agg policy='sync'")
    # ---- two-tier topology ----
    if run.fleet.edge_cells > 1 and run.scheme == "sl":
        raise ValueError("scheme='sl' has no aggregation to arrange into "
                         "edge cells")
    # ---- fleet-size-dependent rules ----
    if n_clients is not None:
        if run.agg.buffer_k is not None and run.agg.buffer_k > n_clients:
            raise ValueError("agg_buffer_k cannot exceed the fleet size")
        if run.net.traces is not None and len(run.net.traces) != n_clients:
            raise ValueError("need one (breakpoints, rates) trace per "
                             "client")
        if run.fleet.size is not None and run.fleet.size != n_clients:
            raise ValueError(f"fleet.size={run.fleet.size} does not match "
                             f"the {n_clients}-client fleet")
        if run.fleet.edge_cells > n_clients:
            raise ValueError("edge_cells cannot exceed the fleet size")


def validate_population_training(run: FedRunConfig,
                                 n_clients: Optional[int] = None) -> None:
    """The population-trainer rows on top of :func:`validate_run_config`:
    real-math cohort training at population scale mirrors the per-object
    ``Simulator`` stream-for-stream, so the knobs that keep PER-OBJECT rng
    or residual state the trainer does not replicate are rejected rather
    than silently diverging from the parity oracle."""
    validate_run_config(run, n_clients)
    if run.scheme != "ours":
        raise ValueError("population-scale training models the paper's "
                         "scheme='ours' only (sfl/sl keep per-object "
                         "closed-form runs)")
    if run.engine.mode != "event":
        raise ValueError("population-scale training is driven by the "
                         "PopulationClock's event kernels; set engine "
                         "mode='event'")
    if run.fleet.straggler_prob > 0:
        raise ValueError("straggler re-rolls draw a per-object rng stream "
                         "in a different order than the population kernels "
                         "(Simulator rolls the WHOLE fleet before sampling "
                         "the cohort); set straggler_prob=0 for real-math "
                         "population runs")
    if run.net.quantize:
        raise ValueError("int8+EF transport keeps a per-client error-"
                         "feedback residual for every client; cohort-"
                         "resident training materializes sampled clients "
                         "only — set net quantize=False")
    if run.control.policy != "static":
        raise ValueError("the control plane re-assigns cuts per-object at "
                         "commit boundaries; population-scale training "
                         "runs the static controller")
    if run.agg.transport != "nominal":
        raise ValueError("population-scale training charges commits at "
                         "nominal rates (transport='plane' routing stays "
                         "per-object)")
    if (run.snapshot_every is not None or run.resume_from is not None
            or run.preempt_at is not None):
        raise ValueError("mid-flight snapshots / resume / preemption are "
                         "per-object Simulator features; not supported by "
                         "the population trainer")
