from repro_torch.fed.config import (LINK_MODELS, SAMPLING_POLICIES, AggConfig,
                                    ControlConfig, EngineConfig, FedRunConfig,
                                    FleetConfig, NetConfig, ObsConfig,
                                    validate_run_config)
from repro_torch.fed.devices import (LINK, PAPER_CLIENTS, PAPER_CUTS, SERVER,
                                     TPU_V5E, make_fleet, make_link_fleet)
from repro_torch.fed.engine import (AGG_POLICIES, ClockConfig, ClockResult,
                                    CommitEvent, EngineResult, FederationClock,
                                    Job, RoundPlan, ServeEvent, ServiceRecord,
                                    jobs_from_times, simulate_round)
from repro_torch.fed.fleet import FleetSpec
from repro_torch.fed.population import (PopulationClock, PopulationFleet,
                                        PopulationResult, sample_cohort,
                                        step_time_arrays, vectorized_round)
from repro_torch.fed.simulator import RoundRecord, Simulator

__all__ = ["AGG_POLICIES", "AggConfig", "ClockConfig", "ClockResult",
           "CommitEvent", "ControlConfig", "EngineConfig", "EngineResult",
           "FedRunConfig", "FederationClock", "FleetConfig", "FleetSpec",
           "Job", "LINK", "LINK_MODELS", "NetConfig", "ObsConfig",
           "PAPER_CLIENTS",
           "PAPER_CUTS", "PopulationClock", "PopulationFleet",
           "PopulationResult", "RoundPlan", "RoundRecord",
           "SAMPLING_POLICIES", "SERVER", "ServeEvent", "ServiceRecord",
           "Simulator", "TPU_V5E", "jobs_from_times", "make_fleet",
           "make_link_fleet", "sample_cohort", "simulate_round",
           "step_time_arrays", "validate_run_config", "vectorized_round"]
