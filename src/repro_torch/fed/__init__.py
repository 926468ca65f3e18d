from repro_torch.fed.config import (AggConfig, ControlConfig, EngineConfig,
                                    FedRunConfig, FleetConfig, NetConfig,
                                    ObsConfig, validate_run_config)
from repro_torch.fed.devices import LINK, PAPER_CLIENTS, PAPER_CUTS, SERVER
from repro_torch.fed.simulator import RoundRecord, Simulator

__all__ = ["AggConfig", "ControlConfig", "EngineConfig", "FedRunConfig",
           "FleetConfig", "LINK", "NetConfig", "ObsConfig", "PAPER_CLIENTS",
           "PAPER_CUTS", "RoundRecord", "SERVER", "Simulator",
           "validate_run_config"]
