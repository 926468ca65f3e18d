"""Checkpointing: pickle-free tree serialization on the standard library,
numpy and torch (``checkpoint``), rotation/retention/resume policy
(``manager``), and the periodic mid-flight snapshot policy the Simulator
attaches to the event clock (``PeriodicSnapshotter``).  Port of
``src/repro/checkpointing/`` with its own file format (see
``checkpoint``'s docstring)."""
from repro_torch.checkpointing.checkpoint import load, pack_json, save, unpack_json
from repro_torch.checkpointing.manager import (CheckpointManager,
                                               PeriodicSnapshotter, load_snapshot)

__all__ = ["CheckpointManager", "PeriodicSnapshotter", "load",
           "load_snapshot", "pack_json", "save", "unpack_json"]
