"""Launch layer of the port: the one-card mesh, the sharding plan, the step
constructors, the dry-run (a FLOP and memory report, ``--execute`` on the
card), serving and training entry points (``python -m
repro_torch.launch.{dryrun,serve,train}``).  Port of ``src/repro/launch/``.
Importing this package touches no device."""
from repro_torch.launch.mesh import (dp_axes, dp_size, make_debug_mesh,
                                     make_production_mesh, model_axis_size)
from repro_torch.launch.sharding import ShardingPolicy

__all__ = ["ShardingPolicy", "dp_axes", "dp_size", "make_debug_mesh",
           "make_production_mesh", "model_axis_size"]
