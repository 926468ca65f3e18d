"""Device fleet from the paper's §V simulation setup.

Copied from the JAX package's ``fed/devices.py``: the six paper clients,
the edge server, the link, the TPU server profile the reference models
(cost-model data, not a device the port runs on) and the deprecated
``make_fleet`` / ``make_link_fleet``, which delegate to
:class:`repro_torch.fed.fleet.FleetSpec`.
"""
from __future__ import annotations

import warnings
from typing import List

from repro_torch.core.cost_model import DeviceProfile, LinkProfile
from repro_torch.net import LinkModel

# six heterogeneous clients (name, TFLOPS, memory GB) — paper §V
JETSON_NANO = DeviceProfile("jetson-nano", tflops=0.472, mem_gb=4.0)
JETSON_TX2 = DeviceProfile("jetson-tx2", tflops=1.330, mem_gb=8.0)
SD_8S_GEN3 = DeviceProfile("snapdragon-8s-gen3", tflops=1.689, mem_gb=12.0)
SD_8_GEN3 = DeviceProfile("snapdragon-8-gen3", tflops=2.774, mem_gb=12.0)
A17_PRO = DeviceProfile("a17-pro", tflops=2.147, mem_gb=8.0)
M3 = DeviceProfile("m3", tflops=3.533, mem_gb=16.0)

PAPER_CLIENTS = (JETSON_NANO, JETSON_TX2, SD_8S_GEN3, SD_8_GEN3, A17_PRO, M3)

# the paper's per-device client-side transformer layer counts
PAPER_CUTS = (1, 1, 2, 2, 3, 3)

# RTX 4080 SUPER edge server, 52.2 TFLOPS
SERVER = DeviceProfile("rtx-4080s", tflops=52.2, mem_gb=16.0, utilization=0.45)

LINK = LinkProfile(rate_mbps=100.0)

# TPU v5e: the reference's modelled server profile for its systems plane
TPU_V5E = DeviceProfile("tpu-v5e", tflops=197.0, mem_gb=16.0, utilization=0.55)


def make_fleet(n: int, seed: int = 0, jitter: float = 0.25) -> List[DeviceProfile]:
    """Deprecated: use ``repro_torch.fed.fleet.FleetSpec(n, seed, jitter=...).devices()``.

    Thin wrapper kept for compatibility — the FleetSpec path reproduces
    this function's rng stream exactly."""
    warnings.warn("make_fleet is deprecated; use FleetSpec(...).devices()",
                  DeprecationWarning, stacklevel=2)
    from repro_torch.fed.fleet import FleetSpec
    return FleetSpec(n=n, seed=seed, jitter=jitter).devices()


def make_link_fleet(n: int, seed: int = 0, *, model: str = "gilbert",
                    base_mbps: float = LINK.rate_mbps,
                    jitter: float = 0.3,
                    dwell_s: float = 0.5,
                    horizon_s: float = 120.0,
                    bad_fraction: float = 0.1,
                    p_gb: float = 0.2,
                    p_bg: float = 0.4) -> List[LinkModel]:
    """Deprecated: use ``repro_torch.fed.fleet.FleetSpec(n, seed, link_model=...,
    link_jitter=...).links()``.

    Thin wrapper kept for compatibility — the FleetSpec path reproduces
    this function's rng stream exactly (see the FleetSpec docstring for the
    trace/gilbert link shapes these knobs control)."""
    warnings.warn("make_link_fleet is deprecated; use FleetSpec(...).links()",
                  DeprecationWarning, stacklevel=2)
    from repro_torch.fed.fleet import FleetSpec
    return FleetSpec(n=n, seed=seed, link_model=model, base_mbps=base_mbps,
                     link_jitter=jitter, dwell_s=dwell_s,
                     horizon_s=horizon_s, bad_fraction=bad_fraction,
                     p_gb=p_gb, p_bg=p_bg).links()
