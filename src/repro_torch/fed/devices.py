"""Device fleet from the paper's §V simulation setup.

Copied from the JAX package's ``fed/devices.py``.  The fleet builders
(``make_fleet``, ``make_link_fleet``) and the TPU profile come with the
population-scale slice of the port.
"""
from __future__ import annotations

from repro_torch.core.cost_model import DeviceProfile, LinkProfile

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
