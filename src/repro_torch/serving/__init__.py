"""Multi-tenant serving: port of ``src/repro/serving``."""
from repro_torch.serving.engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
