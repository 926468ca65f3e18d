from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim import schedules

__all__ = ["AdamW", "AdamWState", "schedules"]
