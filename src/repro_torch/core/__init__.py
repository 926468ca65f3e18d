# The paper's primary contribution: memory-efficient split federated
# learning — single-copy server with sequential LoRA switching (splitfl),
# adapter aggregation with re-split (aggregation, lora), and training-order
# scheduling (scheduling), driven by the analytical cost model (§IV-§V).
from repro_torch.core import aggregation, cost_model, lora, scheduling, splitfl

__all__ = ["aggregation", "cost_model", "lora", "scheduling", "splitfl"]
