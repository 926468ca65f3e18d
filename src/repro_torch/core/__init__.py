# The paper's primary contribution: memory-efficient split federated
# learning — heterogeneous layer splitting (partition), single-copy server
# with sequential LoRA switching (splitfl), adapter aggregation with
# re-split (aggregation, lora), and training-order scheduling (scheduling),
# driven by the analytical cost/memory models of §IV-§V.
from repro_torch.core import (aggregation, cost_model, lora, memory_model,
                              partition, scheduling, splitfl)

__all__ = ["aggregation", "cost_model", "lora", "memory_model", "partition",
           "scheduling", "splitfl"]
