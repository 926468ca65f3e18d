"""Operation and byte counts of a step traced on ``meta`` tensors: the port's
counterpart of ``src/repro/launch/hlo_analysis.py``.

The reference reads FLOPs, bytes and collective traffic from the compiled
HLO text.  Eager PyTorch has no HLO, so nothing of that parser carries
over: here the step runs once on ``meta`` tensors (shapes and types, no
data, nothing allocated) under a ``TorchDispatchMode`` that sees every aten
op it dispatches, the backward's and a remat's recomputation included:

  * FLOPs — every matmul-like op (mm, addmm, bmm, baddbmm, convolution,
    ...), by ``torch.utils.flop_counter``'s formulas;
  * bytes — operand plus result bytes of every dispatched op but views and
    allocations (the counterpart of the reference's ``_SKIP_BYTES_OPS``).
    Eager PyTorch fuses nothing, so each op boundary is a trip to device
    memory: the count is what the step as run moves;
  * collectives — none: the port runs on one card.

A hand-written kernel's wrapper runs its plain version on ``meta``; those
plain ops are not counted, and the kernel's own operations and bytes are
(``kernels/work.py``: flash over the pairs its mask keeps), so the counts
describe the step as the card runs it.  ``plain_flops`` and
``plain_bytes`` count every plain op as dispatched instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work

aten = torch.ops.aten

# ops that ask for metadata and move no data (as flop_counter skips them)
_METADATA = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
             aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
             aten.is_non_overlapping_and_dense.default, aten.size.default,
             aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
             aten.storage_offset.default, aten.sym_storage_offset.default,
             aten.numel.default, aten.sym_numel.default, aten.dim.default,
             torch.ops.prim.layout.default}
# allocations: no operand, nothing written yet (the reference skips its
# parameters, constants and iotas)
_ALLOCATIONS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
                aten.new_empty_strided, aten.arange, aten.scalar_tensor, aten.lift_fresh}


@dataclasses.dataclass
class OpCosts:
    flops: float               # the one card's
    bytes_accessed: float      # operand + result bytes at op boundaries
    collective_bytes: float    # 0: one card
    collective_breakdown: Dict[str, float]
    n_collectives: int
    plain_flops: float         # with the kernels' plain versions counted as dispatched
    plain_bytes: float


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class _Counter(TorchDispatchMode):
    """Counts the ops dispatched under it; a kernel's plain version
    (between ``enter_kernel`` and ``exit_kernel``) counts only toward the
    plain totals, the kernel's own work toward the others."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = self.plain_flops = self.plain_bytes = 0.0
        self.kernel_depth = 0

    def enter_kernel(self, flops: float, nbytes: float) -> None:
        if self.kernel_depth == 0:
            self.flops += flops
            self.bytes += nbytes
        self.kernel_depth += 1

    def exit_kernel(self) -> None:
        self.kernel_depth -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:      # count a composite op by its parts, as flop_counter does
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                 if packet in flop_registry else 0)
        nbytes = (0 if func.is_view or packet in _ALLOCATIONS
                  else _tensor_bytes((args, kwargs)) + _tensor_bytes(out))
        self.plain_flops += flops
        self.plain_bytes += nbytes
        if self.kernel_depth == 0:
            self.flops += flops
            self.bytes += nbytes
        return out


def trace(fn: Callable, *args) -> Tuple[Any, OpCosts]:
    """Run ``fn(*args)`` under the counter: (its outputs, the costs).  Give
    it ``meta`` tensors to count without computing or allocating."""
    counter = _Counter()
    work.LISTENERS.append(counter)
    try:
        with counter:
            out = fn(*args)
    finally:
        work.LISTENERS.pop()
    return out, OpCosts(flops=counter.flops, bytes_accessed=counter.bytes,
                        collective_bytes=0.0, collective_breakdown={}, n_collectives=0,
                        plain_flops=counter.plain_flops, plain_bytes=counter.plain_bytes)


def analyze(fn: Callable, *args) -> OpCosts:
    """The costs of one call ``fn(*args)`` (see the module docstring)."""
    return trace(fn, *args)[1]
