"""A kernel's share of its roofline over a traced slice: the least time
the chip allows for the calls the slice needs (``harness.work``: each
call's operations over the type's peak or its bytes over the HBM rate,
whichever is longer), over the device time of the kernels that ran them
(found by name).  The wrapper's launch counter must agree with the calls
counted."""
from __future__ import annotations

from harness import work as W


def share(ctx, calls_key: str, kernel_names) -> float:
    calls = ctx.work.get("calls", {}).get(calls_key, [])
    device_s = ctx.trace.kernel_seconds(kernel_names)
    if not calls or device_s <= 0:
        return None
    launched = ctx.work["launches"][calls_key]
    if launched != len(calls):
        raise RuntimeError(f"{calls_key}: the wrapper counted {launched} launches where "
                           f"the slice's shapes need {len(calls)} calls")
    dtype = ctx.work["dtype"]
    elt = W.ELT[dtype]
    bound = sum(W.call_bound_s(*W.lora_call(m, k, n_, r, g, elt), dtype)
                for m, k, n_, r, g in calls)
    return 100.0 * bound / device_s
