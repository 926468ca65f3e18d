"""mamba_tape_share: the bytes the program's ``mamba`` spans (the Mamba2
mixers, in_proj to out_proj) leave allocated (at exit less at entry: what
the mixer keeps for the backward, and its output), summed over the steps,
over the bytes allocated when each step's ``backward`` span is entered,
summed: weights, the phones' adapters and states, the uploads and the
whole tape.  The steps are those of the slice traced with the device's
activity alone (``harness.spans``).  None where the program records no
such spans or no allocator readings.  Layer: model step."""
from harness.spans import first_slice


def read(ctx):
    spans = first_slice(ctx)
    held = spans.get("mamba", {}).get("bytes_held")
    live = spans.get("backward", {}).get("bytes_at_entry")
    if held is None or not live:
        return None
    return 100.0 * held / live
