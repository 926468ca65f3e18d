"""ssd_share: the device seconds of the program's ``ssd`` spans (the
Mamba2 SSD, from the conv's output to the SSD's) and their ``ssd.bwd``
brackets (the SSD recomputed from its inputs and differentiated) over
those of its ``server_step`` spans, in the slice traced with the device's
activity alone (``harness.spans``).  A span's seconds lie between a pair
of CUDA events on its stream, so they take in the stream's idle time
inside it.  None where the program records no such spans or no device
intervals.  Layer: model step."""
from harness.spans import first_slice


def read(ctx):
    spans = first_slice(ctx)
    step = spans.get("server_step", {}).get("device_s")
    fwd = spans.get("ssd", {}).get("device_s")
    if not step or fwd is None:
        return None
    return 100.0 * (fwd + (spans.get("ssd.bwd", {}).get("device_s") or 0.0)) / step
