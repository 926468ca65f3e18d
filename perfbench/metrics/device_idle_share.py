"""device_idle_share: one minus the union of the device's activity
intervals (kernels, copies, fills) over the traced slice's wall time.
Layer: device."""


def read(ctx):
    if ctx.trace.n_kernels == 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
