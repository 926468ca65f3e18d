"""launches_per_ktok: the CUDA kernels the device ran in the traced slice
(the profiler's kernel records; copies and fills not counted), per
thousand tokens the slice served.  Layer: host dispatch."""


def read(ctx):
    if ctx.trace.n_kernels == 0:
        return None
    return ctx.trace.n_kernels / (ctx.work["tokens"] / 1e3)
