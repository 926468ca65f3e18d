"""The program's own spans (``repro_torch.obs.wall``) of the slice the
per-layer metrics read: the one traced with the device's activity alone.
Its ``ctx.work["attempted"]`` server steps are the first the program
recorded; the slice traced with host ops follows, on a host that recording
host ops slows."""


def first_slice(ctx) -> dict:
    """Per span name, ``wall.summary()`` over the first slice's server
    steps; empty where the program records no spans of its own."""
    try:
        from repro_torch.obs import wall
    except ImportError:
        return {}
    spans = wall.recorded()
    steps = sorted({s.req for s in spans if s.name == "server_step"})
    keep = set(steps[:ctx.work["attempted"]])
    return wall.summary([s for s in spans if s.req in keep])
