"""Device-to-host copies per traced sweep: the counter fetches of each
flush, the probes' reads and the executor's own reads."""


def read(ctx):
    sweeps = len(ctx.stretch.units)
    if not sweeps:
        return None
    return ctx.stretch.copies.get("DtoH", 0) / sweeps
