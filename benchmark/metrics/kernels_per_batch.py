"""Kernels the card ran per batch in the traced stretch (run loop): every
kernel event, the decode kernels included, over the batches decoded."""


def read(ctx):
    batches = ctx.batches()
    if not batches or not ctx.stretch.kernels:
        return None
    return len(ctx.stretch.kernels) / batches
