"""Device milliseconds per batch of every kernel other than the decode
kernels K1, K2 and K3 (batch ops: bits, encode, channel, compaction,
counters)."""

from benchmark.trace import is_decode


def read(ctx):
    batches = ctx.batches()
    if not batches or not ctx.stretch.kernels:
        return None
    return 1e3 * sum(s for n, s in ctx.stretch.kernels
                     if not is_decode(n)) / batches
