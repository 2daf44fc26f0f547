"""The decode kernels' share of their roofline, in percent: the least time
the census work of the traced frames needs, over the device time of the
decode kernels (K1 and K2 on the fused path, K3 on the unfused one).

The work is the census of every frame's sweeps (each through its
converging check window, or the whole budget, from the run's counters),
plus, on the fused path, the in-kernel channel, error count and init, and
on the unfused path the init; the bytes are each codeword's f32 input row
and its outputs (K3 adds its hard decisions). The larger of the two least
times, at the card's published peaks, is the bound."""

from benchmark import census
from benchmark.cells import schedule
from benchmark.trace import is_decode


def read(ctx):
    t_dec = sum(s for n, s in ctx.stretch.kernels if is_decode(n))
    tot = ctx.totals()
    if t_dec <= 0 or not tot["frames"]:
        return None
    o = ctx.config["options"]
    code, frames = ctx.code, tot["frames"]
    sweeps = census.total_sweeps(frames, tot["converged"], tot["conv_sum"],
                                 o["iterations"])
    ops = census.decode_census(code, "spa", schedule(ctx.config),
                               check_every=o.get("check_every", 1)).total()
    ops *= sweeps
    if ctx.fused:
        ops += census.channel_census(code, o.get("mode", 1)).total() * frames
        nbytes = frames * (4 * code.n + 17)
    else:
        ops += census.init_census(code).total() * frames
        nbytes = frames * (5 * code.n + 17)
    bound = census.least_time(ops, nbytes, ctx.device_name)
    if bound is None:
        return None
    ctx.note(f"decode roofline: {ops:.6g} census ops, {nbytes} bytes, "
             f"bound {bound[0] * 1e3:.6g} ms by {bound[1]}, decode kernels "
             f"{t_dec * 1e3:.6g} ms")
    return 100.0 * bound[0] / t_dec
