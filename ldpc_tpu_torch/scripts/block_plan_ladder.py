"""K1 and K2 across block plans: time, block trips and occupancy per ``lanes``.

Run on the card: ``python -m ldpc_tpu_torch.scripts.block_plan_ladder
[--out PATH]``. On the main path's own inputs
(``chip_smoke.py`` phase 5: WiMAX (1152, 576), 4096 frames at Eb/N0 2 dB,
layered SPA, paired layers, a syndrome check every two sweeps, Philox noise)
it runs, for each number of codewords per block (8, 4, 2 and 1):

* K1 ``mc_decoder`` at 12 iterations, single pass;
* K2 ``llr_decoder`` at 12 iterations on the compacted output of a
  6-iteration phase 1 (as a split batch feeds it);

and reports each kernel's mean time over 10 launches (CUDA events),
its mean block trips (``iters`` read once per block), its threads and shared
memory per block and its resident blocks per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and ``ptxas``'s
registers and spill bytes per kernel of the library.

It fails unless every plan gives the same err / ok / conv for every frame
and ``iters`` equals, for every frame, the largest trip count among the
frames of its block (a frame's trips: its check iteration + 1, or the
budget). One JSON object per plan on stdout; ``--out`` writes them all.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ITERS, PHASE1, CHECK_EVERY, BATCH, SNR_DB = 12, 6, 2, 4096, 2.0
LANES, REPS = (8, 4, 2, 1), 10  # the plans, timed launches per kernel
KEY = (0x243F6A88, 0x85A308D3)  # chip_smoke.py phase 5's Philox key
W1152 = "builtin:wimax_1152_0.5.alist.txt"


def main_inputs(dev):
    """(code, layer groups, wT, consts) of the main path's kernel calls."""
    import numpy as np
    import torch

    from ldpc_tpu_torch.models.qc import paired_layer_groups
    from ldpc_tpu_torch.ops.channel import ChannelParams
    from ldpc_tpu_torch.ops.encode import make_encoder_T
    from ldpc_tpu_torch.sim.runner import load_code

    code = load_code(W1152)
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.integers(0, 2, (BATCH, code.k),
                                      dtype=np.uint8)).to(dev)
    wT = make_encoder_T(code.standard_encode_spec, "orig", dev)(u)
    consts = ChannelParams(mode=1, modulation=1, speed=0.5, snr_db=SNR_DB,
                           noise_model="exact").consts(dev)
    return code, paired_layer_groups(code.qc), wT, consts


def block_max_trips(ok, conv, lanes: int, max_it: int, live=None):
    """Per frame: the largest trip count among the frames of its block of
    ``lanes`` (a frame's trips: conv + 1 when it converged, else the
    budget; 0 where ``live`` is given and False: a pre-done frame)."""
    import torch

    trips = torch.where(ok, conv.to(torch.int64) + 1, max_it)
    if live is not None:
        trips = torch.where(live, trips, 0)
    B = trips.numel()
    nb = -(-B // lanes)
    pad = torch.zeros(nb * lanes - B, dtype=trips.dtype, device=trips.device)
    blk = torch.cat([trips, pad]).view(nb, lanes).amax(dim=1)
    return blk.repeat_interleave(lanes)[:B]


def time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def ladder(dev) -> list[dict]:
    """One row per plan of ``LANES``; see the module docstring. Raises on
    a disagreement between plans."""
    import torch

    from ldpc_tpu_torch.ops.mc_kernels import LLRDecoder, MCDecoder

    code, groups, wT, consts = main_inputs(dev)
    info_pos = code.standard_encode_spec.info_pos("orig")
    kw = dict(layer_groups=groups, check_every=CHECK_EVERY)
    mc1 = MCDecoder(code.qc, info_pos, PHASE1, "spa", emit_llr=True, **kw)
    o1 = mc1(wT, consts, seeds=KEY)
    order = torch.argsort(o1[1].to(torch.int32), stable=True)
    llr_s = o1[5].index_select(1, order)
    w_s = wT.index_select(1, order)
    done0 = o1[1].index_select(0, order).to(torch.float32)
    live = done0 < 0.5
    rows, first = [], None
    for lanes in LANES:
        mc = MCDecoder(code.qc, info_pos, ITERS, "spa", lanes=lanes, **kw)
        k2 = LLRDecoder(code.qc, info_pos, ITERS, "spa", lanes=lanes, **kw)
        a = mc(wT, consts, seeds=KEY)
        b = k2(llr_s, w_s, done0)
        torch.cuda.synchronize()
        for tag, out, mask in (("mc_decoder", a, None), ("llr_decoder", b, live)):
            want = block_max_trips(out[1], out[2], lanes, ITERS, mask)
            if not torch.equal(out[4].to(torch.int64), want):
                raise SystemExit(f"block_plan_ladder: {tag} lanes={lanes}: iters "
                                 "differ from the block's largest trip count")
        if first is None:
            first = (a, b)
        else:
            for tag, x, y in (("mc_decoder", a, first[0]), ("llr_decoder", b, first[1])):
                for i, name in ((0, "err"), (1, "ok"), (2, "conv")):
                    if not torch.equal(x[i], y[i]):
                        raise SystemExit(f"block_plan_ladder: {tag} {name} at "
                                         f"lanes={lanes} differs from lanes={LANES[0]}")
        row = {
            "lanes": lanes,
            "k1_ms": time_ms(lambda: mc(wT, consts, seeds=KEY), REPS),
            "k1_block_trips": float(a[4][::lanes].to(torch.float32).mean()),
            "k1_threads": mc.plan.threads, "k1_smem": mc.plan.smem,
            "k1_blocks_per_sm": mc.blocks_per_sm(dev),
            "k2_ms": time_ms(lambda: k2(llr_s, w_s, done0), REPS),
            "k2_block_trips": float(b[4][::lanes].to(torch.float32).mean()),
            "k2_live_blocks": int((b[4][::lanes] > 0).sum()),
            "k2_threads": k2.plan.threads, "k2_smem": k2.plan.smem,
            "k2_blocks_per_sm": k2.blocks_per_sm(dev),
        }
        rows.append(row)
    lane_trips = torch.where(first[0][1], first[0][2].to(torch.int64) + 1, ITERS)
    for row in rows:
        row["lane_trips_mean"] = float(lane_trips.to(torch.float32).mean())
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import subprocess

    import torch

    from ldpc_tpu_torch.ops import build

    if not torch.cuda.is_available():
        print("block_plan_ladder: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    build.build_all(("mc_decoder",))
    ptxas = build.ptxas_report(build.ptxas_log("mc_decoder"))
    dev = torch.device("cuda", 0)
    rows = ladder(dev)
    for row in rows:
        print(json.dumps(row))
    report = {"card": card, "ptxas": ptxas, "ladder": rows}
    print(json.dumps({"card": card, "ptxas": ptxas}))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
