"""The ATTAINABLE ceiling of the port's fused decode path (K5 ladder).

Counterpart of the JAX package's ``scripts/attainable_ceiling.py``. The
roofline (``python -m ldpc_tpu_torch.scripts.roofline``) brackets the
achieved rate between the measured-floor bound (every class at its
dependent-chain rate) and the issue-peak ceiling (perfect issue). This
script measures what the card sustains on the frame's own op mix: the census
histogram of one frame (the dispatch mode the roofline run used), run by the
K5 probe as S independent register chains per thread, over a stream ladder
(``--streams``, default 1,2,4,8,16), at two launch shapes:

* the card full of 256-thread blocks (the attainable rate: the best rung);
* K1's own launch: K1's blocks (its block plan: one codeword of 96
  threads at wimax 1152, paired layers), as many per SM as the card keeps
  resident. The gap between the two is what K1's launch shape costs on this
  op mix.

Writes ``attainable.json`` beside ``roofline.json`` (``--out``, default
``build/roofline``) and prints the accounting: floor, achieved, attainable,
issue peak.

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.attainable_ceiling``
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace


def frame_mix(code, base: dict) -> tuple[dict, float]:
    """(census ops by class, total) of one frame as the roofline run priced
    it: the two-phase stream when it split, else the single pass."""
    from ldpc_tpu_torch.analysis.roofline import (
        speed_of_light,
        speed_of_light_two_phase,
    )

    kw = dict(k=code.k, variant=base["variant"], schedule=base["schedule"],
              mode=base["mode"], peak_ops_per_s=base["issue_peak_ops_per_s"],
              check_every=base["check_every"])
    if base["two_phase_ceiling"]:
        sol = speed_of_light_two_phase(code.qc, trip_model=base["trip_model"],
                                       **kw)
    else:
        sol = speed_of_light(code.qc, mean_tile_iters=base["mean_tile_iters"],
                             **kw)
    return sol["frame_ops_by_class"], sol["frame_ops"]


def k1_launch(code, base: dict, sm_count: int,
              blocks_per_sm) -> tuple[int, int]:
    """(blocks, threads) of K1's launch shape for the mix probe: K1's plan
    at ``blocks_per_sm(tables, plan)`` resident blocks per SM (on the card,
    ``mc_kernels.blocks_per_sm``)."""
    from ldpc_tpu_torch.ops.decode_loop import build_tables
    from ldpc_tpu_torch.ops.mc_kernels import fused_plan
    from ldpc_tpu_torch.sim.runner import resolve_layer_groups

    groups = resolve_layer_groups(
        code.qc, SimpleNamespace(layer_order=base["layer_order"]),
        base["schedule"])
    tables = build_tables(code.qc, groups)
    plan = fused_plan(tables)
    return sm_count * blocks_per_sm(tables, plan), plan.threads


def attainable_report(code, base: dict, ladders: dict, *, full, k1,
                      build_s: float) -> dict:
    """The ``attainable.json`` report from the roofline report ``base`` and
    the two measured ladders (``{"full": {streams: measure_mix_rate(...)},
    "k1": {...}}``): the best rung of each launch shape prices the frame."""
    mix, frame_ops = frame_mix(code, base)
    best = max(ladders["full"].values(), key=lambda r: r["census_ops_per_s"])
    best_k1 = max(ladders["k1"].values(), key=lambda r: r["census_ops_per_s"])
    attainable = code.k / (frame_ops / best["census_ops_per_s"])
    achieved = base["achieved_info_bits_per_s"]
    return {
        "device": base["device"],
        "card": base["card"],
        "code": base["code"],
        "frame_ops": frame_ops,
        "frame_mix": mix,
        "frame_mix_two_phase": base["two_phase_ceiling"],
        "build_s": build_s,
        "streams_ladder": ladders["full"],
        "streams_ladder_k1_launch": ladders["k1"],
        "full_launch": list(full),
        "k1_launch": list(k1),
        "attainable_census_ops_per_s": best["census_ops_per_s"],
        "attainable_info_bits_per_s": attainable,
        "attainable_k1_launch_info_bits_per_s":
            code.k / (frame_ops / best_k1["census_ops_per_s"]),
        "achieved_info_bits_per_s": achieved,
        "floor_info_bits_per_s": base["floor_info_bits_per_s"],
        "issue_peak_info_bits_per_s": base["ceiling_info_bits_per_s"],
        "fraction_of_attainable": achieved / attainable,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/roofline")
    ap.add_argument("--streams", default="1,2,4,8,16")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("attainable_ceiling: CUDA is not available", file=sys.stderr)
        return 2

    from ldpc_tpu_torch.analysis.roofline import (
        build_mix_ladder,
        full_occupancy_launch,
        measure_mix_rate,
    )
    from ldpc_tpu_torch.ops.mc_kernels import K_MC, blocks_per_sm
    from ldpc_tpu_torch.sim.runner import load_code

    out = Path(args.out)
    base = json.loads((out / "roofline.json").read_text())
    code = load_code(f"builtin:{base['code']}")
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"# device={torch.cuda.get_device_name(dev)} card={base['card']!r} "
          f"code={base['code']}", flush=True)

    mix, frame_ops = frame_mix(code, base)
    print(f"# frame mix ({'two-phase' if base['two_phase_ceiling'] else 'single-pass'}): "
          f"{ {c: round(v) for c, v in mix.items() if v} }", flush=True)
    streams = [int(v) for v in args.streams.split(",")]
    t0 = time.perf_counter()
    built = build_mix_ladder(mix, streams)
    build_s = time.perf_counter() - t0
    print(f"# built {len(built)} K5 libraries in {build_s:.1f} s ("
          + ", ".join(f"{v['seconds']:.1f} s" for v in built.values()) + ")",
          flush=True)

    full = full_occupancy_launch(dev)
    k1 = k1_launch(code, base,
                   torch.cuda.get_device_properties(dev).multi_processor_count,
                   lambda t, p: blocks_per_sm(K_MC, t, p, dev))
    ladders = {"full": {}, "k1": {}}
    for s in streams:
        for shape, launch in (("full", full), ("k1", k1)):
            r = measure_mix_rate(mix, launch=launch, streams=s, device=dev,
                                 verbose=True)
            ladders[shape][str(s)] = r
            att = code.k / (frame_ops / r["census_ops_per_s"])
            print(f"# streams={s:2d} launch {launch[0]}x{launch[1]} "
                  f"({r['blocks_per_sm']} blocks/SM): "
                  f"{r['census_ops_per_s'] / 1e12:.4f} T census ops/s -> "
                  f"{att / 1e9:.4f} G info bits/s (stabilizer overhead "
                  f"{r['stabilizer_frac'] * 100:.0f}%)", flush=True)

    result = attainable_report(code, base, ladders, full=full, k1=k1,
                               build_s=build_s)
    (out / "attainable.json").write_text(json.dumps(result, indent=1))
    achieved, attainable = (result["achieved_info_bits_per_s"],
                            result["attainable_info_bits_per_s"])
    print("#")
    print(f"# measured floor      {base['floor_info_bits_per_s'] / 1e9:8.4f} G  (serial dependent chains)")
    print(f"# achieved            {achieved / 1e9:8.4f} G")
    print(f"# attainable          {attainable / 1e9:8.4f} G  (mix at full ILP and occupancy, measured)")
    print(f"# attainable, K1 shape {result['attainable_k1_launch_info_bits_per_s'] / 1e9:7.4f} G  "
          f"({k1[0]} blocks of {k1[1]} threads)")
    print(f"# issue peak          {base['ceiling_info_bits_per_s'] / 1e9:8.4f} G  (perfect issue)")
    print(f"# achieved/attainable {100 * achieved / attainable:.2f}%")
    print(f"# wrote {out / 'attainable.json'}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
