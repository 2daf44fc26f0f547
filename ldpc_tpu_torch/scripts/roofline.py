"""Roofline / speed-of-light report of the port's fused Monte-Carlo path.

Counterpart of the JAX package's ``scripts/roofline.py``. On the card:

1. per-class rates of the K4 probe (``analysis.roofline.measure_rates``);
2. the operating point's per-block trip statistics from K1
   (``measure_tile_trips``);
3. the census priced at the card's issue peak (single-pass and two-phase
   ceilings) and at the measured rates (the measured-floor bound);
4. the achieved info bits/s (``ldpc_tpu_torch.bench.measure_point``, the
   bench's method, 3 windows of ``--bench-batches`` batches);

then writes ``roofline.json`` (the JAX report's keys, ``vpu_*`` renamed as
``analysis.roofline.RENAMED_KEYS`` lists) and a short ``README.md`` to
``--out``. ``python -m ldpc_tpu_torch.scripts.attainable_ceiling`` reads it
and adds the attainable rate on the frame's op mix (K5). ``python -m
ldpc_tpu_torch.bench --roofline <out>/roofline.json`` quotes the ceiling.

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.roofline [--out build/roofline]``
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

from ldpc_tpu_torch.analysis.roofline import (
    CLASSES,
    speed_of_light,
    speed_of_light_two_phase,
)

TWO_PHASE_RAN = re.compile(r"\+2phase\((?:auto:)?\d+\)")


def bench_options(code, args):
    from ldpc_tpu_torch.sim.config import SimOptions

    return SimOptions(
        matrix=args.code, blocks=args.batch, iterations=args.iterations,
        ber=True, fer=True, fidelity="exact", batch=args.batch, seed=0,
        speed=code.k / code.n, schedule=args.schedule,
        layer_order=args.layer_order, check_every=args.check_every,
    )


def roofline_report(code, opts, *, snr_db: float, rates: dict,
                    tile_iters: float, trip_model: dict, peak: float,
                    kernel_used: str, fer: float, bits_per_s: float,
                    device: str, card: str) -> tuple[dict, dict, dict]:
    """The ``roofline.json`` report from measured inputs; returns
    ``(report, single-pass ceiling, two-phase ceiling)``. The headline
    ceiling is the one of the dispatch mode the run used (``kernel_used``
    names a split as ``+2phase(N)`` or ``+2phase(auto:N)``)."""
    from ldpc_tpu_torch.sim.runner import resolve_two_phase

    opts = opts.resolved()
    sol_kw = dict(
        k=code.k, variant=opts.decoder_variant, schedule=opts.schedule,
        mode=opts.mode, track_norm=opts.normalized_llr, peak_ops_per_s=peak,
        check_every=opts.check_every,
    )
    sol1 = speed_of_light(code.qc, rates, mean_tile_iters=tile_iters, **sol_kw)
    phase1 = resolve_two_phase(opts.two_phase, opts.iterations,
                               opts.check_every)
    sol2 = speed_of_light_two_phase(
        code.qc, rates, phase1=phase1 or opts.iterations // 2,
        trip_model=trip_model, **sol_kw,
    )
    used_two_phase = bool(TWO_PHASE_RAN.search(kernel_used))
    sol = sol2 if used_two_phase else sol1
    report = {
        "device": device,
        "card": card,
        "code": code.name,
        "snr_db": snr_db,
        "schedule": opts.schedule,
        "variant": opts.decoder_variant,
        "mode": opts.mode,
        "iterations": opts.iterations,
        "kernel": kernel_used,
        "two_phase_ceiling": used_two_phase,
        "layer_order": opts.layer_order,
        "check_every": opts.check_every,
        "issue_peak_ops_per_s": peak,
        "hbm_bytes_per_s": sol2["hbm_bytes_per_s"],
        "measured_floor_gops": {c: rates[c] / 1e9 for c in CLASSES},
        "mean_tile_iters": tile_iters,
        "trip_model": trip_model,
        "fer": fer,
        "per_iter_ops": sol["per_iter_ops"],
        "frame_ops": sol["frame_ops"],
        "t_frame_us": sol["t_frame_s"] * 1e6,
        "ceiling_info_bits_per_s": sol["ceiling_info_bits_per_s"],
        "floor_info_bits_per_s": sol["floor_info_bits_per_s"],
        "achieved_info_bits_per_s": bits_per_s,
        "sustained_issue_ops_per_s": bits_per_s / code.k * sol["frame_ops"],
        "fraction_of_ceiling": bits_per_s / sol["ceiling_info_bits_per_s"],
        # both bounds, for the record (the headline uses the matching one)
        "single_pass_ceiling_info_bits_per_s": sol1["ceiling_info_bits_per_s"],
        "two_phase_ceiling_info_bits_per_s": sol2["ceiling_info_bits_per_s"],
        "two_phase_t_mem_us": sol2["t_mem_s"] * 1e6,
        "two_phase_t_compute_us": sol2["t_compute_s"] * 1e6,
    }
    return report, sol1, sol2


def summary(report: dict) -> str:
    """The report's accounting in a few lines."""
    tm = report["trip_model"]
    mode = "two-phase" if report["two_phase_ceiling"] else "single-pass"
    return (
        f"card: {report['card']}\n"
        f"kernel: {report['kernel']}\n"
        f"single-pass ceiling: "
        f"{report['single_pass_ceiling_info_bits_per_s'] / 1e9:.4f} G info "
        f"bits/s ({sum(report['per_iter_ops'].values()):,.0f} census ops per "
        f"sweep x {report['mean_tile_iters']:.3f} block trips at the "
        f"{report['issue_peak_ops_per_s'] / 1e12:.4f} T op/s issue peak)\n"
        f"two-phase ceiling:   "
        f"{report['two_phase_ceiling_info_bits_per_s'] / 1e9:.4f} G (trips "
        f"{tm['phase1_mean']:.3f} + {tm['phase2_per_tile']:.3f}; t_mem "
        f"{report['two_phase_t_mem_us'] * 1e3:.2f} ns vs t_compute "
        f"{report['two_phase_t_compute_us'] * 1e3:.2f} ns)\n"
        f"measured-floor bound: {report['floor_info_bits_per_s'] / 1e9:.4f} G "
        f"(each class at its dependent-chain rate)\n"
        f"achieved: {report['achieved_info_bits_per_s'] / 1e9:.4f} G info "
        f"bits/s = {100 * report['fraction_of_ceiling']:.2f}% of the {mode} "
        f"ceiling (sustained "
        f"{report['sustained_issue_ops_per_s'] / 1e12:.4f} T census ops/s)"
    )


def write_report(out: Path, report: dict) -> None:
    out.mkdir(parents=True, exist_ok=True)
    (out / "roofline.json").write_text(json.dumps(report, indent=1))
    (out / "README.md").write_text(
        "# Roofline of the port's fused Monte-Carlo path\n\n"
        "Written by `python -m ldpc_tpu_torch.scripts.roofline` on "
        f"{report['device']} ({report['card']}); `attainable.json` beside it "
        "comes from `python -m ldpc_tpu_torch.scripts.attainable_ceiling`.\n\n"
        "```\n" + summary(report) + "\n```\n"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--code", default="builtin:wimax_1152_0.5.alist.txt")
    ap.add_argument("--snr", type=float, default=2.0)
    ap.add_argument("--iterations", type=int, default=12)
    ap.add_argument("--schedule", default="layered")
    ap.add_argument("--layer-order", default="paired")
    ap.add_argument("--check-every", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--bench-batches", type=int, default=320)
    ap.add_argument("--out", default="build/roofline")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("roofline: CUDA is not available", file=sys.stderr)
        return 2

    from ldpc_tpu_torch.analysis.roofline import (
        issue_peak_ops_per_s,
        measure_rates,
        measure_tile_trips,
    )
    from ldpc_tpu_torch.bench import card_line, measure_point
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code

    code = load_code(args.code)
    opts = bench_options(code, args)
    device, card = torch.cuda.get_device_name(0), card_line()
    print(f"# device={device} card={card!r} code={code.name}", flush=True)

    print("# measuring per-class rates (K4 rate_chain)...", flush=True)
    rates = measure_rates(verbose=True)
    for c in CLASSES:
        print(f"#   {c:7s} {rates[c] / 1e9:10.3f} G census ops/s", flush=True)

    print("# measuring per-block trip statistics (K1)...", flush=True)
    tile_iters, trip_model = measure_tile_trips(code, opts, args.snr)
    print(f"#   mean block trips = {tile_iters:.4f} (max {args.iterations}; "
          f"trip-model cross-check {trip_model['single']:.4f})", flush=True)
    print(f"#   trip model: {trip_model}", flush=True)

    print("# measuring achieved throughput (bench method)...", flush=True)
    executor = PointExecutor(code, opts)
    _, _, fer, bits_per_s = measure_point(
        executor, code, args.snr, batch=args.batch,
        n_batches=args.bench_batches, n_windows=3,
    )
    report, _, _ = roofline_report(
        code, opts, snr_db=args.snr, rates=rates, tile_iters=tile_iters,
        trip_model=trip_model, peak=issue_peak_ops_per_s(),
        kernel_used=executor.kernel_used, fer=fer, bits_per_s=bits_per_s,
        device=device, card=card,
    )
    out = Path(args.out)
    write_report(out, report)
    print("\n" + summary(report), flush=True)
    print(f"# wrote {out / 'roofline.json'}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
