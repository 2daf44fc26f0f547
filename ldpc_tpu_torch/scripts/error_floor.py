"""Deep-waterfall FER curve + failure-structure profile on one card.

Counterpart of the JAX package's ``scripts/error_floor.py``. Two phases:

1. **Curve**: an SNR sweep (``run_simulation``) with per-point early stop
   (``--target-errors``) and a large per-point frame cap, checkpointed to
   ``<out>/curve.json`` and resumed from it.
2. **Profile**: at chosen SNR points, the info-bit error weight of every
   failing frame histogrammed on the device
   (``analysis.failures.profile_sweep``, unfused, through K3), split into
   detected failures and undetected errors (the syndrome passes, the bits
   are wrong: a different codeword).

``--census-snr`` also captures residual patterns at that SNR and classifies
them into (a, b) trapping-set classes (``trapping_census.json``).

Outputs go to ``--out`` (default ``build/error_floor``); the committed TPU
records under ``examples/error_floor`` are never read or written.

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.error_floor [--code
builtin:wimax_576_0.5.alist.txt] [--snr 2.0:4.5:0.25] [--target-errors 100]
[--profile-snrs 3.0,3.5] [--profile-errors 300] [--out build/error_floor]``
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ldpc_tpu_torch.scripts.study import device_label, floats


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--code", default="builtin:wimax_576_0.5.alist.txt")
    ap.add_argument("--snr", default="2.0:4.5:0.25",
                    help="curve grid lo:hi:step (Eb/N0 dB; speed=rate)")
    ap.add_argument("--target-errors", type=int, default=100)
    ap.add_argument("--max-blocks", type=int, default=200_000_000,
                    help="per-point frame cap for the curve")
    ap.add_argument("--profile-snrs", default="3.0,3.5",
                    help="comma list of SNRs for the failure profile")
    ap.add_argument("--profile-errors", type=int, default=300)
    ap.add_argument("--profile-max-blocks", type=int, default=50_000_000)
    ap.add_argument("--iterations", type=int, default=12)
    ap.add_argument("--schedule", default="layered")
    ap.add_argument("--out", default="build/error_floor")
    ap.add_argument("--skip-curve", action="store_true")
    ap.add_argument("--skip-profile", action="store_true",
                    help="curve only (e.g. tail-point re-measurement)")
    ap.add_argument("--census-snr", type=float, default=None,
                    help="Also capture residual patterns at this SNR and "
                         "classify (a,b) trapping-set classes")
    ap.add_argument("--census-patterns", type=int, default=256)
    return ap


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)

    from ldpc_tpu_torch.analysis.failures import (
        collect_failure_patterns,
        profile_sweep,
        trapping_census,
    )
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import load_code, run_simulation
    from ldpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    code = load_code(args.code)
    rate = code.k / code.n
    lo, hi, step = (float(x) for x in args.snr.split(":"))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    base = dict(
        matrix=args.code,
        iterations=args.iterations,
        ber=True,
        fer=True,
        fidelity="exact",
        exact_ber=True,
        speed=rate,
        schedule=args.schedule,
        seed=0,
    )

    print(f"# device={device_label(dev)} code={code.name} "
          f"k={code.k} rate={rate:g}", flush=True)

    if not args.skip_curve:
        opts = SimOptions(
            blocks=args.max_blocks,
            initial_snr=lo, end_snr=hi, step_snr=step,
            target_errors=args.target_errors,
            checkpoint=str(out / "curve.json"),
            resume=True,
            **base,
        )
        result = run_simulation(opts, code, device=dev)
        result.to_json(str(out / "curve.json"))

    if args.skip_profile:
        return 0

    popts = SimOptions(blocks=4096, batch=4096, fused="off", **base)
    profiles = profile_sweep(
        code, popts, floats(args.profile_snrs), args.profile_errors,
        args.profile_max_blocks, device=dev,
    )

    (out / "failure_profile.json").write_text(json.dumps(profiles, indent=1))
    print(json.dumps(profiles, indent=1))

    if args.census_snr is not None:
        print(f"\ntrapping-set census at {args.census_snr:g} dB", flush=True)
        pats, seen, frames = collect_failure_patterns(
            code, popts, args.census_snr,
            min_patterns=args.census_patterns,
            max_blocks=args.profile_max_blocks,
            max_patterns=args.census_patterns,
            device=dev,
        )
        census = trapping_census(pats, code, graph="orig")
        census["snr_db"] = args.census_snr
        census["failures_seen"] = seen
        census["frames"] = frames
        (out / "trapping_census.json").write_text(json.dumps(census, indent=1))
        print(json.dumps(census, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
