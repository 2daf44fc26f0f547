"""Deep error-floor FER via importance sampling — WiMAX (576, 288).

Counterpart of the JAX package's ``scripts/importance_floor.py``:

1. **Capture shift targets on the card**: undetected-error residuals at
   ``--capture-snr`` (codewords of the minimum-distance neighborhood), plus
   the recurring trapping-set supports of a committed census
   (``--census``, read as input); both expand to full QC orbits.
2. **Cross-validate** the defensive-mixture IS estimator
   (``analysis.importance``, decoding through K3) against plain MC at
   ``--validate-snrs``.
3. **Estimate the floor** at ``--deep-snrs`` (an empty list skips a phase).

Writes ``<out>/results.json`` (default ``build/importance_floor``).

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.importance_floor``
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ldpc_tpu_torch.scripts.study import device_label, floats


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--code", default="builtin:wimax_576_0.5.alist.txt")
    ap.add_argument("--iterations", type=int, default=12)
    ap.add_argument("--schedule", default="layered")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--census",
                    default="examples/error_floor/trapping_census.json",
                    help="trapping census JSON for shift targets ('' = none)")
    ap.add_argument("--capture-kind", default="undetected",
                    choices=["undetected", "detected", "none"],
                    help="residual kind to capture on the card as shift "
                         "targets (undetected = codeword events; detected "
                         "= trapping supports, for codes whose floor is "
                         "trapping-driven, e.g. girth-4 WRAN)")
    ap.add_argument("--capture-snr", type=float, default=2.5)
    ap.add_argument("--capture-min", type=int, default=8)
    ap.add_argument("--capture-max-blocks", type=int, default=2_000_000)
    ap.add_argument("--validate-snrs", default="3.5,3.75,4.0,4.25,4.5")
    ap.add_argument("--deep-snrs", default="5.0,5.5,6.0,6.5")
    ap.add_argument("--validate-frames", type=int, default=2_000_000)
    ap.add_argument("--deep-frames", type=int, default=4_000_000)
    ap.add_argument("--pi0", type=float, default=0.2)
    ap.add_argument("--shift", type=float, default=0.5)
    ap.add_argument("--max-support", type=int, default=16)
    ap.add_argument("--out", default="build/importance_floor")
    return ap


def census_targets(census_path: str, max_support: int) -> list[list[int]]:
    """The census's recurring supports of at most ``max_support`` bits
    (none when the path is empty or absent), as the JAX script reads
    them."""
    if not census_path or not Path(census_path).exists():
        return []
    census = json.loads(Path(census_path).read_text())
    return [r["support"] for r in census.get("recurring_supports", [])
            if 0 < len(r["support"]) <= max_support]


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)

    from ldpc_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache()

    from ldpc_tpu_torch.analysis.failures import collect_failure_patterns
    from ldpc_tpu_torch.analysis.importance import (
        estimate_point,
        make_is_step,
        orbit_supports,
    )
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import load_code
    from ldpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    label = device_label(dev)
    code = load_code(args.code)
    Z = code.qc.Z
    rate = code.k / code.n
    base = dict(
        matrix=args.code, iterations=args.iterations, ber=True, fer=True,
        fidelity="exact", exact_ber=True, speed=rate,
        schedule=args.schedule, seed=0, quiet=True,
        blocks=args.batch, batch=args.batch, fused="off",
    )
    opts = SimOptions(**base)
    print(f"# device={label} code={code.name} Z={Z}", flush=True)

    # ---- 1. shift targets ----
    cw_supports: list[list[int]] = []
    if args.capture_kind != "none":
        print(f"# capturing {args.capture_kind} residuals at "
              f"{args.capture_snr:g} dB...", flush=True)
        pats, seen, frames = collect_failure_patterns(
            code, opts, args.capture_snr, min_patterns=args.capture_min,
            max_blocks=args.capture_max_blocks,
            max_patterns=2 * args.capture_min,
            kind=args.capture_kind, device=dev,
        )
        for p in np.asarray(pats):
            sup = np.flatnonzero(p).tolist()
            if 0 < len(sup) <= args.max_support:
                cw_supports.append(sup)
        # dedup identical supports from repeat captures
        cw_supports = [list(s) for s in
                       {tuple(s) for s in cw_supports}]
        print(f"#   {len(cw_supports)} captured supports "
              f"(sizes {sorted(len(s) for s in cw_supports)}) "
              f"from {seen} events / {frames} frames", flush=True)

    ts_supports = census_targets(args.census, args.max_support)
    print(f"#   {len(ts_supports)} recurring trapping supports from census",
          flush=True)

    shifts = orbit_supports(cw_supports + ts_supports, Z, code.n,
                            max_components=1024)
    print(f"#   {shifts.shape[0]} mixture components after orbit expansion",
          flush=True)

    step, kernel = make_is_step(code, opts, shifts, pi0=args.pi0,
                                shift=args.shift, device=dev)
    print(f"# decode kernel: {kernel}", flush=True)

    def run_points(snrs, frames):
        out = []
        for snr in snrs:
            r = estimate_point(
                code, opts, snr, shifts, frames=frames, pi0=args.pi0,
                shift=args.shift, seed=11, step=step, device=dev,
            )
            print(
                f"  {snr:4.2f} dB: FER {r.fer:.3e} +- {r.fer_std:.1e}  "
                f"WER {r.wer:.3e} +- {r.wer_std:.1e}  "
                f"undet {r.undetected:.3e}  "
                f"(fails {r.fail_frames}, E[w] {r.mean_weight:.3f}, "
                f"max w {r.max_weight:.2f}, {r.frames} frames)",
                flush=True,
            )
            out.append(r.to_dict())
        return out

    # ---- 2. cross-validation vs plain MC ----
    print("# cross-validation against plain MC (examples/error_floor):",
          flush=True)
    val = run_points(floats(args.validate_snrs), args.validate_frames)

    # ---- 3. the deep points ----
    print("# deep points (beyond MC reach):", flush=True)
    deep = run_points(floats(args.deep_snrs), args.deep_frames)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "results.json").write_text(json.dumps(
        {
            "device": label,
            "code": code.name,
            "kernel": kernel,
            "pi0": args.pi0,
            "shift": args.shift,
            "components": int(shifts.shape[0]),
            "codeword_supports": cw_supports,
            "trapping_supports": ts_supports,
            "validation": val,
            "deep": deep,
        },
        indent=1,
    ))
    print(f"# wrote {out}/results.json", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
