"""Learned min-sum weight schedule study (``analysis.learned_minsum``).

Counterpart of the JAX package's ``scripts/learned_minsum_study.py``. Trains
a per-iteration alpha schedule for the normalized min-sum decoder at one
operating point (autograd through the unrolled plain decoder, Adam), then
measures paired FER (the same noise stream per seed) against fixed-alpha
baselines across the waterfall, on the plain flooding decoder
(``ops.spa``). Writes ``<out>/{RESULTS.md,results.json}`` (default
``build/learned_minsum``).

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.learned_minsum_study
[--code builtin:wimax_576_0.5.alist.txt] [--iters 12] [--train-snr 2.0]
[--steps 300] [--train-batch 256] [--eval-snrs 2.0,2.5,3.0]
[--eval-blocks 40960] [--out build/learned_minsum]``
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from ldpc_tpu_torch.scripts.study import device_label, floats


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--code", default="builtin:wimax_576_0.5.alist.txt")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--train-snr", type=float, default=2.0)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--train-batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--eval-snrs", default="2.0,2.5,3.0")
    ap.add_argument("--eval-blocks", type=int, default=40960)
    ap.add_argument("--eval-batch", type=int, default=1024)
    ap.add_argument("--out", default="build/learned_minsum")
    return ap


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)

    from ldpc_tpu_torch.analysis.learned_minsum import (
        evaluate_alphas,
        train_alphas,
    )
    from ldpc_tpu_torch.sim.runner import load_code
    from ldpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    code = load_code(args.code)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(f"# device={device_label(dev)} code={code.name} "
          f"iters={args.iters}", flush=True)

    t0 = time.time()
    alphas, losses = train_alphas(
        code, args.train_snr, args.iters, steps=args.steps,
        batch=args.train_batch, lr=args.lr, seed=0, device=dev,
    )
    t_train = time.time() - t0
    print(f"trained in {t_train:.1f}s", flush=True)

    candidates = {
        "alpha=0.75 (default)": 0.75,
        "alpha=0.8125": 0.8125,
        "learned schedule": alphas,
    }
    rows = []
    for snr in floats(args.eval_snrs):
        row = {"snr_db": snr}
        for name, a in candidates.items():
            r = evaluate_alphas(
                code, a, snr, args.iters, blocks=args.eval_blocks,
                batch=args.eval_batch, seed=1, device=dev,
            )
            row[name] = r
            print(f"  {snr:g} dB {name:22s} FER {r['fer']:.5f} "
                  f"BER {r['ber']:.2e} ({r['frames']} frames)", flush=True)
        rows.append(row)

    payload = {
        "code": code.name,
        "iters": args.iters,
        "train_snr_db": args.train_snr,
        "steps": args.steps,
        "alphas": alphas.tolist(),
        "final_loss": losses[-1],
        "train_seconds": t_train,
        "eval": rows,
    }
    (out / "results.json").write_text(json.dumps(payload, indent=1))

    lines = [
        f"# Learned min-sum weight schedule — {code.name}",
        "",
        "The decoder is differentiable in PyTorch, so the port trains its own",
        f"check-update weights: per-iteration alpha[t] (T={args.iters}),"
        f" adam on multiloss BCE,",
        f"{args.steps} steps of fresh noise at Eb/N0 {args.train_snr:g} dB"
        f" ({t_train:.0f}s on {device_label(dev)}). The reference's",
        "imperative per-edge loop cannot express this"
        " (see `ldpc_tpu_torch/analysis/learned_minsum.py`).",
        "",
        "Learned schedule: "
        + ", ".join(f"{a:.3f}" for a in alphas),
        "",
        "Paired FER (same noise stream per point, "
        f"{args.eval_blocks} frames, exact physics):",
        "",
        "| Eb/N0 (dB) | " + " | ".join(candidates) + " |",
        "|---|" + "---|" * len(candidates),
    ]
    for row in rows:
        lines.append(
            f"| {row['snr_db']:g} | "
            + " | ".join(f"{row[name]['fer']:.5f}" for name in candidates)
            + " |"
        )
    (out / "RESULTS.md").write_text("\n".join(lines) + "\n")
    print(f"wrote {out}/RESULTS.md")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
