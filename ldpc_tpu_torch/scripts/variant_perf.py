"""Fused-kernel throughput and FER per decoder variant at the bench point.

Counterpart of the JAX package's ``scripts/variant_perf.py`` on one card.
For each decoder variant at the wimax_1152_0.5 / Eb/N0 2 dB / layered
operating point, times ``run_point`` windows (``bench.measure_point``,
median) through K1 (K2 where two-phase ``auto`` splits) and reports FER:
the data for deciding whether a transcendental-free min-sum variant can
replace SPA without conceding error-correction quality.

Each row's frame errors are held against the TPU record's row of the same
decoder and iterations (the table "Throughput at the bench operating
point" of ``examples/decoder_variants/README.md``, 3 windows of 64 batches
of 4096 = 786,432 frames a row, its FERs rounded to two significant figures,
which moves a count by at most 0.5% of itself) within 5 combined standard
errors (``vs_record``).

A configuration that raises is reported as ``FAILED`` and the sweep goes on,
but :func:`main` then returns 1, as it does when a row is outside its
record's 5 combined standard errors.

Writes ``<out>/results.json`` (default ``build/variant_perf``).

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.variant_perf [config ...]``
  config = variant:iters[:alpha[:beta]][+int8msg on the variant]
  e.g. normalized_minsum:12:0.8125 or normalized_minsum+int8msg:12
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path

from ldpc_tpu_torch.scripts.study import EXAMPLES

CODE = "builtin:wimax_1152_0.5.alist.txt"
BATCH = 4096  # frames a batch, as in the JAX script
RECORD = EXAMPLES / "decoder_variants" / "README.md"
RECORD_FRAMES = 3 * 64 * 4096

DEFAULT_CONFIGS = [
    ("spa", 12, 0.75, 0.15, "f32"),
    ("normalized_minsum", 12, 0.75, 0.15, "f32"),
    ("normalized_minsum", 12, 0.8125, 0.15, "f32"),
    ("normalized_minsum", 12, 0.875, 0.15, "f32"),
    ("offset_minsum", 12, 0.75, 0.15, "f32"),
    ("minsum", 12, 0.75, 0.15, "f32"),
]


def parse_config(arg: str) -> tuple[str, int, float, float, str]:
    """``variant[+int8msg]:iters[:alpha[:beta]]`` -> (variant, iters, alpha,
    beta, msg_store), with the JAX script's defaults (12, 0.75, 0.15,
    f32)."""
    parts = arg.split(":")
    v = parts[0]
    store = "f32"
    if v.endswith("+int8msg"):
        v, store = v[: -len("+int8msg")], "int8"
    it = int(parts[1]) if len(parts) > 1 else 12
    a = float(parts[2]) if len(parts) > 2 else 0.75
    b = float(parts[3]) if len(parts) > 3 else 0.15
    return v, it, a, b, store


def record_label(variant: str, iters: int, alpha: float, beta: float) -> str:
    """The record table's first cell for a configuration."""
    return {
        "spa": "SPA",
        "normalized_minsum": f"normalized min-sum \u03b1={alpha:g}",
        "offset_minsum": f"offset min-sum \u03b2={beta:g}",
        "minsum": "plain min-sum",
    }.get(variant, variant)


def record_fers(text: str) -> dict[tuple[str, int], float]:
    """{(decoder, iters): FER} of the record's throughput table."""
    fers, inside = {}, False
    for line in text.splitlines():
        if line.startswith("| decoder | iters | FER"):
            inside = True
            continue
        if inside and line.startswith("|"):
            cells = [c.strip() for c in line.strip("|").split("|")]
            if not set(cells[0]) <= set("-"):
                fers[(cells[0], int(cells[1]))] = float(cells[2])
        elif inside:
            break
    return fers


def measure(code, variant, iters, alpha=0.75, beta=0.15,
            n_batches=64, n_windows=3, batch=BATCH, msg_store="f32",
            device=None) -> dict:
    """One variant's row: FER and median-window info bits/s."""
    from ldpc_tpu_torch.bench import measure_point
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor

    opts = SimOptions(
        matrix=code.path or code.name, blocks=batch, iterations=iters,
        ber=True, fer=True, fidelity="exact", batch=batch, seed=0,
        speed=0.5, schedule="layered",
        decoder=("sum-product" if variant == "spa" else variant),
        minsum_alpha=alpha, minsum_beta=beta, msg_store=msg_store,
    )
    ex = PointExecutor(code, opts, device=device)
    # the bench's timing method, shorter windows: the table compares
    # variants within one process, not across documents
    med, _, fer, bits = measure_point(
        ex, code, 2.0, batch=batch, n_batches=n_batches,
        n_windows=n_windows, warmup_batches=n_batches, warmup_runs=1,
    )
    tag = variant + ("+int8msg" if msg_store == "int8" else "")
    print(
        f"{tag:26s} it={iters:2d} a={alpha:.4f} b={beta:.2f} "
        f"kernel={ex.kernel_used} FER={fer:.5f} "
        f"med_window={med:.3f}s bits/s={bits:,.0f}",
        flush=True,
    )
    return {"kernel": ex.kernel_used, "fer": fer, "median_window_s": med,
            "info_bits_per_s": bits, "frames": n_windows * n_batches * batch}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="*",
                    help="variant[+int8msg]:iters[:alpha[:beta]]")
    ap.add_argument("--n-batches", type=int, default=64)
    ap.add_argument("--n-windows", type=int, default=3)
    ap.add_argument("--out", default="build/variant_perf")
    args = ap.parse_args(argv)

    from ldpc_tpu_torch.scripts.study import device_label, five_se
    from ldpc_tpu_torch.sim.runner import load_code
    from ldpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    label = device_label(dev)
    code = load_code(CODE)
    print(f"# device={label} code={code.name}", flush=True)
    configs = [parse_config(a) for a in args.configs] or DEFAULT_CONFIGS
    ref = record_fers(RECORD.read_text())
    rows, failed = [], 0
    for v, it, a, b, store in configs:
        row = {"variant": v, "iterations": it, "alpha": a, "beta": b,
               "msg_store": store}
        try:
            row.update(measure(code, v, it, a, b, n_batches=args.n_batches,
                               n_windows=args.n_windows, batch=BATCH,
                               msg_store=store, device=dev))
        except Exception as e:  # record, report, keep sweeping
            traceback.print_exc()
            failed += 1
            row["error"] = f"{type(e).__name__}: {e}"
            print(f"{v} it={it} FAILED: {row['error']}", flush=True)
        else:
            fer = ref.get((record_label(v, it, a, b), it))
            if fer is not None and store == "f32":
                row["vs_record"] = five_se(
                    round(row["fer"] * row["frames"]), row["frames"],
                    round(fer * RECORD_FRAMES), RECORD_FRAMES)
                failed += not row["vs_record"]["within"]
        rows.append(row)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "results.json").write_text(json.dumps(
        {"device": label, "code": code.name, "snr_db": 2.0,
         "batch": BATCH, "n_batches": args.n_batches,
         "n_windows": args.n_windows, "rows": rows}, indent=1))
    print(f"# wrote {out}/results.json; {failed} failed or outside 5 se of "
          "the record", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
