"""MFU levers on the bench point: layer order and syndrome cadence on one card.

Counterpart of the JAX package's ``scripts/mfu_levers.py``. Measures, one
lever at a time, the throughput of:

* ``--layer-order paired``: disjoint-support base-row pairs per layered
  step (arithmetic-identical to a serial sweep in the flattened pair order);
* ``--check-every 2``: one syndrome check per two sweeps (detection
  coarsens to 2-sweep windows);
* both combined,

against the baseline (serial, a check every sweep), all under the
production dispatch (two-phase ``auto``) through K1 (K2 where ``auto``
splits). Method: ``bench.measure_point`` (median of ``--n-windows`` windows
of ``--n-batches`` batches, middle-window spread); then the baseline and
the winner again at bench depth (``--winner-batches``). FER is recorded per
lever: paired reorders layers and ce2 coarsens detection, so FER agreement
is statistical, not bit-exact.

Each lever's frame errors are held against the TPU record's
(``examples/mfu_levers/results.json``, 1,310,720 frames a lever, read
only) within 5 combined standard errors (``vs_record`` in its row);
:func:`main` returns 1 when one is not.

Writes ``<out>/results.json`` (default ``build/mfu_levers``).

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.mfu_levers``
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ldpc_tpu_torch.scripts.study import EXAMPLES

RECORD = EXAMPLES / "mfu_levers" / "results.json"

LEVERS = [
    # label, layer_order, check_every
    ("baseline", "serial", 1),
    ("paired", "paired", 1),
    ("ce2", "serial", 2),
    ("paired+ce2", "paired", 2),
]


def lever_vs_record(row: dict, rec: dict, frames: int) -> dict | None:
    """A lever's frame errors against the record's lever of that name."""
    from ldpc_tpu_torch.scripts.study import five_se

    ref = next((r for r in rec["rows"] if r["lever"] == row["lever"]), None)
    if ref is None:
        return None
    ref_frames = rec["n_windows"] * rec["n_batches"] * rec["batch"]
    return five_se(round(row["fer"] * frames), frames,
                   round(ref["fer"] * ref_frames), ref_frames)


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--code", default="builtin:wimax_1152_0.5.alist.txt")
    ap.add_argument("--snr", type=float, default=2.0)
    ap.add_argument("--iterations", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--n-batches", type=int, default=64)
    ap.add_argument("--n-windows", type=int, default=5)
    ap.add_argument("--winner-batches", type=int, default=320,
                    help="re-measure the best lever at bench depth")
    ap.add_argument("--out", default="build/mfu_levers")
    args = ap.parse_args(argv)

    from ldpc_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache()

    from ldpc_tpu_torch.bench import measure_point
    from ldpc_tpu_torch.scripts.study import device_label
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code
    from ldpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    label_dev = device_label(dev)
    code = load_code(args.code)
    print(f"# device={label_dev} code={code.name} @ {args.snr:g} dB",
          flush=True)

    def make_ex(layer_order, check_every):
        opts = SimOptions(
            matrix=code.name, blocks=args.batch, iterations=args.iterations,
            ber=True, fer=True, fidelity="exact", batch=args.batch, seed=0,
            speed=code.k / code.n, schedule="layered", quiet=True,
            layer_order=layer_order, check_every=check_every,
        )
        return PointExecutor(code, opts, device=dev)

    rows = []
    for label, lo, ce in LEVERS:
        ex = make_ex(lo, ce)
        med, windows, fer, bits = measure_point(
            ex, code, args.snr, batch=args.batch, n_batches=args.n_batches,
            n_windows=args.n_windows, warmup_batches=args.n_batches,
            warmup_runs=1,
        )
        frame_bits = args.n_batches * args.batch * code.k
        t = windows
        lo_t, hi_t = (t[-2], t[1]) if len(t) >= 4 else (t[-1], t[0])
        rows.append({
            "lever": label, "layer_order": lo, "check_every": ce,
            "kernel": ex.kernel_used, "fer": fer,
            "info_bits_per_s": bits,
            "info_bits_per_s_mid_lo": frame_bits / lo_t,
            "info_bits_per_s_mid_hi": frame_bits / hi_t,
            "window_times_s": windows,
        })
        base = rows[0]["info_bits_per_s"]
        print(f"{label:12s} kernel={ex.kernel_used} FER={fer:.2e} "
              f"bits/s={bits:,.0f} "
              f"[{rows[-1]['info_bits_per_s_mid_lo'] / 1e9:.2f}-"
              f"{rows[-1]['info_bits_per_s_mid_hi'] / 1e9:.2f} G] "
              f"x{bits / base:.3f} vs baseline", flush=True)

    rec = json.loads(RECORD.read_text())
    for row in rows:
        row["vs_record"] = lever_vs_record(row, rec, args.n_windows
                                           * args.n_batches * args.batch)
    outside = [r["lever"] for r in rows
               if not r.get("vs_record", {"within": True})["within"]]

    best = max(rows, key=lambda r: r["info_bits_per_s"])
    print(f"# winner: {best['lever']}; re-measuring at bench depth "
          f"({args.winner_batches} batches)", flush=True)
    deep = {}
    for label in dict.fromkeys(("baseline", best["lever"])):
        r = next(x for x in rows if x["lever"] == label)
        ex = make_ex(r["layer_order"], r["check_every"])
        med, windows, fer, bits = measure_point(
            ex, code, args.snr, batch=args.batch,
            n_batches=args.winner_batches, n_windows=3,
            warmup_batches=64, warmup_runs=1,
        )
        deep[label] = {
            "info_bits_per_s": bits, "fer": fer,
            "window_times_s": windows, "kernel": ex.kernel_used,
        }
        print(f"# deep {label}: {bits:,.0f} bits/s FER={fer:.2e}",
              flush=True)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "results.json").write_text(json.dumps({
        "device": label_dev, "code": code.name, "snr_db": args.snr,
        "iterations": args.iterations, "batch": args.batch,
        "n_batches": args.n_batches, "n_windows": args.n_windows,
        "rows": rows, "deep": deep,
    }, indent=1))
    print(f"# wrote {out}/results.json; outside 5 se of the record: "
          f"{outside}", flush=True)
    return 1 if outside else 0


if __name__ == "__main__":
    raise SystemExit(main())
