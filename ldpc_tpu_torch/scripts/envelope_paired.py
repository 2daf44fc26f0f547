"""Paired A/B re-statement of the envelope's auto-vs-off rows on one card.

Counterpart of the JAX package's ``scripts/envelope_paired.py``. The
envelope's unpaired windows cannot tell a few percent of dispatch cost from
drift of the host's load; here ``bench.measure_paired`` times ``auto`` and
``off`` back to back in each round, and the claim is the median per-round
ratio t_off / t_auto (above 1: ``auto`` faster) with its middle-round
spread. Where ``auto`` declines the split it runs the same kernels as
``off``, so the ratio is 1 less the probe batch and ``auto``'s overhead
measure, amortized over the point.

Writes ``<out>/paired.json`` (default ``build/two_phase_envelope``).

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.envelope_paired``
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

BATCH = 4096  # frames a batch, as in the JAX script


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--snrs", default="2.0,3.0,3.5")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--batches", type=int, default=64,
                    help="batches of BATCH frames per timed window")
    ap.add_argument("--out", default="build/two_phase_envelope")
    args = ap.parse_args(argv)

    from ldpc_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache()

    from ldpc_tpu_torch.bench import measure_paired, paired_ratio
    from ldpc_tpu_torch.scripts.study import device_label, floats
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code
    from ldpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    code = load_code("builtin:wimax_1152_0.5.alist.txt")
    batch = BATCH
    base = dict(
        matrix=code.name, blocks=batch, iterations=12, ber=True, fer=True,
        fidelity="exact", batch=batch, seed=0, speed=0.5,
        schedule="layered", layer_order="paired", check_every=2,
        quiet=True,
    )
    report = {"device": device_label(dev), "points": {}}

    for snr in floats(args.snrs):
        ex_off = PointExecutor(code, SimOptions(two_phase="off", **base),
                               device=dev)
        ex_auto = PointExecutor(code, SimOptions(two_phase="auto", **base),
                                device=dev)
        times = measure_paired(
            [("off", ex_off, snr), ("auto", ex_auto, snr)],
            batch=batch, n_batches=args.batches, n_rounds=args.rounds,
        )
        ratio, lo, hi = paired_ratio(times["off"], times["auto"])
        report["points"][str(snr)] = {
            "auto_kernel": ex_auto.kernel_used,
            "times_off_s": times["off"],
            "times_auto_s": times["auto"],
            "auto_over_off": ratio,  # >1: auto faster
            "mid_lo": lo, "mid_hi": hi,
        }
        print(f"{snr:.1f} dB: auto/off = x{ratio:.3f} [{lo:.3f}-{hi:.3f}] "
              f"(auto={ex_auto.kernel_used})", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "paired.json").write_text(json.dumps(report, indent=1))
    print(f"# wrote {out}/paired.json", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
