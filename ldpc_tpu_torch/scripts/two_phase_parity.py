"""Hardware parity check: two-phase fused dispatch against a single pass.

Counterpart of the JAX package's ``scripts/tpu_two_phase_parity.py`` on a
CUDA card. Phase 2 is a kernel of its own (K2 ``llr_decoder``) fed the
compacted LLRs phase 1 of K1 emits, so a difference between the compiled
programs could perturb results, which would break the checkpoint
fingerprint's exclusion of ``two_phase`` (``sim.runner.sweep_fingerprint``).
Here the production dispatch runs on the card, two-phase {explicit N,
``auto``} against ``off``, same seeds, across operating points from FER ~1
to FER ~1e-4 and two decoder configurations, and EVERY counter must be
equal, ``norm_llr_sum`` included.

The norm-LLR boundary: the runner refuses an explicit split when
``--normalized-llr`` is tracked (a float accumulator whose rounding may
follow the program's reduction order), and ``auto`` then runs a single
pass; this script checks both, so the contract is total: in every
configuration two-phase dispatch can run in, all counters are equal.

Writes ``<out>`` (default ``build/parity_runs/two_phase.json``); returns 1
on any violation. Needs a CUDA device whatever ``device`` says: on the CPU
both dispatch modes run the kernels' plain versions, which proves nothing
about the kernels.

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.two_phase_parity``
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

CASES = [
    # (code, schedule, decoder, iterations, snr points)
    ("builtin:wimax_1152_0.5.alist.txt", "layered", "sumproduct", 12,
     [0.0, 2.0, 2.5]),
    ("builtin:wimax_576_0.5.alist.txt", "flooding", "normalized-minsum",
     20, [1.0, 3.0]),
]
BLOCKS = 4096 * 8


def counters(stats) -> dict:
    return {
        "blocks": stats.blocks,
        "ok_blocks": stats.ok_blocks,
        "error_bits": stats.error_bits,
        "fer_frames": stats.fer_frames,
        "norm_llr_sum": stats.norm_llr_sum,
        "conv_iters_sum": stats.conv_iters_sum,
        "conv_count": stats.conv_count,
    }


def parity_rows(cases, blocks: int, device) -> list[dict]:
    """One row per (case, SNR): the counters of ``off`` and whether the
    explicit split (``iterations // 2``) and ``auto`` give the same."""
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code

    rows = []
    for matrix, schedule, variant, iters, snrs in cases:
        code = load_code(matrix)
        base = dict(
            matrix=matrix, blocks=blocks, iterations=iters, ber=True,
            fer=True, fidelity="exact", batch=min(blocks, 4096),
            seed=7, speed=0.5, schedule=schedule, decoder=variant,
        )
        execs = {
            tp: PointExecutor(code, SimOptions(two_phase=tp, **base),
                              device=device)
            for tp in ("off", str(iters // 2), "auto")
        }
        for snr in snrs:
            row = {"code": code.name, "schedule": schedule,
                   "variant": variant, "iterations": iters, "snr_db": snr}
            outs = {}
            for tp, ex in execs.items():
                s = ex.run_point(snr, blocks, 7, int(snr * 2))
                outs[tp] = counters(s)
                row[f"kernel[{tp}]"] = ex.kernel_used
            row["counters"] = outs["off"]
            row["match"] = all(outs[tp] == outs["off"] for tp in outs)
            if not row["match"]:
                row["mismatch"] = {tp: outs[tp] for tp in outs
                                   if outs[tp] != outs["off"]}
            fer = outs["off"]["fer_frames"] / blocks
            print(f"{code.name} {schedule}/{variant} @ {snr:g} dB "
                  f"FER={fer:.2e}: "
                  f"{'MATCH' if row['match'] else 'MISMATCH'}", flush=True)
            rows.append(row)
    return rows


def norm_gate(device) -> dict:
    """Where norm-LLR is tracked, an explicit split raises ``ValueError``
    and ``auto`` runs a single pass."""
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code

    code = load_code("builtin:wimax_576_0.5.alist.txt")
    norm_opts = dict(
        matrix=code.name, blocks=4096, iterations=20, ber=True, fer=True,
        normalized_llr=True, fidelity="exact", batch=4096, seed=7,
        speed=0.5, schedule="flooding", decoder="normalized-minsum",
    )
    try:
        PointExecutor(code, SimOptions(two_phase="10", **norm_opts),
                      device=device)
        raises = False
    except ValueError:
        raises = True
    ex = PointExecutor(code, SimOptions(two_phase="auto", **norm_opts),
                       device=device)
    gate = {"norm_llr_explicit_raises": raises,
            "norm_llr_auto_single_phase": "2phase" not in ex.kernel_used}
    print(f"norm-LLR gate: explicit raises={raises} auto single-phase="
          f"{gate['norm_llr_auto_single_phase']}", flush=True)
    return gate


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/parity_runs/two_phase.json")
    args = ap.parse_args(argv)

    from ldpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the two-phase parity check needs a CUDA device: "
                           f"{dev} runs the kernels' plain versions")

    from ldpc_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache()

    from ldpc_tpu_torch.scripts.study import device_label

    rows = parity_rows(CASES, BLOCKS, dev)
    report = {"device": device_label(dev), "blocks": BLOCKS, "cases": rows,
              **norm_gate(dev)}
    failures = sum(not r["match"] for r in rows) + sum(
        not report[k] for k in ("norm_llr_explicit_raises",
                                "norm_llr_auto_single_phase"))
    report["all_match"] = failures == 0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}; all_match={report['all_match']}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
