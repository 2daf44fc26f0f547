"""Decode EVERY QC built-in through the port's kernels on the card.

Counterpart of the JAX package's ``scripts/family_tpu_validation.py``. One
Monte-Carlo batch per built-in code -- the fused kernel K1 where eligible
(in-kernel Philox noise), flooding schedule -- at an SNR chosen so the
decoder does real work, recording the kernel, the block's shared memory
(``ops.mc_kernels.fused_plan``, where the JAX script records the VMEM
plan), FER and convergence. A second pass covers the layered schedule for
one code per family (incl. the multi-diagonal CCSDS family).

A code that raises is recorded in the table with its error and the sweep
goes on, but :func:`main` then returns 1.

Writes ``--out`` (default ``build/family_validation/RESULTS.md``).

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.family_validation``
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

# the layered pass: one representative per family
LAYERED_TARGETS = [
    "wimax_2304_0.5.alist.txt", "wimax_576_0.5.alist.txt",
    "wimax_2304_0.83.alist.txt", "wifi_648_r083.alist.txt",
    "wigig_R05_N672_K336.alist.txt", "CCSDS_ldpc_n512_k256.alist.txt",
    "CCSDS_ldpc_n32_k16.alist.txt", "Tanner_155_64.alist.txt",
    "LDPC_N336_K196_ITU_G.h.alist.txt",
    "WRAN_N384_K192_P16_R05.txt",
]


def block_smem(ex) -> int:
    """Shared memory of one block of the executor's decode kernel, in
    bytes: the fused plan of K1 (``fused_plan``), or K3's where the
    executor runs unfused."""
    dec = ex._mc_full if ex.fused else ex._decoder
    return dec.plan.smem


def run_code(name: str, schedule: str, blocks: int = 256, iters: int = 8,
             device=None):
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code

    code = load_code(name)
    if code.qc is None:
        return None
    # Eb/N0 ~1 dB above a rate-dependent threshold proxy: high-rate codes
    # need more SNR to reach a working point; this only needs the decoder to
    # do non-trivial work, not a calibrated waterfall.
    snr = 1.5 + 4.0 * max(code.rate - 0.5, 0.0)
    opts = SimOptions(
        matrix=name, blocks=blocks, iterations=iters, ber=True, fer=True,
        fidelity="exact", batch=blocks, seed=0, schedule=schedule, quiet=True,
    )
    t0 = time.time()
    ex = PointExecutor(code, opts, device=device)
    stats = ex.run_point(snr, blocks, 1, 0)
    dt = time.time() - t0
    return {
        "name": name, "n": code.n, "k": code.k, "Z": code.qc.Z,
        "schedule": schedule, "kernel": ex.kernel_used,
        "smem_kb": round(block_smem(ex) / 1024, 1), "snr": snr,
        "fer": stats.fer_frames / max(stats.blocks, 1),
        "ok": stats.ok_blocks, "blocks": stats.blocks,
        "avg_conv": (stats.conv_iters_sum / stats.conv_count
                     if stats.conv_count else -1.0),
        "seconds": round(dt, 3),
    }


def sweep(names, schedule: str, dev, tag: str) -> list[dict]:
    """``run_code`` over ``names``; a code that raises becomes a row with
    its error (the traceback is printed) and the sweep goes on."""
    rows = []
    for i, name in enumerate(names):
        try:
            r = run_code(name, schedule, device=dev)
        except Exception as e:  # record, report, keep sweeping
            traceback.print_exc()
            rows.append({"name": name, "error": f"{type(e).__name__}: {e}"})
            print(f"[{tag} {i + 1}/{len(names)}] {name}: FAILED {e}",
                  flush=True)
            continue
        if r is None:
            print(f"[{tag} {i + 1}/{len(names)}] {name}: not QC (plain "
                  "decoder path)", flush=True)
            continue
        rows.append(r)
        print(f"[{tag} {i + 1}/{len(names)}] {name}: {r['kernel']} "
              f"smem={r['smem_kb']}KB fer={r['fer']:.3f} "
              f"ok={r['ok']}/{r['blocks']} {r['seconds']}s", flush=True)
    return rows


def write_results(path: str, dev_label: str, rows, lrows,
                  minutes: float) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(
            "# Validation of the port's kernels across the whole built-in "
            "family\n\n"
            f"Device: {dev_label}. One 256-codeword batch per code at a "
            "rate-adjusted waterfall-ish SNR, 8 iterations, `--fidelity "
            "exact`; kernel auto-selection (the fused Monte-Carlo kernel K1 "
            "where eligible). `smem KB` is the decode kernel's shared memory "
            "per block. Generated by `python -m "
            f"ldpc_tpu_torch.scripts.family_validation` in {minutes:.1f} "
            "min.\n\n"
            "## Flooding schedule (all QC builtins)\n\n"
            "| code | n | k | Z | kernel | smem KB | SNR | FER | ok | avg conv | s |\n"
            "|---|---|---|---|---|---|---|---|---|---|---|\n"
        )
        for r in rows:
            if "error" in r:
                f.write(f"| {r['name']} | ERROR: {r['error']} |\n")
            else:
                f.write(
                    f"| {r['name']} | {r['n']} | {r['k']} | {r['Z']} "
                    f"| {r['kernel']} | {r['smem_kb']} | {r['snr']:.1f} "
                    f"| {r['fer']:.4f} | {r['ok']}/{r['blocks']} "
                    f"| {r['avg_conv']:.1f} | {r['seconds']} |\n"
                )
        f.write(
            "\n## Layered schedule (family representatives, incl. "
            "multi-diagonal CCSDS)\n\n"
            "| code | n | Z | kernel | smem KB | FER | ok | avg conv | s |\n"
            "|---|---|---|---|---|---|---|---|---|\n"
        )
        for r in lrows:
            if "error" in r:
                f.write(f"| {r['name']} | ERROR: {r['error']} |\n")
            else:
                f.write(
                    f"| {r['name']} | {r['n']} | {r['Z']} | {r['kernel']} "
                    f"| {r['smem_kb']} | {r['fer']:.4f} "
                    f"| {r['ok']}/{r['blocks']} | {r['avg_conv']:.1f} "
                    f"| {r['seconds']} |\n"
                )


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/family_validation/RESULTS.md")
    ap.add_argument("--layered-all", action="store_true",
                    help="layered pass for every code (default: one per family)")
    args = ap.parse_args(argv)

    from ldpc_tpu_torch.models.standards import builtin_names
    from ldpc_tpu_torch.scripts.study import device_label
    from ldpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    label = device_label(dev)
    t_start = time.time()
    rows = sweep(builtin_names(), "flooding", dev, "flooding")
    layered_targets = LAYERED_TARGETS
    if args.layered_all:
        layered_targets = [r["name"] for r in rows if "error" not in r]
    lrows = sweep(layered_targets, "layered", dev, "layered")
    total = time.time() - t_start
    write_results(args.out, label, rows, lrows, total / 60)
    n_err = sum(1 for r in rows + lrows if "error" in r)
    print(f"done: {len(rows)} flooding + {len(lrows)} layered rows, "
          f"{n_err} errors, {total / 60:.1f} min -> {args.out}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
