"""Large custom LDPC codes (n >= 4096) end to end on one card.

Counterpart of the JAX package's ``scripts/big_code_study.py``. Generates
rate-1/2 girth->=6 QC codes on the 802.16e base graph at Z=192 (n=4608)
and Z=384 (n=9216) (``models.generate.wimax_like(Z, seed=5)``), writes
their ALIST files (each byte-equal to the committed
``examples/big_code/wimax_like_n{24Z}_z{Z}.alist.txt``), and runs:

1. **Load-time GF(2) elimination** timed: ``load_code`` (the packed rref,
   the generator and its ``G H^T = 0`` validation).
2. **The shared-memory plan** (``smem_plan``; the JAX script's VMEM plan
   is a TPU matter): for each schedule x message store, the bytes of one
   block of K1 and K3 (``ops.mc_kernels.block_layout``, paired layers
   where layered), its threads, whether it fits a block's shared memory,
   and its resident blocks per SM on the card.
3. **Throughput** at a waterfall point (``bench.measure_point``, the
   production dispatch: layered SPA-12, paired, two-phase ``auto``) with the
   census ceiling of the dispatch that ran (``perf_matrix.row_ceiling``).
   A check every 2 sweeps where the executor runs a kernel; where it routes
   to a plain PyTorch decoder (``kernel_used`` base ``torch``), a check
   every sweep and at most 120,000 frames a curve point, as the JAX script
   does where its kernels do not fit.
4. **Waterfall curves** with a per-point early stop (``--target-errors``)
   through the fused path (interleaver ``none``: K1) and through the
   S-random interleaver chain (``srandom``: the unfused path, K3), each
   point against the committed ``curve_<name>_<il>.json`` (5 combined
   standard errors; the TPU ran n=9216 on its XLA fallback at a check every
   sweep, so the comparison is of the statistic, not the path).

Outputs go to ``--out`` (default ``build/big_code``), where
``results.json`` is merged into; the committed ``examples/big_code`` is
read as the record only. :func:`main` returns 1 when an ALIST differs from
the record or a frame-error count is outside 5 combined standard errors of
it.

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.big_code_study``
"""

from __future__ import annotations

import argparse
import filecmp
import json
import time
from pathlib import Path

from ldpc_tpu_torch.scripts.study import EXAMPLES

SNR_GRID = {
    192: (1.0, 2.2, 0.2),
    384: (0.9, 1.9, 0.2),
}
RECORD = EXAMPLES / "big_code"
PLAIN_MAX_BLOCKS = 120_000  # a curve point's cap on a plain decoder


def smem_plan(qc, device) -> dict:
    """K1's and K3's block for each schedule x E store: bytes, threads,
    whether it fits, and resident blocks per SM (None off the card)."""
    from ldpc_tpu_torch.models.qc import paired_layer_groups
    from ldpc_tpu_torch.ops.decode_loop import build_tables
    from ldpc_tpu_torch.ops.mc_kernels import (
        K_MC,
        K_QC,
        block_layout,
        blocks_per_sm,
        plan_fits,
    )

    plan = {}
    for sched in ("layered", "flooding"):
        flood = sched == "flooding"
        tables = build_tables(qc, None if flood else paired_layer_groups(qc))
        for store in ("f32", "int8"):
            p = block_layout(tables, flood, store == "int8")
            fits = plan_fits(p)
            for tag, kind in (("K1", K_MC), ("K3", K_QC)):
                plan[f"{tag}/{sched}/{store}"] = {
                    "bytes": p.smem, "threads": p.threads, "fits": fits,
                    "blocks_per_sm": (blocks_per_sm(kind, tables, p, device)
                                      if fits and device.type == "cuda"
                                      else None),
                }
    return plan


def on_kernel(kernel_used: str) -> bool:
    """Whether an executor runs one of the port's kernels (K1-K3, or their
    plain versions on the CPU) and not a plain PyTorch decoder."""
    return not kernel_used.startswith("torch")


def curve_vs_record(points: list[dict], record: Path) -> list[dict]:
    """Each curve point's frame errors against the record's point at the
    same Eb/N0 (5 combined standard errors)."""
    from ldpc_tpu_torch.scripts.study import five_se

    rec = {round(p["snr_db"], 6): p for p in
           json.loads(record.read_text())["snr_points"]}
    out = []
    for p in points:
        r = rec.get(round(p["snr_db"], 6))
        if r is None:
            continue
        out.append({"snr_db": p["snr_db"], **five_se(
            round(p["fer"] * p["blocks"]), p["blocks"],
            round(r["fer"] * r["total_blocks"]), r["total_blocks"])})
    return out


def perf_vs_record(perf: dict, rec: dict, k: int) -> dict:
    """The perf window's frame errors against the record's perf point,
    whose frames a window follow from its median window and rate."""
    from ldpc_tpu_torch.scripts.study import five_se

    w = sorted(rec["window_times_s"])
    frames = len(w) * round(rec["info_bits_per_s"] * w[len(w) // 2] / k)
    return five_se(round(perf["fer"] * perf["frames"]), perf["frames"],
                   round(rec["fer"] * frames), frames)


def faults(entry: dict) -> list[str]:
    """What in one code's entry disagrees with the record: the ALIST, or
    a frame-error count outside 5 combined standard errors."""
    bad = [] if entry["alist_equals_record"] is not False else ["alist"]
    perf = entry["perf"].get("vs_record")
    if perf is not None and not perf["within"]:
        bad.append(f"perf {entry['perf']['snr_db']} dB")
    for il in ("none", "srandom"):
        for c in entry.get(f"curve_{il}", {}).get("vs_record", []):
            if not c["within"]:
                bad.append(f"curve {il} {c['snr_db']:.2f} dB")
    return bad


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/big_code")
    ap.add_argument("--zs", default="192,384")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--target-errors", type=int, default=150)
    ap.add_argument("--max-blocks", type=int, default=2_000_000)
    ap.add_argument("--n-windows", type=int, default=5)
    ap.add_argument("--n-batches", type=int, default=64)
    ap.add_argument("--skip-interleaver", action="store_true")
    args = ap.parse_args(argv)

    from ldpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)

    from ldpc_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache()

    from ldpc_tpu_torch.analysis.roofline import issue_peak_ops_per_s
    from ldpc_tpu_torch.bench import measure_point
    from ldpc_tpu_torch.models.generate import wimax_like, write_alist
    from ldpc_tpu_torch.scripts.perf_matrix import row_ceiling
    from ldpc_tpu_torch.scripts.study import device_label
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code, run_simulation

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    label = device_label(dev)
    # the record's codes; a code it lacks (a Z of neither record) is
    # compared with nothing
    record_codes = json.loads((RECORD / "results.json").read_text())["codes"]
    results: dict = {"device": label, "codes": {}}
    prev = out / "results.json"
    if prev.is_file():
        results = json.loads(prev.read_text())
        results["device"] = label
    # the ceiling is a device figure: priced only on the card
    peak = issue_peak_ops_per_s() if dev.type == "cuda" else None

    bad: list[str] = []
    for Z in (int(z) for z in args.zs.split(",")):
        name = f"wimax_like_n{24 * Z}_z{Z}"
        alist_path = out / f"{name}.alist.txt"
        t0 = time.perf_counter()
        al = wimax_like(Z, seed=5)
        t_gen = time.perf_counter() - t0
        write_alist(al, str(alist_path))
        ref = record_codes.get(name)
        t0 = time.perf_counter()
        code = load_code(str(alist_path))
        t_load = time.perf_counter() - t0
        entry = {
            "n": code.n, "k": code.k, "rate": code.rate, "Z": Z,
            "gen_s": t_gen,
            "load_rref_G_validate_s": t_load,
            "alist_equals_record": (
                filecmp.cmp(alist_path, RECORD / alist_path.name,
                            shallow=False) if ref is not None else None),
            "smem_plan": smem_plan(code.qc, dev),
        }
        print(f"# {name}: n={code.n} k={code.k} "
              f"load(rref+G+validate)={t_load:.1f}s alist equals the "
              f"record: {entry['alist_equals_record']}", flush=True)

        # ---- throughput at a waterfall point, production dispatch ----
        lo, hi, step = SNR_GRID[Z]
        snr_perf = (lo + hi) / 2
        base = dict(
            matrix=str(alist_path), iterations=12, ber=True, fer=True,
            fidelity="exact", batch=args.batch, speed=code.k / code.n,
            schedule="layered", layer_order="paired", two_phase="auto",
            quiet=True,
        )
        opts = SimOptions(blocks=args.batch, seed=0, check_every=2, **base)
        ex = PointExecutor(code, opts, device=dev)
        kernel_ok = on_kernel(ex.kernel_used)
        max_blocks = args.max_blocks
        if not kernel_ok:
            # a plain decoder: a check every sweep (the cadence is a kernel
            # knob) and shallower curve points
            max_blocks = min(max_blocks, PLAIN_MAX_BLOCKS)
            opts = SimOptions(blocks=args.batch, seed=0, check_every=1,
                              **base)
            ex = PointExecutor(code, opts, device=dev)
        med, windows, fer, bits = measure_point(
            ex, code, snr_perf, batch=args.batch, n_batches=args.n_batches,
            n_windows=args.n_windows, warmup_batches=args.n_batches,
            warmup_runs=1,
        )
        entry["perf"] = {
            "snr_db": snr_perf, "kernel": ex.kernel_used, "fer": fer,
            "info_bits_per_s": bits, "window_times_s": windows,
            "frames": args.n_windows * args.n_batches * args.batch,
        }
        print(f"#   perf @ {snr_perf} dB: {bits / 1e9:.2f} G bits/s "
              f"kernel={ex.kernel_used} FER={fer:.2e}", flush=True)
        if ref is not None:
            entry["perf"]["vs_record"] = perf_vs_record(entry["perf"],
                                                        ref["perf"], code.k)

        # census ceiling of the dispatch that ran (the fused path only)
        if "+fused" in ex.kernel_used and peak is not None:
            ceil = row_ceiling(code, opts, snr_perf, ex.kernel_used,
                               peak=peak, device=dev)
            entry["ceiling_info_bits_per_s"] = ceil["ceiling_info_bits_per_s"]
            entry["pct_of_ceiling"] = round(
                100 * bits / ceil["ceiling_info_bits_per_s"], 1)
            print(f"#   ceiling {ceil['ceiling_info_bits_per_s'] / 1e9:.2f} G"
                  f" -> {entry['pct_of_ceiling']}% of light", flush=True)

        # ---- waterfall with per-point early stop ----
        # the interleaver takes the unfused path (K3), which routes a QC
        # code to a kernel exactly where the fused path does
        for il in (["none"] if args.skip_interleaver else ["none", "srandom"]):
            curve = out / f"curve_{name}_{il}.json"
            sweep_opts = SimOptions(
                blocks=max_blocks, seed=1, check_every=opts.check_every,
                interleaver=il, target_errors=args.target_errors,
                initial_snr=lo, end_snr=hi, step_snr=step,
                output_json=str(curve), **base,
            )
            t0 = time.perf_counter()
            res = run_simulation(sweep_opts, code=code, device=dev)
            points = [
                {"snr_db": p.snr_db, "fer": p.fer, "ber": p.ber,
                 "blocks": p.total_blocks}
                for p in res.snr_points
            ]
            entry[f"curve_{il}"] = {
                "points": points,
                "wall_s": time.perf_counter() - t0,
            }
            if ref is not None:
                entry[f"curve_{il}"]["vs_record"] = curve_vs_record(
                    points, RECORD / curve.name)
            for p in points:
                print(f"#   [{il}] {p['snr_db']:.2f} dB FER {p['fer']:.3e} "
                      f"({p['blocks']} blocks)", flush=True)

        results["codes"][name] = entry
        (out / "results.json").write_text(json.dumps(results, indent=1))
        bad += [f"{name} {what}" for what in faults(entry)]
    print(f"# wrote {out}/results.json; against the record: "
          f"{'; '.join(bad) or 'all equal or within 5 se'}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
