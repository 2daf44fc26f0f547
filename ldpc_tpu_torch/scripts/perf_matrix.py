"""Throughput matrix: codes x rates x schedules x decoders on one card.

Counterpart of the JAX package's ``scripts/perf_matrix.py``: the same 13
codes (the {576, 1152, 2304} x {r1/2, r5/6} WiMAX grid and one row per
other family of the reference database) x the same 4 decoder
configurations. Each cell reports the median of ``--n-windows`` timed
windows of ``--n-batches`` batches (``ldpc_tpu_torch.bench.measure_point``,
the bench's method: ``run_point`` through the fused kernels K1 / K2,
two-phase ``auto``) with the middle-window spread, and every row carries
its census speed-of-light ceiling (``analysis.roofline``) at the row's
measured mean block trips (K1, ``measure_tile_trips``), priced at the
card's issue peak for the dispatch the spa/layered cell used.

Operating points are matched: each code runs at the Eb/N0 where its
layered-12 SPA FER lands in [2e-3, 3e-2] (a coarse probe on the card, shared
by all four decoder configurations of the row).

Writes ``<out>/{results.json,README.md}`` (default ``build/perf_matrix``),
flushing ``results.json`` after each code; resumes nothing.

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.perf_matrix [--codes ...]``
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ldpc_tpu_torch.scripts.roofline import TWO_PHASE_RAN

CODES = [
    # (builtin name, probe start Eb/N0)
    ("wimax_576_0.5.alist.txt", 2.4),
    ("wimax_1152_0.5.alist.txt", 2.0),
    ("wimax_2304_0.5.alist.txt", 1.8),
    ("wimax_576_0.83.alist.txt", 4.2),
    ("wimax_1152_0.83.alist.txt", 3.8),
    ("wimax_2304_0.83.alist.txt", 3.6),
    # one row per non-WiMAX family in the reference database
    ("wifi_648_r083.alist.txt", 4.2),
    ("wigig_R05_N672_K336.alist.txt", 2.8),
    ("ieee_802_11ad_p42_n672_r081.alist.txt", 4.4),
    ("CCSDS_ldpc_n128_k64.alist.txt", 4.6),
    ("CCSDS_ldpc_n32_k16.alist.txt", 6.4),
    ("WRAN_N384_K192_P16_R05.txt", 3.0),
    ("LDPC_N336_K196_ITU_G.h.alist.txt", 3.2),
]

CONFIGS = [
    # (label, decoder, schedule, iterations, alpha)
    ("spa/layered-12", "sum-product", "layered", 12, 0.75),
    ("spa/flooding-20", "sum-product", "flooding", 20, 0.75),
    ("nms/layered-12", "normalized-minsum", "layered", 12, 0.8125),
    ("nms/flooding-20", "normalized-minsum", "flooding", 20, 0.8125),
]

def make_executor(code, decoder, schedule, iterations, alpha, batch,
                  device=None):
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor

    opts = SimOptions(
        matrix=code.name, blocks=batch, iterations=iterations,
        ber=True, fer=True, fidelity="exact", batch=batch, seed=0,
        speed=code.k / code.n, schedule=schedule, decoder=decoder,
        minsum_alpha=alpha, quiet=True,
        # the production decode-loop dispatch the bench runs: layered rows
        # take the paired order; every row the ce2 cadence
        layer_order="paired" if schedule == "layered" else "serial",
        check_every=2,
    )
    return PointExecutor(code, opts, device=device)


def probe_operating_point(code, snr0, batch, device=None
                          ) -> tuple[float, float]:
    """Eb/N0 with layered-12 SPA FER in [2e-3, 3e-2] (quarter-dB steps)."""
    ex = make_executor(code, "sum-product", "layered", 12, 0.75, batch,
                       device)

    def fer_at(snr):
        s = ex.run_point(snr, batch * 8, 17, 0)
        return s.fer_frames / s.blocks

    snr = snr0
    for _ in range(12):
        f = fer_at(snr)
        print(f"#   probe {code.name} @ {snr:.2f} dB -> FER {f:.2e}",
              flush=True)
        if 2e-3 <= f <= 3e-2:
            return snr, f
        snr += 0.25 if f > 3e-2 else -0.25
    return snr, f  # give up adjusting; report what we have


def row_ceiling(code, opts, snr, kernel_used: str, *, peak: float,
                device=None) -> dict | None:
    """Census speed-of-light for this row's spa/layered config at the issue
    peak ``peak``, priced for the dispatch mode the cell actually ran."""
    from ldpc_tpu_torch.analysis.roofline import (
        measure_tile_trips,
        speed_of_light,
        speed_of_light_two_phase,
    )
    from ldpc_tpu_torch.sim.runner import resolve_two_phase

    if code.qc is None:
        return None
    tile_iters, trip_model = measure_tile_trips(code, opts, snr, batches=4,
                                                device=device)
    kw = dict(
        k=code.k, variant="spa", schedule="layered", mode=1,
        track_norm=False, check_every=opts.check_every, peak_ops_per_s=peak,
    )
    two_phase = bool(TWO_PHASE_RAN.search(kernel_used))
    if two_phase:
        phase1 = resolve_two_phase(
            "auto", opts.iterations, opts.check_every
        ) or opts.iterations // 2
        sol = speed_of_light_two_phase(
            code.qc, phase1=phase1, trip_model=trip_model, **kw
        )
    else:
        sol = speed_of_light(code.qc, mean_tile_iters=tile_iters, **kw)
    return {
        "ceiling_info_bits_per_s": sol["ceiling_info_bits_per_s"],
        "two_phase": two_phase,
        "mean_tile_iters": tile_iters,
        "trip_model": trip_model,
    }


def _spread_lo(r: dict) -> float:
    """Row spread floor, with fallbacks for rows that lack the mid-window
    and the min/max fields."""
    return r.get("info_bits_per_s_mid_lo",
                 r.get("info_bits_per_s_min", r["info_bits_per_s"]))


def _spread_hi(r: dict) -> float:
    return r.get("info_bits_per_s_mid_hi",
                 r.get("info_bits_per_s_max", r["info_bits_per_s"]))


def write_readme(out: Path, dev: str, rows, ceilings,
                 n_windows: int, n_batches: int) -> None:
    """Write README.md from the results rows: one table row per code, in
    ``CODES`` order, each cell the median with the middle-window spread
    and FER."""
    lines = [
        "# Throughput matrix — decoded info bits/s on one card\n",
        f"Measured on {dev} by `python -m ldpc_tpu_torch.scripts.perf_matrix` "
        "(the bench's median-window method, the fused Monte-Carlo path "
        "through K1 / K2, two-phase `auto`).\n",
        "Each code runs at the Eb/N0 where layered-12 SPA FER falls in "
        "[2e-3, 3e-2], shared by all four decoder configurations of the row "
        "so that columns compare on identical channels.\n",
        f"Cells show the median of {n_windows} timed windows of {n_batches} "
        "batches with the middle-window spread (one window dropped per side "
        "at 4 windows or more; the absolute min/max are in results.json).\n",
        "`ceiling` is the row's census speed-of-light "
        "(`ldpc_tpu_torch.analysis.roofline`) at the measured mean block "
        "trips and the card's issue peak, priced for the dispatch the "
        "spa/layered cell ran; `%SoL` is that cell's fraction of it.\n",
        "| code | n | rate | Eb/N0 | "
        + " | ".join(c[0] for c in CONFIGS)
        + " | ceiling | %SoL |",
        "|---|---|---|---|" + "---|" * (len(CONFIGS) + 2),
    ]
    by_code: dict[str, dict] = {}
    canon = [c[0] for c in CODES]
    for r in sorted(rows, key=lambda r: canon.index(r["code"])
                    if r["code"] in canon else len(canon)):
        by_code.setdefault(
            r["code"], {"snr": r["snr_db"], "n": r["n"], "rate": r["rate"]}
        )[r["config"]] = r
    for cname, d in by_code.items():
        cells = []
        for label, *_ in CONFIGS:
            r = d.get(label)
            cells.append(
                f"{r['info_bits_per_s'] / 1e9:.2f} G "
                f"[{_spread_lo(r) / 1e9:.2f}–{_spread_hi(r) / 1e9:.2f}] "
                f"(FER {r['fer']:.0e})"
                if r else "—"
            )
        ceil = ceilings.get(cname)
        cells.append(
            f"{ceil['ceiling_info_bits_per_s'] / 1e9:.2f} G" if ceil else "—"
        )
        cells.append(f"{ceil['pct_of_ceiling']}%" if ceil else "—")
        lines.append(
            f"| {cname} | {d['n']} | {d['rate']:g} | {d['snr']:.2f} dB | "
            + " | ".join(cells) + " |"
        )
    (out / "README.md").write_text("\n".join(lines) + "\n")


def measure_cell(ex, code, snr, args) -> dict:
    """One cell: ``measure_point`` over ``--n-windows`` windows of
    ``--n-batches`` batches, with its spread."""
    from ldpc_tpu_torch.bench import measure_point

    nb = args.n_batches
    med, windows, fer, bits = measure_point(
        ex, code, snr, batch=args.batch, n_batches=nb,
        n_windows=args.n_windows, warmup_batches=nb, warmup_runs=1,
    )
    frame_bits = nb * args.batch * code.k
    # windows sorted ascending by time: fastest -> max bits/s; the README
    # spread uses the middle windows (drop one per side at >= 4 windows)
    t = windows
    lo_t, hi_t = (t[-2], t[1]) if len(t) >= 4 else (t[-1], t[0])
    return {
        "kernel": ex.kernel_used, "n_batches": nb,
        "fer": fer, "info_bits_per_s": bits,
        "info_bits_per_s_min": frame_bits / windows[-1],
        "info_bits_per_s_max": frame_bits / windows[0],
        "info_bits_per_s_mid_lo": frame_bits / lo_t,
        "info_bits_per_s_mid_hi": frame_bits / hi_t,
        "window_times_s": windows,
    }


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/perf_matrix")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--n-batches", type=int, default=64)
    ap.add_argument("--n-windows", type=int, default=5)
    ap.add_argument("--codes", default=None,
                    help="comma-separated subset of builtin names")
    args = ap.parse_args(argv)

    from ldpc_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache()

    from ldpc_tpu_torch.analysis.roofline import issue_peak_ops_per_s
    from ldpc_tpu_torch.scripts.study import device_label
    from ldpc_tpu_torch.sim.runner import load_code
    from ldpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    label = device_label(dev)
    # the ceiling is a device figure: priced only on the card
    peak = issue_peak_ops_per_s() if dev.type == "cuda" else None
    print(f"# device={label}", flush=True)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    codes = CODES
    if args.codes:
        keep = set(args.codes.split(","))
        codes = [c for c in CODES if c[0] in keep]

    rows: list[dict] = []
    ceilings: dict[str, dict] = {}
    for name, snr0 in codes:
        code = load_code(f"builtin:{name}")
        snr, _ = probe_operating_point(code, snr0, args.batch, dev)
        for label_c, decoder, schedule, iters, alpha in CONFIGS:
            ex = make_executor(code, decoder, schedule, iters, alpha,
                               args.batch, dev)
            row = {
                "code": code.name, "n": code.n, "k": code.k,
                "rate": round(code.k / code.n, 4), "snr_db": snr,
                "config": label_c, **measure_cell(ex, code, snr, args),
            }
            rows.append(row)
            print(
                f"{code.name:38s} {label_c:16s} @ {snr:.2f} dB "
                f"kernel={row['kernel']} FER={row['fer']:.2e} "
                f"bits/s={row['info_bits_per_s']:,.0f} "
                f"[{row['info_bits_per_s_mid_lo'] / 1e9:.2f}"
                f"-{row['info_bits_per_s_mid_hi'] / 1e9:.2f} G mid]",
                flush=True,
            )
            if label_c == "spa/layered-12" and peak is not None:
                ceil = row_ceiling(code, ex.opts, snr, ex.kernel_used,
                                   peak=peak, device=dev)
                if ceil is not None:
                    ceil["pct_of_ceiling"] = round(
                        100 * row["info_bits_per_s"]
                        / ceil["ceiling_info_bits_per_s"], 1
                    )
                    ceilings[code.name] = ceil
                    print(
                        f"#   ceiling {ceil['ceiling_info_bits_per_s'] / 1e9:.2f} G "
                        f"({'2phase' if ceil['two_phase'] else 'single'}) "
                        f"-> {ceil['pct_of_ceiling']}% of light",
                        flush=True,
                    )
        # incremental flush so a killed run keeps finished rows
        (out / "results.json").write_text(json.dumps(
            {"device": label, "n_windows": args.n_windows,
             "n_batches": args.n_batches, "batch": args.batch,
             "rows": rows, "ceilings": ceilings}, indent=1))

    write_readme(out, label, rows, ceilings, args.n_windows, args.n_batches)
    print(f"# wrote {out}/results.json and README.md", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
