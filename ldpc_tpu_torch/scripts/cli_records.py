"""The CLI-made records held on the card, and their density-evolution table.

The JAX CLI (``python -m ldpc_tpu.cli``) wrote nine committed records:

* ``examples/wimax1152_waterfall/rate_{0.5,0.66B,0.75A,0.75B,0.83}.json``:
  the five 802.16e rates at n=1152, layered SPA-16, ``--target-errors 200``
  (the recipe of that folder's ``README.md``), 25 points;
* ``examples/decoder_variants/{sumproduct,normalized-minsum,offset-minsum,
  minsum}.json``: flooding, 16 iterations, ``--target-errors 150`` (that
  folder's ``README.md``), 16 points.

:func:`hold_record` rebuilds a record's command line from its own
``config`` (the target from its README: the config does not store it), runs
it through the port's CLI (``ldpc_tpu_torch.cli.main``), and holds each
point's frame errors against the record's within 5 combined standard
errors (``scripts.study.five_se``; BER is shown, not judged). Each point's
wall time runs from the CLI's ``SNR:`` line to its ``Throughput:`` line,
which it prints just before and after the point runs; the launches of K1 /
K2 / K3 are counted a recipe. The CLI's JSON carries no time or
``kernel_used`` a point; it carries the layer order and check cadence the
layered recipes took (the CLI's defaults), and the table states them.

Then the waterfall README's density-evolution table (five rates; 300
iterations, 8000 samples, a 0.08 dB bisection on [0, 4] dB): the port's
``analysis.protograph_threshold`` for seeds 0, 1 and 2; a rate is held when
the record lies within [min - 0.08, max + 0.08] dB of its three thresholds
(the bisection's tolerance on each side of the spread over seeds).

:func:`main` runs every record in full and the whole table, and returns 1
when a point lies outside 5 standard errors, a rate's threshold outside its
bar, or a recipe fails (it stops at the first failed recipe).

Writes ``<out>/<record>.json`` (each CLI run's output), ``<out>/results.json``
and ``<out>/RESULTS.md`` (default ``build/cli_records``).

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.cli_records [--out DIR]``
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
import traceback
from fractions import Fraction
from pathlib import Path

from ldpc_tpu_torch.scripts.study import EXAMPLES, md_rows

WATERFALL = EXAMPLES / "wimax1152_waterfall"
VARIANTS = EXAMPLES / "decoder_variants"
# (record, --target-errors of its README's recipe)
RECIPES = (
    *((WATERFALL / f"rate_{r}.json", 200)
      for r in ("0.5", "0.66B", "0.75A", "0.75B", "0.83")),
    *((VARIANTS / f"{v}.json", 150)
      for v in ("sumproduct", "normalized-minsum", "offset-minsum", "minsum")),
)
DE_README = WATERFALL / "README.md"
DE_SEEDS = (0, 1, 2)
DE = dict(iterations=300, n_samples=8000, tol_db=0.08, lo_db=0.0, hi_db=4.0)
KERNELS = ("mc_decoder", "llr_decoder", "qc_decoder")


def recipe_argv(config: dict, *, target_errors: int, output_json,
                blocks: int | None = None,
                end_snr: float | None = None) -> list[str]:
    """The CLI's argv for a record's ``config``: its code, frames, batch,
    iterations, speed, SNR range, decoder, schedule, fidelity and seed, with
    ``--ber --fer`` and ``--target-errors``. ``blocks`` and ``end_snr`` cut
    a run short; the points kept draw the same frames."""
    start, end, step = config["snr_range"]
    return [
        "--matrix", config["matrix_path"],
        "--decoder", config["decoder_type"],
        "--blocks", str(blocks or config["blocks"]),
        "--batch", str(config["batch"]),
        "--iterations", str(config["max_iterations"]),
        "--ber", "--fer",
        "--speed", str(config["speed"]),
        "--fidelity", config["fidelity"],
        "--schedule", config["schedule"],
        "--seed", str(config["seed"]),
        "--target-errors", str(target_errors),
        "--initial-snr", str(start),
        "--end-snr", str(end if end_snr is None else end_snr),
        "--step-snr", str(step),
        "--output-json", str(output_json),
    ]


def launches() -> dict[str, int]:
    """The launch counts of K1 / K2 / K3 (each wrapper counts its own)."""
    from ldpc_tpu_torch.ops.mc_kernels import LLR_KERNEL, MC_KERNEL
    from ldpc_tpu_torch.ops.qc_kernels import QC_KERNEL

    return dict(zip(KERNELS, (MC_KERNEL.launches, LLR_KERNEL.launches,
                              QC_KERNEL.launches)))


class PointClock(io.TextIOBase):
    """The CLI's standard output, passed on to ``sink``; each point's wall
    time, from its ``SNR:`` line to its ``Throughput:`` line."""

    def __init__(self, sink):
        self.sink = sink
        self.seconds: list[float] = []
        self._start = None

    def write(self, s: str) -> int:
        self.sink.write(s)
        text = s.strip()
        if text.startswith("SNR:"):
            self._start = time.perf_counter()
        elif text.startswith("Throughput:") and self._start:
            self.seconds.append(time.perf_counter() - self._start)
            self._start = None
        return len(s)

    def flush(self) -> None:
        self.sink.flush()


def hold_record(path, *, target_errors: int, blocks: int | None = None,
                end_snr: float | None = None, device=None,
                out_dir="build/cli_records") -> list[dict]:
    """Run one record's recipe through the port's CLI (on ``device``;
    ``None``: the card) and hold each point against the record's: one row a
    point. Raises when the CLI fails."""
    from ldpc_tpu_torch import cli
    from ldpc_tpu_torch.scripts.study import five_se

    path = Path(path)
    rec = json.loads(path.read_text())
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_json = out_dir / path.name
    argv = recipe_argv(rec["config"], target_errors=target_errors,
                       output_json=out_json, blocks=blocks,
                       end_snr=end_snr)
    clock = PointClock(sys.stdout)
    with contextlib.redirect_stdout(clock):
        rc = cli.main(argv, device=device)
    if rc:
        raise RuntimeError(f"{path.name}: the CLI exited {rc} on {argv}")
    res = json.loads(out_json.read_text())
    ref = {round(p["snr_db"], 6): p for p in rec["snr_points"]}
    rows = []
    for p, secs in zip(res["snr_points"], clock.seconds, strict=True):
        r = ref[round(p["snr_db"], 6)]
        rows.append({
            "record": path.name, "snr_db": p["snr_db"],
            "record_fer": r["fer"], "fer": p["fer"],
            **five_se(p["failed_blocks"], p["total_blocks"],
                      r["failed_blocks"], r["total_blocks"]),
            "record_ber": r["ber"], "ber": p["ber"], "seconds": secs,
            "layer_order": res["config"]["layer_order"],
            "check_every": res["config"]["check_every"],
        })
    return rows


def de_table(text: str) -> dict[str, float]:
    """{rate: DE threshold in dB} of the README's threshold table."""
    return {c[0]: float(c[1].split()[0])
            for c in md_rows(text, "| rate | DE threshold |")}


def de_bar(thresholds) -> tuple[float, float]:
    """The seeds' spread widened by the bisection's tolerance each side."""
    return min(thresholds) - DE["tol_db"], max(thresholds) + DE["tol_db"]


def de_held(record_db: float, thresholds) -> bool:
    """The record within :func:`de_bar` of its thresholds."""
    lo, hi = de_bar(thresholds)
    return lo <= record_db <= hi


def de_rate(rate: str, record_db: float, *, device=None) -> dict:
    """One rate's thresholds over ``DE_SEEDS`` (the 802.16e n=1152 protograph
    at the README's settings) against the record's."""
    from ldpc_tpu_torch.analysis import protograph_threshold
    from ldpc_tpu_torch.models.qc import detect_qc
    from ldpc_tpu_torch.models.standards import wimax

    graph = detect_qc(wimax(1152, rate))
    code_rate = float(Fraction(rate.rstrip("AB")))
    t0 = time.perf_counter()
    thr = [protograph_threshold(graph, code_rate, seed=s, device=device, **DE)
           for s in DE_SEEDS]
    return {"rate": rate, "record_db": record_db, "thresholds_db": thr,
            "bar_db": list(de_bar(thr)),
            "held": de_held(record_db, thr),
            "seconds": time.perf_counter() - t0}


def markdown(label: str, recipes: list[dict], rows: list[dict],
             de: list[dict]) -> str:
    """The tables of ``RESULTS.md``."""
    lines = [f"# CLI records held on {label}", "",
             "| record | target | K1 / K2 / K3 launches | layer order, check "
             "every | s on this device | s on the TPU (record) |",
             "|---|---|---|---|---|---|"]
    for r in recipes:
        c = r["launches"]
        lines.append(f"| {r['record']} | {r['target_errors']} | "
                     f"{' / '.join(str(c[k]) for k in KERNELS)} | "
                     f"{r['layer_order']}, {r['check_every']} | "
                     f"{r['seconds']:.2f} | {r['tpu_wall_clock_seconds']:.1f} |")
    lines += ["", "| record | Eb/N0 | record FER | this FER | gap | 5 se | "
              "within | record BER | this BER | s |", "|---" * 10 + "|"]
    for r in rows:
        lines.append(
            f"| {r['record']} | {r['snr_db']:g} | {r['record_errors']} / "
            f"{r['record_frames']} = {r['record_fer']:.4e} | {r['errors']} / "
            f"{r['frames']} = {r['fer']:.4e} | {r['gap']:.3e} | "
            f"{r['five_se']:.3e} | {'yes' if r['within'] else 'NO'} | "
            f"{r['record_ber']:.3e} | {r['ber']:.3e} | {r['seconds']:.3f} |")
    lines += ["", "| rate | record dB | thresholds dB (seeds "
              f"{', '.join(map(str, DE_SEEDS))}) | bar dB | held | s |",
              "|---|---|---|---|---|---|"]
    for d in de:
        lines.append(f"| {d['rate']} | {d['record_db']} | "
                     f"{', '.join(f'{t:.5f}' for t in d['thresholds_db'])} | "
                     f"[{d['bar_db'][0]:.5f}, {d['bar_db'][1]:.5f}] | "
                     f"{'yes' if d['held'] else 'NO'} | {d['seconds']:.2f} |")
    return "\n".join(lines) + "\n"


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/cli_records")
    args = ap.parse_args(argv)

    from ldpc_tpu_torch.scripts.study import device_label
    from ldpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    label = device_label(dev)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(f"# device={label}", flush=True)
    recipes, rows, de, failed = [], [], [], False
    for path, target in RECIPES:
        c0, t0 = launches(), time.perf_counter()
        try:
            pts = hold_record(path, target_errors=target, device=dev,
                              out_dir=out)
        except Exception:
            traceback.print_exc()
            print(f"{path.name}: the recipe FAILED", flush=True)
            failed = True
            break
        secs = time.perf_counter() - t0
        c = launches()
        rows += pts
        recipes.append({
            "record": path.name, "target_errors": target, "seconds": secs,
            "tpu_wall_clock_seconds":
                json.loads(Path(path).read_text())["wall_clock_seconds"],
            "launches": {k: c[k] - c0[k] for k in KERNELS},
            "layer_order": pts[0]["layer_order"],
            "check_every": pts[0]["check_every"]})
        print(f"# {path.name}: {secs:.2f} s, {sum(p['within'] for p in pts)}"
              f" of {len(pts)} points within 5 se", flush=True)
    if not failed:
        for rate, record_db in de_table(DE_README.read_text()).items():
            de.append(de_rate(rate, record_db, device=dev))
            print(f"# DE {rate}: {de[-1]['thresholds_db']} against "
                  f"{record_db} dB: {'held' if de[-1]['held'] else 'NOT held'}",
                  flush=True)
    (out / "results.json").write_text(json.dumps(
        {"device": label, "de_settings": DE, "recipes": recipes,
         "points": rows, "de": de, "failed_recipe": failed}, indent=1))
    text = markdown(label, recipes, rows, de)
    (out / "RESULTS.md").write_text(text)
    print(text, flush=True)
    outside = sum(not r["within"] for r in rows)
    missed = sum(not d["held"] for d in de)
    print(f"# wrote {out}/results.json and RESULTS.md; {outside} points "
          f"outside 5 se, {missed} DE rates outside their bar"
          + (", a recipe failed" if failed else ""), flush=True)
    return 1 if failed or outside or missed else 0


if __name__ == "__main__":
    sys.exit(main())
