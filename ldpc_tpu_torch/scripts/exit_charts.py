"""The EXIT-chart example: Gaussian-approximation thresholds and charts.

Counterpart of the JAX repo's ``examples/exit_charts/generate.py``. Charts
the 802.16e rate-1/2 protograph against the (3,6)-regular ensemble at three
operating points around their Gaussian-approximation thresholds (0.3 dB
below, 0.15 dB and 1.0 dB above), and writes the threshold table
``exit_thresholds.json`` with the example's keys and rounding. The analysis
is closed-form numpy (``analysis.exit``) and makes no tensor, so the card
and the CPU do the same work.

The table is always written; the six charts only where matplotlib is
installed (one line says so where it is not). :func:`main` returns 1 when a
rounded threshold differs from the committed example's
(``examples/exit_charts/exit_thresholds.json``).

Writes ``<out>/exit_thresholds.json`` and ``<out>/<graph>_<tag>.png``
(default ``build/exit_charts``).

Usage: ``python -m ldpc_tpu_torch.scripts.exit_charts [--out DIR]``
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ldpc_tpu_torch.scripts.study import EXAMPLES

RECORD = EXAMPLES / "exit_charts" / "exit_thresholds.json"
BRACKET = dict(lo_db=-0.5, hi_db=3.0)
OFFSETS = ((-0.3, "below"), (0.15, "near"), (1.0, "above"))
WIMAX_KEY = "wimax_576_1/2_ga_threshold_db"
REGULAR_KEY = "regular_3_6_ga_threshold_db"


def thresholds() -> tuple[object, object, float, float]:
    """(wimax graph, (3,6) graph, their GA thresholds in dB)."""
    from ldpc_tpu_torch.analysis import exit_threshold, regular_protograph
    from ldpc_tpu_torch.models.qc import detect_qc
    from ldpc_tpu_torch.models.standards import wimax

    qc = detect_qc(wimax(576, "1/2"))
    reg = regular_protograph(3, 6)
    return (qc, reg, exit_threshold(qc, rate=0.5, **BRACKET),
            exit_threshold(reg, rate=0.5, **BRACKET))


def table(thr_wimax: float, thr_reg: float) -> dict:
    """``exit_thresholds.json``: the example's keys and rounding."""
    return {
        WIMAX_KEY: round(thr_wimax, 3),
        REGULAR_KEY: round(thr_reg, 3),
        "regular_3_6_true_de_db": 1.11,
        "note": "Gaussian-approximation (EXIT) thresholds; the "
                "sampled-DE module measures wimax ~0.8 dB (GA is "
                "optimistic for irregular ensembles).",
    }


def draw(charts, out: Path) -> int:
    """The six charts into ``out``; 0 drawn where matplotlib is missing."""
    try:
        import matplotlib
    except ImportError:
        print("charts skipped: matplotlib is not installed", flush=True)
        return 0
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ldpc_tpu_torch.sim.visualization import plot_exit_chart

    for graph, name, thr in charts:
        for delta, tag in OFFSETS:
            ebno = thr + delta
            fig = plot_exit_chart(
                graph, ebno, 0.5,
                title=f"{name} EXIT chart @ {ebno:.2f} dB "
                      f"({tag} GA threshold {thr:.2f} dB)",
                save_path=out / f"{name}_{tag}.png",
            )
            plt.close(fig)
    return len(charts) * len(OFFSETS)


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/exit_charts")
    args = ap.parse_args(argv)

    from ldpc_tpu_torch.scripts.study import device_label
    from ldpc_tpu_torch.utils.device import resolve_device

    label = device_label(resolve_device(device))
    qc, reg, thr_wimax, thr_reg = thresholds()
    print(f"# device={label}\nGA threshold: wimax R1/2 {thr_wimax:.3f} dB, "
          f"(3,6)-regular {thr_reg:.3f} dB", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    res = table(thr_wimax, thr_reg)
    (out / "exit_thresholds.json").write_text(json.dumps(res, indent=2))
    n = draw(((qc, "wimax576_r12", thr_wimax), (reg, "regular_3_6", thr_reg)),
             out)
    rec = json.loads(RECORD.read_text())
    differ = [k for k in (WIMAX_KEY, REGULAR_KEY) if res[k] != rec[k]]
    print(f"wrote {n} charts + exit_thresholds.json to {out}; against the "
          f"record: " + (", ".join(f"{k} {res[k]} != {rec[k]}" for k in differ)
                         or "equal"), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
