"""Standalone re-plotter for saved JSON results.

A copy of the JAX package's ``plot_cli.py`` (the port imports
nothing from that package).

Counterpart of the reference's `python_ldpc_app/plot_results.py`: load one or
more SimulationResult JSON files and render a metric curve, a comparison
overlay, or the full dashboard.

  python -m ldpc_tpu_torch.plot_cli results.json --metric ber --output ber.png
  python -m ldpc_tpu_torch.plot_cli a.json b.json --metric fer --output cmp.png
  python -m ldpc_tpu_torch.plot_cli results.json --dashboard --output-dir plots/
"""

from __future__ import annotations

import argparse
import sys

from ldpc_tpu_torch.sim.results import SimulationResult
from ldpc_tpu_torch.sim.visualization import SimulationPlotter


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="ldpc_tpu_torch.plot", description="Plot saved LDPC simulation results"
    )
    parser.add_argument("results", nargs="*", help="JSON result file(s)")
    parser.add_argument(
        "--metric",
        type=str,
        choices=["ber", "fer", "llr", "convergence"],
        default="ber",
        help="Metric to plot (default: ber)",
    )
    parser.add_argument("--dashboard", action="store_true",
                        help="Render the 2x2 dashboard (first result only)")
    parser.add_argument("--output", type=str, default=None, help="Output image path")
    parser.add_argument("--output-dir", type=str, default=None,
                        help="Output directory for the dashboard")
    parser.add_argument("--no-show", action="store_true",
                        help="Do not open an interactive window")
    parser.add_argument("--failure-profile", type=str, default=None,
                        metavar="FILE",
                        help="Plot a failure-profile JSON (from the "
                             "simulation CLI's --failure-profile) instead of "
                             "result curves")
    args = parser.parse_args(argv)

    if args.failure_profile:
        import json

        from ldpc_tpu_torch.sim.visualization import plot_failure_profile

        try:
            with open(args.failure_profile) as f:
                profiles = json.load(f)
        except (OSError, ValueError) as e:
            print(f"Error loading failure profile: {e}")
            return 1
        plot_failure_profile(profiles, save_path=args.output)
        if not args.no_show and not args.output:
            import matplotlib.pyplot as plt

            plt.show()
        return 0

    if not args.results:
        parser.error("result files required (or --failure-profile)")

    try:
        results = [SimulationResult.from_json(p) for p in args.results]
    except (OSError, KeyError, ValueError) as e:
        print(f"Error loading results: {e}")
        return 1

    if args.dashboard:
        plotter = SimulationPlotter(results[0])
        fig = plotter.plot_combined_dashboard(save_dir=args.output_dir)
        if args.output:
            fig.savefig(args.output, dpi=150, bbox_inches="tight")
        if results[0].adaptation_log:
            plotter.plot_adaptation_history(save_dir=args.output_dir)
    elif len(results) > 1:
        SimulationPlotter.plot_comparison(results, metric=args.metric, save_path=args.output)
    else:
        plotter = SimulationPlotter(results[0])
        plotter._plot_metric(args.metric, save_path=args.output)

    if not args.no_show and not args.output and not args.output_dir:
        import matplotlib.pyplot as plt

        plt.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
