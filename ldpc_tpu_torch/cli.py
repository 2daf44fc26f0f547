"""Command-line interface of the port.

Counterpart of ``ldpc_tpu/cli.py`` with the same flag surface: every flag of
the reference CLI (`python_ldpc_app/main.py:445-524`) with the same name and
default, plus the simulator's own knobs (--fidelity, --decode-graph,
--check-rule, --noise-model, --batch, --seed, --exact-ber, the kernels'
options). It runs on the card; ``main(argv, device="cpu")`` runs the plain
PyTorch versions on the CPU. ``--kernel pallas`` means the hand-written QC
kernel (K3), ``--kernel xla`` the plain PyTorch decoders; ``--sublane-groups``
is accepted and has no effect. ``--distributed`` joins a ``torch.distributed``
process group (``ldpc_tpu_torch/parallel/distributed.py`` has the launch
lines) and ``--mesh`` lays axes over its ranks: with an ``snr`` axis the
points run in parallel (``run_simulation_parallel``), otherwise the batch is
sharded (``run_simulation(mesh=...)``); ``--failure-profile`` profiles the
failing frames after the sweep (``analysis.failures``).

Example:
  python -m ldpc_tpu_torch.cli --matrix builtin:wimax_576_0.5.alist.txt \
      --blocks 100000 --iterations 5 --ber --fer --output-json out.json
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from datetime import datetime

from ldpc_tpu_torch.sim.config import SimOptions


def _parse_alpha(s: str):
    """'0.75' -> 0.75; '0.64,0.73,0.81' -> per-iteration schedule tuple."""
    parts = [float(x) for x in s.split(",") if x.strip()]
    if not parts:
        raise argparse.ArgumentTypeError("empty --minsum-alpha")
    return parts[0] if len(parts) == 1 else tuple(parts)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ldpc_tpu_torch",
        description="LDPC link simulator (PyTorch + CUDA)",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="""
Examples:
  python -m ldpc_tpu_torch.cli --matrix builtin:wimax_576_0.5.alist.txt --blocks 100000 --ber --fer
  python -m ldpc_tpu_torch.cli --matrix builtin:wimax_1152_0.5.alist.txt --blocks 100000 --fidelity exact --iterations 20 --ber --fer
        """,
    )
    # --- reference-compatible flags (main.py:456-523) ---
    parser.add_argument("--list-codes", action="store_true",
                        help="List available codes (built-in standard codes "
                             "and any matrix database on disk) and exit")
    parser.add_argument("--matrix", "-m", type=str, required=False, default=None,
                        help="Path to the parity-check matrix (ALIST)")
    parser.add_argument("--blocks", "-b", type=int, default=100,
                        help="Number of codeword blocks per SNR point (default: 100)")
    parser.add_argument("--iterations", "-i", type=int, default=5,
                        help="Max decoder iterations (default: 5)")
    parser.add_argument("--interleaver", "-il", type=str, default="none",
                        metavar="{none,regular,random,srandom,file:PATH}",
                        help="Interleaver type (default: none). The "
                             "reference's four types, plus 'file:<perm.npy>'"
                             " -- a custom static permutation (int array pi,"
                             " out[i] = bits[pi[i]])")
    parser.add_argument("--decoder", "-d", type=str,
                        choices=["bitflipping", "sumproduct", "minsum",
                                 "normalized-minsum", "offset-minsum"],
                        default="sumproduct", help="Decoder type (default: sumproduct)")
    parser.add_argument("--speed", "-s", type=float, default=1.0,
                        help="Transmission speed / rate factor (default: 1.0)")
    parser.add_argument("--initial-snr", type=float, default=0.0,
                        help="Initial SNR in dB (default: 0.0)")
    parser.add_argument("--end-snr", type=float, default=5.0,
                        help="Final SNR in dB (default: 5.0)")
    parser.add_argument("--step-snr", type=float, default=0.5,
                        help="SNR step in dB (default: 0.5)")
    parser.add_argument("--interference-snr", type=float, default=1.0,
                        help="Interference SNR in dB for modes 2/3 (default: 1.0)")
    parser.add_argument("--mode", type=int, choices=[1, 2, 3], default=1,
                        help="Channel: 1=AWGN, 2=AWGN+partial-band, 3=AWGN+jamming")
    parser.add_argument("--p", type=float, default=0.1,
                        help="Interference parameter p/gamma for modes 2/3 (default: 0.1)")
    parser.add_argument("--modulation", "-mod", type=int,
                        choices=[1, 2, 4, 16, 64], default=1,
                        help="Modulation: 1=BPSK, 2=QPSK proxy (reference "
                             "semantics), 4/16/64=Gray QAM with max-log LLRs")
    parser.add_argument("--s-param", type=int, default=2,
                        help="S parameter for the S-Random interleaver (default: 2)")
    parser.add_argument("--ber", action="store_true", help="Compute BER")
    parser.add_argument("--fer", action="store_true", help="Compute FER")
    parser.add_argument("--normalized-llr", action="store_true",
                        help="Compute normalized LLR")
    parser.add_argument("--encoding-method", "-e", type=str,
                        choices=["standard", "richardson-urbanke"], default="standard",
                        help="Encoding method (default: standard)")
    parser.add_argument("--ru-gap", type=int, default=None,
                        help="Richardson-Urbanke gap (default: minimal found)")
    parser.add_argument("--threads", "-t", type=int, default=1,
                        help="Accepted for compatibility; parallelism is the device batch")
    parser.add_argument("--output-json", type=str, default=None,
                        help="Export results to a JSON file")
    parser.add_argument("--output-csv", type=str, default=None,
                        help="Export results to a CSV file")
    parser.add_argument("--plot", action="store_true",
                        help="Show plots after the simulation")
    parser.add_argument("--plot-save", type=str, default=None,
                        help="Save plots to this directory")
    parser.add_argument("--adaptive", action="store_true",
                        help="Enable adaptive parameter selection")
    parser.add_argument("--adaptive-strategy", type=str, choices=["threshold"],
                        default="threshold")
    parser.add_argument("--matrix-dir", type=str, default=None,
                        help="Matrix database directory for adaptive rate "
                             "switching (default: the grandparent of --matrix "
                             "-- the database root in the reference layout, "
                             "where matrices live in per-family subfolders; "
                             "built-in codes need no directory)")
    parser.add_argument("--adaptive-high-ber", type=float, default=1e-2)
    parser.add_argument("--adaptive-low-ber", type=float, default=1e-5)

    # --- the simulator's own flags ---
    parser.add_argument("--fidelity", type=str, choices=["reference", "exact"],
                        default="reference",
                        help="'reference' (default): bit-compatible with the reference "
                             "simulator (H_std graph, legacy check rule, legacy noise) "
                             "-- this is the SLOW parity mode: the ~40x-denser H_std "
                             "graph takes neither the fused CUDA path nor the QC "
                             "kernel, only the plain flooding decoder. "
                             "'exact': original sparse graph, correct SPA parity rule, "
                             "calibrated noise -- the port's fused CUDA path; use it "
                             "unless you need curve-for-curve agreement with the "
                             "reference.")
    parser.add_argument("--decode-graph", type=str, choices=["std", "orig"], default=None,
                        help="Override the decode Tanner graph")
    parser.add_argument("--check-rule", type=str, choices=["legacy", "exact"], default=None,
                        help="Override the check-node sign rule")
    parser.add_argument("--noise-model", type=str, choices=["legacy", "exact"], default=None,
                        help="Override the AWGN noise model")
    parser.add_argument("--batch", type=int, default=0,
                        help="Device batch of codewords (0 = auto)")
    parser.add_argument("--seed", type=int, default=0, help="PRNG seed")
    parser.add_argument("--exact-ber", action="store_true",
                        help="Count undetected-error bits too (reference counts only failed frames)")
    parser.add_argument("--kernel", type=str, choices=["auto", "pallas", "xla"],
                        default="auto",
                        help="Decode kernel: 'auto' / 'pallas' the hand-written "
                             "CUDA QC kernels where the configuration allows "
                             "('pallas' refuses where it does not), 'xla' the "
                             "plain PyTorch decoders (the JAX package's XLA "
                             "decoders)")
    parser.add_argument("--msg-store", type=str, choices=["f32", "int8"],
                        default="f32", dest="msg_store",
                        help="Extrinsic-message storage in the CUDA QC "
                             "kernels: 'int8' packs E onto the FER-free "
                             "256-level grid (min-sum variants only; a "
                             "shared-memory capacity knob)")
    parser.add_argument("--fused", type=str, choices=["auto", "on", "off"],
                        default="auto",
                        help="Fully-fused Monte-Carlo step (channel noise from the "
                             "in-kernel Philox generator + decode + counters in one "
                             "CUDA kernel). 'auto': whenever eligible; 'off': keep "
                             "the PyTorch pipeline around the decode kernel")
    parser.add_argument("--two-phase", type=str, default="auto",
                        dest="two_phase", metavar="{auto,off,N}",
                        help="Two-phase fused dispatch: phase 1 decodes every "
                             "frame for N iterations, then only the "
                             "unconverged frames are compacted and re-decoded "
                             "with the full budget -- bit-identical results. "
                             "'auto' probes each SNR point and enables the "
                             "half-budget split only where it wins (it loses "
                             "at FER~1); N forces the split everywhere")
    parser.add_argument("--schedule", type=str, choices=["flooding", "layered"],
                        default="flooding",
                        help="Message-passing schedule: 'flooding' (the reference's) "
                             "or 'layered' serial-C for QC codes (~2x fewer "
                             "iterations to a given FER)")
    parser.add_argument("--layer-order", type=str,
                        choices=["serial", "paired"], default="serial",
                        help="Layered-sweep row order: 'serial' (base rows "
                             "0..mb-1) or 'paired' (disjoint-support row "
                             "pairs per step -- two independent dependence "
                             "chains per step; a different, equally valid "
                             "serial-C schedule)")
    parser.add_argument("--check-every", type=int, default=1,
                        help="Syndrome-check cadence in the QC kernels' decode "
                             "loops: N runs N message-passing sweeps per "
                             "check (~14%% of a layered iteration's ops). "
                             "Convergence detection coarsens to N-sweep "
                             "windows (conv_iter reports the check "
                             "iteration); requires N | iterations and no "
                             "--normalized-llr")
    parser.add_argument("--sublane-groups", type=str, default="auto",
                        dest="sublane_groups", metavar="{auto,N}",
                        help="Accepted for compatibility with the JAX CLI and "
                             "has no effect: sublane grouping is a layout knob "
                             "of the TPU kernels, with per-codeword results "
                             "equal to G=1")
    parser.add_argument("--minsum-alpha", type=_parse_alpha, default=0.75,
                        help="Normalized min-sum scale factor, or a "
                             "comma-separated per-iteration schedule (e.g. a "
                             "learned one; schedules run on every decoder, "
                             "the fused CUDA path included)")
    parser.add_argument("--minsum-beta", type=float, default=0.15,
                        help="Offset min-sum offset")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="JSON checkpoint file, flushed after every SNR point")
    parser.add_argument("--resume", action="store_true",
                        help="Resume the sweep from --checkpoint (skips completed points)")
    parser.add_argument("--profile", type=str, default=None,
                        help="Capture a torch.profiler trace of the sweep "
                             "into this directory; the trace carries the "
                             "program's spans (point, run_point, flush, "
                             "batch.*), and after a serial sweep "
                             "DIR/spans.json holds them with their counters")
    parser.add_argument("--graph-stats", action="store_true",
                        help="Print the code's Tanner-graph statistics "
                             "(girth, degree histograms) as JSON and exit "
                             "(ldpc_tpu_torch.analysis.graph_stats)")
    parser.add_argument("--failure-profile", type=str, default=None,
                        metavar="FILE",
                        help="After the sweep, profile the failing frames at "
                             "every SNR point: on-device histograms of "
                             "info-bit error weight, detected failures vs "
                             "undetected errors, written as JSON "
                             "(ldpc_tpu_torch.analysis.failures)")
    parser.add_argument("--shorten", type=int, default=0,
                        help="Shorten: fix the last S info bits to zero (known "
                             "at the receiver); effective rate (k-S)/(n-S-P)")
    parser.add_argument("--puncture", type=int, default=0,
                        help="Puncture: do not transmit the last P parity bits "
                             "(decoder sees erasures)")
    parser.add_argument("--target-errors", type=int, default=0,
                        help="Stop each SNR point after this many frame errors "
                             "(equalizes estimator precision across points; "
                             "0 = fixed --blocks like the reference)")
    parser.add_argument("--distributed", action="store_true",
                        help="Join a torch.distributed process group "
                             "(torchrun's or the JAX launch variables) before "
                             "building the mesh; see "
                             "ldpc_tpu_torch/parallel/distributed.py")
    parser.add_argument("--mesh", type=str, default=None,
                        help="Rank mesh axes, e.g. 'batch=8' or 'snr=2,batch=4'. "
                             "With an 'snr' axis, all SNR points run in parallel "
                             "(one axis may be -1 to absorb remaining ranks)")
    parser.add_argument("--quiet", "-q", action="store_true")
    return parser


def options_from_args(args: argparse.Namespace) -> SimOptions:
    return SimOptions(
        matrix=args.matrix,
        blocks=args.blocks,
        iterations=args.iterations,
        interleaver=args.interleaver,
        decoder=args.decoder,
        speed=args.speed,
        initial_snr=args.initial_snr,
        end_snr=args.end_snr,
        step_snr=args.step_snr,
        interference_snr=args.interference_snr,
        mode=args.mode,
        p=args.p,
        modulation=args.modulation,
        s_param=args.s_param,
        ber=args.ber,
        fer=args.fer,
        normalized_llr=args.normalized_llr,
        encoding_method=args.encoding_method,
        ru_gap=args.ru_gap,
        threads=args.threads,
        adaptive=args.adaptive,
        adaptive_strategy=args.adaptive_strategy,
        matrix_dir=args.matrix_dir,
        adaptive_high_ber=args.adaptive_high_ber,
        adaptive_low_ber=args.adaptive_low_ber,
        output_json=args.output_json,
        output_csv=args.output_csv,
        plot=args.plot,
        plot_save=args.plot_save,
        fidelity=args.fidelity,
        decode_graph=args.decode_graph,
        check_rule=args.check_rule,
        noise_model=args.noise_model,
        batch=args.batch,
        seed=args.seed,
        exact_ber=args.exact_ber,
        kernel=args.kernel,
        fused=args.fused,
        two_phase=args.two_phase,
        schedule=args.schedule,
        layer_order=args.layer_order,
        check_every=args.check_every,
        msg_store=args.msg_store,
        sublane_groups=args.sublane_groups,
        shorten=args.shorten,
        puncture=args.puncture,
        target_errors=args.target_errors,
        minsum_alpha=args.minsum_alpha,
        minsum_beta=args.minsum_beta,
        checkpoint=args.checkpoint,
        resume=args.resume,
        profile=args.profile,
        quiet=args.quiet,
    )


def _parse_mesh_axes(spec: str) -> dict[str, int]:
    """'snr=2,batch=-1' -> {'snr': 2, 'batch': -1} (-1 = remaining ranks)."""
    axes: dict[str, int] = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        try:
            axes[name.strip()] = int(size)
        except ValueError:
            raise SystemExit(
                f"Error: bad --mesh part {part!r}; expected axis=size"
            )
    return axes


def main(argv: list[str] | None = None, device=None) -> int:
    """Run the CLI on ``argv``; ``device=None`` means the card (tests pass
    ``device="cpu"``). Returns the exit code."""
    args = build_parser().parse_args(argv)

    if args.list_codes:
        from ldpc_tpu_torch.models.catalog import MatrixCatalog
        from ldpc_tpu_torch.utils.db import default_matrix_db

        catalog = MatrixCatalog(default_matrix_db(), include_builtin=True)
        print(f"{'name':44s} {'n':>6} {'k':>6} {'rate':>7}  family")
        for info in catalog.matrices:
            mark = " (builtin)" if info.path.startswith("builtin:") else ""
            print(f"{info.name:44s} {info.n:6d} {info.k:6d} {info.rate:7.4f}"
                  f"  {info.family}{mark}")
        print(f"\n{len(catalog)} codes ({catalog!r})")
        return 0

    if args.matrix is None:
        print("Error: --matrix is required (or use --list-codes)")
        return 1

    if args.distributed:
        from ldpc_tpu_torch.parallel.distributed import initialize_distributed

        initialize_distributed(device=device)

    try:
        from ldpc_tpu_torch.utils.db import resolve_matrix

        resolve_matrix(args.matrix)
    except FileNotFoundError:
        print(
            f"Error: matrix not found: {args.matrix} (not a file, not in the "
            f"matrix database, not a built-in standard code)"
        )
        return 1

    opts = options_from_args(args).resolved()
    say = (lambda *a, **kw: None) if opts.quiet else print

    if args.graph_stats:
        import json

        from ldpc_tpu_torch.analysis.graph_stats import graph_stats
        from ldpc_tpu_torch.sim.runner import load_code

        print(json.dumps(
            graph_stats(load_code(opts.matrix), graph=opts.decode_graph),
            indent=1,
        ))
        return 0

    say("=" * 60)
    say("ldpc_tpu_torch - LDPC link simulator (PyTorch + CUDA)")
    say("=" * 60)
    say(f"Matrix file: {opts.matrix}")
    say(f"Blocks per SNR point: {opts.blocks}")
    say(f"Max iterations: {opts.iterations}")
    say(f"Interleaver: {opts.interleaver}")
    say(f"Decoder: {opts.decoder}")
    say(f"Encoding method: {opts.encoding_method}")
    say(f"Channel mode: {opts.mode}")
    say(f"SNR range: {opts.initial_snr} - {opts.end_snr} dB (step {opts.step_snr} dB)")
    say(f"Fidelity: {opts.fidelity} (graph={opts.decode_graph}, "
        f"rule={opts.check_rule}, noise={opts.noise_model})")
    if opts.fidelity == "reference":
        say("  note: 'reference' is the slow parity mode (dense H_std graph, "
            "plain flooding decoder); pass --fidelity exact for the port's "
            "fused CUDA path")
    if opts.adaptive:
        say(f"Adaptive mode: on (strategy: {opts.adaptive_strategy})")
    say("=" * 60)

    start = time.time()
    start_dt = datetime.now()
    say(f"Started: {start_dt.strftime('%d.%m.%Y %H:%M:%S')}")

    try:
        from ldpc_tpu_torch.sim.runner import load_code, run_simulation

        code = load_code(opts.matrix)
        say(f"Code parameters: n={code.n}, m={code.m}, k={code.k}, rate={code.rate:.4f}")

        if opts.encoding_method == "richardson-urbanke":
            spec = code.richardson_urbanke_spec(opts.ru_gap)
            say(f"Richardson-Urbanke gap: {spec.gap}"
                + (f" (requested: {opts.ru_gap})" if opts.ru_gap is not None else " (minimal found)"))

        if opts.adaptive:
            from ldpc_tpu_torch.models.catalog import MatrixCatalog
            from ldpc_tpu_torch.sim.adaptive import AdaptiveController, ThresholdStrategy

            mesh = None
            if args.mesh:
                from ldpc_tpu_torch.parallel.mesh import make_mesh

                axes = _parse_mesh_axes(args.mesh)
                if "snr" in axes:
                    say("Note: adaptive mode evaluates SNR points sequentially "
                        "(parameters depend on the previous point); the 'snr' "
                        "mesh axis is folded into 'batch'")
                    if any(v == -1 for v in axes.values()):
                        total = -1  # wildcard folds to "all ranks"
                    else:
                        total = 1
                        for v in axes.values():
                            total *= v
                    axes = {"batch": total}
                mesh = make_mesh(axes)
                say(f"Adaptive executors shard the codeword batch over mesh "
                    f"{mesh.shape}")

            matrix_dir = opts.matrix_dir
            if matrix_dir is None and os.path.isfile(opts.matrix):
                matrix_dir = os.path.join(os.path.dirname(os.path.abspath(opts.matrix)), "..")
            # with no directory the catalog serves the built-in standard codes
            catalog = MatrixCatalog(matrix_dir)
            strategy = ThresholdStrategy(
                high_ber_threshold=opts.adaptive_high_ber,
                low_ber_threshold=opts.adaptive_low_ber,
            )
            controller = AdaptiveController(strategy, catalog, device=device,
                                            mesh=mesh)
            sim_result = controller.run_adaptive_sweep(opts)
        elif args.mesh:
            from ldpc_tpu_torch.parallel.mesh import make_mesh
            from ldpc_tpu_torch.sim.runner import run_simulation_parallel

            mesh = make_mesh(_parse_mesh_axes(args.mesh))
            if "snr" in mesh.axis_names:
                sim_result = run_simulation_parallel(opts, code=code, mesh=mesh,
                                                     device=device)
            else:
                sim_result = run_simulation(opts, code=code, mesh=mesh,
                                            device=device)
        else:
            sim_result = run_simulation(opts, code=code, device=device)

        elapsed = time.time() - start
        say()
        say("=" * 60)
        say(f"Wall clock: {elapsed:.2f} s")
        say("=" * 60)

        if opts.output_json:
            sim_result.to_json(opts.output_json)
            say(f"Results exported to JSON: {opts.output_json}")
        if opts.output_csv:
            sim_result.to_csv(opts.output_csv)
            say(f"Results exported to CSV: {opts.output_csv}")

        if args.failure_profile:
            import json
            from dataclasses import replace

            from ldpc_tpu_torch.analysis.failures import profile_sweep
            from ldpc_tpu_torch.sim.runner import snr_steps

            # per-frame stats need the unfused step; undetected errors need
            # exact accounting (the sweep above is not re-run)
            popts = replace(opts, fused="off", exact_ber=True, adaptive=False)
            profiles = profile_sweep(
                code, popts,
                snr_steps(opts.initial_snr, opts.end_snr, opts.step_snr),
                min_failures=max(opts.target_errors, 100),
                max_blocks=opts.blocks,
                say=say, device=device,
            )
            with open(args.failure_profile, "w") as f:
                json.dump(profiles, f, indent=1)
            say(f"Failure profile exported: {args.failure_profile}")

        if opts.plot or opts.plot_save:
            from ldpc_tpu_torch.sim.visualization import SimulationPlotter

            plotter = SimulationPlotter(sim_result)
            plotter.plot_combined_dashboard(save_dir=opts.plot_save)
            if sim_result.adaptation_log:
                plotter.plot_adaptation_history(save_dir=opts.plot_save)
            if opts.plot:
                import matplotlib.pyplot as plt

                plt.show()
        return 0

    except Exception as e:  # mirror the reference's loud failure path
        elapsed = time.time() - start
        print("=" * 60)
        print(f"Error: {e}")
        print(f"Elapsed before error: {elapsed:.2f} s")
        print("=" * 60)
        import traceback

        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
