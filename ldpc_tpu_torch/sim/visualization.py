"""Performance plots for simulation results.

A copy of the JAX package's ``sim/visualization.py`` (the port imports
nothing from that package).

Covers the reference's plotting surface (`python_ldpc_app/visualization.py`):
semilogy BER/FER waterfalls (zero points filtered for the log axis),
normalized-LLR and convergence curves, a 2x2 dashboard PNG, adaptation
history, and multi-result comparison overlays. Uses the non-interactive Agg
backend by default.
"""

from __future__ import annotations

import os

try:
    import matplotlib

    # Headless default only: forcing Agg unconditionally would make the
    # CLI's --plot (plt.show) a silent no-op on machines with a display.
    if not os.environ.get("DISPLAY") and not os.environ.get("MPLBACKEND"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    HAS_MATPLOTLIB = True
except ImportError:  # pragma: no cover
    HAS_MATPLOTLIB = False

from ldpc_tpu_torch.sim.results import SimulationResult

_METRICS = {
    "ber": ("ber", "BER", "BER vs SNR", True, "o-"),
    "fer": ("fer", "FER", "FER vs SNR", True, "s-"),
    "llr": ("avg_normalized_llr", "Normalized LLR", "Normalized LLR vs SNR", False, "d-"),
    "convergence": (
        "avg_convergence_iterations",
        "Avg iterations to convergence",
        "Decoder Convergence vs SNR",
        False,
        "^-",
    ),
}


class SimulationPlotter:
    """Generates standard LDPC performance plots from SimulationResult data."""

    def __init__(self, result: SimulationResult):
        if not HAS_MATPLOTLIB:
            raise ImportError("matplotlib is required for visualization")
        self.result = result

    def _plot_metric(self, metric: str, ax=None, save_path=None, label=None):
        attr, ylabel, title, logy, style = _METRICS[metric]
        pts = self.result.snr_points
        pairs = [(p.snr_db, getattr(p, attr)) for p in pts]
        if logy:
            pairs = [(s, v) for s, v in pairs if v > 0]  # log axis: drop zeros
            if not pairs:
                return ax

        own_fig = ax is None
        fig = None
        if own_fig:
            fig, ax = plt.subplots(figsize=(8, 6))

        xs = [s for s, _ in pairs]
        ys = [v for _, v in pairs]
        lbl = label or f"Rate={self.result.config.rate:.3f}"
        plot = ax.semilogy if logy else ax.plot
        plot(xs, ys, style, label=lbl, markersize=5)
        if metric == "fer":
            # 95% Wilson interval from the exact frame counts -- makes the
            # Monte-Carlo uncertainty of sparse-error points visible
            los, his = [], []
            by_snr = {p.snr_db: p for p in pts}
            for s, v in pairs:
                p = by_snr[s]
                n_tr, n_err = p.total_blocks, p.failed_blocks
                if n_tr <= 0:
                    los.append(v)
                    his.append(v)
                    continue
                z = 1.96
                ph = n_err / n_tr
                den = 1 + z * z / n_tr
                center = (ph + z * z / (2 * n_tr)) / den
                half = (z / den) * (
                    (ph * (1 - ph) / n_tr + z * z / (4 * n_tr * n_tr)) ** 0.5
                )
                los.append(max(center - half, 1e-300))
                his.append(center + half)
            # the Wilson center is shrunk toward 1/2, so at ph near 0 or 1 the
            # bound can sit on one side of the plotted MLE -- clamp to >= 0
            yerr = [[max(y - lo, 0.0) for y, lo in zip(ys, los)],
                    [max(hi - y, 0.0) for y, hi in zip(ys, his)]]
            ax.errorbar(xs, ys, yerr=yerr, fmt="none", ecolor="gray",
                        elinewidth=1, capsize=2, alpha=0.6)
        ax.set_xlabel("SNR (dB)")
        ax.set_ylabel(ylabel)
        ax.set_title(title)
        ax.grid(True, which="both" if logy else "major", alpha=0.3)
        ax.legend()

        if save_path and own_fig:
            fig.savefig(save_path, dpi=150, bbox_inches="tight")
        return ax

    def plot_ber_vs_snr(self, ax=None, save_path=None, label=None):
        return self._plot_metric("ber", ax, save_path, label)

    def plot_fer_vs_snr(self, ax=None, save_path=None, label=None):
        return self._plot_metric("fer", ax, save_path, label)

    def plot_llr_vs_snr(self, ax=None, save_path=None, label=None):
        return self._plot_metric("llr", ax, save_path, label)

    def plot_convergence_vs_snr(self, ax=None, save_path=None, label=None):
        return self._plot_metric("convergence", ax, save_path, label)

    def plot_combined_dashboard(self, save_dir=None):
        """2x2 grid: BER, FER, normalized LLR, convergence -> dashboard.png."""
        fig, axes = plt.subplots(2, 2, figsize=(14, 10))
        cfg = self.result.config
        fig.suptitle(
            f"LDPC Simulation: {os.path.basename(cfg.matrix_path)} "
            f"(n={cfg.n}, k={cfg.k}, rate={cfg.rate:.3f})",
            fontsize=13,
        )
        self.plot_ber_vs_snr(ax=axes[0, 0])
        self.plot_fer_vs_snr(ax=axes[0, 1])
        self.plot_llr_vs_snr(ax=axes[1, 0])
        self.plot_convergence_vs_snr(ax=axes[1, 1])
        fig.tight_layout(rect=[0, 0, 1, 0.95])

        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            fig.savefig(os.path.join(save_dir, "dashboard.png"), dpi=150, bbox_inches="tight")
        return fig

    def plot_adaptation_history(self, save_dir=None):
        """Code-rate and max-iteration trajectories of an adaptive run."""
        log = self.result.adaptation_log
        if not log:
            return None

        fig, axes = plt.subplots(2, 1, figsize=(12, 8))
        fig.suptitle("Adaptive Parameter History", fontsize=13)
        snrs = [e["snr_db"] for e in log]
        axes[0].plot(snrs, [e.get("rate", 0) for e in log], "o-", color="tab:blue")
        axes[0].set_xlabel("SNR (dB)")
        axes[0].set_ylabel("Code Rate")
        axes[0].set_title("Code Rate vs SNR")
        axes[0].grid(True, alpha=0.3)
        axes[1].plot(
            snrs, [e.get("max_iterations", 0) for e in log], "s-", color="tab:orange"
        )
        axes[1].set_xlabel("SNR (dB)")
        axes[1].set_ylabel("Max Iterations")
        axes[1].set_title("Max Decoder Iterations vs SNR")
        axes[1].grid(True, alpha=0.3)
        fig.tight_layout(rect=[0, 0, 1, 0.95])

        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            fig.savefig(
                os.path.join(save_dir, "adaptation_history.png"),
                dpi=150,
                bbox_inches="tight",
            )
        return fig

    @staticmethod
    def plot_comparison(results, metric: str = "ber", save_path=None):
        """Overlay several SimulationResults on one figure."""
        if not HAS_MATPLOTLIB:
            raise ImportError("matplotlib is required for visualization")
        fig, ax = plt.subplots(figsize=(10, 7))
        for r in results:
            plotter = SimulationPlotter(r)
            label = (
                f"{os.path.basename(r.config.matrix_path)} (rate={r.config.rate:.3f})"
            )
            plotter._plot_metric(metric, ax=ax, label=label)
        if save_path:
            fig.savefig(save_path, dpi=150, bbox_inches="tight")
        return fig


def plot_failure_profile(profiles: dict, title: str = "", save_path=None):
    """Failure-weight histograms per SNR point (the JAX package's analysis.failures).

    ``profiles`` is the ``profile_sweep`` / ``--failure-profile`` JSON dict:
    ``{snr: {frames, hist_detected: {weight: count}, hist_undetected}}``.
    One panel per SNR (shared axes), per-frame rate on a log axis so panels
    with different frame counts compare directly; detected failures and
    undetected errors keep fixed hues across panels.
    """
    if not HAS_MATPLOTLIB:
        raise ImportError("matplotlib is required for visualization")
    snrs = sorted(profiles, key=float)
    fig, axes = plt.subplots(
        1, len(snrs), figsize=(4.5 * len(snrs), 4.5),
        sharey=True, squeeze=False,
    )
    for ax, snr in zip(axes[0], snrs):
        p = profiles[snr]
        frames = max(int(p.get("frames", 0)), 1)
        for key, label, color in (
            ("hist_detected", "detected failure", "C0"),
            ("hist_undetected", "undetected error", "C1"),
        ):
            hist = {int(w): c for w, c in p.get(key, {}).items()}
            if not hist:
                continue
            ws = sorted(hist)
            ax.bar(ws, [hist[w] / frames for w in ws], width=1.0,
                   color=color, alpha=0.75, label=label)
        ax.set_yscale("log")
        ax.set_xlabel("info-bit error weight")
        ax.set_title(f"{float(snr):g} dB  ({int(p.get('frames', 0)):,} frames)",
                     fontsize=10)
        ax.grid(True, alpha=0.3)
    axes[0][0].set_ylabel("events / frame")
    axes[0][0].legend(loc="upper right")
    fig.suptitle(title or "Failure structure vs SNR")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig


def plot_exit_chart(graph, ebno_db: float, rate: float, title: str = "",
                    save_path=None):
    """EXIT chart: VND curve vs inverted CND curve at one Eb/N0.

    The shaded region between the curves is the decoding tunnel; BP
    converges iff it stays open over the whole [0, 1) interval
    (ldpc_tpu_torch.analysis.exit). Beyond-reference analysis surface: the
    reference ships no analysis plots at all.
    """
    if not HAS_MATPLOTLIB:
        raise ImportError("matplotlib is required for visualization")
    from ldpc_tpu_torch.analysis.exit import exit_curves

    i_a, vnd, cnd_inv = exit_curves(graph, ebno_db, rate)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(i_a, vnd, label=f"VND (Eb/N0 = {ebno_db:.2f} dB)")
    ax.plot(i_a, cnd_inv, label="CND (axes swapped)")
    open_mask = vnd > cnd_inv
    ax.fill_between(i_a, cnd_inv, vnd, where=open_mask, alpha=0.15,
                    label="decoding tunnel")
    ax.set_xlabel("$I_A$ (VND input) / $I_E$ (CND output)")
    ax.set_ylabel("$I_E$ (VND output) / $I_A$ (CND input)")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.grid(True, alpha=0.3)
    ax.legend(loc="lower right")
    ax.set_title(title or f"EXIT chart (rate {rate:.3f})")
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig
