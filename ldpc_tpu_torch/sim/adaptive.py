"""Adaptive parameter selection between SNR points.

Counterpart of ``ldpc_tpu/sim/adaptive.py``, with the same adaptation log
and the reference's control policy (`python_ldpc_app/adaptive.py:62-124`):

  - BER > high_threshold                      -> switch to a lower-rate code
  - 0 < BER < low_threshold                   -> switch to a higher-rate code
  - avg convergence iters > 0.8 * max_iters   -> double max_iterations (cap 100)
  - FER > 0.5 while no interleaver            -> enable the random interleaver

The controller re-uses PointExecutors keyed by the parameter tuple (matrix,
iterations, interleaver, modulation), so revisiting a configuration does not
rebuild its tables. Point ``i`` draws from ``derive_key(seed, i)``, as a
plain sweep's point ``i`` does.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field, replace
from typing import List, Optional

import torch

from ldpc_tpu_torch.models.catalog import MatrixCatalog
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.results import SimulationResult, SNRPointResult
from ldpc_tpu_torch.sim.runner import (
    PointExecutor,
    build_point_result,
    load_checkpoint,
    load_code,
    make_sim_config,
    snr_steps,
)


@dataclass
class AdaptiveState:
    """Current state of the adaptive controller."""

    current_matrix_path: str
    current_rate: float
    current_modulation: int
    current_max_iterations: int
    current_interleaver: str
    current_encoding_method: str
    history: List[dict] = field(default_factory=list)


@dataclass
class AdaptiveAction:
    """Describes a parameter change decided by a strategy."""

    new_matrix_path: Optional[str] = None
    new_modulation: Optional[int] = None
    new_max_iterations: Optional[int] = None
    new_interleaver: Optional[str] = None
    reason: str = ""


LOWER_RATE = "__LOWER_RATE__"
HIGHER_RATE = "__HIGHER_RATE__"


class AdaptiveStrategy(ABC):
    @abstractmethod
    def evaluate(
        self, state: AdaptiveState, last_snr_result: SNRPointResult
    ) -> Optional[AdaptiveAction]:
        ...

    @abstractmethod
    def get_name(self) -> str:
        ...


class ThresholdStrategy(AdaptiveStrategy):
    """Threshold rules from adaptive.py:82-124."""

    def __init__(
        self,
        high_ber_threshold: float = 1e-2,
        low_ber_threshold: float = 1e-5,
        fer_threshold: float = 0.5,
        convergence_ratio: float = 0.8,
    ):
        self.high_ber_threshold = high_ber_threshold
        self.low_ber_threshold = low_ber_threshold
        self.fer_threshold = fer_threshold
        self.convergence_ratio = convergence_ratio

    def get_name(self) -> str:
        return "threshold"

    def evaluate(self, state, last_snr_result):
        action = AdaptiveAction()
        reasons = []

        if last_snr_result.ber > self.high_ber_threshold:
            action.new_matrix_path = LOWER_RATE
            reasons.append(
                f"BER={last_snr_result.ber:.2e} > {self.high_ber_threshold:.2e}, "
                "switching to lower rate"
            )
        elif 0 < last_snr_result.ber < self.low_ber_threshold:
            action.new_matrix_path = HIGHER_RATE
            reasons.append(
                f"BER={last_snr_result.ber:.2e} < {self.low_ber_threshold:.2e}, "
                "switching to higher rate"
            )

        if (
            last_snr_result.avg_convergence_iterations
            > self.convergence_ratio * state.current_max_iterations
        ):
            new_iters = min(state.current_max_iterations * 2, 100)
            if new_iters > state.current_max_iterations:
                action.new_max_iterations = new_iters
                reasons.append(
                    f"avg_conv={last_snr_result.avg_convergence_iterations:.1f} near "
                    f"max={state.current_max_iterations}, increasing to {new_iters}"
                )

        if (
            last_snr_result.fer > self.fer_threshold
            and state.current_interleaver == "none"
        ):
            action.new_interleaver = "random"
            reasons.append(
                f"FER={last_snr_result.fer:.3f} > {self.fer_threshold}, "
                "enabling random interleaver"
            )

        if not reasons:
            return None
        action.reason = "; ".join(reasons)
        return action


class AdaptiveController:
    """Orchestrates an adaptive SNR sweep (adaptive.py:127-440 analogue)."""

    def __init__(self, strategy: AdaptiveStrategy, catalog: MatrixCatalog,
                 device: str | torch.device | None = None, mesh=None):
        self.strategy = strategy
        self.catalog = catalog
        self.device = device  # None: the card
        # parallel.mesh.Mesh: the point executors shard the batch over it
        self.mesh = mesh
        self._executors: dict[tuple, PointExecutor] = {}

    def _executor(self, opts: SimOptions, state: AdaptiveState) -> PointExecutor:
        key = (
            state.current_matrix_path,
            state.current_max_iterations,
            state.current_interleaver,
            state.current_modulation,
        )
        if key not in self._executors:
            code = load_code(state.current_matrix_path)
            self._executors[key] = PointExecutor(
                code,
                replace(opts, matrix=state.current_matrix_path),
                max_iterations=state.current_max_iterations,
                interleaver=state.current_interleaver,
                modulation=state.current_modulation,
                device=self.device,
                mesh=self.mesh,
            )
        return self._executors[key]

    def run_adaptive_sweep(self, opts: SimOptions) -> SimulationResult:
        opts = opts.resolved()
        if not (opts.ber and opts.fer):
            # the threshold rules read point.ber/point.fer, which the
            # aggregator zeroes when the flags are off -- adaptation would
            # silently degenerate to the convergence rule alone
            opts = replace(opts, ber=True, fer=True)
        start = time.time()
        initial_code = load_code(opts.matrix)
        say = (lambda *a, **kw: None) if opts.quiet else print

        state = AdaptiveState(
            current_matrix_path=opts.matrix,
            current_rate=initial_code.rate,
            current_modulation=opts.modulation,
            current_max_iterations=opts.iterations,
            current_interleaver=opts.interleaver,
            current_encoding_method=opts.encoding_method,
        )

        snr_points: list[SNRPointResult] = []
        adaptation_log: list[dict] = []
        config = make_sim_config(opts, initial_code, self.device)
        prior = load_checkpoint(opts, config, say)
        if prior:
            # replay the strategy over the completed points: adaptation is a
            # deterministic function of (initial state, point results), so the
            # resumed state matches an uninterrupted run exactly
            snr_points = list(prior.snr_points)
            adaptation_log = list(prior.adaptation_log)
            for point in snr_points:
                action = self.strategy.evaluate(state, point)
                if action:
                    self._apply_action(action, state, lambda *a, **kw: None)

        say("Processing blocks across SNR points (adaptive mode)...")
        for idx, snr in enumerate(
            snr_steps(opts.initial_snr, opts.end_snr, opts.step_snr)
        ):
            if idx < len(snr_points):
                continue  # completed before resume
            say(
                f"\nSNR: {snr:.2f} dB  [rate={state.current_rate:.3f}, "
                f"mod={'BPSK' if state.current_modulation == 1 else 'QPSK'}, "
                f"iters={state.current_max_iterations}, "
                f"interleaver={state.current_interleaver}]"
            )

            adaptation_log.append(
                {
                    "snr_db": snr,
                    "matrix_path": state.current_matrix_path,
                    "rate": state.current_rate,
                    "modulation": state.current_modulation,
                    "max_iterations": state.current_max_iterations,
                    "interleaver": state.current_interleaver,
                    "encoding_method": state.current_encoding_method,
                }
            )

            executor = self._executor(opts, state)
            stats = executor.run_point(snr, opts.blocks, opts.seed, idx)
            point = build_point_result(
                snr,
                stats,
                opts,
                executor.k_active,
                matrix_path=state.current_matrix_path,
                modulation=state.current_modulation,
                max_iterations=state.current_max_iterations,
                interleaver=state.current_interleaver,
            )
            snr_points.append(point)
            if opts.ber:
                say(f"  BER: {point.ber:.6f}")
            if opts.fer:
                say(f"  FER: {point.fer:.6f}")
            say(
                f"  Decoded OK: {point.successful_blocks}/{point.total_blocks} "
                f"({100.0 * point.successful_blocks / max(point.total_blocks, 1):.2f}%)"
            )

            action = self.strategy.evaluate(state, point)
            if action:
                say(f"  [Adaptive] {action.reason}")
                self._apply_action(action, state, say)

            if opts.checkpoint:
                SimulationResult(
                    config=config,
                    snr_points=snr_points,
                    wall_clock_seconds=time.time() - start,
                    adaptation_log=adaptation_log,
                ).to_json(opts.checkpoint)

        result = SimulationResult(
            config=config,
            snr_points=snr_points,
            wall_clock_seconds=time.time() - start,
            adaptation_log=adaptation_log,
        )
        return result

    def _apply_action(self, action: AdaptiveAction, state: AdaptiveState, say) -> None:
        current_info = self.catalog.find_by_path(state.current_matrix_path)

        if action.new_matrix_path == LOWER_RATE and current_info:
            lower = self.catalog.get_lower_rate(current_info)
            if lower:
                state.current_matrix_path = lower.path
                state.current_rate = lower.rate
                say(f"  [Adaptive] Matrix: {lower.name} (rate={lower.rate:.3f})")
        elif action.new_matrix_path == HIGHER_RATE and current_info:
            higher = self.catalog.get_higher_rate(current_info)
            if higher:
                state.current_matrix_path = higher.path
                state.current_rate = higher.rate
                say(f"  [Adaptive] Matrix: {higher.name} (rate={higher.rate:.3f})")

        if action.new_max_iterations is not None:
            state.current_max_iterations = action.new_max_iterations
        if action.new_modulation is not None:
            state.current_modulation = action.new_modulation
        if action.new_interleaver is not None:
            state.current_interleaver = action.new_interleaver
