"""The system under test: the only module of the benchmark that imports the
port, ``ldpc_tpu_torch``. It builds the timed entry points from a
configuration and reads their outputs back as counters.

Streaming cells drive ``PointExecutor.run_point`` (one executor for the
run); sweep cells drive ``run_simulation`` (a fresh executor each sweep, the
command line's path without the process start).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

# the kernel libraries' fixed directory inside the checkout
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "benchmark"
COUNTERS = ("frames", "frame_errors", "bit_errors", "converged", "conv_sum")


def use_build_dir() -> None:
    """Point the port's kernel builds at :data:`BUILD_DIR`."""
    from ldpc_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache(str(BUILD_DIR))


class Program:
    def __init__(self, config: dict, traffic: dict, device=None):
        from ldpc_tpu_torch.sim.config import SimOptions
        from ldpc_tpu_torch.sim.runner import load_code

        self.traffic = traffic
        self.device = device
        self.code = load_code(config["options"]["matrix"])
        opts = dict(config["options"], quiet=True, seed=0)
        if traffic["kind"] == "sweep":
            opts.update(blocks=traffic["frames_per_point"],
                        target_errors=traffic["target_errors"],
                        initial_snr=traffic["snr_db"][0],
                        end_snr=traffic["snr_db"][1],
                        step_snr=traffic["snr_db"][2])
        else:
            opts.update(blocks=traffic["frames_per_call"])
        self.opts = SimOptions(**opts)
        self.executor = None

    def start(self) -> None:
        """Builds what a streaming run reuses (a sweep builds its own)."""
        if self.traffic["kind"] == "stream":
            from ldpc_tpu_torch.sim.runner import PointExecutor

            self.executor = PointExecutor(self.code, self.opts,
                                          device=self.device)

    def call(self, key: int) -> dict:
        """One streaming call: ``frames_per_call`` frames at the traffic's
        point, drawn from ``key``."""
        s = self.executor.run_point(self.traffic["snr_db"],
                                    self.traffic["frames_per_call"], key, 0)
        return dict(zip(COUNTERS, (s.blocks, s.fer_frames, s.error_bits,
                                   s.conv_count, s.conv_iters_sum)))

    def sweep(self, key: int) -> list[dict]:
        """One sweep drawn from ``key``: counters per point."""
        from ldpc_tpu_torch.sim.runner import run_simulation

        res = run_simulation(dataclasses.replace(self.opts, seed=key),
                             device=self.device)
        out = []
        for p in res.snr_points:
            ok = p.successful_blocks
            out.append(dict(zip(COUNTERS, (
                p.total_blocks, p.total_blocks - ok,
                round(p.ber * self.code.k * p.total_blocks), ok,
                round(p.avg_convergence_iterations * ok)))))
        return out

    def close(self) -> None:
        self.executor = None
