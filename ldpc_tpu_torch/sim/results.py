"""Structured result data model with JSON/CSV export.

A copy of the JAX package's ``sim/results.py`` (the port imports nothing
from that package), so result files interchange between the two. Schema-
compatible with the reference (`python_ldpc_app/results.py:10-117`):
identical dataclass fields and CSV column set, so result files interchange
between the two simulators. `from_json` additionally tolerates unknown config
keys so files written by newer versions still load.
"""

from __future__ import annotations

import csv
import json
import os
from dataclasses import asdict, dataclass, field, fields
from typing import List, Tuple


@dataclass
class BlockResult:
    """Per-block result from a single encode/decode cycle."""

    block_num: int
    snr_db: float
    decode_success: bool
    error_bits: int
    normalized_llr: float
    convergence_iteration: int  # iteration when syndrome=0, or -1 if failed


@dataclass
class SNRPointResult:
    """Aggregated results for a single SNR point."""

    snr_db: float
    ber: float
    fer: float
    avg_normalized_llr: float
    total_blocks: int
    successful_blocks: int
    failed_blocks: int
    avg_convergence_iterations: float
    # Parameters used for this SNR point (tracks adaptive changes)
    matrix_path: str = ""
    modulation: int = 1
    max_iterations: int = 5
    interleaver: str = "none"
    encoding_method: str = "standard"


@dataclass
class SimulationConfig:
    """Captures all parameters of a simulation run."""

    matrix_path: str
    n: int
    m: int
    k: int
    rate: float
    blocks: int
    max_iterations: int
    encoding_method: str
    interleaver_type: str
    decoder_type: str
    channel_mode: int
    modulation: int
    speed: float
    snr_range: Tuple[float, float, float]  # (start, end, step)
    threads: int
    timestamp: str
    interference_snr: float = 0.0
    p: float = 0.1
    # TPU-framework extensions (absent in reference files; defaulted on load)
    fidelity: str = "reference"
    decode_graph: str = "std"
    check_rule: str = "legacy"
    noise_model: str = "legacy"
    batch: int = 0
    seed: int = 0
    device: str = ""
    shorten: int = 0
    puncture: int = 0
    schedule: str = "flooding"
    s_param: int = 2
    exact_ber: bool = False
    adaptive: bool = False
    fused: str = "auto"
    layer_order: str = "serial"
    check_every: int = 1
    # sublane grouping ('auto' or int as given): at G>1 the hw-PRNG draw
    # geometry changes, so the RESOLVED G is part of the sweep fingerprint
    sublane_groups: str = "auto"


@dataclass
class SimulationResult:
    """Complete simulation result container."""

    config: SimulationConfig
    snr_points: List[SNRPointResult]
    wall_clock_seconds: float
    adaptation_log: List[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        d = asdict(self)
        d["config"]["snr_range"] = list(d["config"]["snr_range"])
        return d

    def to_json(self, filepath: str) -> None:
        # atomic write: checkpoints are flushed mid-run and must survive a
        # kill during the dump (temp file + rename on the same filesystem)
        tmp = f"{filepath}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2, ensure_ascii=False)
        os.replace(tmp, filepath)

    def to_csv(self, filepath: str) -> None:
        """Per-SNR rows with the reference's exact column set (results.py:86-92)."""
        if not self.snr_points:
            return
        fieldnames = [
            "snr_db", "ber", "fer", "avg_normalized_llr",
            "total_blocks", "successful_blocks", "failed_blocks",
            "avg_convergence_iterations",
            "matrix_path", "modulation", "max_iterations",
            "interleaver", "encoding_method",
        ]
        with open(filepath, "w", newline="", encoding="utf-8") as f:
            writer = csv.DictWriter(f, fieldnames=fieldnames)
            writer.writeheader()
            for sp in self.snr_points:
                writer.writerow({k: getattr(sp, k) for k in fieldnames})

    @classmethod
    def from_json(cls, filepath: str) -> "SimulationResult":
        with open(filepath, "r", encoding="utf-8") as f:
            d = json.load(f)

        config_d = dict(d["config"])
        config_d["snr_range"] = tuple(config_d["snr_range"])
        known = {f.name for f in fields(SimulationConfig)}
        config = SimulationConfig(**{k: v for k, v in config_d.items() if k in known})

        point_known = {f.name for f in fields(SNRPointResult)}
        snr_points = [
            SNRPointResult(**{k: v for k, v in sp.items() if k in point_known})
            for sp in d["snr_points"]
        ]

        return cls(
            config=config,
            snr_points=snr_points,
            wall_clock_seconds=d["wall_clock_seconds"],
            adaptation_log=d.get("adaptation_log", []),
        )
