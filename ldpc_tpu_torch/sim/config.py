"""Simulation configuration.

A copy of the JAX package's ``sim/config.py`` (the port imports nothing from
that package), so one options bean means the same thing on both sides.
`SimOptions` carries the reference's full flag surface
(`python_ldpc_app/main.py:456-523`, `settings.py:4-89`) plus the simulator's
own knobs (decode graph, check-node rule, noise model, decoder variant,
device batch size, seed). The port honours every knob, on one device
(ldpc_tpu_torch.sim.runner) and over ranks (meshes in
ldpc_tpu_torch.parallel, the parallel sweep in
runner.run_simulation_parallel). `fidelity` presets bundle the compat quirks:

  'reference' -- decode on H_std with the reference's legacy check-node rule
                 and legacy (sigma^2-as-stddev) noise: BER/FER curves match
                 the reference simulator point-for-point in distribution.
  'exact'     -- decode the original sparse Tanner graph with the correct SPA
                 parity rule and physically calibrated noise: proper LDPC
                 performance (and ~40x fewer edges to process per iteration).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from enum import Enum


class Result(Enum):
    OK = "eOk"
    INVALID_INPUT = "eInvalidInput"
    INVALID_PATH = "eInvalidPath"
    DATA_TRANSFER_NOT_OK = "eDataTransferNotOk"


class InterleaverType(Enum):
    NONE = "eNone"
    REGULAR = "eRegular"
    RANDOM = "eRandom"
    SRANDOM = "eSRandom"


class LDPCDecoderType(Enum):
    BIT_FLIPPING = "eBitFlipping"
    SUM_PRODUCT = "eSumProduct"


class EncodingMethod(Enum):
    STANDARD = "standard"
    RICHARDSON_URBANKE = "richardson_urbanke"


@dataclass
class SimOptions:
    # --- reference flag surface (main.py:456-523) ---
    matrix: str = ""
    blocks: int = 100
    iterations: int = 5
    interleaver: str = "none"  # none | regular | random | srandom | file:<perm.npy>
    decoder: str = "sumproduct"  # sumproduct | bitflipping | minsum | normalized-minsum | offset-minsum
    speed: float = 1.0
    initial_snr: float = 0.0
    end_snr: float = 5.0
    step_snr: float = 0.5
    interference_snr: float = 1.0
    mode: int = 1
    p: float = 0.1
    modulation: int = 1
    s_param: int = 2
    ber: bool = False
    fer: bool = False
    normalized_llr: bool = False
    encoding_method: str = "standard"  # standard | richardson-urbanke
    ru_gap: int | None = None
    threads: int = 1  # accepted for CLI compatibility; ignored (device batch rules)

    # --- adaptive mode (main.py:512-522) ---
    adaptive: bool = False
    adaptive_strategy: str = "threshold"
    matrix_dir: str | None = None
    adaptive_high_ber: float = 1e-2
    adaptive_low_ber: float = 1e-5

    # --- export / plots ---
    output_json: str | None = None
    output_csv: str | None = None
    plot: bool = False
    plot_save: str | None = None

    # --- simulator knobs (the JAX package's flag surface, kept as-is) ---
    fidelity: str = "reference"  # preset: 'reference' | 'exact' (see module doc)
    decode_graph: str | None = None  # 'std' | 'orig' (None -> from fidelity)
    check_rule: str | None = None  # 'legacy' | 'exact' (None -> from fidelity)
    noise_model: str | None = None  # 'legacy' | 'exact' (None -> from fidelity)
    batch: int = 0  # device batch of codewords; 0 -> auto
    # 'auto' / 'pallas': the port's QC kernels (K1-K3) where they take the
    # configuration; 'xla': the plain PyTorch decoders (flooding on
    # EdgeLayout, or layered QC), the JAX package's XLA decoders
    kernel: str = "auto"
    # fully-fused Monte-Carlo step: channel noise, LLRs, decode and counters
    # in one kernel (ldpc_tpu_torch.ops.mc_kernels) where the configuration
    # allows it ('auto'), always ('on', refused where it cannot), or never
    # ('off': the unfused path, the standalone QC decoder K3)
    fused: str = "auto"
    # two-phase fused dispatch: phase 1 decodes every frame for a short
    # budget and emits its LLRs; the unconverged frames are compacted to the
    # front lanes (stable sort) and re-decoded from exactly those LLR bits
    # with the full budget. Decode is lane-wise, so counters equal a
    # single-pass decode. 'auto' probes each SNR point with one single-pass
    # batch and splits only where the probe predicts a win
    # (runner.PointExecutor._decide_two_phase); 'off' disables; an explicit
    # phase-1 iteration count (0 < N < max_iterations) forces the split.
    two_phase: str = "auto"
    schedule: str = "flooding"  # 'flooding' (reference schedule) | 'layered' (QC serial-C)
    # layered-sweep row order: 'serial' processes base rows 0..mb-1; 'paired'
    # processes disjoint-support row pairs per step
    # (models.qc.paired_layer_groups). The flattened pair order is the
    # schedule, so statistics differ from 'serial' at the MC level.
    layer_order: str = "serial"  # 'serial' | 'paired'
    # syndrome-check cadence: N message-passing sweeps per syndrome check.
    # conv_iter reports the check iteration and lanes keep updating between
    # checks, so counters differ from N=1 (FER agreement is statistical).
    # Requires iterations % N == 0 and --normalized-llr off.
    check_every: int = 1
    # extrinsic storage: 'int8' quantizes E to a 256-level grid on [-24, 24]
    # (min-sum variants only; the QC kernels of either path)
    msg_store: str = "f32"  # 'f32' | 'int8'
    # a layout knob of the TPU kernels with no effect on per-codeword
    # results; the port accepts and ignores it
    sublane_groups: str | int = "auto"
    seed: int = 0
    exact_ber: bool = False  # also count undetected-error bits (not just failed frames)
    # scalar, or a per-iteration schedule: [T] values, alpha[min(it, T-1)]
    # at sweep it, or [T, D] per distinct row degree (normalized min-sum)
    minsum_alpha: float | tuple = 0.75
    minsum_beta: float = 0.15
    quiet: bool = False

    # --- checkpoint / observability (absent in the reference, SURVEY.md S5) ---
    checkpoint: str | None = None  # JSON file flushed after every SNR point
    resume: bool = False  # resume a sweep from the checkpoint file
    profile: str | None = None  # profiler trace directory for the sweep

    # --- rate adaptation within one code (absent in the reference) ---
    # shorten: fix the LAST S info bits to zero (known at the receiver);
    # puncture: do not transmit the LAST P parity bits (LLR 0 = erasure).
    # Effective rate: (k - S) / (n - S - P).
    shorten: int = 0
    puncture: int = 0

    # --- sequential Monte-Carlo early stopping (absent in the reference) ---
    # Stop a SNR point once this many frame errors have been observed (the
    # estimator's relative precision is set by the error count, so fixed
    # error targets equalize per-point precision and skip wasted blocks at
    # high SNR). 0 = fixed block count like the reference.
    target_errors: int = 0

    def resolved(self) -> "SimOptions":
        """Fill fidelity-derived fields."""
        if self.fidelity not in ("reference", "exact"):
            raise ValueError(f"Unknown fidelity preset: {self.fidelity}")
        if self.layer_order not in ("serial", "paired"):
            raise ValueError(
                f"layer_order must be 'serial' or 'paired': {self.layer_order!r}"
            )
        if self.layer_order == "paired" and self.schedule != "layered":
            raise ValueError("--layer-order paired requires --schedule layered")
        if self.check_every < 1:
            raise ValueError(f"--check-every must be >= 1: {self.check_every}")
        if self.check_every > 1 and self.iterations % self.check_every:
            raise ValueError(
                f"--check-every {self.check_every} must divide "
                f"--iterations {self.iterations}"
            )
        if self.check_every > 1 and self.normalized_llr:
            raise ValueError(
                "--check-every > 1 is incompatible with --normalized-llr "
                "(the flip metric is defined per iteration)"
            )
        if self.sublane_groups != "auto":
            try:
                g = int(self.sublane_groups)
            except (TypeError, ValueError):
                raise ValueError(
                    "--sublane-groups must be 'auto' or a positive "
                    f"integer: {self.sublane_groups!r}"
                ) from None
            if g < 1:
                raise ValueError(f"--sublane-groups must be >= 1: {g}")
            if g > 1 and self.normalized_llr:
                raise ValueError(
                    "--sublane-groups > 1 is incompatible with "
                    "--normalized-llr (no exact within-block rotate-reduce "
                    "for the flip sum)"
                )
        exact = self.fidelity == "exact"
        return replace(
            self,
            decode_graph=self.decode_graph or ("orig" if exact else "std"),
            check_rule=self.check_rule or ("exact" if exact else "legacy"),
            noise_model=self.noise_model or ("exact" if exact else "legacy"),
        )

    @property
    def decoder_variant(self) -> str:
        d = self.decoder.lower().replace("_", "-")
        return {
            "sumproduct": "spa",
            "sum-product": "spa",
            "spa": "spa",
            "bitflipping": "bitflipping",
            "bit-flipping": "bitflipping",
            "minsum": "minsum",
            "min-sum": "minsum",
            "normalized-minsum": "normalized_minsum",
            "offset-minsum": "offset_minsum",
        }.get(d, d)

    def auto_batch(self, n: int) -> int:
        """Pick a device batch size: large enough to saturate the chip, small
        enough to keep message tensors comfortably in HBM."""
        if self.batch > 0:
            return self.batch
        target_elems = 64 << 20  # ~256 MB of f32 messages
        per_cw = max(n * 8, 1)
        b = max(1, target_elems // per_cw)
        return int(min(b, 8192, max(128, self.blocks)))
