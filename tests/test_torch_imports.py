"""The port stands alone: it imports neither JAX nor the JAX package (nor
does ``chip_smoke.py``), and its entry points default to the card."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import ldpc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ldpc_tpu_torch.__path__,
                                               "ldpc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ldpc_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


# the repo-level studies of the JAX package's scripts/, ported
STUDIES = ("error_floor", "undetected_witness", "importance_floor",
           "is_depth_harvest", "quantized_messages_study",
           "burst_interleaver_study", "learned_minsum_study",
           "parity_fixed_noise", "parity_spread", "family_validation",
           "perf_matrix", "family_atlas", "big_code_study", "mfu_levers",
           "variant_perf", "two_phase_envelope", "envelope_paired",
           "two_phase_parity", "small_code_binder", "exit_charts",
           "cli_records")

_STUDY_PROBE = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module("ldpc_tpu_torch." + name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ldpc_tpu", "scripts",
                                    "bench", "__graft_entry__", "examples",
                                    "generate"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 65  # every module of the port was imported
    for name in ("ops.qc_kernels", "ops.interleave", "ops.modem",
                 "sim.results", "analysis.__init__", "analysis.roofline",
                 "ops.rate_kernels", "scripts.__init__", "scripts.roofline",
                 "scripts.attainable_ceiling", "ops.spa", "ops.layered",
                 "models.ru", "models.generate", "models.catalog",
                 "analysis.graph_stats", "analysis.exit", "utils.timing",
                 "sim.visualization", "sim.adaptive", "cli", "plot_cli",
                 "parallel.__init__", "parallel.distributed", "parallel.mesh",
                 "parallel.dryrun", "analysis.failures", "analysis.importance",
                 "analysis.learned_minsum", "analysis.density_evolution",
                 "utils.legacy_rng", "utils.cache", "scripts.study", "entry",
                 *(f"scripts.{s}" for s in STUDIES)):
        assert os.path.isfile(os.path.join(
            REPO, "ldpc_tpu_torch", *name.split(".")[:-1],
            name.split(".")[-1] + ".py"))
    for src in ("roofline.cu", "mc_decoder.cu", "llr_decoder.cu",
                "qc_decoder.cu", "decode_group.cuh"):
        assert os.path.isfile(os.path.join(REPO, "ldpc_tpu_torch", "csrc", src))


def test_studies_import_neither_jax_nor_reference_nor_its_scripts():
    """The ported studies, the entry point and their shared modules, loaded
    in a fresh interpreter: none pulls in ``jax``, ``ldpc_tpu``, the JAX
    package's ``scripts/``, the root ``bench.py``, ``__graft_entry__`` or
    ``examples/`` (``exit_charts/generate.py``)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    names = ["utils.cache", "scripts.study", "ops.metrics", "bench", "entry",
             *(f"scripts.{s}" for s in STUDIES)]
    proc = subprocess.run([sys.executable, "-c", _STUDY_PROBE, *names],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for launcher in ("run_ldpc.sh", "run_ldpc_advanced.sh"):
        text = open(os.path.join(REPO, "ldpc_tpu_torch", "scripts", launcher),
                    encoding="utf-8").read()
        assert "exec python -m ldpc_tpu_torch.cli" in text
        assert "ldpc_tpu.cli" not in text


def test_chip_smoke_imports_neither_jax_nor_reference():
    """Parsed, not run: every import in the script, at any depth."""
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "ldpc_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "ldpc_tpu"}, sorted(roots)


def test_entry_points_default_to_the_card():
    from ldpc_tpu_torch.analysis.roofline import (
        measure_mix_rate,
        measure_rates,
        measure_tile_trips,
    )
    from ldpc_tpu_torch.analysis.density_evolution import (
        de_error_probability,
        regular_protograph,
    )
    from ldpc_tpu_torch.analysis.failures import profile_point
    from ldpc_tpu_torch.analysis.learned_minsum import evaluate_alphas
    from ldpc_tpu_torch.ops.channel import ChannelParams
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import (
        PointExecutor,
        load_code,
        run_simulation,
        run_simulation_parallel,
    )
    from ldpc_tpu_torch.utils.device import resolve_device

    code = load_code("builtin:wimax_576_0.5.alist.txt")
    opts = SimOptions(matrix=code.name, iterations=4, fidelity="exact",
                      batch=128, schedule="layered", two_phase="off")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert ChannelParams().consts().is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ChannelParams().consts()
    with pytest.raises(RuntimeError, match="CUDA"):
        PointExecutor(code, opts)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_simulation(opts, code)
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_rates()
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_mix_rate({"fma": 3.0, "tanh": 1.0})
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_tile_trips(code, opts, 2.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_simulation_parallel(opts, code)
    with pytest.raises(RuntimeError, match="CUDA"):
        de_error_probability(regular_protograph(3, 6), 1.0, 0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_alphas(code, 0.75, 2.0, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_point(code, opts, 2.0, 1, 1)
    assert PointExecutor(code, opts, device="cpu").device.type == "cpu"


def test_cuda_tensor_never_takes_the_plain_version():
    """A wrapper raises for a device it has no kernel for; on the CPU it
    runs the plain version (there is no fallback in between)."""
    from ldpc_tpu_torch.ops.mc_kernels import LLRDecoder
    from ldpc_tpu_torch.sim.runner import load_code

    code = load_code("builtin:wimax_576_0.5.alist.txt")
    dec = LLRDecoder(code.qc, code.standard_encode_spec.info_pos("orig"), 2,
                     "minsum")
    x = torch.zeros((code.n, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dec(x, x, torch.zeros(4, device="meta"))
    out = dec(torch.ones((code.n, 4)), torch.zeros((code.n, 4)),
              torch.zeros(4))
    assert out[1].all()  # all-positive LLRs are the all-zero codeword


def test_plain_decoders_and_cli_default_to_the_card(capsys):
    """The plain decoders, the adaptive sweep and the CLI run on the card
    unless the caller asks for the CPU."""
    from ldpc_tpu_torch.cli import main
    from ldpc_tpu_torch.models.catalog import MatrixCatalog
    from ldpc_tpu_torch.ops.layered import make_qc_layered_decoder
    from ldpc_tpu_torch.ops.spa import make_bitflip_decoder, make_decoder
    from ldpc_tpu_torch.sim.adaptive import AdaptiveController, ThresholdStrategy
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import load_code

    code = load_code("builtin:wimax_576_0.5.alist.txt")
    info = code.standard_encode_spec.info_pos("orig")
    makers = (
        lambda dev: make_decoder(code.layout("std"), info, 2, device=dev),
        lambda dev: make_bitflip_decoder(code.layout("orig"), info, 2,
                                         device=dev),
        lambda dev: make_qc_layered_decoder(code.qc, info, 2, device=dev),
    )
    if torch.cuda.is_available():
        for build in makers:
            assert next(build(None).buffers()).is_cuda
        return
    for build in makers:
        with pytest.raises(RuntimeError, match="CUDA"):
            build(None)
        build("cpu")
    opts = SimOptions(matrix=code.name, adaptive=True, blocks=8, batch=8,
                      initial_snr=0.0, end_snr=0.0, quiet=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        AdaptiveController(ThresholdStrategy(), MatrixCatalog()) \
            .run_adaptive_sweep(opts)
    assert main(["--matrix", code.name, "--blocks", "8", "--quiet"]) == 1
    assert "CUDA is not available" in capsys.readouterr().out
