"""The port's meshes and parallel sweep (``ldpc_tpu_torch.parallel``,
``run_simulation_parallel``) on the CPU, after ``tests/test_sharding.py``
and ``tests/test_distributed.py``.

The two packages draw from different random streams, so the port is held
to itself where the JAX tests hold the JAX package to itself: the parallel
sweep equals the sequential unfused sweep point for point, a sharded run
equals a one-process run, a resumed sweep equals one that ran through. The
mesh shapes, their errors and the ``fused='on'`` refusal are held to the
JAX package's. Multi-rank cases spawn two gloo ranks on the CPU.

Tolerance: none; the counters are equal (the float norm sum too: the same
per-batch sums add in the same order).
"""

from __future__ import annotations

import json
import re
import sys

import numpy as np
import pytest
import torch

from ldpc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ldpc_tpu.sim.config import SimOptions as JOptions
from ldpc_tpu.sim.runner import PointExecutor as JExecutor
from ldpc_tpu.sim.runner import load_code as jax_load_code
from ldpc_tpu_torch.models.code import LDPCCode
from ldpc_tpu_torch.models.generate import gallager_regular
from ldpc_tpu_torch.ops.mc_kernels import MCDecoder
from ldpc_tpu_torch.ops.channel import ChannelParams
from ldpc_tpu_torch.ops.encode import make_encoder_T
from ldpc_tpu_torch.parallel.dryrun import dryrun_multiprocess, free_port, run_ranks
from ldpc_tpu_torch.parallel.mesh import make_mesh
from ldpc_tpu_torch.sim.adaptive import AdaptiveController, ThresholdStrategy
from ldpc_tpu_torch.models.catalog import MatrixCatalog
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import (
    FUSED_ON_TEXT,
    PointExecutor,
    derive_key,
    load_code,
    run_simulation,
    run_simulation_parallel,
)

torch.set_num_threads(1)

CCSDS = "builtin:CCSDS_ldpc_n32_k16.alist.txt"
W576 = "builtin:wimax_576_0.5.alist.txt"
RANK_TIMEOUT_S = 300


def _points(result):
    return [(p.snr_db, p.total_blocks, p.successful_blocks, p.ber, p.fer,
             p.avg_normalized_llr, p.avg_convergence_iterations)
            for p in result.snr_points]


def _sweep_kw(**kw):
    base = dict(matrix=CCSDS, blocks=128, iterations=5, ber=True, fer=True,
                normalized_llr=True, initial_snr=0.0, end_snr=2.0,
                step_snr=1.0, fidelity="exact", batch=32, seed=11,
                quiet=True)
    return {**base, **kw}


# ------------------------------------------------------------------ meshes --

def test_make_mesh_shapes_and_errors():
    """One rank: the JAX package's shapes and error text at one device."""
    assert make_mesh().shape == {"batch": 1}
    assert make_mesh({"snr": 1, "batch": -1}).shape == {"snr": 1, "batch": 1}
    mesh = make_mesh({"snr": 1, "batch": 1})
    assert mesh.axis_names == ("snr", "batch")
    assert mesh.devices.shape == (1, 1)
    assert mesh.coords == {"snr": 0, "batch": 0}
    assert mesh.index(("snr", "batch")) == 0 and mesh.size(("snr",)) == 1
    with pytest.raises(ValueError) as t:
        make_mesh({"batch": 3})
    with pytest.raises(ValueError) as j:
        jax_make_mesh({"batch": 3}, devices=[object()])
    assert str(t.value) == str(j.value)


def test_executor_pads_batch_to_mesh():
    code = LDPCCode(alist=gallager_regular(48, 3, 6, seed=11), name="r48")
    ex = PointExecutor(code, SimOptions(matrix="r48", blocks=10, batch=10,
                                        fidelity="exact"),
                       device="cpu", mesh=make_mesh())
    assert ex.batch == 10 and ex.local_batch == 10


def test_fused_on_under_the_parallel_sweep_raises_the_jax_text():
    opts = _sweep_kw(fused="on")
    with pytest.raises(ValueError) as t:
        run_simulation_parallel(SimOptions(**opts), device="cpu")
    with pytest.raises(ValueError) as j:
        JExecutor(jax_load_code(CCSDS), JOptions(**opts),
                  mesh=jax_make_mesh({"batch": 8}), step_vmapped=True)
    assert str(j.value) == FUSED_ON_TEXT
    assert str(t.value).startswith(FUSED_ON_TEXT)
    assert "outside the parallel sweep" in str(t.value).split("missing")[1]


# ---------------------------------------------------- one-rank equalities --

@pytest.mark.parametrize("target", [0, 10])
def test_parallel_sweep_matches_sequential_exactly(target):
    kw = _sweep_kw(blocks=256, initial_snr=0.0, end_snr=4.0, step_snr=2.0,
                   seed=7, target_errors=target)
    seq = run_simulation(SimOptions(**kw, fused="off"), device="cpu")
    par = run_simulation_parallel(SimOptions(**kw), device="cpu")
    assert _points(seq) == _points(par)
    if target:  # the low-SNR point stopped early, the clean one did not
        assert seq.snr_points[0].total_blocks < seq.snr_points[-1].total_blocks


def test_sweep_step_one_launch_equals_single_points():
    """The QC decoder takes the active points in one call: per point, the
    stats equal a one-point step, and a skipped point runs 0 trips."""
    code = load_code(W576)
    ex = PointExecutor(code, SimOptions(matrix=W576, iterations=6,
                                        fidelity="exact", batch=16,
                                        fused="off"),
                       device="cpu", step_vmapped=True)
    assert ex.kernel_used.startswith("cpu")
    consts = [ex.consts(s) for s in (1.0, 1.5, 2.0, 2.5)]
    keys = [derive_key(3, i) for i in range(4)]
    skips = [1, 0, 1, 0]
    stats, iters = ex.sweep_step(keys, consts, skips)
    assert tuple(stats.ok.shape) == (4, 16)
    for i in range(4):
        if skips[i]:
            assert int(iters[i]) == 0
            continue
        one, it = ex.step(keys[i], consts[i])
        for a, b in zip(stats, one):
            assert torch.equal(a[i], b)
        assert int(iters[i]) == int(it)


def test_parallel_checkpoint_resume_is_bit_identical(tmp_path):
    kw = _sweep_kw(blocks=96, seed=7)
    full = run_simulation_parallel(SimOptions(**kw), device="cpu")
    ckpt = str(tmp_path / "par.json")
    run_simulation_parallel(SimOptions(**dict(kw, blocks=32, checkpoint=ckpt)),
                            device="cpu")
    saved = json.load(open(ckpt))
    assert saved["parallel_sweep"] == 1 and saved["batch_idx"] == 1
    # what an interrupted 96-block run would have written
    from ldpc_tpu_torch.sim.runner import make_sim_config, sweep_fingerprint

    opts = SimOptions(**dict(kw, checkpoint=ckpt, resume=True))
    saved["fingerprint"] = json.loads(json.dumps(sweep_fingerprint(
        make_sim_config(opts.resolved(), load_code(CCSDS), "cpu"))))
    saved["remaining"] = 96 - 32
    json.dump(saved, open(ckpt, "w"))
    resumed = run_simulation_parallel(opts, device="cpu")
    assert _points(resumed) == _points(full)


def test_k1_shards_draw_the_whole_batch():
    """K1's codeword offset: two half launches (b0 = 0, B/2) give the whole
    launch's outputs, noise included."""
    code = load_code(W576)
    info_pos = code.standard_encode_spec.info_pos("orig")
    B = 32
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.integers(0, 2, (B, code.k), dtype=np.uint8))
    wT = make_encoder_T(code.standard_encode_spec, "orig", "cpu")(u)
    consts = ChannelParams(snr_db=1.0, speed=0.5,
                           noise_model="exact").consts("cpu")
    mc = MCDecoder(code.qc, info_pos, 6, "normalized_minsum", emit_llr=True)
    key = (0x1234, 0x5678)
    whole = mc(wT, consts, seeds=key)
    halves = [mc(wT[:, lo:lo + B // 2].contiguous(), consts, seeds=key, b0=lo)
              for lo in (0, B // 2)]
    for i, x in enumerate(whole):
        joined = torch.cat([h[i] for h in halves], dim=-1)
        assert torch.equal(x, joined)
    other = mc(wT[:, B // 2:].contiguous(), consts, seeds=key)
    assert not torch.equal(other[5], halves[1][5])


# ------------------------------------------------------------- two ranks --

_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
from ldpc_tpu_torch.parallel.distributed import (
    initialize_distributed, is_multi_process, shutdown)
from ldpc_tpu_torch.parallel.mesh import make_mesh
from ldpc_tpu_torch.sim.config import SimOptions

rank, world, port, out, scenario, kw = (int(sys.argv[1]), int(sys.argv[2]),
    sys.argv[3], sys.argv[4], sys.argv[5], json.loads(sys.argv[6]))
assert initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
assert is_multi_process()


def points(res):
    return [(p.snr_db, p.total_blocks, p.successful_blocks, p.ber, p.fer,
             p.avg_normalized_llr, p.avg_convergence_iterations)
            for p in res.snr_points]


if scenario == "point":
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code
    payload = {}
    for fused in ("auto", "off"):
        opts = SimOptions(**kw, fused=fused)
        ex = PointExecutor(load_code(opts.matrix), opts, device="cpu",
                           mesh=make_mesh({"batch": -1}))
        st = ex.run_point(1.0, opts.blocks, 7, 0)
        payload[fused] = [ex.kernel_used, st.__dict__]
elif scenario == "snr":
    from ldpc_tpu_torch.sim.runner import run_simulation_parallel
    payload = points(run_simulation_parallel(
        SimOptions(**kw), mesh=make_mesh({"snr": 2}), device="cpu"))
elif scenario == "adaptive":
    from ldpc_tpu_torch.models.catalog import MatrixCatalog
    from ldpc_tpu_torch.sim.adaptive import AdaptiveController, ThresholdStrategy
    res = AdaptiveController(ThresholdStrategy(), MatrixCatalog(None),
                             device="cpu", mesh=make_mesh({"batch": -1})
                             ).run_adaptive_sweep(SimOptions(**kw))
    payload = [points(res), res.adaptation_log]
elif scenario == "cli":
    from ldpc_tpu_torch import cli
    assert cli.main(kw + ["--output-json", out + ".json"], device="cpu") == 0
    payload = json.load(open(out + ".json"))["snr_points"]
json.dump(payload, open(out, "w"))
shutdown()
"""


def _two_ranks(tmp_path, scenario, kw):
    port = free_port()
    outs = [str(tmp_path / f"{scenario}{r}.out") for r in range(2)]
    run_ranks(lambda r: [sys.executable, "-c", _WORKER, str(r), "2",
                         str(port), outs[r], scenario, json.dumps(kw)],
              2, RANK_TIMEOUT_S)
    a, b = (json.load(open(o)) for o in outs)
    assert a == b, "the ranks disagree"
    return a


def test_two_ranks_batch_mesh_equals_one_process(tmp_path):
    """A point sharded over two ranks, fused (K1's plain version with the
    rank's codeword offset) and unfused, with and without a quota."""
    for target in (0, 20):
        kw = dict(matrix=CCSDS, blocks=160, iterations=5, ber=True, fer=True,
                  normalized_llr=True, fidelity="exact", batch=64, seed=7,
                  quiet=True, target_errors=target)
        got = _two_ranks(tmp_path, "point", kw)
        for fused in ("auto", "off"):
            opts = SimOptions(**kw, fused=fused)
            ex = PointExecutor(load_code(CCSDS), opts, device="cpu")
            st = ex.run_point(1.0, opts.blocks, 7, 0)
            kernel, stats = got[fused]
            assert kernel == ex.kernel_used
            assert stats == st.__dict__, (fused, target)


def test_two_ranks_snr_mesh_equals_one_process(tmp_path):
    """Three points dealt over snr=2 (a padding replica), with a quota."""
    kw = _sweep_kw(target_errors=12, blocks=192)
    got = _two_ranks(tmp_path, "snr", kw)
    one = run_simulation(SimOptions(**kw, fused="off"), device="cpu")
    assert [tuple(p) for p in got] == _points(one)


def test_two_ranks_adaptive_sweep_equals_one_process(tmp_path):
    kw = dict(matrix=W576, blocks=32, iterations=5, ber=True, fer=True,
              initial_snr=0.0, end_snr=2.0, step_snr=1.0, fidelity="exact",
              batch=32, seed=3, quiet=True)
    pts, log = _two_ranks(tmp_path, "adaptive", kw)
    one = AdaptiveController(ThresholdStrategy(), MatrixCatalog(None),
                             device="cpu").run_adaptive_sweep(SimOptions(**kw))
    assert log == json.loads(json.dumps(one.adaptation_log))
    assert [tuple(p) for p in pts] == _points(one)


def test_two_ranks_cli_distributed_mesh(tmp_path):
    """``--distributed --mesh snr=2`` over two ranks: the points of a
    one-process ``--fused off`` run."""
    argv = ["--matrix", CCSDS, "--blocks", "64", "--batch", "32",
            "--iterations", "5", "--ber", "--fer", "--fidelity", "exact",
            "--initial-snr", "0", "--end-snr", "1", "--step-snr", "1",
            "--seed", "5", "--quiet", "--distributed", "--mesh", "snr=2"]
    got = _two_ranks(tmp_path, "cli", argv)
    one = run_simulation(SimOptions(
        matrix=CCSDS, blocks=64, batch=32, iterations=5, ber=True, fer=True,
        fidelity="exact", initial_snr=0.0, end_snr=1.0, step_snr=1.0, seed=5,
        quiet=True, fused="off"), device="cpu")
    assert [(p["snr_db"], p["total_blocks"], p["successful_blocks"], p["ber"],
             p["fer"]) for p in got] == [x[:5] for x in _points(one)]


@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_multiprocess(n, capsys):
    rep = dryrun_multiprocess(n, device="cpu", timeout_s=RANK_TIMEOUT_S)
    out = capsys.readouterr().out
    assert re.search(r"dryrun_multiprocess OK: .*counters == one process", out)
    if n == 2:
        assert rep["mesh"] == {"snr": 2, "batch": 1}
        assert rep["skipped_iters"] == 0
    else:
        assert rep["mesh"] == {"snr": 1, "batch": 3}
