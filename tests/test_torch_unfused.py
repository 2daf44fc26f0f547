"""The unfused path of the port on the CPU: the slice as a whole against the
JAX package's chain on the same inputs, the decoder choice for each
configuration, the SNR sweep with checkpoint and resume, the result files,
and the FER of the 16-QAM burst configuration on both sides of its
waterfall."""

from __future__ import annotations

import csv
import dataclasses
import functools
import json
import operator
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu.ops import encode as jencode
from ldpc_tpu.ops import metrics as jmetrics
from ldpc_tpu.ops.spa import make_decoder
from ldpc_tpu.sim import results as jresults
from ldpc_tpu.sim import runner as jrunner
from ldpc_tpu.sim.config import SimOptions as JOptions
from ldpc_tpu_torch.analysis import importance as tis
from ldpc_tpu_torch.models.generate import gallager_regular
from ldpc_tpu_torch.ops import metrics as tmetrics
from ldpc_tpu_torch.ops.layered import QCLayeredDecoder
from ldpc_tpu_torch.ops.mc_kernels import MCDecoder
from ldpc_tpu_torch.ops.qc_kernels import QCDecoder
from ldpc_tpu_torch.ops.spa import BitflipDecoder, DecodeResult, FloodingDecoder
from ldpc_tpu_torch.sim import runner as trunner
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.results import SimulationResult
from ldpc_tpu_torch.sim.runner import (
    FUSED_ON_TEXT,
    PointExecutor,
    PointStats,
    choose_route,
    load_code,
    run_simulation,
    snr_steps,
)
from ldpc_tpu_torch.utils.carry import code_from_numpy

torch.set_num_threads(1)

W576 = "wimax_576_0.5.alist.txt"
B = 256


def _opts(**kw):
    base = dict(matrix=f"builtin:{W576}", fidelity="exact", batch=B, seed=1,
                speed=0.5, quiet=True)
    base.update(kw)
    return SimOptions(**base)


@pytest.mark.parametrize("normalized_llr", [False, True])
def test_slice_matches_the_reference_chain(normalized_llr):
    """wimax 576, normalized min-sum, flooding, shorten 16, puncture 32:
    the same info bits and the same channel LLRs through the JAX chain and
    the port's executor step give the same packed counters."""
    S, P, iters = 16, 32, 10
    jcode = JCode(alist=jstd.make_builtin(W576), name=W576)
    spec = jcode.standard_encode_spec
    info = np.asarray(spec.info_pos("orig"), np.int64)
    k, n = jcode.k, jcode.n
    k_act = k - S
    rng = np.random.default_rng(11)
    u = rng.integers(0, 2, (B, k), dtype=np.uint8)
    u[:, k_act:] = 0
    w = np.asarray(jencode.make_encoder(spec, "orig")(jnp.asarray(u)),
                   np.float64)
    sigma = 1.0 / np.sqrt(2 * 0.5 * 10 ** (1.0 / 10))
    llr = (2 * ((2 * w - 1) + sigma * rng.standard_normal(w.shape))
           / sigma**2).astype(np.float32)

    # the JAX chain (runner.py:480-497, 921-932)
    parity = np.setdiff1d(np.arange(n), info)
    punct = np.ones((1, n), np.float32)
    punct[0, parity[n - k - P:]] = 0.0
    short = np.zeros((1, n), np.float32)
    short[0, info[k_act:]] = 1.0
    x = jnp.asarray(llr) * punct
    x = x * (1.0 - short) - 60.0 * short
    res = make_decoder(jcode.layout("orig"), info[:k_act], iters,
                       "normalized_minsum", rule="exact")(x)
    if not normalized_llr:  # the runner's QC decoder skips the metric then
        res = res._replace(norm_llr=jnp.zeros_like(res.norm_llr))
    stats = jmetrics.block_stats(jnp.asarray(u[:, :k_act]), res,
                                 jnp.asarray(info[:k_act].astype(np.int32)))
    ref = np.asarray(jmetrics.pack_counters(
        jmetrics.reduce_block_stats(stats, jnp.ones(B, bool)), res.iters_run))

    code = load_code(f"builtin:{W576}")
    ex = PointExecutor(code, _opts(
        schedule="flooding", decoder="normalized-minsum", iterations=iters,
        shorten=S, puncture=P, normalized_llr=normalized_llr), device="cpu")
    assert not ex.fused and ex.kernel_used == "cpu" and ex.k_active == k_act
    st, it = ex.step(0, ex.consts(1.0), u=torch.from_numpy(u),
                     llr=torch.from_numpy(llr))
    port = ex.packed(st, it, B).numpy()
    assert 0 < ref[1] < B  # the point exercises both outcomes
    if normalized_llr:
        # the per-frame metrics agree to an ulp, their f32 sums to rounding
        np.testing.assert_array_equal(port[:7], ref[:7])
        np.testing.assert_allclose(port[7:].view(np.float32),
                                   ref[7:].view(np.float32), rtol=1e-6)
    else:
        np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("kw,fused,kind", [
    # flooding and the normalized-LLR metric take the fused path, as the
    # JAX runner's eligibility (runner.py:525-540) has no clause for them
    (dict(schedule="flooding"), True, "cpu+fused"),
    (dict(schedule="layered", two_phase="off"), True, "cpu+fused+layered"),
    (dict(schedule="layered", interleaver="random"), False, "cpu+layered"),
    (dict(schedule="layered", modulation=16, mode=2), False, "cpu+layered"),
    (dict(schedule="layered", shorten=8), False, "cpu+layered"),
    (dict(schedule="layered", normalized_llr=True), True,
     "cpu+fused+layered"),
    (dict(schedule="layered", layer_order="paired", check_every=2,
          fused="off"), False, "cpu+layered+paired+ce2"),
    (dict(schedule="flooding", kernel="pallas", interleaver="regular"), False,
     "cpu"),
])
def test_decoder_choice(kw, fused, kind):
    ex = PointExecutor(load_code(f"builtin:{W576}"), _opts(iterations=4, **kw),
                       device="cpu")
    assert ex.fused == fused and ex.kernel_used == kind


@pytest.mark.parametrize("kw,exc,what", [
    # refused until the plain PyTorch decoders were ported; now they run on
    # them (``what``: the executor's kernel_used)
    (dict(kernel="xla"), None, "torch"),
    (dict(fidelity="reference"), None, "torch"),
    (dict(check_rule="exact", fidelity="reference"), None, "torch"),
    (dict(decoder="bitflipping"), None, "torch"),
    # the JAX runner's refusals (runner.py:248-288)
    (dict(msg_store="int8", decoder="sumproduct"), ValueError,
     "int8 requires a min-sum"),
    (dict(msg_store="int8", decoder="minsum", kernel="xla"), ValueError,
     "storage knob"),
    (dict(minsum_alpha=(0.7, 0.8), decoder="minsum"), ValueError,
     "requires --decoder normalized-minsum"),
    (dict(fused="on"), ValueError, "interleaver"),
    (dict(modulation=16, fidelity="reference"), ValueError, "exact"),
    # the --two-phase checks run for the unfused path too (runner.py:541-559)
    (dict(two_phase="20", iterations=12), ValueError, "phase-1 iterations"),
    (dict(two_phase="bogus"), ValueError, "'auto', 'off' or an integer"),
    (dict(two_phase="5", check_every=2, iterations=12), ValueError,
     "multiple of --check-every"),
    (dict(two_phase="6", normalized_llr=True, schedule="layered",
          iterations=12), ValueError, "--normalized-llr"),
])
def test_unported_or_invalid_configurations_raise(kw, exc, what):
    opts = dict(schedule="flooding", iterations=4, interleaver="random")
    opts.update(kw)
    if exc is None:
        ex = PointExecutor(load_code(f"builtin:{W576}"), _opts(**opts),
                           device="cpu")
        assert not ex.fused and ex.kernel_used == what
        return
    with pytest.raises(exc, match=what):
        PointExecutor(load_code(f"builtin:{W576}"), _opts(**opts), device="cpu")


# the paired layered schedule with a check every 2 iterations (12 of them)
PAIRED = dict(schedule="layered", layer_order="paired", check_every=2,
              iterations=12)


@pytest.mark.parametrize("who,kw,fused,cls,kind", [
    ("executor", dict(PAIRED), True, MCDecoder,
     "cpu+fused+layered+paired+ce2+2phase(auto)"),
    ("executor", dict(PAIRED, two_phase="6"), True, MCDecoder,
     "cpu+fused+layered+paired+ce2+2phase(6)"),
    ("executor", dict(PAIRED, two_phase="off"), True, MCDecoder,
     "cpu+fused+layered+paired+ce2"),
    ("executor", dict(schedule="flooding", iterations=12), True, MCDecoder,
     "cpu+fused+2phase(auto)"),
    ("executor", dict(schedule="layered", decoder="minsum", msg_store="int8",
                      two_phase="off"), True, MCDecoder, "cpu+fused+layered"),
    ("executor", dict(schedule="layered", interleaver="random"), False,
     QCDecoder, "cpu+layered"),
    ("executor", dict(schedule="flooding", kernel="pallas",
                      interleaver="regular"), False, QCDecoder, "cpu"),
    ("executor", dict(schedule="layered", kernel="xla"), False,
     QCLayeredDecoder, "torch+layered"),
    ("executor", dict(fidelity="reference"), False, FloodingDecoder, "torch"),
    ("executor", dict(decoder="bitflipping"), False, BitflipDecoder, "torch"),
    ("importance", dict(PAIRED, two_phase="off"), False, QCDecoder,
     "cpu+layered+paired+ce2"),
])
def test_route_table(who, kw, fused, cls, kind):
    """Each route of the port: whether the fused path runs, the decoder
    class that runs the batch and ``kernel_used``, for the executor and
    for importance sampling's step (always the unfused route's)."""
    code = load_code(f"builtin:{W576}")
    opts = _opts(**{"iterations": 4, **kw})
    if who == "importance":
        shifts = tis.orbit_supports([[0]], code.qc.Z, code.n)
        _, used = tis.make_is_step(code, opts, shifts, device="cpu")
        route = choose_route(code, dataclasses.replace(opts.resolved(),
                                                       fused="off"),
                             torch.device("cpu"), opts.iterations,
                             opts.modulation, opts.interleaver)
        assert route.fused == fused and used == route.kernel == kind
        info = np.arange(code.k)
        assert type(route.unfused_decoder(info, opts.iterations)) is cls
        return
    ex = PointExecutor(code, opts, device="cpu")
    assert ex.fused == ex.route.fused == fused and ex.kernel_used == kind
    assert type(ex._mc_full if fused else ex._decoder) is cls
    assert ex.route.decoder == {QCLayeredDecoder: "layered",
                                FloodingDecoder: "flooding",
                                BitflipDecoder: "flooding"}.get(cls, "qc")


# one fault each, in the order the executor checks them (and a value that
# breaks each rule on wimax 576 at 12 iterations)
FAULTS = {
    "qam_legacy": dict(modulation=16, noise_model="legacy"),
    "decoder_options": dict(minsum_alpha=(0.7, 0.8), decoder="minsum"),
    "shorten_range": dict(shorten=288),
    "two_phase": dict(two_phase="20"),
    "fused_on": dict(fused="on", interleaver="random"),
    "decoder": dict(msg_store="int8", decoder="minsum", kernel="xla"),
}


def _refusal(make, opts_cls, kw) -> str:
    with pytest.raises(ValueError) as e:
        make(opts_cls(**dict(matrix=f"builtin:{W576}", fidelity="exact",
                             batch=64, iterations=12, seed=1, quiet=True,
                             **kw)))
    return str(e.value)


@pytest.mark.parametrize("first,second", [
    (a, b) for i, a in enumerate(FAULTS) for b in list(FAULTS)[i + 1:]])
def test_refusal_order(first, second):
    """A configuration with two faults gets the refusal of the one checked
    first, in the JAX package's words for that fault alone (its
    ``fused='on'`` text without the port's list of what is missing)."""
    code = load_code(f"builtin:{W576}")
    port = _refusal(lambda o: PointExecutor(code, o, device="cpu"),
                    SimOptions, {**FAULTS[first], **FAULTS[second]})
    jcode = jrunner.load_code(f"builtin:{W576}")
    jax = _refusal(lambda o: jrunner.PointExecutor(jcode, o), JOptions,
                   FAULTS[first])
    if first == "fused_on":
        assert jax == FUSED_ON_TEXT and port.startswith(FUSED_ON_TEXT)
    else:
        assert port == jax


def _fake_decode(B, k):
    """Per-frame decode outputs with errors in failed and converged frames,
    as the fused kernels return them and as a DecodeResult that gives the
    same errors against all-zero info bits."""
    rng = np.random.default_rng(5)
    err = torch.from_numpy(rng.integers(0, k, B).astype(np.int32))
    ok = torch.from_numpy(rng.random(B) < 0.5)
    conv = torch.where(ok, 3, -1).to(torch.int32)
    norm = torch.from_numpy(rng.random(B).astype(np.float32))
    est = (torch.arange(k)[None, :] < err[:, None]).to(torch.uint8)
    res = DecodeResult(ok=ok, est=est, conv_iter=conv, norm_llr=norm,
                       iters_run=torch.tensor(12, dtype=torch.int32))
    return (err, ok, conv, norm, torch.full((B,), 12, dtype=torch.int32)), res


@pytest.mark.parametrize("exact_ber", [False, True])
def test_failed_frames_rule_is_one(monkeypatch, exact_ber):
    """The BER rule (errors of failed frames only, every frame's under
    ``exact_ber``) reads the same on the fused step and in
    ``block_stats``."""
    code = load_code(f"builtin:{W576}")
    ex = PointExecutor(code, _opts(schedule="layered", iterations=4,
                                   exact_ber=exact_ber), device="cpu")
    assert ex.fused
    outs, res = _fake_decode(B, code.k)
    monkeypatch.setattr(ex, "_decode", lambda *a, **kw: outs)
    fused, _ = ex.step(0, ex.consts(1.0))
    unfused = tmetrics.block_stats(torch.zeros(B, code.k, dtype=torch.uint8),
                                   res, torch.arange(code.k), exact=exact_ber)
    err, ok = outs[:2]
    want = err if exact_ber else torch.where(ok, 0, err)
    assert torch.equal(fused.error_bits, want)
    assert torch.equal(unfused.error_bits, want)
    assert bool((want[ok] > 0).any()) == exact_ber


@pytest.mark.parametrize("kw", [
    dict(schedule="layered", normalized_llr=True, two_phase="off"),
    dict(schedule="layered", interleaver="random", normalized_llr=True),
])
def test_counter_layout_round_trip(tmp_path, kw):
    """The totals ``run_point`` gathers over a few batches (a partial last
    one included) equal the sum of ``unpack_counters`` of each batch's
    ``packed``, field by field, ``total_iters_run`` too; the parallel
    checkpoint keeps ``PointStats`` in ``BlockCounters``' order."""
    ex = PointExecutor(load_code(f"builtin:{W576}"), _opts(iterations=6, **kw),
                       device="cpu")
    packs = []
    real = ex.packed

    def packed(stats, iters, take):
        packs.append(real(stats, iters, take))
        return packs[-1]

    ex.packed = packed
    st = ex.run_point(1.5, 3 * B + 10)
    assert len(packs) == 4 and st.blocks == 3 * B + 10
    want = {f: 0 for f in tmetrics.BlockCounters._fields}
    iters = 0
    for p in packs:
        c, it = tmetrics.unpack_counters(p)
        iters += it
        for f, x in c._asdict().items():
            want[f] += float(x) if f == "norm_llr_sum" else int(x)
    assert dataclasses.asdict(st) == want and ex.total_iters_run == iters
    # BlockCounters' own sum (the studies') gives the same counts
    summed = functools.reduce(operator.add, (tmetrics.unpack_counters(p)[0]
                                             for p in packs))
    assert {f: int(x) for f, x in summed._asdict().items()
            if f != "norm_llr_sum"} == {f: x for f, x in want.items()
                                        if f != "norm_llr_sum"}
    assert 0 < st.ok_blocks < st.blocks and st.norm_llr_sum > 0
    assert [f.name for f in dataclasses.fields(PointStats)] == list(
        tmetrics.BlockCounters._fields)
    path = str(tmp_path / "ckpt.json")
    trunner._parallel_ckpt_save(path, ["fp"], 4, 0, [st], iters, B)
    row = json.loads(open(path).read())["counters"][0]
    assert row == [st.blocks, st.ok_blocks, st.error_bits, st.fer_frames,
                   st.norm_llr_sum, st.conv_iters_sum, st.conv_count]
    back = trunner._parallel_ckpt_load(path, ["fp"], 1, print, B)
    assert back == (4, 0, iters, [st])


def test_non_qc_code_and_profile_raise(tmp_path):
    """Both raised until the plain decoders and the profiler trace were
    ported: a non-QC code now decodes on the flooding decoder, and
    ``profile`` writes a torch.profiler trace of the sweep."""
    a = gallager_regular(48, 3, 6, seed=11)
    code = code_from_numpy(a.n, a.m, a.row_idx, a.col_idx, "gallager48")
    assert code.qc is None
    ex = PointExecutor(code, _opts(iterations=4), device="cpu")
    assert ex.kernel_used == "torch"
    trace = tmp_path / "trace"
    run_simulation(_opts(profile=str(trace), blocks=B, iterations=2,
                         initial_snr=3.0, end_snr=3.0), device="cpu")
    assert any(f.endswith(".json") for f in os.listdir(trace))


def test_snr_steps_match_reference():
    for grid in ((0.0, 5.0, 0.5), (1.0, 2.0, 0.3), (2.5, 2.5, 1.0),
                 (0.1, 0.7, 0.2), (-1.0, 3.0, 1.5)):
        assert snr_steps(*grid) == jrunner.snr_steps(*grid)
    with pytest.raises(ValueError):
        snr_steps(1.0, 0.0, 0.5)


def _sweep_opts(tmp_path, **kw):
    opts = dict(schedule="flooding", decoder="normalized-minsum",
                iterations=8, blocks=B + 64, ber=True, fer=True,
                initial_snr=0.5, end_snr=1.5, step_snr=0.5,
                checkpoint=str(tmp_path / "ckpt.json"))
    opts.update(kw)
    return _opts(**opts)


def _points(result):
    return [(p.snr_db, p.ber, p.fer, p.total_blocks, p.successful_blocks,
             p.avg_convergence_iterations) for p in result.snr_points]


def test_sweep_resumed_after_one_point_equals_one_run(tmp_path, monkeypatch):
    whole = run_simulation(_sweep_opts(tmp_path,
                                       output_json=str(tmp_path / "r.json"),
                                       output_csv=str(tmp_path / "r.csv")),
                           device="cpu")
    assert len(whole.snr_points) == 3
    assert whole.config.device == "cpu:x1"

    cut_dir = tmp_path / "cut"
    cut_dir.mkdir()
    real = PointExecutor.run_point

    def run_point(self, snr_db, *a, **kw):
        if snr_db > 0.5:
            raise KeyboardInterrupt  # the sweep dies after its first point
        return real(self, snr_db, *a, **kw)

    monkeypatch.setattr(PointExecutor, "run_point", run_point)
    with pytest.raises(KeyboardInterrupt):
        run_simulation(_sweep_opts(cut_dir), device="cpu")
    monkeypatch.setattr(PointExecutor, "run_point", real)
    saved = SimulationResult.from_json(str(cut_dir / "ckpt.json"))
    assert len(saved.snr_points) == 1
    resumed = run_simulation(_sweep_opts(cut_dir, resume=True), device="cpu")
    assert _points(resumed) == _points(whole)
    # a checkpoint of another sweep is not resumed
    other = run_simulation(_sweep_opts(cut_dir, resume=True, seed=2,
                                       end_snr=0.5), device="cpu")
    assert len(other.snr_points) == 1

    # the files round-trip, with the JAX package's keys and columns
    back = SimulationResult.from_json(str(tmp_path / "r.json"))
    assert _points(back) == _points(whole) and back.config == whole.config
    jres = jresults.SimulationResult(
        config=jresults.SimulationConfig(**{
            f: getattr(whole.config, f)
            for f in jresults.SimulationConfig.__dataclass_fields__}),
        snr_points=[jresults.SNRPointResult(**vars(p))
                    for p in whole.snr_points],
        wall_clock_seconds=whole.wall_clock_seconds)
    jres.to_json(str(tmp_path / "j.json"))
    jres.to_csv(str(tmp_path / "j.csv"))
    mine = json.loads((tmp_path / "r.json").read_text())
    theirs = json.loads((tmp_path / "j.json").read_text())
    assert mine.keys() == theirs.keys()
    assert mine["config"].keys() == theirs["config"].keys()
    assert mine["snr_points"][0].keys() == theirs["snr_points"][0].keys()
    with open(tmp_path / "r.csv") as f, open(tmp_path / "j.csv") as g:
        rows, jrows = list(csv.reader(f)), list(csv.reader(g))
    assert rows == jrows and len(rows) == 4


def test_unfused_point_in_pieces_equals_one_run():
    ex = PointExecutor(load_code(f"builtin:{W576}"),
                       _opts(schedule="layered", interleaver="random",
                             modulation=16, mode=2, p=0.15,
                             interference_snr=-3.0, iterations=6),
                       device="cpu")
    whole = ex.run_point(5.0, 2 * B)
    a = ex.run_point(5.0, B)
    b = ex.run_point(5.0, B, start_batch=1)
    for f in ("blocks", "ok_blocks", "error_bits", "fer_frames",
              "conv_iters_sum", "conv_count"):
        assert getattr(a, f) + getattr(b, f) == getattr(whole, f), f
    assert ex.run_point(5.0, 2 * B) == whole  # same seed, same counters


def test_burst_config_fer_is_sane_across_the_waterfall():
    """16-QAM, mode-2 jamming (p 0.15, jammer 3 dB above the signal),
    random interleaver, layered SPA-12 at wimax 576 (the burst-interleaver
    study's configuration)."""
    ex = PointExecutor(load_code(f"builtin:{W576}"),
                       _opts(schedule="layered", interleaver="random",
                             modulation=16, mode=2, p=0.15,
                             interference_snr=-3.0, iterations=12),
                       device="cpu")
    assert ex.kernel_used == "cpu+layered"
    high = ex.run_point(7.0, B)
    low = ex.run_point(3.0, B)
    assert high.fer_frames / high.blocks < 0.2
    assert low.fer_frames / low.blocks > 0.5
    assert trunner.derive_key(1, 0) != trunner.derive_key(1, 1)
