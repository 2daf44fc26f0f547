"""The roofline path of the port against the JAX package's, on the same
inputs.

* The census (``decode_census`` / ``channel_census`` / ``counter_census`` /
  ``init_census``) is exactly equal to the JAX package's at
  ``sublane_groups=1``, over codes (single- and multi-diagonal, row degree
  up to 22), variants, schedules, the flip metric, syndrome cadences and
  channel modes.
* The pricing (``_mix_schedule``, ``speed_of_light``,
  ``speed_of_light_two_phase``) is equal given the same rates, peak, HBM
  rate and trip model.
* K4's plain chains (``RateChain.plain``) against ``_rate_kernel`` run in
  Pallas interpret mode on a random 32 x 128 tile: ``roll`` bit for bit,
  the rest within rtol 1e-6 / atol 1e-6 (each chain converges on an
  attracting fixed point, so last-ulp differences of tanh / log / cos
  between the two libraries do not grow). Interpret mode's TPU PRNG gives
  constant words, so the prng chain is held against Philox4x32-10 words
  instead.
* K5's plain version against the K4 bodies composed in schedule order.
* The slice: ``measure_tile_trips`` on the CPU, and the report writer's
  keys against ``examples/roofline/roofline.json``.
"""

from __future__ import annotations

import json
import os
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ldpc_tpu.analysis import roofline as jroof
from ldpc_tpu.sim.runner import load_code as jload_code
from ldpc_tpu_torch.analysis import roofline as troof
from ldpc_tpu_torch.ops import build
from ldpc_tpu_torch.ops.mc_kernels import philox4x32
from ldpc_tpu_torch.ops.rate_kernels import (
    OPS,
    PRNG_KEY,
    MixChain,
    RateChain,
    body,
    hot_loops,
    loop_instructions,
    mix_defines,
    opcode,
    pipe_bound,
    pipe_counts,
    thread_index,
)
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import load_code as tload_code

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "roofline")
CODES = ("builtin:wimax_576_0.5.alist.txt", "builtin:wimax_1152_0.5.alist.txt",
         "builtin:CCSDS_ldpc_n32_k16.alist.txt",
         "builtin:wifi_648_r083.alist.txt")  # row degree 22
VARIANTS = ("spa", "minsum", "normalized_minsum", "offset_minsum")
H100 = dict(device_name="NVIDIA H100 80GB HBM3", sm_count=132,
            max_sm_clock_mhz=1980)


def _qcs(name):
    return jload_code(name).qc, tload_code(name).qc


# ------------------------------------------------------------- census ----

def test_census_codes_cover_what_they_claim():
    jqc, tqc = _qcs(CODES[3])
    assert max(len(r) for r in tqc.row_slots()) >= 20
    assert not _qcs(CODES[2])[1].single_diagonal  # CCSDS: multi-diagonal
    assert jqc.edges == tqc.edges


@pytest.mark.parametrize("check_every", (1, 2, 3))
@pytest.mark.parametrize("track_norm", (False, True))
@pytest.mark.parametrize("schedule", ("layered", "flooding"))
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", CODES)
def test_decode_census_equals_jax(name, variant, schedule, track_norm,
                                  check_every):
    jqc, tqc = _qcs(name)
    ref = jroof.decode_census(jqc, variant, schedule, track_norm,
                              check_every=check_every, sublane_groups=1)
    got = troof.decode_census(tqc, variant, schedule, track_norm,
                              check_every=check_every)
    assert got.counts == ref.counts


@pytest.mark.parametrize("mode", (1, 2, 3))
@pytest.mark.parametrize("name", CODES)
def test_channel_counter_init_census_equal_jax(name, mode):
    jqc, tqc = _qcs(name)
    assert (troof.channel_census(tqc, mode).counts
            == jroof.channel_census(jqc, mode).counts)
    assert troof.counter_census(tqc).counts == jroof.counter_census(jqc).counts
    assert troof.init_census(tqc).counts == jroof.init_census(jqc).counts


# ------------------------------------------------------------ pricing ----

def _mixes():
    with open(os.path.join(EXAMPLES, "attainable.json")) as f:
        frame = json.load(f)["frame_mix"]
    with open(os.path.join(EXAMPLES, "roofline.json")) as f:
        per_iter = json.load(f)["per_iter_ops"]
    rng = np.random.default_rng(3)
    rand = {c: float(v) for c, v in zip(troof.CLASSES, rng.random(9) * 1e5)}
    return [frame, per_iter, rand, {"fma": 1.0, "tanh": 1.0}]


@pytest.mark.parametrize("length", (64, 32, 100))
@pytest.mark.parametrize("which", range(4))
def test_mix_schedule_equals_jax(which, length):
    mix = _mixes()[which]
    sched = troof._mix_schedule(mix, length)
    assert sched == jroof._mix_schedule(mix, length)
    assert len(sched) == length


def _rename(d: dict) -> dict:
    return {troof.RENAMED_KEYS.get(k, k.replace("vpu_peak", "issue_peak")): v
            for k, v in d.items()}


MODEL = {"single": 7.25, "phase1_mean": 5.5, "phase2_per_tile": 0.75,
         "refeed_frac": 0.02, "refeed_tile_frac": 0.09}


@pytest.mark.parametrize("name", CODES[:3])
def test_speed_of_light_equals_jax(name):
    jqc, tqc = _qcs(name)
    rates = {c: 1e11 * (i + 1) for i, c in enumerate(troof.CLASSES)}
    peak = troof.issue_peak_ops_per_s(**H100)
    kw = dict(k=jqc.n // 2, variant="spa", schedule="layered", mode=1,
              track_norm=False, peak_ops_per_s=peak, check_every=2)
    ref = jroof.speed_of_light(jqc, rates, mean_tile_iters=7.25, **kw)
    got = troof.speed_of_light(tqc, rates, mean_tile_iters=7.25, **kw)
    assert got == _rename(ref)
    ref2 = jroof.speed_of_light_two_phase(
        jqc, rates, phase1=6, trip_model=MODEL,
        hbm_bytes_per_s=troof.HBM_BYTES_PER_S, **kw)
    got2 = troof.speed_of_light_two_phase(tqc, rates, phase1=6,
                                          trip_model=MODEL, **kw)
    assert got2 == _rename(ref2)
    assert got2["hbm_bytes_per_s"] == 3.35e12


def test_issue_peak():
    assert troof.issue_peak_ops_per_s(**H100) == 132 * 128 * 1.98e9
    with pytest.raises(ValueError, match="no issue-peak model"):
        troof.issue_peak_ops_per_s("Tesla T4", 40, 1590)


# ----------------------------------------------------------- K4 plain ----

def _tile(rows=32, cols=128, seed=0):
    return np.random.default_rng(seed).random((rows, cols)).astype(np.float32)


def _jax_chain(op, depth, x):
    with pltpu.force_tpu_interpret_mode():
        fn, _ = jroof._rate_kernel(op, depth, x.shape, unroll=16)
        return np.asarray(fn(jnp.asarray(x)))


@pytest.mark.parametrize("op,depth", [(op, 32) for op in OPS if op != "prng"]
                         + [("roll", 48)])
def test_rate_chain_plain_matches_interpret_kernel(op, depth):
    x = _tile()
    ref = _jax_chain(op, depth, x)
    got = RateChain(op, depth)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    if op == "roll":
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, np.roll(x, -depth, axis=0))
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_rate_chain_prng_adds_philox_words():
    x = _tile(64, 8, seed=1)
    depth = 32
    g = thread_index(64, 8, "cpu")
    zero = torch.zeros_like(g)
    ref = x.copy()
    for call in range(depth // 4):
        for w in philox4x32(g, zero + call, zero, zero, *PRNG_KEY):
            u = (w.numpy() >> 8).astype(np.int32).astype(np.float32)
            ref = ref + u * np.float32(2.0**-24)
    got = RateChain("prng", depth)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    # every element has its own thread, so its own words
    assert len(np.unique(g.numpy())) == g.numel()


def test_rate_chain_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 16"):
        RateChain("fma", 40)
    with pytest.raises(ValueError, match="unknown op class"):
        RateChain("exp", 16)
    x = torch.zeros((32, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        RateChain("fma", 16)(x)
    with pytest.raises(ValueError, match="no kernel"):
        MixChain(["fma", "tanh"], 2, 2)(x)


# ----------------------------------------------------------- K5 plain ----

@pytest.mark.parametrize("streams", (1, 3, 8))
def test_mix_chain_is_k4_bodies_in_schedule_order(streams):
    sched = troof._mix_schedule(_mixes()[0], 64)
    assert "prng" not in sched and len(set(sched)) == 6
    x = torch.from_numpy(_tile(seed=2))
    depth = 3
    xs = [x * float(np.float32(1.0 + 0.001 * s)) for s in range(streams)]
    for _ in range(depth):
        for i, op in enumerate(sched):
            xs[i % streams] = body(op, xs[i % streams])
    ref = xs[0]
    for v in xs[1:]:
        ref = ref + v
    got = MixChain(sched, streams, depth)(x)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("op", [op for op in OPS if op != "prng"])
def test_mix_chain_of_one_class_is_the_rate_chain(op):
    x = torch.from_numpy(_tile(seed=4))
    got = MixChain([op] * 16, 1, 2)(x)
    assert torch.equal(got, RateChain(op, 32)(x))


def test_mix_defines_pack_the_schedule():
    sched = ["fma", "roll", "where", "tanh", "log", "div", "sqrt",
             "cossin"] * 3
    defs = mix_defines(sched, 4)
    assert not any("," in d for d in defs)  # nvcc splits -D at commas
    kv = dict(d.split("=") for d in defs)
    assert kv["MIX_STREAMS"] == "4" and kv["MIX_LEN"] == str(len(sched))
    words = [int(kv[f"MIX_S{j}"].rstrip("ULL"), 16) for j in range(2)]
    codes = [(words[i // 16] >> (4 * (i % 16))) & 15 for i in range(len(sched))]
    assert [OPS[c] for c in codes] == sched
    with pytest.raises(ValueError, match="prng"):
        mix_defines(["fma", "prng"], 2)
    # each (schedule, streams) is its own library of one source
    paths = {build.library_path(("roofline", mix_defines(sched, s)))
             for s in (1, 2)} | {build.library_path("roofline")}
    assert len(paths) == 3
    assert "roofline" in build.SOURCES


SASS = """
        code for sm_90a
                Function : rate_chain_fma
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   ISETP.GE.AND P0, PT, R2, 0x1, PT ;
        /*0020*/               @!P0 BRA 0x90 ;
        /*0030*/                   FMUL R0, R0, 0.99987792968750000000 ;
        /*0040*/                   FADD R0, R0, 0.0001220703125 ;
        /*0050*/                   IADD3 R2, R2, -0x1, RZ ;
        /*0060*/                   NOP ;
        /*0070*/                   ISETP.NE.AND P0, PT, R2, RZ, PT ;
        /*0080*/                @P0 BRA 0x30 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA 0xa0;
                Function : no_loop
        /*0000*/                   EXIT ;
"""


def test_loop_instructions_reads_the_hot_loop():
    assert loop_instructions(SASS) == {"rate_chain_fma": 5}


def test_pipe_counts_sort_the_hot_loop_by_pipe():
    """The hot loop's opcodes by pipe: FMUL / FADD on the FP32 pipe, IADD3 /
    ISETP on the integer pipe, the branch under control; an opcode of no
    listed pipe lands in ``other``, never dropped."""
    loop = hot_loops(SASS)["rate_chain_fma"]
    assert [opcode(t) for t in loop] == ["FMUL", "FADD", "IADD3", "ISETP", "BRA"]
    c = pipe_counts(loop + ["MUFU.TANH R1, R2", "LDS R1, [R2]",
                            "I2F.S32 R1, R2", "QSPC.E.S P0, RZ, [R2]"])
    assert c == {"fp32": 2, "mufu": 1, "int": 2, "conv": 1, "shared": 1,
                 "control": 1, "other": 1}


def test_pipe_bound_takes_the_larger_of_issue_and_each_pipe():
    peak = 132 * 128 * 1.98e9
    # 2 FP32 + 1 integer: issue (3 at 128 a clock) beats FP32 (2 at 128)
    t, by, terms = pipe_bound({"fp32": 2, "int": 1}, 1e9, peak)
    assert by == "issue" and t == pytest.approx(3e9 / peak)
    assert terms["fp32"] == pytest.approx(2e9 / peak)
    assert terms["int"] == pytest.approx(2e9 / peak)  # 1 at 64 a clock
    # 3 MUFU (16 a clock: 24 issue slots) beat 10 instructions' issue
    t, by, _ = pipe_bound({"fp32": 7, "mufu": 3}, 1e9, peak)
    assert by == "mufu" and t == pytest.approx(24e9 / peak)
    t, by, _ = pipe_bound({"other": 5, "control": 1}, 1e6, peak)
    assert by == "issue" and t == pytest.approx(6e6 / peak)


# ------------------------------------------------------------ the slice ----

def test_measure_tile_trips_on_the_cpu():
    code = tload_code("builtin:wimax_576_0.5.alist.txt")
    opts = SimOptions(matrix=code.name, iterations=8, fidelity="exact",
                      batch=64, speed=0.5, schedule="layered",
                      layer_order="paired", check_every=2, two_phase="auto")
    iters, model = troof.measure_tile_trips(code, opts, 1.5, batches=2,
                                            device="cpu")
    # MCDecoder's block at wimax 576, paired (R x Z = 48): one codeword
    assert model["lanes"] == 1.0
    assert iters == model["single"]
    assert 2.0 <= model["phase1_mean"] <= model["single"] <= 8.0
    assert set(model) >= {"single", "phase1_mean", "phase2_per_tile",
                          "refeed_frac", "refeed_tile_frac"}


@pytest.mark.parametrize("kernel,two_phase", [
    ("cuda+fused+layered+paired+ce2+2phase(auto:off)", False),
    ("cuda+fused+layered+paired+ce2+2phase(auto:6)", True),
    ("cuda+fused+layered+paired+ce2+2phase(6)", True),
])
def test_roofline_report_has_the_jax_keys(kernel, two_phase):
    from ldpc_tpu_torch.bench import matching_ceiling
    from ldpc_tpu_torch.scripts.attainable_ceiling import (
        attainable_report,
        frame_mix,
        k1_launch,
    )
    from ldpc_tpu_torch.scripts.roofline import roofline_report, summary

    code = tload_code("builtin:wimax_1152_0.5.alist.txt")
    opts = SimOptions(matrix=code.name, iterations=12, fidelity="exact",
                      batch=4096, speed=0.5, schedule="layered",
                      layer_order="paired", check_every=2)
    rates = {c: 1e11 * (i + 1) for i, c in enumerate(troof.CLASSES)}
    peak = troof.issue_peak_ops_per_s(**H100)
    report, sol1, sol2 = roofline_report(
        code, opts, snr_db=2.0, rates=rates, tile_iters=7.25,
        trip_model=MODEL, peak=peak, kernel_used=kernel, fer=0.0063,
        bits_per_s=1.88e9, device="NVIDIA H100 80GB HBM3",
        card="NVIDIA H100 80GB HBM3, 700.00 W")
    with open(os.path.join(EXAMPLES, "roofline.json")) as f:
        keys = json.load(f).keys()
    missing = [k for k in keys if troof.RENAMED_KEYS.get(k, k) not in report]
    assert not missing
    assert not [k for k in report if "vpu" in k]
    assert report["two_phase_ceiling"] is two_phase
    sol = sol2 if two_phase else sol1
    assert report["ceiling_info_bits_per_s"] == sol["ceiling_info_bits_per_s"]
    assert report["fraction_of_ceiling"] == 1.88e9 / sol["ceiling_info_bits_per_s"]
    assert report["issue_peak_ops_per_s"] == peak
    # the same numbers as the JAX package's pricing of the same inputs
    jqc = jload_code("builtin:wimax_1152_0.5.alist.txt").qc
    ref = jroof.speed_of_light(jqc, rates, k=code.k, mean_tile_iters=7.25,
                               peak_ops_per_s=peak, check_every=2)
    assert sol1["ceiling_info_bits_per_s"] == ref["ceiling_info_bits_per_s"]
    assert report["measured_floor_gops"]["tanh"] == rates["tanh"] / 1e9
    assert "issue peak" in summary(report)
    # the bench quotes the ceiling only for the dispatch mode it priced
    ceiling, why = matching_ceiling(report, kernel, 2)
    assert ceiling == report["ceiling_info_bits_per_s"] and not why
    other = "cuda+fused+layered+paired+ce2" + (
        "+2phase(auto:off)" if two_phase else "+2phase(auto:6)")
    assert matching_ceiling(report, other, 2)[0] is None
    assert matching_ceiling(report, kernel, 1)[0] is None
    # the attainable script prices the same frame
    mix, total = frame_mix(code, report)
    assert total == sol["frame_ops"] and sum(mix.values()) == pytest.approx(total)
    # K1's plan: one codeword of 2 x 48 threads per block, at the card's
    # count of resident blocks (8 on an H100)
    assert k1_launch(code, report, 132, lambda t, p: 8) == (132 * 8, 2 * 48)
    assert Counter(troof._mix_schedule(mix))["fma"] > 32
    # ... and writes the JAX report's keys, best rung of each launch shape
    rung = {"stabilizer_frac": 0.5, "launch": [1056, 256]}
    ladders = {shape: {str(s): dict(rung, census_ops_per_s=r * s)
                       for s in (1, 2, 4)}
               for shape, r in (("full", 5e12), ("k1", 4e12))}
    att = attainable_report(code, report, ladders, full=(1056, 256),
                            k1=(132, 768), build_s=3.0)
    with open(os.path.join(EXAMPLES, "attainable.json")) as f:
        assert not [k for k in json.load(f) if k not in att]
    assert att["attainable_census_ops_per_s"] == 2e13
    assert att["attainable_info_bits_per_s"] == code.k / (total / 2e13)
    assert att["attainable_k1_launch_info_bits_per_s"] == code.k / (total / 1.6e13)
    assert att["frame_mix"] == mix and att["frame_ops"] == total
    assert att["fraction_of_attainable"] == 1.88e9 / att["attainable_info_bits_per_s"]
