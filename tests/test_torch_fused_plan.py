"""The decode kernels' block plan and gather table (K1, K2, K3), on the CPU.

The kernels themselves run only on the card (``chip_smoke.py``); here the
Python that shapes their launch meets what the plain decode loop does: the
precomputed gather offsets against ``DecodeLoop``'s gather indices, the
plan's threads, padding, shared warps and shared memory under the layered
and the flooding schedule, the plain loop at the plan's codewords per block
(and at the JAX package's tiles) against the JAX package's layered decoder,
the two-phase trip model at the plan's block, the entry points' argument
lists, and the parsers of the chip scripts."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu.models.qc import paired_layer_groups as jpaired
from ldpc_tpu.ops.layered import make_qc_layered_decoder
from ldpc_tpu_torch.models.qc import paired_layer_groups
from ldpc_tpu_torch.ops import mc_kernels as mk
from ldpc_tpu_torch.ops.build import kernel_label, ptxas_report
from ldpc_tpu_torch.ops.decode_loop import DecodeLoop, block_max_trips, build_tables
from ldpc_tpu_torch.ops.qc_kernels import QC_KERNEL, QCDecoder
from ldpc_tpu_torch.sim.runner import load_code, two_phase_trip_model

torch.set_num_threads(1)

W1152 = "builtin:wimax_1152_0.5.alist.txt"
CCSDS = "builtin:CCSDS_ldpc_n32_k16.alist.txt"
DEG15 = "builtin:wimax_1152_0.75A.alist.txt"  # the 16 instantiation
DEG22 = "builtin:wifi_648_r083.alist.txt"  # the 32 instantiation
DEG20 = "builtin:wimax_1152_0.83.alist.txt"  # row degree 20: the 32 one
BIG4608 = "examples/big_code/wimax_like_n4608_z192.alist.txt"
BIG9216 = "examples/big_code/wimax_like_n9216_z384.alist.txt"


def _tables(name, paired):
    if not name.startswith("builtin:"):
        import os
        name = os.path.join(os.path.dirname(__file__), "..", name)
    code = load_code(name)
    return build_tables(code.qc, paired_layer_groups(code.qc) if paired else None)


# --------------------------------------------------------- gather table ----

@pytest.mark.parametrize("name,paired", [(W1152, True), (W1152, False),
                                         (CCSDS, False), (DEG15, False),
                                         (DEG22, False)])
def test_gather_offsets_equal_the_decode_loops_indices(name, paired):
    """For every (layer group, row in group, slot, z): the table's offset is
    the L row the plain loop gathers (and scatters back) for that edge."""
    t = _tables(name, paired)
    Z = t.qc.Z
    goff = mk.gather_offsets(t)
    assert goff.dtype == np.uint16 and goff.shape == (t.e_slots, Z)
    loop = DecodeLoop(t, 2, "minsum")
    seen = 0
    for rows in t.groups:
        for bi in rows:
            lo, hi, _, idx = loop._rows[bi]
            idx = idx.numpy().reshape(hi - lo, Z)
            for j in range(hi - lo):
                np.testing.assert_array_equal(goff[lo + j], idx[j])
                seen += 1
    assert seen == t.e_slots
    if t.has_dup:  # a multi-diagonal row reads one column at two shifts
        assert len(set(goff[:, 0] // Z)) < t.e_slots


@pytest.mark.parametrize("name,paired,flood", [(W1152, True, False),
                                               (CCSDS, False, False),
                                               (DEG22, False, False),
                                               (W1152, False, True)])
def test_kernel_table_packs_the_gathers(name, paired, flood):
    """The schedule tables, the gather offsets two to an int, the info
    mask: in that order, at the lengths the kernels stage."""
    t = _tables(name, paired)
    qc = t.qc
    info = np.arange(0, qc.n, 3)
    tab = mk.kernel_table(t, info, flood)
    head = mk.table_len(t, flood)
    words = mk.gather_words(t)
    assert tab.dtype == np.int32 and tab.size == head + words + qc.n
    np.testing.assert_array_equal(tab[:qc.mb + 1], t.row_off)
    if flood:  # the column tables close the head
        col_off, col_slot, col_shift = t.column_slots()
        np.testing.assert_array_equal(
            tab[head - col_off.size - 2 * t.e_slots:head],
            np.concatenate([col_off, col_slot, col_shift]))
    packed = tab[head:head + words].view("<u2")[: t.e_slots * qc.Z]
    np.testing.assert_array_equal(packed, mk.gather_offsets(t).ravel())
    mask = np.zeros(qc.n, np.int32)
    mask[info] = 1
    np.testing.assert_array_equal(tab[head + words:], mask)


# ----------------------------------------------------------- block plan ----

# (code, schedule) -> (codewords per block, rows per step, threads, padding
# threads, L stride, shared memory bytes)
PLANS = [
    # the bench code: 2 x 48 threads per codeword, whole warps
    (W1152, "paired", (1, 2, 96, 0, 1152, 27276)),
    # serial: 48 threads padded to 64 (a quarter of the lanes idle)
    (W1152, "serial", (1, 1, 64, 16, 1152, 27300)),
    # flooding: 2 check rows per step; the column tables, no channel LLRs
    (W1152, "flooding", (1, 2, 96, 0, 1152, 27912)),
    # Z = 4: codewords share one warp (8 serial, 4 at flooding's 2 rows)
    (CCSDS, "serial", (8, 1, 32, 0, 36, 6852)),
    (CCSDS, "flooding", (4, 2, 32, 0, 40, 3528)),
    # Z = 27: one codeword per warp, 5 padding threads (10 flooding)
    (DEG22, "serial", (1, 1, 32, 5, 648, 17620)),
    (DEG22, "flooding", (1, 2, 64, 10, 648, 18392)),
    # row degree 20, the 32 instantiation: no disjoint pairs, so serial
    (DEG20, "paired", (1, 1, 64, 16, 1152, 28356)),
    (DEG20, "flooding", (1, 2, 96, 0, 1152, 29064)),
    # Z = 192 and 384: one codeword of 384 and 768 threads
    (BIG4608, "paired", (1, 2, 384, 0, 4608, 106764)),
    (BIG4608, "flooding", (1, 2, 384, 0, 4608, 107400)),
    (BIG9216, "paired", (1, 2, 768, 0, 9216, 212748)),
    (BIG9216, "flooding", (1, 2, 768, 0, 9216, 213384)),
]


@pytest.mark.parametrize("name,schedule,want", PLANS)
def test_fused_plan(name, schedule, want):
    flood = schedule == "flooding"
    t = _tables(name, schedule == "paired")
    p = mk.fused_plan(t, flood)
    assert (p.lanes, p.rows, p.threads, p.padding_threads, p.l_stride,
            p.smem) == want
    assert p.flood == flood and p.threads <= mk.MAX_THREADS
    assert p.threads % 32 == 0 and p.lanes * p.row_threads <= p.threads
    assert p.rows == (2 if flood else t.R)
    # codewords share a warp only where one codeword's step does not fill it
    assert p.lanes == 1 or p.threads == 32
    # the lanes of a lane-fastest warp start in distinct banks
    if p.lanes > 1:
        assert (p.l_stride * p.lanes) % 32 == 0 and p.l_stride % 32 == 32 // p.lanes
    # L, E (and the multi-diagonal deltas, layered only) per codeword, then
    # the tables and the gather offsets
    qc = t.qc
    per = p.l_stride + t.e_slots * qc.Z + (
        t.R * mk.kernel_dmax(t) * qc.Z if t.has_dup and not flood else 0)
    assert p.smem == 4 * (p.lanes * per + mk.table_len(t, flood)
                          + mk.gather_words(t))
    assert p.smem <= mk._SMEM_LIMIT


def test_fused_plan_limits(monkeypatch):
    """A code that fits no block raises with its threads and bytes."""
    t = _tables(BIG9216, False)
    need = mk.fused_plan(t, flood=True).smem
    monkeypatch.setattr(mk, "_SMEM_LIMIT", need - 1)
    with pytest.raises(ValueError, match=rf"768 threads .* {need} bytes"):
        mk.fused_plan(t, flood=True)
    # the block past the limits, as the big-code study's plan reports it
    over = mk.block_layout(t, flood=True)
    assert over.smem == need and not mk.plan_fits(over)
    # the entry points take the plan as it is: cpg, tpg, Ls, smem
    p = mk.fused_plan(_tables(W1152, True))
    assert p.launch_args() == [1, 96, 1152, p.smem]


def _c_params(symbol: str) -> list[str]:
    """The parameter list of an ``extern "C"`` entry point of the decode
    kernels' sources (``csrc/{mc,llr,qc}_decoder.cu``)."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(mk.__file__), "..", "csrc")
    for name in ("mc_decoder", "llr_decoder", "qc_decoder"):
        src = open(os.path.join(csrc, name + ".cu"), encoding="utf-8").read()
        m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
        if m:
            return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]
    raise AssertionError(f"no entry point {symbol}")


@pytest.mark.parametrize("kernel", [mk.MC_KERNEL, mk.LLR_KERNEL, QC_KERNEL],
                         ids=lambda k: k.symbol)
def test_entry_points_take_the_plan(kernel):
    """The wrappers' argument types match the C prototypes, the three
    entry points share the decode-loop arguments, and those end with the
    plan (the C side validates it, computing nothing of its own)."""
    params = _c_params(kernel.symbol)
    assert len(params) == len(kernel.argtypes)
    at = params.index("tab")
    assert kernel.argtypes[at:at + len(mk.LOOP_ARGS)] == mk.LOOP_ARGS
    end = params.index("has_dup") + 1
    assert params[end:end + 4] == ["cpg", "tpg", "Ls", "smem"]
    assert end + 4 - at == len(mk.LOOP_ARGS)
    code = load_code(W1152)
    info = code.standard_encode_spec.info_pos("orig")
    dec = mk.LLRDecoder(code.qc, info, 12, "spa",
                        layer_groups=paired_layer_groups(code.qc),
                        check_every=2)
    args = dec._loop_args(torch.device("cpu"), 4096)
    assert len(args) == len(mk.LOOP_ARGS)
    assert args[-4:] == dec.plan.launch_args() == [1, 96, 1152, dec.plan.smem]
    flood = QCDecoder(code.qc, info, 16, "spa")
    qargs = mk.loop_args(flood.tables, flood.plan, torch.zeros(1), 4096, 16,
                         1, "spa", 0.75, 0.15)
    # flooding: no layer groups, 2 rows per step, no multi-diagonal deltas
    loop = params[at:at + len(mk.LOOP_ARGS)]
    assert qargs[6:8] == [0, 2] and qargs[loop.index("has_dup")] == 0
    assert qargs[loop.index("flood")] == 1 and qargs[loop.index("atab")] is None
    assert qargs[-4:] == [1, 96, 1152, flood.plan.smem]


def test_decoders_take_the_plan():
    code = load_code(W1152)
    info = code.standard_encode_spec.info_pos("orig")
    groups = paired_layer_groups(code.qc)
    mc = mk.MCDecoder(code.qc, info, 12, "spa", layer_groups=groups,
                      check_every=2)
    k2 = mk.LLRDecoder(code.qc, info, 12, "spa", layer_groups=groups,
                       check_every=2)
    assert mc.lanes == k2.lanes == 1 and mc.plan == k2.plan
    assert mc.plan.threads == 96
    serial = QCDecoder(code.qc, info, 12, "spa", schedule="layered")
    flood = QCDecoder(code.qc, info, 16, "spa")
    assert (serial.plan.threads, serial.plan.rows) == (64, 1)
    assert (flood.plan.threads, flood.plan.rows, flood.lanes) == (96, 2, 1)
    with pytest.raises(TypeError):
        mk.MCDecoder(code.qc, info, 12, "spa", lanes=4)


# ---------------------------------------- plain loop at the plan's lanes ----

NAME576 = "wimax_576_0.5.alist.txt"
B = 96


@pytest.fixture(scope="module")
def channel():
    code = JCode(alist=jstd.make_builtin(NAME576), name=NAME576)
    rng = np.random.default_rng(11)
    u = rng.integers(0, 2, (B, code.k), dtype=np.uint8)
    w = code.standard_encode_spec.encode_numpy(u, "orig").astype(np.float32)
    sigma = 1.0 / np.sqrt(2 * 0.5 * 10 ** 0.15)
    y = (2 * w - 1) + sigma * rng.standard_normal(w.shape)
    return code, (2 * y / sigma**2).astype(np.float32)


@pytest.mark.parametrize("variant", ["normalized_minsum", "minsum"])
@pytest.mark.parametrize("lanes", [None, 2, 8])
def test_plain_loop_at_the_plans_lanes(channel, variant, lanes):
    """The plain loop at the plan's codewords per block (None), and at the
    JAX package's tiles of 2 and 8, gives the JAX layered decoder's est /
    ok / conv for every frame, and each frame's ``iters`` is the largest
    trip count in its block."""
    code, llr = channel
    jgroups = jpaired(code.qc)
    ref = make_qc_layered_decoder(
        code.qc, code.standard_encode_spec.info_pos("orig"), 8, variant,
        layer_order=[bi for g in jgroups for bi in g])(jnp.asarray(llr))
    tcode = load_code(f"builtin:{NAME576}")
    t = build_tables(tcode.qc, paired_layer_groups(tcode.qc))
    lanes = mk.fused_plan(t).lanes if lanes is None else lanes
    loop = DecodeLoop(t, 8, variant, lanes=lanes)
    L = torch.from_numpy(-llr.T.copy())
    done, conv, iters = loop.run(L, torch.zeros(B, dtype=torch.bool))
    np.testing.assert_array_equal(done.numpy(), np.asarray(ref.ok))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(ref.conv_iter))
    np.testing.assert_array_equal((L < 0).numpy().T.astype(np.uint8),
                                  np.asarray(ref.est))
    want = block_max_trips(done, conv, lanes, 8)
    np.testing.assert_array_equal(iters.numpy(), want.numpy())
    assert 0 < done.sum() < B


def test_block_max_trips_with_pre_done_lanes():
    ok = torch.tensor([True, False, True, True, True])
    conv = torch.tensor([1, -1, 3, 5, 1])
    assert block_max_trips(ok, conv, 2, 12).tolist() == [12, 12, 6, 6, 2]
    live = torch.tensor([True, False, False, True, False])
    assert block_max_trips(ok, conv, 2, 12, live).tolist() == [2, 2, 6, 6, 0]


# ------------------------------------------------- trip model, per phase ----

def test_trip_model_phase2_blocks():
    """At the default plan's one codeword per block, K1 and K2 both group
    lanes one at a time: a block's trips are its frame's, and phase 2 costs
    the refed frames' own trips."""
    rng = np.random.default_rng(3)
    ok = rng.random(64) < 0.8
    conv = np.where(ok, rng.integers(0, 12, 64), -1)
    trips = np.where(ok, conv + 1, 12)
    refeed = trips[trips > 6]
    solo = two_phase_trip_model(conv, ok, 6, 12, lanes=1)
    assert solo["single"] == pytest.approx(trips.mean())
    assert solo["phase1_mean"] == pytest.approx(np.minimum(trips, 6).mean())
    assert solo["phase2_per_tile"] == pytest.approx(refeed.sum() / 64)
    assert solo["refeed_frac"] == solo["refeed_tile_frac"] == refeed.size / 64
    # eight to a block: every block runs its slowest frame's trips
    eight = two_phase_trip_model(conv, ok, 6, 12, lanes=8)
    assert eight["single"] == pytest.approx(trips.reshape(8, 8).max(1).mean())
    assert eight["single"] >= solo["single"]


# ------------------------------------------------------- chip-script parsers ----

PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__d0a32c3_13_mc_decoder_cu_c888c8e017mc_decoder_kernelILi8ELi768ELi1ELb1EEEvNS_4LoopEPKiPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__d0a32c3_13_mc_decoder_cu_c888c8e017mc_decoder_kernelILi8ELi768ELi1ELb1EEEvNS_4LoopEPKiPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 2 barriers, 160 bytes smem
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__d0a32c3_13_mc_decoder_cu_c888c8e017qc_decoder_kernelILi32ELb1EEEvNS_4Loop' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__d0a32c3_13_mc_decoder_cu_c888c8e017qc_decoder_kernelILi32ELb1EEEvNS_4Loop
    1544 bytes stack frame, 3640 bytes spill stores, 4764 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 1544 bytes cumulative stack size
"""


def test_ptxas_report():
    rep = ptxas_report(PTXAS)
    assert rep == {
        "mc_decoder_kernel<8,768,1,1>": {"registers": 72, "barriers": 2, "stack": 0,
                                       "spill_stores": 0, "spill_loads": 0},
        "qc_decoder_kernel<32,1>": {"registers": 32, "barriers": 1, "stack": 1544,
                                    "spill_stores": 3640, "spill_loads": 4764},
    }
    assert kernel_label("rate_chain_fma") == "rate_chain_fma"
