"""Per-sweep alpha schedules of normalized min-sum in the port: its copy of
``resolve_alpha_schedule`` against the JAX package's on every case and
refusal, and the plain versions of K1 (``MCDecoder``), K2 (``LLRDecoder``)
and K3 (``QCDecoder``) with a [T] or a [T, D] schedule against the JAX
package's interpret-mode kernels on the same inputs, bit for bit."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu.ops import channel as jchannel
from ldpc_tpu.ops import encode as jencode
from ldpc_tpu.ops.mc_pallas import (
    consts_vector,
    make_llr_decoder,
    make_mc_decoder,
)
from ldpc_tpu.ops.spa_pallas import make_qc_decoder
from ldpc_tpu.ops.spa_pallas import resolve_alpha_schedule as jresolve
from ldpc_tpu_torch.ops.decode_loop import (
    DecodeLoop,
    build_tables,
    resolve_alpha_schedule,
)
from ldpc_tpu_torch.ops.mc_kernels import DRAWS_PER_BIT, LLRDecoder, MCDecoder
from ldpc_tpu_torch.ops.qc_kernels import QCDecoder
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import PointExecutor, load_code
from ldpc_tpu_torch.utils.carry import code_from_numpy, consts_from_numpy

torch.set_num_threads(1)

W576 = "wimax_576_0.5.alist.txt"  # row degrees 6 and 7: D = 2
N128 = "CCSDS_ldpc_n128_k64.alist.txt"
N32 = "CCSDS_ldpc_n32_k16.alist.txt"  # multi-diagonal rows
B = 128
# shorter than the budgets below, so that the last value repeats; values
# that round differently in f32 and f64
T_SCHED = (0.6428481340408325, 0.7312891483306885, 0.7721433639526367,
           0.7756854295730591, 0.8019131422042847, 0.7957755327224731)
TD_SCHED = ((0.6587, 0.6199), (0.7548, 0.7022), (0.7922, 0.7078),
            (0.7969, 0.7711), (0.8275, 0.7755), (0.8138, 0.7958),
            (0.8166, 0.7882))


def _codes(name):
    ref = JCode(alist=jstd.make_builtin(name), name=name)
    port = code_from_numpy(ref.n, ref.m, ref.H.row_idx, ref.H.col_idx, name)
    return ref, port


def _llr(ref, ebno_db, seed):
    """Channel LLRs (LLR > 0 <=> bit 1), BPSK + AWGN, f32 [B, n]."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (B, ref.k), dtype=np.uint8)
    w = ref.standard_encode_spec.encode_numpy(u, "orig").astype(np.float64)
    sigma = 1.0 / np.sqrt(2 * ref.k / ref.n * 10 ** (ebno_db / 10))
    return (2 * ((2 * w - 1) + sigma * rng.standard_normal(w.shape))
            / sigma**2).astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize("alpha,variant", [
    (0.8, "minsum"), (T_SCHED, "normalized_minsum"),
    (TD_SCHED, "normalized_minsum"), ([[0.7]] * 3, "normalized_minsum"),
    ((0.7, 0.8), "minsum"), ((0.7, 0.8), "spa"), ((), "normalized_minsum"),
    (np.zeros((2, 2, 2)), "normalized_minsum"),
    (np.full((4, 3), 0.7), "normalized_minsum")])
def test_resolve_alpha_schedule_matches_the_reference(alpha, variant):
    """The same result, or the same refusal, as the JAX package's."""
    code = load_code(f"builtin:{W576}")
    t = build_tables(code.qc)
    ref = JCode(alist=jstd.make_builtin(W576), name=W576)
    try:
        want = jresolve(alpha, variant, ref.qc.row_slots())
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            resolve_alpha_schedule(alpha, variant, t.degrees)
        assert str(got.value) == str(e)
        return
    arr, cls = resolve_alpha_schedule(alpha, variant, t.degrees)
    if want[0] is None:
        assert arr is None and cls is None
    else:
        np.testing.assert_array_equal(arr, want[0])
        assert cls == want[1]


def test_alpha_at_is_the_clamped_f32_entry():
    """alpha[min(it, T-1)] of the row's degree class, cast to f32 once."""
    code = load_code(f"builtin:{W576}")
    t = build_tables(code.qc)
    loop = DecodeLoop(t, 12, "normalized_minsum", alpha=TD_SCHED)
    degrees = sorted(set(t.degrees.tolist()))
    for it in (0, 3, 6, 11):
        for bi in range(code.qc.mb):
            c = degrees.index(int(t.degrees[bi]))
            want = np.float32(TD_SCHED[min(it, len(TD_SCHED) - 1)][c])
            assert loop.alpha_at(it, bi) == float(want)
    flat = DecodeLoop(t, 12, "normalized_minsum", alpha=T_SCHED)
    assert flat.alpha_at(40, 0) == float(np.float32(T_SCHED[-1]))
    assert DecodeLoop(t, 12, "normalized_minsum", alpha=0.8).alpha_at(3, 1) == 0.8


def test_qc_decoder_per_degree_schedule_layered():
    """K3, layered, a [T, D] schedule at wimax 576: est / ok / conv / iters
    of every frame equal the interpret-mode kernel's."""
    ref, port = _codes(W576)
    llr, _ = _llr(ref, 1.75, 3)
    info = ref.standard_encode_spec.info_pos("orig")
    kw = dict(alpha=TD_SCHED, schedule="layered", track_norm=False)
    r = jax.jit(make_qc_decoder(ref.qc, info, 10, "normalized_minsum",
                                interpret=True, **kw))(jnp.asarray(llr))
    o = QCDecoder(port.qc, port.standard_encode_spec.info_pos("orig"), 10,
                  "normalized_minsum", **kw)(torch.from_numpy(llr))
    for what, a, b in (("est", o.est, r.est), ("ok", o.ok, r.ok),
                       ("conv", o.conv_iter, r.conv_iter)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=what)
    assert int(o.iters_run) == int(r.iters_run)
    assert 0 < int(o.ok.sum()) < B
    # the schedule is what decoded: the scalar 0.75 gives other frames
    s = QCDecoder(port.qc, port.standard_encode_spec.info_pos("orig"), 10,
                  "normalized_minsum", schedule="layered",
                  track_norm=False)(torch.from_numpy(llr))
    assert not torch.equal(s.conv_iter, o.conv_iter)


def test_mc_decoder_schedule_flooding():
    """K1, flooding with the flip metric, a [T] schedule at CCSDS n128: err /
    ok / conv of every frame equal, norm within 1e-6."""
    ref, port = _codes(N128)
    info = ref.standard_encode_spec.info_pos("orig")
    rng = np.random.default_rng(4)
    u = rng.integers(0, 2, (B, ref.k), dtype=np.uint8)
    raw = rng.integers(0, 2**32, (DRAWS_PER_BIT[1], ref.n, B), dtype=np.uint32)
    wT = jencode.make_encoder_T(ref.standard_encode_spec, "orig")(
        jnp.asarray(u))
    cv = consts_vector(jchannel.ChannelParams(
        mode=1, snr_db=2.5, speed=0.5, noise_model="exact").consts())
    kw = dict(alpha=T_SCHED, schedule="flooding", track_norm=True)
    r = [np.asarray(x) for x in jax.jit(make_mc_decoder(
        ref.qc, info, 10, "normalized_minsum", noise_source="input",
        interpret=True, **kw))(wT, cv, jnp.zeros(2, jnp.int32),
                               jnp.asarray(raw))]
    o = [x.numpy() for x in MCDecoder(
        port.qc, port.standard_encode_spec.info_pos("orig"), 10,
        "normalized_minsum", **kw)(
        torch.from_numpy(np.array(wT, np.float32)),
        consts_from_numpy(np.asarray(cv), "cpu"), raw=torch.from_numpy(raw))]
    for what, i in (("err", 0), ("ok", 1), ("conv", 2)):
        np.testing.assert_array_equal(o[i], r[i], err_msg=what)
    np.testing.assert_allclose(o[3], r[3], rtol=0, atol=1e-6)
    assert int(o[4].max()) == int(r[4].max())
    assert 0 < o[1].sum() < B


def test_llr_decoder_schedule_multi_diagonal():
    """K2, layered with the additive update of multi-diagonal rows (CCSDS
    n32), a [T] schedule, a pre-done mask: the live frames equal."""
    ref, port = _codes(N32)
    info = ref.standard_encode_spec.info_pos("orig")
    llr, w = _llr(ref, 3.0, 5)
    llrT = np.ascontiguousarray(-llr.T)
    wT = np.ascontiguousarray(w.T)
    done0 = (np.random.default_rng(6).random(B) < 0.3).astype(np.float32)
    kw = dict(alpha=T_SCHED, schedule="layered", track_norm=False)
    r = [np.asarray(x) for x in jax.jit(make_llr_decoder(
        ref.qc, info, 8, "normalized_minsum", interpret=True, **kw))(
        jnp.asarray(llrT), jnp.asarray(wT), jnp.asarray(done0))]
    o = [x.numpy() for x in LLRDecoder(
        port.qc, port.standard_encode_spec.info_pos("orig"), 8,
        "normalized_minsum", **kw)(torch.from_numpy(llrT),
                                   torch.from_numpy(wT),
                                   torch.from_numpy(done0))]
    live = done0 < 0.5
    for what, i in (("err", 0), ("ok", 1), ("conv", 2)):
        np.testing.assert_array_equal(o[i][live], r[i][live], err_msg=what)
    assert 0 < o[1][live].sum() < live.sum()


def test_runner_takes_a_schedule_on_both_paths():
    """A vector --minsum-alpha reaches the fused kernels and the QC
    decoder; the runner refuses it for other decoders."""
    code = load_code(f"builtin:{W576}")
    base = dict(matrix=code.name, iterations=6, fidelity="exact", batch=64,
                seed=2, speed=0.5, decoder="normalized-minsum",
                minsum_alpha=T_SCHED)
    fused = PointExecutor(code, SimOptions(**base), device="cpu")
    unfused = PointExecutor(code, SimOptions(**base, interleaver="random"),
                            device="cpu")
    assert fused.fused and not unfused.fused
    np.testing.assert_array_equal(fused._mc_full._sched[0].ravel(),
                                  np.float32(T_SCHED))
    assert unfused._decoder._sched is not None
    assert fused.run_point(2.0, 64).blocks == 64
    with pytest.raises(ValueError, match="normalized-minsum"):
        PointExecutor(code, SimOptions(**{**base, "decoder": "minsum"}),
                      device="cpu")
