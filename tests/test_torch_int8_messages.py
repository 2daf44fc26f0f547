"""int8 extrinsic storage (``msg_store='int8'``) in the port: the grid against
the JAX package's ``E_quantize`` arithmetic on every level, its ties and its
clip, the CUDA source's constants, and the plain versions of K3
(``QCDecoder``) and K1 (``MCDecoder``) with int8 E against the JAX
package's interpret-mode kernels on the same inputs, bit for bit; and the
refusals."""

from __future__ import annotations

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu.ops import channel as jchannel
from ldpc_tpu.ops import encode as jencode
from ldpc_tpu.ops.mc_pallas import consts_vector, make_mc_decoder
from ldpc_tpu.ops.spa_pallas import E_INT8_CLIP, E_INT8_SCALE, make_qc_decoder
from ldpc_tpu_torch.ops import decode_loop as dl
from ldpc_tpu_torch.ops.mc_kernels import DRAWS_PER_BIT, LLRDecoder, MCDecoder
from ldpc_tpu_torch.ops.qc_kernels import QCDecoder
from ldpc_tpu_torch.utils.carry import code_from_numpy, consts_from_numpy

torch.set_num_threads(1)

N32 = "CCSDS_ldpc_n32_k16.alist.txt"  # multi-diagonal rows
N128 = "CCSDS_ldpc_n128_k64.alist.txt"
B = 128


def _jax_quantize(x: np.ndarray) -> np.ndarray:
    """``spa_pallas`` E_quantize's arithmetic (make_decode_loop, :369-376)."""
    q = jnp.round(jnp.clip(jnp.asarray(x), -E_INT8_CLIP, E_INT8_CLIP)
                  * (1.0 / E_INT8_SCALE))
    return np.asarray(q * E_INT8_SCALE)


def test_every_level_of_the_grid():
    """All 255 levels, the midpoints between them (ties round half to
    even), values past the clip and random values: e_quantize equals the
    JAX arithmetic bit for bit; e_write gives each level's own q and e_read
    brings it back."""
    q = np.arange(-127, 128, dtype=np.float32)
    levels = _jax_quantize(q * np.float32(E_INT8_SCALE))
    assert np.unique(levels).size == 255
    rng = np.random.default_rng(0)
    x = np.concatenate([
        levels, (levels[1:] + levels[:-1]) / 2, (q + 0.5) * np.float32(
            E_INT8_SCALE), np.float32([-1e30, -24.5, 24.0, 24.5, 1e30, 0.0]),
        rng.uniform(-30, 30, 4096).astype(np.float32)]).astype(np.float32)
    got = dl.e_quantize(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  _jax_quantize(x).view(np.int32))
    lv = torch.from_numpy(levels.copy())
    assert torch.equal(dl.e_write(lv), torch.from_numpy(q.astype(np.int8)))
    assert torch.equal(dl.e_read(dl.e_write(lv)), lv)
    assert float(dl.e_quantize(torch.tensor([1e30]))[0]) == levels[-1]


def test_cuda_constants_are_the_grid():
    """The kernels' f32 constants are the plain version's (each rounded once
    from float64, as the JAX kernels' Python floats are)."""
    src = open(os.path.join(os.path.dirname(dl.__file__), "..", "csrc",
                            "decode_group.cuh"), encoding="utf-8").read()

    def const(name):
        m = re.search(rf"constexpr float {name} = (0x[0-9a-f.]+p[+-]\d+)f;", src)
        return float.fromhex(m.group(1))

    assert const("E_SCALE") == dl.E_SCALE_F32 == float(np.float32(E_INT8_SCALE))
    assert const("E_INV") == dl.E_INV_F32 == float(np.float32(1.0 / E_INT8_SCALE))
    clip = re.search(r"constexpr float E_CLIP = ([0-9.]+)f;", src)
    assert float(clip.group(1)) == dl.E_INT8_CLIP == E_INT8_CLIP


def _codes(name):
    ref = JCode(alist=jstd.make_builtin(name), name=name)
    port = code_from_numpy(ref.n, ref.m, ref.H.row_idx, ref.H.col_idx, name)
    return ref, port


def _llr(ref, ebno_db, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (B, ref.k), dtype=np.uint8)
    w = ref.standard_encode_spec.encode_numpy(u, "orig").astype(np.float64)
    sigma = 1.0 / np.sqrt(2 * ref.k / ref.n * 10 ** (ebno_db / 10))
    return (2 * ((2 * w - 1) + sigma * rng.standard_normal(w.shape))
            / sigma**2).astype(np.float32)


@pytest.mark.parametrize("schedule,variant,name", [
    ("layered", "normalized_minsum", N32), ("flooding", "minsum", N128)])
def test_qc_decoder_int8(schedule, variant, name):
    """K3 with int8 E (layered: the additive update of multi-diagonal rows;
    flooding with the flip metric): est / ok / conv / iters of every frame
    equal the interpret-mode kernel's, norm within 1e-6."""
    ref, port = _codes(name)
    llr = _llr(ref, 2.5 if schedule == "layered" else 2.25, 7)
    info = ref.standard_encode_spec.info_pos("orig")
    kw = dict(schedule=schedule, track_norm=schedule == "flooding",
              msg_store="int8")
    r = jax.jit(make_qc_decoder(ref.qc, info, 10, variant, interpret=True,
                                **kw))(jnp.asarray(llr))
    o = QCDecoder(port.qc, port.standard_encode_spec.info_pos("orig"), 10,
                  variant, **kw)(torch.from_numpy(llr))
    for what, a, b in (("est", o.est, r.est), ("ok", o.ok, r.ok),
                       ("conv", o.conv_iter, r.conv_iter)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=what)
    np.testing.assert_allclose(o.norm_llr.numpy(), np.asarray(r.norm_llr),
                               rtol=0, atol=1e-6)
    assert int(o.iters_run) == int(r.iters_run)
    assert 0 < int(o.ok.sum()) < B


def test_mc_decoder_int8_flooding():
    """K1 with int8 E under flooding, normalized min-sum, mode 3: err / ok /
    conv of every frame equal, the batch's trips equal."""
    ref, port = _codes(N128)
    info = ref.standard_encode_spec.info_pos("orig")
    rng = np.random.default_rng(8)
    u = rng.integers(0, 2, (B, ref.k), dtype=np.uint8)
    raw = rng.integers(0, 2**32, (DRAWS_PER_BIT[3], ref.n, B), dtype=np.uint32)
    wT = jencode.make_encoder_T(ref.standard_encode_spec, "orig")(
        jnp.asarray(u))
    cv = consts_vector(jchannel.ChannelParams(
        mode=3, snr_db=3.0, speed=0.5, noise_model="exact", p=0.1,
        interference_snr_db=2.0).consts())
    kw = dict(mode=3, schedule="flooding", track_norm=False, msg_store="int8")
    r = [np.asarray(x) for x in jax.jit(make_mc_decoder(
        ref.qc, info, 12, "normalized_minsum", noise_source="input",
        interpret=True, **kw))(wT, cv, jnp.zeros(2, jnp.int32),
                               jnp.asarray(raw))]
    o = [x.numpy() for x in MCDecoder(
        port.qc, port.standard_encode_spec.info_pos("orig"), 12,
        "normalized_minsum", **kw)(
        torch.from_numpy(np.array(wT, np.float32)),
        consts_from_numpy(np.asarray(cv), "cpu"), raw=torch.from_numpy(raw))]
    for what, i in (("err", 0), ("ok", 1), ("conv", 2)):
        np.testing.assert_array_equal(o[i], r[i], err_msg=what)
    assert int(o[4].max()) == int(r[4].max())
    assert 0 < o[1].sum() < B


def test_int8_refusals_and_plans():
    """The JAX kernels' refusals, and the smaller shared memory of an int8
    block (E at one byte an entry, then a 16-byte boundary)."""
    _, port = _codes(N128)
    info = port.standard_encode_spec.info_pos("orig")
    for cls in (MCDecoder, LLRDecoder, QCDecoder):
        with pytest.raises(ValueError, match="requires a min-sum variant"):
            cls(port.qc, info, 8, "spa", msg_store="int8")
        with pytest.raises(ValueError, match="'f32' or 'int8'"):
            cls(port.qc, info, 8, "minsum", msg_store="bf16")
    f32 = QCDecoder(port.qc, info, 8, "minsum", schedule="layered")
    i8 = QCDecoder(port.qc, info, 8, "minsum", schedule="layered",
                   msg_store="int8")
    t = f32.tables
    e = f32.lanes * t.e_slots * port.qc.Z
    head = 4 * f32.lanes * f32.plan.l_stride
    assert i8.plan.int8 and not f32.plan.int8
    assert f32.plan.smem - i8.plan.smem == (head + 4 * e) - (-(-(head + e) // 16) * 16)
