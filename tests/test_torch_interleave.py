"""The port's interleavers against the JAX package's: the same permutations
from the same seeds and files, and the same arrays out of interleave and
deinterleave."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.ops import interleave as jil
from ldpc_tpu_torch.ops import interleave as til

torch.set_num_threads(1)

N = 576


def test_regular_permutation_matches_reference():
    for n in (576, 1152, 97, 648):
        assert til.regular_dims(n) == jil.regular_dims(n)
        np.testing.assert_array_equal(til.regular_permutation(n),
                                      jil.regular_permutation(n))


@pytest.mark.parametrize("s", [2, 6])
def test_srandom_permutation_matches_reference(s):
    for seed in (0, 3):
        pi = til.srandom_permutation(N, s, seed)
        np.testing.assert_array_equal(pi, jil.srandom_permutation(N, s, seed))
        assert sorted(pi.tolist()) == list(range(N))


def _pair(kind, tmp_path=None):
    return (jil.make_interleaver(kind, N, s_param=6, seed=5),
            til.make_interleaver(kind, N, s_param=6, seed=5))


@pytest.mark.parametrize("kind", ["none", "regular", "srandom", "file"])
def test_static_interleavers_match_reference(kind, tmp_path):
    if kind == "file":
        path = tmp_path / "pi.npy"
        np.save(path, np.random.default_rng(1).permutation(N))
        kind = f"file:{path}"
    (j_il, j_de), (t_il, t_de) = _pair(kind)
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (8, N)).astype(np.float32)
    llr = rng.standard_normal((8, N)).astype(np.float32)
    jb, js = j_il(jax.random.key(0), jnp.asarray(bits))
    tb, ts = t_il(None, torch.from_numpy(bits))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(t_de(ts, torch.from_numpy(llr)).numpy(),
                                  np.asarray(j_de(js, jnp.asarray(llr))))
    # deinterleave inverts interleave
    np.testing.assert_array_equal(t_de(ts, tb).numpy(), bits)


def test_file_interleaver_checks_the_permutation(tmp_path):
    path = tmp_path / "bad.npy"
    np.save(path, np.zeros(N, np.int64))
    with pytest.raises(ValueError, match="not a permutation"):
        til.make_interleaver(f"file:{path}", N)
    with pytest.raises(ValueError, match="Unknown interleaver"):
        til.make_interleaver("zigzag", N)


def test_random_interleaver_draws_one_permutation_per_row():
    il, de = til.make_interleaver("random", N)
    B = 16
    bits = torch.arange(N, dtype=torch.float32).repeat(B, 1)  # row = positions
    gen = torch.Generator().manual_seed(9)
    out, pi_b = il(gen, bits)
    assert tuple(pi_b.shape) == (B, N)
    # each row of the output is its own permutation of 0..n-1
    assert torch.equal(out.sort(dim=1).values, bits)
    assert len({tuple(r) for r in pi_b.tolist()}) == B
    assert torch.equal(out, pi_b.to(torch.float32))  # out[i] = bits[pi[i]]
    assert torch.equal(de(pi_b, out), bits)
    # the same generator state gives the same permutations
    out2, _ = il(torch.Generator().manual_seed(9), bits)
    assert torch.equal(out, out2)
