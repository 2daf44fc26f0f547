"""The port's single-device entry point (``ldpc_tpu_torch.entry``) against
the JAX repo's ``__graft_entry__.entry()`` on the CPU.

Both build the flooding SPA decoder (exact rule, ``orig`` graph, 10
iterations) of WiMAX (1152, 576) and take 256 frames of LLRs.

Tolerance: on the example's own N(0, 1) LLRs (no codeword: every frame
fails) ``est``, ``ok`` and ``conv_iter`` are equal on every frame. On
all-zero-codeword LLRs at 2.5 dB, where some frames decode and some do
not, ``ok`` and ``conv_iter`` are equal on every frame and ``est`` on at
least 99% of frames (SPA's ``tanh`` and ``log`` differ by ulps between
XLA and PyTorch).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ldpc_tpu_torch import entry as port_entry

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    j_fn, (j_llr,) = graft.entry()
    p_fn, (p_llr,) = port_entry.entry(device="cpu")
    return jax.jit(j_fn), j_llr, p_fn, p_llr


def _outputs(fn, llr):
    return [np.asarray(o) for o in fn(llr)]


def test_example_args_and_outputs_equal(both):
    j_fn, j_llr, p_fn, p_llr = both
    np.testing.assert_array_equal(np.asarray(j_llr), p_llr.numpy())
    j_est, j_ok, j_conv = _outputs(j_fn, j_llr)
    p_est, p_ok, p_conv = (o.numpy() for o in p_fn(p_llr))
    np.testing.assert_array_equal(p_ok, j_ok)
    np.testing.assert_array_equal(p_conv, j_conv)
    np.testing.assert_array_equal(p_est, j_est)
    assert not p_ok.any() and (p_conv == -1).all()  # no codeword in N(0, 1)


def test_shapes_and_dtypes(both):
    j_fn, j_llr, p_fn, p_llr = both
    assert p_llr.dtype == torch.float32 and tuple(p_llr.shape) == (256, 1152)
    for j, p in zip(_outputs(j_fn, j_llr), p_fn(p_llr)):
        assert tuple(p.shape) == j.shape
        assert p.numpy().dtype == j.dtype, (p.dtype, j.dtype)


def test_all_zero_codeword_at_2_5_db(both):
    j_fn, _, p_fn, _ = both
    sigma2 = 1.0 / (2 * 0.5 * 10 ** (2.5 / 10))
    y = 1.0 + np.sqrt(sigma2) * np.random.default_rng(1).normal(size=(256, 1152))
    llr = (-2.0 * y / sigma2).astype(np.float32)  # log(p1/p0), as entry's
    j_est, j_ok, j_conv = _outputs(j_fn, jax.numpy.asarray(llr))
    p_est, p_ok, p_conv = (o.numpy() for o in p_fn(torch.from_numpy(llr)))
    assert 0 < p_ok.sum() < len(p_ok)  # both outcomes occur
    np.testing.assert_array_equal(p_ok, j_ok)
    np.testing.assert_array_equal(p_conv, j_conv)
    assert (p_est == j_est).all(axis=1).mean() >= 0.99


def test_main_prints_the_shapes_and_runs_the_dry_run(capsys):
    assert port_entry.main([], device="cpu") == 0
    out = capsys.readouterr().out
    assert "entry() run OK: [(256, 1152), (256,), (256,)]" in out
    assert "dryrun_multiprocess OK" in out and "counters == one process" in out


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        assert port_entry.entry()[1][0].is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.main([])
