"""A batch's counters (``ops.metrics.batch_counters`` and ``add_packed``,
K7's plain versions) on the CPU: the same int32[8] as the masked reduction
the run loop took before K7, as the JAX package's ``reduce_block_stats`` and
``pack_counters`` and as the slots written out in numpy; the add into
float64 totals; and the card wrappers' refusals."""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.ops import metrics as jmetrics
from ldpc_tpu_torch.ops.metrics import (
    SLOTS,
    BlockStats,
    add_packed,
    batch_counters,
    failed_frame_errors,
    launch_add_packed,
    launch_batch_counters,
    pack_counters,
    reduce_block_stats,
)

torch.set_num_threads(1)

B = 37  # not a multiple of 4: K7 reads 4 frames at a time


def _stats(exact: bool, norm: bool, seed: int = 3) -> BlockStats:
    """A batch's per-frame stats as a decode leaves them: failed frames'
    errors under the BER rule, a converging sweep (-1 where none) and the
    flip metric (zeros, as the benchmark's cells run, or values)."""
    rng = np.random.default_rng(seed)
    ok = torch.from_numpy(rng.random(B) < 0.6)
    errs = torch.from_numpy(rng.integers(0, 40, B).astype(np.int32))
    conv = torch.from_numpy(np.where(rng.random(B) < 0.7,
                                     rng.integers(0, 12, B), -1)
                            .astype(np.int32))
    nl = (torch.from_numpy(rng.random(B).astype(np.float32) * 3.0) if norm
          else torch.zeros(B))
    return BlockStats(error_bits=failed_frame_errors(errs, ok, exact), ok=ok,
                      conv_iter=conv, norm_llr=nl)


def _iters(kind: str, seed: int = 4) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if kind == "[B]":
        return torch.from_numpy(rng.integers(1, 13, B).astype(np.int32))
    return torch.tensor([7], dtype=torch.int32)


def _numpy_slots(s: BlockStats, iters, lo: int, take: int):
    """The slots written out in numpy: the integer ones and the norm sum in
    float64."""
    v = np.arange(lo, lo + B) < take
    ok, err = s.ok.numpy()[v], s.error_bits.numpy()[v]
    conv = s.conv_iter.numpy()[v]
    ints = [int(v.sum()), int(ok.sum()), int(err.sum()), int((~ok).sum()),
            int(conv[conv >= 0].sum()), int((conv >= 0).sum()),
            int(iters.numpy().max())]
    return ints, float(s.norm_llr.numpy()[v].astype(np.float64).sum())


# take = B (every row), take < B, take <= lo (no row); lo 0 or a shard's
_TAKES = {"all": lambda lo: lo + B, "part": lambda lo: lo + B // 3,
          "none": lambda lo: lo}


@pytest.mark.parametrize("iters_kind, take_kind, lo, exact, norm",
                         list(itertools.product(
                             ("[B]", "[1]"), list(_TAKES), (0, 2 * B),
                             (False, True), (False, True))))
def test_batch_counters_equal_the_masked_reduction(iters_kind, take_kind, lo,
                                                   exact, norm):
    s, iters = _stats(exact, norm), _iters(iters_kind)
    take = _TAKES[take_kind](lo)
    got = batch_counters(s, iters, lo, take)
    valid = torch.arange(lo, lo + B) < take
    want = pack_counters(reduce_block_stats(s, valid), iters.max())
    assert got.dtype == torch.int32 and got.shape == (len(SLOTS),)
    assert torch.equal(got, want)
    jstats = jmetrics.BlockStats(*(jnp.asarray(x.numpy()) for x in s))
    ref = np.asarray(jmetrics.pack_counters(
        jmetrics.reduce_block_stats(jstats, jnp.asarray(valid.numpy())),
        jnp.max(jnp.asarray(iters.numpy()))))
    np.testing.assert_array_equal(got[:7].numpy(), ref[:7])
    np.testing.assert_allclose(got[7:].numpy().view(np.float32),
                               ref[7:].view(np.float32), rtol=1e-6)
    ints, norm_sum = _numpy_slots(s, iters, lo, take)
    assert got[:7].tolist() == ints
    assert got[7:].view(torch.float32).item() == pytest.approx(norm_sum,
                                                               rel=1e-6)
    if take_kind == "none":
        assert got[:6].tolist() == [0] * 6 and got[7] == 0


@pytest.mark.parametrize("total_shape", [(8,), (9,), (3, 8), (2, 10)])
def test_add_packed_adds_every_slot(total_shape):
    rows = int(np.prod(total_shape[:-1]))
    packed = torch.stack([batch_counters(_stats(False, True, seed=r),
                                         _iters("[B]", seed=r), 0, B - r)
                          for r in range(rows)])
    packed = packed.reshape(*total_shape[:-1], len(SLOTS))
    total = torch.arange(float(np.prod(total_shape)), dtype=torch.float64
                         ).reshape(total_shape)
    want = total.clone().numpy()
    p = packed.numpy().reshape(-1, len(SLOTS))
    w = want.reshape(-1, total_shape[-1])
    w[:, :7] += p[:, :7]
    w[:, 7] += p[:, 7:].view(np.float32)[:, 0]
    add_packed(total, packed)
    assert torch.equal(total, torch.from_numpy(want))


def _counter_args():
    """Valid arguments of ``launch_batch_counters`` on the CPU."""
    return dict(zip(BlockStats._fields, _stats(False, True))), _iters("[B]")


def _launch_counters(fault):
    stats, iters = _counter_args()
    args = dict(stats, iters=iters)
    fault(args)
    launch_batch_counters(BlockStats(*(args[f] for f in BlockStats._fields)),
                          args["iters"], 0, B)


def _launch_add(fault):
    args = dict(total=torch.zeros(9, dtype=torch.float64),
                packed=torch.zeros(8, dtype=torch.int32))
    fault(args)
    launch_add_packed(args["total"], args["packed"])


def _strided(x):
    return torch.stack([x, x], dim=1)[:, 0]


_LAUNCH_FAULTS = {
    "error_bits dtype": (_launch_counters, lambda a: a.update(
        error_bits=a["error_bits"].long()), "error_bits has dtype"),
    "ok dtype": (_launch_counters, lambda a: a.update(
        ok=a["ok"].to(torch.uint8)), "ok has dtype"),
    "ok rank": (_launch_counters, lambda a: a.update(
        ok=a["ok"].reshape(1, B)), "ok has shape"),
    "empty batch": (_launch_counters, lambda a: a.update(
        {k: v[:0] for k, v in a.items()}), "ok has shape"),
    "conv_iter shape": (_launch_counters, lambda a: a.update(
        conv_iter=a["conv_iter"][:-1]), "conv_iter has shape"),
    "conv_iter contiguous": (_launch_counters, lambda a: a.update(
        conv_iter=_strided(a["conv_iter"])), "conv_iter must be contiguous"),
    "norm_llr dtype": (_launch_counters, lambda a: a.update(
        norm_llr=a["norm_llr"].double()), "norm_llr has dtype"),
    "norm_llr device": (_launch_counters, lambda a: a.update(
        norm_llr=a["norm_llr"].to("meta")), "norm_llr is on meta"),
    "iters dtype": (_launch_counters, lambda a: a.update(
        iters=a["iters"].long()), "iters has dtype"),
    "iters shape": (_launch_counters, lambda a: a.update(
        iters=a["iters"][:2]), "iters has shape"),
    "counters on cpu": (_launch_counters, lambda a: None,
                        "no kernel for device cpu"),
    "packed dtype": (_launch_add, lambda a: a.update(
        packed=a["packed"].long()), "packed has dtype"),
    "packed shape": (_launch_add, lambda a: a.update(
        packed=a["packed"][:7]), "packed has shape"),
    "total dtype": (_launch_add, lambda a: a.update(
        total=a["total"].float()), "total has dtype"),
    "total width": (_launch_add, lambda a: a.update(
        total=a["total"][:7]), "total has shape"),
    "total rows": (_launch_add, lambda a: a.update(
        total=torch.zeros(2, 8, dtype=torch.float64)), "total has shape"),
    "total contiguous": (_launch_add, lambda a: a.update(
        total=_strided(torch.zeros(9, dtype=torch.float64))),
        "total must be contiguous"),
    "total device": (_launch_add, lambda a: a.update(
        total=a["total"].to("meta")), "total is on meta"),
    "add on cpu": (_launch_add, lambda a: None, "no kernel for device cpu"),
}


@pytest.mark.parametrize("case", list(_LAUNCH_FAULTS))
def test_launch_refusals(case):
    """The card wrappers hand K7 raw pointers, so they refuse, before any
    launch, each tensor the kernel would read out of bounds or misread, and
    a device without the kernel."""
    launch, fault, match = _LAUNCH_FAULTS[case]
    with pytest.raises(ValueError, match=match):
        launch(fault)
