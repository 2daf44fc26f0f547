"""The port's failure profiler (``ldpc_tpu_torch.analysis.failures``) on the
CPU, after ``tests/test_failures.py``.

Ground truth for the profiler: the same steps run one by one through the
executor, histogrammed in numpy (the two packages' random streams differ,
so the histograms are held to the port's own steps). ``trapping_census``
and ``weight_summary`` take numpy input and are held to the JAX package's
on the same input. ``--failure-profile`` writes the JAX CLI's JSON keys.

Tolerance: none; counts, classes and summaries are equal.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from ldpc_tpu import cli as jcli
from ldpc_tpu.analysis import failures as jfail
from ldpc_tpu.sim.config import SimOptions as JOptions
from ldpc_tpu.sim.runner import PointExecutor as JExecutor
from ldpc_tpu.sim.runner import load_code as jload
from ldpc_tpu_torch import cli as tcli
from ldpc_tpu_torch import plot_cli
from ldpc_tpu_torch.analysis import failures as tfail
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import PointExecutor, derive_key, load_code

torch.set_num_threads(1)

W576 = "builtin:wimax_576_0.5.alist.txt"
SNR = 2.0
QUIET = dict(say=lambda *a, **k: None)


def _kw(**kw):
    return {**dict(matrix=W576, blocks=128, batch=64, iterations=4, ber=True,
                   fer=True, fidelity="exact", exact_ber=True, speed=0.5,
                   fused="off", seed=3), **kw}


@pytest.fixture(scope="module")
def code():
    return load_code(W576)


@pytest.mark.parametrize("fused", ["off", "auto"])
def test_profiler_matches_per_step_histograms(code, fused):
    """Through K3's plain version (unfused) and K1's (fused)."""
    opts = SimOptions(**_kw(fused=fused))
    ex = PointExecutor(code, opts, device="cpu")
    assert ex.fused == (fused == "auto")
    hd, hu, frames = tfail.profile_point(code, opts, SNR, 10 ** 9, 8 * 64,
                                         executor=ex, point_index=2, **QUIET)
    assert frames == 8 * 64
    key_point = derive_key(opts.seed, 2)
    ref_d = np.zeros(ex.k_active + 1)
    ref_u = np.zeros(ex.k_active + 1)
    for i in range(8):
        st, _ = ex.step(derive_key(key_point, i), ex.consts(SNR))
        w = st.error_bits.numpy()
        ok = st.ok.numpy()
        np.add.at(ref_d, w, ~ok)
        np.add.at(ref_u, w, ok & (w > 0))
    np.testing.assert_array_equal(hd, ref_d)
    np.testing.assert_array_equal(hu, ref_u)
    assert hd.sum() > 0  # 2 dB, 4 iterations: failures exist
    # the profiled stream is run_point's: its failures are the histogram's
    st = ex.run_point(SNR, 8 * 64, opts.seed, 2)
    assert st.fer_frames == hd.sum()


def test_profile_point_stops_at_quota(code):
    opts = SimOptions(**_kw())
    hd, _, frames = tfail.profile_point(code, opts, SNR, 5, 10 ** 6,
                                        device="cpu", **QUIET)
    assert hd.sum() >= 5 and frames == 8 * 64  # the first chunk sufficed


@pytest.mark.parametrize("kind", ["detected", "undetected"])
def test_pattern_capture_matches_the_steps(code, kind):
    opts = SimOptions(**_kw(iterations=3))
    ex = PointExecutor(code, opts, device="cpu")
    K = 16
    pats, seen, frames = tfail.collect_failure_patterns(
        code, opts, 1.0, 10 ** 6, 8 * 64, max_patterns=K, executor=ex,
        kind=kind, **QUIET)
    rows, count = [], 0
    key_point = derive_key(opts.seed, 0)
    for i in range(8):
        st, _, resid = ex.pattern_step(derive_key(key_point, i),
                                       ex.consts(1.0))
        sel = ~st.ok if kind == "detected" else st.ok & (st.error_bits > 0)
        rows.extend(resid[sel].numpy())
        count += int(sel.sum())
    assert (seen, frames) == (count, 8 * 64)
    want = np.array(rows[:K], np.uint8).reshape(-1, code.n)
    np.testing.assert_array_equal(pats, want)
    if kind == "detected":
        assert len(pats) == K
        syn = (code.H.to_dense().astype(np.int64) @ pats.T.astype(np.int64)) & 1
        assert syn.any(axis=0).all()  # H @ e != 0 for a detected failure


def test_trapping_census_equals_the_jax_census(code):
    rng = np.random.default_rng(4)
    pats = (rng.random((40, code.n)) < 0.01).astype(np.uint8)
    pats[10:14] = pats[3]  # a recurring support
    pats[20] = 0  # an empty residual is skipped
    jcode = jload(W576)
    for graph in ("orig", "std"):
        assert tfail.trapping_census(pats, code, graph) == \
            jfail.trapping_census(pats, jcode, graph)


@pytest.mark.parametrize("hist", [
    np.zeros(9), np.array([0, 3, 0, 5, 1, 0, 0, 2.0]),
    np.random.default_rng(1).integers(0, 50, 300).astype(float)])
def test_weight_summary_equals_the_jax_one(hist):
    assert tfail.weight_summary(hist) == jfail.weight_summary(hist)


def test_refusals_carry_the_jax_text(code):
    kw = _kw()
    jex = JExecutor(jload(W576), JOptions(**dict(kw, exact_ber=False)))
    tex = PointExecutor(code, SimOptions(**dict(kw, exact_ber=False)),
                        device="cpu")
    with pytest.raises(ValueError) as j:
        jfail.make_profiler(jex, 288)
    with pytest.raises(ValueError) as t:
        tfail.make_profiler(tex, 288)
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError) as j:
        jfail.make_pattern_profiler(jex, 8, kind="undetected")
    with pytest.raises(ValueError) as t:
        tfail.make_pattern_profiler(tex, 8, kind="undetected")
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="kind must be"):
        tfail.make_pattern_profiler(tex, 8, kind="bogus")
    fused = PointExecutor(code, SimOptions(**dict(kw, fused="auto")),
                          device="cpu")
    with pytest.raises(ValueError, match="fused='off'"):
        tfail.make_pattern_profiler(fused, 8)


def test_cli_failure_profile_exports_the_jax_keys(tmp_path, monkeypatch):
    monkeypatch.setenv("LDPC_TPU_NO_COMPILE_CACHE", "1")
    argv = ["--matrix", W576, "--blocks", "256", "--batch", "128",
            "--iterations", "3", "--ber", "--fer", "--fidelity", "exact",
            "--speed", "0.5", "--initial-snr", str(SNR), "--end-snr",
            str(SNR), "--step-snr", "1", "--quiet"]
    t_out, j_out = tmp_path / "t.json", tmp_path / "j.json"
    assert tcli.main(argv + ["--failure-profile", str(t_out)],
                     device="cpu") == 0
    assert jcli.main(argv + ["--kernel", "xla", "--failure-profile",
                             str(j_out)]) == 0
    t, j = json.loads(t_out.read_text()), json.loads(j_out.read_text())
    assert list(t) == list(j) == [str(SNR)]
    assert set(t[str(SNR)]) == set(j[str(SNR)])
    p = t[str(SNR)]
    assert set(p["detected"]) == set(j[str(SNR)]["detected"])
    assert p["frames"] >= 256
    assert p["detected"]["count"] == sum(p["hist_detected"].values()) > 0
    png = tmp_path / "fp.png"
    assert plot_cli.main(["--failure-profile", str(t_out), "--output",
                          str(png), "--no-show"]) == 0
    assert png.stat().st_size > 0


def test_profile_sweep_uses_one_executor(code):
    opts = SimOptions(**_kw())
    out = tfail.profile_sweep(code, opts, [1.5, 2.5], 1, 64, device="cpu",
                              **QUIET)
    assert list(out) == [1.5, 2.5]
    assert all(set(v) == {"frames", "detected", "undetected",
                          "hist_detected", "hist_undetected"}
               for v in out.values())
    replaced = dataclasses.replace(opts, seed=4)
    assert tfail.profile_sweep(code, replaced, [1.5], 1, 64, device="cpu",
                               **QUIET)[1.5]["frames"] == 64 * 8
