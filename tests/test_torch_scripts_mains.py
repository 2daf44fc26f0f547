"""Every ported study's ``main`` (``ldpc_tpu_torch/scripts/``) end to end
on the CPU at a tiny size (CCSDS n32 or wimax 576, a few hundred frames,
``device="cpu"``: the plain versions of K1-K3), writing into ``tmp_path``
files with the JSON keys of the JAX package's committed record of the same
study; and every ``main`` without ``device`` raising when CUDA is missing.

Tolerance: none; keys, table headers and return codes are equal, and the
witnesses' residuals are codewords exactly (GF(2)).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.scripts import (
    big_code_study,
    burst_interleaver_study,
    cli_records,
    envelope_paired,
    error_floor,
    exit_charts,
    family_atlas,
    family_validation,
    importance_floor,
    is_depth_harvest,
    learned_minsum_study,
    mfu_levers,
    parity_fixed_noise,
    parity_spread,
    perf_matrix,
    quantized_messages_study,
    small_code_binder,
    two_phase_envelope,
    two_phase_parity,
    undetected_witness,
    variant_perf,
)
from ldpc_tpu_torch.sim.runner import load_code

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
N32 = "builtin:CCSDS_ldpc_n32_k16.alist.txt"
CPU = dict(device="cpu")


def record(*parts) -> dict | list:
    return json.loads(REPO.joinpath(*parts).read_text())


def keys(d) -> list:
    return sorted(d)


def test_error_floor(tmp_path):
    out = tmp_path / "ef"
    assert error_floor.main([
        "--code", N32, "--snr", "2.0:2.5:0.5", "--target-errors", "5",
        "--max-blocks", "512", "--profile-snrs", "3.0", "--profile-errors",
        "5", "--profile-max-blocks", "8192", "--census-snr", "2.0",
        "--census-patterns", "4", "--iterations", "4", "--out", str(out)],
        **CPU) == 0
    curve = json.loads((out / "curve.json").read_text())
    rec = record("examples", "error_floor", "curve.json")
    assert keys(curve) == keys(rec)
    assert keys(curve["snr_points"][0]) == keys(rec["snr_points"][0])
    assert [p["snr_db"] for p in curve["snr_points"]] == [2.0, 2.5]
    prof = json.loads((out / "failure_profile.json").read_text())
    prec = record("examples", "error_floor", "failure_profile.json")
    assert list(prof) == ["3.0"]
    assert keys(prof["3.0"]) == keys(prec["3.5"])
    assert prof["3.0"]["detected"]["count"] >= 5
    census = json.loads((out / "trapping_census.json").read_text())
    assert keys(census) == keys(record("examples", "error_floor",
                                       "trapping_census.json"))
    assert census["patterns"] == 4
    # the curve resumes from its own checkpoint, never from examples/
    assert error_floor.main(["--code", N32, "--snr", "2.0:2.5:0.5",
                             "--target-errors", "5", "--max-blocks", "512",
                             "--iterations", "4", "--skip-profile",
                             "--out", str(out)], **CPU) == 0
    assert json.loads((out / "curve.json").read_text())["snr_points"] \
        == curve["snr_points"]


def test_undetected_witness(tmp_path):
    path = tmp_path / "uw" / "undetected_codewords.json"
    assert undetected_witness.main([
        "--code", N32, "--snrs", "1.0", "--min-patterns", "2",
        "--max-blocks", "8192", "--batch", "256", "--iterations", "4",
        "--out", str(path)], **CPU) == 0
    out = json.loads(path.read_text())
    rec = record("examples", "error_floor", "wimax1152",
                 "undetected_codewords.json")
    assert keys(out) == keys(rec)
    assert keys(out["points"][0]) == keys(rec["points"][0])
    assert keys(out["points"][0]["events"][0]) \
        == keys(rec["points"][0]["events"][0])
    assert keys(out["qc_orbits"][0]) == keys(rec["qc_orbits"][0])
    # every residual is a nonzero codeword of the original H
    code = load_code(N32)
    assert out["all_codewords"]
    for e in out["points"][0]["events"]:
        word = np.zeros(code.n, np.uint8)
        word[e["support"]] = 1
        assert e["weight"] > 0 and not code.syndrome_orig(word).any()


def _importance(tmp_path) -> Path:
    out = tmp_path / "if"
    assert importance_floor.main([
        "--code", N32, "--census", "", "--capture-snr", "1.0",
        "--capture-min", "2", "--capture-max-blocks", "8192",
        "--validate-snrs", "3.0", "--deep-snrs", "4.0",
        "--validate-frames", "512", "--deep-frames", "512", "--batch", "256",
        "--iterations", "4", "--out", str(out)], **CPU) == 0
    return out / "results.json"


def test_importance_floor_and_depth_harvest(tmp_path):
    res = _importance(tmp_path)
    out = json.loads(res.read_text())
    rec = record("examples", "error_floor", "importance", "results.json")
    assert keys(out) == keys(rec)
    assert keys(out["validation"][0]) == keys(rec["validation"][0])
    assert [r["snr_db"] for r in out["validation"] + out["deep"]] == [3.0, 4.0]
    path = tmp_path / "dh" / "results_depth.json"
    assert is_depth_harvest.main([
        "--code", N32, "--base", str(res), "--harvest-snrs", "3.0",
        "--harvest-frames", "512", "--eval-snrs", "4.0", "--eval-frames",
        "512", "--batch", "256", "--iterations", "4", "--out", str(path)],
        **CPU) == 0
    depth = json.loads(path.read_text())
    drec = record("examples", "error_floor", "wran384", "importance",
                  "results_depth.json")
    assert keys(depth) == keys(drec)
    assert keys(depth["deep"][0]) == keys(drec["deep"][0])
    assert depth["components"] >= depth["base_components"]


def test_quantized_messages_study(tmp_path):
    path = tmp_path / "qm" / "RESULTS.md"
    assert quantized_messages_study.main([
        "--blocks", "64", "--batch", "64", "--snrs", "2.0,2.5",
        "--iterations", "2", "--out", str(path)], **CPU) == 0
    ours = path.read_text().splitlines()
    rec = (EXAMPLES / "quantized_messages" / "RESULTS.md").read_text() \
        .splitlines()
    header = "| Eb/N0 (dB) | spa-f32 | spa-bf16 | spa-f32-bf16msg | nms-f32 " \
             "| nms-int8msg |"
    assert ours.count(header) == rec.count(header) == 2
    rows = [ln for ln in ours if ln.startswith("| 2.")]
    assert len(rows) == 4 and all(len(r.split("|")) == 8 for r in rows)


def test_burst_interleaver_study(tmp_path):
    out = tmp_path / "bi"
    assert burst_interleaver_study.main([
        "--snr", "6.0", "--target-errors", "5", "--max-blocks", "256",
        "--batch", "128", "--s-sweep", "2", "--out", str(out)], **CPU) == 0
    res = json.loads((out / "results.json").read_text())
    rec = record("examples", "burst_interleaver", "results.json")
    assert keys(res) == keys(rec)
    assert list(res["rows"]) == ["none", "regular", "random", "srandom_S2",
                                 "adversarial"]
    assert keys(res["rows"]["adversarial"]["6.0"]) \
        == keys(rec["rows"]["adversarial"]["6.0"])
    np.testing.assert_array_equal(
        np.load(out / "adversarial_pi.npy"),
        np.load(EXAMPLES / "burst_interleaver" / "adversarial_pi.npy"))


def test_learned_minsum_study(tmp_path):
    out = tmp_path / "lm"
    assert learned_minsum_study.main([
        "--code", N32, "--iters", "2", "--steps", "2", "--train-batch", "16",
        "--eval-snrs", "2.0", "--eval-blocks", "64", "--eval-batch", "32",
        "--out", str(out)], **CPU) == 0
    res = json.loads((out / "results.json").read_text())
    rec = record("examples", "learned_minsum", "results.json")
    assert keys(res) == keys(rec)
    assert keys(res["eval"][0]) == keys(rec["eval"][0])
    assert len(res["alphas"]) == 2
    assert (out / "RESULTS.md").read_text().startswith(
        "# Learned min-sum weight schedule")


def test_parity_replays(tmp_path, monkeypatch):
    """The fixed-noise replay and the spread at the reference's settings,
    from a reference run cut to 8 blocks."""
    ref = record("parity_runs", "ref_mode3.json")
    ref["config"]["blocks"] = 8
    (tmp_path / "ref_mode3.json").write_text(json.dumps(ref))
    monkeypatch.setattr(parity_fixed_noise, "REF_RUN",
                        str(tmp_path / "ref_mode3.json"))
    path = tmp_path / "pr" / "fixed_noise.json"
    assert parity_fixed_noise.main(["--reps", "2", "--out", str(path)],
                                   **CPU) == 0
    rows = json.loads(path.read_text())
    assert [keys(r) for r in rows] == [
        keys(r) for r in record("parity_runs", "fixed_noise.json")]
    assert [r["blocks"] for r in rows] == [8, 8]
    monkeypatch.setitem(parity_spread.SCENARIOS, "mode3", (
        str(tmp_path / "ref_mode3.json"),
        parity_spread.SCENARIOS["mode3"][1]))
    path = tmp_path / "pr" / "spread.json"
    assert parity_spread.main(["--reps", "2", "--scenarios", "mode3",
                               "--out", str(path)], **CPU) == 0
    spread = json.loads(path.read_text())
    rec = record("parity_runs", "spread.json")
    assert list(spread) == ["mode3"]
    assert [keys(r) for r in spread["mode3"]] == [
        keys(r) for r in rec["mode3"]]


def _family_codes(monkeypatch, flooding: list[str], layered: list[str]):
    """The family validation over ``flooding`` (in place of every built-in)
    and ``layered`` (in place of its ten representatives)."""
    from ldpc_tpu_torch.models import standards

    monkeypatch.setattr(standards, "builtin_names", lambda: flooding)
    monkeypatch.setattr(family_validation, "LAYERED_TARGETS", layered)


def test_family_validation(tmp_path, monkeypatch):
    _family_codes(monkeypatch, ["CCSDS_ldpc_n32_k16.alist.txt",
                                "BCH_7_4_1_strip.alist.txt"],
                  ["CCSDS_ldpc_n32_k16.alist.txt"])
    path = tmp_path / "fv" / "RESULTS.md"
    assert family_validation.main(["--out", str(path)], **CPU) == 0
    text = path.read_text()
    assert "| code | n | k | Z | kernel | smem KB | SNR | FER | ok | avg conv " \
           "| s |" in text
    assert text.count("| CCSDS_ldpc_n32_k16.alist.txt | 32 |") == 2
    assert "BCH_7_4_1" not in text  # not QC: no kernel row
    r = family_validation.run_code("CCSDS_ldpc_n32_k16.alist.txt", "layered",
                                   blocks=64, iters=4, device="cpu")
    assert r["kernel"].startswith("cpu+fused+layered")
    assert r["blocks"] == 64 and r["smem_kb"] > 0


def test_family_validation_returns_1_on_a_failed_code(tmp_path, monkeypatch):
    _family_codes(monkeypatch, ["CCSDS_ldpc_n32_k16.alist.txt",
                                "no_such_code.alist"], [])
    path = tmp_path / "fv" / "RESULTS.md"
    assert family_validation.main(["--out", str(path)], **CPU) == 1
    assert "| no_such_code.alist | ERROR: FileNotFoundError" \
        in path.read_text()


def test_perf_matrix(tmp_path):
    out = tmp_path / "pm"
    assert perf_matrix.main([
        "--codes", "CCSDS_ldpc_n32_k16.alist.txt", "--batch", "64",
        "--n-batches", "2", "--n-windows", "2", "--out", str(out)],
        **CPU) == 0
    res = json.loads((out / "results.json").read_text())
    rec = record("examples", "perf_matrix", "results.json")
    assert keys(res) == keys(rec)
    assert [r["config"] for r in res["rows"]] == [c[0] for c in
                                                  perf_matrix.CONFIGS]
    for r in res["rows"]:
        assert keys(r) == keys(rec["rows"][0])
    assert res["ceilings"] == {}  # a device figure: none on the CPU
    assert (out / "README.md").is_file()


def test_perf_matrix_row_ceiling(tmp_path):
    """``row_ceiling`` at the H100's issue peak (132 SMs x 128 lanes x
    1980 MHz) on the trips of the kernel's plain version."""
    from ldpc_tpu_torch.analysis.roofline import issue_peak_ops_per_s

    code = load_code(N32)
    ex = perf_matrix.make_executor(code, "sum-product", "layered", 12, 0.75,
                                   64, "cpu")
    peak = issue_peak_ops_per_s("NVIDIA H100 80GB HBM3", 132, 1980)
    rec = record("examples", "perf_matrix", "results.json")["ceilings"]
    for kernel_used in (ex.kernel_used + "+2phase(auto:off)",
                        ex.kernel_used + "+2phase(auto:6)"):
        c = perf_matrix.row_ceiling(code, ex.opts, 5.0, kernel_used,
                                    peak=peak, device="cpu")
        assert keys(c) == sorted(set(keys(rec[code.name]))
                                 - {"pct_of_ceiling"})
        assert c["two_phase"] == kernel_used.endswith(":6)")
        assert 0 < c["ceiling_info_bits_per_s"] < float("inf")


MAINS = {
    "error_floor": (error_floor, ["--skip-profile"]),
    "undetected_witness": (undetected_witness, []),
    "importance_floor": (importance_floor, []),
    "is_depth_harvest": (is_depth_harvest, []),
    "quantized_messages_study": (quantized_messages_study, []),
    "burst_interleaver_study": (burst_interleaver_study, []),
    "learned_minsum_study": (learned_minsum_study, []),
    "parity_fixed_noise": (parity_fixed_noise, []),
    "parity_spread": (parity_spread, []),
    "family_validation": (family_validation, []),
    "perf_matrix": (perf_matrix, []),
    "family_atlas": (family_atlas, []),
    "big_code_study": (big_code_study, []),
    "mfu_levers": (mfu_levers, []),
    "variant_perf": (variant_perf, []),
    "two_phase_envelope": (two_phase_envelope, []),
    "envelope_paired": (envelope_paired, []),
    "two_phase_parity": (two_phase_parity, []),
    "small_code_binder": (small_code_binder, []),
    "exit_charts": (exit_charts, []),
    "cli_records": (cli_records, []),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_without_device_needs_cuda(name, tmp_path):
    """Each study runs on the card unless the caller asks for the CPU: with
    no CUDA it raises before writing anything."""
    mod, argv = MAINS[name]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the study would run on it")
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([*argv, "--out", str(out)])
    assert not out.exists()
