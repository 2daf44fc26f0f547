"""The eight throughput studies of ``ldpc_tpu_torch/scripts/`` (the family
atlas, big codes, MFU levers, decoder variants, the two-phase envelope and
its paired re-statement, the two-phase parity check, the small-code binder)
and ``bench.measure_paired`` / ``paired_ratio``: what they copy from the JAX
package's ``scripts/`` and root ``bench.py`` held on the same inputs, and
each ``main`` at a tiny size on the CPU (``device="cpu"``: the plain
versions of K1-K3) writing the JSON keys of the committed TPU record of the
same study.

The JAX scripts and the root ``bench.py`` are loaded from their files with
``importlib.util.spec_from_file_location``.

Tolerance: none. Counters, generated ALIST files, grids, keys and parsed
options are equal; the float formulas (``snr_grid``, ``paired_ratio``, the
trip model) are equal in float64.
"""

from __future__ import annotations

import ast
import csv
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ldpc_tpu.models.generate import wimax_like as j_wimax_like
from ldpc_tpu.models.generate import write_alist as j_write_alist
from ldpc_tpu.sim.runner import two_phase_trip_model as j_trip_model
from ldpc_tpu_torch import bench
from ldpc_tpu_torch.models import standards
from ldpc_tpu_torch.models.generate import wimax_like, write_alist
from ldpc_tpu_torch.scripts import (
    big_code_study,
    envelope_paired,
    family_atlas,
    mfu_levers,
    small_code_binder,
    two_phase_envelope,
    two_phase_parity,
    variant_perf,
)
from ldpc_tpu_torch.sim.runner import load_code, two_phase_trip_model

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
N32 = "CCSDS_ldpc_n32_k16.alist.txt"
W576 = "wimax_576_0.5.alist.txt"
CPU = dict(device="cpu")


def load_file(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_script(name: str):
    """A module of the JAX package's ``scripts/``, loaded from its file."""
    return load_file(f"jax_scripts_{name}", REPO / "scripts" / f"{name}.py")


def record(*parts) -> dict:
    return json.loads(EXAMPLES.joinpath(*parts).read_text())


@pytest.fixture
def fast_windows(monkeypatch):
    """``bench.measure_point`` with one warm-up batch (the studies' windows
    keep their own counts)."""
    measure_point = bench.measure_point

    def one_warmup(*args, **kw):
        kw.update(warmup_batches=1, warmup_runs=1)
        return measure_point(*args, **kw)

    monkeypatch.setattr(bench, "measure_point", one_warmup)


# ------------------------------------------------------- copied helpers ----

def test_family_of_and_snr_grid_equal_jax():
    jmod = jax_script("family_atlas")
    names = standards.builtin_names()
    assert len(names) == 119
    assert [family_atlas.family_of(n) for n in names] \
        == [jmod.family_of(n) for n in names]
    rates = {(a.n - a.m) / a.n for a in map(standards.make_builtin, names)}
    with open(EXAMPLES / "family_atlas" / "atlas.csv", newline="") as f:
        rates |= {float(r["rate"]) for r in csv.DictReader(f)}
    rates |= set(np.linspace(0.0, 1.0, 401).tolist())
    for rate in sorted(rates):
        assert family_atlas.snr_grid(rate) == jmod.snr_grid(rate)


def test_levers_equal_jax():
    assert mfu_levers.LEVERS == jax_script("mfu_levers").LEVERS


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_paired_ratio_equals_root_bench(n):
    root = load_file("root_bench", REPO / "bench.py")
    rng = np.random.default_rng(n)
    a, b = rng.uniform(0.5, 2.0, n), rng.uniform(0.5, 2.0, n)
    assert bench.paired_ratio(a, b) == root.paired_ratio(a, b)
    assert bench.paired_ratio(list(a), list(b)) == root.paired_ratio(a, b)


class _Stub:
    """An executor that records its ``run_point`` calls."""

    def __init__(self, label, calls):
        self.label, self.calls = label, calls

    def run_point(self, snr, blocks, key, index):
        self.calls.append((self.label, snr, blocks, key, index))


def test_measure_paired_key_schedule_equals_root_bench():
    """The port's integer keys are the root bench's ``fold_in`` indices:
    warm-ups at ``key + 7000 + i``, round ``r`` at ``key + r * 97 + i``,
    in the same order, with the same frames and point indices."""
    root = load_file("root_bench", REPO / "bench.py")
    ours, theirs = [], []
    kw = dict(batch=8, n_batches=3, n_rounds=4, warmup_batches=2)
    t = bench.measure_paired([(c, _Stub(c, ours), s) for c, s in
                              (("off", 2.0), ("auto", 3.5))], key=0, **kw)
    root.measure_paired([(c, _Stub(c, theirs), s) for c, s in
                         (("off", 2.0), ("auto", 3.5))], **kw)
    assert [c[:3] + c[4:] for c in ours] == [c[:3] + c[4:] for c in theirs]
    base = jax.random.key(0)
    for o, j in zip(ours, theirs):
        np.testing.assert_array_equal(
            jax.random.key_data(jax.random.fold_in(base, o[3])),
            jax.random.key_data(j[3]))
    assert [c[3] for c in ours[:2]] == [7000, 7001]
    assert [c[3] for c in ours[2:6]] == [0, 1, 97, 98]
    assert list(t) == ["off", "auto"] and all(len(v) == 4 for v in t.values())
    assert all(x >= 0 for v in t.values() for x in v)


def _jax_default_variants() -> list[tuple]:
    """The JAX script's default configuration list, read from its source."""
    tree = ast.parse((REPO / "scripts" / "variant_perf.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.List) \
                and getattr(node.targets[0], "id", None) == "configs" \
                and node.value.elts:
            return [tuple(x) for x in ast.literal_eval(node.value)]
    raise AssertionError("no default list in scripts/variant_perf.py")


def test_variant_parser_on_the_jax_defaults_and_int8():
    defaults = _jax_default_variants()
    assert variant_perf.DEFAULT_CONFIGS == defaults
    for v, it, a, b, store in defaults:
        assert variant_perf.parse_config(f"{v}:{it}:{a}:{b}") \
            == (v, it, a, b, store)
    assert variant_perf.parse_config("normalized_minsum+int8msg:12:0.8125") \
        == ("normalized_minsum", 12, 0.8125, 0.15, "int8")
    assert variant_perf.parse_config("minsum+int8msg") \
        == ("minsum", 12, 0.75, 0.15, "int8")
    assert variant_perf.parse_config("spa") == ("spa", 12, 0.75, 0.15, "f32")


def test_variant_record_rows():
    """The default configurations find their rows in the record's table."""
    fers = variant_perf.record_fers(
        (EXAMPLES / "decoder_variants" / "README.md").read_text())
    assert len(fers) == 10
    got = [fers[(variant_perf.record_label(v, it, a, b), it)]
           for v, it, a, b, _ in variant_perf.DEFAULT_CONFIGS]
    assert got == [0.0063, 0.019, 0.0084, 0.0105, 0.0242, 0.083]


@pytest.mark.parametrize("Z", [8, 12])
def test_wimax_like_alist_equals_jax(Z, tmp_path):
    write_alist(wimax_like(Z, seed=5), str(tmp_path / "port.alist"))
    j_write_alist(j_wimax_like(Z, seed=5), str(tmp_path / "jax.alist"))
    assert (tmp_path / "port.alist").read_bytes() \
        == (tmp_path / "jax.alist").read_bytes()


def test_wimax_like_alist_equals_the_committed_n4608(tmp_path):
    path = tmp_path / "wimax_like_n4608_z192.alist.txt"
    write_alist(wimax_like(192, seed=5), str(path))
    assert path.read_bytes() == (EXAMPLES / "big_code" / path.name).read_bytes()


def test_envelope_trip_model_equals_jax():
    """The envelope's trip model of one probe batch, against the JAX
    package's ``two_phase_trip_model`` on the same per-frame arrays at the
    kernel's block (``ex.lanes``)."""
    code = load_code("builtin:wimax_1152_0.5.alist.txt")
    ex = two_phase_envelope.envelope_executors(code, 64, "cpu")["off"]
    key, snr = 123, 1.0
    m = two_phase_envelope.trip_model_of(ex, snr, key)
    block, _ = ex.step(key, ex.consts(snr), 0)
    conv, ok = block.conv_iter.numpy(), block.ok.numpy()
    assert 0 < ok.sum() < ok.size
    assert m == j_trip_model(conv, ok, 6, 12, lanes=ex.lanes)
    for lanes in (2, 8):
        assert two_phase_trip_model(conv, ok, 6, 12, lanes=lanes) \
            == j_trip_model(conv, ok, 6, 12, lanes=lanes)


def test_five_se_pooled():
    from ldpc_tpu_torch.scripts.study import five_se

    c = five_se(0, 2048, 60, 20000)
    p = 60 / 22048
    assert c["five_se"] == 5 * np.sqrt(p * (1 - p) * (1 / 2048 + 1 / 20000))
    assert c["within"] and c["gap"] == 60 / 20000
    assert not five_se(100, 1000, 10, 1000)["within"]
    assert five_se(0, 64, 0, 20000)["within"]


def test_smem_plan_of_the_big_codes():
    """K1's and K3's block at n=4608 under both schedules and E stores: the
    fused plan's bytes, fitting a block; no occupancy off the card."""
    from ldpc_tpu_torch.models.alist import read_alist
    from ldpc_tpu_torch.models.qc import detect_qc, paired_layer_groups
    from ldpc_tpu_torch.ops.decode_loop import build_tables
    from ldpc_tpu_torch.ops.mc_kernels import fused_plan

    qc = detect_qc(read_alist(str(EXAMPLES / "big_code"
                                  / "wimax_like_n4608_z192.alist.txt")))
    plan = big_code_study.smem_plan(qc, torch.device("cpu"))
    assert sorted(plan) == sorted(f"{k}/{s}/{e}" for k in ("K1", "K3")
                                  for s in ("layered", "flooding")
                                  for e in ("f32", "int8"))
    layered = fused_plan(build_tables(qc, paired_layer_groups(qc)))
    assert plan["K1/layered/f32"]["bytes"] == layered.smem
    assert plan["K3/layered/f32"]["threads"] == layered.threads == 384
    assert all(v["fits"] and v["blocks_per_sm"] is None
               for v in plan.values())
    assert plan["K1/flooding/int8"]["bytes"] < plan["K1/flooding/f32"]["bytes"]


def test_on_kernel_routes():
    assert big_code_study.on_kernel("cuda+fused+layered+paired+ce2")
    assert big_code_study.on_kernel("cpu+layered+paired")
    assert not big_code_study.on_kernel("torch+layered+paired")


# ------------------------------------------------------------- the mains ----

def test_family_atlas(tmp_path, monkeypatch):
    monkeypatch.setattr(standards, "builtin_names",
                        lambda: [N32, "BCH_7_4_1_strip.alist.txt"])
    out = tmp_path / "fa"
    rc = family_atlas.main(["--blocks", "64", "--iterations", "4",
                            "--out-dir", str(out)], **CPU)
    with open(out / "atlas.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    with open(EXAMPLES / "family_atlas" / "atlas.csv", newline="") as f:
        header = next(csv.reader(f))
    assert list(rows[0]) == header
    assert [float(r["snr_db"]) for r in rows] == family_atlas.snr_grid(0.5)
    assert {r["code"] for r in rows} == {N32}  # BCH is not QC
    assert all(int(r["blocks"]) == 64 for r in rows)
    text = (out / "RESULTS.md").read_text()
    assert text.startswith("# Builtin-family waterfall atlas")
    assert "1 QC codes, 6 SNR points" in text
    assert "points within 5 combined standard errors" in text
    held = family_atlas.atlas_vs_record(
        [dict(r, fer=float(r["fer"]), snr_db=float(r["snr_db"]),
              blocks=int(r["blocks"])) for r in rows])
    assert len(held) == 6
    assert rc == (0 if all(c["within"] for c in held) else 1)


def test_big_code_study(tmp_path, monkeypatch):
    """At Z=8 (n=192: no committed record, nothing to compare) through the
    fused path and the S-random chain, started outside the checkout (the
    record's codes are read all the same); a second run merges into its own
    results.json."""
    monkeypatch.setitem(big_code_study.SNR_GRID, 8, (1.0, 2.0, 1.0))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "bc"
    argv = ["--zs", "8", "--batch", "64", "--n-batches", "1", "--n-windows",
            "1", "--max-blocks", "128", "--target-errors", "5", "--out",
            str(out)]
    assert big_code_study.main(argv, **CPU) == 0
    res = json.loads((out / "results.json").read_text())
    entry = res["codes"]["wimax_like_n192_z8"]
    rec = record("big_code", "results.json")["codes"]["wimax_like_n4608_z192"]
    jax_keys = set(rec) - {"vmem_plan", "vmem_plan_note",
                           "ceiling_info_bits_per_s", "pct_of_ceiling"}
    assert jax_keys | {"smem_plan", "alist_equals_record"} == set(entry)
    assert set(rec["perf"]) <= set(entry["perf"])
    assert entry["alist_equals_record"] is None
    assert entry["perf"]["kernel"].startswith("cpu+fused+layered+paired+ce2")
    for il in ("none", "srandom"):
        pts = entry[f"curve_{il}"]["points"]
        assert [p["snr_db"] for p in pts] == [1.0, 2.0]
        assert set(pts[0]) == set(rec[f"curve_{il}"]["points"][0])
        assert "vs_record" not in entry[f"curve_{il}"]
        curve = json.loads((out / f"curve_wimax_like_n192_z8_{il}.json")
                           .read_text())
        assert set(curve) == set(record("big_code", "curve_wimax_like_n4608"
                                        "_z192_none.json"))
    res["codes"]["kept"] = {}
    (out / "results.json").write_text(json.dumps(res))
    assert big_code_study.main(argv + ["--skip-interleaver"], **CPU) == 0
    assert set(json.loads((out / "results.json").read_text())["codes"]) \
        == {"kept", "wimax_like_n192_z8"}


def test_big_code_faults():
    entry = {"alist_equals_record": True,
             "perf": {"snr_db": 1.6, "vs_record": {"within": True}},
             "curve_none": {"vs_record": [{"snr_db": 1.0, "within": True},
                                          {"snr_db": 1.2, "within": False}]}}
    assert big_code_study.faults(entry) == ["curve none 1.20 dB"]
    entry["alist_equals_record"] = False
    assert big_code_study.faults(entry)[0] == "alist"


def test_mfu_levers(tmp_path, fast_windows, monkeypatch):
    """Started outside the checkout: the record is still found and held."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "ml"
    rc = mfu_levers.main(["--code", f"builtin:{W576}", "--iterations", "4",
                          "--batch", "32", "--n-batches", "1", "--n-windows",
                          "2", "--winner-batches", "1", "--out", str(out)],
                         **CPU)
    res = json.loads((out / "results.json").read_text())
    rec = record("mfu_levers", "results.json")
    assert set(res) == set(rec)
    assert [r["lever"] for r in res["rows"]] == [x[0] for x in
                                                 mfu_levers.LEVERS]
    for r in res["rows"]:
        assert set(r) == set(rec["rows"][0]) | {"vs_record"}
        assert r["vs_record"]["frames"] == 64
        assert r["vs_record"]["record_frames"] == 1_310_720
    assert "baseline" in res["deep"]
    assert set(res["deep"]["baseline"]) == set(rec["deep"]["baseline"])
    # 4 iterations at 2 dB: far above the 12-iteration record's FER
    assert rc == 1


def test_variant_perf_returns_1_on_a_failed_configuration(tmp_path,
                                                          fast_windows,
                                                          monkeypatch):
    monkeypatch.setattr(variant_perf, "BATCH", 32)
    out = tmp_path / "vp"
    rc = variant_perf.main(["normalized_minsum+int8msg:2:0.8125",
                            "spa+int8msg:2", "--n-batches", "1",
                            "--n-windows", "1", "--out", str(out)], **CPU)
    assert rc == 1
    rows = json.loads((out / "results.json").read_text())["rows"]
    assert rows[0]["msg_store"] == "int8" and "error" not in rows[0]
    assert rows[0]["kernel"].startswith("cpu+fused+layered")
    assert "vs_record" not in rows[0]  # the record has no int8 row
    assert rows[1]["error"].startswith("ValueError: --msg-store int8")


def test_variant_perf_rows(tmp_path, fast_windows, monkeypatch):
    """Started outside the checkout: the record's table is still found."""
    monkeypatch.setattr(variant_perf, "BATCH", 32)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "vp"
    rc = variant_perf.main(["minsum:12", "minsum:2", "--n-batches", "1",
                            "--n-windows", "1", "--out", str(out)], **CPU)
    res = json.loads((out / "results.json").read_text())
    assert res["batch"] == 32
    full, short = res["rows"]
    assert full["frames"] == short["frames"] == 32
    assert "error" not in full and "vs_record" not in short  # no 2-it row
    assert full["vs_record"]["record_frames"] == 786_432
    assert full["vs_record"]["record_errors"] == round(0.083 * 786_432)
    assert rc == (0 if full["vs_record"]["within"] else 1)


def test_two_phase_envelope(tmp_path, fast_windows, monkeypatch):
    monkeypatch.setattr(two_phase_envelope, "BATCH", 32)
    out = tmp_path / "env"
    assert two_phase_envelope.main(["--snrs", "0.0,2.0", "--batches", "1",
                                    "--windows", "1", "--out", str(out)],
                                   **CPU) == 0
    res = json.loads((out / "results.json").read_text())
    rec = record("two_phase_envelope", "results.json")
    assert set(rec) <= set(res)
    assert res["batch"] == 32
    assert [p["snr_db"] for p in res["points"]] == [0.0, 2.0]
    for p in res["points"]:
        assert set(rec["points"][0]) <= set(p)
        assert p["fer_equal"]
        assert p["6"]["kernel"].endswith("+2phase(6)")
        assert p["auto_probe"]["overhead_us"] is None  # nothing timed here
    assert res["points"][0]["off"]["fer"] == 1.0


def test_envelope_paired(tmp_path, fast_windows, monkeypatch):
    monkeypatch.setattr(envelope_paired, "BATCH", 32)
    out = tmp_path / "env"
    assert envelope_paired.main(["--snrs", "3.5", "--rounds", "2",
                                 "--batches", "1", "--out", str(out)],
                                **CPU) == 0
    res = json.loads((out / "paired.json").read_text())
    rec = record("two_phase_envelope", "paired.json")
    assert set(res) == set(rec)
    assert list(res["points"]) == ["3.5"]
    assert set(res["points"]["3.5"]) == set(rec["points"]["3.5"])
    assert len(res["points"]["3.5"]["times_off_s"]) == 2


def test_two_phase_parity_needs_cuda(tmp_path):
    out = tmp_path / "tp.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        two_phase_parity.main(["--out", str(out)], **CPU)
    assert not out.exists()


def test_two_phase_parity_rows_and_gate():
    """The check's comparison on the plain versions: equal counters, the
    norm-LLR gate holding."""
    rows = two_phase_parity.parity_rows(
        [(f"builtin:{N32}", "layered", "sumproduct", 8, [1.5]),
         (f"builtin:{W576}", "flooding", "normalized-minsum", 4, [2.0])],
        64, "cpu")
    assert [r["match"] for r in rows] == [True, True]
    assert rows[0]["kernel[4]"].endswith("+2phase(4)")
    assert rows[0]["counters"]["blocks"] == 64
    assert two_phase_parity.norm_gate("cpu") == {
        "norm_llr_explicit_raises": True, "norm_llr_auto_single_phase": True}


def test_small_code_binder(tmp_path):
    out = tmp_path / "sb"
    assert small_code_binder.main(["--batches", "64,128", "--window-codewords",
                                   "256", "--rounds", "1", "--out", str(out)],
                                  **CPU) == 0
    res = json.loads((out / "binder.json").read_text())
    rec = record("sublane_fill", "binder.json")
    # the keys the JAX script writes (the record gained two from elsewhere)
    keys = {"device", "code", "snr_db", "window_codewords", "ladder",
            "isolation"}
    assert keys <= set(rec) and set(res) == keys
    assert list(res["ladder"]) == ["64", "128"]
    assert set(rec["ladder"]["4096"]) <= set(res["ladder"]["64"])
    iso = res["isolation"]
    # the JAX script's isolation keys, xla_us_per_batch renamed
    assert {"n_steps", "batch", "full_s", "no_kernel_s", "kernel_s",
            "kernel_us_per_batch", "step_ops_us_per_batch"} <= set(iso)
    assert {"n_steps", "batch", "kernel_us_per_batch",
            "xla_us_per_batch"} <= set(rec["isolation"])
    # the isolation at the window's 256 frames: one step
    assert iso["batch"] == 256 and iso["n_steps"] == 1
    assert "device_us_per_step" not in iso
    assert iso["kernel_us_per_batch"] == pytest.approx(
        (iso["full_s"] - iso["no_kernel_s"]) * 1e6)


@pytest.mark.parametrize("queued", [True, False])
def test_small_code_binder_device_time_needs_a_full_queue(tmp_path,
                                                          monkeypatch,
                                                          queued):
    """The device's time a step is kept only where the host queued every
    group of steps before its spin ended; else it is left out and ``main``
    returns 1."""
    def timed(self, with_kernel, rounds):
        return {"host_s": 2.0, "host_times": [2.0], "device_s": 0.5,
                "device_times": [0.5],
                "queued_before_spin_ended": queued or with_kernel}

    monkeypatch.setattr(small_code_binder.Isolation, "time", timed)
    out = tmp_path / "sb"
    rc = small_code_binder.main(["--batches", "64", "--window-codewords",
                                 "128", "--rounds", "1", "--out", str(out)],
                                **CPU)
    iso = json.loads((out / "binder.json").read_text())["isolation"]
    assert iso["queued_before_spin_ended"] is queued
    assert rc == (0 if queued else 1)
    if queued:
        assert iso["device_idle_share"] == 0.75
        assert iso["kernel_device_us_per_batch"] == 0.0
    else:
        assert "device_us_per_step" not in iso
        assert "device_idle_share" not in iso
