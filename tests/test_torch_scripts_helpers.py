"""What the ported study scripts (``ldpc_tpu_torch/scripts/``) copy from the
JAX package's ``scripts/`` and what they share with it, held on the same
inputs: ``ops.metrics.count_block_metrics``, the burst study's adversarial
permutation (also against the committed ``adversarial_pi.npy``) and Wilson
interval, the QC orbit keys of the committed witnesses, the importance
dictionary of the committed census, the perf matrix's rows and README
table, the message grids of the precision study, ``utils.cache`` and the
two launchers.

The JAX scripts are loaded from ``scripts/`` with
``importlib.util.spec_from_file_location``.

Tolerance: none, except SPA with bf16 messages. Counters (the norm-LLR sum
over values whose partial sums are exact in float32), permutations, orbit
keys, masks, table lines and parsed options are equal; the Wilson bounds
and message grids are equal floats (the same formula in float64, resp.
float32); the min-sum precision variants decode equal frame for frame.
SPA with bf16 messages: equal decisions on >= 95% of frames, FERs within
2% (see its test).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
from collections import namedtuple
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.analysis.importance import orbit_supports as j_orbit_supports
from ldpc_tpu.models.qc import qc_orbit_canonical as j_canonical
from ldpc_tpu.ops.metrics import count_block_metrics as j_count
from ldpc_tpu.sim.runner import load_code as jload
from ldpc_tpu_torch.analysis.importance import orbit_supports
from ldpc_tpu_torch.models.qc import qc_orbit_canonical
from ldpc_tpu_torch.ops import build
from ldpc_tpu_torch.ops.metrics import count_block_metrics
from ldpc_tpu_torch.scripts import burst_interleaver_study as tburst
from ldpc_tpu_torch.scripts.family_validation import LAYERED_TARGETS
from ldpc_tpu_torch.scripts import importance_floor as timp
from ldpc_tpu_torch.scripts import perf_matrix as tpm
from ldpc_tpu_torch.scripts import quantized_messages_study as tqm
from ldpc_tpu_torch.sim.runner import load_code
from ldpc_tpu_torch.utils import cache

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
W576 = "builtin:wimax_576_0.5.alist.txt"


def jax_script(name: str):
    """A module of the JAX package's ``scripts/``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------- count_block_metrics ----

Result = namedtuple("Result", "ok est conv_iter norm_llr")


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_count_block_metrics_equals_jax(exact, masked):
    rng = np.random.default_rng(5)
    B, n, k = 96, 40, 20
    info_pos = rng.permutation(n)[:k].astype(np.int64)
    u = rng.integers(0, 2, (B, k), dtype=np.uint8)
    est = rng.integers(0, 2, (B, n), dtype=np.uint8)
    est[: B // 3, info_pos] = u[: B // 3]  # some frames decode right
    ok = rng.random(B) < 0.6
    conv = np.where(ok, rng.integers(0, 12, B), -1).astype(np.int32)
    # multiples of 1/64 below 4: every partial sum is exact in float32, so
    # the norm sum is equal whatever order the two libraries add in
    norm = (rng.integers(0, 256, B) / 64).astype(np.float32)
    valid = rng.random(B) < 0.8 if masked else None
    t = count_block_metrics(
        torch.from_numpy(u),
        Result(torch.from_numpy(ok), torch.from_numpy(est),
               torch.from_numpy(conv), torch.from_numpy(norm)),
        torch.from_numpy(info_pos), exact=exact,
        valid=None if valid is None else torch.from_numpy(valid))
    j = j_count(jnp.asarray(u),
                Result(jnp.asarray(ok), jnp.asarray(est), jnp.asarray(conv),
                       jnp.asarray(norm)),
                jnp.asarray(info_pos), exact=exact,
                valid=None if valid is None else jnp.asarray(valid))
    assert t._fields == j._fields
    for name, a, b in zip(t._fields, t, j):
        assert a.item() == np.asarray(b).item(), name


# ------------------------------------------------------------ burst study ----

@pytest.mark.parametrize("code_name,bps,seed", [
    (W576, 4, 7), (W576, 2, 0), ("builtin:CCSDS_ldpc_n32_k16.alist.txt", 4, 3)])
def test_adversarial_permutation_equals_jax(code_name, bps, seed):
    jmod = jax_script("burst_interleaver_study")
    t = tburst.adversarial_permutation(load_code(code_name), bps, seed)
    j = jmod.adversarial_permutation(jload(code_name), bps, seed)
    np.testing.assert_array_equal(t, j)
    assert t.dtype == np.int32
    assert sorted(t.tolist()) == list(range(load_code(code_name).n))


def test_adversarial_permutation_is_the_committed_one():
    committed = np.load(EXAMPLES / "burst_interleaver" / "adversarial_pi.npy")
    np.testing.assert_array_equal(
        tburst.adversarial_permutation(load_code(W576), bps=4, seed=7),
        committed)


@pytest.mark.parametrize("err,n", [(0, 0), (0, 100), (1, 7), (821, 8192),
                                   (100, 100), (3, 10 ** 6)])
def test_wilson_equals_jax(err, n):
    assert tburst.wilson(err, n) == jax_script(
        "burst_interleaver_study").wilson(err, n)


def test_burst_rows_in_the_jax_order():
    """The rows the port runs carry the labels of the committed record, in
    its order."""
    rec = json.loads((EXAMPLES / "burst_interleaver" / "results.json")
                     .read_text())
    labels = [c[0] for c in tburst.configs(Path("adv.npy"), "2,6,10,16")]
    assert labels == list(rec["rows"])


# ---------------------------------------------------------- orbit keys ----

def _witness_events():
    rec = json.loads((EXAMPLES / "error_floor" / "wimax1152" /
                      "undetected_codewords.json").read_text())
    return rec, [(e["support"], e["weight"]) for p in rec["points"]
                 for e in p["events"]]


def test_orbit_keys_of_the_committed_witnesses_equal_jax():
    rec, events = _witness_events()
    Z = rec["Z"]
    keys = [qc_orbit_canonical(s, Z) for s, _ in events]
    assert keys == [j_canonical(s, Z) for s, _ in events]
    assert all(type(v) is int for k in keys for v in k)
    # the record's orbits are the canonical keys of its events
    assert sorted(tuple(o["canonical_support"]) for o in rec["qc_orbits"]) \
        == sorted(set(keys))
    for z in (1, 4, 7):
        assert [qc_orbit_canonical(s, z) for s, _ in events[:3]] \
            == [j_canonical(s, z) for s, _ in events[:3]]


# -------------------------------------------------- importance dictionary ----

def test_importance_dictionary_from_the_committed_census():
    """The census supports the importance study reads equal the record's
    trapping supports, and the mixture over the record's whole dictionary
    equals the JAX package's, component for component."""
    census = EXAMPLES / "error_floor" / "trapping_census.json"
    rec = json.loads((EXAMPLES / "error_floor" / "importance" /
                      "results.json").read_text())
    ts = timp.census_targets(str(census), max_support=16)
    assert ts == rec["trapping_supports"]
    assert timp.census_targets("", 16) == []
    code = load_code(W576)
    supports = rec["codeword_supports"] + ts
    t = orbit_supports(supports, code.qc.Z, code.n, max_components=1024)
    j = j_orbit_supports(supports, code.qc.Z, code.n, max_components=1024)
    np.testing.assert_array_equal(t, np.asarray(j))
    assert t.shape[0] == rec["components"]


# --------------------------------------------------------- perf matrix ----

def _pm_record():
    return json.loads((EXAMPLES / "perf_matrix" / "results.json").read_text())


def test_perf_matrix_grid_equals_jax():
    jmod = jax_script("perf_matrix")
    assert tpm.CODES == jmod.CODES
    assert tpm.CONFIGS == jmod.CONFIGS


def test_perf_matrix_spread_equals_jax():
    jmod = jax_script("perf_matrix")
    rows = _pm_record()["rows"]
    assert len(rows) == 52
    stripped = [{k: v for k, v in r.items()
                 if k not in ("info_bits_per_s_mid_lo", "info_bits_per_s_mid_hi")}
                for r in rows[:4]]
    for r in rows + stripped + [{"info_bits_per_s": 1.0}]:
        assert tpm._spread_lo(r) == jmod._spread_lo(r)
        assert tpm._spread_hi(r) == jmod._spread_hi(r)


def test_perf_matrix_readme_table_equals_jax(tmp_path):
    """The README's table from the committed rows and ceilings, line for
    line (the prose around it speaks of the card)."""
    jmod = jax_script("perf_matrix")
    rec = _pm_record()
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    args = (rec["rows"], rec["ceilings"], rec["n_windows"], rec["n_batches"])
    jmod.write_readme(tmp_path / "jax", rec["device"], *args)
    tpm.write_readme(tmp_path / "port", rec["device"], *args)

    def table(p):
        return [ln for ln in (p / "README.md").read_text().splitlines()
                if ln.startswith("|")]

    assert table(tmp_path / "port") == table(tmp_path / "jax")
    assert len(table(tmp_path / "port")) == 2 + len(tpm.CODES)


# ------------------------------------------------ message precision grids ----

def test_message_grids_equal_jax():
    """The int8 grid and the bf16 rounding of the precision study, against
    the JAX script's formulas (``quantized_messages_study.py:62-69``)."""
    x = np.random.default_rng(2).normal(0, 20, 4096).astype(np.float32)
    x[:4] = [24.0, -24.0, 30.0, 0.094]
    q, step = 24.0, 2.0 * 24.0 / 255.0
    j_int8 = jnp.round(jnp.clip(jnp.asarray(x), -q, q) / step) * step
    j_bf16 = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(tqm.int8_grid(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_int8))
    np.testing.assert_array_equal(tqm.bf16_round(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_bf16))


# ------------------------------------------------------------ utils.cache ----

def test_compile_cache_default_is_the_build_directory(monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.delenv("LDPC_TPU_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("LDPC_TPU_NO_COMPILE_CACHE", raising=False)
    assert build.DEFAULT_BUILD_DIR == REPO / "build" / "ldpc_tpu_torch"
    assert cache.enable_compile_cache() == str(build.DEFAULT_BUILD_DIR)
    assert build.BUILD_DIR == build.DEFAULT_BUILD_DIR
    assert build.library_path("qc_decoder").parent == build.DEFAULT_BUILD_DIR


def test_compile_cache_moves_with_the_variable_or_the_path(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.delenv("LDPC_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("LDPC_TPU_COMPILE_CACHE", str(tmp_path / "env"))
    assert cache.enable_compile_cache() == str(tmp_path / "env")
    assert (tmp_path / "env").is_dir()
    assert build.library_path("mc_decoder").parent == tmp_path / "env"
    assert cache.enable_compile_cache(str(tmp_path / "arg")) \
        == str(tmp_path / "arg")
    assert build.BUILD_DIR == tmp_path / "arg"


def test_no_compile_cache_builds_into_a_fresh_directory(monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setenv("LDPC_TPU_NO_COMPILE_CACHE", "1")
    assert cache.enable_compile_cache() is None
    first = build.BUILD_DIR
    assert cache.enable_compile_cache() is None
    assert build.BUILD_DIR != first
    for d in (first, build.BUILD_DIR):
        assert d.is_dir() and not any(d.iterdir())
        assert d != build.DEFAULT_BUILD_DIR


# -------------------------------------------------------------- launchers ----

FAKE_PYTHON = """#!/bin/sh
for a in "$@"; do printf '%s\\n' "$a"; done
"""


def _launcher_args(script: Path, tmp_path: Path, *extra) -> list[str]:
    """The arguments a launcher hands ``python``: a stand-in ``python`` on
    ``PATH`` prints them, one per line."""
    fake = tmp_path / "bin"
    fake.mkdir(exist_ok=True)
    (fake / "python").write_text(FAKE_PYTHON)
    (fake / "python").chmod(0o755)
    env = dict(os.environ, PATH=f"{fake}:{os.environ['PATH']}")
    out = subprocess.run(["bash", str(script), *extra], env=env, check=True,
                         capture_output=True, text=True, timeout=60).stdout
    return out.splitlines()


@pytest.mark.parametrize("name,extra", [
    ("run_ldpc", ()), ("run_ldpc", ("builtin:wimax_576_0.5.alist.txt",
                                     "richardson-urbanke", "4")),
    ("run_ldpc_advanced", ()), ("run_ldpc_advanced", ("builtin:wimax_576_0.5"
                                                      ".alist.txt", "out"))])
def test_launchers_parse_to_the_same_options(name, extra, tmp_path):
    from ldpc_tpu import cli as jcli
    from ldpc_tpu_torch import cli as tcli

    port = _launcher_args(REPO / "ldpc_tpu_torch" / "scripts" / f"{name}.sh",
                          tmp_path, *extra)
    ref = _launcher_args(REPO / "scripts" / f"{name}.sh", tmp_path, *extra)
    assert port[:2] == ["-m", "ldpc_tpu_torch.cli"]
    assert ref[:2] == ["-m", "ldpc_tpu.cli"]
    assert port[2:] == ref[2:]
    t = tcli.options_from_args(tcli.build_parser().parse_args(port[2:]))
    j = jcli.options_from_args(jcli.build_parser().parse_args(ref[2:]))
    assert vars(t) == vars(j)


@pytest.mark.parametrize("name", ["nms-int8msg", "spa-f32-bf16msg", "nms-f32"])
def test_precision_variants_decode_as_jax(name):
    """The study's decoder variants through both packages' plain flooding
    decoders on the same LLRs (wimax 576, 256 frames, 20 iterations, the
    all-zero codeword at Eb/N0 1.4 dB): the min-sum variants equal frame for
    frame; SPA with bf16 messages equal decisions on >= 95% of frames and
    FERs within 2% (tanh and log differ by ulps between libraries, and
    a one-ulp difference of an f32 message can move its bf16 rounding by a
    whole bf16 step, 2^-8 relative)."""
    from ldpc_tpu.ops.spa import make_decoder as j_make_decoder
    from ldpc_tpu_torch.ops.spa import make_decoder

    code = load_code(W576)
    jcode = jload(W576)
    info = code.standard_encode_spec.info_pos("orig")
    rng = np.random.default_rng(11)
    # the all-zero codeword through BPSK at sigma 0.85 (Eb/N0 1.4 dB at rate
    # 1/2); LLR > 0 means bit 1
    sigma = 0.85
    llr = (-2.0 / sigma ** 2 * (1.0 + rng.normal(0, sigma, (256, code.n)))
           ).astype(np.float32)
    kw = dict(tqm.VARIANTS[name])
    jkw = dict(kw)
    if "quantize_msgs" in kw:
        jkw["quantize_msgs"] = {
            tqm.int8_grid: lambda M: jnp.round(
                jnp.clip(M, -24.0, 24.0) / (48.0 / 255.0)) * (48.0 / 255.0),
            tqm.bf16_round: lambda M: M.astype(jnp.bfloat16).astype(
                jnp.float32),
        }[kw["quantize_msgs"]]
    t = make_decoder(code.layout("orig"), info, 20, rule="exact",
                     device="cpu", **kw)(torch.from_numpy(llr))
    j = j_make_decoder(jcode.layout("orig"), info, 20, rule="exact",
                       **jkw)(jnp.asarray(llr))
    same = (t.est.numpy() == np.asarray(j.est)).all(axis=1) \
        & (t.ok.numpy() == np.asarray(j.ok))
    if name.startswith("nms"):
        assert same.all()
        np.testing.assert_array_equal(t.conv_iter.numpy(),
                                      np.asarray(j.conv_iter))
    else:
        assert same.mean() >= 0.95
        assert abs(t.ok.numpy().mean() - np.asarray(j.ok).mean()) <= 0.02
    assert 0 < t.ok.numpy().mean() < 1  # the point has failures to match


# ------------------------------------------------------- parity replays ----

@pytest.mark.parametrize("snr", [7.0, 9.0])
def test_parity_replay_noise_equals_jax(snr):
    """The mode-3 noise rows of the fixed-noise replay equal the JAX
    script's construction (``parity_fixed_noise.py:72-83``) from the JAX
    package's Park-Miller copy and channel constants, element for element."""
    from ldpc_tpu.ops.channel import ChannelParams as JParams
    from ldpc_tpu.utils.legacy_rng import IDUM1, IDUM2, ParkMillerGauss
    from ldpc_tpu_torch.ops.channel import ChannelParams
    from ldpc_tpu_torch.scripts import parity_fixed_noise

    B, n = 3, 576
    kw = dict(mode=3, snr_db=snr, speed=1.0, interference_snr_db=6.0, p=0.1)
    t = parity_fixed_noise.replay_noise(ChannelParams(**kw), B, n)
    prm = JParams(**kw)
    n1 = ParkMillerGauss(IDUM1, prm.sigma1).gauss_sequence(B * n)
    n2 = ParkMillerGauss(IDUM2, prm.sigma2).gauss_sequence(B * n)
    j = ((n1 + prm.p * n2) * prm.l_c3).reshape(B, n)
    np.testing.assert_array_equal(t, j)


# ------------------------------------------- chip_smoke's record readers ----

def test_chip_smoke_reads_the_committed_markdown_records():
    """Phase 14 reads the precision study's and the family validation's
    TPU records from their markdown tables."""
    import chip_smoke

    q = chip_smoke.md_table(chip_smoke.QUANT_REC.read_text(), "Eb/N0 (dB)")
    assert list(q) == ["1.5", "2.0", "2.5", "3.0"]
    assert q["2.0"] == ["1.130e-02", "2.800e-02", "1.125e-02", "3.147e-02",
                        "3.208e-02"]
    text = chip_smoke.FAMILY_REC.read_text()
    flood = chip_smoke.md_table(text, "code | n | k")
    layered = chip_smoke.md_table(text, "code | n | Z")
    assert len(flood) == 118 and len(layered) == 10
    assert list(layered) == LAYERED_TARGETS
    assert flood["wimax_2304_0.83.alist.txt"][-3] == "229/256"
    assert layered["wimax_2304_0.83.alist.txt"][-3] == "253/256"
