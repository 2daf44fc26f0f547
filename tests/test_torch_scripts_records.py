"""The EXIT-chart example (``ldpc_tpu_torch.scripts.exit_charts``) and the
CLI-made records (``ldpc_tpu_torch.scripts.cli_records``) on the CPU.

``exit_charts.main`` writes thresholds equal to the committed
``examples/exit_charts/exit_thresholds.json`` and to the JAX package's
``exit_threshold`` on the same graphs (rounded to 3 decimals, as the
example stores them), with or without matplotlib, and writes nothing under
``examples/``. ``cli_records`` builds the READMEs' recipes from the records'
own configs (the parsed options equal, apart from the output path), holds a
record's points at a tiny size (``device="cpu"``: the plain versions of K1
and K3), and its ``main`` returns 1 on a point far from its record and on a
recipe that fails. The density-evolution table parses into its five rates,
and its bar is checked on given thresholds.

Tolerance: none; thresholds after rounding, parsed options, row counts and
return codes are equal.
"""

from __future__ import annotations

import json
import shlex
import sys
from pathlib import Path

import pytest
import torch

from ldpc_tpu.analysis import exit_threshold as j_exit_threshold
from ldpc_tpu.analysis import regular_protograph as j_regular_protograph
from ldpc_tpu.models.qc import detect_qc as j_detect_qc
from ldpc_tpu.models.standards import wimax as j_wimax
from ldpc_tpu_torch.cli import build_parser
from ldpc_tpu_torch.scripts import cli_records, exit_charts

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
CPU = dict(device="cpu")


def tree(path: Path) -> dict:
    """Every file under ``path`` with its size and modification time."""
    return {str(p): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(path.rglob("*")) if p.is_file()}


# ------------------------------------------------------------ EXIT charts ----

def test_exit_thresholds_equal_the_record_and_the_jax_package(tmp_path):
    before = tree(EXAMPLES)
    assert exit_charts.main(["--out", str(tmp_path)], **CPU) == 0
    assert tree(EXAMPLES) == before
    got = json.loads((tmp_path / "exit_thresholds.json").read_text())
    rec = json.loads((EXAMPLES / "exit_charts" / "exit_thresholds.json")
                     .read_text())
    assert got == rec
    kw = dict(rate=0.5, lo_db=-0.5, hi_db=3.0)
    assert got["wimax_576_1/2_ga_threshold_db"] == round(
        j_exit_threshold(j_detect_qc(j_wimax(576, "1/2")), **kw), 3) == 0.631
    assert got["regular_3_6_ga_threshold_db"] == round(
        j_exit_threshold(j_regular_protograph(3, 6), **kw), 3) == 1.103
    pytest.importorskip("matplotlib")
    assert sorted(p.name for p in tmp_path.glob("*.png")) == sorted(
        p.name for p in (EXAMPLES / "exit_charts").glob("*.png"))


def test_exit_charts_without_matplotlib(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    assert exit_charts.main(["--out", str(tmp_path)], **CPU) == 0
    assert "charts skipped: matplotlib is not installed" in \
        capsys.readouterr().out
    assert [p.name for p in tmp_path.iterdir()] == ["exit_thresholds.json"]


def test_exit_charts_returns_1_when_a_threshold_differs(tmp_path, monkeypatch):
    rec = json.loads(exit_charts.RECORD.read_text())
    rec["regular_3_6_ga_threshold_db"] = 1.2
    doctored = tmp_path / "record.json"
    doctored.write_text(json.dumps(rec))
    monkeypatch.setattr(exit_charts, "RECORD", doctored)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert exit_charts.main(["--out", str(tmp_path / "out")], **CPU) == 1


# ------------------------------------------------------------ the recipes ----

def readme_argv(readme: Path) -> list[str]:
    """The README's first ``python -m ldpc_tpu.cli`` command, its flags."""
    lines = readme.read_text().splitlines()
    i = next(i for i, l in enumerate(lines)
             if l.startswith("python -m ldpc_tpu.cli"))
    cmd = []
    for line in lines[i:]:
        cmd.append(line.rstrip("\\").strip())
        if not line.endswith("\\"):
            break
    return shlex.split(" ".join(cmd))[3:]


@pytest.mark.parametrize("record, target, argv", [
    ("wimax1152_waterfall/rate_0.66B.json", 200, [
        "--matrix", "builtin:wimax_1152_0.66B.alist.txt",
        "--decoder", "sumproduct", "--blocks", "400000", "--batch", "8192",
        "--iterations", "16", "--ber", "--fer", "--speed", "0.6667",
        "--fidelity", "exact", "--schedule", "layered", "--seed", "0",
        "--target-errors", "200", "--initial-snr", "1.5", "--end-snr", "3.5",
        "--step-snr", "0.5", "--output-json", "OUT"]),
    ("decoder_variants/normalized-minsum.json", 150, [
        "--matrix", "builtin:wimax_1152_0.5.alist.txt",
        "--decoder", "normalized-minsum", "--blocks", "300000", "--batch",
        "8192", "--iterations", "16", "--ber", "--fer", "--speed", "0.5",
        "--fidelity", "exact", "--schedule", "flooding", "--seed", "0",
        "--target-errors", "150", "--initial-snr", "1.5", "--end-snr", "3.0",
        "--step-snr", "0.5", "--output-json", "OUT"]),
])
def test_recipe_argv_is_the_readme_recipe(record, target, argv):
    path = EXAMPLES / record
    config = json.loads(path.read_text())["config"]
    ours = cli_records.recipe_argv(config, target_errors=target,
                                   output_json="OUT")
    assert ours == argv
    assert (path, target) in cli_records.RECIPES
    readme = readme_argv(path.parent / "README.md")
    parser = build_parser()
    got, want = vars(parser.parse_args(ours)), vars(parser.parse_args(readme))
    assert want.pop("output_json").endswith(".json")
    assert got.pop("output_json") == "OUT"
    assert got == want


def test_recipes_cover_the_nine_records():
    names = sorted(p.relative_to(EXAMPLES).as_posix()
                   for p, _ in cli_records.RECIPES)
    assert names == sorted(
        [f"wimax1152_waterfall/{p.name}"
         for p in (EXAMPLES / "wimax1152_waterfall").glob("rate_*.json")]
        + [f"decoder_variants/{p.name}"
           for p in (EXAMPLES / "decoder_variants").glob("*.json")])
    points = sum(len(json.loads(p.read_text())["snr_points"])
                 for p, _ in cli_records.RECIPES)
    assert points == 41


def test_hold_record_returns_a_row_per_point(tmp_path):
    """sumproduct.json with its config's batch cut to 32 frames."""
    rec = json.loads((EXAMPLES / "decoder_variants" / "sumproduct.json")
                     .read_text())
    rec["config"]["batch"] = 32
    path = tmp_path / "record" / "sumproduct.json"
    path.parent.mkdir()
    path.write_text(json.dumps(rec))
    rows = cli_records.hold_record(path, target_errors=5, blocks=96,
                                   out_dir=tmp_path / "out", **CPU)
    points = rec["snr_points"]
    assert [r["snr_db"] for r in rows] == [p["snr_db"] for p in points]
    for r, p in zip(rows, points):
        assert r["record_errors"] == p["failed_blocks"]
        assert r["record_frames"] == p["total_blocks"]
        assert 32 <= r["frames"] <= 96 and r["seconds"] > 0
        assert (r["layer_order"], r["check_every"]) == ("serial", 1)
    assert (tmp_path / "out" / path.name).is_file()


def doctored(tmp_path: Path, **config) -> Path:
    """sumproduct.json cut to one point at 2.5 dB, 64 frames of wimax 576,
    its record FER moved to 1 (the port decodes nearly every frame)."""
    rec = json.loads((EXAMPLES / "decoder_variants" / "sumproduct.json")
                     .read_text())
    rec["config"].update({"matrix_path": "builtin:wimax_576_0.5.alist.txt",
                          "blocks": 64, "batch": 32,
                          "snr_range": [2.5, 2.5, 0.5], **config})
    rec["snr_points"] = [dict(rec["snr_points"][2], failed_blocks=8192,
                              total_blocks=8192, fer=1.0)]
    path = tmp_path / "doctored.json"
    path.write_text(json.dumps(rec))
    return path


@pytest.fixture
def no_de(tmp_path, monkeypatch):
    readme = tmp_path / "README.md"
    readme.write_text("no threshold table\n")
    monkeypatch.setattr(cli_records, "DE_README", readme)


def test_main_returns_1_on_a_point_far_from_its_record(tmp_path, monkeypatch,
                                                       no_de, capsys):
    monkeypatch.setattr(cli_records, "RECIPES", ((doctored(tmp_path), 5),))
    out = tmp_path / "out"
    assert cli_records.main(["--out", str(out)], **CPU) == 1
    res = json.loads((out / "results.json").read_text())
    (point,) = res["points"]
    assert point["snr_db"] == 2.5 and not point["within"]
    assert point["gap"] > point["five_se"]
    assert "| doctored.json | 2.5 |" in (out / "RESULTS.md").read_text()
    assert "1 points outside 5 se" in capsys.readouterr().out


@pytest.mark.parametrize("how", ["cli exits 1", "hold_record raises"])
def test_main_returns_1_when_a_recipe_fails(how, tmp_path, monkeypatch, no_de):
    good = EXAMPLES / "decoder_variants" / "sumproduct.json"
    if how == "cli exits 1":
        bad = doctored(tmp_path, matrix_path="builtin:no_such_code.alist.txt")
    else:
        bad = good

        def hold_record(*a, **kw):
            raise ValueError("a recipe that raises")

        monkeypatch.setattr(cli_records, "hold_record", hold_record)
    monkeypatch.setattr(cli_records, "RECIPES", ((bad, 5), (good, 5)))
    out = tmp_path / "out"
    assert cli_records.main(["--out", str(out)], **CPU) == 1
    res = json.loads((out / "results.json").read_text())
    assert res["failed_recipe"] and res["recipes"] == [] and res["de"] == []


# ------------------------------------------------ the density-evolution table ----

def test_de_table_parses_five_rates():
    assert cli_records.de_table(cli_records.DE_README.read_text()) == {
        "1/2": 0.84, "2/3B": 1.72, "3/4A": 2.22, "3/4B": 2.09, "5/6": 2.84}


@pytest.mark.parametrize("record, thresholds, held", [
    (0.84, [0.84375, 0.78125, 0.90625], True),
    (0.84, [0.90625, 0.96875, 0.90625], True),    # 0.066 below the least
    (0.84, [0.93125, 0.96875, 1.0], False),
    (0.84, [0.71875, 0.75, 0.765], True),         # 0.075 above the most
    (0.84, [0.65625, 0.71875, 0.75], False),
    (2.84, [2.84375] * 3, True),
])
def test_de_bar(record, thresholds, held):
    assert cli_records.de_held(record, thresholds) is held


def test_de_rate_at_a_tiny_size(monkeypatch):
    monkeypatch.setattr(cli_records, "DE", dict(
        cli_records.DE, iterations=20, n_samples=500, tol_db=0.5))
    monkeypatch.setattr(cli_records, "DE_SEEDS", (0, 1))
    d = cli_records.de_rate("1/2", 0.84, **CPU)
    assert len(d["thresholds_db"]) == 2
    assert all(0.0 < t < 4.0 for t in d["thresholds_db"])
    assert d["bar_db"] == [min(d["thresholds_db"]) - 0.5,
                           max(d["thresholds_db"]) + 0.5]
    assert d["held"] == cli_records.de_held(0.84, d["thresholds_db"])
