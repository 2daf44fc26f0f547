"""The port's CLI (``python -m ldpc_tpu_torch.cli``) and plot CLI on the
CPU: the JAX CLI's flag surface, its defaults, its result files and its
errors.

The two CLIs draw their noise from different generators, so the statistics
of a run are not compared here; the files are held to the JAX CLI's keys
(JSON) and header (CSV), and the reference-fidelity run to plausible values.
``--graph-stats`` and ``--list-codes`` print the same text.
"""

from __future__ import annotations

import csv
import json
import os

import pytest
import torch

from ldpc_tpu import cli as jcli
from ldpc_tpu_torch import cli as tcli
from ldpc_tpu_torch import plot_cli

torch.set_num_threads(1)

W576 = "builtin:wimax_576_0.5.alist.txt"
SMALL = ["--blocks", "64", "--batch", "64", "--iterations", "5", "--ber",
         "--fer", "--initial-snr", "3.0", "--end-snr", "3.5", "--step-snr",
         "0.5"]


def _dests(parser):
    return {a.dest: (a.default, tuple(a.option_strings))
            for a in parser._actions if a.dest != "help"}


def test_flag_surface_matches_the_jax_cli():
    """Every flag of the JAX CLI, with its default; the parsed options
    equal on a line that sets every knob."""
    assert _dests(tcli.build_parser()) == _dests(jcli.build_parser())
    argv = ["--matrix", "m", "--blocks", "7", "--iterations", "4",
            "--interleaver", "srandom", "--decoder", "normalized-minsum",
            "--speed", "0.5", "--mode", "2", "--modulation", "16",
            "--ber", "--fer", "--normalized-llr", "--encoding-method",
            "richardson-urbanke", "--ru-gap", "2", "--fidelity", "exact",
            "--kernel", "xla", "--schedule", "layered", "--layer-order",
            "paired", "--check-every", "2", "--sublane-groups", "4",
            "--minsum-alpha", "0.6,0.7", "--msg-store", "int8",
            "--two-phase", "off", "--fused", "off", "--shorten", "3",
            "--puncture", "5", "--target-errors", "9", "--profile", "tr"]
    t = tcli.options_from_args(tcli.build_parser().parse_args(argv))
    j = jcli.options_from_args(jcli.build_parser().parse_args(argv))
    assert t.__dict__ == j.__dict__


def _run_both(tmp_path, monkeypatch, argv, capsys):
    monkeypatch.setenv("LDPC_TPU_NO_COMPILE_CACHE", "1")
    out = {}
    for tag, main in (("torch", lambda a: tcli.main(a, device="cpu")),
                      ("jax", jcli.main)):
        d = tmp_path / tag
        d.mkdir()
        rc = main(argv + ["--output-json", str(d / "r.json"),
                          "--output-csv", str(d / "r.csv"), "--quiet"])
        assert rc == 0, capsys.readouterr().out
        with open(d / "r.csv", newline="", encoding="utf-8") as f:
            rows = list(csv.reader(f))
        out[tag] = (json.loads((d / "r.json").read_text()), rows)
    return out


def test_reference_fidelity_writes_the_jax_cli_files(tmp_path, monkeypatch,
                                                     capsys):
    """The CLI's default (--fidelity reference: std graph, legacy rule and
    noise) runs through the plain flooding decoder and writes JSON / CSV
    with the JAX CLI's keys and header."""
    out = _run_both(tmp_path, monkeypatch, ["--matrix", W576] + SMALL, capsys)
    (tj, tcsv), (jj, jcsv) = out["torch"], out["jax"]
    assert set(tj) == set(jj)
    assert set(tj["config"]) == set(jj["config"])
    for key in ("fidelity", "decode_graph", "check_rule", "noise_model",
                "n", "k", "blocks", "snr_range"):
        assert tj["config"][key] == jj["config"][key]
    assert tj["config"]["decode_graph"] == "std"
    assert [set(p) for p in tj["snr_points"]] == [set(p) for p in jj["snr_points"]]
    assert tcsv[0] == jcsv[0] and len(tcsv) == len(jcsv)
    for p in tj["snr_points"]:
        assert p["total_blocks"] == 64 and 0.0 <= p["fer"] <= 1.0
    # 3.5 dB is past the reference fidelity's waterfall at this code
    assert tj["snr_points"][-1]["fer"] < 0.25


@pytest.mark.parametrize("extra", [
    ["--decoder", "bitflipping", "--fidelity", "exact"],
    ["--encoding-method", "richardson-urbanke"],
    ["--kernel", "xla", "--fidelity", "exact", "--schedule", "layered",
     "--layer-order", "paired", "--decoder", "minsum"],
    ["--fidelity", "exact", "--sublane-groups", "4"],
])
def test_cli_runs_the_configurations_once_refused(tmp_path, extra, capsys):
    rc = tcli.main(["--matrix", W576] + SMALL + extra
                   + ["--output-json", str(tmp_path / "r.json")],
                   device="cpu")
    assert rc == 0, capsys.readouterr().out
    d = json.loads((tmp_path / "r.json").read_text())
    assert [p["total_blocks"] for p in d["snr_points"]] == [64, 64]


def test_unknown_matrix_is_a_clean_error(capsys):
    assert tcli.main(["--matrix", "no_such_code.alist.txt"], device="cpu") == 1
    assert "Error: matrix not found" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--mesh", "batch=2"], ["--distributed"],
                                  ["--failure-profile", "f.json"]])
def test_unported_flags_exit_with_an_error(flag, capsys, tmp_path,
                                           monkeypatch):
    """The three flags are ported: each exits with the JAX CLI's error where
    the JAX CLI errs, and runs where it runs. One process is one rank, so
    ``--mesh batch=2`` does not cover it; ``--distributed`` with nothing
    set stays one process; ``--failure-profile`` writes its JSON."""
    monkeypatch.chdir(tmp_path)
    argv = ["--matrix", W576] + SMALL + flag
    rc = tcli.main(argv, device="cpu")
    out = capsys.readouterr().out
    if flag[0] == "--mesh":
        assert rc == 1
        assert "Error: Mesh {'batch': 2} does not cover 1 devices" in out
        with pytest.raises(SystemExit, match="bad --mesh part"):
            tcli.main(["--matrix", W576, "--mesh", "batch"], device="cpu")
        with pytest.raises(SystemExit, match="bad --mesh part"):
            jcli.main(["--matrix", W576, "--mesh", "batch"])
    elif flag[0] == "--distributed":
        assert rc == 0
        assert "--distributed: single-process fallback" in out
    else:
        assert rc == 0
        assert set(json.loads((tmp_path / "f.json").read_text())) == \
            {"3.0", "3.5"}


def test_missing_matrix_and_list_codes(capsys, monkeypatch):
    monkeypatch.setenv("LDPC_TPU_NO_COMPILE_CACHE", "1")
    assert tcli.main([], device="cpu") == 1
    assert "--matrix is required" in capsys.readouterr().out
    assert tcli.main(["--list-codes"], device="cpu") == 0
    t = capsys.readouterr().out
    assert jcli.main(["--list-codes"]) == 0
    assert t == capsys.readouterr().out


def test_graph_stats_prints_the_jax_cli_json(capsys, monkeypatch):
    monkeypatch.setenv("LDPC_TPU_NO_COMPILE_CACHE", "1")
    argv = ["--matrix", "builtin:CCSDS_ldpc_n32_k16.alist.txt",
            "--graph-stats", "--fidelity", "exact"]
    assert tcli.main(argv, device="cpu") == 0
    t = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert json.loads(t) == json.loads(capsys.readouterr().out)


def test_profile_writes_a_trace(tmp_path, capsys):
    trace = tmp_path / "trace"
    rc = tcli.main(["--matrix", W576, "--blocks", "64", "--batch", "64",
                    "--iterations", "3", "--initial-snr", "3.0", "--end-snr",
                    "3.0", "--fidelity", "exact", "--profile", str(trace),
                    "--quiet"], device="cpu")
    assert rc == 0, capsys.readouterr().out
    files = os.listdir(trace)
    assert files and all(f.endswith(".json") for f in files)


def test_adaptive_cli_and_plots(tmp_path, capsys):
    """--adaptive through the CLI, its plots, and the plot CLI's dashboard
    of the saved JSON."""
    out = tmp_path / "r.json"
    rc = tcli.main(["--matrix", W576, "--adaptive", "--blocks", "64",
                    "--batch", "64", "--iterations", "5", "--ber", "--fer",
                    "--initial-snr", "0", "--end-snr", "1", "--step-snr", "1",
                    "--output-json", str(out), "--plot-save", str(tmp_path),
                    "--quiet"], device="cpu")
    assert rc == 0, capsys.readouterr().out
    d = json.loads(out.read_text())
    assert [e["interleaver"] for e in d["adaptation_log"]] == ["none", "random"]
    assert (tmp_path / "dashboard.png").is_file()
    assert (tmp_path / "adaptation_history.png").is_file()
    dash = tmp_path / "dash"
    assert plot_cli.main([str(out), "--dashboard", "--output-dir", str(dash),
                          "--no-show"]) == 0
    assert (dash / "dashboard.png").is_file()
