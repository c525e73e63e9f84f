"""The scenario matrix (``repro_torch.eval.matrix``) and the evaluate CLI
(``repro_torch.launch.evaluate``) against the reference's, on the CPU at a
reduced size.

Tolerances (PERF.md §2): a cell's BMA accuracy within one example of the
reference's, its ECE within 0.01. Each cell is a training run of the
reduced LeNet from the reference's seeds; the local steps' last-bit
differences (convolution and matmul summation order) carry into the
posterior, which moves a prediction only when it sits on a tie. The
markdown's rows are compared in their format, the checkpoint's cells under
the same tolerances.
"""
import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro.eval import matrix as jmatrix
from repro_torch.eval import matrix

import torch_threads  # noqa: F401  (one torch thread a process)

SPEC = dict(algorithms=("cdbfl", "cffl"), pipelines=("",),
            cells=(("clean", 0.0), ("day23_critical", 1.0)), nodes=3,
            per_node=8, rounds=6, eval_examples=40)


def _close(got, want, n):
    assert got.scenario == want.scenario and got.severity == want.severity
    assert got.algorithm == want.algorithm and got.pipeline == want.pipeline
    assert got.report.count == want.report.count == n
    assert abs(got.report.accuracy - want.report.accuracy) <= 1.0 / n + 1e-9
    assert abs(got.report.ece - want.report.ece) <= 0.01


@pytest.fixture(scope="module")
def matrices():
    want = jmatrix.run_matrix(jmatrix.MatrixSpec(**SPEC), log=None)
    trainers = {}
    got = matrix.run_matrix(matrix.MatrixSpec(**SPEC), log=None,
                            trainers=trainers, device="cpu")
    return got, want, trainers


def test_run_matrix_cells_match_reference(matrices):
    got, want, trainers = matrices
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g, w, SPEC["eval_examples"])
        assert np.isfinite(g.report.ece) and np.isfinite(g.report.nll)
    assert set(trainers) == {("cdbfl", ""), ("cffl", "")}


def test_matrix_markdown_rows(matrices):
    got, want, _ = matrices
    md = matrix.matrix_markdown(got)
    # the same cells through the reference's formatter: the same text
    assert md == jmatrix.matrix_markdown(got)
    lines, ref_lines = md.splitlines(), jmatrix.matrix_markdown(
        want).splitlines()
    assert lines[:2] == ref_lines[:2]
    for line, ref in zip(lines[2:], ref_lines[2:]):
        cols, ref_cols = line.split(" | "), ref.split(" | ")
        assert len(cols) == len(ref_cols) == 10
        assert cols[:4] == ref_cols[:4] and cols[-1] == ref_cols[-1]
        assert cols[8][0] in "+-"
    row = got[0].row()
    assert set(row) == set(want[0].row()) and row["pipeline"] == "-"


def test_evaluate_params_matrix_on_a_checkpoint(matrices, tmp_path):
    """Node-stacked params saved by the port, scored by both packages'
    ``evaluate_params_matrix`` (each loading the checkpoint itself)."""
    from repro.checkpoint import load_checkpoint_tree as jax_load
    from repro_torch.checkpoint import load_checkpoint_tree, save_checkpoint
    _, _, trainers = matrices
    save_checkpoint(str(tmp_path), 6, trainers[("cdbfl", "")].state.params)
    cells = (("clean", 0.0), ("snr_degradation", 0.5))
    got = matrix.evaluate_params_matrix(
        load_checkpoint_tree(str(tmp_path), device="cpu"), "lenet-radar",
        cells, eval_examples=24, log=None)
    want = jmatrix.evaluate_params_matrix(jax_load(str(tmp_path)),
                                          "lenet-radar", cells,
                                          eval_examples=24, log=None)
    for g, w in zip(got, want):
        assert g.algorithm == w.algorithm == "checkpoint"
        _close(g, w, 24)


def test_looks_reduced_reads_the_meta_model():
    """Reduced and full-width params, node-stacked or not, each to its own
    config. The reference's rule (any ≥2-D shape in common with the
    reduced model) calls a full-width checkpoint reduced, since the convs,
    fc2 and fc3 have the same shapes at both widths (ROADMAP C24): the
    port requires every ≥2-D shape of the reduced model."""
    from repro_torch import random
    from repro_torch.config import get_arch
    from repro_torch.models import get_model
    for name, reduced in (("reduced", True), ("config", False)):
        params = get_model(getattr(get_arch("lenet-radar"), name)).init(
            random.PRNGKey(0, "meta"), "meta")
        assert matrix._looks_reduced(params, "lenet-radar") is reduced
        stacked = {k: {n: x[None] for n, x in v.items()}
                   for k, v in params.items()}
        assert matrix._looks_reduced(stacked, "lenet-radar") is reduced
    with pytest.raises(KeyError):
        matrix._looks_reduced(params, "no-such-arch")


ARGV = ["--rounds", "4", "--nodes", "3", "--per-node", "6",
        "--eval-examples", "24", "--algorithms", "cdbfl",
        "--scenarios", "clean,gain_drift", "--severities", "0.5",
        "--diagrams"]


def _table(text):
    return [line for line in text.splitlines() if line.startswith("|")]


def test_evaluate_cli_matches_reference_cli(tmp_path, monkeypatch):
    from repro.launch import evaluate as jcli
    from repro_torch.launch import evaluate as cli
    outs = {}
    for name, argv in (("ref", ARGV + ["--out", str(tmp_path / "r.md")]),):
        monkeypatch.setattr(sys, "argv", ["evaluate"] + argv)
        with redirect_stdout(io.StringIO()) as buf:
            jcli.main()
        outs[name] = buf.getvalue()
    with redirect_stdout(io.StringIO()) as buf:
        cells = cli.main(ARGV + ["--device", "cpu", "--out",
                                 str(tmp_path / "p.md"), "--json",
                                 str(tmp_path / "p.json")])
    got, want = buf.getvalue(), outs["ref"]
    assert len(cells) == 2
    rows, ref_rows = _table(got), _table(want)
    assert rows[:2] == ref_rows[:2] and len(rows) == len(ref_rows) == 4
    for row, ref in zip(rows[2:], ref_rows[2:]):
        cols, ref_cols = row.split(" | "), ref.split(" | ")
        assert cols[:4] == ref_cols[:4] and cols[-1] == ref_cols[-1]
        assert abs(float(cols[4]) - float(ref_cols[4])) <= 1 / 24 + 1e-9
        assert abs(float(cols[5]) - float(ref_cols[5])) <= 0.01
    assert got.count("reliability: ") == want.count("reliability: ") == 2
    assert (tmp_path / "p.md").read_text().startswith(
        "# Scenario-matrix calibration report\n\n| scenario |")
    import json
    assert [r["scenario"] for r in json.loads(
        (tmp_path / "p.json").read_text())] == ["clean", "gain_drift"]
