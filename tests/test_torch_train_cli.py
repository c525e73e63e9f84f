"""The port's training CLI (``python -m repro_torch.launch.train``) against
the reference's (``python -m repro.launch.train``), in-process on the CPU
at reduced width (``--trim --device cpu``).

- The ``arch=``, ``wire accounting:`` and ``topology=`` lines equal the
  reference CLI's for the same flags, exactly: they are functions of
  shapes and numpy (the graph, Ω, λ2, the lowering ``plan_mixer`` picks,
  the measured and closed-form bytes), on a ring, a time-varying
  geometric graph with per-layer pipelines, a k-regular graph under
  DSGLD, a torus under CF-FL and the full graph.
- The same run prints the reference's round and eval lines, writes bank
  snapshots that the port's ``launch.serve`` serves and the reference's
  ``load_bank`` reads, and a final checkpoint.
- Each flag of a path the port does not run yet exits naming its ROADMAP
  item; the transport's, the participation model's and the drift's flags
  run, their ``transport:``, ``airtime budget:``, ``participation:``,
  ``drift:``, ``transport accounting:``, ``arq accounting:`` and
  ``participation rates:`` lines equal to the reference CLI's.
"""
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_bank as jax_load_bank
from repro.launch import train as jax_train
from repro_torch.checkpoint import load_bank, load_checkpoint_tree
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.utils.tree import tree_leaves

import torch_threads  # noqa: F401  (one torch thread a process)

BASE = ["--arch", "lenet-radar", "--trim", "--nodes", "5", "--rounds", "1",
        "--local-steps", "1", "--batch", "2", "--pool", "8", "--log-every",
        "1"]
RUNS = {
    "ring": [],
    "geometric-tv-layers": ["--topology", "geometric", "--radius", "0.5",
                            "--link-failure", "0.1", "--gossip-pairs", "2",
                            "--fused-compress", "--layer-pipelines",
                            "fc1=block_topk|qsgd;*=block_topk"],
    "k_regular-dsgld": ["--topology", "k_regular", "--degree", "2",
                        "--algorithm", "dsgld"],
    "torus-cffl-pipeline": ["--topology", "torus", "--nodes", "6",
                            "--algorithm", "cffl", "--pipeline",
                            "block_topk|qsgd", "--layer-pipelines",
                            "conv=qsgd"],
    "full": ["--topology", "full", "--compressor", "topk"],
}
HEADS = ("arch=", "wire accounting:", "topology=")
LINK_HEADS = ("transport:", "airtime budget:", "participation:", "drift:")
ACCOUNTING = ("transport accounting:", "arq accounting:",
              "participation rates:")


def _lines(capsys, fn):
    capsys.readouterr()
    fn()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("run", list(RUNS))
def test_cli_prints_the_reference_cli_lines(run, capsys, monkeypatch):
    argv = BASE + RUNS[run]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    want = _lines(capsys, jax_train.main)
    got = _lines(capsys, lambda: port_train.main(argv + ["--device", "cpu"]))
    heads = [ln for ln in want if ln.startswith(HEADS)]
    assert len(heads) == (2 if "dsgld" in run else 3)
    assert [ln for ln in got if ln.startswith(HEADS)] == heads
    assert any(ln.startswith("round    1 loss=") for ln in got)


def test_cli_snapshots_are_served(tmp_path, capsys):
    """Two eval segments with a bank of 2: the eval lines, two bank
    snapshots, the final checkpoint; the port's serving CLI serves the last
    snapshot and the reference's ``load_bank`` reads it bit for bit."""
    ckpt = str(tmp_path / "ckpt")
    argv = BASE + ["--rounds", "4", "--topology", "geometric", "--radius",
                   "0.5", "--link-failure", "0.1", "--gossip-pairs", "2",
                   "--bank-capacity", "2", "--burn-in", "1", "--eval-every",
                   "2", "--eval-examples", "16", "--ckpt-dir", ckpt,
                   "--device", "cpu"]
    out = _lines(capsys, lambda: port_train.main(argv))
    evals = [ln for ln in out if ln.startswith("eval  round")]
    assert [ln.split()[2] for ln in evals] == ["2", "4"]
    assert "[clean@1] S=1" in evals[0] and "[clean@1] S=2" in evals[1]
    snaps = [ln for ln in out if ln.startswith("bank snapshot:")]
    assert len(snaps) == 2 and snaps[0].endswith("bank_00000002 (S=1)")
    assert snaps[-1].endswith("bank_00000004 (S=2)")
    assert out[-1].startswith("saved ") and out[-1].endswith("ckpt_00000004")
    mine = load_bank(ckpt, device="cpu")
    theirs = jax_load_bank(ckpt)
    for a, b in zip(tree_leaves(mine), jax.tree.leaves(theirs)):
        assert a.shape[:2] == (2, 5)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    params = load_checkpoint_tree(ckpt, device="cpu")
    assert tree_leaves(params)[0].shape[0] == 5
    resps = port_serve.main(["--trim", "--device", "cpu", "--ckpt-dir", ckpt,
                             "--requests", "4", "--smoke"])
    assert len(resps) == 4 and len({r.bank_version for r in resps}) == 1


@pytest.mark.parametrize("flags,item", [
    (["--transport"], "A8"), (["--erasure", "0.1"], "A8"),
    (["--snr-db", "10"], "A8"), (["--arq"], "A8"), (["--toa"], "A8"),
    (["--mtu", "128"], "A8"),
    (["--straggler-prob", "0.1"], "A7"), (["--dead-node", "2:3"], "A7"),
    (["--drift", "gain_drift"], "A9"), (["--refresh-window", "4"], "A9"),
    (["--mesh", "2"], "A10"), (["--engine", "shard"], "A10"),
    (["--arch", "llava-next-mistral-7b"], "A12")])
def test_unported_flags_exit_naming_their_item(flags, item, capsys,
                                               monkeypatch):
    """The flags of a path the port does not run yet exit naming its
    ROADMAP item (A10, and A12 for the LM families not ported yet: the
    dense LMs train since A12 part 2). The transport's (A8), the participation
    model's (A7) and the drift's (A9) flags run since those items were
    ported: one round, whose header, link, drift and accounting lines
    equal the reference CLI's."""
    argv = [a for a in BASE if a != "--trim"] + ["--trim", "--device", "cpu"]
    if item in ("A8", "A7", "A9"):
        run = BASE + flags
        monkeypatch.setattr(sys, "argv", ["train"] + run)
        want = _lines(capsys, jax_train.main)
        got = _lines(capsys, lambda: port_train.main(run + ["--device",
                                                            "cpu"]))
        keep = lambda lines: [ln for ln in lines if ln.startswith(
            HEADS + LINK_HEADS + ACCOUNTING)]
        assert keep(got) == keep(want)
        assert len(keep(want)) >= 3
        assert any(ln.startswith("round    1 loss=") for ln in got)
        return
    if flags[0] == "--arch":
        argv = argv[2:]
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        port_train.main(argv + flags)
