"""Node unlearning in the port (``FedTrainer.unlearn``, ROADMAP A9) and the
retrain oracle (``repro_torch.eval.matrix.run_unlearn_oracle``), against
the reference on the CPU at reduced width, on the host bank
(``engine="host"``) and the device bank in f32 and int8 storage
(``engine="scan"``).

- The reference's errors, in its order (out of range, then every node),
  and idempotence.
- The node's rows of v and v̄ zeroed, the other rows and the params
  untouched, the caller's old state never written; the node's bank rows
  zeroed (int8 scales 1.0), the other rows untouched.
- The chain left out of ``predictor()`` and ``eval_report`` (K - 1 chains),
  the predictions after ``unlearn`` within ``tests/test_torch_trainer.py``'s
  bounds of the reference's (BMA probabilities atol 1e-4, accuracy within
  one example, ECE within 0.01: the local steps differ from XLA's in the
  last bits).
- Training on after ``unlearn``: the scan engine equal to the host engine
  bit for bit.
- The oracle at a spec smaller than ``tests/test_unlearn.py``'s (24 rounds
  of 4 local steps, 12 maps a node, 80 eval maps; the reference takes
  about 27 s on one CPU): within tolerance on both sides; each side's
  accuracy within one example and ECE within 0.01 of the reference's, so
  |Δacc| within two examples and |ΔECE| within 0.02 of the reference's.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import repro.eval.matrix as jax_matrix
from repro.config import FedConfig as JaxFedConfig
from repro.config import get_arch as jax_get_arch
from repro.data.partition import partition_iid
from repro.data.radar import make_dataset
from repro.models import get_model as jax_get_model
from repro.train import FedTrainer as JaxFedTrainer

import repro_torch.eval.matrix as matrix
from repro_torch.config import FedConfig, get_arch
from repro_torch.core.posterior import SampleBank
from repro_torch.models import get_model
from repro_torch.train import FedTrainer
from repro_torch.utils.tree import tree_leaves

import torch_threads  # noqa: F401  (one torch thread a process)

K, ROUNDS, TARGET = 4, 8, 1
FED = dict(num_nodes=K, local_steps=2, eta=3e-3, zeta=0.3, temperature=0.2,
           rounds=ROUNDS, burn_in=4, compressor="topk", compress_ratio=0.05,
           topology="full", algorithm="cdbfl")
# the port's banks: (engine, bank_dtype); the reference run each is held to
BANKS = {"host": ("host", "float32"), "device-f32": ("scan", "float32"),
         "device-int8": ("scan", "int8")}
ECE_BOUND = 0.01


def _world():
    cfg = get_arch("lenet-radar").reduced
    shards = partition_iid(make_dataset(K * 12, hw=cfg.input_hw, day=1,
                                        seed=0), K)
    test = make_dataset(48, hw=cfg.input_hw, day=1, seed=99)
    return cfg, shards, test


def _port(bank: str, rounds: int = ROUNDS) -> FedTrainer:
    engine, dtype = BANKS[bank]
    cfg, shards, _ = _world()
    tr = FedTrainer(get_model(cfg), FedConfig(**FED), shards, minibatch=6,
                    engine=engine, bank_capacity=8, bank_thin=1,
                    bank_dtype=dtype, chunk=3, device="cpu")
    tr.run(rounds=rounds)
    return tr


def _errors(tr) -> list:
    """The messages of ``unlearn(K)``, ``unlearn(-1)`` and, after every
    node but the last is unlearned, ``unlearn(K - 1)``; unlearns nodes."""
    out = []
    for k in (K, -1):
        with pytest.raises(ValueError) as err:
            tr.unlearn(k)
        out.append(str(err.value))
    for k in range(K - 1):
        tr.unlearn(k)
    with pytest.raises(ValueError) as err:
        tr.unlearn(K - 1)
    return out + [str(err.value)]


@pytest.fixture(scope="module")
def references():
    """The reference's run of each bank dtype (its host bank for f32, its
    device bank for int8): the errors, and the BMA probabilities and report
    after ``unlearn(TARGET)``."""
    cfg, shards, test = _world()
    out = {}
    for dtype, engine in (("float32", "host"), ("int8", "scan")):
        ref = JaxFedTrainer(jax_get_model(jax_get_arch("lenet-radar").reduced),
                            JaxFedConfig(**FED), shards, minibatch=6,
                            engine=engine, bank_capacity=8, bank_thin=1,
                            bank_dtype=dtype)
        ref.run(rounds=ROUNDS)
        before = ref.eval_report(test)
        ref.unlearn(TARGET)
        rep, probs = ref.eval_report(test, return_probs=True)
        pprobs, _ = ref.predictor().predict({"x": test["x"]})
        other = copy.copy(ref)
        other._unlearned = set()
        out[dtype] = dict(before=before, report=rep, probs=probs,
                          predictor=np.asarray(pprobs),
                          errors=_errors(other))
    return out, test


def _ref_for(bank: str, references):
    out, test = references
    return out[BANKS[bank][1]], test


@pytest.mark.parametrize("bank", list(BANKS))
def test_unlearn_raises_the_references_errors_and_is_idempotent(
        bank, references):
    want, _ = _ref_for(bank, references)
    tr = _port(bank, rounds=5)
    tr.unlearn(TARGET)
    v = [x.clone() for x in tree_leaves(tr.state.v)]
    tr.unlearn(TARGET)
    assert tr.unlearned == frozenset({TARGET})
    assert all(torch.equal(a, b) for a, b in zip(v, tree_leaves(tr.state.v)))
    tr._unlearned = set()
    assert _errors(tr) == want["errors"]
    assert tr.unlearned == frozenset(range(K - 1))


def _rows(x: torch.Tensor, axis: int):
    keep = [i for i in range(K) if i != TARGET]
    return x.index_select(axis, torch.tensor(keep)), x.select(axis, TARGET)


@pytest.mark.parametrize("bank", list(BANKS))
def test_unlearn_zeroes_the_node_and_nothing_else(bank):
    tr = _port(bank)
    state = tr.state
    old = {p: [x.clone() for x in tree_leaves(getattr(state, p))]
           for p in ("params", "v", "v_bar")}
    bs = tr._bank_state
    if isinstance(bs, SampleBank):
        old_bank = [[x.clone() for x in tree_leaves(s)] for s in bs.samples]
    else:
        old_bank = [x.clone() for x in tree_leaves(bs.slots)]
        old_scales = [x.clone() for x in tree_leaves(bs.scales or {})]
    tr.unlearn(TARGET)
    for p in ("v", "v_bar"):
        for new, was in zip(tree_leaves(getattr(tr.state, p)), old[p]):
            keep, gone = _rows(new, 0)
            assert torch.equal(keep, _rows(was, 0)[0])
            assert not gone.any()
            assert bool(_rows(was, 0)[1].any())    # it held something
    for p in ("params", "v", "v_bar"):               # the old state
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(getattr(state, p)), old[p]))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tr.state.params), old["params"]))
    if isinstance(bs, SampleBank):
        assert len(bs.samples) == len(old_bank) == ROUNDS - FED["burn_in"]
        for s, was in zip(bs.samples, old_bank):
            for x, y in zip(tree_leaves(s), was):
                assert not _rows(x, 0)[1].any()
                assert torch.equal(_rows(x, 0)[0], _rows(y, 0)[0])
        return
    assert tr._bank_state is bs                      # written in place
    for x, y in zip(tree_leaves(bs.slots), old_bank):
        assert not _rows(x, 1)[1].any()
        assert torch.equal(_rows(x, 1)[0], _rows(y, 1)[0])
    if BANKS[bank][1] == "int8":
        for x, y in zip(tree_leaves(bs.scales), old_scales):
            assert bool((_rows(x, 1)[1] == 1.0).all())
            assert torch.equal(_rows(x, 1)[0], _rows(y, 1)[0])
    else:
        assert bs.scales is None


@pytest.mark.parametrize("bank", list(BANKS))
def test_unlearned_chain_leaves_every_view(bank, references):
    want, test = _ref_for(bank, references)
    tr = _port(bank)
    before = tr.eval_report(test)
    tr.unlearn(TARGET)
    stacked, weights = tr._posterior()
    assert weights is None
    assert {tuple(x.shape[:2]) for x in tree_leaves(stacked)} == {
        (ROUNDS - FED["burn_in"], K - 1)}
    rep, probs = tr.eval_report(test, return_probs=True)
    assert rep.ece != before.ece and want["report"].ece != want["before"].ece
    # the reference's predictions after unlearn, within the trainer's bounds
    np.testing.assert_allclose(probs, want["probs"], atol=1e-4)
    assert abs(rep.accuracy - want["report"].accuracy) <= \
        1.0 / len(test["y"]) + 1e-6
    assert abs(rep.ece - want["report"].ece) <= ECE_BOUND
    pred = tr.predictor()
    assert {tuple(x.shape[1:2]) for x in tree_leaves(pred.stacked)} == {
        (K - 1,)}
    pprobs, _ = pred.predict({"x": test["x"]})
    np.testing.assert_allclose(pprobs.numpy(), want["predictor"], atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_training_after_unlearn_scan_equals_host(dtype):
    runs = {}
    for engine in ("host", "scan"):
        cfg, shards, _ = _world()
        tr = FedTrainer(get_model(cfg), FedConfig(**FED), shards,
                        minibatch=6, engine=engine, bank_capacity=8,
                        bank_thin=1, bank_dtype=dtype, chunk=3, device="cpu")
        first = tr.run(rounds=6)
        tr.unlearn(TARGET)
        second = tr.run(rounds=3)
        runs[engine] = (tr, first.loss_history + second.loss_history)
    (host, hloss), (scan, sloss) = runs["host"], runs["scan"]
    assert sloss == hloss
    for p in ("params", "v", "v_bar"):
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(getattr(scan.state, p)),
            tree_leaves(getattr(host.state, p))))
    assert torch.equal(scan.key, host.key)
    assert scan._round == host._round == 9
    # the node's chain is back in the samples admitted after the unlearn
    newest = [x.select(0, -1) for x in tree_leaves(scan._stacked_bank())]
    assert all(bool(_rows(x, 0)[1].any()) for x in newest)
    if dtype == "float32":
        for a, b in zip(scan.bank.samples, host.bank.samples):
            assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                          tree_leaves(b)))


def test_unlearn_oracle_matches_the_reference():
    kw = dict(rounds=24, per_node=12, eval_examples=80, local_steps=4)
    want = jax_matrix.run_unlearn_oracle(
        dataclasses.replace(jax_matrix.CLAIMS_SPEC, **kw), log=None)
    got = matrix.run_unlearn_oracle(
        dataclasses.replace(matrix.CLAIMS_SPEC, **kw), log=None,
        device="cpu")
    assert got["target"] == want["target"] == 4
    assert got["within_tolerance"] and want["within_tolerance"]
    assert got["delta_accuracy"] <= matrix.UNLEARN_ACC_TOL
    assert got["delta_ece"] <= matrix.UNLEARN_ECE_TOL
    # |Δacc| and |ΔECE| beside the reference's: each side's bounds, twice
    assert abs(got["delta_accuracy"] - want["delta_accuracy"]) <= \
        2.0 / kw["eval_examples"] + 1e-6
    assert abs(got["delta_ece"] - want["delta_ece"]) <= 2 * ECE_BOUND
    for side in ("unlearn", "oracle"):
        assert abs(got[side].accuracy - want[side].accuracy) <= \
            1.0 / kw["eval_examples"] + 1e-6
        assert abs(got[side].ece - want[side].ece) <= ECE_BOUND
    assert (matrix.UNLEARN_ACC_TOL, matrix.UNLEARN_ECE_TOL) == (
        jax_matrix.UNLEARN_ACC_TOL, jax_matrix.UNLEARN_ECE_TOL)
