"""``FedTrainer`` and the training CLI on the dense LMs (ROADMAP A12 part
2) against the reference's, on the CPU at smollm-135m's reduced width in
its default bf16 compute: K = 2 nodes on a ring, pools of 8 Markov
sequences of 16 tokens a node (``markov_tokens(pool, seq, V, seed, k)``,
the CLI's), minibatches of 2, L = 2.

- ``FedTrainer.run`` then ``evaluate`` on the held-out stream of node K
  (``lm_apply_fn``, labels ``tokens[:, 1:]``): the bytes exact; each
  round's loss within rtol 2e-4 and consensus within rtol 2e-2 (bf16
  compute: a near-tie of the codec may flip, moving a survivor of ~0.2,
  ``test_torch_lm_train.py``); the report's NLL within rtol 1e-3, ECE within
  1e-3, accuracy within one token of 30. The final params, v and v̄ within
  5e-3 absolute away from every element whose membership in v's support
  differs in some round (measured 3.2e-3: two rounds of the one-round
  bound of 2e-3, ``test_torch_lm_train.py``; 6 and 24 such flips here).
  The BMA probabilities of the evaluation, and the trainer's
  ``predictor()`` against the reference's ``predictor().predict``, within
  5e-2 of the largest probability (measured 2.6e-2: the flipped survivors
  move the bf16 forward).
- In f32 the codec's index sets are the reference's in every round, and
  the run is the reference's to summation order: params, v and v̄ within
  1e-6 absolute (measured 1.2e-7), losses and consensus within rtol 1e-6
  (1.5e-7, 2.8e-7), the evaluation's and the predictor's probabilities
  within rtol 1e-5 (7.7e-7, 1.0e-6) and the predictor's entropy within
  1e-5 (1.4e-6), the report's NLL and ECE within 1e-6.
- The scan engine equals the host engine bit for bit (params, v, v̄, the
  bank, losses, consensus, the report and its probabilities); the
  trainer's ``BankPredictor`` over the LM bank gives the evaluation's BMA
  probabilities (rtol 1e-6: the same products in another batch).
- The CLI: ``--arch smollm-135m --trim`` prints the reference CLI's
  ``arch=``, ``wire accounting:`` and ``topology=`` lines
  (``tests/torch_golden.py: reference_cli_lines``), trains, scores the
  held-out stream each ``--eval-every`` segment and keeps a bank.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig, get_arch as jax_get_arch
from repro.data.synthetic_lm import markov_tokens
from repro.models import get_model as jax_get_model
from repro.train.trainer import FedTrainer as JaxFedTrainer
from repro_torch.config import FedConfig, get_arch
from repro_torch.launch import train as port_train
from repro_torch.models import get_model
from repro_torch.train.trainer import FedTrainer
from repro_torch.utils.tree import tree_leaves
from torch_golden import reference_cli_lines

import torch_threads  # noqa: F401  (one torch thread a process)

K, L, B, S, POOL = 2, 2, 2, 16, 8
DATA_SCALE = 50.0
ROUNDS = 2
FED = dict(num_nodes=K, local_steps=L, eta=1e-3, zeta=0.3, temperature=0.1,
           burn_in=1, rounds=ROUNDS, topology="ring")
TRAINER = dict(minibatch=B, data_scale=DATA_SCALE, bank_capacity=4,
               bank_thin=1, eval_batch_size=8)
LOSS_RTOL, CONS_RTOL, NLL_RTOL, ECE_ATOL = 2e-4, 2e-2, 1e-3, 1e-3
STATE_ATOL = 5e-3            # bf16, away from the flipped elements
PROBS_OF_MAX = 5e-2          # bf16, |Δp| over the largest p
F32_ATOL, F32_RTOL, F32_PROBS_RTOL = 1e-6, 1e-6, 1e-5


def _pools(vocab: int):
    return [{"tokens": markov_tokens(POOL, S, vocab, seed=0, node=k)}
            for k in range(K)]


def _held(vocab: int):
    return {"tokens": markov_tokens(2, S, vocab, seed=0, node=K)}


def _keep_supports(engine, leaves):
    """Wrap a host engine's round so that each round appends the support of
    its v, a bool array a leaf, to the list it returns."""
    supports, round_fn = [], engine.round_fn

    def hooked(state, batches, key, *draws):
        out = round_fn(state, batches, key, *draws)
        supports.append([np.asarray(x) != 0 for x in leaves(out[0].v)])
        return out
    hooked.draws = getattr(round_fn, "draws", None)
    engine.round_fn = hooked
    return supports


def _reference(dtype: str = "bfloat16"):
    """The reference's host-engine run: (trainer, result, the supports of v
    after each round)."""
    cfg = jax_get_arch("smollm-135m").reduced.replace(dtype=dtype)
    tr = JaxFedTrainer(jax_get_model(cfg), JaxFedConfig(**FED),
                       _pools(cfg.vocab_size), engine="host", **TRAINER)
    supports = _keep_supports(tr._engine, jax.tree.leaves)
    return tr, tr.run(rounds=ROUNDS, eval_batch=_held(cfg.vocab_size)), \
        supports


def _port(engine: str, dtype: str = "bfloat16"):
    """The port's run: (trainer, result, the supports of v after each round
    on the host engine, else None)."""
    cfg = get_arch("smollm-135m").reduced.replace(dtype=dtype)
    tr = FedTrainer(get_model(cfg), FedConfig(**FED), _pools(cfg.vocab_size),
                    engine=engine, device="cpu", **TRAINER)
    supports = (_keep_supports(tr._engine, lambda t: [
        x.numpy() for x in tree_leaves(t)]) if engine == "host" else None)
    return tr, tr.run(rounds=ROUNDS, eval_batch=_held(cfg.vocab_size)), \
        supports


@pytest.fixture(scope="module")
def reference():
    return _reference()


@pytest.fixture(scope="module")
def port_runs():
    return {e: _port(e) for e in ("host", "scan")}


@pytest.fixture(scope="module")
def f32_runs():
    return _reference("float32"), _port("host", "float32")


def _flipped(got_supports, want_supports):
    """A leaf's mask of the elements whose membership in v's support differs
    between the runs in some round, on any node (Eq. 8 mixes every node's
    delta, so a flip reaches each node)."""
    masks = None
    for got, want in zip(got_supports, want_supports):
        rnd = [(g != w).any(axis=0) for g, w in zip(got, want)]
        masks = rnd if masks is None else [m | r for m, r in zip(masks, rnd)]
    return masks


def _state_error(port_tr, ref_tr, masks):
    """The largest |Δ| of params, v and v̄ away from ``masks``."""
    worst = 0.0
    for name in ("params", "v", "v_bar"):
        for g, w, m in zip(tree_leaves(getattr(port_tr.state, name)),
                           jax.tree.leaves(getattr(ref_tr.state, name)),
                           masks):
            assert g.shape == w.shape and torch.isfinite(g).all(), name
            err = np.abs(g.numpy() - np.asarray(w))[
                ~np.broadcast_to(m, g.shape)]
            worst = max(worst, float(err.max()) if err.size else 0.0)
    return worst


def _predictions(port_tr, ref_tr):
    """Both trainers' ``predictor().predict`` on the held-out stream:
    (port probs, port entropy, reference probs, reference entropy)."""
    held = _held(get_arch("smollm-135m").reduced.vocab_size)
    probs, ent = port_tr.predictor().predict(held)
    want, want_ent = ref_tr.predictor().predict(
        {k: jnp.asarray(v) for k, v in held.items()})
    return (probs.numpy(), ent.numpy(), np.asarray(want),
            np.asarray(want_ent))


def test_trainer_run_and_evaluate_match_the_reference(reference, port_runs):
    ref_tr, want, want_supports = reference
    tr, got, supports = port_runs["host"]
    assert got.bytes_sent_per_round == want.bytes_sent_per_round
    assert got.measured_bytes_per_round == want.measured_bytes_per_round
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got.consensus_history, want.consensus_history,
                               rtol=CONS_RTOL)
    assert len(tr.bank) == len(ref_tr.bank) > 0
    np.testing.assert_array_equal(got.labels, want.labels)
    want_probs = np.asarray(want.probs)
    assert got.probs.shape == want_probs.shape
    assert np.abs(got.probs - want_probs).max() <= \
        PROBS_OF_MAX * want_probs.max()
    np.testing.assert_allclose(got.nll, want.nll, rtol=NLL_RTOL)
    assert abs(got.ece - want.ece) <= ECE_ATOL
    assert abs(got.accuracy - want.accuracy) * got.labels.size <= 1.0
    assert [h["round"] for h in got.eval_history] == [float(ROUNDS)]
    assert len(supports) == len(want_supports) == ROUNDS
    assert _state_error(tr, ref_tr, _flipped(supports, want_supports)) <= \
        STATE_ATOL


def test_predictor_matches_the_references(reference, port_runs):
    """The trainer's predictor over the LM bank against the reference's
    ``FedTrainer.predictor().predict`` on the held-out stream."""
    probs, ent, want, want_ent = _predictions(port_runs["scan"][0],
                                              reference[0])
    assert probs.shape == want.shape == (2, S, get_arch(
        "smollm-135m").reduced.vocab_size)
    assert np.abs(probs - want).max() <= PROBS_OF_MAX * want.max()
    assert np.isfinite(ent).all() and ent.shape == want_ent.shape


def test_f32_run_and_predictor_are_the_references(f32_runs):
    """In f32 no near-tie flips: every round's index sets are the
    reference's, and the run, its evaluation and the trainer's predictor
    agree with the reference's to summation order."""
    (ref_tr, want, want_supports), (tr, got, supports) = f32_runs
    assert got.bytes_sent_per_round == want.bytes_sent_per_round
    for got_round, want_round in zip(supports, want_supports):
        for g, w in zip(got_round, want_round):
            assert np.array_equal(g, w)
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=F32_RTOL)
    np.testing.assert_allclose(got.consensus_history, want.consensus_history,
                               rtol=F32_RTOL)
    no_flips = [np.zeros(x.shape[1:], bool) for x in supports[0]]
    assert _state_error(tr, ref_tr, no_flips) <= F32_ATOL
    np.testing.assert_allclose(got.probs, np.asarray(want.probs),
                               rtol=F32_PROBS_RTOL, atol=0)
    assert abs(got.nll - want.nll) <= F32_ATOL
    assert abs(got.ece - want.ece) <= F32_ATOL
    assert got.accuracy == want.accuracy
    probs, ent, want_probs, want_ent = _predictions(tr, ref_tr)
    np.testing.assert_allclose(probs, want_probs, rtol=F32_PROBS_RTOL,
                               atol=0)
    np.testing.assert_allclose(ent, want_ent, rtol=0, atol=F32_PROBS_RTOL)


def test_predictor_serves_the_lm_bank(port_runs):
    """``FedTrainer.predictor()`` over the LM bank (``BankPredictor``, the
    model's logits): its BMA probabilities at the scored positions are the
    evaluation's."""
    tr, res, _ = port_runs["scan"]
    cfg = get_arch("smollm-135m").reduced
    held = _held(cfg.vocab_size)
    probs, entropy = tr.predictor().predict(held)
    probs = np.asarray(probs)
    assert probs.shape == (2, S, cfg.vocab_size)
    assert np.isfinite(np.asarray(entropy)).all()
    np.testing.assert_allclose(probs[:, :-1], res.probs, rtol=1e-6,
                               atol=1e-9)


def test_scan_engine_equals_host_engine(port_runs):
    (host, hres, _), (scan, sres, _) = port_runs["host"], port_runs["scan"]
    for name in ("params", "v", "v_bar"):
        for a, b in zip(tree_leaves(getattr(host.state, name)),
                        tree_leaves(getattr(scan.state, name))):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    assert hres.loss_history == sres.loss_history
    assert hres.consensus_history == sres.consensus_history
    hs, ss = host._stacked_bank(), scan._stacked_bank()
    for a, b in zip(tree_leaves(hs), tree_leaves(ss)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(hres.probs, sres.probs)
    for field in hres.report._fields:
        a, b = getattr(hres.report, field), getattr(sres.report, field)
        if field == "bins":
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert a == b or (np.isnan(a) and np.isnan(b)), field


def test_cli_trains_an_lm_with_the_reference_cli_lines(capsys):
    argv = ["--arch", "smollm-135m", "--trim", "--nodes", str(K),
            "--local-steps", "1", "--seq", str(S), "--batch", str(B),
            "--pool", str(POOL), "--log-every", "1"]
    want = reference_cli_lines(argv)
    capsys.readouterr()
    port_train.main(argv + ["--rounds", "2", "--eval-every", "1",
                            "--eval-examples", "4", "--bank-capacity", "2",
                            "--burn-in", "0", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(want) == 3
    assert [ln for ln in out if ln.startswith(("arch=", "wire accounting:",
                                               "topology="))] == want
    assert want[0].startswith("arch=smollm-reduced params=0.27M")
    assert [ln.split()[1] for ln in out if ln.startswith("round ")] == [
        "1", "2"]
    evals = [ln for ln in out if ln.startswith("eval  round")]
    assert [ln.split()[2] for ln in evals] == ["1", "2"]
    assert "[clean@1] S=1" in evals[0] and "[clean@1] S=2" in evals[1]
    assert any(ln.startswith("posterior bank: capacity=2") for ln in out)


def test_cli_refuses_drift_on_a_token_pool():
    with pytest.raises(SystemExit, match="needs a lenet pool"):
        port_train.main(["--arch", "smollm-135m", "--trim", "--nodes", "2",
                         "--rounds", "1", "--seq", "8", "--pool", "4",
                         "--drift", "gain_drift", "--device", "cpu"])
