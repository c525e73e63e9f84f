"""A reduced FedTrainer run of the port (host engine, CPU) against the
reference's ``FedTrainer(engine="host")``, both seeded with ``SEED`` and
nothing handed in: the port draws its init, minibatches, noise and QSGD
uniforms from the reference's keys (``repro_torch.random``), so the two
runs start from the same params and see the same draws. Then BMA
evaluation on a day-1 test set.

Bounds: per-round losses within rtol 1e-4; accuracy within one test
example; ECE within 0.01. The chains differ only by the last-bit
differences of the local steps (see test_torch_round.py), so the BMA
probabilities agree to about 1e-5 and only an example sitting on an argmax
tie or a bin edge could move. The ``block_topk|qsgd`` pipeline is held to
the same bounds (its grid can flip where a uniform lies within the
residual's last bits of its fraction; see test_torch_round.py).

The paper's default run and its two baselines (``FedConfig``'s default
``fused_compress=False``, ``algorithm`` cdbfl, dsgld and cffl) are held
to the same bounds over 3 rounds; cffl keeps no posterior bank on either
side and is evaluated on its nodes' current params.
"""
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig, get_arch as jax_get_arch
from repro.data.partition import partition_iid
from repro.data.radar import make_dataset
from repro.models import get_model as jax_get_model
from repro.train import FedTrainer as JaxFedTrainer
from repro_torch.config import FedConfig, get_arch
from repro_torch.models import get_model
from repro_torch.train import FedTrainer

import torch_threads  # noqa: F401  (one torch thread a process)

K, L, M, ROUNDS, SEED = 3, 2, 5, 6, 0
FED = dict(num_nodes=K, local_steps=L, eta=3e-3, zeta=0.3, temperature=0.2,
           burn_in=2, rounds=ROUNDS, compressor="block_topk",
           fused_compress=True, topology="full")
ECE_BOUND = 0.01


def _check_trainer_against_reference(pipeline, wire):
    model_cfg = jax_get_arch("lenet-radar").reduced
    shards = partition_iid(make_dataset(K * 20, hw=(32, 16), seed=0), K)
    test = make_dataset(60, hw=(32, 16), day=1, seed=99)
    fed = dict(FED, pipeline=pipeline)
    ref = JaxFedTrainer(jax_get_model(model_cfg), JaxFedConfig(**fed), shards,
                        minibatch=M, seed=SEED, engine="host")
    want = ref.run(eval_batch=test)

    port = FedTrainer(get_model(get_arch("lenet-radar").reduced),
                      FedConfig(**fed), shards, minibatch=M, seed=SEED,
                      device="cpu")
    got = port.run(eval_batch=test)

    assert got.wire_history == want.wire_history == [wire] * ROUNDS
    assert len(port.bank) == len(ref.bank) == 2
    np.testing.assert_allclose(got.loss_history, want.loss_history, rtol=1e-4)
    assert abs(got.accuracy - want.accuracy) <= 1.0 / len(test["y"]) + 1e-6
    assert abs(got.ece - want.ece) <= ECE_BOUND
    np.testing.assert_allclose(got.probs, want.probs, atol=1e-4)
    assert np.isfinite([got.nll, got.brier]).all()


def test_trainer_matches_reference():
    _check_trainer_against_reference("", 1056.0)


def test_qsgd_pipeline_trainer_matches_reference():
    _check_trainer_against_reference("block_topk|qsgd", 568.0)


@pytest.mark.parametrize("algorithm", ["cdbfl", "dsgld", "cffl"])
def test_baseline_trainers_match_reference(algorithm):
    model_cfg = jax_get_arch("lenet-radar").reduced
    shards = partition_iid(make_dataset(K * 20, hw=(32, 16), seed=0), K)
    test = make_dataset(60, hw=(32, 16), day=1, seed=99)
    fed = dict(FED, fused_compress=False, algorithm=algorithm, rounds=3,
               burn_in=1)
    ref = JaxFedTrainer(jax_get_model(model_cfg), JaxFedConfig(**fed), shards,
                        minibatch=M, seed=SEED, engine="host")
    want = ref.run(eval_batch=test)
    port = FedTrainer(get_model(get_arch("lenet-radar").reduced),
                      FedConfig(**fed), shards, minibatch=M, seed=SEED,
                      engine="host", device="cpu")
    got = port.run(eval_batch=test)
    assert got.wire_history == want.wire_history
    assert got.bytes_sent_per_round == want.bytes_sent_per_round
    assert len(port.bank) == len(ref.bank)
    assert (len(port.bank) == 0) == (algorithm == "cffl")
    np.testing.assert_allclose(got.loss_history, want.loss_history, rtol=1e-4)
    assert abs(got.accuracy - want.accuracy) <= 1.0 / len(test["y"]) + 1e-6
    assert abs(got.ece - want.ece) <= ECE_BOUND
    np.testing.assert_allclose(got.probs, want.probs, atol=1e-4)
