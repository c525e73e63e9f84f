"""A reduced FedTrainer run of the port (host engine, CPU) against the
reference's ``FedTrainer(engine="host")``: the same initial params, the same
per-round draws (the reference's host-engine keys replayed and handed in),
then BMA evaluation on a day-1 test set.

Bounds: accuracy within one test example; ECE within 0.01. The chains
differ only by the last-bit differences of the local steps (see
test_torch_round.py), so the BMA probabilities agree to about 1e-5 and only
an example sitting on an argmax tie or a bin edge could move. The same run
of the ``block_topk|qsgd`` pipeline, with the reference's QSGD uniforms
replayed too, is held to the same bounds (its grid can flip where a
uniform lies within the residual's last bits of its fraction; see
test_torch_round.py).
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.config import FedConfig as JaxFedConfig, get_arch as jax_get_arch
from repro.core.algorithms import _langevin_noise
from repro.core.fed_state import stack_node_params
from repro.data.partition import DeviceShards as JaxDeviceShards
from repro.data.partition import partition_iid
from repro.data.radar import make_dataset
from repro.models import get_model as jax_get_model
from repro.train import FedTrainer as JaxFedTrainer
from repro.train.engine import round_data_key
from repro_torch.config import FedConfig, get_arch
from repro_torch.models import get_model
from repro_torch.models.lenet import params_from_jax
from repro_torch.train import FedTrainer
from test_torch_compression import reference_uniforms

K, L, M, ROUNDS, SEED = 3, 2, 5, 6, 0
FED = dict(num_nodes=K, local_steps=L, eta=3e-3, zeta=0.3, temperature=0.2,
           burn_in=2, rounds=ROUNDS, compressor="block_topk",
           fused_compress=True, topology="full")
ECE_BOUND = 0.01


def _replayed_draws(shards, params0, fed):
    """The reference host engine's per-round draws, by round index: the
    minibatch indices, the noise, and the QSGD uniforms of a pipeline."""
    dshards = JaxDeviceShards.from_shards(shards)
    stacked = stack_node_params(params0, K)
    draw_idx = jax.jit(lambda k: dshards.sample_indices(round_data_key(k), L, M))
    draw_noise = jax.jit(lambda k: _langevin_noise(
        jax.random.split(k)[1], stacked, fed.eta, fed.temperature,
        jnp.arange(K)))
    key = jax.random.PRNGKey(SEED + 1)
    draws = []
    for _ in range(ROUNDS):
        key, kround = jax.random.split(key)
        uniforms = ({} if not fed.pipeline else reference_uniforms(
            "pipeline", stacked, jax.random.split(kround)[0]))
        draws.append((np.asarray(draw_idx(kround)),
                      jax.tree.map(np.array, draw_noise(kround)), uniforms))
    return lambda t: draws[t]


def _check_trainer_against_reference(pipeline, wire):
    model_cfg = jax_get_arch("lenet-radar").reduced
    shards = partition_iid(make_dataset(K * 20, hw=(32, 16), seed=0), K)
    test = make_dataset(60, hw=(32, 16), day=1, seed=99)
    fed = dict(FED, pipeline=pipeline)
    jfed = JaxFedConfig(**fed)
    jmodel = jax_get_model(model_cfg)
    ref = JaxFedTrainer(jmodel, jfed, shards, minibatch=M, seed=SEED,
                        engine="host")
    params0 = jmodel.init(jax.random.PRNGKey(SEED))
    draws = _replayed_draws(shards, params0, jfed)
    want = ref.run(eval_batch=test)

    port = FedTrainer(get_model(get_arch("lenet-radar", reduced=True)),
                      FedConfig(**fed), shards, minibatch=M, seed=SEED,
                      device="cpu", draws=draws,
                      params=params_from_jax(jax.tree.map(np.asarray, params0)))
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
