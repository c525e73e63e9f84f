"""The paper's default round and its two baselines against the reference,
on the reduced LeNet with K=3, at ``FedConfig``'s default
``fused_compress=False`` (the ``lax.top_k``-order ``block_topk`` codec):
``make_cdbfl_round``, ``make_dsgld_round`` and ``make_cffl_round`` for 1
and 3 rounds, each round handed the reference's minibatches and round key
(from which the port draws its own noise and codec uniforms, as the
reference's does), and ``make_sgld_step`` for one step.

Tolerances and why (as ``test_torch_round.py``):
- wire bytes: exact (a function of shapes).
- params, v and v̄: within rtol 1e-4 / atol 1e-6 of the reference after
  each round: the last-bit differences of the local steps (convolution and
  matmul summation order), carried by the linear parts of the update. A
  survivor the codec chose differently would move v by a whole value,
  far outside it.
- the SGLD step's params the same; its loss rtol 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig, get_arch as jax_get_arch
from repro.core import (build_topology, init_fed_state, make_compressor,
                        resolve_topology)
from repro.core.algorithms import make_round_fn, make_sgld_step
from repro.data.partition import DeviceShards as JaxDeviceShards
from repro.data.partition import partition_iid
from repro.data.radar import make_dataset
from repro.models import get_model as jax_get_model
from repro.train.engine import round_data_key
from repro_torch.config import FedConfig
from repro_torch.config import get_arch
from repro_torch.core import algorithms as port_alg
from repro_torch.core import fed_state as port_state
from repro_torch.core.compression import make_compressor as port_compressor
from repro_torch.data.partition import DeviceShards
from repro_torch.models import get_model
from repro_torch.models.lenet import params_from_jax
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

import torch_threads  # noqa: F401  (one torch thread a process)

K, L, M = 3, 2, 5
FED = dict(num_nodes=K, local_steps=L, eta=3e-3, zeta=0.3, temperature=0.2,
           burn_in=2, rounds=3, topology="full")
RTOL, ATOL = 1e-4, 1e-6
# bytes a node a round: the default codec (its short leaves through
# TopKCodec's global top-k), or DSGLD's dense θ
WIRE = {"cdbfl": 690.0, "dsgld": 35144.0, "cffl": 690.0}


def _key(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _reference_rounds(algorithm, num_rounds):
    """The reference's jitted round of ``algorithm``: per round (idx, state
    after it, wire bytes, port round key)."""
    fed = JaxFedConfig(algorithm=algorithm, **FED)
    model = jax_get_model(jax_get_arch("lenet-radar").reduced)
    shards = partition_iid(make_dataset(K * 20, hw=(32, 16), seed=0), K)
    dshards = JaxDeviceShards.from_shards(shards)
    data_scale = float(np.mean([len(s["y"]) for s in shards]))
    key = jax.random.PRNGKey(0)
    params0 = model.init(key)
    state = init_fed_state(params0, fed, key=key)
    omega = build_topology(resolve_topology(fed), K).omega
    comp = make_compressor(fed)
    round_fn = jax.jit(make_round_fn(algorithm, model.loss, fed, omega, comp,
                                     data_scale))
    key = jax.random.PRNGKey(1)
    out = []
    for _ in range(num_rounds):
        key, kround = jax.random.split(key)
        idx = dshards.sample_indices(round_data_key(kround), L, M)
        state, metrics = round_fn(state, dshards.gather(idx), kround)
        out.append((np.asarray(idx), state, float(metrics.wire_bytes),
                    _key(kround)))
    return shards, data_scale, jax.tree.map(np.asarray, params0), out


@pytest.fixture(scope="module")
def references():
    cache = {}

    def get(algorithm):
        if algorithm not in cache:
            cache[algorithm] = _reference_rounds(algorithm, 3)
        return cache[algorithm]
    return get


def _assert_state_close(port, ref):
    for name in ("params", "v", "v_bar"):
        for (path, g), w in zip(tree_leaves_with_path(getattr(port, name)),
                                jax.tree.leaves(getattr(ref, name))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name}.{path}")


@pytest.mark.parametrize("num_rounds", [1, 3])
@pytest.mark.parametrize("algorithm", ["cdbfl", "dsgld", "cffl"])
def test_rounds_track_reference(references, algorithm, num_rounds):
    shards, data_scale, params0, rounds = references(algorithm)
    fed = FedConfig(algorithm=algorithm, **FED)
    model = get_model(get_arch("lenet-radar").reduced)
    omega = build_topology(resolve_topology(JaxFedConfig(**FED)), K).omega
    round_fn = port_alg.make_round_fn(algorithm, model.nll, fed, omega,
                                      port_compressor(fed), data_scale, "cpu")
    dshards = DeviceShards.from_shards(shards, "cpu")
    state = port_state.init_fed_state(params_from_jax(params0), fed)
    for idx, ref_state, ref_wire, kround in rounds[:num_rounds]:
        state, metrics = round_fn(state, dshards.gather(idx), kround)
        assert metrics.wire_bytes == ref_wire == WIRE[algorithm]
        if algorithm == "dsgld":
            assert metrics.payload is None
            assert metrics.loss.shape == (K, 1)
        else:
            assert metrics.payload.measured_bytes() == WIRE[algorithm] * K
        _assert_state_close(state, ref_state)
        assert all(torch.isfinite(x).all() for x in tree_leaves(state.params))
    assert state.round == num_rounds


def test_round_draws_follow_reference_keys():
    """DSGLD's noise comes from ``knoise, kmix = split(key)``; CF-FL's codec
    keys are CD-BFL's ``kq``, so with QSGD its uniforms are CD-BFL's."""
    model = get_model(get_arch("lenet-radar").reduced)
    fed = FedConfig(**FED)
    params = port_state.init_fed_state(model.init(
        _key(jax.random.PRNGKey(0)), "cpu"), fed).params
    omega = np.full((K, K), 1.0 / K, np.float32)
    key = _key(jax.random.PRNGKey(3))
    dsgld = port_alg.make_dsgld_round(model.nll, fed, omega, 1.0, "cpu")
    cdbfl_fed = FedConfig(pipeline="block_topk|qsgd", **FED)
    cdbfl = port_alg.make_cdbfl_round(model.nll, cdbfl_fed, omega,
                                      port_compressor(cdbfl_fed), 1.0, "cpu")
    cffl = port_alg.make_cffl_round(model.nll, cdbfl_fed, omega,
                                    port_compressor(cdbfl_fed), 1.0, "cpu")
    noise, uniforms = cdbfl.draws(key, params)
    for a, b in zip(tree_leaves(dsgld.draws(key, params)),
                    tree_leaves(port_alg.langevin_noise(
                        port_alg.random.split(key)[0], params, fed.eta,
                        fed.temperature))):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    got = cffl.draws(key, params)
    assert list(got) == list(uniforms)
    for path in uniforms:
        assert torch.equal(got[path], uniforms[path])


def test_sgld_step_matches_reference():
    """One centralized SGLD step on one model's params and a pooled batch."""
    model_cfg = jax_get_arch("lenet-radar").reduced
    jmodel = jax_get_model(model_cfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    batch = make_dataset(8, hw=(32, 16), seed=2)
    key = jax.random.PRNGKey(4)
    want, want_loss = jax.jit(make_sgld_step(jmodel.loss, 3e-3, 0.2, 20.0))(
        params, {k: np.asarray(v) for k, v in batch.items()}, key)
    step = port_alg.make_sgld_step(
        get_model(get_arch("lenet-radar").reduced).nll, 3e-3, 0.2,
        20.0)
    got, loss = step(params_from_jax(jax.tree.map(np.asarray, params)),
                     {k: torch.from_numpy(np.asarray(v))
                      for k, v in batch.items()}, _key(key))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for (path, g), w in zip(tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=path)
