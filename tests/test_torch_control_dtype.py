"""Control variates in bfloat16 (``FedConfig.control_dtype``, ROADMAP A3),
the per-node key stream of ``FedState`` and a user's loss in the round
(ROADMAP A4, A7), against the reference on the CPU.

- bf16 rounds (cdbfl with the default codec, cdbfl with the fused
  ``block_topk``, cffl) on the reduced LeNet, K=4 on a ring (the roll
  lowering: its mix is exact), each round handed the reference's
  minibatches and round key. With η = 0 the local steps return θ as it is,
  so every input of Eqs. 6–9 is the reference's and params, v and v̄ are
  held bit for bit over three rounds; at a 50% ratio most coordinates are
  sent every round, so v + Δv is not a bf16 value and the test tells
  Eq. 9 reading the f32 sums (what XLA's CPU code runs, ROADMAP C23) from
  reading them rounded to bf16. With η = 3e-3 the local steps differ in
  their last bits (convolution and matmul summation order, as
  ``test_torch_baselines.py``): params within rtol 1e-4 / atol 1e-6, v
  and v̄ bit-equal (bf16 rounding absorbs those bits at the default 1%).
- The key stream: ``init_fed_state``'s (K, 2) keys and the round's
  ``fold_in(state.key, round)`` then a ``split`` a step, exact.
- A per-node loss that draws from its key (additive N(0, 1) noise on the
  targets): params within rtol 1e-5 of the reference after three rounds,
  loss within rtol 1e-5; a wrong key moves them by the noise. Through
  both engines, whose round index is a device int32, it equals the rounds
  run with int indices bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig, get_arch as jax_get_arch
from repro.core import (build_topology, init_fed_state, make_compressor,
                        mixing_matrix, resolve_topology)
from repro.core.algorithms import make_round_fn
from repro.data.partition import DeviceShards as JaxDeviceShards
from repro.data.partition import partition_iid
from repro.data.radar import make_dataset
from repro.models import get_model as jax_get_model
from repro.train.engine import round_data_key
from repro_torch import random
from repro_torch.config import FedConfig, get_arch
from repro_torch.core import algorithms as port_alg
from repro_torch.core import fed_state as port_state
from repro_torch.core.compression import make_compressor as port_compressor
from repro_torch.data.partition import DeviceShards
from repro_torch.models import get_model
from repro_torch.models.lenet import params_from_jax
from repro_torch.train import FedTrainer, make_engine
from repro_torch.train.engine import one_round
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

import torch_threads  # noqa: F401  (one torch thread a process)

K, L, M = 4, 2, 5
RTOL, ATOL = 1e-4, 1e-6
# (algorithm, fused_compress, eta, compress_ratio, bit-exact params)
ROUNDS = [("cdbfl", False, 0.0, 0.5, True), ("cdbfl", True, 0.0, 0.5, True),
          ("cffl", False, 0.0, 0.5, True), ("cdbfl", False, 3e-3, 0.01, False),
          ("cdbfl", True, 3e-3, 0.01, False),
          ("cffl", False, 3e-3, 0.01, False)]


def _key(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _fed(algorithm, fused, eta, ratio):
    return dict(num_nodes=K, local_steps=L, eta=eta, zeta=0.3,
                temperature=0.2, burn_in=2, rounds=3, topology="ring",
                control_dtype="bfloat16", algorithm=algorithm,
                fused_compress=fused, compress_ratio=ratio)


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("algorithm,fused,eta,ratio,exact", ROUNDS)
def test_bf16_rounds_against_reference(algorithm, fused, eta, ratio, exact):
    fed = _fed(algorithm, fused, eta, ratio)
    jfed = JaxFedConfig(**fed)
    model = jax_get_model(jax_get_arch("lenet-radar").reduced)
    shards = partition_iid(make_dataset(K * 20, hw=(32, 16), seed=0), K)
    jshards = JaxDeviceShards.from_shards(shards)
    data_scale = float(np.mean([len(s["y"]) for s in shards]))
    key = jax.random.PRNGKey(0)
    params0 = model.init(key)
    jstate = init_fed_state(params0, jfed, key=key)
    omega = build_topology(resolve_topology(jfed), K).omega
    jround = jax.jit(make_round_fn(algorithm, model.loss, jfed, omega,
                                   make_compressor(jfed), data_scale))
    pfed = FedConfig(**fed)
    pround = port_alg.make_round_fn(
        algorithm, get_model(get_arch("lenet-radar").reduced).nll, pfed,
        omega, port_compressor(pfed), data_scale, "cpu")
    pshards = DeviceShards.from_shards(shards, "cpu")
    state = port_state.init_fed_state(
        params_from_jax(jax.tree.map(np.asarray, params0)), pfed)
    key = jax.random.PRNGKey(1)
    for r in range(3):
        key, kround = jax.random.split(key)
        idx = jshards.sample_indices(round_data_key(kround), L, M)
        jstate, jm = jround(jstate, jshards.gather(idx), kround)
        state, pm = pround(state, pshards.gather(np.asarray(idx)),
                           _key(kround))
        assert float(pm.wire_bytes) == float(jm.wire_bytes)
        for name in ("params", "v", "v_bar"):
            for (path, g), w in zip(tree_leaves_with_path(getattr(state, name)),
                                    jax.tree.leaves(getattr(jstate, name))):
                want_dtype = torch.float32 if name == "params" \
                    else torch.bfloat16
                assert g.dtype == want_dtype and str(w.dtype) == \
                    str(want_dtype).replace("torch.", "")
                got = g.view(torch.int16 if g.dtype == torch.bfloat16
                             else torch.int32).numpy()
                if exact or name != "params":
                    assert np.array_equal(got.view(_bits(w).dtype),
                                          _bits(w)), f"round {r} {name}.{path}"
                else:
                    np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                               rtol=RTOL, atol=ATOL,
                                               err_msg=f"{name}.{path}")


@pytest.mark.parametrize("seed,k", [(0, 3), (5, 10), (123, 8)])
def test_fed_state_key_stream_is_the_reference(seed, k):
    """``init_fed_state``'s node keys, from the config's seed and from a
    handed key, and the round's per-node keys and their per-step splits."""
    params = {"w": torch.zeros(3)}
    jfed, fed = JaxFedConfig(num_nodes=k, seed=seed), FedConfig(num_nodes=k,
                                                                seed=seed)
    want = init_fed_state({"w": jnp.zeros(3)}, jfed)
    got = port_state.init_fed_state(params, fed)
    assert got.key.shape == (k, 2)
    assert got.key.tolist() == np.asarray(want.key).astype(np.int64).tolist()
    handed = port_state.init_fed_state(params, fed, key=random.PRNGKey(9))
    want9 = init_fed_state({"w": jnp.zeros(3)}, jfed,
                           key=jax.random.PRNGKey(9))
    assert handed.key.tolist() == \
        np.asarray(want9.key).astype(np.int64).tolist()
    for rnd in (0, 1, 37):
        nk = jax.vmap(jax.random.fold_in, in_axes=(0, None))(want.key, rnd)
        got_nk = port_alg.node_keys(got._replace(round=rnd))
        assert got_nk.tolist() == np.asarray(nk).astype(np.int64).tolist()
        pair = jax.vmap(jax.random.split)(nk)
        got_pair = random.split(got_nk)
        assert got_pair.tolist() == np.asarray(pair).astype(np.int64).tolist()


DIM = 6


def _keyed_loss_jax(params, batch, key):
    x, y = batch
    y = y + jax.random.normal(key, y.shape)
    return 0.5 * jnp.mean((x @ params["w"] - y) ** 2) * 10, ()


def _keyed_loss_port(params, batch, key):
    x, y = batch
    y = y + random.normal(key, tuple(y.shape))
    return 0.5 * torch.mean((x @ params["w"] - y) ** 2) * 10, ()


@pytest.mark.parametrize("algorithm", ["cdbfl", "dsgld", "cffl"])
def test_user_loss_draws_from_its_key(algorithm):
    """A per-node ``loss_fn(params, batch, key)`` over a tuple batch, as the
    quickstart writes it, each node's loss drawing N(0, 1) target noise
    from the key the round hands it."""
    k, l = 4, 3
    fed = dict(num_nodes=k, local_steps=l, eta=2e-3, zeta=0.3,
               topology="ring", compressor="block_topk", compress_ratio=0.5,
               burn_in=1, algorithm=algorithm)
    jfed, pfed = JaxFedConfig(**fed), FedConfig(**fed)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((k, l, 8, DIM)).astype(np.float32)
    y = rng.standard_normal((k, l, 8)).astype(np.float32)
    omega = mixing_matrix("ring", k)
    jround = jax.jit(make_round_fn(algorithm, _keyed_loss_jax, jfed, omega,
                                   make_compressor(jfed)))
    pround = port_alg.make_round_fn(algorithm, _keyed_loss_port, pfed, omega,
                                    port_compressor(pfed))
    jstate = init_fed_state({"w": jnp.zeros(DIM)}, jfed)
    state = port_state.init_fed_state({"w": torch.zeros(DIM)}, pfed)
    key = jax.random.PRNGKey(3)
    for t in range(3):
        kt = jax.random.fold_in(key, t)
        jstate, jm = jround(jstate, (jnp.asarray(x), jnp.asarray(y)), kt)
        state, pm = pround(state, (torch.from_numpy(x), torch.from_numpy(y)),
                           _key(kt))
        np.testing.assert_allclose(pm.loss.numpy(), np.asarray(jm.loss),
                                   rtol=1e-5)
        np.testing.assert_allclose(state.params["w"].numpy(),
                                   np.asarray(jstate.params["w"]),
                                   rtol=1e-5, atol=1e-7)
    assert state.round == 3


def _dict_keyed_loss(params, batch, key):
    return _keyed_loss_port(params, (batch["x"], batch["y"]), key)


@pytest.mark.parametrize("algorithm", ["cdbfl", "cffl"])
def test_user_loss_on_both_engines(algorithm):
    """A keyed per-node loss through both engines. They hand the round a
    device int32 round index, which the key fold reads on the device (no
    host read, so a captured chunk folds each round's own index): both
    equal the rounds run with Python int indices, bit for bit."""
    k, l, m = 4, 2, 8
    fed = FedConfig(num_nodes=k, local_steps=l, eta=2e-3, zeta=0.3,
                    topology="ring", compressor="block_topk",
                    compress_ratio=0.5, burn_in=1, algorithm=algorithm)
    rng = np.random.default_rng(1)
    shards = DeviceShards.from_shards(
        [{"x": rng.standard_normal((20, DIM)).astype(np.float32),
          "y": rng.standard_normal(20).astype(np.float32)}
         for _ in range(k)], "cpu")
    round_fn = port_alg.make_round_fn(algorithm, _dict_keyed_loss, fed,
                                      mixing_matrix("ring", k),
                                      port_compressor(fed))
    state0 = port_state.init_fed_state({"w": torch.zeros(DIM)}, fed)
    want, key = state0, random.PRNGKey(5)
    for t in range(3):
        want, key, _ = one_round(round_fn, shards, l, m, want, key, t)
        want = want._replace(round=t + 1)
    for name in ("host", "scan"):
        got, got_key, *_ = make_engine(name, round_fn, shards, l, m,
                                       chunk=2).run(state0,
                                                    random.PRNGKey(5), None, 3)
        assert torch.equal(got_key, key) and got.round == 3
        for part in ("params", "v", "v_bar"):
            for a, b in zip(tree_leaves(getattr(got, part)),
                            tree_leaves(getattr(want, part))):
                assert torch.equal(a, b), (name, part)


def test_bf16_config_runs_and_float16_still_refuses():
    """bf16 and, since ROADMAP A3's rest, float16 control variates run; a
    value still unported (a QSGD level count that is not a power of two,
    C5) refuses."""
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float16", torch.float16)):
        FedConfig(control_dtype=name).check_supported()
        st = port_state.init_fed_state({"w": torch.ones(2, 3)},
                                       FedConfig(num_nodes=3,
                                                 control_dtype=name))
        assert all(x.dtype == dtype and not x.any()
                   for x in tree_leaves(st.v) + tree_leaves(st.v_bar))
        assert st.params["w"].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="C5"):
        FedConfig(qsgd_levels=3).check_supported()


@pytest.mark.parametrize("algorithm", ["cdbfl", "cffl"])
def test_bf16_trainer_scan_equals_host(algorithm):
    """``FedTrainer`` with bf16 control variates on both engines, bit for
    bit, the state's key stream carried by the scan engine unchanged."""
    cfg = get_arch("lenet-radar").reduced
    fed = FedConfig(num_nodes=3, local_steps=2, burn_in=1, rounds=3,
                    control_dtype="bfloat16", algorithm=algorithm)
    shards = partition_iid(make_dataset(24, hw=cfg.input_hw, seed=0), 3)
    states = []
    for engine in ("host", "scan"):
        tr = FedTrainer(get_model(cfg), fed, shards, minibatch=4,
                        engine=engine, chunk=2, device="cpu")
        key0 = tr.state.key.clone()
        tr.run(rounds=3)
        assert torch.equal(tr.state.key, key0)
        states.append(tr.state)
    for name in ("params", "v", "v_bar"):
        for a, b in zip(tree_leaves(getattr(states[0], name)),
                        tree_leaves(getattr(states[1], name))):
            assert a.dtype == b.dtype and torch.equal(a, b)
