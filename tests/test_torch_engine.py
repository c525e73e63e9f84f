"""The port's chunked round engine and on-device posterior bank, on the CPU
(``repro_torch.train.engine.ScanRoundEngine``,
``repro_torch.core.posterior.DeviceSampleBank``).

- The port's ``DeviceSampleBank`` against the reference's (its ``update``
  under ``jax.jit``, as the reference's scan engine runs it), f32 and int8,
  on one sequence of params with burn-in, thinning and eviction: slots,
  scales, count, rounds, ``order``, ``samples_list`` and ``rounds_list``
  exact. Inside ``jit`` XLA turns the scale's ``amax / 127`` into a product
  with the f32 reciprocal (ROADMAP C5); the port computes that product.
- ``engine="scan"`` against ``engine="host"`` of the port, bit for bit (a
  CPU carry runs the chunk function eagerly, the same code a CUDA graph
  captures): params, v, v̄, key, losses, consensus, bytes and the bank,
  whose capacity is below the admits, so it evicts.
- The same for the paper's default run and its baselines
  (``fused_compress=False``, ``algorithm`` cdbfl, dsgld and cffl; cffl
  with no bank on either engine).
- Chunk lengths 1, 5 and 12 give the same run, bit for bit.
- The port's scan trainer against the reference's scan trainer, both
  ``chunk=5`` and seeded alike, with ``tests/test_torch_trainer.py``'s
  bounds: losses rtol 1e-4, accuracy within one example, ECE within 0.01
  (the local steps differ from XLA's in the last bits; see there); bank
  lengths equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig, get_arch as jax_get_arch
from repro.core.posterior import DeviceSampleBank as JaxDeviceSampleBank
from repro.data.partition import partition_iid
from repro.data.radar import make_dataset
from repro.models import get_model as jax_get_model
from repro.train import FedTrainer as JaxFedTrainer
from repro_torch.config import FedConfig, get_arch
from repro_torch.core.posterior import DeviceSampleBank
from repro_torch.data.partition import DeviceShards
from repro_torch.models import get_model
from repro_torch.train import FedTrainer
from repro_torch.train.engine import make_engine
from repro_torch.utils.tree import tree_leaves

import torch_threads  # noqa: F401  (one torch thread a process)

K, L, M, SEED = 3, 2, 5, 0
CONFIGS = {"block_topk": dict(compressor="block_topk", fused_compress=True),
           "block_topk|qsgd": dict(pipeline="block_topk|qsgd",
                                   fused_compress=True),
           "qsgd_pallas": dict(compressor="qsgd_pallas"),
           "block_topk_pallas": dict(compressor="block_topk_pallas")}
ECE_BOUND = 0.01


def _bits(x) -> np.ndarray:
    a = np.asarray(x.cpu() if torch.is_tensor(x) else x)
    return a.view({4: np.int32, 1: np.int8, 8: np.int64}[a.itemsize])


def _same(a, b) -> bool:
    return np.array_equal(_bits(a), _bits(b))


def _params_seq(rounds: int):
    """Round t's params: normals of varied scale, an all-zero row (scale
    1.0) and a row of exact halves of its scale (round half to even)."""
    rng = np.random.default_rng(7)
    for t in range(rounds):
        w = (rng.standard_normal((3, 4, 5)) *
             np.exp(rng.uniform(-8, 8, (3, 1, 1)))).astype(np.float32)
        w[1] = 0.0
        b = rng.standard_normal((3, 6)).astype(np.float32)
        b[2] = np.float32(127.0) * np.array([1, 0.5, -0.5, 1.5, -2.5, 3.5],
                                            np.float32)
        yield t, {"b": b, "w": w}


@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
def test_device_bank_matches_reference(store_dtype):
    burn_in, thin, capacity, rounds = 5, 3, 4, 30
    ref = JaxDeviceSampleBank(burn_in=burn_in, capacity=capacity, thin=thin,
                              store_dtype=store_dtype)
    port = DeviceSampleBank(burn_in=burn_in, capacity=capacity, thin=thin,
                            store_dtype=store_dtype)
    seq = list(_params_seq(rounds))
    rbank = ref.init(jax.tree.map(jnp.asarray, seq[0][1]))
    pbank = port.init({k: torch.from_numpy(v) for k, v in seq[0][1].items()})
    update = jax.jit(ref.update)
    for t, p in seq:
        if t == 12:      # mid-run, both banks read the same partial state
            assert port.length(pbank) == ref.length(rbank) == 3
        rbank = update(rbank, jnp.asarray(t, jnp.int32),
                       jax.tree.map(jnp.asarray, p))
        port.update(pbank, torch.tensor(t, dtype=torch.int32),
                    {k: torch.from_numpy(v) for k, v in p.items()})
    assert int(pbank.count) == int(rbank.count) == 9
    assert _same(pbank.rounds, rbank.rounds)
    for name in ("b", "w"):
        assert _same(pbank.slots[name], rbank.slots[name])
        if store_dtype == "int8":
            assert _same(pbank.scales[name], rbank.scales[name])
    assert port.order(pbank).tolist() == ref.order(rbank).tolist()
    assert port.length(pbank) == ref.length(rbank) == capacity
    assert port.rounds_list(pbank).tolist() == \
        ref.rounds_list(rbank).tolist() == [20, 23, 26, 29]
    got, want = port.samples_list(pbank), ref.samples_list(rbank)
    assert len(got) == len(want) == capacity
    for g, w in zip(got, want):
        for name in ("b", "w"):
            assert _same(g[name], w[name])


def test_device_bank_admits_on_a_device_round_index():
    """The admit decision is a bool tensor of the round index: nothing is
    written before burn-in, one slot a round after it."""
    bank_cfg = DeviceSampleBank(burn_in=10, capacity=4, thin=1)
    bank = bank_cfg.init({"w": torch.ones((2, 3))})
    for t in range(10):
        assert not bool(bank_cfg.admit_mask(torch.tensor(t)))
        bank_cfg.update(bank, torch.tensor(t, dtype=torch.int32),
                        {"w": torch.full((2, 3), float(t))})
    assert bank_cfg.length(bank) == 0 and not bank.slots["w"].any()
    bank_cfg.update(bank, 10, {"w": torch.full((2, 3), 10.0)})
    assert bank_cfg.length(bank) == 1
    assert bank_cfg.rounds_list(bank).tolist() == [10]


def _world():
    cfg = get_arch("lenet-radar").reduced
    shards = partition_iid(make_dataset(K * 20, hw=cfg.input_hw, seed=0), K)
    return cfg, shards


def _trainer(overrides, engine, rounds, **kw):
    cfg, shards = _world()
    fed = FedConfig(num_nodes=K, local_steps=L, eta=3e-3, zeta=0.3,
                    temperature=0.2, burn_in=1, rounds=rounds,
                    topology="full", **overrides)
    return FedTrainer(get_model(cfg), fed, shards, minibatch=M, seed=SEED,
                      engine=engine, bank_thin=1, bank_capacity=3,
                      device="cpu", **kw)


def _assert_same_run(a, ra, b, rb):
    assert ra.loss_history == rb.loss_history
    assert ra.consensus_history == rb.consensus_history
    assert ra.wire_history == rb.wire_history
    for part in ("params", "v", "v_bar"):
        for x, y in zip(tree_leaves(getattr(a.state, part)),
                        tree_leaves(getattr(b.state, part))):
            assert _same(x, y), part
    assert _same(a.key, b.key)
    assert a.state.round == b.state.round


@pytest.mark.parametrize("name", list(CONFIGS))
def test_scan_engine_equals_host_engine(name):
    """Five rounds, chunks of 2 (the last one shorter): 4 admits into a
    bank of 3."""
    host = _trainer(CONFIGS[name], "host", 5)
    scan = _trainer(CONFIGS[name], "scan", 5, chunk=2)
    want, got = host.run(), scan.run()
    _assert_same_run(scan, got, host, want)
    assert len(scan.bank) == len(host.bank) == 3
    assert scan.bank_cfg.rounds_list(scan._bank_state).tolist() == \
        host.bank.rounds == [2, 3, 4]
    for s, h in zip(scan.bank.samples, host.bank.samples):
        for x, y in zip(tree_leaves(s), tree_leaves(h)):
            assert _same(x, y)


@pytest.mark.parametrize("algorithm", ["cdbfl", "dsgld", "cffl"])
def test_scan_engine_equals_host_engine_for_each_algorithm(algorithm):
    """Three rounds, chunks of 2, at ``FedConfig``'s default codec."""
    fed = dict(algorithm=algorithm)
    host = _trainer(fed, "host", 3)
    scan = _trainer(fed, "scan", 3, chunk=2)
    want, got = host.run(), scan.run()
    _assert_same_run(scan, got, host, want)
    if algorithm == "cffl":
        assert host._bank_state is None and scan._bank_state is None
        assert len(scan.bank) == len(host.bank) == 0
        return
    assert len(scan.bank) == len(host.bank) == 2
    for s, h in zip(scan.bank.samples, host.bank.samples):
        for x, y in zip(tree_leaves(s), tree_leaves(h)):
            assert _same(x, y)


def test_scan_chunking_invariance():
    """A chunk's length is an execution detail: 12 rounds in chunks of 1,
    5 and 12 give one run, bit for bit."""
    runs = []
    for chunk in (1, 5, 12):
        trainer = _trainer(CONFIGS["block_topk"], "scan", 12, chunk=chunk)
        runs.append((trainer, trainer.run()))
    for trainer, res in runs[1:]:
        _assert_same_run(trainer, res, *runs[0])
        for s, h in zip(trainer.bank.samples, runs[0][0].bank.samples):
            for x, y in zip(tree_leaves(s), tree_leaves(h)):
                assert _same(x, y)


def test_scan_trainer_matches_reference_scan_trainer():
    """The port's ``FedTrainer(engine="scan", chunk=5)`` against the
    reference's, 10 rounds (two chunks), seeded alike, then BMA
    evaluation."""
    fed = dict(num_nodes=K, local_steps=L, eta=3e-3, zeta=0.3,
               temperature=0.2, burn_in=2, rounds=10,
               compressor="block_topk", fused_compress=True, topology="full")
    shards = partition_iid(make_dataset(K * 20, hw=(32, 16), seed=0), K)
    test = make_dataset(60, hw=(32, 16), day=1, seed=99)
    ref = JaxFedTrainer(jax_get_model(jax_get_arch("lenet-radar").reduced),
                        JaxFedConfig(**fed), shards, minibatch=M, seed=SEED,
                        engine="scan", chunk=5)
    want = ref.run(eval_batch=test)
    port = FedTrainer(get_model(get_arch("lenet-radar").reduced),
                      FedConfig(**fed), shards, minibatch=M, seed=SEED,
                      chunk=5, device="cpu")
    got = port.run(eval_batch=test)
    assert port._engine.name == "scan"       # the default engine
    assert got.wire_history == want.wire_history == [1056.0] * 10
    assert len(port.bank) == len(ref.bank) == 4
    np.testing.assert_allclose(got.loss_history, want.loss_history, rtol=1e-4)
    assert abs(got.accuracy - want.accuracy) <= 1.0 / len(test["y"]) + 1e-6
    assert abs(got.ece - want.ece) <= ECE_BOUND


def test_set_shards_keeps_the_layout():
    """``set_shards`` copies same-layout shards into the tensors the chunks
    read and refuses any other layout, on both engines."""
    cfg, shards = _world()
    trainer = _trainer(CONFIGS["block_topk"], "scan", 1)
    engine = trainer._engine
    data = {f: v for f, v in engine.shards.data.items()}
    swapped = DeviceShards.from_shards(
        [{f: np.flip(v, 0).copy() for f, v in s.items()} for s in shards],
        "cpu")
    engine.set_shards(swapped)
    for f, v in engine.shards.data.items():
        assert v is data[f] and torch.equal(v, swapped.data[f])
    short = DeviceShards.from_shards(
        [{f: v[:-1] for f, v in s.items()} for s in shards], "cpu")
    host = make_engine("host", trainer.round_fn, trainer.device_shards, L, M)
    for eng in (engine, host):
        with pytest.raises(ValueError, match="layout"):
            eng.set_shards(short)


def test_shard_engine_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="A10"):
        _trainer(CONFIGS["block_topk"], "shard", 1)
