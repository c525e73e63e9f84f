"""The port's gossip mixers against the reference's jitted mixers, and the
rounds on a sparse and a time-varying graph
(``repro_torch.core.gossip`` against ``repro.core.gossip``).

- ROADMAP C14: the port used to mix every graph with the dense einsum; the
  reference mixes a ring by rolls (``plan_mixer`` picks its circulant
  schedule). The two differ in the last bits of 40% of the elements of the
  (10, 4096, 64) input below; the port's mixer is now the reference's
  lowering, bit for bit.
- Every mode of ``make_mixer`` (identity, dense, roll, schedule and the
  time-varying schedule) on every graph family, K in {1, 2, 3, 5, 10},
  against the jitted reference mixer under the same key: exact (ROADMAP
  C16: XLA's CPU code contracts each matching's and each shift's
  multiply-add into an fma, and the port's gossip_mix computes that fma
  chain), the dense einsum within rtol 1e-6 (a matmul's summation order).
- The per-round masks against ``_matching_masks`` for several (p, pairs)
  and keys: exact.
- Two rounds of cdbfl, dsgld and cffl on the ring and on a time-varying
  geometric graph, each handed the reference's minibatches and round key:
  params, v and v̄ within rtol 1e-4 / atol 1e-6 (the local steps' last-bit
  differences, as ``test_torch_baselines.py``); wire bytes exact.
- The scan engine against the host engine on the time-varying graph, bit
  for bit, for each algorithm.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.config import TopologyConfig as JaxTopologyConfig
from repro.config import get_arch as jax_get_arch
from repro.core import build_topology as jbuild_topology
from repro.core import gossip as jgossip
from repro.core import init_fed_state, make_compressor, resolve_topology
from repro.core.algorithms import make_round_fn
from repro.core.topology import GRAPHS
from repro.data.partition import DeviceShards as JaxDeviceShards
from repro.data.partition import partition_iid
from repro.data.radar import make_dataset
from repro.models import get_model as jax_get_model
from repro.train.engine import round_data_key
from repro_torch import random
from repro_torch.config import FedConfig, TopologyConfig, get_arch
from repro_torch.core import algorithms as port_alg
from repro_torch.core import fed_state as port_state
from repro_torch.core import gossip
from repro_torch.core.compression import make_compressor as port_compressor
from repro_torch.core.topology import build_topology
from repro_torch.data.partition import DeviceShards
from repro_torch.models import get_model
from repro_torch.models.lenet import params_from_jax
from repro_torch.train import FedTrainer
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

TV = {"static": {}, "drop": dict(link_failure_prob=0.3),
      "pairs": dict(gossip_pairs=2),
      "both": dict(link_failure_prob=0.1, gossip_pairs=2)}
RTOL, ATOL = 1e-4, 1e-6


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def _port_key(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _omega(graph, k, **kw):
    """Ω of the family at K (the prime-K grid warning silenced) and the
    reference's and the port's TopologyConfig."""
    cfg = JaxTopologyConfig(graph=graph, radius=0.5, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        omega = jbuild_topology(cfg, k).omega
    return omega, cfg, TopologyConfig(graph=graph, radius=0.5, **kw)


def test_c14_ring_mix_was_the_dense_einsum_and_is_now_the_roll_lowering():
    """A (10, 4096, 64) input: the reference's jitted ring mixer and the dense
    einsum the port used to run differ; the port's mixer now equals the
    reference's bit for bit."""
    omega, jcfg, pcfg = _omega("ring", 10)
    x = (np.random.default_rng(0).standard_normal((10, 4096, 64))
         * 1e-3).astype(np.float32)
    want = np.asarray(jax.jit(jgossip.make_mixer(omega, config=jcfg))(
        {"a": jnp.asarray(x)}, jax.random.PRNGKey(0))["a"])
    old = gossip.dense_mix(torch.as_tensor(omega.astype(np.float32)),
                           {"a": torch.from_numpy(x)})["a"].numpy()
    assert (_bits(old) != _bits(want)).mean() > 0.3
    mix = gossip.make_mixer(omega, "cpu", config=pcfg)
    assert mix.mode == "schedule" and mix.schedule.shifts == (0, 1, 9)
    got = mix({"a": torch.from_numpy(x)}, random.PRNGKey(0))["a"].numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("tv", list(TV))
@pytest.mark.parametrize("graph", GRAPHS)
def test_mixer_is_the_jitted_reference_mixer(graph, tv):
    """Every lowering on every family at K in {1, 2, 3, 5, 10}, zeros and
    -0.0 included, under one key: bit for bit but the dense einsum."""
    rng = np.random.default_rng(1)
    for k in (1, 2, 3, 5, 10):
        omega, jcfg, pcfg = _omega(graph, k, **TV[tv])
        x = (rng.standard_normal((k, 37, 3)) * 1e-2).astype(np.float32)
        x[:, :4] = -0.0
        x[:, 4:6] = 0.0
        tree = {"a": x, "b": {"c": x[:, :5, 0].copy()}}
        key = jax.random.PRNGKey(k)
        want = jax.jit(jgossip.make_mixer(omega, config=jcfg))(
            jax.tree.map(jnp.asarray, tree), key)
        mix = gossip.make_mixer(omega, "cpu", config=pcfg)
        mode, _ = jgossip.plan_mixer(omega, jcfg)
        assert mix.mode == mode
        got = mix({"a": torch.from_numpy(x),
                   "b": {"c": torch.from_numpy(tree["b"]["c"])}},
                  _port_key(key))
        for (path, g), w in zip(tree_leaves_with_path(got),
                                jax.tree.leaves(want)):
            if mode == "dense":
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-9)
            else:
                np.testing.assert_array_equal(_bits(g.numpy()), _bits(w),
                                              err_msg=f"{k} {path}")


@pytest.mark.parametrize("p,pairs", [(0.1, 0), (0.5, 0), (0.0, 1),
                                     (0.0, 3), (0.1, 2), (0.9, 6),
                                     (0.3, 7)])
def test_masks_are_the_reference_masks(p, pairs):
    """``_matching_masks`` of the geometric graph at K=10 (7 matchings)
    under 16 keys, and the drawn masks' program beside it: exact."""
    omega, jcfg, _ = _omega("geometric", 10)
    sched = jgossip.plan_mixer(omega, jcfg.replace(link_failure_prob=0.5))[1]
    assert sched.num_perms == 7
    mask_fn = jax.jit(lambda key: jgossip._matching_masks(sched, key, p,
                                                          pairs))
    port_sched = build_topology(TopologyConfig(graph="geometric",
                                               radius=0.5), 10)
    assert np.array_equal(port_sched.omega, omega)
    for seed in range(16):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
        want = np.asarray(mask_fn(key))
        got = gossip.matching_masks(sched, _port_key(key), p, pairs)
        np.testing.assert_array_equal(got.numpy(), want)


def test_ring_mix_and_schedule_mix_are_the_references():
    """The back-compat ``ring_mix`` and the functional ``schedule_mix``
    (static, and time-varying under a key)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 50)).astype(np.float32)
    omega, _, _ = _omega("ring", 6)
    want = jax.jit(lambda t: jgossip.ring_mix(omega, t))({"a": x})["a"]
    got = gossip.ring_mix(omega, {"a": torch.from_numpy(x)})["a"]
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    omega, jcfg, _ = _omega("geometric", 6)
    sched = jgossip.plan_mixer(omega, jcfg.replace(gossip_pairs=1))[1]
    key = jax.random.PRNGKey(9)
    for kw in (dict(), dict(link_failure_prob=0.4, gossip_pairs=2)):
        want = jax.jit(lambda t, k: jgossip.schedule_mix(sched, t, k, **kw))(
            {"a": x}, key)["a"]
        got = gossip.schedule_mix(sched, {"a": torch.from_numpy(x)},
                                  _port_key(key), **kw)["a"]
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("k", [1, 2])
def test_ring_mix_below_three_nodes_is_the_references(k):
    """Below K = 3 ``ring_mix`` is the dense einsum in both packages (Ω on
    the leaves' device); within rtol 1e-6 of the jitted reference (a
    matmul's summation order)."""
    x = np.random.default_rng(k).standard_normal((k, 50)).astype(np.float32)
    omega, _, _ = _omega("ring", k)
    want = jax.jit(lambda t: jgossip.ring_mix(omega, t))({"a": x})["a"]
    got = gossip.ring_mix(omega, {"a": torch.from_numpy(x)})["a"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_unported_mixer_options_name_their_item():
    """``link_probs`` (ROADMAP A8) and ``node_mask`` (A7) used to raise;
    they run now, as the jitted reference mixer does on the ring: a
    ``link_probs`` forces the time-varying schedule, and a node mask
    mixes by the Laplacian form with its edge mask, bit for bit."""
    omega, jcfg, pcfg = _omega("ring", 5)
    outage = lambda s: np.where(s.perms != np.arange(s.k), 0.4, 0.0)
    x = np.random.default_rng(5).standard_normal((5, 3)).astype(np.float32)
    p = np.array([1, 0, 1, 1, 0], np.float32)
    key = jax.random.PRNGKey(3)
    for probs, mask in ((outage, None), (None, p), (outage, p)):
        want = jax.jit(lambda t, k, m: jgossip.make_mixer(
            omega, config=jcfg, link_probs=probs)(t, k, m))(
                {"a": jnp.asarray(x)}, key,
                None if mask is None else jnp.asarray(mask))["a"]
        mix = gossip.make_mixer(omega, "cpu", config=pcfg, link_probs=probs)
        assert mix.mode == ("schedule_tv" if probs else "schedule")
        got = mix({"a": torch.from_numpy(x)}, _port_key(key),
                  None if mask is None else torch.from_numpy(mask))["a"]
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_as_keyed_mixer_adapts_legacy_mixers():
    tree = {"a": torch.ones(3, 2)}
    one = gossip.as_keyed_mixer(lambda t: t)
    two = gossip.as_keyed_mixer(lambda t, k: t)
    full = gossip.make_mixer(np.eye(1), "cpu")
    assert gossip.as_keyed_mixer(full) is full
    for mix in (one, two):
        assert mix(tree, None) is tree
        with pytest.raises(ValueError, match="participation"):
            mix(tree, None, torch.ones(3))


# -- rounds on a sparse and a time-varying graph ---------------------------

K, L, M = 5, 2, 5
FED = dict(num_nodes=K, local_steps=L, eta=3e-3, zeta=0.3, temperature=0.2,
           burn_in=1, rounds=2)
GEO_TV = dict(graph="geometric", radius=0.5, link_failure_prob=0.1,
              gossip_pairs=2)
GRAPH_RUNS = {"ring": (dict(topology="ring"), None),
              "geometric-tv": (dict(), GEO_TV)}


def _feds(graph, algorithm):
    fed, tc = GRAPH_RUNS[graph]
    base = dict(FED, algorithm=algorithm, **fed)
    return (JaxFedConfig(**base, topology_cfg=JaxTopologyConfig(**tc)
                         if tc else None),
            FedConfig(**base, topology_cfg=TopologyConfig(**tc)
                      if tc else None))


def _reference_rounds(graph, algorithm):
    jfed, _ = _feds(graph, algorithm)
    model = jax_get_model(jax_get_arch("lenet-radar").reduced)
    shards = partition_iid(make_dataset(K * 20, hw=(32, 16), seed=0), K)
    dshards = JaxDeviceShards.from_shards(shards)
    data_scale = float(np.mean([len(s["y"]) for s in shards]))
    key = jax.random.PRNGKey(0)
    params0 = model.init(key)
    state = init_fed_state(params0, jfed, key=key)
    omega = jbuild_topology(resolve_topology(jfed), K).omega
    round_fn = jax.jit(make_round_fn(algorithm, model.loss, jfed, omega,
                                     make_compressor(jfed), data_scale))
    key = jax.random.PRNGKey(1)
    out = []
    for _ in range(2):
        key, kround = jax.random.split(key)
        idx = dshards.sample_indices(round_data_key(kround), L, M)
        state, metrics = round_fn(state, dshards.gather(idx), kround)
        out.append((np.asarray(idx), state, float(metrics.wire_bytes),
                    _port_key(kround)))
    return shards, data_scale, jax.tree.map(np.asarray, params0), omega, out


@pytest.mark.parametrize("algorithm", ["cdbfl", "dsgld", "cffl"])
@pytest.mark.parametrize("graph", list(GRAPH_RUNS))
def test_two_rounds_on_the_graph_track_the_reference(graph, algorithm):
    shards, data_scale, params0, omega, rounds = _reference_rounds(
        graph, algorithm)
    _, fed = _feds(graph, algorithm)
    model = get_model(get_arch("lenet-radar", reduced=True))
    round_fn = port_alg.make_round_fn(algorithm, model.nll, fed, omega,
                                      port_compressor(fed), data_scale, "cpu")
    assert round_fn.mixer.mode == ("schedule" if graph == "ring"
                                   else "schedule_tv")
    dshards = DeviceShards.from_shards(shards, "cpu")
    state = port_state.init_fed_state(params_from_jax(params0), fed)
    for idx, ref, ref_wire, kround in rounds:
        state, metrics = round_fn(state, dshards.gather(idx), kround)
        assert metrics.wire_bytes == ref_wire
        for name in ("params", "v", "v_bar"):
            for (path, g), w in zip(
                    tree_leaves_with_path(getattr(state, name)),
                    jax.tree.leaves(getattr(ref, name))):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{name}.{path}")


def test_time_varying_draws_join_the_round_draws():
    """On the time-varying graph the round's draws are ``(draws, masks)``,
    the masks those of ``kmix`` (cdbfl and cffl: ``fold_in(key, 2)``;
    dsgld: ``split(key)[1]``), and the noise and uniforms those of the
    static graph's round; a static graph's draws are unchanged."""
    model = get_model(get_arch("lenet-radar", reduced=True))
    key = _port_key(jax.random.PRNGKey(4))
    for algorithm in ("cdbfl", "dsgld", "cffl"):
        _, tv = _feds("geometric-tv", algorithm)
        _, static = _feds("ring", algorithm)
        params = port_state.init_fed_state(model.init(
            _port_key(jax.random.PRNGKey(0)), "cpu"), tv).params
        omega = build_topology(tv.topology_cfg, K).omega
        fns = [port_alg.make_round_fn(algorithm, model.nll, f, om,
                                      port_compressor(f), 1.0, "cpu")
               for f, om in ((tv, omega), (static, build_topology(
                   TopologyConfig(graph="ring"), K).omega))]
        (base, masks), plain = (fn.draws(key, params) for fn in fns)
        flat = lambda d: [x for t in (d if isinstance(d, tuple) else (d,))
                          for x in tree_leaves(t)]
        assert len(flat(base)) == len(flat(plain))
        for a, b in zip(flat(base), flat(plain)):
            assert torch.equal(a, b)
        kmix = (random.split(key)[1] if algorithm == "dsgld"
                else random.fold_in(key, 2))
        sched = fns[0].mixer.schedule
        want = jgossip._matching_masks(sched, jnp.asarray(
            kmix.numpy().astype(np.uint32)), 0.1, 2)
        np.testing.assert_array_equal(masks.numpy(), np.asarray(want))


@pytest.mark.parametrize("algorithm", ["cdbfl", "dsgld", "cffl"])
def test_scan_engine_equals_host_engine_on_a_time_varying_graph(algorithm):
    """Four rounds, chunks of 3, on the time-varying geometric graph: the
    masks are drawn inside the chunk; params, v, v̄, key, losses,
    consensus, bytes and the bank bit for bit."""
    _, fed = _feds("geometric-tv", algorithm)
    cfg = get_arch("lenet-radar", reduced=True)
    shards = partition_iid(make_dataset(K * 20, hw=cfg.input_hw, seed=0), K)
    runs = []
    for engine in ("host", "scan"):
        trainer = FedTrainer(get_model(cfg), fed, shards, minibatch=M, seed=0,
                             engine=engine, chunk=3, bank_thin=1,
                             bank_capacity=2, device="cpu")
        runs.append((trainer, trainer.run(rounds=4)))
    (host, hres), (scan, sres) = runs
    assert sres.loss_history == hres.loss_history
    assert sres.consensus_history == hres.consensus_history
    assert sres.wire_history == hres.wire_history
    for part in ("params", "v", "v_bar"):
        for x, y in zip(tree_leaves(getattr(scan.state, part)),
                        tree_leaves(getattr(host.state, part))):
            assert torch.equal(x, y), part
    assert torch.equal(scan.key, host.key)
    assert len(scan.bank) == len(host.bank)
    for s, h in zip(scan.bank.samples, host.bank.samples):
        for x, y in zip(tree_leaves(s), tree_leaves(h)):
            assert torch.equal(x, y)


def test_time_varying_masks_add_no_draw_level(monkeypatch):
    """The masks' draws run beside the round's others: still one table
    launch a level, five a round with the engine's split; ``split(kmix)``,
    the dropout uniforms, ``choice``'s split and its sort keys join the
    levels of the node keys, the leaf keys and the draws."""
    from repro_torch.kernels import threefry
    from repro_torch.train.engine import round_indices
    _, fed = _feds("geometric-tv", "cdbfl")
    fed = fed.__class__(**{**vars(fed), "pipeline": "block_topk|qsgd",
                           "fused_compress": True})
    model = get_model(get_arch("lenet-radar", reduced=True))
    params = port_state.init_fed_state(model.init(random.PRNGKey(0), "cpu"),
                                       fed).params
    omega = build_topology(fed.topology_cfg, K).omega
    round_fn = port_alg.make_cdbfl_round(model.nll, fed, omega,
                                         port_compressor(fed), 1.0, "cpu")
    shards = DeviceShards.from_shards(partition_iid(
        make_dataset(K * 6, hw=(32, 16), seed=0), K), "cpu")
    calls = []
    draw = threefry.draw
    monkeypatch.setattr(threefry, "draw",
                        lambda reqs: calls.append(len(reqs)) or draw(reqs))
    key, kround = random.split(random.PRNGKey(1))
    idx, ((noise, uniforms), masks) = random.run(random.together(
        round_indices.program(shards, kround, 2, 5),
        round_fn.draws.program(kround, params)))
    assert calls == [1, 2, 3 + 1, 3 + 2, 2 + 10 + 10 + 1]
    assert masks.shape == (3, K) and len(uniforms) == 10


@pytest.mark.parametrize("algorithm", ["cdbfl", "dsgld"])
def test_recorded_masks_are_the_masks_the_rounds_apply(algorithm,
                                                       monkeypatch):
    """``tests/torch_golden.py``'s ``round_masks`` (the masks of
    ``topology_rounds_lenet_radar.json``) re-derives each round's ``kmix``
    from the engine's key stream; here it equals the masks the reference's
    jitted rounds apply (``_matching_masks`` recorded from inside the
    round), and those equal the masks the port's host engine hands its
    mixer (read off the draws the engine passes ``round_fn``), two rounds
    on the time-varying geometric graph."""
    from repro.train import FedTrainer as JaxFedTrainer
    from torch_golden import round_masks
    jfed, fed = _feds("geometric-tv", algorithm)
    cfg = get_arch("lenet-radar", reduced=True)
    shards = partition_iid(make_dataset(K * 20, hw=cfg.input_hw, seed=0), K)
    applied, inner_masks = [], jgossip._matching_masks

    def recording(*args, **kw):
        masks = inner_masks(*args, **kw)
        jax.debug.callback(lambda m: applied.append(np.asarray(m)), masks)
        return masks

    monkeypatch.setattr(jgossip, "_matching_masks", recording)
    ref = JaxFedTrainer(jax_get_model(jax_get_arch("lenet-radar").reduced),
                        jfed, shards, minibatch=M, seed=0, engine="host")
    ref.run(rounds=2)
    monkeypatch.undo()
    derived = round_masks(jfed, ref.omega, jax.random.PRNGKey(1), 2)
    assert len(applied) == 2
    assert [m.tolist() for m in applied] == derived

    port = FedTrainer(get_model(cfg), fed, shards, minibatch=M, seed=0,
                      engine="host", device="cpu")
    eng, got = port._engine, []
    inner = eng.round_fn

    def hooked(state, batches, key, draws=None):
        got.append(port_alg._split_masks(inner.mixer, draws)[1].numpy().copy())
        return inner(state, batches, key, draws)

    hooked.draws, hooked.mixer = inner.draws, inner.mixer
    eng.round_fn = hooked
    port.run(rounds=2)
    assert [m.tolist() for m in got] == derived
