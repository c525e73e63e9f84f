"""One round, then five, of the port's ``make_cdbfl_round`` against the
reference's, on the reduced LeNet with K=3: each round gets the
reference's minibatches (``DeviceShards.sample_indices(round_data_key(
kround), L, M)``) and the reference's round key ``kround``, from which the
port's round draws its own Langevin noise and QSGD uniforms, as the
reference's does. ``block_topk`` runs 1 and 5 rounds; the
``block_topk|qsgd`` pipeline and the legacy ``qsgd_pallas`` and
``block_topk_pallas`` compressors 1 and 3. Beside them, the draws alone:
the port's noise and uniforms of a round against the reference's
(``algorithms._langevin_noise`` and
``test_torch_compression.reference_uniforms``), exactly.

Tolerances and why:
- wire bytes: exact (a function of shapes).
- survivor index sets: the same set in >= 99.9% of blocks. The local steps
  differ from XLA's in the last bits (convolution and matmul summation
  order), and a block whose 11th and 12th magnitudes lie closer than that
  can swap a survivor. At these shapes every block agrees.
- params, v and v̄: within rtol 1e-4 / atol 1e-6 of the reference after
  each round. The differences are the last-bit differences of the local
  steps, carried by the linear parts of the update; they stay near 1e-6
  relative over five rounds.
- QSGD grids: a grid element may move one step where its uniform lies
  within the residual's last bits of its fraction (and the port's norm,
  a torch reduction, may differ from XLA's in the last bit). A flip is
  counted on the round's decoded delta, against the reference's decode of
  the same round: an element off by one grid step, ``‖x‖/s/(1+ω)`` of its
  node's carrier or leaf (``assert_grid_close``, at most 0.1% of the
  elements). The state after the round is then held to the tolerance
  above everywhere except at the flipped elements of v (the sender's
  control variate absorbs the whole step) and of every node's v̄ and
  params at those positions.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig, get_arch as jax_get_arch
from repro.core import (build_topology, init_fed_state, make_cdbfl_round,
                        make_compressor, resolve_topology)
from repro.core.algorithms import _langevin_noise, _local_sgd
from repro.data.partition import DeviceShards as JaxDeviceShards
from repro.data.partition import partition_iid
from repro.data.radar import make_dataset
from repro.models import get_model as jax_get_model
from repro.train.engine import round_data_key
from repro_torch.config import FedConfig, get_arch
from repro_torch.core import algorithms as port_alg
from repro_torch.core import fed_state as port_state
from repro_torch.core.compression import make_compressor as port_compressor
from repro_torch.data.partition import DeviceShards
from repro_torch.models import get_model
from repro_torch.models.lenet import params_from_jax
from repro_torch.train.engine import round_indices
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path
from test_torch_compression import assert_grid_close, reference_uniforms

import torch_threads  # noqa: F401  (one torch thread a process)

K, L, M = 3, 2, 5
FED = dict(num_nodes=K, local_steps=L, eta=3e-3, zeta=0.3, temperature=0.2,
           burn_in=2, rounds=5, compressor="block_topk", fused_compress=True,
           topology="full")
RTOL, ATOL = 1e-4, 1e-6
MIN_BLOCK_AGREEMENT = 0.999
# the slice-2 configurations: FedConfig overrides, uniforms kind, bytes/node
QSGD_CONFIGS = {
    "block_topk|qsgd": (dict(pipeline="block_topk|qsgd"), "pipeline", 568.0),
    "qsgd_pallas": (dict(compressor="qsgd_pallas", fused_compress=False),
                    "qsgd_pallas", 6629.0),
    "block_topk_pallas": (dict(compressor="block_topk_pallas",
                               fused_compress=False), None, 528.0),
}


def _reference_rounds(num_rounds, overrides=None, uniforms_kind=None):
    """Run the reference round; per round (idx, noise, theta_L's payload,
    state after the round, wire bytes, uniforms, grid steps, round key)."""
    fed = JaxFedConfig(**dict(FED, **(overrides or {})))
    model = jax_get_model(jax_get_arch("lenet-radar").reduced)
    shards = partition_iid(make_dataset(K * 20, hw=(32, 16), seed=0), K)
    dshards = JaxDeviceShards.from_shards(shards)
    data_scale = float(np.mean([len(s["y"]) for s in shards]))
    key = jax.random.PRNGKey(0)
    params0 = model.init(key)
    state = init_fed_state(params0, fed, key=key)
    omega = build_topology(resolve_topology(fed), K).omega
    comp = make_compressor(fed)
    round_fn = jax.jit(make_cdbfl_round(model.loss, fed, omega, comp,
                                        data_scale))
    local = jax.jit(jax.vmap(partial(
        _local_sgd, loss_fn=model.loss, eta=fed.eta, prior_weight=1.0 / K,
        data_scale=data_scale, num_steps_static=L)))
    pipeline = hasattr(comp, "encode_pair")
    encode = jax.jit(jax.vmap(comp.encode_pair)) if pipeline else None
    draw_noise = jax.jit(lambda k, p: _langevin_noise(
        k, p, fed.eta, fed.temperature, jnp.arange(K)))
    draw_idx = jax.jit(lambda k: dshards.sample_indices(round_data_key(k), L, M))
    key = jax.random.PRNGKey(1)
    out = []
    for _ in range(num_rounds):
        key, kround = jax.random.split(key)
        idx = draw_idx(kround)
        batches = dshards.gather(idx)
        kql, knoise = jax.random.split(kround)
        noise = draw_noise(knoise, state.params)
        node_keys = jax.vmap(jax.random.fold_in, in_axes=(0, None))(
            state.key, state.round)
        theta_l, _ = local(state.params, batches, node_keys)
        keys = jax.vmap(lambda i: jax.random.fold_in(kql, i))(jnp.arange(K))
        payload = encode(theta_l, state.v, keys) if pipeline else None
        uniforms, steps = {}, None
        if uniforms_kind is not None:
            uniforms = reference_uniforms(uniforms_kind, state.params, kql)
            steps = _grid_steps(uniforms_kind, payload, jax.tree.map(
                lambda t, v: t - v, theta_l, state.v), fed.qsgd_levels)
        state, metrics = round_fn(state, batches, kround)
        out.append((np.asarray(idx), jax.tree.map(np.asarray, noise),
                    payload, state, float(metrics.wire_bytes), uniforms,
                    steps, _key(kround)))
    return shards, data_scale, jax.tree.map(np.asarray, params0), out


def _grid_steps(kind, payload, residual, levels):
    """One QSGD grid step ``‖x‖/s/(1+ω)`` of each node's carrier (pipeline,
    from the payload's scale) or leaf (dense), by dotted path, shaped to
    broadcast over the leaf."""
    steps = {}
    for i, (path, leaf) in enumerate(jax.tree_util.tree_flatten_with_path(
            residual)[0]):
        r = np.asarray(leaf, np.float64).reshape(K, -1)
        if kind == "pipeline":
            norm = np.asarray(payload.entries[i].aux[1]["scale"], np.float64)
            n = payload.entries[i].wire[0].size
        else:
            norm = np.linalg.norm(r, axis=1)
            n = r.shape[1]
        omega = min(n / levels ** 2, np.sqrt(n) / levels)
        steps[".".join(k.key for k in path)] = (
            norm.reshape(K) / levels / (1 + omega)).reshape(
                (K,) + (1,) * (leaf.ndim - 1))
    return steps


def _key(key) -> torch.Tensor:
    """A reference key as the port's ``(2,)`` int64 key."""
    return torch.from_numpy(np.asarray(key).astype(np.int64))


@pytest.fixture(scope="module")
def reference():
    return _reference_rounds(5)


def _port_round(shards, data_scale, overrides=None):
    fed = FedConfig(**dict(FED, **(overrides or {})))
    model = get_model(get_arch("lenet-radar").reduced)
    omega = build_topology(resolve_topology(JaxFedConfig(**FED)), K).omega
    return (port_alg.make_cdbfl_round(model.nll, fed, omega,
                                      port_compressor(fed), data_scale, "cpu"),
            DeviceShards.from_shards(shards, "cpu"), fed)


def _block_agreement(port_payload, ref_payload) -> float:
    same = total = 0
    for g, w in zip(port_payload.entries, ref_payload.entries):
        gi = np.sort(g.aux[0]["idx"].numpy().astype(np.int64), axis=-1)
        wi = np.sort(np.asarray(w.aux[0]["idx"]).astype(np.int64), axis=-1)
        same += int(np.all(gi == wi, axis=-1).sum())
        total += gi.shape[0] * gi.shape[1]
    return same / total


def _assert_state_close(port, ref):
    for name in ("params", "v", "v_bar"):
        for (path, g), w in zip(tree_leaves_with_path(getattr(port, name)),
                                jax.tree.leaves(getattr(ref, name))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name}.{path}")


@pytest.mark.parametrize("num_rounds", [1, 5])
def test_rounds_track_reference(reference, num_rounds):
    shards, data_scale, params0, rounds = reference
    round_fn, dshards, fed = _port_round(shards, data_scale)
    state = port_state.init_fed_state(params_from_jax(params0), fed)
    for idx, _, ref_payload, ref_state, ref_wire, _, _, kround in \
            rounds[:num_rounds]:
        state, metrics = round_fn(state, dshards.gather(idx), kround)
        assert metrics.wire_bytes == ref_wire == 1056.0
        assert metrics.payload.measured_bytes() == ref_payload.measured_bytes()
        assert _block_agreement(metrics.payload, ref_payload) >= MIN_BLOCK_AGREEMENT
        _assert_state_close(state, ref_state)
        assert all(torch.isfinite(x).all() for x in tree_leaves(state.params))
    assert state.round == num_rounds


@pytest.fixture(scope="module")
def qsgd_references():
    cache = {}

    def get(name):
        if name not in cache:
            overrides, kind, _ = QSGD_CONFIGS[name]
            cache[name] = _reference_rounds(3, overrides, kind)
        return cache[name]
    return get


def _flips(port_v, old_v, ref_v, ref_old_v, steps):
    """Positions where the port's delta (its v's increment) is off the
    reference's by one QSGD grid step; asserts the flip rule."""
    flipped = {}
    for (path, g), g0, w, w0 in zip(tree_leaves_with_path(port_v),
                                    tree_leaves(old_v),
                                    jax.tree.leaves(ref_v),
                                    jax.tree.leaves(ref_old_v)):
        got = g.double().numpy() - g0.double().numpy()
        want = np.asarray(w, np.float64) - np.asarray(w0, np.float64)
        off = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
        if steps is None:
            assert not off.any(), path
        else:
            assert off.sum() <= 1e-3 * off.size, (path, off.sum())
            step = np.broadcast_to(steps[path], off.shape)
            np.testing.assert_allclose(np.abs(got - want)[off], step[off],
                                       rtol=1e-3, err_msg=path)
        flipped[path] = off
    return flipped


def _assert_state_close_but(port, ref, flipped):
    """The state tolerance, except where a grid flip moved the state: v of
    the flipped node, v̄ and params of every node at that position."""
    for name in ("params", "v", "v_bar"):
        for (path, g), w in zip(tree_leaves_with_path(getattr(port, name)),
                                jax.tree.leaves(getattr(ref, name))):
            g, w = g.numpy(), np.asarray(w)
            skip = flipped[path] if name == "v" else \
                np.broadcast_to(flipped[path].any(axis=0), g.shape)
            np.testing.assert_allclose(g[~skip], w[~skip], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name}.{path}")


@pytest.mark.parametrize("num_rounds", [1, 3])
@pytest.mark.parametrize("name", list(QSGD_CONFIGS))
def test_qsgd_and_dense_rounds_track_reference(qsgd_references, name,
                                               num_rounds):
    overrides, kind, wire = QSGD_CONFIGS[name]
    shards, data_scale, params0, rounds = qsgd_references(name)
    round_fn, dshards, fed = _port_round(shards, data_scale, overrides)
    state = port_state.init_fed_state(params_from_jax(params0), fed)
    ref_v = jax.tree.map(np.zeros_like, state.v)
    flipped = {p: np.zeros(tuple(x.shape), bool)
               for p, x in tree_leaves_with_path(state.params)}
    for (idx, _, ref_payload, ref_state, ref_wire, _, steps,
         kround) in rounds[:num_rounds]:
        old_v = state.v
        state, metrics = round_fn(state, dshards.gather(idx), kround)
        assert metrics.wire_bytes == ref_wire == wire
        if ref_payload is not None:
            assert metrics.payload.measured_bytes() == \
                ref_payload.measured_bytes()
            assert _block_agreement(metrics.payload, ref_payload) >= \
                MIN_BLOCK_AGREEMENT
        else:
            assert metrics.payload is None
        new = _flips(state.v, old_v, ref_state.v, ref_v, steps)
        flipped = {p: flipped[p] | new[p] for p in flipped}
        ref_v = ref_state.v
        _assert_state_close_but(state, ref_state, flipped)
        assert all(torch.isfinite(x).all() for x in tree_leaves(state.params))
    assert state.round == num_rounds


@pytest.mark.parametrize("name", ["block_topk"] + list(QSGD_CONFIGS))
def test_round_draws_equal_reference(reference, qsgd_references, name):
    """From the reference's round keys, the port's minibatch indices
    (``round_indices``), Langevin noise and QSGD uniforms (the pipeline's
    ``fold_in(leaf_key, 1)`` streams, the legacy ``qsgd_pallas``'s leaf
    keys; none for block-top-k alone) equal the reference's bit for bit:
    the noise's erfinv and log1p transcribe XLA's."""
    overrides = None if name == "block_topk" else QSGD_CONFIGS[name][0]
    shards, data_scale, params0, rounds = (
        reference if name == "block_topk" else qsgd_references(name))
    round_fn, dshards, fed = _port_round(shards, data_scale, overrides)
    params = port_state.init_fed_state(params_from_jax(params0), fed).params
    for idx, noise, _, _, _, uniforms, _, kround in rounds:
        np.testing.assert_array_equal(
            round_indices(dshards, kround, L, M).numpy(), idx)
        got_noise, got_uniforms = round_fn.draws(kround, params)
        for (path, g), w in zip(tree_leaves_with_path(got_noise),
                                jax.tree.leaves(noise)):
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          np.asarray(w).view(np.int32),
                                          err_msg=path)
        assert list(got_uniforms) == list(uniforms)
        for path, u in uniforms.items():
            np.testing.assert_array_equal(
                got_uniforms[path].numpy().view(np.int32),
                u.view(np.int32), err_msg=path)
