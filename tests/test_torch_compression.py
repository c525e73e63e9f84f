"""The port's FusedCodec (both ``fused`` settings) against the reference's
on the reduced LeNet tree, node-stacked: payload buffers, measured bytes,
leaf order and decode, all exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig, get_arch as jax_get_arch
from repro.core.compression import FusedCodec as JaxFusedCodec
from repro.core.compression import make_compressor as jax_make_compressor
from repro.core.compression import parse_pipeline
from repro.models import get_model as jax_get_model
from repro_torch.config import FedConfig, get_arch
from repro_torch.core.compression import (BlockTopKCodec, CompressionPipeline,
                                          FusedCodec, make_compressor)
from repro_torch.models import get_model
from repro_torch.utils.tree import tree_leaves_with_path, tree_map

K = 3


@pytest.fixture(scope="module")
def trees():
    params = jax_get_model(jax_get_arch("lenet-radar").reduced).init(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    theta = jax.tree.map(lambda x: rng.standard_normal(
        (K,) + x.shape).astype(np.float32), params)
    v = jax.tree.map(lambda x: rng.standard_normal(
        (K,) + x.shape).astype(np.float32) * 0.1, params)
    return theta, v


def _torch_tree(np_tree):
    return {k: (_torch_tree(v) if isinstance(v, dict)
                else torch.from_numpy(np.asarray(v))) for k, v in np_tree.items()}


@pytest.mark.parametrize("fused", [True, False])
def test_encode_pair_decode_match_reference(trees, fused):
    theta, v = trees
    ref = JaxFusedCodec.wrap(parse_pipeline("block_topk"), fused=fused)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(1), i))(
        jnp.arange(K))
    want = jax.vmap(ref.encode_pair)(theta, v, keys)
    port = FusedCodec.wrap(CompressionPipeline((BlockTopKCodec(),)), fused=fused)
    got = port.encode_pair(_torch_tree(theta), _torch_tree(v))

    want_paths = [jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(theta)[0]]
    assert [p.replace(".", "']['") for p in got.paths] == \
        [s[2:-2] for s in want_paths]
    assert got.measured_bytes() == want.measured_bytes()
    assert got.per_leaf_bytes() == want.per_leaf_bytes()
    for g, w, gs, ws in zip(got.entries, want.entries, got.specs, want.specs):
        np.testing.assert_array_equal(g.wire.numpy(), np.asarray(w.wire))
        assert g.aux[0]["idx"].dtype == torch.uint16
        np.testing.assert_array_equal(g.aux[0]["idx"].numpy(),
                                      np.asarray(w.aux[0]["idx"]))
        assert gs.shape == ws.shape and gs.metas[0] == ws.metas[0]

    dec_want = jax.vmap(ref.decode)(want)
    dec_got = port.decode(got)
    for (p, g), w in zip(tree_leaves_with_path(dec_got), jax.tree.leaves(dec_want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=p)


def test_fused_and_two_pass_payloads_agree(trees):
    theta, v = _torch_tree(trees[0]), _torch_tree(trees[1])
    a = FusedCodec.wrap(CompressionPipeline((BlockTopKCodec(),)), fused=True)
    b = FusedCodec.wrap(CompressionPipeline((BlockTopKCodec(),)), fused=False)
    pa, pb = a.encode_pair(theta, v), b.encode_pair(theta, v)
    for ea, eb in zip(pa.entries, pb.entries):
        assert torch.equal(ea.wire, eb.wire)
        assert torch.equal(ea.aux[0]["idx"], eb.aux[0]["idx"])


@pytest.mark.parametrize("reduced,want", [(True, 1056), (False, 168036)])
def test_wire_bytes_match_reference(reduced, want):
    """Shape-only: per-node bytes of one model. Full width is the slice's
    2,546 blocks x 11 survivors x (4 + 2) bytes = 168,036."""
    cfg = get_arch("lenet-radar", reduced=reduced)
    params = get_model(cfg).init(torch.Generator().manual_seed(0), "meta")
    got = make_compressor(FedConfig(fused_compress=True)).wire_bytes(params)
    jcfg = jax_get_arch("lenet-radar")
    jcfg = jcfg.reduced if reduced else jcfg.config
    jparams = jax.eval_shape(jax_get_model(jcfg).init, jax.random.PRNGKey(0))
    ref = jax_make_compressor(JaxFedConfig(fused_compress=True))
    assert got == ref.wire_bytes(jparams) == want


def test_make_compressor_refuses_unported_values():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_compressor(FedConfig(fused_compress=False))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_compressor(FedConfig(fused_compress=True, compressor="qsgd"))


def test_min_dense_size_leaves_ride_dense(trees):
    theta, v = _torch_tree(trees[0]), _torch_tree(trees[1])
    codec = FusedCodec.wrap(CompressionPipeline((BlockTopKCodec(),),
                                                min_dense_size=200))
    payload = codec.encode_pair(theta, v)
    dec = codec.decode(payload)
    np.testing.assert_array_equal(dec["conv1"]["w"].numpy(),
                                  (theta["conv1"]["w"] - v["conv1"]["w"]).numpy())
    assert tree_map(lambda x: x.shape, dec) == tree_map(lambda x: x.shape, theta)
