"""The port's compressors against the reference's on the reduced LeNet
tree, node-stacked (K=3), with the reference's own QSGD uniforms handed in
(:func:`reference_uniforms`).

- ``block_topk`` FusedCodec (both ``fused`` settings): payload buffers,
  measured bytes, leaf order and decode, all exact.
- ``block_topk|qsgd`` FusedCodec: indices, metadata and bytes exact. The
  int8 grid and the f32 scale are held to a tolerance: the port's norm is a
  torch reduction whose summation order differs from XLA's, so the scale
  may differ in its last bits (rtol ``SCALE_RTOL``), and a grid element may
  move one step where its uniform lies within those bits of its fraction
  (at most ``MAX_FLIP_SHARE`` of the elements, each by one step). Decode is
  exact: the reference's payload decoded by the port equals the
  reference's jit-compiled decode (the form its round runs).
- The legacy ``block_topk_pallas`` Compressor exact; ``qsgd_pallas`` within
  the same norm tolerance, a moved grid element counted as a one-step
  difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig, get_arch as jax_get_arch
from repro.core.compression import Compressor as JaxCompressor
from repro.core.compression import FusedCodec as JaxFusedCodec
from repro.core.compression import make_compressor as jax_make_compressor
from repro.core.compression import parse_pipeline
from repro.models import get_model as jax_get_model
from repro_torch import random
from repro_torch.config import FedConfig, get_arch
from repro_torch.core.compression import (BlockTopKCodec, CompressionPipeline,
                                          Compressor, FusedCodec, LeafPayload,
                                          QSGDCodec, WirePayload,
                                          draw_uniforms, make_compressor)
from repro_torch.models import get_model
from repro_torch.utils.tree import tree_leaves_with_path, tree_map

import torch_threads  # noqa: F401  (one torch thread a process)

K = 3
PIPE = "block_topk|qsgd"
SCALE_RTOL = 1e-6           # a few ulps of f32
MAX_FLIP_SHARE = 1e-3


def reference_uniforms(kind, tree, key, ratio=0.01, block_size=1024):
    """The reference's QSGD uniforms for node-stacked ``tree``, by the
    port's dotted leaf path. Node key ``fold_in(key, k)``
    (``algorithms.py:182-184``), leaf key ``split(node_key, n_leaves)[i]``
    (``compression.py:719-723``; ``utils/tree.py:70-74``), then for the
    ``block_topk|qsgd`` pipeline ``uniform(fold_in(leaf_key, 1), (nb, k))``
    (``compression.py:674-677``, ``ops.py:190``) and for ``qsgd_pallas``
    ``uniform(leaf_key, leaf shape)`` (``ops.py:127``)."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    num_nodes = leaves[0][1].shape[0]
    node_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(num_nodes))
    leaf_keys = jax.vmap(lambda nk: jax.random.split(nk, len(leaves)))(
        node_keys)
    out = {}
    for i, (path, x) in enumerate(leaves):
        shape = tuple(x.shape[1:])
        if kind == "pipeline":
            n = int(np.prod(shape))
            nb_k = (max(1, -(-n // block_size)),
                    max(1, int(np.ceil(ratio * block_size))))
            draw = lambda lk: jax.random.uniform(jax.random.fold_in(lk, 1),
                                                 nb_k)
        else:
            draw = lambda lk: jax.random.uniform(lk, shape, jnp.float32)
        out[".".join(k.key for k in path)] = np.array(
            jax.vmap(draw)(leaf_keys[:, i]))
    return out


def _node_keys(key):
    return jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(K))


def assert_grid_close(got, want, scale):
    """``got`` and ``want`` equal within ``SCALE_RTOL``, but for at most
    ``MAX_FLIP_SHARE`` of the elements, each differing by one QSGD grid
    step ``scale`` (a uniform within the norm's last bits of its
    fraction); ``scale`` broadcasts against the values."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.broadcast_to(np.asarray(scale, np.float64), got.shape)
    off = ~np.isclose(got, want, rtol=SCALE_RTOL, atol=0)
    assert off.sum() <= MAX_FLIP_SHARE * got.size, off.sum()
    np.testing.assert_allclose(np.abs(got - want)[off], scale[off],
                               rtol=1e-5)


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
    spec = get_arch("lenet-radar")
    cfg = spec.reduced if reduced else spec.config
    params = get_model(cfg).init(random.PRNGKey(0, "meta"), "meta")
    got = make_compressor(FedConfig(fused_compress=True)).wire_bytes(params)
    jcfg = jax_get_arch("lenet-radar")
    jcfg = jcfg.reduced if reduced else jcfg.config
    jparams = jax.eval_shape(jax_get_model(jcfg).init, jax.random.PRNGKey(0))
    ref = jax_make_compressor(JaxFedConfig(fused_compress=True))
    assert got == ref.wire_bytes(jparams) == want


def test_make_compressor_refuses_unported_values():
    """``layer_pipelines`` runs (ROADMAP A6's PerLayerPipeline); a level
    count that is not a power of two still refuses (C5)."""
    assert make_compressor(FedConfig(layer_pipelines=(("fc", "qsgd"),))
                           ).rules[0][0] == "fc"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_compressor(FedConfig(control_dtype="float16"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_compressor(FedConfig(fused_compress=True, qsgd_levels=10))


def test_min_dense_size_leaves_ride_dense(trees):
    theta, v = _torch_tree(trees[0]), _torch_tree(trees[1])
    codec = FusedCodec.wrap(CompressionPipeline((BlockTopKCodec(),),
                                                min_dense_size=200))
    payload = codec.encode_pair(theta, v)
    dec = codec.decode(payload)
    np.testing.assert_array_equal(dec["conv1"]["w"].numpy(),
                                  (theta["conv1"]["w"] - v["conv1"]["w"]).numpy())
    assert tree_map(lambda x: x.shape, dec) == tree_map(lambda x: x.shape, theta)


def _torch_uniforms(np_uniforms):
    return {p: torch.from_numpy(u) for p, u in np_uniforms.items()}


@pytest.mark.parametrize("min_dense_size", [0, 200])
@pytest.mark.parametrize("kind", ["pipeline", "qsgd_pallas"])
def test_draw_uniforms_equal_reference(trees, kind, min_dense_size):
    """``draw_uniforms`` from a key gives the reference's uniforms exactly,
    for every leaf the compressor names. A leaf that rides dense draws none
    but still takes its place in the per-leaf split."""
    theta = _torch_tree(trees[0])
    key = jax.random.PRNGKey(3)
    comp = (FusedCodec.wrap(CompressionPipeline(
        (BlockTopKCodec(), QSGDCodec()), min_dense_size=min_dense_size))
        if kind == "pipeline" else
        Compressor("qsgd_pallas", min_dense_size=min_dense_size))
    got = draw_uniforms(comp, torch.from_numpy(
        np.asarray(key).astype(np.int64)), theta)
    want = reference_uniforms(kind, trees[0], key)
    assert list(got) == list(comp.uniform_shapes(theta))
    assert (len(got) < len(want)) == bool(min_dense_size)
    for path, u in got.items():
        np.testing.assert_array_equal(u.numpy().view(np.int32),
                                      want[path].view(np.int32), err_msg=path)


@pytest.mark.parametrize("fused", [True, False])
def test_qsgd_pipeline_encode_matches_reference(trees, fused):
    theta, v = trees
    key = jax.random.PRNGKey(1)
    ref = JaxFusedCodec.wrap(parse_pipeline(PIPE), fused=fused)
    want = jax.vmap(ref.encode_pair)(theta, v, _node_keys(key))
    port = FusedCodec.wrap(CompressionPipeline(
        (BlockTopKCodec(), QSGDCodec())), fused=fused)
    got = port.encode_pair(_torch_tree(theta), _torch_tree(v), _torch_uniforms(
        reference_uniforms("pipeline", theta, key)))

    assert got.measured_bytes() == want.measured_bytes()
    assert got.per_leaf_bytes() == want.per_leaf_bytes()
    for g, w, gs, ws in zip(got.entries, want.entries, got.specs, want.specs):
        assert gs.metas == ws.metas
        assert g.wire.dtype == torch.int8 and g.aux[1]["scale"].shape == (K, 1)
        np.testing.assert_array_equal(g.aux[0]["idx"].numpy(),
                                      np.asarray(w.aux[0]["idx"]))
        np.testing.assert_allclose(g.aux[1]["scale"].numpy(),
                                   np.asarray(w.aux[1]["scale"]),
                                   rtol=SCALE_RTOL)
        assert_grid_close(g.wire.numpy(), np.asarray(w.wire), 1.0)


def test_qsgd_pipeline_decode_matches_reference(trees):
    """The reference's payload, decoded by the port, equals the reference's
    jit-compiled decode bit for bit: XLA folds ``/ s / (1 + ω)`` into a
    multiplication by the f32 reciprocal, and the port computes that."""
    theta, v = trees
    key = jax.random.PRNGKey(2)
    ref = JaxFusedCodec.wrap(parse_pipeline(PIPE))
    want = jax.vmap(ref.encode_pair)(theta, v, _node_keys(key))
    dec_want = jax.jit(jax.vmap(ref.decode))(want)
    port = make_compressor(FedConfig(pipeline=PIPE, fused_compress=True))
    shell = port.encode_pair(_torch_tree(theta), _torch_tree(v),
                             _torch_uniforms(reference_uniforms(
                                 "pipeline", theta, key)))
    entries = [LeafPayload(
        wire=torch.from_numpy(np.array(w.wire)),
        aux=tuple({k: torch.from_numpy(np.array(a)) for k, a in aux.items()}
                  for aux in w.aux)) for w in want.entries]
    dec_got = port.decode(WirePayload(entries, shell.paths, shell.specs,
                                      shell.stages))
    for (p, g), w in zip(tree_leaves_with_path(dec_got),
                         jax.tree.leaves(dec_want)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32), err_msg=p)


def test_qsgd_pipeline_oracle_equals_fused_encode(trees):
    theta, v = _torch_tree(trees[0]), _torch_tree(trees[1])
    u = _torch_uniforms(reference_uniforms("pipeline", trees[0],
                                           jax.random.PRNGKey(3)))
    stages = (BlockTopKCodec(), QSGDCodec())
    a = FusedCodec.wrap(CompressionPipeline(stages), fused=True)
    b = FusedCodec.wrap(CompressionPipeline(stages), fused=False)
    pa, pb = a.encode_pair(theta, v, u), b.encode_pair(theta, v, u)
    for ea, eb in zip(pa.entries, pb.entries):
        assert torch.equal(ea.wire, eb.wire)
        assert torch.equal(ea.aux[0]["idx"], eb.aux[0]["idx"])
        assert torch.equal(ea.aux[1]["scale"].view(torch.int32),
                           eb.aux[1]["scale"].view(torch.int32))
    for x, y in zip(tree_leaves_with_path(a.decode(pa)),
                    tree_leaves_with_path(b.decode(pb))):
        assert torch.equal(x[1].view(torch.int32), y[1].view(torch.int32))


@pytest.mark.parametrize("name", ["block_topk_pallas", "qsgd_pallas"])
def test_legacy_compressor_matches_reference(trees, name):
    theta, v = trees
    residual = jax.tree.map(lambda t, vv: t - vv, theta, v)
    key = jax.random.PRNGKey(4)
    ref = jax_make_compressor(JaxFedConfig(compressor=name))
    assert isinstance(ref, JaxCompressor)
    want = jax.vmap(ref)(residual, _node_keys(key))
    port = make_compressor(FedConfig(compressor=name, fused_compress=False))
    assert isinstance(port, Compressor)
    uniforms = (_torch_uniforms(reference_uniforms("qsgd_pallas", residual,
                                                   key))
                if name == "qsgd_pallas" else None)
    got = port(_torch_tree(residual), uniforms)
    for (p, g), w, r in zip(tree_leaves_with_path(got),
                            jax.tree.leaves(want), jax.tree.leaves(residual)):
        if name == "block_topk_pallas":
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          np.asarray(w).view(np.int32),
                                          err_msg=p)
            continue
        # one grid step of each node's row: ‖x‖/s/(1+ω)
        rows = r.reshape(K, -1)
        n = rows.shape[1]
        omega = min(n / 256, np.sqrt(n) / 16)
        step = (np.linalg.norm(rows.astype(np.float64), axis=1) / 16
                / (1 + omega)).reshape((K,) + (1,) * (r.ndim - 1))
        assert_grid_close(g.numpy(), np.asarray(w), step)


def test_compressors_name_their_uniforms(trees):
    theta = _torch_tree(trees[0])
    pipe = make_compressor(FedConfig(pipeline=PIPE, fused_compress=True))
    shapes = pipe.uniform_shapes(theta)
    assert list(shapes) == [p for p, _ in tree_leaves_with_path(theta)]
    assert shapes["fc1.w"] == (K, 3, 11) and shapes["conv1.b"] == (K, 1, 11)
    dense = make_compressor(FedConfig(compressor="qsgd_pallas"))
    assert dense.uniform_shapes(theta)["fc1.w"] == (K, 80, 32)
    assert make_compressor(FedConfig(fused_compress=True)).uniform_shapes(
        theta) == {}
    assert make_compressor(FedConfig(compressor="block_topk_pallas")
                           ).uniform_shapes(theta) == {}
    with pytest.raises(ValueError, match="uniforms"):
        pipe.encode_pair(theta, theta)
    with pytest.raises(ValueError, match="uniforms"):
        dense(theta)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("fed,full_width", [
    (dict(pipeline=PIPE, fused_compress=True), 84058),
    (dict(compressor="qsgd_pallas"), 1949174),
    (dict(compressor="block_topk_pallas"), 155934)])
def test_wire_bytes_of_qsgd_and_dense_configs(reduced, fed, full_width):
    """Shape-only, per node of one model. Full width: block_topk|qsgd sends
    2,546 blocks x 11 survivors x (1 + 2) bytes + a 4-byte scale a leaf;
    the legacy names the reference's closed-form table."""
    spec = get_arch("lenet-radar")
    cfg = spec.reduced if reduced else spec.config
    params = get_model(cfg).init(random.PRNGKey(0, "meta"), "meta")
    got = make_compressor(FedConfig(**fed)).wire_bytes(params)
    jcfg = jax_get_arch("lenet-radar")
    jcfg = jcfg.reduced if reduced else jcfg.config
    jparams = jax.eval_shape(jax_get_model(jcfg).init, jax.random.PRNGKey(0))
    assert got == jax_make_compressor(JaxFedConfig(**fed)).wire_bytes(jparams)
    if not reduced:
        assert got == full_width


def test_make_compressor_routes_and_refuses():
    assert isinstance(make_compressor(FedConfig(pipeline=PIPE,
                                                fused_compress=True)),
                      FusedCodec)
    # a legacy *_pallas name with no pipeline ignores fused_compress
    for fused in (True, False):
        comp = make_compressor(FedConfig(compressor="qsgd_pallas",
                                         fused_compress=fused))
        assert isinstance(comp, Compressor) and comp.name == "qsgd_pallas"
    # a pipeline takes precedence over the legacy name
    assert isinstance(make_compressor(FedConfig(
        compressor="qsgd_pallas", pipeline=PIPE, fused_compress=True)),
        FusedCodec)
    # every codec name and composition runs; what is left refuses
    for ok in (dict(pipeline=PIPE), dict(pipeline="qsgd", fused_compress=True),
               dict(pipeline="block_topk|sign", fused_compress=True),
               dict(layer_pipelines=(("*", PIPE),))):
        assert isinstance(make_compressor(FedConfig(**ok)),
                          CompressionPipeline)
    for bad in (dict(compressor="sign_pallas"),
                dict(pipeline=PIPE, fused_compress=True, qsgd_levels=10),
                dict(control_dtype="float16")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_compressor(FedConfig(**bad))


def test_legacy_min_dense_size_leaves_pass_through(trees):
    """Leaves of at most ``min_dense_size`` elements a node pass through
    the legacy Compressor untouched and draw no uniforms; its closed-form
    bytes ignore the setting, as the reference's do."""
    residual = _torch_tree(trees[0])
    comp = make_compressor(FedConfig(compressor="qsgd_pallas",
                                     min_dense_size=200))
    shapes = comp.uniform_shapes(residual)
    assert "conv1.w" not in shapes and "fc1.w" in shapes
    out = comp(residual, {p: torch.rand(s) for p, s in shapes.items()})
    assert out["conv1"]["w"] is residual["conv1"]["w"]
    assert not torch.equal(out["fc1"]["w"], residual["fc1"]["w"])
    one = tree_map(lambda x: x[0], residual)
    ref = jax_make_compressor(JaxFedConfig(compressor="qsgd_pallas",
                                           min_dense_size=200))
    assert comp.wire_bytes(one) == ref.wire_bytes(
        jax.tree.map(lambda x: x[0], trees[0]))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("pipe,min_dense", [("block_topk", 0),
                                            ("block_topk", 200),
                                            (PIPE, 0), (PIPE, 200)])
def test_fused_encode_packs_every_leaf_in_one_call(trees, monkeypatch, pipe,
                                                   min_dense):
    """``FusedCodec(fused=True)`` hands every compressed leaf to one
    ``fused_delta_pack_leaves`` call (the leaves that ride dense stay out
    of it), and its payload equals the per-leaf two-pass oracle's bit for
    bit and the reference's fused encode (the QSGD grid within the norm's
    tolerance, as in test_qsgd_pipeline_encode_matches_reference)."""
    from repro_torch.kernels import ops as kops
    calls = []
    one_call = kops.fused_delta_pack_leaves
    monkeypatch.setattr(kops, "fused_delta_pack_leaves", lambda t, v, **kw: (
        calls.append(len(t)) or one_call(t, v, **kw)))
    theta, v = trees
    key = jax.random.PRNGKey(5)
    ref = JaxFusedCodec.wrap(parse_pipeline(pipe, min_dense_size=min_dense))
    want = jax.vmap(ref.encode_pair)(theta, v, _node_keys(key))
    uniforms = (_torch_uniforms(reference_uniforms("pipeline", theta, key))
                if pipe == PIPE else None)
    stages = (BlockTopKCodec(),) + ((QSGDCodec(),) if pipe == PIPE else ())
    got, oracle = (FusedCodec.wrap(
        CompressionPipeline(stages, min_dense_size=min_dense), fused=fused
    ).encode_pair(_torch_tree(theta), _torch_tree(v), uniforms)
        for fused in (True, False))

    packed = [not s.passthrough for s in got.specs]
    assert calls == [sum(packed)] and (min_dense > 0) == (not all(packed))
    assert got.measured_bytes() == want.measured_bytes()
    for g, o, w, is_packed in zip(got.entries, oracle.entries, want.entries,
                                  packed):
        assert torch.equal(_bits(g.wire), _bits(o.wire))
        if not is_packed:
            continue
        assert torch.equal(g.aux[0]["idx"], o.aux[0]["idx"])
        np.testing.assert_array_equal(g.aux[0]["idx"].numpy(),
                                      np.asarray(w.aux[0]["idx"]))
        if pipe == PIPE:
            assert_grid_close(g.wire.numpy(), np.asarray(w.wire), 1.0)
        else:
            np.testing.assert_array_equal(_bits(g.wire).numpy(),
                                          np.asarray(w.wire).view(np.int32))


@pytest.mark.parametrize("pipe,min_dense", [("block_topk", 0),
                                            ("block_topk", 200),
                                            (PIPE, 0), (PIPE, 200)])
def test_decode_unpacks_every_leaf_in_one_call(trees, monkeypatch, pipe,
                                               min_dense):
    """The stage-major decode hands every compressed leaf to one
    ``block_topk_unpack_leaves`` call (the leaves that ride dense stay out
    of it) and equals the leaf-by-leaf decode, each leaf through its stages
    in reverse, bit for bit."""
    from repro_torch.kernels import ops as kops
    theta, v = trees
    uniforms = (_torch_uniforms(reference_uniforms(
        "pipeline", theta, jax.random.PRNGKey(6))) if pipe == PIPE else None)
    stages = (BlockTopKCodec(),) + ((QSGDCodec(),) if pipe == PIPE else ())
    codec = FusedCodec.wrap(CompressionPipeline(stages,
                                                min_dense_size=min_dense))
    payload = codec.encode_pair(_torch_tree(theta), _torch_tree(v), uniforms)
    calls = []
    one_call = kops.block_topk_unpack_leaves
    monkeypatch.setattr(kops, "block_topk_unpack_leaves", lambda p, s, **kw: (
        calls.append(len(p)) or one_call(p, s, **kw)))
    got = codec.decode(payload)
    packed = [not s.passthrough for s in payload.specs]
    assert calls == [sum(packed)] and (min_dense > 0) == (not all(packed))
    for (path, leaf), entry, spec in zip(tree_leaves_with_path(got),
                                         payload.entries, payload.specs):
        want = entry.wire
        for stage, aux, meta in reversed(list(zip(payload.stages, entry.aux,
                                                  spec.metas))):
            want = stage.decode(want, aux, meta)
        assert leaf.shape == want.shape and torch.equal(_bits(leaf),
                                                        _bits(want)), path
