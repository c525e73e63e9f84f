"""The port's codec stages, the ``"stage|stage"`` DSL and the legacy jnp
compressor names against the reference's, on the reduced LeNet tree,
node-stacked (K=3), each encode under the reference's keys (the port's
``draw_uniforms`` from the round's ``kql``, the reference's ``fold_in(kql,
k)`` node keys); and the top_k-order selection kernel's plain version on
the edge blocks of ROADMAP C9.

Tolerances and why:
- survivor indices and slot order, carriers and sidecars of every stage
  but QSGD's and the sign scale, packed sign planes, rand-k keys, measured
  bytes, decodes and the legacy operators' outputs (but sign's and QSGD's)
  and closed-form bytes: exact (selections, copies and bit packing).
- QSGD grids and scales: ``assert_grid_close`` and rtol 1e-6, as in
  ``test_torch_compression.py``: the norm's summation order differs from
  XLA's in the last bits, so a grid element may move one step. The sign
  scale ``mean(|x|)`` (and so the sign decode and the legacy sign output)
  within rtol ``SIGN_RTOL`` = 1e-5 for the same reason: XLA's CPU code
  sums in an order of its own (sequential for a (3, 11) carrier, neither
  sequential, pairwise nor lane-strided at other lengths), and two orders
  of n non-negative f32 terms differ by up to (n − 1)·2⁻²⁴ relative (33
  block-top-k survivors: 1.06e-6 seen). Decodes are then held on the
  reference's payload, exactly.
- the update variants (ROADMAP C10): bit for bit to the reference's
  jitted expressions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig, get_arch as jax_get_arch
from repro.core.compression import BlockTopKCodec as JaxBlockTopKCodec
from repro.core.compression import Compressor as JaxCompressor
from repro.core.compression import make_compressor as jax_make_compressor
from repro.core.compression import parse_pipeline as jax_parse_pipeline
from repro.models import get_model as jax_get_model
from repro_torch import random
from repro_torch.config import FedConfig, get_arch
from repro_torch.core.compression import (BlockTopKCodec, CompressionPipeline,
                                          Compressor, FusedCodec, LeafPayload,
                                          PerLayerPipeline, RandKCodec,
                                          WirePayload,
                                          draw_uniforms, keystr,
                                          make_compressor, parse_pipeline)
from repro_torch.kernels.fused_update import (cffl_update, cffl_update_plain,
                                              dsgld_update,
                                              dsgld_update_plain)
from repro_torch.kernels.pack import (from_uint16, magnitude_keys, to_blocks,
                                      topk_candidates_plain, topk_select,
                                      topk_select_plain, unpack_set,
                                      unpack_set_plain)
from repro_torch.models import get_model
from repro_torch.utils.tree import tree_leaves_with_path
from test_torch_compression import SCALE_RTOL, assert_grid_close
from torch_golden import boundary_blocks

K = 3
KEY = 5
SIGN_RTOL = 1e-5


def f32(bits):
    return np.array(bits, np.uint32).view(np.float32)


def _torch_tree(np_tree):
    return {k: (_torch_tree(v) if isinstance(v, dict)
                else torch.from_numpy(np.asarray(v))) for k, v in np_tree.items()}


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.fixture(scope="module")
def trees():
    params = jax_get_model(jax_get_arch("lenet-radar").reduced).init(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    theta = jax.tree.map(lambda x: rng.standard_normal(
        (K,) + x.shape).astype(np.float32), params)
    v = jax.tree.map(lambda x: rng.standard_normal(
        (K,) + x.shape).astype(np.float32) * 0.1, params)
    # a zero in every sign plane and a -0.0 survivor candidate
    theta["fc3"]["b"][:, 3] = 0.0
    v["fc3"]["b"][:, 3] = 0.0
    theta["conv1"]["b"][1, 2] = -0.0
    v["conv1"]["b"][1, 2] = 0.0
    return theta, v


def _node_keys(key):
    return jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(K))


def _port_key(seed):
    return torch.from_numpy(np.asarray(jax.random.PRNGKey(seed)).astype(
        np.int64))


def _to_torch(x):
    x = np.asarray(x)
    if x.dtype == np.uint32:
        return torch.from_numpy(x.view(np.int32).copy())
    return torch.from_numpy(x.copy())


def _as_port_payload(ref, like):
    """The reference's node-stacked payload as the port's, the port's
    ``like`` giving paths, specs and stages; uint32 indices as the port's
    uint32 view, a rand-k key as its int32 words."""
    entries = []
    for e, mine in zip(ref.entries, like.entries):
        aux = []
        for a, m in zip(e.aux, mine.aux):
            aux.append({k: (_to_torch(v).view(m[k].dtype)
                            if m[k].dtype == torch.uint32 else
                            _to_torch(v).to(m[k].dtype)
                            if k == "key" else _to_torch(v))
                        for k, v in a.items()})
        entries.append(LeafPayload(wire=_to_torch(e.wire), aux=tuple(aux)))
    return WirePayload(entries, like.paths, like.specs, like.stages)


def _assert_leaf_equal(got, want, msg):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    assert got.shape == want.shape, msg
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=msg)


# -- the top_k-order selection on the edge blocks of ROADMAP C9 -----------

def _edge_rows():
    """(K, 2055) rows: NaNs of four payloads against ±inf; -0.0 and +0.0
    ties; a block whose k-th magnitude lies 2^30 below its maximum; and a
    ragged last block of 7 elements with two nonzeros, so its zero padding
    ties the valid zeros."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((K, 2055)).astype(np.float32)
    x[0, [5, 900, 17, 33]] = f32([0x7fc00001, 0x7fc00000, 0xffc00002,
                                  0x7f800001])
    x[0, [6, 7, 1100]] = [np.inf, -np.inf, np.inf]
    x[1, :1024] = 0.0
    x[1, :1024:3] = -0.0
    x[1, [10, 500]] = [1.5, -2.5]
    x[2, 1024:2048] = rng.uniform(1e-9, 2e-9, 1024).astype(np.float32)
    x[2, 1500] = 2.0 ** 30
    x[:, 2048:] = 0.0
    x[:, 2049] = -0.0
    x[:, [2050, 2053]] = [3.0, -1.0]
    return x


def _reference_encode(codec, x):
    """``codec.encode`` of each row of ``x``: ``(vals, aux, meta)``."""
    metas = []

    def one(row):
        vals, aux, meta = codec.encode(row, None)
        metas.append(meta)
        return vals, aux
    vals, aux = jax.vmap(one)(jnp.asarray(x))
    return vals, aux, metas[0]


def _reference_select(x):
    vals, aux, _ = _reference_encode(JaxBlockTopKCodec(ratio=0.01), x)
    return np.asarray(vals), np.asarray(aux["idx"])


@pytest.mark.parametrize("with_v", [False, True])
def test_topk_select_matches_lax_top_k_on_edge_blocks(with_v):
    """Indices, slot order and values (NaN payloads, -0.0) of every block
    exact against the reference's jnp encode, with the residual formed by
    the selection (``with_v``) or handed in."""
    x = _edge_rows()
    v = (np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
         * 0.1 if with_v else np.zeros_like(x))
    v[:, 2048:] = 0.0
    with np.errstate(invalid="ignore"):      # inf - inf, NaN - v
        want_vals, want_idx = _reference_select(x - v if with_v else x)
    (vals, idx), = topk_select([torch.from_numpy(x)], [11],
                               [torch.from_numpy(v)] if with_v else None)
    np.testing.assert_array_equal(from_uint16(idx).numpy(), want_idx)
    np.testing.assert_array_equal(vals.numpy().view(np.int32),
                                  want_vals.view(np.int32))
    if not with_v:     # NaNs by payload above ±inf (ties by index)
        assert want_idx[0, 0, :6].tolist() == [17, 5, 900, 33, 6, 7]
    # the ragged block: 3.0, -1.0, its five valid zeros, then padding
    assert want_idx[0, 2].tolist() == [2, 5, 0, 1, 3, 4, 6, 7, 8, 9, 10]


@pytest.mark.parametrize("n", [1, 6, 150, 1024])
def test_topk_select_of_a_short_leaf_is_global_top_k(n):
    """A leaf of at most one block keeps its own ``ceil(0.01·n)`` in
    ``TopKCodec``'s order, its zero padding never picked; ``k >= n`` goes
    dense."""
    x = _edge_rows()[:, :n].copy()
    x[:, n // 2:] = 0.0
    codec = BlockTopKCodec()
    want = _reference_encode(JaxBlockTopKCodec(), x)
    got = codec.encode(torch.from_numpy(x))
    assert got[2].mode == want[2].mode and got[2].k == want[2].k
    _assert_leaf_equal(got[0], want[0], "vals")
    for key in want[1]:
        _assert_leaf_equal(got[1][key], want[1][key], key)


def test_unpack_set_matches_reference_decode():
    """The ``.at[].set`` decode: -0.0 and NaN payloads stored as they are,
    the ragged block's padding indices dropped; exact against the
    reference's jitted decode."""
    x = _edge_rows()
    codec = JaxBlockTopKCodec()
    vals, aux, meta = _reference_encode(codec, x)
    want = jax.jit(jax.vmap(lambda v, a: codec.decode(v, a, meta)))(vals, aux)
    payload = (torch.from_numpy(np.array(vals)),
               torch.from_numpy(np.array(aux["idx"])))
    got, = unpack_set([payload], [x.shape[1]])
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    assert torch.equal(unpack_set_plain(*payload, x.shape[1]).view(
        torch.int32), got.view(torch.int32))
    assert topk_select_plain(torch.from_numpy(x), 11)[0].shape == (K, 3, 11)


@pytest.mark.parametrize("k", [1, 2, 3, 9, 11, 32])
@pytest.mark.parametrize("rows", ["edge", "normal", "boundary"])
def test_lane_maxima_bound_admits_every_lax_top_k_survivor(rows, k):
    """The selection kernel's fast-path rule (``topk_candidates_plain``):
    every survivor of the reference's ``lax.top_k`` has a key >= the
    block's L, so a block has at least k candidates; on the C9 edge rows
    (NaN payloads, ±inf, ±0.0, ties, a ragged block), seeded normal blocks
    and the boundary blocks (32 and 33 candidates at k = 11 exactly)."""
    if rows == "edge":
        x = _edge_rows()
    elif rows == "normal":
        x = np.random.default_rng(k).standard_normal((K, 4096)).astype(
            np.float32)
    else:
        x = np.concatenate([d for _, d, _ in boundary_blocks(K)], axis=1)
    _, aux, _ = _reference_encode(JaxBlockTopKCodec(ratio=k / 1024), x)
    blocks = to_blocks(torch.from_numpy(x), 1024)
    bound, count = topk_candidates_plain(blocks, k)
    keys = torch.gather(magnitude_keys(blocks), 1, torch.from_numpy(
        np.asarray(aux["idx"], np.int64)).reshape(blocks.shape[0], k))
    assert keys.shape == (blocks.shape[0], k)
    assert bool((keys >= bound[:, None]).all())
    assert bool((count >= k).all())
    if rows == "boundary" and k == 11:
        assert count.reshape(K, 5)[:, :2].tolist() == [[32, 33]] * K


# -- every codec and composition against the reference ---------------------

SPECS = ["identity", "topk", "block_topk", "randk", "sign", "qsgd",
         "block_topk|qsgd", "topk|qsgd", "randk|qsgd", "block_topk|sign",
         "identity|randk|qsgd", "identity|qsgd", "block_topk_pallas|sign"]
# fused_compress=True where it changes the route: a block-top-k stage 0
# lowered to delta-pack, or another stage 0 on the stage-major encode
FUSED_SPECS = ["block_topk", "block_topk|sign", "qsgd", "randk|qsgd"]


@pytest.mark.parametrize("spec,fused", [(s, False) for s in SPECS]
                         + [(s, True) for s in FUSED_SPECS])
def test_codec_payloads_match_reference(trees, spec, fused):
    """``make_compressor`` of ``pipeline=spec`` (wrapped in ``FusedCodec``
    when ``fused``) encodes the residual as the reference's does under its
    keys: leaf order, carriers, indices and slot order, rand-k keys, sign
    planes and measured bytes exact, QSGD grids and scales within the
    norm's tolerance; the reference's payload decodes exactly to the
    reference's jitted decode, and the port's own payload decodes to its
    stages' decode."""
    port = make_compressor(FedConfig(pipeline=spec, fused_compress=fused))
    assert isinstance(port, FusedCodec) == fused
    _assert_payloads_match(trees, port, jax_make_compressor(
        JaxFedConfig(pipeline=spec, fused_compress=fused)))


# per-layer rules on the keystr paths (['fc1']['w']): the CLI's, a
# pattern inside a key pair, unmatched leaves on the base, and a
# stochastic stage behind another
LAYER_RULES = [
    (("fc1", "block_topk|qsgd"), ("*", "block_topk")),
    (("conv", "qsgd"), ("1']['w", "topk")),
    (("b']", "identity"), ("*", "randk|qsgd")),
    (("fc", "block_topk|sign"), ("conv2", "sign")),
]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("rules", LAYER_RULES, ids=str)
def test_layer_pipeline_payloads_match_reference(trees, rules, fused):
    """``FedConfig.layer_pipelines`` (ROADMAP A6's ``PerLayerPipeline``):
    every leaf routed as the reference routes it, its payload (each stage's
    carrier, indices, keys and scales, under its own stage keys) and the
    measured bytes exact as in :func:`test_codec_payloads_match_reference`,
    fused and unfused; the decodes too."""
    port = make_compressor(FedConfig(layer_pipelines=rules,
                                     fused_compress=fused))
    ref = jax_make_compressor(JaxFedConfig(layer_pipelines=rules,
                                           fused_compress=fused))
    assert isinstance(port, PerLayerPipeline)
    assert port.stages[0].use_pallas == fused
    got = _assert_payloads_match(trees, port, ref)
    want_paths = [jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(trees[0])[0]]
    for i, (path, spec) in enumerate(zip(got.paths, got.specs)):
        assert keystr(path) == want_paths[i]
        assert [s.name for s in got.leaf_stages(i)] == \
            [s.name for s in ref._resolve_stages(want_paths[i])], path


def _assert_payloads_match(trees, port, ref):
    """The comparison of :func:`test_codec_payloads_match_reference`, each
    leaf through its own stages; returns the port's payload."""
    theta, v = trees
    key = jax.random.PRNGKey(KEY)
    want = jax.jit(jax.vmap(ref.encode_pair))(theta, v, _node_keys(key))
    tt, tv = _torch_tree(theta), _torch_tree(v)
    got = port.encode_pair(tt, tv, draw_uniforms(port, _port_key(KEY), tt))
    assert got.measured_bytes() == want.measured_bytes()
    paths = [p for p, _ in tree_leaves_with_path(tt)]
    assert list(got.paths) == paths
    quants = [got.leaf_stages(i)[-1].name == "qsgd"
              for i in range(len(paths))]
    for path, g, w, gs, ws, quant in zip(paths, got.entries, want.entries,
                                         got.specs, want.specs, quants):
        assert [m.mode for m in gs.metas if hasattr(m, "mode")] == \
            [m.mode for m in ws.metas if hasattr(m, "mode")], path
        for s, (ga, wa) in enumerate(zip(g.aux, w.aux)):
            assert sorted(ga) == sorted(wa), path
            for name in wa:
                if name == "scale":
                    np.testing.assert_allclose(
                        ga[name].numpy(), np.asarray(wa[name]),
                        rtol=SCALE_RTOL if quant else SIGN_RTOL, err_msg=path)
                else:
                    _assert_leaf_equal(ga[name], wa[name], f"{path} {name}")
        if quant:
            assert_grid_close(g.wire.numpy(), np.asarray(w.wire), 1.0)
        else:
            _assert_leaf_equal(g.wire, w.wire, f"{path} carrier")
    decoded = jax.jit(jax.vmap(ref.decode))(want)
    mine = port.decode(_as_port_payload(want, got))
    for (path, g), w in zip(tree_leaves_with_path(mine),
                            jax.tree.leaves(decoded)):
        _assert_leaf_equal(g, w, f"{path} decode")
    for i, ((path, g), (_, w)) in enumerate(zip(
            tree_leaves_with_path(port.decode(got)),
            tree_leaves_with_path(mine))):
        assert g.shape == w.shape and torch.isfinite(g).all(), path
        if got.leaf_stages(i)[-1].name == "sign":
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=SIGN_RTOL,
                                       atol=0, err_msg=path)
        elif not quants[i]:
            _assert_leaf_equal(g, w.numpy(), f"{path} own decode")
    return got


def test_compressors_name_their_draw_sites(trees):
    """One stochastic stage: sites are paths; two (``randk|qsgd``): ``(path,
    stage)``, rand-k's drawn with its key, each under its stage key."""
    tt = _torch_tree(trees[0])
    one = make_compressor(FedConfig(compressor="randk"))
    assert list(one.uniform_shapes(tt)) == [p for p, _ in
                                            tree_leaves_with_path(tt)]
    two = make_compressor(FedConfig(pipeline="randk|qsgd"))
    shapes = two.uniform_shapes(tt)
    assert shapes[("fc1.w", 0)] == (K, 2560) and \
        shapes[("fc1.w", 1)] == (K, 26)
    drawn = draw_uniforms(two, _port_key(KEY), tt)
    key, scores = drawn[("fc1.w", 0)]
    assert key.shape == (K, 2) and scores.shape == (K, 2560)
    assert drawn[("fc1.w", 1)].shape == (K, 26)
    with pytest.raises(ValueError, match="uniforms"):
        two.encode(tt)
    assert make_compressor(FedConfig()).uniform_shapes(tt) == {}


@pytest.mark.parametrize("spec", ["topk|randk", "qsgd|block_topk",
                                  "sign|qsgd", "qsgd|identity", "bogus",
                                  "block_topk|topk", "randk|sign|qsgd"])
def test_dsl_errors_match_reference(spec):
    with pytest.raises(ValueError) as want:
        jax_parse_pipeline(spec)
    with pytest.raises(ValueError) as got:
        parse_pipeline(spec)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        make_compressor(FedConfig(pipeline=spec))


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("fed", [
    dict(), dict(fused_compress=True), dict(pipeline="block_topk|qsgd"),
    dict(compressor="topk"), dict(compressor="randk"),
    dict(compressor="sign"), dict(compressor="qsgd"),
    dict(compressor="identity"), dict(pipeline="randk|qsgd"),
    dict(pipeline="topk|sign", fused_compress=True),
    dict(layer_pipelines=LAYER_RULES[0]),
    dict(layer_pipelines=LAYER_RULES[2], fused_compress=True)])
def test_wire_bytes_of_every_codec(reduced, fed):
    """Shape-only bytes a node of one model, exact against the
    reference's; at full width the default sends 167,682 bytes, its seven
    short leaves through TopKCodec's global top-k."""
    arch = jax_get_arch("lenet-radar")
    params = jax_get_model(arch.reduced if reduced else arch.config).init(
        jax.random.PRNGKey(0))
    want = jax_make_compressor(JaxFedConfig(**fed)).wire_bytes(params)
    mine = get_model(get_arch("lenet-radar", reduced=reduced)).init(
        random.PRNGKey(0, "meta"), "meta")
    assert make_compressor(FedConfig(**fed)).wire_bytes(mine) == want
    if not reduced and not fed:
        assert want == 167_682


@pytest.mark.parametrize("name", ["identity", "topk", "block_topk", "randk",
                                  "sign", "qsgd"])
def test_legacy_jnp_compressor_names_match_reference(trees, name):
    """The legacy ``Compressor``'s dense outputs, its draws under the leaf
    keys, and its closed-form bytes against the reference's jnp
    operators: exact, QSGD within the norm's grid tolerance."""
    theta, v = trees
    residual = jax.tree.map(lambda t, vv: t - vv, theta, v)
    key = jax.random.PRNGKey(KEY)
    ref = JaxCompressor(name=name)
    want = jax.jit(jax.vmap(ref))(residual, _node_keys(key))
    port = Compressor(name=name)
    tr = _torch_tree(residual)
    got = port(tr, draw_uniforms(port, _port_key(KEY), tr))
    for (path, g), w, r in zip(tree_leaves_with_path(got),
                               jax.tree.leaves(want),
                               jax.tree.leaves(residual)):
        if name == "sign":      # ±scale, 0: the scale's summation order
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=SIGN_RTOL, atol=0, err_msg=path)
            np.testing.assert_array_equal(np.sign(g.numpy()),
                                          np.sign(np.asarray(w)))
            continue
        if name != "qsgd":
            _assert_leaf_equal(g, w, path)
            continue
        rows = np.asarray(r, np.float64).reshape(K, -1)
        n = rows.shape[1]
        step = (np.linalg.norm(rows, axis=1) / 16 / (1 + min(
            n / 256, np.sqrt(n) / 16))).reshape((K,) + (1,) * (r.ndim - 1))
        assert_grid_close(g.numpy(), np.asarray(w), step)
    single = jax.tree.map(lambda x: x[0], residual)
    assert port.wire_bytes(_torch_tree(single)) == ref.wire_bytes(single)


def test_make_compressor_routes_both_orders():
    """``fused_compress=False`` is the plain pipeline in ``lax.top_k``
    order; ``True`` a ``FusedCodec`` whose block-top-k stage 0 is the
    kernel path's; another stage 0 is left as it is."""
    plain = make_compressor(FedConfig())
    assert type(plain) is CompressionPipeline
    assert not plain.stages[0].use_pallas
    fused = make_compressor(FedConfig(fused_compress=True))
    assert isinstance(fused, FusedCodec) and fused.stages[0].use_pallas
    other = make_compressor(FedConfig(pipeline="randk|qsgd",
                                      fused_compress=True))
    assert isinstance(other.stages[0], RandKCodec)
    # layer_pipelines: a PerLayerPipeline, its rules lowered as the base
    routed = make_compressor(FedConfig(layer_pipelines=(("*", "qsgd"),)))
    assert isinstance(routed, PerLayerPipeline)
    assert not routed.stages[0].use_pallas
    lowered = make_compressor(FedConfig(
        fused_compress=True, layer_pipelines=(("fc1", "block_topk|qsgd"),)))
    assert lowered.stages[0].use_pallas
    assert lowered.rules[0][1].stages[0].use_pallas


# -- the update variants (ROADMAP C10) ------------------------------------

def test_update_variants_are_bit_exact_to_the_jitted_reference():
    """CF-FL's ``θ + ζ(v̄ − v)`` and DSGLD's ``m − ηg + ξ``, written as the
    reference's round functions write them (``algorithms.py:602-608``,
    ``:515-520``) and jitted, against the kernels' plain versions (what the
    CPU runs): XLA contracts them into ``fma(ζ, v̄ − v, θ)`` and
    ``fma(−η, g, m) + ξ``, bit for bit."""
    rng = np.random.default_rng(7)
    a, b, c = (rng.standard_normal(1 << 16).astype(np.float32) * s
               for s in (0.05, 30.0, 0.014))
    eta, zeta = 1e-4, 0.03
    dsgld = jax.jit(lambda m, g, n: (
        m.astype(jnp.float32) - eta * g.astype(jnp.float32) + n
    ).astype(m.dtype))
    cffl = jax.jit(lambda t, vb, v: (
        t.astype(jnp.float32)
        + zeta * (vb.astype(jnp.float32) - v.astype(jnp.float32))
    ).astype(t.dtype))
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    for got, want in (
            (dsgld_update(ta, tb, tc, eta), dsgld(a, b, c)),
            (dsgld_update_plain(ta, tb, tc, eta), dsgld(a, b, c)),
            (cffl_update(ta, tb * 1e-3, tc, zeta), cffl(a, b * 1e-3, c)),
            (cffl_update_plain(ta, tb * 1e-3, tc, zeta),
             cffl(a, b * 1e-3, c))):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))
