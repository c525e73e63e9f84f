"""The port's static encode ledger (``encode_hbm_bytes``) and
``leaf_stages`` against the reference's, on lenet-radar (reduced and full
width, concrete and shape-only trees, v in f32 and bfloat16) and on the
dense LMs' trees (ROADMAP A12 part 2): smollm-135m at full width
(shape-only: 134,515,008 parameters in 11 leaves, the tied embedding's
28,311,552 elements and the ``(30, …)`` group leaves) and reduced; and
every codec of ``test_torch_codecs.py`` on smollm-135m's reduced tree,
node-stacked (K = 3), its payloads and decodes held to the reference's as
there. Counts and bytes exact.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig, get_arch as jax_get_arch
from repro.core.compression import FusedCodec as JaxFusedCodec
from repro.core.compression import make_compressor as jax_make_compressor
from repro.core.compression import parse_pipeline
from repro.models import get_model as jax_get_model
from repro_torch import random
from repro_torch.config import FedConfig, get_arch
from repro_torch.core.compression import (FusedCodec, draw_uniforms,
                                          make_compressor)
from repro_torch.models import get_model
from repro_torch.utils.tree import tree_count, tree_map
from test_torch_codecs import FUSED_SPECS, K, SPECS, _assert_payloads_match

import torch_threads  # noqa: F401  (one torch thread a process)

# the ledger's pipelines: every codec name alone and the compositions the
# reference's benchmark and LLM example run
LEDGER_SPECS = ("identity", "topk", "block_topk", "randk", "sign", "qsgd",
                "block_topk|qsgd", "block_topk|sign", "topk|qsgd",
                "randk|sign")


@functools.lru_cache(maxsize=None)
def _ledger_trees(reduced, concrete, arch_id="lenet-radar"):
    """One node's tree of ``arch_id`` in both packages, concrete or
    shape-only (``ShapeDtypeStruct`` / ``meta``: the reference's traced by
    ``eval_shape``), made once a module."""
    arch = jax_get_arch(arch_id)
    init = jax_get_model(arch.reduced if reduced else arch.config).init
    jparams = (init(jax.random.PRNGKey(0)) if concrete else
               jax.eval_shape(init, jax.random.PRNGKey(0)))
    spec = get_arch(arch_id)
    device = "cpu" if concrete else "meta"
    params = get_model(spec.reduced if reduced else spec.config).init(
        random.PRNGKey(0, device), device)
    return jparams, params


@pytest.mark.parametrize("spec", LEDGER_SPECS)
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("reduced,concrete", [(True, True), (True, False),
                                              (False, False)])
def test_encode_hbm_bytes_equals_reference(spec, fused, reduced, concrete):
    """The static encode ledger's four counts, exactly, for every codec and
    both stage-0 lowerings (``FusedCodec`` fused and two-pass), on concrete
    and shape-only trees, and with v in bfloat16."""
    from repro.core.compression import encode_hbm_bytes as jax_ledger
    from repro_torch.core.compression import encode_hbm_bytes
    jparams, params = _ledger_trees(reduced, concrete)
    jpipe = JaxFusedCodec.wrap(parse_pipeline(spec), fused=fused)
    pipe = FusedCodec.wrap(make_compressor(FedConfig(pipeline=spec)),
                           fused=fused)
    assert encode_hbm_bytes(pipe, params) == jax_ledger(jpipe, jparams)
    jv = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, jnp.bfloat16),
                      jparams)
    v = tree_map(lambda x: torch.empty(x.shape, dtype=torch.bfloat16,
                                       device="meta"), params)
    assert encode_hbm_bytes(pipe, params, v) == jax_ledger(jpipe, jparams, jv)


def test_encode_hbm_bytes_layer_pipelines_and_min_dense():
    """Per-layer routing and dense-riding leaves in the ledger."""
    from repro.core.compression import encode_hbm_bytes as jax_ledger
    from repro.core.compression import make_compressor as jmake
    from repro_torch.core.compression import encode_hbm_bytes
    jparams, params = _ledger_trees(True, True)
    fed = dict(layer_pipelines=(("fc1", "block_topk|qsgd"), ("*", "topk")),
               min_dense_size=200, fused_compress=True)
    assert encode_hbm_bytes(make_compressor(FedConfig(**fed)), params) == \
        jax_ledger(jmake(JaxFedConfig(**fed)), jparams)


@pytest.mark.parametrize("layered", [False, True])
def test_leaf_stages_equals_reference(layered):
    """The module-level ``leaf_stages(payload, i)``: each leaf's codec
    names in order, the per-layer routing included."""
    from repro.core.compression import leaf_stages as jax_leaf_stages
    from repro_torch.core.compression import leaf_stages
    fed = dict(pipeline="block_topk|qsgd")
    if layered:
        fed["layer_pipelines"] = (("conv", "topk"), ("fc3", "sign"))
    jparams, params = _ledger_trees(True, True)
    jcomp = jax_make_compressor(JaxFedConfig(**fed))
    jpay = jcomp.encode(jparams, jax.random.PRNGKey(1))
    comp = make_compressor(FedConfig(**fed))
    stacked = tree_map(lambda x: x[None], params)
    pay = comp.encode(stacked, draw_uniforms(comp, random.PRNGKey(1),
                                             stacked))
    assert len(pay.entries) == len(jpay.entries)
    for i in range(len(pay.entries)):
        assert [s.name for s in leaf_stages(pay, i)] == \
            [s.name for s in jax_leaf_stages(jpay, i)]


# at full width all but the dense ``qsgd``, whose shape-only ledger walks
# the port's plain carrier norms segment by segment (37 s on the meta tree)
@pytest.mark.parametrize("spec,reduced", [(s, True) for s in LEDGER_SPECS]
                         + [(s, False) for s in LEDGER_SPECS if s != "qsgd"])
def test_encode_hbm_bytes_on_the_lm_trees(spec, reduced):
    """The ledger on smollm-135m's tree, fused and two-pass, v in f32 and
    bfloat16: at full width shape-only, 134,515,008 parameters."""
    from repro.core.compression import encode_hbm_bytes as jax_ledger
    from repro_torch.core.compression import encode_hbm_bytes
    jparams, params = _ledger_trees(reduced, reduced, "smollm-135m")
    if not reduced:
        assert tree_count(params) == 134_515_008
    for fused in (False, True):
        jpipe = JaxFusedCodec.wrap(parse_pipeline(spec), fused=fused)
        pipe = FusedCodec.wrap(make_compressor(FedConfig(pipeline=spec)),
                               fused=fused)
        assert encode_hbm_bytes(pipe, params) == jax_ledger(jpipe, jparams)
        jv = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, jnp.bfloat16), jparams)
        v = tree_map(lambda x: torch.empty(x.shape, dtype=torch.bfloat16,
                                           device="meta"), params)
        assert encode_hbm_bytes(pipe, params, v) == jax_ledger(jpipe,
                                                               jparams, jv)


@pytest.fixture(scope="module")
def lm_trees():
    """smollm-135m's reduced tree, node-stacked (K = 3): θ the init plus
    noise a node, v a tenth of it (every leaf, the ``(2, …)`` group leaves
    and the 49,152-element tied embedding included)."""
    import numpy as np
    params = jax_get_model(jax_get_arch("smollm-135m").reduced).init(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    theta = jax.tree.map(lambda x: (np.asarray(x)[None] + rng.standard_normal(
        (K,) + x.shape)).astype(np.float32), params)
    v = jax.tree.map(lambda x: rng.standard_normal(
        (K,) + x.shape).astype(np.float32) * 0.1, params)
    return theta, v


@pytest.mark.parametrize("spec,fused", [(s, False) for s in SPECS]
                         + [(s, True) for s in FUSED_SPECS])
def test_codec_payloads_match_reference_on_an_lm_tree(lm_trees, spec, fused):
    """Every codec and composition on the LM tree, as
    ``test_torch_codecs.py::test_codec_payloads_match_reference`` holds
    them on LeNet's."""
    port = make_compressor(FedConfig(pipeline=spec, fused_compress=fused))
    _assert_payloads_match(lm_trees, port, jax_make_compressor(
        JaxFedConfig(pipeline=spec, fused_compress=fused)))
