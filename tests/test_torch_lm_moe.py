"""The vlm and moe families on the port against the reference (ROADMAP A12
parts 3 and 4), on the CPU at the reduced widths of llava-next-mistral-7b,
grok-1-314b and deepseek-v2-236b (MLA, shared experts).

- Registry entries and init: every field the reference's entry has, every
  leaf bit for bit (``img_proj`` from the fifth key, the experts drawn
  ``(d, E, ·)`` and moved to ``(E, d, ·)``, MLA's eight keys), with
  ``scan_layers`` on (llava, deepseek-v2) and off (grok-1); and the
  full-width record's writer, which draws the reference's init in row
  blocks, equal to the reference's init.
- The forward, ``loss`` (with its aux term), the node-batched ``nll`` and
  the gradient of the loss, from the reference's params, on both MoE
  dispatches and llava's patches built here: f32 logits within 1e-5 of
  the largest |logit|, losses within rtol 1e-6, each leaf's gradient
  within 1e-5 of its largest |g| (measured 7e-7 to 1.4e-6); bf16 logits
  within 3e-2 of the largest, losses within rtol 1e-3, gradients within
  5e-2 (measured 9e-3 to 1.1e-2 and 1.4e-2 to 2.0e-2: every op rounds to
  bf16's 8 bits, as the dense tests state).
- ``moe_ffn_ragged`` and ``moe_ffn_gshard`` alone against the reference's:
  router ties (two experts' columns equal: the lower index wins, as
  ``lax.top_k``), tokens dropped at capacity factor 0.5, the aux term,
  within 1e-6 of the largest output (f32).
- ``mla_attention`` on its naive and chunked branches against the
  reference's; ``mla_decode`` through f32 latent caches equals the
  prefill (atol 2e-3, the reference's own check of its zoo) and the
  reference's teacher-forced decode within 1e-5 of the largest logit.
- One cdbfl round of grok-1 and deepseek-v2 (f32, each dispatch) from the
  reference's init, minibatches and key: as ``test_torch_lm_train.py``
  holds smollm's, index sets exact and params, v, v̄ within 1e-6.
- llava's round on ``{tokens, patches}`` node pools through ``FedTrainer``
  (scan = host bit for bit) and the train CLI, which fails as the
  reference's does: token-only pools and a vlm loss that reads
  ``batch["patches"]``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig, MoEConfig as JaxMoE
from repro.config import get_arch as jax_get_arch
from repro.core import (build_topology, init_fed_state, make_compressor,
                        resolve_topology)
from repro.core.algorithms import make_round_fn
from repro.models import get_model as jax_get_model
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro_torch import random
from repro_torch.config import FedConfig, MoEConfig, get_arch, list_archs
from repro_torch.core import algorithms as port_alg
from repro_torch.core import fed_state as port_state
from repro_torch.core.compression import make_compressor as port_compressor
from repro_torch.models import get_model
from repro_torch.models import mla as pmla
from repro_torch.models import moe as pmoe
from repro_torch.models.transformer import params_from_jax
from repro_torch.train import FedTrainer
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path, tree_map

import torch_threads  # noqa: F401  (one torch thread a process)
from test_torch_lm_train import _check_round, _key, _tokens

NEW = ("llava-next-mistral-7b", "grok-1-314b", "deepseek-v2-236b")
LOGIT_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
LOSS_RTOL = {"float32": 1e-6, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
FFN_TOL = 1e-6
K, L, B, S = 2, 2, 2, 16
DATA_SCALE = 50.0
FED = dict(num_nodes=K, local_steps=L, eta=1e-3, zeta=0.3, temperature=0.1,
           burn_in=1, rounds=2, topology="ring")


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _cfgs(arch, dtype="float32", impl=None, **kw):
    """The reference's and the port's reduced config of ``arch``."""
    jcfg = jax_get_arch(arch).reduced.replace(dtype=dtype, **kw)
    cfg = get_arch(arch).reduced.replace(dtype=dtype, **kw)
    if impl is not None:
        m = jcfg.moe
        jcfg = jcfg.replace(moe=JaxMoE(m.num_experts, m.num_shared_experts,
                                       m.top_k, m.aux_loss_weight, impl))
        cfg = cfg.replace(moe=MoEConfig(m.num_experts, m.num_shared_experts,
                                        m.top_k, m.aux_loss_weight, impl))
    return jcfg, cfg


def _batch(cfg, lead, seed):
    """Tokens ``lead + (S,)`` and, for llava, patches ``lead + (P, D)``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  lead + (12,)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            lead + (cfg.num_image_patches, cfg.d_model)).astype(np.float32)
    return out


def test_new_archs_are_the_reference_registry_entries():
    assert set(NEW) <= set(list_archs())
    for arch in NEW:
        got, want = get_arch(arch), jax_get_arch(arch)
        for name in ("arch_id", "source", "notes", "skips"):
            assert getattr(got, name) == getattr(want, name)
        for name in ("config", "reduced"):
            mine, ref = getattr(got, name), getattr(want, name)
            for f in ("name", "family", "num_layers", "d_model", "num_heads",
                      "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                      "kv_lora_rank", "q_lora_rank", "rope_head_dim",
                      "num_image_patches", "act", "tie_embeddings", "dtype",
                      "rope_theta", "norm_eps", "scan_layers"):
                assert getattr(mine, f) == getattr(ref, f), (arch, name, f)
            assert vars(mine.moe) == vars(ref.moe)


@pytest.mark.parametrize("arch,scan", [("llava-next-mistral-7b", True),
                                       ("grok-1-314b", False),
                                       ("deepseek-v2-236b", True)])
def test_init_is_the_reference_init(arch, scan):
    jcfg, cfg = _cfgs(arch, scan_layers=scan)
    want = jax.tree_util.tree_leaves_with_path(
        jax_get_model(jcfg).init(jax.random.PRNGKey(5)))
    got = tree_leaves_with_path(get_model(cfg).init(random.PRNGKey(5), "cpu"))
    assert [p for p, _ in got] == [
        ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        assert np.array_equal(g.numpy().view(np.int32), w.view(np.int32)), path


def test_record_writers_chunked_init_is_the_reference_init():
    """``tests/torch_golden.py moe-full`` draws the reference's init of a
    full-width deepseek-v2 layer in row blocks (``lean_init``): at reduced
    width, one layer, in blocks of 12,288 elements (the experts' leaves in
    three blocks, the head's in six, each last block short), every leaf
    bit for bit the reference's ``init``."""
    from torch_golden import lean_init
    jcfg = jax_get_arch("deepseek-v2-236b").reduced.replace(num_layers=1)
    model = jax_get_model(jcfg)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    want = jax.tree_util.tree_leaves_with_path(model.init(key))
    got = jax.tree_util.tree_leaves(lean_init(model, key, chunk=12288))
    assert len(got) == len(want)
    for (path, w), g in zip(want, got):
        w, g = np.asarray(w), np.ascontiguousarray(g)
        assert g.shape == w.shape, path
        assert np.array_equal(g.view(np.int32), w.view(np.int32)), path


FORWARD = [("llava-next-mistral-7b", None, "float32"),
           ("llava-next-mistral-7b", None, "bfloat16"),
           ("grok-1-314b", "ragged", "float32"),
           ("grok-1-314b", "gshard", "bfloat16"),
           ("deepseek-v2-236b", "ragged", "float32"),
           ("deepseek-v2-236b", "ragged", "bfloat16"),
           ("deepseek-v2-236b", "gshard", "float32"),
           ("deepseek-v2-236b", "gshard", "bfloat16")]


@pytest.mark.parametrize("arch,impl,dtype", FORWARD)
def test_forward_nll_and_gradient_are_the_references(arch, impl, dtype):
    """``logits``, ``loss`` (nll and aux), the node-batched ``nll`` on two
    groups' own tokens (and patches), and the gradient of the mean loss."""
    jcfg, cfg = _cfgs(arch, dtype, impl)
    jm, model = jax_get_model(jcfg), get_model(cfg)
    jps = [jm.init(jax.random.PRNGKey(i)) for i in range(K)]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *jps)
    params = params_from_jax(jax.tree.map(np.asarray, stacked))
    one = _batch(cfg, (B,), 1)
    jone = jax.tree.map(jnp.asarray, one)
    tone = {k: torch.from_numpy(v) for k, v in one.items()}

    want_lg = np.asarray(jax.jit(jm.logits)(jps[0], jone).astype(jnp.float32))
    got_lg = model.logits(params, tone)[0].float().numpy()
    assert got_lg.shape == want_lg.shape
    assert _rel(got_lg, want_lg) <= LOGIT_TOL[dtype]
    (wl, waux) = jax.jit(jm.loss)(jps[0], jone)
    gl, gaux = model.loss(params, tone)
    assert abs(float(gl[0]) - float(wl)) <= LOSS_RTOL[dtype] * abs(float(wl))
    if cfg.family == "moe":
        assert float(waux["aux"]) > 0
        assert abs(float(gaux["aux"][0]) - float(waux["aux"])) <= \
            LOSS_RTOL[dtype] * float(waux["aux"])
    else:
        assert float(gaux["aux"][0]) == 0.0

    nodes = _batch(cfg, (K, B), 2)
    jnodes = jax.tree.map(jnp.asarray, nodes)
    tnodes = {k: torch.from_numpy(v) for k, v in nodes.items()}
    (want_nll, _), want_g = jax.jit(jax.vmap(jax.value_and_grad(
        jm.loss, has_aux=True)))(stacked, jnodes)
    np.testing.assert_allclose(model.nll(params, tnodes).numpy(),
                               np.asarray(want_nll), rtol=LOSS_RTOL[dtype])
    leaves = [x.clone().requires_grad_(True) for x in tree_leaves(params)]
    paths = [p for p, _ in tree_leaves_with_path(params)]
    from repro_torch.utils.tree import tree_unflatten
    model.nll(tree_unflatten(paths, leaves), tnodes).sum().backward()
    for path, g, w in zip(paths, leaves, jax.tree.leaves(want_g)):
        w = np.asarray(w)
        if not np.abs(w).max():
            assert not g.grad.abs().max(), path
            continue
        assert _rel(g.grad.numpy(), w) <= GRAD_TOL[dtype], path


def _ffn_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    return x


@pytest.mark.parametrize("impl,factor", [("ragged", 1.25), ("gshard", 1.25),
                                         ("gshard", 0.5)])
@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v2-236b"])
def test_moe_ffn_is_the_references(arch, impl, factor):
    """The FFN alone, with experts 0 and 1 routed alike (equal router
    columns: exact ties, the lower expert first) and, at capacity factor
    0.5, copies dropped."""
    jcfg, cfg = _cfgs(arch)
    m = jcfg.moe
    jcfg = jcfg.replace(moe=JaxMoE(m.num_experts, m.num_shared_experts,
                                   m.top_k, m.aux_loss_weight, impl, factor))
    cfg = cfg.replace(moe=MoEConfig(m.num_experts, m.num_shared_experts,
                                    m.top_k, m.aux_loss_weight, impl, factor))
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    jp["router"] = jp["router"].at[:, 1].set(jp["router"][:, 0])
    x = _ffn_inputs(cfg, 4)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, cfg.d_model)
                           @ jp["router"], axis=-1)
    top_e = np.asarray(jax.lax.top_k(probs, m.top_k)[1])
    assert (top_e[:, 0] == 0).any() and not (top_e[:, 0] == 1).any()
    want, waux = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, jcfg))(
        jp, jnp.asarray(x))
    p = tree_map(lambda a: a[None], params_from_jax(jax.tree.map(np.asarray,
                                                                 jp)))
    got, gaux = pmoe.moe_ffn(p, torch.from_numpy(x)[None], cfg)
    assert _rel(got[0].numpy(), want) <= FFN_TOL
    assert abs(float(gaux[0]) - float(waux)) <= 1e-6 * float(waux)
    if factor < 1:
        full = jmoe.moe_ffn_ragged(jp, jnp.asarray(x), jcfg)[0]
        assert _rel(want, full) > 1e-3          # copies were dropped


@pytest.mark.parametrize("chunked", [False, True])
def test_mla_attention_is_the_references(chunked):
    jcfg, cfg = _cfgs("deepseek-v2-236b", chunk_size=4,
                      attn_impl="chunked" if chunked else "naive")
    jp = jmla.init_mla(jax.random.PRNGKey(2), jcfg)
    x = np.random.default_rng(5).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12))
    want = jax.jit(lambda p, x: jmla.mla_attention(p, x, pos, jcfg))(
        jp, jnp.asarray(x))
    p = tree_map(lambda a: a[None], params_from_jax(jax.tree.map(np.asarray,
                                                                 jp)))
    got = pmla.mla_attention(p, torch.from_numpy(x)[None],
                             torch.from_numpy(pos.copy()), cfg)
    assert _rel(got[0].numpy(), want) <= 1e-5


def test_mla_decode_equals_prefill_and_the_reference():
    """deepseek-v2 reduced in f32 through f32 latent caches: 12 steps of the
    absorbed decode against the forward (atol 2e-3) and against the
    reference's decode steps (1e-5 of the largest logit)."""
    jcfg, cfg = _cfgs("deepseek-v2-236b")
    jm, model = jax_get_model(jcfg), get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = tree_map(lambda a: a[None],
                      params_from_jax(jax.tree.map(np.asarray, jp)))
    toks = _batch(cfg, (2,), 7)["tokens"]
    fwd = model.logits(params, {"tokens": torch.from_numpy(toks)})[0]
    cache = model.init_decode_state(2, 16, dtype_kv=torch.float32)
    jcache = jm.init_decode_state(2, 16, dtype_kv=jnp.float32)
    jstep = jax.jit(jm.decode_step)
    for pos in range(toks.shape[1]):
        cache, lg = model.decode_step(params, cache,
                                      torch.from_numpy(toks[:, pos]),
                                      torch.full((2,), pos))
        jcache, jlg = jstep(jp, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                            pos)
        np.testing.assert_allclose(lg[0, :, 0].numpy(), fwd[:, pos].numpy(),
                                   atol=2e-3, rtol=2e-3)
        assert _rel(lg[0, :, 0].numpy(), jlg[:, 0]) <= 1e-5
    assert cache["groups"]["u0"]["ckv"].shape[-2:] == (16, cfg.kv_lora_rank)


def _reference_round(arch, impl, scan=True):
    fed = JaxFedConfig(algorithm="cdbfl", **FED)
    jcfg, cfg = _cfgs(arch, "float32", impl, scan_layers=scan)
    jm = jax_get_model(jcfg)
    key = jax.random.PRNGKey(0)
    params0 = jm.init(key)
    state = init_fed_state(params0, fed, key=key)
    omega = build_topology(resolve_topology(fed), K).omega
    round_fn = jax.jit(make_round_fn("cdbfl", jm.loss, fed, omega,
                                     make_compressor(fed), DATA_SCALE))
    toks = np.stack([_tokens(jcfg, 10 + k, (L, B, S)) for k in range(K)])
    kround = jax.random.PRNGKey(7)
    state, metrics = round_fn(state, {"tokens": jnp.asarray(toks)}, kround)
    return (cfg, jax.tree.map(np.asarray, params0), toks, _key(kround),
            jax.tree.map(np.asarray, state), metrics, omega)


@pytest.mark.parametrize("arch,impl,scan", [
    ("grok-1-314b", "ragged", True), ("deepseek-v2-236b", "gshard", True),
    ("grok-1-314b", "ragged", False)])
def test_moe_round_is_the_references(arch, impl, scan):
    """``scan=False`` keeps the layers a list (``params["layers"]``): the
    round's gradient tree goes through ``tree_unflatten``, which rebuilt
    that list as a dict of index keys (ROADMAP C34), so a model with
    unscanned layers could not train."""
    cfg, params0, toks, kround, ref_state, ref_metrics, omega = \
        _reference_round(arch, impl, scan)
    fed = FedConfig(algorithm="cdbfl", **FED)
    model = get_model(cfg)
    round_fn = port_alg.make_round_fn("cdbfl", model.nll, fed, omega,
                                      port_compressor(fed), DATA_SCALE, "cpu")
    state = port_state.init_fed_state(params_from_jax(params0), fed)
    batches = {"tokens": torch.from_numpy(toks)}
    theta_l, _ = port_alg._local_sgd(model.nll, state.params, batches,
                                     fed.eta, 1.0 / K, DATA_SCALE, L)
    new, metrics = round_fn(state, batches, kround)
    _check_round(new, metrics, ref_state, ref_metrics, "float32",
                 [x.numpy() for x in tree_leaves(theta_l)])


def _vlm_shards(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (n, 12)).astype(
                 np.int32),
             "patches": rng.standard_normal(
                 (n, cfg.num_image_patches, cfg.d_model)).astype(np.float32)}
            for _ in range(K)]


@pytest.mark.parametrize("layers", [2, 1])
def test_llava_rounds_through_the_trainer_scan_equals_host(layers):
    """llava on ``{tokens, patches}`` pools, two rounds on each engine, bit
    for bit; the losses finite and the bank's θ moved. One layer keeps the
    layers a list, which the scan engine's carry copy once dropped
    (ROADMAP C34)."""
    _, cfg = _cfgs("llava-next-mistral-7b", "bfloat16", num_layers=layers)
    fed = FedConfig(algorithm="cdbfl", **FED)
    states = []
    for engine in ("host", "scan"):
        tr = FedTrainer(get_model(cfg), fed, _vlm_shards(cfg, 6, 0),
                        minibatch=2, engine=engine, chunk=2, device="cpu")
        p0 = [x.clone() for x in tree_leaves(tr.state.params)]
        res = tr.run(rounds=2)
        assert all(np.isfinite(h) for h in res.loss_history)
        states.append(tr.state)
    img = [p for p, _ in tree_leaves_with_path(states[0].params)].index(
        "embed.img_proj")
    assert not torch.equal(tree_leaves(states[0].params)[img], p0[img])
    for name in ("params", "v", "v_bar"):
        for a, b in zip(tree_leaves(getattr(states[0], name)),
                        tree_leaves(getattr(states[1], name))):
            assert torch.equal(a, b), name


def test_llava_train_cli_fails_as_the_references(capsys, monkeypatch):
    """The reference's train CLI builds token-only pools for every LM arch
    and its vlm loss reads ``batch["patches"]``: it prints its header lines
    and fails with ``KeyError: 'patches'`` at the first round. The port's
    CLI prints the same lines and fails the same way."""
    import sys
    from repro.launch import train as jax_train
    from repro_torch.launch import train as port_train
    argv = ["--arch", "llava-next-mistral-7b", "--trim", "--rounds", "1",
            "--local-steps", "1", "--seq", "16", "--batch", "2"]
    heads = ("arch=", "wire accounting:", "topology=")
    outs = []
    for run in (jax_train.main,
                lambda: port_train.main(argv + ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["train"] + argv)
        capsys.readouterr()
        with pytest.raises(KeyError, match="patches"):
            run()
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith(heads)])
    assert len(outs[0]) == 3 and outs[1] == outs[0]


@pytest.mark.parametrize("arch,dtype", [("deepseek-v2-236b", "float32"),
                                        ("grok-1-314b", "bfloat16")])
def test_decode_engine_matches_the_reference_engine(arch, dtype):
    """``DecodeEngine`` over a bank of 3 (MLA's latent caches reset on
    admit; grok's GQA through ``decode_attention``'s plain version) against
    the reference's engine on 5 requests, 2 slots, 4 new tokens: tokens
    equal at every step, as ``test_torch_decode.py`` holds smollm's, token
    entropies within rtol 1e-5 (f32) and 1e-3 (bf16). The port decodes
    with the configs' ``impl="ragged"``; the reference's engine vmaps a
    batch-1 step over its lanes, where ``ragged_dot`` has no batching rule
    (ROADMAP C33), so it decodes with ``"gshard"``, which drops nothing at
    one token a lane: the same function."""
    from repro.config import ServeConfig as JaxServeConfig
    from repro.serve import DecodeEngine as JaxDecodeEngine
    from repro.serve import ServeRequest as JaxServeRequest
    from repro_torch.config import ServeConfig
    from repro_torch.serve import DecodeEngine, ServeRequest
    jcfg, cfg = _cfgs(arch, dtype)
    with pytest.raises(NotImplementedError, match="ragged_dot"):
        JaxDecodeEngine(jax_get_model(jcfg), JaxServeConfig(
            slots=1, max_len=4, max_new_tokens=1), stacked=jax.tree.map(
                lambda x: x[None], jax_get_model(jcfg).init(
                    jax.random.PRNGKey(0)))).run(
            [JaxServeRequest(prompt_token=1, seed=0)])
    jcfg = _cfgs(arch, dtype, "gshard")[0]
    jm = jax_get_model(jcfg)
    key = jax.random.PRNGKey(0)
    bank = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jm.init(jax.random.fold_in(key, i)) for i in range(3)])
    reqs = [(1 + 37 * i % (cfg.vocab_size - 1), i) for i in range(5)]
    want = JaxDecodeEngine(jm, JaxServeConfig(slots=2, max_len=8,
                                              max_new_tokens=4),
                           stacked=bank).run(
        [JaxServeRequest(prompt_token=t, seed=s) for t, s in reqs])
    got = DecodeEngine(get_model(cfg), ServeConfig(slots=2, max_len=8,
                                                   max_new_tokens=4),
                       stacked=params_from_jax(jax.tree.map(np.asarray,
                                                            bank))).run(
        [ServeRequest(prompt_token=t, seed=s) for t, s in reqs])
    for g, w in zip(got, want):
        assert g.tokens.tolist() == w.tokens.tolist()
        np.testing.assert_allclose(g.token_entropy, w.token_entropy,
                                   rtol=1e-5 if dtype == "float32" else 1e-3)
