"""The hybrid and ssm families on the port against the reference (ROADMAP
A12 parts 5 and 6), on the CPU at the reduced widths of recurrentgemma-9b
(RG-LRU and a local-attention ring) and xlstm-1.3b (mLSTM, sLSTM), with
enough layers that the scanned groups and the tail both occur.

- Registry entries and init: every leaf bit for bit but RG-LRU's
  ``a_param``, whose init goes through XLA's CPU ``expm1``, which is not
  correctly rounded where the port's is (ROADMAP C39): within 2 f32 ulps
  (measured 1).
- The RG-LRU parts alone on the same inputs: ``_causal_conv`` within 1e-6
  of the largest output (XLA contracts its products and sums in f32);
  ``lru_scan`` and ``chunked_lru`` bit for bit the reference's
  ``associative_scan`` and ``chunked_lru`` under ``jit`` (the scan's
  ``a2·b1 + b2`` contracted to an fma, ROADMAP C38), and the reference's
  chunked form within 1e-6 of its plain scan.
- The mLSTM's parallel and chunkwise forms and the sLSTM's scan, plain and
  chunked (chunk_size 4 at S = 12), within 1e-5 of the largest output.
- The forward, ``loss`` and node-batched ``nll`` and the gradient, f32
  and bf16: f32 logits within 3e-5 of the largest (measured 1.2e-5 on
  xlstm), losses rtol 1e-6,
  gradients within 3e-5 of each leaf's largest (measured up to 1.4e-5 on
  xlstm's gate weights: 12 recurrent steps a layer); bf16 logits within
  5e-2 (measured 3.05e-2 on recurrentgemma at 8 layers), losses rtol 3e-3
  (measured 1.3e-3 on recurrentgemma at 7: the bf16 recurrence).
  A bf16 gradient is noise-bound at these depths: the reference's own
  bf16 gradient lies up to 0.92 (xlstm) and 0.11 (recurrentgemma) of the
  largest from its f32 gradient, so each port bf16 leaf is held to the f32
  gradient within twice the reference's bf16 distance plus 5e-2.
- Decode through f32 states and caches equals the forward (atol 2e-3, the
  reference's own check of its zoo) and the reference's decode steps
  (1e-5 of the largest logit).
- One cdbfl round from the reference's init, minibatches and key, as
  ``test_torch_lm_train.py`` holds smollm's (index sets exact), params, v
  and v̄ within 3e-5 (measured 1.7e-5 on xlstm's embedding, 1.1e-6 on
  recurrentgemma's: the gradients' f32 differences above, times η and
  the data scale, over two local steps); FedTrainer's scan engine bit for
  bit its host engine.
- ``DecodeEngine`` against the reference's engine, and the two repairs
  (ROADMAP C35, C36): an admit resets a used slot from the pristine
  one-lane cache, and a bf16 bank keeps the leaves the reference reads in
  f32.
- The train and serve CLIs' lines equal the reference CLIs'.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.config import get_arch as jax_get_arch
from repro.core import (build_topology, init_fed_state, make_compressor,
                        resolve_topology)
from repro.core.algorithms import make_round_fn
from repro.models import chunked as jchunked
from repro.models import get_model as jax_get_model
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm
from repro_torch import random
from repro_torch.config import FedConfig, ServeConfig, get_arch, list_archs
from repro_torch.core import algorithms as port_alg
from repro_torch.core import fed_state as port_state
from repro_torch.core.compression import make_compressor as port_compressor
from repro_torch.models import chunked as pchunked
from repro_torch.models import get_model
from repro_torch.models import rglru as prglru
from repro_torch.models import xlstm as pxlstm
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve import DecodeEngine, ServeRequest
from repro_torch.train import FedTrainer
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_map, tree_unflatten)

import torch_threads  # noqa: F401  (one torch thread a process)
from test_torch_lm_train import _check_round, _key, _tokens
from torch_golden import decode_requests, reference_decode

NEW = ("recurrentgemma-9b", "xlstm-1.3b")
# layers: two scanned groups and a tail (recurrentgemma: 2 x (rec, rec,
# local_attn) + rec; xlstm at mlstm_ratio 1: 2 x (mlstm, slstm) + mlstm)
LAYERS = {"recurrentgemma-9b": 7, "xlstm-1.3b": 5}
LOGIT_TOL = {"float32": 3e-5, "bfloat16": 5e-2}
LOSS_RTOL = {"float32": 1e-6, "bfloat16": 3e-3}
GRAD_TOL = {"float32": 3e-5, "bfloat16": 5e-2}
# a bf16 gradient leaf is held to the f32 gradient within twice the
# reference's own bf16 distance to it, plus GRAD_TOL
BF16_GRAD_SLACK = 2.0
A_PARAM_ULPS = 2
K, L, B, S = 2, 2, 2, 12
DATA_SCALE = 50.0
FED = dict(num_nodes=K, local_steps=L, eta=1e-3, zeta=0.3, temperature=0.1,
           burn_in=1, rounds=2, topology="ring")


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _cfgs(arch, dtype="float32", **kw):
    kw.setdefault("num_layers", LAYERS[arch])
    return (jax_get_arch(arch).reduced.replace(dtype=dtype, **kw),
            get_arch(arch).reduced.replace(dtype=dtype, **kw))


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32)).max())


def _port(jp):
    """Reference params as a port bank of one."""
    return tree_map(lambda a: a[None],
                    params_from_jax(jax.tree.map(np.asarray, jp)))


def test_new_archs_are_the_reference_registry_entries():
    assert set(NEW) <= set(list_archs())
    for arch in NEW:
        got, want = get_arch(arch), jax_get_arch(arch)
        for name in ("arch_id", "source", "notes", "skips"):
            assert getattr(got, name) == getattr(want, name)
        for name in ("config", "reduced"):
            assert vars(getattr(got, name)) == {
                k: v for k, v in vars(getattr(want, name)).items()
                if k != "moe"} | {"moe": getattr(got, name).moe}
            assert vars(getattr(got, name).moe) == \
                vars(getattr(want, name).moe)


@pytest.mark.parametrize("arch,scan", [("recurrentgemma-9b", True),
                                       ("recurrentgemma-9b", False),
                                       ("xlstm-1.3b", True)])
def test_init_is_the_reference_init(arch, scan):
    jcfg, cfg = _cfgs(arch, scan_layers=scan)
    want = jax.tree_util.tree_leaves_with_path(
        jax_get_model(jcfg).init(jax.random.PRNGKey(5)))
    got = tree_leaves_with_path(get_model(cfg).init(random.PRNGKey(5), "cpu"))
    assert [p for p, _ in got] == [
        ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in want]
    assert any(p.startswith("tail.") for p, _ in got) == scan
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        if path.endswith("a_param"):
            assert _ulps(g.numpy(), w) <= A_PARAM_ULPS, path
        else:
            assert np.array_equal(g.numpy().view(np.int32),
                                  w.view(np.int32)), path


@pytest.mark.parametrize("state", [False, True])
def test_causal_conv_is_the_references(state):
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 16)).astype(np.float32) if state else None
    want, wst = jax.jit(jrglru._causal_conv)(u, w, b, st)
    got, gst = prglru._causal_conv(
        torch.from_numpy(u)[None], torch.from_numpy(w)[None],
        torch.from_numpy(b)[None],
        None if st is None else torch.from_numpy(st)[None])
    assert _rel(got[0].numpy(), want) <= 1e-6
    assert np.array_equal(gst[0].numpy(), np.asarray(wst))


def _lru_inputs(s: int):
    rng = np.random.default_rng(s)
    return (rng.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32),
            rng.standard_normal((2, s, 8)).astype(np.float32))


def _assoc(a, b):
    def combine(x, y):
        a1, b1 = x
        a2, b2 = y
        return a1 * a2, a2 * b1 + b2
    return jax.lax.associative_scan(combine, (a, b), axis=1)


@pytest.mark.parametrize("s", [1, 2, 7, 16, 33])
def test_lru_scan_is_the_references_associative_scan(s):
    a, b = _lru_inputs(s)
    wa, wb = jax.jit(_assoc)(a, b)
    ga, gb = prglru.lru_scan(torch.from_numpy(a), torch.from_numpy(b), 1)
    assert np.array_equal(ga.numpy(), np.asarray(wa))
    assert np.array_equal(gb.numpy().view(np.int32),
                          np.asarray(wb).view(np.int32))


def test_chunked_lru_is_the_references_and_its_scan():
    a, b = _lru_inputs(24)
    want = np.asarray(jax.jit(lambda a, b: jchunked.chunked_lru(
        a, b, chunk=8))(a, b))
    got = pchunked.chunked_lru(torch.from_numpy(a)[None],
                               torch.from_numpy(b)[None], chunk=8)[0]
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert _rel(want, np.asarray(jax.jit(_assoc)(a, b)[1])) <= 1e-6


def _x(cfg, s=12, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("block,impl", [("mlstm", "naive"),
                                        ("mlstm", "chunked"),
                                        ("slstm", "naive"),
                                        ("slstm", "auto")])
def test_xlstm_blocks_are_the_references(block, impl):
    """At chunk_size 4 and S = 12: the mLSTM's chunkwise form (chunks of
    4) and the sLSTM's chunked scan (``auto``: S >= 2 · chunk)."""
    jcfg, cfg = _cfgs("xlstm-1.3b", chunk_size=4, attn_impl=impl)
    init = getattr(jxlstm, f"init_{block}_block")
    apply = getattr(jxlstm, f"{block}_block")
    jp = init(jax.random.PRNGKey(2), jcfg)
    x = _x(cfg)
    want = jax.jit(lambda p, x: apply(p, x, jcfg))(jp, jnp.asarray(x))
    got = getattr(pxlstm, f"{block}_block")(
        _port(jp), torch.from_numpy(x)[None], cfg)
    assert _rel(got[0].numpy(), want) <= 1e-5


def test_rglru_block_is_the_references_plain_and_chunked():
    for impl in ("naive", "chunked"):
        jcfg, cfg = _cfgs("recurrentgemma-9b", chunk_size=4, attn_impl=impl)
        jp = jrglru.init_rglru_block(jax.random.PRNGKey(2), jcfg)
        x = _x(cfg)
        want = jax.jit(lambda p, x: jrglru.rglru_block(p, x, jcfg))(
            jp, jnp.asarray(x))
        got = prglru.rglru_block(_port(jp), torch.from_numpy(x)[None], cfg)
        assert _rel(got[0].numpy(), want) <= 1e-5, impl


FORWARD = [(a, d) for a in NEW for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("arch,dtype", FORWARD)
def test_forward_nll_and_gradient_are_the_references(arch, dtype):
    jcfg, cfg = _cfgs(arch, dtype)
    jm, model = jax_get_model(jcfg), get_model(cfg)
    jps = [jm.init(jax.random.PRNGKey(i)) for i in range(K)]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *jps)
    params = params_from_jax(jax.tree.map(np.asarray, stacked))
    one = {"tokens": _tokens(cfg, 1, (B, S))}
    jone = jax.tree.map(jnp.asarray, one)
    tone = {k: torch.from_numpy(v) for k, v in one.items()}
    want_lg = np.asarray(jax.jit(jm.logits)(jps[0], jone).astype(jnp.float32))
    got_lg = model.logits(params, tone)[0].float().numpy()
    assert got_lg.shape == want_lg.shape
    assert _rel(got_lg, want_lg) <= LOGIT_TOL[dtype]
    wl, _ = jax.jit(jm.loss)(jps[0], jone)
    gl, _ = model.loss(params, tone)
    assert abs(float(gl[0]) - float(wl)) <= LOSS_RTOL[dtype] * abs(float(wl))

    nodes = {"tokens": np.stack([_tokens(cfg, 2 + k, (B, S))
                                 for k in range(K)])}
    (want_nll, _), want_g = jax.jit(jax.vmap(jax.value_and_grad(
        jm.loss, has_aux=True)))(stacked, jax.tree.map(jnp.asarray, nodes))
    tnodes = {k: torch.from_numpy(v) for k, v in nodes.items()}
    np.testing.assert_allclose(model.nll(params, tnodes).numpy(),
                               np.asarray(want_nll), rtol=LOSS_RTOL[dtype])
    leaves = [x.clone().requires_grad_(True) for x in tree_leaves(params)]
    paths = [p for p, _ in tree_leaves_with_path(params)]
    model.nll(tree_unflatten(paths, leaves), tnodes).sum().backward()
    want_g = [np.asarray(w) for w in jax.tree.leaves(want_g)]
    if dtype == "float32":
        limits = [GRAD_TOL[dtype]] * len(want_g)
        exact = want_g
    else:
        # the f32 gradient, and the reference's own bf16 distance to it
        f32 = jax_get_model(jcfg.replace(dtype="float32"))
        exact = [np.asarray(w) for w in jax.tree.leaves(jax.jit(jax.vmap(
            jax.grad(lambda p, b: f32.loss(p, b)[0])))(
                stacked, jax.tree.map(jnp.asarray, nodes)))]
        limits = [BF16_GRAD_SLACK * _rel(w, e) + GRAD_TOL[dtype]
                  for w, e in zip(want_g, exact)]
    for path, g, w, lim in zip(paths, leaves, exact, limits):
        if not np.abs(w).max():
            assert not g.grad.abs().max(), path
            continue
        assert _rel(g.grad.numpy(), w) <= lim, path


@pytest.mark.parametrize("arch", NEW)
def test_decode_equals_forward_and_the_reference(arch):
    """f32 states and f32 KV caches (the ring of 32 slots wraps at
    recurrentgemma's reduced window only past 32 tokens: 12 here)."""
    jcfg, cfg = _cfgs(arch)
    jm, model = jax_get_model(jcfg), get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = _port(jp)
    toks = _tokens(cfg, 7, (2, S))
    fwd = model.logits(params, {"tokens": torch.from_numpy(toks)})[0]
    cache = model.init_decode_state(2, 16, dtype_kv=torch.float32)
    jcache = jm.init_decode_state(2, 16, dtype_kv=jnp.float32)
    jstep = jax.jit(jm.decode_step)
    for pos in range(S):
        cache, lg = model.decode_step(params, cache,
                                      torch.from_numpy(toks[:, pos]),
                                      torch.full((2,), pos))
        jcache, jlg = jstep(jp, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                            pos)
        np.testing.assert_allclose(lg[0, :, 0].numpy(), fwd[:, pos].numpy(),
                                   atol=2e-3, rtol=2e-3)
        assert _rel(lg[0, :, 0].numpy(), jlg[:, 0]) <= 1e-5
    for path, x in tree_leaves_with_path(cache):
        if not path.endswith(("k", "v", "slot_pos")):
            assert x.dtype == torch.float32, path


@pytest.mark.parametrize("arch", NEW)
def test_round_is_the_references(arch, monkeypatch):
    import test_torch_lm_train
    monkeypatch.setitem(test_torch_lm_train.ROUND_ATOL, "float32", 3e-5)
    fed = JaxFedConfig(algorithm="cdbfl", **FED)
    jcfg, cfg = _cfgs(arch)
    jm = jax_get_model(jcfg)
    key = jax.random.PRNGKey(0)
    params0 = jm.init(key)
    state = init_fed_state(params0, fed, key=key)
    omega = build_topology(resolve_topology(fed), K).omega
    round_fn = jax.jit(make_round_fn("cdbfl", jm.loss, fed, omega,
                                     make_compressor(fed), DATA_SCALE))
    toks = np.stack([_tokens(jcfg, 10 + k, (L, B, S)) for k in range(K)])
    kround = jax.random.PRNGKey(7)
    ref_state, ref_metrics = round_fn(state, {"tokens": jnp.asarray(toks)},
                                      kround)
    pfed = FedConfig(algorithm="cdbfl", **FED)
    model = get_model(cfg)
    pround = port_alg.make_round_fn("cdbfl", model.nll, pfed, omega,
                                    port_compressor(pfed), DATA_SCALE, "cpu")
    pstate = port_state.init_fed_state(
        params_from_jax(jax.tree.map(np.asarray, params0)), pfed)
    batches = {"tokens": torch.from_numpy(toks)}
    theta_l, _ = port_alg._local_sgd(model.nll, pstate.params, batches,
                                     pfed.eta, 1.0 / K, DATA_SCALE, L)
    new, metrics = pround(pstate, batches, _key(kround))
    _check_round(new, metrics, jax.tree.map(np.asarray, ref_state),
                 ref_metrics, "float32",
                 [x.numpy() for x in tree_leaves(theta_l)])


def _shards(cfg, n, seed):
    return [{"tokens": _tokens(cfg, seed + k, (n, S))} for k in range(K)]


@pytest.mark.parametrize("arch", NEW)
def test_rounds_through_the_trainer_scan_equals_host(arch):
    _, cfg = _cfgs(arch, "bfloat16")
    fed = FedConfig(algorithm="cdbfl", **FED)
    states = []
    for engine in ("host", "scan"):
        tr = FedTrainer(get_model(cfg), fed, _shards(cfg, 6, 0),
                        minibatch=2, engine=engine, chunk=2, device="cpu")
        res = tr.run(rounds=2)
        assert all(np.isfinite(h) for h in res.loss_history)
        states.append(tr.state)
    for name in ("params", "v", "v_bar"):
        for a, b in zip(tree_leaves(getattr(states[0], name)),
                        tree_leaves(getattr(states[1], name))):
            assert torch.equal(a, b), name


def _bank(jcfg, n=3):
    jm = jax_get_model(jcfg)
    key = jax.random.PRNGKey(0)
    return jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jm.init(jax.random.fold_in(key, i)) for i in range(n)])


DECODE = dict(slots=2, max_len=8, max_new_tokens=4, requests=5, seed=0,
              top=4)
# a token is held to the reference's only above this top-two margin of its
# perturbed scores, as the decode record's checks hold theirs (bf16: the
# port and the reference round at other places)
MARGIN = {"float32": 0.0, "bfloat16": 1e-2}


@pytest.mark.parametrize("arch,dtype", [(a, d) for a in NEW
                                        for d in ("float32", "bfloat16")])
def test_decode_engine_matches_the_reference_engine(arch, dtype):
    """Over a bank of 3, 5 requests through 2 slots (every slot admitted
    twice), 4 new tokens: each request's tokens the reference engine's up
    to its first step at or under the margin (f32: all), token entropies
    within rtol 1e-5 (f32) and 2e-2 (bf16) up to it."""
    jcfg, cfg = _cfgs(arch, dtype)
    bank = _bank(jcfg)
    run = reference_decode(jax_get_model(jcfg), bank, DECODE)
    reqs = decode_requests(cfg.vocab_size, DECODE["requests"], 0)
    got = DecodeEngine(get_model(cfg), ServeConfig(
        slots=DECODE["slots"], max_len=DECODE["max_len"],
        max_new_tokens=DECODE["max_new_tokens"]),
        stacked=params_from_jax(jax.tree.map(np.asarray, bank))).run(
        [ServeRequest(prompt_token=t, seed=s) for t, s in reqs])
    compared = 0
    for g, toks, ents, margins in zip(got, run["tokens"],
                                      run["token_entropy"], run["margins"]):
        first = next((i for i, m in enumerate(margins)
                      if m <= MARGIN[dtype]), len(margins))
        assert g.tokens[:first].tolist() == toks[:first]
        upto = min(first + 1, len(ents))
        np.testing.assert_allclose(g.token_entropy[:upto], ents[:upto],
                                   rtol=1e-5 if dtype == "float32" else 2e-2)
        compared += first
    assert compared >= (20 if dtype == "float32" else 12)


@pytest.mark.parametrize("arch", NEW)
def test_c35_admit_resets_a_used_slot_from_the_pristine_cache(arch):
    """ROADMAP C35. One slot serves three requests in turn; each gives the
    tokens a fresh engine gives it alone. The old admit filled every leaf
    with 0 along an axis looked up by the leaf's name: sLSTM's normalizer
    starts at 1, and an mLSTM ``n`` and an sLSTM ``n`` sit at different
    depths, so a used slot decoded another sequence."""
    _, cfg = _cfgs(arch)
    model = get_model(cfg)
    bank = params_from_jax(jax.tree.map(np.asarray, _bank(_cfgs(arch)[0], 2)))
    scfg = ServeConfig(slots=1, max_len=8, max_new_tokens=5)
    reqs = [ServeRequest(prompt_token=t, seed=s)
            for t, s in decode_requests(cfg.vocab_size, 3, 4)]
    shared = DecodeEngine(model, scfg, stacked=bank).run(reqs)
    for r, got in zip(reqs, shared):
        alone = DecodeEngine(model, scfg, stacked=bank).run([r])[0]
        assert got.tokens.tolist() == alone.tokens.tolist()
        np.testing.assert_array_equal(got.token_entropy, alone.token_entropy)


# the bf16 engine's teacher-forced logits against the reference's bf16
# decode steps over the f32 bank, relative to the largest (measured up to
# 3.3e-2 on recurrentgemma and 5.1e-2 on xlstm over 6 steps); the control,
# the same bank with the f32 leaves rounded to bf16, departs from the f32
# bank's decode by more than C36_CONTROL (measured 2.9e-2 and 3.3e-2)
C36_TOL = 6e-2
C36_CONTROL = 1e-2


@pytest.mark.parametrize("arch", NEW)
def test_c36_bf16_bank_keeps_the_leaves_the_reference_reads_in_f32(arch):
    """ROADMAP C36. The resident bf16 bank stores ``scale``, ``a_param``,
    ``wif``, ``bif`` and sLSTM's ``b`` and ``wh`` in f32 (the model's
    ``f32_leaf``, not a suffix match: ``conv_b``, ``ba`` and ``bx`` are
    bf16), so its teacher-forced decode over 6 steps is bit for bit the
    decode over the f32 bank, the reference's reading (it casts at use),
    and within C36_TOL of the reference's logits. The bank with those
    leaves rounded to bf16 (the engine's old choice) departs from it by
    more than C36_CONTROL."""
    jcfg, cfg = _cfgs(arch, "bfloat16")
    model = get_model(cfg)
    jbank = _bank(jcfg, 2)
    f32_bank = params_from_jax(jax.tree.map(np.asarray, jbank))
    eng = DecodeEngine(model, ServeConfig(slots=2, max_len=8,
                                          max_new_tokens=2),
                       stacked=f32_bank)
    kept = {p.rsplit(".", 2)[-2] + "." + p.rsplit(".", 1)[-1]
            for p, x in tree_leaves_with_path(eng._bank)
            if x.dtype == torch.float32}
    want = {"rec.a_param"} if arch == "recurrentgemma-9b" else \
        {"mlstm.wif", "mlstm.bif", "slstm.b", "slstm.wh"}
    assert want <= kept
    assert all(k.endswith(".scale") for k in kept - want)
    for p, x in tree_leaves_with_path(eng._bank):
        if p.endswith(("conv_b", ".ba", ".bx", ".proj")):
            assert x.dtype == torch.bfloat16, p
    toks = _tokens(cfg, 9, (2, 6))
    jm = jax_get_model(jcfg)
    jstep = jax.jit(jax.vmap(jm.decode_step, in_axes=(0, 0, None, None)))
    jcache = jax.vmap(lambda _: jm.init_decode_state(2, 8))(jnp.arange(2))

    def run(bank):
        cache = model.init_decode_state(2, 8, groups=2)
        out = []
        for pos in range(toks.shape[1]):
            cache, lg = model.decode_step(bank, cache,
                                          torch.from_numpy(toks[:, pos]),
                                          torch.full((2,), pos))
            out.append(lg[:, :, 0].float().numpy())
        return np.stack(out)

    want_lg = []
    for pos in range(toks.shape[1]):
        jcache, jlg = jstep(jbank, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                            pos)
        want_lg.append(np.asarray(jlg[:, :, 0].astype(jnp.float32)))
    got, exact = run(eng._bank), run(f32_bank)
    assert np.array_equal(got, exact)
    assert _rel(got, np.stack(want_lg)) <= C36_TOL
    control = run(tree_map(lambda x: x.to(torch.bfloat16), eng._bank))
    assert _rel(control, exact) > C36_CONTROL


@pytest.mark.parametrize("arch", NEW)
def test_train_cli_lines_equal_the_reference_cli(arch, capsys, monkeypatch):
    import sys
    from repro.launch import train as jax_train
    from repro_torch.launch import train as port_train
    argv = ["--arch", arch, "--trim", "--rounds", "2", "--local-steps", "1",
            "--seq", "16", "--batch", "2", "--log-every", "1"]
    heads = ("arch=", "wire accounting:", "topology=")
    outs = []
    for run in (jax_train.main,
                lambda: port_train.main(argv + ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["train"] + argv)
        capsys.readouterr()
        run()
        lines = capsys.readouterr().out.splitlines()
        assert sum(ln.startswith("round ") for ln in lines) == 2
        outs.append([ln for ln in lines if ln.startswith(heads)])
    assert len(outs[0]) == 3 and outs[1] == outs[0]


@pytest.mark.parametrize("arch", NEW)
def test_serve_cli_decodes_the_reference_cli_tokens(arch, capsys,
                                                    monkeypatch):
    """The decode CLI's lines on the reduced config in f32 (both
    registries' entries patched for the test; in bf16 an entropy's third
    decimal depends on where each package rounds)."""
    import dataclasses
    import re
    import sys
    import repro.config as jax_config
    import repro_torch.config as port_config
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve as port_serve
    for mod, get in ((jax_config, jax_get_arch), (port_config, get_arch)):
        spec = get(arch)
        monkeypatch.setitem(mod._ARCHS, arch, dataclasses.replace(
            spec, reduced=spec.reduced.replace(dtype="float32")))
    argv = ["--arch", arch, "--trim", "--mode", "decode", "--requests", "4",
            "--slots", "2", "--max-new-tokens", "3", "--smoke"]
    outs = []
    for run in (jax_serve.main,
                lambda: port_serve.main(argv + ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        capsys.readouterr()
        run()
        outs.append([re.sub(r" latency_ms=[0-9.]+", "", ln) for ln in
                     capsys.readouterr().out.splitlines()
                     if ln.startswith(("resp ", "serve[decode]"))])
    assert len(outs[0]) == 5 and outs[1] == outs[0]
