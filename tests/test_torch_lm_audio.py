"""The audio family on the port against the reference (ROADMAP A12 part
7): whisper-tiny's encoder-decoder on the CPU at its reduced width (2
encoder and 2 decoder layers, 64 frames of 96).

- Registry entry and init: every leaf bit for bit.
- ``encode`` (bidirectional attention), the decoder's cross-attention and
  ``prefill_encoder`` against the reference's: f32 within 1e-5 of the
  largest output.
- ``logits``, ``loss``, the node-batched ``nll`` on two groups' own tokens
  and frames, and the gradient: f32 logits within 1e-5 of the largest,
  losses rtol 1e-6, gradients within 1e-5 of each leaf's largest; bf16
  3e-2, 1e-3 and 5e-2 (every op rounds to bf16's 8 bits, as the other
  families' tests state).
- Decode through f32 caches: against zero encoder output (the engine's,
  ROADMAP C37) and against a prefilled one, equal to the forward (atol
  2e-3) and to the reference's decode steps (1e-5 of the largest logit).
- One cdbfl round against the reference's and ``FedTrainer`` on pools of
  ``{tokens, frames}``, scan = host bit for bit.
- ``DecodeEngine`` against the reference's engine (zero ``enc_out``: the
  reference's engine never calls ``prefill_encoder``, C37), and the train
  CLI, which fails as the reference's does (``KeyError: 'frames'``).
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
from repro.models import attention as jattn
from repro.models import get_model as jax_get_model
from repro_torch import random
from repro_torch.config import FedConfig, ServeConfig, get_arch, list_archs
from repro_torch.core import algorithms as port_alg
from repro_torch.core import fed_state as port_state
from repro_torch.core.compression import make_compressor as port_compressor
from repro_torch.models import attention as pattn
from repro_torch.models import get_model
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve import DecodeEngine, ServeRequest
from repro_torch.train import FedTrainer
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_map, tree_unflatten)

import torch_threads  # noqa: F401  (one torch thread a process)
from test_torch_lm_train import _check_round, _key, _tokens
from torch_golden import decode_requests, reference_decode

ARCH = "whisper-tiny"
LOGIT_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
LOSS_RTOL = {"float32": 1e-6, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
K, L, B, S = 2, 2, 2, 12
DATA_SCALE = 50.0
FED = dict(num_nodes=K, local_steps=L, eta=1e-3, zeta=0.3, temperature=0.1,
           burn_in=1, rounds=2, topology="ring")


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _cfgs(dtype="float32", **kw):
    return (jax_get_arch(ARCH).reduced.replace(dtype=dtype, **kw),
            get_arch(ARCH).reduced.replace(dtype=dtype, **kw))


def _frames(cfg, lead, seed):
    return np.random.default_rng(seed).standard_normal(
        lead + (cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)


def _batch(cfg, lead, seed):
    return {"tokens": _tokens(cfg, seed, lead + (S,)),
            "frames": _frames(cfg, lead, seed + 50)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port(jp):
    return tree_map(lambda a: a[None],
                    params_from_jax(jax.tree.map(np.asarray, jp)))


def test_whisper_is_the_reference_registry_entry():
    assert ARCH in list_archs()
    got, want = get_arch(ARCH), jax_get_arch(ARCH)
    for name in ("arch_id", "source", "notes", "skips"):
        assert getattr(got, name) == getattr(want, name)
    for name in ("config", "reduced"):
        mine, ref = vars(getattr(got, name)), vars(getattr(want, name))
        assert {k: v for k, v in mine.items() if k != "moe"} == \
            {k: v for k, v in ref.items() if k != "moe"}


def test_init_is_the_reference_init():
    jcfg, cfg = _cfgs()
    want = jax.tree_util.tree_leaves_with_path(
        jax_get_model(jcfg).init(jax.random.PRNGKey(5)))
    got = tree_leaves_with_path(get_model(cfg).init(random.PRNGKey(5), "cpu"))
    assert [p for p, _ in got] == [
        ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        assert np.array_equal(g.numpy().view(np.int32), w.view(np.int32)), \
            path


def test_encoder_cross_attention_and_prefill_are_the_references():
    jcfg, cfg = _cfgs()
    jm, model = jax_get_model(jcfg), get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(1))
    params = _port(jp)
    frames = _frames(cfg, (2,), 3)
    want = np.asarray(jax.jit(jm.encode)(jp, jnp.asarray(frames)))
    got = model.encode(params, torch.from_numpy(frames))[0]
    assert _rel(got.numpy(), want) <= 1e-5
    # the first decoder layer's cross-attention over that encoder output
    lp = jp["decoder"][0]
    x = np.random.default_rng(4).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)

    def jcross(lp, x, enc):
        k = jnp.einsum("bsd,dgk->bsgk", enc, lp["cross_attn"]["wk"])
        v = jnp.einsum("bsd,dgk->bsgk", enc, lp["cross_attn"]["wv"])
        return jattn.attention(lp["cross_attn"], x, None, jcfg,
                               cross_kv=(k, v))
    wx = np.asarray(jax.jit(jcross)(lp, jnp.asarray(x), jnp.asarray(want)))
    plp = params["decoder"][0]
    enc = torch.from_numpy(want)[None]
    gx = pattn.attention(plp["cross_attn"], torch.from_numpy(x)[None], None,
                         cfg, cross_kv=(pattn._proj(enc,
                                                    plp["cross_attn"]["wk"]),
                                        pattn._proj(enc,
                                                    plp["cross_attn"]["wv"])))
    assert _rel(gx[0].numpy(), wx) <= 1e-5
    jcache = jm.prefill_encoder(jp, jm.init_decode_state(2, 8, jnp.float32),
                                jnp.asarray(frames))
    cache = model.prefill_encoder(
        params, model.init_decode_state(2, 8, dtype_kv=torch.float32),
        torch.from_numpy(frames))
    assert _rel(cache["enc_out"][0].numpy(), jcache["enc_out"]) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_nll_and_gradient_are_the_references(dtype):
    jcfg, cfg = _cfgs(dtype)
    jm, model = jax_get_model(jcfg), get_model(cfg)
    jps = [jm.init(jax.random.PRNGKey(i)) for i in range(K)]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *jps)
    params = params_from_jax(jax.tree.map(np.asarray, stacked))
    one = _batch(cfg, (B,), 1)
    jone = jax.tree.map(jnp.asarray, one)
    want_lg = np.asarray(jax.jit(jm.logits)(jps[0], jone).astype(jnp.float32))
    got_lg = model.logits(params, _torch(one))[0].float().numpy()
    assert got_lg.shape == want_lg.shape
    assert _rel(got_lg, want_lg) <= LOGIT_TOL[dtype]
    wl, _ = jax.jit(jm.loss)(jps[0], jone)
    gl, _ = model.loss(params, _torch(one))
    assert abs(float(gl[0]) - float(wl)) <= LOSS_RTOL[dtype] * abs(float(wl))
    nodes = _batch(cfg, (K, B), 2)
    (want_nll, _), want_g = jax.jit(jax.vmap(jax.value_and_grad(
        jm.loss, has_aux=True)))(stacked, jax.tree.map(jnp.asarray, nodes))
    np.testing.assert_allclose(model.nll(params, _torch(nodes)).numpy(),
                               np.asarray(want_nll), rtol=LOSS_RTOL[dtype])
    leaves = [x.clone().requires_grad_(True) for x in tree_leaves(params)]
    paths = [p for p, _ in tree_leaves_with_path(params)]
    model.nll(tree_unflatten(paths, leaves), _torch(nodes)).sum().backward()
    for path, g, w in zip(paths, leaves, jax.tree.leaves(want_g)):
        w = np.asarray(w)
        if not np.abs(w).max():
            assert not g.grad.abs().max(), path
            continue
        assert _rel(g.grad.numpy(), w) <= GRAD_TOL[dtype], path


@pytest.mark.parametrize("prefill", [False, True])
def test_decode_equals_forward_and_the_reference(prefill):
    jcfg, cfg = _cfgs()
    jm, model = jax_get_model(jcfg), get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = _port(jp)
    toks = _tokens(cfg, 7, (2, S))
    frames = _frames(cfg, (2,), 8) if prefill else \
        np.zeros((2, cfg.encoder_seq_len, cfg.d_model), np.float32)
    cache = model.init_decode_state(2, 16, dtype_kv=torch.float32)
    jcache = jm.init_decode_state(2, 16, dtype_kv=jnp.float32)
    if prefill:
        enc = model.encode(params, torch.from_numpy(frames))
        cache = model.prefill_encoder(params, cache, torch.from_numpy(frames))
        jcache = jm.prefill_encoder(jp, jcache, jnp.asarray(frames))
    else:
        enc = torch.zeros((1, 2, cfg.encoder_seq_len, cfg.d_model))
    fwd = model.decode_forward(params, torch.from_numpy(toks), enc)[0]
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


def test_round_is_the_references():
    fed = JaxFedConfig(algorithm="cdbfl", **FED)
    jcfg, cfg = _cfgs()
    jm = jax_get_model(jcfg)
    key = jax.random.PRNGKey(0)
    params0 = jm.init(key)
    state = init_fed_state(params0, fed, key=key)
    omega = build_topology(resolve_topology(fed), K).omega
    round_fn = jax.jit(make_round_fn("cdbfl", jm.loss, fed, omega,
                                     make_compressor(fed), DATA_SCALE))
    batches = {"tokens": np.stack([_tokens(jcfg, 10 + k, (L, B, S))
                                   for k in range(K)]),
               "frames": _frames(cfg, (K, L, B), 20)}
    kround = jax.random.PRNGKey(7)
    ref_state, ref_metrics = round_fn(state, jax.tree.map(jnp.asarray,
                                                          batches), kround)
    pfed = FedConfig(algorithm="cdbfl", **FED)
    model = get_model(cfg)
    pround = port_alg.make_round_fn("cdbfl", model.nll, pfed, omega,
                                    port_compressor(pfed), DATA_SCALE, "cpu")
    pstate = port_state.init_fed_state(
        params_from_jax(jax.tree.map(np.asarray, params0)), pfed)
    tb = _torch(batches)
    theta_l, _ = port_alg._local_sgd(model.nll, pstate.params, tb, pfed.eta,
                                     1.0 / K, DATA_SCALE, L)
    new, metrics = pround(pstate, tb, _key(kround))
    _check_round(new, metrics, jax.tree.map(np.asarray, ref_state),
                 ref_metrics, "float32",
                 [x.numpy() for x in tree_leaves(theta_l)])


def test_rounds_through_the_trainer_scan_equals_host():
    """Pools of ``{tokens, frames}``, as llava's ``{tokens, patches}``."""
    _, cfg = _cfgs("bfloat16")
    fed = FedConfig(algorithm="cdbfl", **FED)
    shards = [_batch(cfg, (6,), 30 + k) for k in range(K)]
    states = []
    for engine in ("host", "scan"):
        tr = FedTrainer(get_model(cfg), fed, shards, minibatch=2,
                        engine=engine, chunk=2, device="cpu")
        res = tr.run(rounds=2)
        assert all(np.isfinite(h) for h in res.loss_history)
        states.append(tr.state)
    for name in ("params", "v", "v_bar"):
        for a, b in zip(tree_leaves(getattr(states[0], name)),
                        tree_leaves(getattr(states[1], name))):
            assert torch.equal(a, b), name


DECODE = dict(slots=2, max_len=8, max_new_tokens=4, requests=5, seed=0,
              top=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_engine_matches_the_reference_engine(dtype):
    """ROADMAP C37: both engines decode against the zero encoder output of
    ``init_decode_state``. A bank of 3, 5 requests through 2 slots: tokens
    the reference engine's up to each request's first step whose top-two
    margin is at or under 1e-2 in bf16 (f32: all), entropies within rtol
    1e-5 (f32) and 2e-2 (bf16) up to it."""
    jcfg, cfg = _cfgs(dtype)
    jm = jax_get_model(jcfg)
    key = jax.random.PRNGKey(0)
    bank = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jm.init(jax.random.fold_in(key, i)) for i in range(3)])
    run = reference_decode(jm, bank, DECODE)
    reqs = decode_requests(cfg.vocab_size, DECODE["requests"], 0)
    eng = DecodeEngine(get_model(cfg), ServeConfig(
        slots=DECODE["slots"], max_len=DECODE["max_len"],
        max_new_tokens=DECODE["max_new_tokens"]),
        stacked=params_from_jax(jax.tree.map(np.asarray, bank)))
    got = eng.run([ServeRequest(prompt_token=t, seed=s) for t, s in reqs])
    assert not eng._caches["enc_out"].any()
    margin = 0.0 if dtype == "float32" else 1e-2
    compared = 0
    for g, toks, ents, margins in zip(got, run["tokens"],
                                      run["token_entropy"], run["margins"]):
        first = next((i for i, m in enumerate(margins) if m <= margin),
                     len(margins))
        assert g.tokens[:first].tolist() == toks[:first]
        upto = min(first + 1, len(ents))
        np.testing.assert_allclose(g.token_entropy[:upto], ents[:upto],
                                   rtol=1e-5 if dtype == "float32" else 2e-2)
        compared += first
    assert compared >= (20 if dtype == "float32" else 12)


def test_train_cli_fails_as_the_references(capsys, monkeypatch):
    """The reference's train CLI builds token-only pools for every LM arch
    and whisper's loss reads ``batch["frames"]``: it prints its header
    lines and fails with ``KeyError: 'frames'`` at the first round. The
    port's CLI prints the same lines and fails the same way."""
    import sys
    from repro.launch import train as jax_train
    from repro_torch.launch import train as port_train
    argv = ["--arch", ARCH, "--trim", "--rounds", "1", "--local-steps", "1",
            "--seq", "16", "--batch", "2"]
    heads = ("arch=", "wire accounting:", "topology=")
    outs = []
    for run in (jax_train.main,
                lambda: port_train.main(argv + ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["train"] + argv)
        capsys.readouterr()
        with pytest.raises(KeyError, match="frames"):
            run()
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith(heads)])
    assert len(outs[0]) == 3 and outs[1] == outs[0]
