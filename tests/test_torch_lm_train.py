"""Federated LM training on the port against the reference (ROADMAP A12
part 2), on the CPU at reduced width: smollm-135m's reduced config (tied
embeddings, scanned layers, a leading group axis on every layer leaf) and
qwen2.5's (GQA, QKV bias, an untied head), bf16 compute over f32 params
(the configs' default) and f32. K = 2 nodes on a ring, L = 2 local steps
of 2 sequences of 16 tokens, the cold posterior of
``examples/federated_llm.py`` (T = 0.1) and a data scale of 50.

- The per-node NLL (``model.nll``, each node on its own ``(K, B, S)``
  tokens, with and without ``loss_mask``) against the reference's
  ``vmap(loss)``: f32 within rtol 1e-6 (measured 1.5e-7: the two sum the
  log-softmax in other orders); bf16 within rtol 1e-3 (measured 6.8e-5 to
  2.6e-4: every op rounds to bf16's 8 bits).
- The gradient of the round's objective ``data_scale·NLL + ½·(1/K)·Σθ²``
  (``_value_and_grad``) against ``jax.grad``: f32 within 1e-5 of each
  leaf's largest |g| (measured 1.5e-6: summation order); bf16 within 5e-2
  of it. The reference's own bf16 gradient lies 1.6e-2 (smollm) and
  2.1e-2 (qwen) of the largest away from its f32 gradient, so a rounding
  taken the other way carries that far (measured port against reference:
  1.5e-2 to 2.2e-2). The embedding's gather gradient is exact on the CPU:
  XLA adds a token's repeats in token order rounding each add to bf16, as
  torch's ``index_put_`` does on the CPU (ROADMAP C31).
- The backward runs with f32 sums on the card (``f32_sums`` around the
  backward): the flags read inside the backward.
- One round of cdbfl under the default codec (f32: its index sets exact,
  params, v and v̄ within 1e-6 absolute, measured 1.2e-7) and under
  ``fused_compress=True``, one dsgld and one cffl round (bf16): the wire
  bytes exact; the losses within rtol 2e-4 (measured 4e-5: the bf16 NLL
  times the data scale); the index sets equal but where the port's |θ − v|
  of a flipped element lies within 2e-3 of its block's k-th largest (a
  near-tie the bf16 gradients may order either way: η·L·|Δg| reaches
  ~1e-3 here); params, v and v̄ within 2e-3 absolute away from the
  flipped elements (the same bound carried by Eq. 9's linear parts).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig, get_arch as jax_get_arch
from repro.core import (build_topology, init_fed_state, make_compressor,
                        resolve_topology)
from repro.core.algorithms import make_round_fn
from repro.data.synthetic_lm import markov_tokens
from repro.models import get_model as jax_get_model
from repro_torch import random
from repro_torch.config import FedConfig, get_arch
from repro_torch.core import algorithms as port_alg
from repro_torch.core import fed_state as port_state
from repro_torch.core.compression import make_compressor as port_compressor
from repro_torch.models import get_model
from repro_torch.models.transformer import params_from_jax
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

import torch_threads  # noqa: F401  (one torch thread a process)

K, L, B, S = 2, 2, 2, 16
DATA_SCALE = 50.0
FED = dict(num_nodes=K, local_steps=L, eta=1e-3, zeta=0.3, temperature=0.1,
           burn_in=1, rounds=2, topology="ring")
NLL_RTOL = {"float32": 1e-6, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# one round: f32 (exact index sets) and bf16 (near-ties may flip)
ROUND_ATOL = {"float32": 1e-6, "bfloat16": 2e-3}
TIE = 2e-3
LOSS_RTOL = 2e-4
BLOCK = 1024


def _key(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _tokens(cfg, seed: int, shape) -> np.ndarray:
    """Markov tokens of node streams, with repeated tokens: the gather's
    gradient adds repeats."""
    rows = int(np.prod(shape[:-1]))
    return markov_tokens(rows, shape[-1], cfg.vocab_size, seed=seed,
                         node=0).reshape(shape)


def _objective(jm, prior_weight):
    def f(p, batch):
        nll, _ = jm.loss(p, batch, None)
        prior = sum(jnp.sum(jnp.square(x.astype(jnp.float32)))
                    for x in jax.tree.leaves(p))
        return DATA_SCALE * nll + 0.5 * prior_weight * prior, nll
    return f


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,masked", [("smollm-135m", True),
                                         ("qwen2.5-14b", False)])
def test_nll_and_objective_gradient_are_the_references(arch, masked, dtype):
    """Each node's NLL on its own tokens, and the gradient of the round's
    objective, against the jitted reference (``vmap(value_and_grad)``);
    distinct params a node, so a node that read another's would show."""
    jcfg = jax_get_arch(arch).reduced.replace(dtype=dtype)
    jm = jax_get_model(jcfg)
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *[
        jm.init(jax.random.PRNGKey(i)) for i in range(K)])
    toks = _tokens(jcfg, 3, (K, B, S))
    batch = {"tokens": toks}
    if masked:
        batch["loss_mask"] = (np.random.default_rng(4).random((K, B, S))
                              < 0.7).astype(np.float32)
    (f_ref, nll_ref), g_ref = jax.jit(jax.vmap(jax.value_and_grad(
        _objective(jm, 1.0 / K), has_aux=True)))(
            stacked, jax.tree.map(jnp.asarray, batch))

    model = get_model(get_arch(arch).reduced.replace(dtype=dtype))
    params = params_from_jax(jax.tree.map(np.asarray, stacked))
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    nll = model.nll(params, pbatch)
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(nll_ref),
                               rtol=NLL_RTOL[dtype])
    paths = [p for p, _ in tree_leaves_with_path(params)]
    f, grads = port_alg._value_and_grad(model.nll, paths,
                                        tree_leaves(params), pbatch,
                                        1.0 / K, DATA_SCALE)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref),
                               rtol=NLL_RTOL[dtype])
    for path, g, w in zip(paths, grads, jax.tree.leaves(g_ref)):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= GRAD_TOL[dtype], (path, err)


def test_embedding_gather_gradient_is_xlas_on_the_cpu():
    """ROADMAP C31: XLA's CPU code sums a bf16 gather's cotangents into the
    table in token order, each add rounded to bf16; the port's backward
    (``index_put_`` with accumulation) on the CPU equals it bit for bit,
    repeats included."""
    cfg = get_arch("smollm-135m").reduced
    jm = jax_get_model(jax_get_arch("smollm-135m").reduced)
    p0 = jm.init(jax.random.PRNGKey(0))
    toks = _tokens(cfg, 5, (K, B, S))
    toks[:, :, :4] = 7                                    # repeats
    w = np.random.default_rng(6).standard_normal(
        (K, B, S, cfg.d_model)).astype(np.float32)
    stacked = jax.tree.map(lambda *x: jnp.stack(x), p0, p0)

    def f(p, t, w_):
        x = p["embed"]["tok"].astype(jnp.bfloat16)[t]
        return jnp.sum(x.astype(jnp.float32) * w_)
    want = jax.jit(jax.vmap(jax.grad(f)))(stacked, jnp.asarray(toks),
                                          jnp.asarray(w))["embed"]["tok"]
    params = params_from_jax(jax.tree.map(np.asarray, stacked))
    tok = params["embed"]["tok"].requires_grad_(True)
    rows = torch.arange(K)[:, None, None]            # as the model's _embed
    x = tok.to(torch.bfloat16)[rows, torch.from_numpy(toks).long()]
    (x.float() * torch.from_numpy(w)).sum().backward()
    assert np.array_equal(tok.grad.numpy().view(np.int32),
                          np.asarray(want).view(np.int32))


def test_the_backward_sums_in_f32():
    """The round's backward runs inside ``f32_sums``: a hook in the
    backward reads cuBLAS's reduced-precision and TF32 flags off, though
    the process turned them on, and the flags are the process's again
    after the round's gradient."""
    m = torch.backends.cuda.matmul
    names = ("allow_tf32", "allow_bf16_reduced_precision_reduction",
             "allow_fp16_reduced_precision_reduction")
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            seen.append(tuple(getattr(m, n) for n in names))
            return g

    model = get_model(get_arch("smollm-135m").reduced)
    params = port_state.stack_node_params(
        model.init(random.PRNGKey(0), "cpu"), K)

    def nll(p, batch):
        return model.nll(dict(p, final_norm={"scale": Probe.apply(
            p["final_norm"]["scale"])}), batch)

    saved = [getattr(m, n) for n in names]
    try:
        for n in names:
            setattr(m, n, True)
        paths = [p for p, _ in tree_leaves_with_path(params)]
        batch = {"tokens": torch.from_numpy(_tokens(model.cfg, 1, (K, B, S)))}
        port_alg._value_and_grad(nll, paths, tree_leaves(params), batch,
                                 0.5, 1.0)
        assert seen == [(False, False, False)]
        assert all(getattr(m, n) for n in names)
    finally:
        for n, v in zip(names, saved):
            setattr(m, n, v)


def _reference_round(algorithm, dtype, **overrides):
    """The reference's jitted round of ``algorithm`` from the shared init:
    (params0, batches, port round key, state after it, metrics)."""
    fed = JaxFedConfig(algorithm=algorithm, **FED, **overrides)
    jcfg = jax_get_arch("smollm-135m").reduced.replace(dtype=dtype)
    jm = jax_get_model(jcfg)
    key = jax.random.PRNGKey(0)
    params0 = jm.init(key)
    state = init_fed_state(params0, fed, key=key)
    omega = build_topology(resolve_topology(fed), K).omega
    round_fn = jax.jit(make_round_fn(algorithm, jm.loss, fed, omega,
                                     make_compressor(fed), DATA_SCALE))
    toks = np.stack([_tokens(jcfg, 10 + k, (L, B, S)) for k in range(K)])
    kround = jax.random.PRNGKey(7)
    state, metrics = round_fn(state, {"tokens": jnp.asarray(toks)}, kround)
    return (jax.tree.map(np.asarray, params0), toks, _key(kround),
            jax.tree.map(np.asarray, state), metrics)


def _blocks(x: np.ndarray) -> np.ndarray:
    """A node's leaf as ``(nb, block)`` rows of |x|, zero-padded (a leaf of
    at most one block is one row)."""
    flat = np.abs(x.reshape(-1))
    bs = min(BLOCK, flat.size)
    nb = -(-flat.size // bs)
    return np.pad(flat, (0, nb * bs - flat.size)).reshape(nb, bs)


def _flips(d, got, want):
    """The elements of a ``(K, ...)`` leaf that one support holds and the
    other does not, each checked to be a near-tie of its block: |d| within
    :data:`TIE` of the smallest |d| the port selected there. Returns the
    ``(K, ...)`` mask of flipped positions."""
    flipped = (got != 0) != (want != 0)
    for k in range(d.shape[0]):
        if not flipped[k].any():
            continue
        mags, sel = _blocks(d[k]), _blocks(got[k]) != 0
        fl = _blocks(flipped[k].astype(np.float32)) != 0
        for b in np.nonzero(fl.any(axis=1))[0]:
            thr = mags[b][sel[b]].min()
            assert np.abs(mags[b][fl[b]] - thr).max() <= TIE, (k, b)
    return flipped


def _check_round(state, metrics, ref_state, ref_metrics, dtype, theta=None):
    """Port state and metrics after one round against the reference's;
    ``theta`` the port's θ after the local steps (the codec's input)."""
    assert metrics.wire_bytes == float(ref_metrics.wire_bytes)
    np.testing.assert_allclose(metrics.loss.numpy(),
                               np.asarray(ref_metrics.loss), rtol=LOSS_RTOL)
    atol = ROUND_ATOL[dtype]
    leaves = lambda tree: [x.numpy() for x in tree_leaves(tree)]
    got_v = leaves(state.v) if state.v is not None else None
    skip = []
    for i, (path, w) in enumerate(zip(
            [p for p, _ in tree_leaves_with_path(state.params)],
            jax.tree.leaves(ref_state.params))):
        mask = np.zeros(w.shape, bool)
        if theta is not None:
            flipped = _flips(theta[i], got_v[i], jax.tree.leaves(
                ref_state.v)[i])
            if dtype == "float32":
                assert not flipped.any(), path
            # Eq. 8 mixes every node's delta: a flip reaches each node
            mask = np.broadcast_to(flipped.any(axis=0), w.shape)
        skip.append(mask)
    names = ("params",) + (("v", "v_bar") if theta is not None else ())
    for name in names:
        for path, g, w, m in zip(
                [p for p, _ in tree_leaves_with_path(state.params)],
                leaves(getattr(state, name)),
                jax.tree.leaves(getattr(ref_state, name)), skip):
            err = np.abs(g - w)[~m]
            assert err.size == 0 or err.max() <= atol, (name, path,
                                                       err.max())


@pytest.mark.parametrize("algorithm,dtype,fused", [
    ("cdbfl", "float32", False), ("cdbfl", "bfloat16", True),
    ("dsgld", "bfloat16", False), ("cffl", "bfloat16", False)])
def test_round_is_the_references(algorithm, dtype, fused):
    """One round from the reference's init, minibatches and round key; the
    port draws its noise and codec uniforms from that key."""
    params0, toks, kround, ref_state, ref_metrics = _reference_round(
        algorithm, dtype, fused_compress=fused)
    fed = FedConfig(algorithm=algorithm, fused_compress=fused, **FED)
    model = get_model(get_arch("smollm-135m").reduced.replace(dtype=dtype))
    omega = build_topology(resolve_topology(JaxFedConfig(**FED)), K).omega
    comp = port_compressor(fed)
    round_fn = port_alg.make_round_fn(algorithm, model.nll, fed, omega, comp,
                                      DATA_SCALE, "cpu")
    state = port_state.init_fed_state(params_from_jax(params0), fed)
    batches = {"tokens": torch.from_numpy(toks)}
    theta = None
    if algorithm != "dsgld":
        prior = 0.0 if algorithm == "cffl" else 1.0 / K
        theta_l, _ = port_alg._local_sgd(model.nll, state.params, batches,
                                         fed.eta, prior, DATA_SCALE, L)
        theta = [x.numpy() for x in tree_leaves(theta_l)]
    new, metrics = round_fn(state, batches, kround)
    if algorithm == "dsgld":
        assert metrics.loss.shape == (K, 1)
    else:
        assert metrics.payload.measured_bytes() == metrics.wire_bytes * K
    _check_round(new, metrics, ref_state, ref_metrics, dtype, theta)
    assert all(torch.isfinite(x).all() for x in tree_leaves(new.params))
