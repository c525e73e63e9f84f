"""The port's dense decoders against the reference's, on the CPU at the
reduced widths of the four dense archs (smollm-135m, yi-9b, qwen2.5-14b,
mistral-large-123b).

- Init is exact: the same draws from the same keys (the reference's eager
  ``model.init``), with ``scan_layers`` on and off.
- ``logits``, ``loss`` and teacher-forced ``decode_step``, from the
  reference's params carried across, within 1e-5 of the largest |logit| in
  f32 (torch and XLA sum products in other orders, and their exp, rsqrt,
  sin and cos differ in the last bit). In bfloat16 within 3e-2 of it: every
  op rounds to bfloat16's 8 bits, and the reference's own bfloat16 logits
  lie 1.1-1.6e-2 of it away from its f32 logits at these widths, so a
  difference in the last bit of one op's rounding carries that far.
- The reference's own checks of its zoo, held by the port: decode equals the
  forward (atol 2e-3, f32 caches), the sliding window decodes through a
  ring buffer, and chunked attention equals the naive one.
- The LM evaluation (``lm_apply_fn``, the token-level accumulators) through
  the scan and host engines, against the reference's report; bank
  snapshots of an LM across the two packages.

Torch runs on one thread here: the exact contracts compare two runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.eval import engine as jeval
from repro.models import get_model as jax_get_model
from repro_torch import random
from repro_torch.config import get_arch, list_archs
from repro_torch.eval import engine as peval
from repro_torch.models import get_model
from repro_torch.models.chunked import chunked_gqa
from repro_torch.models.transformer import params_from_jax, params_to_numpy
from repro_torch.utils.tree import tree_leaves_with_path, tree_map

import torch_threads  # noqa: F401  (one torch thread a process)

DENSE = ("smollm-135m", "yi-9b", "qwen2.5-14b", "mistral-large-123b")
F32_TOL, BF16_TOL = 1e-5, 3e-2
# f32 compute through bfloat16 caches: the cached entries one bfloat16 ulp
# off, and the logits (test_teacher_forced_f32_decode_through_bf16_caches)
BF16_KV_FLIPS, BF16_KV_TOL = 8, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_params(jparams, groups: bool = True):
    p = params_from_jax(jax.tree.map(np.asarray, jparams))
    return tree_map(lambda x: x[None], p) if groups else p


def _tokens(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def test_dense_archs_are_the_reference_registry_entries():
    assert set(DENSE) <= set(list_archs())
    for arch in DENSE:
        got, want = get_arch(arch), jax_get_arch(arch)
        for name in ("arch_id", "source", "notes", "skips"):
            assert getattr(got, name) == getattr(want, name)
        for name in ("config", "reduced"):
            mine, ref = getattr(got, name), getattr(want, name)
            assert mine.resolved_head_dim == ref.resolved_head_dim
            for f in ("name", "family", "num_layers", "d_model", "num_heads",
                      "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                      "qkv_bias", "sliding_window", "tie_embeddings",
                      "dtype", "rope_theta", "norm_eps", "scan_layers"):
                assert getattr(mine, f) == getattr(ref, f), (arch, name, f)


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("arch", DENSE)
def test_init_is_the_reference_init(arch, scan):
    """Every leaf bit for bit, in the reference's tree and leaf order."""
    jcfg = jax_get_arch(arch).reduced.replace(scan_layers=scan)
    cfg = get_arch(arch).reduced.replace(scan_layers=scan)
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


def qwen_reference(dtype: str):
    """qwen2.5's reduced config (QKV bias, GQA) in one dtype: the
    reference's model and its params with nonzero biases."""
    jcfg = jax_get_arch("qwen2.5-14b").reduced.replace(dtype=dtype)
    jm = jax_get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    for name in ("bq", "bk", "bv"):
        leaf = jp["groups"]["u0"]["attn"][name]
        jp["groups"]["u0"]["attn"][name] = jnp.asarray(
            rng.normal(0, 0.1, leaf.shape).astype(np.float32))
    return jcfg, jm, jp


def teacher_forced(decode_step, cache, toks, pos_of, tokens_of):
    """12 steps of ``decode_step`` on ``toks``' columns -> (the final
    cache, the logits (B, 12, V) in f32)."""
    got = []
    for pos in range(toks.shape[1]):
        cache, lg = decode_step(cache, tokens_of(toks[:, pos:pos + 1]),
                                pos_of(pos))
        got.append(np.asarray(lg.float() if torch.is_tensor(lg)
                              else lg.astype(jnp.float32))[..., 0, :])
    return cache, np.stack(got, -2)


def bf16_bits(x) -> np.ndarray:
    """A bfloat16 array's (or tensor's) bits as int32."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x.astype(jnp.float32)))
    return x.to(torch.bfloat16).view(torch.int16).int().numpy()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def qwen(request):
    """qwen2.5's reduced config, its params, tokens, and the reference's
    logits, loss and teacher-forced decode: through caches in the compute
    dtype (``decode``) and, in f32, through the default bfloat16 caches
    (``decode_bf16_kv``, with the final caches)."""
    dtype = request.param
    jcfg, jm, jp = qwen_reference(dtype)
    toks = _tokens(jcfg, 2, 12, 3)
    mask = np.ones((2, 12), np.float32)
    mask[1, 7:] = 0
    batch = {"tokens": jnp.asarray(toks)}
    want = {"logits": np.asarray(jm.logits(jp, batch)).astype(np.float32),
            "loss": float(jm.loss(jp, batch)[0]),
            "masked": float(jm.loss(jp, dict(batch, loss_mask=mask))[0])}
    step = jax.jit(jm.decode_step)
    run = lambda **kv: teacher_forced(  # noqa: E731
        lambda c, t, p: step(jp, c, t, p), jm.init_decode_state(2, 16, **kv),
        toks, jnp.int32, jnp.asarray)
    _, want["decode"] = run(dtype_kv=getattr(jnp, dtype))
    if dtype == "float32":                          # the default cache
        want["cache_bf16_kv"], want["decode_bf16_kv"] = run()
    return dtype, jp, toks, mask, want


def test_logits_and_loss_match_the_reference(qwen):
    dtype, jp, toks, mask, want = qwen
    model = get_model(get_arch("qwen2.5-14b").reduced.replace(dtype=dtype))
    params = _port_params(jp)
    batch = {"tokens": torch.from_numpy(toks)}
    lg = model.logits(params, batch)[0].float().numpy()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert _rel(lg, want["logits"]) <= tol
    loss, aux = model.loss(params, batch)
    assert abs(float(loss[0]) - want["loss"]) <= tol * abs(want["loss"])
    assert float(aux["aux"][0]) == 0.0
    masked, _ = model.loss(params, dict(batch, loss_mask=mask))
    assert abs(float(masked[0]) - want["masked"]) <= tol * abs(want["masked"])


def port_teacher_forced(jp, dtype: str, toks, **kv):
    """The port's ``teacher_forced`` run from the reference's params,
    through ``init_decode_state(2, 16, **kv)``."""
    model = get_model(get_arch("qwen2.5-14b").reduced.replace(dtype=dtype))
    params = _port_params(jp)
    return teacher_forced(
        lambda c, t, p: model.decode_step(params, c, t, p),
        model.init_decode_state(2, 16, **kv), toks,
        lambda pos: torch.full((2,), pos), torch.from_numpy)


def test_teacher_forced_decode_matches_the_reference(qwen):
    """Caches in the compute dtype on both sides: bfloat16 in bfloat16 (the
    default cache, as the reference's ``init_decode_state`` makes it
    whatever the compute dtype), float32 in float32. f32 compute through
    bfloat16 caches is the next test's."""
    dtype, jp, toks, _, want = qwen
    cache, got = port_teacher_forced(jp, dtype, toks,
                                     dtype_kv=getattr(torch, dtype))
    assert cache["groups"]["u0"]["k"].dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert _rel(got[0], want["decode"]) <= tol


@pytest.mark.parametrize("qwen", ["float32"], indirect=True)
def test_teacher_forced_f32_decode_through_bf16_caches(qwen):
    """f32 compute through the default bfloat16 caches, what
    ``DecodeEngine`` serves in f32 (ROADMAP C29). A key or value whose f32
    sum differs from XLA's in the last bit can round to the other bfloat16
    neighbour, and F32_TOL does not survive one such entry. So: every
    cached entry the reference's or one bfloat16 ulp from it, at most
    BF16_KV_FLIPS of the 8,192 off, and the logits within BF16_KV_TOL of
    the largest. The limits are set from readings
    (``tests/torch_golden.py kv-flips``): at this seed 2 entries are off
    (a key and a value) and the logits lie 4.47e-5 away; one cached entry
    moved one ulp moves the logits by a median 1.15e-4 (at most 1.75e-3)
    over 200 entries drawn at random, so BF16_KV_TOL lies between the
    two, and BF16_KV_FLIPS is four times the reading."""
    _, jp, toks, _, want = qwen
    cache, got = port_teacher_forced(jp, "float32", toks)
    assert cache["groups"]["u0"]["k"].dtype == torch.bfloat16
    off = 0
    for name in ("k", "v"):
        mine = bf16_bits(cache["groups"]["u0"][name][:, 0])
        theirs = bf16_bits(want["cache_bf16_kv"]["groups"]["u0"][name])
        assert np.abs(mine - theirs).max() <= 1, name
        off += int((mine != theirs).sum())
    assert off <= BF16_KV_FLIPS
    assert _rel(got[0], want["decode_bf16_kv"]) <= BF16_KV_TOL


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """The reference's ``test_decode_matches_forward``: one token a step
    through f32 caches reproduces the forward's logits (atol 2e-3)."""
    cfg = get_arch(arch).reduced.replace(dtype="float32")
    model = get_model(cfg)
    params = tree_map(lambda x: x[None], model.init(random.PRNGKey(0), "cpu"))
    b, t = 2, 12
    toks = torch.from_numpy(_tokens(cfg, b, t, 7))
    fwd = model.logits(params, {"tokens": toks})[0]
    cache = model.init_decode_state(b, t + 4, dtype_kv=torch.float32)
    for pos in range(t):
        cache, lg = model.decode_step(params, cache, toks[:, pos],
                                      torch.full((b,), pos))
        np.testing.assert_allclose(lg[0, :, 0].numpy(), fwd[:, pos].numpy(),
                                   atol=2e-3, rtol=2e-3)


def test_sliding_window_decodes_through_a_ring_buffer():
    """yi's reduced config with window 8: 24 steps through 8 slots equal
    the windowed forward, and the reference's decode."""
    jcfg = jax_get_arch("yi-9b").reduced.replace(dtype="float32",
                                                 sliding_window=8)
    cfg = get_arch("yi-9b").reduced.replace(dtype="float32", sliding_window=8)
    jm, model = jax_get_model(jcfg), get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(3))
    params = _port_params(jp)
    b, t = 2, 24
    toks = _tokens(cfg, b, t, 4)
    fwd = model.logits(params, {"tokens": torch.from_numpy(toks)})[0]
    cache = model.init_decode_state(b, t, dtype_kv=torch.float32)
    assert cache["groups"]["u0"]["k"].shape[3] == 8          # 8 slots
    jcache = jm.init_decode_state(b, t, dtype_kv=jnp.float32)
    step = jax.jit(jm.decode_step)
    for pos in range(t):
        cache, lg = model.decode_step(params, cache,
                                      torch.from_numpy(toks[:, pos]),
                                      torch.full((b,), pos))
        jcache, jlg = step(jp, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                           jnp.int32(pos))
        np.testing.assert_allclose(lg[0, :, 0].numpy(), fwd[:, pos].numpy(),
                                   atol=2e-3, rtol=2e-3)
        assert _rel(lg[0, :, 0].numpy(), np.asarray(jlg[:, 0])) <= F32_TOL
    slot_pos = cache["groups"]["u0"]["slot_pos"][0, 0, 0]
    assert sorted(slot_pos.tolist()) == list(range(t - 8, t))


def test_lanes_decode_at_their_own_positions():
    """A lane's logits depend on its own position and cache only: lane 0 at
    position 3 is the same, bit for bit, beside a lane that stays at
    position 0 and beside one that advances with other tokens (the table's
    shape fixed, as in the engine), and equals the lane decoded alone within
    1e-6; the lane held at position 0 decodes as a fresh cache."""
    cfg = get_arch("smollm-135m").reduced.replace(dtype="float32")
    model = get_model(cfg)
    params = tree_map(lambda x: x[None], model.init(random.PRNGKey(2), "cpu"))
    toks = _tokens(cfg, 1, 4, 9)[0].tolist()
    held, moving = model.init_decode_state(2, 8), model.init_decode_state(2, 8)
    alone = model.init_decode_state(1, 8)
    for pos in range(4):
        other = 5 if pos == 3 else 0
        _, lg = model.decode_step(params, held, torch.tensor([toks[pos], other]),
                                  torch.tensor([pos, 0]))
        _, lg2 = model.decode_step(params, moving,
                                   torch.tensor([toks[pos], 7 + pos]),
                                   torch.tensor([pos, pos]))
        _, want = model.decode_step(params, alone, torch.tensor([toks[pos]]),
                                    torch.tensor([pos]))
        assert torch.equal(lg[0, 0], lg2[0, 0])
        np.testing.assert_allclose(lg[0, 0].numpy(), want[0, 0].numpy(),
                                   rtol=1e-6, atol=1e-6)
    _, want0 = model.decode_step(params, model.init_decode_state(1, 8),
                                 torch.tensor([5]), torch.tensor([0]))
    np.testing.assert_allclose(lg[0, 1].numpy(), want0[0, 0].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_chunked_attention_equals_naive():
    """The reference's ``test_chunked_equals_naive_full_model`` (atol 2e-4),
    and the port's chunked path against the reference's chunked path."""
    base = get_arch("yi-9b").reduced.replace(dtype="float32")
    jbase = jax_get_arch("yi-9b").reduced.replace(dtype="float32")
    toks = _tokens(base, 2, 64, 11)
    naive = get_model(base.replace(attn_impl="naive"))
    chunk = get_model(base.replace(attn_impl="chunked", chunk_size=16))
    jp = jax_get_model(jbase).init(jax.random.PRNGKey(0))
    params = _port_params(jp)
    batch = {"tokens": torch.from_numpy(toks)}
    a = naive.logits(params, batch)[0].numpy()
    b = chunk.logits(params, batch)[0].numpy()
    np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4)
    want = np.asarray(jax_get_model(jbase.replace(
        attn_impl="chunked", chunk_size=16)).logits(
        jp, {"tokens": jnp.asarray(toks)}))
    assert _rel(b, want) <= F32_TOL
    q = torch.randn(1, 2, 32, 4, 8)
    kv = torch.randn(1, 2, 32, 2, 8)
    windowed = chunked_gqa(q, kv, kv, window=5, chunk=8)
    assert windowed.shape == q.shape and torch.isfinite(windowed).all()


@pytest.mark.parametrize("arch,item", [
    ("recurrentgemma-9b", "A12 part 5"), ("xlstm-1.3b", "A12 part 6"),
    ("whisper-tiny", "A12 part 7")])
def test_unported_archs_and_families_name_their_part(arch, item):
    """The archs that named their part of A12 here until it was ported
    (``item``): each is the reference's entry and builds; what the port
    still refuses them is a mesh, which names A10."""
    from repro_torch.config import ServeConfig
    from repro_torch.serve import DecodeEngine
    cfg = get_arch(arch).reduced
    assert cfg.family == jax_get_arch(arch).config.family
    assert item.startswith("A12 part")
    with pytest.raises(NotImplementedError, match="A10"):
        DecodeEngine(get_model(cfg), ServeConfig(), mesh=object())


@pytest.mark.parametrize("arch,family", [
    ("deepseek-v2-236b", "moe"), ("grok-1-314b", "moe"),
    ("llava-next-mistral-7b", "vlm")])
def test_archs_of_parts_3_and_4_run(arch, family):
    """The archs that named A12 parts 3 and 4 here until those were
    ported: their entries and families build, and a reduced forward runs
    (their parity with the reference is ``test_torch_lm_moe.py``'s)."""
    cfg = get_arch(arch).reduced
    assert cfg.family == family == jax_get_arch(arch).config.family
    model = get_model(cfg)
    params = tree_map(lambda x: x[None], model.init(random.PRNGKey(0), "cpu"))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
    if family == "vlm":
        batch["patches"] = torch.zeros((1, cfg.num_image_patches,
                                        cfg.d_model))
    lg = model.logits(params, batch)
    assert lg.shape[-1] == cfg.vocab_size
    assert torch.isfinite(lg.float()).all()


def test_params_round_trip_through_numpy():
    model = get_model(get_arch("smollm-135m").reduced)
    p = model.init(random.PRNGKey(4), "cpu")
    back = params_from_jax(params_to_numpy(p))
    for (a, x), (b, y) in zip(tree_leaves_with_path(p),
                              tree_leaves_with_path(back)):
        assert a == b and torch.equal(x, y)


@pytest.mark.parametrize("entry", ["logits", "loss", "decode_step"])
def test_products_are_summed_in_f32_whatever_the_process_set(monkeypatch,
                                                              entry):
    """Every product of the model's entry points runs with TF32 and the
    reduced-precision bf16 and f16 reductions off, though the process
    allows them (torch's default for bf16), and the process's flags are
    back after the call."""
    m = torch.backends.cuda.matmul
    names = ("allow_tf32", "allow_bf16_reduced_precision_reduction",
             "allow_fp16_reduced_precision_reduction")
    for name in names:
        monkeypatch.setattr(m, name, True)
    seen, bmm = [], torch.bmm

    def spy(*args, **kwargs):
        seen.append(tuple(getattr(m, name) for name in names))
        return bmm(*args, **kwargs)

    monkeypatch.setattr(torch, "bmm", spy)
    cfg = get_arch("smollm-135m").reduced
    model = get_model(cfg)
    params = tree_map(lambda x: x[None], model.init(random.PRNGKey(1), "cpu"))
    toks = torch.from_numpy(_tokens(cfg, 2, 4, 3))
    if entry == "decode_step":
        model.decode_step(params, model.init_decode_state(2, 8), toks[:, 0],
                          torch.tensor([0, 0]))
    else:
        getattr(model, entry)(params, {"tokens": toks})
    assert seen and set(seen) == {(False, False, False)}
    assert all(getattr(m, name) for name in names)


@pytest.fixture(scope="module")
def lm_eval():
    """A bank of 3 reduced smollm samples, 10 markov sequences of 9 tokens,
    and the reference's scan-engine report of them (batches of 4)."""
    from repro.data.synthetic_lm import markov_tokens
    jcfg = jax_get_arch("smollm-135m").reduced.replace(dtype="float32")
    jm = jax_get_model(jcfg)
    key = jax.random.PRNGKey(6)
    bank = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jm.init(jax.random.fold_in(key, i)) for i in range(3)])
    toks = markov_tokens(10, 9, jcfg.vocab_size, seed=1)
    data = {"tokens": toks, "y": toks[:, 1:]}
    want, probs = jeval.ScanEvalEngine(jeval.lm_apply_fn(jm), batch_size=4) \
        .evaluate(bank, data, return_probs=True)
    return bank, data, want, np.asarray(probs)


def test_lm_eval_matches_the_reference(lm_eval):
    """Every label position is one scored example: counts exact, the
    metrics within 1e-5, the probabilities within 1e-6; the scan engine
    equals the host engine bit for bit."""
    from repro_torch.data.synthetic_lm import markov_tokens
    jbank, data, want, want_probs = lm_eval
    assert np.array_equal(markov_tokens(10, 9, 512, seed=1), data["tokens"])
    model = get_model(get_arch("smollm-135m").reduced.replace(
        dtype="float32"))
    bank = params_from_jax(jax.tree.map(np.asarray, jbank))
    apply = peval.lm_apply_fn(model)
    scan, probs = peval.ScanEvalEngine(apply, batch_size=4).evaluate(
        bank, data, return_probs=True)
    host, hprobs = peval.HostEvalEngine(apply, batch_size=4).evaluate(
        bank, data, return_probs=True)
    assert np.array_equal(probs, hprobs)
    for f in scan._fields:
        a, b = getattr(scan, f), getattr(host, f)
        if f == "bins":
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert a == b or (np.isnan(a) and np.isnan(b)), f
    assert probs.shape == want_probs.shape == (10, 8, 512)
    np.testing.assert_allclose(probs, want_probs, rtol=1e-5, atol=1e-6)
    assert scan.count == want.count == 80.0
    assert scan.accuracy == want.accuracy
    for f in ("ece", "mce", "nll", "brier", "entropy", "overconf_gap"):
        assert abs(getattr(scan, f) - getattr(want, f)) <= 1e-5, f


def test_lm_bank_snapshots_load_in_either_package(tmp_path, lm_eval):
    """A bank saved by the reference loads in the port bit for bit, and
    the port's, in the reference, into the LM's tree."""
    from repro.checkpoint import load_bank as jax_load_bank
    from repro.checkpoint import save_bank as jax_save_bank
    from repro_torch.checkpoint import load_bank, save_bank
    jbank = lm_eval[0]
    jax_save_bank(str(tmp_path / "ref"), 3, jbank)
    like = get_model(get_arch("smollm-135m").reduced).init(
        random.PRNGKey(0), "cpu")
    got = load_bank(str(tmp_path / "ref"), like=like, device="cpu")
    want = jax.tree_util.tree_leaves(jbank)
    for (_, g), w in zip(tree_leaves_with_path(got), want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    save_bank(str(tmp_path / "port"), 4, got)
    back = jax_load_bank(str(tmp_path / "port"), like=jax.tree.map(
        lambda x: x[0], jbank))
    for a, b in zip(jax.tree_util.tree_leaves(back), want):
        assert np.array_equal(np.asarray(a), np.asarray(b))
