"""The decode kernels' f32 arithmetic (``decode_attention``, ``bma_sample``)
on the CPU.

- XLA's f32 exp (``kernels/threefry.py: exp_plain``, the ``exp_xla`` of
  ``csrc/threefry.cuh``) bit for bit against ``jax.jit(jnp.exp)`` on 10^6
  inputs over [-104, 89] and the edges: the clamp's ends, results at the
  smallest normal (XLA flushes what falls below to +0), ±0, ±inf and NaN
  (a NaN equals any NaN).
- The kernels' division (Markstein's correction) correctly rounded on 8e7
  pairs of the range it serves.
- Each f32 sum of both plain versions, which add in their kernel's fixed
  order, against the float64 sum of the same terms, within the f32 error
  bound of that order: ``n · 2^-24 · Σ|terms|`` for a sum of ``n`` terms,
  at smollm-135m's heads (9 over 3 KV heads of 64) and a group of 12
  heads of 128 (mistral-large-123b's), and at V = 49,152 and 1031.
- The port's ``models.attention.decode_attention`` against the
  reference's on the same parameters, caches and positions, at a reduced
  config with 12 query heads of 128 over one KV head (3 lanes, 16 slots):
  the caches equal but for a new key or value rounded to the other bf16
  neighbour (ROADMAP C29), the output within the LM tests' decode
  tolerances (``test_torch_lm_model.py``: 1e-5 of the largest value in
  f32, 3e-2 in bf16) of the reference's attention over those caches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.models import attention as jattn
from repro_torch import random
from repro_torch.config import get_arch
from repro_torch.kernels.bma_sample import (bma_sample_plain, ordered_sum,
                                            pack_of)
from repro_torch.kernels.decode_attention import (dot_plain, segment,
                                                  softmax_sum_plain,
                                                  weighted_plain)
from repro_torch.kernels.threefry import (_div, _fma, exp_plain, exp_xla,
                                          log_plain)
from repro_torch.models import attention as pattn
from repro_torch.models.transformer import params_from_jax
from repro_torch.utils.tree import tree_map
from torch_golden import exp_inputs

F32_TOL, BF16_TOL = 1e-5, 3e-2          # test_torch_lm_model.py
EPS = 2.0 ** -24


def _same(got: np.ndarray, want: np.ndarray) -> bool:
    """Bit for bit, a NaN equal to any NaN."""
    nan = np.isnan(want)
    return bool(np.array_equal(np.isnan(got), nan) and np.array_equal(
        got[~nan].view(np.int32), want[~nan].view(np.int32)))


def test_exp_is_xla_exp_bit_for_bit():
    x = exp_inputs()
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = exp_plain(torch.from_numpy(x)).numpy()
    assert _same(got, want)
    assert _same(exp_xla(torch.from_numpy(x)).numpy(), want)
    # the softmax's numerators are the same exp (XLA fuses x - max into it)
    s = np.random.default_rng(1).normal(0, 30, (4, 257)).astype(np.float32)
    m = s.max(-1, keepdims=True)
    num = np.asarray(jax.jit(lambda v: jnp.exp(v - v.max(-1, keepdims=True)))(
        s))
    assert _same(exp_plain(torch.from_numpy(s - m)).numpy(), num)


def test_markstein_division_is_correctly_rounded():
    """The kernels' ``div_rn`` (``csrc/threefry.cuh``): ``q = RN(a y)``
    with ``y = RN(1/b)``, then ``RN(q + RN(a - b q) y)`` by two fmas,
    equals the correctly rounded ``a / b`` (the plain versions' ``_div``)
    on 8e7 pairs with ``2^-100 <= a <= 1`` and ``1 <= b <= 2^18`` (the
    softmaxes' numerators and sums, and the scores over ``sqrt(hd)``), a
    third of them divisors whose mantissa's top bits are all set; below
    2^-100 the kernels take ``__fdiv_rn``."""
    gen = torch.Generator().manual_seed(0)
    log2 = float(np.log(2.0))
    for i in range(20):
        n = 4_000_000
        a = torch.exp(torch.empty(n, dtype=torch.float64).uniform_(
            -100 * log2, 0, generator=gen)).float()
        if i % 4 == 0:
            a = torch.rand(n, generator=gen)
        b = torch.exp(torch.empty(n, dtype=torch.float64).uniform_(
            0, 18 * log2, generator=gen)).float()
        if i % 3 == 0:
            m = torch.randint(0, 2 ** 23, (n,), generator=gen)
            e = torch.randint(127, 127 + 18, (n,), generator=gen)
            b = ((e << 23) | (m | 0x7FFF00)).to(torch.int32).view(
                torch.float32)
        y = (1.0 / b.double()).float()
        q = a * y
        got = _fma(_fma(-q, b, a), y, q)
        keep = a >= 2.0 ** -100
        assert torch.equal(got[keep], _div(a, b)[keep])


@pytest.mark.parametrize("h,kv,hd", [(9, 3, 64), (12, 1, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_sums_are_within_their_f32_bound(h, kv, hd, dtype):
    """Each of the plain version's three sums (``dot_plain``,
    ``softmax_sum_plain``, ``weighted_plain``, the stages of
    ``decode_attention_plain``) against the float64 sum of the same f32
    terms, within ``n · 2^-24 · Σ|terms|``, on 2 x 3 lanes of 128 slots
    (bf16 caches): and the plain version is those stages."""
    g, b, slots, r = 2, 3, 128, h // kv
    e, tpr = segment(hd, torch.bfloat16)
    gen = torch.Generator().manual_seed(hd + h)
    rnd = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    q = rnd(g, b, kv, r, hd).to(dtype).float()
    kf = rnd(g, b, kv, slots, hd).bfloat16().to(dtype).float()
    vf = rnd(g, b, kv, slots, hd).bfloat16().to(dtype).float()
    prod = q.double()[..., :, None, :] * kf.double()[..., None, :, :]
    s = dot_plain(q, kf, e)
    assert ((s.double() - prod.sum(-1)).abs()
            <= hd * EPS * prod.abs().sum(-1)).all()
    sc = s.to(dtype).float() / 8.0
    ex = exp_plain(sc - sc.amax(-1, keepdim=True))
    tot = softmax_sum_plain(ex)
    assert ((tot.double() - ex.double().sum(-1)).abs()
            <= slots * EPS * ex.double().sum(-1)).all()
    probs = (ex / tot[..., None]).to(dtype).float()
    terms = probs.double()[..., :, :, None] * vf.double()[..., None, :, :]
    out = weighted_plain(probs, vf, tpr)
    assert ((out.double() - terms.sum(-2)).abs()
            <= slots * EPS * terms.abs().sum(-2)).all()


@pytest.mark.parametrize("vocab,dtype", [(49152, torch.bfloat16),
                                         (49152, torch.float32),
                                         (1031, torch.bfloat16)])
def test_sampler_sums_are_within_their_f32_bound(vocab, dtype):
    """The sampler's two sums over the vocabulary (``ordered_sum``: the
    softmax's denominators, the entropy) against the float64 sums of the
    same f32 terms within ``V · 2^-24 · Σ|terms|``; its probabilities
    within the roundings that follow (a division, M adds, a product); and
    its entropy is that sum, bit for bit."""
    m, s = 4, 3
    gen = torch.Generator().manual_seed(vocab)
    lg = (torch.randn((m, s, vocab), generator=gen) * 4).to(dtype)
    pack = pack_of(vocab)
    x = lg.float()
    ex = exp_plain(x - x.amax(-1, keepdim=True))
    tot = ordered_sum(ex, pack)
    want = ex.double().sum(-1)
    assert ((tot.double() - want).abs() <= vocab * EPS * want).all()
    _, p, ent = bma_sample_plain(lg, random.split(random.PRNGKey(1), s),
                                 torch.arange(s))
    exact = (ex.double() / want[..., None]).mean(0)
    assert ((p.double() - exact).abs()
            <= exact * (vocab + m + 3) * EPS).all()
    lp = log_plain(torch.clamp(p, min=1e-12))
    assert torch.equal(ent, -ordered_sum(p * lp, pack))
    terms = (p * lp).double()
    assert ((-ent.double() - terms.sum(-1)).abs()
            <= vocab * EPS * terms.abs().sum(-1)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_the_reference(dtype):
    """``models.attention.decode_attention`` of both packages on the same
    parameters, caches and positions: 12 query heads of 128 over one KV
    head, 3 lanes at position 9 of 16 slots with bf16 caches, as the
    reference's decode state keeps them. The caches the port writes equal
    the reference's but where an f32 key or value of the new row rounds to
    the other bfloat16 neighbour (one bf16 ulp; ROADMAP C29); the output
    equals the reference's attention over the port's caches within the LM
    tests' decode tolerance."""
    cfg = get_arch("mistral-large-123b").reduced.replace(
        dtype=dtype, num_heads=12, num_kv_heads=1, head_dim=128, d_model=256)
    jcfg = jax_get_arch("mistral-large-123b").reduced.replace(
        dtype=dtype, num_heads=12, num_kv_heads=1, head_dim=128, d_model=256)
    jp = jattn.init_attention(jax.random.PRNGKey(3), jcfg, jnp.float32)
    b, slots, pos = 3, 16, 9
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(b, 1, 256)).astype(np.float32)).astype(
        dtype)
    k = jnp.asarray(rng.normal(size=(b, slots, 1, 128))).astype(jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(b, slots, 1, 128))).astype(jnp.bfloat16)
    sp = np.where(np.arange(slots) < pos, np.arange(slots), -1).astype(
        np.int32)
    jc, _ = jax.jit(lambda p_, c_, x_: jattn.decode_attention(
        p_, c_, x_, jnp.int32(pos), jcfg))(
            jp, {"k": k, "v": v, "slot_pos": jnp.asarray(sp)}, x)

    @jax.jit
    def reference_over(p_, kc, vc, spos, x_):
        """The reference's attention (attention.py:132-141) over given
        caches."""
        q, _, _ = jattn._qkv(p_, x_, jcfg, jnp.broadcast_to(pos, (b, 1)))
        scores = jattn._gqa_scores(q, kc.astype(x_.dtype))
        valid = (spos >= 0) & (spos <= pos)
        scores = jnp.where(valid[None, None, None, None, :], scores,
                           jattn.NEG_INF)
        return jattn._gqa_out(scores, vc.astype(x_.dtype), p_, x_.dtype)

    def as_torch(a):
        return torch.tensor(np.asarray(jnp.asarray(a).astype(jnp.float32)))

    params = tree_map(lambda w: w[None],
                      params_from_jax(jax.tree.map(np.asarray, jp)))
    cache = {"k": as_torch(k)[None].bfloat16(),
             "v": as_torch(v)[None].bfloat16(),
             "slot_pos": torch.from_numpy(sp)[None, None].expand(
                 1, b, slots).contiguous()}
    cache, got = pattn.decode_attention(
        params, cache, as_torch(x)[None].to(getattr(torch, dtype)),
        torch.full((b,), pos), cfg)
    for name in ("k", "v"):
        mine, theirs = cache[name][0].float(), as_torch(jc[name])
        bf16_ulp = 2.0 ** (torch.floor(torch.log2(theirs.abs())) - 7)
        assert ((mine - theirs).abs() <= bf16_ulp).all()
        assert torch.equal(mine[:, :pos], theirs[:, :pos])
    assert torch.equal(cache["slot_pos"][0, 0],
                       torch.tensor(np.asarray(jc["slot_pos"])))
    want = np.asarray(reference_over(
        jp, jnp.asarray(cache["k"][0].float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(cache["v"][0].float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(sp).at[pos].set(pos), x).astype(jnp.float32))
    rel = np.abs(got[0].float().numpy() - want).max() / np.abs(want).max()
    assert rel <= (F32_TOL if dtype == "float32" else BF16_TOL)
