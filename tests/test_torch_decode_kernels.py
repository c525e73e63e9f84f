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
- The split form (recurrentgemma-9b's ring): its tiles (``split_of``, a
  function of one lane's shapes) and shared memory, its sums tile by tile
  in rank order, its output against the float64 attention, and one lane's
  output the same decoded alone and among 16 lanes.
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
from repro_torch.kernels.decode_attention import (MAX_CLUSTER,
                                                  SPLIT_MAX_SMEM,
                                                  SPLIT_STATIC,
                                                  decode_attention_clocks,
                                                  decode_attention_plain,
                                                  dot_plain, segment,
                                                  softmax_sum_plain,
                                                  split_of, split_smem_bytes,
                                                  split_stages,
                                                  weighted_plain)
from repro_torch.kernels.threefry import (_div, _fma, exp_plain, exp_xla,
                                          log_plain)
from repro_torch.models import attention as pattn
from repro_torch.models.transformer import params_from_jax
from repro_torch.utils.tree import tree_map
from torch_golden import exp_inputs

import torch_threads  # noqa: F401  (one torch thread a process)

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


def test_split_form_is_where_one_cta_cannot_hold_the_cache():
    """``split_of``: the one-CTA form for every shape it took before
    (smollm's 3 heads of 64 at 128 and 256 slots, 12 heads of 128, r = 16
    of 256 in bf16 up to 288 slots), the split form for recurrentgemma-9b's
    ring (16 heads of 256 over 2,048 slots: a portable cluster of 8 CTAs
    of 256 slots, 128 CTAs at 16 lanes) and for any f32 row of 256 (64
    segments of 16 bytes, which the one-CTA form's rows of at most 32
    cannot take); each split tile within the card's shared memory."""
    bf, f32 = torch.bfloat16, torch.float32
    for r, hd, slots, dt in ((3, 64, 128, bf), (3, 64, 256, f32),
                             (12, 128, 256, bf), (12, 128, 256, f32),
                             (16, 256, 288, bf), (1, 64, 448, bf)):
        assert split_of(r, hd, slots, dt) is None
    assert split_of(16, 256, 2048, bf) == (8, 256)
    assert split_of(16, 256, 2048, f32) == (8, 256)
    assert split_of(16, 256, 32, f32) == (1, 32)
    assert split_of(16, 256, 40, f32) == (1, 40)
    assert split_of(16, 256, 300, bf) == (2, 150)
    assert split_of(16, 256, 4096, bf) == (8, 512)
    assert split_of(16, 256, 8192, f32) == (8, 1024)
    for slots, dt in ((2048, bf), (2048, f32), (300, bf), (4096, bf),
                      (8192, f32)):
        nc, ts = split_of(16, 256, slots, dt)
        assert nc <= MAX_CLUSTER
        for cdt in (bf, f32):
            assert split_smem_bytes(16, 256, ts, cdt) <= SPLIT_MAX_SMEM
            assert split_stages(16, 256, ts, cdt) >= 2
    # two CTAs an SM at recurrentgemma's bf16 step: a ring of 5 stages, 2 x
    # (the dynamic and static shared memory and 1 KB reserved) within the
    # SM's 228 KB; a tile of 1,024 slots, where not two stages fit there,
    # takes the SM alone (8 stages in bf16, 6 in f32)
    assert split_stages(16, 256, 256, bf) == 5
    assert 2 * (split_smem_bytes(16, 256, 256, bf) + SPLIT_STATIC + 1024) \
        <= 233472
    assert split_stages(16, 256, 1024, bf) == 8
    assert split_stages(16, 256, 1024, f32) == 6
    assert 2 * (split_smem_bytes(16, 256, 1024, bf) + SPLIT_STATIC + 1024) \
        > 233472
    assert segment(256, f32) == (4, 64) and segment(256, bf) == (8, 32)
    assert segment(128, f32) == (4, 32)


@pytest.mark.parametrize("h,kv,hd,first", [
    (32, 4, 128, 4033), (96, 8, 128, 2305), (8, 1, 64, 5633),
    (12, 1, 64, 3563), (9, 3, 64, 11841), (16, 1, 32, 3073)])
def test_split_tiles_at_narrower_heads(h, kv, hd, first):
    """Where ``split_of`` sends narrower heads to the split form (the card
    test ``test_decode_attention_split_form_at_narrower_heads`` holds each
    there): one CTA up to ``first - 1`` bf16 slots, then a cluster of 8
    CTAs of ``ceil(slots / 8)``, every tile up to 4 times the first with a
    ring of at least two stages in both compute dtypes."""
    r, bf = h // kv, torch.bfloat16
    assert split_of(r, hd, first - 1, bf) is None
    for slots in (first, first + 67, 4 * first):
        nc, ts = split_of(r, hd, slots, bf)
        assert (nc, ts) == (8, -(-slots // 8))
        for dt in (bf, torch.float32):
            assert split_stages(r, hd, ts, dt) >= 2
            assert split_smem_bytes(r, hd, ts, dt) <= SPLIT_MAX_SMEM


def test_split_clocks_are_the_cards():
    """``decode_attention_clocks`` (the timed build of the split kernel)
    runs only on the card: CPU tensors raise rather than fall back."""
    g, b, h, hd, slots = 1, 1, 16, 256, 2048
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="clocks"):
        decode_attention_clocks(
            torch.zeros((g, b, h, hd), dtype=bf),
            torch.zeros((g, b, 1, hd), dtype=bf),
            torch.zeros((g, b, 1, hd), dtype=bf),
            torch.zeros((g, b, slots, 1, hd), dtype=bf),
            torch.zeros((g, b, slots, 1, hd), dtype=bf),
            torch.full((g, b, slots), -1, dtype=torch.int32),
            torch.zeros((b,), dtype=torch.int64), 2048)


@pytest.mark.parametrize("ts", [75, 128, 150, 256])
def test_split_sums_are_the_tiles_in_rank_order(ts):
    """The split form's softmax and P·V sums over 300 slots (tiles of 128
    and 256 leave a short last tile): the softmax's each tile's in the
    one-CTA order, the P·V's each output one fma chain over a tile's rows
    in order from +0, the tiles' sums added in rank order from the first;
    one tile is the one-CTA form's softmax sum and a single chain over
    every row; and each is within ``n · 2^-24 · Σ|terms|`` of the float64
    sum."""
    gen = torch.Generator().manual_seed(ts)
    slots, r, hd = 300, 4, 256
    ex = torch.rand((2, r, slots), generator=gen)
    vf = torch.randn((2, slots, hd), generator=gen)
    tot = softmax_sum_plain(ex, ts)
    parts = [softmax_sum_plain(ex[..., i:i + ts]) for i in range(0, slots, ts)]
    want = parts[0]
    for p_ in parts[1:]:
        want = want + p_
    assert torch.equal(tot, want)
    assert torch.equal(softmax_sum_plain(ex, slots), softmax_sum_plain(ex))
    assert ((tot.double() - ex.double().sum(-1)).abs()
            <= slots * EPS * ex.double().sum(-1)).all()
    probs = ex / tot[..., None]
    out = weighted_plain(probs, vf, 32, ts)

    def chain(lo, hi):
        acc = torch.zeros((2, r, hd))
        for t in range(lo, hi):
            acc = _fma(probs[..., t:t + 1], vf[:, None, t], acc)
        return acc
    tiles = [chain(i, min(slots, i + ts)) for i in range(0, slots, ts)]
    want = tiles[0]
    for p_ in tiles[1:]:
        want = want + p_
    assert torch.equal(out, want)
    terms = probs.double()[..., :, :, None] * vf.double()[..., None, :, :]
    assert ((out.double() - terms.sum(-2)).abs()
            <= slots * EPS * terms.abs().sum(-2)).all()
    assert torch.equal(weighted_plain(probs, vf, 32, slots),
                       chain(0, slots))


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_takes_recurrentgemmas_ring(cache_dtype, dtype):
    """The plain version (the split form's order) at recurrentgemma-9b's
    local-attention shape, 16 heads of 256 over one KV head and a ring of
    2,048 slots, 2 lanes past the ring's end (positions 2,100 and 4,095,
    every slot written, the oldest overwritten): its output against the
    float64 attention over the same caches and the same rounded scores,
    within f32 summation error (f32: 1e-5 of the largest) or bf16's
    rounding of the probabilities and output (3e-2)."""
    g, b, h, hd, slots, window = 1, 2, 16, 256, 2048, 2048
    gen = torch.Generator().manual_seed(7)
    q = torch.randn((g, b, h, hd), generator=gen).to(dtype)
    kn = torch.randn((g, b, 1, hd), generator=gen).to(dtype)
    vn = torch.randn((g, b, 1, hd), generator=gen).to(dtype)
    kc = torch.randn((g, b, slots, 1, hd), generator=gen).to(cache_dtype)
    vc = torch.randn((g, b, slots, 1, hd), generator=gen).to(cache_dtype)
    pos = torch.tensor([2100, 4095])
    t = torch.arange(slots)[None]
    sp = (pos[:, None] - 1 - torch.remainder(pos[:, None] - 1 - t, slots))
    sp = sp.to(torch.int32)[None].contiguous()
    out = decode_attention_plain(q, kn, vn, kc, vc, sp, pos, window)
    assert sp[0, 0, 2100 % slots] == 2100 and sp[0, 1, 4095 % slots] == 4095
    kd = kc.to(dtype).double()[0, :, :, 0]          # (b, slots, hd)
    vd = vc.to(dtype).double()[0, :, :, 0]
    s = torch.einsum("bhk,btk->bht", q[0].double(), kd) / hd ** 0.5
    valid = (sp[0] >= 0) & (sp[0].long() <= pos[:, None]) & \
        (sp[0].long() > pos[:, None] - window)
    s = s.masked_fill(~valid[:, None], -1e30)
    want = torch.einsum("bht,btk->bhk", torch.softmax(s, -1), vd)
    rel = float((out[0].double() - want).abs().max() / want.abs().max())
    assert rel <= (F32_TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("window", [0, 2048])
def test_a_lanes_output_is_the_same_alone_and_among_16_lanes(window):
    """The split form's tiles are one lane's (``split_of`` takes no lane
    count): recurrentgemma-9b's 16 heads of 256 over 2,048 bf16 slots,
    each of 16 lanes (M=2 x 8, phase 17 (d)'s launch) decoded alone
    through the plain version gives bit for bit its output among the 16,
    and the same caches and slot_pos."""
    g, b, h, hd, slots = 2, 8, 16, 256, 2048
    gen = torch.Generator().manual_seed(33 + window)
    bf = torch.bfloat16
    q = torch.randn((g, b, h, hd), generator=gen).to(bf)
    kn = torch.randn((g, b, 1, hd), generator=gen).to(bf)
    vn = torch.randn((g, b, 1, hd), generator=gen).to(bf)
    kc = torch.randn((g, b, slots, 1, hd), generator=gen).to(bf)
    vc = torch.randn((g, b, slots, 1, hd), generator=gen).to(bf)
    pos = torch.tensor([0, 5, 255, 256, 2047, 2048, 2300, 4095])
    t = torch.arange(slots)[None]
    p = pos[:, None]
    sp = (p - 1 - torch.remainder(p - 1 - t, slots)) if window else \
        torch.where(t < p, t, -1)
    sp = torch.where(sp >= 0, sp, -1).to(torch.int32).expand(
        g, b, slots).contiguous()
    sp[1, 2] = -1                                    # a reset lane
    many = [kc.clone(), vc.clone(), sp.clone()]
    out = decode_attention_plain(q, kn, vn, *many, pos, window)
    for m in range(g):
        for i in range(b):
            one = [x[m:m + 1, i:i + 1].clone() for x in (kc, vc, sp)]
            alone = decode_attention_plain(
                q[m:m + 1, i:i + 1], kn[m:m + 1, i:i + 1],
                vn[m:m + 1, i:i + 1], *one, pos[i:i + 1], window)
            assert _same(alone[0, 0].float().numpy(),
                         out[m, i].float().numpy())
            for a_, b_ in zip(one, many):
                assert torch.equal(a_[0, 0], b_[m, i])
