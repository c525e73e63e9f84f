"""The decode engine's BMA sampler, one launch a step for every slot
(``csrc/bma_sample.cu``).

From each slot's ``(M, V)`` logits in the compute dtype, as the reference's
jitted ``DecodeEngine`` step (``repro/serve/engine.py:356-380``) computes
them: the tempered softmax of each sample, ``/ temp`` folded by XLA into a
product with ``fl32(1/temp)`` (ROADMAP C5); their mean over the M samples,
summed in order and times ``fl32(1/M)`` (C11); its predictive entropy
(``core.posterior.predictive_entropy``, per slot); and one
``jax.random.categorical`` draw from ``log max(p, 1e-12)`` under the key
``fold_in(key_slot, pos_slot)``: the argmax, first index on ties, of the
log plus ``gumbel`` noise. The noise, the logs and the softmax's exp are
XLA's (``kernels/threefry.py``: ``log_plain``, ``exp_plain``,
``gumbel_plain``), so a token equals the reference's wherever the
reference's top two perturbed scores are further apart than the port's
probabilities are from the reference's.

Kernel and plain version compute in f32 and add the two sums over the
vocabulary (each sample's softmax denominator, the entropy) in one fixed
order, which the kernel's source comment states: ``CLUSTER`` chunks of
the vocabulary, one a CTA of a thread block cluster; in a chunk, packs of
``pack_of`` entries, thread ``tid`` taking packs ``tid, tid + THREADS,
...`` in order; a warp's halving tree; the warps in order; the CTAs in
rank order. The plain version follows it op for op, padded entries adding
exactly +0.0, so the two agree bit for bit. The plain version runs for
CPU tensors; a CUDA tensor launches the kernel or raises;
``bma_sample.launches`` counts launches. No ``pl.pallas_call`` of the
reference computes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check, library, on_card, stream_of
from repro_torch.kernels.threefry import (M32, TINY, _div, exp_plain,
                                          fold_sum, gumbel_plain, log_plain,
                                          seq_sum, threefry2x32_plain,
                                          to_f32)

MAX_SAMPLES = 64                   # csrc/bma_sample.cu: kMaxSamples
CLUSTER = 16                       # kCluster: CTAs a slot
THREADS = 256                      # kSampleThreads
WARPS = THREADS // 32
PACK = 4                           # entries a kernel thread reads at once
MAX_DYN_SMEM = 200 * 1024          # kMaxDynamicSmem
CACHE_SMEM = 96 * 1024             # the most a CTA's exp cache may take


def pack_of(vocab: int) -> int:
    """The entries a kernel thread reads at once: 4 (16 bytes of f32, 8 of
    bfloat16) where the vocabulary is a multiple of 4, else 1."""
    return PACK if vocab % PACK == 0 else 1


def chunk_of(vocab: int, pack: int) -> int:
    """A CTA's entries: ``ceil(V / CLUSTER)`` rounded up to a whole pack."""
    c = -(-vocab // CLUSTER)
    return -(-c // pack) * pack


def ordered_sum(t: torch.Tensor, pack: int) -> torch.Tensor:
    """The kernel's f32 sum of ``t`` over its last axis (the vocabulary):
    each thread's entries in order from +0, a warp's halving tree, the
    warps in order, the CTAs in rank order."""
    vocab = t.shape[-1]
    chunk = chunk_of(vocab, pack)
    packs = chunk // pack
    steps = -(-packs // THREADS)
    lead = t.shape[:-1]
    x = torch.cat([t, t.new_zeros(lead + (CLUSTER * chunk - vocab,))], -1)
    x = x.reshape(lead + (CLUSTER, packs, pack))
    x = torch.cat([x, x.new_zeros(lead + (CLUSTER, steps * THREADS - packs,
                                          pack))], -2)
    x = x.reshape(lead + (CLUSTER, steps, THREADS, pack)).transpose(-2, -3)
    x = seq_sum(x.reshape(lead + (CLUSTER, THREADS, steps * pack)))
    x = fold_sum(x.reshape(lead + (CLUSTER, WARPS, 32)))
    return seq_sum(seq_sum(x))


def argmax_first(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.argmax``: the first index of the largest value, or of the
    first NaN where there is one (int64)."""
    nan = torch.isnan(x)
    hit = torch.where(nan.any(dim=dim, keepdim=True), nan,
                      x == x.amax(dim=dim, keepdim=True))
    return torch.argmax(hit.to(torch.uint8), dim=dim)


def sample_constants(temperature: float, samples: int):
    """``(fl32(1/temp), fl32(1/M))``: the reciprocals XLA multiplies by."""
    return to_f32(1.0 / float(temperature)), to_f32(1.0 / samples)


def slot_gumbel_plain(keys: torch.Tensor, pos: torch.Tensor,
                      vocab: int) -> torch.Tensor:
    """``gumbel(fold_in(keys[s], pos[s]), (vocab,))`` for every slot."""
    k0, k1 = keys[:, :1], keys[:, 1:]
    f0, f1 = threefry2x32_plain(k0, k1, torch.zeros_like(k0),
                                pos.to(torch.int64)[:, None] & M32)
    j = torch.arange(vocab, dtype=torch.int64, device=keys.device)[None]
    x0, x1 = threefry2x32_plain(f0, f1, torch.zeros_like(j), j)
    return gumbel_plain(x0 ^ x1, TINY, 1.0)


def bma_sample_plain(logits, keys, pos, temperature: float = 1.0):
    """The kernel's arithmetic in torch ops, in its order
    (``csrc/bma_sample.cu``, its head comment): ``(next (S,) int64, probs
    (S, V) f32, entropy (S,) f32)``."""
    m = logits.shape[0]
    pack = pack_of(logits.shape[-1])
    inv_temp, inv_m = sample_constants(temperature, m)
    x = logits.float() * inv_temp
    e = exp_plain(x - x.amax(dim=-1, keepdim=True))
    pm = _div(e, ordered_sum(e, pack)[..., None])
    acc = pm[0]
    for i in range(1, m):
        acc = acc + pm[i]
    p = acc * inv_m
    lp = log_plain(torch.clamp(p, min=to_f32(1e-12)))
    ent = -ordered_sum(p * lp, pack)
    score = slot_gumbel_plain(keys, pos, p.shape[-1]) + lp
    return argmax_first(score, dim=-1), p, ent


def bma_sample(logits: torch.Tensor, keys: torch.Tensor, pos: torch.Tensor,
               temperature: float = 1.0, out=None):
    """logits ``(M, S, V)`` (f32 or bf16), keys ``(S, 2)`` int64 words, pos
    ``(S,)`` int64 -> ``(next (S,) int64, probs (S, V) f32, entropy (S,)
    f32)``. ``out`` (that triple of tensors) receives the results in place
    (a captured step's static outputs)."""
    m, s, v = logits.shape
    if keys.shape != (s, 2) or pos.shape != (s,):
        raise ValueError(f"bma_sample: keys {tuple(keys.shape)}, pos "
                         f"{tuple(pos.shape)} for {s} slots")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bma_sample: logits {logits.dtype}")
    if not on_card("bma_sample", [(logits, logits.dtype),
                                  (keys, torch.int64), (pos, torch.int64)]):
        res = bma_sample_plain(logits, keys, pos, temperature)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return out
    if m > MAX_SAMPLES:
        raise ValueError(f"bma_sample: {m} samples, a launch takes at most "
                         f"{MAX_SAMPLES}")
    if out is None:
        out = (torch.empty((s,), dtype=torch.int64, device=logits.device),
               torch.empty((s, v), dtype=torch.float32, device=logits.device),
               torch.empty((s,), dtype=torch.float32, device=logits.device))
    nxt, probs, ent = out
    pack = pack_of(v)
    if pack > 1 and (logits.data_ptr() % 16 or probs.data_ptr() % 16):
        raise ValueError("bma_sample: logits and probs must be 16-byte "
                         "aligned")
    chunk = chunk_of(v, pack)
    if 4 * chunk > MAX_DYN_SMEM:
        raise ValueError(f"bma_sample: a vocabulary of {v} puts {chunk} "
                         f"entries on a CTA, whose noise needs more than "
                         f"{MAX_DYN_SMEM} bytes of shared memory")
    cache_exp = 4 * chunk * (1 + m) <= CACHE_SMEM
    inv_temp, inv_m = sample_constants(temperature, m)
    with torch.cuda.device(logits.device):
        rc = library().repro_bma_sample(
            logits.data_ptr(), keys.data_ptr(), pos.data_ptr(),
            nxt.data_ptr(), probs.data_ptr(), ent.data_ptr(), m, s, v, pack,
            chunk, int(cache_exp), inv_temp, inv_m, TINY,
            int(logits.dtype == torch.bfloat16), stream_of(logits))
    check(rc, "bma_sample")
    bma_sample.launches += 1
    return out


bma_sample.launches = 0
