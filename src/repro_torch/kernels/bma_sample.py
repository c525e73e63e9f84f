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
log plus ``gumbel`` noise. The noise and both logs are XLA's
(``kernels/threefry.py``: ``log_plain``, ``gumbel_plain``), so a token
equals the reference's wherever the reference's top two perturbed scores
are further apart than the port's probabilities are from the reference's.

Kernel and plain version take ``exp`` in float64 rounded to f32 and sum
the vocabulary's f32 terms in float64 (the kernel in a fixed block order,
the plain version in torch's), so their tokens agree bit for bit; the
probabilities and entropies round to the same f32 unless a float64 sum's
rounding error meets an f32 tie. The plain version runs for CPU tensors; a
CUDA tensor launches the kernel or raises; ``bma_sample.launches`` counts
launches. No ``pl.pallas_call`` of the reference computes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check, library, on_card, stream_of
from repro_torch.kernels.threefry import (M32, TINY, gumbel_plain,
                                          log_plain, threefry2x32_plain,
                                          to_f32)

MAX_SAMPLES = 64                   # csrc/bma_sample.cu: kMaxSamples


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
    """The kernel's arithmetic in torch ops: ``(next (S,) int64, probs
    (S, V) f32, entropy (S,) f32)``."""
    m = logits.shape[0]
    inv_temp, inv_m = sample_constants(temperature, m)
    x = logits.float() * inv_temp
    e = torch.exp((x - x.amax(dim=-1, keepdim=True)).double()).float()
    pm = e / e.double().sum(dim=-1, keepdim=True).float()
    acc = pm[0]
    for i in range(1, m):
        acc = acc + pm[i]
    p = acc * inv_m
    lp = log_plain(torch.clamp(p, min=to_f32(1e-12)))
    ent = -((p * lp).double().sum(dim=-1).float())
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
    inv_temp, inv_m = sample_constants(temperature, m)
    with torch.cuda.device(logits.device):
        rc = library().repro_bma_sample(
            logits.data_ptr(), keys.data_ptr(), pos.data_ptr(),
            nxt.data_ptr(), probs.data_ptr(), ent.data_ptr(), m, s, v,
            inv_temp, inv_m, TINY, int(logits.dtype == torch.bfloat16),
            stream_of(logits))
    check(rc, "bma_sample")
    bma_sample.launches += 1
    return out


bma_sample.launches = 0
