"""Grouped-query attention with RoPE, optional QKV bias (Qwen2) and a
sliding window (Mistral), and single-token decode over a full KV cache or a
ring buffer (``repro/models/attention.py:19-142``).

Shapes carry the port's group axis ``G`` first (the samples of a bank):
x ``(G, B, S, D)``; q ``(G, B, S, H, hd)``; k, v ``(G, B, S, KV, hd)``;
weights ``(G, ...)`` of the reference's layouts (``wq`` ``(D, H, hd)``,
``wo`` ``(H, hd, D)``). A decode cache holds one lane a ``(g, b)`` pair:
``k``, ``v`` ``(G, B, slots, KV, hd)`` and ``slot_pos`` ``(G, B, slots)``,
and each lane decodes at its own position, as the reference's engine
vmaps a batch-1 cache over its lanes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import random
from repro_torch.kernels.decode_attention import NEG_INF, head_scale
from repro_torch.kernels.decode_attention import \
    decode_attention as decode_attention_kernel
from repro_torch.models.chunked import chunked_gqa, use_chunked
from repro_torch.models.layers import apply_rope, dense_init, rope_angles
from repro_torch.utils.device import device_const


@random.program
def init_attention(key: torch.Tensor, cfg):
    """``wq``, ``wk``, ``wv``, ``wo`` from ``split(key, 4)`` (zero biases
    with ``qkv_bias``); keys with leading axes give leaves with them."""
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    ks = yield from random.split.program(key, 4)
    wq, wk, wv, wo = yield from random.together(
        dense_init.program(ks[..., 0, :], d, (h, hd)),
        dense_init.program(ks[..., 1, :], d, (kv, hd)),
        dense_init.program(ks[..., 2, :], d, (kv, hd)),
        dense_init.program(ks[..., 3, :], h * hd, (d,)))
    lead = tuple(key.shape[:-1])
    p = {"wq": wq, "wk": wk, "wv": wv,
         "wo": wo.reshape(lead + (h, hd, d))}
    if cfg.qkv_bias:
        for name, heads in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros(lead + (heads, hd), device=key.device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum('gbsd,gd...->gbs...')``: ``x`` ``(G, B, S, D)`` against
    ``w`` ``(G, D, *out)`` in ``x``'s dtype, one batched matmul."""
    g, b, s, d = x.shape
    out = torch.bmm(x.reshape(g, b * s, d), w.to(x.dtype).reshape(g, d, -1))
    return out.reshape((g, b, s) + tuple(w.shape[2:]))


def _bias(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return y + bias.to(y.dtype)[:, None, None]


def _qkv(params, x, cfg, positions, angles=None):
    """q, k, v projections (with bias), RoPE on q and k; ``positions``
    ``(B, S)`` integers (or their ``angles``, ``layers.rope_angles``)."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if "bq" in params:
        q = _bias(q, params["bq"])
        k = _bias(k, params["bk"])
        v = _bias(v, params["bv"])
    if angles is None:
        angles = rope_angles(positions, q.shape[-1], cfg.rope_theta)
    return (apply_rope(q, positions, cfg.rope_theta, angles),
            apply_rope(k, positions, cfg.rope_theta, angles), v)


def _head_scale(hd: int, dtype, device) -> torch.Tensor:
    """``sqrt(hd)`` in the compute dtype, as an f32 scalar on ``device``."""
    return device_const(("head_scale", hd, dtype), device,
                        lambda: torch.tensor(head_scale(hd, dtype)))


def _gqa_scores(q, k):
    """q ``(G,B,Sq,H,hd)``, k ``(G,B,Sk,KV,hd)`` -> scores
    ``(G,B,KV,H/KV,Sq,Sk)`` in q's dtype, divided by ``sqrt(hd)``."""
    g, b, sq, h, hd = q.shape
    kvh = k.shape[3]
    qg = q.reshape(g, b, sq, kvh, h // kvh, hd)
    s = torch.einsum("gbsvrk,gbtvk->gbvrst", qg, k)
    scale = _head_scale(hd, q.dtype, q.device)
    return (s.float() / scale.expand(s.shape)).to(q.dtype)


def _gqa_out(scores, v, params, dt):
    """scores ``(G,B,KV,r,Sq,Sk)``, v ``(G,B,Sk,KV,hd)`` -> ``(G,B,Sq,D)``:
    the f32 softmax rounded to ``dt``, the weighted values, then ``wo``."""
    probs = torch.softmax(scores.float(), dim=-1).to(dt)
    ctx = torch.einsum("gbvrst,gbtvk->gbsvrk", probs, v)
    g, b, sq = ctx.shape[:3]
    return _out(params, ctx.reshape(g, b, sq, -1, v.shape[-1]))


def _out(params, ctx: torch.Tensor) -> torch.Tensor:
    """ctx ``(G, B, S, H, hd)`` through ``wo`` ``(G, H, hd, D)``."""
    g, b, s, h, hd = ctx.shape
    wo = params["wo"].to(ctx.dtype).reshape(g, h * hd, -1)
    return torch.bmm(ctx.reshape(g, b * s, h * hd), wo).reshape(g, b, s, -1)


def attention(params, x, positions, cfg, window: int = 0,
              cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              causal: bool = True, angles=None):
    """Training and prefill attention; ``window > 0`` bands the causal mask.
    ``cross_kv`` (the whisper decoder's, ROADMAP A12) attends to given keys
    and values with no mask. ``positions`` ``(B, S)``; ``angles`` their
    rotations, when the caller has them."""
    dt = x.dtype
    if cross_kv is not None:
        k, v = cross_kv
        q = _proj(x, params["wq"])
        return _gqa_out(_gqa_scores(q, k), v, params, dt)
    q, k, v = _qkv(params, x, cfg, positions, angles)
    if causal and use_chunked(cfg, q.shape[2]):
        return _out(params, chunked_gqa(q, k, v, window=window,
                                        chunk=cfg.chunk_size))
    scores = _gqa_scores(q, k)
    sq, sk = scores.shape[-2], scores.shape[-1]
    ii = torch.arange(sq, device=x.device)[:, None]
    jj = torch.arange(sk, device=x.device)[None, :]
    mask = (jj <= ii) if causal else torch.ones((sq, sk), dtype=torch.bool,
                                                device=x.device)
    if window > 0:
        mask = mask & (ii - jj < window)
    scores = scores.masked_fill(~mask, NEG_INF)
    return _gqa_out(scores, v, params, dt)


# --------------------------------------------------------------------------
# decode caches
# --------------------------------------------------------------------------

def init_cache(cfg, lanes: Tuple[int, ...], max_len: int, window: int = 0,
               dtype=torch.bfloat16, device="cpu") -> Dict:
    """A full cache of ``max_len`` slots when ``window == 0``, else a ring
    buffer of ``window`` slots, for each lane of ``lanes`` (``(G, B)``).
    The cache is bfloat16 by default whatever the compute dtype, as the
    reference's ``init_decode_state``."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    slots = window if window > 0 else max_len
    lanes = tuple(lanes)
    return {
        "k": torch.zeros(lanes + (slots, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros(lanes + (slots, kv, hd), dtype=dtype, device=device),
        "slot_pos": torch.full(lanes + (slots,), -1, dtype=torch.int32,
                               device=device),
    }


def decode_attention(params, cache, x, pos, cfg, window: int = 0,
                     angles=None):
    """One decode step. x ``(G, B, 1, D)``; ``pos`` ``(B,)`` int64, each
    lane's position. Writes the lane's post-RoPE key and value into its slot
    (``min(pos, slots − 1)``, or ``pos mod slots`` in a ring buffer) in
    place, and returns ``(cache, out (G, B, 1, D))``: the kernel
    (``kernels/decode_attention.py``) on the card, its plain version on the
    CPU."""
    q, k_new, v_new = _qkv(params, x, cfg, pos[:, None], angles)
    ctx = decode_attention_kernel(q[:, :, 0], k_new[:, :, 0], v_new[:, :, 0],
                                  cache["k"], cache["v"], cache["slot_pos"],
                                  pos, window)
    return cache, _out(params, ctx[:, :, None])
