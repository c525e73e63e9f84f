"""Multi-head latent attention, DeepSeek-V2 (``repro/models/mla.py``).

Keys and values come from a rank-``kv_lora_rank`` latent ``c_kv`` plus one
shared decoupled-RoPE key of ``rope_head_dim`` channels. Training and
prefill decompress K and V (:func:`mla_attention`, with the reference's
chunked branch into ``chunked_gqa``); decode runs the absorbed form
(:func:`mla_decode`): the query is projected into the latent space, so a
cached token is ``kv_lora_rank + rope_head_dim`` values.

Shapes carry the port's group axis ``G`` first, as ``attention.py``: x
``(G, B, S, D)``; weights ``(G, ...)`` of the reference's layouts
(``wuk`` ``(lkv, H, nope)``, ``wo`` ``(H, vd, D)``). RoPE rotates the
``rope_head_dim`` channels with their own angles (not the attention
layers' ``resolved_head_dim`` ones). The scores' scale is ``1 /
sqrt(nope + rope)`` taken in the compute dtype.

A decode cache holds one lane a ``(g, b)`` pair, each at its own
position, as the port's attention cache: ``ckv`` ``(G, B, slots, lkv)``,
``kr`` ``(G, B, slots, rope)`` and ``slot_pos`` ``(G, B, slots)``; bf16 by
default whatever the compute dtype (ROADMAP C29). The absorbed decode is
torch ops: its 576-wide latent row is beyond the decode-attention kernel's
32 segments of 16 bytes.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch import random
from repro_torch.models.attention import _out, _proj
from repro_torch.models.layers import (apply_rope, dense_init, init_rmsnorm,
                                       rmsnorm, rope_angles)

NEG_INF = -1e30


@random.program
def init_mla(key: torch.Tensor, cfg):
    """``split(key, 8)``: ``wdkv``, ``wuk``, ``wuv``, ``wkr``, ``wo``, then
    ``wdq`` and ``wuq`` with a q LoRA rank, else ``wq`` from the eighth."""
    d, h = cfg.d_model, cfg.num_heads
    nope, rope, vd = cfg.resolved_head_dim, cfg.rope_head_dim, \
        cfg.resolved_head_dim
    lq, lkv = cfg.q_lora_rank, cfg.kv_lora_rank
    ks = yield from random.split.program(key, 8)
    progs = [dense_init.program(ks[..., 0, :], d, (lkv,)),
             dense_init.program(ks[..., 1, :], lkv, (h, nope)),
             dense_init.program(ks[..., 2, :], lkv, (h, vd)),
             dense_init.program(ks[..., 3, :], d, (rope,)),
             dense_init.program(ks[..., 4, :], h * vd, (d,))]
    if lq:
        progs += [dense_init.program(ks[..., 5, :], d, (lq,)),
                  dense_init.program(ks[..., 6, :], lq, (h, nope + rope))]
    else:
        progs.append(dense_init.program(ks[..., 7, :], d, (h, nope + rope)))
    out = yield from random.together(*progs)
    lead = tuple(key.shape[:-1])
    p: Dict = {"wdkv": out[0], "kv_norm": init_rmsnorm(lkv, key.device, lead),
               "wuk": out[1], "wuv": out[2], "wkr": out[3],
               "wo": out[4].reshape(lead + (h, vd, d))}
    if lq:
        p["wdq"] = out[5]
        p["q_norm"] = init_rmsnorm(lq, key.device, lead)
        p["wuq"] = out[6]
    else:
        p["wq"] = out[5]
    return p


def _queries(params, x, cfg, angles):
    nope = cfg.resolved_head_dim
    if "wdq" in params:
        cq = rmsnorm(params["q_norm"], _proj(x, params["wdq"]), cfg.norm_eps)
        q = _proj(cq, params["wuq"])
    else:
        q = _proj(x, params["wq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, apply_rope(q_rope, None, cfg.rope_theta, angles)


def _latents(params, x, cfg, angles):
    """``c_kv`` ``(G, B, S, lkv)`` and the rotated shared key ``(G, B, S,
    rope)``."""
    ckv = rmsnorm(params["kv_norm"], _proj(x, params["wdkv"]), cfg.norm_eps)
    kr = _proj(x, params["wkr"])[..., None, :]
    return ckv, apply_rope(kr, None, cfg.rope_theta, angles)[..., 0, :]


def _scale(cfg, dt) -> float:
    """``1 / sqrt(nope + rope)`` as the reference takes it: the root in f32
    rounded to ``dt``, its reciprocal rounded to ``dt``."""
    root = torch.tensor(math.sqrt(cfg.resolved_head_dim + cfg.rope_head_dim),
                        dtype=torch.float32).to(dt).float()
    return float((1.0 / root).to(dt))


def mla_attention(params, x, positions, cfg, causal: bool = True):
    """Training and prefill: x ``(G, B, S, D)``, positions ``(B, S)``."""
    dt = x.dtype
    g, b, s, _ = x.shape
    h, rope = cfg.num_heads, cfg.rope_head_dim
    angles = rope_angles(positions, rope, cfg.rope_theta)
    q_nope, q_rope = _queries(params, x, cfg, angles)
    ckv, kr = _latents(params, x, cfg, angles)
    k_nope = _proj(ckv, params["wuk"])
    v = _proj(ckv, params["wuv"])
    use_chunked = causal and (
        cfg.attn_impl == "chunked"
        or (cfg.attn_impl == "auto" and s >= 2 * cfg.chunk_size
            and s % cfg.chunk_size == 0))
    if use_chunked:
        from repro_torch.models.chunked import chunked_gqa
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, kr[:, :, :, None].expand(g, b, s, h, rope)],
                           dim=-1)
        return _out(params, chunked_gqa(q_full, k_full, v, window=0,
                                        chunk=cfg.chunk_size))
    scores = (torch.einsum("gbshk,gbthk->gbhst", q_nope, k_nope)
              + torch.einsum("gbshk,gbtk->gbhst", q_rope, kr)) * _scale(cfg, dt)
    if causal:
        ii = torch.arange(s, device=x.device)[:, None]
        jj = torch.arange(s, device=x.device)[None, :]
        scores = scores.masked_fill(~(jj <= ii), NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(dt)
    return _out(params, torch.einsum("gbhst,gbthk->gbshk", probs, v))


# --------------------------------------------------------------------------
# decode with the latent cache (absorbed form)
# --------------------------------------------------------------------------

def init_mla_cache(cfg, lanes, max_len: int, dtype=torch.bfloat16,
                   device="cpu") -> Dict:
    lanes = tuple(lanes)
    return {
        "ckv": torch.zeros(lanes + (max_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "kr": torch.zeros(lanes + (max_len, cfg.rope_head_dim), dtype=dtype,
                          device=device),
        "slot_pos": torch.full(lanes + (max_len,), -1, dtype=torch.int32,
                               device=device),
    }


def mla_decode(params, cache, x, pos, cfg):
    """One decode step. x ``(G, B, 1, D)``; ``pos`` ``(B,)`` int64, each
    lane's position. Writes the lane's latent and rotated key into its slot
    (``min(pos, slots − 1)``) in place and returns ``(cache, out (G, B, 1,
    D))``: scores and context in the latent space."""
    dt = x.dtype
    b = x.shape[1]
    angles = rope_angles(pos[:, None], cfg.rope_head_dim, cfg.rope_theta)
    q_nope, q_rope = _queries(params, x, cfg, angles)        # (G,B,1,H,·)
    ckv_new, kr_new = _latents(params, x, cfg, angles)       # (G,B,1,·)
    slots = cache["ckv"].shape[2]
    slot = torch.clamp(pos, max=slots - 1)
    rows = torch.arange(b, device=x.device)
    cache["ckv"][:, rows, slot] = ckv_new[:, :, 0].to(cache["ckv"].dtype)
    cache["kr"][:, rows, slot] = kr_new[:, :, 0].to(cache["kr"].dtype)
    cache["slot_pos"][:, rows, slot] = pos.to(torch.int32)
    ckv, kr = cache["ckv"].to(dt), cache["kr"].to(dt)
    # absorb: q_lat[h, l] = q_nope[h, k] · wuk[l, h, k]
    q_lat = torch.einsum("gbshk,glhk->gbshl", q_nope, params["wuk"].to(dt))
    scores = (torch.einsum("gbshl,gbtl->gbhst", q_lat, ckv)
              + torch.einsum("gbshk,gbtk->gbhst", q_rope, kr)) * _scale(cfg, dt)
    sp = cache["slot_pos"].to(torch.int64)
    valid = (sp >= 0) & (sp <= pos[None, :, None])          # (G, B, slots)
    scores = scores.masked_fill(~valid[:, :, None, None, :], NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(dt)
    ctx_lat = torch.einsum("gbhst,gbtl->gbshl", probs, ckv)
    ctx = torch.einsum("gbshl,glhk->gbshk", ctx_lat, params["wuv"].to(dt))
    return cache, _out(params, ctx)
