"""Memory-bounded causal GQA for long sequences (``repro/models/chunked.py
:28-74``): the scores of one chunk of queries against every key at a time,
``(G, B, KV, r, C, S)`` instead of ``(.., S, S)``. ``attention`` takes this
path at ``S >= 2 · chunk_size`` (``attn_impl="auto"``). The reference's
``chunked_lru`` and ``chunkwise_mlstm`` come with their families (ROADMAP
A12).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def chunked_gqa(q, k, v, *, window: int = 0, chunk: int = 512):
    """q ``(G,B,S,H,hd)``, k/v ``(G,B,S,KV,hd)`` -> ``(G,B,S,H,hd)``,
    causal (and banded with ``window``), in q's dtype."""
    from repro_torch.models.attention import _head_scale
    g, b, s, h, hd = q.shape
    kv = k.shape[3]
    vd = v.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    qg = q.reshape(g, b, s, kv, h // kv, hd)
    scale = _head_scale(hd, q.dtype, q.device)
    kpos = torch.arange(s, device=q.device)
    outs = []
    for ci in range(s // chunk):
        qc = qg[:, :, ci * chunk:(ci + 1) * chunk]
        scores = torch.einsum("gbcvrk,gbtvk->gbvrct", qc, k)
        scores = (scores.float() / scale.expand(scores.shape)).to(q.dtype)
        qpos = ci * chunk + torch.arange(chunk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        scores = scores.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        outs.append(torch.einsum("gbvrct,gbtvk->gbcvrk", probs, v))
    return torch.cat(outs, dim=2).reshape(g, b, s, h, vd)
