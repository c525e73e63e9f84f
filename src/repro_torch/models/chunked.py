"""Memory-bounded training-path forms for long sequences
(``repro/models/chunked.py``), each taken at ``S >= 2 · chunk_size``
(``attn_impl="auto"``) as the reference takes it:

- :func:`chunked_gqa` (``:28-74``): causal GQA, the scores of one chunk of
  queries against every key at a time, ``(G, B, KV, r, C, S)`` instead of
  ``(.., S, S)``;
- :func:`chunked_lru` (``:77-112``): RG-LRU's diagonal recurrence, an
  associative scan a chunk with the carried ``h``;
- :func:`chunkwise_mlstm` (``:115-189``): the mLSTM, its matrix state
  ``(C, n, m)`` carried from chunk to chunk and the quadratic form within
  a chunk.

The reference recomputes each chunk in its backward (``jax.checkpoint``);
the port keeps autograd's saved tensors, which changes no value.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def use_chunked(cfg, s: int) -> bool:
    """The reference's choice of a chunked form for a sequence of ``s``:
    ``attn_impl="chunked"``, or ``"auto"`` at ``S >= 2 · chunk_size``, S a
    multiple of it."""
    return (cfg.attn_impl == "chunked"
            or (cfg.attn_impl == "auto" and s >= 2 * cfg.chunk_size
                and s % cfg.chunk_size == 0))


def sqrt_hd(hd: int) -> float:
    """``jnp.sqrt(hd)`` in f32, as a Python float."""
    return torch.sqrt(torch.tensor(float(hd))).item()


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


def chunked_lru(a: torch.Tensor, b: torch.Tensor, *, chunk: int = 512):
    """``h_t = a_t h_{t-1} + b_t`` over axis 2 of ``a``, ``b`` ``(G, B, S,
    C)`` f32, a chunk at a time: within a chunk the associative scan
    (``rglru.lru_scan``), then ``fma(a_cum, h0, b_scan)`` with the carried
    ``h0`` (XLA contracts the reference's product and sum under ``jit``)."""
    from repro_torch.models.rglru import fma, lru_scan
    s = a.shape[2]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    h0 = a.new_zeros(a.shape[:2] + a.shape[3:])
    outs = []
    for ci in range(s // chunk):
        part = slice(ci * chunk, (ci + 1) * chunk)
        a_cum, b_scan = lru_scan(a[:, :, part], b[:, :, part], 2)
        h = fma(a_cum, h0[:, :, None], b_scan)
        h0 = h[:, :, -1]
        outs.append(h)
    return torch.cat(outs, dim=2)


def chunkwise_mlstm(q, k, v, log_i, log_f, *, chunk: int = 256):
    """q, k, v ``(N, S, H, hd)``; log_i, log_f ``(N, S, H)`` f32 (N the
    port's groups and rows together) -> ``(N, S, H, hd)`` in q's dtype: the
    stabilized chunkwise form, the carry ``(C (N, H, hd, hd), n (N, H,
    hd), m (N, H))`` f32."""
    n_, s, h, hd = q.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    scale = 1.0 / sqrt_hd(hd)
    tt = torch.arange(chunk, device=q.device)
    causal = (tt[None, :] <= tt[:, None])[None, :, :, None]
    c0 = q.new_zeros((n_, h, hd, hd), dtype=torch.float32)
    nn0 = q.new_zeros((n_, h, hd), dtype=torch.float32)
    m0 = q.new_zeros((n_, h), dtype=torch.float32)
    outs = []
    for ci in range(s // chunk):
        part = slice(ci * chunk, (ci + 1) * chunk)
        qc, kc, vc = q[:, part], k[:, part], v[:, part]
        li, lf = log_i[:, part], log_f[:, part]
        fcum = torch.cumsum(lf, dim=1)                   # (N, C, H)
        ftot = fcum[:, -1]                               # (N, H)
        dmat = fcum[:, :, None, :] - fcum[:, None, :, :] + li[:, None, :, :]
        dmat = dmat.masked_fill(~causal, float("-inf"))
        inter = fcum + m0[:, None, :]                    # (N, C, H)
        m_row = torch.clamp(torch.maximum(dmat.amax(dim=2), inter), min=0.0)
        dexp = torch.exp(dmat - m_row[:, :, None, :])    # (N, C, C, H)
        inter_w = torch.exp(inter - m_row)               # (N, C, H)
        sc = torch.einsum("nthk,nshk->ntsh", qc, kc).float() * scale
        w = sc * dexp
        num_intra = torch.einsum("ntsh,nshk->nthk", w.to(qc.dtype), vc)
        den_intra = w.sum(dim=2)                         # (N, C, H)
        qf = qc.float() * scale
        num_inter = torch.einsum("nthk,nhkv->nthv", qf, c0) * \
            inter_w[..., None]
        den_inter = torch.einsum("nthk,nhk->nth", qf, nn0) * inter_w
        den = torch.maximum((den_intra + den_inter).abs(), torch.exp(-m_row))
        hout = (num_intra.float() + num_inter) / (den[..., None] + 1e-6)
        # the state for the next chunk
        m_next = torch.maximum(ftot + m0, (ftot[:, None] - fcum + li)
                               .amax(dim=1))
        kw = torch.exp(ftot[:, None] - fcum + li - m_next[:, None])
        decay = torch.exp(ftot + m0 - m_next)
        kf = kc.float()
        c0 = decay[..., None, None] * c0 + torch.einsum(
            "nsh,nshk,nshv->nhkv", kw, kf, vc.float())
        nn0 = decay[..., None] * nn0 + torch.einsum("nsh,nshk->nhk", kw, kf)
        m0 = m_next
        outs.append(hout.to(qc.dtype))
    return torch.cat(outs, dim=1)
