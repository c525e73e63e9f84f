"""Mixture-of-experts FFN (``repro/models/moe.py``): a top-k router in
f32, routed SwiGLU/GeGLU experts, DeepSeek-style shared experts and the
Switch load-balance aux loss.

Shapes carry the port's group axis ``G`` first (the samples of a bank, the
nodes of a round): x ``(G, B, S, D)``; ``router`` ``(G, D, E)`` f32;
``gate``, ``up`` ``(G, E, D, F)``; ``down`` ``(G, E, F, D)``.

The router takes ``lax.top_k``'s order: descending probability, the lower
expert first on ties (a stable descending sort, not ``torch.topk``).

Two dispatches, as ``cfg.moe.impl`` names them:

- ``"ragged"`` (the reference's sort and ``ragged_dot``, no token dropped):
  each (token, slot) copy multiplies its own expert's weights, gathered a
  copy, in batched products of fixed shape, so nothing depends on how many
  copies an expert gets: no group size is read on the host and a CUDA
  graph captures it (the decode step's, the scan engine's). It reads
  ``T·k`` expert matrices where a grouped product reads the experts used
  once, and writes each gathered copy before the product reads it again;
  PERF.md §5 has its time. Its memory grows with tokens times expert
  size: a forward holds ``T·k·(2·D·F + F·D)`` gathered elements a layer,
  which autograd keeps for the backward, and the backward builds a
  gradient as large before it scatters into ``(E, D, F)``. At
  deepseek-v2's widths (D 5120, F 1536, k 6) that is 283 MB a token a
  layer in bf16, twice that with its gradient, so past about 140 tokens
  a layer a step no longer fits an 80 GB card; at grok-1's (D 6144, F
  32768, k 2) 2.4 GB a token, about 16 tokens. Training at those widths
  waits for a grouped dispatch (ROADMAP A10). The reference scatters the
  weighted outputs back in its sort's order (expert, then copy), so a token's k
  outputs add in ascending expert order, each add in the compute dtype;
  the port adds them in that order.
- ``"gshard"``: the capacity-based one-hot dispatch, transcribed einsum for
  einsum; copies beyond ``ceil(T·k/E · capacity_factor)`` an expert are
  dropped.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import random
from repro_torch.models.layers import _ACTS, dense_init


@random.program
def init_moe(key: torch.Tensor, cfg):
    """``split(key, 7)``: router, gate, up, down (each drawn ``(d, e, ·)``
    and moved to ``(e, d, ·)``), then the shared experts' three."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    ks = yield from random.split.program(key, 7)
    progs = [dense_init.program(ks[..., 0, :], d, (e,)),
             dense_init.program(ks[..., 1, :], d, (e, ff)),
             dense_init.program(ks[..., 2, :], d, (e, ff)),
             dense_init.program(ks[..., 3, :], ff, (e, d))]
    sff = ff * cfg.moe.num_shared_experts
    if sff:
        progs += [dense_init.program(ks[..., 4, :], d, (sff,)),
                  dense_init.program(ks[..., 5, :], d, (sff,)),
                  dense_init.program(ks[..., 6, :], sff, (d,))]
    out = yield from random.together(*progs)
    lead = key.dim() - 1
    p = {"router": out[0]}
    for name, w in zip(("gate", "up", "down"), out[1:4]):
        p[name] = w.transpose(lead, lead + 1).contiguous()
    if sff:
        p["shared"] = dict(zip(("gate", "up", "down"), out[4:7]))
    return p


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest in descending order,
    the lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params, xt: torch.Tensor, cfg):
    """xt ``(G, T, D)`` -> the router's f32 ``probs`` ``(G, T, E)``, the
    renormalized ``top_p`` and ``top_e`` ``(G, T, k)``."""
    logits = torch.bmm(xt.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, cfg.moe.top_k)
    return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_e


def aux_loss(probs: torch.Tensor, top_e: torch.Tensor, cfg) -> torch.Tensor:
    """The Switch/DeepSeek load-balance term of each group, ``(G,)``:
    ``E · Σ_e f_e p_e · weight``."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    hits = torch.nn.functional.one_hot(top_e, e).float().sum(dim=2)
    frac_tokens = hits.mean(dim=1) / k
    frac_probs = probs.mean(dim=1)
    return e * (frac_tokens * frac_probs).sum(dim=-1) * cfg.moe.aux_loss_weight


def _shared(params, xt: torch.Tensor, act) -> torch.Tensor:
    sp, dt = params["shared"], xt.dtype
    sg = act(torch.bmm(xt, sp["gate"].to(dt))) * torch.bmm(xt, sp["up"].to(dt))
    return torch.bmm(sg, sp["down"].to(dt))


def _rows_of(w: torch.Tensor, experts: torch.Tensor, dt) -> torch.Tensor:
    """Each copy's expert matrix: ``w`` ``(G, E, a, b)``, ``experts`` ``(G,
    N)`` -> ``(G·N, a, b)`` in ``dt``."""
    g, n = experts.shape
    rows = torch.arange(g, device=w.device)[:, None].expand(g, n)
    return w[rows, experts].to(dt).reshape(g * n, w.shape[2], w.shape[3])


def moe_ffn_ragged(params, x: torch.Tensor, cfg):
    """Exact dispatch, no token dropped: x ``(G, B, S, D)`` -> ``(out,
    aux (G,))``."""
    g, b, s, d = x.shape
    k = cfg.moe.top_k
    act, dt = _ACTS[cfg.act], x.dtype
    t = b * s
    xt = x.reshape(g, t, d)
    probs, top_p, top_e = route(params, xt, cfg)
    # a token's copies in ascending expert order: the reference's scatter
    # adds them so
    experts, slot = torch.sort(top_e, dim=-1, stable=True)
    weight = torch.gather(top_p, -1, slot).to(dt)
    xc = xt[:, :, None, :].expand(g, t, k, d).reshape(g * t * k, 1, d)
    flat = experts.reshape(g, t * k)
    h = act(torch.bmm(xc, _rows_of(params["gate"], flat, dt))) * \
        torch.bmm(xc, _rows_of(params["up"], flat, dt))
    yo = torch.bmm(h, _rows_of(params["down"], flat, dt)).reshape(g, t, k, d)
    contrib = yo * weight[..., None]
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    if "shared" in params:
        out = out + _shared(params, xt, act)
    return out.reshape(g, b, s, d), aux_loss(probs, top_e, cfg)


def moe_ffn_gshard(params, x: torch.Tensor, cfg):
    """Capacity-based one-hot dispatch (GShard/Switch): copies beyond an
    expert's capacity are dropped. x ``(G, B, S, D)`` -> ``(out, aux
    (G,))``."""
    g, b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    act, dt = _ACTS[cfg.act], x.dtype
    t = b * s
    xt = x.reshape(g, t, d)
    probs, top_p, top_e = route(params, xt, cfg)
    cap = max(1, int(math.ceil(t * k / e * cfg.moe.capacity_factor)))
    onehot = torch.nn.functional.one_hot(top_e, e).float()     # (G,T,k,E)
    flat = onehot.reshape(g, t * k, e)
    pos_in_e = ((torch.cumsum(flat, dim=1) - 1.0) * flat).sum(-1)
    pos_in_e = pos_in_e.reshape(g, t, k)
    keep = (pos_in_e < cap).float()
    # one_hot(pos, cap): a dropped copy's row is all zeros
    cpos = (pos_in_e.long()[..., None] ==
            torch.arange(cap, device=x.device)).float()        # (G,T,k,C)
    disp = torch.einsum("gtke,gtkc->gtec", onehot * keep[..., None], cpos)
    comb = torch.einsum("gtke,gtkc->gtec",
                        onehot * (top_p * keep)[..., None], cpos)
    xin = torch.einsum("gtec,gtd->gecd", disp.to(dt), xt)
    hg = torch.einsum("gecd,gedf->gecf", xin, params["gate"].to(dt))
    hu = torch.einsum("gecd,gedf->gecf", xin, params["up"].to(dt))
    yo = torch.einsum("gecf,gefd->gecd", act(hg) * hu, params["down"].to(dt))
    out = torch.einsum("gtec,gecd->gtd", comb.to(dt), yo)
    if "shared" in params:
        out = out + _shared(params, xt, act)
    return out.reshape(g, b, s, d), aux_loss(probs, top_e, cfg)


def moe_ffn(params, x: torch.Tensor, cfg):
    """x ``(G, B, S, D)`` -> ``(out, aux (G,))``, by ``cfg.moe.impl``."""
    if cfg.moe.impl == "gshard":
        return moe_ffn_gshard(params, x, cfg)
    if cfg.moe.impl != "ragged":
        raise ValueError(f"moe impl {cfg.moe.impl!r}")
    return moe_ffn_ragged(params, x, cfg)

