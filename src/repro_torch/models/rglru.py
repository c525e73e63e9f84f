"""The RG-LRU recurrent block of Griffin / RecurrentGemma
(``repro/models/rglru.py:29-132``)::

    x -> in_proj -> [gate branch (GeLU)] x [conv1d(4) -> RG-LRU] -> out_proj

    r_t = sigmoid(W_a u_t + b_a)              recurrence gate
    i_t = sigmoid(W_x u_t + b_x)              input gate
    a_t = exp(-c * softplus(Lambda) * r_t)    per-channel decay, c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Shapes carry the port's group axis ``G`` first: x ``(G, B, S, D)``, weights
``(G, ...)``. Training and prefill take the recurrence as the reference's
``jax.lax.associative_scan`` (:func:`lru_scan`: its even/odd recursion,
transcribed, so the port adds in the reference's order, in log depth on
the card); decode keeps ``(h, conv window)`` a lane, f32 whatever the
cache dtype, updated in place.

Two facts of XLA's CPU code that the transcription follows or states
(ROADMAP C38, C39): under ``jit`` XLA contracts the scan's ``a2·b1 + b2``
into one fma (the port takes :func:`~repro_torch.kernels.threefry._fma`);
and its ``expm1`` in ``a_param``'s init is not correctly rounded, where
the port's is (float64, rounded once), so ``a_param`` is within a few f32
ulps of the reference's and every other leaf of the init is bit for bit.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import random
from repro_torch.kernels.threefry import _fma, log_plain
from repro_torch.models.attention import _proj
from repro_torch.models.chunked import chunked_lru, use_chunked
from repro_torch.models.layers import dense_init

_C = 8.0
_CONV_K = 4


def expm1(x: torch.Tensor) -> torch.Tensor:
    """``exp(x) − 1`` correctly rounded to f32 (float64, rounded once)."""
    return torch.expm1(x.double()).float()


@random.program
def init_rglru_block(key: torch.Tensor, cfg):
    """``split(key, 6)``: Λ from a uniform in [0.9, 0.999) (the decay
    ``a ~ U(0.9, 0.999)`` at r = 1), ``in_proj``, the depthwise conv's
    ``0.1 · normal``, ``wa``, ``wx`` and ``out_proj``; zero biases. Keys
    with leading axes give leaves with them."""
    d = cfg.d_model
    dr = cfg.rglru_dim or d
    ks = yield from random.split.program(key, 6)
    u, in_proj, conv, wa, wx, out_proj = yield from random.together(
        random.uniform.program(ks[..., 0, :], (dr,), 0.9, 0.999),
        dense_init.program(ks[..., 1, :], d, (2 * dr,)),
        random.normal.program(ks[..., 2, :], (_CONV_K, dr)),
        dense_init.program(ks[..., 3, :], dr, (dr,)),
        dense_init.program(ks[..., 4, :], dr, (dr,)),
        dense_init.program(ks[..., 5, :], dr, (d,)))
    lead = tuple(key.shape[:-1])

    def zeros():
        return torch.zeros(lead + (dr,), device=key.device)
    # softplus^-1(-log u / c), each op as the reference's eager ops round it
    lam = log_plain(expm1(-log_plain(u) / _C))
    return {"in_proj": in_proj, "conv_w": conv * 0.1, "conv_b": zeros(),
            "a_param": lam, "wa": wa, "ba": zeros(), "wx": wx,
            "bx": zeros(), "out_proj": out_proj}


def _bcast(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``(G, C)`` leaf shaped to broadcast against ``x`` ``(G, ..., C)``."""
    return w.reshape(w.shape[:1] + (1,) * (x.dim() - 2) + w.shape[1:])


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state=None):
    """u ``(G, B, S, C)``; w ``(G, K, C)`` a depthwise causal conv; state
    ``(G, B, K−1, C)`` for decode. Returns ``(out, the last K−1
    inputs)``."""
    k, s, dt = w.shape[1], u.shape[2], u.dtype
    if state is None:
        pad = u.new_zeros(u.shape[:2] + (k - 1,) + u.shape[3:])
    else:
        pad = state.to(dt)
    ext = torch.cat([pad, u], dim=2)                  # (G, B, S+K-1, C)
    wd = w.to(dt)
    out = ext[:, :, 0:s] * wd[:, None, None, 0]
    for i in range(1, k):
        out = out + ext[:, :, i:i + s] * wd[:, None, None, i]
    return out + _bcast(b.to(dt), out), ext[:, :, ext.shape[2] - (k - 1):]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _gates(params, u: torch.Tensor):
    """The decay ``a`` and the gated input ``b`` of the recurrence, f32."""
    dt = u.dtype
    r = torch.sigmoid(_proj(u, params["wa"]) + _bcast(params["ba"].to(dt), u))
    i = torch.sigmoid(_proj(u, params["wx"]) + _bcast(params["bx"].to(dt), u))
    log_a = _bcast(-_C * softplus(params["a_param"].float()), u) * r.float()
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i.float() * u.float())
    return a, gated


def _slice(x: torch.Tensor, dim: int, start: int, stop=None, step: int = 1):
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


class _Fma(torch.autograd.Function):
    """:func:`~repro_torch.kernels.threefry._fma` (one rounding) forward;
    the backward of ``a·b + c``, each gradient summed to its operand's
    shape."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        ctx.c_shape = c.shape
        return _fma(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return ((g * b).sum_to_size(a.shape), (g * a).sum_to_size(b.shape),
                g.sum_to_size(ctx.c_shape))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a·b + c`` rounded once, as XLA's contracted code computes it,
    with a gradient."""
    return _Fma.apply(a, b, c)


def _combine(first, second):
    """The recurrence's associative operator: ``(a1·a2, fma(a2, b1, b2))``
    (XLA contracts the reference's ``a2 * b1 + b2`` under ``jit``)."""
    a1, b1 = first
    a2, b2 = second
    return a1 * a2, fma(a2, b1, b2)


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int):
    """``even[0], odd[0], even[1], ...`` along ``dim``, as XLA's pads and
    add: each value plus +0 (a −0 comes out +0)."""
    shape = list(even.shape)
    shape[dim] += odd.shape[dim]
    out = even.new_zeros(shape)
    _slice(out, dim, 0, None, 2).copy_(even)
    _slice(out, dim, 1, None, 2).copy_(odd)
    return out + 0.0


def lru_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """``jax.lax.associative_scan`` of :func:`_combine` over ``dim``: the
    reference's even/odd recursion (jax 0.9.0, ``lax/control_flow/
    loops.py``), op for op. Returns ``(a_cum, h)``."""
    n = a.shape[dim]
    if n < 2:
        return a, b
    ra, rb = _combine(
        (_slice(a, dim, 0, n - 1, 2), _slice(b, dim, 0, n - 1, 2)),
        (_slice(a, dim, 1, None, 2), _slice(b, dim, 1, None, 2)))
    oa, ob = lru_scan(ra, rb, dim)
    if n % 2 == 0:
        ea, eb = _combine((_slice(oa, dim, 0, -1), _slice(ob, dim, 0, -1)),
                          (_slice(a, dim, 2, None, 2),
                           _slice(b, dim, 2, None, 2)))
    else:
        ea, eb = _combine((oa, ob), (_slice(a, dim, 2, None, 2),
                                     _slice(b, dim, 2, None, 2)))
    ea = torch.cat([_slice(a, dim, 0, 1), ea], dim=dim)
    eb = torch.cat([_slice(b, dim, 0, 1), eb], dim=dim)
    return _interleave(ea, oa, dim), _interleave(eb, ob, dim)


def rglru_scan(params, u: torch.Tensor) -> torch.Tensor:
    """u ``(G, B, S, C)`` -> h ``(G, B, S, C)`` in u's dtype, by the
    associative scan over the sequence."""
    a, b = _gates(params, u)
    return lru_scan(a, b, 2)[1].to(u.dtype)


def rglru_block(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The recurrent block, training and prefill: x ``(G, B, S, D)``. At
    ``S >= 2 · chunk_size``, S a multiple of it, the recurrence runs
    chunked (``chunked.chunked_lru``), as the reference's."""
    dt = x.dtype
    s = x.shape[2]
    gate, rec = _proj(x, params["in_proj"]).chunk(2, dim=-1)
    rec, _ = _causal_conv(rec, params["conv_w"], params["conv_b"])
    if use_chunked(cfg, s):
        a, b = _gates(params, rec)
        h = chunked_lru(a, b, chunk=cfg.chunk_size).to(dt)
    else:
        h = rglru_scan(params, rec)
    y = torch.nn.functional.gelu(gate, approximate="tanh") * h
    return _proj(y, params["out_proj"])


def init_rglru_state(cfg, lanes, device="cpu") -> Dict:
    """A lane's ``h`` ``(dr,)`` and conv window ``(3, dr)``, zero, f32, for
    each lane of ``lanes``."""
    dr = cfg.rglru_dim or cfg.d_model
    lanes = tuple(lanes)
    return {"h": torch.zeros(lanes + (dr,), device=device),
            "conv": torch.zeros(lanes + (_CONV_K - 1, dr), device=device)}


def rglru_block_decode(params, state, x: torch.Tensor, cfg):
    """One token a lane: x ``(G, B, 1, D)`` -> ``(state, y (G, B, 1, D))``,
    the state updated in place."""
    dt = x.dtype
    gate, rec = _proj(x, params["in_proj"]).chunk(2, dim=-1)
    rec, conv = _causal_conv(rec, params["conv_w"], params["conv_b"],
                             state=state["conv"])
    a, b = _gates(params, rec)
    h = fma(a[:, :, 0], state["h"].float(), b[:, :, 0])
    y = torch.nn.functional.gelu(gate, approximate="tanh") * \
        h[:, :, None].to(dt)
    out = _proj(y, params["out_proj"])
    state["h"].copy_(h)
    state["conv"].copy_(conv)
    return state, out
