"""Shared layers of the decoder zoo (``repro/models/layers.py:25-104``).

Parameters are nested dicts of f32 tensors, stored as the reference stores
them; an apply function casts each to the compute dtype of its input at
use (``cfg.dtype``), as the reference does. Every apply function here is
elementwise or row-wise, so it takes any leading axes, the port's group
axis ``G`` (the samples of a bank) among them; a weight with a leading
``G`` multiplies its group's rows (``torch.bmm``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch

from repro_torch import random
from repro_torch.utils.device import device_const

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(dtype) -> torch.dtype:
    """``cfg.dtype`` (a name, as the reference's configs give it) as a
    torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return DTYPES[str(dtype)]


@contextlib.contextmanager
def f32_sums():
    """Matrix products on the card summed in full f32, as XLA sums the
    reference's: no TF32 for f32 products and no reduced-precision
    reductions for bf16 and f16 ones, whatever the process has set (torch
    allows the latter by default). cuBLAS reads the flags at each call, and
    a CUDA graph keeps what its capture chose; restored on exit."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
             m.allow_fp16_reduced_precision_reduction)
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    m.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
         m.allow_fp16_reduced_precision_reduction) = saved


@random.program
def dense_init(key: torch.Tensor, in_dim: int, out_shape, scale: float = 1.0):
    """Truncated-normal fan-in init, as ``dense_init``: ``std ·
    truncated_normal(key, −2, 2, (in_dim, *out_shape))``, the product a
    separate f32 multiply (the reference runs it eagerly)."""
    return (yield from random.truncated_normal.program(
        key, -2.0, 2.0, (in_dim,) + tuple(out_shape),
        scale=scale / math.sqrt(in_dim)))


@random.program
def embed_init(key: torch.Tensor, vocab: int, d: int):
    """``normal(key, (vocab, d)) * 0.02``: the normal, then its own f32
    multiply (not folded into the draw's constant as inside ``jit``)."""
    return (yield from random.normal.program(key, (vocab, d))) * 0.02


def init_rmsnorm(d: int, device, lead=()) -> Dict:
    return {"scale": torch.ones(tuple(lead) + (d,), device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · scale`` in f32, back in ``x``'s dtype.
    ``params['scale']`` is ``(D,)`` or ``(G, D)`` against ``x`` ``(G, ...,
    D)``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    scale = params["scale"].float()
    if scale.dim() == 2:
        scale = scale.reshape(scale.shape[:1] + (1,) * (x.dim() - 2)
                              + scale.shape[1:])
    return (out * scale).to(x.dtype)


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mean and (biased) variance in f32, then scale and bias."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """``1 / theta^(2i / hd)`` in f32, computed once on the host and kept
    on ``device`` (a captured step copies nothing to the card)."""
    def make():
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
        return 1.0 / (torch.tensor(theta, dtype=torch.float32) ** exps)
    return device_const(("rope", head_dim, float(theta)), device, make)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """``(cos, sin)`` of the rotation angles, ``(..., S, 1, hd/2)`` f32, for
    positions ``(..., S)``: a forward computes them once for all layers."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * freqs              # (..., S, hd/2)
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               angles=None) -> torch.Tensor:
    """x ``(..., S, H, hd)``; positions ``(..., S)`` integers (broadcast
    against x's leading axes), or their :func:`rope_angles` as ``angles``.
    Halves rotated in f32, back in x's dtype."""
    cos, sin = angles if angles is not None else rope_angles(
        positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


_ACTS = {"silu": lambda x: x * torch.sigmoid(x),
         "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
         "relu": torch.relu}


@random.program
def init_mlp(key: torch.Tensor, d: int, d_ff: int):
    """``gate``, ``up`` ``(d, d_ff)`` and ``down`` ``(d_ff, d)`` from
    ``split(key, 3)``; keys with leading axes give leaves with them."""
    ks = yield from random.split.program(key, 3)
    gate, up, down = yield from random.together(
        dense_init.program(ks[..., 0, :], d, (d_ff,)),
        dense_init.program(ks[..., 1, :], d, (d_ff,)),
        dense_init.program(ks[..., 2, :], d_ff, (d,)))
    return {"gate": gate, "up": up, "down": down}


def mlp(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP ``(act(x W_g) ⊙ x W_u) W_d`` with ``(G, ...)`` weights
    against ``x`` ``(G, N, D)``; each activation rounded to ``x``'s dtype
    op by op, as XLA rounds the reference's (``x · sigmoid(x)``: two
    roundings)."""
    dt = x.dtype
    g = _ACTS[act](torch.bmm(x, params["gate"].to(dt)))
    u = torch.bmm(x, params["up"].to(dt))
    return torch.bmm(g * u, params["down"].to(dt))
