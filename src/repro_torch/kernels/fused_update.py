"""Fused consensus + Langevin update, paper Eq. 9
(``repro/kernels/fused_update.py``):

    θ' = θ + ζ·(v̄ − v) + s·ξ

Rounding follows the reference as it executes: XLA's CPU backend contracts
the expression into ``fma(s, ξ, fma(ζ, v̄ − v, θ))`` (with ``s = 1`` the
outer fma is a plain add). The CUDA kernel (``csrc/fused_update.cu``) calls
``__fmaf_rn``; the plain version computes the same single-rounding fma
exactly in float64 (:func:`fma_f32`). Both are therefore bit-exact to the
reference's ``ops.fused_update`` and to its round's Eq. 9 ``tree_map``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check, library, on_card, stream_of


def fma_f32(a, b, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 ``a·b + c`` (one rounding, as ``fmaf``).

    The f32 product is exact in float64 (24 + 24 < 53 bits). The sum is
    rounded to odd in float64: the round-to-nearest sum, moved one ulp
    toward the exact value when it is inexact and its last bit is even
    (the error comes exactly from TwoSum). Rounding a round-to-odd float64
    to f32 is then correctly rounded (53 >= 24 + 2; Boldo & Melquiond).
    """
    p = torch.as_tensor(a, dtype=torch.float32, device=c.device).double() * \
        torch.as_tensor(b, dtype=torch.float32, device=c.device).double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def fused_update_plain(theta, vbar, v, noise, zeta: float,
                       noise_scale: float) -> torch.Tensor:
    return fma_f32(noise_scale, noise, fma_f32(zeta, vbar - v, theta))


def fused_update(theta, vbar, v, noise, zeta: float,
                 noise_scale: float) -> torch.Tensor:
    """Eq. 9 over same-shape f32 tensors; returns a new tensor."""
    if not on_card("fused_update", [(t, torch.float32)
                                    for t in (theta, vbar, v, noise)]):
        return fused_update_plain(theta, vbar, v, noise, zeta, noise_scale)
    if not theta.shape == vbar.shape == v.shape == noise.shape:
        raise ValueError("fused_update: operands differ in shape")
    out = torch.empty_like(theta)
    with torch.cuda.device(theta.device):
        rc = library().repro_fused_update(
            theta.data_ptr(), vbar.data_ptr(), v.data_ptr(), noise.data_ptr(),
            out.data_ptr(), theta.numel(), zeta, noise_scale,
            stream_of(theta))
    check(rc, "fused_update")
    fused_update.launches += 1
    return out


fused_update.launches = 0
