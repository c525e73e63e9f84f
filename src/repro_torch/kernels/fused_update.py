"""Fused consensus + Langevin update, paper Eq. 9
(``repro/kernels/fused_update.py``):

    θ' = θ + ζ·(v̄ − v) + s·ξ

Rounding follows the reference as it executes: XLA's CPU backend contracts
the expression into ``fma(s, ξ, fma(ζ, v̄ − v, θ))`` (with ``s = 1`` the
outer fma is a plain add). The CUDA kernel (``csrc/fused_update.cu``) calls
``__fmaf_rn``; the plain version computes the same single-rounding fma
exactly in float64 (:func:`fma_f32`). Both are therefore bit-exact to the
reference's ``ops.fused_update`` and to its round's Eq. 9 ``tree_map``.

Two variants of the same kernel compute the baselines' updates, each as
XLA's CPU code contracts the reference's jitted ``tree_map`` (ROADMAP C10):
:func:`cffl_update`, CF-FL's ``θ + ζ·(v̄ − v)`` as ``fma(ζ, v̄ − v, θ)``
(``algorithms.py:602-608``), and :func:`dsgld_update`, DSGLD's ``m − η·g +
ξ`` as ``fma(−η, g, m) + ξ`` (``algorithms.py:515-520``; the SGLD step's
too). The reference has no ``pl.pallas_call`` for them.

:func:`gossip_mix` is the gossip mixers' chain of those fmas over the node
axis (ROADMAP C16): ``fma(w, x[perm] − x, a)`` a matching, ``fma(c,
roll(x, −s), a)`` a shift, or the ring's ``fma(ω₀₀, x, ω₀₁·(roll(x, 1) +
roll(x, −1)))``, as XLA's CPU code contracts the reference's
``schedule_mix``, ``_roll_mix`` and ``ring_mix``; no ``pl.pallas_call``
either. Its kernel (``csrc/gossip_mix.cu``) mixes a table of leaves in one
launch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels._build import check, library, on_card, stream_of
from repro_torch.kernels.pack import c_array, tables


def fma_f32(a, b, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 ``a·b + c`` (one rounding, as ``fmaf``).

    The f32 product is exact in float64 (24 + 24 < 53 bits). The sum is
    rounded to odd in float64: the round-to-nearest sum, moved one ulp
    toward the exact value when it is inexact and its last bit is even
    (the error comes exactly from TwoSum). Rounding a round-to-odd float64
    to f32 is then correctly rounded (53 >= 24 + 2; Boldo & Melquiond).
    A non-finite sum (an infinite or NaN operand) is the float64 sum as it
    is: ±inf or NaN, as ``fmaf`` gives it.
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
    s = torch.where((err != 0) & even & torch.isfinite(s),
                    torch.nextafter(s, toward), s)
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


def cffl_update_plain(theta, vbar, v, zeta: float) -> torch.Tensor:
    return fma_f32(zeta, vbar - v, theta)


def dsgld_update_plain(mixed, grad, noise, eta: float) -> torch.Tensor:
    return fma_f32(-eta, grad, mixed) + noise


def _variant(name: str, entry: str, wrapper, operands, scalar: float):
    if not on_card(name, [(t, torch.float32) for t in operands]):
        return None
    if any(t.shape != operands[0].shape for t in operands):
        raise ValueError(f"{name}: operands differ in shape")
    out = torch.empty_like(operands[0])
    with torch.cuda.device(out.device):
        rc = getattr(library(), entry)(
            *(t.data_ptr() for t in operands), out.data_ptr(), out.numel(),
            scalar, stream_of(out))
    check(rc, name)
    wrapper.launches += 1
    return out


def cffl_update(theta, vbar, v, zeta: float) -> torch.Tensor:
    """CF-FL's update ``θ + ζ·(v̄ − v)`` over same-shape f32 tensors."""
    out = _variant("cffl_update", "repro_cffl_update", cffl_update,
                   (theta, vbar, v), zeta)
    return cffl_update_plain(theta, vbar, v, zeta) if out is None else out


def dsgld_update(mixed, grad, noise, eta: float) -> torch.Tensor:
    """DSGLD's update ``m − η·g + ξ`` over same-shape f32 tensors."""
    out = _variant("dsgld_update", "repro_dsgld_update", dsgld_update,
                   (mixed, grad, noise), eta)
    return dsgld_update_plain(mixed, grad, noise, eta) if out is None else out


cffl_update.launches = 0
dsgld_update.launches = 0


LAPLACIAN, CIRCULANT, RING = "laplacian", "circulant", "ring"
FORMS = (LAPLACIAN, CIRCULANT, RING)      # csrc/gossip_mix.cu: kLaplacian..


def gossip_mix_plain(x, src, w, c0: float, form: str) -> torch.Tensor:
    """The mixers' fma chain over the node axis of ``x`` (K, ...), for each
    row m of the ``(M, K)`` sources and weights (ROADMAP C16): Laplacian,
    ``a = x``, then ``a = fma(w[m], x[src[m]] − x, a)``; circulant, ``a =
    c0·x``, then ``a = fma(w[m], x[src[m]], a)``; ring (M = 2), ``fma(c0,
    x, w[0]·(x[src[0]] + x[src[1]]))``."""
    flat = x.reshape(x.shape[0], -1)
    c0 = float(np.float32(c0))
    if form == RING:
        pair = flat.index_select(0, src[0].long()) + \
            flat.index_select(0, src[1].long())
        return fma_f32(c0, flat, w[0][:, None] * pair).reshape(x.shape)
    laplacian = form == LAPLACIAN
    out = flat if laplacian else flat * c0
    for m in range(src.shape[0]):
        peer = flat.index_select(0, src[m].long())
        out = fma_f32(w[m][:, None], peer - flat if laplacian else peer, out)
    return out.reshape(x.shape)


def _check_mix(xs, src, w, form: str) -> None:
    if form not in FORMS:
        raise ValueError(f"gossip_mix: form {form!r} is none of {FORMS}")
    rows = xs[0].shape[0] if xs[0].dim() else None
    for i, x in enumerate(xs):
        if x.dim() == 0 or x.shape[0] != rows:
            raise ValueError(f"gossip_mix: leaf {i} has shape "
                             f"{tuple(x.shape)}; every leaf must lead with "
                             f"the K={rows} rows of leaf 0")
    if src.dim() != 2 or src.shape != w.shape or src.shape[1] != rows \
            or (form == RING and src.shape[0] != 2):
        raise ValueError(f"gossip_mix: sources {tuple(src.shape)} and "
                         f"weights {tuple(w.shape)} for the {rows} rows of "
                         f"leaves 0-{len(xs) - 1}: both must be (M, {rows})"
                         + (", M = 2 in the ring form" if form == RING
                            else ""))


def gossip_mix(xs, src, w, c0: float, form: str):
    """One mix of a list of leaves ``(K, ...)`` f32 with the same K over
    ``M`` matchings or shifts: ``src`` (M, K) int32 source rows, ``w`` (M,
    K) f32 weights, on the leaves' device, in ``form`` (see
    :func:`gossip_mix_plain`). Returns a list, each output a tensor of its
    own. On the card one launch mixes a table of up to
    ``MAX_TABLE_LEAVES`` leaves."""
    if isinstance(xs, torch.Tensor):
        raise TypeError("gossip_mix takes a list of leaves")
    if not xs:
        return []
    _check_mix(xs, src, w, form)
    if not on_card("gossip_mix", [(x, torch.float32) for x in xs]
                   + [(src, torch.int32), (w, torch.float32)]):
        return [gossip_mix_plain(x, src, w, c0, form) for x in xs]
    rows = xs[0].shape[0]
    outs = [torch.empty_like(x) for x in xs]
    with torch.cuda.device(xs[0].device):
        for part in tables(len(xs)):
            rc = library().repro_gossip_mix(
                c_array(ctypes.c_void_p, [x.data_ptr() for x in xs[part]]),
                c_array(ctypes.c_void_p, [o.data_ptr() for o in outs[part]]),
                c_array(ctypes.c_longlong,
                        [x.numel() // max(rows, 1) for x in xs[part]]),
                len(xs[part]), rows, src.data_ptr(), w.data_ptr(),
                src.shape[0], FORMS.index(form), float(np.float32(c0)),
                stream_of(xs[0]))
            check(rc, "gossip_mix")
            gossip_mix.launches += 1
    return outs


gossip_mix.launches = 0
