"""QSGD stochastic quantization (``repro/kernels/qsgd.py``), dense:

    out = sign(x) · q · ‖x‖ / s · r,   q = ⌊|x|/‖x‖·s⌋ + [u < frac],

with ``r`` the f32 reciprocal of ``1 + ω`` (:func:`inv_one_plus`): the
reference's kernel writes ``… / levels / (1.0 + omega)``, and XLA, which
executes it, folds the division by that constant into a multiplication by
its f32 reciprocal (checked against the reference on the CPU). ``s`` is a
power of two, so ``/ s`` is exact however it is computed. ``sign`` keeps a
zero's sign, as ``jnp.sign`` does (``torch.sign(-0.0)`` is ``+0.0``).

Each row of a ``(rows, n)`` operand (one node) has its own norm
``‖x‖₂ + 1e-12`` (:func:`row_norm`, a torch reduction between kernels, as
the reference's wrapper computes it in jnp). The uniforms ``u`` are an
input. The wrapper takes lists of leaves: on the card one launch covers a
table of up to ``MAX_TABLE_LEAVES`` leaves, each with its own norms and
``r``. A CPU tensor goes to the plain version, leaf by leaf, a CUDA tensor
to the kernel (``csrc/qsgd.cu``) or to an exception; ``.launches`` counts
launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels._build import check, library, on_card, stream_of
from repro_torch.kernels.pack import aligned_offsets, c_array, tables


def qsgd_omega(n: int, levels: int) -> float:
    """QSGD variance bound (Alistarh '17, Thm 3.2): ω = min(n/s², √n/s)."""
    return float(min(n / levels ** 2, np.sqrt(n) / levels))


def inv_one_plus(omega: float) -> float:
    """f32 ``1 / f32(1 + ω)``: the constant XLA multiplies by."""
    return float(np.float32(1.0) / np.float32(1.0 + omega))


def row_norm(x2d: torch.Tensor) -> torch.Tensor:
    """``‖row‖₂ + 1e-12`` of each row of a ``(rows, n)`` f32 tensor."""
    return torch.linalg.vector_norm(x2d, dim=1) + 1e-12


def qsgd_levels_plain(x: torch.Tensor, u: torch.Tensor, norm: torch.Tensor,
                      levels: int) -> torch.Tensor:
    """``lower + (u < scaled - lower)`` with ``scaled = |x| / norm · s``;
    ``norm`` is ``(rows,)``. A division by a tensor is a true division on
    every device."""
    scaled = x.abs() / norm[:, None] * levels
    lower = scaled.floor()
    return lower + (u < scaled - lower).to(x.dtype)


def qsgd_plain(x: torch.Tensor, u: torch.Tensor, norm: torch.Tensor,
               levels: int, recip: float) -> torch.Tensor:
    q = qsgd_levels_plain(x, u, norm, levels)
    sign = torch.where(x == 0, x, torch.sign(x))
    return sign * q * norm[:, None] / levels * recip


def qsgd(xs, us, norms, levels: int, recips):
    """Lists of ``(rows, n)`` f32 x and u, ``(rows,)`` f32 norms and f32
    reciprocals ``r`` -> a list of ``(rows, n)`` f32, one per leaf. On the
    card the outputs are ``PAYLOAD_ALIGN``-aligned views of one allocation;
    a leaf with no elements is left out of the launch."""
    if isinstance(xs, torch.Tensor):
        raise TypeError("qsgd takes lists of leaves")
    if not len(xs) == len(us) == len(norms) == len(recips):
        raise ValueError(f"qsgd: {len(xs)} xs, {len(us)} us, {len(norms)} "
                         f"norms, {len(recips)} recips")
    if not xs:
        return []
    if not on_card("qsgd", [(t, torch.float32) for leaf in zip(xs, us, norms)
                            for t in leaf]):
        return [qsgd_plain(x, u, norm, levels, r)
                for x, u, norm, r in zip(xs, us, norms, recips)]
    if levels < 1 or levels & (levels - 1):
        raise ValueError(f"qsgd: the CUDA kernel takes a power-of-two level "
                         f"count, got {levels}")
    for i, (x, u, norm) in enumerate(zip(xs, us, norms)):
        if x.dim() != 2 or u.shape != x.shape or norm.shape != x.shape[:1]:
            raise ValueError(f"qsgd: leaf {i}: x {tuple(x.shape)}, u "
                             f"{tuple(u.shape)}, norm {tuple(norm.shape)}")
    offs, end = aligned_offsets([x.numel() for x in xs])
    flat = torch.empty(end, dtype=torch.float32, device=xs[0].device)
    outs = [flat[o:o + x.numel()].view(x.shape) for o, x in zip(offs, xs)]
    live = [i for i, x in enumerate(xs) if x.numel()]
    with torch.cuda.device(xs[0].device):
        for part in tables(len(live)):
            ls = live[part]
            rc = library().repro_qsgd(
                *(c_array(ctypes.c_void_p, [ts[i].data_ptr() for i in ls])
                  for ts in (xs, us, norms, outs)),
                c_array(ctypes.c_longlong, [xs[i].shape[0] for i in ls]),
                c_array(ctypes.c_longlong, [xs[i].shape[1] for i in ls]),
                c_array(ctypes.c_float, [recips[i] for i in ls]), len(ls),
                float(levels), stream_of(xs[0]))
            check(rc, "qsgd")
            qsgd.launches += 1
    return outs


qsgd.launches = 0
