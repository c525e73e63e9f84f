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
input. A CPU tensor goes to the plain version, a CUDA tensor to the kernel
(``csrc/qsgd.cu``) or to an exception; ``.launches`` counts launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels._build import check, library, on_card, stream_of


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


def qsgd(x: torch.Tensor, u: torch.Tensor, norm: torch.Tensor, levels: int,
         recip: float) -> torch.Tensor:
    """(rows, n) f32 x and u, (rows,) f32 norm -> (rows, n) f32."""
    if not on_card("qsgd", [(x, torch.float32), (u, torch.float32),
                            (norm, torch.float32)]):
        return qsgd_plain(x, u, norm, levels, recip)
    rows, n = x.shape
    if u.shape != x.shape or norm.shape != (rows,):
        raise ValueError(f"qsgd: x {tuple(x.shape)}, u {tuple(u.shape)}, "
                         f"norm {tuple(norm.shape)}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = library().repro_qsgd(x.data_ptr(), u.data_ptr(), norm.data_ptr(),
                                  out.data_ptr(), rows, n, float(levels),
                                  recip, stream_of(x))
    check(rc, "qsgd")
    qsgd.launches += 1
    return out


qsgd.launches = 0
