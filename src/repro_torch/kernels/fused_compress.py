"""Compress-in-update: the two kernels of the fused ``block_topk|qsgd``
encode (``repro/kernels/fused_compress.py``), both in
``csrc/fused_compress.cu``.

``delta_pack(theta, v)`` is ``pack_topk(theta - v)`` without writing the
residual: the CUDA kernel forms ``d = theta - v`` in registers and runs the
pack tile on it. The plain version forms the same f32 residual and runs the
same plain tile, so the two paths agree bit for bit.

``grid_quant(x, u, norm, levels)`` rounds the packed ``(rows, nb·k)``
carrier onto the signed QSGD grid, ``sign(x)·q`` as int8, with each row's
norm handed in (``ops.qsgd_quantize_carrier`` computes it between the two
kernels). Its level arithmetic is the dense QSGD's (``qsgd.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check, library, on_card, stream_of
from repro_torch.kernels.pack import (check_kernel_shape, empty_payload,
                                      pack_topk_plain)
from repro_torch.kernels.qsgd import qsgd_levels_plain


def delta_pack_plain(theta: torch.Tensor, v: torch.Tensor, k: int,
                     block_size: int = 1024):
    return pack_topk_plain(theta - v.to(theta.dtype), k, block_size)


def delta_pack(theta: torch.Tensor, v: torch.Tensor, k: int,
               block_size: int = 1024):
    """(theta, v) as (rows, n) f32 -> (vals (rows, nb, k), idx uint16)."""
    if not on_card("delta_pack", [(theta, torch.float32), (v, torch.float32)]):
        return delta_pack_plain(theta, v, k, block_size)
    check_kernel_shape("delta_pack", k, block_size)
    if theta.shape != v.shape:
        raise ValueError(f"delta_pack: theta {tuple(theta.shape)} vs v "
                         f"{tuple(v.shape)}")
    vals, idx = empty_payload(theta, k, block_size)
    rows, n = theta.shape
    with torch.cuda.device(theta.device):
        rc = library().repro_delta_pack(
            theta.data_ptr(), v.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            rows, n, vals.shape[1], k, stream_of(theta))
    check(rc, "delta_pack")
    delta_pack.launches += 1
    return vals, idx


delta_pack.launches = 0


def grid_quant_plain(x: torch.Tensor, u: torch.Tensor, norm: torch.Tensor,
                     levels: int) -> torch.Tensor:
    q = qsgd_levels_plain(x, u, norm, levels)
    return (torch.sign(x) * q).to(torch.int8)


def grid_quant(x: torch.Tensor, u: torch.Tensor, norm: torch.Tensor,
               levels: int) -> torch.Tensor:
    """(rows, m) f32 carrier and uniforms, (rows,) f32 norm -> (rows, m)
    int8 grid."""
    if not on_card("grid_quant", [(x, torch.float32), (u, torch.float32),
                                  (norm, torch.float32)]):
        return grid_quant_plain(x, u, norm, levels)
    rows, m = x.shape
    if u.shape != x.shape or norm.shape != (rows,) or not 1 <= levels <= 127:
        raise ValueError(f"grid_quant: x {tuple(x.shape)}, u {tuple(u.shape)}, "
                         f"norm {tuple(norm.shape)}, levels {levels}")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = library().repro_grid_quant(x.data_ptr(), u.data_ptr(),
                                        norm.data_ptr(), q.data_ptr(), rows, m,
                                        float(levels), stream_of(x))
    check(rc, "grid_quant")
    grid_quant.launches += 1
    return q


grid_quant.launches = 0
