"""Compress-in-update: delta-pack (``repro/kernels/fused_compress.py``).

``delta_pack(theta, v)`` is ``pack_topk(theta - v)`` without writing the
residual: the CUDA kernel (``csrc/fused_compress.cu``) forms
``d = theta - v`` in registers and runs the pack tile on it. The plain
version forms the same f32 residual and runs the same plain tile, so the
two paths agree bit for bit.

The reference's QSGD grid kernel (``grid_quant_pallas``) of this module is
not ported yet (ROADMAP B5).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check, library, on_card, stream_of
from repro_torch.kernels.pack import (check_kernel_shape, empty_payload,
                                      pack_topk_plain)


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
