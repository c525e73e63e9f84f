"""Leaf-level entry points over node-stacked leaves (``repro/kernels/ops.py``).

A leaf ``(K, *shape)`` is handed to the kernels as a ``(K, n)`` view, so one
launch covers every node. The reference's padding of the block rows to its
8-row TPU tile is not needed here: the kernels mask the ragged block
themselves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.fused_compress import delta_pack
from repro_torch.kernels.fused_update import fused_update
from repro_torch.kernels.pack import pack_topk, unpack_topk


def survivors_per_block(ratio: float, block_size: int) -> int:
    return max(1, int(np.ceil(ratio * block_size)))


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def block_topk_pack(x: torch.Tensor, ratio: float = 0.01,
                    block_size: int = 1024):
    """(K, *shape) -> (vals (K, nb, k) f32, idx (K, nb, k) uint16)."""
    assert block_size <= 65536, "uint16 block-local indices"
    return pack_topk(_rows(x), survivors_per_block(ratio, block_size),
                     block_size)


def fused_delta_pack(theta: torch.Tensor, v: torch.Tensor, ratio: float = 0.01,
                     block_size: int = 1024):
    """``block_topk_pack(theta - v)`` without writing the residual."""
    assert block_size <= 65536, "uint16 block-local indices"
    return delta_pack(_rows(theta), _rows(v.to(theta.dtype)),
                      survivors_per_block(ratio, block_size), block_size)


def block_topk_unpack(vals: torch.Tensor, idx: torch.Tensor, shape,
                      block_size: int = 1024) -> torch.Tensor:
    """Scatter a packed payload back to dense ``(K, *shape)`` leaves."""
    n = int(np.prod(shape))
    return unpack_topk(vals, idx, n, block_size).reshape(
        (vals.shape[0],) + tuple(shape))


def leaf_fused_update(theta, vbar, v, noise, zeta: float,
                      noise_scale: float) -> torch.Tensor:
    return fused_update(theta, vbar.to(theta.dtype), v.to(theta.dtype),
                        noise, zeta, noise_scale)
