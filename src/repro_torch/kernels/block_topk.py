"""Dense masked block top-k (``repro/kernels/block_topk.py``).

``block_topk(x, k)`` keeps, in every ``block_size`` block of each row of a
``(rows, n)`` tensor, the ``k`` elements that pack would pack (the same
40-step bisection and two-tier tie rule) and zeroes the rest; the output is
dense, ``(rows, n)``. The ragged last block is padded with zeros, which can
be picked as ties, and positions at or past ``n`` are dropped, as the
reference's wrapper drops them (``ops.py:43-50``).

The plain version shares the selection with pack's (:func:`two_tier_ranks`)
and keeps ``mask_def | (mask_tie & pos_tie < k)``, the reference's mask: a
block holding a NaN keeps its first ``k`` non-NaN elements and zeroes the
NaN, and a block with ``k`` or more ±inf keeps every one of them (ROADMAP
C6). A CPU tensor goes to it, a CUDA tensor to the kernel
(``csrc/block_topk.cu``) or to an exception; ``.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check, library, on_card, stream_of
from repro_torch.kernels.pack import (check_kernel_shape, num_blocks,
                                      to_blocks, two_tier_ranks)


def block_topk_plain(x: torch.Tensor, k: int,
                     block_size: int = 1024) -> torch.Tensor:
    rows, n = x.shape
    blocks = to_blocks(x, block_size)
    mask_def, mask_tie, _, pos_tie = two_tier_ranks(blocks, k)
    keep = mask_def | (mask_tie & (pos_tie < k))
    dense = torch.where(keep, blocks, torch.zeros_like(blocks))
    return dense.reshape(rows, -1)[:, :n].contiguous()


def block_topk(x: torch.Tensor, k: int, block_size: int = 1024) -> torch.Tensor:
    """(rows, n) f32 -> (rows, n) f32, top-k of every block kept."""
    if not on_card("block_topk", [(x, torch.float32)]):
        return block_topk_plain(x, k, block_size)
    check_kernel_shape("block_topk", k, block_size)
    rows, n = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = library().repro_block_topk(x.data_ptr(), out.data_ptr(), rows, n,
                                        num_blocks(n, block_size), k,
                                        stream_of(x))
    check(rc, "block_topk")
    block_topk.launches += 1
    return out


block_topk.launches = 0
