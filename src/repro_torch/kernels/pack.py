"""Block-top-k wire format: pack and unpack (``repro/kernels/pack.py``).

Each leaf is handled as a ``(rows, n)`` tensor, one row per node, cut into
``nb = ceil(n / block_size)`` blocks; the ragged last block is padded with
zeros. Pack keeps ``k`` survivors per block as ``(rows, nb, k)`` f32 values
and uint16 block-local indices; unpack scatters them back.

Beside each kernel wrapper is its plain PyTorch version, which transcribes
the reference's arithmetic (``_pack_tile``: 40-step bisection, definite and
tie masks, cumulative-sum ranks). A CPU tensor goes to the plain version, a
CUDA tensor to the kernel (``csrc/pack.cu``) or to an exception. Each
wrapper counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import check, library, on_card, stream_of

BISECT_ITERS = 40
KERNEL_BLOCK = 1024          # the CUDA kernels hold one block per warp


def num_blocks(n: int, block_size: int) -> int:
    return max(1, -(-n // block_size))


def two_tier_ranks(x2d: torch.Tensor, k: int):
    """``_pack_tile``'s selection on ``(rows, bs)`` blocks (40-step
    bisection, then the two-tier rank), shared with the dense block top-k:
    the definite and tie masks and each element's rank within its tier."""
    mag = x2d.abs()
    hi = mag.amax(dim=1, keepdim=True) + 1.0         # count(mag >= hi) < k
    lo = torch.zeros_like(hi)                        # count(mag >= lo) >= k
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        pred = (mag >= mid).sum(dim=1, keepdim=True) >= k
        lo, hi = torch.where(pred, mid, lo), torch.where(pred, hi, mid)
    # two-tier rank: definite survivors first, then ties in index order
    mask_def = mag >= hi
    mask_tie = (mag >= lo) & ~mask_def
    n_def = mask_def.sum(dim=1, keepdim=True)
    pos_def = mask_def.cumsum(dim=1) - 1
    pos_tie = n_def + mask_tie.cumsum(dim=1) - 1
    return mask_def, mask_tie, pos_def, pos_tie


def pack_tile_plain(x2d: torch.Tensor, k: int):
    """``_pack_tile`` on ``(rows, bs)`` blocks -> (vals f32, idx int64)."""
    rows, bs = x2d.shape
    mask_def, mask_tie, pos_def, pos_tie = two_tier_ranks(x2d, k)
    pos = torch.where(mask_def, pos_def, torch.where(mask_tie, pos_tie, bs))
    # ranks past k (and non-survivors) land in a spare column, dropped below
    slot = torch.clamp(pos, max=k)
    cols = torch.arange(bs, device=x2d.device).expand(rows, bs)
    vals = x2d.new_zeros((rows, k + 1)).scatter_(1, slot, x2d)[:, :k]
    idx = torch.zeros((rows, k + 1), dtype=torch.int64, device=x2d.device)
    idx = idx.scatter_(1, slot, cols)[:, :k]
    return vals, idx


# uint16 is a bare dtype in PyTorch (few kernels, on CUDA fewer still): the
# conversions go through int16 views, which every backend supports
def to_uint16(idx: torch.Tensor) -> torch.Tensor:
    return idx.to(torch.int32).to(torch.int16).view(torch.uint16)


def from_uint16(idx: torch.Tensor) -> torch.Tensor:
    return idx.view(torch.int16).long() & 0xFFFF


def to_blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """(rows, n) -> zero-padded (rows·nb, block_size)."""
    rows, n = x.shape
    nb = num_blocks(n, block_size)
    return F.pad(x, (0, nb * block_size - n)).reshape(rows * nb, block_size)


def pack_topk_plain(x: torch.Tensor, k: int, block_size: int = 1024):
    rows, n = x.shape
    vals, idx = pack_tile_plain(to_blocks(x, block_size), k)
    nb = num_blocks(n, block_size)
    return vals.reshape(rows, nb, k), to_uint16(idx).reshape(rows, nb, k)


def empty_payload(x: torch.Tensor, k: int, block_size: int):
    rows, n = x.shape
    shape = (rows, num_blocks(n, block_size), k)
    return (torch.empty(shape, dtype=torch.float32, device=x.device),
            torch.empty(shape, dtype=torch.uint16, device=x.device))


def check_kernel_shape(kernel: str, k: int, block_size: int) -> None:
    if block_size != KERNEL_BLOCK or not 1 <= k <= block_size:
        raise ValueError(f"{kernel}: the CUDA kernel takes block_size="
                         f"{KERNEL_BLOCK} and 1 <= k <= block_size, got "
                         f"block_size={block_size}, k={k}")


def pack_topk(x: torch.Tensor, k: int, block_size: int = 1024):
    """(rows, n) f32 -> (vals (rows, nb, k) f32, idx (rows, nb, k) uint16)."""
    if not on_card("pack_topk", [(x, torch.float32)]):
        return pack_topk_plain(x, k, block_size)
    check_kernel_shape("pack_topk", k, block_size)
    vals, idx = empty_payload(x, k, block_size)
    rows, n = x.shape
    with torch.cuda.device(x.device):
        rc = library().repro_pack_topk(
            x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, n,
            vals.shape[1], k, stream_of(x))
    check(rc, "pack_topk")
    pack_topk.launches += 1
    return vals, idx


pack_topk.launches = 0


def unpack_topk_plain(vals: torch.Tensor, idx: torch.Tensor, n: int,
                      block_size: int = 1024) -> torch.Tensor:
    rows, nb, k = vals.shape
    dense = vals.new_zeros((rows * nb, block_size))
    dense.scatter_(1, from_uint16(idx).reshape(rows * nb, k),
                   vals.reshape(rows * nb, k))
    return dense.reshape(rows, nb * block_size)[:, :n].contiguous()


def unpack_topk(vals: torch.Tensor, idx: torch.Tensor, n: int,
                block_size: int = 1024) -> torch.Tensor:
    """(vals (rows, nb, k), idx uint16) -> dense (rows, n) f32."""
    if not on_card("unpack_topk", [(vals, torch.float32), (idx, torch.uint16)]):
        return unpack_topk_plain(vals, idx, n, block_size)
    rows, nb, k = vals.shape
    check_kernel_shape("unpack_topk", k, block_size)
    if idx.shape != vals.shape or nb != num_blocks(n, block_size):
        raise ValueError(f"unpack_topk: vals {tuple(vals.shape)}, idx "
                         f"{tuple(idx.shape)} do not fit n={n}")
    out = torch.empty((rows, n), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        rc = library().repro_unpack_topk(
            vals.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, n, nb, k,
            stream_of(vals))
    check(rc, "unpack_topk")
    unpack_topk.launches += 1
    return out


unpack_topk.launches = 0
