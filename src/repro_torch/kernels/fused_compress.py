"""Compress-in-update: the two kernels of the fused ``block_topk|qsgd``
encode (``repro/kernels/fused_compress.py``), both in
``csrc/fused_compress.cu``.

``delta_pack(thetas, vs)`` is ``pack_topk`` of every ``theta - v`` of two
lists of leaves without writing the residuals: the CUDA kernel forms
``d = theta - v`` in registers and runs the pack tile on it, one launch a
table of up to ``MAX_TABLE_LEAVES`` leaves (the round's codec encodes all
its packed leaves with one call). The plain version forms the same f32
residual and runs the same plain tile, leaf by leaf, so the two paths agree
bit for bit.

``grid_quant(x, u, norm, levels)`` rounds the packed ``(rows, nb·k)``
carrier onto the signed QSGD grid, ``sign(x)·q`` as int8, with each row's
norm handed in (``ops.qsgd_quantize_carrier`` computes it between the two
kernels). Its level arithmetic is the dense QSGD's (``qsgd.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check, library, on_card, stream_of
from repro_torch.kernels.pack import pack_table, pack_topk_plain
from repro_torch.kernels.qsgd import qsgd_levels_plain


def delta_pack_plain(theta: torch.Tensor, v: torch.Tensor, k: int,
                     block_size: int = 1024):
    return pack_topk_plain(theta - v.to(theta.dtype), k, block_size)


def delta_pack(thetas, vs, k: int, block_size: int = 1024):
    """Lists of ``(rows, n)`` f32 leaves theta and v -> a list of ``(vals
    (rows, nb, k), idx uint16)``, one per leaf."""
    if isinstance(thetas, torch.Tensor) or isinstance(vs, torch.Tensor):
        raise TypeError("delta_pack takes lists of leaves")
    if len(vs) != len(thetas):
        raise ValueError(f"delta_pack: {len(thetas)} thetas, {len(vs)} vs")
    if not thetas:
        return []
    if not on_card("delta_pack", [(t, torch.float32) for t in thetas]
                   + [(v, torch.float32) for v in vs]):
        return [delta_pack_plain(t, v, k, block_size)
                for t, v in zip(thetas, vs)]
    return pack_table(delta_pack, library().repro_delta_pack, [thetas, vs],
                      k, block_size)


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
