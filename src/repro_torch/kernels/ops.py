"""Leaf-level entry points over node-stacked leaves (``repro/kernels/ops.py``).

A leaf ``(K, *shape)`` is handed to the kernels as a ``(K, n)`` view, so one
launch covers every node. The reference's padding of the block rows to its
8-row TPU tile is not needed here: the kernels mask the ragged block
themselves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.block_topk import block_topk as block_topk_rows
from repro_torch.kernels.fused_compress import delta_pack, grid_quant_leaves
from repro_torch.kernels.fused_update import (cffl_update, dsgld_update,
                                              fused_update)
from repro_torch.kernels.pack import (KERNEL_BLOCK, from_uint16,
                                      magnitude_keys, num_blocks, pack_topk,
                                      to_uint16, topk_select, unpack_set,
                                      unpack_topk)
from repro_torch.kernels.qsgd import inv_one_plus, qsgd_omega, row_norm
from repro_torch.kernels.qsgd import qsgd as qsgd_rows


def survivors_per_block(ratio: float, block_size: int) -> int:
    return max(1, int(np.ceil(ratio * block_size)))


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def block_topk(x: torch.Tensor, ratio: float = 0.01,
               block_size: int = 1024) -> torch.Tensor:
    """Dense masked block top-k of a ``(K, *shape)`` leaf: the
    ``ceil(ratio·block_size)`` largest magnitudes of every block kept."""
    k = survivors_per_block(ratio, block_size)
    return block_topk_rows(_rows(x), k, block_size).reshape(x.shape)


def block_topk_pack(x: torch.Tensor, ratio: float = 0.01,
                    block_size: int = 1024):
    """(K, *shape) -> (vals (K, nb, k) f32, idx (K, nb, k) uint16)."""
    return pack_leaves([x], ratio, block_size)[0]


def pack_leaves(xs, ratio: float = 0.01, block_size: int = 1024):
    """:func:`block_topk_pack` of every ``(K, *shape)`` leaf of a list, in
    one launch a table."""
    assert block_size <= 65536, "uint16 block-local indices"
    return pack_topk([_rows(x) for x in xs],
                     survivors_per_block(ratio, block_size), block_size)


def topk_select_leaves(xs, ks, vs=None, block_size: int = 1024):
    """Each ``(K, *shape)`` leaf's blocks (of ``x − v`` when ``vs`` is
    given) in ``lax.top_k`` order, ``ks[i]`` survivors a block: a list of
    ``(vals (K, nb, k), idx (K, nb, k) uint16)``, one launch a table."""
    return topk_select([_rows(x) for x in xs], list(ks),
                       None if vs is None else [_rows(v) for v in vs],
                       block_size)


def unpack_set_leaves(payloads, shapes, block_size: int = 1024):
    """Top_k-order ``(vals, idx)`` payloads back to dense ``(K,
    *shapes[i])`` leaves, one launch a table."""
    dense = unpack_set(payloads, [int(np.prod(s)) for s in shapes],
                       block_size)
    return [d.reshape((d.shape[0],) + tuple(s)) for d, s in zip(dense, shapes)]


def fused_delta_pack(theta: torch.Tensor, v: torch.Tensor, ratio: float = 0.01,
                     block_size: int = 1024):
    """``block_topk_pack(theta - v)`` without writing the residual."""
    return fused_delta_pack_leaves([theta], [v], ratio, block_size)[0]


def fused_delta_pack_leaves(thetas, vs, ratio: float = 0.01,
                            block_size: int = 1024):
    """:func:`fused_delta_pack` of every ``(K, *shape)`` leaf of two lists,
    in one launch a table of up to ``MAX_TABLE_LEAVES`` leaves; each
    leaf's ``(vals, idx)`` is a view of one allocation."""
    assert block_size <= 65536, "uint16 block-local indices"
    return delta_pack([_rows(t) for t in thetas], [_rows(v) for v in vs],
                      survivors_per_block(ratio, block_size), block_size)


def block_topk_unpack(vals: torch.Tensor, idx: torch.Tensor, shape,
                      block_size: int = 1024) -> torch.Tensor:
    """Scatter a packed payload back to a dense ``(K, *shape)`` leaf."""
    return block_topk_unpack_leaves([(vals, idx)], [shape], block_size)[0]


def block_topk_unpack_leaves(payloads, shapes, block_size: int = 1024):
    """:func:`block_topk_unpack` of every ``(vals, idx)`` payload of a list,
    leaf ``i`` to ``(K, *shapes[i])``, in one launch a table of up to
    ``MAX_TABLE_LEAVES`` leaves."""
    dense = unpack_topk(payloads, [int(np.prod(s)) for s in shapes],
                        block_size)
    return [d.reshape((d.shape[0],) + tuple(s)) for d, s in zip(dense, shapes)]


def leaf_fused_update(theta, vbar, v, noise, zeta: float,
                      noise_scale: float) -> torch.Tensor:
    return fused_update(theta, vbar.to(theta.dtype), v.to(theta.dtype),
                        noise, zeta, noise_scale)


def leaf_cffl_update(theta, vbar, v, zeta: float) -> torch.Tensor:
    return cffl_update(theta, vbar.to(theta.dtype), v.to(theta.dtype), zeta)


def leaf_dsgld_update(mixed, grad, noise, eta: float) -> torch.Tensor:
    return dsgld_update(mixed, grad.to(mixed.dtype), noise, eta)


def qsgd(x: torch.Tensor, u: torch.Tensor, levels: int = 16) -> torch.Tensor:
    """Dense QSGD of a ``(K, *shape)`` leaf, each node's row under its own
    norm, with uniforms ``u`` of the leaf's shape; ω counts one node's
    elements. A zero-size leaf comes back as it is (the reference's
    ``ops.py:122``)."""
    return qsgd_leaves([x], [u], levels)[0]


def qsgd_leaves(xs, us, levels: int = 16):
    """:func:`qsgd` of every leaf of a list, with its uniforms, in one
    launch a table of up to ``MAX_TABLE_LEAVES`` leaves; the per-node
    norms are one torch reduction a leaf."""
    out = list(xs)
    live = [i for i, x in enumerate(xs) if x.numel()]
    rows = [_rows(xs[i]) for i in live]
    got = qsgd_rows(rows, [_rows(us[i]) for i in live],
                    [row_norm(r) for r in rows], levels,
                    [inv_one_plus(qsgd_omega(r.shape[1], levels))
                     for r in rows])
    for i, q in zip(live, got):
        out[i] = q.reshape(xs[i].shape)
    return out


def qsgd_quantize_carriers(carriers, us, levels: int = 16):
    """QSGD grids of packed ``(K, nb, k)`` carriers and their uniforms: a
    list of ``(grid (K, nb, k) int8, norm (K,) f32)``, one per leaf, in one
    grid_quant launch a table of up to ``MAX_TABLE_LEAVES`` leaves, each
    per-node norm computed in it (the reference's ``ops.py:177-196``
    computes it in jnp outside its kernel)."""
    grids, norms = grid_quant_leaves([_rows(c) for c in carriers],
                                     [_rows(u) for u in us], levels)
    return [(g.reshape(c.shape), n) for g, n, c in zip(grids, norms, carriers)]
