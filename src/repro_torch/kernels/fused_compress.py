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

With ``v`` stored in bfloat16 or float16 (``FedConfig.control_dtype``)
the same kernel reads the 2-byte elements and widens them in registers,
each dtype's launches counted apart (``delta_pack_bf16``,
``delta_pack_f16``).

``grid_quant_leaves(carriers, us, levels)`` rounds each packed ``(rows,
m)`` carrier onto the signed QSGD grid, ``sign(x)·q`` as int8, under each
row's norm ``‖row‖₂ + 1e-12``, which it computes too (the reference's
wrapper computes it in jnp between its kernels, ``ops.py:177-196``): one
launch a table of up to ``MAX_TABLE_LEAVES`` leaves. Its level arithmetic
is the dense QSGD's (``qsgd.py``). The norm's summation order is a fixed
function of the row's length (:func:`carrier_norms_plain`), so the plain
version, which the two-pass oracle's QSGD codec runs, gives the kernel's
norm bit for bit.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import (check, control_forms, library,
                                       on_card, stream_of)
from repro_torch.kernels.pack import (aligned_offsets, c_array, pack_table,
                                      pack_topk_plain, tables)
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
    if vs[0].dtype in DELTA_PACK_FORMS:
        return _delta_pack_control(thetas, vs, k, block_size)
    if not on_card("delta_pack", [(t, torch.float32) for t in thetas]
                   + [(v, torch.float32) for v in vs]):
        return [delta_pack_plain(t, v, k, block_size)
                for t, v in zip(thetas, vs)]
    return pack_table(delta_pack, library().repro_delta_pack, [thetas, vs],
                      k, block_size)


# the launches of each stored dtype's form
DELTA_PACK_FORMS = control_forms("delta_pack")


def _delta_pack_control(thetas, vs, k: int, block_size: int):
    """:func:`delta_pack` with the ``vs`` stored in bfloat16 or float16
    (``FedConfig.control_dtype``): the kernel widens each element of v in
    registers, exactly (subnormal halves too); the plain version computes
    ``theta − v.float()``."""
    form = DELTA_PACK_FORMS[vs[0].dtype]
    if not on_card(form.__name__, [(t, torch.float32) for t in thetas]
                   + [(v, vs[0].dtype) for v in vs]):
        return [delta_pack_plain(t, v, k, block_size)
                for t, v in zip(thetas, vs)]
    return pack_table(form, getattr(library(), f"repro_{form.__name__}"),
                      [thetas, vs], k, block_size)


delta_pack.launches = 0


# the norm's summation order (csrc/fused_compress.cu): SEGMENT_LANES lane
# sums in each of NORM_SEGMENTS contiguous segments of a row, then a
# pairwise tree over all of them
NORM_SEGMENTS = 8
SEGMENT_LANES = 512


def carrier_norms_plain(x: torch.Tensor) -> torch.Tensor:
    """``‖row‖₂ + 1e-12`` of each row of a ``(rows, m)`` f32 carrier, in the
    kernel's summation order: the row cut into ``NORM_SEGMENTS`` segments
    of ``S = ⌈m/8⌉`` elements, lane ``q`` of segment ``g`` adding
    ``x[g·S + q + 512·j]²`` for ``j = 0, 1, …`` in sequence, then the 4096
    lane sums added pairwise, neighbours first. Each product and sum is a
    torch op of its own, one f32 rounding; the zero padding adds +0.0,
    which leaves a sum of squares as it is."""
    rows, m = x.shape
    seg = -(-m // NORM_SEGMENTS)
    steps = -(-seg // SEGMENT_LANES)
    xs = F.pad(x, (0, NORM_SEGMENTS * seg - m)).reshape(rows, NORM_SEGMENTS,
                                                         seg)
    xs = F.pad(xs, (0, steps * SEGMENT_LANES - seg)).reshape(
        rows, NORM_SEGMENTS, steps, SEGMENT_LANES)
    acc = x.new_zeros((rows, NORM_SEGMENTS, SEGMENT_LANES))
    for j in range(steps):
        acc = acc + xs[:, :, j] * xs[:, :, j]
    acc = acc.reshape(rows, NORM_SEGMENTS * SEGMENT_LANES)
    while acc.shape[1] > 1:
        acc = acc[:, 0::2] + acc[:, 1::2]
    return torch.sqrt(acc[:, 0]) + 1e-12


def grid_quant_plain(x: torch.Tensor, u: torch.Tensor, norm: torch.Tensor,
                     levels: int) -> torch.Tensor:
    q = qsgd_levels_plain(x, u, norm, levels)
    return (torch.sign(x) * q).to(torch.int8)


def grid_quant_leaves(carriers, us, levels: int):
    """Lists of ``(rows, m)`` f32 carriers and their uniforms -> ``(grids,
    norms)``: each leaf's ``(rows, m)`` int8 grid and ``(rows,)`` f32 norms
    ``‖row‖₂ + 1e-12``. On the card one launch covers a table of up to
    ``MAX_TABLE_LEAVES`` leaves, each long row shared by a cluster of 8
    CTAs; the grids are ``PAYLOAD_ALIGN``-aligned views of one
    int8 allocation and the norms rows of one f32 tensor."""
    if isinstance(carriers, torch.Tensor) or isinstance(us, torch.Tensor):
        raise TypeError("grid_quant_leaves takes lists of leaves")
    if len(us) != len(carriers):
        raise ValueError(f"grid_quant_leaves: {len(carriers)} carriers, "
                         f"{len(us)} uniforms")
    if not carriers:
        return [], []
    if not on_card("grid_quant", [(t, torch.float32) for leaf in
                                  zip(carriers, us) for t in leaf]):
        norms = [carrier_norms_plain(x) for x in carriers]
        return ([grid_quant_plain(x, u, n, levels)
                 for x, u, n in zip(carriers, us, norms)], norms)
    rows = carriers[0].shape[0]
    for i, (x, u) in enumerate(zip(carriers, us)):
        if x.dim() != 2 or x.shape[0] != rows or u.shape != x.shape:
            raise ValueError(f"grid_quant_leaves: leaf {i}: x "
                             f"{tuple(x.shape)}, u {tuple(u.shape)}; every "
                             f"leaf must be (rows={rows}, m)")
    if not 1 <= levels <= 127:
        raise ValueError(f"grid_quant_leaves: levels {levels} do not fit int8")
    ms = [x.shape[1] for x in carriers]
    offs, end = aligned_offsets([rows * m for m in ms])
    dev = carriers[0].device
    flat = torch.empty(end, dtype=torch.int8, device=dev)
    grids = [flat[o:o + rows * m].view(rows, m) for o, m in zip(offs, ms)]
    norms = torch.empty((len(carriers), rows), dtype=torch.float32,
                        device=dev)
    if rows:
        with torch.cuda.device(dev):
            for part in tables(len(carriers)):
                rc = library().repro_grid_quant(
                    *(c_array(ctypes.c_void_p, [t.data_ptr() for t in ts[part]])
                      for ts in (carriers, us, grids, norms)),
                    c_array(ctypes.c_longlong, ms[part]), len(ms[part]), rows,
                    float(levels), stream_of(carriers[0]))
                check(rc, "grid_quant")
                grid_quant_leaves.launches += 1
    return grids, list(norms)


grid_quant_leaves.launches = 0
