"""Block-top-k wire format: pack and unpack (``repro/kernels/pack.py``).

Each leaf is handled as a ``(rows, n)`` tensor, one row per node, cut into
``nb = ceil(n / block_size)`` blocks; the ragged last block is padded with
zeros. Pack keeps ``k`` survivors per block as ``(rows, nb, k)`` f32 values
and uint16 block-local indices; unpack scatters them back. Pack and unpack
take lists of leaves with the same ``rows`` and handle them with one launch
a table of up to ``MAX_TABLE_LEAVES``; a single leaf is a table of one.

Beside each kernel wrapper is its plain PyTorch version, which transcribes
the reference's arithmetic (``_pack_tile``: 40-step bisection, definite and
tie masks, cumulative-sum ranks, and the one-hot contractions' values,
ROADMAP C6, C7). A CPU tensor goes to the plain version, a CUDA tensor to the
kernel (``csrc/pack.cu``) or to an exception. Each wrapper counts its
kernel launches in ``.launches``.

The top_k-order wire format of the reference's default, unfused
``BlockTopKCodec`` has a kernel pair of its own: ``topk_select`` keeps each
block's k largest ``|d|`` in ``lax.top_k``'s order (ROADMAP C9), with a k a
leaf (a leaf of at most one block is ``TopKCodec``'s global top-k), and
``unpack_set`` decodes it as the reference's ``.at[].set`` scatter. Their
plain versions are a stable descending sort of each block's keys and
``scatter_``; ``topk_candidates_plain`` transcribes the rule by which the
selection kernel's fast path bounds a block's survivors.
"""
from __future__ import annotations

import ctypes
import torch
import torch.nn.functional as F

from repro_torch.kernels._build import (check, control_forms, library,
                                       on_card, stream_of)

BISECT_ITERS = 40
KERNEL_BLOCK = 1024          # the CUDA kernels hold one block per warp
MAX_TABLE_LEAVES = 32        # csrc/pack_tile.cuh: kMaxLeaves
PAYLOAD_ALIGN = 128          # elements: 512 bytes of f32, 256 of uint16
NAN = float("nan")           # the NaN the kernels write (0x7fc00000)


def num_blocks(n: int, block_size: int) -> int:
    return max(1, -(-n // block_size))


def bisection_bounds(mag: torch.Tensor, k: int):
    """The reference's 40-step f32 threshold bisection on ``(rows, bs)``
    magnitudes: ``(lo, hi)``, each ``(rows, 1)``. A row holding a NaN ends
    at ``lo = 0, hi = NaN``: ``amax`` propagates NaN as ``jnp.max`` does."""
    hi = mag.amax(dim=1, keepdim=True) + 1.0         # count(mag >= hi) < k
    lo = torch.zeros_like(hi)                        # count(mag >= lo) >= k
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        pred = (mag >= mid).sum(dim=1, keepdim=True) >= k
        lo, hi = torch.where(pred, mid, lo), torch.where(pred, hi, mid)
    return lo, hi


def two_tier_ranks(x2d: torch.Tensor, k: int):
    """``_pack_tile``'s selection on ``(rows, bs)`` blocks (40-step
    bisection, then the two-tier rank), shared with the dense block top-k:
    the definite and tie masks and each element's rank within its tier."""
    mag = x2d.abs()
    lo, hi = bisection_bounds(mag, k)
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
    # the reference's one-hot contraction, 0 + sum_b x[b]·[slot(b) == s]:
    # -0.0 comes out +0.0, and 0·inf, 0·NaN make every slot of a block with
    # a non-finite element NaN but the slot of a lone ±inf (ROADMAP C6)
    bad = (~torch.isfinite(x2d)).sum(dim=1, keepdim=True)
    vals = torch.where(bad > (~torch.isfinite(vals)).long(), NAN, vals + 0.0)
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


def check_kernel_shape(kernel: str, k: int, block_size: int) -> None:
    if block_size != KERNEL_BLOCK or not 1 <= k <= block_size:
        raise ValueError(f"{kernel}: the CUDA kernel takes block_size="
                         f"{KERNEL_BLOCK} and 1 <= k <= block_size, got "
                         f"block_size={block_size}, k={k}")


def c_array(ctype, values):
    return (ctype * len(values))(*values)


def aligned_offsets(sizes):
    """Offsets of buffers of ``sizes`` elements laid one after another in
    one allocation, each starting ``PAYLOAD_ALIGN``-aligned as an
    allocation of its own would (torch's reductions sum a misaligned view
    in another order); and the allocation's length."""
    outs, end = [], 0
    for size in sizes:
        outs.append(-(-end // PAYLOAD_ALIGN) * PAYLOAD_ALIGN)
        end = outs[-1] + size
    return outs, end


def tables(count: int):
    """The slices of a list of ``count`` leaves that one launch takes."""
    return [slice(c, c + MAX_TABLE_LEAVES)
            for c in range(0, count, MAX_TABLE_LEAVES)]


def pack_table(wrapper, entry, operands, k: int, block_size: int):
    """Launch a pack kernel over leaf tables: ``operands`` is ``[xs]`` or
    ``[thetas, vs]``, lists of ``(rows, n)`` CUDA tensors with the same
    ``rows``. One launch packs up to ``MAX_TABLE_LEAVES`` leaves into one
    allocation, leaf after leaf; returns each leaf's ``(vals, idx)``
    ``(rows, nb, k)`` views of it, each starting ``PAYLOAD_ALIGN``-aligned
    (the QSGD norm of a packed carrier is a torch reduction)."""
    name = wrapper.__name__
    check_kernel_shape(name, k, block_size)
    leaves = operands[0]
    rows = leaves[0].shape[0]
    for i, x in enumerate(leaves):
        if x.dim() != 2 or x.shape[0] != rows or \
                any(op[i].shape != x.shape for op in operands):
            raise ValueError(f"{name}: leaf {i} has shapes "
                             f"{[tuple(op[i].shape) for op in operands]}; "
                             f"every leaf must be (rows={rows}, n)")
    nbs = [num_blocks(x.shape[1], block_size) for x in leaves]
    outs, end = aligned_offsets([rows * nb * k for nb in nbs])
    dev = leaves[0].device
    vals = torch.empty(end, dtype=torch.float32, device=dev)
    idx = torch.empty(end, dtype=torch.uint16, device=dev)
    if rows:
        with torch.cuda.device(dev):
            for part in tables(len(leaves)):
                rc = entry(*(c_array(ctypes.c_void_p,
                                     [t.data_ptr() for t in op[part]])
                             for op in operands),
                           c_array(ctypes.c_longlong,
                                   [x.shape[1] for x in leaves[part]]),
                           c_array(ctypes.c_longlong, nbs[part]),
                           c_array(ctypes.c_longlong, outs[part]),
                           len(leaves[part]), rows, vals.data_ptr(),
                           idx.data_ptr(), k, stream_of(leaves[0]))
                check(rc, name)
                wrapper.launches += 1
    return [(vals[o:o + rows * nb * k].view(rows, nb, k),
             idx[o:o + rows * nb * k].view(rows, nb, k))
            for nb, o in zip(nbs, outs)]


def pack_topk(xs, k: int, block_size: int = 1024):
    """A list of ``(rows, n)`` f32 leaves -> a list of ``(vals (rows, nb, k)
    f32, idx (rows, nb, k) uint16)``, one per leaf."""
    if isinstance(xs, torch.Tensor):
        raise TypeError("pack_topk takes a list of leaves")
    if not xs:
        return []
    if not on_card("pack_topk", [(x, torch.float32) for x in xs]):
        return [pack_topk_plain(x, k, block_size) for x in xs]
    return pack_table(pack_topk, library().repro_pack_topk, [xs], k,
                      block_size)


pack_topk.launches = 0


def unpack_topk_plain(vals: torch.Tensor, idx: torch.Tensor, n: int,
                      block_size: int = 1024) -> torch.Tensor:
    rows, nb, k = vals.shape
    v = vals.reshape(rows * nb, k)
    i = from_uint16(idx).reshape(rows * nb, k)
    # the reference's one-hot contraction, 0 + sum_s vals[s]·[idx[s] == b],
    # summed from +0.0 in slot order (ROADMAP C7): values that share an
    # index add up, and -0.0 decodes to +0.0. One slot column an add, so
    # every add is one f32 rounding in that order.
    dense = vals.new_zeros((rows * nb, block_size))
    for s in range(k):
        dense.scatter_add_(1, i[:, s:s + 1], v[:, s:s + 1])
    # 0·inf and 0·NaN make a block whose values hold a non-finite NaN
    # everywhere but at an index that holds all of its non-finite values,
    # which keeps their sum (ROADMAP C6): inf + inf is inf there. Every NaN
    # is written as NAN, whatever the payload the sum came to.
    bad = ~torch.isfinite(v)
    n_bad = bad.sum(dim=1, keepdim=True)
    here = torch.zeros_like(dense, dtype=torch.int64).scatter_add_(
        1, i, bad.long())
    dense = torch.where((n_bad > here) | dense.isnan(), NAN, dense)
    return dense.reshape(rows, nb * block_size)[:, :n].contiguous()


def unpack_topk(payloads, ns, block_size: int = 1024):
    """A list of ``(vals (rows, nb, k) f32, idx (rows, nb, k) uint16)``
    payloads and a list of their leaves' ``n`` -> a list of dense ``(rows,
    n)`` f32 leaves. On the card one launch unpacks a table of up to
    ``MAX_TABLE_LEAVES`` leaves into one allocation, each leaf a
    ``PAYLOAD_ALIGN``-aligned view of it (mixing and the round's norms
    reduce it as they would an allocation of its own)."""
    if isinstance(payloads, torch.Tensor) or isinstance(ns, int):
        raise TypeError("unpack_topk takes a list of payloads and of sizes")
    if len(payloads) != len(ns):
        raise ValueError(f"unpack_topk: {len(payloads)} payloads, "
                         f"{len(ns)} sizes")
    if not payloads:
        return []
    ns = [int(n) for n in ns]
    if not on_card("unpack_topk", [op for vals, idx in payloads for op in
                                   ((vals, torch.float32),
                                    (idx, torch.uint16))]):
        return [unpack_topk_plain(vals, idx, n, block_size)
                for (vals, idx), n in zip(payloads, ns)]
    rows, _, k = payloads[0][0].shape
    check_kernel_shape("unpack_topk", k, block_size)
    for i, ((vals, idx), n) in enumerate(zip(payloads, ns)):
        if vals.shape != (rows, num_blocks(n, block_size), k) or \
                idx.shape != vals.shape:
            raise ValueError(f"unpack_topk: leaf {i}: vals "
                             f"{tuple(vals.shape)}, idx {tuple(idx.shape)} "
                             f"do not fit rows={rows}, n={n}, k={k}")
    offs, end = aligned_offsets([rows * n for n in ns])
    dev = payloads[0][0].device
    out = torch.empty(end, dtype=torch.float32, device=dev)
    dense = [out[o:o + rows * n].view(rows, n) for o, n in zip(offs, ns)]
    if rows:
        with torch.cuda.device(dev):
            for part in tables(len(payloads)):
                rc = library().repro_unpack_topk(
                    c_array(ctypes.c_void_p,
                            [v.data_ptr() for v, _ in payloads[part]]),
                    c_array(ctypes.c_void_p,
                            [i.data_ptr() for _, i in payloads[part]]),
                    c_array(ctypes.c_void_p,
                            [d.data_ptr() for d in dense[part]]),
                    c_array(ctypes.c_longlong, ns[part]),
                    c_array(ctypes.c_longlong,
                            [v.shape[1] for v, _ in payloads[part]]),
                    len(ns[part]), rows, k, stream_of(payloads[0][0]))
                check(rc, "unpack_topk")
                unpack_topk.launches += 1
    return dense


unpack_topk.launches = 0


# --------------------------------------------------------------------------
# the top_k-order wire format (ROADMAP C9)
# --------------------------------------------------------------------------

def magnitude_keys(x: torch.Tensor) -> torch.Tensor:
    """``lax.top_k``'s order of ``|x|`` as int32 keys: the bits of ``|x|``,
    so NaN ranks above ±inf and NaNs by payload (ROADMAP C9)."""
    return x.view(torch.int32) & 0x7FFFFFFF


def topk_select_plain(x: torch.Tensor, k: int, block_size: int = 1024,
                      v: torch.Tensor = None):
    """``(rows, n)`` -> ``(vals (rows, nb, k) f32, idx (rows, nb, k)
    uint16)``: each zero-padded block's k largest ``|d|`` (``d = x − v``
    when ``v`` is given), slots by descending key, equal keys by index,
    values as they are: a stable descending sort of the block's keys."""
    rows, n = x.shape
    d = x if v is None else x - v.to(x.dtype)
    blocks = to_blocks(d, block_size)
    order = torch.sort(magnitude_keys(blocks), dim=1, descending=True,
                       stable=True).indices[:, :k]
    nb = num_blocks(n, block_size)
    vals = torch.gather(blocks, 1, order)
    return vals.reshape(rows, nb, k), to_uint16(order).reshape(rows, nb, k)


def topk_candidates_plain(blocks: torch.Tensor, k: int):
    """The rule of the selection kernel's fast path on ``(rows, 1024)``
    blocks of ``d``, 1 <= k <= 32, as its tile holds them (lane l keeps
    elements ``j·32 + l``): ``(L (rows,) int32, count (rows,) int64)``. L
    is the k-th largest of the 32 lanes' largest keys (``magnitude_keys``),
    a NaN key counting as 0 there as ``fmaxf`` drops it; count is the
    number of the block's keys >= L, NaN keys included. Every survivor's
    key is >= L, so count >= k; a block whose count exceeds 32 takes the
    kernel's k-th-key search instead. The kernel does not call this."""
    if not 1 <= k <= 32 or blocks.shape[-1] != KERNEL_BLOCK:
        raise ValueError(f"topk_candidates_plain: the fast path takes "
                         f"(rows, {KERNEL_BLOCK}) blocks and 1 <= k <= 32, "
                         f"got {tuple(blocks.shape)}, k={k}")
    keys = magnitude_keys(blocks)
    finite = torch.where(keys > 0x7F800000, 0, keys)
    lane_max = finite.reshape(-1, 32, 32).amax(dim=1)      # (rows, lane)
    bound = lane_max.sort(dim=1, descending=True).values[:, k - 1]
    return bound, (keys >= bound[:, None]).sum(dim=1)


def topk_select(xs, ks, vs=None, block_size: int = 1024):
    """Lists of ``(rows, n)`` f32 leaves, their survivors a block ``ks``
    and optionally their ``vs`` -> a list of ``(vals (rows, nb, k) f32, idx
    (rows, nb, k) uint16)``, one per leaf, in ``lax.top_k`` order of each
    block of ``x − v``. On the card one launch a table of up to
    ``MAX_TABLE_LEAVES`` leaves, ``x − v`` formed in registers; each
    payload a ``PAYLOAD_ALIGN``-aligned view of one allocation."""
    if isinstance(xs, torch.Tensor):
        raise TypeError("topk_select takes a list of leaves")
    if len(ks) != len(xs) or (vs is not None and len(vs) != len(xs)):
        raise ValueError(f"topk_select: {len(xs)} leaves, {len(ks)} ks"
                         + ("" if vs is None else f", {len(vs)} vs"))
    if not xs:
        return []
    operands = [xs] if vs is None else [xs, vs]
    if vs is not None and vs[0].dtype in TOPK_SELECT_FORMS:
        return _topk_select_control(xs, ks, vs, block_size)
    if not on_card("topk_select", [(t, torch.float32) for op in operands
                                   for t in op]):
        return [topk_select_plain(x, k, block_size,
                                  None if vs is None else vs[i])
                for i, (x, k) in enumerate(zip(xs, ks))]
    return _topk_select_table(topk_select, library().repro_topk_select, xs,
                              ks, vs, block_size)


# the launches of each stored dtype's form
TOPK_SELECT_FORMS = control_forms("topk_select")


def _topk_select_control(xs, ks, vs, block_size: int):
    """:func:`topk_select` of ``x − v`` with the ``vs`` stored in bfloat16
    or float16 (``FedConfig.control_dtype``): the kernel widens each
    element of v in registers, exactly (subnormal halves too); the plain
    version computes ``x − v.float()``."""
    form = TOPK_SELECT_FORMS[vs[0].dtype]
    if not on_card(form.__name__, [(x, torch.float32) for x in xs]
                   + [(v, vs[0].dtype) for v in vs]):
        return [topk_select_plain(x, k, block_size, v)
                for x, k, v in zip(xs, ks, vs)]
    return _topk_select_table(form, getattr(library(),
                                            f"repro_{form.__name__}"),
                              xs, ks, vs, block_size)


def _topk_select_table(wrapper, entry, xs, ks, vs, block_size: int):
    """Launch a top_k-order selection over leaf tables (see
    :func:`topk_select`); ``wrapper`` counts the launches."""
    operands = [xs] if vs is None else [xs, vs]
    for k in ks:
        check_kernel_shape("topk_select", k, block_size)
    rows = xs[0].shape[0]
    for i, x in enumerate(xs):
        if x.dim() != 2 or x.shape[0] != rows or \
                any(op[i].shape != x.shape for op in operands):
            raise ValueError(f"topk_select: leaf {i} has shapes "
                             f"{[tuple(op[i].shape) for op in operands]}; "
                             f"every leaf must be (rows={rows}, n)")
    nbs = [num_blocks(x.shape[1], block_size) for x in xs]
    outs, end = aligned_offsets([rows * nb * k for nb, k in zip(nbs, ks)])
    dev = xs[0].device
    vals = torch.empty(end, dtype=torch.float32, device=dev)
    idx = torch.empty(end, dtype=torch.uint16, device=dev)
    if rows:
        with torch.cuda.device(dev):
            for part in tables(len(xs)):
                rc = entry(
                    c_array(ctypes.c_void_p,
                            [t.data_ptr() for t in xs[part]]),
                    None if vs is None else c_array(
                        ctypes.c_void_p, [t.data_ptr() for t in vs[part]]),
                    c_array(ctypes.c_longlong,
                            [x.shape[1] for x in xs[part]]),
                    c_array(ctypes.c_longlong, nbs[part]),
                    c_array(ctypes.c_int, ks[part]),
                    c_array(ctypes.c_longlong, outs[part]), len(xs[part]),
                    rows, vals.data_ptr(), idx.data_ptr(),
                    stream_of(xs[0]))
                check(rc, wrapper.__name__)
                wrapper.launches += 1
    return [(vals[o:o + rows * nb * k].view(rows, nb, k),
             idx[o:o + rows * nb * k].view(rows, nb, k))
            for nb, k, o in zip(nbs, ks, outs)]


topk_select.launches = 0


def unpack_set_plain(vals: torch.Tensor, idx: torch.Tensor, n: int,
                     block_size: int = 1024) -> torch.Tensor:
    """The reference's ``.at[].set`` decode of a ``(rows, nb, k)`` payload:
    zeros, each value stored as it is at its index."""
    rows, nb, k = vals.shape
    dense = vals.new_zeros((rows * nb, block_size)).scatter_(
        1, from_uint16(idx).reshape(rows * nb, k), vals.reshape(rows * nb, k))
    return dense.reshape(rows, nb * block_size)[:, :n].contiguous()


def unpack_set(payloads, ns, block_size: int = 1024):
    """A list of top_k-order ``(vals (rows, nb, k) f32, idx uint16)``
    payloads, k a leaf, and their leaves' ``n`` -> a list of dense ``(rows,
    n)`` f32 leaves; on the card one launch a table of up to
    ``MAX_TABLE_LEAVES`` leaves into one allocation, each leaf a
    ``PAYLOAD_ALIGN``-aligned view of it. An index repeated in a payload
    is a caller error (top_k never repeats one)."""
    if isinstance(payloads, torch.Tensor) or isinstance(ns, int):
        raise TypeError("unpack_set takes a list of payloads and of sizes")
    if len(payloads) != len(ns):
        raise ValueError(f"unpack_set: {len(payloads)} payloads, "
                         f"{len(ns)} sizes")
    if not payloads:
        return []
    ns = [int(n) for n in ns]
    if not on_card("unpack_set", [op for vals, idx in payloads for op in
                                  ((vals, torch.float32),
                                   (idx, torch.uint16))]):
        return [unpack_set_plain(vals, idx, n, block_size)
                for (vals, idx), n in zip(payloads, ns)]
    rows = payloads[0][0].shape[0]
    ks = [vals.shape[2] for vals, _ in payloads]
    for i, ((vals, idx), n) in enumerate(zip(payloads, ns)):
        check_kernel_shape("unpack_set", ks[i], block_size)
        if vals.shape != (rows, num_blocks(n, block_size), ks[i]) or \
                idx.shape != vals.shape:
            raise ValueError(f"unpack_set: leaf {i}: vals "
                             f"{tuple(vals.shape)}, idx {tuple(idx.shape)} "
                             f"do not fit rows={rows}, n={n}")
    offs, end = aligned_offsets([rows * n for n in ns])
    dev = payloads[0][0].device
    out = torch.empty(end, dtype=torch.float32, device=dev)
    dense = [out[o:o + rows * n].view(rows, n) for o, n in zip(offs, ns)]
    if rows:
        with torch.cuda.device(dev):
            for part in tables(len(payloads)):
                rc = library().repro_unpack_set(
                    c_array(ctypes.c_void_p,
                            [v.data_ptr() for v, _ in payloads[part]]),
                    c_array(ctypes.c_void_p,
                            [i.data_ptr() for _, i in payloads[part]]),
                    c_array(ctypes.c_void_p,
                            [d.data_ptr() for d in dense[part]]),
                    c_array(ctypes.c_longlong, ns[part]),
                    c_array(ctypes.c_longlong,
                            [v.shape[1] for v, _ in payloads[part]]),
                    c_array(ctypes.c_int, ks[part]), len(ns[part]), rows,
                    stream_of(payloads[0][0]))
                check(rc, "unpack_set")
                unpack_set.launches += 1
    return dense


unpack_set.launches = 0
