"""One decode step of grouped-query attention over every lane's KV cache,
one launch a layer (``csrc/decode_attention.cu``).

The reference's ``decode_attention`` (``repro/models/attention.py:120-142``)
is jnp, vmapped by its decode engine over the (sample, slot) lanes. Its
rounding order, which no library call follows: the post-RoPE key and value
written into the lane's slot in the cache dtype; the scores ``q · k`` in
the compute dtype ``dt``, divided by ``sqrt(hd)`` in ``dt``; rows whose
``slot_pos`` is unwritten, ahead of the lane or outside its window masked
to ``−1e30``; the f32 softmax rounded to ``dt``; the weighted values
rounded to ``dt``.

Kernel and plain version compute in f32 with XLA's exp (``exp_plain``, the
reference's own softmax numerators) and add in one fixed order, which the
kernel's source comment states: each dot product as fma chains over a
thread's 16 bytes of the cache row (32 for an f32 row of 256) and a
halving tree over the row's threads; the softmax's sum thread by thread,
then a warp's tree, then the warps in order; the weighted values as fma
chains over a thread's rows, then a tree over a warp's row groups, then
the warps in order. A cache that one CTA cannot hold (recurrentgemma-9b's
ring of 2,048 slots under 16 heads of 256, or any f32 row of 256) takes
the split form: a cluster of CTAs a (lane, KV head), each over a tile of
the slots in that order, the tiles' sums added in rank order
(:func:`split_of`). The plain version follows that order op for op
(single-rounding ``_fma`` and ``_div``), so the two agree bit for bit. The
reference sums in f32 in XLA's order, so against it the port is within f32
summation error before the ``dt`` rounding.

The plain version runs for CPU tensors; a CUDA tensor launches the kernel
or raises; ``decode_attention.launches`` counts launches. No
``pl.pallas_call`` of the reference computes it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels._build import check, library, on_card, stream_of
from repro_torch.kernels.threefry import (_div, _fma, exp_plain, fold_sum,
                                          seq_sum, to_f32)

NEG_INF = -1e30
THREADS = 256                      # csrc/decode_attention.cu: kAttnThreads
WARPS = THREADS // 32
MAX_GROUP = 16                     # kMaxGroup
MAX_SMEM = 232448 - 2 * WARPS * MAX_GROUP * 4   # the dynamic shared memory
HEAD_CHUNK = 4                     # kHeadChunk
MAX_CLUSTER = 16                   # kMaxCluster: the split form's CTAs
SPLIT_MAX_SMEM = 232448 - 1280     # kSplitMaxSmem
SPLIT_SLOTS = 128                  # the slots a split CTA takes at most
_DTYPES = (torch.float32, torch.bfloat16)


def head_scale(hd: int, dtype) -> float:
    """``sqrt(hd)`` rounded to the compute dtype, as an f32 value."""
    return float(torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype))


def cache_slots(pos: torch.Tensor, slots: int, window: int) -> torch.Tensor:
    """Each lane's slot: ``pos mod slots`` in a ring buffer (``window >
    0``), else ``min(pos, slots − 1)``."""
    return pos % slots if window > 0 else torch.clamp(pos, max=slots - 1)


def segment(hd: int, cache_dtype) -> tuple:
    """``(E, TPR)``: the elements a thread holds, 16 bytes of the cache
    dtype (32 where a row would span more than a warp: an f32 row of 256),
    and the threads that share a row of ``hd``."""
    e = 128 // torch.finfo(cache_dtype).bits
    if hd // e > 32:
        e *= 2
    return e, hd // e


def split_of(r: int, hd: int, slots: int, cache_dtype):
    """``(NC, TS)`` of the split form, or ``None`` where one CTA a (lane,
    KV head) holds the cache (rows of at most 32 segments of 16 bytes,
    :func:`smem_bytes` within ``MAX_SMEM``): NC CTAs, the least power of
    two with ``NC · SPLIT_SLOTS >= slots`` (at most ``MAX_CLUSTER``), each
    over ``TS = ceil(slots / NC)`` slots."""
    e = 128 // torch.finfo(cache_dtype).bits
    if hd // e <= 32 and smem_bytes(r, hd, slots, hd // e) <= MAX_SMEM:
        return None
    nc = 1
    while nc * SPLIT_SLOTS < slots and nc < MAX_CLUSTER:
        nc *= 2
    return nc, -(-slots // nc)


def _pad(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with zeros appended along ``dim`` to length ``n``."""
    if x.shape[dim] == n:
        return x
    shape = list(x.shape)
    shape[dim] = n - x.shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def dot_plain(qf: torch.Tensor, kf: torch.Tensor, e: int) -> torch.Tensor:
    """The scores' f32 sums, in the kernel's order: ``qf`` ``(..., r, hd)``
    and ``kf`` ``(..., slots, hd)`` f32 -> ``(..., r, slots)``: an fma
    chain over each segment of ``e`` elements from +0, then the halving
    tree over a row's segments."""
    tpr = qf.shape[-1] // e
    qs = qf.reshape(qf.shape[:-1] + (1, tpr, e))
    ks = kf.reshape(kf.shape[:-2] + (1,) + kf.shape[-2:-1] + (tpr, e))
    acc = torch.zeros(torch.broadcast_shapes(qs.shape, ks.shape)[:-1],
                      device=qf.device)
    for i in range(e):
        acc = _fma(qs[..., i], ks[..., i], acc)
    return fold_sum(acc)


def _tiles(x: torch.Tensor, dim: int, ts: int):
    """``x`` cut along ``dim`` into tiles of ``ts`` (the last may be
    short)."""
    return [x.narrow(dim, i, min(ts, x.shape[dim] - i))
            for i in range(0, x.shape[dim], ts)]


def _ranks(parts) -> torch.Tensor:
    """The tiles' sums added in rank order, from the first (no +0)."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def softmax_sum_plain(ex: torch.Tensor, ts: int = 0) -> torch.Tensor:
    """The softmax's f32 sum over the last axis (the slots), in the
    kernel's order: a tile's (of ``ts`` slots; all of them with ``ts`` 0)
    thread ``tid``'s terms ``t = tid, tid + THREADS, ...`` from +0, a warp's
    halving tree, the warps in order from +0; the tiles in rank order."""
    parts = []
    for tile in _tiles(ex, -1, ts or ex.shape[-1]):
        lead, slots = tile.shape[:-1], tile.shape[-1]
        n = -(-slots // THREADS)
        terms = _pad(tile, -1, n * THREADS).reshape(lead + (n, THREADS))
        part = fold_sum(seq_sum(terms.transpose(-1, -2)).reshape(
            lead + (WARPS, 32)))
        parts.append(seq_sum(part))
    return _ranks(parts)


def weighted_plain(probs: torch.Tensor, vf: torch.Tensor,
                   tpr: int, ts: int = 0) -> torch.Tensor:
    """The weighted values' f32 sums, in the kernel's order: ``probs``
    ``(..., r, slots)`` and ``vf`` ``(..., slots, hd)`` -> ``(..., r,
    hd)``: in a tile (of ``ts`` slots; all of them with ``ts`` 0) thread
    (row group ``g``, segment) over its rows ``g, g + RPP, ...`` as an fma
    chain from +0, a halving tree over a warp's row groups, the warps in
    order from +0; the tiles in rank order."""
    ts = ts or vf.shape[-2]
    parts = []
    for pt, vt in zip(_tiles(probs, -1, ts), _tiles(vf, -2, ts)):
        lead, slots, hd = vt.shape[:-2], vt.shape[-2], vt.shape[-1]
        r, rpp = pt.shape[-2], THREADS // tpr
        n = -(-slots // rpp)
        pr = _pad(pt, -1, n * rpp).reshape(lead + (r, n, rpp, 1))
        vv = _pad(vt, -2, n * rpp).reshape(lead + (1, n, rpp, hd))
        acc = torch.zeros(lead + (r, rpp, hd), device=vt.device)
        for i in range(n):
            acc = _fma(pr[..., i, :, :], vv[..., i, :, :], acc)
        acc = acc.reshape(lead + (r, WARPS, 32 // tpr, hd)).transpose(-1, -2)
        parts.append(seq_sum(fold_sum(acc).transpose(-1, -2)))
    return _ranks(parts)


def decode_attention_plain(q, k_new, v_new, k_cache, v_cache, slot_pos, pos,
                           window: int = 0) -> torch.Tensor:
    """The kernel's arithmetic in torch ops, in its order
    (``csrc/decode_attention.cu``, its head comment)."""
    g, b, h, hd = q.shape
    slots, kv = k_cache.shape[2], k_cache.shape[3]
    r, dt = h // kv, q.dtype
    e, tpr = segment(hd, k_cache.dtype)
    ts = (split_of(r, hd, slots, k_cache.dtype) or (1, 0))[1]
    pos = pos.to(torch.int64)
    slot = cache_slots(pos, slots, window)
    rows = torch.arange(b, device=q.device)
    k_cache[:, rows, slot] = k_new.to(k_cache.dtype)
    v_cache[:, rows, slot] = v_new.to(v_cache.dtype)
    slot_pos[:, rows, slot] = pos.to(torch.int32)
    # the scores (g, b, kv, r, slots), rounded to dt, over sqrt(hd) in dt
    s = dot_plain(q.float().reshape(g, b, kv, r, hd),
                  k_cache.to(dt).float().transpose(2, 3), e)
    s = _div(s.to(dt).float(), torch.full_like(s, head_scale(hd, dt)))
    s = s.to(dt).float()
    sp = slot_pos.to(torch.int64)[:, :, None, None, :]
    p = pos[None, :, None, None, None]
    valid = (sp >= 0) & (sp <= p)
    if window > 0:
        valid = valid & (sp > p - window)
    s = s.masked_fill(~valid, float(torch.tensor(NEG_INF).to(dt)))
    ex = exp_plain(s - s.amax(dim=-1, keepdim=True))
    probs = _div(ex, softmax_sum_plain(ex, ts)[..., None]).to(dt).float()
    out = weighted_plain(probs, v_cache.to(dt).float().transpose(2, 3), tpr,
                         ts)
    return out.to(dt).reshape(g, b, h, hd)


def row_tile(tpr: int) -> int:
    """``row_tile`` of ``csrc/decode_attention.cu``: the rows of K (and of
    V) a kernel thread stages at once."""
    return min(8, max(1, tpr // 2))


def smem_bytes(r: int, hd: int, slots: int, tpr: int) -> int:
    """The one-CTA form's dynamic shared memory: the staged K and V rows,
    then the queries, the scores and the warps' P·V sums in f32, the heads
    padded to chunks of ``HEAD_CHUNK``."""
    rp = -(-r // HEAD_CHUNK) * HEAD_CHUNK
    return 2 * 16 * row_tile(tpr) * THREADS + \
        4 * (rp * hd + rp * slots + WARPS * rp * hd)


def split_smem_bytes(r: int, hd: int, ts: int, cache_dtype) -> int:
    """The split form's dynamic shared memory a CTA (``split_stage`` and
    ``split_rest`` of the kernel): its threads' staged K rows, and V rows
    beside them where both fit in ``SPLIT_MAX_SMEM`` (else in their
    place), then the queries, the tile's scores, a head chunk's warp sums
    and the CTA's P·V sums in f32, and the tile's slot_pos."""
    rp = -(-r // HEAD_CHUNK) * HEAD_CHUNK
    e, tpr = segment(hd, cache_dtype)
    seg = e * torch.finfo(cache_dtype).bits // 128
    rpp = THREADS // tpr
    stage = -(-ts // rpp) * THREADS * seg * 16
    rest = 4 * (rp * hd + rp * ts + WARPS * HEAD_CHUNK * hd + rp * hd
                + -(-ts // 4) * 4)
    return (2 if 2 * stage + rest <= SPLIT_MAX_SMEM else 1) * stage + rest


def _check(q, k_new, v_new, k_cache, v_cache, slot_pos, pos, window):
    g, b, h, hd = q.shape
    if k_cache.dim() != 5 or k_cache.shape[:2] != (g, b) or \
            k_cache.shape[4] != hd or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} for q {tuple(q.shape)}")
    slots, kv = k_cache.shape[2], k_cache.shape[3]
    if h % kv or h // kv > MAX_GROUP:
        raise ValueError(f"decode_attention: {h} heads over {kv} KV heads "
                         f"(groups of at most {MAX_GROUP} heads)")
    if k_new.shape != (g, b, kv, hd) or v_new.shape != k_new.shape:
        raise ValueError(f"decode_attention: new rows {tuple(k_new.shape)}, "
                         f"{tuple(v_new.shape)}")
    if slot_pos.shape != (g, b, slots) or pos.shape != (b,):
        raise ValueError(f"decode_attention: slot_pos {tuple(slot_pos.shape)}"
                         f", pos {tuple(pos.shape)}")
    if window < 0:
        raise ValueError(f"decode_attention: window {window}")
    e1 = 128 // torch.finfo(k_cache.dtype).bits
    segs = hd // e1
    if hd % e1 or segs > 64 or segs & (segs - 1):
        raise ValueError(f"decode_attention: head_dim {hd} of "
                         f"{k_cache.dtype} is not 16 bytes times a power of "
                         f"two up to 64")


def _check_card(q, k_new, v_new, k_cache, v_cache):
    """What the kernel alone cannot take: a row of fewer than 4 segments of
    16 bytes (a head dim under 32 bf16 or 16 f32), a split form's tile
    beyond the card's shared memory, rows off 16-byte alignment."""
    g, b, h, hd = q.shape
    slots, kv = k_cache.shape[2], k_cache.shape[3]
    r = h // kv
    segs = hd // (128 // torch.finfo(k_cache.dtype).bits)
    if segs < 4:
        raise ValueError(f"decode_attention: the kernel takes rows of 4 to "
                         f"64 segments of 16 bytes, not a head dim of {hd} "
                         f"of {k_cache.dtype}")
    split = split_of(r, hd, slots, k_cache.dtype)
    if split is not None:
        need = split_smem_bytes(r, hd, split[1], k_cache.dtype)
        if need > SPLIT_MAX_SMEM:
            raise ValueError(f"decode_attention: {slots} slots of {r} heads "
                             f"of {hd} over {split[0]} CTAs need {need} "
                             f"bytes of shared memory a CTA, the kernel has "
                             f"{SPLIT_MAX_SMEM}")
    for t in (k_new, v_new, k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention: the new rows and the caches "
                             "must be 16-byte aligned")


def decode_attention(q, k_new, v_new, k_cache, v_cache, slot_pos, pos,
                     window: int = 0) -> torch.Tensor:
    """q ``(G, B, H, hd)``, k_new and v_new ``(G, B, KV, hd)`` in the
    compute dtype (f32 or bf16); the caches ``(G, B, slots, KV, hd)`` (f32
    or bf16) and ``slot_pos`` ``(G, B, slots)`` int32 are updated in place;
    ``pos`` ``(B,)`` int64, each lane's position. Returns ``(G, B, H, hd)``
    in the compute dtype."""
    _check(q, k_new, v_new, k_cache, v_cache, slot_pos, pos, window)
    dt = q.dtype
    if dt not in _DTYPES or k_cache.dtype not in _DTYPES:
        raise ValueError(f"decode_attention: dtypes {dt}, {k_cache.dtype}")
    if not on_card("decode_attention", [
            (q, dt), (k_new, dt), (v_new, dt), (k_cache, k_cache.dtype),
            (v_cache, k_cache.dtype), (slot_pos, torch.int32),
            (pos, torch.int64)]):
        return decode_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                      slot_pos, pos, window)
    _check_card(q, k_new, v_new, k_cache, v_cache)
    g, b, h, hd = q.shape
    slots, kv = k_cache.shape[2], k_cache.shape[3]
    nc, ts = split_of(h // kv, hd, slots, k_cache.dtype) or (0, 0)
    scale = head_scale(hd, dt)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = library().repro_decode_attention(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), slot_pos.data_ptr(),
            pos.data_ptr(), out.data_ptr(), g * b, b, h, kv, hd, slots,
            window, scale, to_f32(1.0 / scale), int(dt == torch.bfloat16),
            int(k_cache.dtype == torch.bfloat16), nc, ts, stream_of(q))
    check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
