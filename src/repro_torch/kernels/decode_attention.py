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
kernel's source comment states. The one-CTA form: each dot product as fma
chains over a thread's 16 bytes of the cache row and a halving tree over
the row's threads; the softmax's sum thread by thread, then a warp's tree,
then the warps in order; the weighted values as fma chains over a thread's
rows, then a tree over a warp's row groups, then the warps in order. A
cache that one CTA cannot hold (recurrentgemma-9b's ring of 2,048 slots
under 16 heads of 256, or any f32 row of 256) takes the split form: a
portable cluster of up to 8 CTAs a (lane, KV head), each over a tile of
the slots (:func:`split_of`, a function of the lane's shapes alone). There
each dot product is one fma chain over the head dim from +0 (a lane 4
slots by 4 heads); the softmax's sum as in the one-CTA form, a tile at a
time; each weighted value one fma chain over the tile's rows in order
from +0 (a thread 4 heads by 4 columns); the tiles' sums added in rank
order; K and V streamed through one ring of stages sized for two CTAs an
SM (:func:`split_stages`), each stage one tensor copy (TMA) that an
mbarrier reports landed. The plain version follows both orders op for
op (single-rounding ``_fma`` and ``_div``), so kernel and plain version
agree bit for bit. The reference sums in f32 in XLA's order, so against
it the port is within f32 summation error before the ``dt`` rounding. On
an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py) a layer of
recurrentgemma-9b's bf16 step at 16 lanes takes 0.0532 ms in the split
form, against SDPA's 0.0269 (an A/B in one run: 0.0522-0.0529 against
0.0549 with cp.async stages); its first design, 16-CTA clusters of 128
slots with a shuffle tree a score, took 0.15936.

The plain version runs for CPU tensors; a CUDA tensor launches the kernel
or raises; ``decode_attention.launches`` counts launches. No
``pl.pallas_call`` of the reference computes it.
"""
from __future__ import annotations

import ctypes
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
MAX_CLUSTER = 8                    # kMaxCluster: a portable cluster's CTAs
MAX_STAGES = 16                    # kMaxStages: the ring's mbarriers
# kSplitStatic: the split kernel's static shared arrays, padded to the 1 KB
# that its ring's alignment takes
SPLIT_STATIC = -(-(4 * (2 * WARPS * MAX_GROUP + 5 * MAX_GROUP +
                        MAX_GROUP * MAX_CLUSTER) + 8 * MAX_STAGES)
                 // 1024) * 1024
SPLIT_MAX_SMEM = 232448 - SPLIT_STATIC              # kSplitMaxSmem
SPLIT_TWO_SMEM = 233472 // 2 - 1024 - SPLIT_STATIC  # kSplitTwoSmem
SPLIT_SLOTS = 256                  # a split CTA's slots (at most 8 CTAs)
STAGE_BYTES = 16384                # kStageBytes: a K or V stage
SPLIT_CLOCKS = 13                  # kSplitClocks
_DTYPES = (torch.float32, torch.bfloat16)


def head_scale(hd: int, dtype) -> float:
    """``sqrt(hd)`` rounded to the compute dtype, as an f32 value."""
    return float(torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype))


def cache_slots(pos: torch.Tensor, slots: int, window: int) -> torch.Tensor:
    """Each lane's slot: ``pos mod slots`` in a ring buffer (``window >
    0``), else ``min(pos, slots − 1)``."""
    return pos % slots if window > 0 else torch.clamp(pos, max=slots - 1)


def segment(hd: int, cache_dtype) -> tuple:
    """``(E, TPR)`` of the one-CTA form: the elements a thread holds, 16
    bytes of the cache dtype, and the threads that share a row of
    ``hd``."""
    e = 128 // torch.finfo(cache_dtype).bits
    return e, hd // e


def split_of(r: int, hd: int, slots: int, cache_dtype):
    """``(NC, TS)`` of the split form, or ``None`` where one CTA a (lane,
    KV head) holds the cache (rows of at most 32 segments of 16 bytes,
    :func:`smem_bytes` within ``MAX_SMEM``): NC CTAs, the least power of
    two with ``NC · SPLIT_SLOTS >= slots`` (at most ``MAX_CLUSTER``), each
    over ``TS = ceil(slots / NC)`` slots. A function of one lane's shapes
    alone (never of the lane count or the device), so the plain version
    takes the same tiles and a lane's output is the same whatever lanes
    share its launch."""
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
    tree over a row's segments (the one-CTA form's); with ``e = hd`` one
    chain over the row (the split form's)."""
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
    kernel's order, both forms': a tile's (of ``ts`` slots; all of them
    with ``ts`` 0) thread ``tid``'s terms ``t = tid, tid + THREADS, ...``
    from +0, a warp's halving tree, the warps in order from +0; the tiles
    in rank order from the first."""
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
    hd)``. With ``ts`` 0 the one-CTA form's: thread (row group ``g``,
    segment) over its rows ``g, g + RPP, ...`` (``RPP = THREADS / tpr``)
    as an fma chain from +0, a halving tree over a warp's row groups, the
    warps in order from +0. With ``ts`` the split form's: each output one
    fma chain over a tile's ``ts`` rows in order from +0 (the last tile
    may be short), the tiles in rank order from the first."""
    if ts:
        lead, slots, hd = vf.shape[:-2], vf.shape[-2], vf.shape[-1]
        r, nc = probs.shape[-2], -(-slots // ts)
        pr = _pad(probs, -1, nc * ts).reshape(lead + (r, nc, ts, 1))
        vv = _pad(vf, -2, nc * ts).reshape(lead + (1, nc, ts, hd))
        acc = torch.zeros(lead + (r, nc, hd), device=vf.device)
        for t in range(ts):      # padded rows add fma(0, 0, acc) = acc
            acc = _fma(pr[..., t, :], vv[..., t, :], acc)
        return _ranks(acc.unbind(-2))
    lead, slots, hd = vf.shape[:-2], vf.shape[-2], vf.shape[-1]
    r, rpp = probs.shape[-2], THREADS // tpr
    n = -(-slots // rpp)
    pr = _pad(probs, -1, n * rpp).reshape(lead + (r, n, rpp, 1))
    vv = _pad(vf, -2, n * rpp).reshape(lead + (1, n, rpp, hd))
    acc = torch.zeros(lead + (r, rpp, hd), device=vf.device)
    for i in range(n):
        acc = _fma(pr[..., i, :, :], vv[..., i, :, :], acc)
    acc = acc.reshape(lead + (r, WARPS, 32 // tpr, hd)).transpose(-1, -2)
    return seq_sum(fold_sum(acc).transpose(-1, -2))


def decode_attention_plain(q, k_new, v_new, k_cache, v_cache, slot_pos, pos,
                           window: int = 0) -> torch.Tensor:
    """The kernel's arithmetic in torch ops, in its order
    (``csrc/decode_attention.cu``, its head comment)."""
    g, b, h, hd = q.shape
    slots, kv = k_cache.shape[2], k_cache.shape[3]
    r, dt = h // kv, q.dtype
    e, tpr = segment(hd, k_cache.dtype)
    ts = (split_of(r, hd, slots, k_cache.dtype) or (1, 0))[1]
    if ts:
        e = hd                   # the split form: one chain a dot product
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


def _split_rest(r: int, hd: int, ts: int, dtype) -> int:
    """``split_rest`` of the kernel: the f32 queries (``hd`` by the heads
    padded to 4), then in their place the f32 probabilities, and the tile's
    scores in the compute dtype (``ts`` rows of the heads padded to 4, and
    to a P·V thread's heads, ``hd / 64``)."""
    tsize = torch.finfo(dtype).bits // 8
    rp = -(-r // 4) * 4
    hop = max(4, hd // 64)
    rps = -(-rp // hop) * hop
    return 4 * max(hd * rp, ts * rps) + tsize * ts * rps


def split_stages(r: int, hd: int, ts: int, dtype) -> int:
    """``split_stages`` of the kernel: the ring's stages of ``STAGE_BYTES``,
    as many as fit beside the rest in the shared memory of one of two CTAs
    that share an SM, or where not two fit there in one CTA's, at most
    ``MAX_STAGES``; 0 where not two fit at all."""
    rest = _split_rest(r, hd, ts, dtype)
    two = (SPLIT_TWO_SMEM - rest) // STAGE_BYTES
    one = (SPLIT_MAX_SMEM - rest) // STAGE_BYTES
    return min(MAX_STAGES, two if two >= 2 else one if one >= 2 else 0)


def split_smem_bytes(r: int, hd: int, ts: int, dtype) -> int:
    """The split form's dynamic shared memory a CTA: the ring's stages,
    then the queries and the tile's scores (:func:`split_stages`)."""
    return split_stages(r, hd, ts, dtype) * STAGE_BYTES + \
        _split_rest(r, hd, ts, dtype)


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
    if split is not None and not split_stages(r, hd, split[1], q.dtype):
        raise ValueError(f"decode_attention: {slots} slots of {r} heads of "
                         f"{hd} over {split[0]} CTAs leave no room for two "
                         f"stages of {STAGE_BYTES} bytes in a CTA's "
                         f"{SPLIT_MAX_SMEM} of shared memory")
    for t in (k_new, v_new, k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention: the new rows and the caches "
                             "must be 16-byte aligned")


def _launch(entry, q, k_new, v_new, k_cache, v_cache, slot_pos, pos,
            window, *extra) -> torch.Tensor:
    """One launch of the C ``entry`` (``repro_decode_attention`` or its
    timed twin) over these tensors, ``extra`` before the stream; returns
    the output."""
    g, b, h, hd = q.shape
    slots, kv = k_cache.shape[2], k_cache.shape[3]
    nc, ts = split_of(h // kv, hd, slots, k_cache.dtype) or (0, 0)
    dt = q.dtype
    scale = head_scale(hd, dt)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = entry(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), slot_pos.data_ptr(),
            pos.data_ptr(), out.data_ptr(), g * b, b, h, kv, hd, slots,
            window, scale, to_f32(1.0 / scale), int(dt == torch.bfloat16),
            int(k_cache.dtype == torch.bfloat16), nc, ts, *extra,
            stream_of(q))
    check(rc, "decode_attention")
    return out


def _args(q, k_new, v_new, k_cache, v_cache, slot_pos, pos, window) -> bool:
    """The arguments checked; True where they lie on the card."""
    _check(q, k_new, v_new, k_cache, v_cache, slot_pos, pos, window)
    dt = q.dtype
    if dt not in _DTYPES or k_cache.dtype not in _DTYPES:
        raise ValueError(f"decode_attention: dtypes {dt}, {k_cache.dtype}")
    card = on_card("decode_attention", [
        (q, dt), (k_new, dt), (v_new, dt), (k_cache, k_cache.dtype),
        (v_cache, k_cache.dtype), (slot_pos, torch.int32),
        (pos, torch.int64)])
    if card:
        _check_card(q, k_new, v_new, k_cache, v_cache)
    return card


def decode_attention(q, k_new, v_new, k_cache, v_cache, slot_pos, pos,
                     window: int = 0) -> torch.Tensor:
    """q ``(G, B, H, hd)``, k_new and v_new ``(G, B, KV, hd)`` in the
    compute dtype (f32 or bf16); the caches ``(G, B, slots, KV, hd)`` (f32
    or bf16) and ``slot_pos`` ``(G, B, slots)`` int32 are updated in place;
    ``pos`` ``(B,)`` int64, each lane's position. Returns ``(G, B, H, hd)``
    in the compute dtype."""
    if not _args(q, k_new, v_new, k_cache, v_cache, slot_pos, pos, window):
        return decode_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                      slot_pos, pos, window)
    out = _launch(library().repro_decode_attention, q, k_new, v_new,
                  k_cache, v_cache, slot_pos, pos, window)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def split_clock_slots(lanes: int, kv: int, nc: int) -> int:
    """The int64s of a split launch's clocks: ``SPLIT_CLOCKS`` and 3 for
    each of its ``lanes · kv · nc`` CTAs."""
    return SPLIT_CLOCKS + 3 * lanes * kv * nc


def decode_attention_clocks(q, k_new, v_new, k_cache, v_cache, slot_pos,
                            pos, window: int = 0) -> tuple:
    """:func:`decode_attention`'s split form on the card with its phase
    clocks (a timed build of the kernel, for bf16 compute and cache at a
    head dim of 256, recurrentgemma-9b's; not counted in ``launches``):
    returns the output and an int64 tensor of ``SPLIT_CLOCKS`` and 3 a CTA
    (:func:`split_clock_slots`): the first CTA's ``clock64()`` at the ends
    of its phases (start, first K stage landed, scores, maxima exchanged,
    its sums, sums exchanged, probabilities, P·V, rank sums), the cycles it
    waited for its stages in the scores and in P·V and in the cluster's
    barriers after the maxima and the sums; then each CTA's globaltimer
    (ns) at its start and before its last barrier, and its SM."""
    g, b, h, hd = q.shape
    slots, kv = k_cache.shape[2], k_cache.shape[3]
    split = split_of(h // kv, hd, slots, k_cache.dtype)
    if not _args(q, k_new, v_new, k_cache, v_cache, slot_pos, pos,
                 window) or split is None or hd != 256 or \
            q.dtype != torch.bfloat16 or k_cache.dtype != torch.bfloat16:
        raise ValueError("decode_attention: clocks are the split form's on "
                         "the card, bf16 at a head dim of 256")
    clocks = torch.zeros(split_clock_slots(g * b, kv, split[0]),
                         dtype=torch.int64, device=q.device)
    out = _launch(library().repro_decode_attention_clocks, q, k_new, v_new,
                  k_cache, v_cache, slot_pos, pos, window, clocks.data_ptr())
    return out, clocks


def split_clusters(lanes: int, h: int, kv: int, hd: int, slots: int, dtype,
                   cache_dtype) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the split form's launch over
    ``lanes`` lanes of these shapes on the current card: how many of its
    clusters run at once. No launch."""
    nc, ts = split_of(h // kv, hd, slots, cache_dtype)
    n = ctypes.c_int(0)
    rc = library().repro_decode_attention_clusters(
        lanes, h, kv, hd, slots, int(dtype == torch.bfloat16),
        int(cache_dtype == torch.bfloat16), nc, ts, ctypes.addressof(n))
    check(rc, "decode_attention (occupancy)")
    return n.value
