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

The kernel sums each dot product's exact products (a product of two
bfloat16, or of two f32, values is exact in float64) in float64 and rounds
the sum to f32, then to ``dt``; the plain version computes the same sums in
float64 in torch's order. So the two agree bit for bit unless a float64
sum's rounding error meets an f32 tie (about 2^-29 a value): the stated
tolerance is one ``dt`` ulp of the output. The reference sums in f32 in
XLA's order, so against it the port is within f32 summation error before
the ``dt`` rounding.

The plain version runs for CPU tensors; a CUDA tensor launches the kernel
or raises; ``decode_attention.launches`` counts launches. No
``pl.pallas_call`` of the reference computes it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels._build import check, library, on_card, stream_of

NEG_INF = -1e30
MAX_GROUP = 16                     # csrc/decode_attention.cu: kMaxGroup
MAX_GROUP_DIMS = 2048              # kMaxOut x kAttnThreads: r * hd
_DTYPES = (torch.float32, torch.bfloat16)


def head_scale(hd: int, dtype) -> float:
    """``sqrt(hd)`` rounded to the compute dtype, as an f32 value."""
    return float(torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype))


def cache_slots(pos: torch.Tensor, slots: int, window: int) -> torch.Tensor:
    """Each lane's slot: ``pos mod slots`` in a ring buffer (``window >
    0``), else ``min(pos, slots − 1)``."""
    return pos % slots if window > 0 else torch.clamp(pos, max=slots - 1)


def decode_attention_plain(q, k_new, v_new, k_cache, v_cache, slot_pos, pos,
                           window: int = 0) -> torch.Tensor:
    """The kernel's arithmetic in torch ops (see the module docstring)."""
    g, b, h, hd = q.shape
    slots, kv = k_cache.shape[2], k_cache.shape[3]
    dt = q.dtype
    pos = pos.to(torch.int64)
    slot = cache_slots(pos, slots, window)
    rows = torch.arange(b, device=q.device)
    k_cache[:, rows, slot] = k_new.to(k_cache.dtype)
    v_cache[:, rows, slot] = v_new.to(v_cache.dtype)
    slot_pos[:, rows, slot] = pos.to(torch.int32)
    qg = q.reshape(g, b, kv, h // kv, hd).double()
    s = torch.einsum("gbvrk,gbtvk->gbvrt", qg, k_cache.to(dt).double())
    s = s.float().to(dt).float()
    s = (s / torch.full_like(s, head_scale(hd, dt))).to(dt)
    sp = slot_pos.to(torch.int64)[:, :, None, None, :]
    p = pos[None, :, None, None, None]
    valid = (sp >= 0) & (sp <= p)
    if window > 0:
        valid = valid & (sp > p - window)
    sf = s.masked_fill(~valid, NEG_INF).float()
    e = torch.exp((sf - sf.amax(dim=-1, keepdim=True)).double()).float()
    tot = e.double().sum(dim=-1, keepdim=True).float()
    probs = (e / tot).to(dt)
    ctx = torch.einsum("gbvrt,gbtvk->gbvrk", probs.double(),
                       v_cache.to(dt).double())
    return ctx.float().to(dt).reshape(g, b, h, hd)


def _check(q, k_new, v_new, k_cache, v_cache, slot_pos, pos, window):
    g, b, h, hd = q.shape
    if k_cache.dim() != 5 or k_cache.shape[:2] != (g, b) or \
            k_cache.shape[4] != hd or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} for q {tuple(q.shape)}")
    slots, kv = k_cache.shape[2], k_cache.shape[3]
    if h % kv or h // kv > MAX_GROUP or (h // kv) * hd > MAX_GROUP_DIMS:
        raise ValueError(f"decode_attention: {h} heads of {hd} over {kv} "
                         f"KV heads (groups of at most {MAX_GROUP} heads, "
                         f"{MAX_GROUP_DIMS} dims)")
    if k_new.shape != (g, b, kv, hd) or v_new.shape != k_new.shape:
        raise ValueError(f"decode_attention: new rows {tuple(k_new.shape)}, "
                         f"{tuple(v_new.shape)}")
    if slot_pos.shape != (g, b, slots) or pos.shape != (b,):
        raise ValueError(f"decode_attention: slot_pos {tuple(slot_pos.shape)}"
                         f", pos {tuple(pos.shape)}")
    if window < 0:
        raise ValueError(f"decode_attention: window {window}")


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
    g, b, h, hd = q.shape
    slots, kv = k_cache.shape[2], k_cache.shape[3]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = library().repro_decode_attention(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), slot_pos.data_ptr(),
            pos.data_ptr(), out.data_ptr(), g * b, b, h, kv, hd, slots,
            window, head_scale(hd, dt), int(dt == torch.bfloat16),
            int(k_cache.dtype == torch.bfloat16), stream_of(q))
    check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
