"""Threefry2x32 draws as ``jax.random`` makes them, one launch a table.

The counter-based generator of JAX's default PRNG (Random123's
threefry2x32: 20 rounds, rotations (13, 15, 26, 6) and (17, 29, 16, 24),
key schedule ``k0 ^ k1 ^ 0x1BD11BDA``, a key injection every 4 rounds) in
its ``jax_threefry_partitionable`` form, which JAX 0.9 uses by default:
element ``j`` of a draw hashes the counter pair ``(j >> 32, j & 0xffffffff)``
under the key. A key is two uint32 words held in int64.

One launch draws a table of :class:`Draw` requests. A request is ``R``
streams, one a row of its ``(R, 2)`` key tensor, each ``n`` elements long,
under one transform:

- ``PAIR``: both output words on counters ``(0, counter + i)``, a key an
  element: ``split`` and ``fold_in`` for a whole level of keys. With
  ``fold`` set, each key is then folded in with ``fold`` (a second hash).
  ``counter`` may be a one-element int32 tensor on the keys' device (a
  round index): the kernel reads it when it runs, so a CUDA graph that
  captured the launch draws each replay's own keys, and the host never
  reads it.
- ``BITS``: ``b1 ^ b2``, the 32 random bits of ``jax.random.bits``.
- ``UNIFORM``: ``max(lo, fma(f − 1, hi − lo, lo))``, ``f`` the float in
  ``[1, 2)`` whose mantissa is the bits' top 23 (``random.py:435``).
- ``GUMBEL``: ``−log(−log(u))`` of that uniform over ``[lo, hi)`` =
  ``[tiny, 1)``, by XLA's f32 log: ``jax.random.gumbel`` in its ``"low"``
  mode, the noise of ``categorical`` (the decode sampler's).
- ``NORMAL``: ``erfinv`` of that uniform, times ``mult``, clipped to
  ``[clip_lo, clip_hi]``, times ``scale``: ``normal`` (``lo`` =
  nextafter(−1, 0), ``hi`` = 1, ``mult`` = √2, no clip) and
  ``truncated_normal`` (``lo``, ``hi`` the erf of the bounds; clipped
  inside them). A caller's scale comes in where the reference's executes
  it: inside ``jit`` XLA folds ``scale · (√2 · erfinv)`` into ``erfinv ·
  fl32(√2 · scale)`` (the Langevin noise: ``mult``), while ``dense_init``'s
  eager ``std · truncated_normal`` multiplies the clipped draw (``scale``).

Rounding follows the reference as it executes on the CPU. XLA contracts
``(f − 1)·span + lo`` into one fma, and evaluates erfinv (XLA's ErfInv32:
``w = −log1p(−x²)``, two 9-coefficient polynomials split at ``w = 5``, fma
Horner steps) with its own log1p: a rational Cephes form below
``|z| < √2 − 1`` and, above it, ``log(1 + z)`` by its Cephes-style f32
log (:func:`log_plain`, which is ``jax.jit(jnp.log)`` bit for bit: XLA's
CPU log is not correctly rounded, so ``torch.log`` is not it), every
multiply-add contracted as XLA's compiled code contracts it.
:func:`erfinv_plain` transcribes that sequence op for op (single-rounding
fma by :func:`fma_f32`), and the CUDA kernel (``csrc/threefry.cu``, with
the hash and the log in ``csrc/threefry.cuh``, which ``bma_sample.cu``
shares) spells out the same sequence with ``__fmaf_rn`` and IEEE
``__f*_rn`` operations.

The plain version runs for CPU tensors (and ``meta`` ones, for shapes). A
CUDA tensor launches the kernel or raises; ``draw.launches`` counts
launches. No ``pl.pallas_call`` of the reference draws random numbers, so
this kernel replaces no TPU kernel: on the TPU the draws are XLA's.
"""
from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels._build import check, library, on_card, stream_of
from repro_torch.kernels.fused_update import fma_f32
from repro_torch.kernels.pack import c_array

PAIR, BITS, UNIFORM, NORMAL, GUMBEL = 0, 1, 2, 3, 4
M32 = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
MAX_TABLE_REQUESTS = 40            # csrc/threefry.cu: kMaxRequests
NUM_PARAMS = 6                     # f32 parameters a request
NO_CLIP = (float("-inf"), float("inf"))
TINY = float(np.finfo(np.float32).tiny)    # gumbel's minval, an f32


def f32(bits: int) -> float:
    """The f32 value of a bit pattern."""
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def to_f32(x: float) -> float:
    """``x`` rounded to f32, as the kernel's ``float`` parameters are."""
    return struct.unpack("<f", struct.pack("<f", x))[0]


# XLA's CPU constants (f32 bit patterns): the log's Cephes polynomial
# p0..p8 (three Horner chains, p0-p2, p3-p5, p6-p8), its exponent split
# q1 + q2 of ln 2, √½ and the smallest normal; log1p's rational form for
# small |z| and its switch point √2 − 1; ErfInv32's two polynomials
LOG_P = tuple(map(f32, (0x3d9021bb, 0xbdebd1b8, 0x3def251a, 0xbdfe5d4f,
                        0x3e11e9bf, 0xbe2aae50, 0x3e4cceac, 0xbe7ffffc,
                        0x3eaaaaaa)))
LOG_Q1, LOG_Q2 = f32(0xb95e8083), f32(0x3f318000)
SQRT_HALF, MIN_NORMAL = f32(0x3f3504f3), f32(0x00800000)
LOG1P_DEN = tuple(map(f32, (0x417101ad, 0x42a6185b, 0x435dc32d, 0x439a8ca3,
                            0x43586d8a, 0x42707982)))
LOG1P_NUM = tuple(map(f32, (0x383de04b, 0x3eff40c5, 0x40d284fa, 0x41ef4b9c,
                            0x4273cc76, 0x426473ad, 0x41a05101)))
LOG1P_SMALL = f32(0x3ed413cd)
ERFINV_LT5 = tuple(map(f32, (0x32f16588, 0x34b84b36, 0xb66c7357, 0xb6935ac1,
                             0x396532db, 0xbaa45408, 0xbb88e4ef, 0x3e7c8f63,
                             0x3fc02e2f)))
ERFINV_GE5 = tuple(map(f32, (0xb951f09b, 0x38d3b56b, 0x3ab0dc72, 0xbb70bde7,
                             0x3bbc127b, 0xbbf9c5d7, 0x3c1aa57e, 0x3f8036db,
                             0x40354f7e)))
SQRT2 = f32(0x3fb504f3)
# XLA's f32 erf: x·A(x²)/B(x²) on x clamped to ±ERF_CLAMP
ERF_CLAMP = f32(0x406f9c68)
ERF_A = tuple(map(f32, (0x39702d51, 0x3b5f5da2, 0x3d50b6eb, 0x3e3da740,
                        0x3f906eba)))
ERF_B = tuple(map(f32, (0xb3fd3906, 0x37c588df, 0x3a856d28, 0x3c6687d4,
                        0x3de34c21, 0x3efeb44a, 0x3f800000)))
# XLA's f32 exp: the input clamp, log2(e), the split C1 + C2 of ln 2 and the
# polynomial e0..e4 of its Horner chain (then 0.5, r², 1)
EXP_LO, EXP_HI = f32(0xc2af999a), f32(0x42b1999a)
EXP_LOG2E, EXP_C1, EXP_C2 = f32(0x3fb8aa3b), f32(0x3f318000), f32(0xb95e8083)
EXP_P = tuple(map(f32, (0x39506967, 0x3ab743ce, 0x3c088908, 0x3d2aa9c1,
                        0x3e2aaaaa)))


class Draw(NamedTuple):
    """A request of a table launch: ``keys.shape[0]`` streams of ``n``
    elements, one a key row. Output ``(R, n, 2)`` int64 keys for ``PAIR``,
    ``(R, n)`` int64 bits for ``BITS``, ``(R, n)`` f32 otherwise.
    ``params``: ``(lo, hi)`` for ``UNIFORM`` and ``GUMBEL``; ``(lo, hi, mult, clip_lo,
    clip_hi, scale)`` for ``NORMAL``; f32 values. ``counter``: an int, or
    for ``PAIR`` a one-element int32 tensor on the keys' device."""
    keys: torch.Tensor
    n: int
    kind: int = BITS
    counter: Union[int, torch.Tensor] = 0
    fold: Optional[int] = None
    params: Tuple[float, ...] = ()


# --------------------------------------------------------------------------
# plain version: int64 torch ops on uint32 values, f32 arithmetic
# --------------------------------------------------------------------------

def threefry2x32_plain(k0, k1, x0, x1):
    """Random123's threefry2x32, 20 rounds, on broadcastable int64 tensors
    of uint32 values; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _fma(a, b, c) -> torch.Tensor:
    """:func:`fma_f32` where ``c`` may be a Python float."""
    if not torch.is_tensor(c):
        c = torch.full_like(a if torch.is_tensor(a) else b, c)
    return fma_f32(a, b, c)


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 ``a / b``: in float64, rounded once more to
    f32 (53 >= 2·24 + 2 bits, so the double rounding is innocuous)."""
    return (a.double() / b.double()).float()


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum over the last axis added in order from +0, as a CUDA
    thread adds its terms one after another."""
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def fold_sum(x: torch.Tensor) -> torch.Tensor:
    """The f32 halving tree over the last axis (a power of two): element
    ``i`` plus element ``i + n/2``, and again, as a shuffle tree ``xor n/2,
    ..., 1`` adds a warp's lanes."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as :func:`_div` (torch's
    vectorized f32 ``sqrt`` on the CPU is not always)."""
    return x.double().sqrt().float()


def log_plain(a: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 log (its Cephes-style polynomial), op for op as its
    compiled code runs it: ``jax.jit(jnp.log)`` bit for bit (a NaN's sign
    bit aside). XLA's CPU code treats a subnormal input as zero: −inf."""
    c = torch.where(a > MIN_NORMAL, a, torch.full_like(a, MIN_NORMAL))
    bits = c.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    below = m < SQRT_HALF
    t = (m - 1.0) + torch.where(below, m, torch.zeros_like(m))
    e = e - below.float()
    t2 = t * t
    t3 = t2 * t
    p = LOG_P
    y0 = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    r = _fma(t3, _fma(t3, y0, y1), y2)
    s = _fma(t3, r, e * LOG_Q1) + _fma(-0.5, t2, t)
    out = _fma(e, LOG_Q2, s)
    out = torch.where(a <= 0, float("nan"), out)         # NaN a falls here too
    out = torch.where(torch.isnan(a), float("nan"), out)
    out = torch.where(a.abs() < MIN_NORMAL, float("-inf"), out)
    return torch.where(a == float("inf"), float("inf"), out)


def exp_plain(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 exp, op for op as its compiled code runs it (the
    ``exp_xla`` of ``csrc/threefry.cuh``): ``jax.jit(jnp.exp)`` bit for bit.
    ``x`` clamped to [-87.8, 88.8]; ``n = floor(fma(x, log2 e, 0.5))``
    clamped to ±127; ``r = x − n·C1 − n·C2`` (two fmas); ``p = 1 +
    fma(P(r), r², r)``, ``P`` a Horner chain of fmas; ``p · 2^n``. XLA's
    code runs with denormals flushed, so a result below the smallest normal
    (``n = −127``, or ``n = −126`` and ``p < 1``) is +0. Not correctly
    rounded: up to one ulp from the true exp."""
    c = x.clamp(EXP_LO, EXP_HI)
    n = torch.floor(_fma(c, EXP_LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = _fma(-n, EXP_C2, _fma(-n, EXP_C1, c))
    y = _fma(r, EXP_P[0], EXP_P[1])
    for coef in EXP_P[2:] + (0.5,):
        y = _fma(y, r, coef)
    p = _fma(y, r * r, r) + 1.0
    ni = torch.nan_to_num(n).to(torch.int32)
    out = p * ((ni + 127) << 23).view(torch.float32)
    out = torch.where((ni < -126) | ((ni == -126) & (p < 1.0)),
                      torch.zeros_like(out), out)
    return torch.where(torch.isnan(x), x, out)


def exp_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 exp of ``x``: the card's ``exp_xla`` (``csrc/threefry.cuh``,
    launched alone by ``repro_exp_xla``) for a CUDA tensor, ``exp_plain``
    for a CPU one. The decode kernels inline the same function; this entry
    point lets a check hold it against ``exp_plain``."""
    if not on_card("exp_xla", [(x, torch.float32)]):
        return exp_plain(x)
    y = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            rc = library().repro_exp_xla(x.data_ptr(), y.data_ptr(),
                                         x.numel(), stream_of(x))
        check(rc, "exp_xla")
        exp_xla.launches += 1
    return y


exp_xla.launches = 0


def log1p_plain(z: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 log1p, op for op as its compiled code runs it."""
    # |z| >= √2 − 1: log(1 + z), XLA's Cephes-style f32 log
    large = log_plain(z + 1.0)
    # |z| < √2 − 1: z − z²/2 + z³·P(z)/Q(z)
    zz = z * z
    den = z * 0.0 + 1.0
    for coef in LOG1P_DEN:
        den = _fma(den, z, coef)
    num = z * 0.0 + LOG1P_NUM[0]
    for coef in LOG1P_NUM[1:]:
        num = _fma(num, z, coef)
    small = z + _fma(-0.5, zz, (z * zz) * _div(num, den))
    return torch.where(z.abs() < LOG1P_SMALL, small, large)


def erfinv_plain(x: torch.Tensor) -> torch.Tensor:
    """XLA's ErfInv32 on f32 ``x``: ``x·P(w)``, ``w = −log1p(−x²)``."""
    lg = log1p_plain(x * -x)
    lt = lg > -5.0                                       # w < 5
    w = torch.where(lt, -2.5 - lg, _sqrt(-lg) - 3.0)
    p = torch.where(lt, ERFINV_LT5[0], ERFINV_GE5[0])
    for c_lt, c_ge in zip(ERFINV_LT5[1:], ERFINV_GE5[1:]):
        p = _fma(w, p, torch.where(lt, c_lt, c_ge))
    p = torch.where(x.abs() == 1.0, float("inf"), p)
    return x * p


def erf_plain(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erf (the bounds of ``truncated_normal``), op for op."""
    x = x.clamp(-ERF_CLAMP, ERF_CLAMP)
    x2 = x * x
    a = _fma(x2, ERF_A[0], ERF_A[1])
    for coef in ERF_A[2:]:
        a = _fma(a, x2, coef)
    b = _fma(x2, ERF_B[0], ERF_B[1])
    for coef in ERF_B[2:]:
        b = _fma(b, x2, coef)
    return _div(x * a, b)


def uniform_plain(b: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """f32 uniforms in ``[lo, hi)`` from int64 random bits."""
    lo, hi = to_f32(lo), to_f32(hi)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    span = torch.tensor(hi, dtype=torch.float32) - \
        torch.tensor(lo, dtype=torch.float32)
    u = _fma(f - 1.0, span.to(b.device), torch.full_like(f, lo))
    return torch.maximum(u, torch.tensor(lo, dtype=torch.float32,
                                         device=b.device))


def gumbel_plain(b: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``−log(−log(u))``, ``u`` the uniform in ``[lo, hi)`` of the bits."""
    return -log_plain(-log_plain(uniform_plain(b, lo, hi)))


def normal_plain(b: torch.Tensor, params) -> torch.Tensor:
    lo, hi, mult, clip_lo, clip_hi, scale = map(to_f32, params)
    z = erfinv_plain(uniform_plain(b, lo, hi)) * mult
    return z.clamp(clip_lo, clip_hi) * scale


def draw_one_plain(req: Draw) -> torch.Tensor:
    keys = req.keys.reshape(-1, 2)
    k0, k1 = keys[:, :1], keys[:, 1:]
    j = torch.arange(req.n, dtype=torch.int64, device=keys.device)[None]
    if req.kind == PAIR:
        counter = req.counter
        if torch.is_tensor(counter):
            counter = counter.reshape(()).to(torch.int64) & M32
        x0, x1 = threefry2x32_plain(k0, k1, torch.zeros_like(j),
                                    (j + counter) & M32)
        if req.fold is not None:
            x0, x1 = threefry2x32_plain(x0, x1, torch.zeros_like(x0),
                                        torch.full_like(x0, req.fold))
        return torch.stack([x0, x1], dim=-1)
    x0, x1 = threefry2x32_plain(k0, k1, j >> 32, j & M32)
    b = x0 ^ x1
    if req.kind == BITS:
        return b
    if req.kind == UNIFORM:
        return uniform_plain(b, *req.params)
    if req.kind == GUMBEL:
        return gumbel_plain(b, *req.params)
    return normal_plain(b, req.params)


def draw_plain(requests):
    return [draw_one_plain(req) for req in requests]


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------

def _check(req: Draw, i: int) -> None:
    keys = req.keys
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.stride(1) != 1:
        raise ValueError(f"threefry: request {i}: keys must be (R, 2) with "
                         f"unit column stride, got {tuple(keys.shape)} "
                         f"strides {keys.stride()}")
    if req.kind not in (PAIR, BITS, UNIFORM, NORMAL, GUMBEL):
        raise ValueError(f"threefry: request {i}: unknown kind {req.kind}")
    if torch.is_tensor(req.counter):
        c = req.counter
        if (req.kind != PAIR or c.numel() != 1 or c.dtype != torch.int32
                or c.device != keys.device):
            raise ValueError(f"threefry: request {i}: a tensor counter is a "
                             f"one-element int32 on the keys' device, of a "
                             f"PAIR request; got {tuple(c.shape)} {c.dtype} "
                             f"on {c.device}, kind {req.kind}")
    elif not 0 <= req.n or req.counter + req.n > M32 + 1 or req.counter < 0:
        raise ValueError(f"threefry: request {i}: counters {req.counter} + "
                         f"{req.n} exceed 32 bits")
    if req.fold is not None and not 0 <= req.fold <= M32:
        raise ValueError(f"threefry: request {i}: fold {req.fold} is not a "
                         f"uint32")
    want = {PAIR: 0, BITS: 0, UNIFORM: 2, NORMAL: NUM_PARAMS,
            GUMBEL: 2}[req.kind]
    if len(req.params) != want:
        raise ValueError(f"threefry: request {i}: {len(req.params)} params, "
                         f"the transform takes {want}")


def draw(requests):
    """Fill every :class:`Draw` of ``requests``; returns their outputs, in
    order. On the card one launch covers up to ``MAX_TABLE_REQUESTS``
    requests; the keys are read from device memory by the kernel."""
    requests = list(requests)
    if not requests:
        return []
    if not on_card("threefry", [(r.keys, torch.int64) for r in requests],
                   strided=True):
        return draw_plain(requests)
    for i, req in enumerate(requests):
        _check(req, i)
    dev = requests[0].keys.device
    outs = []
    for req in requests:
        rows = req.keys.shape[0]
        if req.kind == PAIR:
            outs.append(torch.empty((rows, req.n, 2), dtype=torch.int64,
                                    device=dev))
        else:
            outs.append(torch.empty((rows, req.n), device=dev, dtype=(
                torch.int64 if req.kind == BITS else torch.float32)))
    live = [i for i, r in enumerate(requests)
            if r.n and r.keys.shape[0]]
    with torch.cuda.device(dev):
        for start in range(0, len(live), MAX_TABLE_REQUESTS):
            part = [requests[i] for i in live[start:start + MAX_TABLE_REQUESTS]]
            pouts = [outs[i] for i in live[start:start + MAX_TABLE_REQUESTS]]
            params = []
            for r in part:
                params += list(r.params) + [0.0] * (NUM_PARAMS - len(r.params))
            rc = library().repro_threefry(
                c_array(ctypes.c_void_p, [r.keys.data_ptr() for r in part]),
                c_array(ctypes.c_longlong, [r.keys.stride(0) for r in part]),
                c_array(ctypes.c_longlong, [r.keys.shape[0] for r in part]),
                c_array(ctypes.c_void_p, [o.data_ptr() for o in pouts]),
                c_array(ctypes.c_longlong, [r.n for r in part]),
                c_array(ctypes.c_int, [r.kind for r in part]),
                c_array(ctypes.c_longlong, [0 if torch.is_tensor(r.counter)
                                            else r.counter for r in part]),
                c_array(ctypes.c_void_p, [r.counter.data_ptr()
                                          if torch.is_tensor(r.counter)
                                          else None for r in part]),
                c_array(ctypes.c_longlong,
                        [-1 if r.fold is None else r.fold for r in part]),
                c_array(ctypes.c_float, params), len(part), stream_of(
                    part[0].keys))
            check(rc, "threefry")
            draw.launches += 1
    return outs


draw.launches = 0
