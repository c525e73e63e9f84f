"""The ``jax.random`` calls of the reference, bit for bit, on torch tensors.

JAX's default PRNG (threefry2x32, ``jax_threefry_partitionable``) as the
reference's main path uses it: ``PRNGKey``, ``split``, ``fold_in``,
``bits``, ``uniform``, ``normal``, ``truncated_normal``, ``randint``,
``permutation``, ``choice`` (without ``p``), ``gumbel`` (mode ``"low"``)
and ``categorical`` (with replacement).
A key is a ``(..., 2)`` int64 tensor of two uint32 words, on the device of
the run; a function of keys with leading batch dimensions draws one stream
a key, as ``jax.vmap`` over keys does, and its output leads with those
dimensions.

Exact against ``jax.random`` on the CPU: keys, bits, uniforms and randint
by construction; ``normal``, ``truncated_normal`` and ``gumbel`` because
the kernel and its plain version transcribe XLA's CPU erfinv, log1p, log
and erf op for op (``kernels/threefry.py``).

Every draw is a table launch of the threefry kernel (``kernels/threefry.py``)
on the card, or its plain version on the CPU. A function decorated with
:class:`program` is a generator that yields a list of requests a level and
gets their outputs back; calling it runs it alone, one launch a level,
and ``f.program(...)`` is the generator, so :func:`together` can run
several side by side with one launch a level for all of them. That is how
a round's keys cost one launch a level of derivation (``core/algorithms.py``,
``train/engine.py``). Keys never leave the device: deriving them syncs
nothing with the host.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import threefry
from repro_torch.kernels.bma_sample import argmax_first
from repro_torch.kernels.threefry import (BITS, GUMBEL, NO_CLIP, NORMAL,
                                          PAIR, TINY, UNIFORM, Draw, to_f32)

M32 = threefry.M32


def run(gen):
    """Run a draw program to its end: one table launch a level."""
    try:
        requests = gen.send(None)
        while True:
            requests = gen.send(threefry.draw(requests))
    except StopIteration as stop:
        return stop.value


class program:
    """Decorator: the generator ``fn`` is ``f.program``; ``f(...)`` runs it
    alone. On a method, ``obj.f.program`` is bound to ``obj``."""

    def __init__(self, fn):
        self.program = fn
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        return run(self.program(*args, **kwargs))

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return program(functools.partial(self.program, obj))


def together(*gens):
    """A program running ``gens`` side by side: each level's requests of all
    of them go out in one launch. Returns the list of their results."""
    results = [None] * len(gens)
    live = {}

    def step(i, gen, outs):
        try:
            live[i] = (gen, gen.send(outs))
        except StopIteration as stop:
            live.pop(i, None)
            results[i] = stop.value

    for i, gen in enumerate(gens):
        step(i, gen, None)
    while live:
        order = list(live.items())
        outs = yield [r for _, (_, reqs) in order for r in reqs]
        pos = 0
        for i, (gen, reqs) in order:
            step(i, gen, outs[pos:pos + len(reqs)])
            pos += len(reqs)
    return results


def _rows(key: torch.Tensor) -> torch.Tensor:
    if key.shape[-1:] != (2,) or key.dtype != torch.int64:
        raise ValueError(f"a key is a (..., 2) int64 tensor, got "
                         f"{tuple(key.shape)} {key.dtype}")
    return key.reshape(-1, 2)


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 32-bit seeds (JAX's default):
    ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


@program
def split(key: torch.Tensor, num: int = 2):
    """``(..., 2)`` keys -> ``(..., num, 2)``: key ``i`` is threefry on the
    counters ``(0, i)``. ``fold_in(key, i)`` equals ``split(key, n)[i]``
    for every ``i < n``."""
    out, = yield [Draw(_rows(key), num, PAIR)]
    return out.reshape(key.shape[:-1] + (num, 2))


@program
def split_fold_in(key: torch.Tensor, num: int, data: int):
    """``fold_in(split(key, num), data)`` in one level."""
    out, = yield [Draw(_rows(key), num, PAIR, fold=int(data) & M32)]
    return out.reshape(key.shape[:-1] + (num, 2))


@program
def fold_in(key: torch.Tensor, data):
    """``jax.random.fold_in``: threefry on the counters ``(0, data)``.
    ``data`` is an int, or a one-element int32 tensor on the key's device
    that the draw reads on the device (a round index inside a CUDA graph)."""
    counter = data if torch.is_tensor(data) else int(data) & M32
    out, = yield [Draw(_rows(key), 1, PAIR, counter=counter)]
    return out.reshape(key.shape)


def _size(shape) -> int:
    return int(np.prod(tuple(shape), dtype=np.int64))


@program
def bits(key: torch.Tensor, shape: Sequence[int]):
    """32 random bits an element (int64 of uint32 values)."""
    shape = tuple(shape)
    out, = yield [Draw(_rows(key), _size(shape), BITS)]
    return out.reshape(key.shape[:-1] + shape)


@program
def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0):
    """f32 uniforms in ``[minval, maxval)``."""
    shape = tuple(shape)
    out, = yield [Draw(_rows(key), _size(shape), UNIFORM,
                       params=(to_f32(minval), to_f32(maxval)))]
    return out.reshape(key.shape[:-1] + shape)


NORMAL_LO = to_f32(np.nextafter(np.float32(-1.0), np.float32(0.0)))


@program
def normal(key: torch.Tensor, shape: Sequence[int], scale: float = 1.0):
    """f32 standard normals, ``√2·erfinv(u)``, ``u`` uniform in
    ``(-1, 1)``. With ``scale`` (a port extension), the reference's ``scale
    · normal(...)`` inside ``jit``, where XLA folds the two constants:
    ``erfinv(u) · fl32(√2 · fl32(scale))`` (the Langevin noise,
    ``algorithms.py:139-143``)."""
    shape = tuple(shape)
    mult = to_f32(np.float32(threefry.SQRT2) * np.float32(scale))
    out, = yield [Draw(_rows(key), _size(shape), NORMAL,
                       params=(NORMAL_LO, 1.0, mult, *NO_CLIP, 1.0))]
    return out.reshape(key.shape[:-1] + shape)


def truncation(lower: float, upper: float):
    """``truncated_normal``'s uniform range and clip: ``erf(bound/√2)`` by
    XLA's f32 erf, and the bounds moved one f32 step inward. XLA divides by
    the constant √2 as a product with its f32 reciprocal (ROADMAP C5)."""
    lo, hi = np.float32(lower), np.float32(upper)
    recip = np.float32(1.0) / np.float32(threefry.SQRT2)
    a, b = threefry.erf_plain(torch.tensor([lo * recip, hi * recip],
                                            dtype=torch.float32)).tolist()
    return (a, b, to_f32(np.nextafter(lo, np.float32(np.inf))),
            to_f32(np.nextafter(hi, np.float32(-np.inf))))


@program
def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape: Sequence[int], scale: float = 1.0):
    """f32 normals truncated to ``(lower, upper)``, then times the f32
    ``scale`` (``dense_init``'s eager ``std · truncated_normal``)."""
    shape = tuple(shape)
    a, b, clip_lo, clip_hi = truncation(lower, upper)
    out, = yield [Draw(_rows(key), _size(shape), NORMAL,
                       params=(a, b, threefry.SQRT2, clip_lo, clip_hi,
                               to_f32(scale)))]
    return out.reshape(key.shape[:-1] + shape)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a · b mod 2**32`` of uint32 values in int64, without overflow."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def randint_from_bits(high: torch.Tensor, low: torch.Tensor, minval,
                      maxval) -> torch.Tensor:
    """``jax.random.randint``'s span arithmetic (int32 dtype) on its two
    bit arrays; ``minval``, ``maxval`` are ints or int64 tensors that
    broadcast against them (no scalar becomes a device tensor: no copy to
    the device, no sync)."""
    span = (maxval - minval) & M32
    if torch.is_tensor(span):
        span = torch.where(maxval <= minval, 1, span)
    elif maxval <= minval:
        span = 1
    mult = 65536 % span
    mult = _mul32(mult, mult) % span
    offset = (_mul32(high % span, mult) + low % span) & M32
    out = (minval + offset % span) & M32
    return ((out ^ 0x80000000) - 0x80000000).to(torch.int32)


@program
def randint(key: torch.Tensor, shape: Sequence[int], minval, maxval):
    """int32 integers in ``[minval, maxval)``; ``minval`` and ``maxval``
    are ints or tensors over the keys' batch dimensions (one bound a key,
    as ``DeviceShards`` draws each node over its own shard)."""
    shape = tuple(shape)
    k = yield from split.program(key, 2)
    high, low = yield [Draw(_rows(k[..., 0, :]), _size(shape), BITS),
                       Draw(_rows(k[..., 1, :]), _size(shape), BITS)]
    batch = key.shape[:-1]

    def bound(v):
        if not torch.is_tensor(v):
            return v
        return v.to(key.device).reshape(batch + (1,) * len(shape)) \
            if v.dim() else v
    return randint_from_bits(high.reshape(batch + shape),
                             low.reshape(batch + shape), bound(minval),
                             bound(maxval))


def shuffle_rounds(n: int) -> int:
    """The sorts of ``jax.random``'s ``_shuffle`` for ``n`` elements:
    ``ceil(3·ln n / ln(2³² − 1))``, so 0 for one element, 1 up to 1,625."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


@program
def permutation(key: torch.Tensor, n: int):
    """``jax.random.permutation(key, n)`` for an int ``n``: int64 indices.
    Each of :func:`shuffle_rounds` rounds splits the key, ``key, sub =
    split(key)``, draws 32 bits an element from ``sub`` and sorts by them
    with ``lax.sort_key_val``, which is stable (its ``is_stable=True``);
    here ``torch.sort(stable=True)`` of the bits as unsigned values
    (ROADMAP C15)."""
    x = torch.arange(n, device=key.device).expand(key.shape[:-1] + (n,))
    for _ in range(shuffle_rounds(n)):
        pair = yield from split.program(key)
        key, sub = pair[..., 0, :], pair[..., 1, :]
        sort_keys = yield from bits.program(sub, (n,))
        x = torch.gather(x, -1, torch.sort(sort_keys, dim=-1,
                                           stable=True).indices)
    return x


@program
def choice(key: torch.Tensor, n: int, shape: Sequence[int] = (),
           replace: bool = True):
    """``jax.random.choice(key, n, shape, replace)`` without ``p``:
    ``randint(key, shape, 0, n)`` with replacement, else
    ``permutation(key, n)[:prod(shape)]``."""
    shape = tuple(shape)
    draws = _size(shape)
    if not replace and draws > n:
        raise ValueError(f"Cannot take a larger sample (size {draws}) than "
                         f"population (size {n}) when 'replace=False'")
    if replace:
        return (yield from randint.program(key, shape, 0, n)).long()
    perm = yield from permutation.program(key, n)
    return perm[..., :draws].reshape(key.shape[:-1] + shape)


@program
def gumbel(key: torch.Tensor, shape: Sequence[int], minval: float = TINY):
    """f32 standard Gumbel noise, ``jax.random.gumbel`` in its ``"low"``
    mode: ``−log(−log(u))``, ``u`` uniform in ``[minval, 1)`` (``minval``
    the smallest normal f32), by XLA's f32 log."""
    shape = tuple(shape)
    out, = yield [Draw(_rows(key), _size(shape), GUMBEL,
                       params=(to_f32(minval), 1.0))]
    return out.reshape(key.shape[:-1] + shape)


@program
def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1):
    """``jax.random.categorical(key, logits, axis)`` with replacement:
    ``argmax(logits + gumbel(key, logits.shape))`` over ``axis``, the first
    index on ties, as ``jnp.argmax`` (a NaN counts as the largest). A key
    with leading batch dimensions draws one stream a key, over the rest of
    the logits' shape, as ``jax.vmap`` over keys does; the logits' leading
    dimensions must then be the keys'."""
    batch = key.shape[:-1]
    if tuple(logits.shape[:len(batch)]) != tuple(batch):
        raise ValueError(f"keys {tuple(key.shape)} do not lead the logits "
                         f"{tuple(logits.shape)}")
    g = yield from gumbel.program(key, logits.shape[len(batch):])
    return argmax_first(g + logits.float(), dim=axis)
