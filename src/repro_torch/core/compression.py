"""Compression Q(.) for CD-BFL (paper Eq. 6) and its wire format.

Counterpart of ``repro/core/compression.py``: the six codec stages
(:class:`IdentityCodec`, :class:`TopKCodec`, :class:`BlockTopKCodec`,
:class:`RandKCodec`, :class:`QSGDCodec`, :class:`SignCodec`), the
``"stage|stage"`` DSL (:func:`parse_pipeline`), the materialized
:class:`WirePayload`, the compress-in-update lowering :class:`FusedCodec`,
and the legacy dense :class:`Compressor` under every name the reference
gives it, and ``FedConfig.layer_pipelines`` (:class:`PerLayerPipeline`,
routing each leaf by its path), and the static ``encode_hbm_bytes``
ledger of the reference's lowering.

:class:`BlockTopKCodec` has the reference's two survivor orders. The
default, ``use_pallas=False``, is ``lax.top_k``'s (ROADMAP C9): each block's
k largest ``|d|`` by descending key, values as they are, decoded by a
scatter that stores them as they are; a leaf of at most one block is
``TopKCodec``'s global top-k. ``use_pallas=True`` is the kernel path's
two-tier slot order and one-hot contractions (C6, C7), which
:class:`FusedCodec` lowers stage 0 to.

Leaves are node-stacked, ``(K, *shape)``: one encode covers every node, as
the reference's ``vmap(encode_pair)`` does, and each payload buffer leads
with K. The per-leaf metadata describes one node's leaf, so the byte
counts and the metadata equal the reference's.

The random numbers of the stochastic stages (QSGD's uniforms, rand-k's
scores) are an input of encode. A compressor's ``uniform_shapes(tree)``
names them, ``{site: node-stacked shape}`` in leaf order, where a site is
the leaf's dotted path, or ``(path, stage)`` for a pipeline with more than
one stochastic stage; encode takes them as ``uniforms`` (``{site:
tensor}``, a rand-k stage's as ``(key, scores)``) and raises if one is
missing. :func:`draw_uniforms` draws them from the reference's keys: node
k's from ``fold_in(key, k)`` (``algorithms.py:182-184, 221``), leaf i's
from ``split(node_key, n_leaves)[i]`` over every leaf, the dense-riding
ones included (``compression.py:722``; the legacy compressor's
``split_key_like``, ``:194-197``), and stage s > 0's from ``fold_in(leaf_key,
s)`` (``_stage_key``, ``:674-677``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.kernels import ops as kops
from repro_torch.kernels.fused_compress import (carrier_norms_plain,
                                                grid_quant_plain)
from repro_torch.kernels.qsgd import inv_one_plus
from repro_torch.kernels.qsgd import qsgd_omega as _qsgd_omega
from repro_torch.utils.tree import (tree_count, tree_leaves_with_path,
                                    tree_map, tree_unflatten)

UINT16_MAX = 65535


class _SparseMeta(NamedTuple):
    """Static decode info of a sparsify (or identity) stage, one node's
    carrier."""
    shape: Tuple[int, ...]
    n: int
    k: int                      # survivors (a block's in block modes)
    mode: str                   # dense | global | block | pallas
    nb: int = 0
    bs: int = 0


class _QuantMeta(NamedTuple):
    """Static decode info of a QSGD or sign stage (one node's carrier)."""
    shape: Tuple[int, ...]
    n: int
    in_dtype: str               # dtype of the carrier consumed
    levels: int = 0
    omega: float = 0.0          # the 1/(1+ω) contraction scaling


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _node_shape(x) -> Tuple[int, ...]:
    return tuple(x.shape[1:])


def _survivors(ratio: float, n: int) -> int:
    return max(1, int(np.ceil(ratio * n)))


def _residuals(xs, vs):
    return [x if v is None else x - v.to(x.dtype) for x, v in zip(xs, vs)]


def _dense_meta(x) -> _SparseMeta:
    shape = _node_shape(x)
    n = int(np.prod(shape))
    return _SparseMeta(shape, n, n, "dense")


def _to_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 indices into a leaf of ``n`` -> the reference's index dtype:
    uint16 up to 65,535 elements, uint32 past it."""
    if n <= UINT16_MAX:
        return kops.to_uint16(idx)
    return idx.to(torch.int32).view(torch.uint32)


def _from_index(idx: torch.Tensor) -> torch.Tensor:
    if idx.dtype == torch.uint16:
        return kops.from_uint16(idx)
    return idx.view(torch.int32).long() & 0xFFFFFFFF


def _scatter_set(vals: torch.Tensor, idx: torch.Tensor, shape):
    """The reference's ``zeros.at[idx].set(vals)`` of each node's ``(k,)``
    payload into its flat leaf (``_scatter_flat``, ``compression.py:355``)."""
    n = int(np.prod(shape))
    out = vals.new_zeros((vals.shape[0], n)).scatter_(1, idx, vals)
    return out.reshape((vals.shape[0],) + tuple(shape))


def _global_order(keys: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k``'s indices of each row of int32 ``keys``: the first k
    of a stable descending sort (ties to the lower index)."""
    return torch.sort(keys, dim=1, descending=True, stable=True).indices[:, :k]


class _Codec:
    """What every stage shares: a stage encodes a list of leaves at once
    (``encode_leaves``, one table launch where it has a kernel), by default
    one leaf at a time through ``encode``; and decodes a list of ``(carrier,
    aux, meta)`` items at once."""

    stochastic = False
    kind = "identity"

    def encode_leaves(self, xs, us, vs=None):
        """``(carrier, aux, meta)`` of every leaf of ``xs`` (minus ``vs``'s
        leaves when given), ``us`` the leaves' draws of this stage."""
        xs = xs if vs is None else _residuals(xs, vs)
        return [self.encode(x, u) for x, u in zip(xs, us)]

    def decode_leaves(self, items):
        return [self.decode(*item) for item in items]

    def out_shape(self, shape):
        return tuple(shape)

    def draw_shape(self, shape):
        """The shape of the uniforms this stage draws for a carrier of
        ``shape`` (one node's), or None."""
        return None

    # the reference's closed-form byte table (``compression.py:331-338``),
    # the cross-check of the measured bytes
    def out_size(self, n: int) -> int:
        return n

    def sidecar_formula_bytes(self, n: int) -> int:
        return 0

    def carrier_formula_bytes(self, n: int, elem_bytes: int = 4) -> int:
        return self.out_size(n) * elem_bytes


@dataclass(frozen=True)
class IdentityCodec(_Codec):
    """No-op stage: the carrier is the leaf, no sidecar."""
    name: str = "identity"
    kind = "identity"

    def encode(self, x, u=None):
        return x, {}, _dense_meta(x)

    def decode(self, carrier, aux, meta):
        return carrier


@dataclass(frozen=True)
class TopKCodec(_Codec):
    """Exact global top-|.| (``compression.py:361-397``): a ``(k,)``
    carrier a node and the ``lax.top_k`` indices, uint16 up to 65,535
    elements and uint32 past it; a leaf with ``k >= n`` goes dense. A leaf
    of at most one kernel block runs the top_k-order selection kernel (one
    launch for all of them), a longer one a stable sort of its keys."""
    name: str = "topk"
    ratio: float = 0.01
    kind = "sparsify"

    def out_shape(self, shape):
        n = int(np.prod(shape))
        k = _survivors(self.ratio, n)
        return tuple(shape) if k >= n else (k,)

    def out_size(self, n):
        return min(_survivors(self.ratio, n), n)

    def sidecar_formula_bytes(self, n):
        if self.out_size(n) >= n:
            return 0
        return self.out_size(n) * (2 if n <= UINT16_MAX else 4)

    def encode(self, x, u=None):
        return self.encode_leaves([x], [None])[0]

    def encode_leaves(self, xs, us, vs=None):
        vs = [None] * len(xs) if vs is None else vs
        out: List[Any] = [None] * len(xs)
        small, large = [], []
        for i, x in enumerate(xs):
            n = int(np.prod(_node_shape(x)))
            k = _survivors(self.ratio, n)
            if k >= n:
                d, = _residuals([x], [vs[i]])
                out[i] = (d, {}, _dense_meta(x))
            else:
                (small if n <= kops.KERNEL_BLOCK else large).append((i, n, k))
        if small:
            picked = kops.topk_select_leaves(
                [xs[i] for i, _, _ in small], [k for _, _, k in small],
                None if vs[0] is None else [vs[i] for i, _, _ in small],
                kops.KERNEL_BLOCK)
            for (i, n, k), (vals, idx) in zip(small, picked):
                out[i] = (vals.reshape(-1, k), {"idx": idx.reshape(-1, k)},
                          _SparseMeta(_node_shape(xs[i]), n, k, "global"))
        for i, n, k in large:
            d, = _residuals([xs[i].reshape(xs[i].shape[0], -1)], [
                None if vs[i] is None else vs[i].reshape(xs[i].shape[0], -1)])
            order = _global_order(kops.magnitude_keys(d), k)
            out[i] = (torch.gather(d, 1, order), {"idx": _to_index(order, n)},
                      _SparseMeta(_node_shape(xs[i]), n, k, "global"))
        return out

    def decode(self, carrier, aux, meta):
        return self.decode_leaves([(carrier, aux, meta)])[0]

    def decode_leaves(self, items):
        """Dense carriers as they are; payloads of at most one kernel block
        by one unpack_set launch, longer ones by a scatter."""
        out: List[Any] = [None] * len(items)
        small = []
        for i, (carrier, aux, meta) in enumerate(items):
            if meta.mode == "dense":
                out[i] = carrier
            elif meta.n <= kops.KERNEL_BLOCK:
                small.append(i)
            else:
                out[i] = _scatter_set(carrier, _from_index(aux["idx"]),
                                      meta.shape)
        dense = kops.unpack_set_leaves(
            [(items[i][0][:, None], items[i][1]["idx"][:, None])
             for i in small], [items[i][2].shape for i in small],
            kops.KERNEL_BLOCK)
        for i, d in zip(small, dense):
            out[i] = d
        return out


@dataclass(frozen=True)
class BlockTopKCodec(_Codec):
    """Block-local top-k (``compression.py:400-465``): uint16 block-local
    indices and an ``(nb, k)`` value buffer a node. ``use_pallas=False``
    (the default) is ``lax.top_k`` order (one topk_select launch over
    every leaf, ``θ − v`` formed in it; decode one unpack_set launch), and
    a leaf of at most ``block_size`` elements is :class:`TopKCodec`'s.
    ``use_pallas=True`` is the kernel path's slot order (pack or
    delta-pack, one launch a table; decode one unpack launch)."""
    name: str = "block_topk"
    ratio: float = 0.01
    block_size: int = 1024
    use_pallas: bool = False
    kind = "sparsify"

    def _global(self, n: int) -> bool:
        return n <= self.block_size and not self.use_pallas

    def _k(self) -> int:
        return kops.survivors_per_block(self.ratio, self.block_size)

    def out_shape(self, shape):
        n = int(np.prod(shape))
        if self._global(n):
            return TopKCodec(ratio=self.ratio).out_shape(shape)
        return (kops.num_blocks(n, self.block_size), self._k())

    def out_size(self, n):
        if self._global(n):
            return TopKCodec(ratio=self.ratio).out_size(n)
        return kops.num_blocks(n, self.block_size) * self._k()

    def sidecar_formula_bytes(self, n):
        if self._global(n):
            return TopKCodec(ratio=self.ratio).sidecar_formula_bytes(n)
        return self.out_size(n) * 2     # uint16 block-local indices

    def _meta(self, x, vals) -> _SparseMeta:
        shape = _node_shape(x)
        return _SparseMeta(shape, int(np.prod(shape)), vals.shape[2],
                           "pallas" if self.use_pallas else "block",
                           nb=vals.shape[1], bs=self.block_size)

    def encode(self, x, u=None):
        return self.encode_leaves([x], [None])[0]

    def encode_leaves(self, xs, us, vs=None):
        assert self.block_size <= UINT16_MAX + 1, "uint16 block-local indices"
        if self.use_pallas:
            packed = (kops.pack_leaves(xs, ratio=self.ratio,
                                       block_size=self.block_size)
                      if vs is None else
                      kops.fused_delta_pack_leaves(
                          xs, vs, ratio=self.ratio,
                          block_size=self.block_size))
            return [(vals, {"idx": idx}, self._meta(x, vals))
                    for x, (vals, idx) in zip(xs, packed)]
        vs = [None] * len(xs) if vs is None else vs
        out: List[Any] = [None] * len(xs)
        sel, ks = [], []
        for i, x in enumerate(xs):
            n = int(np.prod(_node_shape(x)))
            k = _survivors(self.ratio, n) if self._global(n) else self._k()
            if self._global(n) and k >= n:
                d, = _residuals([x], [vs[i]])
                out[i] = (d, {}, _dense_meta(x))
            else:
                sel.append(i)
                ks.append(k)
        picked = kops.topk_select_leaves(
            [xs[i] for i in sel], ks,
            None if vs[0] is None else [vs[i] for i in sel], self.block_size)
        for i, k, (vals, idx) in zip(sel, ks, picked):
            shape = _node_shape(xs[i])
            n = int(np.prod(shape))
            if not self._global(n):
                out[i] = (vals, {"idx": idx}, self._meta(xs[i], vals))
            else:                      # one block: TopKCodec's payload
                out[i] = (vals.reshape(-1, k), {"idx": idx.reshape(-1, k)},
                          _SparseMeta(shape, n, k, "global"))
        return out

    def decode(self, carrier, aux, meta):
        return self.decode_leaves([(carrier, aux, meta)])[0]

    def decode_leaves(self, items):
        """One launch a mode: unpack for the kernel order, unpack_set for
        the top_k order (a global payload as one block, ``(K, 1, k)``); a
        dense carrier as it is."""
        out: List[Any] = [None] * len(items)
        pallas, sets = [], []
        for i, (carrier, aux, meta) in enumerate(items):
            if meta.mode == "pallas":
                pallas.append(i)
            elif meta.mode == "dense":
                out[i] = carrier
            else:
                sets.append(i)
        if pallas:
            dense = kops.block_topk_unpack_leaves(
                [(items[i][0], items[i][1]["idx"]) for i in pallas],
                [items[i][2].shape for i in pallas],
                block_size=self.block_size)
            for i, d in zip(pallas, dense):
                out[i] = d

        def payload(carrier, aux, meta):
            if meta.mode == "block":
                return carrier, aux["idx"]
            return carrier[:, None], aux["idx"][:, None]
        if sets:
            dense = kops.unpack_set_leaves(
                [payload(*items[i]) for i in sets],
                [items[i][2].shape for i in sets], self.block_size)
            for i, d in zip(sets, dense):
                out[i] = d
        return out


def key_to_wire(key: torch.Tensor) -> torch.Tensor:
    """``(..., 2)`` int64 keys of uint32 words -> int32 words: the 8 bytes
    a rand-k payload carries a node."""
    return ((key & 0xFFFFFFFF) ^ 0x80000000).sub(0x80000000).to(torch.int32)


def key_from_wire(words: torch.Tensor) -> torch.Tensor:
    return words.long() & 0xFFFFFFFF


@random.program
def randk_indices(keys: torch.Tensor, n: int, k: int):
    """``_randk_indices`` (``compression.py:63-71``) of each node's key:
    the ``lax.top_k`` indices of ``uniform(key, (n,))``."""
    scores = yield from random.uniform.program(keys, (n,))
    return _global_order(scores.view(torch.int32), k)


@dataclass(frozen=True)
class RandKCodec(_Codec):
    """Exactly-k random coordinates (``compression.py:469-502``): the
    index set is the stable top-k of ``uniform(stage key, (n,))``, drawn
    beside the round's other draws; the sidecar is the 8-byte key alone,
    from which decode draws the index set again, as a receiver would."""
    name: str = "randk"
    ratio: float = 0.01
    kind = "sparsify"
    stochastic = True

    def out_shape(self, shape):
        return TopKCodec(ratio=self.ratio).out_shape(shape)

    def draw_shape(self, shape):
        n = int(np.prod(shape))
        return (n,) if _survivors(self.ratio, n) < n else None

    def out_size(self, n):
        return min(_survivors(self.ratio, n), n)

    def sidecar_formula_bytes(self, n):
        return 0 if self.out_size(n) >= n else 8    # the key

    def encode(self, x, u=None):
        shape = _node_shape(x)
        n = int(np.prod(shape))
        k = _survivors(self.ratio, n)
        if k >= n:
            return x, {}, _dense_meta(x)
        key, scores = u
        order = _global_order(scores.view(torch.int32), k)
        vals = torch.gather(x.reshape(x.shape[0], n), 1, order)
        return vals, {"key": key_to_wire(key)}, _SparseMeta(shape, n, k,
                                                             "global")

    def decode_leaves(self, items):
        """Every payload's index set drawn again from its key, one draw
        launch for all of them, then scattered."""
        live = [i for i, (_, _, meta) in enumerate(items)
                if meta.mode != "dense"]
        orders = random.run(random.together(*(
            randk_indices.program(key_from_wire(items[i][1]["key"]),
                                  items[i][2].n, items[i][2].k)
            for i in live)))
        out = [carrier for carrier, _, _ in items]
        for i, order in zip(live, orders):
            out[i] = _scatter_set(items[i][0], order, items[i][2].shape)
        return out

    def decode(self, carrier, aux, meta):
        return self.decode_leaves([(carrier, aux, meta)])[0]


@dataclass(frozen=True)
class QSGDCodec(_Codec):
    """QSGD stochastic quantization (``compression.py:505-550`` of the
    reference): the carrier is the int8 grid ``sign(x)·q`` and the sidecar
    the ``(1,)`` f32 norm ``‖x‖₂ + 1e-12`` of each node's carrier, so a
    node-stacked encode gives ``(K, *shape)`` int8 and a ``(K, 1)`` scale.

    ``encode_leaves`` quantizes every carrier, norms included, in one
    grid_quant launch a table (its plain version on the CPU); ``encode``,
    which the two-pass oracle runs, is the same arithmetic in torch ops,
    the norm in the kernel's summation order (:func:`carrier_norms_plain`):
    the same carrier and scale bit for bit. Decode is ``q·norm/s·r`` with
    ``r`` the f32 reciprocal of ``1 + ω``: the reference's jit-compiled
    decode, which XLA folds from ``/ s / (1 + ω)``.
    """
    name: str = "qsgd"
    levels: int = 16
    kind = "quantize"
    stochastic = True

    def draw_shape(self, shape):
        return tuple(shape)

    def sidecar_formula_bytes(self, n):
        return 4                        # the f32 norm

    def carrier_formula_bytes(self, n, elem_bytes: int = 4):
        bits = max(1, int(np.ceil(np.log2(self.levels + 1))) + 1)
        return -(-n * bits // 8)

    def _meta(self, x) -> _QuantMeta:
        shape = _node_shape(x)
        n = int(np.prod(shape))
        return _QuantMeta(shape, n, _dtype_name(x), levels=self.levels,
                          omega=_qsgd_omega(n, self.levels))

    def encode(self, x, u):
        rows = x.float().reshape(x.shape[0], -1)
        norm = carrier_norms_plain(rows)
        grid = grid_quant_plain(rows, u.reshape(rows.shape), norm, self.levels)
        return (grid.reshape(x.shape), {"scale": norm.reshape(-1, 1)},
                self._meta(x))

    def encode_leaves(self, xs, us, vs=None):
        xs = xs if vs is None else _residuals(xs, vs)
        quantized = kops.qsgd_quantize_carriers(xs, us, levels=self.levels)
        return [(grid, {"scale": norm.reshape(-1, 1)}, self._meta(x))
                for x, (grid, norm) in zip(xs, quantized)]

    def decode(self, carrier, aux, meta):
        norm = aux["scale"].reshape((-1,) + (1,) * len(meta.shape))
        out = carrier.float() * norm / meta.levels * inv_one_plus(meta.omega)
        return out.to(getattr(torch, meta.in_dtype))


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


# row lengths XLA's CPU code sums in order (ROADMAP C19)
SEQUENTIAL_SUM_MAX = 32


def mean_magnitude(flat: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(jnp.abs(x))`` of each row as the reference's jitted code
    computes it: the sum times the f32 reciprocal of the count (XLA folds
    the division by a constant, ROADMAP C5); a row of at most 32 elements
    summed in order, as XLA's CPU code sums it (C19)."""
    n = flat.shape[1]
    mag = flat.abs().float()
    if n <= SEQUENTIAL_SUM_MAX:
        total = mag[:, 0]
        for j in range(1, n):
            total = total + mag[:, j]
    else:
        total = mag.sum(dim=1)
    return total * float(np.float32(1.0) / np.float32(n))


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """numpy's ``packbits`` of each row of a ``(rows, n)`` bool tensor:
    big-endian bit order, the last byte zero-padded."""
    rows, n = bits.shape
    padded = torch.nn.functional.pad(bits.to(torch.int32), (0, -n % 8))
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32,
                           device=bits.device)
    return (padded.reshape(rows, -1, 8) * weights).sum(-1).to(torch.uint8)


def unpackbits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's ``unpackbits(…, count=n)`` of each row, as int32 0/1."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :n]


@dataclass(frozen=True)
class SignCodec(_Codec):
    """Ternary sign code (``compression.py:553-594``): a packed sign plane
    (``x > 0``) as the carrier, a packed nonzero plane and the f32 mean
    magnitude as sidecars, so decode gives ``sign(x)·scale`` with zeros
    kept."""
    name: str = "sign"
    kind = "quantize"

    def out_shape(self, shape):
        return (-(-int(np.prod(shape)) // 8),)

    def sidecar_formula_bytes(self, n):
        return 4 + -(-n // 8)           # scale + nonzero plane

    def carrier_formula_bytes(self, n, elem_bytes: int = 4):
        return -(-n // 8)               # sign plane

    def encode(self, x, u=None):
        flat = x.reshape(x.shape[0], -1)
        shape = _node_shape(x)
        scale = mean_magnitude(flat)
        return packbits(flat > 0), {
            "mask": packbits(flat != 0), "scale": scale.reshape(-1, 1)}, \
            _QuantMeta(shape, int(np.prod(shape)), _dtype_name(x))

    def decode(self, carrier, aux, meta):
        pos = unpackbits(carrier, meta.n).float()
        nz = unpackbits(aux["mask"], meta.n).float()
        sgn = (2.0 * pos - 1.0) * nz               # {-1, 0, +1}, exact in f32
        dtype = getattr(torch, meta.in_dtype)
        out = sgn.to(dtype) * aux["scale"].to(dtype)
        return out.reshape((carrier.shape[0],) + tuple(meta.shape))


def _rides_dense(x, min_dense_size: int) -> bool:
    """A node-stacked leaf of at most ``min_dense_size`` elements a node
    crosses the link uncompressed."""
    return bool(min_dense_size) and \
        int(np.prod(tuple(x.shape[1:]))) <= min_dense_size


def _uniforms_for(uniforms, site):
    if uniforms is None or site not in uniforms:
        raise ValueError(f"site {site!r} needs uniforms and none were "
                         f"given (see uniform_shapes)")
    return uniforms[site]


class LeafPayload(NamedTuple):
    """Wire buffers of one leaf: last carrier + per-stage sidecars."""
    wire: Any
    aux: Tuple[Dict[str, Any], ...]


class LeafSpec(NamedTuple):
    """Static per-leaf decode spec (one node's leaf)."""
    shape: Tuple[int, ...]
    dtype: str
    passthrough: bool                 # min_dense_size leaves ride dense
    metas: Tuple[Any, ...] = ()
    stages: Tuple[Any, ...] = ()      # the leaf's own stages when a
    #                                   PerLayerPipeline routed it; ()
    #                                   -> the payload's


def keystr(path: str) -> str:
    """``jax.tree_util.keystr`` of a dotted path of dict keys, the form the
    reference's layer rules match: ``"fc1.w"`` -> ``"['fc1']['w']"``."""
    return "".join(f"[{p!r}]" for p in path.split("."))


def _grouped(items, stage_of):
    """``[(stage, [i, ...]), ...]``: the indices of ``items`` grouped by
    ``stage_of(i)`` (equal stages together, in first-seen order), the
    ``None`` ones left out."""
    groups: Dict[Any, List[int]] = {}
    for i in items:
        stage = stage_of(i)
        if stage is not None:
            groups.setdefault(stage, []).append(i)
    return list(groups.items())


def _buffer_bytes(buf) -> int:
    return int(np.prod(tuple(buf.shape))) * buf.element_size()


class WirePayload:
    """The packed representation that crosses the link: per leaf, the
    carrier (f32 values, the int8 QSGD grid or the packed sign plane) and
    the stages' sidecars (uint16 or uint32 indices, the rand-k key, f32
    scales, the nonzero plane), each leading with K."""

    def __init__(self, entries, paths, specs, stages):
        self.entries = tuple(entries)
        self.paths = tuple(paths)
        self.specs = tuple(specs)
        self.stages = tuple(stages)

    def leaf_stages(self, i: int) -> Tuple[Any, ...]:
        """The stages that encoded leaf ``i``: its own when a
        :class:`PerLayerPipeline` routed it, else the payload's."""
        return self.specs[i].stages or self.stages

    def per_leaf_bytes(self) -> List[int]:
        out = []
        for entry in self.entries:
            b = _buffer_bytes(entry.wire)
            for aux in entry.aux:
                b += sum(_buffer_bytes(v) for v in aux.values())
            out.append(b)
        return out

    def measured_bytes(self) -> int:
        """Total bytes on the wire (all nodes), from the buffers."""
        return int(sum(self.per_leaf_bytes()))


@dataclass(frozen=True)
class CompressionPipeline:
    """Chainable codec stages with a materialized wire format. Encode is
    stage-major: each stage encodes every leaf's carrier at once (one
    table launch where it has a kernel), stage 0 from ``θ`` and ``v``.
    Under a :class:`PerLayerPipeline` leaves may take different stages:
    stage ``s`` then encodes, in one table launch, the leaves whose stage
    ``s`` is the same codec."""

    stages: Tuple[Any, ...] = (BlockTopKCodec(),)
    min_dense_size: int = 0

    def leaf_stages(self, path: str) -> Tuple[Any, ...]:
        """The stages of the leaf at the dotted ``path``."""
        return self.stages

    def draw_sites(self, tree):
        """``{site: (path, stage, (K, *draw shape), keyed)}`` of every draw
        the encode of the node-stacked ``tree`` takes, in leaf order; a site
        is the path, or ``(path, stage)`` when more than one of the leaf's
        stages draws; ``keyed``: the stage takes its key with its draws
        (rand-k)."""
        out = {}
        for path, x in tree_leaves_with_path(tree):
            if _rides_dense(x, self.min_dense_size):
                continue
            stages = self.leaf_stages(path)
            many = sum(s.stochastic for s in stages) > 1
            shape = _node_shape(x)
            for s, stage in enumerate(stages):
                drawn = stage.draw_shape(shape)
                if drawn is not None:
                    out[(path, s) if many else path] = (
                        path, s, (x.shape[0],) + drawn,
                        isinstance(stage, RandKCodec))
                shape = stage.out_shape(shape)
        return out

    def uniform_shapes(self, tree) -> Dict[Any, Tuple[int, ...]]:
        """``{site: (K, *carrier shape)}`` of the draws of ``tree``'s encode
        (see :meth:`draw_sites`)."""
        return {site: site_draw[2] for site, site_draw in
                self.draw_sites(tree).items()}

    def _leaf_draws(self, sites, uniforms, path):
        """``{stage: draw}`` of one leaf."""
        return {s: _uniforms_for(uniforms, site)
                for site, (p, s, _, _) in sites.items() if p == path}

    def _encode_leaf(self, stages, x, v, draws):
        """The two-pass encode of one leaf: the residual materialized, each
        stage's own ``encode``."""
        carrier = x if v is None else x - v.to(x.dtype)
        auxes, metas = [], []
        for s, stage in enumerate(stages):
            carrier, aux, meta = stage.encode(carrier, draws.get(s))
            auxes.append(aux)
            metas.append(meta)
        return carrier, tuple(auxes), tuple(metas)

    def _encode_leaves(self, stage_lists, xs, vs, draws):
        """``(carrier, auxes, metas)`` of every compressed leaf, in order,
        stage-major: stage ``s`` encodes each group of leaves that share it
        at once."""
        items = [(x, (), ()) for x in xs]
        depth = max(len(st) for st in stage_lists)
        for s in range(depth):
            for stage, group in _grouped(range(len(xs)), lambda i: (
                    stage_lists[i][s] if s < len(stage_lists[i]) else None)):
                got = stage.encode_leaves(
                    [items[i][0] for i in group], [draws[i].get(s)
                                                   for i in group],
                    [vs[i] for i in group] if s == 0 and vs[0] is not None
                    else None)
                for i, (c, aux, meta) in zip(group, got):
                    _, auxes, metas = items[i]
                    items[i] = (c, auxes + (aux,), metas + (meta,))
        return items

    def _encode_impl(self, tree, vtree, uniforms) -> WirePayload:
        leaves = tree_leaves_with_path(tree)
        vleaves = ([x for _, x in tree_leaves_with_path(vtree)]
                   if vtree is not None else [None] * len(leaves))
        sites = self.draw_sites(tree)
        packed = [i for i, (_, x) in enumerate(leaves)
                  if not _rides_dense(x, self.min_dense_size)]
        stage_lists = {i: self.leaf_stages(leaves[i][0]) for i in packed}
        encoded = dict(zip(packed, self._encode_leaves(
            [stage_lists[i] for i in packed], [leaves[i][1] for i in packed],
            [vleaves[i] for i in packed],
            [self._leaf_draws(sites, uniforms, leaves[i][0])
             for i in packed]) if packed else []))
        entries, specs = [], []
        for i, ((path, x), v) in enumerate(zip(leaves, vleaves)):
            shape = _node_shape(x)
            dtype = _dtype_name(x)
            if i not in encoded:
                wire = x if v is None else x - v.to(x.dtype)
                entries.append(LeafPayload(wire=wire, aux=()))
                specs.append(LeafSpec(shape, dtype, True))
                continue
            carrier, auxes, metas = encoded[i]
            entries.append(LeafPayload(wire=carrier, aux=auxes))
            own = stage_lists[i]
            specs.append(LeafSpec(shape, dtype, False, metas,
                                  () if own is self.stages else tuple(own)))
        return WirePayload(entries, [p for p, _ in leaves], specs, self.stages)

    def encode(self, tree, uniforms=None) -> WirePayload:
        return self._encode_impl(tree, None, uniforms)

    def encode_pair(self, theta, v, uniforms=None) -> WirePayload:
        """Encode the residual ``theta - v`` handed as its two operands."""
        return self._encode_impl(theta, v, uniforms)

    def decode(self, payload: WirePayload):
        """Stage-major: the last stage decodes every compressed leaf, then
        the stage before it, so one decode launch a stage (and a group of
        leaves that share it) covers them all; passthrough leaves are
        kept."""
        leaves = [entry.wire for entry in payload.entries]
        packed = [i for i, spec in enumerate(payload.specs)
                  if not spec.passthrough]
        stage_lists = {i: payload.leaf_stages(i) for i in packed}
        depth = max((len(st) for st in stage_lists.values()), default=0)
        for s in reversed(range(depth)):
            for stage, group in _grouped(packed, lambda i: (
                    stage_lists[i][s] if s < len(stage_lists[i]) else None)):
                decoded = stage.decode_leaves(
                    [(leaves[i], payload.entries[i].aux[s],
                      payload.specs[i].metas[s]) for i in group])
                for i, leaf in zip(group, decoded):
                    leaves[i] = leaf
        return tree_unflatten(list(payload.paths), leaves)

    def wire_bytes(self, tree) -> int:
        """Bytes one node puts on the wire for a single-model ``tree``:
        the payload of shape-only (``meta``) leaves, measured."""
        specs = tree_map(lambda x: torch.empty((1,) + tuple(x.shape),
                                               dtype=x.dtype, device="meta"),
                         tree)
        draws = {}
        for site, (_, _, shape, keyed) in self.draw_sites(specs).items():
            u = torch.empty(shape, device="meta")
            draws[site] = (torch.empty((shape[0], 2), dtype=torch.int64,
                                       device="meta"), u) if keyed else u
        return self.encode(specs, draws).measured_bytes()

    def formula_bytes(self, tree, elem_bytes: int = 4) -> int:
        """The reference's closed-form byte table (``compression.py:
        813-829``), the cross-check of :meth:`wire_bytes`: each stage's
        sidecars plus the last stage's carrier."""
        total = 0
        for path, x in tree_leaves_with_path(tree):
            n = int(np.prod(tuple(x.shape)))
            if self.min_dense_size and n <= self.min_dense_size:
                total += n * elem_bytes
                continue
            carrier_bytes = n * elem_bytes
            for stage in self.leaf_stages(path):
                total += stage.sidecar_formula_bytes(n)
                carrier_bytes = stage.carrier_formula_bytes(n, elem_bytes)
                n = stage.out_size(n)
            total += carrier_bytes
        return total


def _lower_stage0(stages):
    """A leading block-top-k stage onto the kernel path's order
    (``compression.py:835-847``): later stochastic stages bind uniforms to
    slot positions, so the fused path and its oracle share it."""
    if stages and isinstance(stages[0], BlockTopKCodec):
        return (replace(stages[0], use_pallas=True),) + tuple(stages[1:])
    return tuple(stages)


@dataclass(frozen=True)
class FusedCodec(CompressionPipeline):
    """Compress-in-update lowering (``compression.py:850-893``): stage 0,
    a block-top-k, runs on the kernel path's order, and ``encode_pair``
    runs delta-pack once over every compressed leaf (one launch a table of
    leaves), so the dense residual never reaches device memory; a trailing
    QSGD stage quantizes every packed carrier, norms included, in one
    grid_quant launch. A pipeline whose stage 0 is another codec takes the
    stage-major encode of :class:`CompressionPipeline`, as the reference's
    falls back to its two-pass encode (the same bits).

    With ``fused=False`` the same object is the two-pass oracle: leaf by
    leaf, the residual materialized, the pack kernel, then each stage's
    own ``encode`` (QSGD's torch arithmetic). Both give the same payload
    bit for bit."""

    fused: bool = True

    @classmethod
    def wrap(cls, pipeline: CompressionPipeline, fused: bool = True
             ) -> "FusedCodec":
        return cls(stages=_lower_stage0(pipeline.stages),
                   min_dense_size=pipeline.min_dense_size, fused=fused)

    def _encode_leaves(self, stage_lists, xs, vs, draws):
        if self.fused:
            return super()._encode_leaves(stage_lists, xs, vs, draws)
        return [self._encode_leaf(st, x, v, d)
                for st, x, v, d in zip(stage_lists, xs, vs, draws)]


@dataclass(frozen=True)
class PerLayerPipeline(CompressionPipeline):
    """Per-layer pipelines (``FedConfig.layer_pipelines``,
    ``compression.py:917-939``): ``rules`` is an ordered tuple of
    ``(pattern, pipeline)``; the first pattern that is a substring of the
    leaf's path in ``jax.tree_util.keystr`` form (``['fc1']['w']``, so a
    pattern like ``1']['w`` routes the same leaves in both packages)
    routes the leaf through that pipeline's stages; ``"*"`` or ``""``
    matches everything; an unmatched leaf takes the base ``stages``. Each
    leaf's stages are recorded in its :class:`LeafSpec`, so decode reads
    them from the payload. Under ``fused_compress`` :func:`make_compressor`
    lowers the base's and each rule's leading block-top-k to the kernel
    order (``stages[0].use_pallas``), and stage 0 encodes from ``θ`` and
    ``v`` in the delta-pack launch; either way the leaves encode
    stage-major, as the plain pipeline's do."""

    rules: Tuple[Tuple[str, CompressionPipeline], ...] = ()
    # the rules were lowered under fused_compress (read by the ledger,
    # encode_hbm_bytes, as the reference's FusedCodec field)
    fused: bool = False

    def leaf_stages(self, path: str) -> Tuple[Any, ...]:
        path_str = keystr(path)
        for pat, pipe in self.rules:
            if pat in ("*", "") or pat in path_str:
                return pipe.stages
        return self.stages


def parse_layer_rules(spec: str) -> Tuple[Tuple[str, str], ...]:
    """The ``"pattern=pipeline;pattern=pipeline"`` CLI DSL
    (``compression.py:942-954``) as ``(pattern, spec)`` pairs."""
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        pat, eq, sub = part.partition("=")
        if not eq or not sub.strip():
            raise ValueError(
                f"layer rule {part!r} is not 'pattern=pipeline'")
        rules.append((pat.strip(), sub.strip()))
    return tuple(rules)


_CODEC_FACTORIES = {
    "identity": lambda ratio, block_size, levels: IdentityCodec(),
    "topk": lambda ratio, block_size, levels: TopKCodec(ratio=ratio),
    "block_topk": lambda ratio, block_size, levels: BlockTopKCodec(
        ratio=ratio, block_size=block_size),
    "block_topk_pallas": lambda ratio, block_size, levels: BlockTopKCodec(
        name="block_topk_pallas", ratio=ratio, block_size=block_size,
        use_pallas=True),
    "randk": lambda ratio, block_size, levels: RandKCodec(ratio=ratio),
    "qsgd": lambda ratio, block_size, levels: QSGDCodec(levels=levels),
    "sign": lambda ratio, block_size, levels: SignCodec(),
}


def parse_pipeline(spec: str, *, ratio: float = 0.01, block_size: int = 1024,
                   qsgd_levels: int = 16,
                   min_dense_size: int = 0) -> CompressionPipeline:
    """The ``"stage|stage"`` DSL (``compression.py:971-998``): at most one
    sparsifier, and a quantizer only as the last stage; ``ValueError``
    otherwise, and for an unknown codec."""
    stages = []
    for nm in (s.strip() for s in spec.split("|")):
        if nm not in _CODEC_FACTORIES:
            raise ValueError(
                f"unknown codec {nm!r}; known: {sorted(_CODEC_FACTORIES)}")
        stages.append(_CODEC_FACTORIES[nm](ratio, block_size, qsgd_levels))
    if sum(1 for s in stages if s.kind == "sparsify") > 1:
        raise ValueError(f"at most one sparsifier per pipeline: {spec!r}")
    for i, s in enumerate(stages):
        if s.kind == "quantize" and i != len(stages) - 1:
            kind = ("sparsifier" if stages[i + 1].kind == "sparsify"
                    else "quantizer" if stages[i + 1].kind == "quantize"
                    else "stage")
            raise ValueError(
                f"quantizer must be the terminal stage ({kind} follows "
                f"{s.name!r}): {spec!r}")
    return CompressionPipeline(stages=tuple(stages),
                               min_dense_size=min_dense_size)


@dataclass(frozen=True)
class Compressor:
    """The legacy dense compressor (``compression.py:162-267`` of the
    reference). ``__call__`` maps node-stacked leaves to dense leaves of
    the same shape; leaves of at most ``min_dense_size`` elements pass
    through. ``block_topk_pallas`` is the dense masked block top-k kernel,
    ``qsgd_pallas`` and ``qsgd`` the dense QSGD kernel (one norm a node's
    leaf; the reference's jnp ``_qsgd_leaf`` is its kernel's arithmetic);
    ``identity``, ``topk``, ``block_topk``, ``randk`` and ``sign`` are the
    reference's jnp operators, the sparse ones a decode of their codec's
    encode (bitwise the same, ``compression.py:17-20``). ``wire_bytes`` is
    the reference's closed-form table, not a measured payload."""

    name: str = "block_topk_pallas"
    ratio: float = 0.01
    block_size: int = 1024
    qsgd_levels: int = 16
    min_dense_size: int = 0

    def _draws(self, n: int) -> bool:
        if self.name in ("qsgd", "qsgd_pallas"):
            return True
        return self.name == "randk" and _survivors(self.ratio, n) < n

    def uniform_shapes(self, tree) -> Dict[str, Tuple[int, ...]]:
        """``{path: shape}``: QSGD's uniforms of the leaf's shape, rand-k's
        scores ``(K, n)``, each under the leaf key (``ops.py:127``,
        ``compression.py:63-71``)."""
        out = {}
        for p, x in tree_leaves_with_path(tree):
            n = int(np.prod(_node_shape(x)))
            if _rides_dense(x, self.min_dense_size) or not self._draws(n):
                continue
            out[p] = tuple(x.shape) if self.name != "randk" else \
                (x.shape[0], n)
        return out

    def draw_sites(self, tree):
        return {p: (p, 0, s, False)
                for p, s in self.uniform_shapes(tree).items()}

    def _codec(self):
        return {"topk": TopKCodec(ratio=self.ratio),
                "block_topk": BlockTopKCodec(ratio=self.ratio,
                                             block_size=self.block_size)
                }.get(self.name)

    def _leaf(self, x, u):
        if self.name == "identity":
            return x
        if self.name == "sign":
            flat = x.reshape(x.shape[0], -1)
            scale = mean_magnitude(flat).to(flat.dtype)
            sign = torch.where(flat == 0, flat, torch.sign(flat))
            return (sign * scale[:, None]).reshape(x.shape)
        if self.name == "randk":
            n = int(np.prod(_node_shape(x)))
            k = _survivors(self.ratio, n)
            if k >= n:
                return x
            order = _global_order(u.view(torch.int32), k)
            flat = x.reshape(x.shape[0], n)
            return _scatter_set(torch.gather(flat, 1, order), order,
                                _node_shape(x))
        codec = self._codec()
        return codec.decode(*codec.encode(x))

    def __call__(self, tree, uniforms=None):
        items = tree_leaves_with_path(tree)
        paths, leaves = [p for p, _ in items], [x for _, x in items]
        packed = [i for i, x in enumerate(leaves)
                  if not _rides_dense(x, self.min_dense_size)]
        if self.name == "block_topk_pallas":
            out = [kops.block_topk(leaves[i], ratio=self.ratio,
                                   block_size=self.block_size)
                   for i in packed]
        elif self.name in ("qsgd", "qsgd_pallas"):   # one launch a table
            out = kops.qsgd_leaves(
                [leaves[i] for i in packed],
                [_uniforms_for(uniforms, paths[i]) for i in packed],
                levels=self.qsgd_levels)
        else:
            shapes = self.uniform_shapes(tree)
            out = [self._leaf(leaves[i], _uniforms_for(uniforms, paths[i])
                              if paths[i] in shapes else None)
                   for i in packed]
        for i, leaf in zip(packed, out):
            leaves[i] = leaf
        return tree_unflatten(paths, leaves)

    def wire_bytes(self, tree) -> int:
        """Closed-form bytes one node sends for a single-model ``tree``
        (``compression.py:218-241``): f32 values, 4-byte top-k and 2-byte
        block-top-k indices."""
        n = tree_count(tree)
        leaves = len(tree_leaves_with_path(tree))
        name = self.name.replace("_pallas", "")
        if name == "identity":
            return n * 4
        if name == "randk":
            return int(np.ceil(self.ratio * n)) * 4 + 8 * leaves
        if name in ("topk", "block_topk"):
            ib = 2 if name == "block_topk" else 4
            return int(np.ceil(self.ratio * n)) * (4 + ib)
        if name == "sign":
            return n // 8 + 4 * leaves
        if name == "qsgd":
            bits = max(1, int(np.ceil(np.log2(self.qsgd_levels + 1))) + 1)
            return n * bits // 8 + 4 * leaves
        raise ValueError(self.name)


@random.program
def draw_uniforms(compressor, key: torch.Tensor, tree):
    """The draws ``{site: tensor}`` that the reference's encode of the
    node-stacked ``tree`` makes under ``key`` (the round's ``kql``; a
    rand-k stage's as ``(key, scores)``); none for a compressor that names
    no site. One launch a level: the node keys, every stage's leaf keys,
    the draws."""
    sites = compressor.draw_sites(tree)
    if not sites:
        return {}
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    first = next(iter(sites.values()))
    node_keys = yield from random.split.program(key, first[2][0])
    stages = sorted({site[1] for site in sites.values()})
    leaf_keys = dict(zip(stages, (yield from random.together(*(
        random.split.program(node_keys, len(paths)) if s == 0 else
        random.split_fold_in.program(node_keys, len(paths), s)
        for s in stages)))))
    keys = [leaf_keys[s][:, paths.index(p)] for p, s, _, _ in sites.values()]
    drawn = yield from random.together(*(
        random.uniform.program(k, site[2][1:])
        for k, site in zip(keys, sites.values())))
    return {site: (k, u) if keyed else u
            for (site, (_, _, _, keyed)), k, u in zip(sites.items(), keys,
                                                      drawn)}


def leaf_stages(payload: WirePayload, i: int) -> Tuple[Any, ...]:
    """The codec stages that encoded leaf ``i`` of ``payload``
    (``compression.py:617-620``)."""
    return payload.leaf_stages(i)


# the reference's TPU tile rows (repro/kernels/pack.py: ROWS_PER_TILE),
# which its lowering pads the packed leaves to
ROWS_PER_TILE = 8


def _pad_rows(nb: int, mult: int = 8) -> int:
    return -(-nb // mult) * mult


def _qsgd_stage_traffic(nb: int, k: int, esize: int, wbytes: int):
    """(reads, writes) of one carrier-level QSGD stage of the reference's
    lowering (``compression.py:1017-1030``)."""
    c = nb * k
    pr = _pad_rows(nb)
    r = c * esize                       # norm reduction over the carrier
    w = c * 4                           # materialized uniforms (f32)
    r += c * (esize + 4)                # row-pad reads carrier + uniforms
    w += pr * k * (esize + 4)           # padded tiles
    r += pr * k * (esize + 4) + 4       # kernel reads tiles + the norm
    w += pr * k * wbytes                # integer grid out
    r += c * wbytes                     # [:nb] slice
    w += c * wbytes + 4                 # sliced grid + the f32 scale
    return r, w


def encode_hbm_bytes(pipeline: CompressionPipeline, theta, v=None) -> dict:
    """The reference's static per-encode HBM-byte ledger of
    ``encode_pair(theta, v)`` (``compression.py:1033-1126``) for one
    node's trees (no K axis), concrete or shape-only (``meta``) tensors.

    It counts the traffic of the *reference's* lowering on its TPU tiles
    from the leaves' shapes and dtypes alone: every materialized
    intermediate one write and one read a consumer, its Pallas kernels
    their inputs and outputs, the fused path's register-tile residual
    nothing. It is not a measurement of the port's kernels (those are in
    PERF.md, from chip_smoke.py). Returns reads, writes, their total, and
    the ``2p reads + wire writes`` lower bound: one read of θ and v, the
    payload's measured bytes written."""
    fused = bool(getattr(pipeline, "fused", False))
    tleaves = tree_leaves_with_path(theta)
    vleaves = ([x for _, x in tree_leaves_with_path(v)] if v is not None
               else [x for _, x in tleaves])
    reads = writes = lb_reads = lb_writes = 0
    for (path, x), vx in zip(tleaves, vleaves):
        n = int(np.prod(tuple(x.shape)))
        esize, vsize = x.dtype.itemsize, vx.dtype.itemsize
        stages = pipeline.leaf_stages(path)
        s0 = stages[0] if stages else None
        lb_reads += n * (esize + vsize)
        if pipeline.min_dense_size and n <= pipeline.min_dense_size:
            # passthrough: delta materializes at wire size either way (the
            # reference's bound counts its write here and again in the
            # measured payload below)
            reads += n * (esize + vsize)
            writes += n * esize
            lb_writes += n * esize
            continue
        eligible = isinstance(s0, BlockTopKCodec) and s0.use_pallas
        bs = s0.block_size if eligible else 0
        k = max(1, int(np.ceil(s0.ratio * bs))) if eligible else 0
        nb = max(1, -(-n // bs)) if eligible else 0
        if eligible and fused:
            tile = ROWS_PER_TILE * bs
            n_head = (n // tile) * tile
            # aligned prefix: the kernel's read of theta and v is the only
            # O(p) traffic
            reads += n_head * (esize + vsize)
            writes += (n_head // bs) * k * (esize + 4)
            if n_head < n or n_head == 0:
                tail = n - n_head
                reads += tail * (esize + vsize)      # build padded tiles
                writes += tile * (esize + vsize)
                reads += tile * (esize + vsize)      # kernel reads them
                writes += ROWS_PER_TILE * k * (esize + 4)
            rows = (n_head // bs) + (ROWS_PER_TILE if (n_head < n or
                                                       n_head == 0) else 0)
            reads += rows * k * (esize + 4)          # concat + [:nb] slice
            writes += nb * k * (esize + 2)           # vals + uint16 idx
        elif eligible:
            # two-pass: materialize delta, pad-copy, pack kernel
            reads += n * (esize + vsize)             # delta read
            writes += n * esize                      # delta write
            pr = _pad_rows(-(-n // bs), ROWS_PER_TILE)
            pp = pr * bs
            reads += n * esize                       # pad copy
            writes += pp * esize
            reads += pp * esize                      # pack kernel read
            writes += pr * k * (esize + 4)           # vals + int32 idx
            reads += nb * k * (esize + 4)            # slice + narrow
            writes += nb * k * (esize + 2)
        else:
            # ineligible stage 0: delta, then one read and write a stage
            # at its carrier size
            reads += n * (esize + vsize)
            writes += n * esize
            cn, ce = n, esize
            for stage in stages:
                reads += cn * ce
                cn = stage.out_size(cn)
                ce = ce if stage.kind != "quantize" else 1
                writes += cn * ce + stage.sidecar_formula_bytes(n)
            stages = ()
        for stage in stages[1:] if eligible else ():
            if isinstance(stage, QSGDCodec):
                wb = 1 if stage.levels <= 127 else 2
                r, w = _qsgd_stage_traffic(nb, k, esize, wb)
            else:   # e.g. sign: one pass over the carrier, packed out
                r = nb * k * esize
                w = stage.carrier_formula_bytes(nb * k) + \
                    stage.sidecar_formula_bytes(nb * k)
            reads += r
            writes += w
    lb_writes += pipeline.wire_bytes(theta)
    return {
        "read_bytes": int(reads),
        "write_bytes": int(writes),
        "hbm_bytes": int(reads + writes),
        "lower_bound_bytes": int(lb_reads + lb_writes),
    }


def make_compressor(fed_cfg):
    """The compression object a FedConfig names, routed as the reference's
    ``make_compressor`` (``compression.py:1129-1173``): a legacy
    ``*_pallas`` name with no ``pipeline`` is a :class:`Compressor`;
    otherwise ``pipeline`` (or the ``compressor`` name) is parsed into a
    :class:`CompressionPipeline`, wrapped in a :class:`FusedCodec` when
    ``fused_compress`` is set."""
    fed_cfg.check_supported()
    if not fed_cfg.pipeline and fed_cfg.compressor.endswith("_pallas"):
        return Compressor(name=fed_cfg.compressor,
                          ratio=fed_cfg.compress_ratio,
                          block_size=fed_cfg.block_size,
                          qsgd_levels=fed_cfg.qsgd_levels,
                          min_dense_size=fed_cfg.min_dense_size)
    kw = dict(ratio=fed_cfg.compress_ratio, block_size=fed_cfg.block_size,
              qsgd_levels=fed_cfg.qsgd_levels,
              min_dense_size=fed_cfg.min_dense_size)
    base = parse_pipeline(fed_cfg.pipeline or fed_cfg.compressor, **kw)
    fused = bool(fed_cfg.fused_compress)
    if fed_cfg.layer_pipelines:
        rules = tuple((pat, parse_pipeline(sub, **kw))
                      for pat, sub in fed_cfg.layer_pipelines)
        if fused:
            rules = tuple((pat, replace(p, stages=_lower_stage0(p.stages)))
                          for pat, p in rules)
        return PerLayerPipeline(stages=_lower_stage0(base.stages) if fused
                                else base.stages,
                                min_dense_size=base.min_dense_size,
                                rules=rules, fused=fused)
    if fused:
        return FusedCodec.wrap(base, fused=True)
    return base
