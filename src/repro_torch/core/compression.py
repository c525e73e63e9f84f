"""Compression Q(.) for CD-BFL (paper Eq. 6) and its wire format.

The subset of ``repro/core/compression.py`` the port runs: the block-top-k
codec on the kernel path (``"pallas"`` mode: two-tier slot order, uint16
block-local indices), the QSGD codec (int8 grid + f32 scale), the
``block_topk`` and ``block_topk|qsgd`` pipelines, the fused
compress-in-update lowering, the materialized :class:`WirePayload`, and
the legacy dense :class:`Compressor` under its ``block_topk_pallas`` and
``qsgd_pallas`` names.

Leaves are node-stacked, ``(K, *shape)``: one encode covers every node, as
the reference's ``vmap(encode_pair)`` does, and each payload buffer leads
with K. The per-leaf metadata describes one node's leaf, so the byte
counts and the metadata equal the reference's.

The QSGD uniforms are an input of encode. A compressor's
``uniform_shapes(tree)`` names the leaves whose encode draws them,
``{path: node-stacked shape}`` in leaf order; encode takes them as
``uniforms`` (``{path: tensor}``) and raises if one is missing.
:func:`draw_uniforms` draws them from the reference's keys: node k's from
``fold_in(key, k)`` (``algorithms.py:182-184, 221``), leaf i's from
``split(node_key, n_leaves)[i]`` over every leaf, the dense-riding ones
included (``compression.py:722``; the legacy compressor's
``split_key_like``, ``:194-197``), and a pipeline's stochastic stage s > 0
from ``fold_in(leaf_key, s)`` (``_stage_key``, ``:674-677``).
"""
from __future__ import annotations

from dataclasses import dataclass
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


class _SparseMeta(NamedTuple):
    """Static decode info of a sparsify stage (one node's leaf)."""
    shape: Tuple[int, ...]
    n: int
    k: int
    mode: str                   # "pallas": the kernel path's slot order
    nb: int = 0
    bs: int = 0


@dataclass(frozen=True)
class BlockTopKCodec:
    """Block-local top-k, a codec stage: uint16 block-local indices and an
    (nb, k) value buffer a node, in the kernel path's slot order (the
    reference's ``use_pallas=True``). The ``lax.top_k``-order path is
    ROADMAP A4.
    """
    ratio: float = 0.01
    block_size: int = 1024
    stochastic = False

    def _meta(self, x, vals) -> _SparseMeta:
        shape = tuple(x.shape[1:])
        return _SparseMeta(shape, int(np.prod(shape)), vals.shape[2], "pallas",
                           nb=vals.shape[1], bs=self.block_size)

    def out_shape(self, shape) -> Tuple[int, int]:
        """One node's carrier shape for a leaf of ``shape``: ``(nb, k)``."""
        n = int(np.prod(shape))
        return (kops.num_blocks(n, self.block_size),
                kops.survivors_per_block(self.ratio, self.block_size))

    def encode(self, x, u=None):
        vals, idx = kops.block_topk_pack(x, ratio=self.ratio,
                                         block_size=self.block_size)
        return vals, {"idx": idx}, self._meta(x, vals)

    def decode(self, carrier, aux, meta):
        return self.decode_leaves([(carrier, aux, meta)])[0]

    def decode_leaves(self, items):
        """:meth:`decode` of every ``(carrier, aux, meta)`` of a list, one
        unpack launch a table of leaves."""
        return kops.block_topk_unpack_leaves(
            [(carrier, aux["idx"]) for carrier, aux, _ in items],
            [meta.shape for _, _, meta in items], block_size=self.block_size)


class _QuantMeta(NamedTuple):
    """Static decode info of a QSGD stage (one node's carrier)."""
    shape: Tuple[int, ...]
    n: int
    in_dtype: str               # dtype of the carrier consumed
    levels: int = 0
    omega: float = 0.0          # the 1/(1+ω) contraction scaling


@dataclass(frozen=True)
class QSGDCodec:
    """QSGD stochastic quantization (``compression.py:505-550`` of the
    reference): the carrier is the int8 grid ``sign(x)·q`` and the sidecar
    the ``(1,)`` f32 norm ``‖x‖₂ + 1e-12`` of each node's carrier, so a
    node-stacked encode gives ``(K, *shape)`` int8 and a ``(K, 1)`` scale.

    ``encode`` is the codec's own arithmetic in torch ops (the two-pass
    oracle's), the norm in the grid_quant kernel's summation order
    (:func:`carrier_norms_plain`); the fused path runs the kernel instead
    (``FusedCodec``), with the same carrier and scale bit for bit. Decode
    is ``q·norm/s·r`` with ``r`` the f32 reciprocal of ``1 + ω``: the
    reference's jit-compiled decode, which XLA folds from ``/ s / (1 +
    ω)``.
    """
    levels: int = 16
    stochastic = True

    def _meta(self, x) -> _QuantMeta:
        shape = tuple(x.shape[1:])
        n = int(np.prod(shape))
        return _QuantMeta(shape, n, str(x.dtype).replace("torch.", ""),
                          levels=self.levels, omega=_qsgd_omega(n, self.levels))

    def out_shape(self, shape):
        return tuple(shape)

    def encode(self, x, u):
        rows = x.float().reshape(x.shape[0], -1)
        norm = carrier_norms_plain(rows)
        grid = grid_quant_plain(rows, u.reshape(rows.shape), norm, self.levels)
        return (grid.reshape(x.shape), {"scale": norm.reshape(-1, 1)},
                self._meta(x))

    def decode(self, carrier, aux, meta):
        norm = aux["scale"].reshape((-1,) + (1,) * len(meta.shape))
        out = carrier.float() * norm / meta.levels * inv_one_plus(meta.omega)
        return out.to(getattr(torch, meta.in_dtype))

    def decode_leaves(self, items):
        return [self.decode(*item) for item in items]


def _rides_dense(x, min_dense_size: int) -> bool:
    """A node-stacked leaf of at most ``min_dense_size`` elements a node
    crosses the link uncompressed."""
    return bool(min_dense_size) and \
        int(np.prod(tuple(x.shape[1:]))) <= min_dense_size


def _uniforms_for(uniforms, path):
    if uniforms is None or path not in uniforms:
        raise ValueError(f"leaf {path!r} needs QSGD uniforms and none were "
                         f"given (see uniform_shapes)")
    return uniforms[path]


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


def _buffer_bytes(buf) -> int:
    return int(np.prod(tuple(buf.shape))) * buf.element_size()


class WirePayload:
    """The packed representation that crosses the link: per leaf, the
    carrier (f32 values, or the int8 QSGD grid) and the stages' sidecars
    (uint16 indices, f32 scale), each leading with K."""

    def __init__(self, entries, paths, specs, stages):
        self.entries = tuple(entries)
        self.paths = tuple(paths)
        self.specs = tuple(specs)
        self.stages = tuple(stages)

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
    """Chainable codec stages with a materialized wire format."""

    stages: Tuple[Any, ...] = (BlockTopKCodec(),)
    min_dense_size: int = 0

    @property
    def uniform_stage(self) -> int:
        """Index of the stage that draws uniforms (its key is
        ``fold_in(leaf_key, index)`` past stage 0)."""
        return next((i for i, s in enumerate(self.stages) if s.stochastic), 0)

    def uniform_shapes(self, tree) -> Dict[str, Tuple[int, ...]]:
        """``{path: (K, *carrier shape)}`` of the leaves whose stochastic
        stage draws uniforms, in leaf order; ``tree`` is node-stacked."""
        out = {}
        for path, x in tree_leaves_with_path(tree):
            if _rides_dense(x, self.min_dense_size):
                continue
            shape = tuple(x.shape[1:])
            for stage in self.stages:
                if stage.stochastic:
                    out[path] = (x.shape[0],) + tuple(shape)
                shape = stage.out_shape(shape)
        return out

    def _encode_leaf(self, x, v, u):
        """The two-pass encode: the residual is materialized here."""
        carrier = x if v is None else x - v.to(x.dtype)
        auxes, metas = [], []
        for stage in self.stages:
            carrier, aux, meta = stage.encode(carrier, u)
            auxes.append(aux)
            metas.append(meta)
        return carrier, tuple(auxes), tuple(metas)

    def _encode_leaves(self, xs, vs, us):
        """``(carrier, auxes, metas)`` of every compressed leaf, in order."""
        return [self._encode_leaf(x, v, u) for x, v, u in zip(xs, vs, us)]

    def _encode_impl(self, tree, vtree, uniforms) -> WirePayload:
        leaves = tree_leaves_with_path(tree)
        vleaves = ([x for _, x in tree_leaves_with_path(vtree)]
                   if vtree is not None else [None] * len(leaves))
        stochastic = any(s.stochastic for s in self.stages)
        packed = [i for i, (_, x) in enumerate(leaves)
                  if not _rides_dense(x, self.min_dense_size)]
        encoded = dict(zip(packed, self._encode_leaves(
            [leaves[i][1] for i in packed], [vleaves[i] for i in packed],
            [_uniforms_for(uniforms, leaves[i][0]) if stochastic else None
             for i in packed])))
        entries, specs = [], []
        for i, ((path, x), v) in enumerate(zip(leaves, vleaves)):
            shape = tuple(x.shape[1:])
            dtype = str(x.dtype).replace("torch.", "")
            if i not in encoded:
                wire = x if v is None else x - v.to(x.dtype)
                entries.append(LeafPayload(wire=wire, aux=()))
                specs.append(LeafSpec(shape, dtype, True))
                continue
            carrier, auxes, metas = encoded[i]
            entries.append(LeafPayload(wire=carrier, aux=auxes))
            specs.append(LeafSpec(shape, dtype, False, metas))
        return WirePayload(entries, [p for p, _ in leaves], specs, self.stages)

    def encode(self, tree, uniforms=None) -> WirePayload:
        return self._encode_impl(tree, None, uniforms)

    def encode_pair(self, theta, v, uniforms=None) -> WirePayload:
        """Encode the residual ``theta - v`` handed as its two operands."""
        return self._encode_impl(theta, v, uniforms)

    def decode(self, payload: WirePayload):
        """Stage-major: the last stage decodes every compressed leaf, then
        the stage before it, so one block-top-k decode (one unpack launch a
        table of leaves) covers them all; passthrough leaves are kept."""
        leaves = [entry.wire for entry in payload.entries]
        packed = [i for i, spec in enumerate(payload.specs)
                  if not spec.passthrough]
        for s in reversed(range(len(payload.stages))):
            decoded = payload.stages[s].decode_leaves(
                [(leaves[i], payload.entries[i].aux[s],
                  payload.specs[i].metas[s]) for i in packed])
            for i, leaf in zip(packed, decoded):
                leaves[i] = leaf
        return tree_unflatten(list(payload.paths), leaves)

    def wire_bytes(self, tree) -> int:
        """Bytes one node puts on the wire for a single-model ``tree``:
        the payload of shape-only (``meta``) leaves, measured."""
        specs = tree_map(lambda x: torch.empty((1,) + tuple(x.shape),
                                               dtype=x.dtype, device="meta"),
                         tree)
        uniforms = {p: torch.empty(s, device="meta")
                    for p, s in self.uniform_shapes(specs).items()}
        return self.encode(specs, uniforms).measured_bytes()


@dataclass(frozen=True)
class FusedCodec(CompressionPipeline):
    """Compress-in-update lowering: ``encode_pair`` runs the delta-pack
    kernel once over every compressed leaf (one launch a table of leaves),
    so the dense residual never reaches device memory, and a trailing QSGD
    stage quantizes every packed carrier, norms included, in one grid_quant
    launch a table of leaves. With
    ``fused=False`` the same object is the two-pass oracle: residual
    materialized, the pack kernel leaf by leaf, then the QSGD codec's own
    arithmetic. Both give the same payload bit for bit."""

    fused: bool = True

    @classmethod
    def wrap(cls, pipeline: CompressionPipeline, fused: bool = True
             ) -> "FusedCodec":
        return cls(stages=pipeline.stages,
                   min_dense_size=pipeline.min_dense_size, fused=fused)

    def _encode_leaves(self, xs, vs, us):
        if not xs or vs[0] is None or not self.fused:
            return super()._encode_leaves(xs, vs, us)
        s0, *rest = self.stages          # parse_pipeline: block_topk first
        packed = kops.fused_delta_pack_leaves(xs, vs, ratio=s0.ratio,
                                              block_size=s0.block_size)
        out = [(vals, ({"idx": idx},), (s0._meta(x, vals),))
               for x, (vals, idx) in zip(xs, packed)]
        if not rest:
            return out
        stage, = rest                    # QSGD, the one stage that follows
        quantized = kops.qsgd_quantize_carriers([vals for vals, _ in packed],
                                                us, levels=stage.levels)
        return [(grid, auxes + ({"scale": norm.reshape(-1, 1)},),
                 metas + (stage._meta(carrier),))
                for (carrier, auxes, metas), (grid, norm) in zip(out,
                                                                 quantized)]


@dataclass(frozen=True)
class Compressor:
    """The legacy dense compressor (``compression.py:162-236`` of the
    reference) under the names that reach a kernel: ``block_topk_pallas``
    (the dense masked block top-k) and ``qsgd_pallas`` (dense QSGD, one
    norm per node's leaf). ``__call__`` maps node-stacked leaves to dense
    leaves of the same shape; leaves of at most ``min_dense_size``
    elements pass through. ``wire_bytes`` is the reference's closed-form
    table, not a measured payload: there is none."""

    name: str = "block_topk_pallas"
    ratio: float = 0.01
    block_size: int = 1024
    qsgd_levels: int = 16
    min_dense_size: int = 0
    uniform_stage = 0           # the leaf key itself (``ops.py:127``)

    def uniform_shapes(self, tree) -> Dict[str, Tuple[int, ...]]:
        if self.name != "qsgd_pallas":
            return {}
        return {p: tuple(x.shape) for p, x in tree_leaves_with_path(tree)
                if not _rides_dense(x, self.min_dense_size)}

    def __call__(self, tree, uniforms=None):
        items = tree_leaves_with_path(tree)
        paths, leaves = [p for p, _ in items], [x for _, x in items]
        packed = [i for i, x in enumerate(leaves)
                  if not _rides_dense(x, self.min_dense_size)]
        if self.name == "block_topk_pallas":
            out = [kops.block_topk(leaves[i], ratio=self.ratio,
                                   block_size=self.block_size)
                   for i in packed]
        else:                    # one qsgd launch a table of leaves
            out = kops.qsgd_leaves(
                [leaves[i] for i in packed],
                [_uniforms_for(uniforms, paths[i]) for i in packed],
                levels=self.qsgd_levels)
        for i, leaf in zip(packed, out):
            leaves[i] = leaf
        return tree_unflatten(paths, leaves)

    def wire_bytes(self, tree) -> int:
        """Closed-form bytes one node sends for a single-model ``tree``."""
        n = tree_count(tree)
        if self.name == "block_topk_pallas":
            # values + uint16 block-local indices
            return int(np.ceil(self.ratio * n)) * (4 + 2)
        bits = max(1, int(np.ceil(np.log2(self.qsgd_levels + 1))) + 1)
        return n * bits // 8 + 4 * len(tree_leaves_with_path(tree))


@random.program
def draw_uniforms(compressor, key: torch.Tensor, tree):
    """The QSGD uniforms ``{path: (K, *carrier shape)}`` that the
    reference's encode of the node-stacked ``tree`` draws under ``key``
    (the round's ``kql``); none for a compressor that names no leaf."""
    shapes = compressor.uniform_shapes(tree)
    if not shapes:
        return {}
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    node_keys = yield from random.split.program(key, shapes[next(iter(
        shapes))][0])
    stage = compressor.uniform_stage
    leaf_keys = yield from (
        random.split.program(node_keys, len(paths)) if stage == 0 else
        random.split_fold_in.program(node_keys, len(paths), stage))
    drawn = yield from random.together(*(
        random.uniform.program(leaf_keys[:, paths.index(p)], shape[1:])
        for p, shape in shapes.items()))
    return dict(zip(shapes, drawn))


_PIPELINES = {
    "block_topk": lambda ratio, block_size, levels: (
        BlockTopKCodec(ratio=ratio, block_size=block_size),),
    "block_topk|qsgd": lambda ratio, block_size, levels: (
        BlockTopKCodec(ratio=ratio, block_size=block_size),
        QSGDCodec(levels=levels)),
}


def parse_pipeline(spec: str, *, ratio: float = 0.01, block_size: int = 1024,
                   qsgd_levels: int = 16,
                   min_dense_size: int = 0) -> CompressionPipeline:
    """The ``"stage|stage"`` DSL, for the pipelines the port runs."""
    key = "|".join(s.strip() for s in spec.split("|"))
    if key not in _PIPELINES:
        raise NotImplementedError(
            f"pipeline {spec!r} is not ported yet (runs: {sorted(_PIPELINES)})"
            f"; ROADMAP A6 (the other codecs)")
    return CompressionPipeline(
        stages=_PIPELINES[key](ratio, block_size, qsgd_levels),
        min_dense_size=min_dense_size)


def make_compressor(fed_cfg):
    """The compression object a FedConfig names, routed as the reference's
    ``make_compressor`` (``compression.py:1129-1164``): a legacy
    ``*_pallas`` name with no ``pipeline`` is a :class:`Compressor`;
    otherwise ``pipeline`` (or the ``compressor`` name) is parsed into a
    pipeline wrapped in a :class:`FusedCodec`."""
    fed_cfg.check_supported()
    if not fed_cfg.pipeline and fed_cfg.compressor.endswith("_pallas"):
        return Compressor(name=fed_cfg.compressor,
                          ratio=fed_cfg.compress_ratio,
                          block_size=fed_cfg.block_size,
                          qsgd_levels=fed_cfg.qsgd_levels,
                          min_dense_size=fed_cfg.min_dense_size)
    base = parse_pipeline(fed_cfg.pipeline or fed_cfg.compressor,
                          ratio=fed_cfg.compress_ratio,
                          block_size=fed_cfg.block_size,
                          qsgd_levels=fed_cfg.qsgd_levels,
                          min_dense_size=fed_cfg.min_dense_size)
    return FusedCodec.wrap(base, fused=True)
