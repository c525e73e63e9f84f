"""Compression Q(.) for CD-BFL (paper Eq. 6) and its wire format.

The subset of ``repro/core/compression.py`` the slice runs: the block-top-k
codec on the kernel path (``"pallas"`` mode: two-tier slot order, uint16
block-local indices), the codec pipeline, the fused compress-in-update
lowering and the materialized :class:`WirePayload`.

Leaves are node-stacked, ``(K, *shape)``: one encode covers every node, as
the reference's ``vmap(encode_pair)`` does, and each payload buffer leads
with K. The per-leaf metadata describes one node's leaf, so the byte
counts and the metadata equal the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.utils.tree import (tree_leaves_with_path, tree_map,
                                   tree_unflatten)


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

    def _meta(self, x, vals) -> _SparseMeta:
        shape = tuple(x.shape[1:])
        return _SparseMeta(shape, int(np.prod(shape)), vals.shape[2], "pallas",
                           nb=vals.shape[1], bs=self.block_size)

    def encode(self, x):
        vals, idx = kops.block_topk_pack(x, ratio=self.ratio,
                                         block_size=self.block_size)
        return vals, {"idx": idx}, self._meta(x, vals)

    def decode(self, carrier, aux, meta):
        return kops.block_topk_unpack(carrier, aux["idx"], meta.shape,
                                      block_size=self.block_size)


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
    value buffer and its uint16 index sidecar, each leading with K."""

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

    stages: Tuple[BlockTopKCodec, ...] = (BlockTopKCodec(),)
    min_dense_size: int = 0

    def _encode_leaf(self, x, v):
        """The two-pass encode: the residual is materialized here."""
        carrier = x if v is None else x - v.to(x.dtype)
        auxes, metas = [], []
        for stage in self.stages:
            carrier, aux, meta = stage.encode(carrier)
            auxes.append(aux)
            metas.append(meta)
        return carrier, tuple(auxes), tuple(metas)

    def _encode_impl(self, tree, vtree) -> WirePayload:
        leaves = tree_leaves_with_path(tree)
        vleaves = ([x for _, x in tree_leaves_with_path(vtree)]
                   if vtree is not None else [None] * len(leaves))
        entries, specs = [], []
        for (_, x), v in zip(leaves, vleaves):
            shape = tuple(x.shape[1:])
            dtype = str(x.dtype).replace("torch.", "")
            if self.min_dense_size and int(np.prod(shape)) <= self.min_dense_size:
                wire = x if v is None else x - v.to(x.dtype)
                entries.append(LeafPayload(wire=wire, aux=()))
                specs.append(LeafSpec(shape, dtype, True))
                continue
            carrier, auxes, metas = self._encode_leaf(x, v)
            entries.append(LeafPayload(wire=carrier, aux=auxes))
            specs.append(LeafSpec(shape, dtype, False, metas))
        return WirePayload(entries, [p for p, _ in leaves], specs, self.stages)

    def encode(self, tree) -> WirePayload:
        return self._encode_impl(tree, None)

    def encode_pair(self, theta, v) -> WirePayload:
        """Encode the residual ``theta - v`` handed as its two operands."""
        return self._encode_impl(theta, v)

    def decode(self, payload: WirePayload):
        leaves = []
        for entry, spec in zip(payload.entries, payload.specs):
            carrier = entry.wire
            if not spec.passthrough:
                for stage, aux, meta in reversed(list(zip(
                        payload.stages, entry.aux, spec.metas))):
                    carrier = stage.decode(carrier, aux, meta)
            leaves.append(carrier)
        return tree_unflatten(list(payload.paths), leaves)

    def wire_bytes(self, tree) -> int:
        """Bytes one node puts on the wire for a single-model ``tree``:
        the payload of shape-only (``meta``) leaves, measured."""
        specs = tree_map(lambda x: torch.empty((1,) + tuple(x.shape),
                                               dtype=x.dtype, device="meta"),
                         tree)
        return self.encode(specs).measured_bytes()


@dataclass(frozen=True)
class FusedCodec(CompressionPipeline):
    """Compress-in-update lowering: ``encode_pair`` runs the delta-pack
    kernel, so the dense residual never reaches device memory. With
    ``fused=False`` the same object is the two-pass oracle: residual
    materialized, then the pack kernel. Both give the same payload bit for
    bit."""

    fused: bool = True

    @classmethod
    def wrap(cls, pipeline: CompressionPipeline, fused: bool = True
             ) -> "FusedCodec":
        return cls(stages=pipeline.stages,
                   min_dense_size=pipeline.min_dense_size, fused=fused)

    def _encode_leaf(self, x, v):
        if v is None or not self.fused:
            return super()._encode_leaf(x, v)
        (s0,) = self.stages     # one block-top-k stage (block_topk|qsgd: B5)
        vals, idx = kops.fused_delta_pack(x, v, ratio=s0.ratio,
                                          block_size=s0.block_size)
        return vals, ({"idx": idx},), (s0._meta(x, vals),)


def make_compressor(fed_cfg) -> CompressionPipeline:
    """The compression object a FedConfig names. The slice runs
    ``compressor="block_topk"`` with ``fused_compress=True``: a
    :class:`FusedCodec` over one block-top-k stage."""
    fed_cfg.check_supported()
    base = CompressionPipeline(
        stages=(BlockTopKCodec(ratio=fed_cfg.compress_ratio,
                               block_size=fed_cfg.block_size),),
        min_dense_size=fed_cfg.min_dense_size)
    return FusedCodec.wrap(base, fused=True)
