"""Lossy D2D transport under the gossip layer (``repro/core/transport.py``).

Two levels share one frame-layout arithmetic, as in the reference:

* the host byte codec — :func:`fragment`, :func:`parse_frame`,
  :func:`reassemble` and :func:`serialize_payload` on real byte strings
  (``struct`` headers, zlib CRC-32 over the frame's payload, ROADMAP C1);
* the in-round erasure model — frames are never built; each leaf's static
  layout maps its stage-0 codec records to frames, a loss model draws a
  keep mask a frame, and the decoded delta is masked through the stage-0
  decode (the sparsifier's own: unpack_set for the default codec, unpack
  for the fused one).

Every draw is the reference's: the transport's stream is ``fold_in(kql,
TRANSPORT_SALT)`` (``kql`` the codec key of the round), node k's key
``fold_in(·, k)``, leaf i's ``fold_in(·, i)``, ARQ attempt ``a > 0``'s
``fold_in(·, a)``. The keys of every node, leaf and attempt come a level
at a time as :mod:`repro_torch.random` programs, so they join the round's
batched draws: the transport adds three key levels to a round (the salt,
the nodes, the leaves with their attempts), and a burst channel one more
(its three-way split) before its uniforms.

Leaves lead with the node axis K: one call masks every node. The loss
models' masks are ``(K, A, F)`` for A attempts of F frames. The Gilbert–
Elliott recurrence runs in the gilbert_keep kernel
(``kernels/gilbert.py``) on the card.

The ARQ budget gate sums airtime in XLA's CPU order (ROADMAP C18): the
reference's ``cumsum`` is a reduce-window that XLA's rewriter blocks into
rows of 16 (:func:`xla_cumsum`), and its node-batched ``dot`` is XLA's
tiled matrix-vector emitter (:func:`xla_matvec`), so the frames an airtime
budget admits are the reference's exactly.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.kernels.gilbert import channel_params, gilbert_keep
from repro_torch.utils.device import device_const
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

# Frame header: LEN (uint16, payload bytes) | SEQ (uint16) | CRC32 (uint32),
# little-endian. 8 bytes on the air in front of every fragment.
HEADER_FMT = "<HHI"
HEADER_BYTES = struct.calcsize(HEADER_FMT)       # == 8

# the salt folding the round's codec key into the frame-loss stream
# (transport.py:84)
TRANSPORT_SALT = 5


# --------------------------------------------------------------------------
# Host byte codec: real frames, real headers, real CRC (transport.py:91-192)
# --------------------------------------------------------------------------

def _payload_cap(mtu: int) -> int:
    cap = int(mtu) - HEADER_BYTES
    if cap <= 0:
        raise ValueError(f"mtu {mtu} too small for the {HEADER_BYTES}-byte "
                         f"frame header")
    return cap


def frame_sizes(total_bytes: int, mtu: int) -> np.ndarray:
    """On-air bytes of every frame of a ``total_bytes`` payload: at most
    ``mtu - 8`` payload bytes plus the header each, the tail short; a
    zero-byte payload still costs one header-only frame."""
    cap = _payload_cap(mtu)
    n = max(1, -(-int(total_bytes) // cap))
    sizes = np.full(n, cap + HEADER_BYTES, np.int64)
    sizes[-1] = total_bytes - (n - 1) * cap + HEADER_BYTES
    return sizes


def num_frames(total_bytes: int, mtu: int) -> int:
    return int(frame_sizes(total_bytes, mtu).shape[0])


def fragment(data: bytes, mtu: int) -> List[bytes]:
    """``data`` as MTU-bounded frames with LEN/SEQ/CRC headers."""
    cap = _payload_cap(mtu)
    n = max(1, -(-len(data) // cap))
    if n - 1 > np.iinfo(np.uint16).max:
        raise ValueError(f"payload of {len(data)} bytes needs {n} frames; "
                         f"SEQ is uint16")
    frames = []
    for seq in range(n):
        chunk = data[seq * cap:(seq + 1) * cap]
        hdr = struct.pack(HEADER_FMT, len(chunk), seq,
                          zlib.crc32(chunk) & 0xFFFFFFFF)
        frames.append(hdr + chunk)
    return frames


def parse_frame(frame: bytes) -> Optional[Tuple[int, bytes]]:
    """``(seq, payload)`` of a frame, or None if it is truncated, over-long
    or fails its CRC (which covers the payload only, ROADMAP C1)."""
    if len(frame) < HEADER_BYTES:
        return None
    length, seq, crc = struct.unpack(HEADER_FMT, frame[:HEADER_BYTES])
    payload = frame[HEADER_BYTES:]
    if len(payload) != length:
        return None
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        return None
    return seq, payload


def reassemble(frames: Sequence[Optional[bytes]], total_bytes: int,
               mtu: int) -> Tuple[bytes, np.ndarray]:
    """``(data, received)`` of a ``total_bytes`` payload from lost, corrupt
    or reordered frames: missing regions zero-filled, ``received`` the
    per-frame delivery mask."""
    sizes = frame_sizes(total_bytes, mtu)
    cap = int(mtu) - HEADER_BYTES
    n = sizes.shape[0]
    received = np.zeros(n, bool)
    out = bytearray(total_bytes)
    for frame in frames:
        if frame is None:
            continue
        parsed = parse_frame(frame)
        if parsed is None:
            continue
        seq, payload = parsed
        if seq >= n or len(payload) != sizes[seq] - HEADER_BYTES:
            continue
        out[seq * cap:seq * cap + len(payload)] = payload
        received[seq] = True
    return bytes(out), received


def _le_bytes(buf: torch.Tensor) -> bytes:
    arr = buf.detach().cpu().contiguous()
    if arr.dtype == torch.uint16:
        arr = arr.view(torch.int16)
    elif arr.dtype == torch.uint32:
        arr = arr.view(torch.int32)
    data = arr.numpy()
    return data.astype(data.dtype.newbyteorder("<")).tobytes()


def serialize_payload(payload) -> bytes:
    """The on-air byte string of a :class:`WirePayload`: per leaf in order,
    the final carrier, then every stage's sidecars with keys sorted, each
    buffer's raw little-endian C-order bytes. The buffers lead with the
    node axis, so a payload of one node gives that node's bytes, and
    ``len(serialize_payload(p)) == p.measured_bytes()``."""
    chunks: List[bytes] = []
    for entry in payload.entries:
        chunks.append(_le_bytes(entry.wire))
        for aux in entry.aux:
            for k in sorted(aux):
                chunks.append(_le_bytes(aux[k]))
    return b"".join(chunks)


# --------------------------------------------------------------------------
# Loss models: keep masks of (K, A, F) frames as draw programs
# (transport.py:199-346)
# --------------------------------------------------------------------------

def _no_draws():
    """A program that draws nothing (a generator that yields no level)."""
    return
    yield


def _rate(rate, num_nodes: int, device):
    """A rate as the reference's f32 comparison operand: a scalar's f32
    value, or one a node shaped to broadcast over (K, A, F)."""
    r = np.asarray(rate, np.float32)
    if not r.ndim:
        return float(r)
    return device_const(("rate", r.tobytes()), device,
                        lambda: r.reshape(num_nodes, 1, 1))


class LossModel:
    """Per-frame keep masks. ``keep.program(keys, frames)`` takes the
    ``(K, A, n_leaves, 2)`` keys of every node, ARQ attempt and leaf and
    the leaves' frame counts, and returns ``[(K, A, F_i)]`` f32 0/1 masks:
    ``mask[k, a]`` is the reference's ``keep(key, F_i, k, attempt=a)``."""

    lossy: bool = True

    def keep(self, keys, frames):
        raise NotImplementedError

    def constant(self, attempt: int) -> bool:
        """Is attempt ``attempt``'s mask a constant of the reference's
        program (no draw behind it)? XLA folds what follows from one."""
        return False


@dataclass(frozen=True)
class BernoulliLoss(LossModel):
    """iid erasure: ``uniform(key, (F,)) >= rate``, the rate a scalar or
    one a node (1.0 is a dead transmitter)."""

    rate: object = 0.0

    @property
    def lossy(self) -> bool:
        return bool(np.any(np.asarray(self.rate, np.float64) > 0.0))

    @random.program
    def keep(self, keys, frames):
        got = yield from random.together(*(
            random.uniform.program(keys[:, :, i], (f,))
            for i, f in enumerate(frames)))
        p = _rate(self.rate, keys.shape[0], keys.device)
        return [(u >= p).float() for u in got]


@dataclass(frozen=True)
class GilbertElliottLoss(LossModel):
    """The two-state burst channel: ``k0, ktrans, kloss = split(key, 3)``,
    the start state ``uniform(k0, ()) < π_bad``, ``u_t`` and ``u_l``
    uniforms of the frames from ``ktrans`` and ``kloss``; the chain runs in
    the gilbert_keep kernel, every chain of the round in one launch."""

    p_enter: float = 0.05
    p_exit: float = 0.3
    loss_good: float = 0.0
    loss_bad: float = 1.0

    @property
    def lossy(self) -> bool:
        return (self.loss_good > 0.0
                or (self.loss_bad > 0.0 and self.p_enter > 0.0))

    @random.program
    def keep(self, keys, frames):
        k, a, nl = keys.shape[:3]
        ks = yield from random.split.program(keys, 3)   # (K, A, nl, 3, 2)
        got = yield from random.together(
            random.uniform.program(ks[:, :, :, 0], ()),
            *(random.uniform.program(ks[:, :, i, 1], (f,))
              for i, f in enumerate(frames)),
            *(random.uniform.program(ks[:, :, i, 2], (f,))
              for i, f in enumerate(frames)))
        u0 = got[0].reshape(k * a, nl)
        u_t = [x.reshape(k * a, -1) for x in got[1:1 + nl]]
        u_l = [x.reshape(k * a, -1) for x in got[1 + nl:]]
        params = channel_params(self.p_enter, self.p_exit, self.loss_good,
                                self.loss_bad)
        return [m.reshape(k, a, -1)
                for m in gilbert_keep(u0, u_t, u_l, params)]


@dataclass(frozen=True)
class FixedMaskLoss(LossModel):
    """Drop an explicit set of frame indices on every leaf, node and
    attempt: the fault harness's deterministic fixture."""

    drop: Tuple[int, ...] = ()

    @property
    def lossy(self) -> bool:
        return len(self.drop) > 0

    def constant(self, attempt: int) -> bool:
        return True

    @random.program
    def keep(self, keys, frames):
        yield from _no_draws()

        def mask(f):
            m = np.ones(f, np.float32)
            for d in self.drop:
                if 0 <= d < f:
                    m[d] = 0.0
            return m
        return [device_const(("drop", self.drop, f), keys.device,
                             lambda: mask(f)).expand(
                                 keys.shape[0], keys.shape[1], f)
                for f in frames]


@dataclass(frozen=True)
class DeadNodeLoss(LossModel):
    """``base``'s masks with the listed senders' broadcasts erased."""

    base: LossModel = BernoulliLoss(0.0)
    dead: Tuple[int, ...] = ()

    @property
    def lossy(self) -> bool:
        return self.base.lossy or len(self.dead) > 0

    def constant(self, attempt: int) -> bool:
        return self.base.constant(attempt)

    @random.program
    def keep(self, keys, frames):
        got = yield from self.base.keep.program(keys, frames)
        k = keys.shape[0]

        def alive():
            a = np.ones((k, 1, 1), np.float32)
            for d in self.dead:
                if 0 <= int(d) < k:
                    a[int(d)] = 0.0
            return a
        alive_t = device_const(("alive", self.dead, k), keys.device, alive)
        return [m * alive_t for m in got]


@dataclass(frozen=True)
class DropFirstAttemptLoss(LossModel):
    """Every frame erased on the first ``attempts`` ARQ attempts, then
    ``base``'s masks: the fixture that forces the retransmit path."""

    base: LossModel = BernoulliLoss(0.0)
    attempts: int = 1

    @property
    def lossy(self) -> bool:
        return True

    def constant(self, attempt: int) -> bool:
        return attempt < self.attempts or self.base.constant(attempt)

    @random.program
    def keep(self, keys, frames):
        got = yield from self.base.keep.program(keys, frames)
        first = torch.arange(keys.shape[1], device=keys.device) >= \
            self.attempts
        return [m * first.float().reshape(1, -1, 1) for m in got]


def model_from_config(cfg) -> LossModel:
    """The loss model a :class:`~repro_torch.config.TransportConfig`
    names."""
    if cfg.loss_model == "bernoulli":
        return BernoulliLoss(rate=cfg.erasure)
    if cfg.loss_model == "gilbert":
        return GilbertElliottLoss(p_enter=cfg.gilbert_p_enter,
                                  p_exit=cfg.gilbert_p_exit,
                                  loss_good=cfg.gilbert_loss_good,
                                  loss_bad=cfg.gilbert_loss_bad)
    raise ValueError(f"unknown loss model {cfg.loss_model!r}; "
                     f"known: bernoulli, gilbert")


# --------------------------------------------------------------------------
# LoRa time-on-air (transport.py:354-378)
# --------------------------------------------------------------------------

def lora_toa_s(frame_bytes, sf: int = 7, bw_hz: float = 125_000.0,
               coding_rate: int = 1, preamble_syms: int = 8) -> np.ndarray:
    """Per-frame LoRa time-on-air in seconds (Semtech SX127x formula):
    ``T_sym = 2^SF / BW``, explicit header, CRC on, low-data-rate
    optimization when a symbol exceeds 16 ms; float64 numpy."""
    sf = int(sf)
    cr = int(coding_rate)
    if not 6 <= sf <= 12:
        raise ValueError(f"LoRa spreading factor {sf} outside 6..12")
    if not 1 <= cr <= 4:
        raise ValueError(f"LoRa coding-rate index {cr} outside 1..4 "
                         f"(4/5 .. 4/8)")
    pl = np.asarray(frame_bytes, np.float64)
    t_sym = float(2.0 ** sf) / float(bw_hz)
    de = 1 if t_sym > 0.016 else 0
    n_payload = 8.0 + np.maximum(
        np.ceil((8.0 * pl - 4.0 * sf + 28.0 + 16.0)
                / (4.0 * (sf - 2.0 * de))) * (cr + 4.0), 0.0)
    return (float(preamble_syms) + 4.25 + n_payload) * t_sym


# --------------------------------------------------------------------------
# XLA's CPU summation orders of the ARQ budget gate (ROADMAP C18)
# --------------------------------------------------------------------------

XLA_SCAN_BASE = 16     # ReduceWindowRewriter's base length on the CPU
XLA_GEMV_TILE = 8      # the tiled gemv emitter's rows and columns a tile


def _prefix_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last dim, one add at a time."""
    cols = list(x.unbind(-1))
    for j in range(1, len(cols)):
        cols[j] = cols[j - 1] + cols[j]
    return torch.stack(cols, dim=-1)


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` along the last dim as XLA's CPU code sums it: up to
    16 elements in order; longer, zero-padded rows of 16 summed in order,
    their totals' prefix sums recursively, and each row's exclusive offset
    added to it."""
    n = x.shape[-1]
    if n <= XLA_SCAN_BASE:
        return _prefix_rows(x)
    rows = -(-n // XLA_SCAN_BASE)
    pad = torch.nn.functional.pad(x, (0, rows * XLA_SCAN_BASE - n))
    w = _prefix_rows(pad.reshape(x.shape[:-1] + (rows, XLA_SCAN_BASE)))
    inc = xla_cumsum(w[..., -1])
    exc = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], dim=-1)
    return (w + exc[..., None]).reshape(x.shape[:-1] + (-1,))[..., :n]


def xla_matvec(a: torch.Tensor, b: torch.Tensor,
               addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``vmap(jnp.dot)`` of the rows of ``a`` (K, F) with ``b`` (F,) as
    XLA's CPU tiled gemv emitter sums it, ``addend + dot`` when XLA fuses
    the add into it: an 8-lane accumulator over the first ``F // 8 * 8``
    columns, the tail columns in order from 0, the lanes summed by a
    pairwise tree, then the tail. The rows of whole 8-row tiles reduce
    ``((v0+v1)+(v2+v3))+((v4+v5)+(v6+v7))`` and take the addend before the
    tail, ``(addend + h) + s``; the rows after them reduce
    ``((v0+v4)+(v2+v6))+((v1+v5)+(v3+v7))`` and take it last, ``addend +
    (h + s)``."""
    k, f = a.shape
    p = a * b
    f8 = f // XLA_GEMV_TILE * XLA_GEMV_TILE
    v = torch.zeros((k, XLA_GEMV_TILE), dtype=p.dtype, device=p.device)
    for j in range(0, f8, XLA_GEMV_TILE):
        v = v + p[:, j:j + XLA_GEMV_TILE]
    s = torch.zeros((k,), dtype=p.dtype, device=p.device)
    for j in range(f8, f):
        s = s + p[:, j]
    c = v.unbind(1)
    tiled = ((c[0] + c[1]) + (c[2] + c[3])) + ((c[4] + c[5]) + (c[6] + c[7]))
    rest = ((c[0] + c[4]) + (c[2] + c[6])) + ((c[1] + c[5]) + (c[3] + c[7]))
    if addend is None:
        tiled, rest = tiled + s, rest + s
    else:
        tiled, rest = (addend + tiled) + s, addend + (rest + s)
    rows = torch.arange(k, device=p.device) < k // XLA_GEMV_TILE * XLA_GEMV_TILE
    return torch.where(rows, tiled, rest)


def sequential_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each row of ``a`` (K, F) dotted with ``b`` (F,), summed in frame
    order (XLA's constant folding of a dot)."""
    acc = torch.zeros((a.shape[0],), dtype=a.dtype, device=a.device)
    for j in range(a.shape[1]):
        acc = acc + a[:, j] * b[j]
    return acc


def sum_nodes(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum`` of a (K,) f32 vector as XLA's CPU code sums it at the
    node counts the port runs: in order."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


# --------------------------------------------------------------------------
# The transport (transport.py:385-786)
# --------------------------------------------------------------------------

class LeafFraming(NamedTuple):
    """Static framing of one node's leaf: host integer arithmetic."""
    nbytes: int                  # payload bytes (measured from the buffers)
    n_frames: int
    frame_bytes: np.ndarray      # (F,) on-air bytes incl. header
    record_frame: np.ndarray     # flat record index -> frame index
    record_shape: Tuple[int, ...]


class TransportMetrics(NamedTuple):
    """Per-node accounting: (K,) f32 tensors, or f32 scalars (Python
    floats) where every node's value is the same static number."""
    offered: object
    delivered: object
    airtime_s: object
    energy_j: object
    retransmits: object = 0.0
    abandoned: object = 0.0

    @staticmethod
    def zero() -> "TransportMetrics":
        return TransportMetrics(0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _record_layout(payload, i: int):
    """Stage-0 record shape and scatter mode of leaf ``i``
    (``transport.py:421-440``): ``"scatter"`` records go through the
    sparsifier's decode, ``"dense"`` ones are the leaf's elements."""
    spec = payload.specs[i]
    if spec.passthrough:
        return tuple(spec.shape), "dense"
    stage0 = payload.leaf_stages(i)[0]
    meta0 = spec.metas[0]
    if stage0.kind == "sparsify" and meta0.mode != "dense":
        if meta0.mode in ("block", "pallas"):
            return (meta0.nb, meta0.k), "scatter"
        return (meta0.k,), "scatter"
    return tuple(meta0.shape), "dense"


class FramePlan(NamedTuple):
    """A payload layout's framing: each leaf's :class:`LeafFraming` and
    record mode, and the device tensors the masks are gathered with."""
    framings: Tuple[LeafFraming, ...]
    modes: Tuple[str, ...]
    record_frame: Tuple[torch.Tensor, ...]   # int64 (records,) a leaf
    frame_bytes: torch.Tensor                # f32 (F_total,)
    frame_toa: torch.Tensor                  # f32 (F_total,)

    @property
    def frames(self) -> List[int]:
        return [fr.n_frames for fr in self.framings]


class LossyTransport:
    """Frame-level erasure between ``encode()`` and ``mix(decode())``.

    ``model`` overrides the config's loss model (the fault harness injects
    fixed masks, bursts, dead nodes); ``link_probs`` overrides the
    SNR-derived per-edge outage callable the gossip layer takes;
    ``num_nodes`` sizes the SNR draws and the node axis."""

    def __init__(self, cfg, num_nodes: int = 0,
                 model: Optional[LossModel] = None,
                 link_probs: Optional[Callable] = None):
        self.cfg = cfg
        self.num_nodes = int(num_nodes)
        self.model = model if model is not None else model_from_config(cfg)
        self._link_probs = link_probs
        self._framings = {}
        self._plans = {}
        self._first = {}

    # -- static layout -----------------------------------------------------
    @property
    def lossy(self) -> bool:
        """Frame masking active: loss draws, or an ARQ airtime budget that
        can abandon frames over a lossless channel."""
        return self.model.lossy or (self.arq and self.budgeted)

    @property
    def arq(self) -> bool:
        return bool(getattr(self.cfg, "arq", False))

    @property
    def max_attempts(self) -> int:
        if not self.arq:
            return 1
        return 1 + max(0, int(getattr(self.cfg, "max_retries", 0)))

    @property
    def airtime_budget_s(self) -> float:
        period = float(getattr(self.cfg, "round_period_s", 0.0))
        if period <= 0.0:
            return float("inf")
        return float(getattr(self.cfg, "duty_cycle", 1.0)) * period

    @property
    def budgeted(self) -> bool:
        return bool(np.isfinite(self.airtime_budget_s))

    @property
    def toa(self) -> bool:
        return bool(getattr(self.cfg, "toa", False))

    @property
    def error_feedback(self) -> bool:
        return bool(self.cfg.error_feedback)

    @property
    def has_link_outage(self) -> bool:
        return self._link_probs is not None or self.cfg.snr_db is not None

    def leaf_framing(self, nbytes: int, record_shape: Tuple[int, ...]
                     ) -> LeafFraming:
        """One leaf's static layout: ``nbytes`` spread uniformly over the
        records, MTU-fragmented; record ``r`` rides in the frame holding its
        first byte ``r·B // E``."""
        key = (int(nbytes), tuple(record_shape))
        if key not in self._framings:
            sizes = frame_sizes(nbytes, self.cfg.mtu)
            cap = self.cfg.mtu - HEADER_BYTES
            e = max(1, int(np.prod(record_shape)))
            start = np.arange(e, dtype=np.int64) * int(nbytes) // e
            self._framings[key] = LeafFraming(
                nbytes=int(nbytes), n_frames=int(sizes.shape[0]),
                frame_bytes=sizes, record_frame=(start // cap),
                record_shape=tuple(record_shape))
        return self._framings[key]

    # -- airtime / energy ----------------------------------------------------
    def airtime_s(self, on_air_bytes: float) -> float:
        return float(on_air_bytes) * 8.0 / float(self.cfg.phy_rate_bps)

    def frame_toa_s(self, frame_bytes) -> np.ndarray:
        """Per-frame on-air seconds: LoRa ToA under ``cfg.toa``, else the
        flat phy-rate division (float64)."""
        fb = np.asarray(frame_bytes, np.float64)
        if self.toa:
            return lora_toa_s(fb, sf=self.cfg.sf, bw_hz=self.cfg.bw_hz,
                              coding_rate=self.cfg.coding_rate,
                              preamble_syms=self.cfg.preamble_syms)
        return fb * 8.0 / float(self.cfg.phy_rate_bps)

    def _frames_airtime_s(self, sizes: np.ndarray, offered: float) -> float:
        if self.toa:
            return float(np.sum(self.frame_toa_s(sizes)))
        return self.airtime_s(offered)

    def account_dense(self, nbytes: int) -> TransportMetrics:
        """Static accounting of a dense exchange (the dsgld baseline):
        frames offered and their airtime, nothing erased."""
        sizes = frame_sizes(nbytes, self.cfg.mtu)
        offered = float(sizes.sum())
        air = self._frames_airtime_s(sizes, offered)
        return TransportMetrics(
            offered=_f32(offered), delivered=_f32(offered),
            airtime_s=_f32(air),
            energy_j=_f32(air * float(self.cfg.tx_power_w)),
            retransmits=0.0, abandoned=0.0)

    def plan(self, payload, device=None) -> FramePlan:
        """The framing of ``payload``'s layout (one node's bytes a leaf),
        its tensors on ``device`` (the payload's by default), cached by
        layout."""
        k = payload.entries[0].wire.shape[0] if payload.entries else 1
        per_node = [b // k for b in payload.per_leaf_bytes()]
        layouts = [_record_layout(payload, i) for i in range(len(per_node))]
        if device is None:
            device = (payload.entries[0].wire.device if payload.entries
                      else "cpu")
        key = (tuple(per_node), tuple(layouts), str(torch.device(device)))
        if key not in self._plans:
            framings = tuple(self.leaf_framing(b, shape)
                             for b, (shape, _) in zip(per_node, layouts))
            fb = np.concatenate([fr.frame_bytes for fr in framings]) \
                if framings else np.zeros(0)
            toa = np.concatenate([self.frame_toa_s(fr.frame_bytes)
                                  for fr in framings]) \
                if framings else np.zeros(0)
            self._plans[key] = FramePlan(
                framings=framings, modes=tuple(m for _, m in layouts),
                record_frame=tuple(torch.as_tensor(
                    fr.record_frame, device=device) for fr in framings),
                frame_bytes=torch.as_tensor(fb.astype(np.float32),
                                            device=device),
                frame_toa=torch.as_tensor(toa.astype(np.float32),
                                          device=device))
        return self._plans[key]

    # -- the draws ------------------------------------------------------------
    @random.program
    def frame_keeps(self, kround: torch.Tensor, frames: Sequence[int],
                    num_nodes: int):
        """``[(K, A, F_i)]`` keep masks of the round keyed ``kround``, whose
        codec key is ``kql = split(kround)[0]`` (CD-BFL's and CF-FL's):
        ``kloss = fold_in(kql, TRANSPORT_SALT)`` (one level, a hash and a
        fold), node keys
        ``split(kloss, K)``, then every leaf's key of every attempt
        (``split(node, n_leaves)``, and ``fold_in`` by the attempt after
        the first) in one level, then the model's draws."""
        kloss, = yield [random.Draw(kround.reshape(1, 2), 1, random.PAIR,
                                    fold=TRANSPORT_SALT)]
        nodes = yield from random.split.program(kloss.reshape(2), num_nodes)
        nl = len(frames)
        per_attempt = [random.split.program(nodes, nl)] + [
            random.split_fold_in.program(nodes, nl, a)
            for a in range(1, self.max_attempts)]
        got = yield from random.together(*per_attempt)
        keys = torch.stack(got, dim=1)                     # (K, A, nl, 2)
        return (yield from self.model.keep.program(keys, frames))

    def layout(self, compressor, params) -> FramePlan:
        """The framing of the payload ``compressor`` makes of the
        node-stacked ``params``: its buffers measured on shape-only
        tensors, so a round's draws know their frame counts before the
        encode."""
        specs = tree_map(lambda x: torch.empty(
            (1,) + tuple(x.shape[1:]), dtype=x.dtype, device="meta"), params)
        draws = {}
        for site, (_, _, shape, keyed) in compressor.draw_sites(specs).items():
            u = torch.empty(shape, device="meta")
            draws[site] = (torch.empty((shape[0], 2), dtype=torch.int64,
                                       device="meta"), u) if keyed else u
        return self.plan(compressor.encode(specs, draws),
                         tree_leaves(params)[0].device)

    # -- the in-round erasure path ---------------------------------------------
    def _dense_keep(self, payload, plan: FramePlan, keep_f):
        """Each leaf's (K, F) frame mask gathered to its records and, for a
        scatter leaf, decoded by its stage 0 (one decode call a stage)."""
        k = keep_f[0].shape[0] if keep_f else 0
        recs = [m[:, idx].reshape((k,) + fr.record_shape)
                for m, idx, fr in zip(keep_f, plan.record_frame,
                                      plan.framings)]
        out = list(recs)
        groups = {}
        for i, mode in enumerate(plan.modes):
            if mode == "scatter":
                groups.setdefault(payload.leaf_stages(i)[0], []).append(i)
            else:
                out[i] = recs[i].reshape((k,) + tuple(payload.specs[i].shape))
        for stage, idx in groups.items():
            decoded = stage.decode_leaves([
                (recs[i], payload.entries[i].aux[0],
                 payload.specs[i].metas[0]) for i in idx])
            for i, d in zip(idx, decoded):
                out[i] = d
        return tree_unflatten(list(payload.paths), out)

    def keep_masks(self, payload, keeps):
        """Single shot: ``(dense_keep, delivered (K,), offered)``, bytes
        with headers (``transport.py:577-610``)."""
        plan = self.plan(payload)
        keep_f = [m[:, 0] for m in keeps]
        delivered = None
        for m, fb in zip(keep_f, plan.frame_bytes.split(plan.frames)):
            d = (m * fb).sum(-1)              # integers below 2**24: exact
            delivered = d if delivered is None else delivered + d
        offered = float(sum(float(fr.frame_bytes.sum())
                            for fr in plan.framings))
        return self._dense_keep(payload, plan, keep_f), delivered, offered

    def arq_masks(self, payload, keeps):
        """Selective-repeat ARQ over the concatenated frames of all leaves
        (``transport.py:613-690``): attempt 0 sends every frame, attempt
        ``a`` the frames still missing, each gated by the airtime budget in
        frame order; returns ``(dense_keep, TransportMetrics)``."""
        plan = self.plan(payload)
        attempts = self.max_attempts
        backoff = float(getattr(self.cfg, "arq_backoff_s", 0.0))
        keep_a = torch.cat(keeps, dim=2)                   # (K, A, F_total)
        k = keep_a.shape[0]
        fbytes, ftoa = plan.frame_bytes, plan.frame_toa
        budget = _f32(self.airtime_budget_s)
        tx0, cost0 = self._first_attempt(plan)
        used = airtime = torch.full((k,), cost0, device=fbytes.device)
        offered = (tx0 * fbytes).sum(-1).expand(k)
        retrans = torch.zeros((k,), device=fbytes.device)
        got = tx0 * keep_a[:, 0]
        # while every mask so far is a constant (a fixture's), XLA folds
        # the attempt: its cost an f32 sum in frame order
        folded = self.model.constant(0)
        for a in range(1, attempts):
            want = 1.0 - got
            if backoff > 0.0:
                pending = (want.sum(-1) > 0).float()
                used = used + _f32(backoff * 2.0 ** (a - 1)) * pending
            if self.budgeted:
                cum = used[:, None] + xla_cumsum(want * ftoa)
                tx = want * (cum <= budget).float()
            else:
                tx = want
            if folded:
                cost = sequential_rows(tx, ftoa)
                used, airtime = used + cost, airtime + cost
            else:
                # XLA fuses `used + dot(tx, ftoa)` into the dot; the
                # airtime's add too when it equals `used` (no backoff)
                used = xla_matvec(tx, ftoa, used)
                airtime = (used if backoff <= 0.0 else
                           airtime + xla_matvec(tx, ftoa))
            folded = folded and self.model.constant(a)
            offered = offered + (tx * fbytes).sum(-1)
            retrans = retrans + tx.sum(-1)
            got = torch.maximum(got, tx * keep_a[:, a])
        keep_f = list(got.split(plan.frames, dim=1))
        metrics = TransportMetrics(
            offered=offered, delivered=(got * fbytes).sum(-1),
            airtime_s=airtime,
            energy_j=airtime * _f32(self.cfg.tx_power_w),
            retransmits=retrans,
            abandoned=((1.0 - got) * fbytes).sum(-1))
        return self._dense_keep(payload, plan, keep_f), metrics

    def _first_attempt(self, plan: FramePlan):
        """Attempt 0 sends the same frames on every node, those whose
        cumulative airtime fits the budget: XLA folds them and their cost
        to constants (the cost an f32 sum in frame order). Made on the
        host once a plan: ``(tx0 on the device, cost0)``."""
        key = id(plan)
        if key not in self._first:
            toa = plan.frame_toa.cpu()
            tx0 = (xla_cumsum(toa[None]) <= _f32(self.airtime_budget_s)
                   ).float()[0]
            cost0 = float(sequential_rows(tx0[None], toa)[0])
            self._first[key] = (plan, tx0.to(plan.frame_toa.device), cost0)
        return self._first[key][1:]

    def deliver(self, pipeline, payload, keeps=None):
        """Decode and erase for every node: ``(delta_full, delta_delivered,
        TransportMetrics)``; ``keeps`` is :meth:`frame_keeps`'s output
        (unused when the transport is lossless)."""
        delta_full = pipeline.decode(payload)
        k = payload.entries[0].wire.shape[0]
        if not self.lossy:
            return delta_full, delta_full, self._static_metrics(payload, k)
        if self.arq:
            keep, m = self.arq_masks(payload, keeps)
        else:
            keep, delivered, offered = self.keep_masks(payload, keeps)
            off = torch.full_like(delivered, _f32(offered))
            if self.toa:
                air = _f32(self._payload_airtime_s(payload, k))
                energy = _f32(air * float(self.cfg.tx_power_w))
            else:
                air = _f32(_f32(self.airtime_s(1.0)) * _f32(offered))
                energy = _f32(air * _f32(self.cfg.tx_power_w))
            m = TransportMetrics(
                offered=off, delivered=delivered,
                airtime_s=torch.full_like(delivered, air),
                energy_j=torch.full_like(delivered, energy),
                retransmits=torch.zeros_like(delivered),
                abandoned=torch.zeros_like(delivered))
        delta_del = tree_map(lambda x, w: (x.float() * w).to(x.dtype),
                             delta_full, keep)
        return delta_full, delta_del, m

    def _payload_airtime_s(self, payload, k: int) -> float:
        air = 0.0
        for nbytes in payload.per_leaf_bytes():
            sizes = frame_sizes(nbytes // k, self.cfg.mtu)
            air += self._frames_airtime_s(sizes, float(sizes.sum()))
        return air

    def _static_metrics(self, payload, k: int) -> TransportMetrics:
        """The lossless transport's accounting (``transport.py:731-744``),
        the same for every node."""
        offered = 0.0
        for nbytes in payload.per_leaf_bytes():
            offered += float(frame_sizes(nbytes // k, self.cfg.mtu).sum())
        air = (self._payload_airtime_s(payload, k) if self.toa
               else self.airtime_s(offered))
        return TransportMetrics(
            offered=_f32(offered), delivered=_f32(offered),
            airtime_s=_f32(air),
            energy_j=_f32(air * float(self.cfg.tx_power_w)),
            retransmits=0.0, abandoned=0.0)

    # -- SNR-parameterized link outage (the gossip dropout seam) ------------
    def snr_per_node(self) -> np.ndarray:
        """Per-node mean link SNR in dB: ``snr_db`` plus seed-deterministic
        lognormal shadowing of ``snr_spread_db``."""
        rng = np.random.default_rng(int(self.cfg.seed) + 0x5EED)
        base = float(self.cfg.snr_db if self.cfg.snr_db is not None else 0.0)
        return base + float(self.cfg.snr_spread_db) * rng.standard_normal(
            self.num_nodes)

    def outage_probs(self, schedule) -> np.ndarray:
        """The (M, K) Rayleigh outage matrix of the schedule's edges:
        ``1 - exp(-γ_th/γ̄)`` at the weaker endpoint's mean SNR, 0 on fixed
        points; symmetric per edge."""
        if self._link_probs is not None:
            return np.asarray(self._link_probs(schedule), np.float64)
        snr_db = self.snr_per_node()
        if schedule.k != self.num_nodes:
            raise ValueError(f"schedule over {schedule.k} nodes but the "
                             f"transport was built for {self.num_nodes}")
        gamma = 10.0 ** (snr_db / 10.0)
        gamma_th = 10.0 ** (float(self.cfg.snr_threshold_db) / 10.0)
        edge_gamma = np.minimum(gamma[None, :], gamma[schedule.perms])
        p = 1.0 - np.exp(-gamma_th / np.maximum(edge_gamma, 1e-12))
        p[schedule.perms == np.arange(schedule.k)[None, :]] = 0.0
        return p


def resolve_transport(fed_cfg, transport: Optional[LossyTransport] = None
                      ) -> Optional[LossyTransport]:
    """An explicit override, or one built from ``fed_cfg.transport`` (None:
    ideal links)."""
    if transport is not None:
        return transport
    tcfg = getattr(fed_cfg, "transport", None)
    if tcfg is None:
        return None
    return LossyTransport(tcfg, num_nodes=fed_cfg.num_nodes)
