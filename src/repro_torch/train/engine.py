"""Round engines (``repro/train/engine.py``): the chunked
:class:`ScanRoundEngine` and the per-round :class:`HostRoundEngine`, its
oracle.

Both consume the reference's streams. Per round, ``key, kround =
split(key)``; the minibatch indices come from ``fold_in(kround,
DATA_STREAM_SALT)`` (:func:`round_indices`), the round's noise and QSGD
uniforms, and on a time-varying graph its mixing masks, from ``kround``
itself (``round_fn.draws``). Both derivations run side by side, one
threefry table launch a level: with the split of the engine's key, five
launches a round. The masks are formed on the device, so a captured
chunk draws and applies each round's own. Then the batches are gathered on the
device, the round runs, and its params are offered to the posterior bank.

The scan engine runs a chunk of rounds as the reference's ``jit(lax.scan)``
does: on a CUDA carry, one CUDA graph a chunk length, captured once and
replayed with a single launch, every round's launches inside it and one
device-to-host read of the chunk's metrics after it; on a CPU carry, the
same chunk function eagerly. Its posterior bank is the on-device
:class:`~repro_torch.core.posterior.DeviceSampleBank`.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.posterior import DeviceSampleBank, SampleBank
from repro_torch.data.partition import DeviceShards
from repro_torch.utils.tree import tree_leaves

LogCb = Callable[[int, float, float], None]

# the reference's salt of the round key's data stream (engine.py:50)
DATA_STREAM_SALT = 7


@random.program
def round_data_key(kround: torch.Tensor):
    """Data-sampling key for one round, derived from the round key
    (``engine.py:53-55``)."""
    return (yield from random.fold_in.program(kround, DATA_STREAM_SALT))


@random.program
def round_indices(shards: DeviceShards, kround: torch.Tensor, l: int, m: int):
    """The round's ``(K, L, M)`` minibatch indices
    (``round_data_key``, ``engine.py:53-55``)."""
    kdata = yield from round_data_key.program(kround)
    return (yield from shards.sample_indices.program(kdata, l, m))


def one_round(round_fn, shards: DeviceShards, local_steps: int,
              minibatch: int, state, key: torch.Tensor, t: torch.Tensor):
    """The engines' round ``t`` (a device int32 index, the round function's
    ``state.round``) from the engine's ``key``: ``(state, key, metrics)``
    after it; the state's round is the caller's to set."""
    key, kround = random.split(key)
    idx, draws = random.run(random.together(
        round_indices.program(shards, kround, local_steps, minibatch),
        round_fn.draws.program(kround, state.params)))
    state, metrics = round_fn(state._replace(round=t), shards.gather(idx),
                              kround, draws)
    return state, key, metrics


# the per-round scalars every engine records, (history attribute, its
# RoundMetrics field); the participation vector comes last
_SCALARS = (("last_offered_history", "offered_bytes"),
            ("last_delivered_history", "delivered_bytes"),
            ("last_airtime_history", "airtime_s"),
            ("last_energy_history", "energy_j"),
            ("last_retransmit_history", "retransmits"),
            ("last_abandoned_history", "abandoned_bytes"))
HISTORIES = ("last_wire_history",) + tuple(a for a, _ in _SCALARS) + (
    "last_participation_history",)


def _reset_histories(engine) -> None:
    for attr in HISTORIES + ("last_round_ms",):
        setattr(engine, attr, [])


class EngineCarry(NamedTuple):
    """What a chunk threads from round to round."""
    state: Any                    # FedState
    key: torch.Tensor             # the engine's PRNG stream
    bank: Any                     # DeviceBankState or None


class ChunkMetrics(NamedTuple):
    """Per-round scalars of a chunk, after its one device-to-host read
    (``repro/train/engine.py:65-80``)."""
    loss: np.ndarray              # (chunk,) mean over (K, L)
    consensus: np.ndarray         # (chunk,)
    delta_norm: np.ndarray        # (chunk,)
    wire: np.ndarray              # (chunk,) measured bytes/node/round
    # the transport's columns (0 without a transport)
    offered: np.ndarray           # (chunk,) on-air bytes/node/round offered
    delivered: np.ndarray         # (chunk,) bytes/node/round delivered
    airtime: np.ndarray           # (chunk,) TX airtime s/node/round
    energy: np.ndarray            # (chunk,) TX energy J/node/round
    retransmits: np.ndarray       # (chunk,) ARQ frame re-sends/node/round
    abandoned: np.ndarray         # (chunk,) bytes/node/round abandoned
    participation: np.ndarray     # (chunk, K) per-node participation
    #                               ((chunk,) ones without a model)


def _check_same_layout(old: DeviceShards, new: DeviceShards) -> None:
    """Swapped shards keep the captured layout (fields, shapes, dtypes)."""
    old_l = {f: (tuple(v.shape), v.dtype) for f, v in old.data.items()}
    new_l = {f: (tuple(v.shape), v.dtype) for f, v in new.data.items()}
    if old_l != new_l:
        raise ValueError(f"set_shards: data layout changed "
                         f"({old_l} -> {new_l})")


def _state_tensors(state, key: torch.Tensor) -> List[torch.Tensor]:
    return tree_leaves(state.params) + tree_leaves(state.v) + \
        tree_leaves(state.v_bar) + [state.key, key]


def _carry_tensors(carry: EngineCarry) -> List[torch.Tensor]:
    state, key, bank = carry
    out = _state_tensors(state, key)
    if bank is not None:
        out += tree_leaves(bank.slots) + [bank.count]
        out += [] if bank.scales is None else tree_leaves(bank.scales)
        out += [] if bank.rounds is None else [bank.rounds]
    return out


def _copy_into(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    if len(dst) != len(src):
        raise ValueError("the carry's layout changed")
    for d, s in zip(dst, src):
        if d is s:
            continue
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"the carry's layout changed: {tuple(d.shape)} "
                             f"{d.dtype} -> {tuple(s.shape)} {s.dtype}")
        d.copy_(s)


class _Row:
    """How a round's metrics become a row of the chunk's buffer: each
    column a tensor written by the round, or a static value read once at
    capture (the wire bytes, and a transport's static accounting)."""

    def __init__(self, metrics):
        self.static = {"wire": float(metrics.wire_bytes)}
        self.cols = ["loss", "consensus", "delta_norm"]
        for _, field in _SCALARS:
            value = getattr(metrics, field)
            if torch.is_tensor(value):
                self.cols.append(field)
            else:
                self.static[field] = float(value)
        part = metrics.participation
        self.k = part.shape[0] if torch.is_tensor(part) else 0
        if not self.k:
            self.static["participation"] = float(part)

    @staticmethod
    def values(metrics) -> torch.Tensor:
        """The round's row: the tensor columns, then the participation
        vector when there is one."""
        out = [metrics.loss.mean(), metrics.consensus_error,
               metrics.delta_norm]
        out += [getattr(metrics, f) for _, f in _SCALARS
                if torch.is_tensor(getattr(metrics, f))]
        row = torch.stack([x.float().reshape(()) for x in out])
        if torch.is_tensor(metrics.participation):
            row = torch.cat([row, metrics.participation.float()])
        return row

    def chunk_metrics(self, vals: np.ndarray) -> ChunkMetrics:
        n = vals.shape[0]
        col = {name: vals[:, j] for j, name in enumerate(self.cols)}
        get = lambda f: col[f] if f in col else np.full((n,), self.static[f])
        return ChunkMetrics(
            loss=col["loss"], consensus=col["consensus"],
            delta_norm=col["delta_norm"], wire=get("wire"),
            offered=get("offered_bytes"), delivered=get("delivered_bytes"),
            airtime=get("airtime_s"), energy=get("energy_j"),
            retransmits=get("retransmits"),
            abandoned=get("abandoned_bytes"),
            participation=(vals[:, len(self.cols):] if self.k
                           else get("participation")))


def _extend_histories(engine, ms: ChunkMetrics) -> None:
    """One entry a round: floats, and a K-list a round for the
    participation vector (``repro/train/engine.py:118-121``)."""
    engine.last_wire_history += ms.wire.tolist()
    for (attr, _), field in zip(_SCALARS, ("offered", "delivered", "airtime",
                                           "energy", "retransmits",
                                           "abandoned")):
        getattr(engine, attr).extend(getattr(ms, field).tolist())
    engine.last_participation_history.extend(
        np.asarray(ms.participation, np.float64).tolist())


class ScanRoundEngine:
    """R rounds as chunks (``repro/train/engine.py:148-248``).

    The engine keeps its own carry: copies of the params, v, v̄ and key it
    is handed, and the bank it is handed, which it writes in place (the
    reference donates it). On a CUDA carry each chunk length is captured
    once as a CUDA graph that reads that carry, the shards' data and a
    device round index ``t0``; a replay runs the chunk's rounds back to
    back (round ``i`` feeds round ``i + 1`` through the graph's private
    pool, and sees ``t0 + i`` as its ``state.round``), writes each round's
    metrics row (mean loss, consensus error, delta norm, the transport's
    per-round columns and the participation vector) into a static ``(n,
    W)`` buffer, and last copies the final params, v, v̄ and key back into
    the carry. A CPU carry runs the same chunk function eagerly. A CUDA
    chunk never runs eagerly: a failed capture or replay raises.

    Round ``i``'s wire bytes are a function of the buffers' shapes, read
    once at capture, so the graph's value stands for every round of it; so
    are a lossless transport's static byte and airtime columns.
    """

    name = "scan"

    def __init__(self, round_fn, shards: DeviceShards, local_steps: int,
                 minibatch: int, bank: Optional[DeviceSampleBank] = None,
                 default_chunk: int = 64):
        self.round_fn = round_fn
        self.shards = shards
        self.local_steps = int(local_steps)
        self.minibatch = int(minibatch)
        self.bank = bank
        self.default_chunk = int(default_chunk)
        self._carry: Optional[EngineCarry] = None
        self._t0: Optional[torch.Tensor] = None
        self._stream = None
        # chunk length -> (graph, its metrics buffer, its row layout)
        self._graphs: Dict[int, tuple] = {}
        self.capture_ms: Dict[int, float] = {}  # host ms of each capture
        _reset_histories(self)

    def set_shards(self, shards: DeviceShards) -> None:
        """Swap the training data between chunks: copied into the tensors
        the captured graphs read, so the layout must match."""
        _check_same_layout(self.shards, shards)
        for f, v in self.shards.data.items():
            v.copy_(shards.data[f])
        self.shards.size_tensor.copy_(shards.size_tensor)
        self.shards = DeviceShards(data=self.shards.data, sizes=shards.sizes,
                                   size_tensor=self.shards.size_tensor)

    # -- one chunk -----------------------------------------------------------
    def _chunk(self, carry: EngineCarry, t0: torch.Tensor, n: int):
        """``n`` rounds from ``carry``, round ``i`` numbered ``t0 + i`` (a
        device int32); returns the ``(n, W)`` metrics rows and their
        :class:`_Row` layout, and last copies the final params, v, v̄ and
        key to ``carry``'s own tensors."""
        state, key, bank = carry
        rows, layout = [], None
        for i in range(n):
            state, key, metrics = one_round(self.round_fn, self.shards,
                                            self.local_steps, self.minibatch,
                                            state, key, t0 + i)
            if bank is not None:
                self.bank.update(bank, t0 + i, state.params)
            rows.append(_Row.values(metrics))
            layout = _Row(metrics)
        _copy_into(_state_tensors(carry.state, carry.key),
                   _state_tensors(state, key))
        return torch.stack(rows), layout

    def graph(self, n: int):
        """The chunk of length ``n`` as a CUDA graph over the carry, captured
        on first use. Before the first capture one round runs on clones of
        the carry on the capture stream, and is thrown away."""
        if n in self._graphs:
            return self._graphs[n]
        carry = self._carry
        dev = carry.key.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            scratch = EngineCarry(
                _clone_state(carry.state), carry.key.clone(),
                None if carry.bank is None else
                type(carry.bank)(*map(_clone, carry.bank)))
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._stream):
                self._chunk(scratch, self._t0.clone(), 1)
            torch.cuda.current_stream(dev).wait_stream(self._stream)
            del scratch
        graph = torch.cuda.CUDAGraph()
        start = time.perf_counter()
        with torch.cuda.graph(graph, stream=self._stream):
            out, layout = self._chunk(carry, self._t0, n)
        self.capture_ms[n] = 1e3 * (time.perf_counter() - start)
        self._graphs[n] = (graph, out, layout)
        return self._graphs[n]

    def run_chunk(self, t0: int, n: int) -> ChunkMetrics:
        """Rounds ``t0 .. t0 + n - 1`` on the engine's carry."""
        self._t0.fill_(t0)
        if self._carry.key.device.type == "cuda":
            graph, out, layout = self.graph(n)
            graph.replay()
        else:
            out, layout = self._chunk(self._carry, self._t0, n)
        vals = out.cpu().double().numpy()      # the chunk's one read
        return layout.chunk_metrics(vals)

    def _adopt(self, state, key, bank) -> None:
        """Bring ``(state, key, bank)`` into the engine's carry: copies of
        the state and key (the caller's tensors are never written), the
        bank itself on first use."""
        if self._carry is None:
            self._carry = EngineCarry(_clone_state(state), key.clone(), bank)
            self._t0 = torch.zeros((), dtype=torch.int32, device=key.device)
            return
        if (bank is None) != (self._carry.bank is None):
            raise ValueError("the carry's layout changed: a bank came or went")
        _copy_into(_carry_tensors(self._carry),
                   _carry_tensors(EngineCarry(state, key, bank)))

    def run(self, state, key: torch.Tensor, bank_state, rounds: int,
            t0: int = 0, log_every: int = 0, log_cb: Optional[LogCb] = None):
        """``rounds`` rounds from global round index ``t0``. Chunks align
        with ``log_every``; without logging they are ``default_chunk``
        rounds long. Returns ``(state, key, bank_state, losses,
        consensus)``: the state and key are copies of the carry, the bank
        the engine's own (written in place); the per-round columns land in
        the ``last_*_history`` lists."""
        self._adopt(state, key, bank_state)
        chunk = log_every if log_every > 0 else min(rounds, self.default_chunk)
        losses: List[float] = []
        cons: List[float] = []
        _reset_histories(self)
        done = 0
        while done < rounds:
            n = min(chunk, rounds - done)
            start = time.perf_counter()
            ms = self.run_chunk(t0 + done, n)
            self.last_round_ms += [1e3 * (time.perf_counter() - start) / n] * n
            losses += ms.loss.tolist()
            cons += ms.consensus.tolist()
            _extend_histories(self, ms)
            done += n
            # the host loop's cadence: only exact multiples of log_every
            if log_cb is not None and log_every and done % log_every == 0:
                log_cb(t0 + done, losses[-1], cons[-1])
        out = _clone_state(self._carry.state)._replace(
            round=state.round + rounds)
        return out, self._carry.key.clone(), self._carry.bank, losses, cons


def _clone(tree):
    """A copy of every tensor of a tree of dicts (``None`` stays)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _clone_state(state):
    return state._replace(params=_clone(state.params), v=_clone(state.v),
                          v_bar=_clone(state.v_bar))


class HostRoundEngine:
    """Per-round dispatch loop, kept as the oracle: one blocking read of
    the round's metrics a round and the host :class:`SampleBank`."""

    name = "host"

    def __init__(self, round_fn, shards: DeviceShards, local_steps: int,
                 minibatch: int, bank: Optional[DeviceSampleBank] = None):
        self.round_fn = round_fn
        self.shards = shards
        self.local_steps = int(local_steps)
        self.minibatch = int(minibatch)
        self.bank = bank                  # config only: burn_in/thin/capacity
        _reset_histories(self)

    def set_shards(self, shards: DeviceShards) -> None:
        """Swap the training data; the layout must match."""
        _check_same_layout(self.shards, shards)
        self.shards = shards

    def make_bank(self) -> Optional[SampleBank]:
        if self.bank is None:
            return None
        return SampleBank(burn_in=self.bank.burn_in,
                          max_samples=self.bank.capacity, thin=self.bank.thin)

    def run(self, state, key: torch.Tensor, bank: Optional[SampleBank],
            rounds: int, t0: int = 0, log_every: int = 0,
            log_cb: Optional[LogCb] = None):
        """``rounds`` rounds from ``(state, key)``; returns ``(state, key,
        bank, losses, consensus)``. Round ``t`` sees ``t`` as a device int32
        ``state.round``, as on the scan engine."""
        losses: List[float] = []
        cons: List[float] = []
        _reset_histories(self)
        base = torch.full((), t0, dtype=torch.int32, device=key.device)
        for i in range(rounds):
            t = t0 + i
            start = time.perf_counter()
            state, key, metrics = one_round(self.round_fn, self.shards,
                                            self.local_steps, self.minibatch,
                                            state, key, base + i)
            state = state._replace(round=t + 1)
            # float() waits for the device: the round's wall time ends here
            losses.append(float(metrics.loss.mean()))
            cons.append(float(metrics.consensus_error))
            self.last_round_ms.append(1e3 * (time.perf_counter() - start))
            layout = _Row(metrics)
            _extend_histories(self, layout.chunk_metrics(
                _Row.values(metrics)[None].cpu().double().numpy()))
            if bank is not None:
                bank.maybe_add(t, state.params)
            if log_cb is not None and log_every and (i + 1) % log_every == 0:
                log_cb(t + 1, losses[-1], cons[-1])
        return state, key, bank, losses, cons


def make_engine(name: str, round_fn, shards: DeviceShards, local_steps: int,
                minibatch: int, bank: Optional[DeviceSampleBank] = None,
                chunk: int = 64):
    """``"scan"`` (the default: chunks of rounds, a CUDA graph each on the
    card) or ``"host"`` (the per-round oracle). The shard engine is ROADMAP
    A10."""
    if name == "scan":
        return ScanRoundEngine(round_fn, shards, local_steps, minibatch,
                               bank=bank, default_chunk=chunk)
    if name == "host":
        return HostRoundEngine(round_fn, shards, local_steps, minibatch,
                               bank=bank)
    if name == "shard":
        raise NotImplementedError(
            "engine='shard' is not ported yet; ROADMAP A10 (multi-GPU shard "
            "engine)")
    raise ValueError(f"unknown engine {name!r}; use 'scan' or 'host'")
