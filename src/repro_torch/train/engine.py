"""The host round loop (``repro/train/engine.py:HostRoundEngine``).

Per round, as the reference's host engine: ``key, kround = split(key)``;
the minibatch indices come from ``fold_in(kround, DATA_STREAM_SALT)``
(:func:`round_indices`), the round's noise and QSGD uniforms from
``kround`` itself (``round_fn.draws``). Both derivations run side by side,
one threefry table launch a level: with the split of the engine's key,
five launches a round. Then gather the batches on the device, call the
round, and offer the new params to the posterior bank. The scan-style
chunked engine is ROADMAP A5.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch

from repro_torch import random
from repro_torch.core.posterior import SampleBank
from repro_torch.data.partition import DeviceShards

LogCb = Callable[[int, float, float], None]

# the reference's salt of the round key's data stream (engine.py:50)
DATA_STREAM_SALT = 7


@random.program
def round_indices(shards: DeviceShards, kround: torch.Tensor, l: int, m: int):
    """The round's ``(K, L, M)`` minibatch indices
    (``round_data_key``, ``engine.py:53-55``)."""
    kdata = yield from random.fold_in.program(kround, DATA_STREAM_SALT)
    return (yield from shards.sample_indices.program(kdata, l, m))


class HostRoundEngine:
    """Per-round dispatch loop over the engine's key."""

    def __init__(self, round_fn, shards: DeviceShards, fed_cfg,
                 minibatch: int):
        self.round_fn = round_fn
        self.shards = shards
        self.fed_cfg = fed_cfg
        self.minibatch = int(minibatch)
        self.last_wire_history: List[float] = []
        self.last_round_ms: List[float] = []

    def run(self, state, key: torch.Tensor, bank: Optional[SampleBank],
            rounds: int, t0: int = 0, log_every: int = 0,
            log_cb: Optional[LogCb] = None):
        """``rounds`` rounds from ``(state, key)``; returns ``(state, key,
        bank, losses, consensus)``."""
        losses: List[float] = []
        cons: List[float] = []
        self.last_wire_history = []
        self.last_round_ms = []
        for i in range(rounds):
            t = t0 + i
            start = time.perf_counter()
            key, kround = random.split(key)
            idx, draws = random.run(random.together(
                round_indices.program(self.shards, kround,
                                      self.fed_cfg.local_steps,
                                      self.minibatch),
                self.round_fn.draws.program(kround, state.params)))
            state, metrics = self.round_fn(state, self.shards.gather(idx),
                                           kround, draws)
            # float() waits for the device: the round's wall time ends here
            losses.append(float(metrics.loss.mean()))
            cons.append(float(metrics.consensus_error))
            self.last_round_ms.append(1e3 * (time.perf_counter() - start))
            self.last_wire_history.append(float(metrics.wire_bytes))
            if bank is not None:
                bank.maybe_add(t, state.params)
            if log_cb is not None and log_every and (i + 1) % log_every == 0:
                log_cb(t + 1, losses[-1], cons[-1])
        return state, key, bank, losses, cons
