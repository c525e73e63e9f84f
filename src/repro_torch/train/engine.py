"""The host round loop (``repro/train/engine.py:HostRoundEngine``).

Per round: draw the round's inputs from the engine's ``torch.Generator``
in this order: the ``(K, L, M)`` minibatch indices, the Langevin noise
(one normal draw a leaf, in leaf order), then the QSGD uniforms (one
``torch.rand`` a leaf that the compressor's ``uniform_shapes`` names, in
leaf order; none for block-top-k alone). ``draws(t)`` replaces all three,
which is how a run is driven with the reference's own draws. Then gather
the batches on the device, call the round, and offer the new params to
the posterior bank. The scan-style chunked engine is ROADMAP A5.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch

from repro_torch.core.algorithms import langevin_noise
from repro_torch.core.posterior import SampleBank
from repro_torch.data.partition import DeviceShards
from repro_torch.utils.tree import tree_map

LogCb = Callable[[int, float, float], None]


class HostRoundEngine:
    """Per-round dispatch loop. ``draws(t) -> (idx (K, L, M), noise tree,
    uniforms {path: array})`` replaces the generator's draws when given
    (noise already scaled)."""

    def __init__(self, round_fn, compressor, shards: DeviceShards, fed_cfg,
                 minibatch: int, generator: torch.Generator,
                 draws: Optional[Callable] = None):
        self.round_fn = round_fn
        self.compressor = compressor
        self.shards = shards
        self.fed_cfg = fed_cfg
        self.minibatch = int(minibatch)
        self.generator = generator
        self.draws = draws
        self.last_wire_history: List[float] = []
        self.last_round_ms: List[float] = []

    def _round_inputs(self, t: int, params):
        dev = self.shards.device
        if self.draws is not None:
            idx, noise, uniforms = self.draws(t)
            noise = tree_map(lambda a: torch.as_tensor(a, device=dev), noise)
            uniforms = {p: torch.as_tensor(a, device=dev)
                        for p, a in uniforms.items()}
            return self.shards.gather(idx), noise, uniforms
        cfg = self.fed_cfg
        idx = self.shards.sample_indices(self.generator, cfg.local_steps,
                                         self.minibatch)
        noise = langevin_noise(self.generator, params, cfg.eta,
                               cfg.temperature)
        uniforms = {p: torch.rand(shape, generator=self.generator, device=dev)
                    for p, shape in
                    self.compressor.uniform_shapes(params).items()}
        return self.shards.gather(idx), noise, uniforms

    def run(self, state, bank: Optional[SampleBank], rounds: int, t0: int = 0,
            log_every: int = 0, log_cb: Optional[LogCb] = None):
        losses: List[float] = []
        cons: List[float] = []
        self.last_wire_history = []
        self.last_round_ms = []
        for i in range(rounds):
            t = t0 + i
            start = time.perf_counter()
            batches, noise, uniforms = self._round_inputs(t, state.params)
            state, metrics = self.round_fn(state, batches, noise, uniforms)
            # float() waits for the device: the round's wall time ends here
            losses.append(float(metrics.loss.mean()))
            cons.append(float(metrics.consensus_error))
            self.last_round_ms.append(1e3 * (time.perf_counter() - start))
            self.last_wire_history.append(float(metrics.wire_bytes))
            if bank is not None:
                bank.maybe_add(t, state.params)
            if log_cb is not None and log_every and (i + 1) % log_every == 0:
                log_cb(t + 1, losses[-1], cons[-1])
        return state, bank, losses, cons
