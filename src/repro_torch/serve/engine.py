"""Uncertainty-aware serving over a resident posterior bank
(``repro/serve/engine.py``).

Three invariants, as in the reference:

* **A fixed-shape slot table, no recapture.** Requests are admitted into
  and retired from the rows of a ``(slots, *input_shape)`` table, each
  admit a row ``copy_``; on the card the predict path is one CUDA graph
  captured at that shape, so after the warm-up ``compile_count()`` (graph
  captures) does not move at any occupancy.
* **A resident bank, hot-swapped in place.** :meth:`ClassifyEngine.
  install_bank` copies a bank of the same layout into the buffers the
  captured graph reads: no recapture, no allocation, so the device's bytes
  stay flat over any number of swaps. Requests in flight finish on the new
  bank; completed responses are untouched.
* **Entropy-gated selective prediction.** Every response carries the BMA
  probabilities and their predictive entropy, and ``abstain=True`` above
  ``ServeConfig.entropy_threshold``: the eval accumulators' rule
  (:func:`repro_torch.eval.engine.abstain_mask`).

With ``slots`` equal to an eval engine's batch size, the BMA probabilities
equal that engine's bit for bit on the same device (the same forward at
the same shape; on the card, given that cuDNN picks one algorithm a shape,
as it does with ``torch.backends.cudnn.benchmark`` off). The
autoregressive ``DecodeEngine`` is ROADMAP A12.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ServeConfig
from repro_torch.core.posterior import BankPredictor
from repro_torch.eval.engine import abstain_mask


def live_device_bytes() -> int:
    """Bytes held by live tensors on the current card
    (``torch.cuda.memory_allocated``); 0 without a card. N hot swaps must
    leave it flat."""
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_allocated())


@dataclasses.dataclass
class ServeRequest:
    """One request. A classify engine reads ``x`` (one example, no batch
    axis); the decode fields are ROADMAP A12's."""
    x: Any = None
    prompt_token: int = 0
    max_new_tokens: int = 0
    seed: int = 0


@dataclasses.dataclass
class ServeResponse:
    """A prediction, its uncertainty and the abstain gate."""
    request_id: int
    probs: np.ndarray              # (C,) BMA predictive distribution
    entropy: float                 # nats
    abstain: bool                  # entropy gate: route to a human
    bank_version: int              # the bank that answered
    latency_s: float
    tokens: Optional[np.ndarray] = None          # decode (A12)
    token_entropy: Optional[np.ndarray] = None   # decode (A12)


class ServingEngine:
    """Queue and slot-table bookkeeping. ``submit`` enqueues; each ``step``
    admits queued requests into free slots, runs the predict path over the
    whole table and retires the occupied slots into responses; ``drain``
    steps until idle; ``run`` submits all, then drains."""

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        self.queue: Deque[Tuple[int, ServeRequest]] = deque()
        self.slot_req: List[Optional[int]] = [None] * cfg.slots
        self.bank_version = 0
        self.steps = 0
        self._next_id = 0
        self._submit_t: Dict[int, float] = {}
        self._latencies: List[float] = []
        self._served = 0
        self._abstained = 0

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: ServeRequest) -> int:
        rid = self._next_id
        self._next_id += 1
        self._submit_t[rid] = time.perf_counter()
        self.queue.append((rid, req))
        return rid

    def pending(self) -> int:
        return len(self.queue) + sum(r is not None for r in self.slot_req)

    def step(self) -> List[ServeResponse]:
        raise NotImplementedError

    def drain(self) -> List[ServeResponse]:
        out: List[ServeResponse] = []
        while self.pending():
            out.extend(self.step())
        return out

    def run(self, requests) -> List[ServeResponse]:
        for r in requests:
            self.submit(r)
        return sorted(self.drain(), key=lambda r: r.request_id)

    def _respond(self, rid: int, probs: np.ndarray, entropy: float,
                 **kw) -> ServeResponse:
        abstain = bool(abstain_mask(np.float32(entropy),
                                    self.cfg.entropy_threshold))
        lat = time.perf_counter() - self._submit_t.pop(rid)
        self._latencies.append(lat)
        self._served += 1
        self._abstained += int(abstain)
        return ServeResponse(request_id=rid, probs=probs,
                             entropy=float(entropy), abstain=abstain,
                             bank_version=self.bank_version, latency_s=lat,
                             **kw)

    # -- accounting ----------------------------------------------------------
    def compile_count(self) -> int:
        raise NotImplementedError

    def stats(self) -> Dict[str, float]:
        lat = np.asarray(self._latencies, np.float64)
        return {
            "served": float(self._served),
            "abstained": float(self._abstained),
            "abstain_rate": (self._abstained / self._served
                             if self._served else 0.0),
            "steps": float(self.steps),
            "p50_ms": float(np.percentile(lat, 50) * 1e3) if lat.size else 0.0,
            "p99_ms": float(np.percentile(lat, 99) * 1e3) if lat.size else 0.0,
        }


class ClassifyEngine(ServingEngine):
    """Serving for single-step classifier requests.

    ``logits_fn(params, x)`` is the eval engines' contract (the model's
    ``logits``). The slot table ``(slots, *input_shape)`` lives on the
    bank's device; an admit writes its row in place, and each step copies
    the table into the input of the :class:`BankPredictor`'s predict graph
    (on the card) and replays it. ``compile_count()`` is the predictor's
    graph captures: one a table shape on the card, 0 on the CPU. Sharding
    the sample axis over a mesh (``ServeConfig.ensemble_axis``) is ROADMAP
    A10.
    """

    def __init__(self, logits_fn: Callable, cfg: ServeConfig,
                 input_shape: Tuple[int, ...], stacked: Any = None,
                 node_axis: Optional[int] = None, mesh=None,
                 input_dtype=torch.float32):
        super().__init__(cfg)
        self.predictor = BankPredictor(logits_fn, stacked=stacked,
                                       node_axis=node_axis, mesh=mesh,
                                       ensemble_axis=cfg.ensemble_axis)
        if stacked is not None:
            self.bank_version = 1
        self.input_shape = tuple(input_shape)
        self.input_dtype = input_dtype
        self._xs: Optional[torch.Tensor] = None   # made on the bank's device

    def install_bank(self, stacked, weights=None) -> None:
        """Hot swap between steps (:meth:`BankPredictor.install`)."""
        self.predictor.install(stacked, weights=weights)
        self.bank_version += 1

    def num_samples(self) -> int:
        return self.predictor.num_samples()

    @torch.no_grad()
    def step(self) -> List[ServeResponse]:
        if self._xs is None:
            if self.predictor.stacked is None:
                raise ValueError("no bank installed; call install_bank")
            self._xs = torch.zeros((self.cfg.slots,) + self.input_shape,
                                   dtype=self.input_dtype,
                                   device=self.predictor.device)
        for i in range(self.cfg.slots):
            if self.slot_req[i] is None and self.queue:
                rid, req = self.queue.popleft()
                self._xs[i].copy_(torch.as_tensor(req.x))
                self.slot_req[i] = rid
        if not any(r is not None for r in self.slot_req):
            return []
        probs, ent = self.predictor.predict({"x": self._xs})
        probs = probs.cpu().numpy()
        ent = ent.cpu().numpy()
        self.steps += 1
        done = []
        for i in range(self.cfg.slots):
            rid = self.slot_req[i]
            if rid is None:
                continue
            done.append(self._respond(rid, probs[i], float(ent[i])))
            self.slot_req[i] = None
        return done

    def compile_count(self) -> int:
        return self.predictor.compile_count()


class DecodeEngine(ServingEngine):
    """Continuous batching for autoregressive decode under BMA: ROADMAP
    A12 (it needs the LM model zoo and ``random.categorical``)."""

    def __init__(self, model, cfg: ServeConfig, stacked: Any = None,
                 mesh=None):
        raise NotImplementedError(
            "DecodeEngine is not ported yet; ROADMAP A12 (LM model zoo, "
            "decode models and random.categorical)")
