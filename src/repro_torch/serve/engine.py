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
autoregressive :class:`DecodeEngine` serves the dense LMs the same way: a
captured step over a fixed slot table, its bank swapped in place.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.config import ServeConfig
from repro_torch.core.posterior import BankPredictor
from repro_torch.eval.engine import abstain_mask
from repro_torch.kernels.bma_sample import bma_sample
from repro_torch.utils.graphs import capture
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_map_with_path)


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
    axis); a decode engine reads ``prompt_token``, ``max_new_tokens`` (0:
    the config's) and ``seed`` (the request's sampling stream)."""
    x: Any = None
    prompt_token: int = 0
    max_new_tokens: int = 0
    seed: int = 0


@dataclasses.dataclass
class ServeResponse:
    """A prediction, its uncertainty and the abstain gate."""
    request_id: int
    probs: np.ndarray              # (C,) BMA predictive distribution
    entropy: float                 # nats; decode: mean over its tokens
    abstain: bool                  # entropy gate: route to a human
    bank_version: int              # the bank that answered
    latency_s: float
    tokens: Optional[np.ndarray] = None          # decode: (T,) int32
    token_entropy: Optional[np.ndarray] = None   # decode: (T,) f32


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

    ``logits_fn(params, batch)`` is the eval engines' contract (the model's
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
    """Continuous batching for autoregressive decode under BMA
    (``repro/serve/engine.py:240-439``).

    State lives in fixed-shape device tables, sized at the first
    :meth:`install_bank`:

    * the KV caches, one lane a (posterior sample, slot) pair
      (``model.init_decode_state(slots, max_len, groups=M)``). An admit
      resets its slot's M lanes to the pristine init (zeros, ``slot_pos =
      -1``: the attention mask makes the lane decode as a fresh cache); a
      retire only frees the slot; a swap never touches them.
    * ``tokens (slots,)``, ``pos (slots,)``: each slot's last token and
      position, so lanes advance independently; ``keys (slots, 2)``: each
      request's ``PRNGKey(seed)``, sampled at ``fold_in(key, pos)``, so a
      request's tokens depend on its seed and position only.
    * the bank in the compute dtype, the weights stored layer-major so each
      layer's are one block: ``install_bank`` copies a bank into it in place
      (the reference casts at use; the values are the same, and a step reads
      the weights once at half the bytes in bfloat16). Norm scales stay f32,
      as the reference reads them.

    One step advances every lane: the M samples' decode steps over all
    slots (``decode_attention``, one launch a layer), then ``bma_sample``
    (one launch): the BMA mean of the tempered softmaxes, its entropy, one
    categorical draw a slot. On the card the step is one CUDA graph,
    captured at the first step (which runs eagerly on the capture stream
    as its warm-up) and replayed after; ``compile_count()`` counts captures
    and stays fixed at any occupancy, over mixed lengths and swaps. On the
    CPU the step runs eagerly (the kernels' plain versions) and nothing is
    captured. Idle lanes decode at fixed cost into their own caches and are
    reset on admit. Sharding the sample axis (``mesh``) is ROADMAP A10.
    """

    def __init__(self, model, cfg: ServeConfig, stacked: Any = None,
                 mesh=None):
        super().__init__(cfg)
        if getattr(model, "decode_step", None) is None:
            raise ValueError(f"{model.cfg.name} has no decode step")
        if cfg.max_new_tokens > cfg.max_len:
            raise ValueError("max_new_tokens exceeds the KV cache length")
        if mesh is not None or cfg.ensemble_axis:
            raise NotImplementedError(
                "DecodeEngine over a mesh is not ported yet; ROADMAP A10 "
                "(multi-GPU shard engine, place_ensemble)")
        self.model = model
        self.device = None
        self._bank = None
        self._num_samples = 0
        self._caches = self._tokens = self._pos = self._keys = None
        self._out = None            # (next, probs, entropy) of a step
        self._graph = None
        self._stream = None
        self._captures = 0
        self.capture_ms = 0.0
        self.slot_left: List[int] = [0] * cfg.slots
        self._slot_toks: Dict[int, List[int]] = {}
        self._slot_ents: Dict[int, List[float]] = {}
        if stacked is not None:
            self.install_bank(stacked)

    # -- bank lifecycle ------------------------------------------------------
    def _allocate(self, stacked) -> None:
        """The resident tables, on the bank's device, once."""
        m = tree_leaves(stacked)[0].shape[0]
        dev = tree_leaves(stacked)[0].device
        dt = self.model.dtype

        def buffer(path: str, x: torch.Tensor) -> torch.Tensor:
            want = torch.float32 if path.endswith("scale") else dt
            if path.startswith("groups."):
                # (G, L, ...) read a layer at a time: store (L, G, ...)
                buf = torch.empty((x.shape[1], x.shape[0]) + x.shape[2:],
                                  dtype=want, device=dev)
                return buf.transpose(0, 1)
            return torch.empty(x.shape, dtype=want, device=dev)

        self._bank = tree_map_with_path(buffer, stacked)
        s = self.cfg.slots
        self._caches = self.model.init_decode_state(
            s, self.cfg.max_len, groups=m, device=dev)
        self._tokens = torch.zeros((s,), dtype=torch.int64, device=dev)
        self._pos = torch.zeros((s,), dtype=torch.int64, device=dev)
        self._keys = torch.zeros((s, 2), dtype=torch.int64, device=dev)
        self._out = (torch.zeros((s,), dtype=torch.int64, device=dev),
                     torch.zeros((s, self.model.cfg.vocab_size),
                                 dtype=torch.float32, device=dev),
                     torch.zeros((s,), dtype=torch.float32, device=dev))
        self._num_samples = m
        self.device = dev

    def install_bank(self, stacked) -> None:
        """Hot swap between steps: the bank ``(M, ...)`` (f32 leaves, the
        model's tree) copied into the resident one in place. No recapture,
        no allocation, the caches untouched; the sample count M sizes the KV
        lanes, so a swap must keep it."""
        m = int(tree_leaves(stacked)[0].shape[0])
        if self._bank is not None and m != self._num_samples:
            raise ValueError(
                f"hot swap changed the sample count {self._num_samples} "
                f"-> {m}; the resident KV lanes are sized by it")
        if self._bank is None:
            self._allocate(stacked)
        mine = [(p, tuple(x.shape)) for p, x in
                tree_leaves_with_path(self._bank)]
        theirs = [(p, tuple(x.shape)) for p, x in
                  tree_leaves_with_path(stacked)]
        if mine != theirs:
            raise ValueError("hot swap changed the bank's layout")
        with torch.no_grad():
            for d, x in zip(tree_leaves(self._bank), tree_leaves(stacked)):
                d.copy_(x)
        self.bank_version += 1

    def num_samples(self) -> int:
        return self._num_samples

    # -- the step ------------------------------------------------------------
    def _decode_all(self):
        """Every lane one token: the decode steps, then the sampler. Reads
        and writes only the resident tables (a captured graph replays it)."""
        _, logits = self.model.decode_step(self._bank, self._caches,
                                           self._tokens, self._pos)
        out = bma_sample(logits[:, :, 0], self._keys, self._pos,
                         self.cfg.temperature, out=self._out)
        self._tokens.copy_(out[0])
        self._pos.add_(1)
        return out

    def _run_step(self):
        if self.device.type != "cuda":
            return self._decode_all()
        if self._graph is None:
            # capture()'s warm-up call is the first step; capturing runs
            # nothing, so the tables hold that step's results after it
            self._stream = torch.cuda.Stream(self.device)
            self._graph, _, self.capture_ms = capture(self._decode_all,
                                                      self._stream)
            self._captures += 1
        else:
            self._graph.replay()
        return self._out

    def _admit(self, i: int, tok0: int, seed: int) -> None:
        """Reset slot ``i``'s M lanes to the pristine init and its tables."""
        for path, c in tree_leaves_with_path(self._caches):
            # the slot axis: before (slots,) or (slots, KV, hd)
            rows = path.endswith("slot_pos")
            c.select(c.dim() - (2 if rows else 4), i).fill_(-1 if rows else 0)
        self._tokens[i] = int(tok0)
        self._pos[i] = 0
        self._keys[i] = random.PRNGKey(seed, self.device)

    @torch.no_grad()
    def step(self) -> List[ServeResponse]:
        if self._bank is None:
            raise ValueError("no bank installed; call install_bank(stacked)")
        for i in range(self.cfg.slots):
            if self.slot_req[i] is None and self.queue:
                rid, req = self.queue.popleft()
                self._admit(i, req.prompt_token, req.seed)
                self.slot_req[i] = rid
                self.slot_left[i] = (req.max_new_tokens
                                     or self.cfg.max_new_tokens)
                self._slot_toks[rid] = []
                self._slot_ents[rid] = []
        if not any(r is not None for r in self.slot_req):
            return []
        nxt, probs, ent = self._run_step()
        toks = nxt.cpu().numpy()
        ents = ent.cpu().numpy()
        probs_h = None                       # fetched on a retire
        self.steps += 1
        done = []
        for i in range(self.cfg.slots):
            rid = self.slot_req[i]
            if rid is None:
                continue
            self._slot_toks[rid].append(int(toks[i]))
            self._slot_ents[rid].append(float(ents[i]))
            self.slot_left[i] -= 1
            if self.slot_left[i] == 0:
                if probs_h is None:
                    probs_h = probs.cpu().numpy()
                t = np.asarray(self._slot_toks.pop(rid), np.int32)
                e = np.asarray(self._slot_ents.pop(rid), np.float32)
                done.append(self._respond(rid, probs_h[i].copy(),
                                          float(e.mean()), tokens=t,
                                          token_entropy=e))
                self.slot_req[i] = None
        return done

    def compile_count(self) -> int:
        """CUDA graph captures of the step: 1 after the first step on the
        card, 0 on the CPU."""
        return self._captures
