"""Federated training harness (``repro/train/trainer.py:FedTrainer``): the
paper's protocol run by a round engine, a posterior bank filled after
burn-in, and BMA evaluation of accuracy and ECE.

    trainer = FedTrainer(model, fed_cfg, shards)          # device="cuda"
    result = trainer.run(rounds=T, eval_batch=test)

The default ``engine="scan"`` runs chunks of rounds (a CUDA graph a chunk
on the card) with the on-device posterior bank; ``engine="host"`` is the
per-round oracle with the host bank. The card is the default device.
``device="cpu"`` runs every kernel's plain version on the CPU; a ``cuda``
device without a card raises.

The graph is ``build_topology(resolve_topology(fed_cfg), K)``: any family,
static or time-varying (``FedConfig.topology_cfg``), mixed by the lowering
the reference's ``plan_mixer`` picks (``core/gossip.py``). A
``FedConfig.transport`` sends the payloads through the lossy D2D transport
(``core/transport.py``), a ``FedConfig.participation`` makes the rounds
barrier-free; their per-round columns land in the ``TrainResult``.

Evaluation runs through the :class:`ScanEvalEngine` (a CUDA graph of the
whole eval on the card), ``run(eval_every=N)`` takes in-training
snapshots through it, and :meth:`FedTrainer.predictor` hands the
posterior to serving as a :class:`BankPredictor`.

Continual learning (DESIGN.md §15): ``continual`` (or
``FedConfig.continual``) drifts the training pool on a schedule, refreshed
between chunks at phase boundaries (``train/drift.py``), and ages the bank
(window eviction, age-discounted BMA weights in every eval and predictor).
:meth:`FedTrainer.unlearn` removes a node's chain from the posterior.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.algorithms import make_round_fn
from repro_torch.core.compression import make_compressor
from repro_torch.core.fed_state import FedState, init_fed_state
from repro_torch.core.posterior import (BankPredictor, DeviceSampleBank,
                                        SampleBank, bank_age_weights)
from repro_torch.core.topology import build_topology, resolve_topology
from repro_torch.data.partition import DeviceShards
from repro_torch.eval.engine import EvalReport, ScanEvalEngine, lm_apply_fn
from repro_torch.core.transport import resolve_transport
from repro_torch.train.drift import make_refresher
from repro_torch.train.engine import HISTORIES, make_engine
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_count, tree_leaves, tree_map


@dataclass
class TrainResult:
    accuracy: float
    ece: float
    nll: float
    brier: float
    bytes_sent_per_round: float
    total_bytes: float
    overconf_gap: float = float("nan")
    # in-training snapshots (run(eval_every=N)) and the final evaluation:
    # [{"round", "accuracy", "ece", "nll", "brier", "overconf_gap"}, ...]
    eval_history: List[Dict[str, float]] = field(default_factory=list)
    report: Optional[EvalReport] = None
    # measured from the packed WirePayload buffers, scaled by the directed
    # edge count like bytes_sent_per_round
    measured_bytes_per_round: float = 0.0
    # the transport's accounting, means a node a round (0 without one)
    offered_bytes_per_round: float = 0.0
    delivered_bytes_per_round: float = 0.0
    airtime_s_per_round: float = 0.0
    energy_j_per_round: float = 0.0
    retransmits_per_round: float = 0.0
    abandoned_bytes_per_round: float = 0.0
    # (K,) share of rounds each node took part in (None without a model)
    participation_rates: Optional[np.ndarray] = None
    wire_history: List[float] = field(default_factory=list)   # bytes/node
    offered_history: List[float] = field(default_factory=list)
    delivered_history: List[float] = field(default_factory=list)
    # per-round (K,) participation vectors (empty without a model)
    participation_history: List[Any] = field(default_factory=list)
    loss_history: List[float] = field(default_factory=list)
    consensus_history: List[float] = field(default_factory=list)
    round_ms: List[float] = field(default_factory=list)       # wall, per round
    probs: Optional[np.ndarray] = None
    labels: Optional[np.ndarray] = None
    wall_s: float = 0.0


def _snapshot(round_idx: int, rep: EvalReport) -> Dict[str, float]:
    """One entry of ``TrainResult.eval_history``."""
    return {"round": float(round_idx), "accuracy": rep.accuracy,
            "ece": rep.ece, "nll": rep.nll, "brier": rep.brier,
            "overconf_gap": rep.overconf_gap}


class _BankView:
    """``len()`` and ``.samples`` over a :class:`DeviceBankState`
    (``repro/train/trainer.py:93-107``); reads the device on access."""

    def __init__(self, cfg: DeviceSampleBank, state):
        self._cfg = cfg
        self._state = state

    def __len__(self):
        return 0 if self._state is None else self._cfg.length(self._state)

    @property
    def samples(self):
        return ([] if self._state is None
                else self._cfg.samples_list(self._state))


class FedTrainer:
    """Host-side orchestration of the decentralized protocol.

    Seeded as the reference's ``FedTrainer``: the model is initialized
    from ``PRNGKey(seed)`` and the engine's stream is ``PRNGKey(seed + 1)``
    (``repro/train/trainer.py:152-161``), so a run equals the reference's
    run of the same seed. ``params`` (one model's params, e.g. the
    reference's through ``params_from_jax``) replaces the init.
    ``transport`` (a :class:`LossyTransport`, the fault harness's way to
    inject a loss model) overrides the one ``fed_cfg.transport`` builds;
    ``fed_cfg.participation`` makes the rounds barrier-free.
    ``continual`` (a :class:`~repro_torch.config.ContinualConfig`; default
    ``fed_cfg.continual``) drifts the pool and ages the bank; ``None``
    leaves every path as it is without it.
    """

    def __init__(self, model, fed_cfg, shards: List[Dict[str, np.ndarray]],
                 minibatch: int = 10, data_scale: Optional[float] = None,
                 seed: int = 0, engine: str = "scan",
                 chunk: Optional[int] = None, bank_capacity: int = 40,
                 bank_thin: int = 2, bank_dtype: str = "float32",
                 eval_batch_size: int = 64, device="cuda",
                 params: Optional[Dict] = None, transport=None,
                 continual=None):
        fed_cfg.check_supported()
        assert len(shards) == fed_cfg.num_nodes, "one shard per node"
        self.device = resolve_device(device)
        self.model = model
        self.fed_cfg = fed_cfg
        self.minibatch = minibatch
        self.topology = build_topology(resolve_topology(fed_cfg),
                                       fed_cfg.num_nodes)
        self.omega = self.topology.omega
        self.compressor = make_compressor(fed_cfg)
        if data_scale is None:
            data_scale = float(np.mean([len(s[next(iter(s))]) for s in shards]))
        self.data_scale = data_scale

        if params is None:
            params = model.init(random.PRNGKey(seed, self.device), self.device)
        params0 = tree_map(lambda x: x.to(self.device), params)
        self.state: FedState = init_fed_state(params0, fed_cfg)
        self.transport = resolve_transport(fed_cfg, transport)
        pcfg = fed_cfg.participation
        self._participation_active = bool(pcfg is not None and pcfg.active)
        self.round_fn = make_round_fn(fed_cfg.algorithm, model.nll, fed_cfg,
                                      self.omega, self.compressor,
                                      self.data_scale, self.device,
                                      self.transport)
        self.device_shards = DeviceShards.from_shards(shards, self.device)
        self.bank_cfg = DeviceSampleBank(
            burn_in=fed_cfg.burn_in, capacity=bank_capacity, thin=bank_thin,
            store_dtype=bank_dtype)
        # the posterior bank: the Bayesian algorithms only (cffl is a point
        # learner, evaluated on its nodes' current params)
        bank_enabled = fed_cfg.algorithm in ("cdbfl", "dsgld")
        self._engine = make_engine(engine, self.round_fn, self.device_shards,
                                   fed_cfg.local_steps, minibatch,
                                   bank=self.bank_cfg if bank_enabled
                                   else None, chunk=chunk or 64)
        self.key = random.PRNGKey(seed + 1, self.device)
        if engine == "host":
            self._bank_state = self._engine.make_bank()
        else:
            self._bank_state = (self.bank_cfg.init(self.state.params)
                                if bank_enabled else None)
        self.eval_batch_size = int(eval_batch_size)
        # one scan eval engine a kind of batch: a classifier's (``y``)
        # through the logits, an LM's (tokens) through ``lm_apply_fn``
        self._eval_engines: Dict[str, ScanEvalEngine] = {}
        # continual learning: the drift schedule over the caller's pool
        # (which the engines never write) and the bank's aging
        self.continual = (continual if continual is not None
                          else fed_cfg.continual)
        self._refresher = make_refresher(self.continual, self.device_shards)
        # node ids removed by unlearn(): dropped from every posterior view
        self._unlearned: set = set()
        # the round index on the host, advanced by each engine.run: the
        # refresher and the age weights read it without touching the card
        self._round = 0

        n_edges = float(self.topology.adjacency.sum())
        self._n_edges = n_edges
        # a pipeline's measured payload of meta leaves, or the legacy
        # Compressor's closed-form table; DSGLD sends the dense θ
        per_node = self.compressor.wire_bytes(params0)
        if fed_cfg.algorithm == "dsgld":
            per_node = tree_count(params0) * 4
        self.bytes_per_round = float(per_node * n_edges)

    @property
    def bank(self):
        """The posterior bank: the host engine's :class:`SampleBank`, or a
        view with its ``len()`` and ``.samples`` of the device bank."""
        if isinstance(self._bank_state, SampleBank):
            return self._bank_state
        return _BankView(self.bank_cfg, self._bank_state)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def unlearn(self, node_id: int) -> None:
        """Remove node ``node_id``'s contribution from the posterior
        (``repro/train/trainer.py:228-270``): its chain is zeroed in every
        bank slot and dropped from every stacked view, predictor and
        evaluation (axis 1), and its control variates ``v``, ``v̄`` are
        zeroed. The influence its past gossip had on the other chains
        stays, which :func:`~repro_torch.eval.matrix.run_unlearn_oracle`
        bounds against a retrain without the node. Continued training
        re-admits the node. Idempotent.

        The device bank is written in place: the scan engine's carry holds
        that bank, so its captured chunk graphs read the erased rows and
        none is captured again."""
        k = int(node_id)
        if not 0 <= k < self.fed_cfg.num_nodes:
            raise ValueError(f"node_id {k} out of range "
                             f"[0, {self.fed_cfg.num_nodes})")
        if k in self._unlearned:
            return
        if len(self._unlearned) + 1 >= self.fed_cfg.num_nodes:
            raise ValueError("cannot unlearn every node")
        self._unlearned.add(k)
        row = torch.tensor([k], device=self.device)

        def zero_row(x):
            return x.index_fill(0, row, 0)

        self.state = self.state._replace(v=tree_map(zero_row, self.state.v),
                                         v_bar=tree_map(zero_row,
                                                        self.state.v_bar))
        bank = self._bank_state
        if isinstance(bank, SampleBank):
            bank.samples = [tree_map(zero_row, s) for s in bank.samples]
        elif bank is not None:
            for x in tree_leaves(bank.slots):
                x[:, k] = 0
            if bank.scales is not None:
                for x in tree_leaves(bank.scales):
                    if x.dim() > 1:
                        x[:, k] = 1.0

    @property
    def unlearned(self) -> frozenset:
        """Node ids removed by :meth:`unlearn`."""
        return frozenset(self._unlearned)

    def run(self, rounds: Optional[int] = None, log_every: int = 0,
            eval_batch: Optional[Dict[str, np.ndarray]] = None,
            eval_every: int = 0) -> TrainResult:
        """Train ``rounds`` rounds, then evaluate on ``eval_batch``; with
        ``eval_every=N`` the eval engine also scores the current posterior
        every N rounds, and the snapshots land in ``eval_history``."""
        rounds = rounds if rounds is not None else self.fed_cfg.rounds
        log_cb = None
        if log_every:
            log_cb = lambda t, l, c: print(
                f"  round {t:4d}  loss={l:.4f} consensus={c:.3e}")
        segment = (eval_every if eval_every and eval_batch is not None
                   else rounds)
        losses: List[float] = []
        cons: List[float] = []
        round_ms: List[float] = []
        hist: Dict[str, List[Any]] = {}
        eval_history: List[Dict[str, float]] = []
        t0 = time.time()
        done = 0
        while done < rounds:
            n = min(segment, rounds - done)
            # drift: split at the schedule's phase boundaries and refresh
            # the engine's pool once a constant-severity run
            subsegs = (list(self._refresher.segments(self._round, n))
                       if self._refresher is not None
                       else [(self._round, n)])
            for s, m in subsegs:
                if self._refresher is not None:
                    self._refresher.refresh(self._engine, s)
                (self.state, self.key, self._bank_state, seg_losses,
                 seg_cons) = self._engine.run(
                     self.state, self.key, self._bank_state, m, t0=s,
                     log_every=log_every, log_cb=log_cb)
                self._round = s + m
                losses += seg_losses
                cons += seg_cons
                round_ms += self._engine.last_round_ms
                for name in HISTORIES:
                    hist.setdefault(name, []).extend(getattr(self._engine,
                                                             name))
            done += n
            if done < rounds:
                eval_history.append(
                    _snapshot(self._round, self.eval_report(eval_batch)))
        wire = hist.get("last_wire_history", [])
        mean = lambda name: (float(np.mean(hist[name])) if hist.get(name)
                             else 0.0)
        part = hist.get("last_participation_history", [])
        res = TrainResult(
            accuracy=float("nan"), ece=float("nan"), nll=float("nan"),
            brier=float("nan"),
            bytes_sent_per_round=self.bytes_per_round,
            total_bytes=self.bytes_per_round * rounds,
            measured_bytes_per_round=(float(np.mean(wire)) * self._n_edges
                                      if wire else self.bytes_per_round),
            offered_bytes_per_round=mean("last_offered_history"),
            delivered_bytes_per_round=mean("last_delivered_history"),
            airtime_s_per_round=mean("last_airtime_history"),
            energy_j_per_round=mean("last_energy_history"),
            retransmits_per_round=mean("last_retransmit_history"),
            abandoned_bytes_per_round=mean("last_abandoned_history"),
            participation_rates=(np.mean(np.asarray(part, np.float64), axis=0)
                                 if self._participation_active and part
                                 else None),
            wire_history=wire,
            offered_history=hist.get("last_offered_history", []),
            delivered_history=hist.get("last_delivered_history", []),
            participation_history=(part if self._participation_active
                                   else []),
            loss_history=losses, consensus_history=cons,
            round_ms=round_ms, wall_s=time.time() - t0)
        if eval_batch is not None:
            res = self.evaluate(eval_batch, res)
            res.eval_history = eval_history + [
                _snapshot(self._round, res.report)]
        return res

    def _stacked_bank(self):
        """(S, K, ...) posterior samples, whichever bank holds them (the
        device bank read outside any graph, its count once); the current
        params (S = 1) while the bank is empty, and for cffl, which keeps
        none."""
        if isinstance(self._bank_state, SampleBank):
            stacked = self._bank_state.stacked()
        elif self._bank_state is None:                 # cffl: no bank
            stacked = None
        else:
            order = self.bank_cfg.order(self._bank_state)
            stacked = (self.bank_cfg.stacked(self._bank_state, order)
                       if len(order) else None)
        if stacked is None:
            stacked = tree_map(lambda x: x[None], self.state.params)
        return stacked

    def _filter_nodes(self, stacked):
        """Drop the unlearned nodes' chains (axis 1) from a stacked view."""
        if not self._unlearned:
            return stacked
        keep = torch.tensor([i for i in range(self.fed_cfg.num_nodes)
                             if i not in self._unlearned],
                            device=tree_leaves(stacked)[0].device)
        return tree_map(lambda x: x.index_select(1, keep), stacked)

    def _bank_weights(self, stacked):
        """Age-discounted BMA weights over the bank behind ``stacked``
        (float64, ``bank_age_weights``), or None: no aging configured, no
        bank, or a view that is not the bank's samples (the current params
        while it is empty)."""
        c = self.continual
        if c is None or not c.ages or self._bank_state is None:
            return None
        if isinstance(self._bank_state, SampleBank):
            rounds = self._bank_state.rounds
        else:
            rounds = self.bank_cfg.rounds_list(self._bank_state)
        if len(rounds) != int(tree_leaves(stacked)[0].shape[0]):
            return None
        return bank_age_weights(rounds, self._round, window=c.window,
                                decay=c.decay)

    def _posterior(self):
        """What every evaluation reads: the stacked view without the
        unlearned chains, and its age weights (None: the uniform mean)."""
        stacked = self._stacked_bank()
        return self._filter_nodes(stacked), self._bank_weights(stacked)

    def predictor(self) -> BankPredictor:
        """A :class:`BankPredictor` over the current posterior bank (the
        current params while it is empty; for cffl, always), node chains
        averaged, the unlearned ones left out, the bank's age weights
        installed: hand it to ``ClassifyEngine`` or call
        ``predict(batch)`` (an LM's: ``{"tokens": (B, S)}``)."""
        stacked, weights = self._posterior()
        bp = BankPredictor(self.model.logits, node_axis=1)
        bp.install(stacked, weights=weights)
        return bp

    def _apply_fn(self, batch: Dict[str, np.ndarray]):
        """The eval engine and the labels of ``batch``
        (``repro/train/trainer.py:405-408``): a classifier's batch (``y``)
        through the model's logits; an LM's token batch through
        ``lm_apply_fn``, labelled ``tokens[:, 1:]``."""
        kind = "clf" if "y" in batch else "lm"
        eng = self._eval_engines.get(kind)
        if eng is None:
            eng = ScanEvalEngine(self.model.logits if kind == "clf"
                                 else lm_apply_fn(self.model),
                                 batch_size=self.eval_batch_size)
            self._eval_engines[kind] = eng
        if kind == "clf":
            return eng, batch["y"]
        return eng, np.asarray(batch["tokens"])[:, 1:]

    def eval_report(self, batch: Dict[str, np.ndarray],
                    return_probs: bool = False):
        """BMA evaluation of the current posterior through the scan eval
        engine, the unlearned chains left out and the bank's age weights
        applied."""
        eng, labels = self._apply_fn(batch)
        data = dict(batch)
        data["y"] = np.asarray(labels)
        stacked, weights = self._posterior()
        return eng.evaluate(stacked, data, node_axis=1,
                            return_probs=return_probs, weights=weights)

    def evaluate(self, batch: Dict[str, np.ndarray],
                 res: Optional[TrainResult] = None) -> TrainResult:
        rep, probs = self.eval_report(batch, return_probs=True)
        if res is None:
            res = TrainResult(0, 0, 0, 0, self.bytes_per_round, 0)
        res.accuracy = rep.accuracy
        res.ece = rep.ece
        res.nll = rep.nll
        res.brier = rep.brier
        res.overconf_gap = rep.overconf_gap
        res.report = rep
        res.probs = probs
        res.labels = (np.asarray(batch["y"]) if "y" in batch
                      else np.asarray(batch["tokens"])[:, 1:])
        return res
