"""Evaluation engines (``repro/eval/engine.py``): streaming metric
accumulators, the :class:`ScanEvalEngine` and its oracle, the per-batch
:class:`HostEvalEngine`.

Metrics are defined through sufficient statistics (:class:`EvalAccum`),
accumulated batch by batch on the device in a fixed order and finalized on
the host, so every engine is deterministic in ``(stacked, data,
weights)``. On a CUDA bank the scan engine is one CUDA graph of the whole
batch loop, equal to the host engine's loop bit for bit, given that cuDNN
picks the same algorithm for the same shapes (``torch.backends.cudnn``
with ``benchmark`` off); no engine sets a global flag. The SPMD
``ShardEvalEngine`` is ROADMAP A10.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.calibration import (ReliabilityBins, bin_index,
                                          bin_sums)
from repro_torch.core.posterior import bma_predict_stacked, predictive_entropy
from repro_torch.utils.graphs import capture
from repro_torch.utils.tree import tree_layout, tree_leaves, tree_map


def abstain_mask(entropy, threshold: float):
    """Entropy-gated selective prediction, True = abstain (route to a
    human): the one abstain rule of the eval accumulators and the serving
    engine, so a threshold tuned on an :class:`EvalReport` transfers to
    serving unchanged."""
    return entropy > threshold


class EvalAccum(NamedTuple):
    n: torch.Tensor             # () examples scored (mask-weighted)
    correct: torch.Tensor       # () argmax hits
    nll_sum: torch.Tensor       # () summed -log p(y)
    brier_sum: torch.Tensor     # () summed squared error to the one-hot
    ent_sum: torch.Tensor       # () summed predictive entropy
    bin_counts: torch.Tensor    # (O,) reliability-bin occupancy
    bin_conf: torch.Tensor      # (O,) summed confidence per bin
    bin_acc: torch.Tensor       # (O,) summed accuracy per bin
    abstained: torch.Tensor     # () examples over the entropy threshold
    kept_correct: torch.Tensor  # () argmax hits among answered examples


class EvalReport(NamedTuple):
    accuracy: float
    ece: float
    mce: float
    nll: float
    brier: float
    entropy: float
    overconf_gap: float         # mean (confidence - accuracy) over bins
    count: float
    bins: ReliabilityBins
    abstain_rate: float = 0.0
    kept_accuracy: float = float("nan")


def init_accum(num_bins: int, device="cpu") -> EvalAccum:
    z = torch.zeros((), device=device)
    zb = torch.zeros((num_bins,), device=device)
    return EvalAccum(z, z, z, z, z, zb, zb, zb, z, z)


def update_accum(accum: EvalAccum, probs, labels, mask, num_bins: int,
                 entropy_threshold: float = float("inf")) -> EvalAccum:
    """Fold one ``(B, C)`` probability batch in; ``mask`` zeroes padding.
    ``entropy_threshold`` feeds the selective-prediction sums only. A
    token-level batch (probs ``(B, T, C)``, labels ``(B, T)``) scores every
    label position as one example, the batch mask broadcast over them."""
    probs = probs.float()
    mask = mask.float()
    labels = labels.long()
    if labels.dim() > 1:
        mask = mask.reshape(mask.shape + (1,) * (labels.dim() - mask.dim())
                            ).expand(labels.shape).reshape(-1)
        probs = probs.reshape(-1, probs.shape[-1])
        labels = labels.reshape(-1)
    conf, pred = probs.max(dim=-1)
    correct = (pred == labels).float() * mask
    p_label = torch.gather(probs, -1, labels[:, None])[:, 0]
    nll = -torch.log(torch.clamp(p_label, min=1e-12)) * mask
    onehot = torch.nn.functional.one_hot(labels, probs.shape[-1]).float()
    brier = ((probs - onehot) ** 2).sum(dim=-1) * mask
    ent_raw = predictive_entropy(probs)
    abstain = abstain_mask(ent_raw, entropy_threshold).float()
    counts, conf_sum, acc_sum = bin_sums(
        bin_index(conf, num_bins), torch.stack([mask, conf * mask, correct]),
        num_bins)
    return EvalAccum(
        n=accum.n + mask.sum(),
        correct=accum.correct + correct.sum(),
        nll_sum=accum.nll_sum + nll.sum(),
        brier_sum=accum.brier_sum + brier.sum(),
        ent_sum=accum.ent_sum + (ent_raw * mask).sum(),
        bin_counts=accum.bin_counts + counts,
        bin_conf=accum.bin_conf + conf_sum,
        bin_acc=accum.bin_acc + acc_sum,
        abstained=accum.abstained + (abstain * mask).sum(),
        kept_correct=accum.kept_correct + (correct * (1.0 - abstain)).sum(),
    )


def finalize(accum: EvalAccum) -> EvalReport:
    """Sufficient statistics -> metrics (host floats)."""
    a = EvalAccum(*(t.detach().cpu().numpy() for t in accum))
    num_bins = a.bin_counts.shape[0]
    n = max(float(a.n), 1.0)
    safe = np.maximum(a.bin_counts, 1.0)
    conf_b = a.bin_conf / safe
    acc_b = a.bin_acc / safe
    w = a.bin_counts / n
    gaps = acc_b - conf_b
    occ = a.bin_counts > 0
    bins = ReliabilityBins(
        bin_confidence=conf_b.astype(np.float32),
        bin_accuracy=acc_b.astype(np.float32),
        bin_counts=a.bin_counts.astype(np.float32),
        edges=np.linspace(0.0, 1.0, num_bins + 1, dtype=np.float32),
    )
    return EvalReport(
        accuracy=float(a.correct / n),
        ece=float(np.sum(w * np.abs(gaps))),
        mce=float(np.max(np.where(occ, np.abs(gaps), 0.0))),
        nll=float(a.nll_sum / n),
        brier=float(a.brier_sum / n),
        entropy=float(a.ent_sum / n),
        overconf_gap=float(np.sum(np.where(occ, conf_b - acc_b, 0.0))
                           / max(int(occ.sum()), 1)),
        count=float(a.n),
        bins=bins,
        abstain_rate=float(a.abstained / n),
        kept_accuracy=float(a.kept_correct / max(float(a.n - a.abstained), 1.0)),
    )


def stack_eval_batches(data: Dict[str, np.ndarray], batch_size: int, device):
    """Pad + reshape to ``(nb, B, ...)`` tensors with a ``(nb, B)`` mask;
    the padded tail repeats example 0 and is masked out."""
    n = len(data["y"])
    if n == 0:
        raise ValueError("empty evaluation dataset")
    nb = -(-n // batch_size)
    pad = nb * batch_size - n
    out = {}
    for f, v in data.items():
        v = np.asarray(v)
        if pad:
            v = np.concatenate([v, np.repeat(v[:1], pad, axis=0)])
        out[f] = torch.from_numpy(v.reshape((nb, batch_size) + v.shape[1:])).to(device)
    mask = np.ones(nb * batch_size, np.float32)
    mask[n:] = 0.0
    return out, torch.from_numpy(mask.reshape(nb, batch_size)).to(device)


def eval_pass(logits_fn: Callable, stacked, weights, batches, masks,
              node_axis: Optional[int], num_bins: int,
              entropy_threshold: float, with_probs: bool):
    """One pass over ``(nb, B, ...)`` batches: zeroed accumulators, then
    each batch's BMA probabilities folded in, in batch order. Returns the
    accumulators and, ``with_probs``, the ``(nb * B, C)`` probabilities
    (``(nb * B, T, C)`` for token batches). The host engine runs it
    eagerly; the scan engine captures it."""
    acc = init_accum(num_bins, masks.device)
    probs_all = []
    for i in range(masks.shape[0]):
        batch = {f: v[i] for f, v in batches.items()}
        probs = bma_predict_stacked(logits_fn, stacked, batch,
                                    node_axis=node_axis, weights=weights)
        acc = update_accum(acc, probs, batches["y"][i], masks[i], num_bins,
                           entropy_threshold)
        if with_probs:
            probs_all.append(probs)
    return acc, (torch.cat(probs_all) if with_probs else None)


def lm_apply_fn(model) -> Callable:
    """Next-token prediction over token batches: the model's logits with
    any non-text prefix trimmed and the last position dropped; the labels
    are ``tokens[:, 1:]`` (the reference's one LM evaluation contract).
    ``apply(params, batch)`` -> ``(G, B, T - 1, V)``."""
    def apply(params, batch):
        lg = model.logits(params, batch)
        t = batch["tokens"].shape[1]
        return lg[:, :, lg.shape[2] - t:][:, :, :-1]
    return apply


def as_stacked(params: Any) -> Any:
    """Point params as a bank of one sample (S = 1)."""
    return tree_map(lambda x: torch.as_tensor(x)[None], params)


class _EvalGraph(NamedTuple):
    graph: Any                    # torch.cuda.CUDAGraph
    batches: Dict[str, torch.Tensor]   # static (nb, B, ...) inputs
    masks: torch.Tensor
    accum: EvalAccum              # outputs, rewritten by every replay
    probs: Optional[torch.Tensor]  # (nb * B, C) with return_probs


class HostEvalEngine:
    """The oracle: :func:`eval_pass` run eagerly, one batch after another,
    on the device of the ``stacked`` leaves. Deterministic in ``(stacked,
    data, weights)``."""

    name = "host"

    def __init__(self, logits_fn: Callable, num_bins: int = 10,
                 batch_size: int = 64,
                 entropy_threshold: float = float("inf")):
        self.logits_fn = logits_fn
        self.num_bins = int(num_bins)
        self.batch_size = int(batch_size)
        self.entropy_threshold = float(entropy_threshold)

    def _run(self, stacked, weights, batches, masks, node_axis,
             with_probs: bool):
        return eval_pass(self.logits_fn, stacked, weights, batches, masks,
                         node_axis, self.num_bins, self.entropy_threshold,
                         with_probs)

    @torch.no_grad()
    def evaluate(self, stacked, data: Dict[str, np.ndarray],
                 node_axis: Optional[int] = None, return_probs: bool = False,
                 weights=None):
        """One pass -> :class:`EvalReport`, and with ``return_probs`` the
        unpadded ``(N, C)`` BMA probabilities. ``weights`` ``(S,)``
        switches the BMA mean to that mixture."""
        n = len(data["y"])
        device = tree_leaves(stacked)[0].device
        batches, masks = stack_eval_batches(data, self.batch_size, device)
        if weights is not None:
            weights = torch.as_tensor(weights, dtype=torch.float32,
                                      device=device)
        acc, probs = self._run(stacked, weights, batches, masks, node_axis,
                               return_probs)
        report = finalize(acc)
        if return_probs:
            return report, probs[:n].cpu().numpy()
        return report


class ScanEvalEngine(HostEvalEngine):
    """The whole evaluation as one pass over fixed-size batches
    (``repro/eval/engine.py:ScanEvalEngine``, :func:`eval_pass`): per batch
    the BMA over the stacked bank, folded into the accumulators, which the
    pass zeroes first.

    ``logits_fn(params, batch)`` (a model's ``logits``, or
    :func:`lm_apply_fn`) takes params with a leading group axis and one
    batch's fields;
    ``stacked`` is ``(S, ...)``, or ``(S, K, ...)`` with ``node_axis=1``.
    On a CUDA bank the pass is one CUDA graph a shape key (the bank's
    layout, the number and size of batches, ``node_axis``, weighted or
    not, ``return_probs``), captured at first use after a warm-up on the
    capture stream and replayed after it: each call copies the bank, the
    weights and the batches into the static buffers the graph reads. The
    engine keeps one copy of the bank for its graphs; a bank of another
    layout replaces it, and its graphs with it. A failed capture raises;
    a CUDA bank never runs eagerly. On a CPU bank the pass runs eagerly,
    as the host engine's. Equal to :class:`HostEvalEngine` bit for bit.
    """

    name = "scan"

    def __init__(self, logits_fn: Callable, num_bins: int = 10,
                 batch_size: int = 64,
                 entropy_threshold: float = float("inf")):
        super().__init__(logits_fn, num_bins, batch_size, entropy_threshold)
        self._bank = None           # the bank the graphs read
        self._weights = None        # (S,) f32, beside it
        self._graphs: Dict[tuple, _EvalGraph] = {}
        self._stream = None
        self.capture_ms: Dict[tuple, float] = {}

    def _graph(self, stacked, batches, masks, node_axis, weighted: bool,
               with_probs: bool) -> _EvalGraph:
        if self._bank is None or tree_layout(stacked) != tree_layout(
                self._bank):
            self._graphs = {}       # they read the bank dropped here
            self._bank = tree_map(torch.empty_like, stacked)
            self._weights = torch.zeros((tree_leaves(stacked)[0].shape[0],),
                                        device=masks.device)
        key = (tuple((f, tuple(v.shape), v.dtype)
                     for f, v in sorted(batches.items())),
               node_axis, weighted, with_probs)
        if key not in self._graphs:
            if self._stream is None:
                self._stream = torch.cuda.Stream(masks.device)
            bs = {f: torch.zeros_like(v) for f, v in batches.items()}
            ms = torch.zeros_like(masks)
            bank, w = self._bank, self._weights if weighted else None
            graph, (acc, probs), took = capture(
                lambda: eval_pass(self.logits_fn, bank, w, bs, ms, node_axis,
                                  self.num_bins, self.entropy_threshold,
                                  with_probs), self._stream)
            self._graphs[key] = _EvalGraph(graph, bs, ms, acc, probs)
            self.capture_ms[key] = took
        return self._graphs[key]

    def _run(self, stacked, weights, batches, masks, node_axis,
             with_probs: bool):
        if masks.device.type != "cuda":
            return super()._run(stacked, weights, batches, masks, node_axis,
                                with_probs)
        g = self._graph(stacked, batches, masks, node_axis,
                        weights is not None, with_probs)
        for d, s in zip(tree_leaves(self._bank), tree_leaves(stacked)):
            d.copy_(s)
        if weights is not None:
            self._weights.copy_(weights)
        for f, v in batches.items():
            g.batches[f].copy_(v)
        g.masks.copy_(masks)
        g.graph.replay()
        return g.accum, g.probs


def ShardEvalEngine(*args, **kwargs):
    """The reference's SPMD eval engine (``eval/engine.py:364``) is
    ROADMAP A10."""
    raise NotImplementedError(
        "ShardEvalEngine is not ported yet; ROADMAP A10 (multi-GPU shard "
        "engine)")


def make_eval_engine(name: str, logits_fn: Callable, num_bins: int = 10,
                     batch_size: int = 64, mesh=None, fed_axis: str = "fed",
                     entropy_threshold: float = float("inf")):
    """``"scan"`` or ``"host"``; the SPMD ``"shard"`` engine is ROADMAP
    A10."""
    if name == "scan":
        return ScanEvalEngine(logits_fn, num_bins, batch_size,
                              entropy_threshold)
    if name == "host":
        return HostEvalEngine(logits_fn, num_bins, batch_size,
                              entropy_threshold)
    if name == "shard":
        raise NotImplementedError(
            "make_eval_engine('shard') is not ported yet; ROADMAP A10 "
            "(multi-GPU shard engine, ShardEvalEngine)")
    raise ValueError(f"unknown eval engine {name!r}; use 'scan', 'host' or "
                     f"'shard'")
