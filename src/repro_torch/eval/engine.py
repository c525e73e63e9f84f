"""Evaluation: streaming metric accumulators and the host eval engine
(``repro/eval/engine.py:60-190`` and ``HostEvalEngine``, ``:308-362``).

Metrics are defined through sufficient statistics (:class:`EvalAccum`),
accumulated batch by batch on the device and finalized on the host.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.calibration import (ReliabilityBins, bin_index,
                                          predictive_entropy)
from repro_torch.core.posterior import bma_predict_stacked
from repro_torch.utils.tree import tree_leaves


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
    """Fold one ``(B, C)`` probability batch in; ``mask`` zeroes padding."""
    probs = probs.float()
    mask = mask.float()
    labels = labels.long()
    conf, pred = probs.max(dim=-1)
    correct = (pred == labels).float() * mask
    p_label = torch.gather(probs, -1, labels[:, None])[:, 0]
    nll = -torch.log(torch.clamp(p_label, min=1e-12)) * mask
    onehot = torch.nn.functional.one_hot(labels, probs.shape[-1]).float()
    brier = ((probs - onehot) ** 2).sum(dim=-1) * mask
    ent_raw = predictive_entropy(probs)
    abstain = (ent_raw > entropy_threshold).float()
    idx = bin_index(conf, num_bins)
    return EvalAccum(
        n=accum.n + mask.sum(),
        correct=accum.correct + correct.sum(),
        nll_sum=accum.nll_sum + nll.sum(),
        brier_sum=accum.brier_sum + brier.sum(),
        ent_sum=accum.ent_sum + (ent_raw * mask).sum(),
        bin_counts=accum.bin_counts.index_add(0, idx, mask),
        bin_conf=accum.bin_conf.index_add(0, idx, conf * mask),
        bin_acc=accum.bin_acc.index_add(0, idx, correct),
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


class HostEvalEngine:
    """Per-batch loop: BMA probabilities of each batch folded into the
    accumulators in batch order, on the device of the ``stacked`` leaves."""

    def __init__(self, logits_fn: Callable, num_bins: int = 10,
                 batch_size: int = 64):
        self.logits_fn = logits_fn
        self.num_bins = int(num_bins)
        self.batch_size = int(batch_size)

    @torch.no_grad()
    def evaluate(self, stacked, data: Dict[str, np.ndarray],
                 node_axis: Optional[int] = None, return_probs: bool = False):
        n = len(data["y"])
        device = tree_leaves(stacked)[0].device
        batches, masks = stack_eval_batches(data, self.batch_size, device)
        acc = init_accum(self.num_bins, device)
        all_probs = []
        for i in range(masks.shape[0]):
            probs = bma_predict_stacked(self.logits_fn, stacked,
                                        batches["x"][i], node_axis=node_axis)
            acc = update_accum(acc, probs, batches["y"][i], masks[i],
                               self.num_bins)
            if return_probs:
                all_probs.append(probs)
        report = finalize(acc)
        if return_probs:
            return report, torch.cat(all_probs)[:n].cpu().numpy()
        return report
