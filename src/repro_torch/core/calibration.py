"""Calibration metrics: ECE (paper Eq. 10), reliability bins, NLL, Brier
(``repro/core/calibration.py``). Probabilities ``(N, C)``, labels ``(N,)``.

Bins are summed in a fixed order (:func:`bin_sums`), so every statistic is
deterministic on the card as on the CPU."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.posterior import predictive_entropy  # noqa: F401


class ReliabilityBins(NamedTuple):
    bin_confidence: torch.Tensor   # (O,) mean confidence per bin
    bin_accuracy: torch.Tensor     # (O,) mean accuracy per bin
    bin_counts: torch.Tensor       # (O,) samples per bin
    edges: torch.Tensor            # (O+1,)


def bin_index(conf: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Right-inclusive bins (Guo et al. '17)."""
    return torch.clamp(torch.ceil(conf * num_bins).long() - 1, 0, num_bins - 1)


def bin_sums(idx: torch.Tensor, values: torch.Tensor, num_bins: int):
    """Bin sums ``(J, O)`` of ``values`` ``(J, B)``: row ``j``, bin ``o`` is
    the sum of ``values[j, b]`` over the examples ``b`` with ``idx[b] == o``,
    taken as a ``(B, O)`` one-hot selection reduced over the batch axis.
    A reduction sums in an order fixed by the shape, where ``index_add``
    on the card sums by float atomics in an order that changes from run to
    run (ROADMAP C12)."""
    hit = idx[:, None] == torch.arange(num_bins, device=idx.device)
    return torch.where(hit, values[..., None], 0.0).sum(dim=1)


def reliability_bins(probs, labels, num_bins: int = 10) -> ReliabilityBins:
    probs = probs.float()
    conf, pred = probs.max(dim=-1)
    correct = (pred == labels).float()
    idx = bin_index(conf, num_bins)
    counts, conf_sum, acc_sum = bin_sums(
        idx, torch.stack([torch.ones_like(conf), conf, correct]), num_bins)
    safe = torch.clamp(counts, min=1.0)
    return ReliabilityBins(conf_sum / safe, acc_sum / safe, counts,
                           torch.linspace(0.0, 1.0, num_bins + 1))


def ece(probs, labels, num_bins: int = 10) -> torch.Tensor:
    """Expected Calibration Error (paper Eq. 10)."""
    bins = reliability_bins(probs, labels, num_bins)
    w = bins.bin_counts / torch.clamp(bins.bin_counts.sum(), min=1.0)
    return (w * (bins.bin_accuracy - bins.bin_confidence).abs()).sum()


def accuracy(probs, labels) -> torch.Tensor:
    return (probs.argmax(dim=-1) == labels).float().mean()


def nll(probs, labels) -> torch.Tensor:
    p = torch.gather(probs, -1, labels.long()[:, None])[:, 0]
    return -torch.log(torch.clamp(p, min=1e-12)).mean()


def brier(probs, labels) -> torch.Tensor:
    onehot = torch.nn.functional.one_hot(labels.long(), probs.shape[-1]).float()
    return ((probs - onehot) ** 2).sum(dim=-1).mean()
