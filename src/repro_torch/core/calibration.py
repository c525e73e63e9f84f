"""Calibration metrics: ECE (paper Eq. 10), reliability bins, NLL, Brier
(``repro/core/calibration.py``). Probabilities ``(N, C)``, labels ``(N,)``."""
from __future__ import annotations

from typing import NamedTuple

import torch


class ReliabilityBins(NamedTuple):
    bin_confidence: torch.Tensor   # (O,) mean confidence per bin
    bin_accuracy: torch.Tensor     # (O,) mean accuracy per bin
    bin_counts: torch.Tensor       # (O,) samples per bin
    edges: torch.Tensor            # (O+1,)


def bin_index(conf: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Right-inclusive bins (Guo et al. '17)."""
    return torch.clamp(torch.ceil(conf * num_bins).long() - 1, 0, num_bins - 1)


def reliability_bins(probs, labels, num_bins: int = 10) -> ReliabilityBins:
    probs = probs.float()
    conf, pred = probs.max(dim=-1)
    correct = (pred == labels).float()
    idx = bin_index(conf, num_bins)
    zeros = torch.zeros(num_bins, device=probs.device)
    counts = zeros.index_add(0, idx, torch.ones_like(conf))
    conf_sum = zeros.index_add(0, idx, conf)
    acc_sum = zeros.index_add(0, idx, correct)
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


def predictive_entropy(probs) -> torch.Tensor:
    """Per-example entropy of the predictive distribution, nats."""
    return -(probs * torch.log(torch.clamp(probs, min=1e-12))).sum(dim=-1)
