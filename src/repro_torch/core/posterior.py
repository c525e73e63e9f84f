"""Posterior sample bank and Bayesian model averaging
(``repro/core/posterior.py``: the host ``SampleBank`` and the unweighted
path of ``bma_predict_stacked``)."""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


class SampleBank:
    """Reservoir of posterior samples (thinned, post burn-in), kept on the
    device the chains run on. Round ``t`` is admitted iff ``t >= burn_in``
    and it is every ``thin``-th admissible round; once full, the oldest
    sample is evicted."""

    def __init__(self, burn_in: int, max_samples: int = 50, thin: int = 1):
        self.burn_in = burn_in
        self.max_samples = max_samples
        self.thin = thin
        self.samples: List[Any] = []
        self.rounds: List[int] = []
        self._seen = 0

    def maybe_add(self, round_idx: int, params) -> bool:
        if round_idx < self.burn_in:
            return False
        self._seen += 1
        if (self._seen - 1) % self.thin != 0:
            return False
        if len(self.samples) >= self.max_samples:
            self.samples.pop(0)
            self.rounds.pop(0)
        self.samples.append(tree_map(lambda x: x.detach().clone(), params))
        self.rounds.append(int(round_idx))
        return True

    def stacked(self):
        """(S, ...) samples in insertion order, or None while empty."""
        if not self.samples:
            return None
        return tree_map(lambda *xs: torch.stack(xs), *self.samples)

    def __len__(self):
        return len(self.samples)


def bma_predict_stacked(logits_fn: Callable, stacked, x,
                        node_axis: Optional[int] = None) -> torch.Tensor:
    """BMA predictive distribution over a stacked ``(S, [K,] ...)`` bank:
    the mean of the softmax probabilities over samples (and node chains).
    ``logits_fn(params, x)`` takes params with a leading group axis; one
    sample's K chains run as one group, so memory stays at one sample's.
    The reference's age-weighted mixture is ROADMAP A4."""
    num_samples = tree_leaves(stacked)[0].shape[0]
    probs = []
    for s in range(num_samples):
        params = tree_map(
            lambda a: a[s] if node_axis is not None else a[s:s + 1], stacked)
        probs.append(torch.softmax(logits_fn(params, x).float(), dim=-1))
    return torch.stack(probs).mean(dim=(0, 1))
