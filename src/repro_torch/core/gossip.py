"""Gossip: Ω-mixing over the node axis (Eq. 8's neighbor aggregate).

Counterpart of ``repro/core/gossip.py:dense_mix`` and a static
``make_mixer``. Static graphs only: no link dropout, no gossip pairs, no
participation masks (ROADMAP A7).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def dense_mix(omega: torch.Tensor, tree):
    """``einsum("kj,j...->k...", Ω, delta)`` leafwise, in f32."""
    return tree_map(
        lambda d: torch.einsum("kj,j...->k...", omega, d.float()).to(d.dtype),
        tree)


def make_mixer(omega: np.ndarray, device) -> Callable:
    """mix(tree) -> tree for the static Ω (identity for one node)."""
    if omega.shape[0] == 1:
        return lambda tree: tree
    om = torch.as_tensor(np.asarray(omega, np.float32), device=device)
    return lambda tree: dense_mix(om, tree)
