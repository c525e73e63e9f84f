"""Legacy string API for Ω (copy of ``repro/core/mixing.py``)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.topology import graph_adjacency, mixing_weights
from repro_torch.core.topology import spectral_gap as _spectral_gap


def adjacency(topology: str, k: int) -> np.ndarray:
    return graph_adjacency(topology, k)


def mixing_matrix(topology: str, k: int, rule: str = "metropolis") -> np.ndarray:
    """Symmetric doubly-stochastic Ω for the given graph."""
    if k == 1:
        return np.ones((1, 1))
    return mixing_weights(adjacency(topology, k), rule)


def spectral_gap(omega: np.ndarray) -> float:
    """1 - |lambda_2|: governs consensus speed."""
    return _spectral_gap(omega)
