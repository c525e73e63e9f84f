"""Device graphs and their mixing matrices Ω (numpy, copied).

A copy of the part of ``repro/core/topology.py`` the port runs: the
``full`` and ``ring`` families a ``FedConfig`` names and the three mixing
rules of ``FedConfig.mixing`` (Metropolis-Hastings weights, Xiao & Boyd
'04, by default). Same arithmetic, so Ω is bit-identical to the
reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

GRAPHS = ("full", "ring")


def graph_adjacency(graph: str, k: int) -> np.ndarray:
    """0/1 adjacency (connected, no self loops)."""
    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")
    a = np.zeros((k, k), dtype=np.float64)
    if k == 1:
        return a
    if graph == "full":
        a = np.ones((k, k)) - np.eye(k)
    elif graph == "ring":
        for i in range(k):
            a[i, (i + 1) % k] = a[i, (i - 1) % k] = 1.0
    else:
        raise NotImplementedError(
            f"graph {graph!r} is not ported yet (ported: {GRAPHS}); ROADMAP A4")
    return a


def mixing_weights(adj: np.ndarray, rule: str = "metropolis") -> np.ndarray:
    """Symmetric doubly-stochastic Ω from an adjacency."""
    k = adj.shape[0]
    if k == 1:
        return np.ones((1, 1))
    deg = adj.sum(axis=1)
    w = np.zeros_like(adj, dtype=np.float64)
    if rule == "metropolis":
        nz = np.nonzero(adj)
        w[nz] = 1.0 / (1.0 + np.maximum(deg[nz[0]], deg[nz[1]]))
    elif rule in ("max_degree", "uniform"):
        w = adj / (deg.max() + 1.0)
    else:
        raise ValueError(f"unknown mixing rule {rule!r}")
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


@dataclass(frozen=True)
class Topology:
    graph: str
    k: int
    adjacency: np.ndarray           # (K, K) 0/1, symmetric, hollow
    omega: np.ndarray               # (K, K) symmetric doubly stochastic


def build_topology(graph: str, k: int, rule: str = "metropolis") -> Topology:
    adj = graph_adjacency(graph, k)
    return Topology(graph=graph, k=k, adjacency=adj,
                    omega=mixing_weights(adj, rule))


def resolve_topology(fed_cfg) -> str:
    """The graph family a FedConfig names; its rule is ``fed_cfg.mixing``
    (``FedConfig.topology_cfg`` is ROADMAP A4)."""
    return fed_cfg.topology
