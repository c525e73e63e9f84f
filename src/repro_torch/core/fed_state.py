"""Federated state: node-stacked params and the CHOCO control variates.

Counterpart of ``repro/core/fed_state.py``. Every leaf leads with the node
axis K. The round function returns a new :class:`FedState`; tensors are
never updated in place, so a caller may keep an old state.

``key`` is the reference's per-node key stream (``fed_state.py:38-59``):
``kinit, kstack, knodes = split(key or PRNGKey(seed), 3)``, then
``split(knodes, K)``, a ``(K, 2)`` key tensor in ``repro_torch.random``'s
representation on the params' device. A round folds it by its index and
hands it to a user's loss (``core/algorithms.py``); it never changes.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import random
from repro_torch.utils.tree import tree_leaves, tree_map


class FedState(NamedTuple):
    params: Any          # θ_k   leaves (K, ...)
    v: Any               # v_k   control sequence (paper Eq. 7)
    v_bar: Any           # v̄_k  neighbor aggregate (paper Eq. 8)
    seeds: tuple         # (K,) per-node seeds (node k: seed·K + k)
    key: Any             # (K, 2) per-node keys
    round: int


def stack_node_params(params_single, num_nodes: int):
    """Replicate single-model params to K nodes."""
    return tree_map(
        lambda x: x[None].expand((num_nodes,) + tuple(x.shape)).contiguous(),
        params_single)


def init_fed_state(params_single, fed_cfg, key=None) -> FedState:
    """K copies of ``params_single``; ``v = v̄ = 0`` in ``control_dtype``;
    the node keys from ``key`` (default ``PRNGKey(fed_cfg.seed)``), derived
    on the key's device and moved to the params' device."""
    params = stack_node_params(params_single, fed_cfg.num_nodes)
    device = tree_leaves(params)[0].device
    cdtype = getattr(torch, fed_cfg.control_dtype)
    key = random.PRNGKey(fed_cfg.seed) if key is None else key
    knodes = random.split(key, 3)[2]
    node_keys = random.split(knodes, fed_cfg.num_nodes)
    return FedState(
        params=params,
        v=tree_map(lambda x: torch.zeros(x.shape, dtype=cdtype, device=x.device),
                   params),
        v_bar=tree_map(lambda x: torch.zeros(x.shape, dtype=cdtype,
                                             device=x.device), params),
        seeds=tuple(fed_cfg.seed * fed_cfg.num_nodes + k
                    for k in range(fed_cfg.num_nodes)),
        key=node_keys.to(device),
        round=0,
    )
