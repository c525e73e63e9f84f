"""Federated state: node-stacked params and the CHOCO control variates.

Counterpart of ``repro/core/fed_state.py``. Every leaf leads with the node
axis K. The round function returns a new :class:`FedState`; tensors are
never updated in place, so a caller may keep an old state.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils.tree import tree_map


class FedState(NamedTuple):
    params: Any          # θ_k   leaves (K, ...)
    v: Any               # v_k   control sequence (paper Eq. 7)
    v_bar: Any           # v̄_k  neighbor aggregate (paper Eq. 8)
    seeds: tuple         # (K,) per-node seeds (node k: seed·K + k)
    round: int


def stack_node_params(params_single, num_nodes: int):
    """Replicate single-model params to K nodes."""
    return tree_map(
        lambda x: x[None].expand((num_nodes,) + tuple(x.shape)).contiguous(),
        params_single)


def init_fed_state(params_single, fed_cfg) -> FedState:
    """K copies of ``params_single``; ``v = v̄ = 0`` in ``control_dtype``."""
    params = stack_node_params(params_single, fed_cfg.num_nodes)
    cdtype = getattr(torch, fed_cfg.control_dtype)
    return FedState(
        params=params,
        v=tree_map(lambda x: torch.zeros(x.shape, dtype=cdtype, device=x.device),
                   params),
        v_bar=tree_map(lambda x: torch.zeros(x.shape, dtype=cdtype,
                                             device=x.device), params),
        seeds=tuple(fed_cfg.seed * fed_cfg.num_nodes + k
                    for k in range(fed_cfg.num_nodes)),
        round=0,
    )
