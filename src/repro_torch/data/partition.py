"""Federated data partitioner and the device-resident shards.

``partition_iid``, ``partition_dirichlet`` (label skew, per-class device
proportions ~ Dir(α)) and ``minibatch_stack`` (host sampling of one
round's ``(K, L, M, ...)`` stack) are copies of the reference's numpy code,
byte-equal output for the same seed or generator.
:class:`DeviceShards` is the counterpart of the reference class of the same
name: every node's shard is zero-padded to the longest one and stacked, so
each field lives on the device as one ``(K, N_max, ...)`` tensor, and a
round's ``(K, L, M)`` minibatch indices are drawn on the device with the
reference's keys and arithmetic (``repro_torch.random``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from repro_torch import random


def partition_iid(ds: Dict[str, np.ndarray], k: int, seed: int = 0
                  ) -> List[Dict[str, np.ndarray]]:
    n = len(ds["y"])
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    shards = np.array_split(perm, k)
    return [{key: val[idx] for key, val in ds.items()} for idx in shards]


def partition_dirichlet(ds: Dict[str, np.ndarray], k: int, alpha: float = 0.5,
                        seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """Label-skewed split: per-class device proportions ~ Dir(alpha); an
    empty shard gets one random example."""
    rng = np.random.default_rng(seed)
    y = ds["y"]
    device_idx: List[List[int]] = [[] for _ in range(k)]
    for c in np.unique(y):
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(alpha * np.ones(k))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for dev, part in enumerate(np.split(idx, cuts)):
            device_idx[dev].extend(part.tolist())
    out = []
    for dev in range(k):
        idx = np.array(sorted(device_idx[dev]), dtype=int)
        if len(idx) == 0:
            idx = rng.integers(0, len(y), size=1)
        out.append({key: val[idx] for key, val in ds.items()})
    return out


def minibatch_stack(shards: List[Dict[str, np.ndarray]], l: int, m: int,
                    rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """One round's ``(K, L, M, ...)`` minibatch stacks, sampled on the
    host."""
    out: Dict[str, List] = {key: [] for key in shards[0]}
    for shard in shards:
        idx = rng.integers(0, len(shard["y"]), size=(l, m))
        for key in shard:
            out[key].append(shard[key][idx])
    return {key: np.stack(val) for key, val in out.items()}


@dataclass(frozen=True)
class DeviceShards:
    """Padded ``(K, N_max, ...)`` shards on one device.

    Sampling draws node ``k``'s indices uniformly from ``[0, n_k)``, so the
    padded tail is never read.
    """

    data: Dict[str, torch.Tensor]          # (K, N_max, ...) per field
    sizes: tuple                           # (K,) true shard lengths
    size_tensor: torch.Tensor              # the same, (K,) int64 on device

    @classmethod
    def from_shards(cls, shards: List[Dict[str, np.ndarray]],
                    device) -> "DeviceShards":
        fields = list(shards[0])
        count_key = "y" if "y" in fields else fields[0]
        sizes = tuple(len(s[count_key]) for s in shards)
        n_max = max(sizes)
        data = {}
        for f in fields:
            padded = [np.pad(np.asarray(s[f]),
                             [(0, n_max - len(s[f]))] + [(0, 0)] * (s[f].ndim - 1))
                      for s in shards]
            data[f] = torch.from_numpy(np.stack(padded)).to(device)
        return cls(data=data, sizes=sizes,
                   size_tensor=torch.tensor(sizes, device=device))

    @property
    def num_nodes(self) -> int:
        return len(self.sizes)

    @property
    def device(self) -> torch.device:
        return next(iter(self.data.values())).device

    @random.program
    def sample_indices(self, key: torch.Tensor, l: int, m: int):
        """(K, L, M) int32 indices: node k draws ``randint(fold_in(key, k),
        (l, m), 0, n_k)`` (``repro/data/partition.py:105-119``);
        ``fold_in(key, k)`` for ``k < K`` is ``split(key, K)[k]``."""
        node_keys = yield from random.split.program(key, self.num_nodes)
        return (yield from random.randint.program(node_keys, (l, m), 0,
                                                  self.size_tensor))

    def gather(self, idx) -> Dict[str, torch.Tensor]:
        """(K, L, M, ...) round batches from (K, L, M) indices (a tensor or
        an array handed in, e.g. the reference's own draws)."""
        if not torch.is_tensor(idx):
            idx = torch.from_numpy(np.array(idx))
        idx = idx.to(self.device).long()
        rows = torch.arange(self.num_nodes, device=self.device)
        rows = rows.view(-1, *([1] * (idx.dim() - 1)))
        return {f: v[rows, idx] for f, v in self.data.items()}
