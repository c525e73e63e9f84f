"""Federated data partitioner and the device-resident shards.

``partition_iid`` is a copy of the reference (numpy, byte-equal output).
:class:`DeviceShards` is the counterpart of the reference class of the same
name: every node's shard is zero-padded to the longest one and stacked, so
each field lives on the device as one ``(K, N_max, ...)`` tensor, and a
round's ``(K, L, M)`` minibatch indices are drawn from a ``torch.Generator``
(or handed in, which is how the parity tests feed the reference's draws).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch


def partition_iid(ds: Dict[str, np.ndarray], k: int, seed: int = 0
                  ) -> List[Dict[str, np.ndarray]]:
    n = len(ds["y"])
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    shards = np.array_split(perm, k)
    return [{key: val[idx] for key, val in ds.items()} for idx in shards]


@dataclass(frozen=True)
class DeviceShards:
    """Padded ``(K, N_max, ...)`` shards on one device.

    Sampling draws node ``k``'s indices uniformly from ``[0, n_k)``, so the
    padded tail is never read.
    """

    data: Dict[str, torch.Tensor]          # (K, N_max, ...) per field
    sizes: tuple                           # (K,) true shard lengths

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
        return cls(data=data, sizes=sizes)

    @property
    def num_nodes(self) -> int:
        return len(self.sizes)

    @property
    def device(self) -> torch.device:
        return next(iter(self.data.values())).device

    def sample_indices(self, generator: torch.Generator, l: int, m: int
                       ) -> torch.Tensor:
        """(K, L, M) int64 indices, node k uniform over its shard length."""
        return torch.stack([
            torch.randint(0, n, (l, m), generator=generator,
                          device=generator.device).to(self.device)
            for n in self.sizes])

    def gather(self, idx) -> Dict[str, torch.Tensor]:
        """(K, L, M, ...) round batches from (K, L, M) indices (a tensor or
        an array handed in, e.g. the reference's own draws)."""
        if not torch.is_tensor(idx):
            idx = torch.from_numpy(np.array(idx))
        idx = idx.to(self.device).long()
        rows = torch.arange(self.num_nodes, device=self.device)
        rows = rows.view(-1, *([1] * (idx.dim() - 1)))
        return {f: v[rows, idx] for f, v in self.data.items()}
