"""Posterior sample banks and Bayesian model averaging
(``repro/core/posterior.py``: the host ``SampleBank``, the on-device
``DeviceSampleBank`` and the unweighted path of ``bma_predict_stacked``)."""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
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


class DeviceBankState(NamedTuple):
    """Ring buffer of posterior samples on the device
    (``repro/core/posterior.py:55-75``).

    ``slots`` mirrors the params tree with a leading capacity axis ``(C,
    ...)``; ``count`` is the number of samples ever admitted (the write
    pointer is ``count % C``, so eviction drops the oldest, as the host
    :class:`SampleBank`'s pop-front does). In int8 storage ``slots`` holds
    the quantized grid and ``scales`` the per-(slot, row) f32 scales;
    ``None`` in f32 storage. ``rounds`` is each slot's admission round
    (-1: empty).
    """
    slots: Any             # leaves (C, ...)
    count: torch.Tensor    # () int32, samples ever admitted
    scales: Any = None     # int8 storage: f32 leaves (C, leaf.shape[0])
    rounds: Any = None     # (C,) int32


# XLA folds the reference's ``amax / 127.0`` inside ``jit`` (its scan
# engine's bank update) into a product with the f32 reciprocal (ROADMAP C5)
INV_127 = float(np.float32(1.0) / np.float32(127.0))


class DeviceSampleBank:
    """Fixed-capacity posterior bank on the device
    (``repro/core/posterior.py:77-244``).

    Admits round ``t`` iff ``t >= burn_in`` and ``(t - burn_in) % thin ==
    0``; once full, the oldest sample is evicted: the host
    :class:`SampleBank`'s semantics for rounds visited in order. The admit
    decision is made on the device from a device round index (the
    reference's ``lax.select``): every update reads and writes one slot,
    whichever branch is taken, and syncs nothing with the host, so it can
    run inside a CUDA graph. Where the reference returns a new state from
    its donated one, :meth:`update` writes the state's tensors in place.

    ``store_dtype="int8"`` keeps each sample as a symmetric absmax int8
    grid with per-(slot, leading-row) f32 scales: the leading row is the
    node axis under the trainer's layout. The age weights of continual
    learning are ROADMAP A4 and A9; mesh placement (``pspecs``) is A10.
    """

    def __init__(self, burn_in: int, capacity: int = 40, thin: int = 1,
                 store_dtype: str = "float32"):
        self.burn_in = int(burn_in)
        self.capacity = int(capacity)
        self.thin = max(1, int(thin))
        self.store_dtype = str(store_dtype)
        if self.store_dtype not in ("float32", "int8"):
            raise ValueError(f"store_dtype must be float32|int8, "
                             f"got {store_dtype!r}")

    def init(self, params) -> DeviceBankState:
        dev = tree_leaves(params)[0].device
        rounds = torch.full((self.capacity,), -1, dtype=torch.int32,
                            device=dev)
        count = torch.zeros((), dtype=torch.int32, device=dev)
        if self.store_dtype == "int8":
            return DeviceBankState(
                slots=tree_map(lambda x: torch.zeros(
                    (self.capacity,) + tuple(x.shape), dtype=torch.int8,
                    device=dev), params),
                count=count,
                scales=tree_map(lambda x: torch.ones(
                    (self.capacity,) + tuple(x.shape[:1]), device=dev),
                    params),
                rounds=rounds)
        return DeviceBankState(
            slots=tree_map(lambda x: torch.zeros(
                (self.capacity,) + tuple(x.shape), device=dev), params),
            count=count, rounds=rounds)

    # -- int8 storage -------------------------------------------------------
    @staticmethod
    def _leaf_scale(x: torch.Tensor) -> torch.Tensor:
        """Per-leading-row absmax/127 (1.0 for an all-zero row, so
        dequantizing it stays exact)."""
        x32 = x.float()
        amax = x32.abs().flatten(1).amax(1) if x32.dim() > 1 else x32.abs()
        return torch.where(amax > 0, amax * INV_127, 1.0)

    @classmethod
    def _quantize_leaf(cls, x: torch.Tensor) -> torch.Tensor:
        scale = cls._leaf_scale(x)
        x32 = x.float()
        s = scale.reshape(scale.shape + (1,) * (x32.dim() - scale.dim()))
        # torch.round rounds half to even, as jnp.round does
        return torch.round(x32 / s).clamp(-127, 127).to(torch.int8)

    def admit_mask(self, round_idx) -> torch.Tensor:
        """Whether round ``round_idx`` (an int or a device int tensor)
        enters the bank, as a bool tensor."""
        since = torch.as_tensor(round_idx) - self.burn_in
        return (since >= 0) & (since % self.thin == 0)

    def update(self, bank: DeviceBankState, round_idx, params
               ) -> DeviceBankState:
        """Offer round ``round_idx``'s params; writes ``bank`` in place and
        returns it. ``round_idx``: an int, or an int32 tensor on the bank's
        device (as the chunked engine passes it)."""
        t = torch.as_tensor(round_idx, dtype=torch.int32,
                            device=bank.count.device)
        add = self.admit_mask(t)
        ptr = torch.remainder(bank.count, self.capacity).reshape(1).long()

        def write(slot, new):
            cur = slot.index_select(0, ptr)
            slot.index_copy_(0, ptr, torch.where(add, new.to(slot.dtype)[None],
                                                 cur))

        if bank.rounds is not None:
            write(bank.rounds, t)
        if bank.scales is not None:
            for s, sc, p in zip(tree_leaves(bank.slots),
                                tree_leaves(bank.scales), tree_leaves(params)):
                write(s, self._quantize_leaf(p))
                write(sc, self._leaf_scale(p))
        else:
            for s, p in zip(tree_leaves(bank.slots), tree_leaves(params)):
                write(s, p)
        bank.count.add_(add.to(torch.int32))
        return bank

    # -- host-side views ------------------------------------------------------
    def order(self, bank: DeviceBankState) -> np.ndarray:
        """Slot indices oldest to newest (the host bank's list order); reads
        the count once."""
        count = int(bank.count)
        if count <= self.capacity:
            return np.arange(count)
        ptr = count % self.capacity
        return (ptr + np.arange(self.capacity)) % self.capacity

    def stacked(self, bank: DeviceBankState, order=None):
        """(S, ...) samples in insertion order, dequantized to f32 in int8
        storage; ``order``, when given, is :meth:`order`'s result."""
        order = self.order(bank) if order is None else order
        idx = torch.as_tensor(order, dtype=torch.long,
                              device=bank.count.device)
        if bank.scales is None:
            return tree_map(lambda s: s[idx], bank.slots)

        def deq(s, sc):
            rows, scr = s[idx].float(), sc[idx]
            return rows * scr.reshape(scr.shape + (1,) * (rows.dim()
                                                          - scr.dim()))
        return tree_map(deq, bank.slots, bank.scales)

    def samples_list(self, bank: DeviceBankState) -> List[Any]:
        """The host SampleBank's list-of-trees view."""
        order = self.order(bank)
        stacked = self.stacked(bank, order)
        return [tree_map(lambda s: s[i], stacked) for i in range(len(order))]

    def length(self, bank: DeviceBankState) -> int:
        return min(int(bank.count), self.capacity)

    def rounds_list(self, bank: DeviceBankState) -> np.ndarray:
        """Admission rounds in insertion order (host SampleBank.rounds)."""
        order = self.order(bank)
        if bank.rounds is None:
            return np.zeros((len(order),), np.int32)
        return bank.rounds.cpu().numpy()[order]


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
