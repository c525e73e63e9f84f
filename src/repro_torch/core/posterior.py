"""Posterior sample banks and Bayesian model averaging
(``repro/core/posterior.py``): the host ``SampleBank``, the on-device
``DeviceSampleBank``, the age weights of a bank, ``bma_predict_stacked``
and the ``BankPredictor`` that serving and the trainer hand out.

Bit equality between two paths that run the same forward on the card
(``BankPredictor`` on a CUDA bank, the eval engines) assumes that cuDNN
picks the same algorithm for the same shapes, as it does with
``torch.backends.cudnn.benchmark`` off; this module sets no global flag.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.graphs import capture
from repro_torch.utils.tree import tree_layout, tree_leaves, tree_map


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
    node axis under the trainer's layout. Mesh placement (``pspecs``) is
    ROADMAP A10.
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

    def age_weights(self, bank: DeviceBankState, now: int, window: int = 0,
                    decay: float = 1.0) -> np.ndarray:
        """Age-discounted BMA weights in insertion order."""
        return bank_age_weights(self.rounds_list(bank), now, window=window,
                                decay=decay)


def bank_age_weights(rounds, now: int, window: int = 0,
                     decay: float = 1.0) -> np.ndarray:
    """Age-discounted, window-evicted BMA weights over a sample bank
    (float64 numpy, the reference's arithmetic).

    Sample ``i``, admitted at round ``r_i``, weighs ``decay ** (now -
    r_i)``, zero when ``window > 0`` and ``now - r_i >= window``; then the
    weights are normalized to sum to one. If every sample falls outside
    the window, the newest alone weighs 1.
    """
    rounds = np.asarray(rounds, np.int64)
    if rounds.size == 0:
        return np.zeros((0,), np.float64)
    age = np.maximum(np.int64(now) - rounds, 0)
    w = np.power(np.float64(min(max(decay, 0.0), 1.0)), age)
    if window > 0:
        w = np.where(age < window, w, 0.0)
    total = float(w.sum())
    if total <= 0.0:
        w = np.zeros_like(w)
        w[int(np.argmin(age))] = 1.0
        return w
    return w / total


def bma_predict_stacked(logits_fn: Callable, stacked, batch,
                        node_axis: Optional[int] = None,
                        weights=None) -> torch.Tensor:
    """BMA predictive distribution over a stacked ``(S, [K,] ...)`` bank:
    the mean of the softmax probabilities over samples (and node chains).
    ``logits_fn(params, batch)`` (a model's ``logits``) takes params with a
    leading group axis; one sample's K chains run as one group, so memory
    stays at one sample's.

    ``weights`` ``(S,)`` replaces the uniform sample mean by a mixture (for
    example :func:`bank_age_weights`): the nodes are averaged first, then
    the samples mixed with the normalized weights, as a separate reduction;
    ``weights=None`` keeps the uniform mean unchanged. Inside a CUDA graph
    ``weights`` must already be a float32 tensor on the bank's device."""
    num_samples = tree_leaves(stacked)[0].shape[0]
    probs = []
    for s in range(num_samples):
        params = tree_map(
            lambda a: a[s] if node_axis is not None else a[s:s + 1], stacked)
        probs.append(torch.softmax(logits_fn(params, batch).float(),
                                   dim=-1))
    probs = torch.stack(probs)                  # (S, K or 1, B, C)
    if weights is None:
        return probs.mean(dim=(0, 1))
    w = torch.as_tensor(weights, dtype=torch.float32, device=probs.device)
    w = w / torch.clamp(w.sum(), min=1e-12)
    return torch.einsum("s,s...->...", w, probs.mean(dim=1))


def predictive_entropy(probs) -> torch.Tensor:
    """Entropy of the predictive distribution in nats, the last axis
    reduced: the one entropy formula, which the eval accumulators, the
    serving engine's abstain gate and the CLI all use."""
    p = probs.float()
    return -(p * torch.log(torch.clamp(p, min=1e-12))).sum(dim=-1)


class PosteriorPredictor:
    """``predict(batch) -> (probs, entropy)``: BMA probabilities and the
    predictive entropy, whatever holds the samples."""

    def predict(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError


class _PredictGraph(NamedTuple):
    graph: Any                   # torch.cuda.CUDAGraph
    batch: Dict[str, torch.Tensor]   # the static inputs the graph reads
    probs: torch.Tensor          # outputs, rewritten by every replay
    entropy: torch.Tensor


class BankPredictor(PosteriorPredictor):
    """BMA over a resident stacked bank ``(S, ...)``, or ``(S, K, ...)``
    with ``node_axis=1`` (the layout of :meth:`DeviceSampleBank.stacked`),
    through ``logits_fn(params, batch)`` (a model's ``logits``) on the
    batch dict that :meth:`predict` is given, as the reference's.

    The predictor keeps its own copy of the bank. On a CUDA bank each batch
    layout (its fields' shapes and dtypes, and weighted or not) is one CUDA
    graph of the BMA forward and
    its entropy, captured at its first ``predict`` and replayed after it;
    ``compile_count()`` counts captures. :meth:`install` with the layout of
    the bank in place (leaf paths, shapes and dtypes) copies the new bank,
    from any device, into the buffers the graphs read, so a hot swap
    captures nothing and allocates nothing; another layout allocates new
    buffers, and each input shape is captured again, counted as such. On
    a CPU bank the same forward runs eagerly. A failed capture raises.

    Two predictions are equal bit for bit to an eval engine's of the same
    bank at the same batch shape on the same device (see the module's note
    on cuDNN). Mesh placement of the sample axis is ROADMAP A10.
    """

    def __init__(self, logits_fn: Callable, stacked: Any = None,
                 node_axis: Optional[int] = None, mesh=None,
                 ensemble_axis: str = ""):
        if mesh is not None or ensemble_axis:
            raise NotImplementedError(
                "BankPredictor(mesh=, ensemble_axis=) is not ported yet; "
                "ROADMAP A10 (multi-GPU shard engine, place_ensemble)")
        self.logits_fn = logits_fn
        self.node_axis = node_axis
        self._stacked = None
        self._weights = None       # (S,) f32 buffer of the weighted graphs
        self._weighted = False
        self._graphs: Dict[tuple, _PredictGraph] = {}
        self._captures = 0
        self._stream = None
        self.capture_ms: Dict[tuple, float] = {}
        if stacked is not None:
            self.install(stacked)

    # -- bank lifecycle ------------------------------------------------------
    @torch.no_grad()
    def install(self, stacked, weights=None) -> None:
        """Install a bank (a hot swap between calls). ``weights`` ``(S,)``
        (e.g. :func:`bank_age_weights`) switches ``predict`` to the weighted
        mixture; ``None`` keeps the uniform mean."""
        stacked = tree_map(torch.as_tensor, stacked)
        if self._stacked is not None and \
                tree_layout(stacked) == tree_layout(self._stacked):
            for d, s in zip(tree_leaves(self._stacked), tree_leaves(stacked)):
                if d is not s:
                    d.copy_(s)
        else:
            self._graphs = {}          # they read the buffers dropped here
            self._stacked = tree_map(lambda x: x.detach().clone(), stacked)
            s = tree_leaves(stacked)[0]
            self._weights = torch.zeros((s.shape[0],), device=s.device)
        self._weighted = weights is not None
        if self._weighted:
            self._weights.copy_(torch.as_tensor(weights,
                                                dtype=torch.float32))

    @property
    def stacked(self):
        return self._stacked

    @property
    def device(self) -> torch.device:
        return tree_leaves(self._stacked)[0].device

    def num_samples(self) -> int:
        if self._stacked is None:
            return 0
        return int(tree_leaves(self._stacked)[0].shape[0])

    def compile_count(self) -> int:
        """CUDA graphs captured so far (0 on the CPU)."""
        return self._captures

    # -- prediction ----------------------------------------------------------
    def _forward(self, batch: Dict[str, torch.Tensor], weighted: bool):
        probs = bma_predict_stacked(self.logits_fn, self._stacked, batch,
                                    node_axis=self.node_axis,
                                    weights=self._weights if weighted
                                    else None)
        return probs, predictive_entropy(probs)

    def _graph(self, batch: Dict[str, torch.Tensor]) -> _PredictGraph:
        key = (tuple((f, tuple(v.shape), v.dtype)
                     for f, v in sorted(batch.items())), self._weighted)
        if key not in self._graphs:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            bs = {f: torch.zeros(v.shape, dtype=v.dtype, device=self.device)
                  for f, v in batch.items()}
            weighted = self._weighted
            graph, (probs, ent), ms = capture(
                lambda: self._forward(bs, weighted), self._stream)
            self._graphs[key] = _PredictGraph(graph, bs, probs, ent)
            self._captures += 1
            self.capture_ms[key] = ms
        return self._graphs[key]

    @torch.no_grad()
    def predict(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """A batch dict (a classifier's ``{"x": (B, ...)}``, an LM's
        ``{"tokens": (B, S)}``) -> the BMA probabilities (``(B, C)``,
        ``(B, S, V)``) and their entropy, on the bank's device."""
        if self._stacked is None:
            raise ValueError("no bank installed; call install(stacked)")
        batch = {f: torch.as_tensor(v) for f, v in batch.items()}
        if self.device.type != "cuda":
            return self._forward({f: v.to(self.device)
                                  for f, v in batch.items()}, self._weighted)
        g = self._graph(batch)
        for f, v in batch.items():
            g.batch[f].copy_(v)
        g.graph.replay()
        return g.probs.clone(), g.entropy.clone()


def place_ensemble(stacked, mesh, axis: str):
    """Sharding the sample axis over a mesh is ROADMAP A10."""
    raise NotImplementedError(
        "place_ensemble is not ported yet; ROADMAP A10 (multi-GPU shard "
        "engine)")


def bma_predict(logits_fn: Callable, samples: List[Any], batch,
                node_axis: Optional[int] = None) -> torch.Tensor:
    """Average softmax probabilities over a list of posterior samples, one
    forward a sample.

    .. deprecated::
        Kept as the reference's legacy oracle; use :class:`BankPredictor`
        or :func:`bma_predict_stacked`.
    """
    warnings.warn(
        "bma_predict (per-sample dispatch loop) is deprecated; use "
        "repro_torch.core.posterior.BankPredictor / bma_predict_stacked",
        DeprecationWarning, stacklevel=2)
    probs, n = None, 0
    for params in samples:
        p_s = point_predict(logits_fn, params, batch, node_axis=node_axis)
        probs = p_s if probs is None else probs + p_s
        n += 1
    if probs is None:
        raise ValueError("empty sample bank")
    return probs / n


def point_predict(logits_fn: Callable, params, batch,
                  node_axis: Optional[int] = None) -> torch.Tensor:
    """Frequentist prediction (the CF-FL baseline): one model's softmax, or
    the mean over the node axis of ``(K, ...)`` params."""
    if node_axis is None:
        params = tree_map(lambda a: a[None], params)
    return torch.softmax(logits_fn(params, batch).float(),
                         dim=-1).mean(dim=0)
