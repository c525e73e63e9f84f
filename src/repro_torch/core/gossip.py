"""Gossip communicators: how Ω-mixing executes (``repro/core/gossip.py``).

* :func:`dense_mix` — ``einsum`` with the full Ω, the oracle for any graph.
* :func:`schedule_mix` — a :class:`~repro_torch.core.topology.MixSchedule`:
  ``Ω x = x + Σ_m w_m ⊙ (x[perm_m] − x)`` over the graph's edge matchings;
  a circulant Ω (ring, k-regular) takes the roll path ``Σ_s c_s·roll(x,
  −s)``. With per-round ``(M, K)`` masks the schedule is time-varying: link
  dropout and gossip-pair sampling, still symmetric doubly stochastic per
  realization.
* :func:`make_mixer` — the lowering :func:`plan_mixer` picks for Ω, as the
  reference's ``make_mixer`` runs it: identity, dense, roll or schedule.

Both sparse paths, and the back-compat :func:`ring_mix`, run the
gossip_mix kernel, one launch over the tree's leaves (its plain version on
the CPU): XLA's CPU code contracts each matching's ``out + w·(x[perm] −
x)`` and each shift's ``+ c·roll(x, −s)`` into an fma (ROADMAP C16), so
the port's chain of single-rounding fmas is bit-exact to the jitted
reference mixer. The masks are drawn as a :func:`random.program`
(:func:`matching_masks`), so a round draws them beside its other draws and
they never leave the device.

Barrier-free rounds (``gossip.py:93-118``, ``:635-702``): a per-node
participation vector ``node_mask`` reaches every lowering, the dense one
as the stale-weighted :func:`participation_omega`, the schedule ones (the
roll lowering too, as the reference's) as the Laplacian form with the
edge mask ``p_k·p_perm(k)`` on the weights; :class:`ParticipationSchedule`
draws the vector from the round key and the round index. The transport's
SNR outage (``link_probs``) composes with the config's link dropout into
per-edge probabilities (:func:`_tv_probs`). The shard mixers are ROADMAP
A10.
"""
from __future__ import annotations

import inspect
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import random
from repro_torch.config import TopologyConfig
from repro_torch.core.topology import MixSchedule, build_schedule
from repro_torch.kernels.fused_update import (CIRCULANT, LAPLACIAN, RING,
                                              gossip_mix)
from repro_torch.models.layers import f32_sums
from repro_torch.utils.device import device_const
from repro_torch.utils.tree import tree_leaves, tree_map


def dense_mix(omega: torch.Tensor, tree):
    """``einsum("kj,j...->k...", Ω, delta)`` leafwise, in full f32 whatever
    the process allows (``f32_sums``: no TF32 on the card, ROADMAP C40)."""
    with f32_sums():
        return tree_map(
            lambda d: torch.einsum("kj,j...->k...", omega,
                                   d.float()).to(d.dtype), tree)


class _Terms:
    """A lowering's ``(M, K)`` source rows and weights on the device, in a
    form of the gossip_mix kernel: the matchings' perms and weights
    (Laplacian), the shifts' rows ``(k + s) mod K`` and coefficients after
    the shift-0 one (circulant), or the ring's rows ``k ∓ 1`` (ring)."""

    def __init__(self, src: np.ndarray, w: np.ndarray, device, form: str,
                 c0: float = 0.0):
        self.src = torch.as_tensor(np.asarray(src, np.int32), device=device)
        self.w = torch.as_tensor(np.asarray(w, np.float32), device=device)
        self.form = form
        self.c0 = c0

    def mix(self, tree, w: Optional[torch.Tensor] = None):
        """Every leaf of ``tree`` in one gossip_mix call, each cast to f32
        and back."""
        w = self.w if w is None else w
        leaves = []
        tree_map(leaves.append, tree)           # tree_map's order, twice
        mixed = iter(gossip_mix([d.float().contiguous() for d in leaves],
                                self.src, w, self.c0, self.form))
        return tree_map(lambda d: next(mixed).to(d.dtype), tree)


def _roll_terms(schedule: MixSchedule, device) -> _Terms:
    """``_roll_mix``'s ``Σ_s c_s·roll(x, −s)``: row k of ``roll(x, −s)`` is
    row ``(k + s) mod K`` of x."""
    k = schedule.k
    rows = np.arange(k)
    pairs = [(s, c) for s, c in zip(schedule.shifts, schedule.coeffs)
             if s != 0]
    c0 = dict(zip(schedule.shifts, schedule.coeffs)).get(0, 0.0)
    src = np.array([(rows + s) % k for s, _ in pairs]).reshape(-1, k)
    w = np.array([np.full(k, c, np.float32) for _, c in pairs]).reshape(-1, k)
    return _Terms(src, w, device, CIRCULANT, c0=c0)


def ring_mix(omega: np.ndarray, tree):
    """The circulant ring by rolls (the reference's back-compat alias):
    ``ω₀₀·x + ω₀₁·(roll(x, 1) + roll(x, −1))``, which XLA contracts into
    ``fma(ω₀₀, x, ω₀₁·(roll(x, 1) + roll(x, −1)))`` (the first product,
    where ``_roll_mix``'s sums fuse the later ones: ROADMAP C16), the
    gossip_mix kernel's ring form; dense below K = 3. On the leaves'
    device; not on the port's main path."""
    k = omega.shape[0]
    leaves = tree_leaves(tree)
    device = leaves[0].device if leaves else "cpu"
    if k < 3:
        return dense_mix(torch.as_tensor(np.asarray(omega, np.float32),
                                         device=device), tree)
    rows = np.arange(k)
    side = np.full((2, k), omega[0, 1], np.float32)
    return _Terms(np.stack([(rows - 1) % k, (rows + 1) % k]), side, device,
                  RING, c0=float(np.float32(omega[0, 0]))).mix(tree)


def participation_omega(omega, node_mask) -> torch.Tensor:
    """The stale-weighted Ω of a participation vector (``gossip.py:93-108``):
    ``off = Ω·(p pᵀ)·(1 − I)``, the diagonal ``1 − Σ_j off`` summed in
    column order, as XLA's CPU code sums the reference's rows."""
    om = torch.as_tensor(omega, dtype=torch.float32, device=node_mask.device)
    p = node_mask.float()
    k = om.shape[0]
    eye = torch.eye(k, dtype=torch.float32, device=om.device)
    off = om * (p[:, None] * p[None, :]) * (1.0 - eye)
    row = off[:, 0]
    for j in range(1, k):
        row = row + off[:, j]
    return off + torch.diag(1.0 - row)


def participation_edge_mask(perms: torch.Tensor, node_mask) -> torch.Tensor:
    """``(M, K)`` survival of matching edge (k, perm_m[k]): both endpoints
    participate (``gossip.py:111-118``)."""
    p = node_mask.float()
    return p[None, :] * p[perms]


def _p_active(link_failure_prob) -> bool:
    """Does this dropout probability ever fire (a host-side check)?"""
    return bool(np.any(np.asarray(link_failure_prob, np.float64) > 0.0))


class _MaskPlan:
    """The device tensors of a schedule's mask draws: the perms and the
    dropout probability, made once, so a captured round copies nothing to
    the device."""

    def __init__(self, schedule: MixSchedule, link_failure_prob,
                 gossip_pairs: int, device):
        self.m, self.k = schedule.perms.shape
        self.drop = _p_active(link_failure_prob)
        self.pairs = int(gossip_pairs)
        self.sample = 0 < self.pairs < self.m
        self.perms = torch.as_tensor(schedule.perms, dtype=torch.int64,
                                     device=device)
        self.p = torch.as_tensor(np.asarray(link_failure_prob, np.float32),
                                 device=device)

    @random.program
    def masks(self, key: torch.Tensor):
        """``_matching_masks`` (``gossip.py:121-155``): the round's ``(M,
        K)`` f32 activation mask, symmetric per edge, from ``key`` (the
        round's ``kmix``). ``kdrop, kpair = split(key)``; link dropout keeps
        edge (i, j) of matching m when ``mod(u_i + u_j, 1) >= p``, ``u =
        uniform(kdrop, (M, K))``; gossip-pair sampling keeps the
        ``gossip_pairs`` matchings ``choice(kpair, M, (pairs,),
        replace=False)``. Exact: the coin's sum of two f32 uniforms below 2
        and its ``fmod`` by 1 round the same way on both sides."""
        pair = yield from random.split.program(key)
        kdrop, kpair = pair[0], pair[1]
        progs = []
        if self.drop:
            progs.append(random.uniform.program(kdrop, (self.m, self.k)))
        if self.sample:
            progs.append(random.choice.program(kpair, self.m, (self.pairs,),
                                               replace=False))
        got = list((yield from random.together(*progs)))
        mask = torch.ones((self.m, self.k), dtype=torch.float32,
                          device=key.device)
        if self.drop:
            u = got.pop(0)
            coin = torch.fmod(u + torch.gather(u, 1, self.perms), 1.0)
            mask = mask * (coin >= self.p).float()
        if self.sample:
            sel = torch.zeros((self.m,), dtype=torch.float32,
                              device=key.device)
            mask = mask * sel.index_fill(0, got.pop(0), 1.0)[:, None]
        return mask


def matching_masks(schedule: MixSchedule, key: torch.Tensor,
                   link_failure_prob, gossip_pairs: int) -> torch.Tensor:
    """The reference's ``_matching_masks(schedule, key, p, pairs)``: the
    ``(M, K)`` mask of one round (see :meth:`_MaskPlan.masks`)."""
    return _MaskPlan(schedule, link_failure_prob, gossip_pairs,
                     key.device).masks(key)


def schedule_mix(schedule: MixSchedule, tree, key=None, *,
                 link_failure_prob=0.0, gossip_pairs: int = 0,
                 node_mask=None):
    """Sparse Ω-mixing as a sum of matching permutations (Laplacian form),
    ``x + Σ_m mask_m·w_m·(x[perm_m] − x)``; without a key (or with both
    knobs at 0) exactly Ω x, by rolls when Ω is circulant. Builds its
    device tensors on every call: :func:`make_mixer` builds them once."""
    m = schedule.num_perms
    if m == 0:
        return tree
    device = tree_leaves(tree)[0].device
    time_varying = key is not None and (_p_active(link_failure_prob)
                                        or 0 < gossip_pairs < m)
    if node_mask is None and not time_varying and schedule.shifts is not None:
        return _roll_terms(schedule, device).mix(tree)
    terms = _Terms(schedule.perms, schedule.weights, device, LAPLACIAN)
    w = terms.w
    if time_varying:
        w = w * matching_masks(schedule, key, link_failure_prob, gossip_pairs)
    if node_mask is not None:
        w = w * participation_edge_mask(torch.as_tensor(
            schedule.perms, dtype=torch.int64, device=device), node_mask)
    return terms.mix(tree, w)


def plan_mixer(omega: np.ndarray, config: Optional[TopologyConfig] = None,
               use_ring: bool = True, force_tv: bool = False):
    """The lowering for Ω, ``(mode, schedule)``, as the reference decides it
    (``gossip.py:200-235``): ``"identity"`` (K = 1), ``"dense"`` (deg ≥ K −
    1 or K ≤ 2), ``"schedule"`` (the static sparse mixer) or
    ``"schedule_tv"`` (per-round masks from the config's
    ``link_failure_prob`` / ``gossip_pairs``)."""
    om = np.asarray(omega, np.float64)
    k = om.shape[0]
    p_drop = float(config.link_failure_prob) if config is not None else 0.0
    pairs = int(config.gossip_pairs) if config is not None else 0
    if k == 1:
        return "identity", None
    adj = (np.abs(om) > 1e-12) & ~np.eye(k, dtype=bool)
    max_deg = int(adj.sum(axis=1).max())
    if (p_drop == 0.0 and pairs == 0 and not force_tv
            and (k <= 2 or max_deg >= k - 1)):
        return "dense", None
    schedule = build_schedule(om)
    if schedule.num_perms == 0:
        return "dense", schedule
    if p_drop > 0.0 or force_tv or 0 < pairs < schedule.num_perms:
        return "schedule_tv", schedule
    if k <= 2 or schedule.num_perms >= k - 1 or not use_ring:
        return "dense", schedule
    return "schedule", schedule


def _tv_probs(schedule: MixSchedule, config: Optional[TopologyConfig],
              link_probs: Optional[Callable]):
    """The dropout probability of a time-varying mixer
    (``gossip.py:238-255``): the config's scalar ``p1``, composed with the
    transport's per-edge outage ``p2 = link_probs(schedule)`` (M, K) as
    ``1 − (1 − p1)(1 − p2)`` in float64, then f32."""
    p_cfg = float(config.link_failure_prob) if config is not None else 0.0
    if link_probs is None:
        return p_cfg
    p_link = np.asarray(link_probs(schedule), np.float64)
    if p_link.shape != schedule.perms.shape:
        raise ValueError(f"link_probs returned shape {p_link.shape}, "
                         f"schedule needs {schedule.perms.shape}")
    return np.asarray(1.0 - (1.0 - p_cfg) * (1.0 - p_link), np.float32)


def make_mixer(omega: np.ndarray, device="cuda",
               config: Optional[TopologyConfig] = None,
               use_ring: bool = True,
               link_probs: Optional[Callable] = None) -> Callable:
    """``mix(tree, key=None, node_mask=None, *, masks=None)`` for any graph
    (leaves lead with K), executing :func:`plan_mixer`'s lowering. A
    time-varying mixer draws its masks from ``key`` (the round's ``kmix``),
    or takes them drawn already as ``masks`` (``mix.masks(kmix)``, a
    program, so a round draws them with its other draws); without either it
    mixes the static Ω, as the reference's does without a key.
    ``node_mask`` (K,) is the round's participation vector: the dense
    lowering mixes :func:`participation_omega`, every schedule lowering
    the Laplacian form with the edge mask on its weights. ``link_probs``
    (the transport's SNR outage) forces the time-varying schedule.

    The mixer carries its plan: ``mix.mode``, ``mix.schedule`` and
    ``mix.masks`` (None unless time-varying)."""
    om = np.asarray(omega, np.float64)
    mode, schedule = plan_mixer(om, config, use_ring,
                                force_tv=link_probs is not None)
    masks = None

    if mode == "identity":
        def mix(tree, key=None, node_mask=None, *, masks=None):
            return tree
    elif mode == "dense":
        om_t = torch.as_tensor(np.asarray(om, np.float32), device=device)

        def mix(tree, key=None, node_mask=None, *, masks=None):
            if node_mask is None:
                return dense_mix(om_t, tree)
            return dense_mix(participation_omega(om_t, node_mask), tree)
    else:
        static = (_roll_terms(schedule, device) if schedule.shifts
                  is not None else _Terms(schedule.perms, schedule.weights,
                                          device, LAPLACIAN))
        laplace = _Terms(schedule.perms, schedule.weights, device, LAPLACIAN)
        perms = torch.as_tensor(schedule.perms, dtype=torch.int64,
                                device=device)
        tv = mode == "schedule_tv"
        if tv:
            p_drop = _tv_probs(schedule, config, link_probs)
            pairs = int(config.gossip_pairs) if config is not None else 0
            masks = _MaskPlan(schedule, p_drop, pairs, device).masks

        def mix(tree, key=None, node_mask=None, *, masks=None):
            if tv and masks is None and key is not None:
                masks = mix.masks(key)
            if not tv:
                masks = None
            if masks is None and node_mask is None:
                return static.mix(tree)
            w = laplace.w
            if masks is not None:
                w = w * masks
            if node_mask is not None:
                w = w * participation_edge_mask(perms, node_mask)
            return laplace.mix(tree, w)
    mix.mode, mix.schedule, mix.masks = mode, schedule, masks
    return mix


def _unported_a10(name: str) -> Callable:
    """A callable standing for a name of the reference's SPMD shard path,
    which raises naming ROADMAP A10."""
    def unported(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet; ROADMAP A10 (multi-GPU shard "
            f"engine)")
    unported.__name__ = unported.__qualname__ = name
    return unported


# the reference's shard mixer (gossip.py:369-600): ppermute over a mesh
ShardContext = _unported_a10("ShardContext")
ShardMixStats = _unported_a10("ShardMixStats")
make_shard_mixer = _unported_a10("make_shard_mixer")
plan_shard_mix = _unported_a10("plan_shard_mix")


def as_keyed_mixer(mixer: Callable) -> Callable:
    """Adapt a legacy ``mix(tree)`` / ``mix(tree, key)`` callable to the
    ``mix(tree, key, node_mask)`` convention (``gossip.py:603-633``); a
    participation mask handed to a legacy mixer is an error."""
    try:
        params = inspect.signature(mixer).parameters
        n = len([p for p in params.values()
                 if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                               p.VAR_POSITIONAL)])
        if any(p.kind == p.VAR_POSITIONAL for p in params.values()):
            n = 3
    except (TypeError, ValueError):
        n = 3
    if n >= 3:
        return mixer

    def adapted(tree, key=None, node_mask=None):
        if node_mask is not None:
            raise ValueError(
                "this mixer predates participation masks; build it with "
                "make_mixer to run barrier-free rounds")
        return mixer(tree, key) if n >= 2 else mixer(tree)

    return adapted


# --------------------------------------------------------------------------
# Barrier-free rounds: per-node participation (gossip.py:635-702)
# --------------------------------------------------------------------------

# the salt folding the round key into the straggler stream (gossip.py:50)
PARTICIPATION_SALT = 11


class ParticipationSchedule:
    """Per-round node participation: stragglers skip a round with
    ``straggler_prob`` (``u < p`` on ``uniform(fold_in(key, 11), (K,))``),
    restricted to ``cfg.stragglers`` when that is non-empty; ``cfg.dead``
    entries ``(node, die, rejoin)`` take the node out for rounds ``die <=
    t < rejoin`` (``rejoin < 0``: for good). The uniforms are a draw
    program of the round key (:meth:`draws`); :meth:`mask` combines them
    with the round index, a device int tensor inside a captured chunk."""

    def __init__(self, cfg, num_nodes: int):
        self.cfg = cfg
        self.num_nodes = int(num_nodes)
        elig = np.ones(self.num_nodes, np.float32)
        if cfg.stragglers:
            elig = np.zeros(self.num_nodes, np.float32)
            for n in cfg.stragglers:
                if not 0 <= int(n) < self.num_nodes:
                    raise ValueError(f"straggler node {n} outside "
                                     f"0..{self.num_nodes - 1}")
                elig[int(n)] = 1.0
        for (n, die, rejoin) in cfg.dead:
            if not 0 <= int(n) < self.num_nodes:
                raise ValueError(f"dead node {n} outside "
                                 f"0..{self.num_nodes - 1}")
            if int(rejoin) >= 0 and int(rejoin) <= int(die):
                raise ValueError(f"node {n}: rejoin round {rejoin} not "
                                 f"after death round {die}")
        self._eligible = elig

    @property
    def active(self) -> bool:
        return bool(self.cfg.active)

    @random.program
    def draws(self, key: torch.Tensor):
        """The straggler uniforms of the round keyed ``key`` (None without
        stragglers): ``fold_in(key, 11)``, then ``(K,)`` uniforms."""
        if float(self.cfg.straggler_prob) <= 0.0:
            return None
        kp = yield from random.fold_in.program(key, PARTICIPATION_SALT)
        return (yield from random.uniform.program(kp, (self.num_nodes,)))

    def mask(self, u, round_idx, device) -> torch.Tensor:
        """The (K,) f32 {0,1} participation vector of round ``round_idx``
        (an int, or a device int tensor), ``u`` :meth:`draws`' uniforms."""
        p = torch.ones((self.num_nodes,), dtype=torch.float32, device=device)
        if u is not None:
            elig = device_const(("eligible", self._eligible.tobytes()),
                                device, lambda: self._eligible)
            straggle = (u < float(np.float32(self.cfg.straggler_prob))
                        ).float() * elig
            p = p * (1.0 - straggle)
        for (n, die, rejoin) in self.cfg.dead:
            onehot = np.zeros(self.num_nodes, np.float32)
            onehot[int(n)] = 1.0
            hot = device_const(("onehot", onehot.tobytes()), device,
                               lambda: onehot)
            if torch.is_tensor(round_idx):
                dead_now = round_idx >= int(die)
                if int(rejoin) >= 0:
                    dead_now = dead_now & (round_idx < int(rejoin))
                dead_now = dead_now.float()
            else:
                dead_now = float(int(die) <= int(round_idx) and (
                    int(rejoin) < 0 or int(round_idx) < int(rejoin)))
            p = p * (1.0 - hot * dead_now)
        return p


def resolve_participation(fed_cfg) -> Optional[ParticipationSchedule]:
    """The schedule of ``fed_cfg.participation`` (None, or inactive: every
    node in every round)."""
    pcfg = getattr(fed_cfg, "participation", None)
    if pcfg is None or not pcfg.active:
        return None
    return ParticipationSchedule(pcfg, num_nodes=fed_cfg.num_nodes)
