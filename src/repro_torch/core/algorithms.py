"""The round functions (``repro/core/algorithms.py``): CD-BFL, the paper's
Algorithm 1, and its two baselines, DSGLD and CF-FL; and the centralized
SGLD step.

Counterparts of ``make_cdbfl_round`` (reference lines 335-453),
``make_dsgld_round`` (:460-553), ``make_cffl_round`` (:560-635),
``make_sgld_step`` (:642-672) and ``make_round_fn`` (:675-694), on one
device. Every leaf leads with the node axis K, and the K nodes run batched
(grouped convolutions, batched matmuls), not in a Python loop.

``round_fn(state, batches, key)`` takes the reference's round key and
draws as the reference's round does (``algorithms.py:374-381``): ``kql,
knoise = split(key)``; node k's Langevin noise for leaf i from
``split(fold_in(knoise, k), n_leaves)[i]``, scaled by √(2ηT); node k's
QSGD uniforms from ``fold_in(kql, k)`` (:func:`draw_uniforms`). The draws
cost three table launches of the threefry kernel (the split, the node
keys, the leaf keys) and one for the draws themselves; ``round_fn.draws``
is that derivation as a program, so the engine can run it beside the
minibatch sampling's (``draws=`` then hands the result in). The mixer is
the reference's default, ``make_mixer(Ω, config=resolve_topology(fed_cfg))``
(``algorithms.py:60-65``). On a time-varying graph the round also derives
``kmix = fold_in(key, 2)``, as ``split(key, 3)[2]`` in the same launch, and
draws the mixer's ``(M, K)`` masks from it beside the other draws
(``round_fn.draws`` then returns ``(draws, masks)``); a static graph draws
nothing more.

The loss is either a node-batched ``nll_fn(params, batch) -> (K,)`` over a
dict of ``(K, L, M, ...)`` batches (the model's, LeNet's fast path: one
grouped forward and one backward a step for all K nodes), or the
reference's per-node ``loss_fn(params, batch, key) -> (nll, aux)`` over
any tree of ``(K, L, ...)`` batches (a dict, a tuple, a tensor), told
apart by their positional arity as ``as_keyed_mixer`` tells mixers apart.
A per-node loss runs K calls a step, one backward of their sum, and
receives the reference's per-node key stream (``algorithms.py:102-116``,
``:381-383``): node k's key ``fold_in(state.key[k], state.round)``, split
once a step, the second half handed to the loss. The node-batched path
reads no key, so its rounds derive none.

With ``control_dtype="bfloat16"`` the stored v and v̄ are bf16; the
codec's kernels read them as they are, and Eqs. 7–9 run as one launch a
leaf (``fused_update_control``, ``cffl_update_control``) that takes the
round's f32 deltas: Eq. 9 reads the f32 sums and the new v, v̄ are those
sums rounded to bf16, as the reference's jitted round executes them on the
CPU (ROADMAP C23). With ``"float16"`` the same launches' f16 forms round
the sums to f16 and Eq. 9 reads the rounded sums (C32).

DSGLD draws ``knoise, kmix = split(key)`` and its noise from ``knoise``,
its masks from ``kmix``; CF-FL keys its codec by ``kq, _ = split(key)``,
CD-BFL's codec stream, and its masks by ``kmix = fold_in(key, 2)``. Their
updates are the fused_update kernel's two variants (ROADMAP C10).

A lossy transport (``fed_cfg.transport`` or ``transport=``) masks the
decoded delta frame by frame (``algorithms.py:187-238``): its keep masks
are drawn from ``fold_in(kql, TRANSPORT_SALT)`` beside the round's other
draws (three key levels, then the loss model's), the neighbors mix the
delivered delta, and under error feedback ``v`` absorbs only that; its
SNR outage joins the mixer's dropout. A participation model
(``fed_cfg.participation``) draws its stragglers from ``fold_in(key,
11)`` and reads its death timelines off ``state.round`` (a device int
tensor on both engines): the mixer drops the absent nodes' edges, and a
node that sits the round out keeps its params, v and v̄ (the freeze,
``:269-277``). Both add their columns to :class:`RoundMetrics`, means
over the nodes as the reference reduces them.
"""
from __future__ import annotations

import inspect
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.compression import draw_uniforms
from repro_torch.core.fed_state import FedState
from repro_torch.core.gossip import make_mixer, resolve_participation
from repro_torch.core.topology import resolve_topology
from repro_torch.core.transport import (TransportMetrics, resolve_transport,
                                        sum_nodes)
from repro_torch.kernels import ops as kops
from repro_torch.kernels._build import CONTROL_DTYPES
from repro_torch.kernels.fused_update import (cffl_update_control,
                                              fused_update_control)
from repro_torch.models.layers import f32_sums
from repro_torch.utils.tree import (tree_count, tree_leaves,
                                    tree_leaves_with_path, tree_map,
                                    tree_unflatten)


class RoundMetrics(NamedTuple):
    loss: torch.Tensor             # (K, L) local objective per step
    consensus_error: torch.Tensor  # scalar: mean ||θ_k - θ̄||²
    delta_norm: torch.Tensor       # scalar: mean ||Δθ_k||²
    wire_bytes: float              # bytes/node/round: the payload's, or
                                   # the legacy Compressor's closed form
    payload: Any = None            # the round's WirePayload (Eq. 6); None
                                   # for the legacy dense Compressor
    # the transport's accounting, means over nodes (0 without a transport):
    # f32 scalar tensors, or Python floats where static
    offered_bytes: Any = 0.0       # on-air bytes offered, headers and
                                   # ARQ re-sends included
    delivered_bytes: Any = 0.0     # bytes whose frames survived
    airtime_s: Any = 0.0           # TX airtime (LoRa ToA under cfg.toa)
    energy_j: Any = 0.0            # TX energy at tx_power
    retransmits: Any = 0.0         # ARQ frame re-sends
    abandoned_bytes: Any = 0.0     # bytes never delivered after every
                                   # ARQ attempt
    participation: Any = 1.0       # (K,) {0,1} vector of the round; 1.0
                                   # without a participation model


def per_node_loss(fn) -> bool:
    """True for the reference's ``loss_fn(params, batch, key)`` (three or
    more positional parameters), False for a node-batched ``nll_fn(params,
    batch)``."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return True
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return True
    return len([p for p in params if p.kind in (
        p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]) >= 3


def _map_batch(fn, tree):
    """``fn`` over every tensor of a batch tree (dicts, tuples, lists)."""
    if isinstance(tree, dict):
        return {k: _map_batch(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_batch(fn, v) for v in tree)
    return fn(tree)


def _objective(nll, leaves, prior_weight: float, data_scale: float):
    prior = sum(x.float().square().flatten(1).sum(1) for x in leaves)
    return data_scale * nll + 0.5 * prior_weight * prior


def _value_and_grad(nll_fn, paths, leaves, batch, prior_weight: float,
                    data_scale: float, keys=None):
    """``(f (K,), grads)`` of ``data_scale·NLL + ½·prior_weight·Σθ²`` on
    every node. Node k's objective depends on node k's params only, so one
    backward of the sum gives every node's gradient. With ``keys`` (K, 2),
    ``nll_fn`` is a per-node ``loss_fn(params, batch, key)``, called once a
    node on its slices. The forward and the backward both run inside
    ``f32_sums``: the backward's matrix products sum in full f32 as XLA
    sums the reference's, whatever the process set (torch's default lets
    cuBLAS reduce bf16 products in reduced precision)."""
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad(), f32_sums():
        if keys is None:
            nll = nll_fn(tree_unflatten(paths, leaves), batch)        # (K,)
        else:
            nll = torch.stack([torch.as_tensor(nll_fn(
                tree_unflatten(paths, [x[k] for x in leaves]),
                _map_batch(lambda b: b[k], batch), keys[k])[0],
                dtype=torch.float32) for k in range(keys.shape[0])])
        f = _objective(nll, leaves, prior_weight, data_scale)
        grads = torch.autograd.grad(f.sum(), leaves)
    return f.detach(), grads


def node_keys(state) -> torch.Tensor:
    """The round's per-node keys ``fold_in(state.key[k], state.round)``
    (``algorithms.py:381-383``). The engines' round index is a device int32
    that the draw reads on the device: nothing syncs, and a captured round
    folds each replay's own index."""
    return random.fold_in(state.key, state.round)


def _local_sgd(nll_fn, params, batches, eta: float, prior_weight: float,
               data_scale: float, num_steps: int, keys=None):
    """L plain SGD steps on every node (paper Eq. 5) on
    ``data_scale·NLL + ½·prior_weight·Σθ²``; with ``keys`` (a per-node
    loss), ``keys, ksub = split(keys)`` each step and the loss gets
    ``ksub`` (``algorithms.py:102-116``)."""
    paths = [p for p, _ in tree_leaves_with_path(params)]
    leaves = tree_leaves(params)
    losses = []
    for step in range(num_steps):
        batch = _map_batch(lambda b: b[:, step], batches)
        ksub = None
        if keys is not None:
            pair = random.split(keys)
            keys, ksub = pair[:, 0], pair[:, 1]
        f, grads = _value_and_grad(nll_fn, paths, leaves, batch,
                                   prior_weight, data_scale, ksub)
        losses.append(f)
        leaves = [x.detach() - eta * g.to(x.dtype) for x, g in zip(leaves, grads)]
    return tree_unflatten(paths, leaves), torch.stack(losses, dim=1)


def _control_update(theta_l, state, delta_v, mixed, zeta: float, noise=None):
    """Eqs. 7–9: ``(params, v, v̄)`` after the round. f32 control variates
    take the adds in torch and Eq. 9's kernel (fused_update, or
    cffl_update without ``noise``); bf16 and f16 ones the one launch a
    leaf of ``fused_update_control`` / ``cffl_update_control`` (ROADMAP
    C23, C32)."""
    if tree_leaves(state.v)[0].dtype in CONTROL_DTYPES:
        if noise is None:
            outs = tree_map(lambda t_, vb, v, m, d: cffl_update_control(
                t_, vb, v, m, d, zeta), theta_l, state.v_bar, state.v, mixed,
                delta_v)
        else:
            outs = tree_map(lambda t_, vb, v, m, d, n: fused_update_control(
                                t_, vb, v, m, d, n, zeta, 1.0),
                            theta_l, state.v_bar, state.v, mixed, delta_v,
                            noise)
        return tuple(tree_map(lambda o: o[i], outs) for i in (0, 2, 1))
    v_new = tree_map(lambda v, d: v + d.to(v.dtype), state.v, delta_v)
    v_bar_new = tree_map(lambda vb, m: vb + m.to(vb.dtype), state.v_bar,
                         mixed)
    if noise is None:
        params_new = tree_map(
            lambda t_, vb, v: kops.leaf_cffl_update(t_, vb, v, zeta),
            theta_l, v_bar_new, v_new)
    else:
        # Eq. 9, noise pre-scaled: s = 1
        params_new = tree_map(
            lambda t_, vb, v, n: kops.leaf_fused_update(t_, vb, v, n, zeta,
                                                        1.0),
            theta_l, v_bar_new, v_new, noise)
    return params_new, v_new, v_bar_new


def langevin_scale(eta: float, temperature: float) -> float:
    """``jnp.sqrt(2.0 * eta * temperature)``: the product in float64, its
    square root in f32 (``algorithms.py:139``)."""
    return float(np.sqrt(np.float32(2.0 * eta * temperature)))


@random.program
def langevin_noise(key: torch.Tensor, like, eta: float, temperature: float):
    """N(0, 2ηT) f32 noise shaped like the node-stacked tree ``like``
    (``algorithms.py:133-143``): node k draws from ``fold_in(key, k)``,
    its leaf i from ``split(node_key, n_leaves)[i]``
    (``utils/tree.py:70-83``), ``scale · normal``."""
    items = tree_leaves_with_path(like)
    node_keys = yield from random.split.program(key, items[0][1].shape[0])
    leaf_keys = yield from random.split.program(node_keys, len(items))
    scale = langevin_scale(eta, temperature)
    drawn = yield from random.together(*(
        random.normal.program(leaf_keys[:, i], x.shape[1:], scale=scale)
        for i, (_, x) in enumerate(items)))
    return tree_unflatten([p for p, _ in items], drawn)


def _consensus_error(params) -> torch.Tensor:
    return sum(((x.float() - x.float().mean(dim=0, keepdim=True)) ** 2).sum()
               for x in tree_leaves(params))


def _sq_norm(tree) -> torch.Tensor:
    return sum((x.float() ** 2).sum() for x in tree_leaves(tree))


def _compress_exchange(compressor, theta, v, uniforms, transport=None,
                       keeps=None):
    """Q over the residual ``theta - v`` of every node: ``(delta_v, delta,
    wire bytes per node, payload, tx)``. A pipeline encodes the pair (a
    :class:`FusedCodec` never materializes the residual) into a measured
    :class:`WirePayload` and decodes it; the legacy dense
    :class:`Compressor` is applied to the materialized residual, and its
    bytes are the closed-form table on one node's tree
    (``algorithms.py:187-238`` of the reference). With a transport, the
    decoded delta is masked by the frames' ``keeps``: ``delta`` is the
    delivered delta, ``delta_v`` what the sender's control sequence
    absorbs (the delivered one under error feedback, else the full
    decode), ``tx`` the per-node :class:`TransportMetrics`."""
    if hasattr(compressor, "encode_pair"):
        payload = compressor.encode_pair(theta, v, uniforms)
        num_nodes = tree_leaves(theta)[0].shape[0]
        wire = payload.measured_bytes() / num_nodes
        if transport is None:
            delta = compressor.decode(payload)
            return delta, delta, wire, payload, None
        full, delivered, tx = transport.deliver(compressor, payload, keeps)
        return (delivered if transport.error_feedback else full, delivered,
                wire, payload, tx)
    residual = tree_map(lambda t, vv: t - vv.to(t.dtype), theta, v)
    wire = compressor.wire_bytes(tree_map(lambda x: x[0], residual))
    delta = compressor(residual, uniforms)
    return delta, delta, float(wire), None, None


def _inverse(num_nodes: int) -> float:
    """``fl32(1/K)``: XLA's CPU code divides by the constant K as a product
    with its f32 reciprocal."""
    return float(np.float32(1.0) / np.float32(num_nodes))


def _reduce_transport(tx, num_nodes: int) -> TransportMetrics:
    """Means over the nodes of the per-node metrics (``algorithms.py:
    241-258``): each summed in node order and times ``fl32(1/K)``, as XLA's
    CPU code computes the reference's ``sum / K``. A static value (every
    node's the same) is a Python float, reduced on the host alike."""
    if tx is None:
        return TransportMetrics.zero()
    inv = _inverse(num_nodes)

    def mean(x):
        if torch.is_tensor(x):
            return sum_nodes(x) * inv
        acc = np.float32(x)
        for _ in range(num_nodes - 1):
            acc = np.float32(acc + np.float32(x))
        return float(np.float32(acc * np.float32(inv)))
    return TransportMetrics(*(mean(f) for f in tx))


def _mask_transport(tx, p):
    """A node that sits the round out transmits nothing: its rows of the
    per-node metrics zeroed (``algorithms.py:261-266``)."""
    if tx is None or p is None:
        return tx
    return TransportMetrics(*(f * p for f in tx))


def _participation_freeze(p, new_tree, old_tree):
    """Barrier-free rounds (``algorithms.py:269-277``): a node that skipped
    the round keeps its old state."""
    def leaf(n, o):
        m = p.reshape((p.shape[0],) + (1,) * (n.dim() - 1))
        return torch.where(m > 0.5, n, o.to(n.dtype))
    return tree_map(leaf, new_tree, old_tree)


def _check_transport(transport, compressor) -> None:
    """Frame-level loss needs the materialized wire format
    (``algorithms.py:280-287``)."""
    if (transport is not None and transport.lossy
            and not hasattr(compressor, "encode")):
        raise ValueError(
            "frame-level transport loss requires a codec pipeline "
            "(CompressionPipeline); the legacy dense-masked Compressor has "
            "no wire payload to fragment — use fed_cfg.pipeline")


def _round_metrics(txm: TransportMetrics, p_full, **kw) -> RoundMetrics:
    return RoundMetrics(
        offered_bytes=txm.offered, delivered_bytes=txm.delivered,
        airtime_s=txm.airtime_s, energy_j=txm.energy_j,
        retransmits=txm.retransmits, abandoned_bytes=txm.abandoned,
        participation=p_full if p_full is not None else 1.0, **kw)


def _default_mixer(omega, fed_cfg, device, transport=None):
    """The reference's default mixer (``algorithms.py:52-65``): the
    lowering ``plan_mixer`` picks for Ω under the run's TopologyConfig,
    with the transport's SNR outage as ``link_probs`` when it models
    one. ``device=None``: a :class:`_DeviceMixer`."""
    link_probs = (transport.outage_probs if transport is not None
                  and transport.has_link_outage else None)

    def build(dev):
        return make_mixer(omega, dev, config=resolve_topology(fed_cfg),
                          link_probs=link_probs)
    return _DeviceMixer(build) if device is None else build(device)


class _DeviceMixer:
    """A mixer whose constants are made for the device of what it is given
    (the tree it mixes, the key its masks come from), once a device: a
    round built without ``device=`` follows its caller's tensors."""

    def __init__(self, build):
        self._build, self._built = build, {}
        plan = build("meta")
        self.mode, self.schedule = plan.mode, plan.schedule
        self.masks = None if plan.masks is None else self._masks

    def on(self, device):
        key = str(device)
        if key not in self._built:
            self._built[key] = self._build(device)
        return self._built[key]

    def __call__(self, tree, key=None, node_mask=None, *, masks=None):
        return self.on(tree_leaves(tree)[0].device)(
            tree, key, node_mask, masks=masks)

    @random.program
    def _masks(self, key: torch.Tensor):
        return (yield from self.on(key.device).masks.program(key))


class _Draws(NamedTuple):
    """A round's draws when a transport or a participation model draws
    too: the codec's and the noise's (``base``), the mixer's masks, the
    frames' keep masks and the straggler uniforms."""
    base: Any
    masks: Any
    keeps: Any = None
    straggle: Any = None


def _with_masks(mix, key: torch.Tensor, num: int, draw, extra=()):
    """A round's draws program: ``split(key, num)`` (one more key, ``kmix
    = fold_in(key, num)``, when the mixer is time-varying), then
    ``draw(keys)``'s programs and the masks side by side; the ``extra``
    programs of ``key`` itself (the transport's keeps, the stragglers) run
    beside them from the first level on. Returns the draws, ``(draws,
    masks)`` on a time-varying graph, or a :class:`_Draws` when ``extra``
    is given."""
    tv = mix.masks is not None

    def core():
        keys = yield from random.split.program(key, num + tv)
        progs = draw(keys)
        got = yield from random.together(*progs, *(
            [mix.masks.program(keys[num])] if tv else []))
        base = tuple(got[:len(progs)]) if len(progs) > 1 else got[0]
        return base, (got[len(progs)] if tv else None)

    extra = list(extra)
    (base, masks), *rest = yield from random.together(core(), *extra)
    if extra:
        return _Draws(base, masks, *rest)
    return (base, masks) if tv else base


def _split_masks(mix, draws):
    """``(draws, masks)`` of a round's draws (masks None on a static
    graph)."""
    if isinstance(draws, _Draws):
        return draws.base, draws.masks
    return draws if mix.masks is not None else (draws, None)


class _Links:
    """What a round adds for the transport and the participation model:
    their draw programs and the round's participation vector."""

    def __init__(self, fed_cfg, compressor, transport):
        self.transport = transport
        self.participation = resolve_participation(fed_cfg)
        self.compressor = compressor
        self.num_nodes = fed_cfg.num_nodes
        self._layouts = {}

    @property
    def draws_keeps(self) -> bool:
        return (self.transport is not None and self.transport.lossy
                and self.compressor is not None
                and hasattr(self.compressor, "encode"))

    def programs(self, key, params):
        """The programs of ``key`` a round adds, in order: the frames'
        keeps, the straggler uniforms (each present or None)."""
        out = []
        if self.draws_keeps:
            shapes = tuple((p, tuple(x.shape), x.dtype, x.device) for p, x
                           in tree_leaves_with_path(params))
            if shapes not in self._layouts:
                self._layouts[shapes] = self.transport.layout(
                    self.compressor, params)
            out.append(self.transport.frame_keeps.program(
                key, self._layouts[shapes].frames, self.num_nodes))
        if self.participation is not None:
            out.append(self.participation.draws.program(key))
        return out

    def unpack(self, draws):
        """``(keeps, straggler uniforms)`` of a round's draws."""
        if not isinstance(draws, _Draws):
            return None, None
        if self.draws_keeps:
            return draws.keeps, draws.straggle
        return None, draws.keeps

    def mask(self, straggle, round_idx, device):
        """The round's participation vector (None without a model)."""
        if self.participation is None:
            return None
        return self.participation.mask(straggle, round_idx, device)


def make_cdbfl_round(nll_fn, fed_cfg, omega, compressor, data_scale: float = 1.0,
                     device=None, transport=None):
    """One round = L local SGD steps per node (Eq. 5), compressed residual
    exchange (Eq. 6) through the transport when one is configured, the
    CHOCO control variates (Eqs. 7-8), and the consensus correction with
    Langevin noise (Eq. 9, the fused_update kernel); under a participation
    model a node that sits the round out keeps its state
    (``algorithms.py:335-453``). ``nll_fn`` is node-batched or the
    reference's per-node ``loss_fn(params, batch, key)`` (see the module
    docstring). ``device``: where the mixer's constants are made; None
    makes them for the device of the tensors the round is given."""
    eta, zeta = fed_cfg.eta, fed_cfg.zeta
    num_nodes = fed_cfg.num_nodes
    transport = resolve_transport(fed_cfg, transport)
    _check_transport(transport, compressor)
    mix = _default_mixer(omega, fed_cfg, device, transport)
    links = _Links(fed_cfg, compressor, transport)
    prior_weight = 1.0 / num_nodes
    keyed = per_node_loss(nll_fn)

    @random.program
    def draws(key: torch.Tensor, params):
        """``(noise, uniforms)`` of the round keyed ``key``: ``kql, knoise
        = split(key)``, then the noise and the uniforms side by side (and
        the masks from ``kmix``, the frames' keeps from ``kql`` and the
        straggler uniforms from ``key``)."""
        return (yield from _with_masks(mix, key, 2, lambda k: (
            langevin_noise.program(k[1], params, eta, fed_cfg.temperature),
            draw_uniforms.program(compressor, k[0], params)),
            links.programs(key, params)))

    def round_fn(state: FedState, batches, key: torch.Tensor, draws=None):
        """One round keyed ``key``; ``draws``, when given, is
        ``round_fn.draws(key, state.params)`` drawn already. The round
        index is ``state.round`` (the engines hand it in as a device int
        tensor)."""
        drawn = draws if draws is not None else round_fn.draws(
            key, state.params)
        (noise, uniforms), masks = _split_masks(mix, drawn)
        keeps, straggle = links.unpack(drawn)
        p = links.mask(straggle, state.round, key.device)
        # Eq. 5
        theta_l, losses = _local_sgd(nll_fn, state.params, batches, eta,
                                     prior_weight, data_scale,
                                     fed_cfg.local_steps,
                                     node_keys(state) if keyed else None)
        # Eq. 6: encode -> wire payload -> (frames) -> decode
        delta_v, delta, wire, payload, tx = _compress_exchange(
            compressor, theta_l, state.v, uniforms, transport, keeps)
        # Eqs. 7-9, control sequences stored in control_dtype
        params_new, v_new, v_bar_new = _control_update(
            theta_l, state, delta_v, mix(delta, masks=masks, node_mask=p),
            zeta, noise)
        if p is not None:
            v_new = _participation_freeze(p, v_new, state.v)
            v_bar_new = _participation_freeze(p, v_bar_new, state.v_bar)
            params_new = _participation_freeze(p, params_new, state.params)
        metrics = _round_metrics(
            _reduce_transport(_mask_transport(tx, p), num_nodes), p,
            loss=losses,
            consensus_error=_consensus_error(params_new) / num_nodes,
            delta_norm=_sq_norm(delta) / num_nodes,
            wire_bytes=wire,
            payload=payload)
        return state._replace(params=params_new, v=v_new, v_bar=v_bar_new,
                              round=state.round + 1), metrics

    round_fn.draws, round_fn.mixer = draws, mix
    round_fn.transport = transport
    return round_fn


def make_dsgld_round(nll_fn, fed_cfg, omega, data_scale: float = 1.0,
                     device=None, transport=None):
    """One DSGLD iteration (paper Eq. 4): ``θ' = Σ_j ω_kj θ_j − η∇f_k +
    √(2ηT)ξ`` on the first of the round's L minibatches, the dense θ
    exchanged uncompressed (the dsgld_update kernel). A transport adds its
    link outage to the mixer and its static accounting of the dense
    frames, nothing erased (``algorithms.py:460-553``)."""
    eta = fed_cfg.eta
    num_nodes = fed_cfg.num_nodes
    transport = resolve_transport(fed_cfg, transport)
    mix = _default_mixer(omega, fed_cfg, device, transport)
    links = _Links(fed_cfg, None, transport)
    prior_weight = 1.0 / num_nodes
    keyed = per_node_loss(nll_fn)

    @random.program
    def draws(key: torch.Tensor, params):
        """The noise of the round keyed ``key``: ``knoise, kmix =
        split(key)`` (the masks from ``kmix``, the straggler uniforms from
        ``key``)."""
        return (yield from _with_masks(
            mix, key, 1, lambda k: (langevin_noise.program(
                k[0], params, eta, fed_cfg.temperature),),
            links.programs(key, params)))

    def round_fn(state: FedState, batches, key: torch.Tensor, draws=None):
        drawn = draws if draws is not None else round_fn.draws(
            key, state.params)
        noise, masks = _split_masks(mix, drawn)
        _, straggle = links.unpack(drawn)
        p = links.mask(straggle, state.round, key.device)
        paths = [p_ for p_, _ in tree_leaves_with_path(state.params)]
        batch0 = _map_batch(lambda b: b[:, 0], batches)
        losses, grads = _value_and_grad(nll_fn, paths,
                                        tree_leaves(state.params), batch0,
                                        prior_weight, data_scale,
                                        node_keys(state) if keyed else None)
        mixed = mix(state.params, masks=masks, node_mask=p)
        params_new = tree_map(
            lambda m, g, n: kops.leaf_dsgld_update(m, g, n, eta), mixed,
            tree_unflatten(paths, list(grads)), noise)
        if p is not None:
            params_new = _participation_freeze(p, params_new, state.params)
        dense_bytes = tree_count(state.params) // num_nodes * 4
        txm = (transport.account_dense(dense_bytes)
               if transport is not None else TransportMetrics.zero())
        if p is not None:
            # a node that skipped the round never offered its dense θ
            rate = sum_nodes(p) * _inverse(num_nodes)
            txm = TransportMetrics(*(rate * f for f in txm))
        metrics = _round_metrics(
            txm, p,
            loss=losses[:, None],
            consensus_error=_consensus_error(params_new) / num_nodes,
            delta_norm=_sq_norm(state.params) / num_nodes,
            wire_bytes=float(dense_bytes),
        )
        return state._replace(params=params_new,
                              round=state.round + 1), metrics

    round_fn.draws, round_fn.mixer = draws, mix
    round_fn.transport = transport
    return round_fn


def make_cffl_round(nll_fn, fed_cfg, omega, compressor,
                    data_scale: float = 1.0, device=None, transport=None):
    """CF-FL (CHOCO-SGD, the compressed frequentist baseline): CD-BFL's
    round without the Langevin noise and the prior (the cffl_update
    kernel), through the transport and the participation model as
    CD-BFL's (``algorithms.py:560-635``)."""
    eta, zeta = fed_cfg.eta, fed_cfg.zeta
    num_nodes = fed_cfg.num_nodes
    transport = resolve_transport(fed_cfg, transport)
    _check_transport(transport, compressor)
    mix = _default_mixer(omega, fed_cfg, device, transport)
    links = _Links(fed_cfg, compressor, transport)
    keyed = per_node_loss(nll_fn)

    @random.program
    def draws(key: torch.Tensor, params):
        """The codec's draws of the round keyed ``key``: ``kq, _ =
        split(key)``, CD-BFL's codec stream (the masks from ``kmix =
        fold_in(key, 2)``, the keeps from ``kq``)."""
        return (yield from _with_masks(mix, key, 2, lambda k: (
            draw_uniforms.program(compressor, k[0], params),),
            links.programs(key, params)))

    def round_fn(state: FedState, batches, key: torch.Tensor, draws=None):
        drawn = draws if draws is not None else round_fn.draws(
            key, state.params)
        uniforms, masks = _split_masks(mix, drawn)
        keeps, straggle = links.unpack(drawn)
        p = links.mask(straggle, state.round, key.device)
        theta_l, losses = _local_sgd(nll_fn, state.params, batches, eta, 0.0,
                                     data_scale, fed_cfg.local_steps,
                                     node_keys(state) if keyed else None)
        delta_v, delta, wire, payload, tx = _compress_exchange(
            compressor, theta_l, state.v, uniforms, transport, keeps)
        params_new, v_new, v_bar_new = _control_update(
            theta_l, state, delta_v, mix(delta, masks=masks, node_mask=p),
            zeta)
        if p is not None:
            v_new = _participation_freeze(p, v_new, state.v)
            v_bar_new = _participation_freeze(p, v_bar_new, state.v_bar)
            params_new = _participation_freeze(p, params_new, state.params)
        metrics = _round_metrics(
            _reduce_transport(_mask_transport(tx, p), num_nodes), p,
            loss=losses,
            consensus_error=_consensus_error(params_new) / num_nodes,
            delta_norm=_sq_norm(delta) / num_nodes,
            wire_bytes=wire,
            payload=payload)
        return state._replace(params=params_new, v=v_new, v_bar=v_bar_new,
                              round=state.round + 1), metrics

    round_fn.draws, round_fn.mixer = draws, mix
    round_fn.transport = transport
    return round_fn


def make_sgld_step(nll_fn, eta: float, temperature: float = 1.0,
                   data_scale: float = 1.0):
    """The centralized SGLD oracle (paper Eq. 2) on one model's params, no
    node axis: ``step(params, batch, key) -> (params', loss)``, ``kgrad,
    knoise = split(key)``, the noise leaf i from ``split(knoise,
    n_leaves)[i]`` times ``√(2ηT)`` (the dsgld_update kernel)."""

    def step(params, batch, key: torch.Tensor):
        paths = [p for p, _ in tree_leaves_with_path(params)]
        _, knoise = random.split(key)
        leaf_keys = random.split(knoise, len(paths))
        scale = langevin_scale(eta, temperature)
        noise = random.run(random.together(*(
            random.normal.program(leaf_keys[i], x.shape, scale=scale)
            for i, (_, x) in enumerate(tree_leaves_with_path(params)))))
        stacked = [x[None] for x in tree_leaves(params)]
        loss, grads = _value_and_grad(
            nll_fn, paths, stacked,
            {f: v[None] for f, v in batch.items()}, 1.0, data_scale)
        new = [kops.leaf_dsgld_update(x, g[0], n, eta)
               for x, g, n in zip(tree_leaves(params), grads, noise)]
        return tree_unflatten(paths, new), loss[0]

    return step


def make_round_fn(algorithm: str, nll_fn, fed_cfg, omega, compressor=None,
                  data_scale: float = 1.0, device=None, transport=None):
    """The round function of ``algorithm`` (``algorithms.py:678-694``);
    ``transport`` overrides the one ``fed_cfg.transport`` builds."""
    if algorithm == "cdbfl":
        return make_cdbfl_round(nll_fn, fed_cfg, omega, compressor,
                                data_scale, device, transport)
    if algorithm == "dsgld":
        return make_dsgld_round(nll_fn, fed_cfg, omega, data_scale, device,
                                transport)
    if algorithm == "cffl":
        return make_cffl_round(nll_fn, fed_cfg, omega, compressor,
                               data_scale, device, transport)
    raise ValueError(f"unknown algorithm {algorithm!r}")
