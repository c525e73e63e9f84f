"""The round functions (``repro/core/algorithms.py``): CD-BFL, the paper's
Algorithm 1, and its two baselines, DSGLD and CF-FL; and the centralized
SGLD step.

Counterparts of ``make_cdbfl_round`` (reference lines 335-453),
``make_dsgld_round`` (:460-553), ``make_cffl_round`` (:560-635),
``make_sgld_step`` (:642-672) and ``make_round_fn`` (:675-694), with ideal
links: no transport, no participation model, one device. Every leaf leads
with the node axis K, and the K nodes run batched (grouped convolutions,
batched matmuls), not in a Python loop.

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
nothing more. The reference's per-node ``state.key`` stream feeds only
models with dropout, which the port does not run, so it is not derived.

DSGLD draws ``knoise, kmix = split(key)`` and its noise from ``knoise``,
its masks from ``kmix``; CF-FL keys its codec by ``kq, _ = split(key)``,
CD-BFL's codec stream, and its masks by ``kmix = fold_in(key, 2)``. Their
updates are the fused_update kernel's two variants (ROADMAP C10).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.compression import draw_uniforms
from repro_torch.core.fed_state import FedState
from repro_torch.core.gossip import make_mixer
from repro_torch.core.topology import resolve_topology
from repro_torch.kernels import ops as kops
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


def _value_and_grad(nll_fn, paths, leaves, batch, prior_weight: float,
                    data_scale: float):
    """``(f (K,), grads)`` of ``data_scale·NLL + ½·prior_weight·Σθ²`` on
    every node. Node k's objective depends on node k's params only, so one
    backward of the sum gives every node's gradient."""
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        nll = nll_fn(tree_unflatten(paths, leaves), batch)            # (K,)
        prior = sum(x.float().square().flatten(1).sum(1) for x in leaves)
        f = data_scale * nll + 0.5 * prior_weight * prior
        grads = torch.autograd.grad(f.sum(), leaves)
    return f.detach(), grads


def _local_sgd(nll_fn, params, batches, eta: float, prior_weight: float,
               data_scale: float, num_steps: int):
    """L plain SGD steps on every node (paper Eq. 5) on
    ``data_scale·NLL + ½·prior_weight·Σθ²``."""
    paths = [p for p, _ in tree_leaves_with_path(params)]
    leaves = tree_leaves(params)
    losses = []
    for step in range(num_steps):
        batch = {f: v[:, step] for f, v in batches.items()}
        f, grads = _value_and_grad(nll_fn, paths, leaves, batch,
                                   prior_weight, data_scale)
        losses.append(f)
        leaves = [x.detach() - eta * g.to(x.dtype) for x, g in zip(leaves, grads)]
    return tree_unflatten(paths, leaves), torch.stack(losses, dim=1)


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


def _compress_exchange(compressor, theta, v, uniforms):
    """Q over the residual ``theta - v`` of every node: ``(delta, wire
    bytes per node, payload)``. A pipeline encodes the pair (a
    :class:`FusedCodec` never materializes the residual) into a measured
    :class:`WirePayload` and decodes it; the legacy dense
    :class:`Compressor` is applied to the materialized residual, and its
    bytes are the closed-form table on one node's tree
    (``algorithms.py:235-238`` of the reference)."""
    if hasattr(compressor, "encode_pair"):
        payload = compressor.encode_pair(theta, v, uniforms)
        num_nodes = tree_leaves(theta)[0].shape[0]
        return (compressor.decode(payload),
                payload.measured_bytes() / num_nodes, payload)
    residual = tree_map(lambda t, vv: t - vv.to(t.dtype), theta, v)
    wire = compressor.wire_bytes(tree_map(lambda x: x[0], residual))
    return compressor(residual, uniforms), float(wire), None


def _default_mixer(omega, fed_cfg, device):
    """The reference's default mixer (``algorithms.py:60-65``): the
    lowering ``plan_mixer`` picks for Ω under the run's TopologyConfig."""
    return make_mixer(omega, device, config=resolve_topology(fed_cfg))


def _with_masks(mix, key: torch.Tensor, num: int, draw):
    """A round's draws program: ``split(key, num)`` (one more key, ``kmix
    = fold_in(key, num)``, when the mixer is time-varying), then
    ``draw(keys)``'s programs and the masks side by side. Returns the
    draws, or ``(draws, masks)`` on a time-varying graph."""
    tv = mix.masks is not None
    keys = yield from random.split.program(key, num + tv)
    progs = draw(keys)
    got = yield from random.together(*progs, *(
        [mix.masks.program(keys[num])] if tv else []))
    base = tuple(got[:len(progs)]) if len(progs) > 1 else got[0]
    return (base, got[-1]) if tv else base


def _split_masks(mix, draws):
    """``(draws, masks)`` of a round's draws (masks None on a static
    graph)."""
    return draws if mix.masks is not None else (draws, None)


def make_cdbfl_round(nll_fn, fed_cfg, omega, compressor, data_scale: float = 1.0,
                     device="cuda"):
    """One round = L local SGD steps per node (Eq. 5), compressed residual
    exchange (Eq. 6), the CHOCO control variates (Eqs. 7-8), and the
    consensus correction with Langevin noise (Eq. 9, the fused_update
    kernel)."""
    eta, zeta = fed_cfg.eta, fed_cfg.zeta
    num_nodes = fed_cfg.num_nodes
    mix = _default_mixer(omega, fed_cfg, device)
    prior_weight = 1.0 / num_nodes

    @random.program
    def draws(key: torch.Tensor, params):
        """``(noise, uniforms)`` of the round keyed ``key``: ``kql, knoise
        = split(key)``, then the noise and the uniforms side by side (and
        the masks from ``kmix``)."""
        return (yield from _with_masks(mix, key, 2, lambda k: (
            langevin_noise.program(k[1], params, eta, fed_cfg.temperature),
            draw_uniforms.program(compressor, k[0], params))))

    def round_fn(state: FedState, batches, key: torch.Tensor, draws=None):
        """One round keyed ``key``; ``draws``, when given, is
        ``round_fn.draws(key, state.params)`` drawn already."""
        (noise, uniforms), masks = _split_masks(
            mix, draws if draws is not None else
            round_fn.draws(key, state.params))
        # Eq. 5
        theta_l, losses = _local_sgd(nll_fn, state.params, batches, eta,
                                     prior_weight, data_scale,
                                     fed_cfg.local_steps)
        # Eq. 6: encode -> wire payload -> decode
        delta, wire, payload = _compress_exchange(compressor, theta_l,
                                                  state.v, uniforms)
        # Eqs. 7-8, control sequences stored in control_dtype
        v_new = tree_map(lambda v, d: v + d.to(v.dtype), state.v, delta)
        v_bar_new = tree_map(lambda vb, m: vb + m.to(vb.dtype), state.v_bar,
                             mix(delta, masks=masks))
        # Eq. 9, noise pre-scaled: s = 1
        params_new = tree_map(
            lambda t, vb, v, n: kops.leaf_fused_update(t, vb, v, n, zeta, 1.0),
            theta_l, v_bar_new, v_new, noise)
        metrics = RoundMetrics(
            loss=losses,
            consensus_error=_consensus_error(params_new) / num_nodes,
            delta_norm=_sq_norm(delta) / num_nodes,
            wire_bytes=wire,
            payload=payload,
        )
        return state._replace(params=params_new, v=v_new, v_bar=v_bar_new,
                              round=state.round + 1), metrics

    round_fn.draws, round_fn.mixer = draws, mix
    return round_fn


def make_dsgld_round(nll_fn, fed_cfg, omega, data_scale: float = 1.0,
                     device="cuda"):
    """One DSGLD iteration (paper Eq. 4): ``θ' = Σ_j ω_kj θ_j − η∇f_k +
    √(2ηT)ξ`` on the first of the round's L minibatches, the dense θ
    exchanged uncompressed (the dsgld_update kernel)."""
    eta = fed_cfg.eta
    num_nodes = fed_cfg.num_nodes
    mix = _default_mixer(omega, fed_cfg, device)
    prior_weight = 1.0 / num_nodes

    @random.program
    def draws(key: torch.Tensor, params):
        """The noise of the round keyed ``key``: ``knoise, kmix =
        split(key)`` (the masks from ``kmix``)."""
        knoise, kmix = yield from random.split.program(key)
        tv = mix.masks is not None
        got = yield from random.together(
            langevin_noise.program(knoise, params, eta, fed_cfg.temperature),
            *([mix.masks.program(kmix)] if tv else []))
        return tuple(got) if tv else got[0]

    def round_fn(state: FedState, batches, key: torch.Tensor, draws=None):
        noise, masks = _split_masks(
            mix, draws if draws is not None else
            round_fn.draws(key, state.params))
        paths = [p for p, _ in tree_leaves_with_path(state.params)]
        batch0 = {f: v[:, 0] for f, v in batches.items()}
        losses, grads = _value_and_grad(nll_fn, paths,
                                        tree_leaves(state.params), batch0,
                                        prior_weight, data_scale)
        mixed = mix(state.params, masks=masks)
        params_new = tree_map(
            lambda m, g, n: kops.leaf_dsgld_update(m, g, n, eta), mixed,
            tree_unflatten(paths, list(grads)), noise)
        dense_bytes = tree_count(state.params) // num_nodes * 4
        metrics = RoundMetrics(
            loss=losses[:, None],
            consensus_error=_consensus_error(params_new) / num_nodes,
            delta_norm=_sq_norm(state.params) / num_nodes,
            wire_bytes=float(dense_bytes),
        )
        return state._replace(params=params_new,
                              round=state.round + 1), metrics

    round_fn.draws, round_fn.mixer = draws, mix
    return round_fn


def make_cffl_round(nll_fn, fed_cfg, omega, compressor,
                    data_scale: float = 1.0, device="cuda"):
    """CF-FL (CHOCO-SGD, the compressed frequentist baseline): CD-BFL's
    round without the Langevin noise and the prior (the cffl_update
    kernel)."""
    eta, zeta = fed_cfg.eta, fed_cfg.zeta
    num_nodes = fed_cfg.num_nodes
    mix = _default_mixer(omega, fed_cfg, device)

    @random.program
    def draws(key: torch.Tensor, params):
        """The codec's draws of the round keyed ``key``: ``kq, _ =
        split(key)``, CD-BFL's codec stream (the masks from ``kmix =
        fold_in(key, 2)``)."""
        return (yield from _with_masks(mix, key, 2, lambda k: (
            draw_uniforms.program(compressor, k[0], params),)))

    def round_fn(state: FedState, batches, key: torch.Tensor, draws=None):
        uniforms, masks = _split_masks(
            mix, draws if draws is not None else
            round_fn.draws(key, state.params))
        theta_l, losses = _local_sgd(nll_fn, state.params, batches, eta, 0.0,
                                     data_scale, fed_cfg.local_steps)
        delta, wire, payload = _compress_exchange(compressor, theta_l,
                                                  state.v, uniforms)
        v_new = tree_map(lambda v, d: v + d.to(v.dtype), state.v, delta)
        v_bar_new = tree_map(lambda vb, m: vb + m.to(vb.dtype), state.v_bar,
                             mix(delta, masks=masks))
        params_new = tree_map(
            lambda t, vb, v: kops.leaf_cffl_update(t, vb, v, zeta), theta_l,
            v_bar_new, v_new)
        metrics = RoundMetrics(
            loss=losses,
            consensus_error=_consensus_error(params_new) / num_nodes,
            delta_norm=_sq_norm(delta) / num_nodes,
            wire_bytes=wire,
            payload=payload,
        )
        return state._replace(params=params_new, v=v_new, v_bar=v_bar_new,
                              round=state.round + 1), metrics

    round_fn.draws, round_fn.mixer = draws, mix
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
                  data_scale: float = 1.0, device="cuda"):
    """The round function of ``algorithm`` (``algorithms.py:675-694``)."""
    if algorithm == "cdbfl":
        return make_cdbfl_round(nll_fn, fed_cfg, omega, compressor,
                                data_scale, device)
    if algorithm == "dsgld":
        return make_dsgld_round(nll_fn, fed_cfg, omega, data_scale, device)
    if algorithm == "cffl":
        return make_cffl_round(nll_fn, fed_cfg, omega, compressor,
                               data_scale, device)
    raise ValueError(f"unknown algorithm {algorithm!r}")
