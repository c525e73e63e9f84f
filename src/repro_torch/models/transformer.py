"""Decoder-only models (``repro/models/transformer.py:31-220``), the dense
family.

The parameter tree is the reference's: ``embed/tok``, ``final_norm``,
``lm_head`` (untied), and the layers either stacked under ``groups/u0``
with a leading ``n_groups`` axis (``scan_layers`` and more than one layer)
or as a ``layers`` list. So a bank checkpoint written by either package
loads in the other. Every function takes params with a leading group axis
``G`` (the samples of a bank; see ``models/lenet.py``); per-sample products
are ``torch.bmm``.

    init(key, device)                            -> params of one model
    logits(params, batch)                        -> (G, B, S, V)
    loss(params, batch, key=None)                -> ((G,), {"nll", "aux"})
    init_decode_state(batch, max_len, groups=1)  -> cache of G·B lanes
    decode_step(params, cache, tokens, pos)      -> (cache, (G, B, 1, V))

``decode_step`` takes a position a lane (``pos`` ``(B,)``), so the lanes of
an engine advance independently, and updates the cache in place.
``logits``, ``loss`` and ``decode_step`` sum their products in full f32
on the card whatever the process set (``layers.f32_sums``), so a served
step and an eval read the reference's arithmetic under torch's defaults.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (dense_init, embed_init, f32_sums,
                                       init_rmsnorm, rmsnorm, rope_angles,
                                       torch_dtype)
from repro_torch.utils.tree import tree_map

# the families of the reference's zoo the port does not run yet
_UNPORTED_FAMILIES = {"moe": "A12 part 4 (moe and MLA)",
                      "vlm": "A12 part 3 (vlm)",
                      "hybrid": "A12 part 5 (hybrid, RG-LRU)",
                      "ssm": "A12 part 6 (ssm, xLSTM)",
                      "audio": "A12 part 7 (audio)"}


def full_pattern(cfg) -> List[blk.BlockSpec]:
    if cfg.family in _UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; ROADMAP "
            f"{_UNPORTED_FAMILIES[cfg.family]}")
    if cfg.family != "dense":
        raise ValueError(cfg.family)
    return [("attn", "mlp")] * cfg.num_layers


def scan_unit(cfg) -> Tuple[List[blk.BlockSpec], int, List[blk.BlockSpec]]:
    """(repeating unit, n_groups, tail specs): one block for dense."""
    pat = full_pattern(cfg)
    unit = pat[:1]
    n_groups = len(pat) // len(unit)
    return unit, n_groups, pat[n_groups * len(unit):]


def layer_params(params, i: int, use_scan: bool):
    """Layer ``i``'s params, each leaf ``(G, ...)``."""
    if use_scan:
        return tree_map(lambda a: a[:, i], params["groups"]["u0"])
    return params["layers"][i]


def make_model(cfg) -> SimpleNamespace:
    dtype = torch_dtype(cfg.dtype)
    unit, n_groups, tail = scan_unit(cfg)
    use_scan = cfg.scan_layers and n_groups > 1
    pat = full_pattern(cfg)

    def init(key: torch.Tensor, device) -> Dict:
        """The reference's ``init(key)``: ``split(key, 5)`` into the
        embedding, layer, tail, head and image keys; the layer groups from
        ``split(klayers, n_groups)``, each group's draws from its own key
        (the reference's ``vmap``)."""
        kemb, klayers, _, khead, _ = random.split(key.to(device), 5)
        progs = [embed_init.program(kemb, cfg.vocab_size, cfg.d_model)]
        if not cfg.tie_embeddings:
            progs.append(dense_init.program(khead, cfg.d_model,
                                            (cfg.vocab_size,)))
        if use_scan:
            gkeys = random.split(klayers, n_groups)
            uks = random.split(gkeys, len(unit))
            progs += [blk.init_block.program(uks[:, i], spec, cfg)
                      for i, spec in enumerate(unit)]
        else:
            lkeys = random.split(klayers, max(1, len(pat)))
            progs += [blk.init_block.program(lkeys[i], spec, cfg)
                      for i, spec in enumerate(pat)]
        out = random.run(random.together(*progs))
        p: Dict = {"embed": {"tok": out.pop(0)},
                   "final_norm": init_rmsnorm(cfg.d_model, device)}
        if not cfg.tie_embeddings:
            p["lm_head"] = out.pop(0)
        if use_scan:
            p["groups"] = {f"u{i}": out[i] for i in range(len(unit))}
        else:
            p["layers"] = out
        return p

    # -- embedding and head --------------------------------------------------
    def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
        """tokens ``(B, S)`` -> ``(G, B, S, D)`` in the compute dtype."""
        return params["embed"]["tok"].to(dtype)[:, tokens.long()]

    def _head(params, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        w = (params["embed"]["tok"].transpose(1, 2) if cfg.tie_embeddings
             else params["lm_head"]).to(dtype)
        g, b, s, d = x.shape
        return torch.bmm(x.reshape(g, b * s, d), w).reshape(g, b, s, -1)

    # -- forward -------------------------------------------------------------
    def _trunk(params, x):
        b, s = x.shape[1], x.shape[2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        angles = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
        aux = torch.zeros((), device=x.device)
        for i, spec in enumerate(pat):
            x, ai = blk.apply_block(layer_params(params, i, use_scan), x,
                                    positions, spec, cfg, angles)
            aux = aux + ai
        return x, aux

    @f32_sums()
    def logits(params, batch) -> torch.Tensor:
        x, _ = _trunk(params, _embed(params, batch["tokens"]))
        return _head(params, x)

    @f32_sums()
    def loss(params, batch, key=None):
        """The mean next-token NLL a model, over ``loss_mask[:, 1:]`` where
        the batch has one: ``((G,), {"nll": (G,), "aux": (G,)})``."""
        tokens = batch["tokens"].long()
        x, aux = _trunk(params, _embed(params, tokens))
        lg = _head(params, x)
        logp = torch.log_softmax(lg[:, :, :-1].float(), dim=-1)
        tgt = tokens[:, 1:].expand(lg.shape[0], -1, -1)
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is not None:
            m = torch.as_tensor(mask, device=nll.device)[:, 1:].float()
            mean_nll = (nll * m).sum(dim=(1, 2)) / torch.clamp(m.sum(), min=1.0)
        else:
            mean_nll = nll.mean(dim=(1, 2))
        return mean_nll + aux, {"nll": mean_nll, "aux": aux.expand_as(mean_nll)}

    # -- decode --------------------------------------------------------------
    def init_decode_state(batch_size: int, max_len: int, groups: int = 1,
                          dtype_kv=torch.bfloat16, device="cpu"):
        """Zeroed caches, one lane a (group, row) pair: with scanned layers
        ``{"groups": {"u0": {k, v: (n_groups, G, B, slots, KV, hd),
        slot_pos: (n_groups, G, B, slots)}}}``, layer-major so each layer's
        cache is one contiguous block; else ``{"layers": [...]}``."""
        lanes = (groups, batch_size)
        if use_scan:
            return {"groups": {f"u{i}": blk.init_block_cache(
                spec, cfg, (n_groups,) + lanes, max_len, dtype_kv, device)
                for i, spec in enumerate(unit)}}
        return {"layers": [blk.init_block_cache(spec, cfg, lanes, max_len,
                                                dtype_kv, device)
                           for spec in pat]}

    @f32_sums()
    def decode_step(params, cache, tokens, pos):
        """tokens ``(B,)`` or ``(B, 1)``; ``pos`` ``(B,)`` (or one int for
        every lane) -> ``(cache, logits (G, B, 1, V))``."""
        tokens = tokens.reshape(-1)
        if not torch.is_tensor(pos) or pos.dim() == 0:
            pos = torch.full(tokens.shape, int(pos), dtype=torch.int64,
                             device=tokens.device)
        x = _embed(params, tokens[:, None])
        angles = rope_angles(pos[:, None], cfg.resolved_head_dim,
                             cfg.rope_theta)
        for i, spec in enumerate(pat):
            lc = (tree_map(lambda c: c[i], cache["groups"]["u0"]) if use_scan
                  else cache["layers"][i])
            _, x = blk.decode_block(layer_params(params, i, use_scan), lc, x,
                                    pos, spec, cfg, angles)
        return cache, _head(params, x)

    return SimpleNamespace(
        cfg=cfg, init=init, loss=loss, logits=logits,
        init_decode_state=init_decode_state, decode_step=decode_step,
        pattern=pat, scan_unit=(unit, n_groups, tail), use_scan=use_scan,
        dtype=dtype)


def params_from_jax(np_tree, device="cpu"):
    """Reference params (numpy leaves, the same tree) -> f32 tensors."""
    return tree_map(lambda x: torch.from_numpy(
        np.array(x, np.float32)).to(device), np_tree)


def params_to_numpy(tree):
    """Inverse of :func:`params_from_jax`."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
