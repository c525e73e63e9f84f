"""Decoder blocks (``repro/models/blocks.py:37-131``): pre-norm mixer and
residual, then pre-norm FFN and residual. The port runs the dense specs,
``("attn" | "local_attn", "mlp")``; every other mixer or FFN raises, naming
the part of ROADMAP A12 that ports it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import random
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import init_mlp, init_rmsnorm, mlp, rmsnorm

BlockSpec = Tuple[str, str]

# the mixers and FFNs of the reference's zoo the port does not run yet
_UNPORTED = {"mla": "A12 part 4 (MLA)", "rec": "A12 part 5 (RG-LRU)",
             "mlstm": "A12 part 6 (xLSTM)", "slstm": "A12 part 6 (xLSTM)",
             "moe": "A12 part 4 (moe)"}


def _check(spec: BlockSpec) -> None:
    for part in spec:
        if part in _UNPORTED:
            raise NotImplementedError(
                f"block {part!r} is not ported yet; ROADMAP {_UNPORTED[part]}")
    mixer, ffn = spec
    if mixer not in ("attn", "local_attn"):
        raise ValueError(mixer)
    if ffn not in ("mlp", "none"):
        raise ValueError(ffn)


def _mixer_window(spec_mixer: str, cfg) -> int:
    if spec_mixer == "local_attn":
        return cfg.local_attn_window
    return cfg.sliding_window


@random.program
def init_block(key: torch.Tensor, spec: BlockSpec, cfg):
    """A block's params from ``split(key)``: the mixer's from the first key,
    the FFN's from the second; keys with leading axes (the reference's
    ``vmap`` over layer groups) give leaves with them."""
    _check(spec)
    lead = tuple(key.shape[:-1])
    k12 = yield from random.split.program(key)
    progs = [attn_mod.init_attention.program(k12[..., 0, :], cfg)]
    if spec[1] == "mlp":
        progs.append(init_mlp.program(k12[..., 1, :], cfg.d_model, cfg.d_ff))
    parts = yield from random.together(*progs)
    p: Dict = {"norm1": init_rmsnorm(cfg.d_model, key.device, lead),
               "attn": parts[0]}
    if spec[1] == "mlp":
        p["norm2"] = init_rmsnorm(cfg.d_model, key.device, lead)
        p["mlp"] = parts[1]
    return p


def _ffn(params, x, spec, cfg):
    if spec[1] != "mlp":
        return x
    g, b, s, d = x.shape
    h = rmsnorm(params["norm2"], x, cfg.norm_eps).reshape(g, b * s, d)
    return x + mlp(params["mlp"], h, cfg.act).reshape(g, b, s, d)


def apply_block(params, x, positions, spec: BlockSpec, cfg, angles=None):
    """Training and prefill: x ``(G, B, S, D)`` -> ``(x, aux)`` (aux 0: no
    dense block has a router loss). ``angles``: the positions' RoPE
    rotations, computed once a forward."""
    _check(spec)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    x = x + attn_mod.attention(params["attn"], h, positions, cfg,
                               window=_mixer_window(spec[0], cfg),
                               angles=angles)
    return _ffn(params, x, spec, cfg), torch.zeros((), device=x.device)


def init_block_cache(spec: BlockSpec, cfg, lanes, max_len: int,
                     dtype=torch.bfloat16, device="cpu") -> Dict:
    _check(spec)
    return attn_mod.init_cache(cfg, lanes, max_len,
                               window=_mixer_window(spec[0], cfg),
                               dtype=dtype, device=device)


def decode_block(params, cache, x, pos, spec: BlockSpec, cfg, angles=None):
    """One token a lane: x ``(G, B, 1, D)``, ``pos`` ``(B,)``. Returns
    ``(cache, x)``; the cache is updated in place."""
    _check(spec)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    cache, h = attn_mod.decode_attention(params["attn"], cache, h, pos, cfg,
                                         window=_mixer_window(spec[0], cfg),
                                         angles=angles)
    return cache, _ffn(params, x + h, spec, cfg)
