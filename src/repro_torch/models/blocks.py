"""Decoder blocks (``repro/models/blocks.py:37-131``): pre-norm mixer and
residual, then pre-norm FFN and residual. The mixers are the reference's:
``attn``, ``local_attn``, ``mla`` (DeepSeek-V2's latent attention),
``rec`` (Griffin's RG-LRU) and ``mlstm`` / ``slstm`` (xLSTM); the FFNs
``mlp``, ``moe`` and ``none``.

A block's decode cache is the mixer's: a KV cache (or MLA's latent cache)
in the cache dtype, or a recurrent state in f32 whatever the cache dtype,
as the reference keeps it. :func:`reads_f32` names the leaves the
reference reads uncast, in f32, whatever the compute dtype.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import random
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import init_mlp, init_rmsnorm, mlp, rmsnorm

BlockSpec = Tuple[str, str]

# a mixer's (or FFN's) init, train, state and decode functions
_MIXERS = {
    "rec": (rglru_mod.init_rglru_block, rglru_mod.rglru_block,
            rglru_mod.init_rglru_state, rglru_mod.rglru_block_decode),
    "mlstm": (xlstm_mod.init_mlstm_block, xlstm_mod.mlstm_block,
              xlstm_mod.init_mlstm_state, xlstm_mod.mlstm_block_decode),
    "slstm": (xlstm_mod.init_slstm_block, xlstm_mod.slstm_block,
              xlstm_mod.init_slstm_state, xlstm_mod.slstm_block_decode),
}
# the leaves, by their parent's name, that the reference reads uncast in
# f32 whatever the compute dtype: a resident bank keeps them f32
F32_PARAMS = {"rec": ("a_param",), "mlstm": ("wif", "bif"),
              "slstm": ("b", "wh"), "moe": ("router",)}


def reads_f32(path: str) -> bool:
    """Whether the reference reads the leaf at ``path`` (dotted, as
    ``tree_leaves_with_path`` gives it) in f32: the norms' scales and
    :data:`F32_PARAMS`."""
    parts = path.split(".")
    return parts[-1] == "scale" or (
        len(parts) > 1 and parts[-1] in F32_PARAMS.get(parts[-2], ()))


def _check(spec: BlockSpec) -> None:
    mixer, ffn = spec
    if mixer not in ("attn", "local_attn", "mla") and mixer not in _MIXERS:
        raise ValueError(mixer)
    if ffn not in ("mlp", "moe", "none"):
        raise ValueError(ffn)


def _param_name(mixer: str) -> str:
    """The mixer's subtree: ``attn`` for both attentions, else its name."""
    return "attn" if mixer in ("attn", "local_attn") else mixer


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
    mixer, ffn = spec
    lead = tuple(key.shape[:-1])
    k12 = yield from random.split.program(key)
    init_mixer = (_MIXERS[mixer][0] if mixer in _MIXERS else
                  mla_mod.init_mla if mixer == "mla" else
                  attn_mod.init_attention)
    progs = [init_mixer.program(k12[..., 0, :], cfg)]
    if ffn == "mlp":
        progs.append(init_mlp.program(k12[..., 1, :], cfg.d_model, cfg.d_ff))
    elif ffn == "moe":
        progs.append(moe_mod.init_moe.program(k12[..., 1, :], cfg))
    parts = yield from random.together(*progs)
    p: Dict = {"norm1": init_rmsnorm(cfg.d_model, key.device, lead),
               _param_name(mixer): parts[0]}
    if ffn != "none":
        p["norm2"] = init_rmsnorm(cfg.d_model, key.device, lead)
        p[ffn] = parts[1]
    return p


def _ffn(params, x, spec, cfg):
    """The FFN and its residual: ``(x, aux (G,) or 0)``."""
    ffn = spec[1]
    if ffn == "none":
        return x, torch.zeros((), device=x.device)
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    if ffn == "moe":
        h, aux = moe_mod.moe_ffn(params["moe"], h, cfg)
        return x + h, aux
    g, b, s, d = x.shape
    h = mlp(params["mlp"], h.reshape(g, b * s, d), cfg.act)
    return x + h.reshape(g, b, s, d), torch.zeros((), device=x.device)


def apply_block(params, x, positions, spec: BlockSpec, cfg, angles=None):
    """Training and prefill: x ``(G, B, S, D)`` -> ``(x, aux)``, aux the
    router's load-balance term ``(G,)`` of a ``moe`` block, else 0.
    ``angles``: the positions' RoPE rotations of the attention layers,
    computed once a forward (MLA rotates its own ``rope_head_dim``)."""
    _check(spec)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if spec[0] in _MIXERS:
        h = _MIXERS[spec[0]][1](params[spec[0]], h, cfg)
    elif spec[0] == "mla":
        h = mla_mod.mla_attention(params["mla"], h, positions, cfg)
    else:
        h = attn_mod.attention(params["attn"], h, positions, cfg,
                               window=_mixer_window(spec[0], cfg),
                               angles=angles)
    return _ffn(params, x + h, spec, cfg)


def init_block_cache(spec: BlockSpec, cfg, lanes, max_len: int,
                     dtype=torch.bfloat16, device="cpu") -> Dict:
    """The mixer's cache for each lane of ``lanes``: a KV (or latent) cache
    in ``dtype``, or a recurrent state in f32."""
    _check(spec)
    if spec[0] in _MIXERS:
        return _MIXERS[spec[0]][2](cfg, lanes, device=device)
    if spec[0] == "mla":
        return mla_mod.init_mla_cache(cfg, lanes, max_len, dtype=dtype,
                                      device=device)
    return attn_mod.init_cache(cfg, lanes, max_len,
                               window=_mixer_window(spec[0], cfg),
                               dtype=dtype, device=device)


def decode_block(params, cache, x, pos, spec: BlockSpec, cfg, angles=None):
    """One token a lane: x ``(G, B, 1, D)``, ``pos`` ``(B,)``. Returns
    ``(cache, x)``; the cache is updated in place. The router's aux term is
    dropped, as the reference drops it."""
    _check(spec)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if spec[0] in _MIXERS:
        cache, h = _MIXERS[spec[0]][3](params[spec[0]], cache, h, cfg)
    elif spec[0] == "mla":
        cache, h = mla_mod.mla_decode(params["mla"], cache, h, pos, cfg)
    else:
        cache, h = attn_mod.decode_attention(
            params["attn"], cache, h, pos, cfg,
            window=_mixer_window(spec[0], cfg), angles=angles)
    return cache, _ffn(params, x + h, spec, cfg)[0]
