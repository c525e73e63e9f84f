"""The whisper encoder-decoder (``repro/models/whisper.py:22-132``): a
bidirectional encoder over precomputed frame embeddings (``batch["frames"]``
``(B, S_enc, D)``: the mel and conv front end is a stub, as in the
reference), and a causal decoder with cross-attention to the encoder's
output. Positions are RoPE, as the reference's.

Every function takes params with a leading group axis ``G`` (the samples
of a bank), as the decoders' do (``models/transformer.py``):

    init(key, device)                            -> params of one model
    encode(params, frames)                       -> (G, B, S_enc, D)
    logits(params, batch)                        -> (G, B, S, V)
    loss(params, batch, key=None)                -> ((G,), {"nll"})
    nll(params, batch)                           -> (G,)
    init_decode_state(batch, max_len, groups=1)  -> cache of G·B lanes
    prefill_encoder(params, cache, frames)       -> cache with enc_out
    decode_step(params, cache, tokens, pos)      -> (cache, (G, B, 1, V))

``frames`` is ``(B, S_enc, D)`` (one batch for every group) or ``(G, B,
S_enc, D)`` (group g's own), as llava's patches. The decode cache holds a
lane's encoder output ``enc_out`` in the cache dtype and its decoder
layers' KV caches; the self-attention decodes through ``decode_attention``
(the kernel on the card). ``init_decode_state`` leaves ``enc_out`` zero:
the reference's ``DecodeEngine`` never calls ``prefill_encoder``, so it
decodes against zero encoder output, and so does the port's (ROADMAP
C37).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import torch

from repro_torch import random
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models.attention import _proj
from repro_torch.models.layers import (dense_init, embed_init, f32_sums,
                                       init_mlp, init_rmsnorm, mlp, rmsnorm,
                                       torch_dtype)


def make_whisper(cfg) -> SimpleNamespace:
    dtype = torch_dtype(cfg.dtype)
    n_enc = cfg.encoder_layers or cfg.num_layers
    n_dec = cfg.num_layers

    def init(key: torch.Tensor, device) -> Dict:
        """``split(key, 4 + 2·n_enc + 3·n_dec)`` in the reference's order:
        the embedding, the head, each encoder layer's attention and MLP,
        each decoder layer's self-attention, cross-attention and MLP."""
        ks = random.split(key.to(device), 4 + n_enc * 2 + n_dec * 3)
        d, f = cfg.d_model, cfg.d_ff
        progs = [embed_init.program(ks[0], cfg.vocab_size, d),
                 dense_init.program(ks[1], d, (cfg.vocab_size,))]
        i = 2
        for _ in range(n_enc):
            progs += [attn_mod.init_attention.program(ks[i], cfg),
                      init_mlp.program(ks[i + 1], d, f)]
            i += 2
        for _ in range(n_dec):
            progs += [attn_mod.init_attention.program(ks[i], cfg),
                      attn_mod.init_attention.program(ks[i + 1], cfg),
                      init_mlp.program(ks[i + 2], d, f)]
            i += 3
        out = random.run(random.together(*progs))

        def norm():
            return init_rmsnorm(d, device)
        p: Dict = {"embed": {"tok": out[0]}, "enc_norm": norm(),
                   "final_norm": norm(), "lm_head": out[1],
                   "encoder": [], "decoder": []}
        j = 2
        for _ in range(n_enc):
            p["encoder"].append({"norm1": norm(), "attn": out[j],
                                 "norm2": norm(), "mlp": out[j + 1]})
            j += 2
        for _ in range(n_dec):
            p["decoder"].append({"norm1": norm(), "self_attn": out[j],
                                 "norm_x": norm(), "cross_attn": out[j + 1],
                                 "norm2": norm(), "mlp": out[j + 2]})
            j += 3
        return p

    def _mlp(lp, x):
        g, b, s, d = x.shape
        h = rmsnorm(lp["norm2"], x, cfg.norm_eps).reshape(g, b * s, d)
        return x + mlp(lp["mlp"], h, "gelu").reshape(g, b, s, d)

    def _frames(params, frames: torch.Tensor) -> torch.Tensor:
        frames = frames.to(dtype)
        if frames.dim() == 3:
            frames = frames.expand((params["lm_head"].shape[0],)
                                   + frames.shape)
        return frames

    def encode(params, frames: torch.Tensor) -> torch.Tensor:
        x = _frames(params, frames)
        b, s = x.shape[1], x.shape[2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        for lp in params["encoder"]:
            h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
            x = x + attn_mod.attention(lp["attn"], h, positions, cfg,
                                       causal=False)
            x = _mlp(lp, x)
        return rmsnorm(params["enc_norm"], x, cfg.norm_eps)

    def _cross_kv(lp, enc_out: torch.Tensor):
        return (_proj(enc_out, lp["cross_attn"]["wk"]),
                _proj(enc_out, lp["cross_attn"]["wv"]))

    def _tokens(params, tokens: torch.Tensor) -> torch.Tensor:
        tok = params["embed"]["tok"].to(dtype)
        if tokens.dim() == 2:
            return tok[:, tokens.long()]
        rows = torch.arange(tok.shape[0], device=tok.device)[:, None, None]
        return tok[rows, tokens.long()]

    def _head(params, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        g, b, s, d = x.shape
        return torch.bmm(x.reshape(g, b * s, d),
                         params["lm_head"].to(dtype)).reshape(g, b, s, -1)

    def decode_forward(params, tokens: torch.Tensor, enc_out: torch.Tensor):
        x = _tokens(params, tokens)
        b, s = x.shape[1], x.shape[2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        for lp in params["decoder"]:
            h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
            x = x + attn_mod.attention(lp["self_attn"], h, positions, cfg)
            h = rmsnorm(lp["norm_x"], x, cfg.norm_eps)
            x = x + attn_mod.attention(lp["cross_attn"], h, positions, cfg,
                                       cross_kv=_cross_kv(lp, enc_out))
            x = _mlp(lp, x)
        return _head(params, x)

    @f32_sums()
    def logits(params, batch) -> torch.Tensor:
        return decode_forward(params, batch["tokens"],
                              encode(params, batch["frames"]))

    def _mean_nll(lg, tokens) -> torch.Tensor:
        logp = torch.log_softmax(lg[:, :, :-1].float(), dim=-1)
        return -torch.gather(logp, -1, tokens[:, :, 1:, None])[..., 0] \
            .mean(dim=(1, 2))

    @f32_sums()
    def loss(params, batch, key=None):
        """The mean next-token NLL a model: ``((G,), {"nll": (G,)})``."""
        lg = decode_forward(params, batch["tokens"],
                            encode(params, batch["frames"]))
        tokens = batch["tokens"].long()
        nll_ = _mean_nll(lg, tokens.expand((lg.shape[0],) + tokens.shape))
        return nll_, {"nll": nll_}

    @f32_sums()
    def nll(params, batch) -> torch.Tensor:
        """Group g's mean next-token NLL on its own tokens ``(G, B, S)``
        and frames ``(G, B, S_enc, D)``, ``(G,)`` (the reference's
        ``vmap(loss)`` over its nodes)."""
        tokens = batch["tokens"].long()
        lg = decode_forward(params, tokens, encode(params, batch["frames"]))
        return _mean_nll(lg, tokens)

    # -- decode --------------------------------------------------------------
    def init_decode_state(batch_size: int, max_len: int, groups: int = 1,
                          dtype_kv=torch.bfloat16, device="cpu"):
        """A lane a (group, row) pair: ``enc_out`` ``(G, B, S_enc, D)``
        zero in ``dtype_kv`` and each decoder layer's KV cache of
        ``max_len`` slots."""
        lanes = (groups, batch_size)
        return {"enc_out": torch.zeros(lanes + (cfg.encoder_seq_len,
                                                cfg.d_model),
                                       dtype=dtype_kv, device=device),
                "layers": [attn_mod.init_cache(cfg, lanes, max_len,
                                               dtype=dtype_kv, device=device)
                           for _ in range(n_dec)]}

    @f32_sums()
    def prefill_encoder(params, cache, frames: torch.Tensor):
        """The cache with ``enc_out`` the encoder's output on ``frames``,
        in the cache's dtype (written in place)."""
        cache["enc_out"].copy_(encode(params, frames))
        return cache

    @f32_sums()
    def decode_step(params, cache, tokens, pos):
        """tokens ``(B,)`` or ``(B, 1)``; ``pos`` ``(B,)`` (or one int for
        every lane) -> ``(cache, logits (G, B, 1, V))``, the caches updated
        in place."""
        tokens = tokens.reshape(-1)
        if not torch.is_tensor(pos) or pos.dim() == 0:
            pos = torch.full(tokens.shape, int(pos), dtype=torch.int64,
                             device=tokens.device)
        x = _tokens(params, tokens[:, None])
        enc_out = cache["enc_out"].to(dtype)
        for lp, lc in zip(params["decoder"], cache["layers"]):
            h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
            _, h = attn_mod.decode_attention(lp["self_attn"], lc, h, pos, cfg)
            x = x + h
            h = rmsnorm(lp["norm_x"], x, cfg.norm_eps)
            x = x + attn_mod.attention(lp["cross_attn"], h, None, cfg,
                                       cross_kv=_cross_kv(lp, enc_out))
            x = _mlp(lp, x)
        return cache, _head(params, x)

    return SimpleNamespace(
        cfg=cfg, init=init, loss=loss, logits=logits, nll=nll,
        encode=encode, decode_forward=decode_forward,
        init_decode_state=init_decode_state,
        prefill_encoder=prefill_encoder, decode_step=decode_step,
        dtype=dtype, f32_leaf=blk.reads_f32)
