"""xLSTM's blocks, mLSTM and sLSTM (``repro/models/xlstm.py:27-233``).

* mLSTM: a matrix memory with exponential gating. Training and prefill
  take the stabilized parallel form (``chunked.chunkwise_mlstm`` at ``S >=
  2 · chunk_size``, chunks of ``min(chunk_size, 256)``); decode keeps a
  lane's ``(C, n, m)``.
* sLSTM: a scalar memory with a normalizer state and hidden-to-gate
  matrices a head, so its recurrence is not diagonal: training runs the
  steps over time, one after another (the reference's ``lax.scan``; it
  recomputes each chunk of steps in its backward, the port keeps
  autograd's saved tensors, the same values). On the card the steps are
  torch ops inside the engines' CUDA graphs.

Shapes carry the port's group axis ``G`` first: x ``(G, B, S, D)``,
weights ``(G, ...)``. The recurrent states are f32 whatever the cache
dtype, as the reference keeps them, and decode updates them in place. The
leaves the reference reads uncast, in f32 (``wif``, ``bif``; sLSTM's
``b`` and ``wh``), are read so here (``blocks.F32_PARAMS``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import random
from repro_torch.models.attention import _proj
from repro_torch.models.chunked import chunkwise_mlstm, sqrt_hd, use_chunked
from repro_torch.models.layers import dense_init

F = torch.nn.functional


# ==========================================================================
# mLSTM
# ==========================================================================

@random.program
def init_mlstm_block(key: torch.Tensor, cfg):
    """``split(key, 4)``: ``wqkv`` ``(D, 3, H, hd)``, ``wif`` ``(D, 2, H)``,
    ``wo_gate`` and ``proj``; ``bif`` the gates' biases (0 and 3)."""
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    ks = yield from random.split.program(key, 4)
    wqkv, wif, wo_gate, proj = yield from random.together(
        dense_init.program(ks[..., 0, :], d, (3, h, hd)),
        dense_init.program(ks[..., 1, :], d, (2, h)),
        dense_init.program(ks[..., 2, :], d, (d,)),
        dense_init.program(ks[..., 3, :], d, (d,)))
    lead = tuple(key.shape[:-1])
    bif = torch.stack([torch.zeros(h), 3.0 * torch.ones(h)]).to(key.device)
    return {"wqkv": wqkv, "wif": wif,
            "bif": bif.expand(lead + bif.shape).contiguous(),
            "wo_gate": wo_gate, "proj": proj}


def _mlstm_qkvif(params, x: torch.Tensor):
    """q, k, v ``(G, B, S, H, hd)`` in x's dtype; log_i, log_f ``(G, B, S,
    H)`` f32 (the gates from x in f32 and ``wif`` uncast)."""
    qkv = _proj(x, params["wqkv"])                    # (G, B, S, 3, H, hd)
    q, k, v = qkv.unbind(3)
    gates = torch.einsum("gbsd,gdth->gbsth", x.float(),
                         params["wif"].float()) + \
        params["bif"].float()[:, None, None]
    return q, k, v, gates[..., 0, :], F.logsigmoid(gates[..., 1, :])


def _out_gate(params, x, hout):
    """``(sigmoid(x W_og) ⊙ h) W_proj``."""
    og = torch.sigmoid(_proj(x, params["wo_gate"]))
    return _proj(og * hout, params["proj"])


def mlstm_block(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The stabilized parallel form (Beck et al. eqs. 21-27), x ``(G, B,
    S, D)``; long sequences take the chunkwise form."""
    dt = x.dtype
    g, b, s, d = x.shape
    hd = d // cfg.num_heads
    q, k, v, log_i, log_f = _mlstm_qkvif(params, x)
    if use_chunked(cfg, s):
        hout = chunkwise_mlstm(*(t.reshape((g * b,) + t.shape[2:]) for t in
                                 (q, k, v, log_i, log_f)),
                               chunk=min(cfg.chunk_size, 256))
        return _out_gate(params, x, hout.reshape(g, b, s, d))
    # D_ts = cumsum(log_f)[t] - cumsum(log_f)[s] + log_i[s], s <= t
    cf = torch.cumsum(log_f, dim=2)                      # (G, B, S, H)
    dmat = cf[:, :, :, None, :] - cf[:, :, None, :, :] + \
        log_i[:, :, None, :, :]
    ii = torch.arange(s, device=x.device)
    causal = (ii[None, :] <= ii[:, None])[:, :, None]
    dmat = dmat.masked_fill(~causal, float("-inf"))     # (G, B, T, S, H)
    m = torch.clamp(dmat.amax(dim=3, keepdim=True), min=0.0)
    dexp = torch.exp(dmat - m)
    scores = torch.einsum("gbthk,gbshk->gbtsh", q, k).float() / sqrt_hd(hd)
    w = scores * dexp
    norm = torch.maximum(w.sum(dim=3).abs(), torch.exp(-m[:, :, :, 0]))
    hout = torch.einsum("gbtsh,gbshk->gbthk", w.to(dt), v) / (
        norm[..., None].to(dt) + 1e-6)
    return _out_gate(params, x, hout.reshape(g, b, s, d))


def init_mlstm_state(cfg, lanes, device="cpu") -> Dict:
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    lanes = tuple(lanes)
    return {"C": torch.zeros(lanes + (h, hd, hd), device=device),
            "n": torch.zeros(lanes + (h, hd), device=device),
            "m": torch.zeros(lanes + (h,), device=device)}


def mlstm_block_decode(params, state, x: torch.Tensor, cfg):
    """The recurrent step ``C_t = f C + i v kᵀ`` (stabilized), x ``(G, B,
    1, D)``; the state updated in place."""
    dt = x.dtype
    g, b, _, d = x.shape
    hd = d // cfg.num_heads
    q, k, v, log_i, log_f = _mlstm_qkvif(params, x)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]         # (G, B, H, hd)
    log_i, log_f = log_i[:, :, 0], log_f[:, :, 0]        # (G, B, H)
    m_prev = state["m"].float()
    m_new = torch.maximum(log_f + m_prev, log_i)
    f_sc = torch.exp(log_f + m_prev - m_new)
    i_sc = torch.exp(log_i - m_new)
    kf = k.float() / sqrt_hd(hd)
    c = f_sc[..., None, None] * state["C"].float() + i_sc[..., None, None] * (
        v.float()[..., :, None] * kf[..., None, :])
    n = f_sc[..., None] * state["n"].float() + i_sc[..., None] * kf
    qf = q.float()
    num = torch.einsum("gbhvk,gbhk->gbhv", c, qf)
    den = torch.maximum(torch.einsum("gbhk,gbhk->gbh", n, qf).abs(),
                        torch.exp(-m_new))
    hout = (num / (den[..., None] + 1e-6)).reshape(g, b, 1, d).to(dt)
    out = _out_gate(params, x, hout)
    state["C"].copy_(c)
    state["n"].copy_(n)
    state["m"].copy_(m_new)
    return state, out


# ==========================================================================
# sLSTM
# ==========================================================================

@random.program
def init_slstm_block(key: torch.Tensor, cfg):
    """``split(key, 3)``: ``wx`` ``(D, 4, D)`` (input to the gates i, f, z,
    o), ``wh`` ``(H, hd, 4, hd)`` (hidden to gates, block-diagonal a head,
    drawn ``(hd, H, 4, hd)`` and moved), ``proj``; ``b`` the gates' biases
    (f's 2)."""
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    ks = yield from random.split.program(key, 3)
    wx, wh, proj = yield from random.together(
        dense_init.program(ks[..., 0, :], d, (4, d)),
        dense_init.program(ks[..., 1, :], hd, (h, 4, hd)),
        dense_init.program(ks[..., 2, :], d, (d,)))
    lead = tuple(key.shape[:-1])
    bias = torch.cat([torch.zeros(d), 2.0 * torch.ones(d),
                      torch.zeros(2 * d)]).to(key.device)
    return {"wx": wx, "wh": wh.transpose(-4, -3).contiguous(),
            "b": bias.expand(lead + bias.shape).contiguous(), "proj": proj}


def init_slstm_state(cfg, lanes, device="cpu") -> Dict:
    """``c``, ``m``, ``h`` zero and the normalizer ``n`` one, f32."""
    shape = tuple(lanes) + (cfg.d_model,)
    return {"c": torch.zeros(shape, device=device),
            "n": torch.ones(shape, device=device),
            "m": torch.zeros(shape, device=device),
            "h": torch.zeros(shape, device=device)}


def _slstm_step(params, cfg, state, xg: torch.Tensor) -> Dict:
    """xg ``(G, B, 4, D)`` the input's part of the gates; the state a dict
    of ``(G, B, D)``. Returns the next state (new tensors)."""
    nh, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    g, b = xg.shape[:2]
    hprev = state["h"].float().reshape(g, b, nh, hd)
    hg = torch.einsum("gbhk,ghkcv->gbchv", hprev, params["wh"].float())
    bias = params["b"].float().reshape(g, 1, 4, -1)
    gates = xg.float() + hg.reshape(g, b, 4, -1) + bias
    gi, gf, gz, go = gates.unbind(2)
    m_prev = state["m"].float()
    log_f = F.logsigmoid(gf)
    m_new = torch.maximum(log_f + m_prev, gi)
    i_sc = torch.exp(gi - m_new)
    f_sc = torch.exp(log_f + m_prev - m_new)
    c = f_sc * state["c"].float() + i_sc * torch.tanh(gz)
    n = torch.clamp(f_sc * state["n"].float() + i_sc, min=1e-6)
    h = torch.sigmoid(go) * (c / n)
    return {"c": c, "n": n, "m": m_new, "h": h}


def slstm_block(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Training: the steps over time from the initial state, x ``(G, B,
    S, D)``."""
    dt = x.dtype
    g, b, s, _ = x.shape
    xg = _proj(x, params["wx"])                          # (G, B, S, 4, D)
    state = init_slstm_state(cfg, (g, b), x.device)
    hs = []
    for t in range(s):
        state = _slstm_step(params, cfg, state, xg[:, :, t])
        hs.append(state["h"])
    return _proj(torch.stack(hs, dim=2).to(dt), params["proj"])


def slstm_block_decode(params, state, x: torch.Tensor, cfg):
    """One step, x ``(G, B, 1, D)``; the state updated in place."""
    dt = x.dtype
    new = _slstm_step(params, cfg, state, _proj(x, params["wx"])[:, :, 0])
    for name, val in new.items():
        state[name].copy_(val)
    return state, _proj(new["h"].to(dt)[:, :, None], params["proj"])

