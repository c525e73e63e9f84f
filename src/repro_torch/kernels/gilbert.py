"""Gilbert–Elliott burst-channel keep masks, one launch for a round's chains.

The reference draws a burst channel's per-frame keep mask as a
``lax.scan`` over the frames (``GilbertElliottLoss.keep``,
``repro/core/transport.py:255-273``): a chain of one (node, leaf, ARQ
attempt) starts bad when its start uniform ``u0 < fl32(π_bad)``, then each
frame keeps when ``u_l >= (bad ? loss_bad : loss_good)`` and flips the state
when ``u_t < (bad ? p_exit : p_enter)``. On the card it is a kernel
(``csrc/gilbert.cu``) over a table of leaves, each leaf's ``rows`` chains
(the nodes times the ARQ attempts) of its own frame count: a warp a chain,
32 frames a tile, one a lane. A frame maps the 2-state chain by one of four
maps (keep, flip, set-bad, clear), and the maps compose associatively, so
the state before each frame is a warp scan of the tile's 2-bit maps applied
to the state carried from the tile before; the loads run ahead of the
scan, so the longest chain takes about one memory latency and its tiles'
scans. The comparisons are exact: kernel, plain version (the frame loop)
and reference agree bit for bit.

No ``pl.pallas_call`` of the reference computes it: on the TPU the scan is
XLA's. The plain version runs for CPU tensors; a CUDA tensor launches the
kernel or raises; ``gilbert_keep.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, library, on_card, stream_of
from repro_torch.kernels.pack import c_array
from repro_torch.kernels.threefry import to_f32

MAX_LEAVES = 64                    # csrc/gilbert.cu: kMaxLeaves


def channel_params(p_enter: float, p_exit: float, loss_good: float,
                   loss_bad: float):
    """``(π_bad, p_enter, p_exit, loss_good, loss_bad)`` as the f32
    constants the reference compares its uniforms with: ``π_bad = p_enter
    / max(p_enter + p_exit, 1e-12)`` in float64, each then rounded to f32
    (a Python float is a weak f32 in a comparison with an f32 array)."""
    pi_bad = p_enter / max(p_enter + p_exit, 1e-12)
    return tuple(to_f32(x) for x in (pi_bad, p_enter, p_exit, loss_good,
                                     loss_bad))


def _check(u0, u_t, u_l) -> None:
    if u0.dim() != 2 or u0.shape[1] != len(u_t) or len(u_t) != len(u_l):
        raise ValueError(f"gilbert_keep: u0 {tuple(u0.shape)} for "
                         f"{len(u_t)} leaves")
    for i, (a, b) in enumerate(zip(u_t, u_l)):
        if a.shape != b.shape or a.dim() != 2 or a.shape[0] != u0.shape[0]:
            raise ValueError(f"gilbert_keep: leaf {i}: u_t {tuple(a.shape)}, "
                             f"u_l {tuple(b.shape)}, {u0.shape[0]} rows")


def gilbert_keep_plain(u0, u_t, u_l, params):
    """The frame loop, vectorized over every leaf's chains (the leaves
    padded to the longest)."""
    pi_bad, p_enter, p_exit, loss_good, loss_bad = params
    rows, count = u0.shape
    if not count:
        return []
    longest = max(a.shape[1] for a in u_t)
    pad = lambda xs: torch.stack([torch.nn.functional.pad(
        x, (0, longest - x.shape[1])) for x in xs], dim=1)
    ut, ul = pad(u_t), pad(u_l)                     # (rows, count, longest)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=u0.device)
    lb, lg, pe, pn = f32(loss_bad), f32(loss_good), f32(p_exit), f32(p_enter)
    bad = u0 < f32(pi_bad)
    keep = torch.empty_like(ut)
    for t in range(longest):
        keep[:, :, t] = (ul[:, :, t] >= torch.where(bad, lb, lg)).float()
        bad = bad ^ (ut[:, :, t] < torch.where(bad, pe, pn))
    return [keep[:, i, :a.shape[1]] for i, a in enumerate(u_t)]


def gilbert_keep(u0: torch.Tensor, u_t, u_l, params):
    """Keep masks of ``len(u_t)`` leaves: ``u0`` is ``(rows, leaves)``, leaf
    i's start uniforms in column i; ``u_t[i]``, ``u_l[i]`` are ``(rows,
    n_i)`` f32; ``params`` is :func:`channel_params`'s tuple. Returns
    ``[(rows, n_i) f32 of 0/1]``."""
    u_t, u_l = list(u_t), list(u_l)
    _check(u0, u_t, u_l)
    if not on_card("gilbert_keep", [(t, torch.float32)
                                    for t in [u0, *u_t, *u_l]]):
        return gilbert_keep_plain(u0, u_t, u_l, params)
    if len(u_t) > MAX_LEAVES:
        raise ValueError(f"gilbert_keep: {len(u_t)} leaves, a launch takes "
                         f"at most {MAX_LEAVES}")
    keep = [torch.empty_like(a) for a in u_t]
    rows = u0.shape[0]
    if rows and keep:
        with torch.cuda.device(u0.device):
            rc = library().repro_gilbert_keep(
                c_array(ctypes.c_void_p, [a.data_ptr() for a in u_t]),
                c_array(ctypes.c_void_p, [a.data_ptr() for a in u_l]),
                c_array(ctypes.c_void_p, [k.data_ptr() for k in keep]),
                c_array(ctypes.c_longlong, [a.shape[1] for a in u_t]), len(u_t),
                rows, u0.data_ptr(), c_array(ctypes.c_float, list(params)),
                stream_of(u0))
        check(rc, "gilbert_keep")
        gilbert_keep.launches += 1
    return keep


gilbert_keep.launches = 0

