"""LeNet for range-azimuth radar maps (the paper's model, §IV), in PyTorch.

Counterpart of ``repro/models/lenet.py``. Parameters keep the reference's
layouts: conv ``w`` is HWIO ``(5, 5, Cin, Cout)`` and dense ``w`` is
``(in, out)``. That is not cosmetic: block-top-k works on the flattened
leaf, so any other storage order selects other blocks and breaks byte
parity with the reference. The forward converts at the point of use
(HWIO -> OIHW for ``conv2d``, NHWC <-> NCHW around the convolutions) and
flattens in NHWC order before ``fc1``, as the reference does.

Every function takes parameters with a leading group axis ``G`` (the K
nodes of a federation, or the S·K chains of a posterior bank): the G
models run as one grouped convolution and one batched matmul per layer.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random
from repro_torch.utils.tree import tree_map


def _flat_dim(hw):
    h, w = hw
    h = (h - 4) // 2       # conv5 valid + pool2
    w = (w - 4) // 2
    h = (h - 4) // 2
    w = (w - 4) // 2
    return 16 * h * w


@random.program
def dense_init(key: torch.Tensor, in_dim: int, out_shape, scale: float = 1.0):
    """Truncated-normal fan-in init, as ``models/layers.py:dense_init``:
    ``std · truncated_normal(key, −2, 2, (in_dim, *out_shape))``."""
    return (yield from random.truncated_normal.program(
        key, -2.0, 2.0, (in_dim,) + tuple(out_shape),
        scale=scale / math.sqrt(in_dim)))


def init_lenet(cfg, key: torch.Tensor, device) -> Dict:
    """The reference's ``init_lenet(key, cfg)`` on ``device``: one key of
    ``split(key, 5)`` a layer (two launches: the split, then the five
    draws)."""
    fdim = _flat_dim(cfg.input_hw)
    fc1 = max(32, min(220, fdim // 4)) if fdim < 2048 else 220
    ks = random.split(key.to(device), 5)
    w1, w2, w3, w4, w5 = random.run(random.together(
        dense_init.program(ks[0], 25, (6,)),
        dense_init.program(ks[1], 150, (16,)),
        dense_init.program(ks[2], fdim, (fc1,)),
        dense_init.program(ks[3], fc1, (84,)),
        dense_init.program(ks[4], 84, (cfg.num_classes,))))

    def zeros(n):
        return torch.zeros((n,), device=device)

    return {
        "conv1": {"w": w1.reshape(5, 5, 1, 6), "b": zeros(6)},
        "conv2": {"w": w2.reshape(5, 5, 6, 16), "b": zeros(16)},
        "fc1": {"w": w3, "b": zeros(fc1)},
        "fc2": {"w": w4, "b": zeros(84)},
        "fc3": {"w": w5, "b": zeros(cfg.num_classes)},
    }


def _conv_tanh_pool(h, w, b):
    """h (B, G·Cin, H, W); w (G, 5, 5, Cin, Cout) HWIO; b (G, Cout)."""
    g, kh, kw, cin, cout = w.shape
    w_oihw = w.permute(0, 4, 3, 1, 2).reshape(g * cout, cin, kh, kw)
    out = F.conv2d(h, w_oihw, b.reshape(g * cout), groups=g)
    return F.max_pool2d(torch.tanh(out), 2)


def lenet_logits(params, x) -> torch.Tensor:
    """Grouped forward. ``params`` leaves lead with G; ``x`` is NHWC, either
    ``(G, B, H, W, 1)`` (one batch per model) or ``(B, H, W, 1)`` (one batch
    shared by all G). Returns ``(G, B, R)`` logits."""
    g = params["conv1"]["w"].shape[0]
    if x.dim() == 4:
        h = x.permute(0, 3, 1, 2).expand(-1, g, -1, -1)
    else:
        h = x.permute(1, 0, 4, 2, 3).reshape(x.shape[1], g, *x.shape[2:4])
    b = h.shape[0]
    h = _conv_tanh_pool(h.contiguous(), params["conv1"]["w"], params["conv1"]["b"])
    h = _conv_tanh_pool(h, params["conv2"]["w"], params["conv2"]["b"])
    # NHWC flatten per model, as the reference's reshape after its NHWC conv
    h = h.view(b, g, 16, *h.shape[2:]).permute(1, 0, 3, 4, 2).reshape(g, b, -1)
    for name in ("fc1", "fc2"):
        h = torch.tanh(torch.bmm(h, params[name]["w"]) + params[name]["b"][:, None])
    return torch.bmm(h, params["fc3"]["w"]) + params["fc3"]["b"][:, None]


def lenet_nll(params, batch) -> torch.Tensor:
    """Mean cross-entropy per model: ``(G,)``. ``batch['x']`` is
    ``(G, B, H, W, 1)``, ``batch['y']`` is ``(G, B)``."""
    logits = lenet_logits(params, batch["x"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, batch["y"].long()[..., None])[..., 0]
    return nll.mean(dim=-1)


def params_from_jax(np_tree, device="cpu") -> Dict:
    """Reference params (numpy leaves, same layouts) -> tensors."""
    return tree_map(lambda x: torch.from_numpy(np.array(x, np.float32)).to(device),
                    np_tree)


def params_to_numpy(tree) -> Dict:
    """Inverse of :func:`params_from_jax`."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
