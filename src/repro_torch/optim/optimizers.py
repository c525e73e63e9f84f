"""The optimizer substrate (``repro/optim/optimizers.py``): SGD, momentum
(and Nesterov), AdamW with decoupled weight decay, and the cosine
schedules, over trees of tensors (nested dicts and lists, as the models'
params).

The API is the reference's, optax's: ``opt.init(params) -> state``,
``opt.update(grads, state, params) -> (updates, state)``; the updates
carry their sign, so ``tree_map(torch.add, params, updates)`` applies
them. ``state["count"]`` is an int32 scalar tensor on the params' device,
and a schedule ``lr(step)`` reads it as a tensor (no host read), so an
update can sit inside a captured CUDA graph. Every product is in f32, as
the reference's; AdamW's moments are f32 whatever the params' dtype, and
its updates come back in the params' dtype.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _count(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr):
    """``updates = −lr(count)·g``."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"count": _count(params)}

    def update(grads, state, params=None):
        step_lr = lr_fn(state["count"])
        upd = tree_map(lambda g: -step_lr * g, grads)
        return upd, {"count": state["count"] + 1}

    return SimpleNamespace(init=init, update=update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False):
    """Heavy ball: ``μ = β·μ + g``, ``updates = −lr·μ`` (Nesterov: ``−lr·(β·μ
    + g)``)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"count": _count(params),
                "mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        mu = tree_map(lambda m, g: beta * m + g, state["mu"], grads)
        upd_g = (tree_map(lambda m, g: beta * m + g, mu, grads) if nesterov
                 else mu)
        step_lr = lr_fn(state["count"])
        upd = tree_map(lambda u: -step_lr * u, upd_g)
        return upd, {"count": state["count"] + 1, "mu": mu}

    return SimpleNamespace(init=init, update=update)


def _pow(b: float, c: torch.Tensor) -> torch.Tensor:
    """``b ** c`` in f32 for the int32 count ``c``, as the reference's
    ``b ** c.astype(f32)``."""
    return torch.pow(torch.tensor(b, dtype=torch.float32, device=c.device),
                     c.float())


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0):
    """Adam with bias correction and decoupled weight decay: ``updates =
    −lr·(m̂ / (√v̂ + eps) + wd·p)``, the moments in f32."""
    lr_fn = _lr_fn(lr)

    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        return {"count": _count(params), "m": z,
                "v": tree_map(torch.zeros_like, z)}

    def update(grads, state, params):
        c = state["count"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(),
                     state["v"], grads)
        c1, c2 = 1 - _pow(b1, c), 1 - _pow(b2, c)
        mhat = tree_map(lambda x: x / c1, m)
        vhat = tree_map(lambda x: x / c2, v)
        step_lr = lr_fn(state["count"])
        upd = tree_map(
            lambda mh, vh, p: (-step_lr * (mh / (torch.sqrt(vh) + eps)
                                           + weight_decay * p.float())
                               ).to(p.dtype),
            mhat, vhat, params)
        return upd, {"count": c, "m": m, "v": v}

    return SimpleNamespace(init=init, update=update)


def _as_f32(step) -> torch.Tensor:
    return (step.float() if torch.is_tensor(step)
            else torch.tensor(step, dtype=torch.float32))


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    """``base_lr·(min_frac + (1 − min_frac)·½(1 + cos(π·clip(step /
    total, 0, 1))))``, in f32."""
    def lr(step):
        frac = torch.clamp(_as_f32(step) / max(1, total_steps), 0.0, 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5
                          * (1 + torch.cos(math.pi * frac)))
    return lr


def warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                  min_frac: float = 0.1):
    """A linear warmup over ``warmup`` steps, then :func:`cosine_schedule`
    over the rest."""
    cos = cosine_schedule(base_lr, max(1, total_steps - warmup), min_frac)

    def lr(step):
        s = _as_f32(step)
        w = torch.clamp((s + 1) / max(1, warmup), max=1.0)
        return w * cos(torch.clamp(s - warmup, min=0.0))
    return lr


def make_optimizer(name: str, lr, **kw):
    """``sgd``, ``momentum`` or ``adamw`` by name."""
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise ValueError(name)
