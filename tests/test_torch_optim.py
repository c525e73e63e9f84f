"""The port's optimizers and schedules (``repro_torch.optim``) against the
reference's (``repro.optim``): SGD, momentum and Nesterov momentum, AdamW
with and without weight decay, each under a constant rate and under the
cosine schedules, five steps on a tree of an f32 matrix and an f32 vector,
the gradients and the schedules' steps the same on both sides.

Tolerances: updates, params and optimizer state within rtol 1e-6 / atol
1e-7 after five steps (both compute in f32; XLA contracts ``β·m + g`` and
AdamW's products into fused multiply-adds where torch rounds each), the
schedules' rates within rtol 1e-6 (the same cos of the same f32 argument,
to its last bit). The ``count`` exact. ``TrainConfig`` has the reference's
fields and defaults.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.config import TrainConfig as JaxTrainConfig
from repro_torch import optim
from repro_torch.config import TrainConfig
from repro_torch.utils.tree import tree_leaves, tree_map

import torch_threads  # noqa: F401  (one torch thread a process)

STEPS = 5
RTOL, ATOL = 1e-6, 1e-7


def _schedules(lib):
    return {"constant": 0.05,
            "cosine": lib.cosine_schedule(0.05, 4),
            "warmup_cosine": lib.warmup_cosine(0.05, 2, 6)}


OPTS = {"sgd": ("sgd", {}), "momentum": ("momentum", {"beta": 0.9}),
        "nesterov": ("momentum", {"beta": 0.8, "nesterov": True}),
        "adamw": ("adamw", {}),
        "adamw_wd": ("adamw", {"weight_decay": 0.1, "b1": 0.8, "eps": 1e-6})}


def _params(rng):
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}


def _close(got, want, what):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=what)


@pytest.mark.parametrize("schedule", list(_schedules(jax_optim)))
@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_steps_are_the_references(name, schedule):
    kind, kw = OPTS[name]
    jopt = jax_optim.make_optimizer(kind, _schedules(jax_optim)[schedule],
                                    **kw)
    popt = optim.make_optimizer(kind, _schedules(optim)[schedule], **kw)
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    pp = tree_map(torch.from_numpy, p0)
    jstate, pstate = jopt.init(jp), popt.init(pp)
    update = jax.jit(jopt.update)
    for step in range(STEPS):
        g = tree_map(lambda x: (x * rng.standard_normal(x.shape)).astype(
            np.float32), p0)
        jupd, jstate = update(jax.tree.map(jnp.asarray, g), jstate, jp)
        pupd, pstate = popt.update(tree_map(torch.from_numpy, g), pstate, pp)
        _close(pupd, jupd, f"{name} updates, step {step}")
        jp = jax.tree.map(jnp.add, jp, jupd)
        pp = tree_map(torch.add, pp, pupd)
        assert int(pstate["count"]) == int(jstate["count"]) == step + 1
    _close(pp, jp, f"{name} params")
    for key in pstate:
        if key != "count":
            _close(pstate[key], jstate[key], f"{name} state {key}")


def test_schedules_are_the_references():
    for name, jfn in _schedules(jax_optim).items():
        if not callable(jfn):
            continue
        pfn = _schedules(optim)[name]
        for step in range(9):
            want = float(jax.jit(jfn)(jnp.int32(step)))
            got = float(pfn(torch.tensor(step, dtype=torch.int32)))
            assert got == pytest.approx(want, rel=RTOL), (name, step)
            assert float(pfn(step)) == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("make_opt", [
    lambda: optim.sgd(0.1),
    lambda: optim.momentum(0.05, 0.9),
    lambda: optim.adamw(0.05, weight_decay=0.0),
])
def test_optimizers_minimize_quadratic(make_opt):
    """The reference's own check (``tests/test_substrate.py``)."""
    opt = make_opt()
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = tree_map(lambda p: 2 * p, params)
        upd, state = opt.update(grads, state, params)
        params = tree_map(torch.add, params, upd)
    assert float(torch.linalg.norm(params["w"])) < 1e-2


def test_unknown_optimizer_raises_and_train_config_is_the_references():
    with pytest.raises(ValueError):
        optim.make_optimizer("lion", 0.1)
    assert ([(f.name, f.default) for f in dataclasses.fields(TrainConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(
                JaxTrainConfig)])
