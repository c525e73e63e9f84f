"""The port's LeNet against the reference's: the same parameters (carried
across with ``params_from_jax``), the same inputs made with numpy; and the
port's init from a key against the reference's from the same key.

Tolerance rtol 1e-5 / atol 1e-6 in f32: the convolutions and matmuls sum
their products in another order than XLA does, which moves the last bits.
The init is exact: its truncated normals transcribe XLA's arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.models import lenet as jlenet
from repro_torch import random
from repro_torch.config import get_arch
from repro_torch.models import get_model
from repro_torch.models.lenet import (lenet_logits, lenet_nll, params_from_jax,
                                      params_to_numpy)
from repro_torch.utils.tree import tree_leaves_with_path, tree_map

RTOL, ATOL = 1e-5, 1e-6


def _setup(reduced, batch=6, seed=0):
    arch = jax_get_arch("lenet-radar")
    cfg = arch.reduced if reduced else arch.config
    params = jlenet.init_lenet(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch,) + cfg.input_hw + (1,)).astype(np.float32)
    y = rng.integers(0, 10, batch).astype(np.int32)
    return params, x, y


def _stack(tree):
    return tree_map(lambda t: t[None], tree)


def test_params_round_trip():
    params, _, _ = _setup(reduced=True)
    np_params = jax.tree.map(np.asarray, params)
    back = params_to_numpy(params_from_jax(np_params))
    for (path, a), b in zip(tree_leaves_with_path(back),
                            jax.tree.leaves(np_params)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("reduced", [True, False])
def test_logits_match_reference(reduced):
    params, x, _ = _setup(reduced, batch=4 if not reduced else 6)
    want = jlenet.lenet_logits(params, jnp.asarray(x))
    p = params_from_jax(jax.tree.map(np.asarray, params))
    got = lenet_logits(_stack(p), torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_grouped_forward_runs_each_model_on_its_batch():
    """G models with their own batches == G single-model forwards."""
    params = [params_from_jax(jax.tree.map(np.asarray, _setup(True, seed=s)[0]))
              for s in range(3)]
    xs = np.stack([_setup(True, seed=s)[1] for s in range(3)])
    stacked = tree_map(lambda *a: torch.stack(a), *params)
    got = lenet_logits(stacked, torch.from_numpy(xs))
    for g in range(3):
        one = lenet_logits(_stack(params[g]), torch.from_numpy(xs[g]))[0]
        torch.testing.assert_close(got[g], one, rtol=RTOL, atol=ATOL)


def test_gradients_match_reference():
    params, x, y = _setup(reduced=True)
    grads = jax.grad(lambda p: jlenet.lenet_loss(
        p, {"x": jnp.asarray(x), "y": jnp.asarray(y)})[0])(params)
    p = _stack(params_from_jax(jax.tree.map(np.asarray, params)))
    leaves = [t.requires_grad_(True) for _, t in tree_leaves_with_path(p)]
    nll = lenet_nll(p, {"x": torch.from_numpy(x)[None],
                        "y": torch.from_numpy(y)[None]})
    got = torch.autograd.grad(nll.sum(), leaves)
    for (path, _), g, w in zip(tree_leaves_with_path(p), got,
                               jax.tree.leaves(grads)):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=path)


def test_full_width_model_size():
    """lenet-radar at the paper's 256x63: 2,598,846 parameters, fc1.w is
    (11712, 220) — the reference's shapes, leaf for leaf."""
    cfg = get_arch("lenet-radar")
    p = get_model(cfg).init(random.PRNGKey(0, "meta"), "meta")
    shapes = {k: tuple(v.shape) for k, v in tree_leaves_with_path(p)}
    ref = jax.eval_shape(lambda k: jlenet.init_lenet(
        k, jax_get_arch("lenet-radar").config), jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(k)[2:-2].replace("']['", "."): v.shape
            for k, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert shapes == want
    assert sum(int(np.prod(s)) for s in shapes.values()) == 2_598_846
    assert shapes["fc1.w"] == (11712, 220)


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1])
def test_init_equals_reference(seed):
    """``init_lenet(cfg, PRNGKey(seed))`` equals the reference's
    ``init_lenet(PRNGKey(seed), cfg)`` bit for bit, leaf for leaf (reduced
    width; the full width's shapes are held above)."""
    cfg = get_arch("lenet-radar", reduced=True)
    want = jlenet.init_lenet(jax.random.PRNGKey(seed),
                             jax_get_arch("lenet-radar").reduced)
    got = get_model(cfg).init(random.PRNGKey(seed), "cpu")
    for (path, g), w in zip(tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        assert g.dtype == torch.float32 and g.shape == w.shape, path
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32),
                                      err_msg=path)
