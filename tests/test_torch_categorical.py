"""The decode sampler's draws against ``jax.random``, on the CPU.

- XLA's f32 log (``kernels/threefry.py: log_plain``, the ``log_xla`` of
  ``csrc/threefry.cuh``) bit for bit against ``jax.jit(jnp.log)`` on 10^6
  uniforms, their negated logs and the edges (tiny, 1, ±0, ±inf, NaN,
  negatives, subnormals, which XLA reads as zero). A NaN equals any NaN:
  XLA's CPU code may set a NaN's sign bit.
- ``random.gumbel`` (the threefry table's ``GUMBEL`` transform) and
  ``random.categorical`` exact against ``jax.random``: V = 49,152, batched
  keys, ties, −inf logits, a NaN.
- The BMA sampler's plain version (``kernels/bma_sample.py``) against the
  reference's decode step arithmetic run by XLA (``jit`` of the engine's
  softmax, mean, entropy and categorical): tokens equal where the
  reference's top two perturbed scores are more than 1e-4 apart (every one
  here), probabilities within 1e-6 absolute, entropies within rtol 1e-5
  (XLA's exp and summation order differ from the port's float64 sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random
from repro_torch.core.posterior import predictive_entropy
from repro_torch.kernels.bma_sample import (argmax_first, bma_sample,
                                            bma_sample_plain)
from repro_torch.kernels.threefry import (GUMBEL, TINY, Draw, draw,
                                          log_plain)

V = 49152


def _same(got: np.ndarray, want: np.ndarray) -> bool:
    """Bit for bit, a NaN equal to any NaN."""
    nan = np.isnan(want)
    return bool(np.array_equal(np.isnan(got), nan) and np.array_equal(
        got[~nan].view(np.int32), want[~nan].view(np.int32)))


def test_log_is_xla_log_bit_for_bit():
    rng = np.random.default_rng(0)
    u = rng.random(1_000_000, dtype=np.float32)
    u = np.maximum(u, np.float32(TINY))
    f32 = np.finfo(np.float32)
    edges = np.array([f32.tiny, 1.0, 0.0, -0.0, np.inf, -np.inf, np.nan,
                      -1.0, 1e-45, -1e-45, 1e-40, f32.max, 0.5, 2.0,
                      np.nextafter(np.float32(1), np.float32(0))],
                     np.float32)
    x = np.concatenate([u, -np.asarray(jax.jit(jnp.log)(u)), edges])
    want = np.asarray(jax.jit(jnp.log)(x))
    assert _same(log_plain(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("seed,shape", [(0, (V,)), (1, (7,)),
                                        (2, (3, 1031)), (3, (1,))])
def test_gumbel_is_jax_gumbel(seed, shape):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    got = random.gumbel(random.PRNGKey(seed), shape).numpy()
    assert _same(got, want)


def test_gumbel_with_batched_keys_and_the_table_transform():
    keys = jax.random.split(jax.random.PRNGKey(4), 5)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (513,)))(keys))
    pk = torch.from_numpy(np.asarray(keys).astype(np.int64))
    assert _same(random.gumbel(pk, (513,)).numpy(), want)
    table, = draw([Draw(pk, 513, GUMBEL, params=(TINY, 1.0))])
    assert _same(table.numpy(), want)


def _logits(seed):
    rng = np.random.default_rng(seed)
    lg = rng.normal(size=(6, V)).astype(np.float32)
    lg[1, :] = 0.25                              # every index tied
    lg[2, :] = -np.inf
    lg[2, [11, 40000]] = [0.0, 0.0]              # two finite, tied
    lg[3, ::2] = -np.inf
    lg[4, 17] = 60.0                             # one certain winner
    lg[5, 123] = np.nan
    return lg


def test_categorical_is_jax_categorical_batched():
    lg = _logits(0)
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, lg))
    got = random.categorical(torch.from_numpy(np.asarray(keys).astype(
        np.int64)), torch.from_numpy(lg)).numpy()
    assert got.tolist() == want.tolist()
    assert got[4] == 17 and got[5] == 123 and got[2] in (11, 40000)


def test_categorical_is_jax_categorical_one_key():
    lg = _logits(1)[:5]
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(9), lg))
    got = random.categorical(random.PRNGKey(9), torch.from_numpy(lg))
    assert got.tolist() == want.tolist()
    want0 = np.asarray(jax.random.categorical(jax.random.PRNGKey(9), lg.T,
                                              axis=0))
    got0 = random.categorical(random.PRNGKey(9), torch.from_numpy(lg.T),
                              axis=0)
    assert got0.tolist() == want0.tolist()
    with pytest.raises(ValueError, match="lead"):
        random.categorical(torch.zeros((3, 2), dtype=torch.int64),
                           torch.from_numpy(lg))


def test_argmax_first_is_jnp_argmax():
    x = np.array([[1, 3, 3, 2], [np.nan, 5, np.nan, 1], [-np.inf] * 4,
                  [0, np.inf, np.inf, 1], [2, 1, np.nan, 2]], np.float32)
    assert argmax_first(torch.from_numpy(x)).tolist() == \
        np.asarray(jnp.argmax(x, axis=-1)).tolist()


def _reference_step(logits, keys, pos, temp):
    """The reference engine's sampling arithmetic, jitted as its step is."""
    from repro.core.posterior import predictive_entropy as jent

    @jax.jit
    def step(lg, ks, ps):
        probs = jnp.mean(jax.nn.softmax(lg.astype(jnp.float32) / temp,
                                        axis=-1), axis=0)
        ent = jent(probs)
        lp = jnp.log(jnp.maximum(probs, 1e-12))

        def sample(k, p, row):
            kk = jax.random.fold_in(k, p)
            return jax.random.categorical(kk, row), \
                jax.random.gumbel(kk, row.shape) + row
        nxt, scores = jax.vmap(sample)(ks, ps, lp)
        return nxt, probs, ent, scores
    return [np.asarray(a) for a in step(logits, keys, pos)]


@pytest.mark.parametrize("dtype,samples,temp", [
    ("float32", 4, 1.0), ("bfloat16", 4, 1.0), ("float32", 2, 0.5)])
def test_bma_sampler_matches_the_reference_step(dtype, samples, temp):
    rng = np.random.default_rng(samples)
    slots, vocab = 5, 4099
    lg = (rng.normal(size=(samples, slots, vocab)) * 3).astype(np.float32)
    lg[:, 1, 200:] = -np.inf                       # a slot of few tokens
    jl = jnp.asarray(lg).astype(dtype)
    keys = jax.random.split(jax.random.PRNGKey(samples), slots)
    pos = np.arange(slots, dtype=np.int32) * 7
    nxt, probs, ent, scores = _reference_step(jl, keys, jnp.asarray(pos),
                                              temp)
    top2 = -np.sort(-scores, axis=-1)[:, :2]
    assert (top2[:, 0] - top2[:, 1] > 1e-4).all()
    pl = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    pk = torch.from_numpy(np.asarray(keys).astype(np.int64))
    got = bma_sample(pl, pk, torch.from_numpy(pos).long(), temp)
    plain = bma_sample_plain(pl, pk, torch.from_numpy(pos).long(), temp)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert got[0].tolist() == nxt.tolist()
    np.testing.assert_allclose(got[1].numpy(), probs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), ent, rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(),
                               predictive_entropy(got[1]).numpy(), rtol=1e-5)
    out = tuple(torch.zeros_like(t) for t in got)
    assert bma_sample(pl, pk, torch.from_numpy(pos).long(), temp,
                      out=out) is out
    assert all(torch.equal(a, b) for a, b in zip(out, got))
