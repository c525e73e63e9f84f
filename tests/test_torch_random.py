"""``repro_torch.random`` against ``jax.random`` on the CPU (the threefry
kernel's plain version), and the known-answer file the card is held to.

Exact everywhere: keys, bits, uniforms and randint are integer and
bit-level arithmetic; ``normal`` and ``truncated_normal`` transcribe XLA's
CPU erfinv, log1p and erf op for op (``kernels/threefry.py``), so no ulp
bound is needed. Each normal test prints the share of elements that
differ (0).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lax.special import erf_inv

from repro_torch import random
from repro_torch.config import FedConfig, get_arch
from repro_torch.core.algorithms import make_cdbfl_round
from repro_torch.core.compression import make_compressor
from repro_torch.core.fed_state import init_fed_state
from repro_torch.data.partition import DeviceShards, partition_iid
from repro_torch.data.radar import make_dataset
from repro_torch.kernels import threefry
from repro_torch.models import get_model
from repro_torch.train.engine import round_indices
from torch_golden import THREEFRY_FILE, port_draw, threefry_golden

SIZES = [(1,), (7,), (1024,), (1_000_003,), (3, 1031)]


def _key(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _same_bits(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    if want.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want.astype(got.dtype))


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1])
def test_prng_key_equals_reference(seed):
    _same_bits(random.PRNGKey(seed), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("num", [1, 2, 5, 10])
def test_split_equals_reference(num):
    key = jax.random.PRNGKey(42)
    _same_bits(random.split(_key(key), num), jax.random.split(key, num))
    # a batch of keys splits row by row, as vmap does
    keys = jax.random.split(key, 3)
    _same_bits(random.split(_key(keys), num),
               jax.vmap(lambda k: jax.random.split(k, num))(keys))


@pytest.mark.parametrize("data", [0, 7, 2**32 - 1])
def test_fold_in_equals_reference(data):
    key = jax.random.PRNGKey(42)
    _same_bits(random.fold_in(_key(key), data), jax.random.fold_in(key, data))
    keys = jax.random.split(key, 4)
    want = jax.vmap(lambda k: jax.random.fold_in(jax.random.split(k, 5)[3],
                                                 data))(keys)
    _same_bits(random.split_fold_in(_key(keys), 5, data)[:, 3], want)
    if data < 5:       # fold_in(key, i) is split(key, n)[i]
        _same_bits(random.split(_key(key), 5)[data],
                   jax.random.fold_in(key, data))


@pytest.mark.parametrize("shape", SIZES)
def test_bits_and_uniform_equal_reference(shape):
    key = jax.random.PRNGKey(sum(shape))
    _same_bits(random.bits(_key(key), shape), jax.random.bits(key, shape))
    _same_bits(random.uniform(_key(key), shape), jax.random.uniform(key, shape))
    _same_bits(random.uniform(_key(key), shape, -3.7, 11.3),
               jax.random.uniform(key, shape, minval=-3.7, maxval=11.3))


@pytest.mark.parametrize("shape", [(1,), (7,), (1024,), (1_000_003,),
                                   (40, 25)])
@pytest.mark.parametrize("span", [(0, 1), (0, 7), (0, 50), (-5, 45),
                                  (4, 4), (9, 2), (-2**31, 2**31 - 1)])
def test_randint_equals_reference(shape, span):
    """Spans 1, 7 and 50, an empty span (``maxval <= minval`` gives
    ``minval``) and the whole int32 range."""
    key = jax.random.PRNGKey(11)
    _same_bits(random.randint(_key(key), shape, *span),
               jax.random.randint(key, shape, *span))


def test_randint_per_row_maxvals_equal_reference():
    """One bound a key, as ``DeviceShards`` draws each node over its own
    shard length."""
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    sizes = np.array([1, 7, 50, 123457], np.int32)
    want = jax.vmap(lambda k, n: jax.random.randint(k, (6, 9), 0, n))(
        keys, jnp.asarray(sizes))
    _same_bits(random.randint(_key(keys), (6, 9), 0,
                              torch.from_numpy(sizes).long()), want)


def _differ_share(got: torch.Tensor, want) -> float:
    bad = got.numpy().view(np.int32) != np.asarray(want).view(np.int32)
    return float(bad.mean())


@pytest.mark.parametrize("shape", [(1,), (7,), (1_000_003,), (3, 1031)])
def test_normal_and_truncated_normal_equal_reference(shape):
    key = jax.random.PRNGKey(5)
    draws = {
        "normal": (random.normal(_key(key), shape),
                   jax.random.normal(key, shape)),
        "truncated_normal": (
            random.truncated_normal(_key(key), -2.0, 2.0, shape),
            jax.random.truncated_normal(key, -2.0, 2.0, shape)),
        "truncated_normal(-1.5, 0.7)": (
            random.truncated_normal(_key(key), -1.5, 0.7, shape),
            jax.random.truncated_normal(key, -1.5, 0.7, shape)),
    }
    for name, (got, want) in draws.items():
        print(f"{name} {shape}: {_differ_share(got, want):.3g} of the "
              f"elements differ from jax.random")
        _same_bits(got, want)


def test_scaled_normal_is_the_jitted_product():
    """``normal(key, shape, scale)`` is ``scale · normal(key, shape)`` as
    XLA runs it inside ``jit``: ``erfinv · fl32(√2 · scale)``."""
    key = jax.random.PRNGKey(6)
    scale = np.float32(np.sqrt(np.float32(2.0 * 3e-3 * 0.2)))
    want = jax.jit(lambda k: scale * jax.random.normal(k, (4099,)))(key)
    _same_bits(random.normal(_key(key), (4099,), scale=float(scale)), want)


@pytest.mark.parametrize("bounds", [(-1.0, 1.0), (-2.0, 2.0)])
def test_erfinv_transcription_exact_on_every_uniform(bounds):
    """Every one of the 2**23 uniforms a draw can give, through the
    reference's own ``√2 · erf_inv(max(lo, u·(hi − lo) + lo))``: ``normal``'s
    range and ``truncated_normal(−2, 2)``'s."""
    if bounds == (-1.0, 1.0):
        lo, hi = random.NORMAL_LO, 1.0
    else:
        lo, hi, _, _ = random.truncation(*bounds)
    sqrt2 = np.float32(np.sqrt(2))

    @jax.jit
    def ref(b):
        f = jax.lax.bitcast_convert_type(
            (b >> 9) | jnp.uint32(0x3F800000), jnp.float32) - 1.0
        u = jnp.maximum(jnp.float32(lo),
                        f * (jnp.float32(hi) - jnp.float32(lo))
                        + jnp.float32(lo))
        return sqrt2 * erf_inv(u)

    bad = 0
    for chunk in range(4):
        b = np.arange(chunk << 21, (chunk + 1) << 21,
                      dtype=np.uint32) << np.uint32(9)
        want = np.asarray(ref(jnp.asarray(b)))
        u = threefry.uniform_plain(torch.from_numpy(b.astype(np.int64)), lo,
                                   hi)
        got = (threefry.erfinv_plain(u) * threefry.SQRT2).numpy()
        bad += int((got.view(np.int32) != want.view(np.int32)).sum())
    print(f"bounds {bounds}: {bad} of 2**23 uniforms differ")
    assert bad == 0


@pytest.mark.parametrize("bounds", [(-2.0, 2.0), (-1.5, 0.7), (0.3, 3.1),
                                    (-6.0, 6.0)])
def test_truncation_bounds_equal_reference(bounds):
    """XLA's f32 erf of ``bound · fl32(1/√2)``."""
    from jax._src.lax.special import erf
    recip = np.float32(1) / np.float32(np.sqrt(2))
    want = [float(jax.jit(erf)(np.float32(b) * recip)) for b in bounds]
    assert list(random.truncation(*bounds)[:2]) == want


def test_golden_file_is_what_jax_gives_now():
    """``tests/golden/threefry_draws.npz`` (``tests/torch_golden.py``)."""
    stored = np.load(THREEFRY_FILE)
    fresh = threefry_golden()
    assert sorted(stored.files) == sorted(fresh)
    for name, want in fresh.items():
        np.testing.assert_array_equal(stored[name], want, err_msg=name)


def test_port_reproduces_the_golden_file():
    stored = np.load(THREEFRY_FILE)
    for name, fn, seed, args in json.loads(str(stored["cases"])):
        _same_bits(port_draw(fn, seed, args), stored[name])


def test_round_keys_cost_one_launch_a_level(monkeypatch):
    """The engine's minibatch draw and the round's noise and uniforms run
    side by side: four table launches for a round (the kround split, the
    node keys, the leaf keys, the draws) plus the engine's own split."""
    fed = FedConfig(num_nodes=3, local_steps=2, pipeline="block_topk|qsgd",
                    fused_compress=True)
    model = get_model(get_arch("lenet-radar", reduced=True))
    params = init_fed_state(model.init(random.PRNGKey(0), "cpu"), fed).params
    omega = np.full((3, 3), 1 / 3, np.float32)
    round_fn = make_cdbfl_round(model.nll, fed, omega, make_compressor(fed),
                                1.0, "cpu")
    shards = DeviceShards.from_shards(partition_iid(
        make_dataset(30, hw=(32, 16), seed=0), 3), "cpu")
    calls = []
    draw = threefry.draw
    monkeypatch.setattr(threefry, "draw",
                        lambda reqs: calls.append(len(reqs)) or draw(reqs))
    key, kround = random.split(random.PRNGKey(1))
    idx, (noise, uniforms) = random.run(random.together(
        round_indices.program(shards, kround, 2, 5),
        round_fn.draws.program(kround, params)))
    # requests a launch: the engine's split; fold_in(kround, 7) and
    # split(kround); the three node-key splits; randint's split and the two
    # per-leaf splits; 2 bit streams, 10 noise leaves, 10 uniform leaves
    assert calls == [1, 2, 3, 3, 2 + 10 + 10]
    assert idx.shape == (3, 2, 5) and len(uniforms) == 10


# -- permutation and choice (ROADMAP C15) ----------------------------------

@pytest.mark.parametrize("n", list(range(1, 33)))
def test_permutation_and_choice_equal_reference(n):
    """``jax.random.permutation(key, n)`` and ``choice(key, n, (d,),
    replace=False)`` for every d <= n, over 12 keys: exact (one stable sort
    of 32-bit keys below 1,626 elements, none for one element)."""
    for seed in range(12):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), n)
        key = _key(jkey)
        got = random.permutation(key, n)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax.random.permutation(jkey, n)))
        for d in sorted({1, (n + 1) // 2, n}):
            np.testing.assert_array_equal(
                random.choice(key, n, (d,), replace=False).numpy(),
                np.asarray(jax.random.choice(jkey, n, (d,), replace=False)))
    assert random.shuffle_rounds(n) == (0 if n == 1 else 1)


@pytest.mark.parametrize("n", [1626, 4099])
def test_permutation_of_two_sorts_equals_reference(n):
    """Past 1,625 elements ``_shuffle`` sorts twice, each under a fresh
    split of the key."""
    assert random.shuffle_rounds(n) == 2
    jkey = jax.random.PRNGKey(n)
    np.testing.assert_array_equal(random.permutation(_key(jkey), n).numpy(),
                                  np.asarray(jax.random.permutation(jkey, n)))


def test_choice_with_replacement_and_batched_keys_equal_reference():
    """``replace=True`` is ``randint(key, shape, 0, n)``; a batch of keys
    draws one stream a key, as ``vmap`` does; too large a sample raises."""
    jkeys = jax.random.split(jax.random.PRNGKey(3), 4)
    got = random.choice(_key(jkeys), 9, (2, 5))
    want = jax.vmap(lambda k: jax.random.choice(k, 9, (2, 5)))(jkeys)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = random.choice(_key(jkeys), 9, (4,), replace=False)
    want = jax.vmap(lambda k: jax.random.choice(k, 9, (4,),
                                                replace=False))(jkeys)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="larger sample"):
        random.choice(_key(jkeys[0]), 3, (4,), replace=False)
