"""The port's copied data path is byte-equal to the reference's, and its
device shards draw the reference's minibatch indices from the same key."""
import numpy as np
import pytest
import torch

from repro.data import partition as jpartition
from repro.data import radar as jradar
from repro_torch import random
from repro_torch.data import radar
from repro_torch.data.partition import DeviceShards, partition_iid

import torch_threads  # noqa: F401  (one torch thread a process)


@pytest.mark.parametrize("day,hw", [(1, (32, 16)), (2, (32, 16)), (1, (256, 63))])
def test_make_dataset_is_byte_equal(day, hw):
    n = 12 if hw == (256, 63) else 40
    want = jradar.make_dataset(n, hw=hw, day=day, seed=3)
    got = radar.make_dataset(n, hw=hw, day=day, seed=3)
    for f in ("x", "y"):
        assert got[f].dtype == want[f].dtype
        assert got[f].tobytes() == want[f].tobytes()
    crit_want, crit_got = jradar.critical_subset(want), radar.critical_subset(got)
    for f in ("x", "y"):
        assert crit_got[f].tobytes() == crit_want[f].tobytes()


def test_partition_iid_is_byte_equal():
    ds = jradar.make_dataset(53, hw=(32, 16), seed=0)
    for g, w in zip(partition_iid(ds, 5, seed=1), jpartition.partition_iid(ds, 5, seed=1)):
        for f in ("x", "y"):
            assert g[f].tobytes() == w[f].tobytes()


def test_device_shards_gather_handed_indices():
    """Handed (K, L, M) indices gather exactly the reference's rows."""
    ds = radar.make_dataset(23, hw=(32, 16), seed=0)
    shards = partition_iid(ds, 3)
    dev = DeviceShards.from_shards(shards, "cpu")
    assert dev.sizes == (8, 8, 7)
    ref = jpartition.DeviceShards.from_shards(shards)
    import jax
    idx = np.asarray(ref.sample_indices(jax.random.PRNGKey(0), 2, 4))
    want = ref.gather(idx)
    got = dev.gather(idx)
    for f in ("x", "y"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))
    drawn = dev.sample_indices(random.PRNGKey(0), 2, 4)
    assert drawn.shape == (3, 2, 4)
    np.testing.assert_array_equal(drawn.numpy(), idx)
    assert all(int(drawn[k].max()) < n for k, n in enumerate(dev.sizes))


@pytest.mark.parametrize("seed,k,l,m", [(0, 3, 2, 4), (5, 10, 8, 10),
                                        (2**31 - 1, 4, 3, 7)])
def test_sample_indices_equal_reference(seed, k, l, m):
    """``DeviceShards.sample_indices`` from a key equals the reference's
    from the same key exactly, shards of unequal lengths included."""
    import jax
    ds = radar.make_dataset(9 * k + 2, hw=(32, 16), seed=seed % 7)
    shards = partition_iid(ds, k)
    want = jpartition.DeviceShards.from_shards(shards).sample_indices(
        jax.random.PRNGKey(seed), l, m)
    got = DeviceShards.from_shards(shards, "cpu").sample_indices(
        random.PRNGKey(seed), l, m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("alpha,seed,k", [(0.5, 0, 5), (0.1, 3, 7),
                                          (10.0, 1, 3), (0.01, 2, 10)])
def test_partition_dirichlet_is_byte_equal(alpha, seed, k):
    """Label-skewed shards, the empty-shard guarantee included (alpha
    0.01 over 10 nodes leaves some node no example)."""
    from repro_torch.data.partition import partition_dirichlet
    ds = jradar.make_dataset(61, hw=(32, 16), seed=seed)
    got = partition_dirichlet(ds, k, alpha=alpha, seed=seed)
    want = jpartition.partition_dirichlet(ds, k, alpha=alpha, seed=seed)
    assert len(got) == len(want) == k
    for g, w in zip(got, want):
        for f in ("x", "y"):
            assert g[f].dtype == w[f].dtype
            assert g[f].tobytes() == w[f].tobytes()


@pytest.mark.parametrize("l,m", [(1, 1), (4, 5), (8, 10)])
def test_minibatch_stack_is_byte_equal(l, m):
    from repro_torch.data.partition import minibatch_stack
    shards = partition_iid(jradar.make_dataset(37, hw=(32, 16), seed=1), 4)
    got = minibatch_stack(shards, l, m, np.random.default_rng(5))
    want = jpartition.minibatch_stack(shards, l, m, np.random.default_rng(5))
    for f in ("x", "y"):
        assert got[f].shape == (4, l, m) + want[f].shape[3:]
        assert got[f].tobytes() == want[f].tobytes()
