"""``mce``, ``render_reliability`` and ``predictive_entropy`` of
``repro_torch.core.calibration`` against the reference's.

- ``mce``: within 1e-6 absolute (a maximum over per-bin means, which the
  port sums in a fixed order and the reference by scatter-adds).
- ``render_reliability``: the reference's string character for character,
  on bins the port computes and on the reference's own bins.
- ``predictive_entropy``: the batch mean, within rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro_torch.core import calibration as cal

import torch_threads  # noqa: F401  (one torch thread a process)


def _case(seed, n=300, c=10, temp=2.0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c)).astype(np.float32) * temp
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.integers(0, c, n).astype(np.int32)
    return probs.astype(np.float32), labels


@pytest.mark.parametrize("seed,bins", [(0, 10), (1, 15), (2, 5), (3, 20)])
def test_mce_matches_reference(seed, bins):
    probs, labels = _case(seed)
    got = cal.mce(torch.from_numpy(probs), torch.from_numpy(labels), bins)
    want = jcal.mce(jnp.asarray(probs), jnp.asarray(labels), bins)
    assert abs(float(got) - float(want)) <= 1e-6
    assert float(got) >= float(cal.ece(torch.from_numpy(probs),
                                       torch.from_numpy(labels), bins)) - 1e-7


def test_mce_ignores_empty_bins():
    probs = np.full((4, 2), 0.5, np.float32)
    probs[:, 0] = 0.95
    probs[:, 1] = 0.05
    labels = np.zeros(4, np.int32)
    got = cal.mce(torch.from_numpy(probs), torch.from_numpy(labels))
    want = jcal.mce(jnp.asarray(probs), jnp.asarray(labels))
    assert abs(float(got) - float(want)) <= 1e-6


@pytest.mark.parametrize("seed,temp", [(0, 2.0), (4, 0.3), (5, 6.0)])
@pytest.mark.parametrize("title", ["", "cdbfl|- day23_critical@1"])
def test_render_reliability_matches_reference(seed, temp, title):
    probs, labels = _case(seed, n=120, temp=temp)
    jbins = jcal.reliability_bins(jnp.asarray(probs), jnp.asarray(labels))
    bins = cal.reliability_bins(torch.from_numpy(probs),
                                torch.from_numpy(labels))
    want = jcal.render_reliability(jbins, title)
    assert cal.render_reliability(jbins, title) == want
    assert cal.render_reliability(bins, title) == want


@pytest.mark.parametrize("seed", [0, 7])
def test_predictive_entropy_mean(seed):
    probs, _ = _case(seed)
    got = cal.predictive_entropy(torch.from_numpy(probs))
    want = jcal.predictive_entropy(jnp.asarray(probs))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
