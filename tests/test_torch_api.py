"""The port's public API against the reference's (ROADMAP C20-C22).

- C20: ``get_arch`` returns an ``ArchSpec`` (``.config``, ``.reduced``,
  ``source``, ``notes``, ``skips``) equal field for field to the
  reference's registry entry; an unknown id raises ``KeyError``, an id the
  reference knows and the port does not runs into ``NotImplementedError``
  naming its part of A12 (the dense LMs run since A12's part 1).
- C21: ``core.calibration.predictive_entropy`` is the batch mean, the
  per-example entropy is ``core.posterior``'s, each within rtol 1e-6.
- C22: every subpackage exports the reference's public names (``__all__``
  where the reference has one), the shard path's stand-ins raise naming
  A10, and the quickstart's import works.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import repro.config as jconfig
from repro_torch import config

import torch_threads  # noqa: F401  (one torch thread a process)

# (reference module, port module): the packages whose names are compared
SUBPACKAGES = (("repro.core", "repro_torch.core"),
               ("repro.train", "repro_torch.train"),
               ("repro.eval", "repro_torch.eval"),
               ("repro.serve", "repro_torch.serve"),
               ("repro.checkpoint", "repro_torch.checkpoint"))
A10_STANDINS = (("repro_torch.core", "ShardContext"),
                ("repro_torch.core", "ShardMixStats"),
                ("repro_torch.core", "make_shard_mixer"),
                ("repro_torch.core", "plan_shard_mix"),
                ("repro_torch.eval", "ShardEvalEngine"))


def _same_config(mine, ref):
    """Field for field; a nested config (``moe``) by its fields."""
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, (mine.name, f.name)


def test_c20_get_arch_returns_the_reference_arch_spec():
    got, want = config.get_arch("lenet-radar"), jconfig.get_arch("lenet-radar")
    assert type(got).__name__ == type(want).__name__ == "ArchSpec"
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for name in ("arch_id", "source", "notes", "skips"):
        assert getattr(got, name) == getattr(want, name)
    for name in ("config", "reduced"):
        _same_config(getattr(got, name), getattr(want, name))
    assert got.reduced.input_hw == (32, 16) and got.config.input_hw == (256, 63)
    assert config.list_archs() == ["deepseek-v2-236b", "grok-1-314b",
                                   "lenet-radar", "llava-next-mistral-7b",
                                   "mistral-large-123b", "qwen2.5-14b",
                                   "recurrentgemma-9b", "smollm-135m",
                                   "whisper-tiny", "xlstm-1.3b", "yi-9b"]


def test_c20_unknown_and_unported_archs():
    """An unknown id raises ``KeyError`` in both packages; every arch of
    the reference's registry is the port's (A12 is done: none is left
    unported)."""
    with pytest.raises(KeyError):
        jconfig.get_arch("no-such-arch")
    with pytest.raises(KeyError):
        config.get_arch("no-such-arch")
    assert config.list_archs() == sorted(jconfig.list_archs())
    for arch in jconfig.list_archs():
        _same_config(config.get_arch(arch).config,
                     jconfig.get_arch(arch).config)


def test_c20_register_arch():
    spec = config.ArchSpec(arch_id="lenet-tiny",
                           config=config.LENET_RADAR_REDUCED,
                           reduced=config.LENET_RADAR_REDUCED, source="test")
    try:
        assert config.register_arch(spec) is spec
        assert config.get_arch("lenet-tiny").reduced.input_hw == (32, 16)
        assert config.get_arch("lenet-tiny").skips == {}
    finally:
        config._ARCHS.pop("lenet-tiny")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_c21_predictive_entropy_is_the_batch_mean(seed):
    import jax.numpy as jnp
    from repro.core import calibration as jcal
    from repro.core import posterior as jpost
    from repro_torch.core import calibration, posterior
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((37, 10)).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[0] = 0.0
    probs[0, 3] = 1.0                          # a zero probability
    got = calibration.predictive_entropy(torch.from_numpy(probs))
    want = jcal.predictive_entropy(jnp.asarray(probs))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    per = posterior.predictive_entropy(torch.from_numpy(probs))
    np.testing.assert_allclose(per.numpy(),
                               np.asarray(jpost.predictive_entropy(probs)),
                               rtol=1e-6)
    # the issue's case: the mean of two rows, 0.94536
    two = torch.tensor([[.7, .2, .1], [.3, .3, .4]])
    np.testing.assert_allclose(float(calibration.predictive_entropy(two)),
                               float(jcal.predictive_entropy(
                                   jnp.asarray(two.numpy()))), rtol=1e-6)


@pytest.mark.parametrize("ref,port", SUBPACKAGES)
def test_c22_public_names_equal_the_reference(ref, port):
    jmod, mod = importlib.import_module(ref), importlib.import_module(port)
    if hasattr(jmod, "__all__"):
        assert list(mod.__all__) == list(jmod.__all__)
        names = jmod.__all__
    else:
        names = [n for n in dir(jmod) if not n.startswith("_")
                 and not isinstance(getattr(jmod, n), type(jmod))]
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, f"{port} lacks {missing}"


@pytest.mark.parametrize("module,name", A10_STANDINS)
def test_c22_shard_standins_raise_naming_a10(module, name):
    fn = getattr(importlib.import_module(module), name)
    assert callable(fn) and fn.__name__ == name
    with pytest.raises(NotImplementedError, match="A10"):
        fn()


def test_c22_quickstart_imports_and_round_data_key():
    """The quickstart's import line, and ``round_data_key`` exact against
    the reference's."""
    import jax
    from repro.train import round_data_key as jax_round_data_key
    from repro_torch import random
    from repro_torch.core import (init_fed_state, make_cdbfl_round,  # noqa
                                  make_compressor, mixing_matrix)
    from repro_torch.train import (HostRoundEngine, ScanRoundEngine,  # noqa
                                   make_engine, round_data_key)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_round_data_key(key)).astype(np.int64)
    got = round_data_key(random.PRNGKey(7))
    assert got.tolist() == want.tolist()
