"""The port's checkpoints against the reference's (``repro/checkpoint``): one
format, so a checkpoint or a posterior-bank snapshot written by either
package loads in the other bit for bit, bfloat16 leaves included, under a
``like=`` tree and under the manifest's key paths."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch import checkpoint as ckpt


def _trees():
    """The same tree for each package: f32, bfloat16 and int32 leaves,
    nested dicts with keys out of order."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    half = rng.standard_normal((4, 2)).astype(np.float32)
    count = rng.integers(-9, 9, (6,)).astype(np.int32)
    ref = {"fc": {"w": jnp.asarray(w), "b": jnp.asarray(half,
                                                          jnp.bfloat16)},
           "count": jnp.asarray(count)}
    port = {"fc": {"w": torch.from_numpy(w),
                   "b": torch.from_numpy(half).to(torch.bfloat16)},
            "count": torch.from_numpy(count)}
    return ref, port


def _bits(x):
    """The leaf's raw bytes, whichever package made it."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes(), tuple(x.shape)
    x = np.asarray(x)
    return x.tobytes(), x.shape


def _same_tree(port, ref):
    assert sorted(port) == sorted(ref)
    for k in port:
        if isinstance(port[k], dict):
            _same_tree(port[k], ref[k])
        else:
            assert _bits(port[k]) == _bits(ref[k]), k


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    ref, port = _trees()
    jckpt.save_checkpoint(str(tmp_path), 7, ref, metadata={"note": "x"})
    for got in (ckpt.load_checkpoint(str(tmp_path), like=port, device="cpu"),
                ckpt.load_checkpoint_tree(str(tmp_path), device="cpu")):
        _same_tree(got, ref)
        assert got["fc"]["b"].dtype == torch.bfloat16
        assert got["count"].dtype == torch.int32
    assert ckpt.latest_step(str(tmp_path)) == 7


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    ref, port = _trees()
    ckpt.save_checkpoint(str(tmp_path), 3, port, metadata={"note": "x"})
    for got in (jckpt.load_checkpoint(str(tmp_path), like=ref),
                jckpt.load_checkpoint_tree(str(tmp_path))):
        _same_tree(port, got)
        assert str(np.asarray(got["fc"]["b"]).dtype) == "bfloat16"
    assert jckpt.latest_step(str(tmp_path)) == 3


def test_manifests_are_the_same(tmp_path):
    """Leaf names, key paths, shapes, dtypes, metadata and the structure
    string, as the reference writes them."""
    ref, port = _trees()
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1, ref, metadata={"a": 1})
    ckpt.save_checkpoint(str(tmp_path / "port"), 1, port, metadata={"a": 1})
    want, got = (json.loads((tmp_path / d / "ckpt_00000001.json").read_text())
                 for d in ("ref", "port"))
    assert got == want
    assert [e["path"] for e in got["leaves"]] == ["count", "fc/b", "fc/w"]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bank_snapshots_cross_load(tmp_path, writer):
    """Two snapshots of a stacked bank: the latest step, both structures,
    the sample count in the metadata, no ``.bank_tmp`` left behind."""
    ref, port = _trees()
    d = str(tmp_path)
    if writer == "reference":
        jckpt.save_bank(d, 10, ref)
        jckpt.save_bank(d, 20, jax.tree.map(lambda x: x * 2, ref))
    else:
        ckpt.save_bank(d, 10, port)
        ckpt.save_bank(d, 20, {"fc": {k: v * 2 for k, v in
                                      port["fc"].items()},
                               "count": port["count"] * 2})
    assert not os.path.isdir(os.path.join(d, ".bank_tmp"))
    assert ckpt.latest_bank_step(d) == jckpt.latest_bank_step(d) == 20
    assert ckpt.checkpoint.bank_steps(d) == [10, 20]
    meta = json.loads((tmp_path / "bank_00000010.json").read_text())
    assert meta["metadata"]["bank_samples"] == 6
    _same_tree(ckpt.load_bank(d, step=10, like=port, device="cpu"), ref)
    _same_tree(ckpt.load_bank(d, step=10, device="cpu"), ref)
    _same_tree(port, jckpt.load_bank(d, step=10, like=ref))
    twice = ckpt.load_bank(d, device="cpu")
    _same_tree(twice, jckpt.load_bank(d))
    assert twice["count"].tolist() == (port["count"] * 2).tolist()


def test_loads_check_their_inputs(tmp_path):
    _, port = _trees()
    with pytest.raises(FileNotFoundError):
        ckpt.load_bank(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path), like=port, device="cpu")
    ckpt.save_checkpoint(str(tmp_path), 1, port)
    with pytest.raises(ValueError, match="like="):
        ckpt.load_checkpoint(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_checkpoint(str(tmp_path), like={"w": port["count"]},
                             device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ckpt.load_checkpoint(str(tmp_path), like=port)
