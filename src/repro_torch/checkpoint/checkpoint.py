"""Checkpoints: a tree of tensors -> an ``.npz`` of its leaves and a JSON
manifest (``repro/checkpoint/checkpoint.py``), in the reference's format,
so a snapshot written by either package loads in the other bit for bit.

The format: ``ckpt_%08d`` (``bank_%08d`` for posterior banks) ``.npz`` and
``.json``; leaf ``i`` is array ``leaf_%05d`` of the ``.npz``, the leaves in
JAX's flatten order (dict keys sorted at every level); the manifest holds
each leaf's ``"/"``-joined key path, shape and dtype name, the step, the
caller's metadata and the tree's structure (``treedef``, written for the
reader, never read back). numpy has no bfloat16, so a bfloat16 leaf is
saved as its uint16 bits. The port's trees are nested dicts; their paths
are the reference's (the port's ``utils.tree`` joins keys with ``"."``).

Loads put the leaves on ``device``, the card by default.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.device import resolve_device

BANK_PREFIX = "bank_"


def _flatten(tree, parts: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(key path, leaf)`` in JAX's order for a tree of nested dicts."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], parts + (str(key),))
    else:
        yield parts, tree


def _treedef(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"


def _nest(paths: List[Tuple[str, ...]], leaves: List[Any]) -> Dict:
    tree: Dict = {}
    for parts, leaf in zip(paths, leaves):
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """The leaf as the array the ``.npz`` stores, and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    name = str(arr.dtype)
    if name == "bfloat16":
        arr = arr.view(np.uint16)
    return arr, name


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    metadata: Optional[Dict] = None) -> str:
    """Write ``tree`` as ``ckpt_{step:08d}.npz`` and ``.json``; returns
    their common path without the extension."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "leaves": [], "metadata": metadata or {}}
    for i, (parts, leaf) in enumerate(_flatten(tree)):
        name = f"leaf_{i:05d}"
        arrays[name], dtype = _to_numpy(leaf)
        manifest["leaves"].append({"name": name, "path": "/".join(parts),
                                   "shape": list(arrays[name].shape),
                                   "dtype": dtype})
    base = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    np.savez(base + ".npz", **arrays)
    manifest["treedef"] = f"PyTreeDef({_treedef(tree)})"
    with open(base + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    return base


def _read(base: str, device) -> Tuple[Dict, List[torch.Tensor]]:
    device = resolve_device(device)
    with open(base + ".json") as f:
        manifest = json.load(f)
    with np.load(base + ".npz") as data:
        leaves = [_to_tensor(data[e["name"]], e["dtype"], device)
                  for e in manifest["leaves"]]
    return manifest, leaves


def _like(like, leaves: List[torch.Tensor]) -> Dict:
    """The leaves in the structure of ``like`` (its leaf values unused)."""
    paths = [parts for parts, _ in _flatten(like)]
    if len(paths) != len(leaves):
        raise ValueError(f"like= has {len(paths)} leaves, the checkpoint "
                         f"{len(leaves)}")
    return _nest(paths, leaves)


def _from_manifest(manifest: Dict, leaves: List[torch.Tensor]) -> Dict:
    return _nest([tuple(e["path"].split("/")) for e in manifest["leaves"]],
                 leaves)


def _step_or_latest(ckpt_dir: str, step: Optional[int], latest, what: str):
    if step is None:
        step = latest(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no {what} in {ckpt_dir}")
    return step


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                    like: Any = None, device="cuda") -> Any:
    """Restore in the structure of ``like`` (required); the latest step
    when ``step`` is None."""
    step = _step_or_latest(ckpt_dir, step, latest_step, "checkpoints")
    if like is None:
        raise ValueError("pass `like=` tree for structure")
    _, leaves = _read(os.path.join(ckpt_dir, f"ckpt_{step:08d}"), device)
    return _like(like, leaves)


def load_checkpoint_tree(ckpt_dir: str, step: Optional[int] = None,
                         device="cuda") -> Any:
    """Restore as nested dicts rebuilt from the manifest's key paths."""
    step = _step_or_latest(ckpt_dir, step, latest_step, "checkpoints")
    return _from_manifest(*_read(os.path.join(ckpt_dir, f"ckpt_{step:08d}"),
                                 device))


def save_bank(ckpt_dir: str, step: int, stacked: Any,
              metadata: Optional[Dict] = None) -> str:
    """Snapshot a stacked posterior bank ``(S, ...)`` or ``(S, K, ...)`` for
    the serving plane as ``bank_{step:08d}``, with its sample count in the
    metadata (``bank_samples``). Written under ``.bank_tmp`` and renamed
    into place, so a server polling the directory never loads a half-written
    snapshot."""
    meta = dict(metadata or {})
    meta.setdefault("bank_samples",
                    int(next(_flatten(stacked))[1].shape[0]))
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, ".bank_tmp")
    path = save_checkpoint(tmp, step, stacked, metadata=meta)
    final = os.path.join(ckpt_dir, f"{BANK_PREFIX}{step:08d}")
    for ext in (".npz", ".json"):
        os.replace(path + ext, final + ext)
    try:
        os.rmdir(tmp)
    except OSError:
        pass
    return final


def load_bank(ckpt_dir: str, step: Optional[int] = None, like: Any = None,
              device="cuda") -> Any:
    """Restore a bank written by :func:`save_bank` (the latest when ``step``
    is None), in the structure of ``like`` (any params tree of the model;
    its leaf shapes are unused) or, without it, of the manifest's paths."""
    step = _step_or_latest(ckpt_dir, step, latest_bank_step,
                           "bank snapshots")
    manifest, leaves = _read(
        os.path.join(ckpt_dir, f"{BANK_PREFIX}{step:08d}"), device)
    if like is not None:
        return _like(like, leaves)
    return _from_manifest(manifest, leaves)


def _steps(ckpt_dir: str, prefix: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in (
        re.match(rf"{prefix}(\d+)\.npz", fn) for fn in os.listdir(ckpt_dir))
        if m)


def bank_steps(ckpt_dir: str) -> List[int]:
    """The steps of the bank snapshots in ``ckpt_dir``, ascending."""
    return _steps(ckpt_dir, BANK_PREFIX)


def latest_bank_step(ckpt_dir: str) -> Optional[int]:
    steps = bank_steps(ckpt_dir)
    return steps[-1] if steps else None


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir, "ckpt_")
    return steps[-1] if steps else None
