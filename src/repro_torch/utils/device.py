"""The device an entry point runs on: the card unless the caller asks for
the CPU."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but no CUDA device is available; pass "
            f"device='cpu' to run the kernels' plain versions on the CPU")
    return dev


_CONSTS = {}


def device_const(key, device, make) -> torch.Tensor:
    """A constant tensor made once a device from ``make()``'s array, keyed by
    ``key``: a round captured in a CUDA graph copies nothing to the card."""
    k = (key, str(device))
    if k not in _CONSTS:
        _CONSTS[k] = torch.as_tensor(make(), device=device)
    return _CONSTS[k]
