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
