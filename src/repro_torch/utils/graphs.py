"""Capture of a fixed-shape step as a CUDA graph, the port's counterpart of
the reference's ``jax.jit`` of a fixed shape (the eval scan, the predict
kernel)."""
from __future__ import annotations

import time
from typing import Any, Callable, Tuple

import torch


def capture(fn: Callable[[], Any], stream: torch.cuda.Stream
            ) -> Tuple[torch.cuda.CUDAGraph, Any, float]:
    """Run ``fn`` once on ``stream`` and throw its result away (the warm-up:
    cuDNN and cuBLAS choose their algorithms and workspaces outside the
    capture), then capture ``fn`` on ``stream``. Returns the graph, the
    outputs of the captured call, which every replay rewrites in place, and
    the host ms of the capture. ``fn`` must read only tensors that outlive
    the graph. A failed capture raises; nothing falls back to eager."""
    dev = stream.device
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    start = time.perf_counter()
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    return graph, out, 1e3 * (time.perf_counter() - start)
