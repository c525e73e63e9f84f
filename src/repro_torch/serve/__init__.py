"""Serving plane: uncertainty-aware engine over a resident posterior bank."""
from repro_torch.serve.engine import (ClassifyEngine, DecodeEngine,
                                      ServeRequest, ServeResponse,
                                      ServingEngine, live_device_bytes)

__all__ = [
    "ClassifyEngine", "DecodeEngine", "ServeRequest", "ServeResponse",
    "ServingEngine", "live_device_bytes",
]
