"""Configuration for the PyTorch port: the fields its round functions read.

A copy of the subset of ``repro/config.py`` this package runs, with the same
defaults (``FedConfig``: ``config.py:288-312`` of the reference). Values the
port does not run yet raise :class:`NotImplementedError` naming the ROADMAP
item that ports them, so a config can never silently select a path that is
missing here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """The LeNet fields of the reference ``ModelConfig``."""
    name: str = "model"
    family: str = "lenet"
    input_hw: Tuple[int, int] = (0, 0)
    num_classes: int = 0
    dtype: str = "float32"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# values of each FedConfig field the port runs, and where the rest go
_CODECS = ("identity", "topk", "block_topk", "randk", "sign", "qsgd")
_SUPPORTED = {
    "compressor": (_CODECS + ("qsgd_pallas", "block_topk_pallas"),
                   "A6 (the reference's codec names)"),
    # powers of two: XLA folds the reference's `/ s / (1 + ω)` differently
    # in its qsgd kernel and in its decode for any other s (ROADMAP C5)
    "qsgd_levels": ((1, 2, 4, 8, 16, 32, 64), "C5 (QSGD levels)"),
    "control_dtype": (("float32",), "A3 (bfloat16 control variates)"),
    "topology": (("full", "ring"), "A4 (the other graph families)"),
}


@dataclass(frozen=True)
class FedConfig:
    """The federated run's knobs (paper notation); same defaults as the
    reference ``FedConfig``."""
    num_nodes: int = 10             # K
    topology: str = "full"          # full | ring
    local_steps: int = 8            # L
    zeta: float = 0.03              # consensus mixing weight
    eta: float = 1e-4               # SGLD learning rate
    temperature: float = 1.0        # posterior tempering
    burn_in: int = 700              # T_b
    rounds: int = 800               # T
    compressor: str = "block_topk"  # identity | topk | block_topk | randk |
    #                                 sign | qsgd | qsgd_pallas | block_topk_pallas
    # codec pipeline DSL, e.g. "block_topk|qsgd" (sparsify, then quantize
    # the survivors); takes precedence over ``compressor`` when set
    pipeline: str = ""
    compress_ratio: float = 0.01    # paper: 1% of parameters
    qsgd_levels: int = 16
    block_size: int = 1024          # block-local top-k granularity
    min_dense_size: int = 0         # leaves this small are sent dense
    fused_compress: bool = False
    # per-layer pipeline overrides, (path substring, pipeline) pairs
    layer_pipelines: Tuple[Tuple[str, str], ...] = ()
    algorithm: str = "cdbfl"        # cdbfl | dsgld | cffl
    control_dtype: str = "float32"  # v / v̄ storage
    seed: int = 0

    def check_supported(self) -> None:
        """Raise NotImplementedError for a value the port does not run."""
        for name, (ok, item) in _SUPPORTED.items():
            value = getattr(self, name)
            if value not in ok:
                raise NotImplementedError(
                    f"FedConfig.{name}={value!r} is not ported yet "
                    f"(runs: {ok}); ROADMAP {item}")
        if self.layer_pipelines:
            raise NotImplementedError(
                "FedConfig.layer_pipelines is not ported yet; ROADMAP A6 "
                "(PerLayerPipeline)")


# the paper's radar ROI classifier (reference: configs/lenet_radar.py)
LENET_RADAR = ModelConfig(name="lenet-radar", family="lenet",
                          input_hw=(256, 63), num_classes=10)
LENET_RADAR_REDUCED = LENET_RADAR.replace(name="lenet-radar-reduced",
                                          input_hw=(32, 16))

_ARCHS = {"lenet-radar": (LENET_RADAR, LENET_RADAR_REDUCED)}


def get_arch(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id not in _ARCHS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ported: {sorted(_ARCHS)}); "
            f"ROADMAP A12 (LM model zoo)")
    full, small = _ARCHS[arch_id]
    return small if reduced else full
