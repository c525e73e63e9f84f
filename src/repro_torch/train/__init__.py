"""Training harness: the round engines and FedTrainer."""
from repro_torch.train.trainer import FedTrainer, TrainResult  # noqa: F401
from repro_torch.train.engine import (  # noqa: F401
    HostRoundEngine, ScanRoundEngine, make_engine, round_data_key)
