"""Training harness: the host round engine and FedTrainer."""
from repro_torch.train.trainer import FedTrainer, TrainResult

__all__ = ["FedTrainer", "TrainResult"]
