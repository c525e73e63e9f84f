"""Optimizers and schedules over tensor trees (``repro/optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    adamw, cosine_schedule, make_optimizer, momentum, sgd, warmup_cosine,
)
