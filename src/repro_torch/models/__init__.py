"""Model factory: the radar LeNet (the only model ported so far)."""
from types import SimpleNamespace

from repro_torch.models import lenet as _lenet


def get_model(cfg) -> SimpleNamespace:
    """``init(key, device)`` -> params of one model; ``logits`` and
    ``nll`` take params with a leading group axis (see ``models/lenet.py``)."""
    if cfg.family != "lenet":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; ROADMAP A12")
    return SimpleNamespace(
        cfg=cfg,
        init=lambda key, device: _lenet.init_lenet(cfg, key, device),
        logits=_lenet.lenet_logits,
        nll=_lenet.lenet_nll,
    )
