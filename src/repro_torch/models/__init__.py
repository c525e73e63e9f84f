"""Model factory: the radar LeNet and the decoders (dense, vlm, moe)."""
from types import SimpleNamespace

from repro_torch.models import lenet as _lenet
from repro_torch.models.transformer import make_model as _make_decoder


def get_model(cfg) -> SimpleNamespace:
    """``init(key, device)`` -> params of one model; the apply functions
    take params with a leading group axis and a batch dict, as the
    reference's (``models/lenet.py``, ``models/transformer.py``): LeNet
    reads ``batch["x"]``, a decoder ``batch["tokens"]``. LeNet has
    ``logits`` and ``nll`` and no
    decode step; a decoder has ``logits``, ``loss``, ``init_decode_state``
    and ``decode_step``. A family the port does not run yet raises, naming
    its part of ROADMAP A12."""
    if cfg.family == "lenet":
        return SimpleNamespace(
            cfg=cfg,
            init=lambda key, device: _lenet.init_lenet(cfg, key, device),
            logits=lambda params, batch: _lenet.lenet_logits(params,
                                                              batch["x"]),
            nll=_lenet.lenet_nll,
            init_decode_state=None, decode_step=None,
        )
    return _make_decoder(cfg)
