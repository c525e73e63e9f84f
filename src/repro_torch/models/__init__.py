"""Model factory: the radar LeNet, the decoders (dense, vlm, moe, hybrid,
ssm) and the whisper encoder-decoder (audio)."""
from types import SimpleNamespace

from repro_torch.models import lenet as _lenet
from repro_torch.models.transformer import make_model as _make_decoder
from repro_torch.models.whisper import make_whisper


def get_model(cfg) -> SimpleNamespace:
    """``init(key, device)`` -> params of one model; the apply functions
    take params with a leading group axis and a batch dict, as the
    reference's (``models/lenet.py``, ``models/transformer.py``,
    ``models/whisper.py``): LeNet reads ``batch["x"]``, a decoder
    ``batch["tokens"]`` (llava also ``patches``, whisper ``frames``). LeNet
    has ``logits`` and ``nll`` and no decode step; an LM has ``logits``,
    ``loss``, ``nll``, ``init_decode_state`` and ``decode_step``."""
    if cfg.family == "lenet":
        return SimpleNamespace(
            cfg=cfg,
            init=lambda key, device: _lenet.init_lenet(cfg, key, device),
            logits=lambda params, batch: _lenet.lenet_logits(params,
                                                              batch["x"]),
            nll=_lenet.lenet_nll,
            init_decode_state=None, decode_step=None,
        )
    if cfg.family == "audio":
        return make_whisper(cfg)
    return _make_decoder(cfg)
