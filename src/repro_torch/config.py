"""Configuration for the PyTorch port: the fields its round functions read.

A copy of the subset of ``repro/config.py`` this package runs, with the same
defaults (``FedConfig``: ``config.py:285-327`` of the reference, every
field; ``TransportConfig`` and ``ParticipationConfig``: ``:120-210``;
``ServeConfig``: ``:255-282``). Values the port does not run yet
raise :class:`NotImplementedError` naming the ROADMAP item that ports them,
so a config can never silently select a path that is missing here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class TopologyConfig:
    """Device graph of the D2D deployment: the family and its parameters,
    and the two knobs that make Ω time-varying (per-round realizations
    drawn inside the round from its key)."""
    graph: str = "full"             # full | ring | chain | star | grid |
    #                                 torus | k_regular | erdos_renyi | geometric
    degree: int = 4                 # k_regular: even neighbor count
    edge_prob: float = 0.3          # erdos_renyi: iid link probability
    radius: float = 0.45            # geometric: radio range in the unit square
    rule: str = "metropolis"        # metropolis | max_degree | uniform
    seed: int = 0                   # graph-sampling seed (ER / geometric)
    # time-varying schedule (0/0 = static graph)
    link_failure_prob: float = 0.0  # per-round, per-link Bernoulli dropout
    gossip_pairs: int = 0           # >0: activate only this many matchings/round

    def replace(self, **kw) -> "TopologyConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TransportConfig:
    """Lossy D2D frame transport under the gossip layer (DESIGN.md §11).

    Payloads are fragmented into ``mtu``-bounded frames (8-byte LEN/SEQ/CRC
    header each); frames erase per the named loss model, and whole links
    drop for a round per the SNR-derived Rayleigh outage (reusing the
    gossip layer's ``link_failure_prob`` seam). Pure data so config stays
    dependency-free; ``repro_torch.core.transport`` interprets it.
    """
    mtu: int = 256                  # on-air frame size cap, header included
    # per-frame erasure: scalar rate, or a per-node tuple (asymmetric loss;
    # 1.0 = dead transmitter). Interpreted by the ``loss_model`` below.
    erasure: Any = 0.0
    loss_model: str = "bernoulli"   # bernoulli | gilbert
    # Gilbert-Elliott burst channel (loss_model="gilbert")
    gilbert_p_enter: float = 0.05   # good -> bad episode start, per frame
    gilbert_p_exit: float = 0.3     # bad -> good recovery, per frame
    gilbert_loss_good: float = 0.0
    gilbert_loss_bad: float = 1.0
    # SNR-parameterized per-link outage (None disables): per-node mean SNR
    # snr_db ± lognormal shadowing, edge outage 1 - exp(-γ_th/γ̄) at the
    # weaker endpoint, fed into the gossip link-dropout seam.
    snr_db: Optional[float] = None
    snr_spread_db: float = 0.0
    snr_threshold_db: float = 0.0
    # radio cost model (802.15.4-class defaults) for airtime/energy columns
    phy_rate_bps: float = 250_000.0
    tx_power_w: float = 0.1
    # selective-repeat ARQ (DESIGN.md §12): lost frames are retransmitted
    # up to ``max_retries`` extra attempts, each attempt drawing a fresh
    # PRNG-pure keep mask (fold_in of the per-leaf transport key by the
    # attempt index). ``arq_backoff_s`` is the wait before retransmit
    # attempt a (doubling per attempt), charged against the round's
    # airtime budget but not TX energy. arq=False keeps the single-shot
    # path bitwise identical to the pre-ARQ transport.
    arq: bool = False
    max_retries: int = 2
    arq_backoff_s: float = 0.0
    # LoRa-style time-on-air accounting (DESIGN.md §12): per-frame airtime
    # from the SX127x symbol-count formula at spreading factor ``sf`` over
    # ``bw_hz`` with coding rate 4/(4+coding_rate), instead of the flat
    # phy_rate_bps division. toa=False keeps the flat accounting (and the
    # committed byte/airtime baselines) unchanged.
    toa: bool = False
    sf: int = 7                     # LoRa spreading factor (7..12)
    bw_hz: float = 125_000.0        # LoRa channel bandwidth
    coding_rate: int = 1            # CR index: 1..4 -> 4/5..4/8
    preamble_syms: int = 8
    # per-round airtime budget: duty_cycle × round_period_s seconds of
    # airtime (plus ARQ backoff waits) per node per round; 0 period = no
    # budget (∞). Frames that exhaust the budget are abandoned and their
    # mass falls back to the CHOCO residual via error feedback.
    duty_cycle: float = 1.0
    round_period_s: float = 0.0
    # CHOCO error feedback: update the control sequence v with the
    # *delivered* delta only, so lost frames stay in the next residual
    error_feedback: bool = True
    seed: int = 0                   # SNR shadowing draw seed

    def replace(self, **kw) -> "TransportConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ParticipationConfig:
    """Barrier-free round model (DESIGN.md §12): which nodes show up.

    A node that does not participate in a round performs no local steps,
    transmits nothing, and integrates nothing — its params/v/v̄ freeze
    and the Metropolis-Hastings mixing row of every neighbor renormalizes
    over the delivered neighbor set (the missing weight folds into the
    self-loop, so the realized Ω stays doubly stochastic). Pure data;
    ``repro_torch.core.gossip.ParticipationSchedule`` interprets it.
    """
    # iid per-round straggler skips: each subject node misses a round
    # with this probability (PRNG-pure from the round key)
    straggler_prob: float = 0.0
    # nodes subject to straggling; empty = every node
    stragglers: Tuple[int, ...] = ()
    # deterministic death/rejoin timelines: (node, die_round, rejoin_round)
    # — the node is out for die_round <= t < rejoin_round; rejoin < 0
    # means it never comes back
    dead: Tuple[Tuple[int, int, int], ...] = ()

    @property
    def active(self) -> bool:
        return self.straggler_prob > 0.0 or len(self.dead) > 0

    def replace(self, **kw) -> "ParticipationConfig":
        return dataclasses.replace(self, **kw)


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
    "control_dtype": (("float32", "bfloat16"),
                      "A3 (float16 control variates)"),
    "topology": (("full", "ring", "chain", "star", "grid", "torus",
                  "k_regular", "erdos_renyi", "geometric"),
                 "A4 (graph families)"),
}
# fields the port runs only at None, and the item that ports the rest
_UNSET_ONLY = {
    "continual": "A9 (drift and continual learning)",
}


@dataclass(frozen=True)
class FedConfig:
    """The federated run's knobs (paper notation); same defaults as the
    reference ``FedConfig``."""
    num_nodes: int = 10             # K
    topology: str = "full"          # a graph family of TopologyConfig
    # full graph spec; when set it overrides the ``topology`` string
    topology_cfg: Optional[TopologyConfig] = None
    mixing: str = "metropolis"      # metropolis | max_degree | uniform
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
    transport: Optional["TransportConfig"] = None
    participation: Optional["ParticipationConfig"] = None
    continual: Optional[Any] = None       # a ContinualConfig (A9)
    seed: int = 0

    def check_supported(self) -> None:
        """Raise NotImplementedError for a value the port does not run."""
        for name, (ok, item) in _SUPPORTED.items():
            value = getattr(self, name)
            if value not in ok:
                raise NotImplementedError(
                    f"FedConfig.{name}={value!r} is not ported yet "
                    f"(runs: {ok}); ROADMAP {item}")
        for name, item in _UNSET_ONLY.items():
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"FedConfig.{name} is not ported yet (runs: None); "
                    f"ROADMAP {item}")


@dataclass(frozen=True)
class ServeConfig:
    """The serving plane (``repro/serve``). The slot table is the fixed
    shape a predict graph is captured at: requests are admitted into and
    retired from ``slots`` rows each step with no recapture."""
    slots: int = 8                  # the slot table's rows
    max_len: int = 128              # decode KV-cache length (ROADMAP A12)
    max_new_tokens: int = 16        # decode budget a request (A12)
    temperature: float = 1.0        # decode softmax temperature (A12)
    # abstain (route to a human) above this predictive entropy in nats; inf
    # answers always. The eval accumulators use the same rule.
    entropy_threshold: float = float("inf")
    # > 0: the serving CLI polls its checkpoint directory at this period
    # and hot-swaps the posterior banks that land there
    hot_swap_poll_s: float = 0.0
    # mesh axis of the bank's sample axis ("" replicated; A10)
    ensemble_axis: str = ""

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ArchSpec:
    """A registry entry (``repro/config.py:372-381``): the full and the
    reduced (``--trim``) configs of one arch id, the citation, and the
    input shapes the arch skips with the reason."""
    arch_id: str
    config: ModelConfig
    reduced: ModelConfig
    source: str
    notes: str = ""
    skips: Dict[str, str] = field(default_factory=dict)


_ARCHS: Dict[str, ArchSpec] = {}
# the reference's registry (``repro/configs``): the ids the port does not
# run yet, which come with the LM model zoo
_UNPORTED_ARCHS = ("deepseek-v2-236b", "grok-1-314b", "llava-next-mistral-7b",
                   "mistral-large-123b", "qwen2.5-14b", "recurrentgemma-9b",
                   "smollm-135m", "whisper-tiny", "xlstm-1.3b", "yi-9b")


def register_arch(spec: ArchSpec) -> ArchSpec:
    _ARCHS[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    """The registry entry of ``arch_id``: ``KeyError`` for an id the
    reference does not know, ``NotImplementedError`` for one it knows and
    the port does not run yet."""
    if arch_id in _ARCHS:
        return _ARCHS[arch_id]
    if arch_id in _UNPORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ported: {sorted(_ARCHS)}); "
            f"ROADMAP A12 (LM model zoo)")
    raise KeyError(f"unknown arch {arch_id!r}; known: "
                   f"{sorted(set(_ARCHS) | set(_UNPORTED_ARCHS))}")


def list_archs():
    """The ids the port runs."""
    return sorted(_ARCHS)


# the paper's radar ROI classifier (reference: configs/lenet_radar.py)
LENET_RADAR = ModelConfig(name="lenet-radar", family="lenet",
                          input_hw=(256, 63), num_classes=10,
                          dtype="float32")
LENET_RADAR_REDUCED = LENET_RADAR.replace(name="lenet-radar-reduced",
                                          input_hw=(32, 16))

register_arch(ArchSpec(
    arch_id="lenet-radar",
    config=LENET_RADAR,
    reduced=LENET_RADAR_REDUCED,
    source="Barbieri et al. 2024 §IV; LeCun et al. 1998 [32]",
    notes="Paper's radar ROI classifier; the CD-BFL case-study model.",
    skips={
        "train_4k": "classifier, not an LM — trained via the radar pipeline",
        "prefill_32k": "no sequence dimension",
        "decode_32k": "no decode step",
        "long_500k": "no decode step",
    },
))
