"""Configuration for the PyTorch port: the fields its round functions read.

A copy of the subset of ``repro/config.py`` this package runs, with the same
defaults (``FedConfig``: ``config.py:285-327`` of the reference, every
field; ``TransportConfig`` and ``ParticipationConfig``: ``:120-210``;
``ContinualConfig``: ``:212-252``; ``ServeConfig``: ``:255-282``;
``TrainConfig``: ``:330-342``). Values the port does not run yet raise
:class:`NotImplementedError` naming the ROADMAP item that ports them, so a
config can never silently select a path that is missing here.
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
class ContinualConfig:
    """Streaming drift and continual posterior refresh (DESIGN.md §15).

    Pure data: the drift half is interpreted by
    ``repro_torch.data.scenarios.DriftSchedule`` (severity trajectories
    pure in ``(seed, round)``), the refresh half by the bank's age weights
    (window eviction and age-discounted BMA weights).
    ``FedTrainer(continual=...)`` and ``launch/train.py
    --drift/--refresh-*`` read it.
    """
    # -- drift schedule over the node-local training distribution --------
    scenario: str = "clean"       # shift family (repro_torch.data.scenarios);
    #                               "clean" = no drift, bitwise unchanged
    schedule: str = "step"        # constant | step | ramp | cyclic | piecewise
    severity: float = 0.0         # plateau / peak severity in [0, 1]
    base_severity: float = 0.0    # pre-onset severity (keeps caller shards)
    onset: int = 0                # first drifted round
    ramp_rounds: int = 0          # ramp duration (0 degenerates to step)
    period: int = 0               # cyclic period in rounds
    breakpoints: Tuple[Tuple[int, float], ...] = ()   # piecewise knots
    refresh_every: int = 1        # rounds per drift phase (pool re-draw)
    drift_seed: int = 0           # drift-synthesis stream seed
    # -- continual posterior refresh (bank aging) ------------------------
    # >0: posterior samples older than this many rounds are evicted from
    # the BMA (their weight masks to zero): the moving-window posterior
    window: int = 0
    # <1: BMA weight decay**age (age in rounds since admission),
    # renormalized over the surviving window
    decay: float = 1.0

    @property
    def drifts(self) -> bool:
        return self.scenario not in ("", "clean")

    @property
    def ages(self) -> bool:
        return self.window > 0 or self.decay < 1.0

    def replace(self, **kw) -> "ContinualConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MoEConfig:
    """The reference's MoE knobs (``repro/config.py:19-32``); the port runs
    no MoE family yet (ROADMAP A12)."""
    num_experts: int = 0            # routed experts (0 = dense MLP)
    num_shared_experts: int = 0     # always-on experts (DeepSeek style)
    top_k: int = 2
    aux_loss_weight: float = 0.01   # router load-balance loss
    impl: str = "ragged"            # ragged | gshard
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    """One architecture: every field of the reference ``ModelConfig``
    (``repro/config.py:35-93``) with its default. The port runs the
    ``lenet`` and ``dense`` families (``repro_torch.models``)."""
    name: str = "model"
    family: str = "dense"           # dense | moe | hybrid | ssm | vlm | audio | lenet
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0               # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 8192
    # attention
    qkv_bias: bool = False          # Qwen2-style
    sliding_window: int = 0         # 0 = full attention
    rope_theta: float = 10000.0
    # MoE
    moe: MoEConfig = field(default_factory=MoEConfig)
    # MLA (DeepSeek-V2): 0 disables, >0 is the KV LoRA/latent rank
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    # hybrid (RecurrentGemma / Griffin): block pattern, e.g. ("rec","rec","attn")
    block_pattern: Tuple[str, ...] = ()
    rglru_dim: int = 0              # 0 -> d_model
    local_attn_window: int = 2048
    # xLSTM
    mlstm_ratio: int = 7            # mLSTM blocks per sLSTM block
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq_len: int = 1500
    # VLM stub frontend
    num_image_patches: int = 0
    # training-path memory control
    attn_impl: str = "auto"         # naive | chunked | auto (chunked iff S >= 2 chunk)
    chunk_size: int = 512
    # norms / activations
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"
    dtype: Any = "bfloat16"
    # LeNet (radar) specific
    input_hw: Tuple[int, int] = (0, 0)
    num_classes: int = 0
    # layer scanning for deep stacks: one stacked leaf a weight
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

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
    continual: Optional[ContinualConfig] = None
    seed: int = 0

    def check_supported(self) -> None:
        """Raise NotImplementedError for a value the port does not run."""
        for name, (ok, item) in _SUPPORTED.items():
            value = getattr(self, name)
            if value not in ok:
                raise NotImplementedError(
                    f"FedConfig.{name}={value!r} is not ported yet "
                    f"(runs: {ok}); ROADMAP {item}")


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
class TrainConfig:
    """Optimizer and schedule scalars (``repro/config.py:330-342``), pure
    data; ``repro_torch.optim`` builds the optimizers they name."""
    global_batch: int = 256
    seq_len: int = 4096
    steps: int = 100
    log_every: int = 10
    optimizer: str = "sgld"         # sgld | sgd | adamw
    lr: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    warmup_steps: int = 0
    param_dtype: Any = "float32"
    remat: bool = False


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
# run yet, each with the part of the LM model zoo (ROADMAP A12) that ports it
_UNPORTED_ARCHS = {
    "deepseek-v2-236b": "A12 part 4 (moe and MLA)",
    "grok-1-314b": "A12 part 4 (moe)",
    "llava-next-mistral-7b": "A12 part 3 (vlm)",
    "recurrentgemma-9b": "A12 part 5 (hybrid, RG-LRU)",
    "xlstm-1.3b": "A12 part 6 (ssm, xLSTM)",
    "whisper-tiny": "A12 part 7 (audio)",
}


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
            f"ROADMAP {_UNPORTED_ARCHS[arch_id]}")
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


# the dense decoders of the reference's registry (``repro/configs``):
# (arch id, config, the reduced config's overrides, source, notes)
_GQA_REDUCED = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                    head_dim=32, d_ff=256, vocab_size=512)
_DENSE = (
    ("smollm-135m",
     ModelConfig(name="smollm-135m", family="dense", num_layers=30,
                 d_model=576, num_heads=9, num_kv_heads=3, d_ff=1536,
                 vocab_size=49152, tie_embeddings=True),
     dict(name="smollm-reduced", num_layers=2, d_model=96, num_heads=3,
          num_kv_heads=3, d_ff=256, vocab_size=512),
     "hf:HuggingFaceTB/SmolLM-135M",
     "~135M params: the end-to-end CPU-trainable arch (examples use a "
     "trimmed variant). long_500k via sliding_window variant."),
    ("yi-9b",
     ModelConfig(name="yi-9b", family="dense", num_layers=48, d_model=4096,
                 num_heads=32, num_kv_heads=4, head_dim=128, d_ff=11008,
                 vocab_size=64000),
     dict(_GQA_REDUCED, name="yi-reduced"),
     "arXiv:2403.04652 (Yi)",
     "Llama-style dense GQA. long_500k via sliding_window variant."),
    ("qwen2.5-14b",
     ModelConfig(name="qwen2.5-14b", family="dense", num_layers=48,
                 d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
                 d_ff=13824, vocab_size=152064, qkv_bias=True),
     dict(_GQA_REDUCED, name="qwen2.5-reduced"),
     "hf:Qwen/Qwen2.5-0.5B (family card)",
     "Dense GQA with QKV bias. long_500k via sliding_window variant."),
    ("mistral-large-123b",
     ModelConfig(name="mistral-large-123b", family="dense", num_layers=88,
                 d_model=12288, num_heads=96, num_kv_heads=8, head_dim=128,
                 d_ff=28672, vocab_size=32768, sliding_window=0),
     dict(_GQA_REDUCED, name="mistral-large-reduced"),
     "hf:mistralai/Mistral-Large-Instruct-2407",
     "Dense GQA. long_500k uses the sliding_window=4096 variant "
     "(ring-buffer cache) per the assignment's sub-quadratic carve-out."),
)
for _arch_id, _cfg, _reduced, _source, _notes in _DENSE:
    register_arch(ArchSpec(arch_id=_arch_id, config=_cfg,
                           reduced=_cfg.replace(**_reduced), source=_source,
                           notes=_notes))
