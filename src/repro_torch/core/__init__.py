"""Core: the paper's contribution — CD-BFL and its baselines, its codec,
gossip, transport and posterior. The reference's public names
(``repro/core/__init__.py``); the SPMD shard mixer's four stand for
ROADMAP A10 and raise."""
from repro_torch.core.compression import (Compressor, CompressionPipeline,
                                          FusedCodec, PerLayerPipeline,
                                          WirePayload, encode_hbm_bytes,
                                          leaf_stages, make_compressor,
                                          parse_layer_rules, parse_pipeline)
from repro_torch.core.mixing import mixing_matrix, adjacency, spectral_gap
from repro_torch.core.topology import (Topology, MixSchedule, build_topology,
                                       build_schedule, graph_adjacency,
                                       mixing_weights, resolve_topology)
from repro_torch.core.gossip import (dense_mix, schedule_mix, make_mixer,
                                     ShardContext, ShardMixStats,
                                     make_shard_mixer, plan_shard_mix,
                                     participation_omega,
                                     ParticipationSchedule,
                                     resolve_participation)
from repro_torch.core.transport import (BernoulliLoss, DeadNodeLoss,
                                        DropFirstAttemptLoss, FixedMaskLoss,
                                        GilbertElliottLoss, LossyTransport,
                                        TransportMetrics, fragment,
                                        lora_toa_s, reassemble,
                                        resolve_transport, serialize_payload)
from repro_torch.core.fed_state import FedState, init_fed_state
from repro_torch.core.algorithms import (
    make_cdbfl_round,
    make_dsgld_round,
    make_cffl_round,
    make_sgld_step,
    make_round_fn,
    RoundMetrics,
)
from repro_torch.core.posterior import (BankPredictor, SampleBank,
                                        DeviceSampleBank, DeviceBankState,
                                        PosteriorPredictor, bma_predict,
                                        bma_predict_stacked, place_ensemble,
                                        point_predict, predictive_entropy)
from repro_torch.core import calibration

__all__ = [
    "Compressor", "CompressionPipeline", "FusedCodec", "PerLayerPipeline",
    "WirePayload", "encode_hbm_bytes", "leaf_stages", "make_compressor",
    "parse_layer_rules", "parse_pipeline", "mixing_matrix", "adjacency",
    "spectral_gap", "Topology", "MixSchedule", "build_topology",
    "build_schedule", "graph_adjacency", "mixing_weights",
    "resolve_topology", "dense_mix", "schedule_mix", "make_mixer",
    "ShardContext", "ShardMixStats", "make_shard_mixer", "plan_shard_mix",
    "participation_omega", "ParticipationSchedule", "resolve_participation",
    "BernoulliLoss", "DeadNodeLoss", "DropFirstAttemptLoss", "FixedMaskLoss",
    "GilbertElliottLoss", "LossyTransport", "TransportMetrics", "fragment",
    "lora_toa_s", "reassemble", "resolve_transport", "serialize_payload",
    "FedState", "init_fed_state", "make_cdbfl_round",
    "make_dsgld_round", "make_cffl_round", "make_sgld_step", "make_round_fn",
    "RoundMetrics", "SampleBank", "DeviceSampleBank", "DeviceBankState",
    "BankPredictor", "PosteriorPredictor", "bma_predict",
    "bma_predict_stacked", "place_ensemble", "point_predict",
    "predictive_entropy", "calibration",
]
