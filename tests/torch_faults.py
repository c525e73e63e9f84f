"""The fault-injection harness of ``tests/faults.py`` on the PyTorch port.

The same tiny linear-regression federation (K=4 nodes, L=3 local steps,
minibatch 5, a 6-dimensional linear model, ``topk`` at ratio 0.5 on a ring)
with the same loss patterns, built from the port's loss models, so a test
can run one world through both packages and hold the port to the
reference: :func:`port_model` maps a reference loss model onto the port's,
:func:`port_transport` a reference :class:`LossyTransport` onto the port's,
and :func:`run_port_world` runs the port's engines as ``faults.run_world``
runs the reference's (host or scan, seed 1, the state from
``init_fed_state`` of zero weights).
"""
from typing import List, NamedTuple

import numpy as np
import torch

import faults
from repro_torch import random
from repro_torch.config import (FedConfig, ParticipationConfig,
                                TransportConfig)
from repro_torch.core import transport as pt
from repro_torch.core.algorithms import make_round_fn
from repro_torch.core.compression import make_compressor
from repro_torch.core.fed_state import init_fed_state
from repro_torch.core.posterior import DeviceSampleBank
from repro_torch.core.topology import build_topology, resolve_topology
from repro_torch.data.partition import DeviceShards
from repro_torch.train.engine import make_engine

K, L, M, DIM = faults.K, faults.L, faults.M, faults.DIM


def linear_nll(params, batch):
    """``faults.linear_loss`` on every node: the (K,) mean squared errors
    of ``x @ w``."""
    pred = torch.einsum("kmd,kd->km", batch["x"], params["w"])
    return ((pred - batch["y"]) ** 2).mean(dim=1)


def port_model(model):
    """The port's loss model of a reference loss model, field for field."""
    name = type(model).__name__
    if name in ("DeadNodeLoss", "DropFirstAttemptLoss"):
        fields = dict(vars(model))
        fields["base"] = port_model(model.base)
        return getattr(pt, name)(**fields)
    return getattr(pt, name)(**vars(model))


def port_transport_config(cfg) -> TransportConfig:
    return TransportConfig(**vars(cfg))


def port_participation_config(cfg) -> ParticipationConfig:
    return ParticipationConfig(**vars(cfg))


def port_transport(transport, num_nodes: int = K):
    """The port's transport of a reference one (or of a reference
    TransportConfig, or None)."""
    if transport is None:
        return None
    if not hasattr(transport, "model"):
        return pt.LossyTransport(port_transport_config(transport),
                                 num_nodes=num_nodes)
    return pt.LossyTransport(port_transport_config(transport.cfg),
                             num_nodes=transport.num_nodes,
                             model=port_model(transport.model),
                             link_probs=transport._link_probs)


class PortRun(NamedTuple):
    state: object
    bank: object
    key: torch.Tensor
    losses: np.ndarray
    cons: np.ndarray
    wire: List[float]
    offered: List[float]
    delivered: List[float]
    airtime: List[float]
    energy: List[float]
    retransmits: List[float]
    abandoned: List[float]
    participation: np.ndarray


def run_port_world(engine_name="host", algorithm="cdbfl", transport=None,
                   rounds=8, chunk=4, seed=1, topology="ring",
                   sizes=(17, 20, 20, 13), participation=None) -> PortRun:
    """``faults.run_world`` on the port: ``transport`` and
    ``participation`` are the reference's objects (mapped here)."""
    fed = FedConfig(num_nodes=K, local_steps=L, eta=5e-3, zeta=0.3,
                    burn_in=4, compressor="topk", compress_ratio=0.5,
                    topology=topology, algorithm=algorithm,
                    participation=(None if participation is None else
                                   port_participation_config(participation)))
    topo = build_topology(resolve_topology(fed), K)
    comp = make_compressor(fed)
    dshards = DeviceShards.from_shards(faults.make_shards(sizes), "cpu")
    bayes = algorithm in ("cdbfl", "dsgld")
    bank_cfg = DeviceSampleBank(burn_in=4, capacity=5, thin=2)
    rf = make_round_fn(algorithm, linear_nll, fed, topo.omega, comp,
                       data_scale=10.0, device="cpu",
                       transport=port_transport(transport))
    eng = make_engine(engine_name, rf, dshards, L, M,
                      bank=bank_cfg if bayes else None, chunk=chunk)
    state = init_fed_state({"w": torch.zeros(DIM)}, fed)
    if not bayes:
        bank0 = None
    elif engine_name == "host":
        bank0 = eng.make_bank()
    else:
        bank0 = bank_cfg.init(state.params)
    state, key, bank, losses, cons = eng.run(state, random.PRNGKey(seed),
                                             bank0, rounds)
    return PortRun(state=state, bank=bank, key=key,
                   losses=np.asarray(losses), cons=np.asarray(cons),
                   wire=list(eng.last_wire_history),
                   offered=list(eng.last_offered_history),
                   delivered=list(eng.last_delivered_history),
                   airtime=list(eng.last_airtime_history),
                   energy=list(eng.last_energy_history),
                   retransmits=list(eng.last_retransmit_history),
                   abandoned=list(eng.last_abandoned_history),
                   participation=np.asarray(eng.last_participation_history,
                                            np.float64))
