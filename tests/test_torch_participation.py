"""Barrier-free rounds in the port (``repro_torch.core.gossip``'s
participation model and the rounds' freeze) against the reference, and the
fault harness's worlds through both packages, on the CPU.

- ``ParticipationSchedule``'s (K,) vector from the round key and the
  round index (an int or a device int tensor): exact, every config and
  round; its validation errors.
- ``participation_omega`` against the jitted reference: bit for bit (the
  diagonal's row sums in column order).
- Every mixer lowering with a node mask (and with the transport's
  ``link_probs``) against the jitted reference mixer: exact, the dense
  einsum within rtol 1e-6 (a matmul's summation order).
- ``tests/faults.py``'s worlds (fixed drops, asymmetric rates, bursts, dead
  nodes, dead links, drop-first-attempt, stragglers, death timelines) run
  through both packages (``tests/torch_faults.py``) under cdbfl, dsgld and
  cffl: params within the port's round tolerance (rtol 1e-4, atol 1e-6),
  losses within rtol 1e-4, offered, delivered and abandoned bytes,
  retransmits and participation vectors exact, airtime and energy within
  rtol 1e-6.
- The scan engine equals the host engine bit for bit with a death
  timeline crossing a chunk boundary; an inactive config is invisible.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faults
import torch_faults
from repro.config import ParticipationConfig as JaxParticipationConfig
from repro.config import TopologyConfig as JaxTopologyConfig
from repro.config import TransportConfig as JaxTransportConfig
from repro.core import build_topology as jbuild_topology
from repro.core import gossip as jgossip
from repro.core.topology import GRAPHS
from repro_torch.config import ParticipationConfig, TopologyConfig
from repro_torch.core import gossip
from repro_torch.utils.tree import tree_leaves

RTOL, ATOL = 1e-4, 1e-6


def _port_key(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


# -- the schedule ---------------------------------------------------------------

SCHEDULES = {
    "stragglers": dict(straggler_prob=0.3),
    "listed": dict(straggler_prob=1.0, stragglers=(2,)),
    "timeline": dict(straggler_prob=0.2, dead=((1, 2, 5), (3, 4, -1))),
    "dead-at-zero": dict(dead=((0, 0, -1),)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_mask_is_the_references(name):
    k = 6
    ref = jgossip.ParticipationSchedule(
        JaxParticipationConfig(**SCHEDULES[name]), k)
    port = gossip.ParticipationSchedule(
        ParticipationConfig(**SCHEDULES[name]), k)
    mask = jax.jit(ref.mask)
    for seed in (0, 7):
        for t in range(7):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
            want = np.asarray(mask(key, jnp.int32(t)))
            u = port.draws(_port_key(key))
            for idx in (t, torch.tensor(t, dtype=torch.int32)):
                np.testing.assert_array_equal(
                    port.mask(u, idx, "cpu").numpy(), want)


def test_schedule_validation_is_the_references():
    for cfg in (dict(straggler_prob=0.1, stragglers=(9,)),
                dict(dead=((7, 2, -1),)), dict(dead=((1, 5, 5),))):
        with pytest.raises(ValueError):
            gossip.ParticipationSchedule(ParticipationConfig(**cfg), 4)
    from repro_torch.config import FedConfig
    assert gossip.resolve_participation(FedConfig()) is None
    assert gossip.resolve_participation(FedConfig(
        participation=ParticipationConfig())) is None
    assert gossip.resolve_participation(FedConfig(
        participation=ParticipationConfig(dead=((1, 2, -1),)))).active


# -- the mixers -----------------------------------------------------------------

def _omega(graph, k, **kw):
    cfg = JaxTopologyConfig(graph=graph, radius=0.5, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        omega = jbuild_topology(cfg, k).omega
    return omega, cfg, TopologyConfig(graph=graph, radius=0.5, **kw)


def _masks(k, rng, count=6):
    out = [np.ones(k, np.float32), np.zeros(k, np.float32)]
    while len(out) < count:
        out.append((rng.random(k) < 0.6).astype(np.float32))
    return out


@pytest.mark.parametrize("graph", ["ring", "geometric", "full", "star"])
def test_participation_omega_is_the_jitted_references(graph):
    rng = np.random.default_rng(2)
    for k in (4, 5, 10):
        omega, _, _ = _omega(graph, k)
        for p in _masks(k, rng):
            want = jax.jit(jgossip.participation_omega)(omega, p)
            got = gossip.participation_omega(omega, torch.from_numpy(p))
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


TV = {"static": {}, "drop": dict(link_failure_prob=0.3),
      "pairs": dict(gossip_pairs=2)}


@pytest.mark.parametrize("outage", [False, True])
@pytest.mark.parametrize("tv", list(TV))
@pytest.mark.parametrize("graph", GRAPHS)
def test_every_lowering_with_a_node_mask_is_the_jitted_mixer(graph, tv,
                                                            outage):
    """Each lowering (identity, dense, roll, schedule, time-varying) at K in
    {1, 5, 10} with node masks, and with an SNR-style outage matrix as
    ``link_probs``, under one key."""
    rng = np.random.default_rng(3)
    for k in (1, 5, 10):
        omega, jcfg, pcfg = _omega(graph, k, **TV[tv])
        probs = ((lambda s: np.where(s.perms != np.arange(s.k), 0.3, 0.0))
                 if outage else None)
        jmix = jax.jit(lambda t, key, m: jgossip.make_mixer(
            omega, config=jcfg, link_probs=probs)(t, key, m))
        mix = gossip.make_mixer(omega, "cpu", config=pcfg, link_probs=probs)
        mode, _ = jgossip.plan_mixer(omega, jcfg, force_tv=outage)
        assert mix.mode == mode
        x = (rng.standard_normal((k, 23, 2)) * 1e-2).astype(np.float32)
        key = jax.random.PRNGKey(k)
        for p in _masks(k, rng, 4):
            want = np.asarray(jmix({"a": jnp.asarray(x)}, key,
                                   jnp.asarray(p))["a"])
            got = mix({"a": torch.from_numpy(x)}, _port_key(key),
                      torch.from_numpy(p))["a"].numpy()
            if mode == "dense":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
            else:
                np.testing.assert_array_equal(_bits(got), _bits(want))


# -- the fault harness's worlds ------------------------------------------------

WORLDS = {
    "fixed-drop": lambda: (faults.make_transport(
        model=faults.fixed_drop(1), mtu=16), None),
    "asymmetric": lambda: (faults.make_transport(
        model=faults.asymmetric([0.0, 0.6, 0.1, 0.9]), mtu=16), None),
    "bursts-arq": lambda: (faults.make_transport(
        model=faults.bursty(p_enter=0.2, p_exit=0.5), mtu=16, arq=True),
        None),
    "dead-node": lambda: (faults.make_transport(
        model=faults.dead_nodes(1), mtu=32), None),
    "dead-links": lambda: (faults.make_transport(
        link_probs=faults.dead_links([(0, 1)]), mtu=32, erasure=0.1), None),
    "drop-first-attempt": lambda: (faults.make_transport(
        model=faults.drop_first_attempts(1), mtu=32, arq=True,
        max_retries=1), None),
    "stragglers": lambda: (JaxTransportConfig(mtu=16, erasure=0.25),
                           faults.stragglers(0.3)),
    "death-timeline": lambda: (JaxTransportConfig(
        mtu=16, erasure=0.3, arq=True, max_retries=2, toa=True,
        duty_cycle=0.5, round_period_s=0.3),
        faults.death_timeline((1, 2, 5), (3, 4), straggler_prob=0.2)),
}


@pytest.mark.parametrize("algorithm", ["cdbfl", "dsgld", "cffl"])
@pytest.mark.parametrize("world", list(WORLDS))
def test_fault_world_tracks_the_reference(world, algorithm):
    transport, participation = WORLDS[world]()
    ref = faults.run_world("host", algorithm, transport=transport,
                           rounds=6, participation=participation)
    got = torch_faults.run_port_world("host", algorithm, transport=transport,
                                      rounds=6, participation=participation)
    for part in ("params", "v", "v_bar"):
        for g, w in zip(tree_leaves(getattr(got.state, part)),
                        jax.tree.leaves(getattr(ref.state, part))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL, err_msg=part)
    np.testing.assert_allclose(got.losses, ref.losses, rtol=RTOL)
    for col in ("wire", "offered", "delivered", "abandoned", "retransmits"):
        assert getattr(got, col) == getattr(ref, col), col
    for col in ("airtime", "energy"):
        np.testing.assert_allclose(getattr(got, col), getattr(ref, col),
                                   rtol=1e-6, atol=0, err_msg=col)
    np.testing.assert_array_equal(got.participation, ref.participation)


@pytest.mark.parametrize("algorithm", ["cdbfl", "dsgld", "cffl"])
def test_scan_equals_host_across_a_death_at_a_chunk_boundary(algorithm):
    """Chunks of 3 over 7 rounds, node 1 out for rounds 2-4 and node 3 from
    round 3 on, stragglers and a budgeted ARQ transport: the chunk that
    starts at round 3 sees its own rounds, bit for bit."""
    transport, participation = WORLDS["death-timeline"]()
    participation = faults.death_timeline((1, 2, 5), (3, 3),
                                          straggler_prob=0.2)
    runs = [torch_faults.run_port_world(engine, algorithm,
                                        transport=transport, rounds=7,
                                        chunk=3, participation=participation)
            for engine in ("host", "scan")]
    host, scan = runs
    for part in ("params", "v", "v_bar"):
        for a, b in zip(tree_leaves(getattr(host.state, part)),
                        tree_leaves(getattr(scan.state, part))):
            assert torch.equal(a, b), part
    assert torch.equal(host.key, scan.key)
    assert host.losses.tolist() == scan.losses.tolist()
    for col in ("offered", "delivered", "abandoned", "retransmits",
                "airtime", "energy"):
        assert getattr(host, col) == getattr(scan, col), col
    np.testing.assert_array_equal(host.participation, scan.participation)
    assert host.participation[3:, 3].tolist() == [0.0] * 4
    assert host.participation[2:5, 1].tolist() == [0.0] * 3


def test_inactive_participation_is_bitwise_invisible():
    plain = torch_faults.run_port_world("scan", "cdbfl", rounds=5)
    inactive = torch_faults.run_port_world(
        "scan", "cdbfl", rounds=5, participation=JaxParticipationConfig())
    for a, b in zip(tree_leaves(plain.state.params),
                    tree_leaves(inactive.state.params)):
        assert torch.equal(a, b)
    assert plain.participation.tolist() == [1.0] * 5


def test_participation_draws_join_the_round_levels(monkeypatch):
    """Stragglers and a lossy transport add no launch to a round: the
    straggler key and uniforms ride the levels of the round's split and
    node keys, the transport's salt, node, leaf and attempt keys the first
    three levels, its Bernoulli uniforms the draws' level."""
    from repro_torch.kernels import threefry
    transport, participation = WORLDS["stragglers"]()
    calls = []
    draw = threefry.draw
    monkeypatch.setattr(threefry, "draw",
                        lambda reqs: calls.append(len(reqs)) or draw(reqs))
    torch_faults.run_port_world("host", "cdbfl", rounds=1)
    plain = list(calls)
    calls.clear()
    torch_faults.run_port_world("host", "cdbfl", transport=transport,
                                rounds=1, participation=participation)
    assert len(calls) == len(plain) == 5
    assert sum(calls) > sum(plain)
