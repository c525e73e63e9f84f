"""The port's topology module against the reference's
(``repro_torch.core.topology`` against ``repro.core.topology``), mirroring
``tests/test_topology.py``: every graph family of ``GRAPHS`` at K in {1, 2,
3, 5, 7, 10, 16} under every mixing rule and several graph seeds, its
adjacency, Ω, edge matchings (perms, weights, circulant shifts and
coefficients) and ``plan_mixer``'s mode, static and time-varying; the
spectral diagnostics; ``resolve_topology``; the prime-K grid warning; the
legacy string API.

Everything here is numpy on both sides (the same draws of
``numpy.random`` and the same float64 arithmetic), so every comparison is
exact: ``assert_array_equal`` on the arrays, ``==`` on the floats."""
import warnings

import numpy as np
import pytest

from repro.config import FedConfig as JaxFedConfig
from repro.config import TopologyConfig as JaxTopologyConfig
from repro.core import gossip as jgossip
from repro.core import mixing as jmixing
from repro.core import topology as jtopo
from repro_torch.config import FedConfig, TopologyConfig
from repro_torch.core import gossip, mixing, topology

KS = [1, 2, 3, 5, 7, 10, 16]
RULES = ["metropolis", "max_degree", "uniform"]
SEEDS = [0, 1, 7]
# the family parameters of each graph's configurations
PARAMS = {"k_regular": [dict(degree=4), dict(degree=6)],
          "erdos_renyi": [dict(edge_prob=0.3), dict(edge_prob=0.6)],
          "geometric": [dict(radius=0.45), dict(radius=0.5)]}


def _built(cfg_kw, k):
    """The reference's and the port's ``Topology`` of one configuration
    (or the exception each raises), warnings silenced."""
    out = []
    for cls, mod in ((JaxTopologyConfig, jtopo), (TopologyConfig, topology)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                out.append(mod.build_topology(cls(**cfg_kw), k))
            except ValueError as err:
                out.append(err)
    return out


def _plans(om, cfg_kw):
    out = []
    for cls, mod in ((JaxTopologyConfig, jgossip), (TopologyConfig, gossip)):
        try:
            out.append(mod.plan_mixer(om, cls(**cfg_kw)))
        except (ValueError, AssertionError) as err:
            out.append(err)
    return out


def _assert_same_schedule(got, want):
    if want is None:
        assert got is None
        return
    assert got.k == want.k and got.num_perms == want.num_perms
    np.testing.assert_array_equal(got.perms, want.perms)
    assert got.perms.dtype == want.perms.dtype
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.weights.dtype == want.weights.dtype
    assert got.shifts == want.shifts and got.coeffs == want.coeffs
    assert got.wire_bytes(1000.0) == want.wire_bytes(1000.0)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("graph", jtopo.GRAPHS)
def test_topology_is_the_reference_topology(graph, k, rule):
    """Adjacency, Ω, the spectral numbers, ``describe()``, the schedule and
    ``plan_mixer``'s mode (static, link dropout, gossip pairs), at every
    seed and family parameter, exactly."""
    assert topology.GRAPHS == jtopo.GRAPHS
    for extra in PARAMS.get(graph, [{}]):
        for seed in SEEDS:
            kw = dict(graph=graph, rule=rule, seed=seed, **extra)
            want, got = _built(kw, k)
            if isinstance(want, Exception):
                assert type(got) is type(want) and str(got) == str(want)
                continue
            np.testing.assert_array_equal(got.adjacency, want.adjacency)
            np.testing.assert_array_equal(got.omega, want.omega)
            assert (got.k, got.max_degree, got.num_edges) == \
                (want.k, want.max_degree, want.num_edges)
            assert got.lambda2 == want.lambda2
            assert got.spectral_gap == want.spectral_gap
            assert got.describe() == want.describe()
            for tv in ({}, dict(link_failure_prob=0.2), dict(gossip_pairs=2),
                       dict(link_failure_prob=0.1, gossip_pairs=1)):
                pw, pg = _plans(want.omega, dict(kw, **tv))
                if isinstance(pw, Exception):
                    assert type(pg) is type(pw)
                    continue
                assert pg[0] == pw[0], (kw, tv)
                _assert_same_schedule(pg[1], pw[1])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("graph", ["ring", "k_regular", "geometric", "star"])
def test_build_schedule_and_its_parts_match(graph, k):
    """``edge_matchings``, ``circulant_coefficients`` and ``build_schedule``
    (its reconstruction check included) on Ω directly."""
    want, got = _built(dict(graph=graph, radius=0.5), k)
    om = want.omega
    assert topology.edge_matchings(got.adjacency) == \
        jtopo.edge_matchings(want.adjacency)
    cw = jtopo.circulant_coefficients(om)
    cg = topology.circulant_coefficients(om)
    assert (cw is None) == (cg is None)
    if cw is not None:
        np.testing.assert_array_equal(cg, cw)
    _assert_same_schedule(topology.build_schedule(om), jtopo.build_schedule(om))
    assert topology.dense_wire_bytes(k, 123.0) == \
        jtopo.dense_wire_bytes(k, 123.0)


def test_build_schedule_refuses_what_the_reference_refuses():
    for om in (np.array([[0.5, 0.5], [0.4, 0.6]]),       # not symmetric
               np.array([[0.5, 0.3], [0.3, 0.5]])):      # not stochastic
        with pytest.raises(ValueError) as want:
            jtopo.build_schedule(om)
        with pytest.raises(ValueError) as got:
            topology.build_schedule(om)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k", [5, 7, 13])
@pytest.mark.parametrize("graph", ["grid", "torus"])
def test_prime_grid_warns_as_the_reference(graph, k):
    """A prime K factorizes as 1 x K and degenerates, with the reference's
    warning."""
    with pytest.warns(UserWarning) as want:
        jtopo.graph_adjacency(graph, k)
    with pytest.warns(UserWarning) as got:
        topology.graph_adjacency(graph, k)
    assert [str(w.message) for w in got] == [str(w.message) for w in want]


def test_unknown_graph_and_rule_raise_as_the_reference():
    for fn, args in (("graph_adjacency", ("hypercube", 4)),):
        with pytest.raises(ValueError) as want:
            getattr(jtopo, fn)(*args)
        with pytest.raises(ValueError) as got:
            getattr(topology, fn)(*args)
        assert str(got.value) == str(want.value)
    adj = jtopo.graph_adjacency("ring", 4)
    with pytest.raises(ValueError, match="unknown mixing rule"):
        topology.mixing_weights(adj, "sinkhorn")


@pytest.mark.parametrize("fed", [
    dict(), dict(topology="ring", mixing="max_degree", seed=3),
    dict(topology="geometric"),
    dict(topology_cfg=dict(graph="torus", link_failure_prob=0.1)),
    dict(topology="ring", topology_cfg=dict(graph="erdos_renyi",
                                            gossip_pairs=2, seed=4))])
def test_resolve_topology_follows_the_reference(fed):
    """``topology_cfg`` wins; else the legacy strings map onto a static
    TopologyConfig with the run's rule and seed."""
    tc = fed.get("topology_cfg")
    jfed = JaxFedConfig(**dict(fed, topology_cfg=JaxTopologyConfig(**tc)
                               if tc else None))
    pfed = FedConfig(**dict(fed, topology_cfg=TopologyConfig(**tc)
                            if tc else None))
    assert vars(topology.resolve_topology(pfed)) == \
        vars(jtopo.resolve_topology(jfed))


def test_topology_config_has_the_reference_fields_and_defaults():
    assert vars(TopologyConfig()) == vars(JaxTopologyConfig())
    assert TopologyConfig().replace(graph="ring").graph == "ring"


@pytest.mark.parametrize("graph", jtopo.GRAPHS)
def test_legacy_mixing_matrix_delegates_every_graph(graph):
    for k in (1, 4, 9):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            np.testing.assert_array_equal(mixing.mixing_matrix(graph, k),
                                          jmixing.mixing_matrix(graph, k))
            np.testing.assert_array_equal(mixing.adjacency(graph, k),
                                          jmixing.adjacency(graph, k))
        assert mixing.spectral_gap(jmixing.mixing_matrix(graph, k)) == \
            jmixing.spectral_gap(jmixing.mixing_matrix(graph, k))
