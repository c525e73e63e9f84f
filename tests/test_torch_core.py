"""The port's topology, gossip, federated state, calibration, posterior and
eval accumulators against the reference's, on numpy inputs from a seed.

Exact where both sides run the same f32 operations in the same order
(topology, masks, counts); rtol 1e-6 where a reduction's summation order
may differ (means, einsum, the streaming sums)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.core import calibration as jcal
from repro.core import build_topology as jbuild_topology
from repro.core import resolve_topology as jresolve_topology
from repro.core.gossip import dense_mix as jdense_mix
from repro.core.posterior import SampleBank as JaxSampleBank
from repro.core.posterior import bma_predict_stacked as jbma
from repro.eval import engine as jeval
from repro.models import lenet as jlenet
from repro_torch.config import (LENET_RADAR_REDUCED, ContinualConfig,
                                FedConfig,
                                ParticipationConfig, TopologyConfig,
                                TransportConfig)
from repro_torch.core import calibration as cal
from repro_torch.core.fed_state import init_fed_state
from repro_torch.core.gossip import dense_mix, make_mixer
from repro_torch.core.mixing import mixing_matrix
from repro_torch.core.posterior import SampleBank, bma_predict_stacked
from repro_torch.core.topology import build_topology, resolve_topology
from repro_torch.eval import engine as peval
from repro_torch.models.lenet import lenet_logits, params_from_jax
from repro_torch.utils.tree import tree_leaves, tree_map

import torch_threads  # noqa: F401  (one torch thread a process)

RTOL = 1e-6


def lenet_apply(params, batch):
    """The port's LeNet logits on a batch dict (``get_model``'s contract)."""
    return lenet_logits(params, batch["x"])


@pytest.mark.parametrize("graph,k", [("full", 10), ("full", 3), ("ring", 10),
                                     ("ring", 5), ("full", 1)])
def test_omega_is_the_reference_omega(graph, k):
    want = jbuild_topology(jresolve_topology(JaxFedConfig(topology=graph)), k)
    got = build_topology(resolve_topology(FedConfig(topology=graph)), k)
    np.testing.assert_array_equal(got.adjacency, want.adjacency)
    np.testing.assert_array_equal(got.omega, want.omega)
    np.testing.assert_array_equal(mixing_matrix(graph, k), want.omega)


@pytest.mark.parametrize("graph", ["full", "ring"])
def test_dense_mix_matches_reference(graph):
    """The dense einsum on either Ω (the ring's mixer is its roll lowering,
    held bit for bit in ``test_torch_gossip.py``); ``make_mixer`` takes
    the dense path for the full graph."""
    k = 5
    omega = build_topology(resolve_topology(FedConfig(topology=graph)),
                           k).omega
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((k, 7, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((k, 11)).astype(np.float32)}}
    want = jdense_mix(omega, jax.tree.map(jnp.asarray, tree))
    mix = make_mixer(omega, "cpu")
    assert mix.mode == ("dense" if graph == "full" else "schedule")
    got = dense_mix(torch.as_tensor(omega.astype(np.float32)),
                    tree_map(torch.from_numpy, tree))
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-7)


def test_init_fed_state_stacks_params_and_zeroes_controls():
    p = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    st = init_fed_state(p, FedConfig(num_nodes=4))
    assert st.params["w"].shape == (4, 2, 3) and st.round == 0
    assert torch.equal(st.params["w"][3], p["w"])
    for tree in (st.v, st.v_bar):
        assert all(x.dtype == torch.float32 and not x.any()
                   for x in tree_leaves(tree))
    assert len(set(st.seeds)) == 4


def _probs(n=300, c=10, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c)).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return probs.astype(np.float32), rng.integers(0, c, n).astype(np.int32)


def test_calibration_matches_reference():
    probs, labels = _probs()
    tp, tl = torch.from_numpy(probs), torch.from_numpy(labels)
    jp, jl = jnp.asarray(probs), jnp.asarray(labels)
    for name in ("accuracy", "ece", "nll", "brier"):
        np.testing.assert_allclose(float(getattr(cal, name)(tp, tl)),
                                   float(getattr(jcal, name)(jp, jl)),
                                   rtol=RTOL, err_msg=name)
    got, want = cal.reliability_bins(tp, tl), jcal.reliability_bins(jp, jl)
    np.testing.assert_array_equal(got.bin_counts.numpy(), np.asarray(want.bin_counts))
    for f in ("bin_confidence", "bin_accuracy"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=RTOL)


def test_eval_accumulators_match_reference():
    probs, labels = _probs(seed=1)
    mask = np.ones(len(labels), np.float32)
    mask[-17:] = 0.0
    acc_t = peval.init_accum(10)
    acc_j = jeval.init_accum(10)
    for sl in (slice(0, 128), slice(128, 300)):
        acc_t = peval.update_accum(acc_t, torch.from_numpy(probs[sl]),
                                   torch.from_numpy(labels[sl]),
                                   torch.from_numpy(mask[sl]), 10, 1.5)
        acc_j = jeval.update_accum(acc_j, jnp.asarray(probs[sl]),
                                   jnp.asarray(labels[sl]),
                                   jnp.asarray(mask[sl]), 10, 1.5)
    got, want = peval.finalize(acc_t), jeval.finalize(acc_j)
    for f in ("accuracy", "ece", "mce", "nll", "brier", "entropy",
              "overconf_gap", "count", "abstain_rate", "kept_accuracy"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_array_equal(got.bins.bin_counts, want.bins.bin_counts)


def test_sample_bank_admits_like_reference():
    port, ref = SampleBank(burn_in=3, max_samples=4, thin=2), \
        JaxSampleBank(burn_in=3, max_samples=4, thin=2)
    for t in range(15):
        assert port.maybe_add(t, {"w": torch.full((2,), float(t))}) == \
            ref.maybe_add(t, {"w": np.full((2,), float(t))})
    assert port.rounds == ref.rounds
    assert port.stacked()["w"][:, 0].tolist() == [float(r) for r in ref.rounds]


def test_bma_and_host_eval_engine_match_reference():
    """Stacked (S=2, K=3) reduced LeNets: BMA probabilities and the host
    eval engine's report against the reference's."""
    cfg = LENET_RADAR_REDUCED
    samples = [[jlenet.init_lenet(jax.random.PRNGKey(10 * s + k), cfg)
                for k in range(3)] for s in range(2)]
    stacked_j = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jax.tree.map(lambda *ks: jnp.stack(ks), *row) for row in samples])
    stacked_t = params_from_jax(jax.tree.map(np.asarray, stacked_j))
    rng = np.random.default_rng(2)
    data = {"x": rng.standard_normal((70, 32, 16, 1)).astype(np.float32),
            "y": rng.integers(0, 10, 70).astype(np.int32)}
    want = jbma(lambda p, b: jlenet.lenet_logits(p, b["x"]), stacked_j,
                {"x": jnp.asarray(data["x"][:8])}, node_axis=1)
    got = bma_predict_stacked(lenet_apply, stacked_t,
                              {"x": torch.from_numpy(data["x"][:8])},
                              node_axis=1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    rep_j, probs_j = jeval.HostEvalEngine(
        lambda p, b: jlenet.lenet_logits(p, b["x"]), batch_size=32).evaluate(
        stacked_j, data, node_axis=1, return_probs=True)
    rep_t, probs_t = peval.HostEvalEngine(lenet_apply, batch_size=32).evaluate(
        stacked_t, data, node_axis=1, return_probs=True)
    np.testing.assert_allclose(probs_t, probs_j, rtol=1e-5, atol=1e-6)
    assert rep_t.accuracy == rep_j.accuracy and rep_t.count == rep_j.count == 70
    np.testing.assert_allclose(rep_t.ece, rep_j.ece, atol=1e-5)


def test_host_eval_engine_takes_its_device_from_the_parameters():
    """``evaluate`` has no device argument: on CPU-stacked parameters the
    batches go to the CPU, and the report and probabilities are exactly
    those of the same loop with every batch placed on the CPU by hand."""
    cfg = LENET_RADAR_REDUCED
    stacked = params_from_jax(jax.tree.map(np.asarray, jax.tree.map(
        lambda *xs: jnp.stack(xs)[:, None],
        *[jlenet.init_lenet(jax.random.PRNGKey(s), cfg) for s in range(2)])))
    rng = np.random.default_rng(5)
    data = {"x": rng.standard_normal((41, 32, 16, 1)).astype(np.float32),
            "y": rng.integers(0, 10, 41).astype(np.int32)}
    engine = peval.HostEvalEngine(lenet_apply, batch_size=16)
    with pytest.raises(TypeError):
        engine.evaluate(stacked, data, node_axis=1, device="cpu")
    report, probs = engine.evaluate(stacked, data, node_axis=1,
                                    return_probs=True)
    batches, masks = peval.stack_eval_batches(data, 16, "cpu")
    acc, want = peval.init_accum(10, "cpu"), []
    for i in range(masks.shape[0]):
        p = bma_predict_stacked(lenet_apply, stacked,
                                {f: v[i] for f, v in batches.items()},
                                node_axis=1)
        acc = peval.update_accum(acc, p, batches["y"][i], masks[i], 10)
        want.append(p)
    expected = peval.finalize(acc)
    assert probs.dtype == np.float32 and probs.shape == (41, 10)
    np.testing.assert_array_equal(
        probs.view(np.int32), torch.cat(want)[:41].numpy().view(np.int32))
    for field in expected._fields:
        got, exp = getattr(report, field), getattr(expected, field)
        if field == "bins":
            for a, b in zip(got, exp):
                np.testing.assert_array_equal(a, b)
        else:
            assert got == exp or (np.isnan(got) and np.isnan(exp)), field


def test_fed_config_has_every_reference_field_at_its_default():
    """ROADMAP C13: code written for the reference's FedConfig runs on the
    port's, and every reference field's default is accepted."""
    import dataclasses
    ref = {f.name: f.default for f in dataclasses.fields(JaxFedConfig)}
    port = {f.name: f.default for f in dataclasses.fields(FedConfig)}
    assert set(ref) <= set(port)
    for name, default in ref.items():
        assert port[name] == default, name
    FedConfig(**ref).check_supported()


@pytest.mark.parametrize("rule", ["metropolis", "max_degree", "uniform"])
@pytest.mark.parametrize("graph,k", [("ring", 5), ("full", 4)])
def test_mixing_rule_gives_the_reference_omega(rule, graph, k):
    """``FedConfig.mixing`` reaches Ω through the trainer, as the reference's
    ``resolve_topology`` carries it."""
    from repro_torch.data.radar import make_dataset
    from repro_torch.data.partition import partition_iid
    from repro_torch.models import get_model
    from repro_torch.config import get_arch
    from repro_torch.train import FedTrainer
    want = jbuild_topology(jresolve_topology(
        JaxFedConfig(topology=graph, mixing=rule)), k).omega
    cfg = get_arch("lenet-radar").reduced
    trainer = FedTrainer(get_model(cfg), FedConfig(num_nodes=k,
                                                   topology=graph,
                                                   mixing=rule),
                         partition_iid(make_dataset(2 * k, hw=cfg.input_hw),
                                       k), minibatch=2, device="cpu")
    np.testing.assert_array_equal(trainer.omega, want)
    np.testing.assert_array_equal(
        build_topology(TopologyConfig(graph=graph, rule=rule), k).omega, want)


@pytest.mark.parametrize("field,item", [
    ("topology_cfg", None), ("transport", "A8"), ("participation", "A7"),
    ("continual", "A9")])
def test_unported_fed_config_fields_name_their_item(field, item):
    """``topology_cfg`` runs since ROADMAP A4's topology was ported,
    ``transport``, ``participation`` and ``continual`` since A8, A7 and A9
    were."""
    runs = {"topology_cfg": TopologyConfig(graph="geometric",
                                           link_failure_prob=0.1,
                                           gossip_pairs=2),
            "transport": TransportConfig(erasure=0.1, arq=True, toa=True),
            "participation": ParticipationConfig(straggler_prob=0.2,
                                                 dead=((1, 2, 4),)),
            "continual": ContinualConfig(scenario="gain_drift", severity=0.5,
                                         onset=3, window=4, decay=0.9)}
    FedConfig(**{field: runs[field]}).check_supported()
