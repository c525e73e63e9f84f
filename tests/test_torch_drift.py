"""Streaming drift and continual posteriors in the port (ROADMAP A9):
``repro_torch.data.scenarios``' drift schedules and pools,
``repro_torch.train.drift.DriftRefresher``, ``FedTrainer(continual=...)``
and the drift-recovery gate, against the reference on the CPU at reduced
width.

- Schedules: ``severity_at``, ``phase`` and ``onset_round`` equal the
  reference's bit for bit over rounds 0-200 for every kind (numpy's
  ``cos`` and the module's ``_lerp``, the reference's float arithmetic);
  validation raises the reference's errors.
- Pools: ``make_drift_shards`` byte-equal to the reference's for every
  registered scenario; a repeated severity gives the same pool.
- The refresher: segments equal the reference's (the ramp case of DESIGN.md
  §15 included), a base phase returns the caller's pool object, token
  pools are refused, ``eval_dataset`` is the reference's byte for byte.
- The trainer: before onset a drift run is bit for bit the run without
  one, on both engines. ROADMAP C26: a piecewise schedule that returns to
  its base pool runs bit for bit alike on the scan and host engines, and
  both match the reference's ``FedTrainer(continual=...)`` within
  ``tests/test_torch_trainer.py``'s bounds (losses rtol 1e-4, BMA
  probabilities atol 1e-4, accuracy within one example, ECE within 0.01:
  the local steps differ from XLA's in the last bits); the caller's pool
  is never written.
- ``run_drift_recovery`` at a reduced spec: each probe within one example
  of accuracy and 0.01 of ECE of the reference's (the same bounds), the
  recovery summary equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.eval.matrix as jax_matrix
from repro.config import (ContinualConfig as JaxContinualConfig,
                          FedConfig as JaxFedConfig)
from repro.data import scenarios as jax_scenarios
from repro.data.partition import DeviceShards as JaxDeviceShards
from repro.data.partition import partition_iid
from repro.data.radar import make_dataset
from repro.models import get_model as jax_get_model
from repro.config import get_arch as jax_get_arch
from repro.train import FedTrainer as JaxFedTrainer
from repro.train.drift import DriftRefresher as JaxDriftRefresher

import repro_torch.eval.matrix as matrix
from repro_torch.config import ContinualConfig, FedConfig, get_arch
from repro_torch.data import scenarios
from repro_torch.data.partition import DeviceShards
from repro_torch.models import get_model
from repro_torch.train import FedTrainer
from repro_torch.train.drift import DriftRefresher, make_refresher
from repro_torch.utils.tree import tree_leaves

import torch_threads  # noqa: F401  (one torch thread a process)

HW = (32, 16)
K = 4
ECE_BOUND = 0.01

# one schedule a kind (and the edge forms of each): DriftSchedule fields
SCHEDULES = {
    "constant": dict(kind="constant", severity=0.6),
    "constant-at-base": dict(kind="constant", severity=0.3, base=0.3),
    "step": dict(kind="step", severity=0.8, onset=45, refresh_every=5),
    "ramp": dict(kind="ramp", severity=1.0, onset=10, ramp_rounds=20,
                 refresh_every=10),
    "ramp-0-rounds": dict(kind="ramp", severity=0.7, base=0.1, onset=7,
                          refresh_every=3),
    "ramp-odd": dict(kind="ramp", severity=0.93, base=0.05, onset=3,
                     ramp_rounds=37, refresh_every=1),
    "cyclic": dict(kind="cyclic", severity=0.8, period=40, onset=20,
                   refresh_every=5),
    "cyclic-odd": dict(kind="cyclic", severity=0.9, base=0.1, period=7,
                       onset=3, refresh_every=2),
    "piecewise": dict(kind="piecewise", breakpoints=((3, 0.8), (6, 0.0))),
    "piecewise-unsorted": dict(kind="piecewise", base=0.2, refresh_every=4,
                               breakpoints=((50, 0.2), (10, 0.5),
                                            (30, 1.0))),
}


def _schedules(name: str, scenario: str = "gain_drift", seed: int = 0):
    kw = dict(SCHEDULES[name], scenario=scenario, seed=seed)
    return (scenarios.DriftSchedule(**kw),
            jax_scenarios.DriftSchedule(**kw))


def _bits(x: float) -> bytes:
    assert isinstance(x, float)
    return np.float64(x).tobytes()


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_equals_the_references_bit_for_bit(name):
    port, ref = _schedules(name)
    for t in range(201):
        assert port.phase(t) == ref.phase(t)
        assert _bits(port.severity_at(t)) == _bits(ref.severity_at(t)), t
    assert port.onset_round() == ref.onset_round()


@pytest.mark.parametrize("kw", [
    dict(kind="sawtooth"), dict(kind="cyclic", period=0),
    dict(kind="piecewise"), dict(scenario="no_such_family")])
def test_schedule_validation_raises_the_references_errors(kw):
    kw = dict(dict(scenario="gain_drift"), **kw)
    with pytest.raises(Exception) as want:
        jax_scenarios.DriftSchedule(**kw)
    with pytest.raises(type(want.value)) as got:
        scenarios.DriftSchedule(**kw)
    assert str(got.value) == str(want.value)


def test_make_drift_schedule_is_the_references():
    for cfg in (None, ContinualConfig(), ContinualConfig(scenario="clean",
                                                         severity=0.9)):
        assert scenarios.make_drift_schedule(cfg) is None
    kw = dict(scenario="doa_miscal", schedule="cyclic", severity=0.7,
              base_severity=0.1, onset=4, period=9, refresh_every=2,
              drift_seed=5, window=3, decay=0.8,
              breakpoints=[(1, 0.5)])
    port = scenarios.make_drift_schedule(ContinualConfig(**kw))
    ref = jax_scenarios.make_drift_schedule(JaxContinualConfig(**kw))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    cont = ContinualConfig(**kw)
    assert cont.drifts and cont.ages
    assert not ContinualConfig().drifts and not ContinualConfig().ages
    assert cont.replace(window=0, decay=1.0).ages is False


@pytest.mark.parametrize("scenario", scenarios.list_scenarios())
def test_drift_shards_equal_the_references(scenario):
    assert scenarios.list_scenarios() == jax_scenarios.list_scenarios()
    port, ref = _schedules("step", scenario, seed=3)
    sizes = [3, 2, 4]
    got = scenarios.make_drift_shards(port, 50, sizes, HW)
    want = jax_scenarios.make_drift_shards(ref, 50, sizes, HW)
    assert len(got) == len(want) == 3
    for g, w, n in zip(got, want, sizes):
        assert sorted(g) == sorted(w) == ["x", "y"]
        for f in g:
            assert g[f].dtype == w[f].dtype and len(g[f]) == n
            assert g[f].tobytes() == w[f].tobytes()
    # another round of the same severity: the same pool
    again = scenarios.make_drift_shards(port, 90, sizes, HW)
    for g, a in zip(got, again):
        assert all(g[f].tobytes() == a[f].tobytes() for f in g)


def _pools(n_each=(3, 2, 4)):
    shards = partition_iid(make_dataset(sum(n_each) + 3, hw=HW, seed=1),
                           len(n_each))
    return (DeviceShards.from_shards(shards, "cpu"),
            JaxDeviceShards.from_shards(shards))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_refresher_segments_equal_the_references(name):
    port, ref = _schedules(name)
    pool, jpool = _pools()
    mine, theirs = DriftRefresher(port, pool), JaxDriftRefresher(ref, jpool)
    for t0, rounds in ((0, 200), (3, 17), (25, 10), (7, 1), (0, 0)):
        assert list(mine.segments(t0, rounds)) == list(
            theirs.segments(t0, rounds))
    if name == "ramp":      # DESIGN.md §15's case: severities 0, 0.5, 1
        assert list(mine.segments(0, 40)) == [(0, 20), (20, 10), (30, 10)]


def test_refresher_pools_and_eval_cells_are_the_references():
    port, ref = _schedules("cyclic-odd", "day23_critical", seed=2)
    pool, jpool = _pools()
    mine, theirs = DriftRefresher(port, pool), JaxDriftRefresher(ref, jpool)
    assert mine.sizes == theirs.sizes and mine.hw == theirs.hw == HW
    base_round = next(t for t in range(50)
                      if port.severity_at(t) == port.base)
    assert mine.shards_for(base_round) is pool
    drifted = next(t for t in range(50) if port.severity_at(t) != port.base)
    got, want = mine.shards_for(drifted), theirs.shards_for(drifted)
    assert got.sizes == tuple(want.sizes)
    for f in ("x", "y"):
        assert got.data[f].numpy().tobytes() == np.asarray(
            want.data[f]).tobytes()
    # a severity's pool is synthesized once
    same = next(t for t in range(drifted + 1, 200)
                if port.severity_at(t) == port.severity_at(drifted))
    assert mine.shards_for(same) is got
    for t in (base_round, drifted, 33):
        g = mine.eval_dataset(t, 12, seed=90)
        w = theirs.eval_dataset(t, 12, seed=90)
        assert all(g[f].tobytes() == w[f].tobytes() for f in ("x", "y"))


class _Recorder:
    """An engine stand-in that records what ``refresh`` installs."""

    def __init__(self):
        self.installed = []

    def set_shards(self, shards):
        self.installed.append(shards)


def test_refresh_installs_on_a_severity_change_only():
    port, _ = _schedules("piecewise")
    pool, _ = _pools()
    mine, eng = DriftRefresher(port, pool), _Recorder()
    sevs = [mine.refresh(eng, t) for t in range(10)]
    assert sevs == [0.0] * 3 + [0.8] * 3 + [0.0] * 4
    assert len(eng.installed) == 2 and eng.installed[1] is pool
    assert eng.installed[0] is mine.shards_for(4)


def test_refresher_refuses_token_pools():
    toks = [{"tokens": np.zeros((4, 9), np.int32)} for _ in range(2)]
    port, ref = _schedules("step")
    with pytest.raises(ValueError) as want:
        JaxDriftRefresher(ref, JaxDeviceShards.from_shards(toks))
    with pytest.raises(ValueError) as got:
        DriftRefresher(port, DeviceShards.from_shards(toks, "cpu"))
    assert str(got.value) == str(want.value)
    pool, _ = _pools()
    assert make_refresher(None, pool) is None
    assert make_refresher(ContinualConfig(), pool) is None
    assert make_refresher(ContinualConfig(scenario="gain_drift"),
                          pool).base_shards is pool


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

FED = dict(num_nodes=K, local_steps=2, eta=3e-3, zeta=0.3, temperature=0.2,
           burn_in=2, rounds=10, compressor="topk", compress_ratio=0.05,
           topology="full")
# ROADMAP C26's schedule: base, drifted (rounds 3-5), base again
RETURN_TO_BASE = dict(scenario="gain_drift", schedule="piecewise",
                      breakpoints=((3, 0.8), (6, 0.0)), refresh_every=1,
                      window=6, decay=0.9)


def _world():
    cfg = get_arch("lenet-radar").reduced
    shards = partition_iid(make_dataset(K * 12, hw=cfg.input_hw, seed=0), K)
    test = make_dataset(60, hw=cfg.input_hw, day=1, seed=99)
    return cfg, shards, test


def _port(engine, continual=None, rounds=10, **kw):
    cfg, shards, _ = _world()
    return FedTrainer(get_model(cfg), FedConfig(**dict(FED, rounds=rounds)),
                      shards, minibatch=5, engine=engine, bank_capacity=8,
                      bank_thin=1, chunk=3, continual=continual,
                      device="cpu", **kw)


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


def _same_report(a, b) -> None:
    """Every field of two ``EvalReport`` s equal, the bins included."""
    for field, x in a._asdict().items():
        y = getattr(b, field)
        if field == "bins":
            for u, v in zip(x, y):
                assert np.array_equal(np.asarray(u), np.asarray(v))
        else:
            assert x == y or (np.isnan(x) and np.isnan(y)), field


def _same_run(a: FedTrainer, b: FedTrainer) -> None:
    for part in ("params", "v", "v_bar"):
        assert all(_same(x, y) for x, y in zip(
            tree_leaves(getattr(a.state, part)),
            tree_leaves(getattr(b.state, part)))), part
    assert torch.equal(a.key, b.key)
    sa, sb = a.bank.samples, b.bank.samples
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert all(_same(p, q) for p, q in zip(tree_leaves(x),
                                               tree_leaves(y)))


@pytest.mark.parametrize("engine", ["host", "scan"])
def test_pre_onset_training_is_bit_for_bit_the_run_without_drift(engine):
    cont = ContinualConfig(scenario="gain_drift", severity=0.9, onset=100,
                           refresh_every=5)
    drift, plain = _port(engine, cont, 8), _port(engine, None, 8)
    assert drift.continual is cont and drift._refresher is not None
    rd, rp = drift.run(rounds=8), plain.run(rounds=8)
    assert rd.loss_history == rp.loss_history
    _same_run(drift, plain)
    # FedConfig.continual is read when the argument is left out
    via_cfg = FedTrainer(get_model(get_arch("lenet-radar").reduced),
                         FedConfig(**dict(FED, continual=cont)), _world()[1],
                         minibatch=5, device="cpu")
    assert via_cfg.continual is cont


@pytest.fixture(scope="module")
def return_to_base():
    """ROADMAP C26's run on the reference (host engine) and on the port's
    two engines, each evaluated (aged: window 6, decay 0.9)."""
    cfg, shards, test = _world()
    ref = JaxFedTrainer(jax_get_model(jax_get_arch("lenet-radar").reduced),
                        JaxFedConfig(**FED), shards, minibatch=5,
                        engine="host", bank_capacity=8, bank_thin=1,
                        continual=JaxContinualConfig(**RETURN_TO_BASE))
    want = ref.run(eval_batch=test)
    runs = {}
    for engine in ("host", "scan"):
        tr = _port(engine, ContinualConfig(**RETURN_TO_BASE))
        base = {f: v.clone() for f, v in tr.device_shards.data.items()}
        runs[engine] = (tr, tr.run(eval_batch=test), base)
    return ref, want, runs, test


def test_c26_scan_engine_equals_host_engine_through_a_return_to_base(
        return_to_base):
    """The scan engine copied each phase's pool into the caller's base
    pool, so after the schedule came back to base it trained on the
    drifted maps again (ROADMAP C26): on the unrepaired engine the two
    engines part at round 7."""
    _, _, runs, _ = return_to_base
    (host, hres, _), (scan, sres, _) = runs["host"], runs["scan"]
    assert sres.loss_history == hres.loss_history
    assert sres.consensus_history == hres.consensus_history
    assert sres.wire_history == hres.wire_history
    _same_run(scan, host)
    assert list(scan.bank_cfg.rounds_list(scan._bank_state)) == \
        host._bank_state.rounds
    assert np.array_equal(sres.probs.view(np.int32),
                          hres.probs.view(np.int32))
    _same_report(sres.report, hres.report)


def test_c26_the_callers_pool_is_never_written(return_to_base):
    _, _, runs, _ = return_to_base
    for engine, (tr, _, base) in runs.items():
        assert tr._refresher.base_shards is tr.device_shards
        for f, v in tr.device_shards.data.items():
            assert torch.equal(v, base[f]), engine
        # the schedule ended at base: the engine trains on the base maps
        for f, v in tr._engine.shards.data.items():
            assert torch.equal(v, base[f]), engine
    scan = runs["scan"][0]
    assert all(v is not scan.device_shards.data[f]
               for f, v in scan._engine.shards.data.items())


@pytest.mark.parametrize("engine", ["host", "scan"])
def test_c26_run_matches_the_reference(engine, return_to_base):
    ref, want, runs, test = return_to_base
    tr, got, _ = runs[engine]
    assert got.wire_history == want.wire_history
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=1e-4)
    assert len(tr.bank) == len(ref.bank) == 8
    rounds = (tr._bank_state.rounds if engine == "host"
              else list(tr.bank_cfg.rounds_list(tr._bank_state)))
    assert rounds == list(ref._bank_state.rounds)
    # the aged report: accuracy within one example, ECE within 0.01, the
    # BMA probabilities within 1e-4 (the last-bit differences of the local
    # steps; tests/test_torch_trainer.py)
    np.testing.assert_allclose(got.probs, want.probs, atol=1e-4)
    assert abs(got.accuracy - want.accuracy) <= 1.0 / len(test["y"]) + 1e-6
    assert abs(got.ece - want.ece) <= ECE_BOUND


def test_age_weights_are_the_references(return_to_base):
    ref, _, runs, _ = return_to_base
    want = ref._bank_weights(ref._stacked_bank())
    assert want is not None and want[0] == 0.0       # window 6 evicts
    for tr, _, _ in runs.values():
        got = tr._bank_weights(tr._stacked_bank())
        assert got.dtype == np.float64
        assert np.array_equal(got, np.asarray(want, np.float64))
    plain = _port("host")
    plain.run(rounds=4)
    assert plain._bank_weights(plain._stacked_bank()) is None


def test_weighted_predictor_equals_the_aged_eval_report(return_to_base):
    """The weighted ``BankPredictor`` and the weighted eval pass run one
    forward; on the CPU their last bits can depend on how torch splits the
    work across threads (``tests/test_torch_serve.py``), so both run on
    one thread here."""
    _, _, runs, test = return_to_base
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for tr, _, _ in runs.values():
            pred = tr.predictor()
            assert pred._weighted and pred.num_samples() == len(tr.bank)
            probs, ent = pred.predict({"x": test["x"][:8]})
            _, want = tr.eval_report({f: v[:8] for f, v in test.items()},
                                     return_probs=True)
            assert np.array_equal(probs.numpy().view(np.int32),
                                  want.view(np.int32))
            assert ent.shape == (8,) and torch.isfinite(ent).all()
    finally:
        torch.set_num_threads(n)


def test_drift_recovery_matches_the_reference():
    kw = dict(rounds=20, onset=10, probe_every=5, refresh_every=5,
              burn_in=4, window=8, nodes=3, per_node=12, local_steps=2,
              eval_examples=60)
    want = jax_matrix.run_drift_recovery(jax_matrix.DriftRecoverySpec(**kw),
                                         log=None)
    got = matrix.run_drift_recovery(matrix.DriftRecoverySpec(**kw), log=None,
                                    device="cpu")
    assert len(got["probes"]) == len(want["probes"]) == 4
    for g, w in zip(got["probes"], want["probes"]):
        assert g["round"] == w["round"] and g["severity"] == w["severity"]
        # one example of accuracy, 0.01 of ECE (the trainer's bounds)
        assert abs(g["accuracy"] - w["accuracy"]) <= 1 / 60 + 1e-6
        assert abs(g["ece"] - w["ece"]) <= ECE_BOUND
    for key in ("algorithm", "onset", "excursion_round", "recovery_round",
                "rounds_to_recovery"):
        assert got[key] == want[key], key
    assert abs(got["pre_ece"] - want["pre_ece"]) <= ECE_BOUND
    assert matrix.DRIFT_RECOVERY_MAX_ROUNDS == \
        jax_matrix.DRIFT_RECOVERY_MAX_ROUNDS
    assert dataclasses.asdict(matrix.DRIFT_CLAIMS_SPEC) == \
        dataclasses.asdict(jax_matrix.DRIFT_CLAIMS_SPEC)
