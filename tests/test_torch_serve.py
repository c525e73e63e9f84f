"""The port's posterior predictor, scan eval engine, serving engine, trainer
serving view and serving CLI against the reference's (``tests/test_serve.py``,
``tests/test_eval_engine.py``), on the CPU at reduced width: LeNet on 16x16
maps, a bank of S=3 samples x K=2 node chains from the reference's inits.

Each contract is checked on the port against itself exactly (serving against
the scan eval, the scan eval against the host eval, a request alone against
the same request in a full table) and against the reference within the
tolerance of ``test_bma_and_host_eval_engine_match_reference``: BMA
probabilities within rtol 1e-5, atol 1e-6 (the port's convolutions and
reductions sum in other orders than XLA's), counts and accuracy exact, ECE
within 1e-5. The age weights are pure float64 numpy on both sides, so
exact. The card's versions of these contracts are in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.config import ServeConfig as JaxServeConfig
from repro.config import get_arch as jax_get_arch
from repro.core import posterior as jpost
from repro.data.partition import partition_iid
from repro.data.radar import make_dataset
from repro.eval import engine as jeval
from repro.models import get_model as jax_get_model
from repro.serve import ClassifyEngine as JaxClassifyEngine
from repro.serve import ServeRequest as JaxServeRequest
from repro.train import FedTrainer as JaxFedTrainer
from repro_torch.config import FedConfig, ServeConfig, get_arch
from repro_torch.core import posterior as post
from repro_torch.eval import engine as peval
from repro_torch.models import get_model
from repro_torch.models.lenet import lenet_logits, params_from_jax
from repro_torch.serve import (ClassifyEngine, DecodeEngine, ServeRequest,
                               live_device_bytes)
from repro_torch.train import FedTrainer
from repro_torch.utils.tree import tree_map

import torch_threads  # noqa: F401  (one torch thread a process)

HW = (16, 16)
S, K = 3, 2
RTOL, ATOL = 1e-5, 1e-6


def lenet_apply(params, batch):
    """The port's LeNet logits on a batch dict (``get_model``'s contract)."""
    return lenet_logits(params, batch["x"])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's exact contracts compare two runs of the same forward. On
    the CPU their bits can depend on how many threads torch splits the
    work across, and a process's first parallel call may get fewer: the
    first forward of a process differed in its last bits from the next
    ones in about a third of the runs with 8 threads, never with one. So
    this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield n
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def radar():
    """The reference's reduced radar bank (``tests/test_serve.py``), and the
    same bank as tensors."""
    cfg = jax_get_arch("lenet-radar").reduced.replace(input_hw=HW)
    model = jax_get_model(cfg)
    key = jax.random.PRNGKey(0)

    def node_stack(i):
        ps = [model.init(jax.random.fold_in(key, i * K + j))
              for j in range(K)]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *ps)

    stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[node_stack(i) for i in range(S)])
    ds = make_dataset(24, hw=HW, day=2, seed=5)
    apply = lambda p, b: model.logits(p, b)           # noqa: E731
    port = params_from_jax(jax.tree.map(np.asarray, stacked))
    return apply, stacked, port, ds


def _same(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def _engine(stacked, ds, slots=8, **kw):
    return ClassifyEngine(lenet_apply, ServeConfig(slots=slots, **kw),
                          input_shape=ds["x"].shape[1:], stacked=stacked,
                          node_axis=1)


def _serve(eng, xs):
    return eng.run([ServeRequest(x=x) for x in xs])


# -- the bank's age weights --------------------------------------------------

@pytest.mark.parametrize("rounds,now,window,decay", [
    ([3, 5, 9], 10, 0, 1.0), ([3, 5, 9], 10, 4, 0.8), ([1, 2], 100, 5, 0.9),
    ([], 5, 0, 1.0), ([0, 4, 8], 8, 0, 1.5), ([0, 4, 8], 8, 0, 0.0),
    ([7, 2, 7], 6, 3, 0.5)])
def test_bank_age_weights_equal_the_reference(rounds, now, window, decay):
    """Including the all-evicted case (the newest sample alone) and an
    admission after ``now`` (age clipped to 0)."""
    want = jpost.bank_age_weights(rounds, now, window=window, decay=decay)
    got = post.bank_age_weights(rounds, now, window=window, decay=decay)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_device_bank_age_weights_equal_the_reference():
    port = post.DeviceSampleBank(burn_in=2, capacity=4, thin=1)
    ref = jpost.DeviceSampleBank(burn_in=2, capacity=4, thin=1)
    bank = port.init({"w": torch.zeros(3)})
    rbank = ref.init({"w": jnp.zeros(3)})
    for t in range(9):
        bank = port.update(bank, t, {"w": torch.full((3,), float(t))})
        rbank = ref.update(rbank, t, {"w": jnp.full((3,), float(t))})
    np.testing.assert_array_equal(port.age_weights(bank, 9, window=3,
                                                   decay=0.7),
                                  ref.age_weights(rbank, 9, window=3,
                                                  decay=0.7))


# -- BMA and the predictor ---------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("node_axis", [1, None])
def test_bma_and_bank_predictor_match_reference(radar, weighted, node_axis):
    apply, stacked, port, ds = radar
    if node_axis is None:                       # one chain a sample
        stacked = jax.tree.map(lambda x: x[:, 0], stacked)
        port = tree_map(lambda x: x[:, 0], port)
    w = np.asarray([0.5, 0.3, 0.2]) if weighted else None
    x = ds["x"][:8]
    want = jpost.bma_predict_stacked(apply, stacked, {"x": jnp.asarray(x)},
                                     node_axis=node_axis, weights=w)
    got = post.bma_predict_stacked(lenet_apply, port,
                                   {"x": torch.from_numpy(x)},
                                   node_axis=node_axis, weights=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    pred = post.BankPredictor(lenet_apply, node_axis=node_axis)
    pred.install(port, weights=w)
    probs, ent = pred.predict({"x": x})
    assert _same(probs, got)
    assert _same(ent, post.predictive_entropy(got))
    assert pred.num_samples() == S and pred.compile_count() == 0
    rprobs, rent = jpost.BankPredictor(apply, node_axis=node_axis)._fn(
        stacked, {"x": jnp.asarray(x)}) if w is None else \
        jpost.BankPredictor(apply, node_axis=node_axis)._fn_weighted(
            stacked, jnp.asarray(w, jnp.float32), {"x": jnp.asarray(x)})
    np.testing.assert_allclose(probs.numpy(), np.asarray(rprobs), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ent.numpy(), np.asarray(rent), rtol=RTOL,
                               atol=ATOL)


def test_uniform_weights_leave_the_mean_within_rounding(radar):
    """Equal weights give the uniform mean, by a separate reduction."""
    _, _, port, ds = radar
    x = {"x": torch.from_numpy(ds["x"][:8])}
    base = post.bma_predict_stacked(lenet_apply, port, x, node_axis=1)
    even = post.bma_predict_stacked(lenet_apply, port, x, node_axis=1,
                                    weights=np.ones(S))
    np.testing.assert_allclose(even.numpy(), base.numpy(), rtol=1e-6)


def test_legacy_predictors_match_reference(radar):
    apply, stacked, port, ds = radar
    x = ds["x"][:4]
    samples = [tree_map(lambda a: a[s], port) for s in range(S)]
    jsamples = [jax.tree.map(lambda a: a[s], stacked) for s in range(S)]
    with pytest.warns(DeprecationWarning):
        got = post.bma_predict(lenet_apply, samples,
                               {"x": torch.from_numpy(x)},
                               node_axis=0)
    with pytest.warns(DeprecationWarning):
        want = jpost.bma_predict(apply, jsamples, {"x": jnp.asarray(x)},
                                 node_axis=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    point = post.point_predict(lenet_apply, samples[0],
                               {"x": torch.from_numpy(x)},
                               node_axis=0)
    np.testing.assert_allclose(point.numpy(), np.asarray(jpost.point_predict(
        apply, jsamples[0], {"x": jnp.asarray(x)}, node_axis=0)), rtol=RTOL,
        atol=ATOL)
    one = post.point_predict(lenet_apply,
                             tree_map(lambda a: a[0], samples[0]),
                             {"x": torch.from_numpy(x)})
    np.testing.assert_allclose(one.numpy(), np.asarray(jpost.point_predict(
        apply, jax.tree.map(lambda a: a[0], jsamples[0]),
        {"x": jnp.asarray(x)})), rtol=RTOL, atol=ATOL)


def test_unported_serving_paths_name_their_roadmap_item(radar):
    _, _, port, ds = radar
    with pytest.raises(NotImplementedError, match="A10"):
        post.BankPredictor(lenet_apply, port, node_axis=1,
                           ensemble_axis="ens")
    with pytest.raises(NotImplementedError, match="A10"):
        post.place_ensemble(port, None, "ens")
    with pytest.raises(NotImplementedError, match="A10"):
        peval.make_eval_engine("shard", lenet_apply)
    with pytest.raises(NotImplementedError, match="A10"):
        ClassifyEngine(lenet_apply, ServeConfig(ensemble_axis="ens"),
                       input_shape=(16, 16, 1))
    assert get_arch("recurrentgemma-9b").config.family == "hybrid"
    assert isinstance(peval.make_eval_engine("scan", lenet_apply),
                      peval.ScanEvalEngine)
    assert isinstance(peval.make_eval_engine("host", lenet_apply),
                      peval.HostEvalEngine)
    with pytest.raises(ValueError):
        peval.make_eval_engine("nope", lenet_apply)
    assert live_device_bytes() >= 0


def test_abstain_mask_is_the_shared_rule():
    ent = torch.tensor([0.1, 1.0, 2.5])
    assert peval.abstain_mask(ent, 1.0).tolist() == [False, False, True]
    assert not peval.abstain_mask(np.float32(0.5), float("inf"))
    got = peval.as_stacked({"w": torch.ones(2, 3)})
    assert got["w"].shape == (1, 2, 3)


# -- the scan eval engine ----------------------------------------------------

def _ragged(seed=2):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((70,) + HW + (1,)).astype(np.float32),
            "y": rng.integers(0, 10, 70).astype(np.int32)}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("gated", [False, True])
def test_scan_eval_engine_matches_reference(radar, weighted, gated):
    """70 maps in batches of 32 (a ragged last batch): the port's scan and
    host engines equal bit for bit, every report field; the reference's
    within the module's tolerance, the abstain rate exact (the threshold
    lies midway between two of the reference's entropies)."""
    apply, stacked, port, _ = radar
    data = _ragged()
    w = np.asarray([0.2, 0.5, 0.3]) if weighted else None
    thr = float("inf")
    if gated:
        _, ent = jpost.BankPredictor(apply, stacked=stacked,
                                     node_axis=1).predict(
            {"x": jnp.asarray(data["x"])})
        e = np.sort(np.asarray(ent))
        thr = float((e[34] + e[35]) / 2)
    rep_j, probs_j = jeval.ScanEvalEngine(
        apply, batch_size=32, entropy_threshold=thr).evaluate(
        stacked, data, node_axis=1, return_probs=True, weights=w)
    scan = peval.ScanEvalEngine(lenet_apply, batch_size=32,
                                entropy_threshold=thr)
    rep, probs = scan.evaluate(port, data, node_axis=1, return_probs=True,
                               weights=w)
    host, hprobs = peval.HostEvalEngine(
        lenet_apply, batch_size=32, entropy_threshold=thr).evaluate(
        port, data, node_axis=1, return_probs=True, weights=w)
    assert _same(probs, hprobs)
    for f in rep._fields:
        a, b = getattr(rep, f), getattr(host, f)
        if f == "bins":
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert a == b or (np.isnan(a) and np.isnan(b)), f
    again = scan.evaluate(port, data, node_axis=1, weights=w)
    assert (again.accuracy, again.ece, again.mce) == (rep.accuracy, rep.ece,
                                                      rep.mce)
    np.testing.assert_allclose(probs, probs_j, rtol=RTOL, atol=ATOL)
    assert probs.shape == (70, 10)
    assert rep.accuracy == rep_j.accuracy and rep.count == rep_j.count == 70
    np.testing.assert_array_equal(rep.bins.bin_counts, rep_j.bins.bin_counts)
    np.testing.assert_allclose(rep.ece, rep_j.ece, atol=1e-5)
    assert rep.abstain_rate == rep_j.abstain_rate
    assert (0.0 < rep.abstain_rate < 1.0) == gated


# -- the serving engine ------------------------------------------------------

def test_classify_bitwise_equals_scan_eval(radar):
    apply, stacked, port, ds = radar
    resps = _serve(_engine(port, ds), ds["x"])
    serve_probs = np.stack([r.probs for r in resps])
    _, eval_probs = peval.ScanEvalEngine(lenet_apply, batch_size=8).evaluate(
        port, ds, node_axis=1, return_probs=True)
    assert _same(serve_probs, eval_probs)
    ent = post.predictive_entropy(torch.from_numpy(serve_probs)).numpy()
    np.testing.assert_allclose(np.asarray([r.entropy for r in resps],
                                          np.float32), ent, rtol=1e-6, atol=0)
    ref = JaxClassifyEngine(apply, JaxServeConfig(slots=8),
                            input_shape=ds["x"].shape[1:], stacked=stacked,
                            node_axis=1).run(
        [JaxServeRequest(x=x) for x in ds["x"]])
    np.testing.assert_allclose(serve_probs, np.stack([r.probs for r in ref]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose([r.entropy for r in resps],
                               [r.entropy for r in ref], rtol=RTOL, atol=ATOL)


def test_classify_zero_recompiles_across_occupancy(radar):
    """No graph on the CPU, so the port's count is 0 and stays 0; the card
    test holds it at 1."""
    _, _, port, ds = radar
    eng = _engine(port, ds)
    first = _serve(eng, ds["x"][:1])                    # warm-up: 1/8 slots
    c0 = eng.compile_count()
    full = _serve(eng, ds["x"][:17])                    # full, then partial
    last = _serve(eng, ds["x"][3:4])                    # single
    assert eng.compile_count() == c0 == 0
    assert _same(first[0].probs, full[0].probs)
    assert _same(last[0].probs, full[3].probs)
    assert [r.request_id for r in full] == list(range(1, 18))


def test_classify_abstain_stable_under_batch_composition(radar):
    apply, stacked, port, ds = radar
    _, ent = post.BankPredictor(lenet_apply, port, node_axis=1).predict(
        {"x": ds["x"][:16]})
    thr = float(np.median(ent.numpy()))
    together = _serve(_engine(port, ds, entropy_threshold=thr), ds["x"][:16])
    alone = _engine(port, ds, entropy_threshold=thr)
    for i, r in enumerate(together):
        solo = _serve(alone, ds["x"][i:i + 1])[0]
        assert solo.abstain == r.abstain
        assert solo.entropy == r.entropy                # bitwise
    assert {r.abstain for r in together} == {True, False}
    _, rent = jpost.BankPredictor(apply, stacked=stacked, node_axis=1
                                  ).predict({"x": jnp.asarray(ds["x"][:16])})
    np.testing.assert_allclose([r.entropy for r in together],
                               np.asarray(rent), rtol=RTOL, atol=ATOL)


def test_classify_swap_bumps_version_not_compiles(radar):
    apply, stacked, port, ds = radar
    eng = _engine(port, ds)
    r0 = _serve(eng, ds["x"][:1])[0]
    c0 = eng.compile_count()
    eng.install_bank(tree_map(lambda x: x + 0.1, port))
    r1 = _serve(eng, ds["x"][:1])[0]
    assert eng.compile_count() == c0
    assert (r0.bank_version, r1.bank_version) == (1, 2)
    assert not np.array_equal(r0.probs, r1.probs)
    ref = JaxClassifyEngine(apply, JaxServeConfig(slots=8),
                            input_shape=ds["x"].shape[1:],
                            stacked=jax.tree.map(lambda x: x + 0.1, stacked),
                            node_axis=1).run([JaxServeRequest(x=ds["x"][0])])
    np.testing.assert_allclose(r1.probs, ref[0].probs, rtol=RTOL, atol=ATOL)
    # a bank of another sample count: new buffers, same answers as a fresh
    # predictor over it
    eng.install_bank(tree_map(lambda x: x[:2], port))
    assert eng.num_samples() == 2 and eng.bank_version == 3
    r2 = _serve(eng, ds["x"][:1])[0]
    fresh = _serve(_engine(tree_map(lambda x: x[:2], port), ds), ds["x"][:1])
    assert _same(r2.probs, fresh[0].probs)


# -- the trainer's serving view and its in-training evaluations --------------

TRAIN_FED = dict(num_nodes=3, local_steps=2, eta=3e-3, zeta=0.3, rounds=6,
                 burn_in=2, compressor="block_topk", compress_ratio=0.05,
                 topology="full", algorithm="cdbfl", seed=0)


def _trainers(rounds, eval_every=0, burn_in=2):
    model_cfg = jax_get_arch("lenet-radar").reduced.replace(input_hw=HW)
    shards = partition_iid(make_dataset(3 * 12, hw=HW, day=1, seed=0), 3,
                           seed=0)
    test = make_dataset(24, hw=HW, day=2, seed=5)
    fed = dict(TRAIN_FED, rounds=rounds, burn_in=burn_in)
    ref = JaxFedTrainer(jax_get_model(model_cfg), JaxFedConfig(**fed), shards,
                        minibatch=6, eval_batch_size=8, engine="host")
    want = ref.run(rounds=rounds, eval_batch=test, eval_every=eval_every)
    port = FedTrainer(get_model(get_arch("lenet-radar").reduced.replace(
        input_hw=HW)), FedConfig(**fed), shards, minibatch=6,
        eval_batch_size=8, device="cpu")
    got = port.run(rounds=rounds, eval_batch=test, eval_every=eval_every)
    return ref, want, port, got, test


def test_trainer_predictor_matches_eval_report():
    """``FedTrainer.predictor()`` is the serving view of the trainer: its
    BMA probabilities equal the eval engine's on the same batch bit for
    bit, and the reference's within the trainers' bound (the chains differ
    in the last bits of the local steps: ``tests/test_torch_trainer.py``)."""
    ref, _, tr, _, test = _trainers(6)
    pred = tr.predictor()
    rpred = ref.predictor()
    assert pred.num_samples() == rpred.num_samples() == len(tr.bank) == 2
    probs, ent = pred.predict({"x": test["x"][:8]})
    _, want = tr.eval_report({f: v[:8] for f, v in test.items()},
                             return_probs=True)
    assert _same(probs, want)
    assert np.all(np.isfinite(ent.numpy()))
    rprobs, _ = rpred.predict({"x": jnp.asarray(test["x"][:8])})
    np.testing.assert_allclose(probs.numpy(), np.asarray(rprobs), atol=1e-4)


def test_trainer_periodic_eval_history():
    _, want, port, got, _ = _trainers(9, eval_every=3, burn_in=4)
    assert [h["round"] for h in got.eval_history] == [3.0, 6.0, 9.0] == \
        [h["round"] for h in want.eval_history]
    assert got.eval_history[-1]["accuracy"] == got.accuracy
    assert got.eval_history[-1]["ece"] == got.ece
    assert set(got.eval_history[0]) == set(want.eval_history[0])
    for g, w in zip(got.eval_history, want.eval_history):
        assert np.isfinite([g["ece"], g["nll"]]).all()
        assert abs(g["accuracy"] - w["accuracy"]) <= 1 / 24 + 1e-6
        assert abs(g["ece"] - w["ece"]) <= 0.01
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=1e-4)
    assert len(got.round_ms) == len(got.wire_history) == 9


def test_trainer_predictor_falls_back_to_the_params_before_burn_in():
    shards = partition_iid(make_dataset(3 * 12, hw=HW, day=1, seed=0), 3,
                           seed=0)
    test = make_dataset(24, hw=HW, day=2, seed=5)
    tr = FedTrainer(get_model(get_arch("lenet-radar").reduced.replace(
        input_hw=HW)), FedConfig(**dict(TRAIN_FED, burn_in=100)), shards,
        minibatch=6, eval_batch_size=8, device="cpu")
    tr.run(rounds=2)
    pred = tr.predictor()
    assert pred.num_samples() == 1
    probs, _ = pred.predict({"x": test["x"][:8]})
    _, want = tr.eval_report({f: v[:8] for f, v in test.items()},
                             return_probs=True)
    assert _same(probs, want)


# -- the serving CLI ---------------------------------------------------------

def test_cli_smoke_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    resps = main(["--trim", "--device", "cpu", "--smoke", "--requests", "12",
                  "--slots", "4", "--entropy-threshold", "1.2"])
    out = capsys.readouterr().out
    assert "SMOKE OK" in out and "recompiles=0" in out
    assert [r.request_id for r in resps] == list(range(12))
    assert all(r.bank_version == 1 and r.probs.shape == (10,) for r in resps)


def test_cli_follows_snapshots_with_a_swap_mid_stream(tmp_path, capsys):
    """Two bank snapshots of a trainer's layout (S, K, ...): the CLI starts
    from the older and swaps in the newer while requests are in flight."""
    from repro_torch import random
    from repro_torch.checkpoint import save_bank
    from repro_torch.launch.serve import main
    model = get_model(get_arch("lenet-radar").reduced)
    p = model.init(random.PRNGKey(3, "cpu"), "cpu")
    bank = tree_map(lambda x: torch.stack([torch.stack([x, x + 0.01])] * 2),
                    p)
    save_bank(str(tmp_path), 10, bank)
    save_bank(str(tmp_path), 20, tree_map(lambda x: x * 1.5, bank))
    resps = main(["--trim", "--device", "cpu", "--smoke", "--requests", "16",
                  "--slots", "4", "--ckpt-dir", str(tmp_path),
                  "--follow-snapshots"])
    out = capsys.readouterr().out
    assert "hot-swap: installed bank_00000020 (version 2" in out
    versions = [r.bank_version for r in resps]
    assert versions[0] == 1 and versions[-1] == 2 and 1 in versions[1:]


def test_cli_polling_without_a_directory_serves_the_synthetic_bank():
    from repro_torch.launch.serve import main
    resps = main(["--trim", "--device", "cpu", "--requests", "6", "--slots",
                  "2", "--poll-s", "0.0001", "--smoke"])
    assert [r.bank_version for r in resps] == [1] * 6


@pytest.mark.parametrize("argv,item", [
    (["--arch", "recurrentgemma-9b"], "A12"), (["--mesh", "2"], "A10"),
    (["--arch", "xlstm-1.3b"], "A12")])
def test_cli_unported_modes_name_their_roadmap_item(argv, item):
    """``--mesh 2`` names A10; the archs that named A12 until it was
    ported decode now, and refuse a mesh naming A10."""
    from repro_torch.launch.serve import main
    if item == "A12":
        argv, item = argv + ["--mesh", "2"], "A10"
    with pytest.raises(NotImplementedError, match=item):
        main(["--trim", "--device", "cpu"] + argv)


def test_cli_bank_matches_the_reference_at_full_width(one_thread):
    """The CLI's synthetic bank (seed 0, 4 inits from the reference's keys)
    at full lenet-radar width: BMA probabilities and entropies on its first
    8 requests against the reference's, recorded by ``tests/torch_golden.py
    serve-bma``, within rtol 1e-5; the argmax exact. (A tolerance, so on
    all threads.)"""
    torch.set_num_threads(one_thread)
    try:
        _check_serve_golden()
    finally:
        torch.set_num_threads(1)


def _check_serve_golden():
    import json
    from repro_torch.data.radar import make_dataset as port_dataset
    from repro_torch.launch.serve import synthetic_bank
    from torch_golden import SERVE_BMA_FILE, SERVE_CONFIG
    golden = np.load(SERVE_BMA_FILE)
    c = json.loads(str(golden["config"]))
    assert c == SERVE_CONFIG
    spec = get_arch(c["arch"])
    cfg = spec.reduced if c["reduced"] else spec.config
    model = get_model(cfg)
    bank = synthetic_bank(model, c["seed"], c["samples"], "cpu")
    ds = port_dataset(c["requests"], hw=cfg.input_hw, seed=c["seed"] + 7)
    probs, ent = post.BankPredictor(model.logits, stacked=bank).predict(
        {"x": ds["x"][:c["maps"]]})
    np.testing.assert_allclose(probs.numpy(), golden["probs"], rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(ent.numpy(), golden["entropy"], rtol=1e-5,
                               atol=0)
    np.testing.assert_array_equal(probs.numpy().argmax(-1),
                                  golden["probs"].argmax(-1))
