"""The port's BMA decode serving (``DecodeEngine``, the serving CLI's decode
mode) against the reference's, on the CPU at smollm-135m's reduced width.

- The reference's decode contracts (``tests/test_serve.py``), held by the
  port: no capture after the warm-up over mixed lengths; a request's tokens
  and entropies independent of what shares its table; a hot swap mid-stream
  keeps completed outputs and changes what follows; a change of the sample
  count is refused; memory flat over swaps.
- Engine parity: the reference's engine and the port's on the same bank
  (4 inits from ``fold_in(PRNGKey(0), i)``) and requests, in float32 and in
  the arch's bfloat16: tokens equal at every step (the reference's top two
  perturbed scores are never within the stated logit tolerance here, 1e-4
  in f32 and 3e-2 in bf16, as ``test_torch_lm_model.py`` states it), token
  entropies within rtol 1e-5 in f32 and 1e-3 in bf16, the last BMA
  distribution within 1e-6 (f32) and 1e-5 (bf16) absolute.
- The serving CLI's decode lines (``--trim``) equal the reference CLI's but
  for the latencies and the serve line's times.
- The full-width record of the reference's run
  (``tests/golden/decode_smollm_135m.json``) is consistent with its config
  and with the serving CLI's requests; the card holds the port to it.

Torch runs on one thread here: the exact contracts compare two runs.
"""
import gc
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JaxServeConfig
from repro.config import get_arch as jax_get_arch
from repro.models import get_model as jax_get_model
from repro.serve import DecodeEngine as JaxDecodeEngine
from repro.serve import ServeRequest as JaxServeRequest
from repro_torch import random
from repro_torch.config import ServeConfig, get_arch
from repro_torch.models import get_model
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve import DecodeEngine, ServeRequest
from repro_torch.utils.tree import tree_map
from torch_golden import DECODE_CONFIG, DECODE_FILE, decode_requests

import torch_threads  # noqa: F401  (one torch thread a process)

ARCH = "smollm-135m"
TOL = {"float32": dict(ent=1e-5, probs=1e-6),
       "bfloat16": dict(ent=1e-3, probs=1e-5)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    """The reduced model in f32 and a bank of 3 samples from the port's
    init (the reference's decode tests' shape)."""
    model = get_model(get_arch(ARCH).reduced.replace(dtype="float32"))
    key = random.PRNGKey(0)
    samples = [model.init(random.fold_in(key, i), "cpu") for i in range(3)]
    return model, tree_map(lambda *xs: torch.stack(xs), *samples)


def test_decode_no_capture_and_the_lengths_it_was_asked(lm):
    model, stacked = lm
    scfg = ServeConfig(slots=4, max_len=16, max_new_tokens=4)
    eng = DecodeEngine(model, scfg, stacked=stacked)
    eng.run([ServeRequest(prompt_token=1, seed=0)])       # warm-up
    c0 = eng.compile_count()
    reqs = [ServeRequest(prompt_token=i + 1, max_new_tokens=2 + (i % 3),
                         seed=i) for i in range(9)]
    resps = eng.run(reqs)
    assert len(resps) == 9 and eng.compile_count() == c0 == 0
    for r, q in zip(resps, reqs):
        assert len(r.tokens) == (q.max_new_tokens or scfg.max_new_tokens)
        assert len(r.token_entropy) == len(r.tokens)
        assert r.probs.shape == (model.cfg.vocab_size,)
    st = eng.stats()
    assert st["served"] == 10.0 and st["steps"] == eng.steps


def test_decode_tokens_independent_of_batch_composition(lm):
    model, stacked = lm
    scfg = ServeConfig(slots=4, max_len=16, max_new_tokens=5)
    batched = DecodeEngine(model, scfg, stacked=stacked).run(
        [ServeRequest(prompt_token=i + 1, seed=10 + i) for i in range(7)])
    target = batched[3]
    solo = DecodeEngine(model, scfg, stacked=stacked).run(
        [ServeRequest(prompt_token=4, seed=13)])[0]
    assert np.array_equal(solo.tokens, target.tokens)
    assert np.array_equal(solo.token_entropy, target.token_entropy)


def test_hot_swap_mid_stream_preserves_completed_outputs(lm):
    model, stacked = lm
    bank2 = tree_map(lambda x: x + 0.05, stacked)
    scfg = ServeConfig(slots=2, max_len=16, max_new_tokens=4)
    reqs = lambda: [ServeRequest(prompt_token=i + 1, seed=i,
                                 max_new_tokens=2 + 2 * (i % 2))
                    for i in range(6)]
    ref = DecodeEngine(model, scfg, stacked=stacked).run(reqs())
    eng = DecodeEngine(model, scfg, stacked=stacked)
    for r in reqs():
        eng.submit(r)
    early = []
    while not early:
        early.extend(eng.step())
    assert sum(r is not None for r in eng.slot_req) > 0
    eng.install_bank(bank2)
    late = eng.drain()
    assert len(early) + len(late) == 6
    by_id = {r.request_id: r for r in ref}
    for r in early:
        assert np.array_equal(r.tokens, by_id[r.request_id].tokens)
        assert r.entropy == by_id[r.request_id].entropy
        assert r.bank_version == 1
    assert all(r.bank_version == 2 for r in late)
    assert any(not np.array_equal(r.tokens, by_id[r.request_id].tokens)
               for r in late)


def test_hot_swap_rejects_sample_count_change(lm):
    model, stacked = lm
    eng = DecodeEngine(model, ServeConfig(slots=2, max_len=16,
                                          max_new_tokens=2), stacked=stacked)
    with pytest.raises(ValueError, match="sample count"):
        eng.install_bank(tree_map(lambda x: x[:-1], stacked))
    with pytest.raises(ValueError, match="layout"):
        eng.install_bank(tree_map(lambda x: x[..., :1], stacked))


def test_swaps_copy_in_place(lm):
    """N swaps: no capture, the resident bank's buffers kept (so no device
    memory grows), each swap's values read by the next request."""
    model, stacked = lm
    eng = DecodeEngine(model, ServeConfig(slots=2, max_len=16,
                                          max_new_tokens=2), stacked=stacked)
    eng.run([ServeRequest(prompt_token=1, seed=0)])
    ptrs = [x.data_ptr() for x in jax.tree_util.tree_leaves(eng._bank)]
    outs = []
    for i in range(4):
        eng.install_bank(tree_map(lambda x: x + 0.01 * (i + 1), stacked))
        outs.append(eng.run([ServeRequest(prompt_token=1, seed=100)])[0])
        gc.collect()
    assert [x.data_ptr() for x in jax.tree_util.tree_leaves(eng._bank)] == ptrs
    assert eng.compile_count() == 0 and eng.bank_version == 5
    assert len({r.entropy for r in outs}) == 4


def test_engine_refuses_what_it_cannot_serve(lm):
    model, stacked = lm
    with pytest.raises(ValueError, match="no decode step"):
        DecodeEngine(get_model(get_arch("lenet-radar").reduced),
                     ServeConfig())
    with pytest.raises(ValueError, match="KV cache length"):
        DecodeEngine(model, ServeConfig(max_len=4, max_new_tokens=8))
    with pytest.raises(NotImplementedError, match="A10"):
        DecodeEngine(model, ServeConfig(ensemble_axis="ens"))
    with pytest.raises(ValueError, match="no bank"):
        DecodeEngine(model, ServeConfig()).step()


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's engine on the CLI's synthetic bank (4 samples) and
    10 of its requests, 3 slots, 6 new tokens, in f32 and bf16."""
    cfg = jax_get_arch(ARCH).reduced
    key = jax.random.PRNGKey(0)
    jm = jax_get_model(cfg)
    bank = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jm.init(jax.random.fold_in(key, i)) for i in range(4)])
    reqs = decode_requests(cfg.vocab_size, 10, 0)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        eng = JaxDecodeEngine(jax_get_model(cfg.replace(dtype=dtype)),
                              JaxServeConfig(slots=3, max_len=16,
                                             max_new_tokens=6), stacked=bank)
        runs[dtype] = eng.run([JaxServeRequest(prompt_token=t, seed=s)
                               for t, s in reqs])
    return bank, reqs, runs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_matches_the_reference_engine(reference_runs, dtype):
    jbank, reqs, runs = reference_runs
    model = get_model(get_arch(ARCH).reduced.replace(dtype=dtype))
    bank = params_from_jax(jax.tree.map(np.asarray, jbank))
    got = DecodeEngine(model, ServeConfig(slots=3, max_len=16,
                                          max_new_tokens=6), stacked=bank) \
        .run([ServeRequest(prompt_token=t, seed=s) for t, s in reqs])
    for g, w in zip(got, runs[dtype]):
        assert g.tokens.tolist() == w.tokens.tolist()
        np.testing.assert_allclose(g.token_entropy, w.token_entropy,
                                   rtol=TOL[dtype]["ent"])
        np.testing.assert_allclose(g.probs, np.asarray(w.probs), rtol=0,
                                   atol=TOL[dtype]["probs"])
        assert g.abstain == w.abstain and g.bank_version == w.bank_version


def _resp_lines(text: str):
    """The CLI's response and serve lines, latencies dropped."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("resp ") or ln.startswith("serve[decode]"):
            out.append(re.sub(r" latency_ms=[0-9.]+", "", ln))
    return out


def test_cli_decode_lines_equal_the_reference_cli(capsys, monkeypatch):
    import sys
    from repro.launch import serve as jax_serve
    from repro_torch.launch.serve import main
    argv = ["--arch", ARCH, "--trim", "--mode", "decode", "--requests", "6",
            "--slots", "4", "--max-new-tokens", "5", "--smoke"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jax_serve.main()
    want = _resp_lines(capsys.readouterr().out)
    resps = main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert _resp_lines(out) == want and len(want) == 5
    assert "SMOKE OK" in out and "recompiles=0" in out
    assert [len(r.tokens) for r in resps] == [5] * 6
    # --mode auto serves an LM arch by decode
    assert len(main(["--arch", ARCH, "--trim", "--device", "cpu",
                     "--requests", "2", "--max-new-tokens", "2"])) == 2


def test_cli_decode_serves_snapshots_of_a_bank(tmp_path, capsys):
    """A trainer's (S, K, ...) snapshots flattened to S·K samples, with a
    swap mid-stream."""
    from repro_torch.checkpoint import save_bank
    from repro_torch.launch.serve import main
    model = get_model(get_arch(ARCH).reduced)
    p = model.init(random.PRNGKey(3), "cpu")
    bank = tree_map(lambda x: torch.stack([torch.stack([x, x + 0.01])] * 2),
                    p)
    save_bank(str(tmp_path), 10, bank)
    save_bank(str(tmp_path), 20, tree_map(lambda x: x * 1.5, bank))
    resps = main(["--arch", ARCH, "--trim", "--device", "cpu", "--requests",
                  "8", "--slots", "2", "--max-new-tokens", "3",
                  "--ckpt-dir", str(tmp_path), "--follow-snapshots",
                  "--smoke"])
    out = capsys.readouterr().out
    assert "samples=4" in out and "bank_00000020 (version 2" in out
    assert resps[0].bank_version == 1 and resps[-1].bank_version == 2


def test_full_width_record_is_the_cli_run():
    """The record's config is the serving CLI's decode defaults; its
    requests are the CLI's; each run holds 16 requests of 16 tokens with a
    margin a step, and no step's margin is within the bf16 tolerance."""
    rec = json.loads(DECODE_FILE.read_text())
    assert rec["config"] == DECODE_CONFIG
    assert decode_requests(49152, 3, 0) == [(1, 0), (2, 1), (3, 2)]
    assert len(rec["leaves"]) == 11
    for dtype, run in rec["runs"].items():
        assert len(run["tokens"]) == 16 and run["argmax_mismatches"] == 0
        assert all(len(t) == 16 for t in run["tokens"])
        assert all(len(m) == 16 for m in run["margins"])
        assert min(min(m) for m in run["margins"]) > 1e-4
        assert len(run["first_step_top"]["idx"]) == 8
