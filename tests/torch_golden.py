"""Known answers of the reference, recorded from JAX on the CPU for the
PyTorch port's tests and for ``chip_smoke.py``, which reads them on the card.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py threefry
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py seeded-rounds
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py baseline-rounds
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py serve-bma
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py topology-rounds
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py transport-rounds
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py bf16-rounds
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py claims-smoke
    PYTHONPATH=src python tests/torch_golden.py claims-port
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py claims-nudged
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py drift
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py drift-claims
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py decode
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py kv-flips
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py lm-rounds
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py f16-rounds
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py lm-families
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py vlm-full
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py moe-full
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py recurrent-families
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py hybrid-full
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py ssm-full
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py audio

``threefry`` writes ``tests/golden/threefry_draws.npz``: ``jax.random``'s
keys, bits, uniforms, normals, truncated normals and randints for the cases
of :data:`THREEFRY_CASES` (each array under its case name, the cases as
JSON under ``cases``). ``tests/test_torch_random.py`` holds the file to what
JAX gives now, so it cannot go stale, and the port to the file
(:func:`port_draw`, which the card tests and ``chip_smoke.py`` run on the
card too). This module imports JAX only inside the writers.

``seeded-rounds`` writes ``tests/golden/seeded_rounds_lenet_radar.json``:
the reference's first two rounds of full-width ``lenet-radar`` (256x63,
K=10, L=8, minibatch 10, compressor ``block_topk`` with fused compression,
seed 0), their mean loss, consensus error and wire bytes a node, beside the
configuration they ran. ``chip_smoke.py`` runs the same configuration on the
card and compares (bytes exact; loss and consensus within rtol 1e-3).

``baseline-rounds`` writes ``tests/golden/baseline_rounds_lenet_radar.json``:
the same record for the paper's default run and its two baselines, the
same configuration at ``FedConfig``'s default ``fused_compress=False``
(the ``lax.top_k``-order ``block_topk`` codec) under ``algorithm`` cdbfl,
dsgld and cffl, one record each under its algorithm's name.

``topology-rounds`` writes ``tests/golden/topology_rounds_lenet_radar.json``:
the same record for three runs off the default configuration
(:data:`TOPOLOGY_RUNS`): ``FedConfig()``'s cdbfl on the ``ring`` (the
roll lowering of ROADMAP C14), and cdbfl and dsgld on the geometric graph
of radius 0.5 with link dropout 0.1 and 2 gossip pairs a round (7
matchings at K=10), each round's realized ``(M, K)`` mask included
(``_matching_masks`` on the round's ``kmix``, as its round draws it);
and, under ``cli``, the ``arch=``, ``wire accounting:`` and ``topology=``
lines the reference's training CLI prints for :data:`TOPOLOGY_CLI_ARGV`
(run with ``--rounds 0``: the lines are functions of shapes and numpy).

``transport-rounds`` writes ``tests/golden/transport_rounds_lenet_radar.json``:
the same record for :data:`TRANSPORT_RUNS`, the runs of ``chip_smoke.py``'s
phase 10 on the geometric graph of the topology runs: (a) ``FedConfig()``'s
cdbfl under Bernoulli erasure 0.1; (b) the fused ``block_topk|qsgd``
pipeline under the Gilbert–Elliott channel with ARQ, LoRa time-on-air and
an airtime budget that cuts the last attempt; (c) cdbfl and dsgld under the
SNR outage model with stragglers and two death timelines. Beside the loss,
consensus and wire bytes, each round's offered, delivered and abandoned
bytes, retransmits, airtime and energy a node, its participation vector
and its ``(M, K)`` mixer masks (the SNR outage composed in); and, under
``cli``, the header and accounting lines the reference's training CLI
prints for :data:`TRANSPORT_CLI_ARGV` over two rounds.

``bf16-rounds`` writes ``tests/golden/bf16_rounds_lenet_radar.json``: the
same record for :data:`BF16_RUNS`, the runs of ``chip_smoke.py``'s phase
11 (b) with ``control_dtype="bfloat16"``: the paper's default cdbfl, the
fused ``block_topk`` (the seeded-rounds configuration) and cffl; with the
control state's ‖v‖₂ and ‖v̄‖₂ after the last round, and under
``f32_control`` the loss, consensus and norms of the same run with
float32 control variates.

``f16-rounds`` writes ``tests/golden/f16_rounds_lenet_radar.json``: the same
runs with ``control_dtype="float16"`` (ROADMAP C32), their ``f32_control``
copied from the bf16 record (the same configurations in f32).

``claims-smoke`` writes ``tests/golden/claims_smoke_lenet_radar.json``: the
reference's ``repro.eval.matrix.run_claims_smoke(CLAIMS_SPEC)`` (reduced
LeNet, 60 rounds of cdbfl and cffl, the clean and days-2/3 critical cells)
on the CPU at its seed 0 and re-seeded to 1 (under ``other_seeds``): its
claims, failures, warnings, each cell's row and each algorithm's per-round
loss, which ``chip_smoke.py`` prints beside the port's run on the card.
``claims-port`` runs the port's slice on the CPU at both seeds and prints
it beside that record, with the first round where each loss departs;
``claims-nudged`` runs the reference's own slice with its training maps
one ulp up, beside the same record: the second witness.

``drift`` writes ``tests/golden/drift_rounds_lenet_radar.json``: the same
record for :data:`DRIFT_CONFIG`, ``chip_smoke.py``'s phase-12 run: the
paper-default cdbfl with a days-2/3 critical drift at full severity in
round 1 only (a piecewise schedule that returns to its base pool), a
2-round bank window and a 0.9 age decay; with each round's scheduled
severity, the bank's admission rounds and age weights, and the aged
evaluation on the day-1 test maps and the days-2/3 shift set; and, under
``cli``, the lines the reference's training CLI prints for the README's
two drift commands at full width (:data:`DRIFT_CLI_RUNS`).

``drift-claims`` writes ``tests/golden/drift_claims_lenet_radar.json``:
the reference's ``run_drift_claims(DRIFT_CLAIMS_SPEC)`` (reduced LeNet,
K=5, 90 rounds of cdbfl and dsgld through a step drift at round 45) with
its probe curves, and ``run_unlearn_oracle(CLAIMS_SPEC)`` (|Δacc|, |ΔECE|
and both reports' accuracy and ECE), which ``chip_smoke.py`` prints beside
the port's run on the card (:func:`drift_claims_record`).

``decode`` writes ``tests/golden/decode_smollm_135m.json``: the reference's
BMA decode at full ``smollm-135m`` width (:data:`DECODE_CONFIG`): the bank
of ``init(fold_in(PRNGKey(seed), i))``, i < samples, with each leaf's
shape, float64 sum, the sum of its f32 bit patterns and its elements at
:func:`leaf_picks`; then ``DecodeEngine`` at 8 slots, ``max_len`` 128, 16
new tokens, over the serving CLI's 16 requests (``prompt_token = 1 + i mod
(V − 1)``, seed ``seed + i``), in ``dtype="float32"`` and in the arch's
bfloat16: per request its tokens, token entropies, the argmax of its last
BMA distribution (the CLI's ``pred``) and, at each step, the margin
between the two highest perturbed scores ``log max(p, 1e-12) + g`` (``g``
the step's ``gumbel(fold_in(key, pos))``); and each slot's top-8 BMA
probabilities at the first step. About 10 minutes on one CPU core.

``kv-flips`` writes nothing: it prints the readings behind the limits of
``tests/test_torch_lm_model.py::
test_teacher_forced_f32_decode_through_bf16_caches`` (reduced qwen2.5, f32
compute, the default bfloat16 caches): the cached entries in which the
port's teacher-forced decode and the reference's differ, by how many
bfloat16 ulps, and how far apart their logits lie; then how far the port's
logits move when one cached entry, drawn at random (200 draws, seed 0,
before the last step), is moved one bfloat16 ulp right after its write.
About 40 seconds.

``lm-rounds`` writes ``tests/golden/lm_rounds_smollm_135m.json``: the
reference's first two rounds of federated smollm-135m at full width in
f32 (:data:`LM_ROUNDS_CONFIG`: the train CLI's defaults, a ring of K
nodes, ``block_topk`` at 1%, ζ = 0.3, η = 1e-4, the CLI's Markov pools,
with the cuts it lists: K = 2, L = 2, minibatch 2, 32 tokens), through
``FedTrainer(engine="host")``: each round's losses, consensus and wire
bytes a node, and after it every leaf of θ and v as ``decode`` records
the bank's, v's survivor count beside it, and each node's NLL of θ on
its pool's first minibatch; the init's θ likewise, with its NLL and the
gradient of the nodes' summed NLL (the |g| largest elements, the sum and
the norm of each leaf); and,
under ``cli``, the header lines the reference's training CLI prints for
:data:`LM_CLI_ARGV` at full width. ``chip_smoke.py``'s phase 14 holds the
card's f32 rounds (a) and the CLI's lines (e) to it.

``serve-bma`` writes ``tests/golden/serve_bma_lenet_radar.npz``: the
reference's BMA probabilities and predictive entropies
(``repro.core.posterior.BankPredictor``) for the serving CLI's synthetic
bank at full ``lenet-radar`` width (:data:`SERVE_CONFIG`: the inits from
``fold_in(PRNGKey(seed), i)``, i < samples) on the first maps of the CLI's
requests (``make_dataset(requests, seed=seed + 7)``), beside the
configuration as JSON under ``config``. A CPU test holds the port to it
within rtol 1e-5, ``chip_smoke.py`` the card within rtol 1e-4.

``recurrent-families``, ``hybrid-full``, ``ssm-full`` and ``audio`` write
the records of ``chip_smoke.py``'s phases 17–19 (ROADMAP A12 parts 5–7):
the reduced rounds and decode of recurrentgemma-9b, xlstm-1.3b and
whisper-tiny (``lm_families_recurrent.json``, as ``lm-families``);
recurrentgemma's one full-width ``(rec, rec, local_attn)`` group in f32,
its init drawn in row blocks (:func:`lean_init`), forward and the
reference engine's run (``hybrid_recurrentgemma_9b.json``; 41 GB peak);
xlstm at full width and depth, its init and forward
(``ssm_xlstm_1_3b.json``); whisper at full width, its init, wire bytes,
NLL on frames, encoder output and the reference engine's run against
zero encoder output (``audio_whisper_tiny.json``, ROADMAP C37).

:func:`boundary_blocks` is not a record of the reference but test data
shared the same way: one-block leaves at the edge of the top_k-order
selection kernel's fast path, which the card tests, ``chip_smoke.py`` and
the CPU tests of its rule hold to the plain version.
"""
from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().parent / "golden"
THREEFRY_FILE = GOLDEN / "threefry_draws.npz"
SEEDED_ROUNDS_FILE = GOLDEN / "seeded_rounds_lenet_radar.json"
BASELINE_ROUNDS_FILE = GOLDEN / "baseline_rounds_lenet_radar.json"
SERVE_BMA_FILE = GOLDEN / "serve_bma_lenet_radar.npz"
TOPOLOGY_ROUNDS_FILE = GOLDEN / "topology_rounds_lenet_radar.json"
TRANSPORT_ROUNDS_FILE = GOLDEN / "transport_rounds_lenet_radar.json"

# (name, function, seed, arguments): one ``jax.random`` call each
THREEFRY_CASES = [
    ("key_0", "PRNGKey", 0, {}),
    ("key_1", "PRNGKey", 1, {}),
    ("key_max", "PRNGKey", 2**31 - 1, {}),
    ("split_10", "split", 42, {"num": 10}),
    ("fold_in_7", "fold_in", 42, {"data": 7}),
    ("fold_in_max", "fold_in", 42, {"data": 2**32 - 1}),
    ("bits_1", "bits", 3, {"shape": [1]}),
    ("bits_7", "bits", 3, {"shape": [7]}),
    ("bits_3x1031", "bits", 4, {"shape": [3, 1031]}),
    ("uniform_7", "uniform", 5, {"shape": [7]}),
    ("uniform_4099", "uniform", 5, {"shape": [4099]}),
    ("uniform_range", "uniform", 6, {"shape": [2, 513], "minval": -3.5,
                                     "maxval": 11.25}),
    ("normal_1", "normal", 7, {"shape": [1]}),
    ("normal_4099", "normal", 7, {"shape": [4099]}),
    ("truncated_normal_4099", "truncated_normal", 8,
     {"lower": -2.0, "upper": 2.0, "shape": [4099]}),
    ("randint_50", "randint", 9, {"shape": [5, 7], "minval": 0,
                                  "maxval": 50}),
    ("randint_empty_span", "randint", 9, {"shape": [6], "minval": 4,
                                          "maxval": 4}),
    # the decode sampler's noise: gumbel in mode "low" at the vocabulary of
    # smollm-135m, and at an edge size
    ("gumbel_7", "gumbel", 10, {"shape": [7]}),
    ("gumbel_49152", "gumbel", 11, {"shape": [49152]}),
]


# the decode kernels' exp (ROADMAP C30): the inputs on which the CPU test
# holds exp_plain to jax.jit(jnp.exp) and the card holds exp_xla to
# exp_plain, both bit for bit
def exp_inputs() -> np.ndarray:
    """10^6 f32 inputs spread over [-104, 89] and the edges of XLA's exp:
    the clamp's ends and their neighbours, 64 inputs each side of
    log(smallest normal), ±0, ±inf, NaN, subnormals and the extremes."""
    x = np.random.default_rng(0).uniform(-104, 89, 1_000_000)
    f32 = np.finfo(np.float32)
    edge = [np.float32(v) for v in (-87.8, 88.8, 88.72, 88.7228, -87.3365)]
    around = [np.float32(np.log(np.float64(f32.tiny)))]
    for v in list(edge) + around[:1]:
        up, down = v, v
        for _ in range(64):
            up, down = np.nextafter(up, np.float32(200)), \
                np.nextafter(down, np.float32(-200))
            around += [up, down]
    edges = np.array(edge + around + [0.0, -0.0, np.inf, -np.inf, np.nan,
                                      1e-45, -1e-45, 1e-40, f32.tiny, 1.0,
                                      -1.0, f32.max, -f32.max],
                     np.float32)
    return np.concatenate([x.astype(np.float32), edges])


# the survivors a block of the selection kernel's fast-path boundary blocks
BOUNDARY_K = 11


def boundary_blocks(rows: int, seed: int = 0):
    """``(name, d, v)`` one-block leaves, ``(rows, 1024)`` f32 each, at the
    edge of the selection kernel's fast path at k = ``BOUNDARY_K``
    (``topk_candidates_plain``): exactly 32 and exactly 33 candidates (11
    lane maxima 10 + l and 21 or 22 more keys of 10 to 15.25 in one lane,
    signs alternating, ties at 15 included), the 20 largest keys all in one
    lane, every element 0.75, every element 0; elsewhere keys below 0.5.
    Lanes rotate by 3 a row. ``v`` lies on a grid of 1/4, so ``(d + v) − v``
    is ``d`` on every key that reaches the candidates."""
    rng = np.random.default_rng(seed)
    at = lambda j, lane: 32 * (j % 32) + lane % 32        # noqa: E731

    def small():
        return (rng.random((rows, 1024), dtype=np.float32)
                - np.float32(0.5)).astype(np.float32)

    def candidates(count):
        d = small()
        for r in range(rows):
            lanes = [(l + 3 * r) % 32 for l in range(11)]
            for l, lane in enumerate(lanes):
                d[r, at(l + r, lane)] = 10.0 + l
            js = [j for j in range(32) if j != (10 + r) % 32]
            for i in range(count - 11):
                d[r, at(js[i], lanes[10])] = (10.0 + 0.25 * i) * (-1) ** i
        return d

    one_lane = small()
    for r in range(rows):
        for j in range(20):
            one_lane[r, at(j, 7 + 3 * r)] = (50.0 + j) * (-1) ** j
    v = rng.integers(-8, 9, (rows, 1024)).astype(np.float32) / 4
    return [(name, d, v) for name, d in (
        ("32 candidates", candidates(32)), ("33 candidates", candidates(33)),
        ("20 largest in one lane", one_lane),
        ("all equal", np.full((rows, 1024), 0.75, np.float32)),
        ("all zero", np.zeros((rows, 1024), np.float32)))]


def jax_draw(fn: str, seed: int, args: dict) -> np.ndarray:
    """One case from ``jax.random``, as numpy (keys as int64)."""
    import jax
    key = jax.random.PRNGKey(seed)
    if fn == "PRNGKey":
        out = key
    elif fn in ("split", "fold_in"):
        out = getattr(jax.random, fn)(key, *args.values())
    elif fn == "truncated_normal":
        out = jax.random.truncated_normal(key, args["lower"], args["upper"],
                                          tuple(args["shape"]))
    else:
        out = getattr(jax.random, fn)(key, tuple(args["shape"]), **{
            k: v for k, v in args.items() if k != "shape"})
    out = np.asarray(out)
    return out.astype(np.int64) if out.dtype == np.uint32 else out


def port_draw(fn: str, seed: int, args: dict, device="cpu"):
    """One case through ``repro_torch.random``, on ``device``."""
    from repro_torch import random
    key = random.PRNGKey(seed, device)
    if fn == "PRNGKey":
        return key
    if fn in ("split", "fold_in"):
        return getattr(random, fn)(key, *args.values())
    if fn == "truncated_normal":
        return random.truncated_normal(key, args["lower"], args["upper"],
                                       args["shape"])
    return getattr(random, fn)(key, args["shape"], **{
        k: v for k, v in args.items() if k != "shape"})


def threefry_golden() -> dict:
    arrays = {name: jax_draw(fn, seed, args)
              for name, fn, seed, args in THREEFRY_CASES}
    arrays["cases"] = np.array(json.dumps(THREEFRY_CASES))
    return arrays


def write_threefry() -> None:
    np.savez_compressed(THREEFRY_FILE, **threefry_golden())
    print(f"wrote {THREEFRY_FILE}")


# chip_smoke.py's block_topk configuration (its K, L, MINIBATCH, BURN_IN,
# RATIO, BLOCK, LEVELS and fed_config), which it checks against this record
SEEDED_CONFIG = dict(
    arch="lenet-radar", reduced=False, train_maps=500, data_seed=0,
    minibatch=10, seed=0, rounds=2,
    fed=dict(num_nodes=10, local_steps=8, eta=1e-4, zeta=0.03,
             temperature=1.0, burn_in=2, compress_ratio=0.01,
             block_size=1024, qsgd_levels=16, topology="full",
             compressor="block_topk", fused_compress=True))


# chip_smoke.py's paper-default runs: SEEDED_CONFIG unfused, one an algorithm
BASELINE_ALGORITHMS = ("cdbfl", "dsgld", "cffl")


def baseline_config(algorithm: str) -> dict:
    return dict(SEEDED_CONFIG, fed=dict(SEEDED_CONFIG["fed"],
                                        fused_compress=False,
                                        algorithm=algorithm))


# the geometric graph of the topology runs: 7 matchings at K=10, 2 a round
GEOMETRIC_TV = dict(graph="geometric", radius=0.5, link_failure_prob=0.1,
                    gossip_pairs=2)
# chip_smoke.py's phase-9 runs: the paper-default configuration on another
# graph (``topology`` or a TopologyConfig's fields), one an algorithm
TOPOLOGY_RUNS = {
    "cdbfl-ring": dict(baseline_config("cdbfl"),
                       fed=dict(baseline_config("cdbfl")["fed"],
                                topology="ring")),
    "cdbfl-geometric-tv": dict(baseline_config("cdbfl"),
                               topology_cfg=GEOMETRIC_TV),
    "dsgld-geometric-tv": dict(baseline_config("dsgld"),
                               topology_cfg=GEOMETRIC_TV),
}


# chip_smoke.py's phase-9 CLI run (it adds --rounds 4 and --ckpt-dir)
TOPOLOGY_CLI_ARGV = [
    "--arch", "lenet-radar", "--nodes", "10", "--local-steps", "8",
    "--batch", "10", "--zeta", "0.03", "--topology", "geometric",
    "--radius", "0.5", "--link-failure", "0.1", "--gossip-pairs", "2",
    "--fused-compress", "--layer-pipelines",
    "fc1=block_topk|qsgd;*=block_topk", "--bank-capacity", "2",
    "--burn-in", "2", "--eval-every", "2"]
CLI_HEADS = ("arch=", "wire accounting:", "topology=")


def reference_cli_lines(argv) -> list:
    """The header lines (:data:`CLI_HEADS`) the reference's training CLI
    prints for ``argv``, run in-process with ``--rounds 0``."""
    import contextlib
    import io
    from repro.launch import train
    out, saved = io.StringIO(), sys.argv
    sys.argv = ["train"] + list(argv) + ["--rounds", "0"]
    try:
        with contextlib.redirect_stdout(out):
            train.main()
    finally:
        sys.argv = saved
    return [ln for ln in out.getvalue().splitlines()
            if ln.startswith(CLI_HEADS)]


# chip_smoke.py's phase-10 runs: the topology runs' geometric graph under
# the transport and the participation model
PIPE_CONFIG = dict(SEEDED_CONFIG, fed=dict(SEEDED_CONFIG["fed"],
                                           pipeline="block_topk|qsgd"))
TRANSPORT_RUNS = {
    "cdbfl-bernoulli": dict(baseline_config("cdbfl"),
                            topology_cfg=GEOMETRIC_TV,
                            transport=dict(erasure=0.1, mtu=256)),
    # 346 frames a node, 135.7 s of SF7 time-on-air a first attempt: a
    # budget of 165 s lets most nodes resend and cuts the last attempt
    "fused-gilbert-arq": dict(PIPE_CONFIG, topology_cfg=GEOMETRIC_TV,
                              transport=dict(loss_model="gilbert", arq=True,
                                             max_retries=2, toa=True, sf=7,
                                             duty_cycle=0.5,
                                             round_period_s=330.0)),
    "cdbfl-snr-participation": dict(
        baseline_config("cdbfl"), topology_cfg=GEOMETRIC_TV,
        transport=dict(snr_db=10.0, snr_spread_db=4.0),
        participation=dict(straggler_prob=0.2, dead=[[3, 2, -1], [7, 1, 3]])),
    "dsgld-snr-participation": dict(
        baseline_config("dsgld"), topology_cfg=GEOMETRIC_TV,
        transport=dict(snr_db=10.0, snr_spread_db=4.0),
        participation=dict(straggler_prob=0.2, dead=[[3, 2, -1], [7, 1, 3]])),
}
# chip_smoke.py's phase-10 CLI run: phase 9's graph with the transport's
# and the participation model's flags, two rounds
TRANSPORT_CLI_ARGV = [
    "--arch", "lenet-radar", "--nodes", "10", "--local-steps", "8",
    "--batch", "10", "--zeta", "0.03", "--topology", "geometric",
    "--radius", "0.5", "--link-failure", "0.1", "--gossip-pairs", "2",
    "--transport", "--erasure", "0.1", "--arq", "--toa",
    "--straggler-prob", "0.2", "--dead-node", "3:2", "--rounds", "2",
    "--log-every", "2"]
TRANSPORT_CLI_LINES = ("arch=", "wire accounting:", "topology=",
                       "transport:", "airtime budget:", "participation:",
                       "transport accounting:", "arq accounting:",
                       "participation rates:")


def transport_configs(c: dict):
    """The reference's TransportConfig and ParticipationConfig of a run
    (None where the run has none)."""
    from repro.config import ParticipationConfig, TransportConfig
    t, p = c.get("transport"), c.get("participation")
    return (TransportConfig(**t) if t else None,
            ParticipationConfig(**dict(p, dead=tuple(
                tuple(d) for d in p.get("dead", ())))) if p else None)


def reference_cli_run(argv, heads=TRANSPORT_CLI_LINES) -> list:
    """The lines starting with one of ``heads`` that the reference's
    training CLI prints for ``argv``, run in-process."""
    import contextlib
    import io
    from repro.launch import train
    out, saved = io.StringIO(), sys.argv
    sys.argv = ["train"] + list(argv)
    try:
        with contextlib.redirect_stdout(out):
            train.main()
    finally:
        sys.argv = saved
    return [ln for ln in out.getvalue().splitlines()
            if ln.startswith(heads)]


def round_masks(fed, omega, key, rounds: int):
    """The ``(M, K)`` masks the reference's time-varying mixer draws in the
    first ``rounds`` rounds of a host-engine run whose key is ``key``: round
    key ``kround`` from ``key, kround = split(key)``, ``kmix`` as the round
    derives it (``fold_in(kround, 2)``; DSGLD's ``split(kround)[1]``).
    ``tests/test_torch_gossip.py`` holds this derivation to the masks the
    reference's jitted rounds apply
    (``test_recorded_masks_are_the_masks_the_rounds_apply``)."""
    import jax
    from repro.core.gossip import _matching_masks, _tv_probs, plan_mixer
    from repro.core.topology import resolve_topology
    from repro.core.transport import resolve_transport
    tc = resolve_topology(fed)
    transport = resolve_transport(fed)
    link = (transport.outage_probs if transport is not None
            and transport.has_link_outage else None)
    mode, sched = plan_mixer(omega, tc, force_tv=link is not None)
    if mode != "schedule_tv":
        return None
    p_drop = _tv_probs(sched, tc, link)
    out = []
    for _ in range(rounds):
        key, kround = jax.random.split(key)
        kmix = (jax.random.split(kround)[1] if fed.algorithm == "dsgld"
                else jax.random.fold_in(kround, 2))
        out.append(np.asarray(_matching_masks(
            sched, kmix, p_drop, tc.gossip_pairs)).tolist())
    return out


def control_norms(state) -> dict:
    """‖v‖₂ and ‖v̄‖₂ of a ``FedState`` (the reference's or the port's), over
    every node and leaf, summed in float64 from the stored values."""
    def norm(tree):
        leaves = tree.values() if isinstance(tree, dict) else tree
        total = 0.0
        for x in leaves:
            if isinstance(x, dict):
                total += norm(x) ** 2
                continue
            if hasattr(x, "detach"):        # a torch tensor
                x = x.detach().cpu().double().numpy()
            x = np.asarray(x, np.float64)
            total += float(np.dot(x.ravel(), x.ravel()))
        return total ** 0.5
    return {"v_norm": norm(state.v), "v_bar_norm": norm(state.v_bar)}


def continual_config(c: dict, config_cls):
    """``c``'s continual block as ``config_cls`` (the reference's or the
    port's ``ContinualConfig``), or None."""
    cont = c.get("continual")
    if not cont:
        return None
    return config_cls(**dict(cont, breakpoints=tuple(
        tuple(b) for b in cont.get("breakpoints", ()))))


def shift_maps(make_dataset, critical_subset, hw) -> dict:
    """The days-2/3 safety-critical shift set (examples/radar_hrc.py:43-49)
    from either package's radar module."""
    parts = [critical_subset(make_dataset(250, hw=hw, day=d, seed=90 + d))
             for d in (2, 3)]
    return {k: np.concatenate([p[k] for p in parts]) for k in ("x", "y")}


def seeded_rounds(c: dict, command: str, norms: bool = False) -> dict:
    """The reference's host-engine run of configuration ``c``; with
    ``norms``, the control state's :func:`control_norms` after it; with a
    ``continual`` block, each round's scheduled severity, the bank's
    admission rounds and age weights, and the aged evaluation on the
    day-1 test maps and the shift set after it."""
    import jax
    from repro.config import (ContinualConfig, FedConfig, TopologyConfig,
                              get_arch)
    from repro.data.partition import partition_iid
    from repro.data.radar import make_dataset
    from repro.models import get_model
    from repro.train import FedTrainer
    arch = get_arch(c["arch"])
    cfg = arch.reduced if c["reduced"] else arch.config
    tc = c.get("topology_cfg")
    tcfg, pcfg = transport_configs(c)
    fed = FedConfig(rounds=c["rounds"], **c["fed"], **(
        {"topology_cfg": TopologyConfig(**tc)} if tc else {}),
        transport=tcfg, participation=pcfg)
    train = make_dataset(c["train_maps"], hw=cfg.input_hw, day=1,
                         seed=c["data_seed"])
    t0 = time.time()
    cont = continual_config(c, ContinualConfig)
    trainer = FedTrainer(get_model(cfg), fed,
                         partition_iid(train, fed.num_nodes),
                         minibatch=c["minibatch"], seed=c["seed"],
                         engine="host", bank_thin=c.get("bank_thin", 2),
                         continual=cont)
    res = trainer.run(rounds=c["rounds"])
    record = {
        "command": "JAX_PLATFORMS=cpu PYTHONPATH=src python "
                   f"tests/torch_golden.py {command}",
        "reference": "repro.train.FedTrainer(engine='host') on the CPU",
        "config": c,
        "loss": [float(x) for x in res.loss_history],
        "consensus": [float(x) for x in res.consensus_history],
        "wire_bytes": [float(x) for x in res.wire_history],
        "seconds": time.time() - t0,
    }
    if norms:
        record.update(control_norms(trainer.state))
    if cont is not None:
        from repro.data.radar import critical_subset
        sched = trainer._refresher.schedule
        record["severity"] = [float(sched.severity_at(t))
                              for t in range(c["rounds"])]
        record["bank_rounds"] = [int(r) for r in trainer._bank_state.rounds]
        record["weights"] = np.asarray(trainer._bank_weights(
            trainer._stacked_bank()), np.float64).tolist()
        for name, data in (
                ("day1", make_dataset(200, hw=cfg.input_hw, day=1, seed=99)),
                ("shift", shift_maps(make_dataset, critical_subset,
                                     cfg.input_hw))):
            rep = trainer.eval_report(data)
            record[f"eval_{name}"] = {"accuracy": float(rep.accuracy),
                                      "ece": float(rep.ece),
                                      "count": float(rep.count)}
    if tc or c["fed"].get("topology", "full") != "full":
        record["masks"] = round_masks(fed, trainer.omega,
                                      jax.random.PRNGKey(c["seed"] + 1),
                                      c["rounds"])
    if tcfg is not None or pcfg is not None:
        eng = trainer._engine
        for name, attr in TRANSPORT_COLUMNS.items():
            record[name] = [np.asarray(x, np.float64).tolist()
                            for x in getattr(eng, attr)]
    return record


# the transport's and the participation model's per-round columns of a
# record, and the reference engine's history each is read from
TRANSPORT_COLUMNS = {
    "offered": "last_offered_history", "delivered": "last_delivered_history",
    "abandoned": "last_abandoned_history",
    "retransmits": "last_retransmit_history",
    "airtime": "last_airtime_history", "energy": "last_energy_history",
    "participation": "last_participation_history"}


def write_seeded_rounds() -> None:
    record = seeded_rounds(SEEDED_CONFIG, "seeded-rounds")
    SEEDED_ROUNDS_FILE.write_text(json.dumps(record, indent=1) + "\n")
    print(f"wrote {SEEDED_ROUNDS_FILE}: {record}")


def write_baseline_rounds() -> None:
    records = {alg: seeded_rounds(baseline_config(alg), "baseline-rounds")
               for alg in BASELINE_ALGORITHMS}
    BASELINE_ROUNDS_FILE.write_text(json.dumps(records, indent=1) + "\n")
    print(f"wrote {BASELINE_ROUNDS_FILE}: {records}")


def write_topology_rounds() -> None:
    records = {name: seeded_rounds(c, "topology-rounds")
               for name, c in TOPOLOGY_RUNS.items()}
    records["cli"] = {"argv": TOPOLOGY_CLI_ARGV,
                      "lines": reference_cli_lines(TOPOLOGY_CLI_ARGV)}
    TOPOLOGY_ROUNDS_FILE.write_text(json.dumps(records, indent=1) + "\n")
    print(f"wrote {TOPOLOGY_ROUNDS_FILE}: "
          f"{ {n: (r['loss'], r['wire_bytes']) for n, r in records.items() if n != 'cli'} }; "
          f"{records['cli']['lines']}")


def write_transport_rounds() -> None:
    records = {name: seeded_rounds(c, "transport-rounds")
               for name, c in TRANSPORT_RUNS.items()}
    records["cli"] = {"argv": TRANSPORT_CLI_ARGV,
                      "lines": reference_cli_run(TRANSPORT_CLI_ARGV)}
    TRANSPORT_ROUNDS_FILE.write_text(json.dumps(records, indent=1) + "\n")
    print(f"wrote {TRANSPORT_ROUNDS_FILE}: "
          f"{ {n: (r['loss'], r['delivered']) for n, r in records.items() if n != 'cli'} }; "
          f"{records['cli']['lines']}")


# chip_smoke.py's phase-11 runs: the paper-default cdbfl, the fused
# block_topk and cffl, each with bfloat16 control variates
BF16_ROUNDS_FILE = GOLDEN / "bf16_rounds_lenet_radar.json"
BF16_RUNS = {
    "cdbfl": dict(baseline_config("cdbfl"), fed=dict(
        baseline_config("cdbfl")["fed"], control_dtype="bfloat16")),
    "fused": dict(SEEDED_CONFIG, fed=dict(SEEDED_CONFIG["fed"],
                                          control_dtype="bfloat16")),
    "cffl": dict(baseline_config("cffl"), fed=dict(
        baseline_config("cffl")["fed"], control_dtype="bfloat16")),
}


def write_bf16_rounds() -> None:
    """Each bf16 run with its control norms, and under ``f32_control`` the
    same run with float32 control variates: what a run that lost the bf16
    rounding would read."""
    records = {}
    for name, c in BF16_RUNS.items():
        records[name] = seeded_rounds(c, "bf16-rounds", norms=True)
        f32 = seeded_rounds(dict(c, fed=dict(c["fed"],
                                             control_dtype="float32")),
                            "bf16-rounds", norms=True)
        records[name]["f32_control"] = {
            k: f32[k] for k in ("loss", "consensus", "v_norm", "v_bar_norm")}
    BF16_ROUNDS_FILE.write_text(json.dumps(records, indent=1) + "\n")
    print(f"wrote {BF16_ROUNDS_FILE}: "
          f"{ {n: (r['loss'], r['wire_bytes']) for n, r in records.items()} }")


# chip_smoke.py's phase-11 (b) runs again with float16 control variates
# (ROADMAP C32); their float32 controls are the bf16 runs' (the same
# configurations but for the control dtype)
F16_ROUNDS_FILE = GOLDEN / "f16_rounds_lenet_radar.json"


def write_f16_rounds() -> None:
    bf16 = json.loads(BF16_ROUNDS_FILE.read_text())
    records = {}
    for name, c in BF16_RUNS.items():
        c = dict(c, fed=dict(c["fed"], control_dtype="float16"))
        records[name] = seeded_rounds(c, "f16-rounds", norms=True)
        records[name]["f32_control"] = bf16[name]["f32_control"]
    F16_ROUNDS_FILE.write_text(json.dumps(records, indent=1) + "\n")
    print(f"wrote {F16_ROUNDS_FILE}: "
          f"{ {n: (r['loss'], r['wire_bytes']) for n, r in records.items()} }")


# chip_smoke.py's phase-12 run: the paper-default cdbfl (phase 7's) under a
# days-2/3 critical drift that comes in round 1 and goes in round 2, the
# bank aged by a 2-round window and a 0.9 decay, bank thin 1
DRIFT_ROUNDS_FILE = GOLDEN / "drift_rounds_lenet_radar.json"
DRIFT_CONTINUAL = dict(scenario="day23_critical", schedule="piecewise",
                       breakpoints=[[1, 1.0], [2, 0.0]], refresh_every=1,
                       window=2, decay=0.9)
DRIFT_CONFIG = dict(baseline_config("cdbfl"), rounds=4, bank_thin=1,
                    fed=dict(baseline_config("cdbfl")["fed"], burn_in=1),
                    continual=DRIFT_CONTINUAL)
# the README's two drift commands at full width on 10 nodes, cut to 4
# rounds with their onset, period, refresh and window scaled so the drift
# fires inside them, and an eval every 2 rounds
DRIFT_CLI_RUNS = {
    "step": ["--arch", "lenet-radar", "--nodes", "10", "--rounds", "4",
             "--bank-capacity", "16", "--drift", "day23_critical",
             "--drift-severity", "1.0", "--drift-onset", "2",
             "--refresh-every", "2", "--refresh-window", "3",
             "--refresh-decay", "0.9", "--eval-every", "2",
             "--eval-scenario", "day23_critical", "--eval-severity", "1.0",
             "--log-every", "2"],
    "cyclic": ["--arch", "lenet-radar", "--nodes", "10", "--rounds", "4",
               "--bank-capacity", "16", "--drift", "gain_drift",
               "--drift-kind", "cyclic", "--drift-period", "4",
               "--drift-severity", "0.8", "--drift-onset", "1",
               "--refresh-every", "1", "--refresh-window", "12",
               "--eval-every", "2", "--log-every", "2"],
}
DRIFT_CLI_LINES = CLI_HEADS + ("drift:", "posterior bank:", "eval  round")


def write_drift_rounds() -> None:
    record = seeded_rounds(DRIFT_CONFIG, "drift")
    record["cli"] = {name: {"argv": argv,
                            "lines": reference_cli_run(argv, DRIFT_CLI_LINES)}
                     for name, argv in DRIFT_CLI_RUNS.items()}
    DRIFT_ROUNDS_FILE.write_text(json.dumps(record, indent=1) + "\n")
    print(f"wrote {DRIFT_ROUNDS_FILE}: loss {record['loss']}, severity "
          f"{record['severity']}, {record['eval_day1']}; "
          f"{ {n: r['lines'] for n, r in record['cli'].items()} }")


DRIFT_CLAIMS_FILE = GOLDEN / "drift_claims_lenet_radar.json"


def _floats(x):
    """``x`` with numpy scalars as Python floats (JSON)."""
    if isinstance(x, dict):
        return {k: _floats(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_floats(v) for v in x]
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


def drift_claims_record(matrix, **kw) -> dict:
    """``matrix.run_drift_claims(DRIFT_CLAIMS_SPEC)`` and
    ``matrix.run_unlearn_oracle(CLAIMS_SPEC)`` (the reference's or the
    port's ``eval.matrix``; ``kw`` goes to both calls): the claims,
    failures and probe curves, and the oracle's deltas and reports."""
    t0 = time.time()
    drift = matrix.run_drift_claims(matrix.DRIFT_CLAIMS_SPEC, log=None, **kw)
    t1 = time.time()
    un = matrix.run_unlearn_oracle(matrix.CLAIMS_SPEC, log=None, **kw)
    t2 = time.time()
    report = lambda r: {"accuracy": float(r.accuracy),      # noqa: E731
                        "ece": float(r.ece)}
    return _floats({
        "claims": drift["claims"], "failures": drift["failures"],
        "curves": drift["curves"], "drift_seconds": t1 - t0,
        "unlearn": {"target": un["target"],
                    "delta_accuracy": un["delta_accuracy"],
                    "delta_ece": un["delta_ece"],
                    "within_tolerance": un["within_tolerance"],
                    "unlearn": report(un["unlearn"]),
                    "oracle": report(un["oracle"])},
        "unlearn_seconds": t2 - t1,
    })


def write_drift_claims() -> None:
    import repro.eval.matrix as matrix
    record = {
        "command": "JAX_PLATFORMS=cpu PYTHONPATH=src python "
                   "tests/torch_golden.py drift-claims",
        "reference": "repro.eval.matrix.run_drift_claims("
                     "DRIFT_CLAIMS_SPEC) and run_unlearn_oracle(CLAIMS_SPEC)"
                     " on the CPU",
        **drift_claims_record(matrix),
    }
    DRIFT_CLAIMS_FILE.write_text(json.dumps(record, indent=1) + "\n")
    print(f"wrote {DRIFT_CLAIMS_FILE}: {record['claims']}, failures "
          f"{record['failures']}, unlearn {record['unlearn']}")


CLAIMS_FILE = GOLDEN / "claims_smoke_lenet_radar.json"
# CLAIMS_SPEC's own seed, then a second witness: the same slice re-seeded
CLAIMS_SEEDS = (0, 1)


def claims_record(matrix, trainer_cls, seed: int, **kw) -> dict:
    """``matrix.run_claims_smoke(CLAIMS_SPEC re-seeded to seed)`` (the
    reference's or the port's ``eval.matrix``; ``kw`` goes to the call):
    its claims, failures, warnings, each cell's row and each algorithm's
    per-round mean loss, kept by wrapping ``trainer_cls.run``."""
    import dataclasses
    losses = {}
    run = trainer_cls.run

    def recording_run(self, *args, **kwargs):
        res = run(self, *args, **kwargs)
        losses[self.fed_cfg.algorithm] = [float(x) for x in res.loss_history]
        return res

    trainer_cls.run = recording_run
    try:
        t0 = time.time()
        out = matrix.run_claims_smoke(
            dataclasses.replace(matrix.CLAIMS_SPEC, seed=seed), log=None,
            **kw)
    finally:
        trainer_cls.run = run
    return {
        "claims": {k: (float(v) if not isinstance(v, str) else v)
                   for k, v in out["claims"].items()},
        "failures": out["failures"], "warnings": out["warnings"],
        "cells": [{k: (float(v) if not isinstance(v, str) else v)
                   for k, v in c.row().items()} for c in out["cells"]],
        "loss_history": losses,
        "seconds": time.time() - t0,
    }


def claims_departure(got: list, want: list) -> dict:
    """The first round (1-based; None if none) where the per-round mean
    loss ``got`` leaves ``want`` at all, and beyond rtol 1e-6 and 1e-3."""
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    return {f"first_{name}": next((i + 1 for i, r in enumerate(rel)
                                   if r > tol), None)
            for name, tol in (("bit", 0.0), ("1e-6", 1e-6),
                              ("1e-3", 1e-3))}


def write_claims_smoke() -> None:
    import repro.eval.matrix as matrix
    from repro.train import FedTrainer
    seeds = {seed: claims_record(matrix, FedTrainer, seed)
             for seed in CLAIMS_SEEDS}
    record = {
        "command": "JAX_PLATFORMS=cpu PYTHONPATH=src python "
                   "tests/torch_golden.py claims-smoke",
        "reference": "repro.eval.matrix.run_claims_smoke(CLAIMS_SPEC) on "
                     "the CPU",
        **seeds[CLAIMS_SEEDS[0]],
        "other_seeds": {str(s): seeds[s] for s in CLAIMS_SEEDS[1:]},
    }
    CLAIMS_FILE.write_text(json.dumps(record, indent=1) + "\n")
    print(f"wrote {CLAIMS_FILE}: "
          f"{ {s: r['claims'] for s, r in seeds.items()} }")


def claims_golden(seed: int) -> dict:
    """The reference's record of the claims slice at ``seed``."""
    want = json.loads(CLAIMS_FILE.read_text())
    return want if seed == CLAIMS_SEEDS[0] else want["other_seeds"][str(seed)]


def compare_claims_port() -> None:
    """The port's claims slice on the CPU at every recorded seed, beside
    the reference's record: each cell's accuracy and ECE, the claims, and
    where each algorithm's per-round loss first leaves the reference's.
    Runs without JAX."""
    import repro_torch.eval.matrix as matrix
    from repro_torch.train import FedTrainer
    for seed in CLAIMS_SEEDS:
        want = claims_golden(seed)
        got = claims_record(matrix, FedTrainer, seed, device="cpu")
        print(f"seed {seed}: port on the CPU {got['seconds']:.1f} s; "
              f"failures {got['failures']} (reference {want['failures']}); "
              f"warnings {len(got['warnings'])} (reference "
              f"{len(want['warnings'])})")
        for g, w in zip(got["cells"], want["cells"]):
            print(f"  {g['algorithm']} {g['scenario']}@{g['severity']}: "
                  f"accuracy {g['accuracy']!r} (reference "
                  f"{w['accuracy']!r}), ECE {g['ece']!r} (reference "
                  f"{w['ece']!r})")
        for alg, hist in got["loss_history"].items():
            print(f"  {alg} loss by round: "
                  f"{claims_departure(hist, want['loss_history'][alg])}; "
                  f"round 60 {hist[-1]!r} (reference "
                  f"{want['loss_history'][alg][-1]!r})")


def compare_claims_nudged() -> None:
    """The reference's claims slice at every recorded seed with its training
    maps nudged by one ulp (every element of ``x`` to the next float32 up),
    beside its own record: how far a last-bit difference in the local steps,
    the kind the port's convolutions make, carries over 60 rounds."""
    import repro.eval.matrix as matrix
    from repro.train import FedTrainer
    make_dataset = matrix.make_dataset

    def nudged(*args, **kwargs):
        ds = dict(make_dataset(*args, **kwargs))
        ds["x"] = np.nextafter(ds["x"], np.float32(np.inf))
        return ds

    matrix.make_dataset = nudged
    try:
        for seed in CLAIMS_SEEDS:
            want = claims_golden(seed)
            got = claims_record(matrix, FedTrainer, seed)
            for g, w in zip(got["cells"], want["cells"]):
                print(f"seed {seed} {g['algorithm']} {g['scenario']}@"
                      f"{g['severity']}: nudged accuracy {g['accuracy']!r} "
                      f"(recorded {w['accuracy']!r}), ECE {g['ece']!r} "
                      f"(recorded {w['ece']!r})")
            for alg, hist in got["loss_history"].items():
                print(f"seed {seed} {alg} loss by round: "
                      f"{claims_departure(hist, want['loss_history'][alg])}")
    finally:
        matrix.make_dataset = make_dataset


# the serving CLI's synthetic bank and requests (launch/serve.py defaults)
SERVE_CONFIG = dict(arch="lenet-radar", reduced=False, seed=0, samples=4,
                    requests=32, maps=8)


def write_serve_bma() -> None:
    import jax
    import jax.numpy as jnp
    from repro.config import get_arch
    from repro.core.posterior import BankPredictor
    from repro.data.radar import make_dataset
    from repro.models import get_model
    c = SERVE_CONFIG
    arch = get_arch(c["arch"])
    cfg = arch.reduced if c["reduced"] else arch.config
    model = get_model(cfg)
    key = jax.random.PRNGKey(c["seed"])
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        model.init(jax.random.fold_in(key, i)) for i in range(c["samples"])])
    ds = make_dataset(c["requests"], hw=cfg.input_hw, seed=c["seed"] + 7)
    probs, ent = BankPredictor(lambda p, b: model.logits(p, b),
                               stacked=stacked).predict(
        {"x": jnp.asarray(ds["x"][:c["maps"]])})
    np.savez_compressed(SERVE_BMA_FILE, probs=np.asarray(probs, np.float32),
                        entropy=np.asarray(ent, np.float32),
                        config=np.array(json.dumps(c)))
    print(f"wrote {SERVE_BMA_FILE}: argmax "
          f"{np.asarray(probs).argmax(-1).tolist()}")

# chip_smoke's phase 13: the serving CLI's decode defaults at full width
DECODE_FILE = GOLDEN / "decode_smollm_135m.json"
DECODE_CONFIG = dict(arch="smollm-135m", seed=0, samples=4, slots=8,
                     max_len=128, max_new_tokens=16, requests=16, top=8,
                     dtypes=["float32", "bfloat16"])


def leaf_picks(n: int) -> list:
    """The flat indices of a leaf of ``n`` elements whose values the decode
    record keeps: both ends and five points between."""
    return sorted(i for i in {0, n // 7, n // 3, n // 2, (5 * n) // 7,
                              n - 2, n - 1} if 0 <= i < n)


def decode_requests(vocab: int, requests: int, seed: int) -> list:
    """The serving CLI's decode requests: ``(prompt_token, seed)``."""
    return [(1 + (i % max(vocab - 1, 1)), seed + i) for i in range(requests)]


def leaf_record(a: np.ndarray) -> dict:
    flat = np.ascontiguousarray(a, np.float32).reshape(-1)
    idx = leaf_picks(flat.size)
    return {"shape": list(a.shape), "sum": float(flat.astype(np.float64).sum()),
            "bits_sum": int(flat.view(np.uint32).astype(np.int64).sum()),
            "idx": idx, "values": [float(flat[i]) for i in idx]}


def reference_decode(model, stacked, c: dict) -> dict:
    """The reference DecodeEngine's run of :func:`decode_requests` on the
    bank ``stacked`` (``c``: slots, max_len, max_new_tokens, requests, seed,
    top): each request's tokens, token entropies, mean entropy and argmax,
    the top-two margin of the perturbed scores at each of its steps (a
    token is held to the record only above a margin) recomputed from the
    step's BMA probabilities and the lane's Gumbel draw, and the first
    step's top ``top`` probabilities of each slot."""
    import jax
    import jax.numpy as jnp
    from repro.config import ServeConfig
    from repro.serve import DecodeEngine, ServeRequest
    scores = jax.jit(lambda p, g: jnp.log(jnp.maximum(p, 1e-12)) + g)
    eng = DecodeEngine(model, ServeConfig(
        slots=c["slots"], max_len=c["max_len"],
        max_new_tokens=c["max_new_tokens"]), stacked=stacked)
    step_fn, margins, first, mismatch = eng._step_fn, {}, [], [0]

    def hooked(bank, caches, tokens, pos, keys):
        out = step_fn(bank, caches, tokens, pos, keys)
        probs, nxt = np.asarray(out[3]), np.asarray(out[1][:, 0])
        pos_h, keys_h = np.asarray(pos), np.asarray(keys)
        for i, rid in enumerate(eng.slot_req):
            if rid is None:
                continue
            g = jax.random.gumbel(jax.random.fold_in(
                jnp.asarray(keys_h[i]), int(pos_h[i])), probs.shape[-1:])
            s = np.asarray(scores(jnp.asarray(probs[i]), g))
            top = np.argsort(-s, kind="stable")[:2]
            mismatch[0] += int(top[0] != nxt[i])
            margins.setdefault(rid, []).append(float(s[top[0]] - s[top[1]]))
        if not first:
            order = np.argsort(-probs, axis=-1, kind="stable")[:, :c["top"]]
            first.append({"idx": order.tolist(), "probs": np.take_along_axis(
                probs, order, -1).tolist()})
        return out

    eng._step_fn = hooked
    reqs = [ServeRequest(prompt_token=t, seed=s) for t, s in
            decode_requests(model.cfg.vocab_size, c["requests"], c["seed"])]
    resps = eng.run(reqs)
    return {"tokens": [r.tokens.tolist() for r in resps],
            "token_entropy": [r.token_entropy.tolist() for r in resps],
            "entropy": [r.entropy for r in resps],
            "pred": [int(np.argmax(r.probs)) for r in resps],
            "margins": [margins[r.request_id] for r in resps],
            "first_step_top": first[0], "argmax_mismatches": mismatch[0]}


def write_decode() -> None:
    import jax
    import jax.numpy as jnp
    from repro.config import get_arch
    from repro.models import get_model
    c = DECODE_CONFIG
    cfg = get_arch(c["arch"]).config
    key = jax.random.PRNGKey(c["seed"])
    t0 = time.perf_counter()
    model = get_model(cfg)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        model.init(jax.random.fold_in(key, i)) for i in range(c["samples"])])
    leaves = {"/".join(str(getattr(k, "key", k)) for k in path):
              leaf_record(np.asarray(x))
              for path, x in jax.tree_util.tree_leaves_with_path(stacked)}
    print(f"bank: {len(leaves)} leaves in {time.perf_counter() - t0:.1f} s",
          flush=True)
    runs = {}
    for dtype in c["dtypes"]:
        t0 = time.perf_counter()
        runs[dtype] = reference_decode(get_model(cfg.replace(dtype=dtype)),
                                       stacked, c)
        print(f"{dtype}: {len(runs[dtype]['tokens'])} requests in "
              f"{time.perf_counter() - t0:.1f} s; smallest margin "
              f"{min(min(m) for m in runs[dtype]['margins']):.3g}; "
              f"recomputed argmax off the engine's token "
              f"{runs[dtype]['argmax_mismatches']} times; first tokens "
              f"{runs[dtype]['tokens'][0][:6]}", flush=True)
    DECODE_FILE.write_text(json.dumps(
        {"config": c, "leaves": leaves, "runs": runs}, indent=1) + "\n")
    print(f"wrote {DECODE_FILE}")


LM_ROUNDS_FILE = GOLDEN / "lm_rounds_smollm_135m.json"
# the train CLI's defaults for smollm-135m (``repro/launch/train.py``),
# each cut listed under ``cuts``: the CPU holds two nodes' f32 state at
# full width
LM_ROUNDS_CONFIG = dict(
    arch="smollm-135m", dtype="float32", seed=0, rounds=2, pool=8,
    minibatch=2, seq=32, data_scale=1.0,
    fed=dict(num_nodes=2, local_steps=2, eta=1e-4, zeta=0.3,
             topology="ring", compressor="block_topk", compress_ratio=0.01),
    cuts={"num_nodes": "4 -> 2", "local_steps": "4 -> 2",
          "batch": "4 -> 2", "seq": "128 -> 32", "rounds": "20 -> 2",
          "pool": "64 -> 8", "dtype": "bfloat16 -> float32"})


# the elements of largest |g| a gradient leaf keeps in the LM record
LM_GRAD_TOP = 16


# chip_smoke.py's phase-14 (e) run of the training CLI at full width: the
# reference CLI's defaults for smollm-135m, two rounds, each evaluated
LM_CLI_ARGV = ["--arch", "smollm-135m", "--rounds", "2", "--log-every", "1",
               "--eval-every", "1", "--eval-examples", "16",
               "--bank-capacity", "2", "--burn-in", "0"]


def lm_pools(markov_tokens, nodes: int, pool: int, seq: int, vocab: int,
             seed: int = 0, node0: int = 0) -> list:
    """The train CLI's per-node pools, ``markov_tokens(pool, seq, V, seed,
    k)`` for nodes ``node0 .. node0 + nodes - 1`` (node K's stream is its
    held-out set)."""
    return [{"tokens": markov_tokens(pool, seq, vocab, seed=seed, node=k)}
            for k in range(node0, node0 + nodes)]


def tree_record(tree) -> dict:
    """:func:`leaf_record` of every leaf of a (numpy) tree, by path."""
    import jax
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            leaf_record(np.asarray(x))
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def lm_nll_batch(pools, minibatch: int) -> np.ndarray:
    """The LM record's NLL batch ``(K, minibatch, S)``: the first
    ``minibatch`` sequences of each node's pool."""
    return np.stack([p["tokens"][:minibatch] for p in pools])


def grad_record(g: np.ndarray, top: int = LM_GRAD_TOP) -> dict:
    """A gradient leaf: shape, float64 sum and L2 norm, the largest |g|,
    and the ``top`` elements of largest |g| (flat index and value; picks at
    fixed places would mostly read the zero rows of an embedding that the
    batch's tokens never reach)."""
    flat = np.ascontiguousarray(g, np.float32).reshape(-1)
    idx = np.sort(np.argsort(-np.abs(flat), kind="stable")[:top])
    return {"shape": list(g.shape),
            "sum": float(flat.astype(np.float64).sum()),
            "norm": float(np.sqrt(np.square(flat.astype(np.float64)).sum())),
            "absmax": float(np.abs(flat).max()),
            "idx": [int(i) for i in idx],
            "values": [float(flat[i]) for i in idx]}


def write_lm_rounds() -> None:
    """The reference's host-engine rounds of full-width smollm-135m in f32
    (:data:`LM_ROUNDS_CONFIG`): each round's losses (K, L), consensus and
    wire bytes a node, and after it each leaf of θ and v (shape, float64
    sum, sum of the f32 bit patterns, elements at :func:`leaf_picks`)
    with v's count of survivors and each node's NLL of θ on the record's
    NLL batch (:func:`lm_nll_batch`); the init's θ under ``init``, its NLL
    under ``init_nll`` and the gradient of the nodes' summed NLL there
    under ``init_grad`` (:func:`grad_record`). The loss is data_scale·NLL
    plus the prior's ½·(1/K)·Σθ², which dwarfs the NLL at full width, and
    η·∇NLL moves θ by less than the rounds' noise: the NLL and its gradient
    are recorded apart so that a wrong forward or backward shows."""
    import jax
    import jax.numpy as jnp
    from repro.config import FedConfig, get_arch
    from repro.data.synthetic_lm import markov_tokens
    from repro.models import get_model
    from repro.train import FedTrainer
    c = LM_ROUNDS_CONFIG
    cfg = get_arch(c["arch"]).config.replace(dtype=c["dtype"])
    fed = FedConfig(rounds=c["rounds"], **c["fed"])
    t0 = time.time()
    model = get_model(cfg)
    pools = lm_pools(markov_tokens, fed.num_nodes, c["pool"], c["seq"],
                     cfg.vocab_size, c["seed"])
    trainer = FedTrainer(model, fed, pools, minibatch=c["minibatch"],
                         seed=c["seed"], data_scale=c["data_scale"],
                         engine="host", bank_capacity=1)
    batch = {"tokens": jnp.asarray(lm_nll_batch(pools, c["minibatch"]))}
    nll_fn = jax.jit(jax.vmap(lambda p, b: model.loss(p, b)[0]))
    grad_fn = jax.jit(jax.grad(lambda p, b: jnp.sum(jax.vmap(
        lambda q, t: model.loss(q, t)[0])(p, b))))
    nll = lambda p: np.asarray(nll_fn(p, batch), np.float64).tolist()
    rec = {"command": "JAX_PLATFORMS=cpu PYTHONPATH=src python "
                      "tests/torch_golden.py lm-rounds",
           "reference": "repro.train.FedTrainer(engine='host') on the CPU",
           "config": c, "init": tree_record(trainer.state.params),
           "init_nll": nll(trainer.state.params),
           "init_grad": {
               "/".join(str(getattr(k, "key", k)) for k in path):
               grad_record(np.asarray(g)) for path, g in
               jax.tree_util.tree_leaves_with_path(
                   grad_fn(trainer.state.params, batch))},
           "rounds": []}
    print(f"init in {time.time() - t0:.1f} s", flush=True)
    eng, losses = trainer._engine, []
    round_fn = eng.round_fn

    def hooked(state, batches, key):
        out = round_fn(state, batches, key)
        losses.append(np.asarray(out[1].loss, np.float64).tolist())
        return out
    eng.round_fn = hooked
    for t in range(c["rounds"]):
        t1 = time.time()
        res = trainer.run(rounds=1)
        v = jax.tree.map(np.asarray, trainer.state.v)
        rec["rounds"].append({
            "loss": losses[-1],
            "mean_loss": float(res.loss_history[-1]),
            "consensus": float(res.consensus_history[-1]),
            "wire_bytes": float(res.wire_history[-1]),
            "theta": tree_record(trainer.state.params),
            "v": tree_record(v),
            "v_survivors": {"/".join(str(getattr(k, "key", k)) for k in path):
                            int(np.count_nonzero(x)) for path, x in
                            jax.tree_util.tree_leaves_with_path(v)},
            "nll": nll(trainer.state.params),
            "seconds": time.time() - t1})
        print(f"round {t + 1}: loss {res.loss_history[-1]:.6f} consensus "
              f"{res.consensus_history[-1]:.6e} in {time.time() - t1:.1f} s",
              flush=True)
    rec["cli"] = {"argv": LM_CLI_ARGV,
                  "lines": reference_cli_lines(LM_CLI_ARGV)}
    LM_ROUNDS_FILE.write_text(json.dumps(rec, indent=1) + "\n")
    print(f"wrote {LM_ROUNDS_FILE}")


# chip_smoke.py's phases 15 and 16 at reduced width: llava-next (with its
# patches), grok-1 and deepseek-v2 (MLA, shared experts) under cdbfl in
# f32 on the reference's host engine, and the reference's DecodeEngine on
# the two MoE archs. The reference's engine vmaps a batch-1 decode over
# its lanes, where jax.lax.ragged_dot has no batching rule (jax 0.9.0:
# "ragged_dot vmap over any dim but 0 - NYI"), so it decodes with
# impl="gshard": one token a lane drops no copy at any capacity, so it is
# the ragged dispatch's function there.
LM_FAMILIES_FILE = GOLDEN / "lm_families_reduced.json"
LM_FAMILY_RUNS = {
    "llava": dict(arch="llava-next-mistral-7b", impl=None),
    "grok_ragged": dict(arch="grok-1-314b", impl="ragged"),
    "deepseek_gshard": dict(arch="deepseek-v2-236b", impl="gshard"),
    "deepseek_ragged": dict(arch="deepseek-v2-236b", impl="ragged"),
}
LM_FAMILY_CONFIG = dict(
    dtype="float32", seed=0, rounds=2, pool=6, minibatch=2, seq=16,
    fed=dict(num_nodes=2, local_steps=2, eta=1e-3, zeta=0.3,
             temperature=0.1, topology="ring", compressor="block_topk",
             compress_ratio=0.05, burn_in=1))
# the decode runs: a bank of 2 inits from fold_in(PRNGKey(0), i), 6
# requests (decode_requests), 2 slots, 5 new tokens, in f32
LM_FAMILY_DECODE = dict(samples=2, requests=6, slots=2, max_len=8,
                        new_tokens=5)


def family_cfg(get_arch, moe_cls, arch: str, impl, dtype: str):
    """The reduced config of ``arch`` in ``dtype`` with MoE dispatch
    ``impl`` (either package's ``get_arch`` and ``MoEConfig``)."""
    cfg = get_arch(arch).reduced.replace(dtype=dtype)
    if impl is not None:
        m = cfg.moe
        cfg = cfg.replace(moe=moe_cls(m.num_experts, m.num_shared_experts,
                                      m.top_k, m.aux_loss_weight, impl,
                                      m.capacity_factor))
    return cfg


def family_pools(cfg, markov_tokens, nodes: int, pool: int, seq: int,
                 seed: int = 0) -> list:
    """Each node's pool: markov tokens, and for the vlm family numpy
    normal patches ``(pool, P, D)`` from ``default_rng(seed + 100 + k)``,
    for the audio family frames ``(pool, S_enc, D)`` from
    ``default_rng(seed + 200 + k)``."""
    pools = lm_pools(markov_tokens, nodes, pool, seq, cfg.vocab_size, seed)
    for k, p in enumerate(pools):
        if cfg.family == "vlm":
            p["patches"] = np.random.default_rng(seed + 100 + k) \
                .standard_normal((pool, cfg.num_image_patches,
                                  cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            p["frames"] = np.random.default_rng(seed + 200 + k) \
                .standard_normal((pool, cfg.encoder_seq_len,
                                  cfg.d_model)).astype(np.float32)
    return pools


def write_lm_families(runs=None, path=None, command="lm-families") -> None:
    """Each run of ``runs`` (:data:`LM_FAMILY_RUNS`): its rounds' losses
    (K, L), consensus and wire bytes, θ after them (:func:`tree_record`)
    and v's nonzero count a leaf; for every family but the vlm the
    reference's engine's tokens and entropies (the MoE archs with
    ``impl="gshard"``)."""
    import jax
    import jax.numpy as jnp
    from repro.config import FedConfig, MoEConfig, ServeConfig, get_arch
    from repro.data.synthetic_lm import markov_tokens
    from repro.models import get_model
    from repro.serve import DecodeEngine, ServeRequest
    from repro.train import FedTrainer
    runs = LM_FAMILY_RUNS if runs is None else runs
    path = LM_FAMILIES_FILE if path is None else path
    c, d = LM_FAMILY_CONFIG, LM_FAMILY_DECODE
    out = {"command": "JAX_PLATFORMS=cpu PYTHONPATH=src python "
                      f"tests/torch_golden.py {command}",
           "config": c, "decode": d, "runs": {}}
    for name, run in runs.items():
        t0 = time.time()
        cfg = family_cfg(get_arch, MoEConfig, run["arch"], run["impl"],
                         c["dtype"])
        fed = FedConfig(rounds=c["rounds"], **c["fed"])
        pools = family_pools(cfg, markov_tokens, fed.num_nodes, c["pool"],
                             c["seq"], c["seed"])
        trainer = FedTrainer(get_model(cfg), fed, pools,
                             minibatch=c["minibatch"], seed=c["seed"],
                             engine="host", bank_capacity=1)
        eng, losses = trainer._engine, []
        round_fn = eng.round_fn

        def hooked(state, batches, key, round_fn=round_fn, losses=losses):
            o = round_fn(state, batches, key)
            losses.append(np.asarray(o[1].loss, np.float64).tolist())
            return o
        eng.round_fn = hooked
        res = trainer.run(rounds=c["rounds"])
        rec = {"loss": losses,
               "consensus": [float(x) for x in res.consensus_history],
               "wire_bytes": [float(x) for x in res.wire_history],
               "theta": tree_record(jax.tree.map(np.asarray,
                                                 trainer.state.params)),
               "v_survivors": {
                   "/".join(str(getattr(k, "key", k)) for k in path):
                   int(np.count_nonzero(np.asarray(x))) for path, x in
                   jax.tree_util.tree_leaves_with_path(trainer.state.v)}}
        if cfg.family != "vlm":
            dcfg = family_cfg(get_arch, MoEConfig, run["arch"],
                              "gshard" if cfg.family == "moe" else None,
                              c["dtype"])
            model = get_model(dcfg)
            key = jax.random.PRNGKey(0)
            bank = jax.tree.map(lambda *xs: jnp.stack(xs), *[
                model.init(jax.random.fold_in(key, i))
                for i in range(d["samples"])])
            resps = DecodeEngine(model, ServeConfig(
                slots=d["slots"], max_len=d["max_len"],
                max_new_tokens=d["new_tokens"]), stacked=bank).run(
                [ServeRequest(prompt_token=t, seed=s) for t, s in
                 decode_requests(cfg.vocab_size, d["requests"], 0)])
            rec["decode"] = [{"tokens": [int(x) for x in r.tokens],
                              "entropy": [float(x) for x in r.token_entropy]}
                             for r in resps]
        out["runs"][name] = rec
        print(f"{name}: loss {losses}, bytes {rec['wire_bytes']} in "
              f"{time.time() - t0:.1f} s", flush=True)
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path}")


# chip_smoke.py's phases 17-19 at reduced width: recurrentgemma-9b (RG-LRU
# and a local-attention ring), xlstm-1.3b (mlstm_ratio 1) and whisper-tiny
# (on pools with frames) under LM_FAMILY_CONFIG, and the reference's
# DecodeEngine on each (whisper against zero encoder output, ROADMAP C37)
RECURRENT_FAMILIES_FILE = GOLDEN / "lm_families_recurrent.json"
RECURRENT_FAMILY_RUNS = {
    "recurrentgemma": dict(arch="recurrentgemma-9b", impl=None),
    "xlstm": dict(arch="xlstm-1.3b", impl=None),
    "whisper": dict(arch="whisper-tiny", impl=None),
}


def write_recurrent_families() -> None:
    write_lm_families(RECURRENT_FAMILY_RUNS, RECURRENT_FAMILIES_FILE,
                      "recurrent-families")


# chip_smoke.py's phase-15 record of llava-next at full width, cut to the
# fewest layers that scan (2): the init of one model (seed 0), each of its
# leaves' record; each node's NLL of it on its own first sequence
# (1,152 patches and 32 text tokens); the gradient of node 0's NLL over
# img_proj and each layer leaf (its first layer); and the wire bytes a
# node a round of K=2 nodes under the default codec, from the shapes
VLM_FULL_FILE = GOLDEN / "vlm_llava_next.json"
VLM_FULL_CONFIG = dict(arch="llava-next-mistral-7b", num_layers=2,
                       dtype="float32", seed=0, nodes=2, seq=32, pool=1,
                       fed=dict(num_nodes=2, compressor="block_topk",
                                compress_ratio=0.01),
                       cuts={"num_layers": "32 -> 2"})


def write_vlm_full() -> None:
    import jax
    import jax.numpy as jnp
    from repro.config import FedConfig, get_arch
    from repro.core import make_compressor
    from repro.data.synthetic_lm import markov_tokens
    from repro.models import get_model
    c = VLM_FULL_CONFIG
    cfg = get_arch(c["arch"]).config.replace(num_layers=c["num_layers"],
                                             dtype=c["dtype"])
    model = get_model(cfg)
    t0 = time.time()
    params = model.init(jax.random.PRNGKey(c["seed"]))
    pools = family_pools(cfg, markov_tokens, c["nodes"], c["pool"], c["seq"],
                         c["seed"])
    rec = {"command": "JAX_PLATFORMS=cpu PYTHONPATH=src python "
                      "tests/torch_golden.py vlm-full",
           "config": c, "init": tree_record(jax.tree.map(np.asarray, params)),
           "wire_bytes": float(make_compressor(FedConfig(**c["fed"]))
                               .wire_bytes(params))}
    print(f"init in {time.time() - t0:.1f} s", flush=True)
    loss = jax.jit(lambda p, b: model.loss(p, b)[0])
    rec["nll"] = [float(loss(params, jax.tree.map(jnp.asarray, p)))
                  for p in pools]
    print(f"nll {rec['nll']} at {time.time() - t0:.1f} s", flush=True)
    g = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))(
        params, jax.tree.map(jnp.asarray, pools[0]))
    rec["grad"] = {}
    for path, x in jax.tree_util.tree_leaves_with_path(g):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        if key == "embed/img_proj":
            rec["grad"][key] = grad_record(np.asarray(x))
        elif key.startswith("groups/"):
            rec["grad"][key] = grad_record(np.asarray(x)[0])
    del g
    VLM_FULL_FILE.write_text(json.dumps(rec, indent=1) + "\n")
    print(f"wrote {VLM_FULL_FILE} in {time.time() - t0:.1f} s")


# chip_smoke.py's phase-16 (b) record of deepseek-v2 at full width, cut to
# one layer (5.0 B parameters, 20 GB in f32): the init of bank sample 0
# (fold_in(PRNGKey(0), 0)), each leaf's record; its logits of one markov
# sequence of ``seq`` tokens through the ragged dispatch (each position's
# ``top`` largest) with their NLL and aux term; and the reference
# DecodeEngine's run (:func:`reference_decode`) on a bank of that one
# sample, with impl="gshard" (one token a lane: the ragged dispatch's
# function, see LM_FAMILY_RUNS). Each cut of the serving CLI's decode
# defaults (DECODE_CONFIG) is listed under ``cuts``.
MOE_FULL_FILE = GOLDEN / "moe_deepseek_v2.json"
MOE_FULL_CONFIG = dict(
    arch="deepseek-v2-236b", num_layers=1, dtype="float32", seed=0, seq=16,
    top=8, decode=dict(samples=1, slots=8, max_len=16, max_new_tokens=6,
                       requests=16, seed=0, top=8, impl="gshard"),
    cuts={"num_layers": "60 -> 1", "samples": "4 -> 1",
          "max_len": "128 -> 16", "max_new_tokens": "16 -> 6"})


def aligned_empty(shape, dtype) -> np.ndarray:
    """An uninitialized C-contiguous array at a 64-byte boundary, which
    ``jnp.from_dlpack`` takes on the CPU without a copy."""
    dtype = np.dtype(dtype)
    n = int(np.prod(shape, dtype=np.int64))
    buf = np.empty(n * dtype.itemsize + 64, np.uint8)
    off = -buf.ctypes.data % 64
    return buf[off:off + n * dtype.itemsize].view(dtype).reshape(shape)


def chunked_dense_init(chunk: int = 1 << 26):
    """The reference's ``dense_init`` (``repro/models/layers.py``), drawn
    about ``chunk`` elements of leading rows at a time into one
    :func:`aligned_empty` numpy array. JAX's threefry is partitionable
    (``jax_threefry_partitionable``): a draw depends on the key and its
    flat index alone, the index split into two uint32 counters by
    ``prng.iota_2x32_shape``; each block's draws take that function with
    the counters offset to the block's first index, so the blocks are the
    whole leaf's draws without its several leaf-sized temporaries (a
    full-width deepseek-v2 layer's init otherwise outgrows 60 GB)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax._src import prng

    def counters(offset: int):
        lo0, hi0 = np.uint32(offset & 0xFFFFFFFF), np.uint32(offset >> 32)

        def iota(shape):
            lo = lax.iota(np.uint32, math.prod(shape)).reshape(shape) + lo0
            return [(lo < lo0).astype(np.uint32) + hi0, lo]
        return iota

    def init(key, in_dim, out_shape, scale=1.0, dtype=jnp.float32):
        shape = (in_dim,) + tuple(out_shape)
        row = math.prod(shape[1:])
        rows = max(1, chunk // row)
        out = aligned_empty(shape, dtype)
        std = scale / math.sqrt(in_dim)
        if rows >= in_dim:                      # one block: as drawn
            out[...] = np.asarray((std * jax.random.truncated_normal(
                key, -2.0, 2.0, shape)).astype(dtype))
            return out
        saved = prng.iota_2x32_shape
        try:
            for a in range(0, in_dim, rows):
                b = min(a + rows, in_dim)
                prng.iota_2x32_shape = counters(a * row)
                jax.clear_caches()
                out[a:b] = np.asarray((std * jax.random.truncated_normal(
                    key, -2.0, 2.0, (b - a,) + shape[1:])).astype(dtype))
        finally:
            prng.iota_2x32_shape = saved
            jax.clear_caches()
        return out
    return init


def lean_init(model, key, chunk: int = 1 << 26):
    """``model.init(key)`` of a transformer whose large leaves come from
    ``dense_init`` (every block's, the head's), with
    :func:`chunked_dense_init` in its place: the leaves are numpy arrays
    (those the init transposes or reshapes, views)."""
    from repro.models import (attention, layers, mla, moe, rglru,
                              transformer, xlstm)
    mods = (moe, mla, transformer, attention, layers, rglru, xlstm)
    saved = [m.dense_init for m in mods]
    for m in mods:
        m.dense_init = chunked_dense_init(chunk)
    try:
        return model.init(key)
    finally:
        for m, f in zip(mods, saved):
            m.dense_init = f


def jax_leaf(x, lead: bool = False):
    """A JAX array over numpy ``x``'s memory (a C-contiguous aligned copy
    first where ``x`` is not one), with a leading axis of 1 if ``lead``."""
    import jax.numpy as jnp
    if not isinstance(x, np.ndarray):
        return x[None] if lead else x
    return jnp.from_dlpack(x[None] if lead else x)


def contiguous(x):
    if isinstance(x, np.ndarray) and not (x.flags.c_contiguous and
                                          x.ctypes.data % 64 == 0):
        y = aligned_empty(x.shape, x.dtype)
        y[...] = x
        return y
    return x


def write_moe_full() -> None:
    import jax
    from repro.config import MoEConfig, get_arch
    from repro.data.synthetic_lm import markov_tokens
    from repro.models import get_model
    c, d = MOE_FULL_CONFIG, MOE_FULL_CONFIG["decode"]
    cfg = get_arch(c["arch"]).config.replace(num_layers=c["num_layers"],
                                             dtype=c["dtype"])
    t0 = time.time()
    model = get_model(cfg)
    host = lean_init(model, jax.random.fold_in(
        jax.random.PRNGKey(c["seed"]), 0))
    leaves, tdef = jax.tree_util.tree_flatten(host)
    del host
    for i in range(len(leaves)):
        leaves[i] = contiguous(leaves[i])
    host = jax.tree_util.tree_unflatten(tdef, leaves)
    del leaves
    rec = {"command": "JAX_PLATFORMS=cpu PYTHONPATH=src python "
                      "tests/torch_golden.py moe-full",
           "config": c, "init": tree_record(host)}
    print(f"init in {time.time() - t0:.1f} s", flush=True)
    params = jax.tree.map(jax_leaf, host)
    tokens = markov_tokens(1, c["seq"], cfg.vocab_size, seed=c["seed"])
    rec["forward"] = forward_record(model, params, tokens, c["top"])
    print(f"forward: nll {rec['forward']['nll']}, aux {rec['forward']['aux']}"
          f" at {time.time() - t0:.1f} s", flush=True)
    del params
    m = cfg.moe
    dmodel = get_model(cfg.replace(moe=MoEConfig(
        m.num_experts, m.num_shared_experts, m.top_k, m.aux_loss_weight,
        d["impl"], m.capacity_factor)))
    stacked = jax.tree.map(lambda x: jax_leaf(x, lead=True), host)
    rec["decode"] = reference_decode(dmodel, stacked, d)
    print(f"decode: smallest margin "
          f"{min(min(x) for x in rec['decode']['margins']):.3g}, first "
          f"tokens {rec['decode']['tokens'][0]} at {time.time() - t0:.1f} s",
          flush=True)
    MOE_FULL_FILE.write_text(json.dumps(rec, indent=1) + "\n")
    print(f"wrote {MOE_FULL_FILE} in {time.time() - t0:.1f} s")


def forward_record(model, params, tokens, top: int) -> dict:
    """The reference's f32 forward of one sequence (``tokens`` ``(1, S)``):
    each position's ``top`` largest logits, the largest |logit|, the NLL
    and, where the model has one (the MoE archs), the aux term."""
    import jax
    import jax.numpy as jnp
    batch = {"tokens": jnp.asarray(tokens)}
    lg = np.asarray(jax.jit(model.logits)(params, batch))[0]
    order = np.argsort(-lg, axis=-1, kind="stable")[:, :top]
    _, parts = jax.jit(model.loss)(params, batch)
    rec = {"tokens": tokens[0].tolist(), "top_idx": order.tolist(),
           "top_logits": np.take_along_axis(lg, order, -1).tolist(),
           "absmax": float(np.abs(lg).max()), "nll": float(parts["nll"])}
    if float(parts.get("aux", 0.0)):
        rec["aux"] = float(parts["aux"])
    return rec


# chip_smoke.py's phase-17 (b) record of recurrentgemma-9b at full width,
# cut to one (rec, rec, local_attn) group (2.75 B parameters, 11.0 GB in
# f32): the init of bank sample 0 (fold_in(PRNGKey(0), 0)), drawn in row
# blocks (lean_init), each leaf's record; the f32 forward of one markov
# sequence (forward_record); and the reference DecodeEngine's run
# (reference_decode) on a bank of that one sample. Each cut of the serving
# CLI's decode defaults is listed under ``cuts``.
HYBRID_FULL_FILE = GOLDEN / "hybrid_recurrentgemma_9b.json"
HYBRID_FULL_CONFIG = dict(
    arch="recurrentgemma-9b", num_layers=3, dtype="float32", seed=0,
    seq=16, top=8, decode=dict(samples=1, slots=8, max_len=16,
                               max_new_tokens=6, requests=16, seed=0, top=8),
    cuts={"num_layers": "38 -> 3 (one (rec, rec, local_attn) group)",
          "samples": "4 -> 1", "max_len": "128 -> 16",
          "max_new_tokens": "16 -> 6"})


def write_hybrid_full() -> None:
    import jax
    from repro.config import get_arch
    from repro.data.synthetic_lm import markov_tokens
    from repro.models import get_model
    c, d = HYBRID_FULL_CONFIG, HYBRID_FULL_CONFIG["decode"]
    cfg = get_arch(c["arch"]).config.replace(num_layers=c["num_layers"],
                                             dtype=c["dtype"])
    t0 = time.time()
    model = get_model(cfg)
    host = lean_init(model, jax.random.fold_in(
        jax.random.PRNGKey(c["seed"]), 0))
    leaves, tdef = jax.tree_util.tree_flatten(host)
    del host
    for i in range(len(leaves)):
        leaves[i] = contiguous(leaves[i])
    host = jax.tree_util.tree_unflatten(tdef, leaves)
    del leaves
    rec = {"command": "JAX_PLATFORMS=cpu PYTHONPATH=src python "
                      "tests/torch_golden.py hybrid-full",
           "config": c, "init": tree_record(host)}
    print(f"init in {time.time() - t0:.1f} s", flush=True)
    params = jax.tree.map(jax_leaf, host)
    tokens = markov_tokens(1, c["seq"], cfg.vocab_size, seed=c["seed"])
    rec["forward"] = forward_record(model, params, tokens, c["top"])
    print(f"forward: nll {rec['forward']['nll']} at {time.time() - t0:.1f} s",
          flush=True)
    del params
    stacked = jax.tree.map(lambda x: jax_leaf(x, lead=True), host)
    rec["decode"] = reference_decode(model, stacked, d)
    print(f"decode: smallest margin "
          f"{min(min(x) for x in rec['decode']['margins']):.3g}, first "
          f"tokens {rec['decode']['tokens'][0]} at {time.time() - t0:.1f} s",
          flush=True)
    HYBRID_FULL_FILE.write_text(json.dumps(rec, indent=1) + "\n")
    print(f"wrote {HYBRID_FULL_FILE} in {time.time() - t0:.1f} s")


# chip_smoke.py's phase-18 (b) record of xlstm-1.3b at full width and full
# depth (1.24 B parameters, 4.96 GB in f32): the init of bank sample 0
# (fold_in(PRNGKey(seed), 0)), each leaf's record, and the f32 forward of
# one markov sequence
SSM_FULL_FILE = GOLDEN / "ssm_xlstm_1_3b.json"
SSM_FULL_CONFIG = dict(arch="xlstm-1.3b", dtype="float32", seed=0, seq=16,
                       top=8)


def write_ssm_full() -> None:
    import jax
    from repro.config import get_arch
    from repro.data.synthetic_lm import markov_tokens
    from repro.models import get_model
    c = SSM_FULL_CONFIG
    cfg = get_arch(c["arch"]).config.replace(dtype=c["dtype"])
    t0 = time.time()
    model = get_model(cfg)
    params = model.init(jax.random.fold_in(jax.random.PRNGKey(c["seed"]), 0))
    rec = {"command": "JAX_PLATFORMS=cpu PYTHONPATH=src python "
                      "tests/torch_golden.py ssm-full",
           "config": c, "init": tree_record(jax.tree.map(np.asarray,
                                                         params))}
    print(f"init in {time.time() - t0:.1f} s", flush=True)
    tokens = markov_tokens(1, c["seq"], cfg.vocab_size, seed=c["seed"])
    rec["forward"] = forward_record(model, params, tokens, c["top"])
    print(f"forward: nll {rec['forward']['nll']} at {time.time() - t0:.1f} s",
          flush=True)
    SSM_FULL_FILE.write_text(json.dumps(rec, indent=1) + "\n")
    print(f"wrote {SSM_FULL_FILE} in {time.time() - t0:.1f} s")


# chip_smoke.py's phase-19 record of whisper-tiny at full width and depth:
# the init of PRNGKey(seed), each leaf's record; the wire bytes a node a
# round under the default codec; each node's NLL of its first sequence
# (``seq`` tokens, 1,500 frames; family_pools); the encoder's output on
# node 0's first frames (prefill_encoder); and the reference DecodeEngine's
# run on a bank of ``samples`` inits from fold_in(PRNGKey(0), i), against
# the zero encoder output of init_decode_state (ROADMAP C37)
AUDIO_FILE = GOLDEN / "audio_whisper_tiny.json"
AUDIO_CONFIG = dict(arch="whisper-tiny", dtype="float32", seed=0, nodes=2,
                    seq=32, pool=2,
                    fed=dict(num_nodes=2, compressor="block_topk",
                             compress_ratio=0.01),
                    decode=dict(samples=2, slots=8, max_len=32,
                                max_new_tokens=8, requests=16, seed=0,
                                top=8))


def write_audio() -> None:
    import jax
    import jax.numpy as jnp
    from repro.config import FedConfig, get_arch
    from repro.core import make_compressor
    from repro.data.synthetic_lm import markov_tokens
    from repro.models import get_model
    c, d = AUDIO_CONFIG, AUDIO_CONFIG["decode"]
    cfg = get_arch(c["arch"]).config.replace(dtype=c["dtype"])
    t0 = time.time()
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(c["seed"]))
    pools = family_pools(cfg, markov_tokens, c["nodes"], c["pool"], c["seq"],
                         c["seed"])
    loss = jax.jit(lambda p, b: model.loss(p, b)[0])
    first = [{k: jnp.asarray(v[:1]) for k, v in p.items()} for p in pools]
    cache = model.prefill_encoder(params, model.init_decode_state(
        1, 8, jnp.float32), first[0]["frames"])
    rec = {"command": "JAX_PLATFORMS=cpu PYTHONPATH=src python "
                      "tests/torch_golden.py audio",
           "config": c, "init": tree_record(jax.tree.map(np.asarray, params)),
           "wire_bytes": float(make_compressor(FedConfig(**c["fed"]))
                               .wire_bytes(params)),
           "nll": [float(loss(params, b)) for b in first],
           "enc_out": leaf_record(np.asarray(cache["enc_out"]))}
    print(f"init, nll {rec['nll']} at {time.time() - t0:.1f} s", flush=True)
    key = jax.random.PRNGKey(0)
    bank = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        model.init(jax.random.fold_in(key, i)) for i in range(d["samples"])])
    rec["decode"] = reference_decode(model, bank, d)
    print(f"decode: smallest margin "
          f"{min(min(x) for x in rec['decode']['margins']):.3g} at "
          f"{time.time() - t0:.1f} s", flush=True)
    AUDIO_FILE.write_text(json.dumps(rec, indent=1) + "\n")
    print(f"wrote {AUDIO_FILE} in {time.time() - t0:.1f} s")


def print_kv_flips(draws: int = 200) -> None:
    import jax
    import jax.numpy as jnp
    import torch
    from repro_torch.config import get_arch
    from repro_torch.models import get_model
    from test_torch_lm_model import (_port_params, _rel, _tokens, bf16_bits,
                                     port_teacher_forced, qwen_reference,
                                     teacher_forced)
    torch.set_num_threads(1)
    jcfg, jm, jp = qwen_reference("float32")
    toks = _tokens(jcfg, 2, 12, 3)
    step = jax.jit(jm.decode_step)
    ref_cache, want = teacher_forced(lambda c, t, p: step(jp, c, t, p),
                                     jm.init_decode_state(2, 16), toks,
                                     jnp.int32, jnp.asarray)
    cache, got = port_teacher_forced(jp, "float32", toks)
    for name in ("k", "v"):
        d = np.abs(bf16_bits(cache["groups"]["u0"][name][:, 0])
                   - bf16_bits(ref_cache["groups"]["u0"][name]))
        print(f"{name}: {int((d > 0).sum())} of {d.size} cached entries "
              f"differ, by at most {int(d.max())} bfloat16 ulps")
    print(f"logits: {_rel(got[0], want):.6g} of the largest apart")
    model = get_model(get_arch("qwen2.5-14b").reduced.replace(
        dtype="float32"))
    params = _port_params(jp)
    toks_t = torch.from_numpy(toks)

    def moved(at):
        """The port's logits with one cached entry moved one ulp (away
        from 0, or towards it) right after the step that wrote it."""
        pos0, name, idx, up = at
        c, out = model.init_decode_state(2, 16), []
        for pos in range(toks.shape[1]):
            c, lg = model.decode_step(params, c, toks_t[:, pos],
                                      torch.full((2,), pos))
            if pos == pos0:
                layer, lane, kvh, e = idx
                c["groups"]["u0"][name][layer, 0, lane, pos, kvh,
                                        e:e + 1].view(torch.int16).add_(up)
            out.append(lg[0, :, 0].numpy())
        return np.stack(out, 1)

    base = moved((-1, "k", (0, 0, 0, 0), 0))
    shape = cache["groups"]["u0"]["k"].shape
    rng = np.random.default_rng(0)
    moves = []
    for _ in range(draws):
        idx = (int(rng.integers(shape[0])), int(rng.integers(2)),
               int(rng.integers(shape[4])), int(rng.integers(shape[5])))
        at = (int(rng.integers(toks.shape[1] - 1)),
              ("k", "v")[rng.integers(2)], idx, (1, -1)[rng.integers(2)])
        moves.append(_rel(moved(at), base))
    moves = np.array(moves)
    print(f"one entry one ulp off, {draws} draws: the logits move by a "
          f"median {np.median(moves):.6g}, at most {moves.max():.6g}, "
          f"at least {moves.min():.6g} of the largest; "
          f"{int((moves > 1e-5).sum())} draws above 1e-5")


if __name__ == "__main__":
    which = sys.argv[1:] or ["threefry"]
    for name in which:
        {"threefry": write_threefry,
         "seeded-rounds": write_seeded_rounds,
         "baseline-rounds": write_baseline_rounds,
         "serve-bma": write_serve_bma,
         "topology-rounds": write_topology_rounds,
         "transport-rounds": write_transport_rounds,
         "bf16-rounds": write_bf16_rounds,
         "f16-rounds": write_f16_rounds,
         "claims-smoke": write_claims_smoke,
         "claims-port": compare_claims_port,
         "claims-nudged": compare_claims_nudged,
         "drift": write_drift_rounds,
         "drift-claims": write_drift_claims,
         "decode": write_decode,
         "lm-rounds": write_lm_rounds,
         "kv-flips": print_kv_flips,
         "lm-families": write_lm_families,
         "vlm-full": write_vlm_full,
         "moe-full": write_moe_full,
         "recurrent-families": write_recurrent_families,
         "hybrid-full": write_hybrid_full,
         "ssm-full": write_ssm_full,
         "audio": write_audio}[name]()
