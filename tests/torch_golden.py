"""Known answers of the reference, recorded from JAX on the CPU for the
PyTorch port's tests and for ``chip_smoke.py``, which reads them on the card.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py threefry
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py seeded-rounds
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py baseline-rounds
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py serve-bma
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py topology-rounds
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_golden.py transport-rounds

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

``serve-bma`` writes ``tests/golden/serve_bma_lenet_radar.npz``: the
reference's BMA probabilities and predictive entropies
(``repro.core.posterior.BankPredictor``) for the serving CLI's synthetic
bank at full ``lenet-radar`` width (:data:`SERVE_CONFIG`: the inits from
``fold_in(PRNGKey(seed), i)``, i < samples) on the first maps of the CLI's
requests (``make_dataset(requests, seed=seed + 7)``), beside the
configuration as JSON under ``config``. A CPU test holds the port to it
within rtol 1e-5, ``chip_smoke.py`` the card within rtol 1e-4.

:func:`boundary_blocks` is not a record of the reference but test data
shared the same way: one-block leaves at the edge of the top_k-order
selection kernel's fast path, which the card tests, ``chip_smoke.py`` and
the CPU tests of its rule hold to the plain version.
"""
from __future__ import annotations

import json
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
]


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


def reference_cli_run(argv) -> list:
    """The lines of :data:`TRANSPORT_CLI_LINES` the reference's training
    CLI prints for ``argv``, run in-process."""
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
            if ln.startswith(TRANSPORT_CLI_LINES)]


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


def seeded_rounds(c: dict, command: str) -> dict:
    """The reference's host-engine run of configuration ``c``."""
    import jax
    from repro.config import FedConfig, TopologyConfig, get_arch
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
    trainer = FedTrainer(get_model(cfg), fed,
                         partition_iid(train, fed.num_nodes),
                         minibatch=c["minibatch"], seed=c["seed"],
                         engine="host")
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


if __name__ == "__main__":
    which = sys.argv[1:] or ["threefry"]
    for name in which:
        {"threefry": write_threefry,
         "seeded-rounds": write_seeded_rounds,
         "baseline-rounds": write_baseline_rounds,
         "serve-bma": write_serve_bma,
         "topology-rounds": write_topology_rounds,
         "transport-rounds": write_transport_rounds}[name]()
