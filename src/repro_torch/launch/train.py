"""The CD-BFL training CLI of the port (``repro/launch/train.py``).

The reference's flags with its defaults, for the ``lenet`` family and the
LMs (``--arch smollm-135m``, the default, and every other LM arch:
per-node Markov token pools, ``markov_tokens(pool, seq, V, seed, k)``, and
in-training evals of the held-out stream of node K through
``lm_apply_fn``), on one device: the card unless ``--device cpu``. Each round gathers its minibatch
indices from the round key inside the engine (``--engine scan``: chunks of
rounds as CUDA graphs on the card; ``host``: the per-round oracle), mixes
over the graph of ``--topology`` by the lowering the reference's
``plan_mixer`` picks (static, or time-varying under ``--link-failure`` /
``--gossip-pairs``), and routes each layer through its codec pipeline
under ``--layer-pipelines``, sends the payloads through the lossy D2D
transport under ``--transport``/``--erasure``/``--arq``/``--toa``/
``--snr-db``, runs barrier-free rounds under ``--straggler-prob``/
``--dead-node``, and drifts the training pool on a schedule under
``--drift``/``--drift-*`` (refreshed at phase boundaries; the in-training
eval scores the current distribution) with the bank aged under
``--refresh-window``/``--refresh-decay``. It prints the reference's lines
(``arch=…``, ``wire accounting:``, ``topology=…``, ``transport:``,
``airtime budget:``, ``participation:``, ``drift:``, ``round …``, ``eval
round …``, ``bank snapshot: …``,
``transport accounting:``, ``arq accounting:``, ``participation rates:``,
``saved …``) and writes the bank snapshots and the final checkpoint in the
reference's format, which both packages' ``launch.serve`` read.

    # the CPU, reduced width
    PYTHONPATH=src python -m repro_torch.launch.train --arch lenet-radar \\
        --trim --device cpu --nodes 5 --rounds 4 --local-steps 2 --batch 4 \\
        --topology geometric --radius 0.5 --link-failure 0.1 \\
        --gossip-pairs 2 --log-every 2 --transport --erasure 0.1 --arq \\
        --toa --straggler-prob 0.2 --dead-node 3:2
    PYTHONPATH=src python -m repro_torch.launch.train --arch lenet-radar \
        --trim --device cpu --nodes 5 --rounds 6 --bank-capacity 16 \
        --drift day23_critical --drift-severity 1.0 --drift-onset 2 \
        --refresh-every 2 --refresh-window 3 --refresh-decay 0.9 \
        --eval-every 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --trim --device cpu --rounds 4 --local-steps 2 --seq 32 --batch 2 \\
        --log-every 2 --eval-every 2 --bank-capacity 4 --burn-in 1
    # the card, full width
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --rounds 2 --log-every 1 --eval-every 1 --bank-capacity 2 \\
        --burn-in 0
    PYTHONPATH=src python -m repro_torch.launch.train --arch lenet-radar \\
        --nodes 10 --rounds 4 --local-steps 8 --batch 10 --zeta 0.03 \\
        --topology geometric --radius 0.5 --link-failure 0.1 \\
        --gossip-pairs 2 --fused-compress \\
        --layer-pipelines 'fc1=block_topk|qsgd;*=block_topk' \\
        --bank-capacity 2 --burn-in 2 --eval-every 2 --ckpt-dir /tmp/ckpt

Flags of paths the port does not run yet exit naming their ROADMAP item:
``--mesh > 1`` and ``--engine shard`` (A10). As the reference's CLI, it
builds token pools for every LM arch, so llava-next (whose loss reads
``batch["patches"]``) and whisper-tiny (``batch["frames"]``) fail at their
first round with the reference's ``KeyError``; both train through
``FedTrainer`` on pools that hold those fields.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

# the flags of paths not ported yet, by the ROADMAP item that ports them
_UNPORTED = {
    "A10 (multi-GPU shard engine)": ("mesh", "fed_axis"),
}


def _parse_args(argv: Optional[List[str]] = None):
    from repro_torch.core.topology import GRAPHS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--trim", action="store_true", help="use reduced config")
    ap.add_argument("--algorithm", default="cdbfl",
                    choices=["cdbfl", "dsgld", "cffl"])
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4, help="per-node minibatch")
    ap.add_argument("--seq", type=int, default=128,
                    help="LM sequence length (the LM archs: ROADMAP A12)")
    ap.add_argument("--eta", type=float, default=1e-4)
    ap.add_argument("--zeta", type=float, default=0.3)
    ap.add_argument("--topology", default="ring", choices=list(GRAPHS))
    ap.add_argument("--degree", type=int, default=4,
                    help="k_regular neighbor count")
    ap.add_argument("--edge-prob", type=float, default=0.3,
                    help="erdos_renyi link probability")
    ap.add_argument("--radius", type=float, default=0.45,
                    help="geometric radio range (unit square)")
    ap.add_argument("--link-failure", type=float, default=0.0,
                    help="per-round per-link dropout probability")
    ap.add_argument("--gossip-pairs", type=int, default=0,
                    help=">0: activate only this many matchings per round")
    ap.add_argument("--topo-seed", type=int, default=0,
                    help="graph-sampling seed (erdos_renyi/geometric)")
    ap.add_argument("--transport", action="store_true",
                    help="frame the wire payloads (MTU fragmentation + "
                         "header/airtime accounting) even at zero loss")
    ap.add_argument("--mtu", type=int, default=256,
                    help="transport frame MTU in bytes (8-byte header)")
    ap.add_argument("--erasure", type=float, default=0.0,
                    help=">0: per-frame Bernoulli erasure rate (implies "
                         "--transport; error feedback re-offers lost mass)")
    ap.add_argument("--loss-model", default="bernoulli",
                    choices=["bernoulli", "gilbert"],
                    help="frame-loss process (gilbert: bursty episodes)")
    ap.add_argument("--snr-db", type=float, default=None,
                    help="mean link SNR: enables the Rayleigh per-link "
                         "outage model on the gossip schedule")
    ap.add_argument("--snr-spread-db", type=float, default=0.0,
                    help="per-node lognormal shadowing std dev (dB)")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="ablation: sender's control sequence absorbs the "
                         "full delta even when frames were lost")
    ap.add_argument("--arq", action="store_true",
                    help="selective-repeat retransmission of lost frames "
                         "(implies --transport; see --max-retries)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="ARQ retransmit attempts per frame per round")
    ap.add_argument("--arq-backoff", type=float, default=0.0,
                    help="base retransmit backoff in seconds (doubles per "
                         "attempt; charged against the airtime budget)")
    ap.add_argument("--toa", action="store_true",
                    help="LoRa time-on-air airtime accounting (SX127x "
                         "formula) instead of the flat PHY rate "
                         "(implies --transport)")
    ap.add_argument("--sf", type=int, default=7,
                    help="LoRa spreading factor 6-12 (with --toa)")
    ap.add_argument("--duty-cycle", type=float, default=1.0,
                    help="fraction of the round period the radio may "
                         "transmit (budget = duty-cycle x round period)")
    ap.add_argument("--round-period-s", type=float, default=0.0,
                    help=">0: wall-clock round period bounding the ARQ "
                         "airtime budget; frames over budget are abandoned "
                         "to the CHOCO residual")
    ap.add_argument("--straggler-prob", type=float, default=0.0,
                    help=">0: barrier-free rounds; each node skips a "
                         "round with this probability (stale-weighted "
                         "mixing carries its last state)")
    ap.add_argument("--dead-node", action="append", default=[],
                    metavar="NODE:DIE[:REJOIN]",
                    help="node death timeline, e.g. '2:30' (node 2 dies at "
                         "round 30) or '2:30:60' (rejoins at 60); repeatable")
    ap.add_argument("--compressor", default="block_topk")
    ap.add_argument("--pipeline", default="",
                    help="codec pipeline DSL, e.g. 'block_topk|qsgd' "
                         "(overrides --compressor)")
    ap.add_argument("--ratio", type=float, default=0.01)
    ap.add_argument("--fused-compress", action="store_true",
                    help="encode Q(θ−v) straight from (θ, v) in the "
                         "delta-pack kernel: the dense residual never "
                         "reaches device memory")
    ap.add_argument("--layer-pipelines", default="",
                    help="per-layer codec overrides, "
                         "'pattern=pipeline;pattern=pipeline': the first "
                         "substring match on the param path (keystr form, "
                         "['fc1']['w']) wins, '*' matches all")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--bank-capacity", type=int, default=0,
                    help=">0: keep a posterior sample bank of this capacity "
                         "(cdbfl/dsgld) and snapshot it to --ckpt-dir at "
                         "every --eval-every boundary")
    ap.add_argument("--burn-in", type=int, default=-1,
                    help="rounds before bank admission (-1: rounds // 2)")
    ap.add_argument("--thin", type=int, default=1,
                    help="bank admission stride after burn-in")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--engine", default="scan",
                    choices=["scan", "host", "shard"],
                    help="scan: chunks of rounds, a CUDA graph each on the "
                         "card; host: the per-round oracle; shard: ROADMAP "
                         "A10")
    ap.add_argument("--mesh", type=int, default=1,
                    help="cards on the federated axis (ROADMAP A10)")
    ap.add_argument("--fed-axis", default="fed")
    ap.add_argument("--pool", type=int, default=64,
                    help="per-node synthetic training pool size")
    # streaming drift and bank aging (DESIGN.md §15)
    ap.add_argument("--drift", default="",
                    help="shift family whose severity drifts over training "
                         "(repro_torch.data.scenarios; empty: static data)")
    ap.add_argument("--drift-kind", default="step",
                    choices=["constant", "step", "ramp", "cyclic"],
                    help="severity trajectory shape")
    ap.add_argument("--drift-severity", type=float, default=0.8,
                    help="plateau/peak severity of the drift")
    ap.add_argument("--drift-base", type=float, default=0.0,
                    help="pre-onset severity (keeps the original pool)")
    ap.add_argument("--drift-onset", type=int, default=0,
                    help="first drifted round (step/ramp/cyclic)")
    ap.add_argument("--drift-ramp-rounds", type=int, default=0,
                    help="ramp duration in rounds (kind=ramp)")
    ap.add_argument("--drift-period", type=int, default=0,
                    help="cycle period in rounds (kind=cyclic)")
    ap.add_argument("--drift-seed", type=int, default=0,
                    help="drift-synthesis stream seed")
    ap.add_argument("--refresh-every", type=int, default=5,
                    help="rounds between training-pool refreshes")
    ap.add_argument("--refresh-window", type=int, default=0,
                    help=">0: evict bank samples older than this many "
                         "rounds from the BMA mixture")
    ap.add_argument("--refresh-decay", type=float, default=1.0,
                    help="<1: exponential age discount on the bank "
                         "samples' BMA weights")
    ap.add_argument("--eval-every", type=int, default=0,
                    help=">0: score the posterior every N rounds through "
                         "the scan eval engine")
    ap.add_argument("--eval-scenario", default="clean",
                    help="shift family of the in-training eval set "
                         "(repro_torch.data.scenarios)")
    ap.add_argument("--eval-severity", type=float, default=1.0)
    ap.add_argument("--eval-examples", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    for item, dests in _UNPORTED.items():
        changed = [d for d in dests if getattr(args, d) != ap.get_default(d)]
        if changed:
            flags = ", ".join("--" + d.replace("_", "-") for d in changed)
            raise SystemExit(f"{flags}: not ported yet; ROADMAP {item}")
    if args.engine == "shard":
        raise SystemExit("--engine shard: not ported yet; ROADMAP A10 "
                         "(multi-GPU shard engine)")
    return args


def _transport_config(args):
    """The TransportConfig the flags name, or None (``repro/launch/
    train.py:231-242``)."""
    if not (args.transport or args.erasure > 0 or args.snr_db is not None
            or args.arq or args.toa):
        return None
    from repro_torch.config import TransportConfig
    return TransportConfig(
        mtu=args.mtu, erasure=args.erasure, loss_model=args.loss_model,
        snr_db=args.snr_db, snr_spread_db=args.snr_spread_db,
        error_feedback=not args.no_error_feedback,
        arq=args.arq, max_retries=args.max_retries,
        arq_backoff_s=args.arq_backoff,
        toa=args.toa, sf=args.sf, duty_cycle=args.duty_cycle,
        round_period_s=args.round_period_s)


def _participation_config(args):
    """The ParticipationConfig of ``--straggler-prob``/``--dead-node``, or
    None (``repro/launch/train.py:243-256``)."""
    if not (args.straggler_prob > 0 or args.dead_node):
        return None
    from repro_torch.config import ParticipationConfig
    dead = []
    for spec in args.dead_node:
        parts = [int(p) for p in spec.split(":")]
        if len(parts) == 2:
            parts.append(-1)
        if len(parts) != 3:
            raise SystemExit(f"--dead-node {spec!r}: want NODE:DIE[:REJOIN]")
        dead.append(tuple(parts))
    return ParticipationConfig(straggler_prob=args.straggler_prob,
                               dead=tuple(dead))


def _link_lines(tcfg, pcfg) -> List[str]:
    """The header's ``transport:``, ``airtime budget:`` and
    ``participation:`` lines, character for character the reference's."""
    out = []
    if tcfg is not None:
        out.append(
            f"transport: mtu={tcfg.mtu}B (+8B header/frame) "
            f"loss={tcfg.loss_model}@{tcfg.erasure:g} "
            + (f"snr={tcfg.snr_db:g}±{tcfg.snr_spread_db:g}dB "
               if tcfg.snr_db is not None else "")
            + f"error_feedback={'on' if tcfg.error_feedback else 'OFF'}"
            + (f" arq=selective-repeat x{tcfg.max_retries}"
               + (f" backoff={tcfg.arq_backoff_s:g}s"
                  if tcfg.arq_backoff_s else "")
               if tcfg.arq else "")
            + (f" toa=SF{tcfg.sf}/{tcfg.bw_hz/1e3:g}kHz" if tcfg.toa
               else ""))
        if tcfg.round_period_s > 0:
            out.append(f"airtime budget: {tcfg.duty_cycle:g} duty x "
                       f"{tcfg.round_period_s:g}s round = "
                       f"{tcfg.duty_cycle * tcfg.round_period_s:g}"
                       f"s/node/round (over-budget frames abandoned to the "
                       f"residual)")
    if pcfg is not None:
        out.append(f"participation: straggler_prob={pcfg.straggler_prob:g} "
                   f"dead={list(pcfg.dead) or 'none'} "
                   f"(barrier-free rounds, stale-weighted mixing)")
    return out


def _accounting_lines(engine, tcfg, pcfg) -> List[str]:
    """The closing ``transport accounting:``, ``arq accounting:`` and
    ``participation rates:`` lines of the last round, as the reference
    prints them."""
    import numpy as np
    out = []
    offered = engine.last_offered_history
    if offered and float(offered[-1]) > 0:
        delivered = float(engine.last_delivered_history[-1])
        frac = delivered / float(offered[-1])
        out.append(
            f"transport accounting: offered "
            f"{float(offered[-1]):.0f}B/node/round, delivered "
            f"{delivered:.0f}B ({100 * frac:.1f}%), airtime "
            f"{1e3 * float(engine.last_airtime_history[-1]):.2f}ms, "
            f"energy {1e3 * float(engine.last_energy_history[-1]):.2f}mJ")
        retrans = engine.last_retransmit_history
        if retrans and (tcfg is not None and tcfg.arq):
            out.append(f"arq accounting: {float(retrans[-1]):.2f} "
                       f"retransmits/node/round, "
                       f"{float(engine.last_abandoned_history[-1]):.0f}B "
                       f"abandoned at budget exhaustion")
    part = engine.last_participation_history
    if pcfg is not None and len(part):
        rates = np.asarray(part, np.float64).mean(axis=0)
        out.append("participation rates: "
                   + " ".join(f"n{i}={r:.2f}" for i, r in enumerate(rates))
                   + f" (mean {rates.mean():.2f})")
    return out


def main(argv: Optional[List[str]] = None) -> None:
    args = _parse_args(argv)

    import numpy as np

    from repro_torch import random
    from repro_torch.checkpoint import save_bank, save_checkpoint
    from repro_torch.config import FedConfig, TopologyConfig, get_arch
    from repro_torch.core.algorithms import make_round_fn
    from repro_torch.core.compression import (make_compressor,
                                              parse_layer_rules)
    from repro_torch.core.fed_state import init_fed_state
    from repro_torch.core.gossip import plan_mixer
    from repro_torch.core.posterior import DeviceSampleBank, bank_age_weights
    from repro_torch.core.topology import build_topology, dense_wire_bytes
    from repro_torch.data.partition import DeviceShards, partition_iid
    from repro_torch.data.radar import make_dataset
    from repro_torch.data.synthetic_lm import markov_tokens
    from repro_torch.eval.engine import (ScanEvalEngine, as_stacked,
                                         lm_apply_fn)
    from repro_torch.models import get_model
    from repro_torch.train.engine import make_engine
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.tree import tree_leaves

    try:
        spec = get_arch(args.arch)
        cfg = spec.reduced if args.trim else spec.config
    except NotImplementedError as err:
        raise SystemExit(f"--arch {args.arch}: {err}")
    device = resolve_device(args.device)
    model = get_model(cfg)
    topo_cfg = TopologyConfig(
        graph=args.topology, degree=args.degree, edge_prob=args.edge_prob,
        radius=args.radius, seed=args.topo_seed,
        link_failure_prob=args.link_failure, gossip_pairs=args.gossip_pairs)
    tcfg, pcfg = _transport_config(args), _participation_config(args)
    fed = FedConfig(
        num_nodes=args.nodes, local_steps=args.local_steps,
        eta=args.eta, zeta=args.zeta, topology=args.topology,
        topology_cfg=topo_cfg,
        compressor=args.compressor, pipeline=args.pipeline,
        compress_ratio=args.ratio,
        fused_compress=args.fused_compress,
        layer_pipelines=parse_layer_rules(args.layer_pipelines),
        algorithm=args.algorithm, transport=tcfg, participation=pcfg)
    topo = build_topology(topo_cfg, fed.num_nodes)
    omega = topo.omega
    comp = make_compressor(fed)
    round_fn = make_round_fn(args.algorithm, model.nll, fed, omega, comp,
                             data_scale=1.0, device=device)

    key = random.PRNGKey(fed.seed, device)
    params0 = model.init(key, device)
    n_params = sum(int(np.prod(tuple(x.shape))) for x in tree_leaves(params0))
    state = init_fed_state(params0, fed)
    # dsgld gossips uncompressed θ; the compressed algorithms ship Q(Δθ)
    wire = (n_params * 4 if args.algorithm == "dsgld"
            else comp.wire_bytes(params0))
    # the lowering make_mixer runs (the same decision function; an SNR
    # outage model forces the time-varying schedule)
    mode, sched = plan_mixer(omega, topo_cfg,
                             force_tv=tcfg is not None
                             and tcfg.snr_db is not None)
    n_perms = sched.num_perms if sched else 0
    if mode.startswith("schedule"):
        active = (args.gossip_pairs if 0 < args.gossip_pairs < n_perms
                  else n_perms)
        gossip_wire = active * wire * (1.0 - args.link_failure)
    else:
        gossip_wire = dense_wire_bytes(fed.num_nodes, wire)
    q_name = fed.pipeline or fed.compressor
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M nodes={fed.num_nodes} "
          f"L={fed.local_steps} Q={q_name}@{fed.compress_ratio} "
          f"wire={wire/1e6:.3f}MB/node/round "
          f"(dense {n_params*4/1e6:.1f}MB, saving "
          f"{100*(1-wire/(n_params*4)):.1f}%)")
    if hasattr(comp, "formula_bytes") and args.algorithm != "dsgld":
        formula = comp.formula_bytes(params0)
        print(f"wire accounting: measured={wire} B/node (packed payload) "
              f"formula={formula} B/node "
              f"(x{wire/max(formula, 1):.3f} byte-alignment)")
    print(f"topology={topo.describe()} |λ2|={topo.lambda2:.4f} "
          f"mixer={mode} matchings={n_perms} "
          f"gossip_wire={gossip_wire/1e6:.3f}MB/node/round "
          f"(dense all-gather "
          f"{dense_wire_bytes(fed.num_nodes, wire)/1e6:.3f}MB)"
          + (f" link_failure={args.link_failure}" if args.link_failure else "")
          + (f" gossip_pairs={args.gossip_pairs}" if args.gossip_pairs else ""))
    for line in _link_lines(tcfg, pcfg):
        print(line)

    # per-node synthetic pool on the device; rounds gather their minibatch
    # indices from the round key inside the engine
    if cfg.family == "lenet":
        ds = make_dataset(fed.num_nodes * args.pool, hw=cfg.input_hw, day=1,
                          seed=fed.seed)
        pool = partition_iid(ds, fed.num_nodes, seed=fed.seed)
    else:
        pool = [{"tokens": markov_tokens(args.pool, args.seq, cfg.vocab_size,
                                         seed=fed.seed, node=k)}
                for k in range(fed.num_nodes)]
    dshards = DeviceShards.from_shards(pool, device)
    # streaming drift: the training pool follows a severity schedule,
    # installed in the engine at phase boundaries (DESIGN.md §15)
    refresher = cont = None
    if args.drift:
        if cfg.family != "lenet":
            raise SystemExit("--drift needs a lenet pool (the scenario "
                             "registry synthesizes radar maps, not tokens)")
        from repro_torch.config import ContinualConfig
        from repro_torch.train.drift import make_refresher
        cont = ContinualConfig(
            scenario=args.drift, schedule=args.drift_kind,
            severity=args.drift_severity, base_severity=args.drift_base,
            onset=args.drift_onset, ramp_rounds=args.drift_ramp_rounds,
            period=args.drift_period, refresh_every=args.refresh_every,
            drift_seed=args.drift_seed, window=args.refresh_window,
            decay=args.refresh_decay)
        refresher = make_refresher(cont, dshards)
        print(f"drift: {args.drift} kind={args.drift_kind} "
              f"severity={args.drift_base:g}->{args.drift_severity:g} "
              f"onset={args.drift_onset} refresh_every={args.refresh_every}"
              + (f" window={args.refresh_window}" if args.refresh_window
                 else "")
              + (f" decay={args.refresh_decay:g}"
                 if args.refresh_decay < 1.0 else ""))
    bank_cfg = bank_state = None
    if args.bank_capacity > 0 and args.algorithm in ("cdbfl", "dsgld"):
        burn = args.burn_in if args.burn_in >= 0 else args.rounds // 2
        bank_cfg = DeviceSampleBank(burn_in=burn, capacity=args.bank_capacity,
                                    thin=args.thin)
    engine = make_engine(args.engine, round_fn, dshards, fed.local_steps,
                         args.batch, bank=bank_cfg,
                         chunk=args.log_every or 64)
    if bank_cfg is not None:
        bank_state = (engine.make_bank() if args.engine == "host"
                      else bank_cfg.init(state.params))
        print(f"posterior bank: capacity={args.bank_capacity} "
              f"burn_in={bank_cfg.burn_in} thin={bank_cfg.thin}"
              + (f" snapshots -> {args.ckpt_dir}" if args.ckpt_dir else ""))

    eval_engine = eval_ds = None
    if args.eval_every > 0:
        if cfg.family == "lenet":
            from repro_torch.data.scenarios import make_scenario_dataset
            eval_ds = make_scenario_dataset(
                args.eval_scenario, args.eval_severity, args.eval_examples,
                hw=cfg.input_hw, seed=fed.seed + 90)
            eval_engine = ScanEvalEngine(model.logits)
        else:
            # the held-out stream of node K, which no node trains on
            held = markov_tokens(args.eval_examples, args.seq,
                                 cfg.vocab_size, seed=fed.seed,
                                 node=fed.num_nodes)
            eval_ds = {"tokens": held, "y": held[:, 1:]}
            # batches no larger than the held-out set: a padded row of an
            # LM batch costs its (T, V) f32 logits a sample, and is masked
            eval_engine = ScanEvalEngine(
                lm_apply_fn(model), batch_size=min(64, args.eval_examples))

    t0 = time.time()
    log_cb = lambda t, loss, cons: print(
        f"round {t:4d} loss={loss:.4f} consensus={cons:.3e} "
        f"({(time.time()-t0)/max(t, 1):.2f}s/round)")
    key = random.fold_in(key, 1)

    def bank_stacked():
        """(S, K, ...) posterior samples, or None while still empty."""
        if bank_cfg is None or bank_state is None:
            return None
        if hasattr(bank_state, "samples"):          # host SampleBank
            return bank_state.stacked()
        if not bank_cfg.length(bank_state):
            return None
        return bank_cfg.stacked(bank_state)

    def bank_weights(now: int):
        """The bank's age weights under --refresh-window/--refresh-decay
        (None: the uniform mean)."""
        if cont is None or not cont.ages or bank_cfg is None \
                or bank_state is None:
            return None
        rounds_seen = (bank_state.rounds if hasattr(bank_state, "samples")
                       else bank_cfg.rounds_list(bank_state))
        if not len(rounds_seen):
            return None
        return bank_age_weights(rounds_seen, now, window=cont.window,
                                decay=cont.decay)

    segment = args.eval_every if args.eval_every > 0 else args.rounds
    done = 0
    while done < args.rounds:
        n = min(segment, args.rounds - done)
        subsegs = (list(refresher.segments(done, n))
                   if refresher is not None else [(done, n)])
        for s0, m in subsegs:
            if refresher is not None:
                refresher.refresh(engine, s0)
            state, key, bank_state, _, _ = engine.run(
                state, key, bank_state, m, t0=s0, log_every=args.log_every,
                log_cb=log_cb)
        done += n
        stacked_bank = bank_stacked()
        if eval_engine is not None:
            # BMA over the bank once it has samples; the nodes' current
            # params before burn-in
            stacked = (stacked_bank if stacked_bank is not None
                       else as_stacked(state.params))
            # under drift, the current distribution's held-out cell
            eval_name, eval_sev, ds_now = (args.eval_scenario,
                                           args.eval_severity, eval_ds)
            if refresher is not None:
                eval_name = args.drift
                eval_sev = float(refresher.schedule.severity_at(done - 1))
                ds_now = refresher.eval_dataset(done - 1, args.eval_examples,
                                                seed=fed.seed + 90)
            w = bank_weights(done) if stacked_bank is not None else None
            rep = eval_engine.evaluate(stacked, ds_now, node_axis=1,
                                       weights=w)
            s = tree_leaves(stacked)[0].shape[0]
            print(f"eval  round {done:4d} [{eval_name}"
                  f"@{eval_sev:g}] S={s} acc={rep.accuracy:.4f} "
                  f"ece={rep.ece:.4f} nll={rep.nll:.4f} "
                  f"gap={rep.overconf_gap:+.4f}"
                  + (" aged" if w is not None else ""))
        if args.ckpt_dir and stacked_bank is not None:
            path = save_bank(args.ckpt_dir, done, stacked_bank,
                             metadata={"arch": cfg.name, "round": done})
            print(f"bank snapshot: {path} "
                  f"(S={tree_leaves(stacked_bank)[0].shape[0]})")
    for line in _accounting_lines(engine, tcfg, pcfg):
        print(line)
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, args.rounds, state.params,
                               metadata={"arch": cfg.name, "fed": vars(args)})
        print("saved", path)


if __name__ == "__main__":
    main()
