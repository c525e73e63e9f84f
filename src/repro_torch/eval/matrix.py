"""Scenario × algorithm × pipeline calibration matrix
(``repro/eval/matrix.py``).

Evaluates trained models (fresh training runs or checkpointed params)
across the shift-family registry (``repro_torch.data.scenarios``) through
the scan eval engine, one calibration row per (scenario, severity,
algorithm, pipeline) cell: accuracy, ECE, NLL, Brier, predictive entropy
and the signed overconfidence gap. :func:`run_claims_smoke` is the
reference's claims gate: a tiny fixed-seed slice of the matrix that fails
when the paper's transferable calibration-under-shift claims break.

Every cell trains on the reduced LeNet with the reference's seeds, so a
cell is the reference's cell within the port's last-bit differences.
Trainers run on ``device`` (the card by default; ``"cpu"`` runs every
kernel's plain version).

The drift-recovery gate and the unlearning oracle (``matrix.py:356-610``,
DESIGN.md §15): :func:`run_drift_recovery` probes a continual run's
calibration through a step drift, :func:`run_drift_claims` gates cdbfl's
recovery, and :func:`run_unlearn_oracle` holds ``FedTrainer.unlearn``
to a retrain without the node.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import random
from repro_torch.config import (ContinualConfig, FedConfig,
                                ParticipationConfig, TransportConfig,
                                get_arch)
from repro_torch.data.partition import partition_iid
from repro_torch.data.radar import make_dataset
from repro_torch.data.scenarios import make_scenario_dataset
from repro_torch.eval.engine import EvalReport, ScanEvalEngine, as_stacked
from repro_torch.models import get_model
from repro_torch.utils.tree import tree_leaves


@dataclass(frozen=True)
class MatrixCell:
    """One (scenario, severity, algorithm) cell, a function of the spec and
    seed."""
    scenario: str
    severity: float
    algorithm: str
    pipeline: str          # codec DSL ("" = the legacy compressor enum)
    report: EvalReport
    train_wall_s: float = 0.0
    eval_wall_s: float = 0.0

    def row(self) -> Dict[str, float]:
        r = self.report
        return {
            "scenario": self.scenario, "severity": self.severity,
            "algorithm": self.algorithm, "pipeline": self.pipeline or "-",
            "accuracy": r.accuracy, "ece": r.ece, "nll": r.nll,
            "brier": r.brier, "overconf_gap": r.overconf_gap,
            "count": r.count,
        }


@dataclass(frozen=True)
class MatrixSpec:
    """One matrix run: what to train, what to evaluate it on. A run is a
    function of (spec, seed)."""
    algorithms: Sequence[str] = ("cdbfl", "cffl")
    pipelines: Sequence[str] = ("",)
    # (scenario, severity) cells; every trained model sees every cell
    cells: Sequence[Tuple[str, float]] = (("clean", 0.0),
                                          ("day23_critical", 0.5))
    # reduced-scale training world (paper: K=10, T=800)
    nodes: int = 5
    per_node: int = 24
    rounds: int = 150
    burn_in_frac: float = 2.0 / 3.0
    local_steps: int = 8
    minibatch: int = 10
    eta: float = 3e-3
    zeta: float = 0.3
    temperature: float = 0.2
    # the paper's operator: plain top-k at 1%
    compressor: str = "topk"
    compress_ratio: float = 0.01
    topology: str = "full"
    eval_examples: int = 200
    eval_batch_size: int = 64
    seed: int = 0
    arch: str = "lenet-radar"


def _chaos_blocks(spec: MatrixSpec):
    """``REPRO_CHAOS=1``: every cell trains under protocol-level chaos — 20%
    frame erasure recovered by selective-repeat ARQ, 20% stragglers, and
    one mid-run node death and rejoin."""
    if os.environ.get("REPRO_CHAOS", "") in ("", "0"):
        return None, None
    transport = TransportConfig(mtu=64, erasure=0.2, arq=True, max_retries=2)
    participation = ParticipationConfig(
        straggler_prob=0.2,
        dead=((spec.nodes - 1, spec.rounds // 3, 2 * spec.rounds // 3),))
    return transport, participation


def _train_one(spec: MatrixSpec, algorithm: str, pipeline: str,
               device="cuda"):
    from repro_torch.train import FedTrainer   # the trainer imports eval
    cfg = get_arch(spec.arch).reduced
    model = get_model(cfg)
    train = make_dataset(spec.nodes * spec.per_node, hw=cfg.input_hw,
                         day=1, seed=spec.seed)
    shards = partition_iid(train, spec.nodes, seed=spec.seed)
    transport, participation = _chaos_blocks(spec)
    fed = FedConfig(
        num_nodes=spec.nodes, local_steps=spec.local_steps, eta=spec.eta,
        zeta=spec.zeta, rounds=spec.rounds,
        burn_in=int(spec.rounds * spec.burn_in_frac),
        compressor=spec.compressor, pipeline=pipeline,
        compress_ratio=spec.compress_ratio, topology=spec.topology,
        temperature=spec.temperature, algorithm=algorithm, seed=spec.seed,
        transport=transport, participation=participation,
    )
    tr = FedTrainer(model, fed, shards, minibatch=spec.minibatch,
                    seed=spec.seed, eval_batch_size=spec.eval_batch_size,
                    device=device)
    t0 = time.time()
    tr.run(rounds=spec.rounds)
    return cfg, tr, time.time() - t0


def _cell_dataset(spec: MatrixSpec, cfg, scenario: str, severity: float
                  ) -> Dict[str, np.ndarray]:
    return make_scenario_dataset(scenario, severity, spec.eval_examples,
                                 hw=cfg.input_hw, seed=spec.seed + 90)


def run_matrix(spec: MatrixSpec, log=print, trainers: Optional[Dict] = None,
               device="cuda") -> List[MatrixCell]:
    """Train every (algorithm, pipeline), evaluate every scenario cell.
    Pass a dict as ``trainers`` to receive each trained ``FedTrainer`` by
    (algorithm, pipeline): the claims gate re-scores cells on them."""
    cells: List[MatrixCell] = []
    for algorithm in spec.algorithms:
        for pipeline in spec.pipelines:
            cfg, tr, train_s = _train_one(spec, algorithm, pipeline, device)
            if trainers is not None:
                trainers[(algorithm, pipeline)] = tr
            for scenario, severity in spec.cells:
                ds = _cell_dataset(spec, cfg, scenario, severity)
                t0 = time.time()
                rep = tr.eval_report(ds)
                cells.append(MatrixCell(
                    scenario=scenario, severity=float(severity),
                    algorithm=algorithm, pipeline=pipeline, report=rep,
                    train_wall_s=train_s, eval_wall_s=time.time() - t0))
                if log:
                    log(f"  [{algorithm}|{pipeline or '-'}] "
                        f"{scenario}@{severity:g}: acc={rep.accuracy:.4f} "
                        f"ece={rep.ece:.4f} nll={rep.nll:.4f} "
                        f"gap={rep.overconf_gap:+.4f}")
    return cells


def evaluate_params_matrix(params, arch: str,
                           cells: Sequence[Tuple[str, float]],
                           eval_examples: int = 200, seed: int = 0,
                           batch_size: int = 64, node_axis: Optional[int] = 0,
                           log=print) -> List[MatrixCell]:
    """Point-estimate matrix for checkpointed params (no training run), on
    the params' device. ``node_axis=0`` treats a leading params axis as
    node chains (the FedState layout); ``None`` scores a single replica."""
    spec = get_arch(arch)
    cfg = spec.reduced if _looks_reduced(params, arch) else spec.config
    model = get_model(cfg)
    stacked = as_stacked(params)
    engine = ScanEvalEngine(model.logits, batch_size=batch_size)
    out: List[MatrixCell] = []
    for scenario, severity in cells:
        ds = make_scenario_dataset(scenario, severity, eval_examples,
                                   hw=cfg.input_hw, seed=seed + 90)
        t0 = time.time()
        rep = engine.evaluate(stacked, ds,
                              node_axis=(node_axis + 1
                                         if node_axis is not None else None))
        out.append(MatrixCell(scenario=scenario, severity=float(severity),
                              algorithm="checkpoint", pipeline="",
                              report=rep, eval_wall_s=time.time() - t0))
        if log:
            log(f"  [checkpoint] {scenario}@{severity:g}: "
                f"acc={rep.accuracy:.4f} ece={rep.ece:.4f}")
    return out


def _looks_reduced(params, arch: str) -> bool:
    """Whether checkpoint params have the reduced config's shapes (fc1's
    input width differs between the two), read off the port's model
    initialized on the ``meta`` device: every ≥2-D shape of the reduced
    model must be among the params' (node-stacked or not). The reference
    asks for any one shape in common, which a full-width LeNet has too
    (its convs, fc2 and fc3 keep their shapes), so it scores a full-width
    checkpoint with the reduced model (ROADMAP C24). The reference also
    takes any error here for "reduced"; the port lets it propagate, so a
    checkpoint of another model fails loudly."""
    model = get_model(get_arch(arch).reduced)
    like = model.init(random.PRNGKey(0, "meta"), "meta")
    flat_p = {tuple(np.shape(x)) for x in tree_leaves(params)
              if np.ndim(x) >= 2}
    flat_r = {tuple(x.shape) for x in tree_leaves(like) if x.dim() >= 2}
    # node-stacked checkpoints carry one leading axis
    stripped = {s[1:] for s in flat_p}
    return flat_r <= flat_p or flat_r <= stripped


def matrix_markdown(cells: Sequence[MatrixCell]) -> str:
    lines = [
        "| scenario | severity | algorithm | pipeline | acc | ece | nll "
        "| brier | overconf_gap | n |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        r = c.report
        lines.append(
            f"| {c.scenario} | {c.severity:g} | {c.algorithm} "
            f"| {c.pipeline or '-'} | {r.accuracy:.4f} | {r.ece:.4f} "
            f"| {r.nll:.4f} | {r.brier:.4f} | {r.overconf_gap:+.4f} "
            f"| {int(r.count)} |")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# the claims gate (matrix.py:221-356)
# --------------------------------------------------------------------------

#: the tiny fixed-seed slice the claims gate runs
CLAIMS_SPEC = MatrixSpec(
    algorithms=("cdbfl", "cffl"),
    pipelines=("",),
    cells=(("clean", 0.0), ("day23_critical", 1.0)),
    rounds=60, per_node=24, eval_examples=200, seed=0,
)

#: slack on the ECE ordering claim. At reduced scale the cold-posterior
#: BMA is underconfident, so the paper's raw "cdbfl ECE <= cffl ECE under
#: shift" ordering is only a warning; the hard gates are the claims that
#: transfer: the shift degrades accuracy, the Bayesian model keeps far
#: more predictive uncertainty under shift, and the frequentist model is
#: the one that turns overconfident.
CLAIMS_ECE_MARGIN = 0.02
CLAIMS_ACC_DROP_MIN = 0.15
CLAIMS_ENTROPY_MARGIN = 0.15
CLAIMS_CFFL_GAP_RISE_MIN = 0.10


def run_claims_smoke(spec: MatrixSpec = CLAIMS_SPEC, log=print,
                     device="cuda") -> Dict[str, object]:
    """Run the claims slice; list a failure for each transferable claim
    that breaks and a warning for the reduced-scale ECE ordering.

    Also re-scores the cdbfl shifted cell from scratch (a fresh scenario
    synthesis through a fresh eval engine) and requires the same ECE bit
    for bit: the cell is a function of the spec, nothing else."""
    trainers: Dict = {}
    cells = run_matrix(spec, log=log, trainers=trainers, device=device)
    by = {(c.algorithm, c.scenario): c for c in cells}
    shift_name, shift_sev = next((s, v) for s, v in spec.cells
                                 if s != "clean")

    failures: List[str] = []
    warnings: List[str] = []
    for c in cells:
        if not np.isfinite(c.report.ece):
            failures.append(f"{c.algorithm}/{c.scenario}: ECE is not finite "
                            f"({c.report.ece})")
    cd = by[("cdbfl", shift_name)].report
    cf = by[("cffl", shift_name)].report
    cd0 = by[("cdbfl", "clean")].report
    cf0 = by[("cffl", "clean")].report

    cfg = get_arch(spec.arch).reduced
    ds_a = _cell_dataset(spec, cfg, shift_name, shift_sev)
    ds_b = _cell_dataset(spec, cfg, shift_name, shift_sev)
    if not (np.array_equal(ds_a["x"], ds_b["x"])
            and np.array_equal(ds_a["y"], ds_b["y"])):
        failures.append(f"scenario {shift_name}@{shift_sev} is not "
                        f"reproducible: two syntheses differ")
    tr = trainers[("cdbfl", spec.pipelines[0])]
    fresh = ScanEvalEngine(tr.model.logits, batch_size=spec.eval_batch_size)
    rep2 = fresh.evaluate(tr._stacked_bank(), ds_b, node_axis=1)
    if rep2.ece != cd.ece:
        failures.append(
            f"shifted ECE not reproducible: fresh-engine re-score "
            f"{rep2.ece!r} != first score {cd.ece!r}")

    # the shift must degrade accuracy (the argument's precondition)
    for name, clean, shifted in (("cdbfl", cd0, cd), ("cffl", cf0, cf)):
        drop = clean.accuracy - shifted.accuracy
        if drop < CLAIMS_ACC_DROP_MIN:
            failures.append(
                f"{name}: {shift_name} no longer degrades accuracy "
                f"(drop {drop:.3f} < {CLAIMS_ACC_DROP_MIN}) — the shift "
                f"scenario lost its teeth")
    # uncertainty retention: the Bayesian model keeps far more predictive
    # entropy under shift than the frequentist point model (paper §V-B)
    if cd.entropy < cf.entropy + CLAIMS_ENTROPY_MARGIN:
        failures.append(
            f"uncertainty-retention claim broke under {shift_name}: cdbfl "
            f"entropy {cd.entropy:.4f} < cffl entropy {cf.entropy:.4f} + "
            f"{CLAIMS_ENTROPY_MARGIN}")
    # overconfidence onset: the shift turns the frequentist model
    # overconfident
    gap_rise = cf.overconf_gap - cf0.overconf_gap
    if gap_rise < CLAIMS_CFFL_GAP_RISE_MIN:
        failures.append(
            f"overconfidence-onset claim broke: cffl gap rose only "
            f"{gap_rise:+.4f} under {shift_name} "
            f"(< {CLAIMS_CFFL_GAP_RISE_MIN}) — Fig. 4's frequentist "
            f"overconfidence signal vanished")
    if not (cd.ece <= cf.ece + CLAIMS_ECE_MARGIN):
        warnings.append(
            f"reduced-scale ECE ordering under {shift_name}: cdbfl ECE "
            f"{cd.ece:.4f} > cffl ECE {cf.ece:.4f} + {CLAIMS_ECE_MARGIN} "
            f"(known DESIGN.md §7/§10 deviation: the cold-posterior BMA "
            f"is underconfident at smoke scale; gated via the entropy and "
            f"overconfidence-onset claims instead)")
    return {
        "cells": cells,
        "failures": failures,
        "warnings": warnings,
        "claims": {
            "shift_scenario": shift_name,
            "shift_severity": shift_sev,
            "cdbfl_shift_ece": cd.ece,
            "cffl_shift_ece": cf.ece,
            "cdbfl_shift_entropy": cd.entropy,
            "cffl_shift_entropy": cf.entropy,
            "cdbfl_shift_gap": cd.overconf_gap,
            "cffl_shift_gap": cf.overconf_gap,
            "cffl_gap_rise": gap_rise,
            "cdbfl_acc_drop": cd0.accuracy - cd.accuracy,
            "cffl_acc_drop": cf0.accuracy - cf.accuracy,
        },
    }


# --------------------------------------------------------------------------
# the drift-recovery gate and the unlearning oracle (matrix.py:356-610)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class DriftRecoverySpec:
    """A continual-training run probed for calibration recovery.

    A step drift of ``severity`` hits at ``onset`` (after the bank holds
    pre-drift samples), training goes on on the drifted pool, and every
    ``probe_every`` rounds the current distribution's held-out cell is
    scored. The pre-drift steady state is the mean ECE of the
    post-burn-in, pre-onset probes; an excursion is the first post-onset
    probe whose ECE leaves the ``pre_ece + recover_eps`` band, and recovery
    the first probe after it back inside. A run whose calibration never
    leaves the band recovers in zero rounds. A run is a function of the
    spec."""
    scenario: str = "day23_critical"
    severity: float = 1.0
    schedule: str = "step"        # step | ramp (the drift-rate knob)
    ramp_rounds: int = 0          # ramp duration; 0 = abrupt step
    rounds: int = 90
    onset: int = 45
    probe_every: int = 5
    refresh_every: int = 5
    burn_in: int = 20
    # bank aging so the moving posterior sheds pre-drift samples: window
    # eviction after `window` rounds and an exponential age discount
    window: int = 25
    decay: float = 0.9
    nodes: int = 5
    per_node: int = 24
    local_steps: int = 8
    minibatch: int = 10
    eta: float = 3e-3
    zeta: float = 0.3
    temperature: float = 0.2
    compressor: str = "topk"
    compress_ratio: float = 0.01
    topology: str = "full"
    eval_examples: int = 200
    eval_batch_size: int = 64
    seed: int = 0
    arch: str = "lenet-radar"
    recover_eps: float = 0.05


#: the claims gate's bound: cdbfl's calibration back within ``recover_eps``
#: of its pre-drift steady state no later than this many rounds after
#: onset (DRIFT_CLAIMS_SPEC scale; the reference records 25 rounds at the
#: claims seed, 40 for the uncompressed dsgld baseline)
DRIFT_RECOVERY_MAX_ROUNDS = 30

DRIFT_CLAIMS_SPEC = DriftRecoverySpec()


def run_drift_recovery(spec: DriftRecoverySpec, algorithm: str = "cdbfl",
                       log=print, device="cuda") -> Dict[str, object]:
    """Train ``algorithm`` through the spec's drift on ``device``; return
    the probe curve and the recovery summary: ``{"algorithm", "probes",
    "pre_ece", "onset", "excursion_round", "recovery_round",
    "rounds_to_recovery"}``. ``excursion_round`` is None when the drift
    never leaves the band (``rounds_to_recovery`` is then 0);
    ``recovery_round`` is None when calibration never comes back (and
    ``rounds_to_recovery`` None). ``rounds_to_recovery`` counts from
    ``onset``."""
    from repro_torch.train import FedTrainer   # the trainer imports eval
    cfg = get_arch(spec.arch).reduced
    model = get_model(cfg)
    train = make_dataset(spec.nodes * spec.per_node, hw=cfg.input_hw,
                         day=1, seed=spec.seed)
    shards = partition_iid(train, spec.nodes, seed=spec.seed)
    cont = ContinualConfig(
        scenario=spec.scenario, schedule=spec.schedule,
        severity=spec.severity, onset=spec.onset,
        ramp_rounds=spec.ramp_rounds, refresh_every=spec.refresh_every,
        window=spec.window, decay=spec.decay, drift_seed=spec.seed)
    fed = FedConfig(
        num_nodes=spec.nodes, local_steps=spec.local_steps, eta=spec.eta,
        zeta=spec.zeta, rounds=spec.rounds, burn_in=spec.burn_in,
        compressor=spec.compressor, compress_ratio=spec.compress_ratio,
        topology=spec.topology, temperature=spec.temperature,
        algorithm=algorithm, seed=spec.seed,
    )
    tr = FedTrainer(model, fed, shards, minibatch=spec.minibatch,
                    seed=spec.seed, eval_batch_size=spec.eval_batch_size,
                    continual=cont, device=device)
    sched = tr._refresher.schedule
    probes: List[Dict[str, float]] = []
    done = 0
    while done < spec.rounds:
        n = min(spec.probe_every, spec.rounds - done)
        tr.run(rounds=n)
        done += n
        now = int(tr.state.round)
        sev = float(sched.severity_at(now - 1))
        ds = make_scenario_dataset(spec.scenario, sev, spec.eval_examples,
                                   hw=cfg.input_hw, seed=spec.seed + 90)
        rep = tr.eval_report(ds)
        probes.append({"round": float(now), "severity": sev,
                       "accuracy": rep.accuracy, "ece": rep.ece,
                       "entropy": rep.entropy})
        if log:
            log(f"  [{algorithm}] round {now:3d} sev={sev:.2f} "
                f"acc={rep.accuracy:.4f} ece={rep.ece:.4f}")
    pre = [p["ece"] for p in probes
           if spec.burn_in < p["round"] <= spec.onset]
    pre_ece = float(np.mean(pre)) if pre else float("nan")
    band = pre_ece + spec.recover_eps
    excursion_round = None
    recovery_round = None
    for p in probes:
        if p["round"] <= spec.onset or p["severity"] == 0.0:
            continue
        if excursion_round is None:
            if p["ece"] > band:
                excursion_round = int(p["round"])
        elif p["ece"] <= band:
            recovery_round = int(p["round"])
            break
    if excursion_round is None:
        rounds_to_recovery = 0        # calibration never left the band
    elif recovery_round is None:
        rounds_to_recovery = None     # left the band and never came back
    else:
        rounds_to_recovery = recovery_round - spec.onset
    return {
        "algorithm": algorithm,
        "probes": probes,
        "pre_ece": pre_ece,
        "onset": spec.onset,
        "excursion_round": excursion_round,
        "recovery_round": recovery_round,
        "rounds_to_recovery": rounds_to_recovery,
    }


def run_drift_claims(spec: DriftRecoverySpec = DRIFT_CLAIMS_SPEC,
                     max_rounds: int = DRIFT_RECOVERY_MAX_ROUNDS,
                     log=print, device="cuda") -> Dict[str, object]:
    """The drift-recovery claims gate: cdbfl must recover calibration
    within ``max_rounds`` of onset; the uncompressed dsgld baseline runs
    beside it, reported and not gated."""
    failures: List[str] = []
    out: Dict[str, object] = {"curves": {}}
    for algorithm in ("cdbfl", "dsgld"):
        res = run_drift_recovery(spec, algorithm=algorithm, log=log,
                                 device=device)
        out["curves"][algorithm] = res
        if algorithm == "cdbfl":
            if res["rounds_to_recovery"] is None:
                failures.append(
                    f"drift-recovery claim broke: cdbfl ECE never returned "
                    f"within {spec.recover_eps} of the pre-drift steady "
                    f"state {res['pre_ece']:.4f} after onset at round "
                    f"{spec.onset}")
            elif res["rounds_to_recovery"] > max_rounds:
                failures.append(
                    f"drift-recovery claim broke: cdbfl took "
                    f"{res['rounds_to_recovery']} rounds to recover "
                    f"calibration (> {max_rounds})")
    out["failures"] = failures
    out["claims"] = {
        "drift_scenario": spec.scenario,
        "drift_severity": spec.severity,
        "drift_onset": spec.onset,
        "cdbfl_pre_ece": out["curves"]["cdbfl"]["pre_ece"],
        "cdbfl_rounds_to_recovery":
            out["curves"]["cdbfl"]["rounds_to_recovery"],
        "dsgld_rounds_to_recovery":
            out["curves"]["dsgld"]["rounds_to_recovery"],
    }
    return out


#: unlearn-against-retrain tolerances (DESIGN.md §15): unlearning drops the
#: node's chain and zeroes its control variates but cannot rewind what its
#: past gossip did to the other chains (the reference records about 0.05
#: accuracy and 0.022 ECE at the oracle's seed)
UNLEARN_ACC_TOL = 0.10
UNLEARN_ECE_TOL = 0.06


def run_unlearn_oracle(spec: MatrixSpec = CLAIMS_SPEC,
                       scenario: str = "clean", severity: float = 0.0,
                       log=print, device="cuda") -> Dict[str, object]:
    """Unlearn the last node and compare with the retrain oracle: cdbfl on
    K nodes, node K-1 unlearned, against a run from scratch on the same
    first K-1 shards with ``num_nodes=K-1``. Every surviving node keeps its
    global id, and with it its draws and shard."""
    from repro_torch.train import FedTrainer   # the trainer imports eval
    cfg = get_arch(spec.arch).reduced
    model = get_model(cfg)
    train = make_dataset(spec.nodes * spec.per_node, hw=cfg.input_hw,
                         day=1, seed=spec.seed)
    shards = partition_iid(train, spec.nodes, seed=spec.seed)
    ds = make_scenario_dataset(scenario, severity, spec.eval_examples,
                               hw=cfg.input_hw, seed=spec.seed + 90)

    def build(num_nodes: int, node_shards):
        fed = FedConfig(
            num_nodes=num_nodes, local_steps=spec.local_steps, eta=spec.eta,
            zeta=spec.zeta, rounds=spec.rounds,
            burn_in=int(spec.rounds * spec.burn_in_frac),
            compressor=spec.compressor, compress_ratio=spec.compress_ratio,
            topology=spec.topology, temperature=spec.temperature,
            algorithm="cdbfl", seed=spec.seed,
        )
        return FedTrainer(model, fed, node_shards, minibatch=spec.minibatch,
                          seed=spec.seed,
                          eval_batch_size=spec.eval_batch_size,
                          device=device)

    target = spec.nodes - 1
    tr = build(spec.nodes, shards)
    tr.run(rounds=spec.rounds)
    tr.unlearn(target)
    rep_unlearn = tr.eval_report(ds)

    oracle = build(spec.nodes - 1, shards[:target])
    oracle.run(rounds=spec.rounds)
    rep_oracle = oracle.eval_report(ds)

    d_acc = abs(rep_unlearn.accuracy - rep_oracle.accuracy)
    d_ece = abs(rep_unlearn.ece - rep_oracle.ece)
    if log:
        log(f"  unlearn(node {target}): acc={rep_unlearn.accuracy:.4f} "
            f"ece={rep_unlearn.ece:.4f} | retrain oracle: "
            f"acc={rep_oracle.accuracy:.4f} ece={rep_oracle.ece:.4f} | "
            f"|Δacc|={d_acc:.4f} |Δece|={d_ece:.4f}")
    return {
        "target": target,
        "unlearn": rep_unlearn,
        "oracle": rep_oracle,
        "delta_accuracy": d_acc,
        "delta_ece": d_ece,
        "within_tolerance": bool(d_acc <= UNLEARN_ACC_TOL
                                 and d_ece <= UNLEARN_ECE_TOL),
    }
