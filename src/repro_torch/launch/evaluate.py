"""Scenario-matrix evaluation CLI of the port (``repro/launch/evaluate.py``).

Produces the scenario × algorithm × pipeline calibration matrix — accuracy,
ECE, NLL, Brier and the overconfidence gap a cell — through the scan eval
engine, from fresh reduced-scale training runs or from a checkpoint, on
one device: the card unless ``--device cpu``. The reference's flags and
output: the markdown table, ``--diagrams``, ``--out`` and ``--json``.

    # the CPU: 60-round runs, two cells
    PYTHONPATH=src python -m repro_torch.launch.evaluate --device cpu \\
        --quick --scenarios clean,day23_critical --severities 1.0

    # the card: the full registry, every severity, with reliability diagrams
    PYTHONPATH=src python -m repro_torch.launch.evaluate --scenarios all \\
        --severities 0.25,0.5,1.0 --diagrams --out matrix.md

    # score a checkpoint (point estimate) across the registry
    PYTHONPATH=src python -m repro_torch.launch.evaluate --ckpt ckpts/ \\
        --scenarios all
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

DEFAULT_SCENARIOS = ("clean", "gain_drift", "clutter_ramp", "doa_miscal",
                     "snr_degradation", "room_geometry", "node_hetero")


def _parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="lenet-radar")
    ap.add_argument("--algorithms", default="cdbfl,cffl",
                    help="comma list from {cdbfl,dsgld,cffl}")
    ap.add_argument("--pipelines", default="",
                    help="comma list of codec DSL pipelines ('' = the "
                         "configured --compressor)")
    ap.add_argument("--compressor", default="block_topk")
    ap.add_argument("--ratio", type=float, default=0.01)
    ap.add_argument("--scenarios", default=",".join(DEFAULT_SCENARIOS),
                    help="comma list of shift families, or 'all'")
    ap.add_argument("--severities", default="0.5,1.0",
                    help="comma list of severity scalars in [0,1]")
    ap.add_argument("--nodes", type=int, default=5)
    ap.add_argument("--per-node", type=int, default=24)
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--eval-examples", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir: score its params (point "
                         "estimate) instead of training")
    ap.add_argument("--quick", action="store_true",
                    help="60-round training runs (CI/laptop scale)")
    ap.add_argument("--diagrams", action="store_true",
                    help="print ASCII reliability diagrams per cell")
    ap.add_argument("--out", default=None, help="write markdown report here")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the raw cell rows as JSON here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the kernels' plain "
                         "versions)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Run the CLI on ``argv`` (``sys.argv`` when None); returns the
    matrix's cells."""
    args = _parse_args(argv)
    from repro_torch.core.calibration import render_reliability
    from repro_torch.data.scenarios import list_scenarios
    from repro_torch.eval.matrix import (MatrixSpec, evaluate_params_matrix,
                                         matrix_markdown, run_matrix)
    from repro_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    names = (list_scenarios() if args.scenarios == "all"
             else [s for s in args.scenarios.split(",") if s])
    sevs = [float(s) for s in args.severities.split(",") if s]
    # clean is severity-independent: evaluate it once
    cells = [(n, s) for n in names for s in
             (sevs if n != "clean" else sevs[:1])]

    if args.ckpt:
        from repro_torch.checkpoint import load_checkpoint_tree
        params = load_checkpoint_tree(args.ckpt, device=device)
        out = evaluate_params_matrix(params, args.arch, cells,
                                     eval_examples=args.eval_examples,
                                     seed=args.seed)
    else:
        spec = MatrixSpec(
            algorithms=tuple(a for a in args.algorithms.split(",") if a),
            pipelines=tuple(args.pipelines.split(",")),
            cells=tuple(cells),
            nodes=args.nodes, per_node=args.per_node,
            rounds=60 if args.quick else args.rounds,
            compressor=args.compressor, compress_ratio=args.ratio,
            eval_examples=args.eval_examples, seed=args.seed,
            arch=args.arch,
        )
        out = run_matrix(spec, device=device)

    md = matrix_markdown(out)
    print()
    print(md)
    if args.diagrams:
        for c in out:
            print()
            print(render_reliability(
                c.report.bins,
                f"{c.algorithm}|{c.pipeline or '-'} "
                f"{c.scenario}@{c.severity:g}"))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write("# Scenario-matrix calibration report\n\n" + md + "\n")
        print(f"\nwrote {args.out}")
    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump([c.row() for c in out], f, indent=1)
        print(f"wrote {args.json_out}")
    return out


if __name__ == "__main__":
    main()
