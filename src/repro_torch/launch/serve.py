"""Uncertainty-aware serving CLI over ``repro_torch.serve``, classify mode
(``repro/launch/serve.py``).

A thin argparse shim over :class:`repro_torch.config.ServeConfig`: one flag
a field, every behaviour in the engine. Loads the posterior bank snapshots
of ``--ckpt-dir`` (``bank_*.npz``, written by
:func:`repro_torch.checkpoint.save_bank` or the reference's), or makes a
synthetic bank of ``--samples`` models initialized from
``fold_in(PRNGKey(seed), i)``; serves ``--requests`` radar maps through
the :class:`ClassifyEngine` and reports throughput, tail latency and the
abstain rate. With ``--follow-snapshots`` it starts from the oldest
snapshot and hot-swaps through the rest while requests are in flight;
``--poll-s`` also polls for snapshots that land while it runs.

    # the card (the default device): 32 requests, entropy gate at 1.2 nats
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 32 \\
        --entropy-threshold 1.2
    # the CPU, reduced width, with the smoke assertions
    PYTHONPATH=src python -m repro_torch.launch.serve --trim --device cpu \\
        --smoke

Decode mode and the LM archs are ROADMAP A12; ``--mesh > 1`` (the sample
axis over several cards) is A10.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch


def _parse_args(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lenet-radar")
    ap.add_argument("--trim", action="store_true", help="use reduced config")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "classify", "decode"],
                    help="auto: classify for classifier families, decode "
                         "for LM families (decode: ROADMAP A12)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="load the posterior bank snapshots (bank_*.npz); "
                         "no dir -> synthetic bank")
    ap.add_argument("--samples", type=int, default=4,
                    help="synthetic posterior size when no --ckpt-dir")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    # ServeConfig fields, one flag each
    ap.add_argument("--slots", type=int, default=8,
                    help="slot-table width (the captured batch)")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--entropy-threshold", type=float, default=float("inf"),
                    help="abstain (route to a human) above this predictive "
                         "entropy in nats")
    ap.add_argument("--poll-s", type=float, default=0.0,
                    help=">0: poll --ckpt-dir for new bank snapshots "
                         "between steps and hot-swap them in")
    ap.add_argument("--mesh", type=int, default=0,
                    help=">1: shard the sample axis over this many cards "
                         "(ROADMAP A10)")
    ap.add_argument("--ensemble-axis", default="ens")
    ap.add_argument("--follow-snapshots", action="store_true",
                    help="start from the oldest bank snapshot and hot-swap "
                         "through the rest while requests are in flight")
    ap.add_argument("--smoke", action="store_true",
                    help="assert no recapture after warm-up and print the "
                         "response fields")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def synthetic_bank(model, seed: int, samples: int, device):
    """A bank ``(samples, ...)`` of the model's inits from
    ``fold_in(PRNGKey(seed), i)``, standing in for an SGLD chain (the
    reference CLI's bank)."""
    from repro_torch import random
    from repro_torch.utils.tree import tree_map
    key = random.PRNGKey(seed, device)
    inits = [model.init(random.fold_in(key, i), device)
             for i in range(samples)]
    return tree_map(lambda *xs: torch.stack(xs), *inits)


def main(argv: Optional[List[str]] = None):
    """Run the CLI on ``argv`` (``sys.argv`` when None); returns the
    responses in request order."""
    args = _parse_args(argv)
    from repro_torch import random
    from repro_torch.checkpoint import load_bank
    from repro_torch.checkpoint.checkpoint import bank_steps
    from repro_torch.config import ServeConfig, get_arch
    from repro_torch.data.radar import make_dataset
    from repro_torch.models import get_model
    from repro_torch.serve import ClassifyEngine, ServeRequest
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.tree import tree_leaves

    if args.mesh > 1:
        raise NotImplementedError(
            "--mesh > 1 is not ported yet; ROADMAP A10 (multi-GPU shard "
            "engine, place_ensemble)")
    spec = get_arch(args.arch)
    cfg = spec.reduced if args.trim else spec.config
    if args.mode == "decode":
        raise NotImplementedError(
            "--mode decode is not ported yet; ROADMAP A12 (LM model zoo, "
            "DecodeEngine)")
    device = resolve_device(args.device)
    model = get_model(cfg)
    scfg = ServeConfig(
        slots=args.slots, max_len=args.max_len,
        max_new_tokens=args.max_new_tokens, temperature=args.temperature,
        entropy_threshold=args.entropy_threshold,
        hot_swap_poll_s=args.poll_s)

    params0 = model.init(random.PRNGKey(args.seed, device), device)
    steps = bank_steps(args.ckpt_dir) if args.ckpt_dir else []
    if args.ckpt_dir and not steps:
        raise SystemExit(f"no bank_*.npz snapshots in {args.ckpt_dir}")
    if steps:
        first = steps[0] if args.follow_snapshots else steps[-1]
        stacked = load_bank(args.ckpt_dir, step=first, like=params0,
                            device=device)
        pending_steps = [s for s in steps if s > first]
    else:
        stacked = synthetic_bank(model, args.seed, args.samples, device)
        pending_steps = []
    known = set(steps)
    lead = tree_leaves(stacked)[0].dim() - tree_leaves(params0)[0].dim()
    node_axis = 1 if lead == 2 else None        # (S, K, ...) trainer banks

    ds = make_dataset(args.requests, hw=cfg.input_hw, seed=args.seed + 7)
    eng = ClassifyEngine(model.logits, scfg, input_shape=ds["x"].shape[1:],
                         stacked=stacked, node_axis=node_axis)
    reqs = [ServeRequest(x=ds["x"][i]) for i in range(args.requests)]

    # warm-up: one request through the whole path, then the count is frozen
    warm = eng.run([reqs[0]])
    compiles0 = eng.compile_count()

    def maybe_swap():
        if args.poll_s > 0 and args.ckpt_dir:
            new = [s for s in bank_steps(args.ckpt_dir) if s not in known]
            known.update(new)
            pending_steps.extend(new)
        if pending_steps:
            s = pending_steps.pop(0)
            eng.install_bank(load_bank(args.ckpt_dir, step=s, like=params0,
                                       device=device))
            print(f"hot-swap: installed bank_{s:08d} (version "
                  f"{eng.bank_version}, in-flight {eng.pending()})")

    for r in reqs[1:]:
        eng.submit(r)
    t0 = time.perf_counter()
    resps = list(warm)
    last_poll = t0
    while eng.pending():
        resps.extend(eng.step())
        now = time.perf_counter()
        if pending_steps or (args.poll_s > 0
                             and now - last_poll >= args.poll_s):
            maybe_swap()
            last_poll = now
    dt = max(time.perf_counter() - t0, 1e-9)
    resps.sort(key=lambda r: r.request_id)

    for r in resps[:4]:
        print(f"resp id={r.request_id} pred={int(np.argmax(r.probs))} "
              f"entropy={r.entropy:.3f} abstain={r.abstain} "
              f"bank_version={r.bank_version} "
              f"latency_ms={1e3 * r.latency_s:.2f}")
    st = eng.stats()
    served = len(resps)
    recompiles = eng.compile_count() - compiles0
    print(f"serve[classify]: arch={cfg.name} device={device} "
          f"samples={eng.num_samples()} slots={scfg.slots} "
          f"requests={served}")
    print(f"serve: requests_per_s={(served - 1) / dt:.2f} "
          f"p50_ms={st['p50_ms']:.2f} p99_ms={st['p99_ms']:.2f} "
          f"abstain_rate={st['abstain_rate']:.3f} "
          f"entropy_mean={np.mean([r.entropy for r in resps]):.3f} "
          f"compiles={eng.compile_count()} recompiles={recompiles} "
          f"bank_version={eng.bank_version}")
    if args.smoke:
        if recompiles != 0:
            raise AssertionError(f"{recompiles} recaptures after warm-up (the "
                                 f"slot table must hold its shape)")
        if served != args.requests:
            raise AssertionError(f"served {served} of {args.requests}")
        r = resps[0]
        if not (r.probs.ndim == 1 and np.isfinite(r.entropy)
                and isinstance(r.abstain, bool)):
            raise AssertionError(f"malformed response {r}")
        print("SMOKE OK: no recapture after warm-up; response carries "
              "probs/entropy/abstain/latency/bank_version")
    return resps


if __name__ == "__main__":
    main()
