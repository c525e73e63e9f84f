"""``examples/quickstart.py`` on the PyTorch port: the reference's program
line for line, ``repro.`` replaced by ``repro_torch.`` and its keys made by
``repro_torch.random``; the tensors on ``device`` (the card in
``chip_smoke.py``, the CPU in ``tests/test_torch_quickstart.py``).

    PYTHONPATH=src python tests/torch_quickstart.py [cpu|cuda]
"""
import sys

import numpy as np
import torch

from repro_torch import random
from repro_torch.config import FedConfig
from repro_torch.core import (init_fed_state, make_compressor, make_cdbfl_round,
                              mixing_matrix)

K, DIM, L = 8, 16, 4


def loss_fn(params, batch, key):
    x, y = batch
    return 0.5 * torch.mean((x @ params["w"] - y) ** 2) * 100, ()


def run(device="cpu", rounds: int = 400, log=print) -> dict:
    """The quickstart's run: ``{"err", "w_std", "w_hat", "dense", "wire",
    "losses", "consensus"}``."""
    # --- problem: K nodes observe y = x·w* + noise ----------------------
    key = random.PRNGKey(0, device)
    w_true = random.normal(key, (DIM,))
    X = random.normal(random.fold_in(key, 1), (K, L, 32, DIM))
    Y = X @ w_true + 0.1 * random.normal(random.fold_in(key, 2), (K, L, 32))

    # --- CD-BFL (paper Algorithm 1) -------------------------------------
    fed = FedConfig(num_nodes=K, local_steps=L, eta=2e-3, zeta=0.3,
                    topology="ring", compressor="block_topk",
                    compress_ratio=0.05, burn_in=150)
    omega = mixing_matrix(fed.topology, K)
    compressor = make_compressor(fed)
    round_fn = make_cdbfl_round(loss_fn, fed, omega, compressor)

    state = init_fed_state({"w": torch.zeros((DIM,), device=device)}, fed)
    posterior, losses, consensus = [], [], []
    for t in range(rounds):
        state, metrics = round_fn(state, (X, Y), random.fold_in(key, t))
        if t >= fed.burn_in and t % 5 == 0:
            posterior.append(state.params["w"].cpu().numpy())
        if (t + 1) % 100 == 0:
            losses.append(float(metrics.loss.mean()))
            consensus.append(float(metrics.consensus_error))
            log(f"round {t+1:3d} loss={losses[-1]:8.4f} "
                f"consensus={consensus[-1]:.2e}")

    # --- posterior summary ----------------------------------------------
    samples = np.concatenate(posterior, axis=0)          # (S*K, DIM)
    w_hat, w_std = samples.mean(0), samples.std(0)
    w_true = w_true.cpu().numpy()
    err = np.linalg.norm(w_hat - w_true) / np.linalg.norm(w_true)
    dense = 4 * DIM * K * (K - 1)
    wire = compressor.wire_bytes({"w": torch.zeros((DIM,))}) * K * (K - 1)
    log(f"posterior mean rel-err: {err:.4f}; posterior std (uncertainty): "
        f"mean {w_std.mean():.4f}; bytes/round: dense {dense} vs "
        f"compressed {wire} ({100 * (1 - wire / dense):.0f}% saved)")
    return {"err": float(err), "w_std": float(w_std.mean()), "w_hat": w_hat,
            "dense": dense, "wire": int(wire), "losses": losses,
            "consensus": consensus}


if __name__ == "__main__":
    out = run(sys.argv[1] if len(sys.argv) > 1 else "cpu")
    assert out["err"] < 0.1, "quickstart should recover w*"
    print("OK")
