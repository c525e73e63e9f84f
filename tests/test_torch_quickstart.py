"""``examples/quickstart.py`` on the port (``tests/torch_quickstart.py``:
the same program, ``repro.`` replaced by ``repro_torch.``) against the
reference's own run of the file: 400 rounds of CD-BFL on K=8 nodes of a
ring, the user's per-node ``loss_fn(params, (X, Y), key)``.

- wire bytes: exact (336 a round against 3,584 dense).
- the posterior mean: within atol 1e-5 of the reference's, and its
  relative error below 0.1 as the example asserts. The local steps'
  gradients differ in their last bits (torch autograd against XLA's
  fused jvp), which the update carries; a codec that chose another
  survivor would move a coordinate by a whole value.
- the printed losses every 100 rounds within rtol 1e-4.
"""
import io
import runpy
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_quickstart

import torch_threads  # noqa: F401  (one torch thread a process)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def reference():
    with redirect_stdout(io.StringIO()) as out:
        ns = runpy.run_path(str(ROOT / "examples" / "quickstart.py"))
    return ns, out.getvalue()


def test_quickstart_matches_reference(reference):
    ns, printed = reference
    got = torch_quickstart.run("cpu", log=lambda *_: None)
    assert got["wire"] == int(ns["wire"]) == 336
    assert got["dense"] == ns["dense"] == 3584
    assert got["err"] < 0.1 and float(ns["err"]) < 0.1
    np.testing.assert_allclose(got["w_hat"], np.asarray(ns["w_hat"]),
                               atol=1e-5)
    want_losses = [float(line.split("loss=")[1].split()[0])
                   for line in printed.splitlines()
                   if line.startswith("round ")]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4)
