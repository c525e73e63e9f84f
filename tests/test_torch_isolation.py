"""The port stands alone: it imports neither JAX nor the reference package,
and it runs on the card unless the caller asks for the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = _port_modules()
    assert "repro_torch.kernels.pack" in mods and len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(sorted(bad))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_trainer_defaults_to_the_card():
    import torch
    from repro_torch.config import FedConfig, get_arch
    from repro_torch.data.partition import partition_iid
    from repro_torch.data.radar import make_dataset
    from repro_torch.models import get_model
    from repro_torch.train import FedTrainer
    cfg = get_arch("lenet-radar").reduced
    fed = FedConfig(num_nodes=2, local_steps=1, burn_in=0, rounds=1,
                    fused_compress=True)
    shards = partition_iid(make_dataset(8, hw=cfg.input_hw), 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FedTrainer(get_model(cfg), fed, shards, minibatch=2)
    res = FedTrainer(get_model(cfg), fed, shards, minibatch=2,
                     device="cpu").run(eval_batch=make_dataset(5, hw=cfg.input_hw))
    assert res.wire_history == [1056.0] and 0.0 <= res.accuracy <= 1.0


def test_unported_options_name_their_roadmap_item():
    from repro_torch.config import FedConfig
    # transport and participation run since ROADMAP A8 and A7 were ported
    for bad in (dict(continual=object()), dict(qsgd_levels=3),
                dict(control_dtype="float16"),
                dict(compressor="sign_pallas")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            FedConfig(**{"fused_compress": True, **bad}).check_supported()
