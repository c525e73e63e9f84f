"""Control variates in float16 (``FedConfig.control_dtype="float16"``,
ROADMAP A3, C32) against the reference on the CPU.

XLA's CPU code keeps each f16 add of Eqs. 7–8 (``v + Δ.astype(f16)``) a
fusion of its own with an f16 output, and Eq. 9's fusion widens those
stored sums (ROADMAP C32): where bf16 control variates read the f32 sums
(C23), f16 ones read the rounded sums. The port's f16 forms round first and
read the rounded values.

- Eqs. 7–9 alone: ``fused_update_control`` and ``cffl_update_control`` on
  f16 operands (their plain versions on the CPU) against the reference's
  expressions under ``jax.jit``, bit for bit, on values that take in f16
  subnormals, ±0, sums that round and deltas beyond f16's range.
- Rounds as ``test_torch_control_dtype.py`` holds bf16: cdbfl (two-pass
  and, at η = 0, fused codec) and cffl on the reduced LeNet, K=4 on a ring, each
  round handed the reference's minibatches and key. At η = 0 params, v and
  v̄ are bit for bit over three rounds. At η = 3e-3 the local steps differ
  in their last bits (as in the bf16 test): v and v̄ within one f16 ulp of
  the reference's, params within rtol 1e-4 / atol 1e-6 plus ζ times those
  ulps for each round so far.
- ``FedTrainer`` with f16 control variates, scan = host bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig, get_arch as jax_get_arch
from repro.core import (build_topology, init_fed_state, make_compressor,
                        resolve_topology)
from repro.core.algorithms import make_round_fn
from repro.data.partition import DeviceShards as JaxDeviceShards
from repro.data.partition import partition_iid
from repro.data.radar import make_dataset
from repro.models import get_model as jax_get_model
from repro.train.engine import round_data_key
from repro_torch.config import FedConfig, get_arch
from repro_torch.core import algorithms as port_alg
from repro_torch.core import fed_state as port_state
from repro_torch.core.compression import make_compressor as port_compressor
from repro_torch.data.partition import DeviceShards
from repro_torch.kernels.fused_update import (cffl_update_control,
                                              cffl_update_plain, fma_f32,
                                              fused_update_control)
from repro_torch.kernels.fused_compress import delta_pack
from repro_torch.kernels.pack import topk_select
from repro_torch.models import get_model
from repro_torch.models.lenet import params_from_jax
from repro_torch.train import FedTrainer
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

import torch_threads  # noqa: F401  (one torch thread a process)

K, L, M = 4, 2, 5
RTOL, ATOL = 1e-4, 1e-6
ROUNDS = [("cdbfl", False, 0.0, 0.5, True), ("cdbfl", True, 0.0, 0.5, True),
          ("cffl", False, 0.0, 0.5, True), ("cdbfl", False, 3e-3, 0.01, False),
          ("cffl", False, 3e-3, 0.01, False)]


def _key(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def control_inputs(n: int = 4096, seed: int = 0):
    """θ, v̄, v (f16), Δv̄, Δv, ξ: normals at several scales, with f16
    subnormals, ±0 and deltas beyond f16's range (±inf once rounded)."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.integers(-9, 3, size=(6, n))
    th, vb, v, dvb, dv, xi = (rng.standard_normal((6, n)) * scale
                              ).astype(np.float32)
    vb, v = vb.astype(np.float16), v.astype(np.float16)
    sub = np.float16(2.0 ** -24) * rng.integers(-1023, 1024, size=n // 8)
    vb[: n // 8] = sub
    v[n // 8: n // 4] = sub
    dvb[n // 4: n // 4 + 64] = np.float32(2.0 ** -25) * rng.integers(
        -5, 6, size=64)
    v[-8:] = np.float16(-0.0)
    dv[-8:] = np.float32(-0.0)
    dvb[-12:-8] = np.float32([7e4, -7e4, 65519.0, 65520.0])
    return th, vb, v, dvb, dv, xi


def _jax_update(th, vb, v, dvb, dv, xi, zeta, cffl):
    """The reference round's Eqs. 7–9 (``algorithms.py:406-422``) on one
    leaf, under ``jit``."""
    def fn(th, vb, v, dvb, dv, xi):
        v_new = v + dv.astype(v.dtype)
        vb_new = vb + dvb.astype(vb.dtype)
        upd = th.astype(jnp.float32) + zeta * (
            vb_new.astype(jnp.float32) - v_new.astype(jnp.float32))
        return (upd if cffl else upd + xi).astype(th.dtype), vb_new, v_new
    return jax.jit(fn)(th, vb, v, dvb, dv, xi)


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    return _bits(t.numpy())


@pytest.mark.parametrize("cffl", [False, True])
def test_f16_update_forms_are_the_jitted_reference(cffl):
    th, vb, v, dvb, dv, xi = control_inputs()
    zeta = 0.3
    want = _jax_update(th, vb, v, dvb, dv, xi, zeta, cffl)
    args = [torch.from_numpy(a) for a in (th, vb, v, dvb, dv)]
    if cffl:
        got = cffl_update_control(*args, zeta)
    else:
        got = fused_update_control(*args, torch.from_numpy(xi), zeta, 1.0)
    for g, w, name in zip(got, want, ("theta", "v_bar", "v")):
        assert g.dtype == (torch.float32 if name == "theta"
                           else torch.float16)
        assert np.array_equal(_torch_bits(g), _bits(w)), name
    # reading the f32 sums (the bf16 rule, C23) is another result here
    svb = args[1].float() + args[3].half().float()
    sv = args[2].float() + args[4].half().float()
    f32_read = cffl_update_plain(args[0], svb, sv, zeta)
    if not cffl:
        f32_read = fma_f32(1.0, torch.from_numpy(xi), f32_read)
    assert not np.array_equal(_torch_bits(f32_read), _bits(want[0]))


def test_f16_codec_forms_read_v_exactly():
    """``delta_pack`` and ``topk_select`` of θ − v with v in f16 (their
    plain versions here) equal the f32 forms on the widened v."""
    th, _, v, *_ = control_inputs(2 * 2048, seed=3)
    th = torch.from_numpy(th.reshape(2, -1))
    v16 = torch.from_numpy(v.reshape(2, -1))
    for got, want in zip(delta_pack([th], [v16], 7),
                         delta_pack([th], [v16.float()], 7)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = topk_select([th], [9], [v16])[0]
    want = topk_select([th], [9], [v16.float()])[0]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _fed(algorithm, fused, eta, ratio):
    return dict(num_nodes=K, local_steps=L, eta=eta, zeta=0.3,
                temperature=0.2, burn_in=2, rounds=3, topology="ring",
                control_dtype="float16", algorithm=algorithm,
                fused_compress=fused, compress_ratio=ratio)


@pytest.mark.parametrize("algorithm,fused,eta,ratio,exact", ROUNDS)
def test_f16_rounds_against_reference(algorithm, fused, eta, ratio, exact):
    fed = _fed(algorithm, fused, eta, ratio)
    jfed = JaxFedConfig(**fed)
    model = jax_get_model(jax_get_arch("lenet-radar").reduced)
    shards = partition_iid(make_dataset(K * 20, hw=(32, 16), seed=0), K)
    jshards = JaxDeviceShards.from_shards(shards)
    data_scale = float(np.mean([len(s["y"]) for s in shards]))
    key = jax.random.PRNGKey(0)
    params0 = model.init(key)
    jstate = init_fed_state(params0, jfed, key=key)
    omega = build_topology(resolve_topology(jfed), K).omega
    jround = jax.jit(make_round_fn(algorithm, model.loss, jfed, omega,
                                   make_compressor(jfed), data_scale))
    pfed = FedConfig(**fed)
    pround = port_alg.make_round_fn(
        algorithm, get_model(get_arch("lenet-radar").reduced).nll, pfed,
        omega, port_compressor(pfed), data_scale, "cpu")
    pshards = DeviceShards.from_shards(shards, "cpu")
    state = port_state.init_fed_state(
        params_from_jax(jax.tree.map(np.asarray, params0)), pfed)
    key = jax.random.PRNGKey(1)
    for r in range(3):
        key, kround = jax.random.split(key)
        idx = jshards.sample_indices(round_data_key(kround), L, M)
        jstate, jm = jround(jstate, jshards.gather(idx), kround)
        state, pm = pround(state, pshards.gather(np.asarray(idx)),
                           _key(kround))
        assert float(pm.wire_bytes) == float(jm.wire_bytes)
        # where the port's v or v̄ is one f16 ulp off the reference's (the
        # local steps differ in their last bits), Eq. 9 moves θ by ζ times
        # that ulp, once a round it lasts
        spread = [(r + 1) * 0.3 * (np.spacing(np.abs(np.asarray(a, np.float16)))
                                   + np.spacing(np.abs(np.asarray(b, np.float16)))
                                   ).astype(np.float32)
                  for a, b in zip(jax.tree.leaves(jstate.v),
                                  jax.tree.leaves(jstate.v_bar))]
        for name in ("params", "v", "v_bar"):
            for i, ((path, g), w) in enumerate(zip(
                    tree_leaves_with_path(getattr(state, name)),
                    jax.tree.leaves(getattr(jstate, name)))):
                want_dtype = np.float32 if name == "params" else np.float16
                assert g.numpy().dtype == want_dtype == np.asarray(w).dtype
                w32 = np.asarray(w, np.float32)
                err = np.abs(g.numpy().astype(np.float32) - w32)
                if exact:
                    assert np.array_equal(_torch_bits(g), _bits(w)), \
                        f"round {r} {name}.{path}"
                elif name == "params":
                    assert np.all(err <= RTOL * np.abs(w32) + ATOL
                                  + spread[i]), f"round {r} {name}.{path}"
                else:
                    ulp = np.spacing(np.abs(np.asarray(w, np.float16)))
                    assert np.all(err <= ulp.astype(np.float32)), \
                        f"round {r} {name}.{path}"


@pytest.mark.parametrize("algorithm", ["cdbfl", "cffl"])
def test_f16_trainer_scan_equals_host(algorithm):
    cfg = get_arch("lenet-radar").reduced
    fed = FedConfig(num_nodes=3, local_steps=2, burn_in=1, rounds=3,
                    control_dtype="float16", algorithm=algorithm)
    shards = partition_iid(make_dataset(24, hw=cfg.input_hw, seed=0), 3)
    states = []
    for engine in ("host", "scan"):
        tr = FedTrainer(get_model(cfg), fed, shards, minibatch=4,
                        engine=engine, chunk=2, device="cpu")
        tr.run(rounds=3)
        states.append(tr.state)
    for name in ("params", "v", "v_bar"):
        for a, b in zip(tree_leaves(getattr(states[0], name)),
                        tree_leaves(getattr(states[1], name))):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert tree_leaves(states[0].v)[0].dtype == torch.float16
