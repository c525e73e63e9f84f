"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skipped, with the reason, on a host without a CUDA device.
On a card host: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.block_topk import block_topk_plain
from repro_torch.kernels.fused_compress import (carrier_norms_plain,
                                                delta_pack_plain,
                                                grid_quant_plain)
from repro_torch.kernels.fused_update import (cffl_update_control_plain,
                                              cffl_update_plain,
                                              dsgld_update_plain,
                                              fused_update_control_plain,
                                              fused_update_plain)
from repro_torch.kernels.pack import (pack_topk_plain, topk_select_plain,
                                      unpack_set_plain, unpack_topk_plain)
from repro_torch.kernels.qsgd import (inv_one_plus, qsgd_omega, qsgd_plain,
                                      row_norm)
from torch_golden import boundary_blocks

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _same_bits(a, b):
    view = {torch.float32: torch.int32, torch.uint16: torch.int16,
            torch.int8: torch.int8, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}[a.dtype]
    return a.shape == b.shape and torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("n", [6, 150, 1024, 4097, 21000])
def test_kernels_match_plain_versions(card, n):
    gen = torch.Generator(device=card).manual_seed(n)
    theta = torch.randn((4, n), generator=gen, device=card)
    v = torch.randn((4, n), generator=gen, device=card) * 0.1
    kernels.reset_launch_counts()
    vals, idx = kernels.pack_topk([theta], 11)[0]
    want = pack_topk_plain(theta, 11)
    assert _same_bits(vals, want[0]) and _same_bits(idx, want[1])
    dvals, didx = kernels.delta_pack([theta], [v], 11)[0]
    dwant = delta_pack_plain(theta, v, 11)
    assert _same_bits(dvals, dwant[0]) and _same_bits(didx, dwant[1])
    dense, = kernels.unpack_topk([(dvals, didx)], [n])
    assert _same_bits(dense, unpack_topk_plain(dvals, didx, n))
    xi = torch.randn((4, n), generator=gen, device=card)
    out = kernels.fused_update(theta, v * 0.5, v, xi, 0.03, 1.0)
    assert _same_bits(out, fused_update_plain(theta, v * 0.5, v, xi, 0.03, 1.0))
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        "pack": 1, "delta_pack": 1, "unpack": 1, "fused_update": 1,
        "grid_quant": 0, "qsgd": 0, "block_topk": 0, "threefry": 0,
        "topk_select": 0, "unpack_set": 0, "cffl_update": 0,
        "dsgld_update": 0, "gossip_mix": 0, "gilbert_keep": 0,
        "topk_select_bf16": 0, "delta_pack_bf16": 0,
        "fused_update_bf16": 0, "cffl_update_bf16": 0,
        "topk_select_f16": 0, "delta_pack_f16": 0,
        "fused_update_f16": 0, "cffl_update_f16": 0,
        "decode_attention": 0, "bma_sample": 0}


@pytest.mark.parametrize("n", [6, 150, 1024, 4097, 21000])
def test_qsgd_and_dense_kernels_match_plain_versions(card, n):
    """block_topk, qsgd and grid_quant (on the packed carrier), with -0.0
    entries in the leaf; bit-exact."""
    gen = torch.Generator(device=card).manual_seed(100 + n)
    x = torch.randn((4, n), generator=gen, device=card)
    x[:, ::5] = -0.0
    u = torch.rand((4, n), generator=gen, device=card)
    norm = row_norm(x)
    recip = inv_one_plus(qsgd_omega(n, 16))
    kernels.reset_launch_counts()
    assert _same_bits(kernels.block_topk(x, 11), block_topk_plain(x, 11))
    assert _same_bits(kernels.qsgd([x], [u], [norm], 16, [recip])[0],
                      qsgd_plain(x, u, norm, 16, recip))
    carrier = kernels.pack_topk([x], 11)[0][0].reshape(4, -1)
    uc = torch.rand(carrier.shape, generator=gen, device=card)
    (grid,), (nc,) = kernels.grid_quant_leaves([carrier], [uc], 16)
    assert _same_bits(nc, carrier_norms_plain(carrier))
    assert _same_bits(grid, grid_quant_plain(carrier, uc, nc, 16))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["block_topk"], counts["qsgd"], counts["grid_quant"]) == \
        (1, 1, 1)


def test_ties_and_zeros(card):
    ties = torch.randint(-3, 4, (3, 5000), device=card).float()
    for x in (ties, torch.zeros_like(ties)):
        vals, idx = kernels.pack_topk([x], 11)[0]
        want = pack_topk_plain(x, 11)
        assert _same_bits(vals, want[0]) and _same_bits(idx, want[1])
        assert _same_bits(kernels.block_topk(x, 11), block_topk_plain(x, 11))
        u = torch.rand(x.shape, device=card)
        norm = row_norm(x)      # eps alone for the all-zero leaf
        assert _same_bits(kernels.qsgd([x], [u], [norm], 16, [0.5])[0],
                          qsgd_plain(x, u, norm, 16, 0.5))


def test_misaligned_fused_update(card):
    """The float4 path needs 16-byte alignment; offset views take the
    scalar path and must agree too."""
    base = torch.randn((5, 1001), device=card)
    a, b, c, d = (base[i, 1:].contiguous()[1:] for i in range(4))
    out = kernels.fused_update(a, b, c, d, 0.03, 0.5)
    assert _same_bits(out, fused_update_plain(a, b, c, d, 0.03, 0.5))
    np.testing.assert_array_equal(out.isfinite().cpu().numpy(), True)


def _nonfinite(card, kind):
    """(3, 4097) leaves with NaN or ±inf blocks (ROADMAP C6's cases)."""
    x = torch.randn((3, 4097), generator=torch.Generator(device=card)
                    .manual_seed(7), device=card)
    if kind == "nan":
        x[0, 5] = float("nan")
        x[0, 1024:2048] = float("nan")
        x[0, 1030:1080:10] = 1.5
        x[1, 2048::3] = float("nan")
        x[2, 100], x[2, 200] = float("nan"), float("inf")
    else:
        x[0, 77] = -float("inf")
        x[0, 1027:1030] = float("inf")
        x[1, 2048:3072:50] = float("inf")
        x[1, 4096] = -float("inf")
        x[2, 3072:4096] = -float("inf")
    return x


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_nonfinite_blocks_match_plain_versions(card, kind):
    """pack, delta-pack, unpack and block_topk on NaN and ±inf blocks, bit
    for bit (the plain versions follow the reference, ROADMAP C6)."""
    x = _nonfinite(card, kind)
    v = torch.full_like(x, 0.125)
    v[2, 3072] = float("inf")                        # inf - inf = NaN
    vals, idx = kernels.pack_topk([x], 11)[0]
    want = pack_topk_plain(x, 11)
    assert _same_bits(vals, want[0]) and _same_bits(idx, want[1])
    dvals, didx = kernels.delta_pack([x], [v], 11)[0]
    dwant = delta_pack_plain(x, v, 11)
    assert _same_bits(dvals, dwant[0]) and _same_bits(didx, dwant[1])
    for p in ((vals, idx), (dvals, didx)):
        assert _same_bits(kernels.unpack_topk([p], [4097])[0],
                          unpack_topk_plain(*p, 4097))
    assert _same_bits(kernels.block_topk(x, 11), block_topk_plain(x, 11))


def test_table_launch_matches_per_leaf_plain_versions(card):
    """One launch packs a table of mixed leaves (short, ragged, full-block,
    NaN and ±inf), each leaf's payload a contiguous view of one allocation;
    a list longer than a table takes one launch a table."""
    gen = torch.Generator(device=card).manual_seed(3)
    xs = [torch.randn((3, n), generator=gen, device=card)
          for n in (6, 150, 1024, 4097, 21000)]
    xs += [_nonfinite(card, "nan"), _nonfinite(card, "inf")]
    vs = [x * 0.5 for x in xs]
    kernels.reset_launch_counts()
    packed = kernels.pack_topk(xs, 11)
    dpacked = kernels.delta_pack(xs, vs, 11)
    assert kernels.launch_counts()["pack"] == 1
    assert kernels.launch_counts()["delta_pack"] == 1
    for x, v, (vals, idx), (dvals, didx) in zip(xs, vs, packed, dpacked):
        want, dwant = pack_topk_plain(x, 11), delta_pack_plain(x, v, 11)
        assert vals.is_contiguous() and didx.is_contiguous()
        assert _same_bits(vals, want[0]) and _same_bits(idx, want[1])
        assert _same_bits(dvals, dwant[0]) and _same_bits(didx, dwant[1])
        # aligned as an allocation of its own, so torch reduces it alike
        assert _same_bits(row_norm(dvals.reshape(3, -1)),
                          row_norm(dvals.clone().reshape(3, -1)))
    many = [torch.randn((2, 100 + i), generator=gen, device=card)
            for i in range(40)]
    for x, (vals, idx) in zip(many, kernels.pack_topk(many, 7)):
        want = pack_topk_plain(x, 7)
        assert _same_bits(vals, want[0]) and _same_bits(idx, want[1])
    torch.cuda.synchronize()
    assert kernels.launch_counts()["pack"] == 3


def test_unpack_and_qsgd_tables_match_plain_versions(card):
    """One launch unpacks a table of mixed payloads (short, ragged,
    full-block, NaN, ±inf and -0.0 leaves: float4 and scalar fills mixed)
    and one quantizes a table of mixed leaves (a zero-size leaf left out),
    each leaf against its plain version; a list longer than a table takes
    one launch a table."""
    gen = torch.Generator(device=card).manual_seed(4)
    xs = [torch.randn((3, n), generator=gen, device=card)
          for n in (6, 150, 1024, 4097, 21000)]
    signed = torch.randn((3, 4097), generator=gen, device=card)
    signed[:, ::3] = -0.0
    xs += [signed, _nonfinite(card, "nan"), _nonfinite(card, "inf")]
    payloads = kernels.delta_pack(xs, [x * 0.5 for x in xs], 11)
    ns = [x.shape[1] for x in xs]
    kernels.reset_launch_counts()
    dense = kernels.unpack_topk(payloads, ns)
    assert kernels.launch_counts()["unpack"] == 1
    for (vals, idx), n, d in zip(payloads, ns, dense):
        assert _same_bits(d, unpack_topk_plain(vals, idx, n))
        assert d.data_ptr() % 512 == 0
    finite = xs[:6] + [torch.empty((3, 0), device=card)]
    us = [torch.rand(x.shape, generator=gen, device=card) for x in finite]
    norms = [row_norm(x) for x in finite]
    recips = [inv_one_plus(qsgd_omega(max(x.shape[1], 1), 16)) for x in finite]
    out = kernels.qsgd(finite, us, norms, 16, recips)
    assert kernels.launch_counts()["qsgd"] == 1
    for x, u, norm, r, q in zip(finite, us, norms, recips, out):
        assert _same_bits(q, qsgd_plain(x, u, norm, 16, r))
    many = [torch.randn((2, 100 + 4 * i), generator=gen, device=card)
            for i in range(40)]
    mpay = kernels.pack_topk(many, 7)
    mns = [x.shape[1] for x in many]
    mus = [torch.rand(x.shape, generator=gen, device=card) for x in many]
    mnorms = [row_norm(x) for x in many]
    kernels.reset_launch_counts()
    for (vals, idx), n, d in zip(mpay, mns, kernels.unpack_topk(mpay, mns)):
        assert _same_bits(d, unpack_topk_plain(vals, idx, n))
    for x, u, norm, q in zip(many, mus, mnorms, kernels.qsgd(
            many, mus, mnorms, 4, [0.5] * len(many))):
        assert _same_bits(q, qsgd_plain(x, u, norm, 4, 0.5))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["unpack"], counts["qsgd"]) == (2, 2)


def _misaligned(x, offset):
    """``x`` copied into a contiguous view ``offset`` floats into a buffer:
    its rows start off the 16-byte grid."""
    buf = torch.empty(x.numel() + offset, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def test_grid_quant_table_matches_plain_versions(card):
    """One grid_quant launch over a table of carriers (an all-zero one,
    ties, -0.0 entries, one-block leaves, misaligned views, fc1.w's
    full-width (10, 27687) carrier, and a row too long for registers, read
    twice): grids and norms bit for bit against carrier_norms_plain and
    grid_quant_plain; a list longer than a table takes one launch a
    table."""
    from repro_torch.kernels.fused_compress import grid_quant_leaves
    gen = torch.Generator(device=card).manual_seed(5)

    def normal(rows, m):
        return torch.randn((rows, m), generator=gen, device=card)

    ties = torch.randint(-3, 4, (10, 5000), generator=gen,
                         device=card).float()
    signed = normal(10, 4097)
    signed[:, ::3] = -0.0
    xs = [normal(10, 27687), torch.zeros((10, 3000), device=card), ties,
          signed, normal(10, 11), normal(10, 1), normal(10, 253),
          _misaligned(normal(10, 1001), 1), _misaligned(normal(10, 6), 3),
          normal(10, 40000) * 1e-3]
    us = [torch.rand(x.shape, generator=gen, device=card) for x in xs]
    us[7] = _misaligned(us[7], 2)
    kernels.reset_launch_counts()
    grids, norms = grid_quant_leaves(xs, us, 16)
    assert kernels.launch_counts()["grid_quant"] == 1
    for x, u, g, n in zip(xs, us, grids, norms):
        assert _same_bits(n, carrier_norms_plain(x))
        assert _same_bits(g, grid_quant_plain(x, u, n, 16))
        assert g.data_ptr() % 128 == 0
    assert _same_bits(norms[1], torch.full((10,), 1e-12, device=card))
    many = [normal(3, 11 * (1 + i)) for i in range(40)]
    mus = [torch.rand(x.shape, generator=gen, device=card) for x in many]
    grids, norms = grid_quant_leaves(many, mus, 4)
    for x, u, g, n in zip(many, mus, grids, norms):
        assert _same_bits(n, carrier_norms_plain(x))
        assert _same_bits(g, grid_quant_plain(x, u, n, 4))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["grid_quant"] == 3


def _repeated_payloads(card, k):
    """(2, 8, k) payloads whose first block repeats indices (ROADMAP C7):
    pairs, order-sensitive triples (1e8, 1, -1e8), -0.0 beside +0.0, an
    inf beside a finite value in the second row; inf beside inf and inf
    beside -inf in blocks of their own; k > 32 across chunks."""
    gen = torch.Generator().manual_seed(k)
    idx = torch.stack([torch.randperm(1024, generator=gen)[:k]
                       for _ in range(16)]).reshape(2, 8, k)
    vals = torch.randn((2, 8, k), generator=gen)
    inf = float("inf")
    groups = [(0, 0, (0, 1, 2), (1e8, 1.0, -1e8)),
              (0, 0, (3, k - 1), (1.5, 2.25)), (0, 0, (4, 5), (-0.0, 0.0)),
              (1, 0, (1, k - 2), (inf, 2.0)), (1, 2, (2, k - 1), (inf, inf)),
              (1, 4, (0, 7), (inf, -inf))]
    if k > 32:
        groups += [(0, 3, (6, 31, 32, k - 1), (1e8, 1.0, -1e8, 1.0)),
                   (1, 5, (3, 35), (inf, inf))]
    for row, block, slots, slot_vals in groups:
        vals[row, block, list(slots)] = torch.tensor(slot_vals)
        idx[row, block, list(slots)] = int(idx[row, block, slots[0]])
    return (vals.to(card), idx.to(torch.int32).to(torch.int16)
            .view(torch.uint16).to(card))


@pytest.mark.parametrize("k", [11, 32, 40, 1024])
def test_unpack_of_repeated_indices_matches_plain_version(card, k):
    """Values that share an index add up from +0.0 in slot order, in the
    kernel (one launch over the table) as in the plain version."""
    payloads = [_repeated_payloads(card, k), _repeated_payloads(card, k)]
    payloads[1][0][:, 1:] = 0.5                 # repeats in one block only
    ns = [8 * 1024, 8 * 1024 - 100]
    kernels.reset_launch_counts()
    dense = kernels.unpack_topk(payloads, ns)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["unpack"] == 1
    for (vals, idx), n, d in zip(payloads, ns, dense):
        assert _same_bits(d, unpack_topk_plain(vals, idx, n))
    vals, idx = payloads[0]
    assert float(dense[0][0, int(idx[0, 0, 0].view(torch.int16))]) == 0.0


@pytest.mark.parametrize("overrides,once", [
    (dict(compressor="block_topk", fused_compress=True),
     ("delta_pack", "unpack")),
    (dict(pipeline="block_topk|qsgd", fused_compress=True),
     ("delta_pack", "grid_quant", "unpack")),
    (dict(compressor="qsgd_pallas"), ("qsgd",)),
    (dict(), ("topk_select", "unpack_set")),
    (dict(pipeline="block_topk|qsgd"), ("topk_select", "grid_quant",
                                        "unpack_set")),
    (dict(compressor="qsgd"), ("grid_quant",)),
    (dict(algorithm="cffl"), ("topk_select", "unpack_set"))])
def test_a_round_launches_its_table_kernels_once(card, overrides, once):
    """One reduced round of each configuration: delta-pack and unpack (the
    fused rounds), grid_quant (the block_topk|qsgd round) and qsgd (the
    legacy dense round) launch once over the table of the model's
    leaves."""
    from repro_torch.config import FedConfig, get_arch
    from repro_torch.data.partition import partition_iid
    from repro_torch.data.radar import make_dataset
    from repro_torch.models import get_model
    from repro_torch.train import FedTrainer
    cfg = get_arch("lenet-radar").reduced
    fed = FedConfig(num_nodes=3, local_steps=2, eta=1e-3, zeta=0.3,
                    temperature=0.2, burn_in=0, rounds=1, topology="full",
                    **overrides)
    data = make_dataset(30, hw=cfg.input_hw, day=1, seed=0)
    trainer = FedTrainer(get_model(cfg), fed, partition_iid(data, 3),
                         minibatch=5, engine="host", device=card)
    kernels.reset_launch_counts()
    trainer.run(rounds=1)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert {name: counts[name] for name in once} == dict.fromkeys(once, 1)


def _every_draw(keys, n):
    """One draw of every transform over the rows of ``keys``, ``n``
    elements a row, as one program: one table launch on the card."""
    from repro_torch import random
    return random.together(
        random.split.program(keys, 8),
        random.fold_in.program(keys, 2**32 - 1),
        random.fold_in.program(keys, torch.tensor(2**31 - 1,
                                                  dtype=torch.int32,
                                                  device=keys.device)),
        random.split_fold_in.program(keys, 8, 1),
        random.bits.program(keys, (n,)),
        random.uniform.program(keys, (n,)),
        random.uniform.program(keys, (n,), -3.5, 11.25),
        random.normal.program(keys, (n,), scale=0.0346410162),
        random.truncated_normal.program(keys, -2.0, 2.0, (n,), scale=0.07))


@pytest.mark.parametrize("n", [1, 7, 1023, 4099, 1_000_003])
def test_threefry_table_matches_plain_version(card, n):
    """Every transform, one table launch, bit-exact to the plain version
    on the CPU: keys of a (3, 5, 2) tensor read through a strided view."""
    from repro_torch import random
    keys = random.split(random.PRNGKey(n, card), 15).view(3, 5, 2)[:, 2]
    kernels.reset_launch_counts()
    got = random.run(_every_draw(keys, n))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["threefry"] == 1
    want = random.run(_every_draw(keys.cpu(), n))
    for g, w in zip(got, want):
        g = g.cpu()
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


def test_threefry_reproduces_the_golden_file(card):
    """``tests/golden/threefry_draws.npz``, made from JAX, on the card."""
    import json
    from torch_golden import THREEFRY_FILE, port_draw
    stored = np.load(THREEFRY_FILE)
    for name, fn, seed, args in json.loads(str(stored["cases"])):
        got = port_draw(fn, seed, args, card).cpu().numpy()
        want = stored[name]
        if want.dtype == np.float32:
            got, want = got.view(np.int32), want.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_seeded_round_on_the_card_draws_what_the_cpu_draws(card):
    """A seeded reduced trainer: the card's init equals the CPU's bit for
    bit, a round's draws take at most 6 threefry launches, and one round
    tracks the CPU's (rtol 1e-4: cuDNN sums in another order)."""
    from repro_torch.config import FedConfig, get_arch
    from repro_torch.data.partition import partition_iid
    from repro_torch.data.radar import make_dataset
    from repro_torch.models import get_model
    from repro_torch.train import FedTrainer
    cfg = get_arch("lenet-radar").reduced
    fed = FedConfig(num_nodes=3, local_steps=2, eta=1e-3, zeta=0.3,
                    temperature=0.2, burn_in=0, rounds=1, topology="full",
                    pipeline="block_topk|qsgd", fused_compress=True)
    shards = partition_iid(make_dataset(30, hw=cfg.input_hw, day=1, seed=0),
                           3)
    runs = {dev: FedTrainer(get_model(cfg), fed, shards, minibatch=5,
                            seed=3, engine="host", device=dev)
            for dev in (card, "cpu")}
    for a, b in zip(runs[card].state.params.values(),
                    runs["cpu"].state.params.values()):
        for x, y in zip(a.values(), b.values()):
            assert torch.equal(x.cpu().view(torch.int32), y.view(torch.int32))
    kernels.reset_launch_counts()
    got = runs[card].run(rounds=1)
    torch.cuda.synchronize()
    assert 1 <= kernels.launch_counts()["threefry"] <= 6
    want = runs["cpu"].run(rounds=1)
    np.testing.assert_allclose(got.loss_history, want.loss_history, rtol=1e-4)
    assert got.wire_history == want.wire_history


GRAPH_CONFIGS = [dict(compressor="block_topk", fused_compress=True),
                 dict(pipeline="block_topk|qsgd", fused_compress=True),
                 dict(compressor="qsgd_pallas"),
                 dict(compressor="block_topk_pallas")]


def _reduced_trainer(card, overrides, engine, **kw):
    from repro_torch.config import FedConfig, get_arch
    from repro_torch.data.partition import partition_iid
    from repro_torch.data.radar import make_dataset
    from repro_torch.models import get_model
    from repro_torch.train import FedTrainer
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = get_arch("lenet-radar").reduced
    fed = FedConfig(num_nodes=3, local_steps=2, eta=1e-3, zeta=0.3,
                    temperature=0.2, burn_in=1, rounds=6, topology="full",
                    **overrides)
    shards = partition_iid(make_dataset(30, hw=cfg.input_hw, day=1, seed=0),
                           3)
    return FedTrainer(get_model(cfg), fed, shards, minibatch=5, seed=2,
                      engine=engine, bank_thin=1, bank_capacity=3,
                      device=card, **kw)


@pytest.mark.parametrize("overrides", GRAPH_CONFIGS)
def test_graph_chunks_equal_the_host_rounds(card, overrides):
    """Six reduced rounds in chunks of two, one capture and two replays of
    the chunk's CUDA graph, against the host engine's eager rounds: params,
    v, v̄, key, losses, consensus and the bank (capacity 3 < 5 admits, so
    it evicts) equal bit for bit."""
    from repro_torch.utils.tree import tree_leaves
    host = _reduced_trainer(card, overrides, "host")
    scan = _reduced_trainer(card, overrides, "scan", chunk=2)
    want, got = host.run(rounds=6), scan.run(rounds=6)
    assert list(scan._engine.capture_ms) == [2]
    assert got.loss_history == want.loss_history
    assert got.consensus_history == want.consensus_history
    assert got.wire_history == want.wire_history
    for part in ("params", "v", "v_bar"):
        for a, b in zip(tree_leaves(getattr(scan.state, part)),
                        tree_leaves(getattr(host.state, part))):
            assert _same_bits(a, b), part
    assert torch.equal(scan.key, host.key)
    assert len(scan.bank) == len(host.bank) == 3
    for s, h in zip(scan.bank.samples, host.bank.samples):
        for a, b in zip(tree_leaves(s), tree_leaves(h)):
            assert _same_bits(a, b)


def test_a_sync_inside_the_chunk_fails_its_capture(card):
    """A round that reads a value to the host (``.item()``) cannot be
    captured: the capture raises, and nothing runs eagerly in its place
    (the bank and the state stay as they were)."""
    from repro_torch.train.engine import ScanRoundEngine
    trainer = _reduced_trainer(card, GRAPH_CONFIGS[0], "scan", chunk=2)

    def syncing(state, batches, key, draws=None):
        state, metrics = trainer.round_fn(state, batches, key, draws)
        metrics.loss.mean().item()
        return state, metrics
    syncing.draws = trainer.round_fn.draws
    engine = ScanRoundEngine(syncing, trainer.device_shards, 2, 5,
                             bank=trainer.bank_cfg)
    params = {k: {n: x.clone() for n, x in v.items()}
              for k, v in trainer.state.params.items()}
    with pytest.raises(RuntimeError):
        engine.run(trainer.state, trainer.key, trainer._bank_state, 2)
    torch.cuda.synchronize()
    assert engine.last_round_ms == [] and len(trainer.bank) == 0
    assert int(trainer._bank_state.count) == 0
    for a, b in zip(trainer.state.params.values(), params.values()):
        for x, y in zip(a.values(), b.values()):
            assert _same_bits(x, y)


def _edge_leaf(card, n):
    """(4, n) rows made on the card: NaNs of several payloads against ±inf,
    a block of signed zeros with two nonzeros, a block whose k-th magnitude
    lies 2^30 below its maximum, and normals."""
    gen = torch.Generator(device=card).manual_seed(n)
    x = torch.randn((4, n), generator=gen, device=card)
    nans = torch.tensor([0x7fc00001, 0x7fc00000, -0x3ffffe, 0x7f800001],
                        dtype=torch.int32, device=card).view(torch.float32)
    m = min(n, 1024)
    x[0, [i % m for i in (5, 900, 17, 33)]] = nans
    x[0, [i % m for i in (6, 7)]] = torch.tensor([float("inf"),
                                                  -float("inf")], device=card)
    x[1, :m] = 0.0
    x[1, :m:3] = -0.0
    x[1, [10 % m, 500 % m]] = torch.tensor([1.5, -2.5], device=card)
    x[2, :m] = torch.rand(m, generator=gen, device=card) * 1e-9 + 1e-9
    x[2, m // 2] = 2.0 ** 30
    return x


@pytest.mark.parametrize("k", [1, 11, 32, 40, 1024])
def test_topk_select_matches_plain_version(card, k):
    """The top_k-order selection against its stable-sort plain version on
    normal and edge leaves (NaN payloads, ±inf, -0.0, a ragged block, a
    k-th magnitude far below the maximum) and on the fast path's boundary
    blocks (32 and 33 candidates at k = 11, the 20 largest keys in one
    lane, all equal, all zero), with and without v, each boundary block in
    a launch of its own and every leaf in one table launch with a k a
    leaf; unpack_set decodes each as its plain version does."""
    ns = [1024, 4097, 21000] if k > 32 else [6, 150, 1024, 4097, 21000]
    xs = [_edge_leaf(card, n) for n in ns]
    gen = torch.Generator(device=card).manual_seed(k)
    vs = [torch.randn(x.shape, generator=gen, device=card) * 0.1 for x in xs]
    # without v the selection sees d itself, with v it forms (d + v) − v
    ds = list(xs)
    for _, d, v in boundary_blocks(4, seed=k):
        d, v = torch.from_numpy(d).to(card), torch.from_numpy(v).to(card)
        ds.append(d)
        xs.append(d + v)
        vs.append(v)
        ns.append(1024)
    ks = [min(k, n) if n <= 1024 else k for n in ns]
    kernels.reset_launch_counts()
    for with_v in (False, True):
        sel = xs if with_v else ds
        alone = [kernels.topk_select([x], [kk], [v] if with_v else None)[0]
                 for x, kk, v in zip(sel[-5:], ks[-5:], vs[-5:])]
        got = kernels.topk_select(sel, ks, vs if with_v else None)
        for x, v, kk, (vals, idx) in zip(sel, vs, ks, got):
            want = topk_select_plain(x, kk, v=v if with_v else None)
            assert _same_bits(vals, want[0]) and _same_bits(idx, want[1])
        for (vals, idx), (avals, aidx) in zip(got[-5:], alone):
            assert _same_bits(avals, vals) and _same_bits(aidx, idx)
        dense = kernels.unpack_set(got, ns)
        for (vals, idx), n, d in zip(got, ns, dense):
            assert _same_bits(d, unpack_set_plain(vals, idx, n))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["topk_select"], counts["unpack_set"]) == (12, 2)


def test_update_variants_match_plain_versions(card):
    """CF-FL's and DSGLD's updates, aligned (float4) and offset views
    (the scalar path), bit-exact to their plain versions."""
    gen = torch.Generator(device=card).manual_seed(9)
    base = torch.randn((4, 5, 1001), generator=gen, device=card)
    kernels.reset_launch_counts()
    for a, b, c in ((base[0], base[1], base[2]),
                    (base[0, :, 1:], base[1, :, :-1], base[3, :, 1:])):
        a, b, c = (t.contiguous() if t.is_contiguous() else t.clone()
                   for t in (a, b, c))
        assert _same_bits(kernels.cffl_update(a, b, c, 0.03),
                          cffl_update_plain(a, b, c, 0.03))
        assert _same_bits(kernels.dsgld_update(a, b * 30, c, 1e-4),
                          dsgld_update_plain(a, b * 30, c, 1e-4))
    flat = torch.randn(4 * 1001 + 1, generator=gen, device=card)
    a, b, c = flat[1:1002], flat[1002:2003], flat[2003:3004]
    assert _same_bits(kernels.cffl_update(a, b, c, 0.03),
                      cffl_update_plain(a, b, c, 0.03))
    assert _same_bits(kernels.dsgld_update(a, b, c, 1e-4),
                      dsgld_update_plain(a, b, c, 1e-4))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["cffl_update"], counts["dsgld_update"]) == (3, 3)


@pytest.mark.parametrize("algorithm", ["cdbfl", "dsgld", "cffl"])
def test_graph_chunks_equal_the_host_rounds_for_each_algorithm(card,
                                                               algorithm):
    """The paper's default codec (``fused_compress=False``) under each
    algorithm: six reduced rounds in chunks of two against the host
    engine, bit for bit; cffl keeps no bank."""
    from repro_torch.utils.tree import tree_leaves
    host = _reduced_trainer(card, dict(algorithm=algorithm), "host")
    scan = _reduced_trainer(card, dict(algorithm=algorithm), "scan", chunk=2)
    want, got = host.run(rounds=6), scan.run(rounds=6)
    assert got.loss_history == want.loss_history
    assert got.consensus_history == want.consensus_history
    assert got.wire_history == want.wire_history
    for part in ("params", "v", "v_bar"):
        for a, b in zip(tree_leaves(getattr(scan.state, part)),
                        tree_leaves(getattr(host.state, part))):
            assert _same_bits(a, b), part
    assert len(scan.bank) == len(host.bank) == (0 if algorithm == "cffl"
                                                else 3)


# -- serving the posterior: the scan eval graph, the predict graph, swaps --

def _served(card):
    """A reduced cdbfl trainer after 6 rounds (a bank of 3 samples x K=3)
    and 70 test maps."""
    from repro_torch.data.radar import make_dataset
    trainer = _reduced_trainer(card, dict(algorithm="cdbfl"), "scan",
                               chunk=2)
    trainer.run(rounds=6)
    test = make_dataset(70, hw=(32, 16), day=2, seed=9)
    return trainer, trainer.predictor().stacked, test


def _same_report(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "bins":
            assert all(np.array_equal(u, v) for u, v in zip(x, y))
        else:
            assert x == y or (np.isnan(x) and np.isnan(y)), f


@pytest.mark.parametrize("weighted", [False, True])
def test_scan_eval_equals_host_eval_on_the_card(card, weighted):
    """One CUDA graph of the whole eval against the eager batch loop: the
    probabilities and every report field, ECE included, bit for bit, with
    and without weights and an entropy gate; a second call replays."""
    from repro_torch.eval.engine import HostEvalEngine, ScanEvalEngine
    trainer, bank, test = _served(card)
    w = np.asarray([0.2, 0.3, 0.5]) if weighted else None
    kw = dict(batch_size=32, entropy_threshold=2.2)
    scan = ScanEvalEngine(trainer.model.logits, **kw)
    rep, probs = scan.evaluate(bank, test, node_axis=1, return_probs=True,
                               weights=w)
    hrep, hprobs = HostEvalEngine(trainer.model.logits, **kw).evaluate(
        bank, test, node_axis=1, return_probs=True, weights=w)
    assert np.array_equal(probs.view(np.int32), hprobs.view(np.int32))
    _same_report(rep, hrep)
    again = scan.evaluate(bank, test, node_axis=1, return_probs=True,
                          weights=w)
    _same_report(again[0], hrep)
    assert len(scan.capture_ms) == 1


def test_classify_equals_scan_eval_on_the_card(card):
    from repro_torch.config import ServeConfig
    from repro_torch.core.posterior import predictive_entropy
    from repro_torch.eval.engine import ScanEvalEngine
    from repro_torch.serve import ClassifyEngine, ServeRequest
    trainer, bank, test = _served(card)
    eng = ClassifyEngine(trainer.model.logits, ServeConfig(slots=8),
                         input_shape=test["x"].shape[1:], stacked=bank,
                         node_axis=1)
    resps = eng.run([ServeRequest(x=x) for x in test["x"][:24]])
    probs = np.stack([r.probs for r in resps])
    _, want = ScanEvalEngine(trainer.model.logits, batch_size=8).evaluate(
        bank, {f: v[:24] for f, v in test.items()}, node_axis=1,
        return_probs=True)
    assert np.array_equal(probs.view(np.int32), want.view(np.int32))
    ent = predictive_entropy(torch.from_numpy(probs)).numpy()
    np.testing.assert_allclose([r.entropy for r in resps], ent, rtol=1e-6,
                               atol=0)
    assert eng.compile_count() == 1
    pred, _ = trainer.predictor().predict({"x": test["x"][:8]})
    _, rep = trainer.eval_report({f: v[:8] for f, v in test.items()},
                                 return_probs=True)
    assert np.array_equal(pred.cpu().numpy().view(np.int32),
                          rep.view(np.int32))


def test_no_recapture_across_occupancy_and_swaps_and_memory_flat(card):
    """One capture at the warm-up; none at full, partial and single
    occupancy nor across same-size hot swaps; memory_allocated flat over 8
    swaps after the first; a bank of another sample count is one more
    capture."""
    import gc
    from repro_torch.config import ServeConfig
    from repro_torch.serve import ClassifyEngine, ServeRequest
    from repro_torch.utils.tree import tree_map
    trainer, bank, test = _served(card)
    eng = ClassifyEngine(trainer.model.logits, ServeConfig(slots=8),
                         input_shape=test["x"].shape[1:], stacked=bank,
                         node_axis=1)
    xs = [ServeRequest(x=x) for x in test["x"]]
    first = eng.run(xs[:1])
    assert eng.compile_count() == 1
    eng.run(xs[:17])
    eng.run(xs[3:4])
    assert eng.compile_count() == 1
    other = tree_map(lambda t: t + 0.01, bank)
    eng.install_bank(other)
    eng.run(xs[:1])
    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    for i in range(8):
        eng.install_bank(bank if i % 2 == 0 else other)
        eng.run(xs[:1])
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == m0
    assert eng.compile_count() == 1 and eng.bank_version == 10
    eng.install_bank(bank)
    again = eng.run(xs[:1])
    assert np.array_equal(again[0].probs.view(np.int32),
                          first[0].probs.view(np.int32))
    eng.install_bank(tree_map(lambda t: t[:2], bank))
    eng.run(xs[:1])
    assert eng.compile_count() == 2 and eng.num_samples() == 2


def test_a_sync_inside_the_eval_fails_its_capture(card):
    """An eval whose forward reads a value to the host cannot be captured:
    the scan engine raises rather than run eagerly."""
    from repro_torch.eval.engine import ScanEvalEngine
    trainer, bank, test = _served(card)

    def syncing(params, batch):
        out = trainer.model.logits(params, batch)
        out.sum().item()
        return out
    with pytest.raises(RuntimeError):
        ScanEvalEngine(syncing, batch_size=32).evaluate(bank, test,
                                                        node_axis=1)


# -- the gossip mixers and a time-varying graph (ROADMAP C16) --------------

def _mix_leaves(card, rows, count, seed):
    """``count`` (rows, n) leaves for one gossip_mix call: n = 65,536 for
    leaf 0 (4,099 above K = 64) and 1, 7, 1,024, 4,099 after it, leaf 2 a
    contiguous view 4 bytes past an aligned allocation (scalar staging
    though n % 4 == 0), every leaf's first column -0.0."""
    gen = torch.Generator(device=card).manual_seed(seed)
    xs = []
    for i in range(count):
        n = (65_536 if rows <= 64 else 4099) if i == 0 else \
            (1, 7, 1024, 4099)[i % 4]
        x = torch.randn((rows * n + 1,), generator=gen, device=card)
        x = x[1:].view(rows, n) if i == 2 else x[:rows * n].view(rows, n)
        x[:, :1] = -0.0
        xs.append(x)
    return xs, gen


def _mix_terms(card, rows, form, gen):
    """7 random terms, zero weights among them, or the ring's rows k ∓ 1."""
    if form == "ring":
        k = torch.arange(rows, device=card, dtype=torch.int32)
        src = torch.stack([(k - 1) % rows, (k + 1) % rows])
        return src, torch.full((2, rows), 0.25, device=card), 0.5
    src = torch.randint(0, rows, (7, rows), generator=gen, device=card,
                        dtype=torch.int32)
    w = torch.rand((7, rows), generator=gen, device=card)
    w[2] = 0.0
    return src, w, 0.3


@pytest.mark.parametrize("count", [1, 10, 33])
@pytest.mark.parametrize("rows", [3, 10, 64, 512])
@pytest.mark.parametrize("form", ["laplacian", "circulant", "ring"])
def test_gossip_mix_matches_plain_version(card, form, rows, count):
    """The fma chain over the node axis in each form, one launch a table of
    up to 32 leaves (33 take two), each leaf on the card bit for bit
    against the plain version on the card and on the CPU. K = 512 has no
    32-column tile within 48 KB: it takes the row kernel."""
    from repro_torch.kernels.fused_update import gossip_mix_plain
    xs, gen = _mix_leaves(card, rows, count, seed=rows * 100 + count)
    src, w, c0 = _mix_terms(card, rows, form, gen)
    kernels.reset_launch_counts()
    got = kernels.gossip_mix(xs, src, w, c0, form)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gossip_mix"] == -(-count // 32)
    for x, g in zip(xs, got):
        assert _same_bits(g, gossip_mix_plain(x, src, w, c0, form))
        cpu = gossip_mix_plain(x.cpu(), src.cpu(), w.cpu(), c0, form)
        assert _same_bits(g.cpu(), cpu)


def _tv_fed(algorithm="cdbfl"):
    from repro_torch.config import FedConfig, TopologyConfig
    return FedConfig(num_nodes=5, local_steps=2, eta=1e-3, zeta=0.3,
                     temperature=0.2, burn_in=1, rounds=4,
                     algorithm=algorithm, topology_cfg=TopologyConfig(
                         graph="geometric", radius=0.5,
                         link_failure_prob=0.1, gossip_pairs=2))


def _tv_trainer(device, algorithm, engine, **kw):
    from repro_torch.config import get_arch
    from repro_torch.data.partition import partition_iid
    from repro_torch.data.radar import make_dataset
    from repro_torch.models import get_model
    from repro_torch.train import FedTrainer
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = get_arch("lenet-radar").reduced
    shards = partition_iid(make_dataset(50, hw=cfg.input_hw, day=1, seed=0),
                           5)
    return FedTrainer(get_model(cfg), _tv_fed(algorithm), shards, minibatch=5,
                      seed=2, engine=engine, bank_thin=1, bank_capacity=3,
                      device=device, **kw)


@pytest.mark.parametrize("algorithm", ["cdbfl", "dsgld", "cffl"])
def test_time_varying_round_on_the_card_tracks_the_cpu(card, algorithm):
    """On the time-varying geometric graph: each round's masks on the card
    equal the CPU's exactly, its draws cost at most 6 threefry launches and
    its mix launches gossip_mix once; two rounds track the CPU's (rtol 1e-4:
    cuDNN sums in another order), bytes exact."""
    from repro_torch import random
    runs = {dev: _tv_trainer(dev, algorithm, "host") for dev in (card, "cpu")}
    for seed in range(4):
        keys = {dev: random.fold_in(random.PRNGKey(seed, dev), 9)
                for dev in runs}
        masks = {dev: runs[dev].round_fn.draws(keys[dev],
                                               runs[dev].state.params)[1]
                 for dev in runs}
        assert torch.equal(masks[card].cpu(), masks["cpu"])
    kernels.reset_launch_counts()
    got = runs[card].run(rounds=2)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert 1 <= counts["threefry"] <= 12 and counts["gossip_mix"] == 2
    want = runs["cpu"].run(rounds=2)
    np.testing.assert_allclose(got.loss_history, want.loss_history, rtol=1e-4)
    assert got.wire_history == want.wire_history


@pytest.mark.parametrize("algorithm", ["cdbfl", "dsgld", "cffl"])
def test_graph_chunks_equal_the_host_rounds_on_a_time_varying_graph(
        card, algorithm):
    """Four rounds in chunks of two on the time-varying graph: the masks are
    drawn and applied inside the captured chunk; params, v, v̄, key,
    losses, consensus and the bank equal the host engine's bit for bit."""
    from repro_torch.utils.tree import tree_leaves
    host = _tv_trainer(card, algorithm, "host")
    scan = _tv_trainer(card, algorithm, "scan", chunk=2)
    want, got = host.run(rounds=4), scan.run(rounds=4)
    assert list(scan._engine.capture_ms) == [2]
    assert got.loss_history == want.loss_history
    assert got.consensus_history == want.consensus_history
    assert got.wire_history == want.wire_history
    for part in ("params", "v", "v_bar"):
        for a, b in zip(tree_leaves(getattr(scan.state, part)),
                        tree_leaves(getattr(host.state, part))):
            assert _same_bits(a, b), part
    assert torch.equal(scan.key, host.key)
    assert len(scan.bank) == len(host.bank)
    for s, h in zip(scan.bank.samples, host.bank.samples):
        for a, b in zip(tree_leaves(s), tree_leaves(h)):
            assert _same_bits(a, b)


def test_gossip_mix_of_non_finite_rows_matches_plain_version(card):
    """±inf and NaN rows through each form, as one table of leaves of
    n = 4,099, 1,024, 7 and an unaligned 1,024: ±inf where the plain version
    has it, NaN where it has NaN (the payload is not part of the contract),
    every other element bit for bit."""
    from repro_torch.kernels.fused_update import gossip_mix_plain
    gen = torch.Generator(device=card).manual_seed(5)
    xs = [torch.randn((10, n), generator=gen, device=card)
          for n in (4099, 1024, 7)]
    xs.append(torch.randn((10 * 1024 + 1,), generator=gen,
                          device=card)[1:].view(10, 1024))
    for x in xs:
        x[1, 5], x[2, 6], x[3, 0] = float("nan"), float("inf"), -float("inf")
    for form in ("laplacian", "circulant", "ring"):
        src, w, c0 = _mix_terms(card, 10, form, gen)
        for got, x in zip(kernels.gossip_mix(xs, src, w, c0, form), xs):
            want = gossip_mix_plain(x, src, w, c0, form)
            nan = torch.isnan(want)
            assert torch.equal(torch.isnan(got), nan) and nan.any()
            assert _same_bits(torch.where(nan, 0.0, got),
                              torch.where(nan, 0.0, want))


def test_ring_mix_on_the_card_is_dense_below_three_nodes_else_refused(card):
    """The back-compat ``ring_mix``: below K = 3 the dense einsum with Ω on
    the leaves' device (within rtol 1e-6 of the CPU's: a matmul's summation
    order); from K = 3 on, a card's leaves are no longer refused: the
    gossip_mix kernel's ring form, one launch over the tree, bit for bit
    the CPU's ``ring_mix``. ``make_mixer``'s roll path launches gossip_mix
    once too and equals its own CPU run bit for bit."""
    from repro_torch.config import TopologyConfig
    from repro_torch.core import gossip
    from repro_torch.core.topology import build_topology
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randn((2, 4099), generator=gen, device=card)
    omega = build_topology(TopologyConfig(graph="ring"), 2).omega
    got = gossip.ring_mix(omega, {"a": x})["a"]
    assert got.device.type == "cuda"
    want = gossip.ring_mix(omega, {"a": x.cpu()})["a"]
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-6,
                               atol=0)
    ring = TopologyConfig(graph="ring")
    for k in (3, 10):
        omega = build_topology(ring, k).omega
        tree = {"a": torch.randn((k, 4099), generator=gen, device=card),
                "b": {"c": torch.randn((k, 7, 3), generator=gen,
                                       device=card).bfloat16()}}
        kernels.reset_launch_counts()
        got = gossip.ring_mix(omega, tree)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["gossip_mix"] == 1
        want = gossip.ring_mix(omega, {"a": tree["a"].cpu(),
                                       "b": {"c": tree["b"]["c"].cpu()}})
        assert _same_bits(got["a"].cpu(), want["a"])
        assert torch.equal(got["b"]["c"].cpu(), want["b"]["c"])
    x = tree["a"]
    kernels.reset_launch_counts()
    got = gossip.make_mixer(omega, card, config=ring)({"a": x})["a"]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gossip_mix"] == 1
    want = gossip.make_mixer(omega, "cpu", config=ring)({"a": x.cpu()})["a"]
    assert _same_bits(got.cpu(), want)


@pytest.mark.parametrize("rows", [1, 7, 10, 30])
@pytest.mark.parametrize("params", [(0.05, 0.3, 0.0, 1.0), (0.0, 0.3, 0.2,
                                                             1.0),
                                    (0.5, 0.5, 0.1, 0.9), (1.0, 0.0, 0.0,
                                                           1.0),
                                    (1.0, 1.0, 0.3, 0.6), (0.6, 0.3, 0.1,
                                                           0.9)])
def test_gilbert_keep_matches_plain_version(card, params, rows):
    """The burst-channel kernel against its plain version, bit for bit:
    ragged chains in one launch, at and around the 32-frame tiles of its
    warp scan and its groups of 8 tiles (1 to 690 frames), rows that fill
    no whole CTA of 4 warps, channels whose frames take every map (keep,
    flip, set-bad, clear; always enter and never leave; every frame flips;
    flip beside set-bad), start uniforms and transition and loss uniforms
    set to the thresholds themselves."""
    from repro_torch.kernels.gilbert import channel_params, gilbert_keep_plain
    consts = channel_params(*params)
    gen = torch.Generator(device=card).manual_seed(rows)
    lengths = (1, 3, 8, 9, 31, 32, 33, 64, 65, 255, 256, 257, 335, 512, 513,
               690)
    u0 = torch.rand((rows, len(lengths)), generator=gen, device=card)
    u0[0] = consts[0]
    ut = [torch.rand((rows, n), generator=gen, device=card) for n in lengths]
    ul = [torch.rand((rows, n), generator=gen, device=card) for n in lengths]
    for a, b in zip(ut, ul):
        a[-1, ::2], a[-1, 1::2] = consts[1], consts[2]
        b[0, ::2], b[0, 1::2] = consts[3], consts[4]
    kernels.reset_launch_counts()
    got = kernels.gilbert_keep(u0, ut, ul, consts)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gilbert_keep"] == 1
    want = gilbert_keep_plain(u0, ut, ul, consts)
    for g, w in zip(got, want):
        assert _same_bits(g, w.contiguous())


TRANSPORT_CONFIGS = [
    dict(transport="bernoulli"), dict(transport="gilbert-arq-budget"),
    dict(participation=True), dict(transport="bernoulli",
                                   participation=True)]


def _transport_trainer(card, case, engine, **kw):
    from repro_torch.config import (ParticipationConfig, TopologyConfig,
                                    TransportConfig)
    transports = {
        "bernoulli": TransportConfig(erasure=0.2, mtu=64),
        "gilbert-arq-budget": TransportConfig(
            loss_model="gilbert", arq=True, toa=True, mtu=64,
            duty_cycle=0.5, round_period_s=4.0)}
    overrides = dict(topology_cfg=TopologyConfig(
        graph="ring", link_failure_prob=0.1),
        pipeline="block_topk|qsgd", fused_compress=True)
    if "transport" in case:
        overrides["transport"] = transports[case["transport"]]
    if case.get("participation"):
        overrides["participation"] = ParticipationConfig(
            straggler_prob=0.3, dead=((1, 2, 5),))
    return _reduced_trainer(card, overrides, engine, **kw)


@pytest.mark.parametrize("case", TRANSPORT_CONFIGS)
def test_graph_chunks_equal_the_host_rounds_under_transport(card, case):
    """Six reduced rounds in chunks of two under the lossy transport and the
    participation model (a death from round 2 to 5 crossing the chunks),
    the scan engine's CUDA graph against the host engine: state, losses
    and every transport and participation column bit for bit."""
    from repro_torch.utils.tree import tree_leaves
    host = _transport_trainer(card, case, "host")
    scan = _transport_trainer(card, case, "scan", chunk=2)
    kernels.reset_launch_counts()
    want = host.run(rounds=6)
    launched = kernels.launch_counts()
    got = scan.run(rounds=6)
    assert got.loss_history == want.loss_history
    for name in ("offered_history", "delivered_history",
                 "participation_history"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("airtime_s_per_round", "energy_j_per_round",
                 "retransmits_per_round", "abandoned_bytes_per_round"):
        assert getattr(got, name) == getattr(want, name), name
    for part in ("params", "v", "v_bar"):
        for a, b in zip(tree_leaves(getattr(scan.state, part)),
                        tree_leaves(getattr(host.state, part))):
            assert _same_bits(a, b), part
    assert torch.equal(scan.key, host.key)
    if case.get("transport") == "gilbert-arq-budget":
        assert launched["gilbert_keep"] == 6


def _bf16_operands(card, n, seed, nonfinite=False):
    gen = torch.Generator(device=card).manual_seed(seed)
    theta = torch.randn((4, n), generator=gen, device=card)
    v = torch.randn((4, n), generator=gen, device=card) * 0.1
    if nonfinite:
        v[0, n // 2] = float("nan")
        v[1, :min(n, 1024)] = float("nan")
        v[2, n - 1] = float("inf")
        v[3, 0] = -float("inf")
    return theta, v.to(torch.bfloat16), gen


@pytest.mark.parametrize("n", [6, 150, 1024, 4097, 21000])
@pytest.mark.parametrize("nonfinite", [False, True])
def test_bf16_selection_and_pack_match_plain_versions(card, n, nonfinite):
    """topk_select and delta-pack with v in bf16: the kernel widens v in
    registers; bit for bit, NaN and ±inf in v included, one launch each of
    the bf16 forms and none of the f32 ones."""
    theta, v, _ = _bf16_operands(card, n, n, nonfinite)
    kernels.reset_launch_counts()
    k = max(1, -(-n // 100)) if n <= 1024 else 11
    (vals, idx), = kernels.topk_select([theta], [k], [v])
    want = topk_select_plain(theta, k, v=v)
    assert _same_bits(vals, want[0]) and _same_bits(idx, want[1])
    (vals, idx), = kernels.delta_pack([theta], [v], 11)
    want = delta_pack_plain(theta, v, 11)
    assert _same_bits(vals, want[0]) and _same_bits(idx, want[1])
    counts = kernels.launch_counts()
    assert counts["topk_select_bf16"] == counts["delta_pack_bf16"] == 1
    assert counts["topk_select"] == counts["delta_pack"] == 0


def _same_or_nan(a, b):
    nan = torch.isnan(a.float())
    return torch.equal(nan, torch.isnan(b.float())) and _same_bits(
        torch.where(nan, 0, a), torch.where(nan, 0, b))


@pytest.mark.parametrize("n", [1, 7, 4097, 1_000_003])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("nonfinite", [False, True])
def test_bf16_updates_match_plain_versions(card, n, offset, nonfinite):
    """fused_update and cffl_update with v and v̄ in bf16 (ROADMAP C23:
    Eq. 9 reads the f32 sums, the new v, v̄ are those sums in bf16), on
    aligned and unaligned operands: θ', v̄' and v' bit for bit (a NaN equals
    any NaN where v holds one)."""
    if n <= offset:
        pytest.skip("no element past the offset")
    theta, v, gen = _bf16_operands(card, n, n + 7, nonfinite)
    vb = (v.float() * 0.5 + 0.01).to(torch.bfloat16)
    dvb, dv, xi = (torch.randn((4, n), generator=gen, device=card) * s
                   for s in (1e-2, 1e-2, 1e-3))
    ops = [x.reshape(-1)[offset:] for x in (theta, vb, v, dvb, dv, xi)]
    kernels.reset_launch_counts()
    got = kernels.fused_update_control(*ops, 0.03, 1.0)
    want = fused_update_control_plain(*ops, 0.03, 1.0)
    assert all(_same_or_nan(g, w) for g, w in zip(got, want))
    got = kernels.cffl_update_control(*ops[:5], 0.03)
    want = cffl_update_control_plain(*ops[:5], 0.03)
    assert all(_same_or_nan(g, w) for g, w in zip(got, want))
    counts = kernels.launch_counts()
    assert counts["fused_update_bf16"] == counts["cffl_update_bf16"] == 1
    assert counts["fused_update"] == counts["cffl_update"] == 0


@pytest.mark.parametrize("n", [7, 4097])
@pytest.mark.parametrize("offset", [0, 1])
def test_f16_forms_match_plain_versions(card, n, offset):
    """The float16 forms (ROADMAP C32): topk_select and delta-pack of θ − v
    with v in f16 (subnormal halves and ±0 among its elements), and the
    Eqs. 7–9 updates, whose sums are rounded to f16 before Eq. 9, on
    aligned and unaligned operands: bit for bit, one launch each."""
    theta, v, gen = _bf16_operands(card, n, n + 11)
    v = v.float()
    v[:, ::5] = torch.randint(-1023, 1024, v[:, ::5].shape, generator=gen,
                              device=card).float() * 2.0 ** -24
    v[:, 1::7] = -0.0
    v = v.to(torch.float16)
    kernels.reset_launch_counts()
    k = max(1, -(-n // 100)) if n <= 1024 else 11
    (vals, idx), = kernels.topk_select([theta], [k], [v])
    want = topk_select_plain(theta, k, v=v)
    assert _same_bits(vals, want[0]) and _same_bits(idx, want[1])
    (vals, idx), = kernels.delta_pack([theta], [v], 11)
    want = delta_pack_plain(theta, v, 11)
    assert _same_bits(vals, want[0]) and _same_bits(idx, want[1])
    vb = (v.float() * 0.5 + 1e-6).to(torch.float16)
    dvb, dv, xi = (torch.randn((4, n), generator=gen, device=card) * s
                   for s in (1e-2, 1e-6, 1e-3))
    ops = [x.reshape(-1)[offset:] for x in (theta, vb, v, dvb, dv, xi)]
    got = kernels.fused_update_control(*ops, 0.03, 1.0)
    assert all(_same_or_nan(g, w) for g, w in zip(
        got, fused_update_control_plain(*ops, 0.03, 1.0)))
    got = kernels.cffl_update_control(*ops[:5], 0.03)
    assert all(_same_or_nan(g, w) for g, w in zip(
        got, cffl_update_control_plain(*ops[:5], 0.03)))
    counts = kernels.launch_counts()
    assert [counts[f"{f}_f16"] for f in ("topk_select", "delta_pack",
                                         "fused_update", "cffl_update")] \
        == [1, 1, 1, 1]


def _keyed_loss(params, batch, key):
    from repro_torch import random
    y = batch["y"] + random.normal(key, tuple(batch["y"].shape))
    return 0.5 * torch.mean((batch["x"] @ params["w"] - y) ** 2) * 10, ()


@pytest.mark.parametrize("algorithm", ["cdbfl", "cffl"])
def test_user_loss_in_the_graph_chunks_folds_each_rounds_index(card,
                                                               algorithm):
    """A per-node ``loss_fn(params, batch, key)`` on the scan engine: the
    captured chunk folds the node keys by the device round index at each
    replay (threefry's device counter), so two chunks of two rounds equal
    the host engine and the rounds run with Python int indices, bit for
    bit."""
    from repro_torch import random
    from repro_torch.config import FedConfig
    from repro_torch.core import init_fed_state, make_compressor, \
        make_round_fn, mixing_matrix
    from repro_torch.data.partition import DeviceShards
    from repro_torch.train import make_engine
    from repro_torch.train.engine import one_round
    k, l, m, dim = 4, 2, 8, 6
    fed = FedConfig(num_nodes=k, local_steps=l, eta=2e-3, zeta=0.3,
                    topology="ring", compressor="block_topk",
                    compress_ratio=0.5, burn_in=1, algorithm=algorithm)
    rng = np.random.default_rng(1)
    shards = DeviceShards.from_shards(
        [{"x": rng.standard_normal((20, dim)).astype(np.float32),
          "y": rng.standard_normal(20).astype(np.float32)}
         for _ in range(k)], card)
    round_fn = make_round_fn(algorithm, _keyed_loss, fed,
                             mixing_matrix("ring", k), make_compressor(fed))
    state0 = init_fed_state({"w": torch.zeros(dim, device=card)}, fed)
    want, key = state0, random.PRNGKey(5, card)
    for t in range(4):
        want, key, _ = one_round(round_fn, shards, l, m, want, key, t)
        want = want._replace(round=t + 1)
    for name in ("host", "scan"):
        got, got_key, *_ = make_engine(name, round_fn, shards, l, m,
                                       chunk=2).run(state0,
                                                    random.PRNGKey(5, card),
                                                    None, 4)
        assert torch.equal(got_key, key) and got.round == 4
        for part in ("params", "v", "v_bar"):
            for a, b in zip(getattr(got, part).values(),
                            getattr(want, part).values()):
                assert _same_bits(a, b), (name, part)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("dtype,cache,h,kv,hd,slots", [
    (torch.bfloat16, torch.bfloat16, 9, 3, 64, 16),
    (torch.float32, torch.bfloat16, 9, 3, 64, 16),
    (torch.float32, torch.float32, 9, 3, 64, 16),
    (torch.bfloat16, torch.bfloat16, 12, 1, 128, 16),
    (torch.float32, torch.float32, 12, 1, 128, 16),
    (torch.bfloat16, torch.bfloat16, 4, 2, 32, 16),
    (torch.float32, torch.bfloat16, 4, 2, 32, 16),
    (torch.bfloat16, torch.bfloat16, 3, 3, 32, 16),
    (torch.bfloat16, torch.bfloat16, 9, 3, 64, 256),
    (torch.float32, torch.bfloat16, 9, 3, 64, 256),
    (torch.float32, torch.float32, 9, 3, 64, 256),
    (torch.float32, torch.float32, 12, 1, 128, 256),
    (torch.bfloat16, torch.bfloat16, 4, 2, 32, 256)])
def test_decode_attention_matches_plain_version(card, dtype, cache, h, kv,
                                                hd, slots, window):
    """smollm-135m's heads (9 over 3 KV heads, hd 64), a group of 12 heads
    of 128 (mistral-large-123b's) and the reduced configs' heads of 32 (4
    over 2, smollm-reduced's 3 over 3) over 2 x 5 lanes of 16 slots, and of
    256 (the kernel's rows taken in two or more tiles), at positions 0 (one
    valid slot), 3, slots + 3 and 2 slots + 8 (past the end: the clamp, or
    a ring buffer wrapped) and a reset lane; the caches, slot_pos and the
    output bit for bit."""
    from repro_torch.kernels.decode_attention import decode_attention_plain
    gen = torch.Generator(device=card).manual_seed(window + hd)
    g, b = 2, 5
    q = torch.randn((g, b, h, hd), generator=gen, device=card).to(dtype)
    kn = torch.randn((g, b, kv, hd), generator=gen, device=card).to(dtype)
    vn = torch.randn((g, b, kv, hd), generator=gen, device=card).to(dtype)
    kc = torch.randn((g, b, slots, kv, hd), generator=gen,
                     device=card).to(cache)
    vc = torch.randn((g, b, slots, kv, hd), generator=gen,
                     device=card).to(cache)
    pos = torch.tensor([0, 3, slots + 3, 2 * slots + 8, 2], device=card)
    sp = torch.arange(slots, device=card, dtype=torch.int32).expand(
        g, b, slots).contiguous()
    sp[:, 4] = -1                                    # a reset lane
    args = [kc, vc, sp]
    want_args = [t.clone() for t in args]
    got = kernels.decode_attention(q, kn, vn, *args, pos, window)
    want = decode_attention_plain(q, kn, vn, *want_args, pos, window)
    for a, b_ in zip(args, want_args):
        assert torch.equal(a, b_)
    assert _same_bits(got, want)


@pytest.mark.parametrize("window", [0, 2048])
@pytest.mark.parametrize("dtype,cache,slots", [
    (torch.bfloat16, torch.bfloat16, 2048),
    (torch.float32, torch.bfloat16, 2048),
    (torch.bfloat16, torch.float32, 2048),
    (torch.float32, torch.float32, 2048),
    (torch.float32, torch.float32, 40),
    (torch.bfloat16, torch.bfloat16, 300)])
def test_decode_attention_split_form_matches_plain_version(
        card, dtype, cache, slots, window):
    """recurrentgemma-9b's local attention, 16 heads of 256 over one KV
    head: a ring (or full cache) of 2,048 slots, the split form's cluster
    of 8 CTAs of 256 slots, bf16 and f32 caches; f32 rows at 40 slots
    (one CTA of the split form) and 300 bf16 slots (2 CTAs of 150); 2 x 8
    lanes at positions 0, at the tiles' edges (TS - 1, TS, TS + 1: 255,
    256, 257 at 2,048 slots), at the ring's size, on a tile edge inside a
    wrapped ring (slots + TS), far past it, and a reset lane; the caches,
    slot_pos and the output bit for bit; and each lane decoded alone (1
    lane beside 16) bit for bit its output among the 16."""
    from repro_torch.kernels.decode_attention import (decode_attention_plain,
                                                      split_of)
    window = min(window, slots)
    h, kv, hd, g, b = 16, 1, 256, 2, 8
    nc, ts = split_of(h, hd, slots, cache)
    gen = torch.Generator(device=card).manual_seed(slots + window)
    q = torch.randn((g, b, h, hd), generator=gen, device=card).to(dtype)
    kn = torch.randn((g, b, kv, hd), generator=gen, device=card).to(dtype)
    vn = torch.randn((g, b, kv, hd), generator=gen, device=card).to(dtype)
    kc = torch.randn((g, b, slots, kv, hd), generator=gen,
                     device=card).to(cache)
    vc = torch.randn((g, b, slots, kv, hd), generator=gen,
                     device=card).to(cache)
    pos = torch.tensor([0, ts - 1, ts, ts + 1, slots, slots + ts,
                        3 * slots - 1, 5], device=card)
    t = torch.arange(slots, device=card)[None]
    p = pos[:, None]
    sp = (p - 1 - torch.remainder(p - 1 - t, slots)) if window else \
        torch.where(t < p, t, -1)
    sp = torch.where(sp >= 0, sp, -1).to(torch.int32).expand(
        g, b, slots).contiguous()
    sp[:, 7] = -1                                    # a reset lane
    args = [kc.clone(), vc.clone(), sp.clone()]
    want_args = [x.clone() for x in args]
    got = kernels.decode_attention(q, kn, vn, *args, pos, window)
    want = decode_attention_plain(q, kn, vn, *want_args, pos, window)
    for a, b_ in zip(args, want_args):
        assert torch.equal(a, b_)
    assert _same_bits(got, want)
    for m in range(g):
        for i in range(b):
            one = [x[m:m + 1, i:i + 1].clone() for x in (kc, vc, sp)]
            alone = kernels.decode_attention(
                q[m:m + 1, i:i + 1], kn[m:m + 1, i:i + 1],
                vn[m:m + 1, i:i + 1], *one, pos[i:i + 1], window)
            assert _same_bits(alone[0, 0], got[m, i])
            for a, b_ in zip(one, args):
                assert torch.equal(a[0, 0], b_[m, i])


@pytest.mark.parametrize("dtype,cache", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32)])
@pytest.mark.parametrize("h,kv,hd,slots", [
    (32, 4, 128, 4100), (96, 8, 128, 2400), (8, 1, 64, 5700),
    (12, 1, 64, 3600), (9, 3, 64, 12000), (16, 1, 32, 3100)])
def test_decode_attention_split_form_at_narrower_heads(card, dtype, cache, h,
                                                       kv, hd, slots):
    """The split form where ``split_of`` sends narrower heads: 8 and 12
    heads of 128 (yi-9b's and mistral-large-123b's) and of 64, smollm's 3
    of 64 and 16 of 32, each in a full cache a little past the slots one
    CTA holds (bf16 and f32 caches, both compute dtypes): their K stages,
    P·V maps (1 or 2 heads a thread, fewer than 256 threads at a head dim
    of 32) and tiles of 300 to 1,500 slots. 2 x 6 lanes at positions 0
    (a reset lane), at the tiles' edges, the cache's last slot and past
    it; the caches, slot_pos and the output bit for bit."""
    from repro_torch.kernels.decode_attention import (decode_attention_plain,
                                                      split_of)
    nc, ts = split_of(h // kv, hd, slots, cache)
    assert nc == 8
    g, b = 2, 6
    gen = torch.Generator(device=card).manual_seed(h + hd)
    q = torch.randn((g, b, h, hd), generator=gen, device=card).to(dtype)
    kn = torch.randn((g, b, kv, hd), generator=gen, device=card).to(dtype)
    vn = torch.randn((g, b, kv, hd), generator=gen, device=card).to(dtype)
    kc = torch.randn((g, b, slots, kv, hd), generator=gen,
                     device=card).to(cache)
    vc = torch.randn((g, b, slots, kv, hd), generator=gen,
                     device=card).to(cache)
    pos = torch.tensor([0, ts - 1, ts, ts + 1, slots - 1, slots + 7],
                       device=card)
    t = torch.arange(slots, device=card)[None]
    sp = torch.where(t < pos[:, None], t, -1).to(torch.int32).expand(
        g, b, slots).contiguous()
    args = [kc, vc, sp]
    want_args = [x.clone() for x in args]
    got = kernels.decode_attention(q, kn, vn, *args, pos, 0)
    want = decode_attention_plain(q, kn, vn, *want_args, pos, 0)
    for a, b_ in zip(args, want_args):
        assert torch.equal(a, b_)
    assert _same_bits(got, want)


def test_c40_dense_mix_sums_in_f32_whatever_the_process_allows(card):
    """ROADMAP C40: the dense mixer's einsum with TF32 allowed for the
    process (chip_smoke's phases 13-19 allow it) sums in full f32: within
    K f32 roundings of the float64 mix, where TF32's 10-bit products are
    ~2^-11 off."""
    from repro_torch.core.gossip import dense_mix
    gen = torch.Generator(device=card).manual_seed(40)
    omega = torch.rand((4, 4), generator=gen, device=card)
    omega = omega / omega.sum(1, keepdim=True)
    d = torch.randn((4, 4096), generator=gen, device=card)
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32
    m.allow_tf32 = True
    try:
        got = dense_mix(omega, {"w": d})["w"]
    finally:
        m.allow_tf32 = saved
    want = omega.double() @ d.double()
    bound = 8 * 2.0 ** -24 * (omega.abs().double() @ d.abs().double())
    assert ((got.double() - want).abs() <= bound).all()
    assert not m.allow_tf32 or saved


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bma_sample_matches_plain_version(card, dtype):
    """4 samples, 3 slots, V = 49,152, 152,064 (qwen2.5-14b's) and one not
    a multiple of the 16-byte pack, with -inf and tied logits; 64 slots at
    V = 49,152; and 8 slots at V = 256,000 (recurrentgemma-9b's): tokens,
    probabilities and entropies bit for bit."""
    from repro_torch import random
    from repro_torch.kernels.bma_sample import bma_sample_plain
    for slots, vocab in ((3, 49152), (3, 152064), (3, 1031), (64, 49152),
                         (8, 256000)):
        gen = torch.Generator(device=card).manual_seed(vocab + slots)
        lg = torch.randn((4, slots, vocab), generator=gen, device=card) * 4
        lg[:, 1, 100:] = float("-inf")
        lg[:, 2] = 0.5
        lg = lg.to(dtype)
        keys = random.split(random.PRNGKey(3, card), slots)
        pos = torch.arange(slots, device=card) * 7
        got = kernels.bma_sample(lg, keys, pos)
        want = bma_sample_plain(lg, keys, pos)
        assert torch.equal(got[0], want[0])
        assert _same_bits(got[1], want[1]) and _same_bits(got[2], want[2])


def test_exp_xla_is_its_plain_version(card):
    """The decode kernels' exp (``exp_xla``, launched alone) against
    ``exp_plain`` on the CPU, bit for bit: the CPU test's 10^6 inputs over
    [-104, 89] and its edges (``torch_golden.exp_inputs``)."""
    from repro_torch.kernels.threefry import exp_plain, exp_xla
    from torch_golden import exp_inputs
    x = torch.from_numpy(exp_inputs())
    got, want = exp_xla(x.to(card)).cpu(), exp_plain(x)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert _same_bits(got[~nan], want[~nan])


def test_gumbel_draws_match_the_golden_and_the_plain_version(card):
    from repro_torch import random
    from repro_torch.kernels.threefry import GUMBEL, TINY, Draw, draw_plain
    keys = random.split(random.PRNGKey(4, card), 5)
    got, = kernels.draw([Draw(keys, 49153, GUMBEL, params=(TINY, 1.0))])
    want, = draw_plain([Draw(keys.cpu(), 49153, GUMBEL, params=(TINY, 1.0))])
    assert _same_bits(got.cpu(), want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_engine_is_the_same_under_permissive_matmuls(card, dtype):
    """DecodeEngine end to end on the card (smollm-135m reduced, 4 samples,
    8 slots, 12 requests of mixed lengths): one capture, both kernels
    launched, and the same tokens, entropies and probabilities, bit for
    bit, whether the process allows TF32 and reduced-precision reductions
    or not: the model sums its own products in f32."""
    from repro_torch.config import ServeConfig, get_arch
    from repro_torch.launch.serve import synthetic_bank
    from repro_torch.models import get_model
    from repro_torch.serve import DecodeEngine, ServeRequest
    m = torch.backends.cuda.matmul
    names = ("allow_tf32", "allow_bf16_reduced_precision_reduction",
             "allow_fp16_reduced_precision_reduction")
    model = get_model(get_arch("smollm-135m").reduced.replace(dtype=dtype))
    bank = synthetic_bank(model, 0, 4, card)

    def serve(allow):
        saved = [getattr(m, x) for x in names]
        for x in names:
            setattr(m, x, allow)
        try:
            kernels.reset_launch_counts()
            eng = DecodeEngine(model, ServeConfig(slots=8, max_len=32,
                                                  max_new_tokens=6),
                               stacked=bank)
            resps = eng.run([ServeRequest(prompt_token=1 + i, seed=i,
                                          max_new_tokens=1 + i % 6)
                             for i in range(12)])
            counts = kernels.launch_counts()
        finally:
            for x, v in zip(names, saved):
                setattr(m, x, v)
        assert eng.compile_count() == 1
        assert counts["decode_attention"] > 0 and counts["bma_sample"] > 0
        return sorted(resps, key=lambda r: r.request_id)

    for a, b in zip(serve(False), serve(True)):
        assert np.array_equal(a.tokens, b.tokens)
        assert np.array_equal(a.token_entropy.view(np.int32),
                              b.token_entropy.view(np.int32))
        assert np.array_equal(a.probs.view(np.int32), b.probs.view(np.int32))
