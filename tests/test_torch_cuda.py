"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skipped, with the reason, on a host without a CUDA device.
On a card host: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.block_topk import block_topk_plain
from repro_torch.kernels.fused_compress import delta_pack_plain, grid_quant_plain
from repro_torch.kernels.fused_update import fused_update_plain
from repro_torch.kernels.pack import pack_topk_plain, unpack_topk_plain
from repro_torch.kernels.qsgd import (inv_one_plus, qsgd_omega, qsgd_plain,
                                      row_norm)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _same_bits(a, b):
    view = {torch.float32: torch.int32, torch.uint16: torch.int16,
            torch.int8: torch.int8}[a.dtype]
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
        "grid_quant": 0, "qsgd": 0, "block_topk": 0}


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
    nc = row_norm(carrier)
    assert _same_bits(kernels.grid_quant(carrier, uc, nc, 16),
                      grid_quant_plain(carrier, uc, nc, 16))
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


@pytest.mark.parametrize("overrides,once", [
    (dict(compressor="block_topk", fused_compress=True),
     ("delta_pack", "unpack")),
    (dict(pipeline="block_topk|qsgd", fused_compress=True),
     ("delta_pack", "unpack")),
    (dict(compressor="qsgd_pallas"), ("qsgd",))])
def test_a_round_launches_its_table_kernels_once(card, overrides, once):
    """One reduced round of each configuration: delta-pack and unpack (the
    fused rounds) and qsgd (the legacy dense round) launch once over the
    table of the model's leaves."""
    from repro_torch.config import FedConfig, get_arch
    from repro_torch.data.partition import partition_iid
    from repro_torch.data.radar import make_dataset
    from repro_torch.models import get_model
    from repro_torch.train import FedTrainer
    cfg = get_arch("lenet-radar", reduced=True)
    fed = FedConfig(num_nodes=3, local_steps=2, eta=1e-3, zeta=0.3,
                    temperature=0.2, burn_in=0, rounds=1, topology="full",
                    **overrides)
    data = make_dataset(30, hw=cfg.input_hw, day=1, seed=0)
    trainer = FedTrainer(get_model(cfg), fed, partition_iid(data, 3),
                         minibatch=5, device=card)
    kernels.reset_launch_counts()
    trainer.run(rounds=1)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert {name: counts[name] for name in once} == dict.fromkeys(once, 1)
