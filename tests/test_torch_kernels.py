"""The port's kernel wrappers (plain versions on the CPU) against the
reference's Pallas kernels run in interpret mode, as tests/test_kernels.py
runs them. Inputs are made with numpy from a seed. Values, indices and
grids are compared exactly: both sides run the same f32 arithmetic. The
QSGD kernels are handed the reference's norm and uniforms: the port's
norms sum in another order than XLA's and may differ in the last bit
(rtol 1e-6 here; the codec and round tests bound the effect).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import _qsgd_omega
from repro.kernels import ops as jops
from repro.kernels.fused_compress import grid_quant_pallas
from repro.kernels.pack import unpack_topk_pallas
from repro_torch import kernels, random
from repro_torch.kernels import ops
from repro_torch.kernels.fused_compress import (carrier_norms_plain, delta_pack,
                                                grid_quant_leaves,
                                                grid_quant_plain)
from repro_torch.kernels.fused_update import (FORMS, cffl_update_control,
                                              fma_f32, fused_update_control,
                                              gossip_mix_plain)
from repro_torch.kernels.pack import (BISECT_ITERS, bisection_bounds,
                                      pack_topk, unpack_topk_plain)
from repro_torch.kernels.qsgd import inv_one_plus, qsgd, qsgd_omega

import torch_threads  # noqa: F401  (one torch thread a process)

SHAPES = [(1024,), (3, 1000, 7), (4097,), (6,), (150,)]
ROWS = 2        # node-stacked: two nodes per leaf, one launch


def _leaf(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal((ROWS,) + shape).astype(np.float32)
    if kind == "zeros":
        return np.zeros((ROWS,) + shape, np.float32)
    if kind == "signed_zero":       # every third entry -0.0
        x = rng.standard_normal((ROWS,) + shape).astype(np.float32)
        x.reshape(ROWS, -1)[:, ::3] = -0.0
        return x
    # heavy ties: 7 distinct magnitudes over thousands of entries
    return rng.integers(-3, 4, size=(ROWS,) + shape).astype(np.float32)


CASES = ([(s, "normal") for s in SHAPES]
         + [((4097,), "zeros"), ((150,), "zeros"),
            ((4097,), "ties"), ((3, 1000, 7), "ties"),
            ((4097,), "signed_zero"), ((6,), "signed_zero")])


def _assert_exact(got, want):
    """Equal bits: the dtype, the shape, and every value, a zero's sign
    included."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


def _ref_norm(x):
    """The reference's QSGD norm (``ops.py:124-125, 187``), as (1,) f32."""
    return np.array(jnp.linalg.norm(jnp.asarray(x).reshape(-1)
                                    .astype(jnp.float32)) + 1e-12).reshape(1)


@pytest.mark.parametrize("shape,kind", CASES)
def test_pack_matches_reference(shape, kind):
    x = _leaf(shape, kind)
    vals, idx = ops.block_topk_pack(torch.from_numpy(x), ratio=0.01)
    for r in range(ROWS):
        want_v, want_i = jops.block_topk_pack(jnp.asarray(x[r]), ratio=0.01)
        _assert_exact(vals[r].numpy(), want_v)
        _assert_exact(idx[r].numpy(), want_i)


@pytest.mark.parametrize("shape,kind", CASES)
def test_delta_pack_matches_reference(shape, kind):
    theta = _leaf(shape, kind, seed=1)
    v = _leaf(shape, "normal", seed=2) if kind == "normal" else theta * 0.5
    vals, idx = ops.fused_delta_pack(torch.from_numpy(theta),
                                     torch.from_numpy(v), ratio=0.01)
    for r in range(ROWS):
        want_v, want_i = jops.fused_delta_pack(jnp.asarray(theta[r]),
                                               jnp.asarray(v[r]), ratio=0.01)
        _assert_exact(vals[r].numpy(), want_v)
        _assert_exact(idx[r].numpy(), want_i)


@pytest.mark.parametrize("shape,kind", CASES)
def test_unpack_matches_reference(shape, kind):
    x = _leaf(shape, kind, seed=3)
    n = int(np.prod(shape))
    packed = [jops.block_topk_pack(jnp.asarray(x[r]), ratio=0.01)
              for r in range(ROWS)]
    vals = torch.from_numpy(np.stack([np.asarray(p[0]) for p in packed]))
    idx = torch.from_numpy(np.stack([np.asarray(p[1]) for p in packed]))
    got = ops.block_topk_unpack(vals, idx, shape)
    for r in range(ROWS):
        want = jops.block_topk_unpack(packed[r][0], packed[r][1], n, shape)
        _assert_exact(got[r].numpy(), want)


@pytest.mark.parametrize("shape,kind", CASES)
def test_block_topk_matches_reference(shape, kind):
    x = _leaf(shape, kind, seed=8)
    got = ops.block_topk(torch.from_numpy(x), ratio=0.01)
    for r in range(ROWS):
        _assert_exact(got[r].numpy(),
                      jops.block_topk(jnp.asarray(x[r]), ratio=0.01))


def _grid_quant_ref(carrier, u, norm, levels=16):
    """``grid_quant_pallas`` on an ``(nb, k)`` carrier, its rows padded to
    the 8-row tile as ``ops.py:191-195`` does."""
    nb = carrier.shape[0]
    pad = ((0, -(-nb // 8) * 8 - nb), (0, 0))
    return np.asarray(grid_quant_pallas(
        jnp.pad(carrier, pad), jnp.pad(u, pad),
        jnp.asarray(norm, jnp.float32).reshape(1, 1), levels, jnp.int8)[:nb])


def _packed_carriers(shape, kind, seed):
    """(ROWS, nb, k) reference payload values of a case's leaf, and
    uniforms drawn by the reference's key for each row."""
    x = _leaf(shape, kind, seed=seed)
    carrier = np.stack([np.array(jops.block_topk_pack(jnp.asarray(x[r]),
                                                      ratio=0.01)[0])
                        for r in range(ROWS)])
    u = np.stack([np.array(jax.random.uniform(jax.random.PRNGKey(r),
                                              carrier.shape[1:]))
                  for r in range(ROWS)])
    return carrier, u


@pytest.mark.parametrize("shape,kind", CASES)
def test_grid_quant_matches_reference(shape, kind):
    """The plain grid on the packed carrier of each case, with the
    reference's uniforms and norm."""
    carrier, u = _packed_carriers(shape, kind, seed=9)
    for r in range(ROWS):
        norm = _ref_norm(carrier[r])
        got = grid_quant_plain(torch.from_numpy(carrier[r].reshape(1, -1)),
                               torch.from_numpy(u[r].reshape(1, -1)),
                               torch.from_numpy(norm), 16)
        _assert_exact(got.numpy().reshape(carrier.shape[1:]),
                      _grid_quant_ref(carrier[r], u[r], norm))


@pytest.mark.parametrize("shape,kind", CASES + [((0,), "zeros")])
def test_carrier_norms_match_reference(shape, kind):
    """The port's norm (the kernel's summation order) against the
    reference's ``jnp.linalg.norm(x) + 1e-12``, within rtol 1e-6 (a few
    ulps: the two sum in different orders), on each case's leaf rows and
    on its packed carrier; an all-zero or empty row is 1e-12 exactly."""
    x = _leaf(shape, kind, seed=18).reshape(ROWS, -1)
    carrier = (_packed_carriers(shape, kind, seed=18)[0].reshape(ROWS, -1)
               if x.shape[1] else x)
    for rows in (x, carrier):
        got = carrier_norms_plain(torch.from_numpy(rows)).numpy()
        want = np.concatenate([_ref_norm(r) for r in rows])
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        if not rows.any():
            _assert_exact(got, np.full(ROWS, 1e-12, np.float32))


@pytest.mark.parametrize("levels", [16, 4])
def test_grid_quant_leaves_matches_reference(levels):
    """One table call over every case's packed carrier: each leaf's grid
    equals ``grid_quant_pallas`` handed the port's norm, row by row,
    exactly, and the norms are the plain norms."""
    cases = [_packed_carriers(shape, kind, seed=19) for shape, kind in CASES]
    carriers = [torch.from_numpy(c.reshape(ROWS, -1)) for c, _ in cases]
    grids, norms = grid_quant_leaves(
        carriers, [torch.from_numpy(u.reshape(ROWS, -1)) for _, u in cases],
        levels)
    assert len(grids) == len(norms) == len(cases)
    for (carrier, u), x, grid, norm in zip(cases, carriers, grids, norms):
        _assert_exact(norm.numpy(), carrier_norms_plain(x).numpy())
        for r in range(ROWS):
            _assert_exact(grid[r].numpy().reshape(carrier.shape[1:]),
                          _grid_quant_ref(carrier[r], u[r], norm[r].numpy(),
                                          levels))
    with pytest.raises(TypeError, match="list"):
        grid_quant_leaves(carriers[0], carriers[0], levels)
    with pytest.raises(ValueError, match="uniforms"):
        grid_quant_leaves(carriers, carriers[:1], levels)


@pytest.mark.parametrize("shape,kind", CASES)
@pytest.mark.parametrize("levels", [16, 4])
def test_qsgd_matches_reference(shape, kind, levels):
    """``jops.qsgd(x, key)`` draws ``uniform(key, x.shape)``; the port is
    handed those uniforms and the reference's norm."""
    x = _leaf(shape, kind, seed=10)
    for r in range(ROWS):
        key = jax.random.PRNGKey(20 + r)
        want = jops.qsgd(jnp.asarray(x[r]), key, levels=levels)
        u = np.array(jax.random.uniform(key, x[r].shape, jnp.float32))
        n = x[r].size
        got, = qsgd([torch.from_numpy(x[r].reshape(1, -1))],
                    [torch.from_numpy(u.reshape(1, -1))],
                    [torch.from_numpy(_ref_norm(x[r]))], levels,
                    [inv_one_plus(qsgd_omega(n, levels))])
        _assert_exact(got.numpy().reshape(x[r].shape), want)


def test_qsgd_keeps_the_sign_of_zero():
    """jnp.sign(-0.0) is -0.0 and torch.sign(-0.0) is +0.0; the port
    gives the reference's -0.0."""
    x = torch.tensor([[-0.0, 0.0, 1.0, -2.0]])
    out, = qsgd([x], [torch.zeros_like(x)], [torch.ones(1)], 16, [1.0])
    assert torch.signbit(out[0, :2]).tolist() == [True, False]
    assert torch.signbit(ops.qsgd(x, torch.zeros_like(x))[0, :2]).tolist() \
        == [True, False]


@pytest.mark.parametrize("n,levels", [(28006, 16), (2598846, 16), (6, 4),
                                      (150, 64)])
def test_qsgd_omega_matches_reference(n, levels):
    assert qsgd_omega(n, levels) == _qsgd_omega(n, levels)


def test_qsgd_of_a_zero_size_leaf_is_the_leaf():
    x = torch.empty((3, 0, 4))
    assert ops.qsgd(x, None) is x


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("noise_scale", [1.0, 0.0141])
def test_fused_update_matches_reference(shape, noise_scale):
    rng = np.random.default_rng(4)
    th, vb, v, xi = (rng.standard_normal(shape).astype(np.float32)
                     for _ in range(4))
    got = ops.leaf_fused_update(*(torch.from_numpy(a) for a in (th, vb, v, xi)),
                                zeta=0.03, noise_scale=noise_scale)
    want = jops.fused_update(*(jnp.asarray(a) for a in (th, vb, v, xi)),
                             zeta=0.03, noise_scale=noise_scale)
    _assert_exact(got.numpy(), want)


def test_fused_update_matches_reference_round_expression():
    """The round's Eq. 9 tree_map (algorithms.py:415-422) is what the port's
    round replaces with the kernel at noise_scale=1."""
    rng = np.random.default_rng(5)
    th, vb, v, n = (rng.standard_normal((3, 2000)).astype(np.float32)
                    for _ in range(4))
    eq9 = jax.jit(lambda t, vb, v, n: t.astype(jnp.float32)
                  + 0.03 * (vb.astype(jnp.float32) - v.astype(jnp.float32)) + n)
    want = eq9(*(jnp.asarray(a) for a in (th, vb, v, n)))
    got = ops.leaf_fused_update(*(torch.from_numpy(a) for a in (th, vb, v, n)),
                                zeta=0.03, noise_scale=1.0)
    _assert_exact(got.numpy(), want)


def test_fma_f32_is_single_rounding():
    """fma_f32 against an exact rational evaluation. The first two cases
    are double-rounding traps: (1 + 2^-15)(1 - 2^-15) + (2^24 + 2) is
    2^24 + 3 - 2^-30, which a float64 sum rounds to the f32 midpoint
    2^24 + 3 and then (ties to even) to 2^24 + 4; the fma gives 2^24 + 2."""
    from fractions import Fraction
    rng = np.random.default_rng(6)
    a = rng.standard_normal(4000).astype(np.float32)
    b = rng.standard_normal(4000).astype(np.float32)
    c = (a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)
    c = -c + np.float32(2.0) ** rng.integers(-40, -20, 4000).astype(np.float32)
    a[:2] = 1 + 2.0 ** -15, -(1 + 2.0 ** -15)
    b[:2] = 1 - 2.0 ** -15
    c[:2] = 2.0 ** 24 + 2, -(2.0 ** 24 + 2)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    assert got[0] == 2.0 ** 24 + 2 and got[1] == -(2.0 ** 24 + 2)
    for ai, bi, ci, gi in zip(a, b, c, got.numpy()):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        lo = np.nextafter(gi, np.float32(-np.inf))
        hi = np.nextafter(gi, np.float32(np.inf))
        err = abs(Fraction(float(gi)) - exact)
        assert err <= abs(Fraction(float(lo)) - exact)
        assert err <= abs(Fraction(float(hi)) - exact)


def test_delta_pack_equals_pack_of_residual():
    rng = np.random.default_rng(7)
    theta = torch.from_numpy(rng.standard_normal((3, 5000)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((3, 5000)).astype(np.float32))
    a = ops.fused_delta_pack(theta, v)
    b = ops.block_topk_pack(theta - v)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_cpu_tensors_run_the_plain_versions():
    kernels.reset_launch_counts()
    x = torch.randn(2, 3000)
    vals, idx = pack_topk([x], 11)[0]
    ops.block_topk_unpack(vals, idx, (3000,))
    ops.fused_delta_pack(x, x)
    ops.leaf_fused_update(x, x, x, x, 0.03, 1.0)
    ops.block_topk(x)
    ops.qsgd(x, torch.rand(2, 3000))
    ops.qsgd_quantize_carriers([vals], [torch.rand(vals.shape)])
    random.normal(random.split(random.PRNGKey(0), 3), (7,))
    (tvals, tidx), = ops.topk_select_leaves([x], [11], [x])
    ops.unpack_set_leaves([(tvals, tidx)], [(3000,)])
    ops.leaf_cffl_update(x, x, x, 0.03)
    ops.leaf_dsgld_update(x, x, x, 1e-4)
    kernels.gossip_mix([x], torch.tensor([[1, 0]], dtype=torch.int32),
                       torch.full((1, 2), 0.5), 0.0, "laplacian")
    kernels.gilbert_keep(torch.rand(2, 1), [torch.rand(2, 5)],
                         [torch.rand(2, 5)], (0.1, 0.05, 0.3, 0.0, 1.0))
    vb = x.to(torch.bfloat16)
    ops.topk_select_leaves([x], [11], [vb])
    ops.fused_delta_pack_leaves([x], [vb])
    fused_update_control(x, vb, vb, x, x, x, 0.03, 1.0)
    cffl_update_control(x, vb, vb, x, x, 0.03)
    vh = x.to(torch.float16)
    ops.topk_select_leaves([x], [11], [vh])
    ops.fused_delta_pack_leaves([x], [vh])
    kernels.fused_update_control(x, vh, vh, x, x, x, 0.03, 1.0)
    kernels.cffl_update_control(x, vh, vh, x, x, 0.03)
    q = torch.randn(1, 2, 3, 8)
    kv = torch.randn(1, 2, 3, 8)
    kernels.decode_attention(q, kv, kv, torch.zeros(1, 2, 4, 3, 8),
                             torch.zeros(1, 2, 4, 3, 8),
                             torch.full((1, 2, 4), -1, dtype=torch.int32),
                             torch.tensor([0, 5]))
    kernels.bma_sample(torch.randn(2, 3, 50), random.split(
        random.PRNGKey(0), 3), torch.tensor([0, 1, 2]))
    assert kernels.launch_counts() == {
        "pack": 0, "delta_pack": 0, "unpack": 0, "fused_update": 0,
        "grid_quant": 0, "qsgd": 0, "block_topk": 0, "threefry": 0,
        "topk_select": 0, "unpack_set": 0, "cffl_update": 0,
        "dsgld_update": 0, "gossip_mix": 0, "gilbert_keep": 0,
        "topk_select_bf16": 0, "delta_pack_bf16": 0,
        "fused_update_bf16": 0, "cffl_update_bf16": 0,
        "topk_select_f16": 0, "delta_pack_f16": 0,
        "fused_update_f16": 0, "cffl_update_f16": 0,
        "decode_attention": 0, "bma_sample": 0}


def _mix_terms(form, k=10, seed=0):
    """``(src, w, c0)`` for ``form`` at K=k: 7 random terms with zero
    weights among them, or the ring's rows k ∓ 1."""
    rng = np.random.default_rng(seed)
    if form == "ring":
        rows = np.arange(k)
        src = np.stack([(rows - 1) % k, (rows + 1) % k])
        w = np.full((2, k), 0.25, np.float32)
    else:
        src = rng.integers(0, k, (7, k))
        w = rng.random((7, k)).astype(np.float32)
        w[2] = 0.0
    return (torch.from_numpy(src.astype(np.int32)), torch.from_numpy(w),
            0.3 if form != "ring" else 0.5)


@pytest.mark.parametrize("form", FORMS)
def test_gossip_mix_list_equals_per_leaf_plain_version(form):
    """33 leaves of mixed shapes (more than one table) in one call, on the
    CPU: each the plain version of its leaf, bit for bit, and no launch;
    through a mixer's ``_Terms.mix``, a tree of bf16 and f32 leaves is
    each leaf's plain mix in f32, cast back."""
    from repro_torch.core.gossip import _Terms
    rng = np.random.default_rng(3)
    src, w, c0 = _mix_terms(form)
    xs = [torch.from_numpy(rng.standard_normal((10,) + s).astype(np.float32))
          for s in [(1,), (7,), (4, 3), (1024,), (4099,)] * 6 + [(5,)] * 3]
    kernels.reset_launch_counts()
    got = kernels.gossip_mix(xs, src, w, c0, form)
    assert kernels.launch_counts()["gossip_mix"] == 0
    assert len(got) == len(xs) == 33
    for x, g in zip(xs, got):
        want = gossip_mix_plain(x, src, w, c0, form)
        assert g.shape == x.shape
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      want.numpy().view(np.int32))
    tree = {f"l{i:02d}": x.bfloat16() if i % 2 else x
            for i, x in enumerate(xs)}
    tree["sub"] = {"b": xs[3].bfloat16(), "a": xs[4]}
    mixed = _Terms(src.numpy(), w.numpy(), "cpu", form, c0).mix(tree)
    assert list(mixed) == list(tree) and list(mixed["sub"]) == ["b", "a"]
    for leaf, out in [(tree[k], mixed[k]) for k in tree if k != "sub"] + [
            (tree["sub"][k], mixed["sub"][k]) for k in ("a", "b")]:
        want = gossip_mix_plain(leaf.float(), src, w, c0, form).to(leaf.dtype)
        assert out.dtype == leaf.dtype and torch.equal(out, want)
    assert kernels.launch_counts()["gossip_mix"] == 0


@pytest.mark.parametrize("case,match", [
    ("rows", "leaf 2 has shape \\(9, 4\\)"),
    ("src", "sources \\(7, 9\\)"),
    ("w", "weights \\(6, 10\\)"),
    ("ring", "M = 2 in the ring form"),
    ("form", "form 'roll' is none of"),
    ("tensor", "takes a list of leaves")])
def test_gossip_mix_rejects_what_the_kernel_does_not_take(case, match):
    """Leaves whose K differs from leaf 0's, sources and weights of the
    wrong shape, the ring form without its 2 terms, an unknown form, a bare
    tensor: each refused on the CPU as on the card, naming what is wrong."""
    src, w, c0 = _mix_terms("laplacian")
    xs = [torch.zeros(10, 4), torch.zeros(10, 3), torch.zeros(10, 4)]
    form = "laplacian"
    if case == "rows":
        xs[2] = torch.zeros(9, 4)
    elif case == "src":
        src = src[:, :9]
    elif case == "w":
        w = w[:6]
    elif case == "ring":
        form = "ring"
    elif case == "form":
        form = "roll"
    elif case == "tensor":
        xs = xs[0]
    error = TypeError if case == "tensor" else ValueError
    with pytest.raises(error, match=match):
        kernels.gossip_mix(xs, src, w, c0, form)


def test_meta_tensors_give_payload_shapes():
    vals, idx = pack_topk([torch.empty((10, 11712 * 220), device="meta")],
                          11)[0]
    assert vals.shape == idx.shape == (10, 2517, 11)
    assert vals.dtype == torch.float32 and idx.dtype == torch.uint16


def test_meta_tensors_give_dense_and_grid_shapes():
    x = torch.empty((10, 11712 * 220), device="meta")
    assert ops.block_topk(x).shape == x.shape
    (grid, norm), = ops.qsgd_quantize_carriers(
        [torch.empty((10, 2517, 11), device="meta")],
        [torch.empty((10, 2517, 11), device="meta")])
    assert grid.shape == (10, 2517, 11) and grid.dtype == torch.int8
    assert norm.shape == (10,)


def test_wrappers_check_dtypes():
    with pytest.raises(ValueError, match="float32"):
        pack_topk([torch.zeros(1, 64, dtype=torch.float64)], 1)
    x = torch.zeros(1, 64)
    with pytest.raises(ValueError, match="float32"):
        grid_quant_leaves([x], [x.double()], 16)
    with pytest.raises(ValueError, match="float32"):
        qsgd([x], [x], [torch.ones(1, dtype=torch.float64)], 16, [1.0])


# --------------------------------------------------------------------------
# The CUDA tile's selection (csrc/pack_tile.cuh: kth_magnitude, then the
# replayed bisection in bisect_block), transcribed in numpy, against the
# plain version's 40 counted passes (bisection_bounds)
# --------------------------------------------------------------------------

def _kth_magnitude(mag, k):
    """Step (a): the k-th largest of each row's magnitudes by an MSB-first
    search on its bits, bit b kept when at least k magnitudes are >= the
    candidate as f32 (a NaN never counts, a candidate past inf is NaN); a
    row stops when exactly k reach the candidate, with v_k their least."""
    bits = np.zeros(mag.shape[0], np.uint32)
    done = np.zeros(mag.shape[0], bool)
    least = np.full(mag.shape[0], np.inf, np.float32)
    for b in range(30, -1, -1):
        cand = bits | np.uint32(1 << b)
        with np.errstate(invalid="ignore"):
            above = mag >= cand.view(np.float32)[:, None]
        cnt = above.sum(axis=1)
        take = ~done & (cnt >= k)
        stop = take & (cnt == k)
        least[stop] = np.where(above[stop], mag[stop], np.inf).min(axis=1)
        bits = np.where(take, cand, bits)
        done |= stop
    return np.where(done, least, bits.view(np.float32))


def _replayed_bounds(mag, k):
    """Step (b): the reference's 40 f32 bisection steps with each count
    replaced by ``v_k >= mid``; ``m`` propagates NaN as jnp.max does."""
    vk = _kth_magnitude(mag, k)
    lo = np.zeros(mag.shape[0], np.float32)
    hi = mag.max(axis=1) + np.float32(1.0)
    for _ in range(BISECT_ITERS):
        mid = np.float32(0.5) * (lo + hi)
        with np.errstate(invalid="ignore"):
            up = vk >= mid
        lo, hi = np.where(up, mid, lo), np.where(up, hi, mid)
    return lo, hi


def _selection_blocks(seed=0):
    """(rows, 1024) f32 blocks of every kind the selection must survive."""
    rng = np.random.default_rng(seed)

    def normal(rows):
        return rng.standard_normal((rows, 1024)).astype(np.float32)

    ragged = normal(3)
    ragged[0, 300:] = 0.0            # a leaf's ragged last block
    ragged[1, 1:] = 0.0
    ragged[2, 1000:] = 0.0
    half_zero = normal(2)
    half_zero[:, ::2] = 0.0
    nan = normal(4)
    nan[0, 5] = np.nan
    nan[1, :] = np.nan               # NaN but for 5 values
    nan[1, [10, 20, 30, 40, 50]] = [1, -2, 3, -4, 5]
    nan[2, ::7] = np.nan
    nan[3, 100] = np.nan
    nan[3, 200] = np.inf
    inf = normal(4)
    inf[0, 77] = -np.inf
    inf[1, [3, 100, 700]] = [np.inf, -np.inf, np.inf]
    inf[2, ::50] = np.inf            # 21 infinities
    inf[3, :] = np.inf
    return np.concatenate([
        normal(6),
        np.round(normal(4) * 4) / 4,                  # ties at quarters
        np.zeros((2, 1024), np.float32),
        np.full((2, 1024), 0.75, np.float32),         # all equal
        normal(3) * np.float32(1e-30),                # tiny
        ragged, half_zero, nan, inf]).astype(np.float32)


@pytest.mark.parametrize("k", [1, 11, 39, 1024])
def test_replayed_bisection_equals_counted_bisection(k):
    """lo and hi of the tile's selection (exact v_k, then the replay) equal
    the 40 counted passes' bit for bit, on every kind of block, NaN and
    ±inf included; v_k is the k-th largest non-NaN magnitude."""
    mag = np.abs(_selection_blocks())
    lo, hi = _replayed_bounds(mag, k)
    want_lo, want_hi = bisection_bounds(torch.from_numpy(mag), k)
    np.testing.assert_array_equal(lo.view(np.int32),
                                  want_lo.numpy().ravel().view(np.int32))
    np.testing.assert_array_equal(hi.view(np.int32),
                                  want_hi.numpy().ravel().view(np.int32))
    vk = _kth_magnitude(mag, k)
    for row, got in zip(mag, vk):
        finite = np.sort(row[~np.isnan(row)])[::-1]
        assert got == (finite[k - 1] if finite.size >= k else 0.0)


# --------------------------------------------------------------------------
# Non-finite blocks (ROADMAP C6) against the interpret-mode Pallas kernels
# --------------------------------------------------------------------------

def _nonfinite_leaf(kind, seed=11):
    """(ROWS, 4097) leaves: four full blocks and a ragged one a row."""
    x = np.random.default_rng(seed).standard_normal(
        (ROWS, 4097)).astype(np.float32)
    if kind == "nan":
        x[0, 5] = np.nan                              # one NaN
        x[0, 1024:2048] = np.nan                      # NaN but for 5 values
        x[0, [1030, 1040, 1050, 1060, 1070]] = [1, -2, 3, -4, 5]
        x[1, 2048::3] = np.nan                        # many, ragged block too
        x[1, 100] = np.nan
        x[1, 200] = np.inf                            # NaN beside an inf
    else:
        x[0, 77] = -np.inf                            # a lone -inf
        x[0, [1027, 1124, 1724]] = [np.inf, -np.inf, np.inf]  # fewer than k
        x[0, 2048:3072:50] = np.inf                   # more than k
        x[0, 4096] = np.inf                           # the ragged block's
        x[1, 3072:4096] = -np.inf                     # a whole block
        x[1, 10] = np.inf
    return x


def _assert_exact_nan(got, want):
    """:func:`_assert_exact` with every NaN read as one bit pattern. A
    NaN's payload and sign are not part of the contract: the reference's
    follow x86's rules (a NaN operand's payload propagates, 0·inf gives the
    negative default NaN), the port writes torch's ``float('nan')``."""
    got, want = np.array(got), np.array(want)
    if got.dtype == np.float32 and want.dtype == np.float32:
        got[np.isnan(got)] = np.nan
        want[np.isnan(want)] = np.nan
    _assert_exact(got, want)


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_pack_and_delta_pack_of_nonfinite_blocks_match_reference(kind):
    """Every slot of a block with a non-finite element is NaN but the slot
    of a lone ±inf; a block holding a NaN keeps its first k non-NaN
    elements, its empty slots NaN at index 0."""
    x = _nonfinite_leaf(kind)
    v = (np.random.default_rng(12).standard_normal(x.shape) * 0.1).astype(
        np.float32)
    v[1, 10] = np.inf                                 # inf - inf = NaN
    vals, idx = ops.block_topk_pack(torch.from_numpy(x))
    dvals, didx = ops.fused_delta_pack(torch.from_numpy(x),
                                       torch.from_numpy(v))
    for r in range(ROWS):
        want_v, want_i = jops.block_topk_pack(jnp.asarray(x[r]))
        _assert_exact_nan(vals[r].numpy(), want_v)
        _assert_exact(idx[r].numpy(), want_i)
        want_v, want_i = jops.fused_delta_pack(jnp.asarray(x[r]),
                                               jnp.asarray(v[r]))
        _assert_exact_nan(dvals[r].numpy(), want_v)
        _assert_exact(didx[r].numpy(), want_i)
    if kind == "inf":            # the lone -inf keeps its slot
        assert vals[0, 0, 0] == -np.inf and vals[0, 0, 1:].isnan().all()


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_block_topk_of_nonfinite_blocks_matches_reference(kind):
    """The first k non-NaN elements of a block holding a NaN are kept and
    the NaN becomes 0; k or more ±inf are all kept."""
    x = _nonfinite_leaf(kind, seed=13)
    got = ops.block_topk(torch.from_numpy(x))
    for r in range(ROWS):
        _assert_exact(got[r].numpy(), jops.block_topk(jnp.asarray(x[r])))


def _crafted_payloads(seed=14):
    """(name, vals (8, k), idx int32 (8, k)) payloads for unpack: block 0
    holds the case, the other blocks finite."""
    rng = np.random.default_rng(seed)
    k = 11
    idx = np.stack([rng.choice(1024, k, replace=False)
                    for _ in range(8)]).astype(np.int32)
    base = rng.standard_normal((8, k)).astype(np.float32)
    cases = []
    for name, slot_vals in [("one inf", {2: np.inf}),
                            ("one -inf", {0: -np.inf}),
                            ("one nan", {5: np.nan}),
                            ("inf and nan", {1: np.inf, 3: np.nan}),
                            ("two infs", {1: np.inf, 4: -np.inf}),
                            ("-0.0", {0: -0.0})]:
        vals = base.copy()
        for s, val in slot_vals.items():
            vals[0, s] = val
        cases.append((name, vals, idx))
    cases.append(("all negative", -np.abs(base), idx))
    # a NaN block with nothing to keep: every slot NaN at index 0
    empty = idx.copy()
    empty[0] = 0
    nan_block = base.copy()
    nan_block[0] = np.nan
    cases.append(("empty nan slots", nan_block, empty))
    # ROADMAP C7: values that share an index add up, from +0.0 in slot
    # order (the triples tell the orders apart)
    for name, slots, slot_vals in [
            ("two at one index", (2, 6), (1.5, 2.25)),
            ("1e8, 1, -1e8", (0, 1, 2), (1e8, 1.0, -1e8)),
            ("1, 1e8, -1e8", (0, 1, 2), (1.0, 1e8, -1e8)),
            ("1e8, -1e8, 1", (0, 1, 2), (1e8, -1e8, 1.0)),
            ("1e8, 1, -1e8 in slots 0, 5, 10", (0, 5, 10), (1e8, 1.0, -1e8)),
            ("-0.0 and +0.0 at one index", (3, 4), (-0.0, 0.0)),
            ("inf and 2 at one index", (1, 7), (np.inf, 2.0)),
            ("inf and inf at one index", (2, 9), (np.inf, np.inf)),
            ("inf and -inf at one index", (2, 9), (np.inf, -np.inf))]:
        vals, rep = base.copy(), idx.copy()
        vals[0, list(slots)] = slot_vals
        rep[0, list(slots)] = idx[0, slots[0]]
        cases.append((name, vals, rep))
    # k > 32: repeats within and across the 32-slot chunks
    k = 40
    wide_idx = np.stack([rng.choice(1024, k, replace=False)
                         for _ in range(8)]).astype(np.int32)
    wide = rng.standard_normal((8, k)).astype(np.float32)
    wide[0, [1, 31, 33, 39]] = (1e8, 1.0, -1e8, 1.0)
    wide_idx[0, [1, 31, 33, 39]] = wide_idx[0, 1]
    wide[0, [4, 5]] = (1.5, 2.25)
    wide_idx[0, 5] = wide_idx[0, 4]
    wide_idx[3, 36] = wide_idx[3, 2]
    cases.append(("k=40 repeats", wide, wide_idx))
    wide, wide_idx = wide.copy(), wide_idx.copy()
    wide[2, [3, 35]] = np.inf                   # one index, both chunks
    wide_idx[2, 35] = wide_idx[2, 3]
    cases.append(("k=40 inf and inf at one index", wide, wide_idx))
    return cases


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_unpack_of_nonfinite_payloads_matches_reference(kind):
    """The reference's payloads of non-finite leaves, decoded: a block whose
    values hold a non-finite is NaN but at a lone non-finite value's index."""
    x = _nonfinite_leaf(kind, seed=15)
    packed = [jops.block_topk_pack(jnp.asarray(x[r])) for r in range(ROWS)]
    vals = torch.from_numpy(np.stack([np.asarray(p[0]) for p in packed]))
    idx = torch.from_numpy(np.stack([np.asarray(p[1]) for p in packed]))
    got = ops.block_topk_unpack(vals, idx, (4097,))
    for r in range(ROWS):
        want = jops.block_topk_unpack(packed[r][0], packed[r][1], 4097,
                                      (4097,))
        _assert_exact_nan(got[r].numpy(), want)


@pytest.mark.parametrize("case", range(len(_crafted_payloads())))
def test_unpack_follows_the_one_hot_contraction(case):
    """Crafted payloads against ``unpack_topk_pallas``: a lone ±inf keeps
    its index and NaNs the rest of its block, a -0.0 value and the unpicked
    positions of an all-negative block decode to +0.0, NaN slots that
    share an index decode to a block of NaN, and values that share an index
    add up from +0.0 in slot order (1.5 + 2.25 = 3.75; the three orders of
    1e8, 1 and -1e8 give 0, 0 and 1; inf + inf keeps inf at its index, the
    rest of its block NaN), k = 40 included."""
    name, vals, idx = _crafted_payloads()[case]
    want = unpack_topk_pallas(jnp.asarray(vals), jnp.asarray(idx), 1024)
    got = unpack_topk_plain(torch.from_numpy(vals).reshape(1, 8, -1),
                            torch.from_numpy(idx.astype(np.uint16))
                            .reshape(1, 8, -1), 8 * 1024)
    _assert_exact_nan(got.numpy().reshape(8, 1024), want)
    expect = {"two at one index": (2, 3.75), "1e8, 1, -1e8": (0, 0.0),
              "1, 1e8, -1e8": (0, 0.0), "1e8, -1e8, 1": (0, 1.0),
              "inf and inf at one index": (2, np.inf)}
    if name in expect:
        slot, value = expect[name]
        assert got[0, idx[0, slot]] == value



def test_list_form_equals_per_leaf_calls():
    """pack and delta-pack over a list of leaves equal the reference's
    per-leaf pack, leaf by leaf, in the order given."""
    leaves = [_leaf(s, "normal", seed=i).reshape(ROWS, -1)
              for i, s in enumerate(SHAPES)] + [_nonfinite_leaf("inf")]
    vs = [np.full_like(x, 0.25) for x in leaves]
    packed = pack_topk([torch.from_numpy(x) for x in leaves], 11)
    dpacked = delta_pack([torch.from_numpy(x) for x in leaves],
                         [torch.from_numpy(v) for v in vs], 11)
    assert len(packed) == len(dpacked) == len(leaves)
    for x, v, (vals, idx), (dvals, didx) in zip(leaves, vs, packed, dpacked):
        for r in range(ROWS):
            want_v, want_i = jops.block_topk_pack(jnp.asarray(x[r]))
            _assert_exact_nan(vals[r].numpy(), want_v)
            _assert_exact(idx[r].numpy(), want_i)
            want_v, want_i = jops.fused_delta_pack(jnp.asarray(x[r]),
                                                   jnp.asarray(v[r]))
            _assert_exact_nan(dvals[r].numpy(), want_v)
            _assert_exact(didx[r].numpy(), want_i)
    with pytest.raises(TypeError, match="list"):
        pack_topk(torch.from_numpy(leaves[0]), 11)
    with pytest.raises(ValueError, match="thetas"):
        delta_pack([torch.from_numpy(leaves[0])], [], 11)


TABLE_NS = (6, 150, 1024, 4097, 21000, 0)


@pytest.mark.parametrize("levels", [16, 4])
def test_qsgd_table_equals_reference_leaf_by_leaf(levels):
    """The table wrapper over mixed leaves (a zero-size one included),
    each row handed the reference's uniforms and norm, against
    ``jops.qsgd`` row by row, exactly."""
    rng = np.random.default_rng(16)
    xs, us, norms, recips, wants = [], [], [], [], []
    for i, n in enumerate(TABLE_NS):
        x = rng.standard_normal((ROWS, n)).astype(np.float32)
        x[:, ::7] = -0.0
        keys = [jax.random.PRNGKey(100 * i + r) for r in range(ROWS)]
        wants.append([np.asarray(jops.qsgd(jnp.asarray(x[r]), keys[r],
                                           levels=levels))
                      for r in range(ROWS)])
        xs.append(torch.from_numpy(x))
        us.append(torch.from_numpy(np.stack([np.array(jax.random.uniform(
            k, (n,), jnp.float32)) for k in keys])))
        norms.append(torch.from_numpy(np.concatenate(
            [_ref_norm(x[r]) for r in range(ROWS)])))
        recips.append(inv_one_plus(qsgd_omega(n, levels)) if n else 1.0)
    got = qsgd(xs, us, norms, levels, recips)
    assert len(got) == len(TABLE_NS)
    for q, want in zip(got, wants):
        for r in range(ROWS):
            _assert_exact(q[r].numpy(), want[r])
    with pytest.raises(TypeError, match="list"):
        qsgd(xs[0], us[0], norms[0], levels, recips[0])


def test_unpack_table_equals_reference_leaf_by_leaf():
    """The table wrapper over the reference's payloads of mixed leaves
    (short, ragged, full-block, NaN and ±inf) against
    ``jops.block_topk_unpack`` and the interpret-mode
    ``unpack_topk_pallas``, row by row; every NaN read as one pattern."""
    leaves = [_leaf((n,), "normal", seed=17).reshape(ROWS, n)
              for n in TABLE_NS[:-1]]
    leaves += [_nonfinite_leaf("nan"), _nonfinite_leaf("inf")]
    packed = [[jops.block_topk_pack(jnp.asarray(x[r])) for r in range(ROWS)]
              for x in leaves]
    payloads = [tuple(torch.from_numpy(np.stack([np.asarray(p[j])
                                                 for p in rows]))
                      for j in range(2)) for rows in packed]
    ns = [x.shape[1] for x in leaves]
    got = kernels.unpack_topk(payloads, ns)
    assert len(got) == len(leaves)
    for dense, rows, n in zip(got, packed, ns):
        for r, (vals, idx) in enumerate(rows):
            want = jops.block_topk_unpack(vals, idx, n, (n,))
            _assert_exact_nan(dense[r].numpy(), want)
            pad = ((0, -vals.shape[0] % 8), (0, 0))    # its 8-row tiles
            tile = unpack_topk_pallas(jnp.pad(vals, pad),
                                      jnp.pad(idx.astype(jnp.int32), pad),
                                      1024)
            _assert_exact_nan(dense[r].numpy(),
                              np.asarray(tile).reshape(-1)[:n])
    with pytest.raises(TypeError, match="list"):
        kernels.unpack_topk(payloads[0], ns[0])
    with pytest.raises(ValueError, match="sizes"):
        kernels.unpack_topk(payloads, ns[:-1])
