"""The port's lossy D2D transport (``repro_torch.core.transport``) against
the reference's (``repro.core.transport``), on the CPU at small sizes.

- The host byte codec: the reference's properties (round trip, dropped
  frames, truncation, the header-only frame, the MTU and SEQ bounds), the
  frames equal to the reference's byte for byte, ``serialize_payload`` of a
  port payload equal to the reference's bytes, and the golden dump
  ``tests/golden/transport_frames.bin``. The CRC covers the payload only
  (ROADMAP C1): the port's copy of the header-corruption property is an
  expected failure naming C1, as the reference's test fails.
- ``lora_toa_s``, the SNR draws and ``outage_probs``: exact.
- Every loss model's keep masks from the round key, node, leaf and ARQ
  attempt, drawn as one program (``frame_keeps``): exact against the
  reference's ``keep`` under the reference's key chain; the gilbert_keep
  plain version against the reference's scan on edge chains (length 1,
  p_enter = 0, loss_good > 0, uniforms equal to a threshold); a numpy
  transcription of the card kernel's warp scan of 2-bit state maps
  against both, at and around its 32-frame tiles.
- ``keep_masks``, ``arq_masks`` (a budget that ends inside the frame
  stream included) and ``deliver``'s delivered delta against the jitted,
  node-vmapped reference: masks, bytes and retransmits exact; airtime
  exact where the reference sums it in the order the port transcribes
  (ROADMAP C18), else within rtol 1e-6.
- A lossless transport (erasure 0, with or without ARQ) is bitwise the
  run without one, on the host and the scan engine (the reference's
  ``test_erasure_zero_is_bitwise_teleport``).
"""
import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import faults
import torch_faults
from repro.config import TransportConfig as JaxTransportConfig
from repro.core import transport as jt
from repro.core.compression import parse_pipeline as jax_parse_pipeline
from repro.core.gossip import plan_mixer as jax_plan_mixer
from repro.core.topology import build_topology as jax_build_topology
from repro.config import TopologyConfig as JaxTopologyConfig
from repro_torch import random
from repro_torch.config import TransportConfig
from repro_torch.core import transport as pt
from repro_torch.core.compression import parse_pipeline
from repro_torch.kernels.gilbert import channel_params, gilbert_keep_plain
from repro_torch.utils.tree import tree_leaves

import torch_threads  # noqa: F401  (one torch thread a process)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
EXAMPLES = settings(max_examples=30, deadline=None)


def _payload_bytes(nbytes: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed * 7919 + nbytes)
    return rng.integers(0, 256, nbytes, np.uint8).tobytes()


def _port_key(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


# -- the host byte codec ------------------------------------------------------

@EXAMPLES
@given(nbytes=st.integers(min_value=0, max_value=3000),
       mtu=st.integers(min_value=9, max_value=300),
       seed=st.integers(min_value=0, max_value=10 ** 6))
def test_fragment_is_the_references_and_round_trips(nbytes, mtu, seed):
    data = _payload_bytes(nbytes, seed)
    frames = pt.fragment(data, mtu)
    assert frames == jt.fragment(data, mtu)
    sizes = pt.frame_sizes(nbytes, mtu)
    assert sizes.tolist() == jt.frame_sizes(nbytes, mtu).tolist()
    assert [len(f) for f in frames] == sizes.tolist()
    assert pt.num_frames(nbytes, mtu) == len(frames)
    shuffled = list(frames)
    np.random.default_rng(seed).shuffle(shuffled)
    out, received = pt.reassemble(shuffled, nbytes, mtu)
    assert out == data and received.all()


@EXAMPLES
@given(nbytes=st.integers(min_value=1, max_value=3000),
       mtu=st.integers(min_value=9, max_value=300),
       seed=st.integers(min_value=0, max_value=10 ** 6))
def test_reassemble_with_dropped_subset_is_the_references(nbytes, mtu, seed):
    frames = pt.fragment(_payload_bytes(nbytes, seed), mtu)
    rng = np.random.default_rng(seed + 1)
    drop = set(rng.choice(len(frames), size=rng.integers(0, len(frames) + 1),
                          replace=False).tolist())
    kept = [None if i in drop else f for i, f in enumerate(frames)]
    out, received = pt.reassemble(kept, nbytes, mtu)
    want, want_received = jt.reassemble(kept, nbytes, mtu)
    assert out == want
    assert received.tolist() == want_received.tolist() == [
        i not in drop for i in range(len(frames))]


@EXAMPLES
@given(nbytes=st.integers(min_value=1, max_value=800),
       mtu=st.integers(min_value=9, max_value=120),
       seed=st.integers(min_value=0, max_value=10 ** 6))
def test_crc_rejects_payload_corruption(nbytes, mtu, seed):
    """A flipped bit in a frame's payload kills exactly that frame."""
    frames = pt.fragment(_payload_bytes(nbytes, seed), mtu)
    rng = np.random.default_rng(seed + 2)
    victim = int(rng.integers(0, len(frames)))
    frame = bytearray(frames[victim])
    pos = int(rng.integers(pt.HEADER_BYTES, len(frame)))
    frame[pos] ^= 1 + int(rng.integers(0, 255))
    corrupted = list(frames)
    corrupted[victim] = bytes(frame)
    _, received = pt.reassemble(corrupted, nbytes, mtu)
    assert not received[victim] and received.sum() == len(frames) - 1


@pytest.mark.xfail(strict=True, reason="ROADMAP C1: the frame CRC covers the "
                   "payload only, so a flipped SEQ bit passes the check, as "
                   "in the reference (tests/test_transport.py::"
                   "test_crc_rejects_corruption)")
def test_crc_rejects_header_corruption():
    """The reference's property with the flipped bit in a header: frame 2's
    SEQ made 0, so its payload lands on frame 0's bytes."""
    data = _payload_bytes(200, 3)
    frames = pt.fragment(data, 64)
    frame = bytearray(frames[2])
    frame[2] ^= 0x02                        # SEQ 2 -> 0
    corrupted = list(frames)
    corrupted[2] = bytes(frame)
    out, received = pt.reassemble(corrupted, 200, 64)
    assert not received[2] and received.sum() >= len(frames) - 1
    cap = 64 - pt.HEADER_BYTES
    for i in np.flatnonzero(received):
        assert out[i * cap:(i + 1) * cap] == data[i * cap:(i + 1) * cap]


def test_parse_frame_edges_are_the_references():
    frame, = pt.fragment(b"hello world", 64)
    for f in (frame, frame[:5], frame[:-1], frame + b"x",
              frame[:8] + b"jello world"):
        assert pt.parse_frame(f) == jt.parse_frame(f)
    assert pt.parse_frame(frame) == (0, b"hello world")
    assert pt.fragment(b"", 32) == jt.fragment(b"", 32)
    assert pt.frame_sizes(0, 32).tolist() == [8]
    with pytest.raises(ValueError, match="header"):
        pt.fragment(b"abc", 8)
    with pytest.raises(ValueError, match="uint16"):
        pt.fragment(bytes(65537), 9)


def _demo_payloads():
    """The reference golden test's payload (``block_topk|sign`` at ratio
    0.25, blocks of 8, two leaves) from both packages, the port's as a
    one-node stack."""
    tree = {"a": np.linspace(-1.0, 1.0, 48, dtype=np.float32).reshape(4, 12),
            "b": np.linspace(0.5, -0.5, 11, dtype=np.float32)}
    ref = jax_parse_pipeline("block_topk|sign", ratio=0.25, block_size=8)
    port = parse_pipeline("block_topk|sign", ratio=0.25, block_size=8)
    return (ref.encode(jax.tree.map(jnp.asarray, tree),
                       jax.random.PRNGKey(0)),
            port.encode({k: torch.from_numpy(v)[None]
                         for k, v in tree.items()}))


def test_serialize_payload_is_the_references_and_the_golden_frames():
    ref, port = _demo_payloads()
    data = pt.serialize_payload(port)
    assert data == jt.serialize_payload(ref)
    assert len(data) == port.measured_bytes()
    frames = pt.fragment(data, 64)
    with open(os.path.join(GOLDEN_DIR, "transport_frames.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(GOLDEN_DIR, "transport_frames.bin"), "rb") as f:
        assert b"".join(frames) == f.read()
    assert [len(fr) for fr in frames] == manifest["frame_sizes"]
    assert [zlib.crc32(fr) & 0xFFFFFFFF for fr in frames] == \
        manifest["frame_crc32"]
    assert port.per_leaf_bytes() == manifest["per_leaf_bytes"]


def test_sign_scale_of_short_rows_is_the_references():
    """ROADMAP C19: the sign stage's scale ``mean(|x|)`` over a row of at
    most 32 elements equals the jitted reference's bit for bit (XLA sums
    such a row in order), at every length from 1 to 32."""
    from repro.core.compression import SignCodec as JaxSignCodec
    from repro_torch.core.compression import SignCodec
    rng = np.random.default_rng(19)
    for n in range(1, 33):
        x = (rng.standard_normal((6, n)) * rng.random()).astype(np.float32)
        want = jax.jit(jax.vmap(lambda r: JaxSignCodec().encode(
            r, None)[1]["scale"]))(jnp.asarray(x))
        got = SignCodec().encode(torch.from_numpy(x))[1]["scale"]
        np.testing.assert_array_equal(got.numpy().reshape(-1),
                                      np.asarray(want).reshape(-1))


@pytest.mark.parametrize("mtu", [16, 48, 256])
def test_static_framing_matches_the_host_codec(mtu):
    _, port = _demo_payloads()
    transport = pt.LossyTransport(TransportConfig(mtu=mtu), num_nodes=1)
    data = pt.serialize_payload(port)
    offset = 0
    for nbytes in port.per_leaf_bytes():
        frames = pt.fragment(data[offset:offset + nbytes], mtu)
        offset += nbytes
        fr = transport.leaf_framing(nbytes, (nbytes,))
        want = jt.LossyTransport(JaxTransportConfig(mtu=mtu)).leaf_framing(
            nbytes, (nbytes,))
        assert fr.frame_bytes.tolist() == [len(f) for f in frames]
        assert fr.record_frame.tolist() == want.record_frame.tolist()


# -- time on air, SNR ------------------------------------------------------------

def test_lora_toa_and_snr_outage_are_the_references():
    sizes = np.arange(0, 300, 7)
    for sf in (6, 7, 9, 11, 12):
        for cr in (1, 4):
            np.testing.assert_array_equal(
                pt.lora_toa_s(sizes, sf=sf, coding_rate=cr, bw_hz=250e3),
                jt.lora_toa_s(sizes, sf=sf, coding_rate=cr, bw_hz=250e3))
    for bad in (dict(sf=5), dict(sf=13), dict(coding_rate=0)):
        with pytest.raises(ValueError):
            pt.lora_toa_s(25, **bad)
    omega = jax_build_topology(JaxTopologyConfig(graph="geometric",
                                                 radius=0.5), 10).omega
    _, sched = jax_plan_mixer(omega, None, force_tv=True)
    for snr, spread, seed in ((10.0, 4.0, 0), (3.0, 0.0, 5), (0.0, 8.0, 2)):
        kw = dict(snr_db=snr, snr_spread_db=spread, seed=seed)
        want = jt.LossyTransport(JaxTransportConfig(**kw), num_nodes=10)
        got = pt.LossyTransport(TransportConfig(**kw), num_nodes=10)
        np.testing.assert_array_equal(got.snr_per_node(),
                                      want.snr_per_node())
        np.testing.assert_array_equal(got.outage_probs(sched),
                                      want.outage_probs(sched))


def test_static_accounting_is_the_references():
    for kw in (dict(), dict(toa=True), dict(mtu=64, toa=True, sf=9),
               dict(phy_rate_bps=50e3, tx_power_w=0.025)):
        want = jt.LossyTransport(JaxTransportConfig(**kw)).account_dense(
            24_000)
        got = pt.LossyTransport(TransportConfig(**kw)).account_dense(24_000)
        assert [float(x) for x in got] == [float(x) for x in want]


# -- the loss models -------------------------------------------------------------

MODELS = {
    "bernoulli": jt.BernoulliLoss(rate=0.3),
    "per-node": jt.BernoulliLoss(rate=(0.0, 0.5, 1.0, 0.2)),
    "gilbert": jt.GilbertElliottLoss(p_enter=0.2, p_exit=0.4),
    "gilbert-good-loss": jt.GilbertElliottLoss(p_enter=0.0, p_exit=0.3,
                                               loss_good=0.25, loss_bad=1.0),
    "fixed": jt.FixedMaskLoss(drop=(0, 3, 40)),
    "dead": jt.DeadNodeLoss(base=jt.BernoulliLoss(0.1), dead=(2,)),
    "drop-first": jt.DropFirstAttemptLoss(
        base=jt.GilbertElliottLoss(p_enter=0.1), attempts=1),
}


def _reference_keeps(model, kround, frames, attempts, k):
    """The reference's masks, key chain of ``arq_masks``: (K, A, F_i)."""
    kloss = jax.random.fold_in(jax.random.split(kround)[0], jt.TRANSPORT_SALT)
    out = []
    for i, f in enumerate(frames):
        rows = []
        for node in range(k):
            kleaf = jax.random.fold_in(jax.random.fold_in(kloss, node), i)
            rows.append([np.asarray(model.keep(
                kleaf if a == 0 else jax.random.fold_in(kleaf, a), f,
                jnp.int32(node), attempt=a)) for a in range(attempts)])
        out.append(np.asarray(rows))
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_loss_model_masks_are_the_references(name):
    model = MODELS[name]
    frames, attempts, k = (1, 7, 60), 3, 4
    transport = pt.LossyTransport(TransportConfig(arq=True, max_retries=2),
                                  num_nodes=k,
                                  model=torch_faults.port_model(model))
    assert transport.model.lossy == model.lossy
    kround = jax.random.PRNGKey(11)
    got = transport.frame_keeps(_port_key(kround), frames, k)
    want = _reference_keeps(model, kround, frames, attempts, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def _scan_reference(u0, ut, ul, p_enter, p_exit, loss_good, loss_bad):
    """The reference's burst-channel scan (``transport.py:255-273``) on
    given uniforms."""
    pi_bad = p_enter / max(p_enter + p_exit, 1e-12)
    bad0 = (jnp.asarray(u0) < pi_bad).astype(jnp.float32)

    def step(bad, us):
        t, l_ = us
        keep = (l_ >= jnp.where(bad > 0.5, loss_bad, loss_good)).astype(
            jnp.float32)
        bad = jnp.where(t < jnp.where(bad > 0.5, p_exit, p_enter),
                        1.0 - bad, bad)
        return bad, keep
    return np.asarray(jax.lax.scan(step, bad0, (jnp.asarray(ut),
                                               jnp.asarray(ul)))[1])


@pytest.mark.parametrize("params", [(0.05, 0.3, 0.0, 1.0), (0.0, 0.3, 0.2,
                                                             1.0),
                                    (0.5, 0.5, 0.1, 0.9), (1.0, 0.0, 0.0,
                                                           1.0)])
def test_gilbert_plain_version_is_the_references_scan(params):
    """Ragged chains (lengths 1, 2, 17, 40), three rows each, and uniforms
    set to the thresholds themselves."""
    rng = np.random.default_rng(int(sum(params) * 100))
    consts = np.float32([*channel_params(*params)])
    lengths = (1, 2, 17, 40)
    rows = 3
    u0 = rng.random((rows, len(lengths))).astype(np.float32)
    u0[0] = consts[0]
    ut, ul = [], []
    for n in lengths:
        a = rng.random((rows, n)).astype(np.float32)
        b = rng.random((rows, n)).astype(np.float32)
        a[1, ::2] = consts[1]
        a[1, 1::2] = consts[2]
        b[2, ::2] = consts[3]
        b[2, 1::2] = consts[4]
        ut.append(a)
        ul.append(b)
    got = gilbert_keep_plain(torch.from_numpy(u0),
                             [torch.from_numpy(a) for a in ut],
                             [torch.from_numpy(b) for b in ul],
                             channel_params(*params))
    for i in range(len(lengths)):
        for r in range(rows):
            want = _scan_reference(u0[r, i], ut[i][r], ul[i][r], *params)
            np.testing.assert_array_equal(got[i][r].numpy(), want)


# -- the card kernel's warp scan, transcribed (csrc/gilbert.cu) -------------

_LANES, _IDENTITY = 32, 2     # a warp; the map good -> good, bad -> bad


def _compose(g, f):
    """The 2-bit map "g after f" (bit s is the image of state s)."""
    return ((g >> (f & 1)) & 1) | (((g >> (f >> 1)) & 1) << 1)


def _warp_scan_keep(u0, ut, ul, consts):
    """gilbert_keep_kernel's arithmetic on one chain: tiles of 32 frames,
    one a lane; each frame's map ``(u_t < p_enter) | (!(u_t < p_exit) <<
    1)``, identity past n; a Hillis–Steele inclusive scan (``__shfl_up_sync``
    returns a lane below d its own value, which it does not compose); the
    exclusive prefix applied to the tile's incoming state; lane 31's
    inclusive map carries the state."""
    pi_bad, p_enter, p_exit, loss_good, loss_bad = np.float32(consts)
    n = len(ut)
    lane = np.arange(_LANES)
    bad = int(np.float32(u0) < pi_bad)
    keep = np.empty(n, np.float32)
    for t0 in range(0, n, _LANES):
        t = t0 + lane
        live = t < n
        a = np.where(live, ut[np.minimum(t, n - 1)], np.float32(0))
        b = ul[np.minimum(t, n - 1)]
        inc = np.where(live, (a < p_enter).astype(np.int64)
                       | (~(a < p_exit)).astype(np.int64) << 1, _IDENTITY)
        d = 1
        while d < _LANES:
            earlier = np.where(lane >= d, np.roll(inc, d), inc)
            inc = np.where(lane >= d, _compose(inc, earlier), inc)
            d <<= 1
        excl = np.where(lane == 0, _IDENTITY, np.roll(inc, 1))
        before = (excl >> bad) & 1
        k = (b >= np.where(before == 1, loss_bad, loss_good)).astype(
            np.float32)
        keep[t[live]] = k[live]
        bad = int((inc[-1] >> bad) & 1)
    return keep


GILBERT_CHANNELS = [(0.05, 0.3, 0.0, 1.0), (0.0, 0.3, 0.2, 1.0),
                    (0.5, 0.5, 0.1, 0.9), (1.0, 0.0, 0.0, 1.0),
                    (1.0, 1.0, 0.3, 0.6), (0.6, 0.3, 0.1, 0.9)]
TILE_LENGTHS = (1, 2, 31, 32, 33, 64, 65, 335, 690)


@pytest.mark.parametrize("params", GILBERT_CHANNELS)
def test_warp_scan_is_the_plain_version_and_the_references_scan(params):
    """The kernel's tile scan, transcribed, against the frame loop and the
    reference's ``lax.scan``, bit for bit: chains at and around the tile
    boundaries, both start states (the first row's start uniform is π_bad
    itself), and the thresholds among the uniforms. The maps of the first
    and last channels do not commute (flip and clear, flip and set-bad), so
    a scan that composes in the wrong order fails there."""
    rng = np.random.default_rng(int(sum(params) * 1000) + 7)
    consts = channel_params(*params)
    rows = 3
    u0 = rng.random((rows, len(TILE_LENGTHS))).astype(np.float32)
    u0[0] = consts[0]
    ut, ul = [], []
    for n in TILE_LENGTHS:
        a = rng.random((rows, n)).astype(np.float32)
        b = rng.random((rows, n)).astype(np.float32)
        a[1, ::3], a[1, 1::3] = consts[1], consts[2]
        b[2, ::2], b[2, 1::2] = consts[3], consts[4]
        ut.append(a)
        ul.append(b)
    plain = gilbert_keep_plain(torch.from_numpy(u0),
                               [torch.from_numpy(a) for a in ut],
                               [torch.from_numpy(b) for b in ul], consts)
    for i, n in enumerate(TILE_LENGTHS):
        for r in range(rows):
            got = _warp_scan_keep(u0[r, i], ut[i][r], ul[i][r], consts)
            np.testing.assert_array_equal(got, plain[i][r].numpy())
            np.testing.assert_array_equal(
                got, _scan_reference(u0[r, i], ut[i][r], ul[i][r], *params))


def test_the_channels_reach_the_four_maps():
    """Between them the channels give every frame map, keep (0b10), flip
    (0b01), set-bad (0b11) and clear (0b00), and the composition is
    associative with 0b10 its identity."""
    u = np.linspace(0, 1, 1001, dtype=np.float32)
    seen = set()
    for params in GILBERT_CHANNELS:
        _, p_enter, p_exit, _, _ = np.float32(channel_params(*params))
        seen |= set(((u < p_enter).astype(int)
                     | (~(u < p_exit)).astype(int) << 1).tolist())
    assert seen == {0, 1, 2, 3}
    for f in range(4):
        assert _compose(f, _IDENTITY) == f == _compose(_IDENTITY, f)
        for g in range(4):
            for h in range(4):
                assert _compose(h, _compose(g, f)) == \
                    _compose(_compose(h, g), f)


# -- keep masks, ARQ and the delivered delta ---------------------------------------

K = 10
TREE_SHAPES = {"a": (300, 7), "b": (50,), "c": (9000,), "d": (3,)}
ARQ_CASES = {
    "bernoulli": (dict(erasure=0.3, mtu=64), None),
    "gilbert-toa": (dict(loss_model="gilbert", mtu=64, toa=True), None),
    "arq": (dict(erasure=0.3, arq=True, max_retries=2, mtu=48), None),
    "arq-budget-cut": (dict(erasure=0.3, arq=True, max_retries=2, mtu=48,
                            round_period_s=0.05), None),
    "arq-gilbert-toa-budget": (dict(loss_model="gilbert", arq=True, toa=True,
                                    mtu=64, duty_cycle=0.5,
                                    round_period_s=4.0), None),
    "arq-backoff": (dict(erasure=0.3, arq=True, max_retries=2, mtu=48,
                         arq_backoff_s=0.01, round_period_s=0.05), None),
    "first-attempt-cut": (dict(arq=True, max_retries=1, mtu=48, toa=True,
                               round_period_s=1.0), None),
    "drop-first": (dict(arq=True, max_retries=1, mtu=64),
                   jt.DropFirstAttemptLoss(attempts=1)),
}


CODECS = {"block_topk": dict(),
          "block_topk|qsgd": dict(pipeline="block_topk|qsgd"),
          "fused-block_topk|qsgd": dict(pipeline="block_topk|qsgd",
                                        fused_compress=True)}


@pytest.fixture(scope="module")
def payloads():
    """Each codec's payload of one random tree in both packages, encoded
    from ``(θ, 0)`` as a round encodes, node k under ``fold_in(key, k)``."""
    from repro.config import FedConfig as JaxFedConfig
    from repro.core.compression import make_compressor as jax_compressor
    from repro_torch.config import FedConfig
    from repro_torch.core.compression import draw_uniforms, make_compressor
    rng = np.random.default_rng(0)
    tree = {k: rng.standard_normal((K,) + s).astype(np.float32)
            for k, s in TREE_SHAPES.items()}
    jtree = jax.tree.map(jnp.asarray, tree)
    ptree = {k: torch.from_numpy(v) for k, v in tree.items()}
    key = jax.random.PRNGKey(3)
    out = {}
    for name, kw in CODECS.items():
        kw = dict(kw, compress_ratio=0.05, block_size=256)
        ref, port = (jax_compressor(JaxFedConfig(**kw)),
                     make_compressor(FedConfig(**kw)))
        jpay = jax.jit(jax.vmap(ref.encode_pair))(
            jtree, jax.tree.map(jnp.zeros_like, jtree),
            jax.random.split(key, K))
        ppay = port.encode_pair(
            ptree, {k: torch.zeros_like(v) for k, v in ptree.items()},
            draw_uniforms(port, _port_key(key), ptree))
        out[name] = (ref, port, jpay, ppay)
    return key, out


@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("case", list(ARQ_CASES))
def test_masks_and_delivered_delta_are_the_references(case, codec, payloads):
    """Masks through each codec's stage-0 decode (unpack_set, and the fused
    codec's unpack), bytes and retransmits exact; airtime exact but with a
    backoff (XLA fuses that add elsewhere), energy within rtol 1e-6."""
    key, all_payloads = payloads
    ref_pipe, port_pipe, jpay, ppay = all_payloads[codec]
    kw, model = ARQ_CASES[case]
    jtrans = jt.LossyTransport(JaxTransportConfig(**kw), num_nodes=K,
                               model=model)
    ptrans = torch_faults.port_transport(jtrans, K)
    assert ppay.per_leaf_bytes() == [int(b) for b in jpay.per_leaf_bytes()]
    kql = jax.random.split(key)[0]
    tkeys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.fold_in(kql, jt.TRANSPORT_SALT), i))(jnp.arange(K))
    deliver = jax.jit(jax.vmap(lambda p, k, n: jtrans.deliver(
        ref_pipe, p, k, n)))
    jfull, jdel, jm = deliver(jpay, tkeys, jnp.arange(K))
    plan = ptrans.plan(ppay)
    keeps = ptrans.frame_keeps(_port_key(key), plan.frames, K)
    full, delivered, m = ptrans.deliver(port_pipe, ppay, keeps)
    for name in ("offered", "delivered", "retransmits", "abandoned"):
        want = np.broadcast_to(np.asarray(getattr(jm, name)), (K,))
        np.testing.assert_array_equal(
            np.broadcast_to(np.asarray(getattr(m, name)), (K,)), want,
            err_msg=name)
    for name in ("airtime_s", "energy_j"):
        want = np.broadcast_to(np.asarray(getattr(jm, name)), (K,))
        got = np.broadcast_to(np.asarray(getattr(m, name)), (K,))
        if case == "arq-backoff" or name == "energy_j":
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    # the delivered delta is the full decode times the reference's keep
    # mask (exact), and the full decode the reference's: exactly for the
    # top-k codec, within rtol 1e-6 under QSGD (its scale's summation
    # order, tests/test_torch_codecs.py)
    for g, f, w, wf in zip(tree_leaves(delivered), tree_leaves(full),
                           jax.tree.leaves(jdel), jax.tree.leaves(jfull)):
        w, wf = np.asarray(w), np.asarray(wf)
        keep = np.where(wf != 0, (w != 0).astype(np.float32), 0.0)
        np.testing.assert_array_equal(g.numpy(), f.numpy() * keep)
        if codec == "block_topk":
            np.testing.assert_array_equal(f.numpy(), wf)
        else:
            np.testing.assert_allclose(f.numpy(), wf, rtol=1e-6, atol=0)


# -- a lossless transport is the teleport run --------------------------------------

@pytest.mark.parametrize("engine", ["host", "scan"])
@pytest.mark.parametrize("spec", [dict(mtu=32), dict(mtu=32, arq=True,
                                                     max_retries=2)])
def test_erasure_zero_is_bitwise_teleport(engine, spec):
    plain = torch_faults.run_port_world(engine, "cdbfl", rounds=6, chunk=4)
    framed = torch_faults.run_port_world(
        engine, "cdbfl", transport=JaxTransportConfig(**spec), rounds=6,
        chunk=4)
    for part in ("params", "v", "v_bar"):
        for a, b in zip(tree_leaves(getattr(plain.state, part)),
                        tree_leaves(getattr(framed.state, part))):
            assert torch.equal(a, b)
    np.testing.assert_array_equal(plain.losses, framed.losses)
    assert framed.offered[-1] > framed.wire[-1] > 0
    assert framed.delivered == framed.offered
    assert plain.offered == [0.0] * 6
    ref = faults.run_world(engine, "cdbfl",
                           transport=JaxTransportConfig(**spec), rounds=6,
                           chunk=4)
    assert framed.offered == ref.offered and framed.airtime == ref.airtime


def test_check_transport_refuses_legacy_compressors():
    from repro_torch.config import FedConfig
    from repro_torch.core.algorithms import make_round_fn
    from repro_torch.core.compression import make_compressor
    fed = FedConfig(num_nodes=4, compressor="qsgd_pallas",
                    transport=TransportConfig(erasure=0.1))
    with pytest.raises(ValueError, match="pipeline"):
        make_round_fn("cdbfl", torch_faults.linear_nll, fed,
                      np.full((4, 4), 0.25), make_compressor(fed),
                      device="cpu")
    assert struct.calcsize(pt.HEADER_FMT) == pt.HEADER_BYTES == 8
