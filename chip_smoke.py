#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each of which fails the run by raising:

1. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
             with nvcc for sm_90a; print the card's name and power limit.
2. kernels — the threefry draw kernel against its plain version, exactly:
             the full-width table of K x 10 Langevin noise streams and
             every transform at edge sizes (n = 1, 7, 4099), one launch a
             table, and the known answers of ``jax.random`` in
             ``tests/golden/threefry_draws.npz``. Then the seven ported
             TPU kernels (pack, delta-pack, unpack, fused_update,
             grid_quant, qsgd, block_topk) against their plain PyTorch
             versions on the card, exactly, at the main paths' full-width
             shapes (K=10: the 10 leaves; grid_quant the 10 packed (K, nb,
             11) carriers, grids and norms) and at edge cases (a ragged
             leaf, leaves shorter than a block, an all-zero leaf, a leaf of
             exact ties, a leaf with -0.0 entries; and, for pack,
             delta-pack, unpack and block_topk, leaves with NaN and ±inf
             blocks); pack, delta-pack and unpack also as one table launch
             over all those leaves mixed together (unpack with payloads
             that repeat indices, ROADMAP C7, added; k = 40 ones in a
             launch of their own), and qsgd and grid_quant as one over the
             finite ones, each exactly one launch. Time each beside its
             bound and its plain
             version, by CUDA events (host time per call included) and by
             the device time in profiler traces (the kernels alone, the
             median of three traces, each after profiled warm-up calls of
             at least 32 launches whose events are dropped, and each whole:
             it holds every launch the wrappers counted, or it is taken
             again); pack,
             delta-pack, unpack, qsgd and grid_quant as the round runs
             them, one table launch over the 10 leaves.
3. slice   — FedTrainer(engine="host", device="cuda", seed=0) on
             full-width lenet-radar
             (256x63, K=10, L=8, minibatch 10, ratio 1%, block 1024,
             η=1e-4, ζ=0.03, T=1) in four configurations, each run with the
             launch counts set to 0 just before it and read just after, its
             draws from the reference's keys (at most 6 threefry launches a
             round): block_topk with
             fused compression (4 rounds, BMA evaluation, 168,036 wire
             bytes per node per round), the block_topk|qsgd pipeline (4
             rounds, BMA evaluation, 84,058 bytes), and the legacy dense
             qsgd_pallas (2 rounds, 1,949,174 bytes) and block_topk_pallas
             (2 rounds, 155,934 bytes) compressors. Every value finite, the
             bytes exact, every kernel of each path launched, and
             delta-pack and unpack (the fused runs), grid_quant
             (block_topk|qsgd) and qsgd (qsgd_pallas) once a round. The
             block_topk run's first two rounds against the reference's
             seeded run recorded on the CPU
             (``tests/golden/seeded_rounds_lenet_radar.json``): bytes exact,
             loss and consensus error within rtol 1e-3. Then one round's
             draws timed: the threefry launches of its key derivation and
             draws, against their plain version and their bound, and the
             host time of the derivation.
4. oracle  — one round of each pipeline from its run's state through
             FusedCodec(fused=False), which runs the pack kernel (and QSGD's
             own torch arithmetic) and unpacks with one launch: its payload
             and params equal the fused round's bit for bit. The card's
             decode of the block_topk|qsgd payload equals the plain CPU
             decode of the same payload.
5. graph   — each configuration's phase-3 run again with engine="scan"
             (same seed, rounds and bank_thin; chunks of rounds / 2, so
             the second chunk replays the first's CUDA graph), its launch
             counts set to 0 just before and read just after (the warm-up
             round and the capture count them): params, v, v̄, key, bank,
             per-round loss and consensus error, bytes, BMA probabilities
             and every field of the evaluation's report (ECE, MCE and
             overconf_gap included) equal to the host run's bit for bit.
             Each trainer evaluates through the scan eval engine, a CUDA
             graph of the whole eval. Then
             the replayed chunk: ms a round (the metrics read included), its
             device time by CUDA events around graph.replay() and the idle
             share, the capture time, the host time of graph.replay(), and
             from a trace of a replay each ported kernel's launches and
             device ms a round inside it (delta-pack, unpack, grid_quant and
             qsgd once a round, fused_update and block_topk ten times,
             threefry at most 6). Last, block_topk with FedTrainer's
             defaults (chunks of 64, a bank of 40): 128 rounds, two runs.
6. profile — traced rounds (block_topk fused, its oracle, block_topk|qsgd,
             qsgd_pallas, block_topk_pallas), each with its draws: the
             device's busy share, the top kernels, each ported kernel's and
             the draw kernel's device time in a round, and torch's norm
             reductions (none in the block_topk|qsgd round: its norms are
             grid_quant's).
7. default — the paper's default run and its two baselines: FedConfig's
             default fused_compress=False (the lax.top_k-order block_topk
             codec) under algorithm cdbfl, dsgld and cffl, at phase 3's
             configuration, 4 rounds each (burn-in 2): bytes exact (167,682,
             10,395,384 and 167,682), each kernel of the path launched
             (topk_select and unpack_set once a round), the bank for cdbfl
             and dsgld only, rounds 1-2 against the reference's seeded CPU
             runs (``tests/golden/baseline_rounds_lenet_radar.json``: bytes
             exact, loss and consensus error within rtol 1e-3); again on the
             scan engine (chunks of 2), bit for bit, the evaluations' reports
             field for field; accuracy and ECE on the day-1 test maps and
             on the days-2/3 critical_subset shift set, printed; the
             replayed chunk's ms a round, device ms and idle
             share, as phase 5 times them; for cdbfl, the share of blocks
             of params − v that leave topk_select's fast path. Then one
             cdbfl round of each other codec with its bytes exact: topk
             207,498, randk 104,056, sign 649,756, qsgd 2,598,886,
             identity 10,395,384, unfused block_topk|qsgd 83,881.
8. serve   — the posterior served on the card, from a cdbfl run of phase
             7's configuration on the scan engine (a bank of 2 samples x
             K=10), its launch counts set to 0 just before the run and read
             after the CLI: the ScanEvalEngine (one CUDA graph of the whole
             eval) against the HostEvalEngine on the 200 day-1 maps and the
             303 shift maps, probabilities and every report field bit for
             bit, each engine timed; FedTrainer.predictor().predict against
             eval_report(return_probs=True), bit for bit; a ClassifyEngine
             with 64 slots over the 200 day-1 maps, bit-equal to the scan
             eval, its entropies predictive_entropy's within rtol 1e-6;
             one with 8 slots, 32 requests and entropy_threshold 1.2
             (requests/s, p50 and p99 ms, the abstain rate, the device ms
             of one predict replay), no recapture after the warm-up at full,
             partial and single occupancy; 8 same-size hot swaps with
             torch.cuda.memory_allocated flat, no recapture, bank_version
             counted; save_bank and load_bank of the bank, bit for bit, its
             probabilities unchanged; the serving CLI in-process, on a
             synthetic full-width bank (its first 8 answers against the
             reference's, tests/golden/serve_bma_lenet_radar.npz, within
             rtol 1e-4, the argmax exact) and on a directory of two
             snapshots with --follow-snapshots (a swap mid-stream). Last,
             whether the eval and serve contracts hold with cuDNN's and
             TF32's defaults, logged.
9. train   — the graph families and the training CLI at phase 3's
             configuration: the reference's recorded rounds 1-2
             (``tests/golden/topology_rounds_lenet_radar.json``) of
             FedConfig()'s cdbfl on the ring (the roll lowering, ROADMAP
             C14) and of cdbfl and dsgld on the geometric graph of radius
             0.5 with link dropout 0.1 and 2 gossip pairs (7 matchings),
             each on the host engine: bytes and each round's (M, K) masks
             (those the engine hands the round) exact, loss and consensus
             within rtol 1e-3, gossip_mix launched once a round, at
             most 6 threefry launches a round; the cdbfl geometric run
             on the scan engine (chunks of 2) against its host run bit
             for bit; then ``repro_torch.launch.train`` with
             the recorded flags (--fused-compress, per-layer
             fc1=block_topk|qsgd, a bank of 2, evals at 2 and 4), its
             launch counts set to 0 just before and read just after: its
             arch=, wire accounting: and topology= lines equal to the
             reference CLI's, delta-pack, unpack, grid_quant,
             fused_update, threefry and gossip_mix launched (gossip_mix
             once a mix: 3), and
             ``repro_torch.launch.serve`` serving its snapshot; last, the
             default cdbfl run on the full graph, the ring and the
             geometric graph static and time-varying: a replayed chunk's
             ms a round, device ms and idle, the mixer's ms a round (a
             trace's device time and CUDA events), and
             threefry's and gossip_mix's launches a round (gossip_mix
             once a round on the sparse graphs, never on the full one).
10. link   — the lossy D2D transport and barrier-free rounds at phase
             3's configuration on phase 9's time-varying geometric graph
             (``tests/golden/transport_rounds_lenet_radar.json``, the
             reference's recorded rounds 1-2): (a) FedConfig()'s cdbfl
             under Bernoulli erasure 0.1 at MTU 256; (b) the fused
             block_topk|qsgd pipeline under the Gilbert-Elliott channel
             with ARQ (2 retries), SF7 time-on-air and a 165 s airtime
             budget that cuts the last attempt; (c) cdbfl and dsgld under
             the SNR outage model (10 ± 4 dB) with stragglers 0.2 and
             deaths ((3, 2, -1), (7, 1, 3)). Each on the host engine, 4
             rounds, its launch counts set to 0 just before and read
             just after: offered, delivered and abandoned bytes,
             retransmits, each round's participation vector and (M, K)
             masks exact; loss and consensus within rtol 1e-3; airtime
             and energy within rtol 1e-6 (exactness logged); every kernel
             of its path launched, gossip_mix once a mix, gilbert_keep
             once a round in (b), the keep records' decode and threefry
             at their stated counts (5, 6, 5, 5 a round). Then each on
             the scan engine (chunks of 2) bit for bit against its host
             run, its replayed chunk timed beside the same run without
             transport and participation, a traced host round beside
             one of that run; last the training CLI with the transport
             and participation flags (two rounds), its header, link and
             accounting lines equal to the reference CLI's.
11. bf16   — control variates in bfloat16 (FedConfig.control_dtype),
             the scenario matrix, the evaluate CLI and the quickstart:
             (a) the bf16 forms of topk_select, delta-pack (v read as
             bf16) and fused_update, cffl_update (Eqs. 7-9 from the bf16
             v, v̄ and the round's f32 deltas, ROADMAP C23) against their
             plain versions, bit for bit, on the 10 full-width leaves at
             K=10 and phase 2's edge leaves, with NaN and ±inf in the
             bf16 v, then one table launch each of topk_select and
             delta-pack; each timed over the round's leaves beside its
             f32 twin's phase-2 time and its bound; (b) the paper-default
             cdbfl, the fused block_topk and cffl with bf16 control
             variates at full width, 4 rounds on the host engine and on
             the scan engine (chunks of 2), bit for bit; rounds 1-2
             against the reference's CPU run
             (``tests/golden/bf16_rounds_lenet_radar.json``, a 2-round
             run: bytes exact; loss and consensus within rtol 2e-6, ‖v‖
             and ‖v̄‖ after round 2 within 5e-7 (cffl: 3e-6), limits
             which the same run with f32 control variates exceeds); each
             run's launch
             counts set to 0 just before and read just after: every bf16
             form of its path launched and its f32 twin never; the
             control state's bytes and a replayed round beside phase 7's
             f32 run; (c) the reference's claims gate
             (``run_claims_smoke(CLAIMS_SPEC)``: reduced LeNet, 60 rounds
             of cdbfl and cffl) on the card at seeds 0 and 1, the shifted
             cell re-scored bit for bit and every ECE finite, its cells,
             claims and per-round loss beside the reference's
             (``tests/golden/claims_smoke_lenet_radar.json``);
             (d) the evaluate CLI in-process (``--quick --scenarios
             clean,day23_critical --severities 1.0``) and on a full-width
             checkpoint of (b)'s cdbfl run, scored at full width; (e)
             ``examples/quickstart.py``'s program on the port
             (``tests/torch_quickstart.py``, K=8, 400 rounds): relative
             error below 0.1 and the reference's 336 bytes a round.
12. drift  — drift, continual posteriors and unlearning (ROADMAP A9):
             phase 7's cdbfl with burn-in 1 and bank thin 1 under a
             days-2/3 critical drift at full severity in round 1 only
             (a piecewise schedule back to its base pool in round 2; a
             2-round bank window, age decay 0.9). (a) The host engine, 4
             rounds, its launch counts set to 0 just before and read just
             after: rounds 1-3 against the reference's CPU run
             (``tests/golden/drift_rounds_lenet_radar.json``: bytes
             exact, loss and consensus within rtol 1e-3, each round's
             severity exact), the caller's pool untouched. (b) The scan
             engine, chunks split at the segments (lengths 1, 1, 2: the
             chunk of 1 captured and replayed), bit for bit the host run
             (params, v, v̄, key, bank slots and rounds, loss, consensus,
             bytes); its own pool equal to the base pool from round 2 on
             (ROADMAP C26); the aged scan eval against the host eval on
             the day-1 and shift sets and the weighted predictor against
             the eval, bit for bit. (c) ``unlearn(9)`` on the host, the
             scan (f32 bank) and an int8-bank scan run: the node's rows
             zero (int8 scales 1.0), the reports moved and equal across
             the f32 engines, 2 more rounds bit for bit, no chunk length
             captured again. (d) A replayed chunk on the drifted pool
             beside the run without ``continual``, in turns; a phase
             refresh's synthesis, upload and ``set_shards`` times; the
             ``set_shards`` copy against its byte bound; ``unlearn``'s
             ms. (e) The README's two drift commands through the train
             CLI at full width, 4 rounds: header, drift and bank lines
             equal to the reference CLI's, eval lines' fields equal and
             numbers within one example and 1e-3. (f) The drift-recovery
             gate and the unlearn oracle on the card beside the
             reference's record (``tests/golden/drift_claims_lenet_radar
             .json``): probes finite, the drift biting, no claim broken
             that the reference keeps (it breaks the recovery claim
             itself: ROADMAP C27), the oracle within tolerance.
13. decode — BMA decode serving of smollm-135m at full width (ROADMAP
             A12, part 1), its launch counts set to 0 just before each
             engine run and read just after, the whole phase with TF32
             and reduced-precision bf16 reductions allowed for the
             process (the model sums its own products in f32): (a) the
             serving CLI's bank of
             4 inits from fold_in(PRNGKey(0), i) made on the card, each
             leaf's bit sum and sampled elements equal to the reference's
             (``tests/golden/decode_smollm_135m.json``, its CPU run), the
             float64 sum within 1e-12; (b) DecodeEngine at 8 and 64 slots,
             max_len 128, 16 new tokens, over the CLI's 16 requests, in
             bf16 and f32: the first step (eager, then captured) alone,
             its BMA log p at the record's top-8 within 5e-3 (f32: the
             bf16 KV caches, ROADMAP C29) or 5e-2 (bf16), then the rest:
             tokens equal to the record's up to each request's first step
             whose recorded top-two margin is at or under the tolerance
             (1e-4 f32, 5e-2 bf16), entropies within rtol 1e-5 / 1e-3,
             one capture in all through partial occupancy and lengths 1-5,
             decode_attention and bma_sample launched; a replayed step's
             device ms (CUDA events) and trace (its kernels by name), the
             median wall ms a step, tokens/s, request p50 / p99, against
             the weight-byte bound; 8 hot swaps with memory_allocated
             flat to the byte; a witness, the port's first step on the
             host CPU at 8 slots in each dtype, its log p against the
             record's (the same limits) and the card's, and its cached
             position-0 keys and values counted against the card's; (c)
             ``repro_torch.launch.serve --arch smollm-135m --mode decode
             --requests 16 --smoke`` in-process, its resp lines equal to
             the record's but for latency wherever the request has no
             low-margin step; (d) the LM eval on markov
             tokens, the scan engine's CUDA graph against the host engine
             bit for bit.
15. vlm    — llava-next-mistral-7b (ROADMAP A12 part 3): (a) the
             reference's reduced-width f32 rounds on {tokens, patches}
             pools (``tests/golden/lm_families_reduced.json``): bytes and
             v's survivors exact, losses and consensus within 1e-5, θ at
             the record's picks within 5e-4, scan = host; (b) full width
             at 2 layers against ``tests/golden/vlm_llava_next.json``:
             init bit for bit, wire bytes exact, each node's NLL within
             4e-6 and the gradient over img_proj and the first layer
             within 1e-4, a bf16-compute control failing both, one f32
             round; (c) two bf16 rounds at full width, one layer, L=1,
             scan = host bit for bit, a replayed round's device ms; (d)
             DecodeEngine text-only at full width on 8 layers (M=2, 8
             slots, bf16): one capture, a replayed step's device ms.
16. moe    — grok-1-314b and deepseek-v2-236b (ROADMAP A12 part 4): (a)
             the reduced records' rounds (grok-1 ragged, deepseek-v2
             gshard and ragged) as 15 (a), the aux term in the losses,
             and DecodeEngine's tokens equal to the reference engine's;
             (b) deepseek-v2 at full width, one layer, f32, against the
             reference's record (tests/golden/moe_deepseek_v2.json): the
             bank's init bit for bit; the ragged forward's top logits
             within 1e-4 of the largest, NLL within rtol 4e-6 and aux
             1e-5, a bf16-compute control failing the first two;
             DecodeEngine M=1, 8 slots: tokens equal to the reference
             engine's at every step above the 1e-4 margin; the absorbed
             MLA decode through f32 latent caches equal to the forward
             (atol 2e-3); then DecodeEngine M=2, 8 slots, bf16, the
             ragged dispatch inside the captured step, timed; (c)
             grok-1's decode at full width, one layer (M=1, 4 slots),
             through decode_attention; (d) torch's grouped_mm probed at
             deepseek-v2's expert shapes (dtypes, capture, backward).
             Training at full width does not fit one card (ROADMAP A10).
             Phase 2 holds decode_attention at grok-1's heads and
             bma_sample at V = 131,072 and 102,400 at these banks.
17. hybrid — recurrentgemma-9b (ROADMAP A12 part 5): (a) the reference's
             reduced-width f32 rounds and decode
             (``tests/golden/lm_families_recurrent.json``) as 15 (a); (b)
             one (rec, rec, local_attn) group at full width (2.75 B
             parameters), f32, against ``hybrid_recurrentgemma_9b.json``:
             the init bit for bit (a_param within 2.5e-7: XLA's expm1,
             ROADMAP C39), the forward's top logits within 1e-4 of the
             largest and its NLL within rtol 1e-5, a bf16-compute control
             failing both, DecodeEngine M=1 tokens equal to the reference
             engine's above the margin, decode = forward through f32
             caches (the split decode_attention on f32 rows of 256); (c)
             one f32 round of that group at S = 1,024 (chunked_lru,
             chunked_gqa), K=1, the vocabulary cut to 8,192 (at 256,000 the
             round holds ~110 GB), scan = host bit for bit, device ms and
             peaks; (d) DecodeEngine M=2 in bf16 on 18 layers (the depth
             an M=2 bank and the engine's copy of it hold), timed.
18. ssm    — xlstm-1.3b (ROADMAP A12 part 6): (a) as 17 (a); (b) full
             width and full depth (48 layers, 1.24 B), f32, against
             ``ssm_xlstm_1_3b.json``: init bit for bit, the forward as 17
             (b), decode = forward through f32 states; (c) a K=2 round of
             one group (7 mLSTM + 1 sLSTM, 378 M) at S = 1,024
             (chunkwise_mlstm, the sLSTM's 1,024 steps), scan = host; (d)
             DecodeEngine M=2 in bf16 at full depth, timed.
19. audio  — whisper-tiny (ROADMAP A12 part 7): (a) as 17 (a), pools with
             frames; (b) full width and depth against
             ``audio_whisper_tiny.json``: init bit for bit, each node's NLL
             of 1,500 frames and 32 tokens within rtol 1e-5, the encoder's
             output (prefill_encoder) within 1e-4, two f32 rounds on
             {tokens, frames} pools, bytes exact, scan = host; (c)
             DecodeEngine M=2, 8 slots, f32, against zero encoder output
             (the reference engine's, ROADMAP C37): tokens equal to the
             record's above the margin, a replayed step timed.
             Phase 2 holds decode_attention at recurrentgemma-9b's 16
             heads of 256 over a 2,048-slot ring (bf16 and f32 caches)
             and whisper's 6 heads of 64, and bma_sample at V = 256,000.

Phase 11 (a) and (b) run for float16 control variates too, after bf16:
the f16 forms of topk_select, delta-pack, fused_update and cffl_update
bit for bit against their plain versions (subnormal halves and ±0 in v
and in the rounded deltas; ROADMAP C32), timed, and the three runs
against ``tests/golden/f16_rounds_lenet_radar.json``.

Phase 2 also holds the decode step's kernels to their plain versions at
smollm-135m's full-width shapes (4 samples x 8 and x 64 slots, 128 cache
slots, 9 heads over 3 KV heads of 64): decode_attention in bf16 and f32
with positions over and past the cache's end (the clamp), reset lanes at
position 0 and a window-8 ring buffer wrapping around (the caches and
slot_pos equal, the output within one ulp of the compute dtype),
bma_sample at V = 49,152 in bf16 and f32, with ties, -inf rows and V =
1031 (tokens bit for bit, probabilities and entropies within one f32
ulp), and threefry's GUMBEL form bit for bit; it times each beside its
bound, its plain version and, for the attention,
scaled_dot_product_attention over the same lanes.

Phase 2 also holds gilbert_keep, the burst channel's frame recurrence
as a warp scan of 2-bit state maps, to its plain version, bit for bit,
one launch a table: phase 10 (b)'s ragged frame counts (1 to 335 frames,
K nodes x 3 ARQ attempts a leaf), one-frame chains, and chains at and
around the scan's 32-frame tiles (1 to 690 frames) in 7 rows, which fill
no whole CTA of 4 warps, under six channels (the defaults, p_enter = 0
with loss in the good state, a symmetric one, always enter and never
leave, every frame flips, flip beside set-bad), start and frame uniforms
set to the thresholds; and times one round's keep masks beside its plain
version, its byte bound, the card's launch floor (a one-element fill,
traced the same way), and the time and serial model of the
one-thread-a-chain design it replaced.

Phase 2 also holds gossip_mix, the sparse mixers' fma chain (ROADMAP
C16), to its plain version on the card as one table launch over the 10
full-width leaves and edge leaves (±inf, a NaN, signed zeros, an
unaligned leaf; a NaN equals any NaN) under both of phase 9's lowerings
(7 masked matchings, 2 ring shifts) and ``ring_mix``'s ring form, and
times one round's mix on each lowering, one launch, beside its bound,
its plain version and one einsum of its Ω. It holds the kernels of phase
7's path to their plain versions, exactly: topk_select (the lax.top_k-order selection, with and without v),
unpack_set (its decode) and fused_update's CF-FL and DSGLD variants, at
the full-width leaf shapes (each leaf with its own k), at edge leaves (NaN
payloads, ±inf, ties, -0.0, ragged, short leaves, a k-th magnitude 2^30
below its block's maximum), at topk_select's fast-path boundary blocks
(``tests/torch_golden.py``: 32 and 33 candidates at k = 11, the 20
largest keys in one lane, all equal, all zero; each alone) and as one
table launch with v and one without; each timed beside its bound, its
plain version and, for topk_select, one stable torch.sort of the same
blocks' keys (the library call; unpack_set has none: scatter_ alone does
not zero the fresh dense leaf). It logs the share of blocks that leave
topk_select's fast path for its k-th-key search on the timed leaves, as
the rule's transcription ``topk_candidates_plain`` counts them.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the rest of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT / "tests"))

from repro_torch import kernels, random  # noqa: E402
from repro_torch.checkpoint import (load_bank, save_bank,  # noqa: E402
                                    save_checkpoint)
from repro_torch.config import (FedConfig, ParticipationConfig,  # noqa: E402
                                ServeConfig, TopologyConfig,
                                TransportConfig, get_arch)
from repro_torch.core.posterior import predictive_entropy  # noqa: E402
from repro_torch.core.algorithms import (langevin_noise,  # noqa: E402
                                         langevin_scale, make_cdbfl_round)
from repro_torch.core.compression import (  # noqa: E402
    CompressionPipeline, FusedCodec, LeafPayload, WirePayload)
from repro_torch.data.partition import partition_iid  # noqa: E402
from repro_torch.data.radar import critical_subset, make_dataset  # noqa: E402
from repro_torch.eval.engine import HostEvalEngine, ScanEvalEngine  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.block_topk import block_topk, block_topk_plain  # noqa: E402
from repro_torch.kernels.fused_compress import (  # noqa: E402
    carrier_norms_plain, delta_pack, delta_pack_plain,
    grid_quant_leaves, grid_quant_plain)
from repro_torch.kernels.fused_update import (  # noqa: E402
    cffl_update, cffl_update_control, cffl_update_control_plain,
    cffl_update_plain, dsgld_update, dsgld_update_plain, fused_update,
    fused_update_control, fused_update_control_plain, fused_update_plain,
    gossip_mix,
    gossip_mix_plain)
from repro_torch.kernels.pack import (from_uint16, magnitude_keys,  # noqa: E402
                                      num_blocks, pack_topk, pack_topk_plain,
                                      to_blocks, topk_candidates_plain,
                                      topk_select,
                                      topk_select_plain, unpack_set,
                                      unpack_set_plain, unpack_topk,
                                      unpack_topk_plain)
from repro_torch.kernels.gilbert import (channel_params,  # noqa: E402
                                         gilbert_keep, gilbert_keep_plain)
from repro_torch.kernels.qsgd import (inv_one_plus, qsgd, qsgd_omega,  # noqa: E402
                                      qsgd_plain, row_norm)
from repro_torch.kernels.threefry import (BITS, GUMBEL,  # noqa: E402
                                          MAX_TABLE_REQUESTS, NORMAL, PAIR,
                                          TINY, UNIFORM, Draw, draw,
                                          draw_plain, exp_plain, exp_xla)
from repro_torch.kernels.bma_sample import (CLUSTER,  # noqa: E402
                                            bma_sample, bma_sample_plain)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    SPLIT_CLOCKS, decode_attention, decode_attention_clocks,
    decode_attention_plain, split_clusters, split_of)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import (ClassifyEngine, DecodeEngine,  # noqa: E402
                               ServeRequest, live_device_bytes)
from repro_torch.train.engine import round_indices  # noqa: E402
from repro_torch.utils.tree import (tree_count, tree_leaves,  # noqa: E402
                                    tree_leaves_with_path, tree_map,
                                    tree_map_with_path)
from torch_golden import (BASELINE_ROUNDS_FILE, BOUNDARY_K,  # noqa: E402
                          CLI_HEADS, GEOMETRIC_TV, SEEDED_CONFIG,
                          SEEDED_ROUNDS_FILE, SERVE_BMA_FILE, SERVE_CONFIG,
                          THREEFRY_FILE, TOPOLOGY_ROUNDS_FILE, TOPOLOGY_RUNS,
                          TRANSPORT_CLI_LINES, TRANSPORT_COLUMNS,
                          TRANSPORT_ROUNDS_FILE, TRANSPORT_RUNS,
                          CLAIMS_SEEDS, DRIFT_CLAIMS_FILE, DRIFT_CLI_LINES,
                          DRIFT_CONFIG, DRIFT_ROUNDS_FILE, baseline_config,
                          boundary_blocks, claims_departure, claims_golden,
                          claims_record, control_norms, drift_claims_record,
                          port_draw)
from torch_golden import (DECODE_CONFIG, DECODE_FILE,  # noqa: E402
                          decode_requests, exp_inputs)
from torch_golden import (LM_CLI_ARGV, LM_ROUNDS_CONFIG,  # noqa: E402
                          LM_ROUNDS_FILE, lm_nll_batch, lm_pools)
from torch_golden import (LM_FAMILIES_FILE, LM_FAMILY_CONFIG,  # noqa: E402
                          LM_FAMILY_DECODE, LM_FAMILY_RUNS, MOE_FULL_CONFIG,
                          MOE_FULL_FILE, VLM_FULL_CONFIG, VLM_FULL_FILE,
                          family_cfg, family_pools)
from torch_golden import (AUDIO_CONFIG, AUDIO_FILE,  # noqa: E402
                          HYBRID_FULL_CONFIG, HYBRID_FULL_FILE,
                          RECURRENT_FAMILIES_FILE, RECURRENT_FAMILY_RUNS,
                          SSM_FULL_CONFIG, SSM_FULL_FILE)

DEVICE = "cuda"
REDUCED = False                                    # full lenet-radar width
K, L, MINIBATCH, BURN_IN = 10, 8, 10, 2
RATIO, BLOCK, LEVELS = 0.01, 1024, 16
SURVIVORS = max(1, math.ceil(RATIO * BLOCK))       # 11
PIPE = "block_topk|qsgd"
# the slice's configurations: FedConfig overrides, rounds, wire bytes per
# node per round (the reference's wire_bytes), the kernels each launches
RUNS = {
    "block_topk": (dict(compressor="block_topk", fused_compress=True), 4,
                   168_036, ("delta_pack", "unpack", "fused_update",
                             "threefry")),
    PIPE: (dict(pipeline=PIPE, fused_compress=True), 4, 84_058,
           ("delta_pack", "grid_quant", "unpack", "fused_update",
            "threefry")),
    "qsgd_pallas": (dict(compressor="qsgd_pallas"), 2, 1_949_174,
                    ("qsgd", "fused_update", "threefry")),
    "block_topk_pallas": (dict(compressor="block_topk_pallas"), 2, 155_934,
                          ("block_topk", "fused_update", "threefry")),
}
# the engine's split, three levels of key derivation and one table launch
# of draws (two if the table outgrows MAX_TABLE_REQUESTS)
MAX_DRAW_LAUNCHES_A_ROUND = 6
# the kernels that launch once a round over a table of all the leaves
ONCE_A_ROUND = ("delta_pack", "unpack", "qsgd", "grid_quant")
# H100 SXM peaks (NVIDIA data sheet); INT32: 64 lanes an SM (Hopper white
# paper) x 132 SMs x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 16.7e12
# f32 operations per element: |d|, the max, 40 bisection compares, 2 mask
# compares (delta-pack adds the subtraction; block_topk is pack's); Eq. 9:
# sub + 2 fma; QSGD's level: |x|, div, mul, floor, sub, compare (grid_quant
# adds the sign and the norm's square and add; qsgd the sign and its three
# products)
PACK_OPS, DELTA_PACK_OPS, UPDATE_OPS = 44, 45, 5
GRID_QUANT_OPS, QSGD_OPS, BLOCK_TOPK_OPS = 8, 8, 44
# threefry (csrc/threefry.cu): INT32 operations an element (2 key adds,
# the key parity, 20 rounds of add, funnel shift and xor, 10 injection
# adds; a pair with a fold hashes twice) and each transform's extra
# INT32 and f32 operations (an fma is 2): bits' xor; the uniform's shift,
# or, add, subtract, fma and max; the normal's log1p bit fields, both
# log1p branches, the erfinv polynomial, the products and the clip
THREEFRY_INT_OPS = 74
TRANSFORM_OPS = {PAIR: (0, 0), BITS: (1, 0), UNIFORM: (3, 5), NORMAL: (7, 97)}

KERNELS = {
    "pack": ("src/repro_torch/kernels/csrc/pack.cu",
             "src/repro/kernels/pack.py:104"),
    "delta_pack": ("src/repro_torch/kernels/csrc/fused_compress.cu",
                   "src/repro/kernels/fused_compress.py:58"),
    "unpack": ("src/repro_torch/kernels/csrc/pack.cu",
               "src/repro/kernels/pack.py:122"),
    "fused_update": ("src/repro_torch/kernels/csrc/fused_update.cu",
                     "src/repro/kernels/fused_update.py:43"),
    "grid_quant": ("src/repro_torch/kernels/csrc/fused_compress.cu",
                   "src/repro/kernels/fused_compress.py:93"),
    "qsgd": ("src/repro_torch/kernels/csrc/qsgd.cu",
             "src/repro/kernels/qsgd.py:50"),
    "block_topk": ("src/repro_torch/kernels/csrc/block_topk.cu",
                   "src/repro/kernels/block_topk.py:61"),
    # no pl.pallas_call draws: the reference's jax.random calls run on XLA
    "threefry": ("src/repro_torch/kernels/csrc/threefry.cu",
                 "none (no pl.pallas_call): jax.random threefry draws, "
                 "src/repro/core/algorithms.py:133"),
    # the paper's default codec and the baselines' updates: jnp in the
    # reference, no pl.pallas_call
    "topk_select": ("src/repro_torch/kernels/csrc/pack.cu",
                    "none (no pl.pallas_call): jnp lax.top_k block "
                    "selection, src/repro/core/compression.py:426"),
    "unpack_set": ("src/repro_torch/kernels/csrc/pack.cu",
                   "none (no pl.pallas_call): jnp .at[].set decode, "
                   "src/repro/core/compression.py:445"),
    "cffl_update": ("src/repro_torch/kernels/csrc/fused_update.cu",
                    "none (no pl.pallas_call): jnp CF-FL update, "
                    "src/repro/core/algorithms.py:602"),
    "dsgld_update": ("src/repro_torch/kernels/csrc/fused_update.cu",
                     "none (no pl.pallas_call): jnp DSGLD update, "
                     "src/repro/core/algorithms.py:515"),
    # the sparse gossip mixers' fma chain (ROADMAP C16): jnp in the
    # reference, no pl.pallas_call
    "gossip_mix": ("src/repro_torch/kernels/csrc/gossip_mix.cu",
                   "none (no pl.pallas_call): jnp schedule, roll and "
                   "ring mixers, src/repro/core/gossip.py:158 and :80"),
    # the burst channel's frame recurrence: a lax.scan in the reference
    "gilbert_keep": ("src/repro_torch/kernels/csrc/gilbert.cu",
                     "none (no pl.pallas_call): lax.scan Gilbert-Elliott "
                     "keep masks, src/repro/core/transport.py:255"),
    # the forms that read bfloat16 control variates (FedConfig.
    # control_dtype, ROADMAP A3): v (and v̄) at control dtype in the
    # reference's kernel or jnp
    "topk_select_bf16": ("src/repro_torch/kernels/csrc/pack.cu",
                         "none (no pl.pallas_call): jnp lax.top_k block "
                         "selection of θ − v, v bf16, "
                         "src/repro/core/compression.py:426"),
    "delta_pack_bf16": ("src/repro_torch/kernels/csrc/fused_compress.cu",
                        "src/repro/kernels/fused_compress.py:58"),
    "fused_update_bf16": ("src/repro_torch/kernels/csrc/fused_update.cu",
                          "src/repro/kernels/fused_update.py:43"),
    "cffl_update_bf16": ("src/repro_torch/kernels/csrc/fused_update.cu",
                         "none (no pl.pallas_call): jnp CF-FL update with "
                         "bf16 v, v̄, src/repro/core/algorithms.py:602"),
    # and float16 ones (ROADMAP A3, C32)
    "topk_select_f16": ("src/repro_torch/kernels/csrc/pack.cu",
                        "none (no pl.pallas_call): jnp lax.top_k block "
                        "selection of θ − v, v f16, "
                        "src/repro/core/compression.py:426"),
    "delta_pack_f16": ("src/repro_torch/kernels/csrc/fused_compress.cu",
                       "src/repro/kernels/fused_compress.py:58"),
    "fused_update_f16": ("src/repro_torch/kernels/csrc/fused_update.cu",
                         "src/repro/kernels/fused_update.py:43"),
    "cffl_update_f16": ("src/repro_torch/kernels/csrc/fused_update.cu",
                        "none (no pl.pallas_call): jnp CF-FL update with "
                        "f16 v, v̄, src/repro/core/algorithms.py:602"),
    # the BMA decode step of the dense LMs (ROADMAP A12): jnp in the
    # reference, no pl.pallas_call
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "none (no pl.pallas_call): jnp decode attention "
                         "over the KV cache, src/repro/models/"
                         "attention.py:120"),
    "bma_sample": ("src/repro_torch/kernels/csrc/bma_sample.cu",
                   "none (no pl.pallas_call): jnp BMA mean, entropy and "
                   "jax.random.categorical of the decode step, "
                   "src/repro/serve/engine.py:356"),
}
# the seven kernels that replace a pl.pallas_call
TPU_KERNELS = ("pack", "delta_pack", "unpack", "fused_update", "grid_quant",
               "qsgd", "block_topk")
# f32 operations an element: the residual, its key and one compare
# (topk_select); sub and fma (cffl_update); fma and add (dsgld_update)
TOPK_SELECT_OPS, VARIANT_OPS = 3, 3


def lenet_config():
    """The lenet-radar config the script runs: full width unless REDUCED."""
    spec = get_arch("lenet-radar")
    return spec.reduced if REDUCED else spec.config


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def ptxas_report(text: str):
    """nvcc's -Xptxas -v report, one line a kernel: its (mangled) name, its
    registers and shared memory, and its stack and spills; each source's
    name on a line of its own."""
    name, spill = None, ""
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("["):
            yield line
        elif "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line
        elif "Used" in line and name:
            yield f"{name}: {line.split(':', 1)[1].strip()}; {spill}"
            name, spill = None, ""


def device_ms(fn, reps: int = 5, per_rep: int = 10) -> float:
    """Median device time of one call: CUDA events around ``per_rep``
    back-to-back calls, ``reps`` times, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def trace_hits(by_name, kname):
    """(summed µs, launches) of the ported kernel ``kname`` in a trace."""
    hits = [(t, c) for name, (t, c) in by_name.items()
            if TRACE_NAMES[kname].search(name)]
    return sum(t for t, _ in hits), sum(c for _, c in hits)


def profiled(fn, expect=None):
    """{device kernel name: (summed µs, count)} of one call of ``fn``
    (which ends in a device sync) under torch.profiler, after profiled
    warm-up calls whose events are dropped. Late in a long process the
    profiler loses the records of about the first ten kernel launches after
    it is enabled, whatever its schedule (PERF.md §7), so the warm-up is at
    least two calls and at least WARM_LAUNCHES launches of the ported
    kernels where ``fn`` makes any. A trace counts only when it is whole:
    it holds some device event and at least as many launches of each ported
    kernel as ``expect`` ({kernel: launches}) says, by default as many as
    the kernels' wrappers counted in the traced call. Otherwise it is taken
    again with twice the warm-up launches, up to TRACE_ATTEMPTS times; None
    if none was whole."""
    for attempt in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            start, calls = sum(kernels.launch_counts().values()), 0
            while calls < 2 or 0 < sum(kernels.launch_counts().values()) - \
                    start < WARM_LAUNCHES << attempt:
                fn()
                calls += 1
            prof.step()
            before = kernels.launch_counts()
            fn()
            after = kernels.launch_counts()
        want = expect if expect is not None else {
            k: after[k] - before[k] for k in after if after[k] > before[k]}
        by_name = device_time_by_name(prof)
        short = {k: f"{trace_hits(by_name, k)[1]} of {n}"
                 for k, n in want.items() if trace_hits(by_name, k)[1] < n}
        if by_name and not short:
            return by_name
        log("trace", f"a trace after {calls} warm-up calls lacks launches "
                     f"({short or 'no device event'}); traced again")
    return None


def traced_readings(fns, reps: int = 3, takes: int = 3):
    """Device times of one pass over ``fns``, each from its own whole trace
    (``profiled``): the summed intervals of the device kernels, fills and
    copies they ran, with no host time in it; None if a trace could not be
    made whole."""
    def passes():
        for _ in range(reps):
            for fn in fns:
                fn()
        torch.cuda.synchronize()

    readings = []
    for _ in range(takes):
        by_name = profiled(passes)
        if by_name is None:
            return None
        readings.append(sum(t for t, _ in by_name.values()) / 1e3 / reps)
    return readings


def traced_ms(fns):
    """The median of ``traced_readings``; None where it has none."""
    readings = traced_readings(fns)
    return None if readings is None else statistics.median(readings)


def device_time_by_name(prof):
    """{device kernel name: (summed µs, count)} of a torch.profiler trace;
    the profiler's own step annotations, which span each step on the
    device's timeline, are left out."""
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                not e.name.startswith("ProfilerStep"):
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    return by_name


def bound(nbytes: float, ops: float, int_ops: float = 0.0):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their type's peak (f32 and INT32
    run on separate lanes, so the larger of the two)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / F32_OPS_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_AS_INT = {torch.float32: torch.int32, torch.uint16: torch.int16,
           torch.bfloat16: torch.int16, torch.float16: torch.int16,
           torch.int8: torch.int8, torch.int64: torch.int64}


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.view(_AS_INT[a.dtype]), b.view(_AS_INT[b.dtype]))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.dtype == torch.uint16:
        a, b = from_uint16(a), from_uint16(b)
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# --------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# --------------------------------------------------------------------------

def leaf_cases(shapes):
    """(name, theta, v) per case: the main path's full-width leaves (K
    rows), then the edge cases. Made on the card from a seed."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def normal(n):
        return torch.randn((K, n), generator=gen, device=DEVICE)

    for name, shape in shapes:
        n = int(np.prod(shape))
        yield name, normal(n), normal(n) * 0.1
    yield "ragged 4097", normal(4097), normal(4097) * 0.1
    yield "short 6", normal(6), normal(6) * 0.1
    yield "short 150", normal(150), normal(150) * 0.1
    zeros = torch.zeros((K, 3000), device=DEVICE)
    yield "all-zero 3000", zeros, zeros.clone()
    ties = torch.randint(-3, 4, (K, 5000), generator=gen, device=DEVICE).float()
    yield "ties 5000", ties, torch.zeros_like(ties)
    signed = normal(4097)
    signed[:, ::3] = -0.0
    yield "signed zeros 4097", signed, torch.zeros_like(signed)
    # ROADMAP C6: a lone NaN, a block that is NaN but for 5 values, NaNs in
    # the ragged block, a block of NaN; a lone ±inf, fewer and more than k
    # infs, a whole block of -inf, and inf - inf
    nan = normal(4097)
    nan[0, 5] = nan[1, 1024:2048] = float("nan")
    nan[1, 1030:1080:10] = 1.5
    nan[2:, 4096] = nan[3, 100] = float("nan")
    nan[3, 200] = float("inf")
    nan[4, 2048:3072] = float("nan")      # nothing to keep: NaN slots at 0
    yield "nan 4097", nan, normal(4097) * 0.1
    inf = normal(4097)
    inf[0, 77] = -float("inf")
    inf[1, 1027:1030] = float("inf")
    inf[2, 2048:3072:50] = float("inf")
    inf[3:, 3072:4096] = -float("inf")
    inf[0, 4096] = float("inf")
    v_inf = normal(4097) * 0.1
    v_inf[0, 4096] = float("inf")
    yield "inf 4097", inf, v_inf


def repeated_payloads(k: int):
    """(K, 4, k) payloads whose blocks repeat indices (ROADMAP C7): a pair,
    the order-sensitive triple (1e8, 1, -1e8), -0.0 beside +0.0, an inf
    beside a finite value, inf beside inf and inf beside -inf, and for
    k > 32 repeats across the 32-slot chunks; the other blocks' indices
    distinct. Made on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(k)
    idx = torch.argsort(torch.rand((K, 4, 1024), generator=gen,
                                   device=DEVICE), dim=2)[:, :, :k]
    vals = torch.randn((K, 4, k), generator=gen, device=DEVICE)
    inf = float("inf")
    groups = [(0, 0, (0, 1, 2), (1e8, 1.0, -1e8)),
              (0, 0, (3, k - 1), (1.5, 2.25)),
              (1, 1, (4, 5), (-0.0, 0.0)),
              (2, 3, (1, k - 2), (inf, 2.0)),
              (4, 0, (2, k - 1), (inf, inf)),
              (5, 1, (0, 7), (inf, -inf))]
    if k > 32:
        groups += [(3, 2, (6, 31, 32, k - 1), (1e8, 1.0, -1e8, 1.0)),
                   (6, 3, (3, 35), (inf, inf))]
    for row, block, slots, slot_vals in groups:
        vals[row, block, list(slots)] = torch.tensor(slot_vals, device=DEVICE)
        idx[row, block, list(slots)] = int(idx[row, block, slots[0]])
    return vals, idx.to(torch.int16).view(torch.uint16)


def check_kernels(shapes):
    errs = {name: 0.0 for name in KERNELS}
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    cases = list(leaf_cases(shapes))
    payloads, quant = [], []      # every case's payload; the finite cases'
    carriers = []                 # (name, x, u, norm, recip), (carrier, u)
    for name, theta, v in cases:
        n = theta.shape[1]
        (vals, idx), = pack_topk([theta], SURVIVORS)
        want = pack_topk_plain(theta, SURVIVORS)
        (dvals, didx), = delta_pack([theta], [v], SURVIVORS)
        dwant = delta_pack_plain(theta, v, SURVIVORS)
        payloads.append((dvals, didx))
        dense, = unpack_topk([(dvals, didx)], [n])
        dense_want = unpack_topk_plain(dvals, didx, n)
        checks = {"pack": [(vals, want[0]), (idx, want[1])],
                  "delta_pack": [(dvals, dwant[0]), (didx, dwant[1])],
                  "unpack": [(dense, dense_want)],
                  "block_topk": [(block_topk(theta, SURVIVORS),
                                  block_topk_plain(theta, SURVIVORS))]}
        # the other three kernels follow the reference on finite leaves only
        # (ROADMAP C6)
        if bool(torch.isfinite(theta).all() and torch.isfinite(v).all()):
            vb, xi = v * 0.5 + 0.01, torch.randn(theta.shape, generator=gen,
                                                 device=DEVICE) * 1.4e-2
            # QSGD: the leaf's rows and the packed carrier's, uniforms and
            # norms made on the card (the all-zero leaf's norm is eps alone)
            u = torch.rand(theta.shape, generator=gen, device=DEVICE)
            norm = row_norm(theta)
            recip = inv_one_plus(qsgd_omega(n, LEVELS))
            carrier = dvals.reshape(K, -1)
            uc = torch.rand(carrier.shape, generator=gen, device=DEVICE)
            (grid,), (nc,) = grid_quant_leaves([carrier], [uc], LEVELS)
            nc_want = carrier_norms_plain(carrier)
            quant.append((name, theta, u, norm, recip))
            carriers.append((carrier, uc))
            checks.update({
                "fused_update": [(fused_update(theta, vb, v, xi, 0.03, 1.0),
                                  fused_update_plain(theta, vb, v, xi, 0.03,
                                                     1.0))],
                "grid_quant": [(nc, nc_want),
                               (grid, grid_quant_plain(carrier, uc, nc_want,
                                                       LEVELS))],
                "qsgd": [(qsgd([theta], [u], [norm], LEVELS, [recip])[0],
                          qsgd_plain(theta, u, norm, LEVELS, recip))]})
        for kname, pairs in checks.items():
            for got, ref in pairs:
                if not bitwise_equal(got, ref):
                    raise AssertionError(f"{kname} differs from its plain "
                                         f"version on {name} (K={K}, n={n})")
                errs[kname] = max(errs[kname], max_abs_err(got, ref))
        # the fused encode is the two-pass encode, bit for bit
        (pvals, pidx), = pack_topk([theta - v], SURVIVORS)
        if not (bitwise_equal(dvals, pvals) and bitwise_equal(didx, pidx)):
            raise AssertionError(f"delta_pack != pack(θ − v) on {name}")
        log("kernels", f"{name}: K={K} n={n}: {', '.join(checks)} bit-exact "
                       f"to their plain versions")
    # one table launch over every case's leaf (unpack: and the payloads that
    # repeat indices; qsgd and grid_quant: every finite case's), each
    # against its leaf's plain version
    repeats = repeated_payloads(SURVIVORS)
    wrappers = (pack_topk, delta_pack, unpack_topk, qsgd, grid_quant_leaves)
    launched = [w.launches for w in wrappers]
    thetas, vs = [c[1] for c in cases], [c[2] for c in cases]
    packed = pack_topk(thetas, SURVIVORS)
    dpacked = delta_pack(thetas, vs, SURVIVORS)
    unpacked = payloads + [repeats]
    ns = [t.shape[1] for t in thetas] + [4 * 1024 - 5]
    dense = unpack_topk(unpacked, ns)
    _, xs, us, norms, recips = zip(*quant)
    quantized = qsgd(xs, us, norms, LEVELS, recips)
    grids, gnorms = grid_quant_leaves(*zip(*carriers), LEVELS)
    if [w.launches - n for w, n in zip(wrappers, launched)] != [1] * 5:
        raise AssertionError("a mixed table took other than one launch")
    for (name, theta, v), got, dgot in zip(cases, packed, dpacked):
        for a, b in zip(got + dgot, pack_topk_plain(theta, SURVIVORS)
                        + delta_pack_plain(theta, v, SURVIVORS)):
            if not bitwise_equal(a, b):
                raise AssertionError(f"the table launch differs from the "
                                     f"plain version on {name}")
    for (vals, idx), n, d in zip(unpacked, ns, dense):
        if not bitwise_equal(d, unpack_topk_plain(vals, idx, n)):
            raise AssertionError(f"the unpack table launch differs from the "
                                 f"plain version (n={n})")
        errs["unpack"] = max(errs["unpack"],
                             max_abs_err(d, unpack_topk_plain(vals, idx, n)))
    wide = repeated_payloads(40)              # k > 32, a launch of its own
    if not bitwise_equal(unpack_topk([wide], [4 * 1024])[0],
                         unpack_topk_plain(*wide, 4 * 1024)):
        raise AssertionError("unpack differs from its plain version on k=40 "
                             "payloads that repeat indices")
    for (name, x, u, norm, recip), got in zip(quant, quantized):
        if not bitwise_equal(got, qsgd_plain(x, u, norm, LEVELS, recip)):
            raise AssertionError(f"the qsgd table launch differs from the "
                                 f"plain version on {name}")
    for (name, *_), (x, u), g, nrm in zip(quant, carriers, grids, gnorms):
        want = carrier_norms_plain(x)
        if not (bitwise_equal(nrm, want)
                and bitwise_equal(g, grid_quant_plain(x, u, want, LEVELS))):
            raise AssertionError(f"the grid_quant table launch differs from "
                                 f"the plain version on {name}")
    log("kernels", f"one table launch each of pack, delta-pack and unpack "
                   f"over the {len(cases)} leaves above (unpack: and {K} rows "
                   f"of payloads that repeat indices, ROADMAP C7; k=40 ones "
                   f"in a launch of their own), and of qsgd and grid_quant "
                   f"over the {len(quant)} finite ones (grid_quant's grids and "
                   f"norms): bit-exact to every leaf's plain version")
    return errs


def levels_of(gen):
    """The threefry requests of each level of the draw program ``gen``,
    drawn level by level as the port runs it (each level's keys feed the
    next)."""
    levels = []
    try:
        requests = gen.send(None)
        while True:
            levels.append(requests)
            requests = gen.send(draw(requests))
    except StopIteration:
        return levels


def edge_draws(keys):
    """Every transform at edge sizes (n = 1, 7 and the odd 4099) over the
    rows of ``keys``, as the port's random functions ask for them: splits,
    a fold-in of the largest counter and one by a device int32 (the
    engines' round index), splits folded in, bits, uniforms in
    [0, 1) and in a range, Langevin-scaled normals and scaled truncated
    normals."""
    programs = []
    for n in (1, 7, 4099):
        programs += [
            random.split.program(keys, n),
            random.fold_in.program(keys, 2**32 - 1),
            random.fold_in.program(keys, torch.tensor(
                2**31 - n, dtype=torch.int32, device=keys.device)),
            random.split_fold_in.program(keys, n, 1),
            random.bits.program(keys, (n,)),
            random.uniform.program(keys, (n,)),
            random.uniform.program(keys, (n,), -3.5, 11.25),
            random.normal.program(keys, (n,),
                                  scale=langevin_scale(1e-4, 1.0)),
            random.truncated_normal.program(keys, -2.0, 2.0, (n,),
                                            scale=1 / math.sqrt(n))]
    return levels_of(random.together(*programs))[0]


def noise_draws(shapes, key):
    """The full-width round's Langevin noise table as the round draws it
    (``langevin_noise``, η = 1e-4, T = 1): K x 10 streams, one request a
    leaf."""
    like = {path: torch.empty((K,) + shape, device="meta")
            for path, shape in shapes}
    return levels_of(langevin_noise.program(key, like, 1e-4, 1.0))[-1]


def same_draws(table, got) -> float:
    """Assert the kernel's outputs of ``table`` equal the plain version's
    (run on the card) bit for bit; the largest absolute difference."""
    err = 0.0
    for i, (req, g, w) in enumerate(zip(table, got, draw_plain(table))):
        if not bitwise_equal(g, w):
            raise AssertionError(f"threefry differs from its plain version "
                                 f"on request {i} (kind {req.kind}, rows "
                                 f"{req.keys.shape[0]}, n={req.n})")
        err = max(err, max_abs_err(g, w))
    return err


def check_draws(shapes) -> float:
    """Phase 2's draw-kernel checks; returns the largest absolute error."""
    err = 0.0
    key = random.PRNGKey(0, DEVICE)
    tables = {"the full-width noise table": noise_draws(shapes, key),
              "every transform at n = 1, 7, 4099 (keys a strided view)":
                  edge_draws(random.split(random.split(key, K), 3)[:, 1])}
    for label, table in tables.items():
        before = draw.launches
        got = draw(table)
        torch.cuda.synchronize()
        want = -(-len(table) // MAX_TABLE_REQUESTS)
        if draw.launches - before != want:
            raise AssertionError(f"threefry: {label} took "
                                 f"{draw.launches - before} launches, not "
                                 f"{want}")
        err = max(err, same_draws(table, got))
        streams = sum(r.keys.shape[0] for r in table)
        log("kernels", f"threefry: {label} ({len(table)} requests, {streams} "
                       f"streams, {sum(r.keys.shape[0] * r.n for r in table):,}"
                       f" elements, one launch): bit-exact to its plain "
                       f"version")
    golden = np.load(THREEFRY_FILE)
    cases = json.loads(str(golden["cases"]))
    for name, fn, seed, args in cases:
        got = port_draw(fn, seed, args, DEVICE).cpu().numpy()
        want = golden[name]
        if got.shape != want.shape or got.dtype != want.dtype or \
                got.tobytes() != want.tobytes():
            raise AssertionError(f"threefry: the card's {name} differs from "
                                 f"jax.random's ({THREEFRY_FILE.name})")
    log("kernels", f"threefry: the {len(cases)} cases of {THREEFRY_FILE.name} "
                   f"(jax.random on the CPU) reproduced bit for bit on the "
                   f"card")
    return err


def leaf_runs(th, v, vb, xi, vals, idx, u, uc):
    """{kernel: (kernel call, plain call, bytes, operations)} on one leaf's
    (K, n) operands; a function of its own so each call binds its leaf."""
    n = th.shape[1]
    nb = num_blocks(n, BLOCK)
    wire = K * nb * SURVIVORS * 6
    padded = K * nb * BLOCK
    carrier = vals.reshape(K, -1)
    m = carrier.shape[1]
    norm = row_norm(th)
    recip = inv_one_plus(qsgd_omega(n, LEVELS))
    return {
        "pack": (lambda: pack_topk([th], SURVIVORS),
                 lambda: pack_topk_plain(th, SURVIVORS),
                 K * n * 4 + wire, PACK_OPS * padded),
        "delta_pack": (lambda: delta_pack([th], [v], SURVIVORS),
                       lambda: delta_pack_plain(th, v, SURVIVORS),
                       2 * K * n * 4 + wire, DELTA_PACK_OPS * padded),
        "unpack": (lambda: unpack_topk([(vals, idx)], [n]),
                   lambda: unpack_topk_plain(vals, idx, n),
                   wire + K * n * 4, 0),
        "fused_update": (lambda: fused_update(th, vb, v, xi, 0.03, 1.0),
                         lambda: fused_update_plain(th, vb, v, xi, 0.03, 1.0),
                         5 * K * n * 4, UPDATE_OPS * K * n),
        "grid_quant": (lambda: grid_quant_leaves([carrier], [uc], LEVELS),
                       lambda: grid_quant_pair_plain(carrier, uc),
                       K * m * (4 + 4 + 1) + K * 4, GRID_QUANT_OPS * K * m),
        "qsgd": (lambda: qsgd([th], [u], [norm], LEVELS, [recip]),
                 lambda: qsgd_plain(th, u, norm, LEVELS, recip),
                 K * n * (4 + 4 + 4) + K * 4, QSGD_OPS * K * n),
        "block_topk": (lambda: block_topk(th, SURVIVORS),
                       lambda: block_topk_plain(th, SURVIVORS),
                       2 * K * n * 4, BLOCK_TOPK_OPS * padded),
    }


def grid_quant_pair_plain(carrier, u):
    """grid_quant's plain version: the norms, then the grid."""
    norm = carrier_norms_plain(carrier)
    return grid_quant_plain(carrier, u, norm, LEVELS), norm


def fmt_ms(ms, digits: int = 4) -> str:
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


def time_kernels(shapes):
    """Per-round time of each kernel over the main path's leaves (K=10
    rows), its plain version's, and its bound: one launch a leaf, but for
    pack, delta-pack, unpack, qsgd and grid_quant one table launch over the
    10 leaves, as the round runs the last four. Two clocks: CUDA events
    around back-to-back calls (``ms``, ``plain_ms``: what a caller pays,
    host time per call included wherever it exceeds the device work) and
    the device time in a profiler trace (``device_ms``,
    ``plain_device_ms``: the kernels alone, None where no trace was
    whole)."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rows = {name: dict(ms=0.0, plain_ms=0.0, nbytes=0.0, ops=0.0, fns=[],
                       plain_fns=[]) for name in TPU_KERNELS}
    largest = max(int(np.prod(s)) for _, s in shapes)
    ths, vs, payloads, us, carriers, ucs = [], [], [], [], [], []
    for _, shape in shapes:
        n = int(np.prod(shape))
        th = torch.randn((K, n), generator=gen, device=DEVICE)
        v, vb, xi = th * 0.1, th * 0.05, th * 0.01
        (vals, idx), = delta_pack([th], [v], SURVIVORS)
        u = torch.rand(th.shape, generator=gen, device=DEVICE)
        ths.append(th)
        vs.append(v)
        payloads.append((vals, idx))
        us.append(u)
        uc = torch.rand((K, vals.shape[1] * SURVIVORS), generator=gen,
                        device=DEVICE)
        carriers.append(vals.reshape(K, -1))
        ucs.append(uc)
        runs = leaf_runs(th, v, vb, xi, vals, idx, u, uc)
        for name, (kern, plain, nbytes, ops) in runs.items():
            r = rows[name]
            ms, plain_ms = device_ms(kern), device_ms(plain, reps=3, per_rep=2)
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["nbytes"] += nbytes
            r["ops"] += ops
            r["fns"].append(kern)
            r["plain_fns"].append(plain)
            if n == largest:
                b_ms, b_by = bound(nbytes, ops)
                log("kernels", f"{name} on the largest leaf {shape} (K={K}): "
                               f"device {fmt_ms(traced_ms([kern]))}, "
                               f"event-timed {ms:.4f} ms; plain {plain_ms:.4f}"
                               f" ms; bound {b_ms:.4f} ms ({b_by})")
    # pack, delta-pack, unpack, qsgd and grid_quant as the round runs the
    # last four, one table launch over the 10 leaves, in place of their sums
    # of one launch a leaf
    ns = [t.shape[1] for t in ths]
    norms = [row_norm(t) for t in ths]
    recips = [inv_one_plus(qsgd_omega(n, LEVELS)) for n in ns]
    table = {"pack": (lambda: pack_topk(ths, SURVIVORS),
                      lambda: [pack_topk_plain(t, SURVIVORS) for t in ths]),
             "delta_pack": (lambda: delta_pack(ths, vs, SURVIVORS),
                            lambda: [delta_pack_plain(t, v, SURVIVORS)
                                     for t, v in zip(ths, vs)]),
             "unpack": (lambda: unpack_topk(payloads, ns),
                        lambda: [unpack_topk_plain(*p, n)
                                 for p, n in zip(payloads, ns)]),
             "qsgd": (lambda: qsgd(ths, us, norms, LEVELS, recips),
                      lambda: [qsgd_plain(*a, LEVELS, r) for a, r in
                               zip(zip(ths, us, norms), recips)]),
             "grid_quant": (lambda: grid_quant_leaves(carriers, ucs,
                                                      LEVELS),
                            lambda: [grid_quant_pair_plain(c, u)
                                     for c, u in zip(carriers, ucs)])}
    for name, (kern, plain) in table.items():
        r = rows[name]
        r["ms"], r["plain_ms"] = device_ms(kern), device_ms(plain, reps=3,
                                                            per_rep=2)
        r["fns"], r["plain_fns"] = [kern], [plain]
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r["nbytes"], r["ops"])
        r["device_ms"] = traced_ms(r.pop("fns"))
        r["plain_device_ms"] = traced_ms(r.pop("plain_fns"))
        if r["device_ms"] is None or r["plain_device_ms"] is None:
            log("kernels", f"{name}: no whole trace; device time not "
                           f"measured")
    return rows


# --------------------------------------------------------------------------
# phase 2, the default codec's kernels: topk_select, unpack_set, and the
# CF-FL and DSGLD variants of fused_update
# --------------------------------------------------------------------------

def leaf_k(n: int) -> int:
    """Survivors a block of the default codec: a leaf of at most one block
    keeps its own ceil(ratio·n) (TopKCodec's global top-k)."""
    return SURVIVORS if n > BLOCK else max(1, math.ceil(RATIO * n))


def far_below_case():
    """A leaf whose second block holds one value 2^30 above the rest: its
    k-th magnitude lies far below its maximum (ROADMAP C3)."""
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    x = torch.randn((K, 3000), generator=gen, device=DEVICE)
    x[:, 1024:2048] = torch.rand((K, 1024), generator=gen,
                                 device=DEVICE) * 1e-9 + 1e-9
    x[:, 1500] = 2.0 ** 30
    return "far below 3000", x, torch.zeros_like(x)


def boundary_cases():
    """(name, d, v) of torch_golden's fast-path boundary blocks at k =
    BOUNDARY_K, K rows each, on the card."""
    return [(name, torch.from_numpy(d).to(DEVICE),
             torch.from_numpy(v).to(DEVICE))
            for name, d, v in boundary_blocks(K)]


def fallback_share(ds, ks):
    """(blocks, blocks that take the k-th-key search, mean candidates) of
    topk_select's fast-path rule (``topk_candidates_plain``) over ``(K,
    n)`` residuals, each with its k (all <= 32). The rule's Python
    transcription counts them, not the kernel, which keeps no counter."""
    blocks = fallen = cands = 0
    for d, k in zip(ds, ks):
        _, count = topk_candidates_plain(to_blocks(d, BLOCK), k)
        blocks += count.numel()
        fallen += int((count > 32).sum())
        cands += int(count.sum())
    return blocks, fallen, cands / blocks


def check_default_kernels(shapes):
    """topk_select (with and without v), unpack_set and the two update
    variants against their plain versions on the card, exactly: every
    full-width and edge leaf, the fast path's boundary blocks (each alone),
    then one table launch over all of them (a k a leaf) with v and one
    without; k = 40 on its own. Returns the largest absolute errors."""
    errs = dict.fromkeys(("topk_select", "unpack_set", "cffl_update",
                          "dsgld_update"), 0.0)
    cases = [c for c in leaf_cases(shapes) if c[1].shape[1] > 1]
    cases.append(far_below_case())

    def same(kname, got, want, label):
        if not bitwise_equal(got, want):
            raise AssertionError(f"{kname} differs from its plain version on "
                                 f"{label}")
        errs[kname] = max(errs[kname], max_abs_err(got, want))

    def select(label, x, k, v):
        """topk_select and unpack_set of one leaf against the plain."""
        (vals, idx), = topk_select([x], [k], None if v is None else [v])
        want = topk_select_plain(x, k, v=v)
        same("topk_select", vals, want[0], label)
        same("topk_select", idx, want[1], label)
        dense, = unpack_set([(vals, idx)], [x.shape[1]])
        same("unpack_set", dense, unpack_set_plain(vals, idx, x.shape[1]),
             label)

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    for name, theta, v in cases:
        n, k = theta.shape[1], leaf_k(theta.shape[1])
        for with_v in (False, True):
            select(name, theta, k, v if with_v else None)
        if bool(torch.isfinite(theta).all() and torch.isfinite(v).all()):
            vb = v * 0.5 + 0.01
            g = torch.randn(theta.shape, generator=gen, device=DEVICE) * 30
            xi = torch.randn(theta.shape, generator=gen, device=DEVICE) * 1e-2
            same("cffl_update", cffl_update(theta, vb, v, 0.03),
                 cffl_update_plain(theta, vb, v, 0.03), name)
            same("dsgld_update", dsgld_update(theta, g, xi, 1e-4),
                 dsgld_update_plain(theta, g, xi, 1e-4), name)
        log("kernels", f"{name}: K={K} n={n} k={k}: topk_select (with and "
                       f"without v), unpack_set and the update variants "
                       f"bit-exact to their plain versions")
    # without v the selection sees d, with v it forms (d + v) − v = d
    boundary = boundary_cases()
    for name, d, v in boundary:
        select(name, d, BOUNDARY_K, None)
        select(f"{name} (with v)", d + v, BOUNDARY_K, v)
        _, count = topk_candidates_plain(d, BOUNDARY_K)
        log("kernels", f"{name}: K={K} n={BLOCK} k={BOUNDARY_K}: candidates "
                       f"a row {count.tolist()} (more than 32 take the k-th-"
                       f"key search): topk_select alone (with and without "
                       f"v) and unpack_set bit-exact")
    ks = [leaf_k(c[1].shape[1]) for c in cases] + [BOUNDARY_K] * len(boundary)
    names = [c[0] for c in cases] + [c[0] for c in boundary]
    for with_v in (True, False):
        xs = [c[1] for c in cases] + [d + v if with_v else d
                                      for _, d, v in boundary]
        vs = [c[2] for c in cases] + [v for _, _, v in boundary]
        before = (topk_select.launches, unpack_set.launches)
        got = topk_select(xs, ks, vs if with_v else None)
        dense = unpack_set(got, [x.shape[1] for x in xs])
        if (topk_select.launches - before[0],
                unpack_set.launches - before[1]) != (1, 1):
            raise AssertionError("a mixed topk_select or unpack_set table "
                                 "took other than one launch")
        for name, x, v, k, (vals, idx), dd in zip(names, xs, vs, ks, got,
                                                  dense):
            want = topk_select_plain(x, k, v=v if with_v else None)
            same("topk_select", vals, want[0], f"the table's {name}")
            same("topk_select", idx, want[1], f"the table's {name}")
            same("unpack_set", dd, unpack_set_plain(vals, idx, x.shape[1]),
                 f"the table's {name}")
    wide = cases[0][1]
    (vals, idx), = topk_select([wide], [40])
    same("topk_select", vals, topk_select_plain(wide, 40)[0], "k=40")
    same("topk_select", idx, topk_select_plain(wide, 40)[1], "k=40")
    log("kernels", f"one table launch each of topk_select and unpack_set "
                   f"over the {len(xs)} leaves above, a k a leaf, with v and "
                   f"again without, and topk_select at k=40 (its k > 32 "
                   f"path): bit-exact to every leaf's plain version")
    return errs


def time_default_kernels(shapes):
    """Per-round time of the default codec's kernels over the 10 full-width
    leaves (K=10): topk_select with v and unpack_set as one table launch
    each, as the round runs them; the update variants one launch a leaf.
    Beside each its plain version, its bound and, for topk_select, one
    stable ``torch.sort`` of all the round's block keys (the full order,
    keys formed outside the timing); no single torch call decodes a
    payload into a fresh dense leaf (``scatter_`` alone leaves the zeros
    to another call) or computes an update variant. Each device time is
    the median of three whole traces, all three logged."""
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    ths = [torch.randn((K, int(np.prod(s))), generator=gen, device=DEVICE)
           for _, s in shapes]
    vs = [t * 0.1 for t in ths]
    ns = [t.shape[1] for t in ths]
    ks = [leaf_k(n) for n in ns]
    payloads = topk_select(ths, ks, vs)
    blocks, fallen, mean = fallback_share([t - v for t, v in zip(ths, vs)],
                                          ks)
    log("kernels", f"topk_select's fast-path rule (topk_candidates_plain) "
                   f"on these leaves: {fallen} of "
                   f"{blocks} blocks take the k-th-key search "
                   f"({100 * fallen / blocks:.4f}%); {mean:.2f} candidates a "
                   f"block on average")
    keys = torch.cat([magnitude_keys(to_blocks(t - v, BLOCK))
                      for t, v in zip(ths, vs)])
    vbs = [v * 0.5 for v in vs]
    xis = [v * 0.3 for v in vs]
    wire = sum(vals.numel() * 6 for vals, _ in payloads)
    padded = sum(vals.shape[1] * K * BLOCK for vals, _ in payloads)
    total = sum(K * n for n in ns)
    rows = {
        "topk_select": (lambda: topk_select(ths, ks, vs),
                        lambda: [topk_select_plain(t, k, v=v)
                                 for t, k, v in zip(ths, ks, vs)],
                        lambda: torch.sort(keys, dim=1, descending=True,
                                           stable=True),
                        2 * total * 4 + wire, TOPK_SELECT_OPS * padded),
        "unpack_set": (lambda: unpack_set(payloads, ns),
                       lambda: [unpack_set_plain(*p, n)
                                for p, n in zip(payloads, ns)],
                       None, wire + total * 4, 0),
        "cffl_update": (lambda: [cffl_update(t, b, v, 0.03)
                                 for t, b, v in zip(ths, vbs, vs)],
                        lambda: [cffl_update_plain(t, b, v, 0.03)
                                 for t, b, v in zip(ths, vbs, vs)],
                        None, 4 * total * 4, VARIANT_OPS * total),
        "dsgld_update": (lambda: [dsgld_update(t, v, x, 1e-4)
                                  for t, v, x in zip(ths, vs, xis)],
                         lambda: [dsgld_update_plain(t, v, x, 1e-4)
                                  for t, v, x in zip(ths, vs, xis)],
                         None, 4 * total * 4, VARIANT_OPS * total),
    }
    out = {}
    for name, (kern, plain, lib, nbytes, ops) in rows.items():
        b_ms, b_by = bound(nbytes, ops)
        readings = traced_readings([kern])
        r = dict(ms=device_ms(kern), plain_ms=device_ms(plain, reps=3,
                                                         per_rep=2),
                 device_ms=readings and statistics.median(readings),
                 plain_device_ms=traced_ms([plain]), bound_ms=b_ms,
                 bound_by=b_by, nbytes=nbytes, ops=ops,
                 library_ms=None if lib is None else traced_ms([lib]))
        out[name] = r
        log("kernels", f"{name} per round (10 leaves, K={K}): device "
                       f"{fmt_ms(r['device_ms'])} (median of the traces' "
                       f"{readings and [round(x, 4) for x in readings]}), "
                       f"event-timed "
                       f"{r['ms']:.4f} ms; plain: device "
                       f"{fmt_ms(r['plain_device_ms'])}, event-timed "
                       f"{r['plain_ms']:.4f} ms; library "
                       f"{fmt_ms(r['library_ms']) if lib else 'none'}; "
                       f"bound {b_ms:.4f} ms ({b_by}: {nbytes:.0f} B, "
                       f"{ops:.0f} ops)")
    return out


# phase 2, the gossip mixers' kernel (ROADMAP C16): gossip_mix
# --------------------------------------------------------------------------

def mix_terms():
    """The two lowerings phase 9 runs at K=10 and ``ring_mix``'s form, as
    ``(label, src, w, c0, form, Ω)``: the time-varying geometric graph's 7
    matchings under one round's masks (Laplacian form), the ring's two
    shifts (circulant form, the roll lowering) and the ring's ``fma(ω₀₀, x,
    ω₀₁·(x[k−1] + x[k+1]))`` (ring form), each with the dense Ω_t it
    computes, for the library call."""
    from repro_torch.core import gossip
    from repro_torch.core.topology import build_topology
    tv = TopologyConfig(**GEOMETRIC_TV)
    mix = gossip.make_mixer(build_topology(tv, K).omega, DEVICE, config=tv)
    sched = mix.schedule
    masks = mix.masks(random.fold_in(random.PRNGKey(0, DEVICE), 2))
    w = torch.as_tensor(sched.weights, device=DEVICE) * masks
    src = torch.as_tensor(sched.perms, dtype=torch.int32, device=DEVICE)
    om = np.eye(K)
    for perm, wm in zip(sched.perms, w.cpu().numpy()):
        for k in range(K):
            om[k, perm[k]] += wm[k]
            om[k, k] -= wm[k]
    out = [("geometric-tv", src, w, 0.0, "laplacian", om)]
    ring = TopologyConfig(graph="ring")
    ring_omega = build_topology(ring, K).omega
    sched = gossip.make_mixer(ring_omega, DEVICE, config=ring).schedule
    terms = gossip._roll_terms(sched, DEVICE)
    om = np.zeros((K, K))
    for shift, c in zip(sched.shifts, sched.coeffs):
        for k in range(K):
            om[k, (k + shift) % K] += c
    out.append(("ring", terms.src, terms.w, terms.c0, terms.form, om))
    rows = torch.arange(K, dtype=torch.int32, device=DEVICE)
    out.append(("ring_mix", torch.stack([(rows - 1) % K, (rows + 1) % K]),
                torch.full((2, K), float(np.float32(ring_omega[0, 1])),
                           device=DEVICE),
                float(np.float32(ring_omega[0, 0])), "ring", ring_omega))
    return out


def same_or_both_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, but a NaN equals any NaN: the card's arithmetic gives
    0x7fffffff where the plain version keeps an operand's payload, and a
    NaN's payload is not part of the contract (ROADMAP C6)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and bitwise_equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


def check_gossip_mix(shapes):
    """gossip_mix against its plain version on the card, bit for bit: one
    table launch over the 10 full-width leaves (K=10) and the edge leaves
    (signed zeros, a NaN, ±inf; n = 4099, an unaligned 4096 and 1), under
    both lowerings of phase 9 and ``ring_mix``'s form; a NaN equals any
    NaN."""
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    leaves = [torch.randn((K, int(np.prod(s))), generator=gen, device=DEVICE)
              for _, s in shapes]
    edge = torch.randn((K, 4099), generator=gen, device=DEVICE)
    edge[:, :3] = -0.0
    edge[1, 5], edge[2, 6], edge[3, 7] = float("nan"), float("inf"), \
        -float("inf")
    unaligned = edge.reshape(-1)[1:1 + K * 4096].view(K, 4096)
    leaves += [edge, unaligned, edge[:, :1].contiguous()]
    err = 0.0
    for label, src, w, c0, form, _ in mix_terms():
        before = gossip_mix.launches
        mixed = gossip_mix(leaves, src, w, c0, form)
        if gossip_mix.launches - before != 1:
            raise AssertionError(f"gossip_mix ({label}): "
                                 f"{gossip_mix.launches - before} launches "
                                 f"for a table of {len(leaves)} leaves")
        for x, got in zip(leaves, mixed):
            want = gossip_mix_plain(x, src, w, c0, form)
            if not same_or_both_nan(got, want):
                raise AssertionError(f"gossip_mix ({label}) differs from its "
                                     f"plain version at {tuple(x.shape)}")
            # ±inf - ±inf is NaN: the error is read off the finite outputs
            fin = torch.isfinite(got) & torch.isfinite(want)
            err = max(err, max_abs_err(torch.where(fin, got, 0.0),
                                       torch.where(fin, want, 0.0)))
        log("kernels", f"gossip_mix ({label}, {form} form, {src.shape[0]} "
                       f"terms): one launch over the 10 full-width leaves "
                       f"and the {len(leaves) - len(shapes)} edge leaves, "
                       f"bit-exact to its plain version (max abs err "
                       f"{err:g} on the finite outputs)")
    return {"gossip_mix": err}


# f32 operations an element of each form: M subtractions and fmas (an fma
# is 2); a product and M fmas; an add, a product and an fma
MIX_OPS = {"laplacian": lambda m: 3 * m, "circulant": lambda m: 2 * m + 1,
           "ring": lambda m: 4}


def time_gossip_mix(shapes):
    """A round's mix of the 10 full-width leaves (K=10), one table launch,
    on the time-varying geometric graph (7 matchings) and on the ring (2
    shifts), each beside its plain version, its bound and one
    ``torch.einsum`` of its own Ω over all the leaves at once (the dense
    lowering C14 replaced). The kernels line takes the geometric graph's."""
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    xs = [torch.randn((K, int(np.prod(s))), generator=gen, device=DEVICE)
          for _, s in shapes]
    flat = torch.cat(xs, dim=1)
    total = flat.numel()
    out = {}
    for label, src, w, c0, form, om in mix_terms()[:2]:
        om_t = torch.as_tensor(om, dtype=torch.float32, device=DEVICE)
        nbytes = 2 * total * 4 + src.numel() * 8
        ops = MIX_OPS[form](src.shape[0]) * total
        b_ms, b_by = bound(nbytes, ops)
        kern = lambda: gossip_mix(xs, src, w, c0, form)  # noqa: E731
        plain = lambda: [gossip_mix_plain(x, src, w, c0, form)  # noqa: E731
                         for x in xs]
        lib = lambda: torch.einsum("kj,jn->kn", om_t, flat)  # noqa: E731
        readings = traced_readings([kern])
        r = dict(ms=device_ms(kern),
                 plain_ms=device_ms(plain, reps=3, per_rep=2),
                 device_ms=readings and statistics.median(readings),
                 plain_device_ms=traced_ms([plain]), bound_ms=b_ms,
                 bound_by=b_by, nbytes=nbytes, ops=ops,
                 library_ms=traced_ms([lib]))
        log("kernels", f"gossip_mix per round ({label}: 10 leaves, K={K}, "
                       f"{src.shape[0]} terms, one launch): device "
                       f"{fmt_ms(r['device_ms'])} (median of the traces' "
                       f"{readings and [round(x, 4) for x in readings]}), "
                       f"event-timed {r['ms']:.4f} ms; plain: device "
                       f"{fmt_ms(r['plain_device_ms'])}, event-timed "
                       f"{r['plain_ms']:.4f} ms; library (einsum of its Ω) "
                       f"{fmt_ms(r['library_ms'])}; bound {b_ms:.4f} ms "
                       f"({b_by}: {nbytes:.0f} B, {ops:.0f} ops)"
                       + (f", {100 * b_ms / r['device_ms']:.0f}% of it"
                          if r['device_ms'] else ""))
        out.setdefault("gossip_mix", r)
    return out


# --------------------------------------------------------------------------
# phases 3 and 4: the slice's runs, and the two-pass oracle rounds
# --------------------------------------------------------------------------

def fed_config(name: str) -> FedConfig:
    overrides, rounds, _, _ = RUNS[name]
    return FedConfig(**dict(
        dict(num_nodes=K, local_steps=L, eta=1e-4, zeta=0.03, temperature=1.0,
             burn_in=BURN_IN, rounds=rounds, compress_ratio=RATIO,
             block_size=BLOCK, qsgd_levels=LEVELS, topology="full"),
        **overrides))


def run_slice(name: str, train, test):
    """FedTrainer(device="cuda") for the configuration's rounds, then BMA
    evaluation; the launch counts set to 0 just before, read just after."""
    from repro_torch.train import FedTrainer
    cfg = lenet_config()
    _, rounds, wire, launched = RUNS[name]
    trainer = FedTrainer(get_model(cfg), fed_config(name),
                         partition_iid(train, K), minibatch=MINIBATCH, seed=0,
                         engine="host", bank_thin=1, device=DEVICE)
    kernels.reset_launch_counts()
    res = trainer.run(rounds=rounds, eval_batch=test)
    launches = kernels.launch_counts()
    for t in range(rounds):
        log("slice", f"{name} round {t}: {res.round_ms[t]:.2f} ms, loss "
                     f"{res.loss_history[t]:.4f}, consensus "
                     f"{res.consensus_history[t]:.6e}, wire bytes/node "
                     f"{res.wire_history[t]:.0f}")
    steady = statistics.median(res.round_ms[1:])
    log("slice", f"{name}: median ms/round after the first: {steady:.2f}; "
                 f"bank {len(trainer.bank)} samples; accuracy "
                 f"{res.accuracy:.4f}, ECE {res.ece:.4f}, NLL {res.nll:.4f}, "
                 f"Brier {res.brier:.4f}")
    log("slice", f"{name}: launches in the run: {launches}")
    values = (res.loss_history + res.consensus_history + res.round_ms
              + [res.accuracy, res.ece, res.nll, res.brier])
    if not all(math.isfinite(x) for x in values):
        raise AssertionError(f"{name}: non-finite metric in {values}")
    if not all(torch.isfinite(x).all() for x in tree_leaves(trainer.state.params)):
        raise AssertionError(f"{name}: non-finite params after the run")
    if res.wire_history != [float(wire)] * rounds:
        raise AssertionError(f"{name}: wire bytes/node/round "
                             f"{res.wire_history}, want {wire}")
    for kname in launched:
        if launches[kname] <= 0:
            raise AssertionError(f"{name}: the run never launched {kname}")
    for kname in set(launched) & set(ONCE_A_ROUND):
        if launches[kname] != rounds:
            raise AssertionError(f"{name}: {kname} launched "
                                 f"{launches[kname]} times in {rounds} "
                                 f"rounds, not once a round")
    if launches["threefry"] > MAX_DRAW_LAUNCHES_A_ROUND * rounds:
        raise AssertionError(f"{name}: {launches['threefry']} threefry "
                             f"launches in {rounds} rounds, more than "
                             f"{MAX_DRAW_LAUNCHES_A_ROUND} a round")
    log("slice", f"{name}: threefry {launches['threefry'] / rounds:g} "
                 f"launches a round")
    if name == "block_topk":
        check_seeded(res)
    if len(trainer.bank) != max(0, rounds - BURN_IN):
        raise AssertionError(f"{name}: bank holds {len(trainer.bank)} samples")
    return trainer, launches, res


def check_seeded(res) -> None:
    """The block_topk run's first rounds against the reference's seeded run
    of the same configuration, recorded on the CPU: bytes exact, loss and
    consensus error within rtol 1e-3 (the card's convolutions and
    reductions sum in other orders than XLA's CPU code)."""
    want = json.loads(SEEDED_ROUNDS_FILE.read_text())
    fed = fed_config("block_topk")
    mine = dict(SEEDED_CONFIG, reduced=REDUCED, train_maps=K * 50,
                minibatch=MINIBATCH,
                fed={k: getattr(fed, k) for k in SEEDED_CONFIG["fed"]})
    if want["config"] != mine:
        raise AssertionError(f"{SEEDED_ROUNDS_FILE.name} ran {want['config']}"
                             f", this run is {mine}")
    n = len(want["loss"])
    if res.wire_history[:n] != want["wire_bytes"]:
        raise AssertionError(f"seeded bytes {res.wire_history[:n]} != "
                             f"{want['wire_bytes']}")
    for metric, got in (("loss", res.loss_history),
                        ("consensus", res.consensus_history)):
        if not np.allclose(got[:n], want[metric], rtol=1e-3, atol=0):
            raise AssertionError(f"seeded {metric} {got[:n]} differs from "
                                 f"the reference's {want[metric]}")
    log("slice", f"block_topk, seed 0, rounds 1-{n} against the reference's "
                 f"seeded CPU run: loss {res.loss_history[:n]} vs "
                 f"{want['loss']}, consensus {res.consensus_history[:n]} vs "
                 f"{want['consensus']}, bytes exact (rtol 1e-3 held)")


def round_inputs(trainer, key):
    """One round's inputs from the round key ``key``, as the engine draws
    them: the minibatches, the key, and the round's noise and uniforms."""
    idx, draws = random.run(random.together(
        round_indices.program(trainer.device_shards, key,
                              trainer.fed_cfg.local_steps, MINIBATCH),
        trainer.round_fn.draws.program(key, trainer.state.params)))
    return trainer.device_shards.gather(idx), key, draws


def draw_levels(trainer, key):
    """The threefry requests of one round from the engine's ``key``, level
    by level as the engine launches them: its split, then the round's
    minibatch indices and draws side by side."""
    split = levels_of(random.split.program(key))
    kround = draw(split[0])[0][0, 1]
    return split + levels_of(random.together(
        round_indices.program(trainer.device_shards, kround,
                              trainer.fed_cfg.local_steps, MINIBATCH),
        trainer.round_fn.draws.program(kround, trainer.state.params)))


def draw_work(levels):
    """(bytes, f32 operations, INT32 operations) of the requests: each key
    read once, each output written once."""
    nbytes = ops = int_ops = 0
    for req in (r for level in levels for r in level):
        rows = req.keys.shape[0]
        elems = rows * req.n
        nbytes += 16 * rows + elems * {PAIR: 16, BITS: 8}.get(req.kind, 4)
        extra_int, extra_f32 = TRANSFORM_OPS[req.kind]
        hashes = 2 if req.fold is not None else 1
        int_ops += elems * (hashes * THREEFRY_INT_OPS + extra_int)
        ops += elems * extra_f32
    return nbytes, ops, int_ops


def time_draws(trainer):
    """One full-width round's draws (the engine's split, three levels of
    key derivation, one table of minibatch bits, noise and uniforms) of the
    ``block_topk|qsgd`` configuration: kernel against plain version, event
    and device time, bound, launches, the host time of the derivation, and
    ``torch.randn`` of the round's normals as context."""
    key = random.PRNGKey(11, DEVICE)
    levels = draw_levels(trainer, key)
    err = 0.0
    for level in levels:
        err = max(err, same_draws(level, draw(level)))
    before = draw.launches
    run = lambda: [draw(level) for level in levels]  # noqa: E731
    run()
    launches = draw.launches - before
    plain = lambda: [draw_plain(level) for level in levels]  # noqa: E731
    nbytes, ops, int_ops = draw_work(levels)
    b_ms, b_by = bound(nbytes, ops, int_ops)
    row = dict(ms=device_ms(run), plain_ms=device_ms(plain, reps=3,
                                                      per_rep=2),
               device_ms=traced_ms([run]),
               plain_device_ms=traced_ms([plain]), bound_ms=b_ms,
               bound_by=b_by, nbytes=nbytes, ops=ops, int_ops=int_ops,
               launches=launches, err=err)
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        _, kround = random.split(key)
        round_inputs(trainer, kround)
        host.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    row["host_ms"] = statistics.median(host)
    normals = sum(r.keys.shape[0] * r.n for level in levels for r in level
                  if r.kind == NORMAL)
    row["randn_ms"] = device_ms(lambda: torch.randn(normals, device=DEVICE))
    log("draws", f"one {PIPE} round's draws: {len(levels)} levels, "
                 f"{launches} launches, "
                 f"{sum(r.keys.shape[0] * r.n for lv in levels for r in lv):,}"
                 f" elements ({normals:,} normals), bit-exact to the plain "
                 f"version; device {fmt_ms(row['device_ms'])}, event-timed "
                 f"{row['ms']:.4f} ms; plain: device "
                 f"{fmt_ms(row['plain_device_ms'])}, event-timed "
                 f"{row['plain_ms']:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
                 f"{nbytes:.0f} B, {ops:.0f} f32 ops, {int_ops:.0f} INT32 "
                 f"ops)")
    log("draws", f"host ms of a round's key derivation and draws (the "
                 f"engine's split, then its round_indices and round_fn.draws "
                 f"side by side, no sync): median {row['host_ms']:.3f} ms of "
                 f"20; torch.randn({normals:,}) on the card (another "
                 f"generator, context only) {row['randn_ms']:.4f} ms")
    return row


def oracle_round(name: str, trainer):
    """One round from the trainer's state, fused and two-pass; same draws.
    Returns the oracle's launches, its round function and the fused
    round's payload."""
    fed = trainer.fed_cfg
    oracle = FusedCodec.wrap(CompressionPipeline(trainer.compressor.stages),
                             fused=False)
    oracle_fn = make_cdbfl_round(trainer.model.nll, fed, trainer.omega, oracle,
                                 trainer.data_scale, trainer.device)
    state = trainer.state
    inputs = round_inputs(trainer, random.PRNGKey(123, DEVICE))
    s_fused, m_fused = trainer.round_fn(state, *inputs)
    kernels.reset_launch_counts()
    s_two, m_two = oracle_fn(state, *inputs)
    launches = kernels.launch_counts()
    if (launches["pack"] <= 0 or launches["delta_pack"] != 0
            or launches["grid_quant"] != 0 or launches["unpack"] != 1):
        raise AssertionError(f"{name} oracle round launches {launches}")
    for (path, _), a, b in zip(tree_leaves_with_path(state.params),
                               m_fused.payload.entries, m_two.payload.entries):
        same = bitwise_equal(a.wire, b.wire) and all(
            bitwise_equal(x[key], y[key])
            for x, y in zip(a.aux, b.aux) for key in x)
        if not same:
            raise AssertionError(f"{name}: two-pass payload differs on {path}")
    for a, b in zip(tree_leaves(s_fused.params), tree_leaves(s_two.params)):
        if not bitwise_equal(a, b):
            raise AssertionError(f"{name}: two-pass round's params differ")
    log("oracle", f"{name}: FusedCodec(fused=False) round: payload "
                  f"({m_two.payload.measured_bytes()} bytes, {K} nodes) and "
                  f"params equal to the fused round's bit for bit; launches "
                  f"{launches}")
    return launches, oracle_fn, m_fused.payload


def check_cpu_decode(compressor, payload):
    """The card's decode of a payload equals the plain CPU decode of the
    same payload, bit for bit."""
    cpu = WirePayload(
        [LeafPayload(wire=e.wire.cpu(),
                     aux=tuple({k: t.cpu() for k, t in aux.items()}
                               for aux in e.aux)) for e in payload.entries],
        payload.paths, payload.specs, payload.stages)
    on_card, on_cpu = compressor.decode(payload), compressor.decode(cpu)
    for (path, a), (_, b) in zip(tree_leaves_with_path(on_card),
                                 tree_leaves_with_path(on_cpu)):
        if a.device != payload.entries[0].wire.device or \
                not bitwise_equal(a.cpu(), b):
            raise AssertionError(f"card decode differs from the CPU's on {path}")
    log("oracle", f"{PIPE}: the card's decode of the fused payload equals the "
                  f"plain CPU decode bit for bit ({len(payload.entries)} leaves)")


# --------------------------------------------------------------------------
# phase 5: the chunked engine, a CUDA graph a chunk
# --------------------------------------------------------------------------

# the ported kernels' launches a round inside a replayed chunk, from its
# trace (threefry: at most)
REPLAY_LAUNCHES = {"delta_pack": 1, "unpack": 1, "grid_quant": 1, "qsgd": 1,
                   "fused_update": 10, "block_topk": 10,
                   "threefry": MAX_DRAW_LAUNCHES_A_ROUND}


def same_tensors(label: str, got, want) -> None:
    """Assert two lists of tensors equal bit for bit."""
    got, want = list(got), list(want)
    if len(got) != len(want) or not all(
            bitwise_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{label}: the graph run differs from the host "
                             f"run")


def same_report(label: str, got, want) -> None:
    """Assert two EvalReports equal field for field, the reliability bins
    bit for bit (NaN equal to NaN: kept_accuracy with nothing kept)."""
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f == "bins":
            ok = all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            ok = a == b or (math.isnan(a) and math.isnan(b))
        if not ok:
            raise AssertionError(f"{label}: EvalReport.{f} {a!r} != {b!r}")


def time_replay(engine, t: int, n: int):
    """A replayed chunk of ``n`` rounds from round ``t`` on: (wall ms a
    round, the median of 5 ``run_chunk`` calls with the metrics read;
    device ms a round, CUDA events around ``graph.replay()``, median of 5;
    the host ms of ``graph.replay()``, median of 5; the next round)."""
    graph, _, _ = engine.graph(n)
    enqueue, walls = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_chunk(t, n)
        walls.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        graph.replay()
        enqueue.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        t += 2 * n
    busy = device_ms(graph.replay, reps=5, per_rep=1) / n
    return statistics.median(walls) / n, busy, statistics.median(enqueue), t


def run_graph(name: str, host, host_res, train, test) -> None:
    """Phase 3's run of ``name`` again with ``engine="scan"``: same seed,
    rounds and ``bank_thin``, ``chunk = rounds / 2``, so the second chunk
    is a replay of the first's graph. Params, v, v̄, key, bank, per-round
    loss and consensus error, bytes and the BMA evaluation against the host
    run, bit for bit. Then the replayed chunk timed and traced: ms per
    round, the device's idle share, each kernel's launches and device ms a
    round inside it."""
    from repro_torch.train import FedTrainer
    cfg = lenet_config()
    _, rounds, wire, launched = RUNS[name]
    n = rounds // 2
    trainer = FedTrainer(get_model(cfg), fed_config(name),
                         partition_iid(train, K), minibatch=MINIBATCH, seed=0,
                         engine="scan", chunk=n, bank_thin=1, device=DEVICE)
    kernels.reset_launch_counts()
    res = trainer.run(rounds=rounds, eval_batch=test)
    launches = kernels.launch_counts()
    engine = trainer._engine
    log("graph", f"{name}: chunks of {n}: capture {engine.capture_ms[n]:.1f} "
                 f"ms; ms/round by chunk {res.round_ms}; launches counted "
                 f"(the warm-up round and the capture) {launches}")
    for kname in launched:
        if launches[kname] <= 0:
            raise AssertionError(f"{name}: the graph run never launched "
                                 f"{kname}")
    if res.wire_history != [float(wire)] * rounds:
        raise AssertionError(f"{name}: graph run bytes {res.wire_history}")
    if (res.loss_history != host_res.loss_history
            or res.consensus_history != host_res.consensus_history):
        raise AssertionError(f"{name}: graph run losses {res.loss_history} "
                             f"consensus {res.consensus_history}, host run "
                             f"{host_res.loss_history} "
                             f"{host_res.consensus_history}")
    for part in ("params", "v", "v_bar"):
        same_tensors(f"{name} {part}", tree_leaves(getattr(trainer.state,
                                                           part)),
                     tree_leaves(getattr(host.state, part)))
    same_tensors(f"{name} key", [trainer.key], [host.key])
    samples = trainer.bank.samples
    if len(samples) != len(host.bank.samples) or \
            list(trainer.bank_cfg.rounds_list(trainer._bank_state)) != \
            host.bank.rounds:
        raise AssertionError(f"{name}: graph bank holds {len(samples)}")
    for got, want in zip(samples, host.bank.samples):
        same_tensors(f"{name} bank", tree_leaves(got), tree_leaves(want))
    # the BMA probabilities and every field of the report, ECE, MCE and
    # overconf_gap included, bit for bit (the bins sum in a fixed order)
    if not np.array_equal(res.probs.view(np.int32),
                          host_res.probs.view(np.int32)):
        raise AssertionError(f"{name}: graph run's BMA probabilities differ")
    same_report(f"{name} graph run's evaluation", res.report, host_res.report)
    log("graph", f"{name}: {rounds} rounds in chunks of {n} (one capture, "
                 f"{rounds // n - 1} replay): params, v, v̄, key, the bank "
                 f"({len(samples)} samples), losses, consensus, bytes "
                 f"({wire:,}), BMA probabilities and the whole report "
                 f"(accuracy {res.accuracy:.4f}, ECE {res.ece!r}, MCE "
                 f"{res.report.mce!r}, overconf_gap "
                 f"{res.report.overconf_gap!r}) equal to the host run's bit "
                 f"for bit")

    # the replayed chunk, timed and traced (the carry runs on from here)
    wall, busy, enqueue, t = time_replay(engine, rounds, n)
    host_ms = statistics.median(host_res.round_ms[1:])
    carry_bytes = 4 * 3 * tree_count(trainer.state.params) + 16   # + key
    copy_ms = 2 * carry_bytes / HBM_BYTES_PER_S * 1e3
    log("graph", f"{name}: a replayed chunk of {n}: {wall:.3f} ms a round "
                 f"(median of 5 run_chunk calls, the metrics read included), "
                 f"{busy:.3f} ms of it on the device (CUDA events around "
                 f"graph.replay(), median of 5): idle "
                 f"{100 * (1 - busy / wall):.1f}%; host engine (phase 3) "
                 f"{host_ms:.3f} ms a round, idle about "
                 f"{100 * (1 - busy / host_ms):.1f}% against the same device "
                 f"time; host time of graph.replay() "
                 f"{enqueue:.3f} ms; capture "
                 f"{engine.capture_ms[n]:.1f} ms; the carry copy at the "
                 f"chunk's end {2 * carry_bytes / 1e6:.0f} MB, bound "
                 f"{copy_ms:.4f} ms")
    span = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def traced_chunk():
        span[0].record()
        engine.run_chunk(t, n)
        span[1].record()
    def per_round(by_name, kname):
        us, count = trace_hits(by_name, kname)
        return us / 1e3 / n, count / n

    def whole(by_name, kname):
        got, want = per_round(by_name, kname)[1], REPLAY_LAUNCHES[kname]
        return 1 <= got <= want and (kname == "threefry" or got == want)

    # a replay launches through no wrapper: each kernel of the path at
    # least once a round
    by_name = profiled(traced_chunk, expect=dict.fromkeys(launched, n))
    if by_name is None:
        raise AssertionError(f"{name}: no whole trace of the replay in "
                             f"{TRACE_ATTEMPTS} tries")
    traced = sum(tm for tm, _ in by_name.values()) / 1e3 / n
    log("graph", f"{name}: traced replay: its device events sum to "
                 f"{traced:.3f} ms a round, and it spans "
                 f"{span[0].elapsed_time(span[1]) / n:.3f} ms a round on "
                 f"CUDA events, against {busy:.3f} ms untraced")
    for kname in launched:
        ms, count = per_round(by_name, kname)
        log("graph", f"  {name}: {kname} {ms:.4f} ms device time and "
                     f"{count:g} launches a round inside the replay")
        if not whole(by_name, kname):
            raise AssertionError(f"{name}: {kname} launched {count:g} "
                                 f"times a round in the replay, want "
                                 f"{REPLAY_LAUNCHES[kname]}")
    count, ms = norm_reductions(by_name)
    log("graph", f"  {name}: torch norm reductions: {count / n:g} launches, "
                 f"{ms / n:.4f} ms device time a round")
    del trainer, engine
    torch.cuda.empty_cache()


def run_default_chunk(train) -> None:
    """The scan engine as a user gets it: ``FedTrainer`` with its default
    engine, chunk (64 rounds) and bank (40 samples, thin 2) on the
    ``block_topk`` configuration, 128 rounds in two runs: the first
    captures the 64-round graph and replays it, the second only replays.
    Every loss finite, the bank full, the bytes exact; capture time, ms a
    round of the second run and the peak device memory logged."""
    from repro_torch.train import FedTrainer
    cfg = lenet_config()
    _, _, wire, _ = RUNS["block_topk"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = FedTrainer(get_model(cfg), fed_config("block_topk"),
                         partition_iid(train, K), minibatch=MINIBATCH, seed=0,
                         device=DEVICE)
    first = trainer.run(rounds=64)
    second = trainer.run(rounds=64)
    losses = first.loss_history + second.loss_history
    if not (all(math.isfinite(x) for x in losses)
            and first.wire_history + second.wire_history == [float(wire)] * 128
            and len(trainer.bank) == 40 and trainer.state.round == 128):
        raise AssertionError(f"default chunk: losses {losses[-3:]}, bank "
                             f"{len(trainer.bank)}, round {trainer.state.round}")
    log("graph", f"block_topk, FedTrainer's defaults (chunks of 64, bank of "
                 f"40): capture {trainer._engine.capture_ms[64]:.1f} ms; first "
                 f"run {first.round_ms[0]:.3f} ms a round (warm-up, capture, "
                 f"replay), second {second.round_ms[0]:.3f} ms a round (one "
                 f"replay); bank {len(trainer.bank)} samples; peak device "
                 f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del trainer
    torch.cuda.empty_cache()


# device kernel names of the ported kernels in a profiler trace; an update
# variant's float4 launch and its scalar tail both count
TRACE_NAMES = {kname: re.compile(pattern) for kname, pattern in {
    "pack": r"pack_kernel<false\b", "delta_pack": r"pack_kernel<true, float>",
    "unpack": r"\bunpack_kernel", "fused_update": r"fused_update_\w+<0>",
    "grid_quant": r"grid_quant_kernel", "qsgd": r"qsgd_kernel",
    "block_topk": r"block_topk_kernel", "threefry": r"threefry_kernel",
    "topk_select": r"topk_select_kernel<\w+, float>",
    "unpack_set": r"unpack_set_kernel",
    "cffl_update": r"fused_update_\w+<1>",
    "dsgld_update": r"fused_update_\w+<2>",
    "gossip_mix": r"gossip_mix_(tiles|rows)",
    "gilbert_keep": r"gilbert_keep_kernel",
    "topk_select_bf16": r"topk_select_kernel<true, \w*bfloat16",
    "delta_pack_bf16": r"pack_kernel<true, \w*bfloat16",
    "fused_update_bf16": r"control_update_\w+<0, \w*bfloat16",
    "cffl_update_bf16": r"control_update_\w+<1, \w*bfloat16",
    "topk_select_f16": r"topk_select_kernel<true, \w*half",
    "delta_pack_f16": r"pack_kernel<true, \w*half",
    "fused_update_f16": r"control_update_\w+<0, \w*half",
    "cffl_update_f16": r"control_update_\w+<1, \w*half",
    "decode_attention": r"decode_attention_(split_)?kernel",
    "bma_sample": r"bma_sample_kernel"}.items()}
# tries at a whole trace, and the least launches of its warm-up (profiled)
TRACE_ATTEMPTS, WARM_LAUNCHES = 4, 32
# the traced round each kernel's in-round device time is read from
TRACE_ROUND = {"pack": "block_topk oracle", "delta_pack": "block_topk",
               "unpack": "block_topk", "fused_update": "block_topk",
               "grid_quant": PIPE, "qsgd": "qsgd_pallas",
               "block_topk": "block_topk_pallas", "threefry": PIPE}


# torch.linalg.vector_norm's reduction kernels in a profiler trace
NORM_REDUCTION = "Norm"


def norm_reductions(by_name):
    """(launches, device ms) of torch's norm reductions in a trace."""
    hits = [(t, c) for n, (t, c) in by_name.items() if NORM_REDUCTION in n]
    return sum(c for _, c in hits), sum(t for t, _ in hits) / 1e3


def trace_round(trainer, round_fn):
    """(wall ms of an untraced round, {device kernel: (µs, count)} of a
    traced one), from the trainer's state, after a warm-up round. Each
    round draws its inputs from the next round key, as the engine does."""
    key = random.PRNGKey(7, DEVICE)

    def one_round():
        nonlocal key
        key, kround = random.split(key)
        round_fn(trainer.state, *round_inputs(trainer, kround))
        torch.cuda.synchronize()

    one_round()
    t0 = time.perf_counter()
    one_round()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    return wall_ms, profiled(one_round)


def profile_rounds(trainers, oracle_fns, timing):
    """Device-busy share of one full-width round of each configuration and
    its top device kernels (torch.profiler; the kernels' own intervals,
    summed), and each ported kernel's device time in a round beside its
    event-timed cost (pack from a traced oracle round)."""
    rounds = {name: (trainers[name], trainers[name].round_fn)
              for name in RUNS}
    rounds["block_topk oracle"] = (trainers["block_topk"],
                                   oracle_fns["block_topk"])
    traces = {}
    for label, (trainer, fn) in rounds.items():
        wall_ms, by_name = trace_round(trainer, fn)
        if not by_name:
            log("profile", "the profiler saw no device events: device time "
                           "not measured")
            return
        traces[label] = by_name
        busy_ms = sum(t for t, _ in by_name.values()) / 1e3
        log("profile", f"{label}: one round: device busy {busy_ms:.3f} ms of "
                       f"the untraced round's {wall_ms:.3f} ms "
                       f"({100 * busy_ms / wall_ms:.1f}%)")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        for kname, (tot, cnt) in top[:10 if label == PIPE else 5]:
            log("profile", f"  {tot / 1e3:8.3f} ms x{cnt:<4d} {kname[:90]}")
        for kname in TRACE_NAMES:
            us, cnt = trace_hits(by_name, kname)
            if cnt:
                log("profile", f"  {label}: {kname} {us / 1e3:.4f} ms device "
                               f"time, {cnt} launches")
        count, ms = norm_reductions(by_name)
        log("profile", f"  {label}: torch norm reductions: {count} launches, "
                       f"{ms:.4f} ms device time")
        if label == PIPE and count:
            raise AssertionError(f"{PIPE} round ran {count} torch norm "
                                 f"reductions; its norms are grid_quant's")
    for kname, label in TRACE_ROUND.items():
        us, cnt = trace_hits(traces[label], kname)
        log("profile", f"{kname}: {us / 1e3:.4f} ms device time in the traced "
                       f"{label} round, {cnt} launches; event-timed "
                       f"{timing[kname]['ms']:.4f} ms a round (phase 2)")


# --------------------------------------------------------------------------
# phase 7: the paper's default run and its two baselines, and the codecs
# --------------------------------------------------------------------------

# algorithm: (rounds, wire bytes per node per round, the kernels it
# launches, those it launches once a round)
DEFAULT_RUNS = {
    "cdbfl": (4, 167_682, ("topk_select", "unpack_set", "fused_update",
                           "threefry"), ("topk_select", "unpack_set")),
    "dsgld": (4, 10_395_384, ("dsgld_update", "threefry"), ()),
    "cffl": (4, 167_682, ("topk_select", "unpack_set", "cffl_update",
                          "threefry"), ("topk_select", "unpack_set")),
}
# one cdbfl round of each other codec: FedConfig overrides, bytes, kernels
CODEC_ROUNDS = {
    "topk": (dict(compressor="topk"), 207_498,
             ("topk_select", "unpack_set", "fused_update", "threefry")),
    "randk": (dict(compressor="randk"), 104_056,
              ("fused_update", "threefry")),
    "sign": (dict(compressor="sign"), 649_756, ("fused_update", "threefry")),
    "qsgd": (dict(compressor="qsgd"), 2_598_886,
             ("grid_quant", "fused_update", "threefry")),
    "identity": (dict(compressor="identity"), 10_395_384,
                 ("fused_update", "threefry")),
    PIPE + " (unfused)": (dict(pipeline=PIPE), 83_881,
                          ("topk_select", "grid_quant", "unpack_set",
                           "fused_update", "threefry")),
}


def default_config(algorithm: str, rounds: int, **overrides) -> FedConfig:
    """Phase 3's configuration at FedConfig's default fused_compress=False
    (the field is left at its default), under ``algorithm``."""
    return FedConfig(**dict(
        dict(num_nodes=K, local_steps=L, eta=1e-4, zeta=0.03, temperature=1.0,
             burn_in=BURN_IN, rounds=rounds, compress_ratio=RATIO,
             block_size=BLOCK, qsgd_levels=LEVELS, topology="full",
             algorithm=algorithm), **overrides))


def shift_set(hw):
    """The days-2/3 safety-critical shift set (examples/radar_hrc.py:43-49)."""
    parts = [critical_subset(make_dataset(250, hw=hw, day=d, seed=90 + d))
             for d in (2, 3)]
    return {k: np.concatenate([p[k] for p in parts]) for k in ("x", "y")}


def check_baseline_seeded(algorithm: str, fed: FedConfig, res) -> None:
    """Rounds 1-2 against the reference's seeded CPU run of the same
    configuration: bytes exact, loss and consensus within rtol 1e-3."""
    want = json.loads(BASELINE_ROUNDS_FILE.read_text())[algorithm]
    mine = dict(baseline_config(algorithm), reduced=REDUCED,
                train_maps=K * 50, minibatch=MINIBATCH,
                fed={k: getattr(fed, k) for k in want["config"]["fed"]})
    if want["config"] != mine:
        raise AssertionError(f"{BASELINE_ROUNDS_FILE.name} ran "
                             f"{want['config']}, this run is {mine}")
    n = len(want["loss"])
    if res.wire_history[:n] != want["wire_bytes"]:
        raise AssertionError(f"{algorithm}: seeded bytes "
                             f"{res.wire_history[:n]} != {want['wire_bytes']}")
    for metric, got in (("loss", res.loss_history),
                        ("consensus", res.consensus_history)):
        if not np.allclose(got[:n], want[metric], rtol=1e-3, atol=0):
            raise AssertionError(f"{algorithm}: seeded {metric} {got[:n]} "
                                 f"differs from the reference's "
                                 f"{want[metric]}")
    log("default", f"{algorithm}, seed 0, rounds 1-{n} against the "
                   f"reference's seeded CPU run: loss {res.loss_history[:n]} "
                   f"vs {want['loss']}, consensus {res.consensus_history[:n]}"
                   f" vs {want['consensus']}, bytes exact (rtol 1e-3 held)")


def run_default(algorithm: str, train, test, shift):
    """The paper's default configuration under ``algorithm`` on the host
    engine, then on the scan engine (chunks of 2) against it bit for bit;
    each evaluated on the day-1 test maps and on the shift set. Returns
    the host run's launches and its evaluations."""
    from repro_torch.train import FedTrainer
    cfg = lenet_config()
    rounds, wire, launched, once = DEFAULT_RUNS[algorithm]
    fed = default_config(algorithm, rounds)
    if fed.fused_compress:
        raise AssertionError("FedConfig's default fused_compress changed")
    runs = {}
    for engine in ("host", "scan"):
        trainer = FedTrainer(get_model(cfg), fed, partition_iid(train, K),
                             minibatch=MINIBATCH, seed=0, engine=engine,
                             chunk=2, bank_thin=1, device=DEVICE)
        kernels.reset_launch_counts()
        res = trainer.run(rounds=rounds, eval_batch=test)
        launches = kernels.launch_counts()
        shifted = trainer.evaluate(shift)
        runs[engine] = (trainer, res, launches, shifted)
        log("default", f"{algorithm} ({engine} engine): ms/round "
                       f"{[round(x, 2) for x in res.round_ms]}; losses "
                       f"{res.loss_history}; consensus "
                       f"{res.consensus_history}; bank {len(trainer.bank)}; "
                       f"day-1 accuracy {res.accuracy:.4f} ECE "
                       f"{res.ece:.4f}; shift set ({len(shift['y'])} maps) "
                       f"accuracy {shifted.accuracy:.4f} ECE "
                       f"{shifted.ece:.4f}; launches {launches}")
        values = (res.loss_history + res.consensus_history
                  + [res.accuracy, res.ece, shifted.accuracy, shifted.ece])
        if not all(math.isfinite(x) for x in values):
            raise AssertionError(f"{algorithm}: non-finite metric {values}")
        if res.wire_history != [float(wire)] * rounds:
            raise AssertionError(f"{algorithm}: wire bytes/node/round "
                                 f"{res.wire_history}, want {wire}")
        for kname in launched:
            if launches[kname] <= 0:
                raise AssertionError(f"{algorithm}: the {engine} run never "
                                     f"launched {kname}")
        want_bank = 0 if algorithm == "cffl" else rounds - BURN_IN
        if len(trainer.bank) != want_bank:
            raise AssertionError(f"{algorithm}: bank holds "
                                 f"{len(trainer.bank)}, want {want_bank}")
    host, res, launches, shifted = runs["host"]
    for kname in once:
        if launches[kname] != rounds:
            raise AssertionError(f"{algorithm}: {kname} launched "
                                 f"{launches[kname]} times in {rounds} "
                                 f"rounds, not once a round")
    check_baseline_seeded(algorithm, host.fed_cfg, res)
    scan, sres, _, sshift = runs["scan"]
    if (sres.loss_history != res.loss_history
            or sres.consensus_history != res.consensus_history
            or sres.wire_history != res.wire_history):
        raise AssertionError(f"{algorithm}: scan run's metrics differ from "
                             f"the host run's")
    for part in ("params", "v", "v_bar"):
        same_tensors(f"{algorithm} {part}",
                     tree_leaves(getattr(scan.state, part)),
                     tree_leaves(getattr(host.state, part)))
    same_tensors(f"{algorithm} key", [scan.key], [host.key])
    for got, want in zip(scan.bank.samples, host.bank.samples):
        same_tensors(f"{algorithm} bank", tree_leaves(got), tree_leaves(want))
    if not (np.array_equal(sres.probs.view(np.int32),
                           res.probs.view(np.int32))
            and np.array_equal(sshift.probs.view(np.int32),
                               shifted.probs.view(np.int32))):
        raise AssertionError(f"{algorithm}: scan run's evaluation differs")
    same_report(f"{algorithm} day-1 evaluation", sres.report, res.report)
    same_report(f"{algorithm} shift-set evaluation", sshift.report,
                shifted.report)
    log("default", f"{algorithm}: scan engine (chunks of 2) equal to the host "
                   f"engine bit for bit: params, v, v̄, key, bank "
                   f"({len(scan.bank)} samples), losses, consensus, bytes "
                   f"({wire:,}), BMA probabilities and every report field "
                   f"(ECE, MCE, overconf_gap included) on both test sets")
    if "topk_select" in once:
        ds = [(p - v).reshape(K, -1) for p, v in zip(
            tree_leaves(host.state.params), tree_leaves(host.state.v))]
        blocks, fallen, mean = fallback_share(
            ds, [leaf_k(d.shape[1]) for d in ds])
        log("default", f"{algorithm}: topk_select's fast-path rule "
                       f"(topk_candidates_plain) on params − v "
                       f"after {rounds} rounds: {fallen} of {blocks} blocks "
                       f"take the k-th-key search "
                       f"({100 * fallen / blocks:.4f}%); {mean:.2f} "
                       f"candidates a block on average")
    engine = scan._engine
    wall, busy, enqueue, _ = time_replay(engine, rounds, 2)
    host_ms = statistics.median(res.round_ms[1:])
    log("default", f"{algorithm}: a replayed chunk of 2: {wall:.3f} ms a "
                   f"round (median of 5 run_chunk calls, the metrics read "
                   f"included), {busy:.3f} ms of it on the device (CUDA "
                   f"events around graph.replay(), median of 5): idle "
                   f"{100 * (1 - busy / wall):.1f}%; host engine "
                   f"{host_ms:.3f} ms a round, idle about "
                   f"{100 * (1 - busy / host_ms):.1f}% against the same "
                   f"device time; host time of graph.replay() "
                   f"{enqueue:.3f} ms; capture {engine.capture_ms[2]:.1f} ms")
    evals = dict(accuracy=res.accuracy, ece=res.ece,
                 shift_accuracy=shifted.accuracy, shift_ece=shifted.ece,
                 replay_ms=(wall, busy))
    del runs, host, scan, engine
    torch.cuda.empty_cache()
    return launches, evals


def run_codec_round(name: str, train) -> None:
    """One full-width cdbfl round of a codec on the host engine: its bytes
    exact, every value finite, each kernel of its path launched."""
    from repro_torch.train import FedTrainer
    cfg = lenet_config()
    overrides, wire, launched = CODEC_ROUNDS[name]
    trainer = FedTrainer(get_model(cfg), default_config("cdbfl", 1,
                                                        **overrides),
                         partition_iid(train, K), minibatch=MINIBATCH,
                         seed=0, engine="host", device=DEVICE)
    kernels.reset_launch_counts()
    res = trainer.run(rounds=1)
    launches = kernels.launch_counts()
    if res.wire_history != [float(wire)]:
        raise AssertionError(f"{name}: wire bytes {res.wire_history}, want "
                             f"{wire}")
    if not (math.isfinite(res.loss_history[0]) and all(
            torch.isfinite(x).all() for x in tree_leaves(
                trainer.state.params))):
        raise AssertionError(f"{name}: non-finite round")
    for kname in launched:
        if launches[kname] <= 0:
            raise AssertionError(f"{name}: the round never launched {kname}")
    log("default", f"codec {name}: one round, {res.round_ms[0]:.2f} ms, loss "
                   f"{res.loss_history[0]:.4f}, wire bytes/node {wire:,} "
                   f"(exact); launches "
                   f"{ {k: v for k, v in launches.items() if v} }")
    del trainer
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 8: the posterior served on the card
# --------------------------------------------------------------------------

# the kernels the phase's path launches: the cdbfl run's and the CLI's
# synthetic bank init (threefry)
SERVE_LAUNCHED = ("topk_select", "unpack_set", "fused_update", "threefry")
EVAL_BATCH = 64          # FedTrainer's and the eval engines' default
SWAPS = 8


def same_probs(label: str, got, want) -> None:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if got.shape != want.shape or not np.array_equal(got.view(np.int32),
                                                     want.view(np.int32)):
        raise AssertionError(f"{label}: probabilities differ")


def replay_ms(graphs) -> float:
    """Device ms of one replay of the only graph in ``graphs`` (an engine's
    captured graphs): CUDA events, the median of 5."""
    (g,) = graphs.values()
    return device_ms(g.graph.replay, reps=5, per_rep=1)


def wall_ms(fn, reps: int = 5) -> float:
    """Median host ms of ``fn`` ending in a device sync, after one call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def check_eval(model, bank, name: str, data):
    """The scan eval engine against the host eval engine on ``data``: the
    probabilities and every report field bit for bit; each engine's ms.
    Returns the scan engine's probabilities."""
    scan = ScanEvalEngine(model.logits, batch_size=EVAL_BATCH)
    host = HostEvalEngine(model.logits, batch_size=EVAL_BATCH)
    srep, sprobs = scan.evaluate(bank, data, node_axis=1, return_probs=True)
    hrep, hprobs = host.evaluate(bank, data, node_axis=1, return_probs=True)
    same_probs(f"{name}: scan eval against host eval", sprobs, hprobs)
    same_report(f"{name}: scan eval against host eval", srep, hrep)
    replay = replay_ms(scan._graphs)
    scan_ms = wall_ms(lambda: scan.evaluate(bank, data, node_axis=1,
                                            return_probs=True))
    host_ms = wall_ms(lambda: host.evaluate(bank, data, node_axis=1,
                                            return_probs=True))
    nb = -(-len(data["y"]) // EVAL_BATCH)
    log("serve", f"eval, {name} ({len(data['y'])} maps, {nb} batches of "
                 f"{EVAL_BATCH}): scan graph equal to the host loop bit for "
                 f"bit (probabilities; accuracy {srep.accuracy:.4f}, ECE "
                 f"{srep.ece!r}, MCE {srep.mce!r}, overconf_gap "
                 f"{srep.overconf_gap!r}); scan: capture "
                 f"{sum(scan.capture_ms.values()):.1f} ms, one replay "
                 f"{replay:.3f} "
                 f"device ms (CUDA events, median of 5), evaluate "
                 f"{scan_ms:.3f} ms wall (copies in, replay, report and "
                 f"probabilities read; median of 5); host loop evaluate "
                 f"{host_ms:.3f} ms wall (median of 5)")
    return sprobs


def serve_all(eng, xs, threshold=None):
    """``eng.run`` over ``xs`` timed: (responses, requests/s, p50 ms, p99 ms
    of their latencies)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resps = eng.run([ServeRequest(x=x) for x in xs])
    dt = time.perf_counter() - t0
    lat = np.asarray([r.latency_s for r in resps]) * 1e3
    return (resps, len(resps) / dt, float(np.percentile(lat, 50)),
            float(np.percentile(lat, 99)))


def check_classify(model, pred, test, eval_probs):
    """ClassifyEngine at 64 slots (the eval batch: bit-equal to the scan
    eval) and at 8 slots with the README's entropy gate; no recapture after
    the warm-up at any occupancy. Returns the 8-slot engine."""
    shape = test["x"].shape[1:]
    eng = ClassifyEngine(model.logits, ServeConfig(slots=EVAL_BATCH),
                         input_shape=shape, stacked=pred.stacked, node_axis=1)
    eng.run([ServeRequest(x=test["x"][0])])
    c0 = eng.compile_count()
    resps, rate, p50, p99 = serve_all(eng, test["x"])
    probs = np.stack([r.probs for r in resps])
    same_probs("classify (64 slots) against the scan eval", probs,
               eval_probs)
    ent = np.asarray([r.entropy for r in resps], np.float32)
    want = predictive_entropy(torch.from_numpy(probs)).numpy()
    if not np.allclose(ent, want, rtol=1e-6, atol=0):
        raise AssertionError("classify entropies differ from "
                             "predictive_entropy of its probabilities")
    if eng.compile_count() != c0 or c0 != 1:
        raise AssertionError(f"64 slots: {c0} captures at warm-up, "
                             f"{eng.compile_count()} after")
    log("serve", f"classify, 64 slots, {len(resps)} day-1 maps: equal to the "
                 f"scan eval bit for bit, entropies within rtol 1e-6 of "
                 f"predictive_entropy; {rate:.1f} requests/s, p50 {p50:.3f} "
                 f"ms, p99 {p99:.3f} ms; captures {c0} at warm-up, "
                 f"{eng.compile_count()} after")
    del eng

    eng = ClassifyEngine(model.logits, ServeConfig(slots=8,
                                                   entropy_threshold=1.2),
                         input_shape=shape, stacked=pred.stacked, node_axis=1)
    eng.run([ServeRequest(x=test["x"][0])])
    c0 = eng.compile_count()
    resps, rate, p50, p99 = serve_all(eng, test["x"][:32])
    abstain = float(np.mean([r.abstain for r in resps]))
    partial = eng.run([ServeRequest(x=x) for x in test["x"][32:35]])
    single = eng.run([ServeRequest(x=test["x"][3])])
    if not (eng.compile_count() == c0 == 1 and len(partial) == 3):
        raise AssertionError(f"8 slots: {c0} captures at warm-up, "
                             f"{eng.compile_count()} after full, partial and "
                             f"single occupancy")
    alone = bool(np.array_equal(single[0].probs.view(np.int32),
                                resps[3].probs.view(np.int32)))
    replay = replay_ms(eng.predictor._graphs)
    log("serve", f"classify, 8 slots, 32 requests, entropy_threshold 1.2: "
                 f"{rate:.1f} requests/s, p50 {p50:.3f} ms, p99 {p99:.3f} "
                 f"ms, abstain rate {abstain:.4f}; predict graph capture "
                 f"{sum(eng.predictor.capture_ms.values()):.1f} ms, one "
                 f"replay {replay:.3f} device ms (CUDA events, median of 5); "
                 f"captures {c0} at warm-up, {eng.compile_count()} after "
                 f"full, partial (3) and single occupancy; a request alone "
                 f"in slot 0 equal to the same in slot 3 of a full table: "
                 f"{alone}")
    return eng


def check_swaps(eng, bank, test):
    """SWAPS same-size hot swaps between ``bank`` and a perturbed copy:
    memory_allocated flat, no recapture, bank_version counted; the last
    swap back to ``bank`` answers as before."""
    x = test["x"][:8]
    before = np.stack([r.probs for r in eng.run(
        [ServeRequest(x=v) for v in x])])
    other = tree_map(lambda t: t * 1.01, bank)
    eng.install_bank(other)                       # reach steady state
    eng.run([ServeRequest(x=x[0])])
    gc.collect()
    torch.cuda.synchronize()
    m0, c0, v0 = live_device_bytes(), eng.compile_count(), eng.bank_version
    install = []
    for i in range(SWAPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.install_bank(bank if i % 2 == 0 else other)
        torch.cuda.synchronize()
        install.append(1e3 * (time.perf_counter() - t0))
        eng.run([ServeRequest(x=x[0])])
    eng.install_bank(bank)
    after = np.stack([r.probs for r in eng.run(
        [ServeRequest(x=v) for v in x])])
    gc.collect()
    torch.cuda.synchronize()
    m1 = live_device_bytes()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(bank))
    one = statistics.median(install)
    if not (m1 == m0 and eng.compile_count() == c0
            and eng.bank_version == v0 + SWAPS + 1):
        raise AssertionError(f"hot swaps: memory {m0} -> {m1} B, captures "
                             f"{c0} -> {eng.compile_count()}, version {v0} "
                             f"-> {eng.bank_version}")
    same_probs("the bank swapped back in", after, before)
    log("serve", f"hot swap: {SWAPS} same-size swaps of a {nbytes:,} B bank "
                 f"(2 x K={K}): torch.cuda.memory_allocated {m0:,} B before "
                 f"and {m1:,} B after, captures {c0} -> "
                 f"{eng.compile_count()}, bank_version {v0} -> "
                 f"{eng.bank_version}; one install {one:.3f} ms (median of "
                 f"{SWAPS}, synchronized), bound "
                 f"{2 * nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; the bank "
                 f"swapped back answers as before, bit for bit")


def check_checkpoint(eng, bank, test):
    """save_bank and load_bank of the full-width bank: equal bit for bit,
    and the engine's answers unchanged after installing it."""
    x = [ServeRequest(x=v) for v in test["x"][:8]]
    before = np.stack([r.probs for r in eng.run(x)])
    like = tree_map(lambda t: t[0, 0], bank)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        save_bank(d, 4, bank)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_bank(d, like=like)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    same_tensors("the bank through save_bank and load_bank",
                 tree_leaves(loaded), tree_leaves(bank))
    eng.install_bank(loaded)
    same_probs("answers after installing the loaded bank",
               np.stack([r.probs for r in eng.run(x)]), before)
    log("serve", f"checkpoint: save_bank {save_s:.2f} s, load_bank to the "
                 f"card {load_s:.2f} s; the loaded bank equals the saved one "
                 f"bit for bit and answers as before")


def check_cli(bank) -> None:
    """The serving CLI in-process on the card: a synthetic full-width bank
    against the reference's answers, then two snapshots with a swap
    mid-stream."""
    c = SERVE_CONFIG
    golden = np.load(SERVE_BMA_FILE)
    if json.loads(str(golden["config"])) != c or c["reduced"] != REDUCED:
        raise AssertionError(f"{SERVE_BMA_FILE.name} ran {golden['config']}")
    resps = serve_cli.main(["--seed", str(c["seed"]), "--samples",
                            str(c["samples"]), "--requests",
                            str(c["requests"]), "--entropy-threshold", "1.2",
                            "--smoke"])
    probs = np.stack([r.probs for r in resps[:c["maps"]]])
    err = float(np.max(np.abs(probs / golden["probs"] - 1)))
    if not (err <= 1e-4 and np.array_equal(probs.argmax(-1),
                                           golden["probs"].argmax(-1))):
        raise AssertionError(f"CLI bank against the reference: rel err {err}")
    log("serve", f"CLI, synthetic bank ({c['samples']} inits, seed "
                 f"{c['seed']}): its first {c['maps']} answers within "
                 f"{err:.3g} relative of the reference's (rtol 1e-4), argmax "
                 f"{probs.argmax(-1).tolist()} exact")
    with tempfile.TemporaryDirectory() as d:
        save_bank(d, 1, bank)
        save_bank(d, 2, tree_map(lambda t: t * 1.01, bank))
        resps = serve_cli.main(["--ckpt-dir", d, "--follow-snapshots",
                                "--requests", "32", "--smoke"])
    versions = sorted({r.bank_version for r in resps})
    if versions != [1, 2]:
        raise AssertionError(f"--follow-snapshots: bank versions {versions}")
    log("serve", "CLI, two snapshots with --follow-snapshots: a swap "
                 "mid-stream (answers from bank versions 1 and 2)")


def check_default_flags(model, bank, test, eval_probs) -> None:
    """Whether the scan eval, host eval and classify contracts hold with
    cuDNN's defaults (TF32 allowed, nondeterministic algorithms allowed),
    and with cudnn.benchmark on too; logged, not gated (main() sets
    deterministic cuDNN with TF32 off for the rest of the run)."""
    cudnn = torch.backends.cudnn
    flags = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    try:
        for benchmark in (False, True):
            cudnn.allow_tf32 = True
            cudnn.deterministic = False
            cudnn.benchmark = benchmark
            srep, sprobs = ScanEvalEngine(
                model.logits, batch_size=EVAL_BATCH).evaluate(
                bank, test, node_axis=1, return_probs=True)
            hrep, hprobs = HostEvalEngine(
                model.logits, batch_size=EVAL_BATCH).evaluate(
                bank, test, node_axis=1, return_probs=True)
            eng = ClassifyEngine(model.logits, ServeConfig(slots=EVAL_BATCH),
                                 input_shape=test["x"].shape[1:],
                                 stacked=bank, node_axis=1)
            cprobs = np.stack([r.probs for r in eng.run(
                [ServeRequest(x=x) for x in test["x"]])])
            same = lambda a, b: bool(np.array_equal(  # noqa: E731
                a.view(np.int32), b.view(np.int32)))
            err = float(np.max(np.abs(sprobs - eval_probs)))
            log("serve", f"cuDNN's defaults (allow_tf32 True, deterministic "
                         f"False, benchmark {benchmark}): scan eval equal to "
                         f"host eval: {same(sprobs, hprobs)} (ECE "
                         f"{srep.ece == hrep.ece}); classify equal to scan "
                         f"eval: {same(cprobs, sprobs)}; largest difference "
                         f"from the TF32-off probabilities {err:.3g}")
            del eng
    finally:
        cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = flags


def run_serve(train, test, shift) -> dict:
    """Phase 8. Returns the launch counts of its path."""
    from repro_torch.train import FedTrainer
    log("serve", f"on {card_line()}")
    cfg = lenet_config()
    model = get_model(cfg)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    trainer = FedTrainer(model, default_config("cdbfl", 4),
                         partition_iid(train, K), minibatch=MINIBATCH, seed=0,
                         chunk=2, bank_thin=1, device=DEVICE)
    trainer.run(rounds=4)
    m0 = torch.cuda.memory_allocated()
    pred = trainer.predictor()
    copy = torch.cuda.memory_allocated() - m0
    bank = pred.stacked
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(bank))
    log("serve", f"cdbfl, 4 rounds (scan engine, chunks of 2): a bank of "
                 f"{pred.num_samples()} samples x K={K}, {nbytes:,} B; the "
                 f"predictor's copy took {copy:,} B of device memory")
    probs, _ = pred.predict({"x": test["x"][:EVAL_BATCH]})
    _, want = trainer.eval_report({f: v[:EVAL_BATCH] for f, v in test.items()},
                                  return_probs=True)
    same_probs("FedTrainer.predictor().predict against eval_report",
               probs.cpu().numpy(), want)
    log("serve", "FedTrainer.predictor().predict equals "
                 "eval_report(return_probs=True) bit for bit "
                 f"({EVAL_BATCH} maps)")
    eval_probs = check_eval(model, bank, "day-1", test)
    check_eval(model, bank, "shift set", shift)
    eng = check_classify(model, pred, test, eval_probs)
    check_swaps(eng, bank, test)
    check_checkpoint(eng, bank, test)
    check_cli(bank)
    launches = kernels.launch_counts()
    log("serve", f"launches in the phase: "
                 f"{ {k: v for k, v in launches.items() if v} }")
    for kname in SERVE_LAUNCHED:
        if launches[kname] <= 0:
            raise AssertionError(f"serve: the phase never launched {kname}")
    check_default_flags(model, bank, test, eval_probs)
    del trainer, pred, eng
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# phase 9: the training CLI on the graph families' lowerings
# --------------------------------------------------------------------------

# the kernels the CLI run launches (per-layer fc1=block_topk|qsgd over the
# kernel order, the rest block_topk, on the time-varying geometric graph)
TRAIN_LAUNCHED = ("delta_pack", "unpack", "grid_quant", "fused_update",
                  "threefry", "gossip_mix")
# the CLI's mixes that launch: its warm-up round and a capture of 2 rounds
# (the replays count none), one gossip_mix table launch each
CLI_MIX_LAUNCHES = 3
# phase 9's timed graphs: overrides of the paper-default cdbfl run
GRAPH_TIMINGS = {
    "full": dict(topology="full"), "ring": dict(topology="ring"),
    "geometric": dict(topology_cfg=TopologyConfig(
        graph="geometric", radius=GEOMETRIC_TV["radius"])),
    "geometric-tv": dict(topology_cfg=TopologyConfig(**GEOMETRIC_TV))}


def topology_config(name: str) -> FedConfig:
    """The FedConfig of the recorded run ``name`` (``TOPOLOGY_RUNS``)."""
    c = TOPOLOGY_RUNS[name]
    if (c["reduced"] != REDUCED or c["train_maps"] != K * 50
            or c["minibatch"] != MINIBATCH):
        raise AssertionError(f"{name}: the record ran {c}")
    tc = c.get("topology_cfg")
    return FedConfig(rounds=c["rounds"], **c["fed"], **(
        {"topology_cfg": TopologyConfig(**tc)} if tc else {}))


def record_masks(trainer) -> list:
    """Hook the trainer's host engine so that each round's ``(M, K)`` masks
    are kept as the round applies them: the masks among the draws the
    engine hands ``round_fn`` (None on a static graph). Returns the list
    they are appended to, one a round."""
    from repro_torch.core.algorithms import _split_masks
    eng, out = trainer._engine, []
    inner = eng.round_fn

    def hooked(state, batches, key, draws=None):
        masks = _split_masks(inner.mixer, draws)[1]
        out.append(None if masks is None else masks.cpu().numpy())
        return inner(state, batches, key, draws)

    hooked.draws, hooked.mixer = inner.draws, inner.mixer
    eng.round_fn = hooked
    return out


def check_topology_rounds(train) -> None:
    """Phase 9 (a) and (b). The reference's recorded runs on the ring and
    the time-varying geometric graph on the card (host engine): bytes and
    masks exact, loss and consensus within rtol 1e-3; then the cdbfl
    geometric run on the scan engine (chunks of 2) against its host run,
    bit for bit."""
    from repro_torch.train import FedTrainer
    cfg = lenet_config()
    records = json.loads(TOPOLOGY_ROUNDS_FILE.read_text())
    for name in TOPOLOGY_RUNS:
        want = records[name]
        if want["config"] != TOPOLOGY_RUNS[name]:
            raise AssertionError(f"{TOPOLOGY_ROUNDS_FILE.name}: {name} ran "
                                 f"{want['config']}")
        n = len(want["loss"])
        trainer = FedTrainer(get_model(cfg), topology_config(name),
                             partition_iid(train, K), minibatch=MINIBATCH,
                             seed=0, engine="host", device=DEVICE)
        applied = record_masks(trainer)
        kernels.reset_launch_counts()
        res = trainer.run(rounds=n)
        launches = kernels.launch_counts()
        mixer = trainer.round_fn.mixer
        if res.wire_history != want["wire_bytes"]:
            raise AssertionError(f"{name}: bytes {res.wire_history}")
        for metric, got in (("loss", res.loss_history),
                            ("consensus", res.consensus_history)):
            if not np.allclose(got, want[metric], rtol=1e-3, atol=0):
                raise AssertionError(f"{name}: {metric} {got} differs from "
                                     f"the reference's {want[metric]}")
        masks = None
        if want.get("masks") is not None:
            masks = applied
            if len(masks) != n or any(m is None for m in masks) or \
                    [m.tolist() for m in masks] != want["masks"]:
                raise AssertionError(f"{name}: masks differ from the "
                                     f"reference's")
        if mixer.mode not in ("schedule", "schedule_tv") or \
                launches["gossip_mix"] != n:
            raise AssertionError(f"{name}: mixer {mixer.mode}, gossip_mix "
                                 f"launched {launches['gossip_mix']} times "
                                 f"in {n} rounds (one table launch a round)")
        if launches["threefry"] > MAX_DRAW_LAUNCHES_A_ROUND * n:
            raise AssertionError(f"{name}: {launches['threefry']} threefry "
                                 f"launches in {n} rounds")
        log("train", f"{name} ({mixer.mode}, {mixer.schedule.num_perms} "
                     f"matchings), seed 0, rounds 1-{n} against the "
                     f"reference's CPU run: loss {res.loss_history} vs "
                     f"{want['loss']}, consensus {res.consensus_history} vs "
                     f"{want['consensus']} (rtol 1e-3 held), bytes exact"
                     + ("" if masks is None else
                        f", masks exact (active edges a round "
                        f"{[int(m.sum()) for m in masks]})")
                     + f"; launches { {k: v for k, v in launches.items() if v} }")
        del trainer
    # (b) the scan engine against the host engine on the time-varying graph
    fed = topology_config("cdbfl-geometric-tv")
    runs = {}
    for engine in ("host", "scan"):
        trainer = FedTrainer(get_model(cfg), fed, partition_iid(train, K),
                             minibatch=MINIBATCH, seed=0, engine=engine,
                             chunk=2, bank_thin=1, device=DEVICE)
        runs[engine] = (trainer, trainer.run(rounds=4))
    (host, hres), (scan, sres) = runs["host"], runs["scan"]
    if (sres.loss_history != hres.loss_history
            or sres.consensus_history != hres.consensus_history
            or sres.wire_history != hres.wire_history):
        raise AssertionError("geometric-tv: the scan run's metrics differ "
                             "from the host run's")
    for part in ("params", "v", "v_bar"):
        same_tensors(f"geometric-tv {part}",
                     tree_leaves(getattr(scan.state, part)),
                     tree_leaves(getattr(host.state, part)))
    same_tensors("geometric-tv key", [scan.key], [host.key])
    if not len(scan.bank) == len(host.bank) == 4 - BURN_IN:
        raise AssertionError(f"geometric-tv: banks {len(scan.bank)}, "
                             f"{len(host.bank)}")
    for got, want in zip(scan.bank.samples, host.bank.samples):
        same_tensors("geometric-tv bank", tree_leaves(got), tree_leaves(want))
    log("train", f"cdbfl-geometric-tv: scan engine (chunks of 2, the masks "
                 f"drawn and applied inside the graph) equal to the host "
                 f"engine bit for bit over 4 rounds: params, v, v̄, key, bank "
                 f"({len(scan.bank)} samples), losses, consensus, bytes")
    del runs, host, scan
    torch.cuda.empty_cache()


def run_train_cli() -> dict:
    """Phase 9 (c): ``repro_torch.launch.train`` with the recorded flags,
    ``--rounds 4`` and a checkpoint directory, in-process as ``python -m``
    runs it, its launch counts set to 0 just before and read just after;
    its header lines against the reference CLI's, its snapshot written,
    then ``repro_torch.launch.serve`` on that directory. Returns the
    counts."""
    cli = json.loads(TOPOLOGY_ROUNDS_FILE.read_text())["cli"]
    with tempfile.TemporaryDirectory() as d:
        argv = cli["argv"] + ["--rounds", "4", "--ckpt-dir", d]
        log("train", "python -m repro_torch.launch.train " + " ".join(
            f"'{a}'" if "|" in a else a for a in argv))
        buf = io.StringIO()
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            train_cli.main(argv)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        wall = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        for ln in lines:
            log("train", "| " + ln)
        heads = [ln for ln in lines if ln.startswith(CLI_HEADS)]
        if heads != cli["lines"]:
            raise AssertionError(f"CLI header lines {heads} differ from the "
                                 f"reference CLI's {cli['lines']}")
        evals = [ln for ln in lines if ln.startswith("eval  round")]
        snaps = [ln for ln in lines if ln.startswith("bank snapshot:")]
        if len(evals) != 2 or len(snaps) != 1 or not \
                lines[-1].startswith("saved "):
            raise AssertionError(f"CLI output: {lines}")
        missing = [k for k in TRAIN_LAUNCHED if launches[k] <= 0]
        log("train", f"CLI: {wall:.1f} s in-process; header lines equal the "
                     f"reference CLI's; launches "
                     f"{ {k: v for k, v in launches.items() if v} }")
        if missing:
            raise AssertionError(f"the CLI never launched {missing}")
        if launches["gossip_mix"] != CLI_MIX_LAUNCHES:
            raise AssertionError(f"the CLI launched gossip_mix "
                                 f"{launches['gossip_mix']} times, not once "
                                 f"a mix ({CLI_MIX_LAUNCHES})")
        resps = serve_cli.main(["--ckpt-dir", d, "--requests", "16",
                                "--smoke"])
        if len(resps) != 16:
            raise AssertionError(f"serve CLI answered {len(resps)} of 16")
        log("train", "python -m repro_torch.launch.serve --ckpt-dir <the "
                     "CLI's> served its snapshot (16 requests, SMOKE OK)")
    torch.cuda.empty_cache()
    return launches


def time_graphs(train) -> None:
    """Phase 9 (d): the paper-default cdbfl run on the full graph, the
    ring, and the geometric graph static and time-varying: a replayed
    chunk of 2 (ms a round, device ms, idle, as phase 5 times it), the
    mixer's ms a round (its 10 leaves: the trace's device time, and CUDA
    events around the calls, host launches included), threefry's and
    gossip_mix's launches a round (two host-engine rounds: one table
    launch a round on the sparse graphs, none on the full graph)."""
    from repro_torch.train import FedTrainer
    cfg = lenet_config()
    log("train", f"timings on {card_line()}")
    for name, overrides in GRAPH_TIMINGS.items():
        fed = default_config("cdbfl", 4, **overrides)
        host = FedTrainer(get_model(cfg), fed, partition_iid(train, K),
                          minibatch=MINIBATCH, seed=0, engine="host",
                          device=DEVICE)
        kernels.reset_launch_counts()
        host.run(rounds=2)
        counts = kernels.launch_counts()
        mixer = host.round_fn.mixer
        if counts["gossip_mix"] != (0 if mixer.mode == "dense" else 2):
            raise AssertionError(f"{name} ({mixer.mode}): gossip_mix "
                                 f"launched {counts['gossip_mix']} times in "
                                 f"2 rounds")
        masks = (mixer.masks(random.fold_in(host.key, 2))
                 if mixer.masks is not None else None)
        delta = host.state.v
        mix_ms = device_ms(lambda: mixer(delta, masks=masks))
        mix_dev = traced_ms([lambda: mixer(delta, masks=masks)])
        del host
        scan = FedTrainer(get_model(cfg), fed, partition_iid(train, K),
                          minibatch=MINIBATCH, seed=0, engine="scan",
                          chunk=2, bank_thin=1, device=DEVICE)
        res = scan.run(rounds=4)
        if not all(math.isfinite(x) for x in res.loss_history):
            raise AssertionError(f"{name}: non-finite loss")
        wall, busy, _, _ = time_replay(scan._engine, 4, 2)
        log("train", f"{name} ({mixer.mode}"
                     + (f", {mixer.schedule.num_perms} matchings"
                        if mixer.schedule is not None else "")
                     + f"): replayed chunk of 2 {wall:.3f} ms a round, "
                     f"{busy:.3f} ms on the device, idle "
                     f"{100 * (1 - busy / wall):.1f}%; mixer "
                     f"{fmt_ms(mix_dev)} a round on the device (trace), "
                     f"{mix_ms:.4f} ms event-timed; threefry "
                     f"{counts['threefry'] / 2:g} and gossip_mix "
                     f"{counts['gossip_mix'] / 2:g} launches a round")
        del scan
        torch.cuda.empty_cache()


def run_train(train) -> dict:
    """Phase 9. Returns the CLI run's launch counts."""
    log("train", f"on {card_line()}")
    check_topology_rounds(train)
    launches = run_train_cli()
    time_graphs(train)
    return launches


# --------------------------------------------------------------------------
# phase 2, the burst channel's kernel: gilbert_keep
# --------------------------------------------------------------------------

# the burst channels phase 2 holds the kernel to: the defaults, p_enter = 0
# with loss in the good state, a symmetric channel, always enter and never
# leave (every frame sets bad), every frame flips, and flip beside set-bad;
# between them every 2-bit frame map of the scan, and two channels whose
# maps do not commute
GILBERT_CASES = ((0.05, 0.3, 0.0, 1.0), (0.0, 0.3, 0.2, 1.0),
                 (0.5, 0.5, 0.1, 0.9), (1.0, 0.0, 0.0, 1.0),
                 (1.0, 1.0, 0.3, 0.6), (0.6, 0.3, 0.1, 0.9))
# chains at and around the warp scan's 32-frame tiles and its groups of
# 8 tiles in flight, in a row count that fills no whole CTA of 4 warps
GILBERT_TILE_FRAMES = (1, 2, 31, 32, 33, 64, 65, 255, 256, 257, 335, 511,
                       512, 513, 690)
GILBERT_TILE_ROWS = 7
ARQ_ATTEMPTS = 3
# f32/INT32 operations a frame of the serial recurrence: two threshold
# selects, two compares, the state's xor and the keep's select
GILBERT_OPS = 6
# the one-thread-a-chain design the warp scan replaced, kept as a
# yardstick: its serial model (the dependent chain of a frame: the
# threshold select, the compare with u_t and the state flip, some 4 cycles
# each, at the 1.98 GHz boost clock; a latency model, not a published
# peak) and its trace device ms a round on phase 10 (b)'s chains, as this
# script measured it on an NVIDIA H100 80GB HBM3 at 700.00 W
GILBERT_STEP_CYCLES, SM_CLOCK_HZ = 12, 1.98e9
GILBERT_SERIAL_MS = 0.0223
# one-element fills a traced pass times for the launch floor
FLOOR_FILLS = 16


def link_frames(name: str):
    """The frame counts a node's payload takes in run ``name`` (its plan,
    from the payload of shape-only params)."""
    fed = link_config(name)
    from repro_torch.core.compression import make_compressor
    from repro_torch.core.transport import resolve_transport
    cfg = lenet_config()
    params = get_model(cfg).init(random.PRNGKey(0, "meta"), "meta")
    stacked = tree_map(lambda x: torch.empty((K,) + tuple(x.shape)), params)
    return resolve_transport(fed).layout(make_compressor(fed), stacked).frames


def gilbert_inputs(frames, params, gen, rows: int = K * ARQ_ATTEMPTS):
    """Start, transition and loss uniforms of ``rows`` chains a leaf, the
    first row's start and the last row's uniforms set to the thresholds."""
    consts = channel_params(*params)
    u0 = torch.rand((rows, len(frames)), generator=gen, device=DEVICE)
    u0[0] = consts[0]
    ut = [torch.rand((rows, f), generator=gen, device=DEVICE) for f in frames]
    ul = [torch.rand((rows, f), generator=gen, device=DEVICE) for f in frames]
    for a, b in zip(ut, ul):
        a[-1, ::2], a[-1, 1::2] = consts[1], consts[2]
        b[-1, ::2], b[-1, 1::2] = consts[3], consts[4]
    return u0, ut, ul, consts


def check_gilbert() -> float:
    """gilbert_keep against its plain version, bit for bit, one launch a
    table: the (b) run's ragged frame counts (K nodes x 3 ARQ attempts a
    leaf) under each channel of GILBERT_CASES, chains of one frame, and
    GILBERT_TILE_FRAMES in GILBERT_TILE_ROWS rows. Returns the largest
    absolute difference (0)."""
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    frames = link_frames("fused-gilbert-arq")
    chains = K * ARQ_ATTEMPTS
    tables = ((frames, chains), ([1] * len(frames), chains),
              (GILBERT_TILE_FRAMES, GILBERT_TILE_ROWS))
    err = 0.0
    for params in GILBERT_CASES:
        for fr, rows in tables:
            u0, ut, ul, consts = gilbert_inputs(fr, params, gen, rows)
            before = gilbert_keep.launches
            got = gilbert_keep(u0, ut, ul, consts)
            torch.cuda.synchronize()
            if gilbert_keep.launches != before + 1:
                raise AssertionError("gilbert_keep: not one launch a table")
            want = gilbert_keep_plain(u0, ut, ul, consts)
            for g, w in zip(got, want):
                if not bitwise_equal(g, w.contiguous()):
                    raise AssertionError(f"gilbert_keep differs from its "
                                         f"plain version ({params}, frames "
                                         f"{fr})")
                err = max(err, max_abs_err(g, w))
    log("kernels", f"gilbert_keep: bit-exact to its plain version on the "
                   f"(b) run's frames {frames} x {K * ARQ_ATTEMPTS} chains "
                   f"(nodes x ARQ attempts), on one-frame chains and on the "
                   f"tile boundaries {GILBERT_TILE_FRAMES} x "
                   f"{GILBERT_TILE_ROWS} chains, channels {GILBERT_CASES}, "
                   f"threshold uniforms included, one launch a table")
    return err


def launch_floor_ms() -> float:
    """The card's launch floor: the trace device time of one one-element
    fill kernel, traced as a kernel is (``traced_ms``, FLOOR_FILLS fills a
    pass so that the profiled warm-up is long enough)."""
    x = torch.zeros(1, device=DEVICE)

    def fills():
        for _ in range(FLOOR_FILLS):
            x.fill_(1.0)
    ms = traced_ms([fills])
    return None if ms is None else ms / FLOOR_FILLS


def time_gilbert():
    """One round's keep masks of the (b) run, one launch: device and
    event-timed ms beside the plain version's, the byte bound (two uniforms
    read and a keep written a frame, a start uniform a chain), the card's
    launch floor, and the one-thread-a-chain design the warp scan replaced:
    its measured time and its serial model, the longest row's dependent
    steps."""
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    frames = link_frames("fused-gilbert-arq")
    u0, ut, ul, consts = gilbert_inputs(frames, GILBERT_CASES[0], gen)
    rows = u0.shape[0]
    nbytes = 12 * rows * sum(frames) + 4 * u0.numel()
    ops = GILBERT_OPS * rows * sum(frames)
    b_ms, b_by = bound(nbytes, 0.0, ops)
    serial_ms = max(frames) * GILBERT_STEP_CYCLES / SM_CLOCK_HZ * 1e3
    kern = lambda: gilbert_keep(u0, ut, ul, consts)  # noqa: E731
    plain = lambda: gilbert_keep_plain(u0, ut, ul, consts)  # noqa: E731
    r = dict(ms=device_ms(kern), plain_ms=device_ms(plain, reps=3,
                                                     per_rep=1),
             device_ms=traced_ms([kern]), plain_device_ms=traced_ms([plain]),
             floor_ms=launch_floor_ms(), bound_ms=b_ms, bound_by=b_by,
             nbytes=nbytes, ops=ops, library_ms=None)
    log("kernels", f"gilbert_keep per round ({len(frames)} leaves, {rows} "
                   f"chains a leaf, {sum(frames)} frames a chain set, the "
                   f"longest {max(frames)}; a warp a chain, "
                   f"{-(-max(frames) // 32)} tiles of its scan): device "
                   f"{fmt_ms(r['device_ms'], 5)} (a thread a chain before: "
                   f"{GILBERT_SERIAL_MS} ms), event-timed {r['ms']:.4f} ms; "
                   f"plain: device {fmt_ms(r['plain_device_ms'])}, "
                   f"event-timed {r['plain_ms']:.4f} ms; bound {b_ms:.7f} ms "
                   f"({b_by}: {nbytes} B, {ops} ops); launch floor (a "
                   f"one-element fill, traced) {fmt_ms(r['floor_ms'], 5)}; "
                   f"the thread-a-chain design's serial model of the longest "
                   f"row "
                   f"{serial_ms:.5f} ms ({GILBERT_STEP_CYCLES} cycles a frame "
                   f"at {SM_CLOCK_HZ / 1e9:g} GHz); library: none")
    return r


# --------------------------------------------------------------------------
# phase 10: the radio under the gossip (lossy transport, barrier-free rounds)
# --------------------------------------------------------------------------

LINK_ROUNDS = 4
# the kernels each run launches, and the decode of the delta and, under
# frame loss, of the keep records: launches a round
LINK_LAUNCHED = {
    "cdbfl-bernoulli": ("topk_select", "unpack_set", "fused_update",
                        "threefry", "gossip_mix"),
    "fused-gilbert-arq": ("delta_pack", "grid_quant", "unpack",
                          "fused_update", "threefry", "gossip_mix",
                          "gilbert_keep"),
    "cdbfl-snr-participation": ("topk_select", "unpack_set", "fused_update",
                                "threefry", "gossip_mix"),
    "dsgld-snr-participation": ("dsgld_update", "threefry", "gossip_mix")}
LINK_DECODES = {"cdbfl-bernoulli": ("unpack_set", 2),
                "fused-gilbert-arq": ("unpack", 2),
                "cdbfl-snr-participation": ("unpack_set", 1)}
# threefry launches a round: the engine's split and one a level of the
# round's draws; the transport's salt, node and leaf-attempt keys ride the
# first three levels, its Bernoulli uniforms the draws' level; the burst
# channel adds a level (its split, then its uniforms)
LINK_DRAW_LAUNCHES = {"cdbfl-bernoulli": 5, "fused-gilbert-arq": 6,
                      "cdbfl-snr-participation": 5,
                      "dsgld-snr-participation": 5}


def link_config(name: str, link: bool = True) -> FedConfig:
    """The FedConfig of the recorded run ``name`` (``TRANSPORT_RUNS``);
    ``link=False``: the same run without transport and participation."""
    c = TRANSPORT_RUNS[name]
    if (c["reduced"] != REDUCED or c["train_maps"] != K * 50
            or c["minibatch"] != MINIBATCH):
        raise AssertionError(f"{name}: the record ran {c}")
    t, p = c.get("transport"), c.get("participation")
    return FedConfig(
        rounds=c["rounds"], **c["fed"],
        topology_cfg=TopologyConfig(**c["topology_cfg"]),
        transport=TransportConfig(**t) if t and link else None,
        participation=(ParticipationConfig(**dict(p, dead=tuple(
            tuple(d) for d in p["dead"]))) if p and link else None))


def link_columns(trainer) -> dict:
    """The run's per-round transport and participation columns, as the
    record holds them."""
    eng = trainer._engine
    return {col: [np.asarray(x, np.float64).tolist()
                  for x in getattr(eng, attr)]
            for col, attr in TRANSPORT_COLUMNS.items()}


def check_link_run(name: str, train):
    """The recorded run ``name`` on the host engine, LINK_ROUNDS rounds, its
    launch counts set to 0 just before and read just after: rounds 1-2
    against the reference's record (bytes, retransmits, participation and
    masks exact; loss and consensus within rtol 1e-3; airtime and energy
    within rtol 1e-6, exactness logged); every kernel of its path launched,
    gossip_mix once a mix, gilbert_keep once a round where the channel
    bursts, the decodes and threefry at their stated counts. Returns
    ``(trainer, result, columns, launches)``."""
    from repro_torch.train import FedTrainer
    cfg = lenet_config()
    want = json.loads(TRANSPORT_ROUNDS_FILE.read_text())[name]
    if want["config"] != TRANSPORT_RUNS[name]:
        raise AssertionError(f"{TRANSPORT_ROUNDS_FILE.name}: {name} ran "
                             f"{want['config']}")
    n = len(want["loss"])
    trainer = FedTrainer(get_model(cfg), link_config(name),
                         partition_iid(train, K), minibatch=MINIBATCH,
                         seed=0, engine="host", device=DEVICE)
    applied = record_masks(trainer)
    kernels.reset_launch_counts()
    res = trainer.run(rounds=LINK_ROUNDS)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    cols = link_columns(trainer)
    if res.wire_history[:n] != want["wire_bytes"]:
        raise AssertionError(f"{name}: wire bytes {res.wire_history}")
    for col in ("offered", "delivered", "abandoned", "retransmits",
                "participation"):
        if cols[col][:n] != want[col]:
            raise AssertionError(f"{name}: {col} {cols[col][:n]} differs "
                                 f"from the reference's {want[col]}")
    if [m.tolist() for m in applied[:n]] != want["masks"]:
        raise AssertionError(f"{name}: masks differ from the reference's")
    for metric, got in (("loss", res.loss_history[:n]),
                        ("consensus", res.consensus_history[:n])):
        if not np.allclose(got, want[metric], rtol=1e-3, atol=0):
            raise AssertionError(f"{name}: {metric} {got} differs from the "
                                 f"reference's {want[metric]}")
    exact = {}
    for col in ("airtime", "energy"):
        if not np.allclose(cols[col][:n], want[col], rtol=1e-6, atol=0):
            raise AssertionError(f"{name}: {col} {cols[col][:n]} vs the "
                                 f"reference's {want[col]}")
        exact[col] = cols[col][:n] == want[col]
    if not all(math.isfinite(x) for x in res.loss_history):
        raise AssertionError(f"{name}: non-finite loss")
    missing = [k for k in LINK_LAUNCHED[name] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{name}: never launched {missing}")
    counts = {"gossip_mix": LINK_ROUNDS,
              "gilbert_keep": LINK_ROUNDS if "gilbert_keep" in
              LINK_LAUNCHED[name] else 0,
              "threefry": LINK_DRAW_LAUNCHES[name] * LINK_ROUNDS}
    if name in LINK_DECODES:
        decode, per_round = LINK_DECODES[name]
        counts[decode] = per_round * LINK_ROUNDS
    wrong = {k: launches[k] for k, v in counts.items() if launches[k] != v}
    if wrong:
        raise AssertionError(f"{name}: launches {wrong}, expected "
                             f"{ {k: counts[k] for k in wrong} }")
    part = cols["participation"]
    if name.endswith("participation") and part[2:] == part[:2]:
        raise AssertionError(f"{name}: rounds 2-3 have rounds 0-1's "
                             f"participation")
    log("link", f"{name}: rounds 1-{n} against the reference's CPU run: "
                f"offered {cols['offered'][:n]}, delivered "
                f"{cols['delivered'][:n]}, abandoned {cols['abandoned'][:n]}"
                f", retransmits {cols['retransmits'][:n]} exact; "
                f"participation and (M, K) masks exact; loss "
                f"{res.loss_history[:n]} vs {want['loss']}, consensus "
                f"{res.consensus_history[:n]} vs {want['consensus']} (rtol "
                f"1e-3 held); airtime {cols['airtime'][:n]} "
                f"({'exact' if exact['airtime'] else 'within rtol 1e-6'}), "
                f"energy {'exact' if exact['energy'] else 'within rtol 1e-6'}"
                f"; rounds 3-4: delivered {cols['delivered'][n:]}, "
                f"participation {part[n:]}; launches in "
                f"{LINK_ROUNDS} rounds "
                f"{ {k: v for k, v in launches.items() if v} }")
    return trainer, res, cols, launches


def check_link_scan(name: str, train, host, host_res, host_cols):
    """The run again on the scan engine (chunks of 2: the second a replay
    with the round index 2, past (c)'s deaths and rejoin), bit for bit
    against its host run; then its replayed chunk timed beside the same
    run without transport and participation."""
    from repro_torch.train import FedTrainer
    cfg = lenet_config()
    timing = {}
    for link in (True, False):
        scan = FedTrainer(get_model(cfg), link_config(name, link),
                          partition_iid(train, K), minibatch=MINIBATCH,
                          seed=0, engine="scan", chunk=2, bank_thin=1,
                          device=DEVICE)
        res = scan.run(rounds=LINK_ROUNDS)
        if link:
            if (res.loss_history != host_res.loss_history
                    or res.consensus_history != host_res.consensus_history
                    or res.wire_history != host_res.wire_history
                    or link_columns(scan) != host_cols):
                raise AssertionError(f"{name}: the scan run's metrics "
                                     f"differ from the host run's")
            for part in ("params", "v", "v_bar"):
                same_tensors(f"{name} {part}",
                             tree_leaves(getattr(scan.state, part)),
                             tree_leaves(getattr(host.state, part)))
            same_tensors(f"{name} key", [scan.key], [host.key])
        wall, busy, _, _ = time_replay(scan._engine, LINK_ROUNDS, 2)
        timing[link] = (wall, busy)
        del scan
        torch.cuda.empty_cache()
    (wall, busy), (wall0, busy0) = timing[True], timing[False]
    log("link", f"{name}: scan engine (chunks of 2) equal to the host "
                f"engine bit for bit over {LINK_ROUNDS} rounds: params, v, "
                f"v̄, key, losses, consensus and every transport and "
                f"participation column; replayed chunk {wall:.3f} ms a "
                f"round, {busy:.3f} ms on the device (idle "
                f"{100 * (1 - busy / wall):.1f}%); without transport and "
                f"participation {wall0:.3f} ms, {busy0:.3f} ms on the "
                f"device: the link's share {busy - busy0:+.3f} ms a round "
                f"on the device")
    return wall, busy, wall0, busy0


def link_trace_ms(name: str, train, trainer):
    """The transport's and participation's device ms in one round: a traced
    host round of the run beside one of the same run without them."""
    from repro_torch.train import FedTrainer
    cfg = lenet_config()
    plain = FedTrainer(get_model(cfg), link_config(name, link=False),
                       partition_iid(train, K), minibatch=MINIBATCH, seed=0,
                       engine="host", device=DEVICE)
    out = []
    for t in (trainer, plain):
        _, by_name = trace_round(t, t.round_fn)
        out.append(None if by_name is None else
                   sum(us for us, _ in by_name.values()) / 1e3)
    del plain
    torch.cuda.empty_cache()
    return out


def run_link_cli() -> dict:
    """``repro_torch.launch.train`` in-process with the recorded transport
    and participation flags (two rounds), its launch counts set to 0 just
    before and read just after: its header, link and accounting lines equal
    to the reference CLI's. Returns the counts."""
    cli = json.loads(TRANSPORT_ROUNDS_FILE.read_text())["cli"]
    log("link", "python -m repro_torch.launch.train " + " ".join(
        cli["argv"]))
    buf = io.StringIO()
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        train_cli.main(cli["argv"])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    lines = buf.getvalue().splitlines()
    for ln in lines:
        log("link", "| " + ln)
    got = [ln for ln in lines if ln.startswith(TRANSPORT_CLI_LINES)]
    if got != cli["lines"]:
        raise AssertionError(f"CLI lines {got} differ from the reference "
                             f"CLI's {cli['lines']}")
    log("link", f"CLI: {time.perf_counter() - t0:.1f} s in-process; its "
                f"{len(got)} header, link and accounting lines equal the "
                f"reference CLI's; launches "
                f"{ {k: v for k, v in launches.items() if v} }")
    torch.cuda.empty_cache()
    return launches


def run_link(train) -> dict:
    """Phase 10. Returns the launch counts of the (b) run, the path of the
    burst channel's kernel."""
    log("link", f"on {card_line()}")
    launches = {}
    for name in TRANSPORT_RUNS:
        trainer, res, cols, counts = check_link_run(name, train)
        launches[name] = counts
        wall, busy, wall0, busy0 = check_link_scan(name, train, trainer, res,
                                                  cols)
        dev, dev0 = link_trace_ms(name, train, trainer)
        log("link", f"{name}: a traced host round {fmt_ms(dev)} on the "
                    f"device, {fmt_ms(dev0)} without transport and "
                    f"participation"
                    + (f": the link's {dev - dev0:+.4f} ms a round"
                       if dev is not None and dev0 is not None else ""))
        del trainer
        torch.cuda.empty_cache()
    run_link_cli()
    return launches["fused-gilbert-arq"]



# --------------------------------------------------------------------------
# phase 11: bfloat16 control variates, the scenario matrix, the evaluate
# CLI and the quickstart
# --------------------------------------------------------------------------

# the 2-byte control dtypes (FedConfig.control_dtype, ROADMAP A3): the tag
# of their kernel forms' names, their dtype and FedConfig name
CONTROL_DTYPES = {"bf16": (torch.bfloat16, "bfloat16"),
                  "f16": (torch.float16, "float16")}
FORMS = ("topk_select", "delta_pack", "fused_update", "cffl_update")
# f32 operations an element of the 2-byte updates: two roundings of the
# deltas, two adds, the subtraction, the fma (2) and two roundings of the
# sums (cdbfl adds the noise's fma, 2; f16 widens the two rounded sums)
UPDATE_FORM_OPS = {"bf16": {"fused_update": 11, "cffl_update": 9},
                   "f16": {"fused_update": 13, "cffl_update": 11}}
# phase 11 (b)'s runs: overrides of phase 7's configuration, the kernels
# each launches (by their f32 twins' names: the run must launch the
# 2-byte form, and not the f32 twin)
CONTROL_RUNS = {
    "cdbfl": (dict(), ("topk_select", "fused_update"), ("unpack_set",
                                                        "threefry")),
    "fused": (dict(fused_compress=True), ("delta_pack", "fused_update"),
              ("unpack", "threefry")),
    "cffl": (dict(algorithm="cffl"), ("topk_select", "cffl_update"),
             ("unpack_set", "threefry")),
}
CONTROL_ROUNDS = 4
CONTROL_GOLDEN = {tag: ROOT / "tests" / "golden" /
                  f"{tag}_rounds_lenet_radar.json" for tag in CONTROL_DTYPES}
EVAL_CLI_ARGV = ["--quick", "--scenarios", "clean,day23_critical",
                 "--severities", "1.0", "--device", DEVICE]


def control_cases(shapes, tag: str = "bf16"):
    """Phase 2's leaves with v (and v̄) rounded to the control dtype, and
    C6/C9's non-finite values in v itself: a NaN, ±inf, a block of NaN, a
    NaN in the ragged block. For f16, a leaf whose v holds subnormal halves
    and ±0 (C32: f16 keeps its subnormals)."""
    dt = CONTROL_DTYPES[tag][0]
    out = [(name, th, v.to(dt)) for name, th, v in leaf_cases(shapes)]
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    th = torch.randn((K, 4097), generator=gen, device=DEVICE)
    v = torch.randn((K, 4097), generator=gen, device=DEVICE) * 0.1
    v[0, 5] = v[1, 1024:2048] = float("nan")
    v[2, 4096] = float("nan")
    v[3, 100] = float("inf")
    v[4, 2048:2060] = -float("inf")
    out.append((f"non-finite {tag} v 4097", th, v.to(dt)))
    if dt == torch.float16:
        th = torch.randn((K, 3000), generator=gen, device=DEVICE) * 1e-6
        v = torch.randint(-1023, 1024, (K, 3000), generator=gen,
                          device=DEVICE).float() * 2.0 ** -24
        v[:, ::7] = 0.0
        v[:, 3::7] = -0.0
        out.append(("subnormal and signed-zero f16 v 3000", th,
                    v.to(dt)))
    return out


def check_control_kernels(shapes, tag: str = "bf16"):
    """Phase 11 (a): the four 2-byte forms of ``tag`` against their plain
    versions on the card, bit for bit (a NaN of an update's output equals
    any NaN, as phase 2's): every full-width and edge leaf (for f16 the
    update's deltas with subnormal halves and ±0 once rounded), then one
    table launch each of topk_select and delta-pack over all of them.
    Returns the largest absolute errors."""
    dt = CONTROL_DTYPES[tag][0]
    names = [f"{f}_{tag}" for f in FORMS]
    errs = dict.fromkeys(names, 0.0)
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    cases = [c for c in control_cases(shapes, tag) if c[1].shape[1] > 1]

    def same(kname, got, want, label, nan_any=False):
        ok = (same_or_both_nan(got, want) if nan_any
              else bitwise_equal(got, want))
        if not ok:
            raise AssertionError(f"{kname} differs from its plain version on "
                                 f"{label}")
        if got.dtype != torch.uint16 and bool(torch.isfinite(
                got.float()).all() and torch.isfinite(want.float()).all()):
            errs[kname] = max(errs[kname], max_abs_err(got, want))

    for name, th, v in cases:
        n, k = th.shape[1], leaf_k(th.shape[1])
        (vals, idx), = topk_select([th], [k], [v])
        want = topk_select_plain(th, k, v=v)
        same(f"topk_select_{tag}", vals, want[0], name)
        same(f"topk_select_{tag}", idx, want[1], name)
        (vals, idx), = delta_pack([th], [v], SURVIVORS)
        want = delta_pack_plain(th, v, SURVIVORS)
        same(f"delta_pack_{tag}", vals, want[0], name)
        same(f"delta_pack_{tag}", idx, want[1], name)
        vb = (v.float() * 0.5 + 0.01).to(dt)
        dvb = torch.randn(th.shape, generator=gen, device=DEVICE) * 1e-2
        dv = torch.randn(th.shape, generator=gen, device=DEVICE) * 1e-2
        if dt == torch.float16:
            # deltas that round to f16 subnormals and to ±0
            dvb[:, ::5] = torch.randint(-60, 61, dvb[:, ::5].shape,
                                        generator=gen, device=DEVICE
                                        ).float() * 2.0 ** -25
            dv[:, 1::5] = -0.0
        xi = torch.randn(th.shape, generator=gen, device=DEVICE) * 1e-3
        finite = bool(torch.isfinite(th).all() and torch.isfinite(
            v.float()).all())
        for kname, got, want in (
                (f"fused_update_{tag}",
                 fused_update_control(th, vb, v, dvb, dv, xi, 0.03, 1.0),
                 fused_update_control_plain(th, vb, v, dvb, dv, xi, 0.03, 1.0)),
                (f"cffl_update_{tag}",
                 cffl_update_control(th, vb, v, dvb, dv, 0.03),
                 cffl_update_control_plain(th, vb, v, dvb, dv, 0.03))):
            for part, g, w in zip(("θ'", "v̄'", "v'"), got, want):
                same(kname, g, w, f"{name} ({part})", nan_any=not finite)
        log(tag, f"{name}: K={K} n={n}: topk_select, delta-pack, "
                 f"fused_update and cffl_update with {tag} v (and v̄) "
                 f"bit-exact to their plain versions")
    ks = [leaf_k(c[1].shape[1]) for c in cases]
    xs, vs = [c[1] for c in cases], [c[2] for c in cases]
    sel_form = kernels.WRAPPERS[f"topk_select_{tag}"]
    pack_form = kernels.WRAPPERS[f"delta_pack_{tag}"]
    before = (sel_form.launches, pack_form.launches)
    got = topk_select(xs, ks, vs)
    packed = delta_pack(xs, vs, SURVIVORS)
    if (sel_form.launches - before[0],
            pack_form.launches - before[1]) != (1, 1):
        raise AssertionError(f"a mixed {tag} topk_select or delta-pack "
                             f"table took other than one launch")
    for (name, x, v), k, sel, pk in zip(cases, ks, got, packed):
        want = topk_select_plain(x, k, v=v)
        same(f"topk_select_{tag}", sel[0], want[0], f"the table's {name}")
        same(f"topk_select_{tag}", sel[1], want[1], f"the table's {name}")
        want = delta_pack_plain(x, v, SURVIVORS)
        same(f"delta_pack_{tag}", pk[0], want[0], f"the table's {name}")
        same(f"delta_pack_{tag}", pk[1], want[1], f"the table's {name}")
    log(tag, f"one table launch each of topk_select and delta-pack with "
             f"{tag} v over the {len(xs)} leaves above: bit-exact")
    return errs


def time_control_kernels(shapes, timing, tag: str = "bf16"):
    """Phase 11 (a)'s times: each 2-byte form of ``tag`` over the 10
    full-width leaves (K=10) as the round runs it (topk_select and
    delta-pack one table launch, the updates one launch a leaf), beside its
    plain version, its bound and its f32 twin's phase-2 device time; for
    topk_select the library call of its f32 twin (one stable torch.sort of
    the blocks' keys)."""
    dt = CONTROL_DTYPES[tag][0]
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    ths = [torch.randn((K, int(np.prod(s))), generator=gen, device=DEVICE)
           for _, s in shapes]
    vs = [(t * 0.1).to(dt) for t in ths]
    vbs = [(t * 0.05).to(dt) for t in ths]
    dvs = [t * 0.01 for t in ths]
    dvbs = [t * 0.02 for t in ths]
    xis = [t * 0.001 for t in ths]
    ns = [t.shape[1] for t in ths]
    ks = [leaf_k(n) for n in ns]
    total = sum(K * n for n in ns)
    sel = topk_select(ths, ks, vs)
    packed = delta_pack(ths, vs, SURVIVORS)
    sel_wire = sum(vals.numel() * 6 for vals, _ in sel)
    pack_wire = sum(vals.numel() * 6 for vals, _ in packed)
    padded = sum(vals.shape[1] * K * BLOCK for vals, _ in packed)
    sel_padded = sum(vals.shape[1] * K * BLOCK for vals, _ in sel)
    keys = torch.cat([magnitude_keys(to_blocks(t - v.float(), BLOCK))
                      for t, v in zip(ths, vs)])
    ops = UPDATE_FORM_OPS[tag]
    rows = {
        "topk_select": (
            lambda: topk_select(ths, ks, vs),
            lambda: [topk_select_plain(t, k, v=v)
                     for t, k, v in zip(ths, ks, vs)],
            lambda: torch.sort(keys, dim=1, descending=True, stable=True),
            total * 6 + sel_wire, TOPK_SELECT_OPS * sel_padded),
        "delta_pack": (
            lambda: delta_pack(ths, vs, SURVIVORS),
            lambda: [delta_pack_plain(t, v, SURVIVORS)
                     for t, v in zip(ths, vs)],
            None, total * 6 + pack_wire, DELTA_PACK_OPS * padded),
        "fused_update": (
            lambda: [fused_update_control(*a, 0.03, 1.0) for a in
                     zip(ths, vbs, vs, dvbs, dvs, xis)],
            lambda: [fused_update_control_plain(*a, 0.03, 1.0) for a in
                     zip(ths, vbs, vs, dvbs, dvs, xis)],
            None, total * 28, ops["fused_update"] * total),
        "cffl_update": (
            lambda: [cffl_update_control(*a, 0.03) for a in
                     zip(ths, vbs, vs, dvbs, dvs)],
            lambda: [cffl_update_control_plain(*a, 0.03) for a in
                     zip(ths, vbs, vs, dvbs, dvs)],
            None, total * 24, ops["cffl_update"] * total),
    }
    out = {}
    for twin, (kern, plain, lib, nbytes, nops) in rows.items():
        name = f"{twin}_{tag}"
        b_ms, b_by = bound(nbytes, nops)
        # the profiler can lose a whole trace's launches late in the
        # process (PERF.md §7): up to three tries for a reading
        readings = None
        for _ in range(3):
            readings = traced_readings([kern])
            if readings:
                break
        r = dict(ms=device_ms(kern), plain_ms=device_ms(plain, reps=3,
                                                         per_rep=2),
                 device_ms=readings and statistics.median(readings),
                 plain_device_ms=traced_ms([plain]), bound_ms=b_ms,
                 bound_by=b_by, nbytes=nbytes, ops=nops,
                 library_ms=None if lib is None else traced_ms([lib]))
        out[name] = r
        f32 = timing.get(twin, {})
        log(tag, f"{name} per round (10 leaves, K={K}): device "
                 f"{fmt_ms(r['device_ms'])} (median of the traces' "
                 f"{readings and [round(x, 4) for x in readings]}), "
                 f"event-timed {r['ms']:.4f} ms; its f32 twin {twin} "
                 f"{fmt_ms(f32.get('device_ms'))} (phase 2); plain: device "
                 f"{fmt_ms(r['plain_device_ms'])}, event-timed "
                 f"{r['plain_ms']:.4f} ms; library "
                 f"{fmt_ms(r['library_ms']) if lib else 'none'}; bound "
                 f"{b_ms:.4f} ms ({b_by}: {nbytes:.0f} B, {nops:.0f} ops)")
    return out


# phase 11 (b)'s limits against the reference's bf16 run, relative, set
# from the readings (PERF.md, PR 26) between the card's and those of the
# same run with float32 control variates (the golden's f32_control). The
# card reads loss and consensus within 5.9e-7, ‖v‖ and ‖v̄‖ within 3.7e-8
# (cdbfl, fused) and 5.8e-7 (cffl's ‖v‖); the f32 control moves cffl's
# consensus by 4.4e-6 and the norms by 7.0e-6 (cdbfl), 2.2e-6 (fused)
# and 1.45e-5 (cffl) at least. Rounds 1-2's loss of cdbfl and fused moves
# by at most 5.1e-7 either way: there only the norms tell bf16 from f32.
BF16_METRIC_RTOL = 2e-6
BF16_NORM_RTOL = {"cdbfl": 5e-7, "fused": 5e-7, "cffl": 3e-6}
# the same for float16 control variates against the reference's f16 run
# (tests/golden/f16_rounds_lenet_radar.json). f16 keeps 11 bits where bf16
# keeps 8, so the f32 control lies closer: its norms move by 4.7e-7 and
# 1.18e-6 (cdbfl), 4.0e-7 and 2.81e-6 (fused), 9.6e-7 and 2.77e-6 (cffl)
# of the record's, its losses and consensus by at most 1.6e-6. And f16
# rounds away less of the card's last bits: the first card run read the
# cdbfl norms within 3.0e-8, the fused run's ‖v̄‖ 9.16e-7 off. The
# norm limits sit between those readings and the control's.
F16_METRIC_RTOL = 2e-6
F16_NORM_RTOL = {"cdbfl": 3e-7, "fused": 2e-6, "cffl": 2e-6}
CONTROL_RTOL = {"bf16": (BF16_METRIC_RTOL, BF16_NORM_RTOL),
                "f16": (F16_METRIC_RTOL, F16_NORM_RTOL)}


def check_bf16_golden(name: str, fed: FedConfig, res, norms,
                      tag: str = "bf16") -> None:
    """Rounds 1-2 against the reference's CPU run of the same bf16
    configuration: bytes exact; loss, consensus and the control state's
    ‖v‖₂, ‖v̄‖₂ after round 2 (``norms``) within the limits above. The
    limits sit between the card's readings (its convolutions sum in
    another order than XLA's CPU code, which moves the local steps' last
    bits) and the same run's with float32 control variates, which the
    check also asserts lie beyond them."""
    golden = CONTROL_GOLDEN[tag]
    metric_rtol, norm_rtol = CONTROL_RTOL[tag]
    want = json.loads(golden.read_text())[name]
    mine = {k: getattr(fed, k) for k in want["config"]["fed"]}
    if want["config"]["fed"] != mine or want["config"]["reduced"] != REDUCED:
        raise AssertionError(f"{golden.name} ran {want['config']}, "
                             f"this run is {mine}")
    n = len(want["loss"])
    if res.wire_history[:n] != want["wire_bytes"]:
        raise AssertionError(f"{tag} {name}: bytes {res.wire_history[:n]} "
                             f"!= {want['wire_bytes']}")
    f32 = want["f32_control"]
    readings, control = {}, {}
    for metric, got in (("loss", res.loss_history),
                        ("consensus", res.consensus_history)):
        readings[metric] = max(abs(g - w) / abs(w)
                               for g, w in zip(got[:n], want[metric]))
        control[metric] = max(abs(g - w) / abs(w)
                              for g, w in zip(f32[metric], want[metric]))
    for metric in ("v_norm", "v_bar_norm"):
        readings[metric] = abs(norms[metric] - want[metric]) / want[metric]
        control[metric] = abs(f32[metric] - want[metric]) / want[metric]
    limit = {m: norm_rtol[name] if m.endswith("norm")
             else metric_rtol for m in readings}
    log(tag, f"{name}, seed 0, rounds 1-{n} against the reference's CPU "
                f"run: loss {res.loss_history[:n]} vs {want['loss']}, "
                f"consensus {res.consensus_history[:n]} vs "
                f"{want['consensus']}, ‖v‖ {norms['v_norm']!r} vs "
                f"{want['v_norm']!r}, ‖v̄‖ {norms['v_bar_norm']!r} vs "
                f"{want['v_bar_norm']!r}, bytes exact; relative readings "
                f"{ {m: float(f'{r:.3g}') for m, r in readings.items()} } "
                f"(limits {limit}); the f32 control's "
                f"{ {m: float(f'{r:.3g}') for m, r in control.items()} }")
    over = {m: r for m, r in readings.items() if r > limit[m]}
    if over:
        raise AssertionError(f"{tag} {name}: {over} over the limits {limit} "
                             f"against the reference's {tag} run")
    if not any(control[m] > limit[m] for m in control):
        raise AssertionError(f"{tag} {name}: the f32 control's readings "
                             f"{control} lie within the limits {limit}")


def run_control(name: str, train, test, evals, tag: str = "bf16"):
    """Phase 11 (b): one configuration with the 2-byte control dtype of
    ``tag`` at full width, 4 rounds on the host engine and on the scan engine (chunks
    of 2), the two bit for bit; rounds 1-2 against the reference's; the
    control state's bytes; a replayed chunk timed beside phase 7's f32
    run of the same algorithm (``evals``). Returns the host run's trainer
    and launches."""
    from repro_torch.train import FedTrainer
    dt, dname = CONTROL_DTYPES[tag]
    overrides, twins, others = CONTROL_RUNS[name]
    launched = tuple(f"{t}_{tag}" for t in twins) + others
    algorithm = overrides.get("algorithm", "cdbfl")
    fed = default_config(algorithm, CONTROL_ROUNDS, control_dtype=dname,
                         **{k: v for k, v in overrides.items()
                            if k != "algorithm"})
    runs = {}
    for engine in ("host", "scan"):
        trainer = FedTrainer(get_model(lenet_config()), fed,
                             partition_iid(train, K), minibatch=MINIBATCH,
                             seed=0, engine=engine, chunk=2, bank_thin=1,
                             device=DEVICE)
        kernels.reset_launch_counts()
        res = trainer.run(rounds=CONTROL_ROUNDS, eval_batch=test)
        launches = kernels.launch_counts()
        runs[engine] = (trainer, res, launches)
        values = res.loss_history + res.consensus_history + [res.accuracy,
                                                              res.ece]
        if not all(math.isfinite(x) for x in values):
            raise AssertionError(f"{tag} {name}: non-finite metric {values}")
        missing = [k for k in launched if launches[k] <= 0]
        twin = {k: launches[k] for k in twins if launches[k]}
        if missing or twin:
            raise AssertionError(f"{tag} {name} ({engine}): never launched "
                                 f"{missing}; launched the f32 forms {twin}")
        for part in ("v", "v_bar"):
            if any(x.dtype != dt
                   for x in tree_leaves(getattr(trainer.state, part))):
                raise AssertionError(f"{tag} {name}: {part} is not {tag}")
        log(tag, f"{name} ({engine} engine): ms/round "
                    f"{[round(x, 2) for x in res.round_ms]}; losses "
                    f"{res.loss_history}; consensus {res.consensus_history}; "
                    f"day-1 accuracy {res.accuracy:.4f} ECE {res.ece:.4f}; "
                    f"launches { {k: v for k, v in launches.items() if v} }")
    host, res, launches = runs["host"]
    scan, sres, _ = runs["scan"]
    short = FedTrainer(get_model(lenet_config()), fed, partition_iid(train, K),
                       minibatch=MINIBATCH, seed=0, engine="host",
                       bank_thin=1, device=DEVICE)
    short_res = short.run(rounds=2)
    if (short_res.loss_history != res.loss_history[:2]
            or short_res.consensus_history != res.consensus_history[:2]):
        raise AssertionError(f"{tag} {name}: a 2-round run differs from the "
                             f"4-round run's first two rounds")
    check_bf16_golden(name, fed, short_res, control_norms(short.state), tag)
    del short
    if (sres.loss_history != res.loss_history
            or sres.consensus_history != res.consensus_history
            or sres.wire_history != res.wire_history):
        raise AssertionError(f"{tag} {name}: the scan run's metrics differ "
                             f"from the host run's")
    for part in ("params", "v", "v_bar"):
        same_tensors(f"{tag} {name} {part}",
                     tree_leaves(getattr(scan.state, part)),
                     tree_leaves(getattr(host.state, part)))
    same_tensors(f"{tag} {name} key", [scan.key], [host.key])
    control = sum(x.numel() * x.element_size() for part in ("v", "v_bar")
                  for x in tree_leaves(getattr(host.state, part)))
    f32 = sum(x.numel() * 4 for part in ("v", "v_bar")
              for x in tree_leaves(getattr(host.state, part)))
    wall, busy, _, _ = time_replay(scan._engine, CONTROL_ROUNDS, 2)
    f32_wall, f32_busy = evals[algorithm]["replay_ms"]
    log(tag, f"{name}: scan engine equal to the host engine bit for bit "
                f"(params, v, v̄, key, losses, consensus, bytes); control "
                f"state v + v̄ {control:,} B against {f32:,} B in f32; a "
                f"replayed chunk of 2: {wall:.3f} ms a round, {busy:.3f} ms "
                f"on the device; phase 7's f32 {algorithm} run "
                f"{f32_wall:.3f} ms, {f32_busy:.3f} ms on the device")
    del runs, scan
    torch.cuda.empty_cache()
    return host, launches


def run_claims() -> None:
    """Phase 11 (c): the reference's claims gate on the card at each seed
    the reference recorded (``CLAIMS_SPEC``'s 0, and 1): the shifted cell
    re-scored bit for bit and every ECE finite (asserted); each cell, the
    claims, failures and warnings beside the reference's CPU run, and the
    first round where each algorithm's loss leaves the reference's."""
    import repro_torch.eval.matrix as matrix
    from repro_torch.train import FedTrainer
    for seed in CLAIMS_SEEDS:
        out = claims_record(matrix, FedTrainer, seed, device=DEVICE)
        bad = [f for f in out["failures"]
               if "not reproducible" in f or "not finite" in f]
        if bad:
            raise AssertionError(f"claims, seed {seed}: {bad}")
        want = claims_golden(seed)
        for g, w in zip(out["cells"], want["cells"]):
            log("claims", f"seed {seed} [{g['algorithm']}] {g['scenario']}@"
                          f"{g['severity']:g}: acc {g['accuracy']:.4f} ECE "
                          f"{g['ece']:.4f} (reference {w['accuracy']:.4f}, "
                          f"{w['ece']:.4f})")
        for key, value in out["claims"].items():
            ref = want["claims"][key]
            log("claims", f"seed {seed} {key}: {value if isinstance(value, str) else round(float(value), 4)}"
                          f" (reference {ref if isinstance(ref, str) else round(ref, 4)})")
        for alg, hist in out["loss_history"].items():
            log("claims", f"seed {seed} {alg} loss leaves the reference's: "
                          f"{claims_departure(hist, want['loss_history'][alg])}")
        log("claims", f"seed {seed}: failures {out['failures']} (reference "
                      f"{want['failures']}); warnings {len(out['warnings'])} "
                      f"(reference {len(want['warnings'])}); the shifted ECE "
                      f"re-scored bit for bit; {out['seconds']:.1f} s")


def run_eval_cli(trainer) -> None:
    """Phase 11 (d): the evaluate CLI in-process on the card, then on a
    full-width checkpoint of ``trainer`` (the bf16 cdbfl run), which it
    must score at full width."""
    from repro_torch.eval.matrix import _looks_reduced
    from repro_torch.launch import evaluate as eval_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cells = eval_cli.main(EVAL_CLI_ARGV)
    if len(cells) != 4 or not all(math.isfinite(c.report.ece)
                                  for c in cells):
        raise AssertionError(f"evaluate CLI: {len(cells)} cells")
    for line in buf.getvalue().splitlines():
        if line.startswith("|"):
            log("eval", line)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, CONTROL_ROUNDS, trainer.state.params)
        if _looks_reduced(trainer.state.params, "lenet-radar"):
            raise AssertionError("_looks_reduced took the full-width "
                                 "checkpoint for the reduced config")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cells = eval_cli.main(["--ckpt", d, "--scenarios",
                                   "clean,day23_critical", "--severities",
                                   "1.0", "--device", DEVICE])
    if len(cells) != 2 or not all(c.report.count == 200 and
                                  math.isfinite(c.report.ece)
                                  for c in cells):
        raise AssertionError(f"evaluate CLI --ckpt: {cells}")
    for line in buf.getvalue().splitlines():
        if line.startswith("|"):
            log("eval", f"--ckpt (full width {lenet_config().input_hw}): "
                        f"{line}")


def run_quickstart() -> dict:
    """Phase 11 (e): examples/quickstart.py's program on the port, on the
    card (tests/torch_quickstart.py): relative error below 0.1 and the
    reference's wire bytes. Returns its launch counts."""
    import torch_quickstart
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = torch_quickstart.run(DEVICE, log=lambda m: log("quickstart", m))
    secs = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if not out["err"] < 0.1 or out["wire"] != 336:
        raise AssertionError(f"quickstart: rel-err {out['err']}, bytes "
                             f"{out['wire']} (want < 0.1 and 336)")
    log("quickstart", f"400 rounds in {secs:.1f} s: rel-err {out['err']:.4f}"
                      f", bytes/round {out['wire']} (the reference's 336); "
                      f"launches { {k: v for k, v in launches.items() if v} }")
    return launches


def run_phase11(shapes, timing, train, test, evals):
    """Phase 11 (``evals``: phase 7's, for its f32 replay times), (a) and
    (b) for bf16 and then f16 control variates. Returns the 2-byte forms'
    errors, timings and launches."""
    log("bf16", f"on {card_line()}")
    errs, form_timing, counts = {}, {}, {}
    trainers = {}
    for tag in CONTROL_DTYPES:
        errs.update(check_control_kernels(shapes, tag))
        form_timing.update(time_control_kernels(shapes, timing, tag))
        launches = {}
        for name in CONTROL_RUNS:
            trainer, launches[name] = run_control(name, train, test, evals,
                                                  tag)
            if tag == "bf16":
                trainers[name] = trainer
            del trainer
        counts.update({
            f"topk_select_{tag}": launches["cdbfl"][f"topk_select_{tag}"],
            f"fused_update_{tag}": launches["cdbfl"][f"fused_update_{tag}"],
            f"delta_pack_{tag}": launches["fused"][f"delta_pack_{tag}"],
            f"cffl_update_{tag}": launches["cffl"][f"cffl_update_{tag}"]})
    run_claims()
    run_eval_cli(trainers["cdbfl"])
    del trainers
    torch.cuda.empty_cache()
    run_quickstart()
    return errs, form_timing, counts


# --------------------------------------------------------------------------
# phase 12: drift, continual posteriors and unlearning (ROADMAP A9)
# --------------------------------------------------------------------------

# the kernels the drift run's path launches (phase 7's cdbfl path)
DRIFT_LAUNCHED = ("topk_select", "unpack_set", "fused_update", "threefry")
# rounds the drift run's scan engine takes a chunk: its segments (1, 1, 2)
# give chunks of 1, 1 and 2, so the chunk of 1 is captured and replayed
DRIFT_CHUNK = 2
UNLEARN_NODE = 9
UNLEARN_MORE_ROUNDS = 2
# the eval lines' numbers of the CLI against the reference CLI's: accuracy
# within one of its 128 examples, the rest within 1e-3 (the card sums the
# convolutions in other orders, phase 7)
CLI_EVAL_EXAMPLES = 128
CLI_EVAL_ATOL = 1e-3


def drift_continual():
    from repro_torch.config import ContinualConfig
    c = DRIFT_CONFIG["continual"]
    return ContinualConfig(**dict(c, breakpoints=tuple(
        tuple(b) for b in c["breakpoints"])))


def drift_config(continual: bool = True) -> FedConfig:
    """Phase 7's cdbfl configuration with the recorded run's burn-in and,
    with ``continual``, its drift and bank aging."""
    return default_config("cdbfl", DRIFT_CONFIG["rounds"],
                          burn_in=DRIFT_CONFIG["fed"]["burn_in"],
                          continual=drift_continual() if continual else None)


def drift_trainer(train, engine: str, continual: bool = True,
                  bank_dtype: str = "float32"):
    from repro_torch.train import FedTrainer
    return FedTrainer(get_model(lenet_config()), drift_config(continual),
                      partition_iid(train, K), minibatch=MINIBATCH, seed=0,
                      engine=engine, chunk=DRIFT_CHUNK,
                      bank_thin=DRIFT_CONFIG["bank_thin"],
                      bank_dtype=bank_dtype, device=DEVICE)


def pool_copy(shards) -> dict:
    return {f: v.clone() for f, v in shards.data.items()}


def same_pool(label: str, data: dict, want: dict) -> None:
    """Two pools equal byte for byte, compared on the card."""
    if set(data) != set(want) or not all(
            data[f].dtype == want[f].dtype and torch.equal(data[f], want[f])
            for f in want):
        raise AssertionError(f"{label}: the pool differs from the base pool")


def same_runs(label: str, got, want) -> None:
    """Two trainers' params, v, v̄, key and banks (samples and admission
    rounds) bit for bit."""
    for part in ("params", "v", "v_bar"):
        same_tensors(f"{label} {part}", tree_leaves(getattr(got.state, part)),
                     tree_leaves(getattr(want.state, part)))
    same_tensors(f"{label} key", [got.key], [want.key])
    gs, ws = got.bank.samples, want.bank.samples
    if len(gs) != len(ws):
        raise AssertionError(f"{label}: banks of {len(gs)} and {len(ws)}")
    for a, b in zip(gs, ws):
        same_tensors(f"{label} bank", tree_leaves(a), tree_leaves(b))
    rounds = [list(map(int, t.bank_cfg.rounds_list(t._bank_state)))
              if not hasattr(t._bank_state, "samples")
              else list(t._bank_state.rounds) for t in (got, want)]
    if rounds[0] != rounds[1]:
        raise AssertionError(f"{label}: bank rounds {rounds}")


def check_drift_host(train):
    """Phase 12 (a): the host engine, 4 rounds, its launch counts set to 0
    just before and read just after; rounds 1-3 against the reference's
    (``tests/golden/drift_rounds_lenet_radar.json``): bytes exact, loss and
    consensus within rtol 1e-3, each round's severity exact; the caller's
    pool untouched and the engine back on it (C26)."""
    want = json.loads(DRIFT_ROUNDS_FILE.read_text())
    fed = drift_config()
    mine = dict(DRIFT_CONFIG, reduced=REDUCED, train_maps=K * 50,
                minibatch=MINIBATCH,
                fed={k: getattr(fed, k) for k in want["config"]["fed"]})
    if want["config"] != json.loads(json.dumps(mine)):
        raise AssertionError(f"{DRIFT_ROUNDS_FILE.name} ran "
                             f"{want['config']}, this run is {mine}")
    trainer = drift_trainer(train, "host")
    base = pool_copy(trainer.device_shards)
    kernels.reset_launch_counts()
    res = trainer.run(rounds=fed.rounds)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    missing = [k for k in DRIFT_LAUNCHED if launches[k] <= 0]
    if missing:
        raise AssertionError(f"drift: the host run never launched {missing}")
    sched = trainer._refresher.schedule
    sev = [float(sched.severity_at(t)) for t in range(fed.rounds)]
    if sev != want["severity"]:
        raise AssertionError(f"drift: severities {sev}, the reference's "
                             f"{want['severity']}")
    n = 3
    if res.wire_history != want["wire_bytes"]:
        raise AssertionError(f"drift: bytes {res.wire_history}, the "
                             f"reference's {want['wire_bytes']}")
    for metric, got in (("loss", res.loss_history),
                        ("consensus", res.consensus_history)):
        if not np.allclose(got[:n], want[metric][:n], rtol=1e-3, atol=0):
            raise AssertionError(f"drift: {metric} {got} differs from the "
                                 f"reference's {want[metric]}")
    same_pool("drift host: the caller's pool", trainer.device_shards.data,
              base)
    if trainer._engine.shards is not trainer.device_shards:
        raise AssertionError("drift host: the engine is not back on the "
                             "base pool after the schedule's return")
    rel = lambda a, b: [abs(x - y) / abs(y) for x, y in zip(a, b)]  # noqa
    log("drift", f"(a) host engine, 4 rounds: severities {sev} (the "
                 f"reference's, exact); losses {res.loss_history} vs "
                 f"{want['loss']} (rel. {rel(res.loss_history, want['loss'])})"
                 f"; consensus {res.consensus_history} vs {want['consensus']} "
                 f"(rel. {rel(res.consensus_history, want['consensus'])}); "
                 f"rounds 1-{n} within rtol 1e-3; bytes "
                 f"{res.wire_history[0]:,.0f} a node a round (exact); bank "
                 f"rounds {trainer._bank_state.rounds}; launches "
                 f"{ {k: v for k, v in launches.items() if v} }")
    return trainer, res, base, launches


def check_drift_scan(train, host, hres, base, test, shift):
    """Phase 12 (b): the scan engine on the same run, chunks split at the
    segments: bit for bit the host run; the aged scan eval against the
    host eval on both test sets; the weighted predictor against the eval;
    a chunk length's graph captured once."""
    want = json.loads(DRIFT_ROUNDS_FILE.read_text())
    scan = drift_trainer(train, "scan")
    kernels.reset_launch_counts()
    res = scan.run(rounds=DRIFT_CONFIG["rounds"])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    engine = scan._engine
    if sorted(engine._graphs) != [1, 2]:
        raise AssertionError(f"drift scan: graphs of chunk lengths "
                             f"{sorted(engine._graphs)}, want [1, 2]")
    if (res.loss_history != hres.loss_history
            or res.consensus_history != hres.consensus_history
            or res.wire_history != hres.wire_history):
        raise AssertionError("drift scan: metrics differ from the host "
                             "run's")
    same_runs("drift scan", scan, host)
    same_pool("drift scan: the caller's pool", scan.device_shards.data, base)
    same_pool("drift scan: the engine's pool at round 2 on",
              engine.shards.data, base)
    stacked, weights = scan._posterior()
    hstacked, hweights = host._posterior()
    if weights is None or not np.array_equal(weights, hweights) or \
            weights.tolist() != want["weights"]:
        raise AssertionError(f"drift: age weights {weights}, host "
                             f"{hweights}, reference {want['weights']}")
    model = scan.model
    reports = {}
    for name, data in (("day-1", test), ("days-2/3 shift", shift)):
        srep, sprobs = ScanEvalEngine(model.logits).evaluate(
            stacked, data, node_axis=1, return_probs=True, weights=weights)
        hrep, hprobs = HostEvalEngine(model.logits).evaluate(
            hstacked, data, node_axis=1, return_probs=True, weights=hweights)
        same_probs(f"drift aged eval {name}", sprobs, hprobs)
        same_report(f"drift aged eval {name}", srep, hrep)
        trep, tprobs = scan.eval_report(data, return_probs=True)
        same_probs(f"drift eval_report {name}", tprobs, sprobs)
        same_report(f"drift eval_report {name}", trep, srep)
        reports[name] = srep
    head = {f: v[:EVAL_BATCH] for f, v in test.items()}
    pred = scan.predictor()
    probs, _ = pred.predict({"x": head["x"]})
    _, eprobs = scan.eval_report(head, return_probs=True)
    same_probs("drift weighted predictor", probs.cpu().numpy(), eprobs)
    if not pred._weighted:
        raise AssertionError("drift: the predictor took no weights")
    r1, r2 = reports["day-1"], reports["days-2/3 shift"]
    log("drift", f"(b) scan engine, chunks {list(engine.capture_ms)} "
                 f"captured (capture ms "
                 f"{ {k: round(v, 1) for k, v in engine.capture_ms.items()} }"
                 f"), the chunk of 1 replayed: params, v, v̄, key, bank "
                 f"slots and rounds, losses, consensus and bytes equal to "
                 f"the host run bit for bit; the caller's pool untouched "
                 f"and the engine's own pool equal to it byte for byte from "
                 f"round 2 on (C26); age weights {weights.tolist()} (the "
                 f"reference's); aged scan eval equal to the host eval bit "
                 f"for bit, every report field: day-1 accuracy "
                 f"{r1.accuracy:.4f} ECE {r1.ece:.4f} (reference "
                 f"{want['eval_day1']['accuracy']:.4f}, "
                 f"{want['eval_day1']['ece']:.4f}), shift accuracy "
                 f"{r2.accuracy:.4f} ECE {r2.ece:.4f} (reference "
                 f"{want['eval_shift']['accuracy']:.4f}, "
                 f"{want['eval_shift']['ece']:.4f}); the weighted predictor "
                 f"equal to eval_report on {EVAL_BATCH} maps; launches "
                 f"{ {k: v for k, v in launches.items() if v} }")
    return scan, reports


def check_unlearn(train, host, scan, test):
    """Phase 12 (c): ``unlearn(9)`` on the host run, the scan run (f32
    bank) and a scan run with an int8 bank: node 9's rows of v and v̄ and
    of the bank zero (int8 scales 1.0), the reports equal across the f32
    engines and changed by the unlearn; then 2 more rounds on each, bit for
    bit across the f32 engines, no chunk length captured again. Returns the
    ms of each unlearn."""
    int8 = drift_trainer(train, "scan", bank_dtype="int8")
    int8.run(rounds=DRIFT_CONFIG["rounds"])
    ms, before, after = {}, {}, {}
    trainers = {"host": host, "scan": scan, "scan int8": int8}
    for name, tr in trainers.items():
        before[name] = tr.eval_report(test)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.unlearn(UNLEARN_NODE)
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        for part in ("v", "v_bar"):
            if any(bool(x[UNLEARN_NODE].any())
                   for x in tree_leaves(getattr(tr.state, part))):
                raise AssertionError(f"unlearn {name}: {part} row kept")
        bs = tr._bank_state
        if hasattr(bs, "samples"):
            rows = [x[UNLEARN_NODE] for s in bs.samples
                    for x in tree_leaves(s)]
        else:
            rows = [x[:, UNLEARN_NODE] for x in tree_leaves(bs.slots)]
            if bs.scales is not None and not all(
                    bool((x[:, UNLEARN_NODE] == 1.0).all())
                    for x in tree_leaves(bs.scales)):
                raise AssertionError(f"unlearn {name}: scales not 1.0")
        if any(bool(r.any()) for r in rows):
            raise AssertionError(f"unlearn {name}: bank rows kept")
        after[name] = tr.eval_report(test, return_probs=True)
        if after[name][0].ece == before[name].ece or not math.isfinite(
                after[name][0].ece):
            raise AssertionError(f"unlearn {name}: the report did not move")
    same_probs("unlearn: scan eval_report", after["scan"][1],
               after["host"][1])
    same_report("unlearn: scan eval_report", after["scan"][0],
                after["host"][0])
    captures = {n: sorted(trainers[n]._engine.capture_ms)
                for n in ("scan", "scan int8")}
    for tr in trainers.values():
        tr.run(rounds=UNLEARN_MORE_ROUNDS)
    same_runs("unlearn, 2 more rounds: scan", scan, host)
    for name in ("scan", "scan int8"):
        got = sorted(trainers[name]._engine.capture_ms)
        if got != captures[name]:
            raise AssertionError(f"unlearn {name}: captured {got} after "
                                 f"{captures[name]}")
    for part in ("params", "v", "v_bar"):
        same_tensors(f"unlearn int8 {part}",
                     tree_leaves(getattr(int8.state, part)),
                     tree_leaves(getattr(host.state, part)))
    log("drift", f"(c) unlearn({UNLEARN_NODE}) on the host engine, the scan "
                 f"engine (f32 bank) and the scan engine with an int8 bank: "
                 f"node {UNLEARN_NODE}'s rows of v, v̄ and the bank zero "
                 f"(int8 scales 1.0); day-1 ECE "
                 + ", ".join(f"{n} {before[n].ece:.4f} -> "
                             f"{after[n][0].ece:.4f}" for n in trainers)
                 + "; the f32 engines' reports equal bit for bit; "
                 f"{UNLEARN_MORE_ROUNDS} more rounds: scan equal to host "
                 f"bit for bit (params, v, v̄, key, bank), the int8 run's "
                 f"params, v, v̄ too, no chunk length captured again "
                 f"({captures}); unlearn ms "
                 f"{ {n: round(v, 3) for n, v in ms.items()} }")
    del int8
    torch.cuda.empty_cache()
    return ms


def time_drift(train, scan, unlearn_ms) -> dict:
    """Phase 12 (d): a replayed chunk of 2 on the drifted pool beside the
    same run without ``continual``; one phase refresh's host ms (synthesis,
    upload, ``set_shards``); the device ms of the ``set_shards`` copy
    against its byte bound."""
    from repro_torch.train.drift import make_refresher
    from repro_torch.data.scenarios import make_drift_shards
    from repro_torch.data.partition import DeviceShards
    engine = scan._engine
    fresh = make_refresher(scan.continual, scan.device_shards)
    sched = fresh.schedule
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps = make_drift_shards(sched, 1, fresh.sizes, fresh.hw)
    t1 = time.perf_counter()
    pool = DeviceShards.from_shards(maps, scan.device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    fresh._cache[float(sched.severity_at(1))] = pool
    fresh.refresh(engine, 1)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    same_pool("drift refresh", engine.shards.data, pool.data)
    nbytes = sum(2 * v.numel() * v.element_size()
                 for v in list(pool.data.values()) + [pool.size_tensor])
    copy_ms = device_ms(lambda: engine.set_shards(pool), reps=5, per_rep=10)
    bound_ms, _ = bound(nbytes, 0)
    plain = drift_trainer(train, "scan", continual=False)
    plain.run(rounds=2)
    # in turns: drifted, plain, drifted, plain
    t, pt, turns = scan._round, 2, []
    for _ in range(2):
        wall, busy, _, t = time_replay(engine, t, 2)
        pwall, pbusy, _, pt = time_replay(plain._engine, pt, 2)
        turns.append((wall, busy, pwall, pbusy))
    out = dict(synth_ms=1e3 * (t1 - t0), upload_ms=1e3 * (t2 - t1),
               install_ms=1e3 * (t3 - t2), copy_ms=copy_ms,
               copy_bound_ms=bound_ms, nbytes=nbytes, turns=turns)
    log("drift", f"(d) on {card_line()}: a replayed chunk of 2, ms a round "
                 f"(device ms), in turns: "
                 + "; ".join(f"drifted pool {w:.3f} ({b:.3f}), the same run "
                             f"without continual {pw:.3f} ({pb:.3f})"
                             for w, b, pw, pb in turns)
                 + "; one phase refresh on the host: synthesis "
                 f"of {K} x {fresh.sizes[0]} maps at {fresh.hw} "
                 f"{out['synth_ms']:.1f} ms, upload {out['upload_ms']:.1f} "
                 f"ms, set_shards {out['install_ms']:.3f} ms; the "
                 f"set_shards copy {copy_ms:.4f} device ms (CUDA events, "
                 f"median of 5 x 10) against its byte bound "
                 f"{bound_ms:.4f} ms ({nbytes:,} B read and written at "
                 f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
                 f"{100 * bound_ms / copy_ms:.0f}%); unlearn "
                 f"{ {n: round(v, 3) for n, v in unlearn_ms.items()} } ms")
    del plain
    torch.cuda.empty_cache()
    return out


def cli_eval_fields(line: str):
    """An eval line's fixed part (through ``S=``, and whether it ends in
    `` aged``) and its four numbers."""
    head, rest = line.split(" acc=")
    aged = rest.endswith(" aged")
    nums = [float(p.split("=")[1]) for p in ("acc=" + rest).split()[:4]]
    return (head, aged), nums


def run_drift_cli() -> dict:
    """Phase 12 (e): the README's two drift commands at full width
    (``DRIFT_CLI_RUNS``), each in-process, its launch counts set to 0 just
    before and read just after: the header, drift and bank lines equal to
    the reference CLI's, each eval line's round, scenario, severity,
    sample count and aged suffix equal, its numbers within one example
    (accuracy) and 1e-3 of the reference's."""
    cli = json.loads(DRIFT_ROUNDS_FILE.read_text())["cli"]
    counts = {}
    for name, rec in cli.items():
        log("drift", "python -m repro_torch.launch.train "
                     + " ".join(rec["argv"]))
        buf = io.StringIO()
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            train_cli.main(rec["argv"])
        torch.cuda.synchronize()
        counts[name] = kernels.launch_counts()
        lines = buf.getvalue().splitlines()
        for ln in lines:
            log("drift", "| " + ln)
        got = [ln for ln in lines if ln.startswith(DRIFT_CLI_LINES)]
        fixed = lambda ls: [ln for ln in ls  # noqa: E731
                            if not ln.startswith("eval  round")]
        if fixed(got) != fixed(rec["lines"]):
            raise AssertionError(f"CLI {name}: {fixed(got)} differ from the "
                                 f"reference CLI's {fixed(rec['lines'])}")
        evals = [ln for ln in got if ln.startswith("eval  round")]
        wevals = [ln for ln in rec["lines"] if ln.startswith("eval  round")]
        if len(evals) != len(wevals) or not evals:
            raise AssertionError(f"CLI {name}: eval lines {evals}")
        for g, w in zip(evals, wevals):
            (gh, gn), (wh, wn) = cli_eval_fields(g), cli_eval_fields(w)
            if gh != wh or abs(gn[0] - wn[0]) > 1 / CLI_EVAL_EXAMPLES + 1e-4 \
                    or any(abs(a - b) > CLI_EVAL_ATOL
                           for a, b in zip(gn[1:], wn[1:])):
                raise AssertionError(f"CLI {name}: {g!r} against the "
                                     f"reference's {w!r}")
            log("drift", f"reference: {w}")
        if not any(ln.endswith(" aged") for ln in evals):
            raise AssertionError(f"CLI {name}: no aged eval")
        missing = [k for k in DRIFT_LAUNCHED if counts[name][k] <= 0]
        if missing:
            raise AssertionError(f"CLI {name}: never launched {missing}")
        log("drift", f"(e) CLI {name}: {time.perf_counter() - t0:.1f} s "
                     f"in-process; header, drift and bank lines equal the "
                     f"reference CLI's; eval lines' fields equal, numbers "
                     f"within bounds; launches "
                     f"{ {k: v for k, v in counts[name].items() if v} }")
        torch.cuda.empty_cache()
    return counts


def claim_kind(failure: str) -> str:
    """A drift-claims failure without its numbers: which claim broke and
    how."""
    return "never returned" if "never returned" in failure else "too slow"


def run_drift_claims_on_card() -> None:
    """Phase 12 (f): ``run_drift_claims(DRIFT_CLAIMS_SPEC)`` and
    ``run_unlearn_oracle(CLAIMS_SPEC)`` on the card, beside the reference's
    record: every probe finite, cdbfl's calibration leaving its band after
    onset (the drift bites), no claim broken that the reference's own CPU
    run keeps (its record breaks the recovery claim: ROADMAP C27), and the
    unlearn oracle within tolerance."""
    import repro_torch.eval.matrix as matrix
    want = json.loads(DRIFT_CLAIMS_FILE.read_text())
    got = drift_claims_record(matrix, device=DEVICE)
    for alg, curve in got["curves"].items():
        ref = want["curves"][alg]
        for p, q in zip(curve["probes"], ref["probes"]):
            log("claims", f"drift {alg} round {p['round']:.0f} sev "
                          f"{p['severity']:g}: acc {p['accuracy']:.4f} ECE "
                          f"{p['ece']:.4f} (reference {q['accuracy']:.4f}, "
                          f"{q['ece']:.4f})")
        log("claims", f"drift {alg}: pre-drift ECE {curve['pre_ece']:.4f}, "
                      f"excursion {curve['excursion_round']}, recovery "
                      f"{curve['recovery_round']}, rounds to recovery "
                      f"{curve['rounds_to_recovery']} (reference "
                      f"{ref['pre_ece']:.4f}, {ref['excursion_round']}, "
                      f"{ref['recovery_round']}, {ref['rounds_to_recovery']})")
    u, w = got["unlearn"], want["unlearn"]
    log("claims", f"unlearn(node {u['target']}): acc "
                  f"{u['unlearn']['accuracy']:.4f} ECE "
                  f"{u['unlearn']['ece']:.4f}, retrain oracle acc "
                  f"{u['oracle']['accuracy']:.4f} ECE {u['oracle']['ece']:.4f}"
                  f"; |Δacc| {u['delta_accuracy']:.4f} |ΔECE| "
                  f"{u['delta_ece']:.4f} (reference {w['delta_accuracy']:.4f}"
                  f", {w['delta_ece']:.4f}; tolerances "
                  f"{matrix.UNLEARN_ACC_TOL}, {matrix.UNLEARN_ECE_TOL})")
    log("claims", f"drift claims: failures {got['failures']} (reference "
                  f"{want['failures']}), {got['drift_seconds']:.1f} s; "
                  f"unlearn oracle {got['unlearn_seconds']:.1f} s")
    probes = [p for c in got["curves"].values() for p in c["probes"]]
    if not all(math.isfinite(p["ece"]) and math.isfinite(p["accuracy"])
               for p in probes):
        raise AssertionError("drift claims: a probe is not finite")
    if got["curves"]["cdbfl"]["excursion_round"] is None:
        raise AssertionError("drift claims: cdbfl's calibration never left "
                             "its band: the drift did not bite")
    kept = ({claim_kind(f) for f in got["failures"]}
            - {claim_kind(f) for f in want["failures"]})
    if kept:
        raise AssertionError(f"drift claims: {got['failures']}, claims the "
                             f"reference keeps")
    if not u["within_tolerance"]:
        raise AssertionError(f"unlearn oracle out of tolerance: {u}")


def run_phase12(train, test, shift) -> dict:
    """Phase 12. Returns the drift host run's launch counts."""
    log("drift", f"on {card_line()}")
    host, hres, base, launches = check_drift_host(train)
    scan, _ = check_drift_scan(train, host, hres, base, test, shift)
    unlearn_ms = check_unlearn(train, host, scan, test)
    time_drift(train, scan, unlearn_ms)
    del host, scan
    torch.cuda.empty_cache()
    run_drift_cli()
    run_drift_claims_on_card()
    return launches


# --------------------------------------------------------------------------
# phase 2, the decode step's kernels (ROADMAP A12): decode_attention and
# bma_sample at smollm-135m's full-width shapes, and threefry's GUMBEL form
# --------------------------------------------------------------------------

DECODE_ARCH = "smollm-135m"
DECODE_M, DECODE_MAX_LEN, DECODE_NEW, DECODE_REQUESTS = 4, 128, 16, 16
DECODE_SLOTS = (8, 64)                     # lanes M x slots: 32 and 256
DECODE_WINDOW = 8                          # the ring-buffer case
# the head groups of 128 that phase 2 also holds to the plain version:
# 8 heads over each KV head (yi-9b), 12 (mistral-large-123b) and 6
# (grok-1-314b, which phase 16 (c) decodes)
DECODE_WIDE_ARCHS = ("yi-9b", "mistral-large-123b", "grok-1-314b")
# phases 17 and 19's decode shapes that phase 2 also holds: the bank's
# samples of recurrentgemma-9b's engine, whisper-tiny's cache length
RG_M, AUDIO_MAX_LEN = 2, 32
# the split form at narrower heads, each a little past the slots one CTA
# holds in a bf16 cache: (heads, KV heads, head dim, slots, whose heads)
SPLIT_NARROW = ((32, 4, 128, 4100, "yi-9b's"),
                (96, 8, 128, 2400, "mistral-large-123b's"),
                (8, 1, 64, 5700, ""), (12, 1, 64, 3600, ""),
                (9, 3, 64, 12000, "smollm's"), (16, 1, 32, 3100, ""))
# f32 operations: an element of each of the decode attention's two dot
# products (a multiply and an add); an element of the sampler: a sample's
# scale, subtraction, XLA's exp (EXP_OPS), division and add, then the
# mean's product, the max, XLA's log (22), the entropy's product and add,
# the Gumbel noise (its uniform and two logs: 49) and the score's add and
# compare
ATTN_OPS = 4
# XLA's exp (threefry.cuh: exp_xla): the input's clamp (2), the exponent's
# fma, floor and clamp (5), two reduction fmas (4), five Horner fmas (10),
# r² and its fma (3), the add (1), the scale's product (1) and the flush's
# compares and selects (4)
EXP_OPS = 30


def sample_ops(m: int) -> int:
    return (4 + EXP_OPS) * m + 78


# INT32 operations an element of the sampler's noise: the hash, its xor and
# the uniform's shift and or
SAMPLE_INT_OPS = THREEFRY_INT_OPS + 3
# the token tolerance against the reference's record: a token must equal
# the reference's wherever the reference's top two perturbed scores are
# further apart than this. f32: 1e-4, a logit difference an f32
# computation stays within. bf16: the reference's own bf16 and f32 runs
# differ by up to 0.0155 in log p at the first step's top-8, and any two
# bf16 computations by rounding noise of that size, so 5e-2.
DECODE_TOL = {"float32": dict(margin=1e-4, ent=1e-5),
              "bfloat16": dict(margin=5e-2, ent=1e-3)}
# the first step's log p at the record's top-8, against the record's. At
# position 0 a lane's attention output is its own value row, exactly, so
# no key enters; but the values are cached in bf16 in f32 serving too
# (ROADMAP C29), and a value row whose f32 product sums in another order
# than XLA's can round to the other bf16 neighbour, a 2^-8 step that 30
# layers carry to the logits. Readings, this script on an NVIDIA H100
# 80GB HBM3 at 700 W: f32 1.16e-3 at 8 slots and 1.52e-3 at 64 (cuBLAS
# picks another product kernel, so another order, at each), bf16 2.33e-2
# at both; the port on the CPU reads beside them (the witness of (b)).
# So 5e-3 in f32 and 5e-2 in bf16.
DECODE_DLOGP = {"float32": 5e-3, "bfloat16": 5e-2}
# the step's kernels named in a trace of a replay: the five longest
DECODE_TOP_KERNELS = 5


def decode_model_cfg(dtype=None):
    cfg = get_arch(DECODE_ARCH).config
    return cfg if dtype is None else cfg.replace(dtype=dtype)


def slot_positions(pos: torch.Tensor, slots: int, window: int):
    """``slot_pos`` as a lane at each position ``pos`` leaves it: the slots
    of the positions before it (in a ring buffer the last ``window``; past
    the full cache's end its last slot holds the previous position)."""
    t = torch.arange(slots, device=pos.device)[None]
    p = pos[:, None]
    if window:
        q = p - 1 - torch.remainder(p - 1 - t, slots)
        return torch.where(q >= 0, q, -1).to(torch.int32)
    sp = torch.where(t < p, t, -1)
    sp[:, -1] = torch.where(p[:, 0] >= slots, p[:, 0] - 1, sp[:, -1])
    return sp.to(torch.int32)


def attention_case(cfg, b: int, dtype, pos, window: int = 0, seed: int = 0,
                   reset: int = 0, slots: int = DECODE_MAX_LEN,
                   m: int = DECODE_M, cache_dtype=torch.bfloat16):
    """Full-width inputs of one layer's launch: m x b lanes at positions
    ``pos``, the first ``reset`` lanes reset (slot_pos -1, as an admit
    leaves them); ``window`` slots in a ring buffer, else ``slots``; the
    caches in ``cache_dtype``."""
    g, h, kv, hd = m, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    slots = window or slots
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=DEVICE)  # noqa
    pos = torch.as_tensor(pos, dtype=torch.int64, device=DEVICE)
    sp = slot_positions(pos, slots, window).expand(g, b, slots).contiguous()
    sp[:, :reset] = -1
    return (rnd(g, b, h, hd).to(dtype), rnd(g, b, kv, hd).to(dtype),
            rnd(g, b, kv, hd).to(dtype),
            rnd(g, b, slots, kv, hd).to(cache_dtype),
            rnd(g, b, slots, kv, hd).to(cache_dtype), sp, pos, window)


def dtype_ulp_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference in units of the compute dtype's last place at
    the value's magnitude."""
    eps = torch.finfo(want.dtype).eps
    d = (got.float() - want.float()).abs()
    return float((d / (eps * want.float().abs().clamp(min=1e-30))).max())


def check_decode_attention() -> float:
    """decode_attention against its plain version, bit for bit (caches,
    slot_pos, output), at the main path's shapes (32 and 256 lanes, bf16
    and f32, positions spread over and past the 128 slots, reset lanes
    decoding from position 0), a window-8 ring buffer wrapping around,
    caches of 256 slots (the serve CLI's ``--max-len 256``: the kernel
    takes the rows in two tiles), and groups of 8 and 12 heads of 128
    (yi-9b's and mistral-large-123b's heads) and of 6 (grok-1's) over 32
    lanes, and grok-1's as phase 16 (c) launches them (M=1, 4 lanes, 32
    slots); recurrentgemma-9b's ring of 2,048 slots under 16 heads of 256
    (the split form) with bf16 and f32 caches, positions at its tiles'
    edges, aligned and wrapped past 2,048; the split form at narrower heads
    (SPLIT_NARROW: 8 and 12 heads of 128 and of 64, smollm's 3 of 64, 16 of
    32) past the slots one CTA holds; and whisper-tiny's 6 heads of 64.
    Returns the largest absolute error (0)."""
    cfg = decode_model_cfg()
    err = 0.0
    cases = []
    for b in DECODE_SLOTS:
        pos = [(37 * i) % 200 for i in range(b)]
        pos[0] = 0
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"{DECODE_M}x{b} lanes {dtype}", attention_case(
                cfg, b, dtype, pos, seed=b, reset=2)))
    cases.append(("window 8, positions 0-30", attention_case(
        cfg, 8, torch.bfloat16, [0, 3, 7, 8, 9, 15, 16, 30],
        window=DECODE_WINDOW, seed=3, reset=1)))
    for dtype in (torch.bfloat16, torch.float32):
        cases.append((f"256 slots, {DECODE_M}x8 lanes {dtype}", attention_case(
            cfg, 8, dtype, [0, 5, 127, 128, 200, 255, 256, 400], seed=4,
            reset=1, slots=2 * DECODE_MAX_LEN)))
    for arch in DECODE_WIDE_ARCHS:
        wide = get_arch(arch).config
        r = wide.num_heads // wide.num_kv_heads
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"{arch}: {wide.num_heads} heads of "
                          f"{wide.resolved_head_dim} over "
                          f"{wide.num_kv_heads} (r = {r}), 4x8 lanes "
                          f"{dtype}", attention_case(
                              wide, 8, dtype, [(37 * i) % 200
                                               for i in range(8)],
                              seed=r, reset=1)))
    grok = get_arch("grok-1-314b").config
    for dtype in (torch.bfloat16, torch.float32):
        cases.append((f"grok-1-314b as phase 16 (c): 1x{GROK_SLOTS} lanes, "
                      f"{FAMILY_MAX_LEN} slots {dtype}", attention_case(
                          grok, GROK_SLOTS, dtype, [0, 1, 5, 31], seed=6,
                          slots=FAMILY_MAX_LEN, m=1)))
    # recurrentgemma-9b's local attention (the split form: a cluster of 8
    # CTAs of 256 slots a lane): 16 heads of 256 over one KV head in a ring
    # of 2,048, bf16 and f32 caches, positions at the tiles' edges before
    # the ring fills, at its size, one past it (the new row at slot 1), on
    # a tile edge inside the wrapped ring, mid-tile in it (slot 952) and
    # far past it
    rg = get_arch("recurrentgemma-9b").config
    rg_pos = [0, 255, 256, 257, 2048, 2049, 2304, 3000, 4095, 6143]
    for cache in (torch.bfloat16, torch.float32):
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"recurrentgemma-9b: 16 heads of 256, ring of "
                          f"{rg.local_attn_window}, {RG_M}x{len(rg_pos)} "
                          f"lanes {dtype}, {cache} cache", attention_case(
                              rg, len(rg_pos), dtype, rg_pos,
                              window=rg.local_attn_window, seed=11, reset=1,
                              m=RG_M, cache_dtype=cache)))
    # the split form at narrower heads (SPLIT_NARROW: other thread maps of
    # its K stages and P.V), full caches past what one CTA holds, positions
    # at the tiles' edges, at the cache's end and past it
    for h, kv, hd, slots, whose in SPLIT_NARROW:
        shape = types.SimpleNamespace(num_heads=h, num_kv_heads=kv,
                                      resolved_head_dim=hd)
        ts = -(-slots // 8)
        for cache in (torch.bfloat16, torch.float32):
            for dtype in (torch.bfloat16, torch.float32):
                cases.append((
                    f"split form, {whose or 'synthetic'} {h} heads of {hd} "
                    f"over {kv}, {slots} slots, {RG_M}x6 lanes {dtype}, "
                    f"{cache} cache", attention_case(
                        shape, 6, dtype,
                        [0, ts - 1, ts, ts + 1, slots - 1, slots + 7],
                        seed=hd + h, reset=1, slots=slots, m=RG_M,
                        cache_dtype=cache)))
    # whisper-tiny's decoder self-attention: 6 heads of 64, a full cache
    wh = get_arch("whisper-tiny").config
    for dtype in (torch.bfloat16, torch.float32):
        cases.append((f"whisper-tiny: 6 heads of 64, {AUDIO_MAX_LEN} slots, "
                      f"2x8 lanes {dtype}", attention_case(
                          wh, 8, dtype, [0, 1, 7, 8, 20, 31, 32, 40],
                          seed=12, reset=1, slots=AUDIO_MAX_LEN, m=2)))
    for label, (q, kn, vn, kc, vc, sp, pos, window) in cases:
        mine = [kc.clone(), vc.clone(), sp.clone()]
        theirs = [kc.clone(), vc.clone(), sp.clone()]
        got = decode_attention(q, kn, vn, *mine, pos, window)
        want = decode_attention_plain(q, kn, vn, *theirs, pos, window)
        torch.cuda.synchronize()
        if not all(bitwise_equal(a, b_) if a.dtype != torch.int32 else
                   torch.equal(a, b_) for a, b_ in zip(mine, theirs)):
            raise AssertionError(f"decode_attention ({label}): the cache "
                                 f"writes differ from the plain version's")
        err = max(err, max_abs_err(got.float(), want.float()))
        if not bitwise_equal(got, want):
            raise AssertionError(f"decode_attention ({label}): output "
                                 f"{dtype_ulp_err(got, want):.2f} ulps "
                                 f"from its plain version")
        log("kernels", f"decode_attention, {label}: caches, slot_pos and "
                       f"output bit for bit its plain version")
    return err


def sample_case(s: int, dtype, vocab: int = 49152, seed: int = 0,
                edges: bool = False, m: int = DECODE_M):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    lg = torch.randn((m, s, vocab), generator=gen, device=DEVICE)
    if edges:
        lg[:, 0] = 0.5                                 # every logit tied
        lg[:, 1, 100:] = float("-inf")                 # 100 finite
        if m > 1:
            lg[1, 2] = float("-inf")                   # a sample's -inf row
    keys = random.split(random.PRNGKey(seed, DEVICE), s)
    pos = torch.arange(s, dtype=torch.int64, device=DEVICE) * 9
    return lg.to(dtype), keys, pos


def check_bma_sample() -> float:
    """bma_sample against its plain version, bit for bit (tokens,
    probabilities, entropies): 8 and 64 slots of M=4 at V=49,152 (bf16 and
    f32), and ties, -inf, V = 1031 (not a whole number of 16-byte packs)
    and V = 152,064 (qwen2.5-14b's, 3.09 packs a thread); and phase 16's
    vocabularies at its banks: V = 131,072 at M=1 over GROK_SLOTS slots
    (grok-1), V = 102,400 at M=2 and M=1 over FAMILY_SLOTS (deepseek-v2's
    bf16 and f32 engines); and V = 256,000 at M=2 (recurrentgemma-9b's,
    phase 17). Returns the largest absolute error (0)."""
    err = 0.0
    cases = [(f"{s} slots {dt}", sample_case(s, dt, seed=s))
             for s in DECODE_SLOTS for dt in (torch.bfloat16, torch.float32)]
    cases.append(("ties, -inf, V=1031", sample_case(8, torch.bfloat16, 1031,
                                                     seed=5, edges=True)))
    cases.append(("ties, -inf, V=49152 f32", sample_case(
        8, torch.float32, seed=6, edges=True)))
    for dt in (torch.bfloat16, torch.float32):
        cases.append((f"8 slots, V=152064 {dt}", sample_case(
            8, dt, 152064, seed=7, edges=True)))
    for dt in (torch.bfloat16, torch.float32):
        cases.append((f"M=1, {GROK_SLOTS} slots, V=131072 {dt}", sample_case(
            GROK_SLOTS, dt, 131072, seed=8, edges=True, m=1)))
        # recurrentgemma-9b's vocabulary, the largest yet (phase 17)
        cases.append((f"M={RG_M}, 8 slots, V=256000 {dt}", sample_case(
            8, dt, 256000, seed=13, edges=True, m=RG_M)))
        for m in (2, 1):
            cases.append((f"M={m}, {FAMILY_SLOTS} slots, V=102400 {dt}",
                          sample_case(FAMILY_SLOTS, dt, 102400, seed=9 + m,
                                      edges=True, m=m)))
    for label, (lg, keys, pos) in cases:
        got = bma_sample(lg, keys, pos)
        want = bma_sample_plain(lg, keys, pos)
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"bma_sample ({label}): tokens {got[0]} "
                                 f"against {want[0]}")
        for name, a, b_ in (("probabilities", got[1], want[1]),
                            ("entropies", got[2], want[2])):
            fin = torch.isfinite(b_)
            err = max(err, max_abs_err(a[fin], b_[fin]))
            if not same_or_both_nan(a, b_):
                raise AssertionError(f"bma_sample ({label}): {name} differ "
                                     f"from the plain version's")
        log("kernels", f"bma_sample, {label}: tokens, probabilities and "
                       f"entropies bit for bit its plain version")
    return err


def check_exp_xla() -> None:
    """The decode kernels' exp (exp_xla, launched alone) against exp_plain
    bit for bit, on the CPU test's inputs (torch_golden.exp_inputs: 10^6
    over [-104, 89] and the edges), the plain version run on the host."""
    x = torch.from_numpy(exp_inputs())
    got, want = exp_xla(x.to(DEVICE)).cpu(), exp_plain(x)
    if not same_or_both_nan(got, want):
        raise AssertionError("exp_xla differs from exp_plain")
    log("kernels", f"exp_xla: {x.numel()} inputs bit for bit exp_plain "
                   f"(which the CPU tests hold to jax.jit(jnp.exp))")


def sdpa_yardstick(q, kc, vc, sp, pos):
    """One ``scaled_dot_product_attention`` call over the same lanes (GQA,
    the validity mask as a boolean mask): the library yardstick."""
    g, b, h, hd = q.shape
    slots, kv = kc.shape[2], kc.shape[3]
    lanes = g * b
    qq = q.reshape(lanes, h, 1, hd)
    kk = kc.reshape(lanes, slots, kv, hd).transpose(1, 2).to(q.dtype)
    vv = vc.reshape(lanes, slots, kv, hd).transpose(1, 2).to(q.dtype)
    mask = ((sp >= 0) & (sp.long() <= pos[None, :, None])).reshape(
        lanes, 1, 1, slots)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, enable_gqa=True)


def max_sm_mhz() -> float:
    """The card's highest SM clock (nvidia-smi), to read clock64 cycles."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def log_split_clocks(c, lanes: int) -> None:
    """The split form's clocks (decode_attention_clocks): its first
    CTA's phases and waits by clock64, then every CTA's time from its start
    to its last barrier by globaltimer, apart for the CTAs alone on their
    SM and those that share one."""
    mhz = max_sm_mhz()
    phases = [(name, c[k + 1] - c[k]) for k, name in enumerate(
        ("loads (first K stage landed)", "scores", "maxima exchanged",
         "the CTA's sums", "sums exchanged", "probabilities", "P.V",
         "rank sums"))]
    waits = list(zip(("stages in the scores", "stages in P.V",
                      "the cluster after the maxima",
                      "the cluster after the sums"), c[9:SPLIT_CLOCKS]))
    log("kernels", f"decode_attention's split form, one CTA's phases at "
                   f"{lanes} lanes (clock64 of thread 0 of the first CTA, "
                   f"cycles and us at the max SM clock {mhz:.0f} MHz; "
                   f"{card_line()}): " + "; ".join(
                       f"{n} {v} ({v / mhz:.3f} us)" for n, v in phases)
                   + f"; total {c[8] - c[0]} ({(c[8] - c[0]) / mhz:.3f} us);"
                     " waiting for " + ", ".join(
                         f"{n} {v} ({v / mhz:.3f} us)" for n, v in waits))
    ctas = np.array(c[SPLIT_CLOCKS:], dtype=np.int64).reshape(-1, 3)
    took = (ctas[:, 1] - ctas[:, 0]) / 1e3
    per_sm = np.bincount(ctas[:, 2])[ctas[:, 2]]
    shared = per_sm > 1

    def spread(x):
        return (f"{x.min():.3f} / {np.median(x):.3f} / {x.max():.3f} us"
                if len(x) else "none")
    log("kernels", f"decode_attention's split form at {lanes} lanes, each "
                   f"CTA from its start to its last barrier (globaltimer; min"
                   f" / median / max): {spread(took)}; {int((~shared).sum())}"
                   f" CTAs alone on their SM {spread(took[~shared])}, "
                   f"{int(shared.sum())} sharing one {spread(took[shared])};"
                   f" starts within {(ctas[:, 0].max() - ctas[:, 0].min()) / 1e3:.3f}"
                   f" us, the launch's CTAs from first start to last end "
                   f"{(ctas[:, 1].max() - ctas[:, 0].min()) / 1e3:.3f} us "
                   f"({card_line()})")


def time_rg_attention() -> dict:
    """decode_attention at one local-attention layer of recurrentgemma-9b's
    bf16 engine (phase 17 (d): M=2 x 8 slots, 16 heads of 256, a ring of
    2,048 slots full, bf16 caches; the split form): traced device ms beside
    its bound (the K and V rows it reads, at HBM rate), its plain version's
    event-timed ms, SDPA over the same lanes and mask, and how many of its
    clusters the card runs at once (cudaOccupancyMaxActiveClusters), held
    bit for bit to its plain version; the same at 128 lanes (M=2 x 64
    slots: many waves); and one CTA's phases by clock64."""
    rg = get_arch("recurrentgemma-9b").config
    w = rg.local_attn_window
    out = {}
    for b in (8, 64):
        q, kn, vn, kc, vc, sp, posv, _ = attention_case(
            rg, b, torch.bfloat16, [w + 37 * i for i in range(b)],
            window=w, seed=14, m=RG_M)
        lanes = RG_M * b
        slots, kv, hd, h = kc.shape[2], kc.shape[3], kc.shape[4], q.shape[2]
        nbytes = (2 * lanes * slots * kv * hd * 2 + 2 * lanes * h * hd * 2
                  + 2 * lanes * kv * hd * 2 + lanes * slots * 4 + b * 8)
        ops = ATTN_OPS * lanes * h * slots * hd
        b_ms, b_by = bound(nbytes, ops)
        kern = lambda: decode_attention(  # noqa: E731
            q, kn, vn, kc, vc, sp, posv, w)
        nc, ts = split_of(h // kv, hd, slots, kc.dtype)
        active = split_clusters(lanes, h, kv, hd, slots, q.dtype, kc.dtype)
        r = dict(ms=device_ms(kern), device_ms=traced_ms([kern]),
                 library_ms=traced_ms([sdpa_yardstick(q, kc, vc, sp, posv)]),
                 bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, ops=ops,
                 clusters=active)
        plain = ""
        if b == 8:
            mine = [kc.clone(), vc.clone(), sp.clone()]
            got = decode_attention(q, kn, vn, *mine, posv, w)
            theirs = [kc.clone(), vc.clone(), sp.clone()]
            want = decode_attention_plain(q, kn, vn, *theirs, posv, w)
            if not bitwise_equal(got, want) or not all(
                    torch.equal(x, y) for x, y in zip(mine, theirs)):
                raise AssertionError(
                    f"decode_attention's split form, {nc} CTAs of {ts} "
                    f"slots: differs from its plain version")
            # the plain version's thousands of small launches make its
            # trace slow to read: it is timed by CUDA events, host gaps
            # included
            r["plain_ms"] = device_ms(lambda: decode_attention_plain(
                q, kn, vn, kc, vc, sp, posv, w), reps=1, per_rep=1)
            plain = (f"bit for bit its plain version; plain: event-timed "
                     f"{r['plain_ms']:.4f} ms; ")
            for _ in range(3):
                _, clk = decode_attention_clocks(q, kn, vn, kc, vc, sp, posv,
                                                 w)
            log_split_clocks(clk.tolist(), lanes)
        log("kernels", f"decode_attention, one local-attention layer of "
                       f"recurrentgemma-9b's bf16 step ({lanes} lanes x "
                       f"{slots} slots, 16 heads of 256, split form: "
                       f"clusters of {nc} CTAs of {ts} slots, {lanes * nc} "
                       f"CTAs, {active} clusters at once; {card_line()}): "
                       f"device {fmt_ms(r['device_ms'], 5)}, event-timed "
                       f"{r['ms']:.5f} ms; {plain}SDPA (library): "
                       f"{fmt_ms(r['library_ms'], 5)}; bound {b_ms:.6f} ms "
                       f"({b_by}: {nbytes} B, {ops} ops)")
        out[lanes] = r
    return out[RG_M * 8]


def time_decode_kernels() -> dict:
    """decode_attention (one layer of the 8-slot step: 32 lanes, bf16) and
    bma_sample (the 8-slot step's sampler) beside their bounds, plain
    versions and, for the attention, SDPA; both also at 64 slots, logged;
    and threefry's GUMBEL form drawing the sampler's noise."""
    cfg = decode_model_cfg()
    out = {}
    for b in DECODE_SLOTS:
        pos = [(37 * i) % DECODE_MAX_LEN for i in range(b)]
        q, kn, vn, kc, vc, sp, posv, _ = attention_case(cfg, b, torch.bfloat16,
                                                        pos, seed=b)
        lanes = DECODE_M * b
        slots, kv, hd, h = kc.shape[2], kc.shape[3], kc.shape[4], q.shape[2]
        nbytes = (2 * lanes * slots * kv * hd * 2 + 2 * lanes * h * hd * 2
                  + 2 * lanes * kv * hd * 2 + lanes * slots * 4 + b * 8)
        ops = ATTN_OPS * lanes * h * slots * hd
        b_ms, b_by = bound(nbytes, ops)
        kern = lambda: decode_attention(q, kn, vn, kc, vc, sp, posv)  # noqa
        plain = lambda: decode_attention_plain(q, kn, vn, kc, vc, sp,  # noqa
                                               posv)
        lib = sdpa_yardstick(q, kc, vc, sp, posv)
        r = dict(ms=device_ms(kern), plain_ms=device_ms(plain, reps=3),
                 device_ms=traced_ms([kern]),
                 plain_device_ms=traced_ms([plain]), library_ms=traced_ms([lib]),
                 bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, ops=ops)
        log("kernels", f"decode_attention, one layer of the {b}-slot step "
                       f"({lanes} lanes x {slots} slots, bf16): device "
                       f"{fmt_ms(r['device_ms'], 5)}, event-timed "
                       f"{r['ms']:.5f} ms; plain: device "
                       f"{fmt_ms(r['plain_device_ms'])}; SDPA (library): "
                       f"{fmt_ms(r['library_ms'], 5)}; bound {b_ms:.6f} ms "
                       f"({b_by}: {nbytes} B, {ops} ops)")
        if b == DECODE_SLOTS[0]:
            out["decode_attention"] = r
        lg, keys, spos = sample_case(b, torch.bfloat16, seed=b)
        v = lg.shape[-1]
        nbytes = lg.numel() * 2 + b * v * 4 + b * (16 + 8 + 8 + 4)
        b_ms, b_by = bound(nbytes, sample_ops(DECODE_M) * b * v,
                           SAMPLE_INT_OPS * b * v)
        kern = lambda: bma_sample(lg, keys, spos)  # noqa: E731
        plain = lambda: bma_sample_plain(lg, keys, spos)  # noqa: E731
        r = dict(ms=device_ms(kern), plain_ms=device_ms(plain, reps=3),
                 device_ms=traced_ms([kern]),
                 plain_device_ms=traced_ms([plain]), library_ms=None,
                 bound_ms=b_ms, bound_by=b_by, nbytes=nbytes)
        log("kernels", f"bma_sample, the {b}-slot step's sampler (M="
                       f"{DECODE_M}, V={v}, bf16; clusters of {CLUSTER} "
                       f"CTAs): device "
                       f"{fmt_ms(r['device_ms'], 5)}, event-timed "
                       f"{r['ms']:.5f} ms; plain: device "
                       f"{fmt_ms(r['plain_device_ms'])}; bound {b_ms:.6f} ms "
                       f"({b_by}: {nbytes} B); library: none")
        if b == DECODE_SLOTS[0]:
            out["bma_sample"] = r
    out["decode_attention_rg"] = time_rg_attention()
    keys = random.split(random.PRNGKey(1, DEVICE), DECODE_SLOTS[0])
    gum = lambda: random.gumbel(keys, (49152,))  # noqa: E731
    n = DECODE_SLOTS[0] * 49152
    plain = lambda: draw_plain([Draw(keys, 49152, GUMBEL,  # noqa: E731
                                     params=(TINY, 1.0))])
    g_ms, g_by = bound(4 * n, 49 * n, SAMPLE_INT_OPS * n)
    if not bitwise_equal(gum(), plain()[0]):
        raise AssertionError("threefry GUMBEL differs from its plain version")
    log("kernels", f"threefry GUMBEL form, the 8-slot step's noise ({n} "
                   f"draws): device {fmt_ms(traced_ms([gum]), 5)}; plain: "
                   f"device {fmt_ms(traced_ms([plain]))}; bound "
                   f"{g_ms:.6f} ms ({g_by}); bit for bit its plain version")
    return out


# --------------------------------------------------------------------------
# phase 13: BMA decode serving of smollm-135m at full width (ROADMAP A12)
# --------------------------------------------------------------------------

DECODE_LAUNCHED = ("decode_attention", "bma_sample")


def decode_golden() -> dict:
    rec = json.loads(DECODE_FILE.read_text())
    c = rec["config"]
    if c != DECODE_CONFIG or c["samples"] != DECODE_M or \
            c["max_len"] != DECODE_MAX_LEN or c["requests"] != \
            DECODE_REQUESTS or c["max_new_tokens"] != DECODE_NEW:
        raise AssertionError(f"{DECODE_FILE.name} ran {c}")
    return rec


def check_decode_bank(rec):
    """(a) The CLI's synthetic bank of M=4 inits on the card, each leaf's
    bit sum and sampled elements the reference's exactly, its float64 sum
    within 1e-12 relative (summed in another order)."""
    model = get_model(decode_model_cfg())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = serve_cli.synthetic_bank(model, 0, DECODE_M, DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves_with_path(bank)
    if len(leaves) != len(rec["leaves"]):
        raise AssertionError(f"bank: {len(leaves)} leaves against "
                             f"{len(rec['leaves'])}")
    for path, x in leaves:
        want = rec["leaves"][path.replace(".", "/")]
        flat = x.reshape(-1)
        bits = int((flat.view(torch.int32).long() & 0xFFFFFFFF).sum())
        vals = flat[torch.tensor(want["idx"], device=DEVICE)].tolist()
        total = float(flat.double().sum())
        if list(x.shape) != want["shape"] or bits != want["bits_sum"] or \
                vals != want["values"] or \
                abs(total - want["sum"]) > 1e-12 * max(abs(want["sum"]), 1):
            raise AssertionError(f"bank leaf {path}: not the reference's "
                                 f"(sum {total!r} against {want['sum']!r})")
    n = tree_count(bank) // DECODE_M
    log("decode", f"(a) {DECODE_ARCH}: {n:,} parameters a sample in "
                  f"{len(leaves)} leaves, a bank of {DECODE_M} inits from "
                  f"fold_in(PRNGKey(0), i) made on the card in "
                  f"{init_s:.2f} s: every leaf's bit sum and "
                  f"{len(rec['leaves']['embed/tok']['idx'])} sampled "
                  f"elements equal the reference's ({DECODE_FILE.name})")
    return bank, n


def compare_decode(label, resps, run, dtype) -> None:
    """Tokens equal the record's up to each request's first step whose
    recorded top-two margin is at or under the tolerance; token entropies
    within the tolerance through that step."""
    tol = DECODE_TOL[dtype]
    low, same, compared = 0, 0, 0
    for r, toks, ents, margins in zip(resps, run["tokens"],
                                      run["token_entropy"], run["margins"]):
        first = next((i for i, m in enumerate(margins) if m <= tol["margin"]),
                     len(margins))
        low += sum(m <= tol["margin"] for m in margins)
        if r.tokens[:first].tolist() != toks[:first]:
            raise AssertionError(f"{label}: request {r.request_id}'s tokens "
                                 f"{r.tokens.tolist()} against {toks}")
        upto = min(first + 1, len(ents))
        e = np.abs(r.token_entropy[:upto] - np.asarray(ents[:upto]))
        if (e > tol["ent"] * np.abs(ents[:upto])).any():
            raise AssertionError(f"{label}: request {r.request_id}'s "
                                 f"entropies off by {e.max():.3g}")
        compared += first
        same += int(r.tokens.tolist() == toks)
    log("decode", f"{label}: tokens equal the reference's at all {compared} "
                  f"steps above the margin {tol['margin']:g} (steps at or "
                  f"under it: {low}); whole sequences equal: {same} of "
                  f"{len(resps)}; entropies within rtol {tol['ent']:g}")


def first_step_state(eng, n: int) -> dict:
    """The first step's BMA probabilities of slots 0..n-1 and the keys and
    values it cached at position 0, on the host."""
    c = eng._caches["groups"]["u0"]
    return dict(probs=eng._out[1][:n].double().cpu(),
                k=c["k"][:, :, :n, 0].cpu(), v=c["v"][:, :, :n, 0].cpu())


def top_dlogp(probs, top, other=None) -> float:
    """The largest |log p - log q| at the record's top-8 of each slot: q the
    record's probabilities, or ``other``'s at the same indices."""
    idx = torch.tensor(top["idx"])
    want = (torch.tensor(top["probs"], dtype=torch.float64) if other is None
            else other.gather(1, idx))
    return float((probs.gather(1, idx).log() - want.log()).abs().max())


def check_cpu_witness(bank, rec, card: dict) -> None:
    """(b) The witness: the port's first step on the CPU at full width, 8
    slots (the record's), in each dtype: torch's CPU products in place of
    cuBLAS's, the kernels' plain versions. Its log p at the record's top-8
    against the record's (held to the same limit as the card's) and the
    card's, and the bf16 keys and values both cached at position 0,
    counted where they differ."""
    cpu_bank = tree_map(lambda t: t.cpu(), bank)
    for dtype in ("float32", "bfloat16"):
        model = get_model(decode_model_cfg(dtype))
        top = rec["runs"][dtype]["first_step_top"]
        n = len(top["idx"])
        eng = DecodeEngine(model, ServeConfig(
            slots=n, max_len=DECODE_MAX_LEN, max_new_tokens=DECODE_NEW),
            stacked=cpu_bank)
        for t, sd in decode_requests(model.cfg.vocab_size, n,
                                     DECODE_CONFIG["seed"]):
            eng.submit(ServeRequest(prompt_token=t, seed=sd))
        t0 = time.perf_counter()
        eng.step()
        secs = time.perf_counter() - t0
        mine, theirs = first_step_state(eng, n), card[dtype]
        ref = top_dlogp(mine["probs"], top)
        cross = top_dlogp(mine["probs"], top, theirs["probs"])
        differ = {x: (int((mine[x] != theirs[x]).sum()), mine[x].numel())
                  for x in ("k", "v")}
        if ref > DECODE_DLOGP[dtype]:
            raise AssertionError(f"the CPU witness, {dtype}: the first "
                                 f"step's log p off the record's top-8 by "
                                 f"{ref:.3g}")
        log("decode", f"(b) the witness, {dtype}: the port's first step on "
                      f"the CPU at full width ({n} slots, {secs:.1f} s): "
                      f"log p within {ref:.3g} of the record's top-8 (the "
                      f"card's: {top_dlogp(theirs['probs'], top):.3g}), "
                      f"{cross:.3g} of the card's; position-0 keys "
                      f"differing from the card's in {differ['k'][0]} of "
                      f"{differ['k'][1]} bf16 values, values in "
                      f"{differ['v'][0]} of {differ['v'][1]}")
        del eng


def run_decode_engine(bank, rec, dtype: str, slots: int) -> dict:
    """(b) DecodeEngine at ``slots`` slots over the record's 16 requests:
    the first step (the capture) alone, then the rest timed; the first
    step's BMA probabilities at the record's top-8; tokens and entropies
    against the record; no capture after the first step at partial
    occupancy and mixed lengths."""
    model = get_model(decode_model_cfg(dtype))
    run = rec["runs"][dtype]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    eng = DecodeEngine(model, ServeConfig(slots=slots, max_len=DECODE_MAX_LEN,
                                          max_new_tokens=DECODE_NEW),
                       stacked=bank)
    resident = torch.cuda.memory_allocated() - m0
    reqs = [ServeRequest(prompt_token=t, seed=s) for t, s in decode_requests(
        model.cfg.vocab_size, DECODE_REQUESTS, DECODE_CONFIG["seed"])]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    resps = eng.step()                   # the first step, then its capture
    first_ms = 1e3 * (time.perf_counter() - t0)
    first = first_step_state(eng, len(run["first_step_top"]["idx"]))
    dlogp = top_dlogp(first["probs"], run["first_step_top"])
    captures = eng.compile_count()
    walls = []
    while eng.pending():
        t = time.perf_counter()
        resps.extend(eng.step())
        walls.append(1e3 * (time.perf_counter() - t))
    launches = kernels.launch_counts()
    resps.sort(key=lambda r: r.request_id)
    label = f"{dtype}, {slots} slots"
    if dlogp > DECODE_DLOGP[dtype]:
        raise AssertionError(f"{label}: the first step's log p off the "
                             f"record's top-8 by {dlogp:.3g}")
    compare_decode(label, resps, run, dtype)
    eng.run([ServeRequest(prompt_token=9, seed=77 + i,
                          max_new_tokens=1 + i % 5) for i in range(slots // 2
                                                                   + 3)])
    if eng.compile_count() != captures or captures != 1:
        raise AssertionError(f"{label}: {eng.compile_count()} captures")
    for kname in DECODE_LAUNCHED:
        if launches[kname] <= 0:
            raise AssertionError(f"{label}: never launched {kname}")
    dev_ms = device_ms(lambda: eng._graph.replay())
    by_name = profiled(lambda: (eng._graph.replay(),
                                torch.cuda.synchronize()))
    if by_name:
        total = sum(t for t, _ in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        named = {k: trace_hits(by_name, k) for k in DECODE_LAUNCHED}
        log("decode", f"(b) {dtype}, {slots} slots, a traced replay: "
                      f"{sum(c for _, c in by_name.values())} kernels, "
                      f"{total / 1e3:.4f} device ms summed; "
                      + "; ".join(f"{k}: {t / 1e3:.4f} ms in {c}"
                                  for k, (t, c) in named.items())
                      + "; the longest: " + "; ".join(
                          f"{n[:60]} {t / 1e3:.4f} ms x{c}"
                          for n, (t, c) in top[:DECODE_TOP_KERNELS]))
    # the tokens of the timed steps (all but the first) over their wall time
    tokens = sum(len(r.tokens) for r in resps) - min(slots, DECODE_REQUESTS)
    lat = np.asarray([r.latency_s for r in resps], np.float64) * 1e3
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(eng._bank))
    b_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    wall = statistics.median(walls)
    res = dict(device_ms=dev_ms, wall_ms=wall, first_ms=first_ms,
               capture_ms=eng.capture_ms,
               tokens_per_s=1e3 * tokens / sum(walls),
               p50_ms=float(np.percentile(lat, 50)),
               p99_ms=float(np.percentile(lat, 99)), bound_ms=b_ms,
               weight_bytes=weight_bytes, resident=resident,
               launches={k: launches[k] for k in DECODE_LAUNCHED}, eng=eng,
               first=first)
    log("decode", f"(b) {label}: the first step {first_ms:.1f} ms "
                  f"(eager, then the capture {eng.capture_ms:.1f} ms), 1 "
                  f"capture in all (partial occupancy and lengths 1-5 "
                  f"after); first-step log p within {dlogp:.3g} of the "
                  f"record's top-8; a replayed step {dev_ms:.4f} device ms, "
                  f"{wall:.4f} wall ms (median of {len(walls)} steps); "
                  f"{res['tokens_per_s']:.1f} tokens/s over them "
                  f"({tokens} tokens); request p50 {res['p50_ms']:.2f} ms, "
                  f"p99 "
                  f"{res['p99_ms']:.2f} ms; weight-byte bound {b_ms:.4f} ms "
                  f"({weight_bytes:,} B of {dtype} weights a step, "
                  f"{100 * b_ms / dev_ms:.1f}% of the device time); "
                  f"resident tables {resident:,} B; launches "
                  f"{res['launches']} (the eager step and the capture)")
    return res


def check_decode_swaps(eng, bank) -> None:
    """8 same-M hot swaps between requests: memory_allocated flat to the
    byte, no capture, the swapped bank answering."""
    other = tree_map(lambda t: t * 1.01, bank)
    req = lambda i: ServeRequest(prompt_token=3, seed=500 + i)  # noqa: E731
    eng.run([req(0)])
    gc.collect()
    torch.cuda.synchronize()
    before, c0 = torch.cuda.memory_allocated(), eng.compile_count()
    ents = []
    for i in range(8):
        eng.install_bank(other if i % 2 == 0 else bank)
        ents.append(eng.run([req(1)])[0].entropy)
        torch.cuda.synchronize()
        now = torch.cuda.memory_allocated()
        if now != before:
            raise AssertionError(f"swap {i + 1}: memory_allocated {now} "
                                 f"against {before}")
    if eng.compile_count() != c0 or len(set(ents)) != 2:
        raise AssertionError(f"swaps: captures {eng.compile_count()}, "
                             f"entropies {ents}")
    log("decode", f"(b) 8 hot swaps ({DECODE_M} samples each): "
                  f"memory_allocated flat at {before:,} B to the byte, no "
                  f"capture, the two banks' answers alternating")


def run_decode_cli(rec) -> None:
    """(c) The serving CLI's decode mode at full width in-process: its
    tokens against the reference's record up to the first low-margin step,
    and its resp lines equal the reference's but for latency_ms wherever
    the request has no step at or under the margin; SMOKE OK."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        resps = serve_cli.main(["--arch", DECODE_ARCH, "--mode", "decode",
                                "--requests", str(DECODE_REQUESTS),
                                "--smoke"])
    wall = time.perf_counter() - t0
    text = out.getvalue()
    if "SMOKE OK" not in text:
        raise AssertionError(f"decode CLI: {text}")
    run = rec["runs"]["bfloat16"]
    compare_decode("(c) the CLI", resps, run, "bfloat16")
    lines = [ln for ln in text.splitlines() if ln.startswith("resp ")]
    full, low = 0, 0
    for ln, r in zip(lines, resps):
        i = r.request_id
        want = (f"resp id={i} pred={run['pred'][i]} entropy="
                f"{run['entropy'][i]:.3f} abstain=False bank_version=1 "
                f"tokens={run['tokens'][i]}")
        same = re.sub(r" latency_ms=[0-9.]+", "", ln) == want
        if min(run["margins"][i]) <= DECODE_TOL["bfloat16"]["margin"]:
            low += 1                 # a low-margin step may part the tokens
        elif not same:
            raise AssertionError(f"decode CLI: {ln!r} against {want!r}")
        full += int(same)
    for ln in text.splitlines():
        if ln.startswith("serve[decode]") and ln != (
                f"serve[decode]: arch={DECODE_ARCH} samples={DECODE_M} "
                f"slots=8 requests={DECODE_REQUESTS}"):
            raise AssertionError(f"decode CLI: {ln}")
    log("decode", f"(c) python -m repro_torch.launch.serve --arch "
                  f"{DECODE_ARCH} --mode decode --requests {DECODE_REQUESTS} "
                  f"--smoke at full width: {wall:.1f} s, SMOKE OK; "
                  f"{full} of its {len(lines)} resp lines equal the "
                  f"reference's but for latency_ms (held for the "
                  f"{len(lines) - low} without a step at or under the "
                  f"margin); "
                  + " | ".join(ln for ln in text.splitlines()
                               if ln.startswith("serve")))


def check_lm_eval(bank) -> None:
    """(d) The LM eval at full width on markov tokens: the scan eval engine
    (one CUDA graph) against the host engine, bit for bit."""
    from repro_torch.data.synthetic_lm import markov_tokens
    from repro_torch.eval.engine import lm_apply_fn
    model = get_model(decode_model_cfg())
    toks = markov_tokens(16, 33, model.cfg.vocab_size, seed=0)
    data = {"tokens": toks, "y": toks[:, 1:]}
    apply = lm_apply_fn(model)
    scan, sp = ScanEvalEngine(apply, batch_size=8).evaluate(
        bank, data, return_probs=True)
    host, hp = HostEvalEngine(apply, batch_size=8).evaluate(
        bank, data, return_probs=True)
    same_report("LM eval: scan against host", scan, host)
    same_probs("LM eval: scan against host", sp, hp)
    log("decode", f"(d) LM eval, {DECODE_M} samples on 16 markov sequences "
                  f"of 33 tokens ({int(scan.count)} scored positions): the "
                  f"scan engine's CUDA graph equals the host engine bit for "
                  f"bit (accuracy {scan.accuracy:.4f}, NLL {scan.nll:.4f}, "
                  f"ECE {scan.ece:.4f}, entropy {scan.entropy:.4f})")


@contextlib.contextmanager
def permissive_matmuls():
    """TF32 and cuBLAS's reduced-precision bf16 and f16 reductions allowed
    for the process (torch's default for the reductions; main() turned
    TF32 off): the model's entry points turn them off for their own
    products (``layers.f32_sums``), so the decode path must read the
    reference's arithmetic all the same."""
    m = torch.backends.cuda.matmul
    names = ("allow_tf32", "allow_bf16_reduced_precision_reduction",
             "allow_fp16_reduced_precision_reduction")
    saved = [getattr(m, x) for x in names]
    for x in names:
        setattr(m, x, True)
    try:
        yield
    finally:
        for x, v in zip(names, saved):
            setattr(m, x, v)


@permissive_matmuls()
def run_phase13() -> dict:
    """Phase 13. Returns the launch counts of the main path's run (bf16,
    8 slots: the CLI's defaults)."""
    log("decode", f"on {card_line()}; the process allows TF32 and "
                  f"reduced-precision bf16 reductions throughout (the model "
                  f"sums its own products in f32)")
    torch.cuda.empty_cache()
    rec = decode_golden()
    bank, n = check_decode_bank(rec)
    timings, launches = {}, None
    for dtype in ("bfloat16", "float32"):
        for slots in DECODE_SLOTS:
            r = run_decode_engine(bank, rec, dtype, slots)
            eng = r.pop("eng")
            if dtype == "bfloat16" and slots == DECODE_SLOTS[0]:
                launches = r["launches"]
                check_decode_swaps(eng, bank)
            timings[(dtype, slots)] = r
            del eng
            torch.cuda.empty_cache()
    check_cpu_witness(bank, rec, {d: timings[(d, DECODE_SLOTS[0])]["first"]
                                  for d in ("bfloat16", "float32")})
    for (dtype, slots), r in timings.items():
        log("decode", f"step table: {dtype}, {slots} slots: device "
                      f"{r['device_ms']:.4f} ms, wall {r['wall_ms']:.4f} ms, "
                      f"{r['tokens_per_s']:.1f} tokens/s, p50 "
                      f"{r['p50_ms']:.2f} ms, p99 {r['p99_ms']:.2f} ms, "
                      f"bound {r['bound_ms']:.4f} ms")
    run_decode_cli(rec)
    check_lm_eval(bank)
    del bank
    torch.cuda.empty_cache()
    return launches



# --------------------------------------------------------------------------
# phase 14: federated LM training of smollm-135m at full width (ROADMAP A12
# part 2): FedTrainer on both engines, the baselines, the training CLI
# --------------------------------------------------------------------------

LM_ARCH = "smollm-135m"
# the reference train CLI's defaults for smollm-135m: K, L, minibatch,
# sequence and pool; a ring, block_topk at 1%, ζ = 0.3, η = 1e-4, seed 0,
# the data scale the CLI hands its round (1.0)
LM_NODES, LM_STEPS, LM_BATCH, LM_SEQ, LM_POOL = 4, 4, 4, 128, 64
LM_FED = dict(num_nodes=LM_NODES, local_steps=LM_STEPS, eta=1e-4, zeta=0.3,
              topology="ring", compressor="block_topk", compress_ratio=0.01)
LM_ROUNDS = 3                # (b)'s host and scan runs, one chunk of 3
LM_HELD = 8                  # held-out sequences of node K scored in (b)
# the kernels each of phase 14's runs must launch
LM_LAUNCHED = {
    "cdbfl": ("topk_select", "unpack_set", "fused_update", "threefry",
              "gossip_mix"),
    "fused": ("delta_pack", "unpack", "fused_update", "threefry",
              "gossip_mix"),
    "dsgld": ("dsgld_update", "threefry", "gossip_mix"),
    "cffl": ("topk_select", "unpack_set", "cffl_update", "threefry",
             "gossip_mix")}
# (a)'s limits against the reference's f32 record (tests/golden/
# lm_rounds_smollm_135m.json), set from the first card run's readings
# (PR 30): losses 1.49e-5 and consensus 3.58e-5 relative (the loss is
# dominated by the prior's f32 sum over 134.5 M squares, which XLA's CPU
# code and the card add in other orders), θ 3.16e-6 at the picks (the
# gradient's f32 sums over 49,152 logits and 64 tokens, times η), sums
# 3.8 times (1e-3 + 1e-6·|sum|); survivors and wire bytes exact
LM_REC_TOL = dict(loss=1e-4, consensus=1e-4, value=2e-5, sum_atol=1e-2,
                  sum_rtol=1e-5)
# (a)'s limits on what the loss and θ cannot show (the loss is dominated by
# the prior, and η·∇NLL moves θ less than the rounds' noise): each node's
# NLL on the record's NLL batch, relative, at the init and after each
# round; the init's gradient of the summed NLL at each leaf's 16 largest
# elements (over the leaf's largest |g|) and its norm (relative). A bf16
# forward and backward on the same θ is the control each limit must fail.
# Set from the first card readings (PR 30): the NLL 0, 2.6e-7 and 4.3e-7
# (bf16 control 8.4e-6 at the init, where the NLL of random weights is
# near log V whatever the rounding, 2.3e-4 and 1.7e-4 after the rounds);
# the gradient 5.8e-6 (bf16 control 2.2e-2)
LM_NLL_RTOL, LM_GRAD_TOL = 4e-6, 1e-4


def lm_record() -> dict:
    rec = json.loads(LM_ROUNDS_FILE.read_text())
    if rec["config"] != LM_ROUNDS_CONFIG:
        raise AssertionError(f"{LM_ROUNDS_FILE.name} ran {rec['config']}")
    return rec


def lm_trainer(pools, engine: str, algorithm: str = "cdbfl",
               fused: bool = False, dtype=None, **kw):
    """A full-width smollm-135m FedTrainer on the card: the CLI's
    configuration, burn-in 1, a bank of 2 (f32, 2.15 GB a sample) and eval
    batches of the held-out set's size (a padded batch of 64 would hold
    6 GB of f32 logits a sample)."""
    from repro_torch.train import FedTrainer
    cfg = get_arch(LM_ARCH).config
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    fed = FedConfig(rounds=LM_ROUNDS, burn_in=1, algorithm=algorithm,
                    fused_compress=fused, **LM_FED)
    args = dict(minibatch=LM_BATCH, seed=0, engine=engine, chunk=LM_ROUNDS,
                bank_capacity=2, bank_thin=1, data_scale=1.0,
                eval_batch_size=LM_HELD, device=DEVICE)
    args.update(kw)
    return FedTrainer(get_model(cfg), fed, pools, **args)


def leaf_reading(x: torch.Tensor, want: dict):
    """(largest |Δ| at the record's picks, |Δ| of the float64 sum, whether
    the sum of the f32 bit patterns is the record's) of one leaf."""
    flat = x.detach().float().reshape(-1)
    idx = torch.tensor(want["idx"], device=flat.device)
    got = flat[idx].double().cpu().numpy()
    bits = int(flat.view(torch.int32).to(torch.int64).remainder(
        1 << 32).sum().item())
    return (float(np.abs(got - np.asarray(want["values"])).max()),
            abs(float(flat.double().sum().item()) - want["sum"]),
            bits == want["bits_sum"])


def lm_round_inputs(trainer, key):
    """One round's inputs from the round key ``key``, as the engine draws
    them (``round_inputs`` at the trainer's own minibatch)."""
    idx, draws = random.run(random.together(
        round_indices.program(trainer.device_shards, key,
                              trainer.fed_cfg.local_steps, trainer.minibatch),
        trainer.round_fn.draws.program(key, trainer.state.params)))
    return trainer.device_shards.gather(idx), key, draws


def nll_reading(model, params, batch, want) -> float:
    """The largest relative |Δ| of the nodes' NLL on ``batch`` against
    the record's."""
    with torch.no_grad():
        got = model.nll(params, batch).double().cpu().numpy()
    return float(np.abs(got / np.asarray(want) - 1).max())


def grad_reading(model, params, batch, want) -> tuple:
    """The gradient of the nodes' summed NLL (``_value_and_grad``, no prior,
    data scale 1) against the record's: (the largest |Δ| at a leaf's
    recorded elements over its largest |g|, or of its norm relative, and
    that leaf)."""
    from repro_torch.core import algorithms as alg
    paths = [p for p, _ in tree_leaves_with_path(params)]
    _, grads = alg._value_and_grad(model.nll, paths, tree_leaves(params),
                                   batch, 0.0, 1.0)
    worst, where = 0.0, ""
    for path, g in zip(paths, grads):
        w = want[path.replace(".", "/")]
        flat = g.reshape(-1)
        got = flat[torch.tensor(w["idx"], device=flat.device)].double()
        err = max(float(np.abs(got.cpu().numpy() - np.asarray(w["values"]))
                        .max()) / w["absmax"],
                  abs(float(flat.double().norm()) / w["norm"] - 1))
        if err > worst:
            worst, where = err, path
    return worst, where


def check_lm_record(rec) -> dict:
    """(a) The reference's record in f32 (``LM_ROUNDS_CONFIG``: K = 2, L = 2,
    minibatch 2, 32 tokens, 2 rounds): the init bit for bit, its nodes' NLL
    and its gradient; each round's losses, consensus, wire bytes, θ and v
    at the record's picks and sums, v's survivors per leaf, and the nodes'
    NLL of θ. The NLL and the gradient are read in bf16 compute too, on
    the same θ: the control that their limits must tell apart."""
    from repro_torch.data.synthetic_lm import markov_tokens
    from repro_torch.train import FedTrainer
    c = rec["config"]
    cfg = get_arch(c["arch"]).config.replace(dtype=c["dtype"])
    model = get_model(cfg)
    control = get_model(cfg.replace(dtype="bfloat16"))
    t0 = time.perf_counter()
    pools = lm_pools(markov_tokens, c["fed"]["num_nodes"], c["pool"],
                     c["seq"], cfg.vocab_size, c["seed"])
    batch = {"tokens": torch.from_numpy(lm_nll_batch(
        pools, c["minibatch"])).to(DEVICE)}
    trainer = FedTrainer(model, FedConfig(rounds=c["rounds"], **c["fed"]),
                         pools, minibatch=c["minibatch"], seed=c["seed"],
                         data_scale=c["data_scale"], engine="host",
                         bank_capacity=1, device=DEVICE)
    for path, x in tree_leaves_with_path(trainer.state.params):
        err, _, bits = leaf_reading(x, rec["init"][path.replace(".", "/")])
        if err != 0 or not bits:
            raise AssertionError(f"(a) init of {path} is not the reference's")
    params = trainer.state.params
    nll = [nll_reading(model, params, batch, rec["init_nll"])]
    nll_control = [nll_reading(control, params, batch, rec["init_nll"])]
    grad, grad_at = grad_reading(model, params, batch, rec["init_grad"])
    grad_control, _ = grad_reading(control, params, batch, rec["init_grad"])
    eng, losses = trainer._engine, []
    round_fn = eng.round_fn

    def hooked(state, batches, key, draws=None):
        out = round_fn(state, batches, key, draws)
        losses.append(out[1].loss.double().cpu().numpy())
        return out
    hooked.draws = round_fn.draws
    eng.round_fn = hooked
    worst = dict(loss=0.0, consensus=0.0, theta=0.0, v=0.0, theta_sum=0.0,
                 v_sum=0.0)
    where = {}
    for t, want in enumerate(rec["rounds"]):
        res = trainer.run(rounds=1)
        if res.wire_history != [want["wire_bytes"]]:
            raise AssertionError(f"(a) round {t + 1}: wire bytes "
                                 f"{res.wire_history}, want "
                                 f"{want['wire_bytes']}")
        worst["loss"] = max(worst["loss"], float(np.abs(
            losses[-1] / np.asarray(want["loss"]) - 1).max()))
        worst["consensus"] = max(worst["consensus"], abs(
            res.consensus_history[-1] / want["consensus"] - 1))
        for part, tree in (("theta", trainer.state.params),
                           ("v", trainer.state.v)):
            for path, x in tree_leaves_with_path(tree):
                key = path.replace(".", "/")
                w = want[part][key]
                err, serr, _ = leaf_reading(x, w)
                serr /= (LM_REC_TOL["sum_atol"]
                         + LM_REC_TOL["sum_rtol"] * abs(w["sum"]))
                if err > worst[part]:
                    worst[part], where[part] = err, f"{path}@{t + 1}"
                if serr > worst[f"{part}_sum"]:
                    worst[f"{part}_sum"] = serr
                    where[f"{part}_sum"] = f"{path}@{t + 1}"
                if part == "v" and int(torch.count_nonzero(x)) != \
                        want["v_survivors"][key]:
                    raise AssertionError(
                        f"(a) round {t + 1}: v.{path} holds "
                        f"{int(torch.count_nonzero(x))} survivors, the "
                        f"reference {want['v_survivors'][key]}")
        nll.append(nll_reading(model, trainer.state.params, batch,
                               want["nll"]))
        nll_control.append(nll_reading(control, trainer.state.params, batch,
                                       want["nll"]))
    log("lm", f"(a) the reference's f32 record ({c['cuts']}): init bit for "
              f"bit, {len(rec['rounds'])} rounds' wire bytes "
              f"({rec['rounds'][0]['wire_bytes']:,.0f}) and v's survivors a "
              f"leaf exact; largest readings: losses {worst['loss']:.3g} "
              f"(rtol), consensus {worst['consensus']:.3g} (rtol), θ "
              f"{worst['theta']:.3g} and v {worst['v']:.3g} at the picks "
              f"(abs), sums {worst['theta_sum']:.3g} / {worst['v_sum']:.3g} "
              f"of their limits (leaf@round: {where}); the nodes' NLL "
              f"({rec['init_nll']} at the init) {max(nll):.3g} (rtol; init "
              f"and rounds: {[float(f'{x:.3g}') for x in nll]}), bf16 "
              f"control {min(nll_control):.3g}; the init's gradient "
              f"{grad:.3g} ({grad_at}), bf16 control {grad_control:.3g}; "
              f"{time.perf_counter() - t0:.1f} s")
    if not max(nll) <= LM_NLL_RTOL < min(nll_control):
        raise AssertionError(f"(a) NLL {nll}, bf16 control {nll_control}, "
                             f"limit {LM_NLL_RTOL}")
    if not grad <= LM_GRAD_TOL < grad_control:
        raise AssertionError(f"(a) gradient {grad} at {grad_at}, bf16 "
                             f"control {grad_control}, limit {LM_GRAD_TOL}")
    worst.update(nll=max(nll), nll_control=min(nll_control), grad=grad,
                 grad_control=grad_control)
    for name in ("loss", "consensus"):
        if not worst[name] <= LM_REC_TOL[name]:
            raise AssertionError(f"(a) {name} {worst[name]} against the "
                                 f"record, limit {LM_REC_TOL[name]}")
    for part in ("theta", "v"):
        if not (worst[part] <= LM_REC_TOL["value"]
                and worst[f"{part}_sum"] <= 1.0):
            raise AssertionError(f"(a) {part} off the record: {worst}")
    return worst


def same_lm_state(label: str, got, want) -> None:
    """Params, v and v̄ (tensors kept from a run) bit for bit."""
    for part in ("params", "v", "v_bar"):
        same_tensors(f"{label} {part}", tree_leaves(getattr(got, part)),
                     want[part])


def lm_state_of(trainer) -> dict:
    return {part: tree_leaves(getattr(trainer.state, part))
            for part in ("params", "v", "v_bar")}


def check_launched(label: str, launches: dict, names) -> None:
    for kname in names:
        if launches.get(kname, 0) <= 0:
            raise AssertionError(f"{label}: never launched {kname} "
                                 f"({launches})")


def time_lm_parts(trainer) -> dict:
    """(f) The replayed round split into its parts: each part of a round of
    the host trainer's state captured in a CUDA graph of its own, as the
    scan engine captures the whole round, and its replay timed by CUDA
    events (device ms, median of 5): the round's inputs (minibatch indices,
    noise and codec uniforms, the gather), the L local steps (Eq. 5), the
    codec (encode and decode, Eq. 6), the mix (Eq. 8) and the update (Eqs.
    7 and 9). What the replayed round spends beyond their sum is the
    metrics, the bank and the copies of the carry."""
    from repro_torch.core import algorithms as alg
    from repro_torch.utils.graphs import capture
    fed, state = trainer.fed_cfg, trainer.state
    key = random.PRNGKey(9, DEVICE)
    batches, _, (noise, uniforms) = lm_round_inputs(trainer, key)
    theta_l, _ = alg._local_sgd(trainer.model.nll, state.params, batches,
                                fed.eta, 1.0 / fed.num_nodes,
                                trainer.data_scale, fed.local_steps)
    delta = alg._compress_exchange(trainer.compressor, theta_l, state.v,
                                   uniforms)[1]
    mixed = trainer.round_fn.mixer(delta)
    parts = {
        "inputs": lambda: lm_round_inputs(trainer, key),
        "local steps": lambda: alg._local_sgd(
            trainer.model.nll, state.params, batches, fed.eta,
            1.0 / fed.num_nodes, trainer.data_scale, fed.local_steps),
        "codec": lambda: alg._compress_exchange(
            trainer.compressor, theta_l, state.v, uniforms)[:2],
        "mix": lambda: trainer.round_fn.mixer(delta),
        "update": lambda: alg._control_update(theta_l, state, delta, mixed,
                                              fed.zeta, noise)}
    stream, out = torch.cuda.Stream(DEVICE), {}
    for name, fn in parts.items():
        graph, _, _ = capture(fn, stream)
        torch.cuda.synchronize()
        out[name] = device_ms(graph.replay, reps=5, per_rep=1)
        del graph
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_lm_engines(pools, held) -> dict:
    """(b) bf16 at full width: the host engine for 3 rounds, then the scan
    engine twice (one chunk of 3, a CUDA graph), each bit for bit to the
    host run, with the held-out evaluation; (f)'s timings and peak
    memory. Returns the host run's launches and the timings."""
    host = lm_trainer(pools, "host")
    kernels.reset_launch_counts()
    hres = host.run(rounds=LM_ROUNDS)
    launches = kernels.launch_counts()
    check_launched("(b) host run", launches, LM_LAUNCHED["cdbfl"])
    wire = float(host.compressor.wire_bytes(tree_map(
        lambda x: x[0], host.state.params)))
    if hres.wire_history != [wire] * LM_ROUNDS or not all(
            math.isfinite(x) for x in hres.loss_history
            + hres.consensus_history):
        raise AssertionError(f"(b) host run: {hres.wire_history} "
                             f"{hres.loss_history} {hres.consensus_history}")
    hrep, hprobs = host.eval_report(held, return_probs=True)
    want = lm_state_of(host)
    want_bank = [tree_leaves(s) for s in host.bank.samples]
    parts = time_lm_parts(host)
    by_name = profiled(lambda: (host.round_fn(
        host.state, *lm_round_inputs(host, random.PRNGKey(11, DEVICE))),
        torch.cuda.synchronize()))
    kernel_ms = {k: trace_hits(by_name, k) for k in LM_LAUNCHED["cdbfl"]} \
        if by_name else {}
    traced_total = (sum(t for t, _ in by_name.values()) / 1e3
                    if by_name else float("nan"))
    top = sorted((by_name or {}).items(), key=lambda kv: -kv[1][0])[:8]
    host_ms = statistics.median(hres.round_ms[1:])
    model = host.model
    del host
    gc.collect()
    torch.cuda.empty_cache()
    runs = []
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        scan = lm_trainer(pools, "scan")
        sres = scan.run(rounds=LM_ROUNDS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        same_lm_state(f"(b) scan run {i + 1} against the host run", scan.state,
                      want)
        if (sres.loss_history != hres.loss_history
                or sres.consensus_history != hres.consensus_history
                or sres.wire_history != hres.wire_history):
            raise AssertionError(f"(b) scan run {i + 1}: metrics differ")
        for got, w in zip(scan.bank.samples, want_bank):
            same_tensors(f"(b) scan run {i + 1} bank", tree_leaves(got), w)
        srep, sprobs = scan.eval_report(held, return_probs=True)
        same_report(f"(b) scan run {i + 1} eval", srep, hrep)
        same_probs(f"(b) scan run {i + 1} eval", sprobs, hprobs)
        engine = scan._engine
        capture = engine.capture_ms.get(LM_ROUNDS, float("nan"))
        if i == 0:
            wall, busy, enqueue, _ = time_replay(engine, LM_ROUNDS, LM_ROUNDS)
        runs.append(dict(peak_gib=peak, capture_ms=capture))
        del scan, engine
        gc.collect()
        torch.cuda.empty_cache()
    n = sum(x[0].numel() for x in want["params"])
    log("lm", f"(b) {LM_ARCH} at full width ({n:,} parameters a node, "
              f"{model.cfg.dtype} compute), K={LM_NODES}, L={LM_STEPS}, "
              f"minibatch {LM_BATCH} of {LM_SEQ} tokens, ring: host engine "
              f"{LM_ROUNDS} rounds (losses {hres.loss_history}, consensus "
              f"{hres.consensus_history}), the scan engine (one chunk of "
              f"{LM_ROUNDS}, a CUDA graph) twice, each equal to it bit for "
              f"bit: params, v, v̄, losses, consensus, bytes, the bank "
              f"({len(want_bank)} samples) and the held-out evaluation of "
              f"{LM_HELD} sequences (NLL {hrep.nll:.4f}, accuracy "
              f"{hrep.accuracy:.4f}, ECE {hrep.ece:.4f}); launches "
              f"{ {k: launches[k] for k in LM_LAUNCHED['cdbfl']} }")
    return dict(launches=launches, wire=wire, host_ms=host_ms, wall=wall,
                busy=busy, enqueue=enqueue, runs=runs, parts=parts,
                kernel_ms=kernel_ms, traced_total=traced_total, top=top)


def check_lm_fused(pools) -> None:
    """(c) ``fused_compress=True`` (delta-pack, unpack, fused_update) for a
    round, then a round from its state fused and through the two-pass
    ``FusedCodec(fused=False)`` oracle on the same draws: payload and params
    bit for bit."""
    trainer = lm_trainer(pools, "host", fused=True)
    kernels.reset_launch_counts()
    res = trainer.run(rounds=1)
    launches = kernels.launch_counts()
    check_launched("(c) fused run", launches, LM_LAUNCHED["fused"])
    oracle = FusedCodec.wrap(CompressionPipeline(trainer.compressor.stages),
                             fused=False)
    oracle_fn = make_cdbfl_round(trainer.model.nll, trainer.fed_cfg,
                                 trainer.omega, oracle, trainer.data_scale,
                                 trainer.device)
    inputs = lm_round_inputs(trainer, random.PRNGKey(123, DEVICE))
    s_fused, m_fused = trainer.round_fn(trainer.state, *inputs)
    kernels.reset_launch_counts()
    s_two, m_two = oracle_fn(trainer.state, *inputs)
    two = kernels.launch_counts()
    traced = {}
    for fn, names in ((trainer.round_fn, LM_LAUNCHED["fused"]),
                      (oracle_fn, ("pack",))):
        by_name = profiled(lambda: (fn(trainer.state, *inputs),
                                    torch.cuda.synchronize()))
        traced.update({k: trace_hits(by_name, k) for k in names}
                      if by_name else {})
    if two["pack"] <= 0 or two["delta_pack"] != 0 or two["unpack"] != 1:
        raise AssertionError(f"(c) oracle round launches {two}")
    for (path, _), a, b in zip(tree_leaves_with_path(trainer.state.params),
                               m_fused.payload.entries,
                               m_two.payload.entries):
        if not (bitwise_equal(a.wire, b.wire) and all(
                bitwise_equal(x[key], y[key])
                for x, y in zip(a.aux, b.aux) for key in x)):
            raise AssertionError(f"(c) two-pass payload differs on {path}")
    for part in ("params", "v", "v_bar"):
        same_tensors(f"(c) two-pass round {part}",
                     tree_leaves(getattr(s_two, part)),
                     tree_leaves(getattr(s_fused, part)))
    log("lm", f"(c) fused_compress=True at full width: a round (loss "
              f"{res.loss_history[0]:.4f}, {res.wire_history[0]:,.0f} bytes "
              f"a node; launches "
              f"{ {k: launches[k] for k in LM_LAUNCHED['fused']} }), then "
              f"FusedCodec(fused=False)'s round from its state: payload "
              f"({m_two.payload.measured_bytes():,} bytes, {LM_NODES} "
              f"nodes), params, v and v̄ equal to the fused round's bit for "
              f"bit; traced rounds: "
              + ", ".join(f"{k} {t / 1e3:.4f} ms ({c} launches)"
                          for k, (t, c) in traced.items()))
    del trainer, s_fused, s_two, m_fused, m_two
    gc.collect()
    torch.cuda.empty_cache()


def check_lm_baselines(pools) -> None:
    """(d) One DSGLD round and one CF-FL round at full width, on the host
    engine and on the scan engine (a CUDA graph), bit for bit."""
    for algorithm in ("dsgld", "cffl"):
        trainer = lm_trainer(pools, "host", algorithm=algorithm)
        kernels.reset_launch_counts()
        res = trainer.run(rounds=1)
        launches = kernels.launch_counts()
        scan = lm_trainer(pools, "scan", algorithm=algorithm, chunk=1)
        sres = scan.run(rounds=1)
        same_lm_state(f"(d) {algorithm} scan against host", scan.state,
                      lm_state_of(trainer))
        if (sres.loss_history != res.loss_history
                or sres.consensus_history != res.consensus_history):
            raise AssertionError(f"(d) {algorithm}: scan metrics differ")
        del scan
        gc.collect()
        torch.cuda.empty_cache()
        check_launched(f"(d) {algorithm}", launches, LM_LAUNCHED[algorithm])
        dense = tree_count(trainer.state.params) // LM_NODES * 4
        want = float(dense) if algorithm == "dsgld" else float(
            trainer.compressor.wire_bytes(tree_map(lambda x: x[0],
                                                   trainer.state.params)))
        if res.wire_history != [want] or not all(
                math.isfinite(x) and x > 0 for x in res.loss_history
                + res.consensus_history):
            raise AssertionError(f"(d) {algorithm}: {res.wire_history} "
                                 f"{res.loss_history}")
        inputs = lm_round_inputs(trainer, random.PRNGKey(5, DEVICE))
        by_name = profiled(lambda: (trainer.round_fn(trainer.state, *inputs),
                                    torch.cuda.synchronize()))
        update = f"{algorithm}_update"
        t_us, n = trace_hits(by_name, update) if by_name else (float("nan"),
                                                               0)
        log("lm", f"(d) {algorithm} at full width, one round, the scan "
                  f"engine equal to the host engine bit for bit: loss "
                  f"{res.loss_history[0]:.4f}, consensus "
                  f"{res.consensus_history[0]:.6g}, {want:,.0f} bytes a "
                  f"node, {res.round_ms[0]:.1f} ms; launches "
                  f"{ {k: launches[k] for k in LM_LAUNCHED[algorithm]} }; a "
                  f"traced round: {update} {t_us / 1e3:.4f} ms ({n} "
                  f"launches)")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()


def run_lm_cli(rec) -> None:
    """(e) ``python -m repro_torch.launch.train --arch smollm-135m`` at full
    width in-process (``LM_CLI_ARGV``: 2 rounds, each evaluated on the
    held-out stream of node K, a bank of 2): its header lines equal the
    reference CLI's (the record's ``cli``), its round, eval and bank lines
    finite."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        train_cli.main(list(LM_CLI_ARGV))
    wall = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    heads = [ln for ln in lines if ln.startswith(CLI_HEADS)]
    if heads != rec["cli"]["lines"]:
        raise AssertionError(f"(e) CLI header {heads} against "
                             f"{rec['cli']['lines']}")
    rounds = [ln for ln in lines if ln.startswith("round ")]
    evals = [ln for ln in lines if ln.startswith("eval  round")]
    if (len(rounds) != 2 or len(evals) != 2 or "nan" in " ".join(
            rounds + evals) or not any(ln.startswith("posterior bank:")
                                       for ln in lines)):
        raise AssertionError(f"(e) CLI: {lines}")
    log("lm", f"(e) python -m repro_torch.launch.train "
              f"{' '.join(LM_CLI_ARGV)}: {wall:.1f} s, header lines equal "
              f"the reference CLI's; " + " | ".join(rounds + evals))


def check_backward_sums() -> None:
    """The round's backward on the card runs with f32 sums (``f32_sums``
    around ``torch.autograd.grad``): cuBLAS's TF32 and reduced-precision
    flags read off inside the backward, though the process allows them."""
    from repro_torch.core import algorithms as alg
    m = torch.backends.cuda.matmul
    names = ("allow_tf32", "allow_bf16_reduced_precision_reduction",
             "allow_fp16_reduced_precision_reduction")
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            seen.append(tuple(getattr(m, n) for n in names))
            return g

    cfg = get_arch(LM_ARCH).reduced
    model = get_model(cfg)
    params = tree_map(lambda x: x[None].expand((2,) + tuple(x.shape)).clone(),
                      model.init(random.PRNGKey(0, DEVICE), DEVICE))

    def nll(p, batch):
        return model.nll(dict(p, final_norm={"scale": Probe.apply(
            p["final_norm"]["scale"])}), batch)

    toks = torch.randint(0, cfg.vocab_size, (2, 2, 16), device=DEVICE,
                         generator=torch.Generator(DEVICE).manual_seed(0))
    before = tuple(getattr(m, n) for n in names)
    alg._value_and_grad(nll, [p for p, _ in tree_leaves_with_path(params)],
                        tree_leaves(params), {"tokens": toks}, 0.5, 1.0)
    torch.cuda.synchronize()
    if seen != [(False, False, False)] or before != (True, True, True) or \
            tuple(getattr(m, n) for n in names) != before:
        raise AssertionError(f"backward flags {seen}, process {before}")
    log("lm", "the round's backward ran with TF32 and reduced-precision "
              "reductions off (read inside it), the process allowing both")


def check_gather_backward() -> None:
    """The embedding gather's backward on the card (ROADMAP C31): a bf16
    table's cotangents added into it by ``index_put_`` with accumulation
    over 49,152 rows and repeated tokens, run twice (bit for bit: no float
    atomics), and read against the two rules a sum of repeats may follow:
    XLA's CPU code (and torch's on the CPU) rounds each add to bf16 in
    token order; one rounding of the f32 sum is the other."""
    gen = torch.Generator().manual_seed(3)
    vocab, d, n = 49152, 576, 4 * 4 * 128
    toks = torch.randint(0, 512, (n,), generator=gen)       # many repeats
    w = torch.randn(n, d, generator=gen).to(torch.bfloat16)
    grads = []
    for _ in range(2):
        tab = torch.zeros(vocab, d, device=DEVICE, requires_grad=True)
        x = tab.to(torch.bfloat16)[toks.to(DEVICE)]
        x.backward(w.to(DEVICE))
        grads.append(tab.grad)
    if not bitwise_equal(grads[0], grads[1]):
        raise AssertionError("the gather's backward is not deterministic")
    tab = torch.zeros(vocab, d, requires_grad=True)
    tab.to(torch.bfloat16)[toks].backward(w)
    seq = tab.grad
    once = torch.zeros(vocab, d).index_add_(0, toks, w.float()).to(
        torch.bfloat16).float()
    card = grads[0].cpu()
    log("lm", f"C31: the gather's backward on the card (index_put_, "
              f"{n} tokens of 512 ids into {vocab} rows) is deterministic; "
              f"its sums of repeats equal one rounding of the f32 sum in "
              f"{float((card == once).float().mean()):.4f} of the entries, "
              f"the token-order bf16 adds of XLA (and the port's CPU) in "
              f"{float((card == seq).float().mean()):.4f}")


@permissive_matmuls()
def run_phase14() -> None:
    """Phase 14, with TF32 and reduced-precision reductions allowed for the
    process (the round pins its own products to f32 sums, backward
    included). Each run checks the launches of its kernels
    (``LM_LAUNCHED``)."""
    log("lm", f"on {card_line()}")
    check_backward_sums()
    check_gather_backward()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = lm_record()
    check_lm_record(rec)
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.data.synthetic_lm import markov_tokens
    vocab = get_arch(LM_ARCH).config.vocab_size
    pools = lm_pools(markov_tokens, LM_NODES, LM_POOL, LM_SEQ, vocab)
    held = lm_pools(markov_tokens, 1, LM_HELD, LM_SEQ, vocab,
                    node0=LM_NODES)[0]
    b = run_lm_engines(pools, held)
    check_lm_fused(pools)
    check_lm_baselines(pools)
    run_lm_cli(rec)
    parts = b["parts"]
    log("lm", f"(f) on {card_line()}: a round of the bf16 default at full "
              f"width (K={LM_NODES}, L={LM_STEPS}): host engine "
              f"{b['host_ms']:.3f} ms wall; a replayed chunk of "
              f"{LM_ROUNDS}: {b['wall']:.3f} ms a round wall, "
              f"{b['busy']:.3f} ms on the device (CUDA events around "
              f"graph.replay(), median of 5; idle "
              f"{100 * (1 - b['busy'] / b['wall']):.1f}%), host "
              f"{b['enqueue']:.3f} ms to enqueue the replay; capture "
              f"{b['runs'][0]['capture_ms']:.1f} ms; peak allocated "
              f"{b['runs'][0]['peak_gib']:.2f} GiB (the scan trainer); "
              f"{b['wire']:,.0f} wire bytes a node a round. The round's "
              f"parts, each a CUDA graph of its own (device ms of its "
              f"replay, CUDA events, median of 5): "
              + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
              + f" (sum {sum(parts.values()):.3f}; the rest of the replayed "
              f"round, metrics, bank and copies, "
              f"{b['busy'] - sum(parts.values()):.3f}); a traced round "
              f"{b['traced_total']:.3f} device ms, the ported kernels in it: "
              + ", ".join(f"{k} {t / 1e3:.4f} ms ({c} launches)"
                          for k, (t, c) in b["kernel_ms"].items())
              + "; the trace's largest: "
              + "; ".join(f"{name[:110]} {t / 1e3:.3f} ms ({c})"
                          for name, (t, c) in b["top"]))
    log("lm", f"phase 14 in {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# phases 15 and 16: the vlm family (llava-next) and the moe family
# (grok-1, deepseek-v2 with MLA) (ROADMAP A12 parts 3 and 4)
# --------------------------------------------------------------------------

# the reference's records (tests/torch_golden.py lm-families, vlm-full)
# and their limits, relative unless named: at reduced width in f32 the
# round's losses and consensus, and θ at the record's picks (absolute),
# v's survivors a leaf exact. Readings of the first card run (the port on
# the CPU reads at most 5.4e-7 and 1.2e-7): losses and consensus within
# 1e-7 of the CPU port's, θ up to 1.03e-4 (llava's final norm scale; the
# MoE archs 2.1e-5): the card sums each gradient in another order, and
# the step η·data_scale = 6e-3 carries it. At full width the nodes' NLL of
# the init and the gradient over img_proj and the first layer (each leaf's
# 16 largest |g| over its largest, its norm), where a bf16-compute control
# must fail each limit
FAMILY_TOL = dict(loss=1e-5, consensus=1e-5, value=5e-4)
# the kernels of these K=2 rounds: a ring of two mixes with one dense
# einsum, not gossip_mix
FAMILY_LAUNCHED = ("topk_select", "unpack_set", "fused_update", "threefry")
VLM_NLL_RTOL, VLM_GRAD_TOL = 4e-6, 1e-4
# phase 15 (c)'s decode: layers of the 32 an M=2 bank holds on one card
# beside the run's other tables, slots, new tokens
VLM_DECODE_LAYERS, FAMILY_SLOTS, FAMILY_NEW = 8, 8, 8
# the full-width engines' cache length; grok-1's slots (phase 16 (c))
FAMILY_MAX_LEN, GROK_SLOTS = 32, 4
# phase 16 (b): deepseek-v2 at full width, one layer; the tokens of its
# decode = forward check
MOE_DECODE_LAYERS, MOE_CHECK_TOKENS = 1, 6
# and its forward against the reference's record (tests/torch_golden.py
# moe-full): the top logits over the largest |logit|, the NLL and the aux
# term relative, where a bf16-compute control must fail the first two
MOE_REC_TOL = dict(logits=1e-4, nll=4e-6, aux=1e-5)


def family_record() -> dict:
    rec = json.loads(LM_FAMILIES_FILE.read_text())
    if rec["config"] != LM_FAMILY_CONFIG or rec["decode"] != \
            LM_FAMILY_DECODE:
        raise AssertionError(f"{LM_FAMILIES_FILE.name} ran {rec['config']}")
    return rec


def family_trainer(cfg, pools, engine: str, **kw):
    from repro_torch.train import FedTrainer
    c = LM_FAMILY_CONFIG
    fed = FedConfig(rounds=c["rounds"], **c["fed"])
    return FedTrainer(get_model(cfg), fed, pools, minibatch=c["minibatch"],
                      seed=c["seed"], engine=engine, chunk=c["rounds"],
                      bank_capacity=1, device=DEVICE, **kw)


def check_family_run(name: str, want: dict, runs=LM_FAMILY_RUNS) -> dict:
    """A reduced-width run of the record (``runs[name]``) on the
    card, f32: the host engine's losses, consensus, bytes and θ against
    the record; the scan engine (one chunk, a CUDA graph) bit for bit to
    the host engine; the round's kernels launched. Returns the readings."""
    from repro_torch.config import MoEConfig
    from repro_torch.data.synthetic_lm import markov_tokens
    run, c = runs[name], LM_FAMILY_CONFIG
    cfg = family_cfg(get_arch, MoEConfig, run["arch"], run["impl"],
                     c["dtype"])
    pools = family_pools(cfg, markov_tokens, c["fed"]["num_nodes"], c["pool"],
                         c["seq"], c["seed"])
    host = family_trainer(cfg, pools, "host")
    eng, losses = host._engine, []
    round_fn = eng.round_fn

    def hooked(state, batches, key, draws=None):
        out = round_fn(state, batches, key, draws)
        losses.append(out[1].loss.double().cpu().numpy())
        return out
    hooked.draws = round_fn.draws
    eng.round_fn = hooked
    kernels.reset_launch_counts()
    res = host.run(rounds=c["rounds"])
    launches = kernels.launch_counts()
    check_launched(f"{name} host run", launches, FAMILY_LAUNCHED)
    if res.wire_history != want["wire_bytes"]:
        raise AssertionError(f"{name}: bytes {res.wire_history} != "
                             f"{want['wire_bytes']}")
    value, at = max((leaf_reading(x, want["theta"][record_key(p)])[0], p)
                    for p, x in tree_leaves_with_path(host.state.params))
    got = dict(
        loss=max(float(np.abs(l / np.asarray(w) - 1).max())
                 for l, w in zip(losses, want["loss"])),
        consensus=max(abs(g / w - 1) for g, w in zip(
            res.consensus_history, want["consensus"])),
        value=value)
    survivors = {record_key(p): int(torch.count_nonzero(x))
                 for p, x in tree_leaves_with_path(host.state.v)}
    if survivors != want["v_survivors"]:
        raise AssertionError(f"{name}: v's survivors {survivors} against the "
                             f"record's {want['v_survivors']}")
    over = {k: v for k, v in got.items() if not v <= FAMILY_TOL[k]}
    if over:
        raise AssertionError(f"{name}: {over} over {FAMILY_TOL} against the "
                             f"reference's record (θ at {at})")
    hstate = lm_state_of(host)
    scan = family_trainer(cfg, pools, "scan")
    sres = scan.run(rounds=c["rounds"])
    same_lm_state(f"{name} scan against host", scan.state, hstate)
    if sres.loss_history != res.loss_history:
        raise AssertionError(f"{name}: scan losses differ from the host's")
    wall, busy, _, _ = time_replay(scan._engine, c["rounds"], c["rounds"])
    log("family", f"{name} ({cfg.name}, f32, K={c['fed']['num_nodes']}, "
                  f"L={c['fed']['local_steps']}; {card_line()}): bytes and "
                  f"v's survivors exact, readings "
                  f"{ {k: float(f'{v:.3g}') for k, v in got.items()} } "
                  f"(limits {FAMILY_TOL}); scan engine bit for bit; a "
                  f"replayed chunk of {c['rounds']}: {wall:.3f} ms a round "
                  f"wall, {busy:.3f} ms on the device; launches "
                  f"{ {k: v for k, v in launches.items() if v} }")
    return dict(got, launches=launches, replay_ms=busy)


def check_family_decode(name: str, want: dict, runs=LM_FAMILY_RUNS) -> dict:
    """The port's DecodeEngine (its ``impl``) on the record's bank and
    requests at reduced width, f32: tokens equal to the reference
    engine's, entropies within rtol 1e-4."""
    from repro_torch.config import MoEConfig
    run, c, d = runs[name], LM_FAMILY_CONFIG, LM_FAMILY_DECODE
    cfg = family_cfg(get_arch, MoEConfig, run["arch"], run["impl"],
                     c["dtype"])
    model = get_model(cfg)
    key = random.PRNGKey(0, DEVICE)
    bank = tree_map(lambda *xs: torch.stack(xs), *[
        model.init(random.fold_in(key, i), DEVICE)
        for i in range(d["samples"])])
    kernels.reset_launch_counts()
    eng = DecodeEngine(model, ServeConfig(slots=d["slots"],
                                          max_len=d["max_len"],
                                          max_new_tokens=d["new_tokens"]),
                       stacked=bank)
    resps = eng.run([ServeRequest(prompt_token=t, seed=s) for t, s in
                     decode_requests(cfg.vocab_size, d["requests"], 0)])
    launches = kernels.launch_counts()
    worst = 0.0
    for r, w in zip(sorted(resps, key=lambda r: r.request_id),
                    want["decode"]):
        if r.tokens.tolist() != w["tokens"]:
            raise AssertionError(f"{name} decode: tokens {r.tokens.tolist()}"
                                 f" != the reference's {w['tokens']}")
        worst = max(worst, float(np.abs(np.asarray(r.token_entropy)
                                        / np.asarray(w["entropy"]) - 1)
                                 .max()))
    if worst > 1e-4 or eng.compile_count() != 1:
        raise AssertionError(f"{name} decode: entropies {worst:.3g} off, "
                             f"{eng.compile_count()} captures")
    check_launched(f"{name} decode", launches, ("bma_sample",) + (
        ("decode_attention",) if attends(cfg) else ()))
    log("family", f"{name} decode ({d['samples']} samples, {d['slots']} "
                  f"slots, {d['requests']} requests): tokens the reference "
                  f"engine's, entropies within {worst:.3g}; one capture; "
                  f"launches { {k: v for k, v in launches.items() if v} }")
    return launches


def attends(cfg) -> bool:
    """Whether the model's decode runs decode_attention: every LM but the
    MLA archs (their own latent decode) and xLSTM (no attention)."""
    return not cfg.kv_lora_rank and cfg.family != "ssm"


def full_bank(model, samples: int, cast=None):
    """A bank of ``samples`` inits from fold_in(PRNGKey(0), i), leaf by
    leaf into a stacked tree (f32, or ``cast`` but for the leaves a served
    bank keeps in f32, ``model.f32_leaf``)."""
    key = random.PRNGKey(0, DEVICE)
    bank = None
    for i in range(samples):
        one = model.init(random.fold_in(key, i), DEVICE)
        if bank is None:
            bank = tree_map_with_path(lambda p, x: torch.empty(
                (samples,) + x.shape, device=DEVICE,
                dtype=x.dtype if cast is None or model.f32_leaf(p)
                else cast), one)
        for b, x in zip(tree_leaves(bank), tree_leaves(one)):
            b[i].copy_(x)
        del one
        torch.cuda.empty_cache()
    return bank


def run_family_decode_full(cfg, label: str, samples: int = 2,
                           slots: int = FAMILY_SLOTS) -> dict:
    """DecodeEngine at full width in bf16: ``samples`` inits, ``slots``
    slots, FAMILY_NEW new tokens over 2·slots requests; one capture, every
    entropy finite; a replayed step's device ms."""
    model = get_model(cfg.replace(dtype="bfloat16"))
    bank = full_bank(model, samples, torch.bfloat16)
    n = tree_count(tree_map(lambda x: x[0], bank))
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    eng = DecodeEngine(model, ServeConfig(slots=slots, max_len=FAMILY_MAX_LEN,
                                          max_new_tokens=FAMILY_NEW),
                       stacked=bank)
    del bank
    gc.collect()
    torch.cuda.empty_cache()
    reqs = [ServeRequest(prompt_token=t, seed=s) for t, s in
            decode_requests(cfg.vocab_size, 2 * slots, 0)]
    t0 = time.perf_counter()
    resps = eng.run(reqs)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    ents = np.concatenate([r.token_entropy for r in resps])
    if eng.compile_count() != 1 or not np.isfinite(ents).all() or \
            len(resps) != len(reqs):
        raise AssertionError(f"{label} decode: {eng.compile_count()} "
                             f"captures, entropies {ents}")
    step_ms = device_ms(eng._graph.replay, reps=5, per_rep=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(label, f"DecodeEngine at full width, {cfg.num_layers} layers, bf16: "
               f"{samples} samples of {n:,} parameters, {slots} "
               f"slots, {len(reqs)} requests of {FAMILY_NEW} tokens in "
               f"{wall:.2f} s wall, one capture, entropies finite "
               f"({float(ents.min()):.3f}-{float(ents.max()):.3f}); a "
               f"replayed step {step_ms:.4f} ms on the device (CUDA events, "
               f"median of 5) on {card_line()}; peak allocated {peak:.2f} "
               f"GiB; launches { {k: v for k, v in launches.items() if v} }")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=step_ms)


def vlm_record() -> dict:
    rec = json.loads(VLM_FULL_FILE.read_text())
    if rec["config"] != VLM_FULL_CONFIG:
        raise AssertionError(f"{VLM_FULL_FILE.name} ran {rec['config']}")
    return rec


def vlm_grad_reading(model, params, batch, want) -> tuple:
    """The gradient of node 0's NLL over img_proj and the first layer
    against the record's (``grad_reading``'s measure; the backward inside
    ``f32_sums``, as the round takes it)."""
    from repro_torch.core import algorithms as alg
    paths = [p for p, _ in tree_leaves_with_path(params)]
    _, grads = alg._value_and_grad(model.nll, paths, tree_leaves(params),
                                   batch, 0.0, 1.0)
    worst, where = 0.0, ""
    for path, g in zip(paths, grads):
        key = path.replace(".", "/")
        if key not in want:
            continue
        w = want[key]
        flat = (g[0] if key == "embed/img_proj" else g[0, 0]).reshape(-1)
        got = flat[torch.tensor(w["idx"], device=flat.device)].double()
        err = max(float(np.abs(got.cpu().numpy() - np.asarray(w["values"]))
                        .max()) / w["absmax"],
                  abs(float(flat.double().norm()) / w["norm"] - 1))
        if err > worst:
            worst, where = err, path
    return worst, where


@permissive_matmuls()
def run_phase15() -> dict:
    """Phase 15: llava-next. (a) the reduced record's rounds; (b) full
    width at 2 layers against the reference's record: init bit for bit,
    wire bytes exact, each node's NLL and the gradient over img_proj and
    the first layer with a bf16 control that must fail their limits, then
    one f32 round; (c) two bf16 rounds at full width, one layer, L=1, on
    both engines, bit for bit; (d) DecodeEngine text-only at full width on VLM_DECODE_LAYERS
    layers. Returns the launches of (c)'s host run and (d)."""
    from repro_torch.data.synthetic_lm import markov_tokens
    from repro_torch.train import FedTrainer
    gc.collect()
    torch.cuda.empty_cache()
    log("vlm", f"on {card_line()}; {torch.cuda.memory_allocated() / 2**30:.2f}"
               f" GiB allocated at the phase's start")
    frec = family_record()
    check_family_run("llava", frec["runs"]["llava"])
    rec = vlm_record()
    c = rec["config"]
    cfg = get_arch(c["arch"]).config.replace(num_layers=c["num_layers"],
                                             dtype=c["dtype"])
    pools = family_pools(cfg, markov_tokens, c["nodes"], c["pool"], c["seq"],
                         c["seed"])
    t0 = time.perf_counter()
    model, control = get_model(cfg), get_model(cfg.replace(dtype="bfloat16"))
    fed = FedConfig(rounds=1, burn_in=0, local_steps=2, **c["fed"])
    trainer = FedTrainer(model, fed, pools, minibatch=1, seed=c["seed"],
                         engine="host", bank_capacity=1, device=DEVICE)
    for path, x in tree_leaves_with_path(trainer.state.params):
        err, _, bits = leaf_reading(x[0], rec["init"][path.replace(".", "/")])
        if err != 0 or not bits:
            raise AssertionError(f"(b) init of {path} is not the reference's")
    params = tree_map(lambda x: x[:1], trainer.state.params)
    params = tree_map(lambda x: x.expand((c["nodes"],) + x.shape[1:]),
                      params)
    batch = {k: torch.from_numpy(np.stack([p[k][0] for p in pools])[:, None]
                                 ).to(DEVICE) for k in pools[0]}
    readings = {}
    for name, m in (("f32", model), ("bf16 control", control)):
        with torch.no_grad():
            got = m.nll(params, batch).double().cpu().numpy()
        nll = float(np.abs(got / np.asarray(rec["nll"]) - 1).max())
        one = {k: v[:1] for k, v in batch.items()}
        grad, at = vlm_grad_reading(m, tree_map(lambda x: x[:1], params),
                                    one, rec["grad"])
        readings[name] = (nll, grad, at)
        gc.collect()
        torch.cuda.empty_cache()
    (nll, grad, at), (cnll, cgrad, _) = readings["f32"], \
        readings["bf16 control"]
    if not (nll <= VLM_NLL_RTOL < cnll and grad <= VLM_GRAD_TOL < cgrad):
        raise AssertionError(f"(b) {readings} against the limits "
                             f"{VLM_NLL_RTOL}, {VLM_GRAD_TOL}")
    del params
    res = trainer.run(rounds=1)
    if res.wire_history != [rec["wire_bytes"]] or not all(
            math.isfinite(x) for x in res.loss_history):
        raise AssertionError(f"(b) round: {res.wire_history} "
                             f"{res.loss_history}")
    n = tree_count(tree_map(lambda x: x[0], trainer.state.params))
    log("vlm", f"(b) {cfg.name} at full width, {c['cuts']}: {n:,} "
               f"parameters a node, {cfg.num_image_patches} patches and "
               f"{c['seq']} tokens a sequence; init bit for bit, wire bytes "
               f"{rec['wire_bytes']:,.0f} exact; the nodes' NLL "
               f"{rec['nll']} within {nll:.3g} (limit {VLM_NLL_RTOL}; bf16 "
               f"control {cnll:.3g}); the gradient over img_proj and the "
               f"first layer within {grad:.3g} ({at}; limit {VLM_GRAD_TOL}; "
               f"bf16 control {cgrad:.3g}); one f32 round (K=2, L=2): loss "
               f"{res.loss_history}, {res.round_ms[0]:.1f} ms; "
               f"{time.perf_counter() - t0:.1f} s")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    # the scan engine holds its chunk's scratch state and its graph's pool
    # beside the trainer's: at 2 layers (715 M parameters a node) it
    # outgrows the card; at one (497 M), L=2 and chunks of 2 it peaked at
    # 68 GiB alone and outgrew the card after the earlier phases: one
    # layer, L=1, chunks of one round
    bcfg = cfg.replace(dtype="bfloat16", num_layers=1)
    runs = {}
    for engine in ("host", "scan"):
        torch.cuda.reset_peak_memory_stats()
        tr = FedTrainer(get_model(bcfg), FedConfig(rounds=2, burn_in=0,
                                                   local_steps=1,
                                                   **c["fed"]),
                        pools, minibatch=1, seed=c["seed"], engine=engine,
                        chunk=1, bank_capacity=1, device=DEVICE)
        kernels.reset_launch_counts()
        r = tr.run(rounds=2)
        # the host run's state waits on the host: the scan trainer's
        # state and its chunk's scratch fill the card
        runs[engine] = ({k: [x.cpu() for x in v]
                         for k, v in lm_state_of(tr).items()}, r,
                        kernels.launch_counts(),
                        torch.cuda.max_memory_allocated() / 2**30)
        if engine == "scan":
            wall, busy, _, _ = time_replay(tr._engine, 2, 1)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    hstate, hres, hl, _ = runs["host"]
    sstate, sres, _, peak = runs["scan"]
    for part in ("params", "v", "v_bar"):
        same_tensors(f"(c) scan {part}", sstate[part], hstate[part])
    if sres.loss_history != hres.loss_history:
        raise AssertionError("(c) scan losses differ from the host's")
    check_launched("(c) host run", hl, FAMILY_LAUNCHED)
    log("vlm", f"(c) bf16 at full width, one layer, L=1, 2 rounds (chunks "
               f"of 1): scan engine bit for bit to the host engine; losses "
               f"{hres.loss_history}; a replayed round {busy:.3f} ms on the device ({wall:.3f} ms wall) on "
               f"{card_line()}; peak allocated {peak:.2f} GiB")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    d = run_family_decode_full(
        get_arch(c["arch"]).config.replace(num_layers=VLM_DECODE_LAYERS),
        "vlm")
    check_launched("(d) decode", d["launches"], DECODE_LAUNCHED)
    return dict(round=hl, decode=d["launches"], round_ms=busy,
                step_ms=d["step_ms"])


def moe_record() -> dict:
    rec = json.loads(MOE_FULL_FILE.read_text())
    if rec["config"] != MOE_FULL_CONFIG:
        raise AssertionError(f"{MOE_FULL_FILE.name} ran {rec['config']}")
    return rec


def check_moe_full() -> dict:
    """(b) deepseek-v2 at full width, one layer, f32, against the
    reference's record (MOE_FULL_FILE): the bank of one init bit for bit;
    the forward of the record's sequence (ragged dispatch): each
    position's top logits, the NLL and the aux term within MOE_REC_TOL,
    where a bf16-compute control on the same weights must fail the logits'
    and the NLL's limits; DecodeEngine on the bank (M=1, the record's
    slots and requests): tokens equal the reference engine's at every step
    above the margin, entropies within rtol (compare_decode), one capture;
    and the decode of MOE_CHECK_TOKENS tokens equal to the forward's
    logits. Returns the readings and the engine's launches."""
    rec = moe_record()
    c, d = rec["config"], rec["config"]["decode"]
    cfg = get_arch(c["arch"]).config.replace(num_layers=c["num_layers"],
                                             dtype=c["dtype"])
    t0 = time.perf_counter()
    model = get_model(cfg)
    bank = full_bank(model, d["samples"])
    check_init("(b) deepseek-v2", bank, rec["init"])
    readings = {name: forward_reading(m, bank, rec["forward"]) for
                name, m in (("f32", model), ("bf16 control", get_model(
                    cfg.replace(dtype="bfloat16"))))}
    got, control = readings["f32"], readings["bf16 control"]
    if not (all(got[k] <= MOE_REC_TOL[k] for k in MOE_REC_TOL) and
            all(control[k] > MOE_REC_TOL[k] for k in ("logits", "nll"))):
        raise AssertionError(f"(b) forward {readings} against the limits "
                             f"{MOE_REC_TOL}")
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    eng = DecodeEngine(model, ServeConfig(
        slots=d["slots"], max_len=d["max_len"],
        max_new_tokens=d["max_new_tokens"]), stacked=bank)
    resps = eng.run([ServeRequest(prompt_token=t, seed=s) for t, s in
                     decode_requests(cfg.vocab_size, d["requests"],
                                     d["seed"])])
    launches = kernels.launch_counts()
    if eng.compile_count() != 1:
        raise AssertionError(f"(b) {eng.compile_count()} captures")
    check_launched("(b) deepseek-v2 f32 decode", launches, ("bma_sample",))
    compare_decode(f"(b) deepseek-v2 at full width, {c['num_layers']} "
                   f"layer, f32, M={d['samples']}, {d['slots']} slots",
                   resps, rec["decode"], "float32")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    dvf = decode_equals_forward(model, bank, MOE_CHECK_TOKENS)
    log("moe", f"(b) deepseek-v2 at full width, {c['cuts']}, f32: "
               f"{tree_count(tree_map(lambda x: x[0], bank)):,} parameters, "
               f"init bit for bit the reference's; the forward of "
               f"{len(rec['forward']['tokens'])} tokens (ragged dispatch) "
               f"within {fmt_readings(got)} of the record (limits "
               f"{MOE_REC_TOL}; bf16 control {fmt_readings(control)}); "
               f"DecodeEngine one capture, launches "
               f"{ {k: v for k, v in launches.items() if v} }; "
               f"{MOE_CHECK_TOKENS} absorbed-MLA decode steps through f32 "
               f"latent caches equal the forward's logits within {dvf:.3g} "
               f"(atol 2e-3); {time.perf_counter() - t0:.1f} s")
    del bank
    gc.collect()
    torch.cuda.empty_cache()
    return dict(readings, decode_vs_forward=dvf, launches=launches)


def fmt_readings(r: dict) -> str:
    return str({k: float(f"{v:.3g}") for k, v in r.items()})


def probe_grouped_mm() -> dict:
    """(d) The library's grouped product as the ragged dispatch would call
    it: ``torch.nn.functional.grouped_mm`` of a (token, slot) copy a row,
    sorted by expert, against deepseek-v2's 160 gate matrices of 5120 x
    1536, the experts' offsets a cumsum of ``scatter_add_`` counts on the
    device (no host read); at 96 copies (the M=2, 8-slot decode step's)
    and 4096, in bf16 and f32: its device ms beside the gathered batched
    product's (the port's route), the error against it in f32 (96
    copies), whether it captures in a CUDA graph and whether it has a
    backward. A record of what the library offers on this card; the
    dispatch does not use it (PERF.md §5)."""
    e, d, f = 160, 5120, 1536
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for n in (96, 4096):
            gen = torch.Generator(device=DEVICE).manual_seed(n)
            w = (torch.randn((e, d, f), generator=gen, device=DEVICE)
                 * 0.02).to(dtype)
            x = torch.randn((n, d), generator=gen, device=DEVICE).to(dtype)
            ex = torch.sort(torch.randint(0, e, (n,), generator=gen,
                                          device=DEVICE), stable=True)[0]
            counts = torch.zeros(e, dtype=torch.int32, device=DEVICE)
            counts.scatter_add_(0, ex, torch.ones_like(ex, dtype=torch.int32))
            offs = torch.cumsum(counts, 0, dtype=torch.int32)
            grouped = lambda: torch.nn.functional.grouped_mm(  # noqa: E731
                x, w, offs=offs)
            r = {}
            try:
                got = grouped()
                r["ms"] = device_ms(grouped, per_rep=2)
            except RuntimeError as err:
                r["forward"] = str(err).splitlines()[0][:120]
                out[(str(dtype), n)] = r
                continue
            if n <= 96:
                gathered = lambda: torch.bmm(x[:, None], w[ex])  # noqa
                want = torch.bmm(x[:, None].float(), w[ex].float())[:, 0]
                r["err"] = float((got.float() - want).abs().max()
                                 / want.abs().max())
                r["gathered_ms"] = device_ms(gathered, per_rep=2)
            try:
                s = torch.cuda.Stream()
                s.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(s):
                    grouped()
                torch.cuda.current_stream().wait_stream(s)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    cap = grouped()
                graph.replay()
                r["captures"] = bool(torch.equal(cap, got))
            except RuntimeError as err:
                r["captures"] = str(err).splitlines()[0][:120]
            torch.cuda.synchronize()
            xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
            step = lambda: torch.autograd.grad(  # noqa: E731
                torch.nn.functional.grouped_mm(xr, wr, offs=offs).float()
                .sum(), (xr, wr))
            try:
                step()
                r["backward_ms"] = device_ms(step, reps=3, per_rep=1)
            except RuntimeError as err:
                r["backward"] = str(err).splitlines()[0][:120]
            out[(str(dtype), n)] = r
            del w, x, xr, wr
            gc.collect()
            torch.cuda.empty_cache()
    for (dt, n), r in out.items():
        log("moe", f"(d) grouped_mm, {n} copies over {e} experts of {d} x "
                   f"{f}, {dt}: " + "; ".join(
                       f"{k} {v:.4g}" if isinstance(v, float) else
                       f"{k}: {v}" for k, v in r.items())
            + f" (device ms by CUDA events; {card_line()})")
    return out


@permissive_matmuls()
def run_phase16() -> dict:
    """Phase 16: the moe family. (a) the reduced records' rounds (grok-1
    ragged, deepseek-v2 gshard and ragged) and decode engines; (b)
    deepseek-v2 at full width against the reference's record
    (check_moe_full), then DecodeEngine M=2 in bf16, timed; (c) grok-1's
    GQA decode at full width, one layer; (d) the grouped_mm probe. A round
    at full width does not fit one card (ROADMAP A10). Returns the
    readings."""
    log("moe", f"on {card_line()}")
    rec = family_record()
    out = {}
    for name in ("grok_ragged", "deepseek_gshard", "deepseek_ragged"):
        out[name] = check_family_run(name, rec["runs"][name])
    for name in ("grok_ragged", "deepseek_ragged"):
        out[f"{name} decode"] = check_family_decode(name, rec["runs"][name])
    out["deepseek_full"] = check_moe_full()
    d = run_family_decode_full(get_arch("deepseek-v2-236b").config.replace(
        num_layers=MOE_DECODE_LAYERS), "moe")
    check_launched("(b) deepseek-v2 decode", d["launches"], ("bma_sample",))
    # grok-1's one layer is 6.5 B parameters (13 GB a sample in bf16) and
    # each token copy gathers its experts' 1.2 GB: one sample, 4 slots
    g = run_family_decode_full(get_arch("grok-1-314b").config.replace(
        num_layers=1), "moe", samples=1, slots=GROK_SLOTS)
    check_launched("(c) grok-1 decode", g["launches"], DECODE_LAUNCHED)
    out.update(deepseek_step_ms=d["step_ms"], grok_step_ms=g["step_ms"],
               decode=g["launches"], grouped_mm=probe_grouped_mm())
    return out


# --------------------------------------------------------------------------
# phases 17-19: the hybrid (recurrentgemma-9b), ssm (xlstm-1.3b) and audio
# (whisper-tiny) families (ROADMAP A12 parts 5-7)
# --------------------------------------------------------------------------

# the full-width forwards against the reference's records (tests/
# torch_golden.py hybrid-full, ssm-full, audio): each position's top
# logits over the largest |logit| (whisper: the encoder's output at the
# record's picks) and the NLL, relative, where a bf16-compute control must
# fail both. xlstm's 48 layers of exponential gating carry f32 summation
# differences furthest: an NVIDIA H100 80GB HBM3 at 700 W read logits
# 4.4e-4 and NLL 1.2e-5 (the bf16 control 0.83 and 1.9e-2). RG-LRU's a_param comes from XLA's expm1, which is not
# correctly rounded where the port's is: within A_PARAM_RTOL of the
# record's (2 f32 ulps at its magnitudes), every other leaf bit for bit
REC_TOL = {"hybrid": dict(logits=1e-4, nll=1e-5),
           "ssm": dict(logits=1e-3, nll=5e-5),
           "audio": dict(logits=1e-4, nll=1e-5)}
A_PARAM_RTOL = 2.5e-7
# decode = forward through f32 caches and states (the reference's own check
# of its zoo), tokens
CHECK_TOKENS = 6
# phase 17 (c): the round of one (rec, rec, local_attn) group at full layer
# width, S = 1,024 so that chunked_lru and chunked_gqa run, K = 1, L = 1,
# the vocabulary cut (the embedding and head are 2.1 B parameters at
# 256,000: a round of the group at full vocabulary holds ~110 GB); (d) the
# layers an M=2 bf16 bank holds beside its copy in the engine
ROUND_SEQ = 1024
RG_ROUND_LAYERS, RG_ROUND_VOCAB, RG_DECODE_LAYERS = 3, 8192, 18
# phase 18 (c): one group of xlstm-1.3b (7 mLSTM + 1 sLSTM, 378 M
# parameters), K = 2
XLSTM_ROUND_LAYERS = 8
# the rounds' kernels (K = 1 mixes nothing: no gossip)
ROUND_LAUNCHED = ("topk_select", "unpack_set", "fused_update", "threefry")


def recurrent_record() -> dict:
    rec = json.loads(RECURRENT_FAMILIES_FILE.read_text())
    if rec["config"] != LM_FAMILY_CONFIG or rec["decode"] != \
            LM_FAMILY_DECODE:
        raise AssertionError(f"{RECURRENT_FAMILIES_FILE.name} ran "
                             f"{rec['config']}")
    return rec


def full_record(path, config) -> dict:
    rec = json.loads(path.read_text())
    if rec["config"] != config:
        raise AssertionError(f"{path.name} ran {rec['config']}")
    return rec


def record_key(path: str) -> str:
    """A port leaf path as the records name it (a list index "[i]")."""
    return "/".join(f"[{p}]" if p.isdigit() else p for p in path.split("."))


def check_init(label: str, bank, want: dict) -> None:
    """Sample 0 of ``bank`` against the record's init: every leaf bit for
    bit, a_param within A_PARAM_RTOL."""
    for path, x in tree_leaves_with_path(bank):
        w = want[record_key(path)]
        err, _, bits = leaf_reading(x[0], w)
        if path.endswith("a_param"):
            if err > A_PARAM_RTOL * max(abs(v) for v in w["values"]):
                raise AssertionError(f"{label}: a_param {err:.3g} off")
        elif err != 0 or not bits:
            raise AssertionError(f"{label}: init of {path} is not the "
                                 f"reference's")


def forward_reading(model, bank, fwd) -> dict:
    """The forward of the record's sequence against the record's: each
    position's top logits over the largest |logit|, the NLL and, where the
    record has one (the MoE archs), the aux term, relative."""
    toks = torch.tensor([fwd["tokens"]], device=DEVICE)
    with torch.no_grad():
        lg = model.logits(bank, {"tokens": toks})[0, 0].float()
        got = lg.gather(1, torch.tensor(fwd["top_idx"], device=DEVICE))
        del lg
        _, parts = model.loss(bank, {"tokens": toks})
    out = dict(logits=float(np.abs(got.double().cpu().numpy()
                                   - np.asarray(fwd["top_logits"])).max())
               / fwd["absmax"],
               nll=abs(float(parts["nll"][0]) / fwd["nll"] - 1))
    if "aux" in fwd:
        out["aux"] = abs(float(parts["aux"][0]) / fwd["aux"] - 1)
    return out


def decode_equals_forward(model, params, n: int = CHECK_TOKENS) -> float:
    """``n`` decode steps through f32 caches and states against the
    forward's logits of the same tokens (atol 2e-3, the reference's own
    check of its zoo). Returns the largest difference."""
    toks = torch.from_numpy(np.asarray(decode_requests(
        model.cfg.vocab_size, n, 0))[:, 0].reshape(1, -1)).to(DEVICE)
    with torch.no_grad():
        fwd = model.logits(params, {"tokens": toks})[0, 0]
        cache = model.init_decode_state(1, n, dtype_kv=torch.float32,
                                        device=DEVICE)
        worst = 0.0
        for pos in range(n):
            cache, lg = model.decode_step(params, cache, toks[:, pos],
                                          torch.full((1,), pos,
                                                     device=DEVICE))
            worst = max(worst, float((lg[0, 0, 0] - fwd[pos]).abs().max()))
    if worst > 2e-3:
        raise AssertionError(f"{model.cfg.name}: decode off its forward by "
                             f"{worst:.3g}")
    return worst


def check_full_forward(label: str, path, config) -> dict:
    """A full-width model against the reference's record, f32: the bank of
    one init (fold_in(PRNGKey(0), 0)) against the record's init; the
    forward of its sequence within REC_TOL, a bf16-compute control failing
    both limits; where the record has one, DecodeEngine M=1 on the bank
    (the record's slots and requests): tokens equal to the reference
    engine's at every step above the margin (compare_decode), one capture;
    and decode = forward through f32 caches. Returns the readings."""
    rec = full_record(path, config)
    c = rec["config"]
    cfg = get_arch(c["arch"]).config.replace(
        dtype=c["dtype"], num_layers=c.get(
            "num_layers", get_arch(c["arch"]).config.num_layers))
    t0 = time.perf_counter()
    model = get_model(cfg)
    bank = full_bank(model, 1)
    check_init(label, bank, rec["init"])
    readings = {name: forward_reading(m, bank, rec["forward"]) for
                name, m in (("f32", model), ("bf16 control", get_model(
                    cfg.replace(dtype="bfloat16"))))}
    got, control = readings["f32"], readings["bf16 control"]
    tol = REC_TOL[label]
    if not (all(got[k] <= tol[k] for k in tol) and
            all(control[k] > tol[k] for k in tol)):
        raise AssertionError(f"{label}: forward {readings} against the "
                             f"limits {tol}")
    gc.collect()
    torch.cuda.empty_cache()
    launches = {}
    if "decode" in rec:
        d = c["decode"]
        kernels.reset_launch_counts()
        eng = DecodeEngine(model, ServeConfig(
            slots=d["slots"], max_len=d["max_len"],
            max_new_tokens=d["max_new_tokens"]), stacked=bank)
        resps = eng.run([ServeRequest(prompt_token=t, seed=s) for t, s in
                         decode_requests(cfg.vocab_size, d["requests"],
                                         d["seed"])])
        launches = kernels.launch_counts()
        if eng.compile_count() != 1:
            raise AssertionError(f"{label}: {eng.compile_count()} captures")
        check_launched(f"{label} f32 decode", launches, DECODE_LAUNCHED)
        compare_decode(f"{label}: {cfg.name} at full width, "
                       f"{cfg.num_layers} layers, f32, M=1, {d['slots']} "
                       f"slots", resps, rec["decode"], "float32")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    dvf = decode_equals_forward(model, bank)
    n = tree_count(tree_map(lambda x: x[0], bank))
    log(label, f"{cfg.name} at full width, {cfg.num_layers} layers, f32: "
               f"{n:,} parameters, init the reference's (a_param within "
               f"{A_PARAM_RTOL:g}); the forward of "
               f"{len(rec['forward']['tokens'])} tokens within "
               f"{fmt_readings(got)} of the record (limits {tol}; bf16 "
               f"control {fmt_readings(control)}); {CHECK_TOKENS} decode "
               f"steps through f32 caches and states equal the forward "
               f"within {dvf:.3g} (atol 2e-3); "
               f"{time.perf_counter() - t0:.1f} s")
    del bank
    gc.collect()
    torch.cuda.empty_cache()
    return dict(readings, decode_vs_forward=dvf, launches=launches)


def run_full_round(label: str, cfg, nodes: int, pools=None) -> dict:
    """One f32 round (L=1, batch 1, the default codec on a full graph of
    ``nodes``) on the host engine, then on the scan engine (one chunk, a
    CUDA graph), bit for bit; a replayed round's device ms and each
    engine's peak memory. ``pools``: each node's pool (default: one markov
    sequence of ROUND_SEQ tokens)."""
    from repro_torch.data.synthetic_lm import markov_tokens
    from repro_torch.train import FedTrainer
    if pools is None:
        pools = lm_pools(markov_tokens, nodes, 1, ROUND_SEQ, cfg.vocab_size)
    fed = FedConfig(num_nodes=nodes, local_steps=1, eta=1e-4, zeta=0.3,
                    burn_in=0, rounds=1, topology="full",
                    compressor="block_topk", compress_ratio=0.01)
    runs = {}
    for engine in ("host", "scan"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = FedTrainer(get_model(cfg), fed, pools, minibatch=1, seed=0,
                        engine=engine, chunk=1, bank_capacity=1,
                        device=DEVICE)
        kernels.reset_launch_counts()
        res = tr.run(rounds=1)
        state = {k: [x.cpu() for x in v] for k, v in lm_state_of(tr).items()}
        launches = kernels.launch_counts()
        busy = time_replay(tr._engine, 1, 1)[1] if engine == "scan" else None
        runs[engine] = (state, res, launches,
                        torch.cuda.max_memory_allocated() / 2**30, busy)
        del tr
    (hstate, hres, hl, hpeak, _), (sstate, sres, _, speak, busy) = \
        runs["host"], runs["scan"]
    for part in ("params", "v", "v_bar"):
        same_tensors(f"{label} round, scan {part}", sstate[part],
                     hstate[part])
    if sres.loss_history != hres.loss_history or not all(
            math.isfinite(x) for x in hres.loss_history):
        raise AssertionError(f"{label} round: losses {hres.loss_history} "
                             f"{sres.loss_history}")
    check_launched(f"{label} round", hl, ROUND_LAUNCHED)
    n = sum(x.numel() for x in hstate["params"]) // nodes
    log(label, f"one f32 round of {cfg.name}, {cfg.num_layers} layers at "
               f"full width (vocabulary {cfg.vocab_size:,}), {n:,} "
               f"parameters a node, K={nodes}, L=1, {ROUND_SEQ} tokens: loss "
               f"{hres.loss_history}, scan engine bit for bit the host's; a "
               f"replayed round {busy:.3f} ms on the device (CUDA events) on "
               f"{card_line()}; peak allocated {hpeak:.2f} GiB (host), "
               f"{speak:.2f} GiB (scan); launches "
               f"{ {k: v for k, v in hl.items() if v} }")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=hl, round_ms=busy, peak_gib=max(hpeak, speak))


@permissive_matmuls()
def run_phase17() -> dict:
    """Phase 17: recurrentgemma-9b. (a) the reduced record's rounds and
    decode; (b) one (rec, rec, local_attn) group at full width against
    the reference's record (check_full_forward: init, forward, the
    engine's f32 tokens, decode = forward through f32 caches: the split
    decode_attention on f32 rows of 256); (c) one round of that group at
    S = 1,024 (chunked_lru, chunked_gqa), scan = host; (d) DecodeEngine
    M=2 in bf16 on RG_DECODE_LAYERS layers, timed. Returns the readings."""
    gc.collect()
    torch.cuda.empty_cache()
    log("hybrid", f"on {card_line()}")
    frec = recurrent_record()["runs"]["recurrentgemma"]
    out = {"reduced": check_family_run("recurrentgemma", frec,
                                       RECURRENT_FAMILY_RUNS),
           "reduced_decode": check_family_decode("recurrentgemma", frec,
                                                 RECURRENT_FAMILY_RUNS),
           "full": check_full_forward("hybrid", HYBRID_FULL_FILE,
                                      HYBRID_FULL_CONFIG)}
    rg = get_arch("recurrentgemma-9b").config
    out["round"] = run_full_round("hybrid", rg.replace(
        num_layers=RG_ROUND_LAYERS, vocab_size=RG_ROUND_VOCAB,
        dtype="float32"), 1)
    d = run_family_decode_full(rg.replace(num_layers=RG_DECODE_LAYERS),
                               "hybrid")
    check_launched("(d) recurrentgemma decode", d["launches"],
                   DECODE_LAUNCHED)
    out["decode"] = d
    return out


@permissive_matmuls()
def run_phase18() -> dict:
    """Phase 18: xlstm-1.3b. (a) the reduced record's rounds and decode;
    (b) full width and full depth against the reference's record (init,
    forward; decode = forward through f32 states); (c) a K=2 round of one
    group (7 mLSTM + 1 sLSTM) at S = 1,024 (chunkwise_mlstm, the sLSTM's
    steps), scan = host; (d) DecodeEngine M=2 in bf16 at full depth,
    timed. Returns the readings."""
    gc.collect()
    torch.cuda.empty_cache()
    log("ssm", f"on {card_line()}")
    frec = recurrent_record()["runs"]["xlstm"]
    out = {"reduced": check_family_run("xlstm", frec, RECURRENT_FAMILY_RUNS),
           "reduced_decode": check_family_decode("xlstm", frec,
                                                 RECURRENT_FAMILY_RUNS),
           "full": check_full_forward("ssm", SSM_FULL_FILE, SSM_FULL_CONFIG)}
    xl = get_arch("xlstm-1.3b").config
    out["round"] = run_full_round("ssm", xl.replace(
        num_layers=XLSTM_ROUND_LAYERS, dtype="float32"), 2)
    d = run_family_decode_full(xl, "ssm")
    check_launched("(d) xlstm decode", d["launches"], ("bma_sample",))
    out["decode"] = d
    return out


@permissive_matmuls()
def run_phase19() -> dict:
    """Phase 19: whisper-tiny. (a) the reduced record's rounds (pools with
    frames) and decode; (b) full width and depth against the reference's
    record (tests/torch_golden.py audio): the init bit for bit, the wire
    bytes exact, each node's NLL of its first sequence (1,500 frames)
    within REC_TOL's, the encoder's output (prefill_encoder) at the
    record's picks, then rounds through FedTrainer on {tokens, frames}
    pools, scan = host; (c) DecodeEngine (M=2, zero encoder output: ROADMAP
    C37) against the reference engine's record above the margin, one
    capture, a replayed step's device ms. Returns the readings."""
    from repro_torch.data.synthetic_lm import markov_tokens
    from repro_torch.train import FedTrainer
    gc.collect()
    torch.cuda.empty_cache()
    log("audio", f"on {card_line()}")
    frec = recurrent_record()["runs"]["whisper"]
    out = {"reduced": check_family_run("whisper", frec,
                                       RECURRENT_FAMILY_RUNS),
           "reduced_decode": check_family_decode("whisper", frec,
                                                 RECURRENT_FAMILY_RUNS)}
    rec = full_record(AUDIO_FILE, AUDIO_CONFIG)
    c, d = rec["config"], rec["config"]["decode"]
    cfg = get_arch(c["arch"]).config.replace(dtype=c["dtype"])
    t0 = time.perf_counter()
    model = get_model(cfg)
    pools = family_pools(cfg, markov_tokens, c["nodes"], c["pool"], c["seq"],
                         c["seed"])
    host = FedTrainer(model, FedConfig(rounds=2, burn_in=0, local_steps=1,
                                       **c["fed"]), pools, minibatch=1,
                      seed=c["seed"], engine="host", bank_capacity=1,
                      device=DEVICE)
    params = host.state.params
    for path, x in tree_leaves_with_path(params):
        err, _, bits = leaf_reading(x[0], rec["init"][record_key(path)])
        if err != 0 or not bits:
            raise AssertionError(f"(b) init of {path} is not the "
                                 f"reference's")
    first = {k: torch.from_numpy(np.stack([p[k][:1] for p in pools])).to(
        DEVICE) for k in pools[0]}
    with torch.no_grad():
        nll = float(np.abs(model.nll(params, first).double().cpu().numpy()
                           / np.asarray(rec["nll"]) - 1).max())
        cache = model.prefill_encoder(
            tree_map(lambda x: x[:1], params),
            model.init_decode_state(1, 8, dtype_kv=torch.float32,
                                    device=DEVICE), first["frames"][0])
    enc, _, _ = leaf_reading(cache["enc_out"][0], rec["enc_out"])
    enc /= max(abs(v) for v in rec["enc_out"]["values"])
    del cache
    tol = REC_TOL["audio"]
    if nll > tol["nll"] or enc > tol["logits"]:
        raise AssertionError(f"(b) whisper NLL {nll:.3g}, encoder output "
                             f"{enc:.3g} against {tol}")
    kernels.reset_launch_counts()
    hres = host.run(rounds=2)
    hl = kernels.launch_counts()
    hstate = lm_state_of(host)
    scan = FedTrainer(model, FedConfig(rounds=2, burn_in=0, local_steps=1,
                                       **c["fed"]), pools, minibatch=1,
                      seed=c["seed"], engine="scan", chunk=2,
                      bank_capacity=1, device=DEVICE)
    sres = scan.run(rounds=2)
    same_lm_state("(b) whisper scan against host", scan.state, hstate)
    if sres.loss_history != hres.loss_history or \
            hres.wire_history != [rec["wire_bytes"]] * 2:
        raise AssertionError(f"(b) whisper rounds: {hres.loss_history} "
                             f"{sres.loss_history} {hres.wire_history}")
    check_launched("(b) whisper rounds", hl, FAMILY_LAUNCHED)
    busy = time_replay(scan._engine, 2, 2)[1]
    log("audio", f"(b) {cfg.name} at full width: {cfg.encoder_seq_len} "
                 f"frames, {c['seq']} tokens; init bit for bit, each node's "
                 f"NLL within {nll:.3g} and the encoder's output within "
                 f"{enc:.3g} of the record (limits {tol}); two f32 "
                 f"rounds (K={c['nodes']}, L=1) on {{tokens, frames}} pools, "
                 f"wire bytes {rec['wire_bytes']:,.0f} exact, scan = host "
                 f"bit for bit, a replayed round {busy:.3f} ms on the device "
                 f"({card_line()}); {time.perf_counter() - t0:.1f} s")
    del host, scan
    gc.collect()
    torch.cuda.empty_cache()
    bank = full_bank(model, d["samples"])
    kernels.reset_launch_counts()
    eng = DecodeEngine(model, ServeConfig(
        slots=d["slots"], max_len=d["max_len"],
        max_new_tokens=d["max_new_tokens"]), stacked=bank)
    resps = eng.run([ServeRequest(prompt_token=t, seed=s) for t, s in
                     decode_requests(cfg.vocab_size, d["requests"],
                                     d["seed"])])
    launches = kernels.launch_counts()
    if eng.compile_count() != 1 or eng._caches["enc_out"].any():
        raise AssertionError(f"(c) whisper: {eng.compile_count()} captures "
                             f"or an encoder output not zero")
    check_launched("(c) whisper decode", launches, DECODE_LAUNCHED)
    compare_decode(f"(c) whisper-tiny at full width, f32, M={d['samples']}, "
                   f"{d['slots']} slots, zero encoder output (C37)", resps,
                   rec["decode"], "float32")
    step_ms = device_ms(eng._graph.replay, reps=5, per_rep=1)
    log("audio", f"(c) DecodeEngine's replayed step {step_ms:.4f} ms on "
                 f"the device (f32, M={d['samples']}, {d['slots']} slots; "
                 f"{card_line()}); launches "
                 f"{ {k: v for k, v in launches.items() if v} }")
    del eng, bank
    gc.collect()
    torch.cuda.empty_cache()
    out.update(round=hl, round_ms=busy, decode=launches, step_ms=step_ms)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True      # the oracle compares rounds
    torch.backends.cudnn.benchmark = False
    device_name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {device_name}; TF32 "
          f"off for convolutions and matmuls; cuDNN deterministic", flush=True)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log("build", f"{lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas_report(_build.build_log):
        log("build", line)
    print(card_line(), flush=True)

    cfg = lenet_config()
    params = get_model(cfg).init(random.PRNGKey(0, "meta"), "meta")
    shapes = [(p, tuple(x.shape)) for p, x in tree_leaves_with_path(params)]
    log("kernels", f"{cfg.name}: {tree_count(params):,} parameters in "
                   f"{len(shapes)} leaves, K={K} nodes")
    draw_err = check_draws(shapes)
    errs = check_kernels(shapes)
    errs.update(check_default_kernels(shapes))
    errs.update(check_gossip_mix(shapes))
    errs["gilbert_keep"] = check_gilbert()
    check_exp_xla()
    errs["decode_attention"] = check_decode_attention()
    errs["bma_sample"] = check_bma_sample()
    timing = time_kernels(shapes)
    for kname, r in timing.items():
        log("kernels", f"{kname} per round (10 leaves, K={K}): device "
                       f"{fmt_ms(r['device_ms'])}, event-timed "
                       f"{r['ms']:.4f} ms; plain: device "
                       f"{fmt_ms(r['plain_device_ms'])}, event-timed "
                       f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
                       f"({r['bound_by']}: {r['nbytes']:.0f} B, "
                       f"{r['ops']:.0f} ops)")

    t0 = time.perf_counter()
    train = make_dataset(K * 50, hw=cfg.input_hw, day=1, seed=0)
    test = make_dataset(200, hw=cfg.input_hw, day=1, seed=99)
    log("slice", f"data: {len(train['y'])} train / {len(test['y'])} test maps "
                 f"at {cfg.input_hw} in {time.perf_counter() - t0:.1f} s")
    trainers, runs, results = {}, {}, {}
    for name in RUNS:
        trainers[name], runs[name], results[name] = run_slice(name, train,
                                                              test)
    timing["threefry"] = time_draws(trainers[PIPE])
    errs["threefry"] = max(draw_err, timing["threefry"]["err"])
    oracles = {name: oracle_round(name, trainers[name])
               for name in ("block_topk", PIPE)}
    check_cpu_decode(trainers[PIPE].compressor, oracles[PIPE][2])
    for name in RUNS:
        run_graph(name, trainers[name], results[name], train, test)
    run_default_chunk(train)
    profile_rounds(trainers, {n: o[1] for n, o in oracles.items()}, timing)

    # phase 7: the paper's default run and its baselines, then the codecs
    timing.update(time_default_kernels(shapes))
    timing.update(time_gossip_mix(shapes))
    timing["gilbert_keep"] = time_gilbert()
    timing.update(time_decode_kernels())
    shift = shift_set(cfg.input_hw)
    default_launches, evals = {}, {}
    for algorithm in DEFAULT_RUNS:
        default_launches[algorithm], evals[algorithm] = run_default(
            algorithm, train, test, shift)
    for name in CODEC_ROUNDS:
        run_codec_round(name, train)
    run_serve(train, test, shift)
    train_launches = run_train(train)
    link_launches = run_link(train)
    bf16_errs, bf16_timing, bf16_launches = run_phase11(shapes, timing,
                                                        train, test, evals)
    errs.update(bf16_errs)
    timing.update(bf16_timing)
    run_phase12(train, test, shift)
    decode_launches = run_phase13()
    run_phase14()
    run_phase15()
    run_phase16()
    run_phase17()
    run_phase18()
    run_phase19()
    log("default", "accuracy / ECE, day-1 test maps and days-2/3 shift set: "
                   + "; ".join(f"{a}: {e['accuracy']:.4f} / {e['ece']:.4f}, "
                               f"{e['shift_accuracy']:.4f} / "
                               f"{e['shift_ece']:.4f}"
                               for a, e in evals.items()))

    # each kernel's launches in the run of the path that reaches it
    launches = dict(runs["block_topk"], pack=oracles["block_topk"][0]["pack"],
                    grid_quant=runs[PIPE]["grid_quant"],
                    qsgd=runs["qsgd_pallas"]["qsgd"],
                    block_topk=runs["block_topk_pallas"]["block_topk"],
                    topk_select=default_launches["cdbfl"]["topk_select"],
                    unpack_set=default_launches["cdbfl"]["unpack_set"],
                    cffl_update=default_launches["cffl"]["cffl_update"],
                    dsgld_update=default_launches["dsgld"]["dsgld_update"],
                    gossip_mix=train_launches["gossip_mix"],
                    gilbert_keep=link_launches["gilbert_keep"],
                    **bf16_launches, **decode_launches)
    record = {"kernels": [
        {"name": kname, "route": "cuda", "source": KERNELS[kname][0],
         "replaces": KERNELS[kname][1], "launches": launches[kname],
         "max_abs_err": errs[kname], "ms": timing[kname]["device_ms"],
         "plain_ms": timing[kname]["plain_device_ms"],
         "bound_ms": timing[kname]["bound_ms"],
         "bound_by": timing[kname]["bound_by"],
         "library_ms": timing[kname].get("library_ms")}
        for kname in KERNELS]}
    print(card_line())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
