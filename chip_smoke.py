#!/usr/bin/env python3
"""Drive the PyTorch port's search, governance and cascade-verifier paths
once on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; needs one card)
    python3 chip_smoke.py --parent DIR
        (DIR: an unpacked earlier commit of this repository; phase 6 also
        times that tree's flat scans K1 / K4 / K5 and bucket probes K7 / K8
        on the same data, in a process of their own before and after this
        tree's)
    python3 chip_smoke.py --flat-times ROOT
        (only phase 6's flat-scan and bucket-probe timing, of the package
        under ROOT, as one JSON line: what --parent runs)
    python3 chip_smoke.py --siglip [--parent DIR]
        (phases 1-2's build, then only the SigLIP phase: K2 at hd 72, E1
        and K6 at tanh GELU, the so400m/14 tower's batch; with --parent,
        K2 of DIR's tree at the same shape, --k2-times DIR)
    python3 chip_smoke.py --layer-norm
        (phases 1-2's build, then only the LayerNorm phase: E2 at the
        index cells' shapes and each index tower's batch)
    python3 chip_smoke.py --k2-times ROOT
        (K2 at SigLIP's [256, 729, 1152] / 16 of the package under ROOT,
        as one JSON line)
    python3 chip_smoke.py --mesh-worker COORD NPROC PID OUT CENTS
        (one of phase 4i's processes on the card; the phase starts them)

Phases, each printed on its own line; any failure ends the run with a
nonzero exit and no result line:
  1. environment: torch/CUDA versions, the card's name and power limit;
     whether PIL, yaml and regex import here;
  2. build: the CUDA kernels (one nvcc per source, all at once, sm_90a;
     each kernel's registers, shared memory and spills) and the Triton
     kernel, from the sources in mmrs_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version at main-path shapes:
     K1-K3 as before, K4/K5 (int8/int4 top-k over a 1,048,576 x 512
     gallery, ids and values equal), K6 (int8 MLP at the ViT-B/32
     serving shape, nonzero biases and rows of rounding ties, ragged M,
     f32 x, W/H = 512/2048 and 1024/8192, equal in every element), K7/K8 (the
     IVF bucket probes over bf16 / int8 / int4 buckets of a clustered
     1,048,576 x 512 gallery at C = 1024, built on the card: K8 equal,
     K7 values within 1e-5 and ids equal where scores are separated; K8
     also at Q = 1, 8, 9, 64 and k = 1, 10, 33, 300; both on shared lists,
     disjoint lists, a bucket twice in a list and out-of-range ids), K9
     (all-pairs first match over 131,072 x 512 planted rows, f32 and bf16:
     keep-first, cross set, ring halves with row offsets, ragged N, f32
     rows of f16 values and of magnitudes down to 1e-6; every id equal;
     f32 copies NEAR_TAU either side of tau decided as f64 dots decide
     them, where bf16 rows must not); K1/K4/K5 and K7/K8 at k = 300 and 1000 (past one 256-row
     scan chunk) against plain; K2 at the 336-px L/14 tower's [8, 577,
     1024] / 16 heads and at T = 65 and T = 1 (ragged key tiles), and its
     f32 route within 1e-5,
     K6 at its MLP ([4616, 1024] -> 4096, equal in every element); K10 /
     K11 (chunk / decode attention over the KV cache) on layer views of
     stacked 32-layer caches at the LLaVA-v1.5-7B shapes (B=8, 32 kv heads,
     HD 128, 704 slots) and the 1.1B draft's (4 kv heads, G=8, HD 64), bf16
     and int8 caches, scalar and per-row positions with dead tails, K10 at
     C=64 with kv_limit windows and at T=2 / T=5, and at head dims 80 and
     96 (2 layers, 8 kv heads, G=4); K1 / K4 / K5 at the edges of their
     spans (N = R - 1, R, R + 1 and 2R + 17 rows, R = 2048 forced; Q = 8,
     K4 also 1 and 64; k = 10 and 32); the shapes the kernels once refused:
     K2 f32 at [8, 577, 1024] / 16 (1e-5), bf16 at hd 160 and past 65,535
     images, K1 / K4 / K9 at D = 100, 520 and 2304, K10 / K11 at head dims
     100, 288, 576 and 1024 and at B or KVH past 65,535 (`repair_checks`);
     the dense epilogue (`bias_act`) at the towers' [12,800 x 768 / 3,072]
     and [65,792 x 1,024 / 4,096] f32 sums with zeros, ties and exp
     overflows, with and without a bias, with no activation, QuickGELU
     and GELU, every bf16 bit equal; a ViT-B/32 and a ViT-L/14 tower's
     256-image batch with 6 launches a block plus the patch embedding's,
     its embedding equal to the plain ops' in every bit; the towers'
     LayerNorm (E2) at the index cells' [12,800 x 768], [65,792 x 1,024]
     and [186,624 x 1,152] rows (some far from zero mean, outlier gains)
     within one bf16 ulp of its plain ops and missing an f64 LayerNorm no
     more often, timed beside its bound, the plain ops and F.layer_norm,
     and each index tower's batch through build_towers with its E2
     launches, with E2 and with the plain ops;
  4. end to end through the port's public paths at ViT-B/32 width (random
     weights from a seed), each with the kernel launch counts set to 0
     just before it and read just after:
     a. bf16: build_towers -> build_index over 4096 seeded synthetic images
        -> SearchEngine image / prototype / text queries -> sweep_class;
        then a 1,048,576 x 512 gallery queried at Q=8;
     b. quantized: build_towers(dtype int8) -> build_index over the same
        images -> SearchEngine(quantize int8 / int4) image and prototype
        queries (hits equal to the plain top-k) -> sweep_class; then the
        1M gallery behind int8 and int4 engines at Q=8;
     c. IVF: SearchEngine(ann="ivf") over phase 4a's index for bf16, int8
        and int4 buckets, image and prototype (mean, cluster, robust_mean)
        queries (hits = the plain IVF top-k), the saved sidecar loaded by a
        second engine with k-means disabled (same hits), ann_target_recall
        0.95; k = 300 through flat bf16 / int8 / int4 and IVF engines
        (= the plain top-300) and `mmrs-torch search -k 300` on each route
        (300 hits); then the clustered 1M gallery: nprobe = C against flat
        K1 (bf16) and K5 (int4), recall@10 at nprobe = 128, sidecar load;
     d. governance: `mmrs-torch dedup --mode embedding` over a 131,072 x
        512 f16 index of planted rows (DUP lines = the planted pairs = the
        plain report); over phase 4a's index with 64 exact image copies
        appended by update_index (every copy found, = plain); the hash
        modes, leakage, convert, clean, rename, merge and dataset make on
        a small image tree (dry runs), naming the native library that ran;
     e. the LLaVA cascade verifier at LLaVA-v1.5-7B width and depth (random
        weights from the seed, made on the card; 16 synthetic 336-px JPEGs;
        a SentencePiece model built with serialize_model): (1) LLaVAVerifier
        with bf16 weights and the CLI's serving options (prefill chunks of
        64, early stop, 32 new tokens), two packs of 8 through
        CascadePipeline.run_streaming, then the first pack against the
        plain route (K2 / K10 / K11 plain versions): prefill logits within
        PREFILL_LOGIT_TOL, and the plain route fed the kernel route's 32
        tokens a row holding them, at every step, to TOKEN_LIMITS (a gap
        below its best logit, and a floor on the share of steps at which
        it picks the fed token: `token_check`); the per-call checks on the
        7B's own tensors (`held_calls`): K2 at tower blocks 0, 11 and 22
        (K6 equal to plain there too, int8), and in a kernel-route trace
        fed the plain route's tokens K10 at every prefill chunk and K11 at
        decode steps 1, 16 and 31, at decoder layers 0, 15 and 31, each
        against its plain version on the same inputs and cache views
        (KV_ATTN_TOL, 99% within 1e-4);
        (3) speculative decode with a 1.1B draft (k=4): its verdicts =
        (1)'s, and the kernel-route target model fed its tokens holding
        them to TOKEN_LIMITS; (2) quantize_llava weights and the int8 KV
        cache, against its plain route as (1); (4) `mmrs-torch cascade
        --verifier llava --verifier-int8` in process over the JPEG folder,
        from an int8 checkpoint written by the port's save_npz (verdicts =
        run (2)'s). Launch counts are reset before each run;
     f. the bilingual (EN + CN) union path at full width, random weights
        from the seed: HF-layout state dicts written as f16 safetensors
        (CLIP ViT-L/14, the Taiyi RoBERTa-large classifier: 24 layers,
        1024 wide, 768 labels) and an OpenAI ViT-B/32 one, converted by
        `mmrs-torch weights convert`; the CN pair assembled as the JAX
        pipeline loads it; `index build` (CN L/14) over 48 seeded JPEGs in
        two classes, `search --text <Chinese> --vocab`, `union` (EN B/32 +
        CN L/14), launch counts of K1-K3 from this run alone; then the
        plain route on the same weights: index embeddings at cosine >=
        0.999, search ids equal where scores are separated, union
        decisions equal where a score is more than 2e-3 from its
        threshold (about a minute; ~5 GiB under TMPDIR);
     g. adaptation and serving at ViT-B/32 width, random weights from the
        seed: `mmrs-torch adapter train --root` in process over 8 classes
        x 12 seeded JPEGs (4 shots, 5 augment epochs, 20 epochs,
        --search-hp; K2 and K3 must launch), the same tree through the
        plain route (cache keys at cosine >= 0.999), Tip-Adapter-F on the
        card against the CPU on the same features (keys within 1e-4, the
        F1 history equal); 4 contrastive steps at full B/32 vision and
        text width, batch 32, bf16 compute (the loss falls; step 1's loss
        and gradient norm against a CPU f32 run; K2 never launches, and
        refuses inputs that require grad); `make_server` on 127.0.0.1:0
        over phase 4a's index behind bf16, int8, int4 and IVF (nprobe =
        C) engines: three bursts (cold, warm, traced by torch.profiler)
        of 64 concurrent /v1/search requests from 16 clients (text, and
        gallery rows' own pixels, each row in its answer's top 3 but
        behind int4; within 2e-3 of the direct engine query,
        none within it of the next same-kind request's answer; more than
        one query a dispatch), each request alone = the direct query, and
        /v1/verify through a LLaVA verifier at 7B width with 2 decoder
        layers (the servers themselves launch K1-K5, K7, K10 and K11:
        counts reset after each engine's build and read at its server's
        shutdown); streaming_topk over a memmapped 1,048,576 x 512 f16
        file in 2^18-row chunks at prefetch 0 and 2 (ids = flat K1's),
        beside a ring's set-up and the host's copy alone;
     h. the operations layer at ViT-B/32 width and the int4-weight LLaMA
        at LLaMA-2-7B width (random weights from the seed; budget 90 s):
        `mmrs-torch lifecycle` in process (the port's seeded B/32 npz,
        bf16) over a tree of 442 seeded images (4 classes x 96 JPEGs, a
        PNG, a planted copy, 32 easy and 24 hard negatives) and a held-out tree
        with 2 leaked copies: every artifact family, both cross-checks,
        the planted copy and leaks reported, a journal row an image, K2,
        K3 and K9 launched; the same tree through the plain route
        (impl="torch": embeddings at cosine >= 0.999, the same sweep grid,
        gate and union decisions equal where a score is more than 2e-3
        from the thresholds, dedup / leakage reports and VQA files
        equal); `parity --rank-gate` over 1,048,576 x 512 at Q=64 (0
        violations, planted queries exact, K1); `parity --int8-tower
        vit_b32` (K6 and K2; min cosine within 1e-3 of the plain route's,
        top-1 agreement equal); `parity --release` over a written OpenAI
        ViT-B/32 archive with --image (probabilities sum to 1; `ok` false
        on random weights); `plan` residency held to the 1M engines' (2%)
        and IVF indexes' (10%) tensors, the plan at 1M, 10M and 100M;
        quantize_llama_int4 (group 128) on the card, 2 decoder layers +
        lm_head, greedy 32 tokens at B=8 from a 614-token prompt equal to
        the dequantized bf16 oracle's (K10, K11), int8 bytes half of
        quantize_llama's;
     i. the data axis of the mesh (parallel/), on 4 distinct cards where
        the machine has them, else cuda:0 four times (said which), each
        part with the counts reset and every kernel held to S launches a
        call (S a ring step): (1) make_sharded_encoder at ViT-B/32 width,
        bf16 and int8 towers, batch 224 (56 a shard) over 4a's 4096
        images, cosine >= 0.9999 per row to the one-device encode and the
        largest bf16 ulp gap (K2, K3, K6); (2) bf16 / int8 / int4 engines
        on the mesh over 4a's 1M gallery and a 1,048,573-row copy at Q=8
        (bf16 ids where separated by 1e-4, int8 / int4 hits equal to one
        device's), each rung's sharded scan timed at S = 1, 2, 4 on one
        card (eager and card alone) beside the direct kernel; (3) 4c's
        clustered 1M indexes slot-sharded, nprobe 128 and C (values and
        ids against one-device ivf_topk: K7 / K8), build_ivf(mesh=)
        bucket strips = place_ivf(build_ivf())'s; (4) the dedup ring over
        4d's planted rows, f32 and bf16, every id = one-device K9's, ms
        beside it; (5) SearchEngine(mesh=) over 4a's index (top-10 and
        sweep_class = 4a's), streaming_topk(mesh=) over a 1 GiB memmap,
        search_hp(mesh=); (6) two processes on the card (gloo, the
        hybrid mesh with 2 shards each, this script's --mesh-worker),
        each placing only its rows: top-10, IVF at nprobe = C and the
        ring identical in both and equal to this process's answers;
     j. the model axis of the mesh (parallel/vlm.py), run after 4e on its
        seeded weights (the bf16 7B and the 1.1B draft made anew from the
        seed, 4e's int8 model), on distinct cards where the machine has
        them, else cuda:0 repeated (said which): (1) bf16 at TP = 2 (1x2)
        and 4 (1x4): a pack of 8 through LLaVAVerifier(mesh=) with the
        CLI's serving options (K2, K3, K10, K11 launched; shard caches
        [L, 8, 32 / T, S, HD]), prefill logits within PREFILL_LOGIT_TOL
        of 4e's one-device kernel route, and one device fed the TP tokens
        holding them to TP_TOKEN_GAP and TOKEN_FLOOR (`token_check`); (2) quantize_llava weights + int8 KV at
        TP = 2: prefill logits and all 32 tokens bit-equal to 4e's
        one-device int8 run (K6 launched); (3) speculative (k = 4) at
        TP = 2 with the draft replicated and sharded: the TP = 2 model
        fed its tokens holding them so, slot utilization; (4) DP x TP
        2x2: 7 JPEGs padded to 8, verdicts = one device's, one device fed
        the rows' tokens holding them so; (5) in 4e's step (4), before
        its int8 checkpoint is removed: `cascade ... --verifier-int8 --tp
        2` (verdicts = run (2)'s on two or more cards, else exit 2 with
        the device-count message), then load_npz(placement=
        llava_checkpoint_placement) bit-equal to shard_llava_params of
        the one-device load, with the host's peak RSS for both loads; (6)
        two DP x TP contrastive steps at B/32 width, batch 32, f32, on
        a 2x2 mesh: losses and gradient norms within 4g's f32 tolerances
        of the one-device step, the updates within the gradient's, K2
        never launched; then ms a decode step and a pack at T = 1, 2, 4,
        the card's busy share over a TP = 2 generate, the peak device
        memory and the phase's seconds;
  5. launch counts: every kernel of each path ran during its phase 4 run
     (4a: the dense epilogue 73 times a ViT-B/32 batch, E2 26 times)
     (K2, K10, K11 in every 4e run, K6 in the int8 ones, K1-K9 in 4i,
     K2, K3, K6, K10 and K11 in 4j);
     phase 4's answers
     against the plain versions on the same inputs;
  6. times (CUDA events, after warm-up), kernel and plain version in turns,
     K9 in Gpairs/s as bench.py counts them; each kernel's bound (the
     larger of its bytes over 3.35 TB/s and its operations over the peak
     rate of their type) and, for K2, K10 and K11 (bf16 caches), PyTorch's
     scaled_dot_product_attention on the same inputs as a yardstick, for
     K6 its two products through torch._int_mm and each of its four
     launches timed alone; K2 and K6 at the L/14
     shapes; K2 and K10 as multiples of SDPA and of
     their bounds; flat bf16 top-300 at Q=8; the flat scans K1 / K4 / K5
     over a seeded 1,048,576 x 512 gallery at Q = 1, 8, 64 (k = 10) and
     Q = 8, k = 300: eager, on the card alone (`graph_ms`) and split by
     torch.profiler into query prep, scan and merge passes, beside their
     bounds (and --parent's kernels); the bucket probes K7 / K8 at Q=8,
     nprobe=128, k=10 the same way (and --parent's); the verifier end to
     end per
     pack (encode,
     prefill, decode ms a step and tokens/s for bf16 and int8 + int8 KV,
     speculative tokens/s); the ViT-L/14 bf16 embed (batch 64) and the
     Taiyi text encode (32 x 16 tokens) on phase 4f's weights; K2 at
     [64, 257, 1024] / 16 bf16 and at f32 [8, 577, 1024] / 16 beside SDPA
     and its bound; K1 over a 1,048,576 x 768 gallery at Q=8, k=10, on the
     card alone and eager; phase 4g's adapter command split into cache
     build, test encode, classifier, Tip-F and the HP search, ms per
     contrastive step, serve QPS and p50 / p99 latency at 16 clients per
     engine, and streaming GB/s at prefetch 0 and 2; the planner's four
     constants fitted from the eager flat and IVF Q=1 top-10 (and K7 alone
     at Q=1), each rung's predicted Q=1 beside its measurement, the plan
     at 1M / 10M / 100M rows; phase 4h's seven lifecycle stages (host
     clock); the int4 LLaMA's decode ms a step beside bf16 and int8 at the
     same depth, and the int4 unpack's share of device time; the dense
     epilogue at phase 3's shapes (QuickGELU or none as the towers run
     them, and GELU) beside its bound and the plain ops, and the two
     towers' batch with the kernel and with the plain ops.
Then the script's total time (the build included). The line before the
last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""

import csv
import dataclasses
import importlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SEED = 0
GALLERY_ROWS = 1 << 20        # 1M x 512 bf16: 1 GiB resident
DIM = 512                     # ViT-B/32 embed_dim
EMBED_BATCH = 224             # serving batch for the embed throughput
SMOKE_IMAGES = 4096
SMOKE_CLASSES = 8
# largest |quantized score - exact cosine| tolerated: mmrs_tpu's bounds
# (tests/test_quant.py, tests/test_quant4.py)
QUANT_SCORE_ERR = {"int8": 0.02, "int4": 0.04}
# least c0 prototype precision@10 on every gallery; chance is 10/8 = 1.25
PROTO_MIN = 6
# IVF over the clustered 1M gallery: auto_clusters(1M) and auto_nprobe(1024)
IVF_CLUSTERS = 1024
IVF_NPROBE = 128
IVF_CHUNK = 65536             # build streaming rows
IVF_ANCHORS = 8192            # bench_ivf.py's clustered data
IVF_DUPS = (77, 500_000, 1_000_000)   # the last two are copies of the first
IVF_RUNGS = {"": "bf16", "int8": "int8", "int4": "int4"}
# governance dedup: the JAX bench's size (bench.py:bench_dedup)
DEDUP_ROWS = 131_072
DEDUP_TEST_ROWS = 16_384
DEDUP_TAU = 0.99
DEDUP_PLANTS = 1024           # noisy copies; near misses and chains: 256 each
DEDUP_COPIES = 64             # exact image copies added to phase 4a's index
# K9's f32 route against f64 dots: copies this far either side of tau,
# rows with a score within a quarter of it of tau left undecided
NEAR_TAU = 2e-6
# the LLaVA cascade verifier (phase 4e): LLaVA-v1.5-7B at full width and
# depth, the CLI's serving options; verify packs of 8, 32 new tokens
LLAVA_IMAGES = 16
VERIFY_BATCH = LLAVA_B = 8
LLAVA_MAX_NEW = 32
KV_SLOTS = 704                # round64(prompt ~630 + 32): the decode cache
# K10 / K11 against their plain versions: both round the probabilities to
# bf16, and a last-bit difference of exp() or of the f32 sums can flip one
# rounding: one bf16 ulp of a probability (<= 2^-8) times |v| (< 5)
KV_ATTN_TOL = 2e-2
# prefill logits, kernel route vs plain route, at 7B on random weights
# (|logits| < 6): the routes' attention outputs differ by such flips, and
# 32 decoder layers carry them to the logits; the int8 route quantizes
# every layer's input per row, where a moved code moves a whole product.
# About 3x the 0.160 (bf16) and 0.567 (int8) measured on an H100
PREFILL_LOGIT_TOL = {"bf16": 0.5, "int8": 1.5}
# The token checks of 4e and 4j (token_check): a route's greedy tokens fed
# to the model it is held against, over every step. The gap: how far below
# that model's best logit a fed token may lie. Over 10 verify packs
# (probe_tp_token_gap.py on an H100, with and without the tower's E2
# norms) the bf16 routes' gaps reached 0.184 (4e, kernel vs plain), 0.154
# (4j, TP = 4 against one device) and 0.140 (TP = 2), medians 0.11-0.14,
# 0.10-0.11 and 0.08-0.10; one bf16 ulp at half of the image embeddings'
# elements moved a pack's 4j gap by up to 0.06 either way (0.036
# speculative against TP = 2 and 0.057 DP x TP, one pack). Above the
# largest, below the median of the packs' median top-2 margins of the
# random 7B (0.206: a route that picked the runner-up would lie a margin
# below). The floor: the least share of the steps at which that model
# picks the fed token; below the lowest bf16 reading (227 of 256 = 0.887;
# 219 of 224 DP x TP); a runner-up route is picked at none.
TP_TOKEN_GAP = 0.19
TOKEN_FLOOR = 0.85
# 4e's speculative tokens fed to the one-device kernel-route target: its
# verify passes run K10 over k + 1 rows where the target's greedy trace
# runs K11, and write the cache from those passes (0.138 on the H100),
# still below the median top-2 margin (0.19)
SPEC_TOKEN_GAP = 0.16
# int8 weights + int8 KV against their plain route: every layer quantizes
# its input per row, so a one-ulp difference anywhere moves int8 codes
# (55-63% of them by tower block 11) and whole products; an f64 version
# of the same attention moves the tokens as far as the kernels do
# (probe_verifier_gap.py on the H100: gaps 0.33-0.87, 169-195 of 256
# steps picked, 0.759 and 169 for this route). Above the largest gap,
# below the lowest share. Here the floor lies below a route wrong at a
# quarter of the steps; such a route fails on the gap wherever one of its
# steps has a top-2 margin past it (the 7B's reach 1.72)
INT8_TOKEN_GAP = 1.0
INT8_TOKEN_FLOOR = 0.6
TOKEN_LIMITS = {"bf16": (TP_TOKEN_GAP, TOKEN_FLOOR),
                "speculative": (SPEC_TOKEN_GAP, TOKEN_FLOOR),
                "int8": (INT8_TOKEN_GAP, INT8_TOKEN_FLOOR)}
# 4e's per-call checks on the 7B's own tensors: K2 (and K6) at these blocks
# of the L/14-336 tower, K10 at every prefill chunk and K11 at these decode
# steps, at these decoder layers; K2 to phase 3's bf16 limit
HELD_BLOCKS = (0, 11, 22)
HELD_LAYERS = (0, 15, 31)
HELD_STEPS = (1, 16, 31)
K2_TOL = 2e-2
# the card's peaks (NVIDIA H100 SXM data sheet, dense): bytes/s, FLOP/s
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# k past one 256-row scan chunk: the engine passes any k <= N
LARGE_K = (300, 1000)
# phase 6's flat scans: (Q, k) over FLAT_SEED's 1M x 512 gallery
FLAT_SHAPES = ((1, 10), (8, 10), (64, 10), (8, 300))
FLAT_SEED = 9


def say(*parts) -> None:
    print(*parts, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """ms per call of fn: CUDA events over `iters` calls after `warmup`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_pair(kernel_fn, plain_fn, iters: int = 10, warmup: int = 3):
    """(kernel ms, plain ms) per call, timed in the order plain, kernel,
    kernel, plain."""
    p1, k1, k2, p2 = (time_ms(fn, iters, warmup) for fn in
                      (plain_fn, kernel_fn, kernel_fn, plain_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


def graph_ms(fn, n: int = 20, reps: int = 20):
    """(mean, min, median, max) ms of one call of fn on the card alone:
    n calls captured in a CUDA graph, each replay timed by CUDA events and
    divided by n, so the host's dispatch of a small kernel (tens of us a
    call through the Python wrapper) is not timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in events:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    ms = sorted(start.elapsed_time(end) / n for start, end in events)
    return sum(ms) / reps, ms[0], ms[reps // 2], ms[-1]


def int_mm_pair(m: int, w1_q: torch.Tensor, w2_q: torch.Tensor, gen) -> float:
    """ms of an int8 MLP's two products through torch._int_mm (cuBLAS) on
    [m, W] and [m, H] int8 codes, int32 out: a yardstick the port never
    calls."""
    dev = w1_q.device
    xq = torch.randint(-127, 128, (m, w1_q.shape[1]), dtype=torch.int8,
                       device=dev, generator=gen)
    hq = torch.randint(-127, 128, (m, w1_q.shape[0]), dtype=torch.int8,
                       device=dev, generator=gen)
    return time_ms(lambda: (torch._int_mm(xq, w1_q.T), torch._int_mm(hq, w2_q.T)),
                   iters=20)


def k6_launch_ms(args, act: str = "quick_gelu"):
    """ms of each of K6's four launches alone (row-quantize x, x.w1 with its
    activation epilogue, row-quantize h, h.w2), on the scratch one whole
    call left; not counted as launches."""
    from mmrs_tpu_torch.ops import mlp_int8 as k6
    x = args[0]
    plan = k6.mlp_plan(x.shape[0], x.shape[1], args[1].shape[0])
    out, scratch = torch.empty_like(x), k6._scratch(x, plan)
    k6._launch(*args, act, out, scratch)
    return [time_ms(lambda: k6._launch(*args, act, out, scratch, only=i),
                    iters=20) for i in range(4)]


def least_ms(nbytes: float, ops: float, kind: str):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the operations over the peak rate of
    their type."""
    by_bytes = nbytes / PEAK_BYTES * 1e3
    by_ops = ops / PEAK_OPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def flat_gallery(dev) -> torch.Tensor:
    """[GALLERY_ROWS, DIM] bf16 unit rows from FLAT_SEED, made on the card:
    the same rows in every process (phase 6 and --flat-times)."""
    gen = torch.Generator(device=dev).manual_seed(FLAT_SEED)
    g = torch.randn((GALLERY_ROWS, DIM), device=dev, generator=gen)
    return (g / g.norm(dim=1, keepdim=True)).to(torch.bfloat16)


def flat_bound(nq: int, k: int, row_bytes: float, kind: str):
    """Least time of a flat top-k: the gallery (and its row scales) read
    once, the queries read, k (value, id) pairs a query written; 2 Q N D
    operations of the rows' type."""
    return least_ms(GALLERY_ROWS * row_bytes + nq * DIM * (2 if kind == "bf16"
                                                           else 4)
                    + nq * k * 8, 2 * nq * GALLERY_ROWS * DIM, kind)


def flat_scan_times(dev) -> dict:
    """The flat scans K1 / K4 / K5 of the `mmrs_tpu_torch` on sys.path over
    flat_gallery, at each FLAT_SHAPES (Q, k): eager ms (CUDA events around
    20 calls), on the card alone (`graph_ms`: mean, min, median, max) and
    the device time of each kernel a launch with the launches seen in 10
    calls (torch.profiler: the query prep, the scan and the merge passes;
    the profiler can miss launches, so a launch's mean is what it reads).
    Launches here are not counted as the main path's: the caller resets or
    reads counts elsewhere."""
    from mmrs_tpu_torch.ops.quant import cosine_topk_quantized, quantize_rows
    from mmrs_tpu_torch.ops.quant4 import cosine_topk_int4, quantize_rows_int4
    from mmrs_tpu_torch.ops.topk import cosine_topk

    g = flat_gallery(dev)
    scans = {"bf16": (cosine_topk, (g,)),
             "int8": (cosine_topk_quantized, quantize_rows(g.float())),
             "int4": (cosine_topk_int4, quantize_rows_int4(g.float()))}
    out = {}
    with torch.inference_mode():
        for kind, (fn, gal) in scans.items():
            for nq, k in FLAT_SHAPES:
                qb = g[torch.arange(nq, device=dev) * 997 % GALLERY_ROWS]
                if kind != "bf16":
                    qb = qb.float()
                call = (lambda fn=fn, qb=qb, gal=gal, k=k: fn(qb, *gal, k))
                eager = time_ms(call, iters=20)
                graph = graph_ms(call)
                for _ in range(2):   # a process's first profile may drop kernels
                    split = profile_device(lambda: [call() for _ in range(10)],
                                           top=6)
                out[f"{kind} Q={nq} k={k}"] = {
                    "eager_ms": eager, "graph_ms": graph,
                    "split": [(name[:48], ms / max(n, 1), n)
                              for name, ms, n in split[2]]}
    del g, scans
    torch.cuda.empty_cache()
    return out


def clustered_ivfs(dev):
    """The clustered 1M gallery (seed SEED) and its IVF index at C =
    IVF_CLUSTERS for every rung from one set of centroids, built on the
    card by the `mmrs_tpu_torch` on sys.path: (gallery, {mode: index},
    {"train": s, mode: build seconds})."""
    from mmrs_tpu_torch.index import ivf as ivf_mod

    gal = clustered_gallery(dev, SEED)

    def chunks():
        return (gal[a:a + IVF_CHUNK] for a in range(0, GALLERY_ROWS, IVF_CHUNK))

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cents = ivf_mod.train_centroids(gal[::4], IVF_CLUSTERS, device=dev)
    torch.cuda.synchronize()
    seconds = {"train": time.perf_counter() - t1}
    ivfs = {}
    for mode in IVF_RUNGS:
        ivfs[mode] = ivf_mod.build_ivf_streaming(
            chunks, GALLERY_ROWS, DIM, n_clusters=IVF_CLUSTERS,
            chunk=IVF_CHUNK, centroids=cents, quantize=mode, device=dev)
        seconds[mode] = ivfs[mode].build_seconds
    return gal, ivfs, seconds


def probe_scan_times(dev, gal, ivfs, plain: bool = False) -> dict:
    """The bucket probes K7 (bf16, int8) and K8 (int4) of the
    `mmrs_tpu_torch` on sys.path at Q=8, nprobe=IVF_NPROBE, k=10 over the
    clustered gallery's indexes (clustered_ivfs), 8 queries near rows i *
    997 (noise from FLAT_SEED): eager ms (CUDA events around 20 calls), on
    the card alone (`graph_ms`), the device time of each kernel a launch
    with the launches seen in 10 calls (torch.profiler, the second of two
    profiles; it can miss launches, so a launch's mean is what it reads),
    the bound
    (the live rows of the distinct probed buckets, which K7 / K8 read once
    for the tile, and their slot ids; 2 D operations a live row and
    query), and with `plain` the plain version's eager ms. Launches here
    are not counted as the main path's."""
    from mmrs_tpu_torch.index import ivf as ivf_mod

    gen = torch.Generator(device=dev).manual_seed(FLAT_SEED + 1)
    rows = torch.arange(8, device=dev) * 997
    qv = gal[rows].float() + 0.02 * torch.randn((8, DIM), device=dev,
                                                generator=gen)
    qv = qv / qv.norm(dim=1, keepdim=True)
    out = {}
    with torch.inference_mode():
        for mode, ivf in ivfs.items():
            plist = ivf_mod.probe_lists(qv, ivf, IVF_NPROBE)
            fn, args = probe_call(ivf, qv, plist)
            call = (lambda fn=fn, args=args: fn(*args, 10))
            r = {"eager_ms": time_ms(call, iters=20), "graph_ms": graph_ms(call)}
            for _ in range(2):   # a process's first profile may drop kernels
                split = profile_device(lambda: [call() for _ in range(10)],
                                       top=4)
            r["split"] = [(name[:40], ms / max(n, 1), n)
                          for name, ms, n in split[2]]
            if plain:
                r["plain_ms"] = time_ms(lambda: fn(*args, 10, impl="torch"))
            live = (ivf.bucket_ids >= 0).sum(1)
            distinct = plist[ivf_mod.bucket_owners(plist)]
            row_bytes = {"": DIM * 2, "int8": DIM + 4, "int4": DIM // 2 + 4}
            r["bound"] = least_ms(
                int(live[distinct].sum()) * row_bytes[mode]
                + distinct.numel() * ivf.bucket_cap * 4 + 8 * DIM * 2
                + 8 * 10 * 8,
                2 * DIM * int(live[plist.long()].sum()),
                "bf16" if mode == "" else "int8")
            out[IVF_RUNGS[mode]] = r
    return out


def parent_times(root: str) -> dict:
    """flat_scan_times and probe_scan_times of the package under `root` (an
    earlier commit), in a process of its own (it builds that tree's
    kernels into its own _build/ and its own IVF indexes from the same
    seed): {"flat": ..., "probe": ...}."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--flat-times", root],
        capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(proc.returncode == 0 and lines,
          f"--flat-times {root} failed ({proc.returncode}): "
          f"{proc.stderr[-2000:]}")
    return json.loads(lines[-1])


def probe_pair(ivf, queries, lists, k: int):
    """The bucket probe over `lists` (kernel, top k) and its plain version
    (top k + 1): ((vals, ids), (plain vals, plain ids)). Out-of-range
    cluster ids, which the kernel scores as empty slots and never reads,
    name an appended empty bucket C for the plain version."""
    c = ivf.bucket_ids.shape[0]
    fn, args = probe_call(ivf, queries, lists)
    got = fn(*args, k)
    *head, _, buckets, bucket_ids, scales = args
    if bool(((lists < 0) | (lists >= c)).any()):
        lists = torch.where((lists < 0) | (lists >= c), c, lists)
        buckets = torch.cat([buckets, torch.zeros_like(buckets[:1])])
        bucket_ids = torch.cat([bucket_ids,
                                torch.full_like(bucket_ids[:1], -1)])
        if scales is not None:
            scales = torch.cat([scales, torch.ones_like(scales[:1])])
    return got, fn(*head, lists, buckets, bucket_ids, scales, k + 1,
                   impl="torch")


def ptxas_lines(log_path: str):
    """(kernel, usage) per compiled kernel from nvcc's -Xptxas -v output."""
    name = "?"
    with open(log_path, encoding="utf-8") as f:
        for line in f:
            if "Compiling entry function" in line:
                # drop the anonymous namespace's mangled prefix
                line = re.sub(r"_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "",
                              line)
                m = re.search(r"(\w+?_kernel)(I(?:Li\d+E|Lb\dE|f|"
                              r"13__nv_bfloat16)+E)?", line)
                args = [next(a for a in g if a) for g in re.findall(
                    r"Li(\d+)E|Lb(\d)E|(f)|13__nv_(bfloat16)",
                    (m.group(2) or "") if m else "")]
                name = (m.group(1) + (f"<{','.join(args)}>" if args else "")
                        if m else "?")
            elif "Used" in line:
                yield name, line.split(":", 1)[1].strip()
            elif "spill" in line and "0 bytes spill stores" not in line:
                yield name, line.strip()


def launched(kernels, call, what: str):
    """call(), checking that it launched every one of `kernels`."""
    before = [fn.launches for fn in kernels]
    out = call()
    for fn, n in zip(kernels, before):
        check(fn.launches > n, f"{what} did not launch {fn.__name__}")
    return out


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in units of b's bf16 spacing (8 significand bits)."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(b)
    ulp = torch.ldexp(torch.ones_like(b), e - 8).clamp_min(2.0 ** -133)
    return float(((a - b).abs() / ulp).max())


def topk_agree(vals, ids, ref_vals, ref_ids, tol: float = 1e-3,
               gap: float = 1e-4) -> float:
    """Values within `tol`; ids equal wherever the reference's neighbours
    (ref has k+1 columns) are more than `gap` apart. Returns max |dv|."""
    k = vals.shape[1]
    err = float((vals - ref_vals[:, :k]).abs().max())
    check(err <= tol, f"top-k values differ by {err}")
    rv = ref_vals.double()
    left = torch.cat([torch.full_like(rv[:, :1], float("inf")),
                      rv[:, :-1] - rv[:, 1:]], dim=1)[:, :k]
    right = (rv[:, :-1] - rv[:, 1:])[:, :k]
    clear = (left > gap) & (right > gap)
    bad = clear & (ids != ref_ids[:, :k])
    check(not bool(bad.any()),
          f"top-k ids differ at {int(bad.sum())} well-separated places")
    return err


def clustered_gallery(dev, seed: int) -> torch.Tensor:
    """[GALLERY_ROWS, DIM] bf16 unit rows clustered like bench_ivf.py's:
    IVF_ANCHORS unit anchors plus noise of sigma 0.9 / sqrt(D) per
    coordinate (same-anchor pairs at cosine ~0.55), made on the card from
    a seed. Rows IVF_DUPS[1:] are copies of row IVF_DUPS[0]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    anchors = torch.randn((IVF_ANCHORS, DIM), device=dev, generator=g)
    anchors /= anchors.norm(dim=1, keepdim=True)
    out = torch.empty((GALLERY_ROWS, DIM), dtype=torch.bfloat16, device=dev)
    for a in range(0, GALLERY_ROWS, IVF_CHUNK):
        which = torch.randint(0, IVF_ANCHORS, (IVF_CHUNK,), device=dev,
                              generator=g)
        x = anchors[which] + 0.9 / DIM ** 0.5 * torch.randn(
            (IVF_CHUNK, DIM), device=dev, generator=g)
        out[a:a + IVF_CHUNK] = (x / x.norm(dim=1, keepdim=True)).to(
            torch.bfloat16)
    out[list(IVF_DUPS[1:])] = out[IVF_DUPS[0]].clone()
    return out


def probe_call(ivf, queries, probe):
    """(wrapper, its arguments before k) of the bucket probe for an index's
    rung: K8 takes the int8 query codes, K7 the bf16 queries."""
    from mmrs_tpu_torch.index.ivf import probe_buckets, probe_buckets_q4
    from mmrs_tpu_torch.ops.quant4 import prep_queries

    if ivf.quant == "int4":
        return probe_buckets_q4, (*prep_queries(queries.float()), probe,
                                  ivf.buckets, ivf.bucket_ids,
                                  ivf.bucket_scales)
    return probe_buckets, (queries.to(torch.bfloat16), probe, ivf.buckets,
                           ivf.bucket_ids, ivf.bucket_scales)


def recall_at(ids: torch.Tensor, exact: torch.Tensor) -> float:
    got, want = ids.tolist(), exact.tolist()
    return sum(len(set(a) & set(b)) for a, b in zip(got, want)) / float(
        len(want) * len(want[0]))


@dataclasses.dataclass
class SyntheticImages:
    """FolderDataset's batches() interface over seeded in-memory images:
    an image is its class's coarse pattern, its own coarse pattern and
    fine noise. No files and no PIL."""

    samples: list
    seed: int = SEED
    image_size: int = 224
    stack: str = "openai"
    num_workers: int = 0
    cache: dict = dataclasses.field(default_factory=dict)  # name -> pixels

    def image(self, name: str, cls: str) -> np.ndarray:
        if name not in self.cache:
            self.cache[name] = self._draw(name, cls)
        return self.cache[name]

    def _draw(self, name: str, cls: str) -> np.ndarray:
        s = self.image_size

        def coarse(*key):
            g = np.random.default_rng([self.seed, *key])
            cells = g.uniform(0, 255, (7, 7, 3))
            return np.repeat(np.repeat(cells, s // 7 + 1, 0), s // 7 + 1,
                             1)[:s, :s]

        idx = int(name.rsplit("/", 1)[1])
        noise = np.random.default_rng([self.seed, 1, idx]).uniform(
            -12, 12, (s, s, 3))
        img = 0.6 * coarse(0, int(cls[1:])) + 0.4 * coarse(2, idx) + noise
        return np.clip(img, 0, 255).astype(np.uint8)

    def batches(self, batch_size: int):
        from mmrs_tpu_torch.io.dataset import Batch

        for a in range(0, len(self.samples), batch_size):
            chunk = self.samples[a:a + batch_size]
            yield Batch(pixels=np.stack([self.image(*s) for s in chunk]),
                        labels=[c for _, c in chunk],
                        paths=[p for p, _ in chunk],
                        ok=np.ones(len(chunk), bool))


def near_rows(x: torch.Tensor, cos, g) -> torch.Tensor:
    """Unit rows at exactly `cos` (a number, or one a row as [rows, 1]) to
    the unit rows x (a random direction orthogonal to each row)."""
    z = torch.randn(x.shape, device=x.device, dtype=x.dtype, generator=g)
    z -= (z * x).sum(1, keepdim=True) * x
    z /= z.norm(dim=1, keepdim=True)
    return cos * x + (1.0 - cos * cos) ** 0.5 * z


def planted_dedup_rows(dev, seed: int):
    """[DEDUP_ROWS, DIM] f32 unit rows made on the card, with planted pairs
    around DEDUP_TAU: DEDUP_PLANTS noisy copies at cosine 0.995, a quarter
    as many near misses at 0.985 and chains A~B, B~C (0.995 a step, A~C
    0.980). Returns (rows, the keep-first first-match vector they must
    give, int64 on the host). Random pairs of 512-d rows stay below ~0.3."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((DEDUP_ROWS, DIM), device=dev, generator=g)
    x /= x.norm(dim=1, keepdim=True)
    perm = torch.randperm(DEDUP_ROWS, device=dev, generator=g)
    p, q = DEDUP_PLANTS, DEDUP_PLANTS // 4
    src, dup = perm[:p], perm[p:2 * p]
    x[dup] = near_rows(x[src], 0.995, g)
    x[perm[2 * p + q:2 * p + 2 * q]] = near_rows(x[perm[2 * p:2 * p + q]],
                                                 0.985, g)
    o = 2 * p + 2 * q
    a, b, c = perm[o:o + q], perm[o + q:o + 2 * q], perm[o + 2 * q:o + 3 * q]
    e1 = near_rows(x[a], 0.0, g)
    t = math.acos(0.995)
    x[b] = math.cos(t) * x[a] + math.sin(t) * e1
    x[c] = math.cos(2 * t) * x[a] + math.sin(2 * t) * e1
    first = np.full(DEDUP_ROWS, -1, np.int64)
    for s, d in zip(src.tolist(), dup.tolist()):
        first[max(s, d)] = min(s, d)
    for ra, rb, rc in zip(a.tolist(), b.tolist(), c.tolist()):
        edges = {ra: (rb,), rb: (ra, rc), rc: (rb,)}
        for r, nb in edges.items():
            earlier = [e for e in nb if e < r]
            if earlier:
                first[r] = min(earlier)
    return x, first


def mixed_magnitude_rows(dev, seed: int, n: int):
    """[n, DIM] f32 unit rows a quarter of whose entries are scaled by
    10^(-6u), u uniform in [0, 1) (magnitudes down to 1e-6 of the rest:
    every bf16 plane of the f32 route's split is busy), with n // 64
    copies at cosine 0.995 planted after the scaling. Returns (rows, the
    first-match vector they must give, int32 on the card)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, DIM), device=dev, generator=g)
    x *= torch.where(torch.rand(x.shape, device=dev, generator=g) < 0.25,
                     10.0 ** (-6 * torch.rand(x.shape, device=dev,
                                              generator=g)), 1.0)
    x /= x.norm(dim=1, keepdim=True)
    perm = torch.randperm(n, device=dev, generator=g)
    src, dup = perm[:n // 64], perm[n // 64:n // 32]
    x[dup] = near_rows(x[src], 0.995, g)
    want = torch.full((n,), -1, dtype=torch.int32, device=dev)
    want[torch.maximum(src, dup)] = torch.minimum(src, dup).int()
    return x, want


def near_tau_rows(dev, seed: int, n: int, margins):
    """[n, DIM] f32 unit rows with n // 8 copies planted at cosines
    f32(DEDUP_TAU) + margin, the margins taken in turn: made in f64 and
    rounded once to f32, which moves a cosine by about 1e-8."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, DIM), device=dev, dtype=torch.float64, generator=g)
    x /= x.norm(dim=1, keepdim=True)
    perm = torch.randperm(n, device=dev, generator=g)
    p = n // 8
    src, dup = perm[:p], perm[p:2 * p]
    margin = torch.tensor(margins, dtype=torch.float64,
                          device=dev).repeat(-(-p // len(margins)))[:p]
    x[dup] = near_rows(x[src], float(np.float32(DEDUP_TAU)) + margin[:, None],
                       g)
    return x.float()


def first_match_f64(a, b, intra: bool, band: float):
    """The first-match vector of the f32 rows a against b at f32(DEDUP_TAU)
    from f64 dots (exact to about 1e-16 for unit rows), and the rows it
    decides: those with no counting column scored within `band` of tau,
    where an f32 sum may fall on either side."""
    tau = float(np.float32(DEDUP_TAU))
    b64 = b.double()
    cols = torch.arange(b.shape[0], device=a.device)
    ids = torch.full((a.shape[0],), -1, dtype=torch.int32, device=a.device)
    clear = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
    for r0 in range(0, a.shape[0], 2048):
        s = a[r0:r0 + 2048].double() @ b64.T
        counts = torch.ones_like(s, dtype=torch.bool)
        if intra:
            rows = torch.arange(r0, r0 + s.shape[0], device=a.device)
            counts = cols[None, :] < rows[:, None]
        first = torch.where(counts & (s >= tau), cols[None, :],
                            b.shape[0]).amin(dim=1)
        ids[r0:r0 + s.shape[0]] = torch.where(first < b.shape[0], first,
                                              -1).int()
        clear[r0:r0 + s.shape[0]] = ~(counts & ((s - tau).abs() <= band)
                                      ).any(dim=1)
    return ids, clear


def keeper_pairs(first, paths):
    """embedding_dedup's (dup, keeper) report from a first-match vector."""
    out = []
    for i, j in enumerate(first):
        if j >= 0:
            k = int(j)
            while first[k] >= 0:
                k = int(first[k])
            out.append((paths[i], paths[k]))
    return out


def run_cli(argv):
    """`mmrs-torch <argv>` in this process: (exit code, stdout lines)."""
    import contextlib
    import io

    from mmrs_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            cli_main(argv)
            code = 0
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue().splitlines()


def dup_lines(lines):
    """(dup, keeper) pairs from `dedup` DUP lines."""
    out = []
    for ln in lines:
        if ln.startswith("DUP\t"):
            _, dup, keeper = ln.split("\t")
            out.append((dup, keeper.removeprefix("-> keeper ")))
    return out


def governance_tree(root: str) -> None:
    """A small image tree for the hash modes and the dataset commands:
    exact and recompressed copies, a train/test leak, convertible formats,
    class folders to rename and merge, and VQA class folders."""
    from PIL import Image

    def grad(seed, size=(64, 64)):
        rng = np.random.default_rng(seed)
        return Image.fromarray(rng.integers(0, 255, (8, 8, 3), np.uint8)
                               ).resize(size, Image.BILINEAR)

    dirs = ("ref", "tgt", "train", "test", "mixed/sub", "classes/cat",
            "classes/kitty", "vqa/cat", "vqa/dog", "vqa/lynx",
            "vqa/ez_negative", "vqa/cat_negative")
    for d in dirs:
        os.makedirs(os.path.join(root, d))
    j = lambda *p: os.path.join(root, *p)  # noqa: E731
    grad(10).save(j("ref", "a.png"))
    grad(10).save(j("tgt", "a_copy.png"))
    grad(11).save(j("tgt", "b.png"))
    grad(20, (128, 128)).save(j("tgt", "big.jpg"), quality=98)
    grad(20, (128, 128)).save(j("tgt", "small.jpg"), quality=40)
    grad(30).save(j("test", "t1.png"))
    grad(30).save(j("train", "leaked.png"))
    grad(31).save(j("train", "clean.png"))
    grad(1).save(j("mixed", "keep.jpg"))
    grad(2).save(j("mixed", "t.png"))
    grad(3).save(j("mixed", "sub", "drop.bmp"))
    for cls, n in (("cat", 3), ("kitty", 2)):
        for i in range(n):
            grad(40 + i).save(j("classes", cls, f"w_{i}.jpg"))
    for cls, n in (("cat", 6), ("dog", 4), ("lynx", 3), ("ez_negative", 12),
                   ("cat_negative", 4)):
        for i in range(n):
            open(j("vqa", cls, f"{cls}{i}.jpg"), "wb").close()


# ---- phase 4e: the LLaVA cascade verifier -----------------------------------

def synthetic_jpegs(root: str, n: int, seed: int):
    """n seeded 400 x 360 JPEGs in two class folders (cat, dog): smooth
    colour fields plus noise, resized to 336 px by the verifier's loader."""
    from PIL import Image

    paths = []
    for i in range(n):
        cls = "cat" if i % 2 == 0 else "dog"
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        rng = np.random.default_rng([seed, i])
        cells = rng.uniform(0, 255, (6, 6, 3)).astype(np.uint8)
        img = Image.fromarray(cells).resize((400, 360), Image.BICUBIC)
        arr = np.asarray(img).astype(np.int16) + rng.integers(
            -10, 10, (360, 400, 3))
        p = os.path.join(root, cls, f"{cls}{i:02d}.jpg")
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
            p, quality=92)
        paths.append(p)
    return sorted(paths)


def tiny_sentencepiece(path: str) -> None:
    """A SentencePiece model (serialize_model) for the llava_v1 prompt:
    control pieces, 256 byte pieces, the prompt's characters and every
    prefix of each of its words, so that a word encodes to one piece (about
    as many tokens as LLaMA's tokenizer gives); every id < 32000."""
    from mmrs_tpu_torch.cascade.verifier import (LLAVA_V1_SYSTEM,
                                                 llava_v1_prompt_parts)
    from mmrs_tpu_torch.models.sentencepiece import (SPACE, Piece,
                                                     serialize_model)

    text = LLAVA_V1_SYSTEM + "".join(llava_v1_prompt_parts(
        "Does this image contain a cat?")) + " yes no"
    pieces = [Piece("<unk>", 0.0, 2), Piece("<s>", 0.0, 3),
              Piece("</s>", 0.0, 3)]
    pieces += [Piece(f"<0x{b:02X}>", -100.0, 6) for b in range(256)]
    chars = sorted(set(text.replace(" ", SPACE)) - {"\n"} | {SPACE})
    pieces += [Piece(c, -50.0, 1) for c in chars]
    words = sorted({SPACE + w for w in text.replace("\n", " ").split()})
    seen = set(chars)
    for w in words:
        for i in range(2, len(w) + 1):
            if w[:i] not in seen:
                seen.add(w[:i])
                pieces.append(Piece(w[:i], -20.0 + i, 1))
    with open(path, "wb") as f:
        f.write(serialize_model(pieces))


def greedy_trace(lm, embeds, kv_dtype, attn: str, steps: int,
                 forced=None, stats=None):
    """Greedy decode of a batch with no EOS (the decode loop of
    llama.greedy_generate, prefill_chunk 64), keeping the prefill's last
    logits and each step's top-2 margin. With `forced` [B, steps] tokens
    it feeds those instead of its own choices and also returns, per step,
    how far the forced token's logit lies below the best one. (logits
    [B, V], tokens [B, steps], margins [B, steps], gaps or None). A
    `stats` dict is given the cache's shapes (one a shard) and the ms of
    a decode step (host clock, the card synchronized after the prefill
    and at the end)."""
    from mmrs_tpu_torch.models import llama

    b, t, _ = embeds.shape
    cache_len = -(-(t + steps) // 64) * 64
    logits, cache = llama.prefill(lm, embeds, cache_len, torch.bfloat16,
                                  kv_dtype, 64, attn)
    if stats is not None:
        shards = cache if isinstance(cache, list) else [cache]
        stats["cache"] = {tuple(c[0].shape) for c in shards}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
    first = logits[:, -1].float()
    toks, margins, gaps = [], [], []
    for i in range(steps):
        last = logits[:, -1]
        top2 = last.topk(2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        toks.append(last.argmax(-1).to(torch.int32))
        feed = toks[-1] if forced is None else forced[:, i]
        if forced is not None:
            gaps.append(top2[:, 0] - last.gather(1, feed[:, None].long())[:,
                                                                          0])
        if i == steps - 1:
            break
        emb = llama.embed_tokens(lm, feed[:, None])
        logits, cache = llama.forward(lm, emb, cache, t + i, torch.bfloat16,
                                      attn=attn)
    if stats is not None:
        torch.cuda.synchronize()
        stats["step_ms"] = (time.perf_counter() - t0) / (steps - 1) * 1e3
    return (first, torch.stack(toks, 1), torch.stack(margins, 1),
            torch.stack(gaps, 1) if gaps else None)


def agreed_steps(tokens, ref_tokens, ref_margins, near_tie: float) -> int:
    """Steps where `tokens` equal the plain run's, counted per row up to
    the first near-tie (the plain top-2 margin below `near_tie`: there
    either route may pick either token). A report: on random weights the
    first near-tie comes at a row's first step, and `token_check` holds
    every step."""
    total = 0
    for r in range(ref_tokens.shape[0]):
        for i in range(ref_tokens.shape[1]):
            if float(ref_margins[r, i]) < near_tie:
                break
            total += int(tokens[r, i]) == int(ref_tokens[r, i])
    return total


def token_check(gaps, same, gap_limit: float, same_floor: float,
                what: str):
    """Hold a route's greedy tokens, fed to the model it is compared with
    (greedy_trace(forced=)), at every step: `gaps` [B, steps] how far each
    fed token's logit lies below that model's best, `same` [B, steps]
    where that model picks the fed token. The largest gap must be within
    `gap_limit` and the share of steps picked at least `same_floor`; a
    route that took the runner-up token at every step lies a top-2 margin
    below at each and is picked at none. Returns (largest gap, steps
    picked)."""
    gap, picked = float(gaps.max()), int(same.sum())
    check(gap <= gap_limit and picked >= same_floor * same.numel(),
          f"{what}: a token lies {gap:.4f} below the best of the model fed "
          f"them (limit {gap_limit}), which picks the same at {picked} of "
          f"{same.numel()} steps (floor {same_floor})")
    return gap, picked


class held_calls:
    """Inside the block, each `module.name` of `ops` is wrapped: it runs as
    it was and its calls are counted per name; call i of `name` for which
    pick(name, i) is true also runs its impl="torch" version on the same
    arguments, and judge(name, i, out, plain) checks the two (then, as
    the call's output was, returned). The ops are restored on exit, also
    when a judge or the block raises."""

    def __init__(self, ops, pick, judge):
        self.ops, self.pick, self.judge = ops, pick, judge
        self.calls = {}

    def __enter__(self):
        self.saved = []
        for module, name in self.ops:
            orig = getattr(module, name)
            self.saved.append((module, name, orig))
            setattr(module, name, self._wrap(name, orig))
        return self

    def _wrap(self, name, orig):
        def run(*args, **kw):
            out = orig(*args, **kw)
            i = self.calls.get(name, 0)
            self.calls[name] = i + 1
            if self.pick(name, i):
                self.judge(name, i, out, orig(*args, **{**kw,
                                                      "impl": "torch"}))
            return out
        return run

    def __exit__(self, *exc):
        for module, name, orig in reversed(self.saved):
            setattr(module, name, orig)


def profile_device(fn, top: int = 8):
    """torch.profiler over one call of fn: (wall ms, device ms summed over
    kernels, [(kernel, ms, launches)] of the `top` largest). It records
    the card's activity only: recording the host's ops too slows a
    host-bound decode under the profiler and leaves more events to sort
    out after it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    kern.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in kern), kern[:top]


def llava_phase(dev, root: str, kernels, cli):
    """Phase 4e: the cascade verifier at LLaVA-v1.5-7B width and depth on
    random weights from SEED. Returns what phases 5 and 6 read."""
    import shutil

    from mmrs_tpu_torch.cascade import CascadePipeline
    from mmrs_tpu_torch.cascade.verifier import LLaVAVerifier
    from mmrs_tpu_torch.models import checkpoint, convert_jax, llava
    from mmrs_tpu_torch.models.configs import VIT_L14_336
    from mmrs_tpu_torch.models.llama import LLAMA2_7B, LLAMA_1B
    from mmrs_tpu_torch.models.quantize import quantize_llava
    from mmrs_tpu_torch.models.sentencepiece import SentencePieceBPE

    bf16 = torch.bfloat16
    ctx = {"launches": {}, "report": [], "e2e": {}, "traces": {}}
    t0 = time.perf_counter()
    cfg = llava.LLaVAConfig(vision=VIT_L14_336, lm=LLAMA2_7B)
    model = llava.LLaVA(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev, dtype=bf16).requires_grad_(False)
    draft = llava.LLaVA(llava.LLaVAConfig(vision=VIT_L14_336, lm=LLAMA_1B),
                        torch.Generator(device=dev).manual_seed(SEED + 1),
                        device=dev, dtype=bf16).requires_grad_(False)
    paths = synthetic_jpegs(os.path.join(root, "folder"), LLAVA_IMAGES, SEED)
    tok_path = os.path.join(root, "tokenizer.model")
    tiny_sentencepiece(tok_path)
    tok = SentencePieceBPE.from_file(tok_path)
    torch.cuda.synchronize()
    say(f"phase 4e setup: LLaVA-v1.5-7B (ViT-L/14-336 + LLaMA-2-7B, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params "
        f"bf16) and the 1.1B draft, random from seed {SEED}, on the card; "
        f"{LLAVA_IMAGES} JPEGs; {time.perf_counter() - t0:.1f} s")

    def serve(m, **kw):
        return LLaVAVerifier(m, m.cfg, tok, max_new_tokens=LLAVA_MAX_NEW,
                             prefill_chunk=64, early_stop=True, device=dev,
                             **kw)

    def pipeline_run(verifier, name, want):
        """Two verify packs through run_streaming; every kernel in `want`
        launched; (result, seconds, launch counts)."""
        for fn in kernels:
            fn.launches = 0
        pipe = CascadePipeline(en_scorer=lambda ps: [1.0] * len(ps),
                               en_threshold=0.0, verifier=verifier)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = pipe.run_streaming(paths, "cat", chunk_size=VERIFY_BATCH,
                                 verify_batch=VERIFY_BATCH)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = {fn.__name__: fn.launches for fn in kernels}
        for fn in want:
            check(counts[fn.__name__] > 0,
                  f"4e {name}: {fn.__name__} never launched")
        check(res.verifier_calls == LLAVA_IMAGES
              and int(res.gate_passed.sum()) == LLAVA_IMAGES,
              f"4e {name}: {res.verifier_calls} verifier calls")
        ctx["launches"][name] = counts
        return res, secs

    # the first pack's inputs, for the plain-route comparisons
    v0 = serve(model)
    images = torch.cat([v0._load_image(p) for p in paths[:VERIFY_BATCH]])
    pre_ids, post_ids = v0._prompt_ids(v0.prompt_template.format(
        category="cat"))
    pre, post = v0._ids(pre_ids, VERIFY_BATCH), v0._ids(post_ids,
                                                         VERIFY_BATCH)

    def embeds(m, plain: bool):
        with torch.inference_mode():
            impl = "torch" if plain else "auto"
            img = llava.encode_images(m, images, bf16, impl)
            return llava.build_multimodal_embeds(m, pre, img, post, bf16)

    def e2e(m, kv, draft_model=None):
        """Seconds of one pack's stages on the kernel route (no EOS, 32
        new tokens): image encode, prefill, the 31 decode steps (or the
        speculative rounds); and tokens/s of the decode."""
        from mmrs_tpu_torch.models import llama

        with torch.inference_mode():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            e = embeds(m, False)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            cache_len = -(-(e.shape[1] + LLAVA_MAX_NEW) // 64) * 64
            llama.prefill(m.lm, e, cache_len, bf16, kv, 64)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if draft_model is None:
                llama.greedy_generate(m.lm, e, LLAVA_MAX_NEW, -1, bf16, kv,
                                      64)
            else:
                llava.generate_speculative(m, draft_model, images, pre, post,
                                           LLAVA_MAX_NEW, 4, -1, bf16,
                                           prefill_chunk=64)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
        if draft_model is None:
            steps = LLAVA_MAX_NEW - 1
            dec = (t4 - t3) - (t3 - t2)
            return {"encode_ms": (t2 - t1) * 1e3,
                    "prefill_ms": (t3 - t2) * 1e3,
                    "decode_step_ms": dec / steps * 1e3,
                    "decode_tok_s": VERIFY_BATCH * steps / dec,
                    "tok_s": VERIFY_BATCH * LLAVA_MAX_NEW
                    / ((t4 - t3) + (t2 - t1))}
        # tok/s of the whole generate (both encodes and prefills, the
        # rounds), as the plain one's encode + generate above
        return {"generate_ms": (t4 - t3) * 1e3,
                "tok_s": VERIFY_BATCH * LLAVA_MAX_NEW / (t4 - t3)}

    def held(m, kv, tokens):
        """The per-call checks on the 7B's own tensors: the kernel-route
        encode with K2 (and K6, int8 weights) at tower blocks HELD_BLOCKS
        held against plain, then a kernel-route trace fed `tokens` with
        K10 at every prefill chunk and K11 at decode steps HELD_STEPS held
        against plain at decoder layers HELD_LAYERS, each on the same
        inputs and cache views. Returns (the embeds, the trace's gaps and
        picks, {op: (calls held, largest |kernel - plain|)}, seconds)."""
        from mmrs_tpu_torch.models import layers, llama

        nl = m.cfg.lm.layers
        seen = {}

        def judge(op, i, out, ref):
            what = f"4e {op} call {i} on the 7B's tensors"
            if op == "mlp_int8_fused":
                check(torch.equal(out, ref), f"{what}: differs from plain")
                err = 0.0
            elif op == "mha_short_seq":
                err = float((out.float() - ref.float()).abs().max())
                check(err <= K2_TOL, f"{what}: max|d| {err} (limit {K2_TOL})")
            else:
                err = attn_err(out, ref, what)
            n, worst = seen.get(op, (0, 0.0))
            seen[op] = (n + 1, max(worst, err))

        def tower(op, i):
            return i in HELD_BLOCKS

        def decoder(op, i):
            return i % nl in HELD_LAYERS and (
                op == "chunk_attention" or i // nl + 1 in HELD_STEPS)

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with held_calls(((layers, "mha_short_seq"),
                         (layers, "mlp_int8_fused")), tower, judge):
            e = embeds(m, False)
        with held_calls(((llama, "chunk_attention"),
                         (llama, "decode_attention")), decoder, judge), \
                torch.inference_mode():
            _, tf, _, gaps = greedy_trace(m.lm, e, kv, "auto", LLAVA_MAX_NEW,
                                          forced=tokens)
        torch.cuda.synchronize()
        return e, gaps, tf == tokens, seen, time.perf_counter() - t1

    def compare(m, kv, name):
        """Prefill logits and greedy tokens, kernel route vs plain; the
        plain route fed the kernel route's tokens, held by token_check to
        TOKEN_LIMITS[name]; and the per-call checks (`held`), whose trace
        is the kernel route fed the plain route's tokens."""
        tol = PREFILL_LOGIT_TOL[name]
        with torch.inference_mode():
            ep = embeds(m, True)
            lp, tp, mp, _ = greedy_trace(m.lm, ep, kv, "torch", LLAVA_MAX_NEW)
        ek, kgaps, kpicks, calls, held_s = held(m, kv, tp)
        with torch.inference_mode():
            lk, tk, mk, _ = greedy_trace(m.lm, ek, kv, "auto", LLAVA_MAX_NEW)
            _, tf, _, gaps = greedy_trace(m.lm, ep, kv, "torch",
                                          LLAVA_MAX_NEW, forced=tk)
        # the kernel route's trace: phase 4j's one-device reference
        ctx["traces"][name] = (ek, lk, tk, mk)
        err = float((lk - lp).abs().max())
        check(err <= tol, f"4e {name}: prefill logits differ by {err} "
              f"(limit {tol}; |logits| <= {float(lp.abs().max())})")
        limit, floor = TOKEN_LIMITS[name]
        gap, same = token_check(gaps, tf == tk, limit, floor, f"4e {name}")
        agreed = agreed_steps(tk, tp, mp, 2 * tol)
        ctx["report"].append(
            f"{name}: image embeds max|d| "
            f"{float((ek - ep).abs().max()):.3e}, prefill logits max|d| "
            f"{err:.4f} (limit {tol}; |logits| <= "
            f"{float(lp.abs().max()):.2f}); fed the kernel route's tokens, "
            f"the plain route picks the same token at {same} of {tk.numel()} "
            f"steps (floor {floor}) and has every kernel token within "
            f"{gap:.4f} of its best (limit {limit}; its top-2 margins median "
            f"{float(mp.median()):.4f}, {float(mp.min()):.4f} to "
            f"{float(mp.max()):.4f}, {float((mp > limit).float().mean()):.3f} "
            f"of them past the limit); report only: tokens = plain for "
            f"{agreed} of {tp.numel()} steps to each row's first plain "
            f"top-2 margin < {2 * tol}; the kernel route fed the plain "
            f"tokens picks the same at {int(kpicks.sum())} of {tp.numel()}, "
            f"each within {float(kgaps.max()):.4f} of its best")
        ctx["report"].append(
            f"{name} per call on the 7B's tensors ({held_s:.1f} s): "
            + "; ".join(f"{op} {n} calls max|d| {e:.3e}"
                        for op, (n, e) in calls.items())
            + f" (K2 at tower blocks {list(HELD_BLOCKS)}, limit {K2_TOL}; "
            f"K6 equal; K10 every prefill chunk and K11 decode steps "
            f"{list(HELD_STEPS)} at layers {list(HELD_LAYERS)}, limit "
            f"{KV_ATTN_TOL}, 99% within 1e-4)")
        want = {"mha_short_seq", "chunk_attention", "decode_attention"} | (
            {"mlp_int8_fused"} if name == "int8" else set())
        check(set(calls) == want, f"4e {name} per call: held {set(calls)}, "
              f"want {want}")
        return tp, mp, ek.shape[1], ep

    from mmrs_tpu_torch.ops.attention import mha_short_seq
    from mmrs_tpu_torch.ops.decode_attention import (chunk_attention,
                                                     decode_attention)
    from mmrs_tpu_torch.ops.mlp_int8 import mlp_int8_fused

    k2_10_11 = (mha_short_seq, chunk_attention, decode_attention)
    # (1) bf16 weights, bf16 KV cache: the CLI's serving options
    res1, secs1 = pipeline_run(v0, "bf16", k2_10_11)
    plain_toks, plain_margins, prompt_len, plain_embeds = compare(
        model, None, "bf16")
    ctx["prompt_len"] = prompt_len
    ctx["pack_s"] = {"bf16": secs1 / 2}
    ctx["e2e"]["bf16"] = e2e(model, None)
    ctx["profile"] = {"bf16": profile_device(lambda: llava.generate(
        model, images, pre, post, LLAVA_MAX_NEW, -1, bf16,
        prefill_chunk=64))}
    ctx["report"][-2] = (f"(1) bf16: 2 packs of {VERIFY_BATCH} through "
                         f"run_streaming in {secs1:.2f} s, "
                         f"{int(res1.verified.sum())} verified; "
                         + ctx["report"][-2])

    # (3) speculative decode with the 1.1B draft, k = 4
    vs = serve(model, draft_params=draft, draft_cfg=draft.cfg,
               draft_tokens=4)
    res3, secs3 = pipeline_run(vs, "speculative", k2_10_11)
    with torch.inference_mode():
        spec_toks, spec_stats = llava.generate_speculative(
            model, draft, images, pre, post, LLAVA_MAX_NEW, 4, -1, bf16,
            prefill_chunk=64, return_stats=True)
    tol = PREFILL_LOGIT_TOL["bf16"]
    agreed = agreed_steps(spec_toks, plain_toks, plain_margins, 2 * tol)
    # the target model's kernel route (the one the drafts are verified
    # by) fed the speculative tokens, as 4j (3); the plain route's reading
    # is a report
    with torch.inference_mode():
        _, tf, _, gaps = greedy_trace(model.lm, ctx["traces"]["bf16"][0],
                                      None, "auto", LLAVA_MAX_NEW,
                                      forced=spec_toks)
        _, pf, _, pgaps = greedy_trace(model.lm, plain_embeds, None, "torch",
                                       LLAVA_MAX_NEW, forced=spec_toks)
    limit, floor = TOKEN_LIMITS["speculative"]
    gap, same = token_check(gaps, tf == spec_toks, limit, floor,
                            "4e speculative")
    st = vs.speculative_stats()
    check(st is not None and st["rounds"] > 0, "4e speculative: no rounds")
    check(list(res3.verified) == list(res1.verified),
          "4e speculative: verdicts differ from run (1)'s")
    ctx["spec_stats"] = st
    ctx["e2e"]["speculative"] = e2e(model, None, draft)
    ctx["report"].append(
        f"(3) speculative (1.1B draft, k=4): 2 packs in {secs3:.2f} s, "
        f"{st['rounds']} rounds, slot utilization {st['utilization']:.3f}, "
        f"verdicts = run (1)'s; fed its tokens, the kernel-route target "
        f"picks the same at {same} of {spec_toks.numel()} steps (floor "
        f"{floor}), every token within {gap:.4f} of its best (limit "
        f"{limit}); report only: the plain route fed them picks the same "
        f"at {int((pf == spec_toks).sum())}, each within "
        f"{float(pgaps.max()):.4f} of its best; tokens = the plain bf16 "
        f"run's for {agreed} of {plain_toks.numel()} steps (to the first "
        f"near-tie)")

    # (2) int8 weights (quantize_llava) + int8 KV cache
    t1 = time.perf_counter()
    quantize_llava(model)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t1
    v2 = serve(model, kv_dtype=torch.int8)
    res2, secs2 = pipeline_run(v2, "int8", k2_10_11 + (mlp_int8_fused,))
    compare(model, torch.int8, "int8")
    ctx["pack_s"].update(speculative=secs3 / 2, int8=secs2 / 2)
    ctx["e2e"]["int8"] = e2e(model, torch.int8)
    ctx["profile"]["int8"] = profile_device(lambda: llava.generate(
        model, images, pre, post, LLAVA_MAX_NEW, -1, bf16,
        kv_dtype=torch.int8, prefill_chunk=64))
    ctx["report"][-2] = (f"(2) int8 weights + int8 KV (quantize_llava "
                         f"{quant_s:.2f} s): 2 packs in {secs2:.2f} s; "
                         + ctx["report"][-2])

    # (4) mmrs-torch cascade --verifier llava --verifier-int8 in process,
    # on an int8 checkpoint written by the port's save_npz
    free = shutil.disk_usage(root).free
    need = sum(b.numel() * b.element_size() for b in
               model.state_dict().values())
    check(free > 1.5 * need,
          f"4e CLI: {free / 2 ** 30:.1f} GiB free under {root}, the int8 "
          f"7B checkpoint needs {need / 2 ** 30:.1f} GiB")
    t1 = time.perf_counter()
    ckpt = os.path.join(root, "llava_int8.npz")
    checkpoint.save_npz(convert_jax.llava_tree(model), ckpt)
    save_s = time.perf_counter() - t1
    embed = os.path.join(root, "cat.npy")
    np.save(embed, np.random.default_rng(SEED).standard_normal(DIM).astype(
        np.float32))
    audit = os.path.join(root, "audit.csv")
    for fn in kernels:
        fn.launches = 0
    t1 = time.perf_counter()
    argv = ["cascade", "--root", os.path.join(root, "folder"),
            "--positive-class", "cat", "--class-embed", embed,
            "--threshold=-1e30", "--verifier", "llava", "--verifier-int8",
            "--llava-checkpoint", ckpt, "--tokenizer-model", tok_path,
            "--chunk-size", str(VERIFY_BATCH), "--verify-batch",
            str(VERIFY_BATCH)]
    code, lines = cli(argv + ["--out", audit])
    cli_s = time.perf_counter() - t1
    counts = {fn.__name__: fn.launches for fn in kernels}
    ctx["launches"]["cli"] = counts
    for fn in k2_10_11 + (mlp_int8_fused,):
        check(counts[fn.__name__] > 0,
              f"4e CLI: {fn.__name__} never launched")
    want = [f"images: {LLAVA_IMAGES}", f"gate passed: {LLAVA_IMAGES}",
            f"verifier calls: {LLAVA_IMAGES}",
            f"final positives: {int(res2.verified.sum())}"]
    check(code == 0 and lines[:4] == want,
          f"4e CLI: exit {code}, {lines[:5]}, want {want}")
    with open(audit) as f:
        rows = list(csv.reader(f))[1:]
    by_path = dict(zip(paths, res2.verified))
    check(all(bool(int(r[4])) == bool(by_path[r[0]]) for r in rows),
          "4e CLI: verdicts differ from run (2)'s")
    # phase 4j (5): --tp 2 and the placed load, on this checkpoint
    ctx["tp_ckpt"] = tp_checkpoint_checks(dev, ckpt, cfg, cli, argv, want,
                                          by_path)
    os.remove(ckpt)
    ctx["report"].append(
        f"(4) mmrs-torch cascade --verifier llava --verifier-int8 over "
        f"{LLAVA_IMAGES} JPEGs (ViT-B/32 gate, threshold -1e30): exit 0, "
        f"{lines[:5]}, verdicts = run (2)'s; save_npz {need / 2 ** 30:.2f} "
        f"GiB in {save_s:.1f} s, the command {cli_s:.1f} s")
    ctx["model"] = model
    ctx["paths"], ctx["tok"] = paths, tok
    return ctx


# ---- phase 4j: the model axis of the mesh -------------------------------------

# the tensor-parallel verifier (phase 4j): 4e's seeded LLaVA-v1.5-7B at TP
# 2 and 4, one pack of VERIFY_BATCH with the CLI's serving options; the
# DP x TP pack is TP_DP_IMAGES images padded to the data axis's width; the
# contrastive step at B/32 width over a 2 x 2 mesh, TP_CONTRASTIVE_STEPS
TP_WIDTHS = (2, 4)
TP_DP_IMAGES = 7
TP_CONTRASTIVE_STEPS = 2


def tp_devices(n: int):
    """([n devices], how): n distinct cards where the machine has them,
    else the first card n times (the model axis's shards run one after
    another on it, their partial sums added by no-op copies)."""
    have = torch.cuda.device_count()
    if have >= n:
        return ([torch.device("cuda", i) for i in range(n)],
                f"{n} distinct cards")
    return ([torch.device("cuda", 0)] * n,
            f"cuda:0 repeated {n} times ({have} card(s) here)")


def peak_rss(fn):
    """(fn(), the host's peak resident set while fn ran in GiB above the
    level it started at, that peak in GiB): VmRSS sampled every 5 ms."""
    import threading

    def rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    base = rss()
    peak = [base]
    done = threading.Event()

    def poll():
        while not done.is_set():
            peak[0] = max(peak[0], rss())
            time.sleep(0.005)

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    try:
        out = fn()
    finally:
        done.set()
        th.join()
    peak[0] = max(peak[0], rss())
    return out, (peak[0] - base) / 2 ** 30, peak[0] / 2 ** 30


def tp_checkpoint_checks(dev, ckpt: str, cfg, cli, argv, want_lines,
                         by_path):
    """Phase 4j (5), run inside 4e's step (4) on its int8 checkpoint:
    `cascade ... --tp 2` (verdicts = 4e run (2)'s on two or more cards,
    else exit 2 with the device-count message), then the checkpoint
    loaded straight into its TP = 2 placement, whose pieces must equal
    shard_llava_params of the one-device load bit for bit."""
    import contextlib
    import io

    from mmrs_tpu_torch.config import MeshConfig
    from mmrs_tpu_torch.models import checkpoint, convert_jax
    from mmrs_tpu_torch.parallel.mesh import make_mesh
    from mmrs_tpu_torch.parallel.vlm import (llava_checkpoint_placement,
                                             llava_from_placed,
                                             shard_llava_params)

    out = {}
    audit = os.path.join(os.path.dirname(ckpt), "audit_tp.csv")
    err = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        code, lines = cli(argv + ["--tp", "2", "--out", audit])
    out["cli_s"] = time.perf_counter() - t1
    if torch.cuda.device_count() >= 2:
        check(code == 0 and lines[:4] == want_lines,
              f"4j CLI --tp 2: exit {code}, {lines[:5]}, want {want_lines}")
        with open(audit) as f:
            rows = list(csv.reader(f))[1:]
        check(all(bool(int(r[4])) == bool(by_path[r[0]]) for r in rows),
              "4j CLI --tp 2: verdicts differ from 4e run (2)'s")
        out["cli"] = f"exit 0, verdicts = 4e run (2)'s"
    else:
        want = "--tp 2 needs 2 local devices; 1 available"
        check(code == 2 and want in err.getvalue(),
              f"4j CLI --tp 2 on one card: exit {code}, stderr "
              f"{err.getvalue()[-300:]!r}")
        out["cli"] = f"exit 2 on one card ({want!r}) in {out['cli_s']:.2f} s"
    devs, how = tp_devices(2)
    mesh = make_mesh(MeshConfig(data_size=1, model_size=2), devs)
    t1 = time.perf_counter()
    placed, out["rss_placed"], _ = peak_rss(lambda: checkpoint.load_npz(
        ckpt, placement=llava_checkpoint_placement(mesh)))
    tp_loaded = llava_from_placed(placed, cfg, mesh)
    del placed
    torch.cuda.synchronize()
    out["placed_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    tree, out["rss_plain"], _ = peak_rss(lambda: checkpoint.load_npz(ckpt))
    one = convert_jax.from_jax_llava(tree, cfg, device=dev)
    del tree
    torch.cuda.synchronize()
    out["plain_s"] = time.perf_counter() - t1
    ref = shard_llava_params(one, mesh)
    got_sd = tp_loaded.rows[0].state_dict()
    want_sd = ref.rows[0].state_dict()
    check(list(got_sd) == list(want_sd),
          "4j placed load: the TP model's keys differ from "
          "shard_llava_params'")
    bad = [k for k in want_sd if not torch.equal(got_sd[k], want_sd[k])]
    check(not bad, f"4j placed load: {len(bad)} pieces differ from "
          f"shard_llava_params (first {bad[:3]})")
    out["pieces"] = len(want_sd)
    out["mesh"] = how
    del tp_loaded, one, ref, got_sd, want_sd
    torch.cuda.empty_cache()
    return out


def tp_phase(dev, kernels, ctx4e, paths, tok):
    """Phase 4j: the verifier's decoder tensor-parallel over the mesh's
    model axis at LLaVA-v1.5-7B width and depth (4e's seeded weights),
    and the DP x TP contrastive step at B/32 width. Returns what phases 5
    and 6 read."""
    import copy

    from mmrs_tpu_torch.adapt import contrastive
    from mmrs_tpu_torch.cascade.verifier import LLaVAVerifier
    from mmrs_tpu_torch.config import MeshConfig
    from mmrs_tpu_torch.models import llava
    from mmrs_tpu_torch.models.clip import CLIP, CLIPConfig
    from mmrs_tpu_torch.models.configs import (CLIP_TEXT_B32, VIT_B32,
                                               VIT_L14_336)
    from mmrs_tpu_torch.models.llama import LLAMA2_7B, LLAMA_1B
    from mmrs_tpu_torch.ops.attention import mha_short_seq
    from mmrs_tpu_torch.ops.decode_attention import (chunk_attention,
                                                     decode_attention)
    from mmrs_tpu_torch.ops.mlp_int8 import mlp_int8_fused
    from mmrs_tpu_torch.ops.preprocess import normalize_images
    from mmrs_tpu_torch.parallel.mesh import make_mesh
    from mmrs_tpu_torch.parallel.vlm import (
        make_tp_llava_speculative_generate, replicate_llama_params,
        shard_llava_params)

    bf16 = torch.bfloat16
    tol = PREFILL_LOGIT_TOL["bf16"]
    ctx = {"launches": {}, "report": [], "times": {}}
    t0 = time.perf_counter()
    devs, how = tp_devices(max(TP_WIDTHS))
    meshes = {t: make_mesh(MeshConfig(data_size=1, model_size=t), devs[:t])
              for t in TP_WIDTHS}
    ctx["report"].append(f"4j mesh: {how}")
    cfg = llava.LLaVAConfig(vision=VIT_L14_336, lm=LLAMA2_7B)
    model = llava.LLaVA(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev, dtype=bf16).requires_grad_(False)
    draft = llava.LLaVA(llava.LLaVAConfig(vision=VIT_L14_336, lm=LLAMA_1B),
                        torch.Generator(device=dev).manual_seed(SEED + 1),
                        device=dev, dtype=bf16).requires_grad_(False)
    int8_model = ctx4e["model"]

    def counts():
        return {fn.__name__: fn.launches for fn in kernels}

    def reset():
        for fn in kernels:
            fn.launches = 0

    def serve(m, mesh=None, **kw):
        return LLaVAVerifier(m, cfg, tok, max_new_tokens=LLAVA_MAX_NEW,
                             prefill_chunk=64, early_stop=True, device=dev,
                             mesh=mesh, **kw)

    v1 = serve(model)
    pack = paths[:VERIFY_BATCH]
    images = torch.cat([v1._load_image(p) for p in pack])
    pre_ids, post_ids = v1._prompt_ids(v1.prompt_template.format(
        category="cat"))
    pre, post = v1._ids(pre_ids, VERIFY_BATCH), v1._ids(post_ids,
                                                         VERIFY_BATCH)
    with torch.inference_mode():
        emb = llava.build_multimodal_embeds(
            model, pre, llava.encode_images(model, images, bf16), post, bf16)
    cache_len = -(-(emb.shape[1] + LLAVA_MAX_NEW) // 64) * 64
    # the one-device kernel route's trace of this pack (4e (1)): the
    # reference of the checks below; 4j's model is 4e's, from the seed
    ek, lk, tk, mk = ctx4e["traces"]["bf16"]
    check(torch.equal(emb, ek), "4j: the pack's embeddings differ from "
          "4e's (not the same model or inputs)")
    ctx["times"]["tp1"] = (ctx4e["e2e"]["bf16"]["decode_step_ms"],
                           ctx4e["pack_s"]["bf16"] * 1e3)

    def timed(fn):
        """(fn(), seconds), the card synchronized around it."""
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1

    def forced(lm, emb, tokens, what):
        """lm fed `tokens` [B, steps], held by token_check to TP_TOKEN_GAP
        and TOKEN_FLOOR: (how far the fed tokens lie below lm's best at
        most; the steps where lm picks the same token)."""
        with torch.inference_mode():
            _, tf, _, gaps = greedy_trace(lm, emb, None, "auto",
                                          tokens.shape[1], forced=tokens)
        return token_check(gaps, tf == tokens, TP_TOKEN_GAP, TOKEN_FLOOR,
                           what)

    laps = {"setup": time.perf_counter() - t0}

    def lap(name):
        laps[name] = time.perf_counter() - t0 - sum(laps.values())

    # (1) bf16 at TP = 2 and 4: logits and tokens against one device
    trace = {}
    for tp, mesh in meshes.items():
        sh = shard_llava_params(model, mesh)
        row = sh.rows[0]
        reset()
        verdicts, pack_s = timed(lambda: serve(sh, mesh).verify_batch(
            pack, "cat"))
        c = counts()
        st = {}
        with torch.inference_mode():
            lt, tt, mt, _ = greedy_trace(row.lm, emb, None, "auto",
                                         LLAVA_MAX_NEW, stats=st)
        ctx["times"][f"tp{tp}"] = (st["step_ms"], pack_s * 1e3)
        ctx["launches"][f"bf16_tp{tp}"] = c
        for fn in (mha_short_seq, normalize_images, chunk_attention,
                   decode_attention):
            check(c[fn.__name__] > 0,
                  f"4j bf16 TP={tp}: {fn.__name__} never launched")
        want = (LLAMA2_7B.layers, VERIFY_BATCH, LLAMA2_7B.kv_heads // tp,
                cache_len, LLAMA2_7B.head_dim)
        check(st["cache"] == {want}, f"4j TP={tp}: shard caches "
              f"{st['cache']}, want {want}")
        err = float((lt - lk).abs().max())
        check(err <= tol, f"4j bf16 TP={tp}: prefill logits differ from one "
              f"device's by {err} (limit {tol})")
        agreed = agreed_steps(tt, tk, mk, 2 * tol)
        # one device fed the TP tokens: each near its best
        gap, same = forced(model.lm, emb, tt, f"4j bf16 TP={tp}")
        trace[tp] = (tt, mt)
        ctx["report"].append(
            f"(1) bf16 TP={tp}: a pack of {VERIFY_BATCH} through "
            f"verify_batch ({sum(verdicts)} verified), K10 "
            f"{c['chunk_attention']} / K11 {c['decode_attention']} launches "
            f"on shard caches {list(want)}; prefill logits max|d| vs one "
            f"device {err:.4f} (limit {tol}); report only: tokens = one "
            f"device's for {agreed} of {tk.numel()} steps (to each row's "
            f"first top-2 margin < {2 * tol}; one device's margins median "
            f"{float(mk.median()):.4f}); fed the TP tokens, one device picks "
            f"the same at {same} of {tt.numel()} steps, every TP token "
            f"within {gap:.4f} of its best (limit {TP_TOKEN_GAP}; floor {TOKEN_FLOOR})")
        lap(f"bf16_tp{tp}")
        if tp == 2:
            sh2 = sh
            ctx["profile_tp2"] = profile_device(lambda: llava.generate(
                row, images, pre, post, LLAVA_MAX_NEW, -1, bf16,
                prefill_chunk=64))
            lap("profile_tp2")
        else:
            del sh
        del row
    # (2) int8 weights + int8 KV at TP = 2: bit-equal to 4e's int8 run
    reset()
    v8 = serve(int8_model, meshes[2], kv_dtype=torch.int8)
    v8.verify_batch(pack, "cat")
    ctx["launches"]["int8_tp2"] = counts()
    check(ctx["launches"]["int8_tp2"]["mlp_int8_fused"] > 0,
          "4j int8 TP=2: mlp_int8_fused never launched")
    e8, l1, t1_, _ = ctx4e["traces"]["int8"]
    with torch.inference_mode():
        l2, t2_, _, _ = greedy_trace(v8.params.rows[0].lm, e8, torch.int8,
                                     "auto", LLAVA_MAX_NEW)
    check(torch.equal(l1, l2), f"4j int8 TP=2: prefill logits differ from "
          f"one device's (max|d| {float((l1 - l2).abs().max())})")
    check(torch.equal(t1_, t2_), "4j int8 TP=2: tokens differ from one "
          "device's")
    ctx["report"].append(
        f"(2) int8 weights + int8 KV, TP=2: prefill logits and all "
        f"{t2_.numel()} tokens bit-equal to 4e's one-device int8 run")
    del v8
    lap("int8")
    # (3) speculative, the 1.1B draft replicated and sharded, k = 4: the
    # TP=2 model fed the speculative tokens finds each near its best
    tt2, mt2 = trace[2]
    seen = None     # (tokens, gap, same) of the last draft's run
    for kind, place in (("replicated", replicate_llama_params),
                        ("sharded", shard_llava_params)):
        gen = make_tp_llava_speculative_generate(
            cfg, draft.cfg, meshes[2], LLAVA_MAX_NEW, 4, -1, bf16,
            prefill_chunk=64, return_stats=True)
        dparams = place(draft, meshes[2])
        reset()
        t1 = time.perf_counter()
        toks, st = gen(sh2, dparams, images, pre, post)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        ctx["launches"][f"spec_{kind}"] = counts()
        agreed = agreed_steps(toks, tt2, mt2, 2 * tol)
        if seen is None or not torch.equal(toks, seen[0]):
            seen = (toks, *forced(sh2.rows[0].lm, emb, toks,
                                  f"4j speculative ({kind} draft)"))
        gap, same = seen[1:]
        b = toks.shape[0]
        util = (float(st["emitted"].sum()) - b) / (st["rounds"] * b * 5)
        ctx["report"].append(
            f"(3) speculative TP=2, {kind} draft (k=4): {secs:.2f} s, "
            f"{st['rounds']} rounds, slot utilization {util:.3f}; report: tokens = "
            f"TP=2 greedy for {agreed} of {tt2.numel()} steps (to the first "
            f"near-tie); fed its tokens, the TP=2 model picks the same at "
            f"{same} of {toks.numel()} steps, every token within {gap:.4f} "
            f"of its best (limit {TP_TOKEN_GAP}; floor {TOKEN_FLOOR})")
        del dparams
    lap("speculative")
    # (4) DP x TP 2 x 2: 7 JPEGs padded to 8, verdicts = one device's
    mesh22 = make_mesh(MeshConfig(data_size=2, model_size=2), devs[:4])
    few = paths[:TP_DP_IMAGES]
    one = serve(model, eos_token=-1)
    dp = serve(model, mesh22, eos_token=-1)
    reset()
    h_dp = dp.verify_batch_async(few, "cat")
    c = counts()
    ctx["launches"]["dp2_tp2"] = c
    tok_dp = h_dp[0]
    check(tok_dp.shape[0] == VERIFY_BATCH, f"4j DP x TP: {tok_dp.shape[0]} "
          f"rows decoded, want {TP_DP_IMAGES} padded to {VERIFY_BATCH}")
    got = dp.collect(h_dp)
    want = one.collect(one.verify_batch_async(few, "cat"))
    check(got == want, f"4j DP x TP verdicts {got} != one device's {want}")
    # the real rows are the pack's first ones: each row decodes alone, so
    # one device's trace of the pack holds their tokens and margins, and
    # one device fed their tokens finds each near its best
    n = TP_DP_IMAGES
    agreed = agreed_steps(tok_dp[:n], tk[:n], mk[:n], 2 * tol)
    gap, same = forced(model.lm, emb[:n], tok_dp[:n], "4j DP x TP")
    ctx["report"].append(
        f"(4) DP x TP 2x2: {n} JPEGs padded to {tok_dp.shape[0]} rows, "
        f"report: tokens = one device's for {agreed} of {tk[:n].numel()} "
        f"steps; fed "
        f"the rows' tokens, one device picks the same at {same} of "
        f"{tok_dp[:n].numel()} steps, every token within {gap:.4f} of its "
        f"best (limit {TP_TOKEN_GAP}; floor {TOKEN_FLOOR}); verdicts {got} = one device's; K10 "
        f"{c['chunk_attention']} / K11 {c['decode_attention']} / K2 "
        f"{c['mha_short_seq']} launches")
    del one, dp, sh2, model, draft
    torch.cuda.empty_cache()
    lap("dp_tp")
    # (6) the DP x TP contrastive step at B/32 width, batch 32
    reset()
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    a = CLIP(CLIPConfig(vision=VIT_B32, text=CLIP_TEXT_B32),
             torch.Generator().manual_seed(SEED)).to(dev)
    b_ = copy.deepcopy(a)
    imgs = torch.randn((CONTRASTIVE_BATCH, 224, 224, 3), device=dev,
                       generator=g)
    toks = torch.randint(1, 49407, (CONTRASTIVE_BATCH, 77), device=dev,
                         generator=g)
    toks[:, 20] = 49407
    before = {k: v.clone() for k, v in a.state_dict().items()}
    f32 = torch.float32
    s1, o1 = contrastive.make_train_step(a, learning_rate=CONTRASTIVE_LR,
                                         compute_dtype=f32)
    s2, o2 = contrastive.make_train_step(b_, mesh=mesh22,
                                         learning_rate=CONTRASTIVE_LR,
                                         compute_dtype=f32)

    def grad_norm(opt):
        return math.sqrt(sum(float(p.grad.double().pow(2).sum())
                             for grp in opt.param_groups
                             for p in grp["params"] if p.grad is not None))

    losses, norms, ms = [], [], {"one": [], "mesh": []}
    for _ in range(TP_CONTRASTIVE_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        la = float(s1(imgs, toks))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        lb = float(s2(imgs, toks))
        torch.cuda.synchronize()
        ms["one"].append((t2 - t1) * 1e3)
        ms["mesh"].append((time.perf_counter() - t2) * 1e3)
        losses.append((la, lb))
        norms.append((grad_norm(o1), grad_norm(o2)))
    ltol, gtol = CONTRASTIVE_TOL["float32"]
    for i, ((la, lb), (ga, gb)) in enumerate(zip(losses, norms)):
        check(abs(la - lb) / la <= ltol and abs(ga - gb) / ga <= gtol,
              f"4j contrastive step {i + 1}: loss {lb} / grad norm {gb} "
              f"over the 2x2 mesh vs one device's {la} / {ga}")
    sa, sb = a.state_dict(), b_.state_dict()
    # Adam moves a weight by about lr a step whatever its gradient's size,
    # so a gradient within rounding of 0 may step either way: a key bias's
    # exact gradient is 0 (it shifts a softmax row alike), so those only
    # keep the bound of 2 lr a step; the other updates agree to the
    # gradient's tolerance, taken over the whole update
    zero = [k for k in sa if k.endswith("attn.wk.bias")]
    rest = [k for k in sa if k not in zero]
    moved = sum(float((sa[k] - before[k]).double().pow(2).sum())
                for k in rest)
    apart = sum(float((sa[k] - sb[k]).double().pow(2).sum()) for k in rest)
    worst = max(float((sa[k] - sb[k]).abs().max()) for k in sa)
    rel = math.sqrt(apart / moved)
    check(rel <= gtol and worst <= 2 * TP_CONTRASTIVE_STEPS * CONTRASTIVE_LR
          * 1.01, f"4j contrastive: updates differ by {rel:.3e} of their "
          f"norm (limit {gtol}), at most {worst:.3e} a weight")
    c = counts()
    ctx["launches"]["contrastive_2x2"] = c
    check(c["mha_short_seq"] == 0, "4j contrastive steps launched K2")
    ctx["times"]["contrastive_ms"] = ms
    ctx["report"].append(
        f"(6) contrastive ViT-B/32 + text B/32, batch {CONTRASTIVE_BATCH}, "
        f"f32 compute, 2x2 mesh: losses (one device / mesh) "
        + ", ".join(f"{la:.6f} / {lb:.6f}" for la, lb in losses)
        + ", grad norms " + ", ".join(f"{ga:.4f} / {gb:.4f}"
                                      for ga, gb in norms)
        + f"; updated weights (key biases aside) apart by {rel:.3e} of the "
        f"update's norm (limit {gtol}), every weight within {worst:.3e} "
        f"(limit 2 lr a step); K2 launches 0; ms a step one device / mesh "
        + ", ".join(f"{x:.1f} / {y:.1f}" for x, y in zip(ms["one"],
                                                       ms["mesh"])))
    del a, b_, o1, o2, s1, s2, sa, sb, before
    lap("contrastive")
    ctx["s"] = laps
    return ctx


# ---- phase 4f: the bilingual (EN + CN) union path -----------------------------

def _rand_state(dev, g, shapes):
    """{key: shape} -> numpy f16 arrays made on the card from `g`: N(0,
    0.02) weights, N(0, 0.01) embeddings, unit LayerNorm scales, zero
    biases (the JAX inits' distributions); logit_scale ln(1 / 0.07)."""
    out = {}
    for key, shape in shapes.items():
        if key.endswith("logit_scale"):
            out[key] = np.asarray(math.log(1 / 0.07), np.float32)
            continue
        if "norm" in key.lower() or ".ln_" in key or key.startswith("ln_"):
            val = 1.0 if key.endswith("weight") else 0.0
            out[key] = np.full(shape, val, np.float16)
        elif key.endswith("bias"):
            out[key] = np.zeros(shape, np.float16)
        else:
            std = 0.01 if "embedding" in key else 0.02
            out[key] = (std * torch.randn(shape, device=dev, generator=g)
                        ).half().cpu().numpy()
    return out


def _hf_layers(prefix: str, layers: int, w: int):
    shapes = {}
    for i in range(layers):
        p = f"{prefix}.layers.{i}"
        for n in ("q", "k", "v", "out"):
            shapes[f"{p}.self_attn.{n}_proj.weight"] = (w, w)
            shapes[f"{p}.self_attn.{n}_proj.bias"] = (w,)
        for n in ("layer_norm1", "layer_norm2"):
            shapes[f"{p}.{n}.weight"] = shapes[f"{p}.{n}.bias"] = (w,)
        shapes[f"{p}.mlp.fc1.weight"], shapes[f"{p}.mlp.fc1.bias"] = \
            (4 * w, w), (4 * w,)
        shapes[f"{p}.mlp.fc2.weight"], shapes[f"{p}.mlp.fc2.bias"] = \
            (w, 4 * w), (w,)
    return shapes


def hf_clip_shapes(v, t):
    """Key -> shape of an HF CLIPModel state dict (what `mmrs-torch
    weights convert --source hf_clip` reads)."""
    w, tw = v.width, t.width
    shapes = {
        "vision_model.embeddings.class_embedding": (w,),
        "vision_model.embeddings.patch_embedding.weight":
            (w, 3, v.patch_size, v.patch_size),
        "vision_model.embeddings.position_embedding.weight": (v.seq_len, w),
        "vision_model.pre_layrnorm.weight": (w,),
        "vision_model.pre_layrnorm.bias": (w,),
        "vision_model.post_layernorm.weight": (w,),
        "vision_model.post_layernorm.bias": (w,),
        "visual_projection.weight": (v.embed_dim, w),
        "text_model.embeddings.token_embedding.weight": (t.vocab_size, tw),
        "text_model.embeddings.position_embedding.weight":
            (t.context_length, tw),
        "text_model.final_layer_norm.weight": (tw,),
        "text_model.final_layer_norm.bias": (tw,),
        "text_projection.weight": (t.embed_dim, tw),
        "logit_scale": ()}
    shapes.update(_hf_layers("vision_model.encoder", v.layers, w))
    shapes.update(_hf_layers("text_model.encoder", t.layers, tw))
    return shapes


def hf_bert_shapes(b):
    """Key -> shape of an HF BertForSequenceClassification state dict
    (`--source taiyi`)."""
    h, inter = b.hidden_size, b.intermediate_size
    shapes = {
        "bert.embeddings.word_embeddings.weight": (b.vocab_size, h),
        "bert.embeddings.position_embeddings.weight":
            (b.max_position_embeddings, h),
        "bert.embeddings.token_type_embeddings.weight":
            (b.type_vocab_size, h),
        "bert.embeddings.LayerNorm.weight": (h,),
        "bert.embeddings.LayerNorm.bias": (h,),
        "bert.pooler.dense.weight": (h, h), "bert.pooler.dense.bias": (h,),
        "classifier.weight": (b.num_labels, h),
        "classifier.bias": (b.num_labels,)}
    for i in range(b.layers):
        p = f"bert.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            shapes[f"{p}.attention.self.{n}.weight"] = (h, h)
            shapes[f"{p}.attention.self.{n}.bias"] = (h,)
        shapes[f"{p}.attention.output.dense.weight"] = (h, h)
        shapes[f"{p}.attention.output.dense.bias"] = (h,)
        shapes[f"{p}.intermediate.dense.weight"] = (inter, h)
        shapes[f"{p}.intermediate.dense.bias"] = (inter,)
        shapes[f"{p}.output.dense.weight"] = (h, inter)
        shapes[f"{p}.output.dense.bias"] = (h,)
        for n in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[f"{p}.{n}.weight"] = shapes[f"{p}.{n}.bias"] = (h,)
    return shapes


def openai_clip_shapes(v, t):
    """Key -> shape of an OpenAI `clip` package state dict
    (`--source openai_clip`)."""
    w, tw = v.width, t.width
    shapes = {
        "visual.conv1.weight": (w, 3, v.patch_size, v.patch_size),
        "visual.class_embedding": (w,),
        "visual.positional_embedding": (v.seq_len, w),
        "visual.ln_pre.weight": (w,), "visual.ln_pre.bias": (w,),
        "visual.ln_post.weight": (w,), "visual.ln_post.bias": (w,),
        "visual.proj": (w, v.embed_dim),
        "token_embedding.weight": (t.vocab_size, tw),
        "positional_embedding": (t.context_length, tw),
        "ln_final.weight": (tw,), "ln_final.bias": (tw,),
        "text_projection": (tw, t.embed_dim), "logit_scale": ()}
    for prefix, width, n in (("visual.transformer", w, v.layers),
                             ("transformer", tw, t.layers)):
        for i in range(n):
            p = f"{prefix}.resblocks.{i}"
            shapes.update({
                f"{p}.attn.in_proj_weight": (3 * width, width),
                f"{p}.attn.in_proj_bias": (3 * width,),
                f"{p}.attn.out_proj.weight": (width, width),
                f"{p}.attn.out_proj.bias": (width,),
                f"{p}.ln_1.weight": (width,), f"{p}.ln_1.bias": (width,),
                f"{p}.ln_2.weight": (width,), f"{p}.ln_2.bias": (width,),
                f"{p}.mlp.c_fc.weight": (4 * width, width),
                f"{p}.mlp.c_fc.bias": (4 * width,),
                f"{p}.mlp.c_proj.weight": (width, 4 * width),
                f"{p}.mlp.c_proj.bias": (width,)})
    return shapes


def union_jpegs(root: str, n: int, seed: int):
    """n seeded 256 x 256 JPEGs in two class folders: `lychee` (red-heavy
    colour fields) and `other` (blue-heavy), plus noise."""
    from PIL import Image

    for i in range(n):
        cls = "lychee" if i % 2 == 0 else "other"
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        rng = np.random.default_rng([seed, i])
        cells = rng.uniform(0, 160, (5, 5, 3))
        cells[..., 0 if cls == "lychee" else 2] += 95
        img = Image.fromarray(cells.astype(np.uint8)).resize(
            (256, 256), Image.BICUBIC)
        arr = np.asarray(img).astype(np.int16) + rng.integers(
            -12, 13, (256, 256, 3))
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
            os.path.join(root, cls, f"{cls}_{i:03d}.jpg"), quality=92)


# CN query and prompt, and the WordPiece vocab the phase writes for them
CN_QUERY = "一张荔枝的图片"
CN_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "一", "张", "荔",
            "枝", "的", "图", "片", "狗", "猫"]
UNION_IMAGES = 48
UNION_BATCH = 64        # phase 6's ViT-L/14 embed batch
UNION_MARGIN = 2e-3     # decisions compared where |sim - threshold| exceeds it
TAIYI_BATCH = 32        # phase 6's Taiyi text encode batch (16 tokens)


def bilingual_phase(dev, root: str, kernels, cli):
    """Phase 4f: the bilingual path at full width from seeded weights.
    HF-layout state dicts written as f16 safetensors (CLIP ViT-L/14,
    Taiyi RoBERTa-large classifier, OpenAI ViT-B/32), converted by
    `mmrs-torch weights convert`, the CN pair assembled; then `index
    build` (CN L/14), `search --text ... --vocab` and `union` (EN B/32 +
    CN L/14) as a user runs them, with the launch counts reset before and
    read after; then the same weights through the plain route (K1-K3
    plain). Returns what phases 5 and 6 read."""
    import shutil

    from mmrs_tpu_torch.config import load as load_config
    from mmrs_tpu_torch.govern.bilingual import score_dataset
    from mmrs_tpu_torch.index.gallery import GalleryIndex
    from mmrs_tpu_torch.io.dataset import FolderDataset
    from mmrs_tpu_torch.io.images import load_image
    from mmrs_tpu_torch.models import checkpoint, clip, release
    from mmrs_tpu_torch.models.configs import (CLIP_TEXT_B32, CLIP_TEXT_L14,
                                               TAIYI_ROBERTA_LARGE, VIT_B32,
                                               VIT_L14)
    from mmrs_tpu_torch.models.tokenizer import (BertWordPieceTokenizer,
                                                 CLIPTokenizer)
    from mmrs_tpu_torch.ops.preprocess import normalize_images
    from mmrs_tpu_torch.ops.topk import cosine_topk
    from mmrs_tpu_torch.pipeline import build_towers

    ctx = {"report": [], "s": {}}
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    sources = {"l14": ("hf_clip", hf_clip_shapes(VIT_L14, CLIP_TEXT_L14)),
               "taiyi": ("taiyi", hf_bert_shapes(TAIYI_ROBERTA_LARGE)),
               "b32": ("openai_clip", openai_clip_shapes(VIT_B32,
                                                         CLIP_TEXT_B32))}
    need = 3 * sum(2 * math.prod(s) for _, sh in sources.values()
                   for s in sh.values())
    free = shutil.disk_usage(root).free
    check(free > need, f"4f: {free / 2 ** 30:.1f} GiB free under {root}, "
                       f"{need / 2 ** 30:.1f} needed")
    npz = {}
    for name, (source, shapes) in sources.items():
        t1 = time.perf_counter()
        st = os.path.join(root, f"{name}.safetensors")
        release.write_safetensors(st, _rand_state(dev, g, shapes))
        t2 = time.perf_counter()
        npz[name] = os.path.join(root, f"{name}.npz")
        arch = "b32" if name == "b32" else "l14"
        code, lines = cli(["weights", "convert", "--source", source,
                           "--arch", arch, "--input", st, "--out",
                           npz[name]])
        check(code == 0 and lines[-1] == json.dumps(
            {"out": npz[name], "int8": False}),
            f"weights convert --source {source}: exit {code}, {lines[-3:]}")
        ctx["report"].append(
            f"4f weights: {source} ({len(shapes)} tensors, "
            f"{sum(math.prod(s) for s in shapes.values()) / 1e6:.1f} M "
            f"params, f16 safetensors {os.path.getsize(st) / 2 ** 20:.0f} "
            f"MiB written in {t2 - t1:.1f} s) -> `mmrs-torch weights convert "
            f"--source {source} --arch {arch}` {time.perf_counter() - t2:.1f}"
            f" s ({os.path.getsize(npz[name]) / 2 ** 20:.0f} MiB npz)")
        os.remove(st)
    # the CN pair as mmrs_tpu/pipeline.py loads it: the L/14 image tower,
    # the Taiyi text tower, a logit scale
    l14 = checkpoint.load_npz(npz["l14"])
    cn = os.path.join(root, "cn.npz")
    checkpoint.save_npz({"visual": l14["visual"],
                         "text": checkpoint.load_npz(npz["taiyi"]),
                         "logit_scale": l14["logit_scale"]}, cn)
    del l14
    for name in ("l14", "taiyi"):
        os.remove(npz[name])
    folder = os.path.join(root, "folder")
    union_jpegs(folder, UNION_IMAGES, SEED)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w", encoding="utf-8") as f:
        f.write("\n".join(CN_VOCAB) + "\n")
    merges = os.path.join(root, "merges.txt")
    with open(merges, "w") as f:
        f.write("#version: 0.2\nl y\nly c\nlyc h\nlych e\nlyche e</w>\n")
    cn_yaml, en_yaml = (os.path.join(root, f"{n}.yaml") for n in ("cn", "en"))
    with open(cn_yaml, "w") as f:
        f.write(f"model:\n  image_tower: vit_l14\n  text_tower: "
                f"taiyi_roberta\n  dtype: bfloat16\n  checkpoint_path: {cn}\n")
    with open(en_yaml, "w") as f:
        f.write(f"model:\n  image_tower: vit_b32\n  dtype: bfloat16\n"
                f"  checkpoint_path: {npz['b32']}\n")
    ctx["s"]["setup"] = time.perf_counter() - t0

    # the path as a user runs it, launch counts from this run alone
    for fn in kernels:
        fn.launches = 0
    t1 = time.perf_counter()
    index = os.path.join(root, "cn_index")
    code, lines = cli(["index", "build", "--root", folder, "--out", index,
                       "--config", cn_yaml])
    built = json.loads(lines[-1]) if code == 0 else {}
    check(code == 0 and built.get("entries") == UNION_IMAGES
          and built.get("dim") == VIT_L14.embed_dim,
          f"4f index build: exit {code}, {lines[-3:]}")
    code, hits = cli(["search", "--index", index, "--text", CN_QUERY,
                      "--vocab", vocab, "-k", "10", "--config", cn_yaml])
    rows = [h.split("\t") for h in hits]
    check(code == 0 and len(rows) == 10 and all(len(r) == 5 for r in rows),
          f"4f search --vocab: exit {code}, {hits[-3:]}")
    uout = os.path.join(root, "union")
    code, lines = cli(["union", "--root", folder, "--positive-class",
                       "lychee", "--out", uout, "--config", en_yaml,
                       "--prompt", "a photo of {}", "--merges", merges,
                       "--cn-prompt", CN_QUERY, "--vocab", vocab,
                       "--cn-checkpoint", cn, "--cn-image-tower", "vit_l14"])
    union = json.loads(lines[-1]) if code == 0 else {}
    check(code == 0 and set(union) == {"class", "en_threshold",
                                       "cn_threshold", "union_pass", "f1"}
          and all(math.isfinite(union[k]) for k in ("en_threshold",
                                                    "cn_threshold", "f1")),
          f"4f union: exit {code}, {lines[-3:]}")
    ctx["s"]["cli"] = time.perf_counter() - t1
    ctx["launches"] = {fn.__name__: fn.launches for fn in kernels}
    for name in ("cosine_topk", "mha_short_seq", "normalize_images"):
        check(ctx["launches"][name] > 0, f"{name} never launched in 4f")
    ctx["report"].append(
        f"4f CLI (CN ViT-L/14 + Taiyi RoBERTa-large, EN ViT-B/32, bf16): "
        f"index build {UNION_IMAGES} JPEGs -> {json.dumps(built)}; search "
        f"--text {CN_QUERY} --vocab: top hit {rows[0][3]} (score x logit "
        f"scale {rows[0][2]}); "
        f"union -> {json.dumps(union)}; {ctx['s']['cli']:.1f} s; launches "
        f"{json.dumps({k: v for k, v in ctx['launches'].items() if v})}")

    # the plain route (K1-K3 plain) on the same converted weights
    t1 = time.perf_counter()
    cn_towers = build_towers(load_config(cn_yaml), device=dev,
                             tokenizer=BertWordPieceTokenizer.from_vocab_file(
                                 vocab))
    en_towers = build_towers(load_config(en_yaml), device=dev,
                             tokenizer=CLIPTokenizer.from_file(merges))
    bf16 = torch.bfloat16

    def plain_encode(towers):
        def encode(pixels_u8):
            x = normalize_images(torch.from_numpy(pixels_u8).to(dev),
                                 dtype=bf16, impl="torch")
            return clip.encode_image(towers.params, x, bf16,
                                     impl="torch").cpu().numpy()
        return encode

    idx = GalleryIndex.load(index)
    px = np.stack([load_image(os.path.join(folder, p) if not os.path.isabs(p)
                              else p).pixels for p in idx.paths])
    plain_gal = plain_encode(cn_towers)(px)
    cos = float((np.asarray(idx.embeddings, np.float32) * plain_gal).sum(1)
                .min())
    check(cos >= 0.999, f"4f index embeddings vs plain route: cosine {cos}")
    tq = torch.from_numpy(cn_towers.text_encode([CN_QUERY])).to(dev)
    rv, ri = cosine_topk(tq.to(bf16), torch.from_numpy(plain_gal).to(dev)
                         .to(bf16), 11, impl="torch")
    got = {r[4]: float(r[2]) for r in rows}
    ref_paths = [idx.paths[int(i)] for i in ri[0, :10]]
    gaps = (rv[0, :-1] - rv[0, 1:]).double().abs().cpu().numpy()
    for j in range(10):
        left = gaps[j - 1] if j else float("inf")
        if min(left, gaps[j]) > UNION_MARGIN:
            check(rows[j][4] == ref_paths[j],
                  f"4f search rank {j}: {rows[j][4]} vs plain {ref_paths[j]}")
    ctx["report"].append(
        f"4f plain route: index embeddings cosine to plain >= {cos:.6f}; "
        f"search top-10 ids = plain where its scores are > {UNION_MARGIN} "
        f"apart")
    decided = 0
    for which, towers, stack, thr, prompt in (
            ("en", en_towers, "openai", union["en_threshold"],
             "a photo of lychee"),
            ("cn", cn_towers, "hf", union["cn_threshold"], CN_QUERY)):
        temb = towers.text_encode([prompt])[0]
        ds = FolderDataset.from_root(folder, image_size=224, stack=stack)
        _, _, k_sims = score_dataset(ds, towers.image_encode, temb, 16)
        _, _, p_sims = score_dataset(ds, plain_encode(towers), temb, 16)
        far = np.abs(p_sims - thr) > UNION_MARGIN
        same = (k_sims >= thr) == (p_sims >= thr)
        check(bool(same[far].all()),
              f"4f union {which}: decisions differ from plain at "
              f"{int((~same & far).sum())} images away from the threshold")
        decided += int(far.sum())
    ctx["report"].append(
        f"4f union decisions (EN B/32, CN L/14) = the plain route's at the "
        f"CLI's thresholds for the {decided} of {2 * UNION_IMAGES} image "
        f"scores more than {UNION_MARGIN} from them; "
        f"{time.perf_counter() - t1:.1f} s")
    ctx["cn_towers"], ctx["en_towers"] = cn_towers, en_towers
    return ctx


# ---- phase 4g: adaptation and serving ----------------------------------------

ADAPT_CLASSES = 8
ADAPT_PER_CLASS = 12
ADAPT_SHOTS = 4
CONTRASTIVE_BATCH = 32
CONTRASTIVE_STEPS = 4
CONTRASTIVE_LR = 1e-5       # make_train_step's default
SERVE_CLIENTS = 16
SERVE_REQUESTS = 64
SERVE_VERIFY_IMAGES = 8
SERVE_CLUSTERS = 64
STREAM_ROWS = 1 << 20       # 1 GiB of f16 rows on disk
STREAM_CHUNK = 1 << 18
# served hits against direct engine queries: the served path encodes a
# query inside a micro-batch of others, where cuBLAS may sum in another
# order; scores (100 x cosine) within this, ids where the direct scores
# are further apart. An H100 has read 2.5e-4 at most (bf16 towers), and
# the next same-kind request's answer 8.5e-3 away at least
SERVE_SCORE_TOL = 2e-3
# the first contrastive step on the card against the CPU at f32: f32 on
# both (TF32 off; sums in other orders) to 1e-4 of the loss and 1e-3 of
# the gradient norm; the card's bf16 compute mix to 1e-3 and 5e-3 (about
# 60x and 20x the 1.6e-5 and 2.4e-4 it has read on an H100)
CONTRASTIVE_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (1e-3, 5e-3)}


def adapt_jpegs(root: str, seed: int):
    """ADAPT_CLASSES folders of ADAPT_PER_CLASS seeded 256 x 256 JPEGs:
    each image its class's coarse colour pattern, its own and noise."""
    from PIL import Image

    def coarse(*key):
        cells = np.random.default_rng([seed, *key]).uniform(0, 255,
                                                            (6, 6, 3))
        return np.asarray(Image.fromarray(cells.astype(np.uint8)).resize(
            (256, 256), Image.BICUBIC), np.float32)

    paths = []
    for c in range(ADAPT_CLASSES):
        os.makedirs(os.path.join(root, f"c{c}"), exist_ok=True)
        base = coarse(0, c)
        for i in range(ADAPT_PER_CLASS):
            noise = np.random.default_rng([seed, 1, c, i]).uniform(
                -16, 16, (256, 256, 3))
            img = 0.6 * base + 0.4 * coarse(2, c, i) + noise
            p = os.path.join(root, f"c{c}", f"c{c}_{i:02d}.jpg")
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                p, quality=92)
            paths.append(p)
    return paths


def plain_towers(towers, dev):
    """`towers` with its image encoders on the plain route (K3 and K2
    plain versions) on the same weights."""
    from mmrs_tpu_torch.models import clip
    from mmrs_tpu_torch.ops.preprocess import normalize_images
    from mmrs_tpu_torch.pipeline import Towers

    def encode(px, normalize=True):
        x = normalize_images(torch.from_numpy(np.ascontiguousarray(px))
                             .to(dev), dtype=torch.bfloat16, impl="torch")
        return clip.encode_image(towers.params, x, torch.bfloat16,
                                 normalize=normalize,
                                 impl="torch").cpu().numpy()

    return Towers(image_encode=encode, text_encode=towers.text_encode,
                  params=towers.params, clip_config=towers.clip_config,
                  image_encode_raw=lambda px: encode(px, False))


def hits_disagreement(served, direct):
    """Why one query's served hits differ from the engine's direct answer,
    or None: the same length, scores within SERVE_SCORE_TOL, paths equal
    where the direct scores are further apart than that."""
    if len(served) != len(direct):
        return f"{len(served)} hits vs {len(direct)}"
    ds = np.asarray([h.score for h in direct], np.float64)
    ss = np.asarray([h["score"] for h in served], np.float64)
    err = float(np.abs(ss - ds).max())
    if err > SERVE_SCORE_TOL:
        return f"scores differ by {err}"
    gap = np.full(len(ds), np.inf)
    gap[:-1] = ds[:-1] - ds[1:]
    gap[1:] = np.minimum(gap[1:], ds[:-1] - ds[1:])
    for j in np.flatnonzero(gap > SERVE_SCORE_TOL):
        if served[j]["path"] != direct[j].path:
            return f"rank {j} {served[j]['path']} vs {direct[j].path}"
    return None


def served_hits_agree(served, direct, what: str) -> float:
    """Checks `hits_disagreement`; returns the largest score difference."""
    why = hits_disagreement(served, direct)
    check(why is None, f"{what}: {why}")
    return max((abs(h["score"] - d.score) for h, d in zip(served, direct)),
               default=0.0)


def adapt_serve_phase(dev, root: str, kernels, cli, index):
    """Phase 4g: the few-shot adapter (`mmrs-torch adapter train --root`),
    contrastive steps at full ViT-B/32 width, the HTTP server over phase
    4a's index behind four engines and a LLaVA verifier, and the streaming
    scan of a 1 GiB memmap at prefetch 0 and 2. Returns what phases 5 and
    6 read."""
    import base64
    import copy
    import io as _io
    import threading
    import urllib.request

    from PIL import Image

    from mmrs_tpu_torch.adapt import contrastive, driver
    from mmrs_tpu_torch.adapt import tip_adapter as tip
    from mmrs_tpu_torch.cascade.verifier import LLaVAVerifier
    from mmrs_tpu_torch.config import Config, ModelConfig, SearchConfig
    from mmrs_tpu_torch.index.gallery import GalleryIndex
    from mmrs_tpu_torch.index.stream import _UploadRing, streaming_topk
    from mmrs_tpu_torch.models import llava
    from mmrs_tpu_torch.models.clip import CLIP, CLIPConfig
    from mmrs_tpu_torch.models.configs import (CLIP_TEXT_B32, VIT_B32,
                                               VIT_L14_336)
    from mmrs_tpu_torch.models.llama import LLAMA2_7B
    from mmrs_tpu_torch.models.sentencepiece import SentencePieceBPE
    from mmrs_tpu_torch.models.tokenizer import CLIPTokenizer
    from mmrs_tpu_torch.ops.attention import mha_short_seq
    from mmrs_tpu_torch.ops.topk import cosine_topk
    from mmrs_tpu_torch.pipeline import build_towers
    from mmrs_tpu_torch.search.engine import SearchEngine
    from mmrs_tpu_torch.serve import SearchService, make_server

    ctx = {"report": [], "launches": {}, "times": {}}
    names = [f"c{c}" for c in range(ADAPT_CLASSES)]

    def reset():
        for fn in kernels:
            fn.launches = 0

    def counts():
        return {fn.__name__: fn.launches for fn in kernels}

    # -- 1. the few-shot adapter, in process as a user runs it ------------
    folder = os.path.join(root, "fewshot")
    shot_paths = adapt_jpegs(folder, SEED + 40)
    merges = os.path.join(root, "merges.txt")
    with open(merges, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\np h\nph o\npho t\nphot o</w>\n")
    seen = {}
    run_few_shot, train_f = driver.run_few_shot, tip.train_tip_adapter_f

    def keep_run(*a, **kw):        # the CLI's run, kept for the checks
        seen["run"] = run_few_shot(*a, **kw)
        return seen["run"]

    def keep_inputs(*a, **kw):     # Tip-F's inputs, for the CPU rerun
        seen["tip_f"] = (a, kw)
        return train_f(*a, **kw)

    driver.run_few_shot, tip.train_tip_adapter_f = keep_run, keep_inputs
    try:
        reset()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        code, lines = cli(["adapter", "train", "--root", folder, "--merges",
                           merges, "--shots", str(ADAPT_SHOTS),
                           "--augment-epochs", "5", "--epochs", "20",
                           "--search-hp"])
        wall = time.perf_counter() - t1
    finally:
        driver.run_few_shot, tip.train_tip_adapter_f = run_few_shot, train_f
    ctx["launches"]["adapter"] = counts()
    check(code == 0, f"4g adapter train exited {code}")
    out = json.loads(lines[-1])
    check(set(out) == {"classes", "zero_shot_f1", "tip_f1", "best_f1",
                       "best_epoch", "hp"} and out["classes"] == names,
          f"4g adapter train printed {lines[-1][:200]}")
    for name in ("mha_short_seq", "normalize_images"):       # K2, K3
        check(ctx["launches"]["adapter"][name] > 0,
              f"4g adapter train did not launch {name}")
    run = seen["run"]
    check(len(run.result.history) == 20 and run.result.hp is not None
          and np.isfinite(run.result.hp.grid).all(), "4g Tip-F result")
    ctx["times"]["adapter_s"] = {"wall": wall, **run.seconds}

    # the same tree through the plain route (K3 and K2 plain versions)
    tok = CLIPTokenizer.from_file(merges)
    towers = build_towers(Config(model=ModelConfig(image_tower="vit_b32")),
                          tokenizer=tok, device=dev)
    plain = driver.run_few_shot(plain_towers(towers, dev), folder,
                                shots=ADAPT_SHOTS, augment_epoch=5,
                                epochs=20, run_search_hp=True)
    cos = float(np.min(np.sum(run.keys * plain.keys, axis=1)))
    check(cos >= 0.999, f"4g cache keys: cosine to the plain route {cos}")
    # Tip-Adapter-F on the card (the CLI's run) against the CPU, on the
    # same features
    a, kw = seen["tip_f"]
    a = [x.cpu() if isinstance(x, torch.Tensor) else x for x in a]
    cpu = train_f(*a, **dict(kw, device="cpu"))
    kerr = float(np.abs(run.result.adapter_keys - cpu.adapter_keys).max())
    check(kerr <= 1e-4, f"4g Tip-F keys card vs CPU differ by {kerr}")
    check(run.result.history == cpu.history,
          f"4g Tip-F history card {run.result.history} vs CPU "
          f"{cpu.history}")
    ctx["report"].append(
        f"4g adapter train --root ({ADAPT_CLASSES} classes x "
        f"{ADAPT_PER_CLASS} JPEGs, {ADAPT_SHOTS} shots, 5 augment epochs, "
        f"20 epochs, --search-hp; ViT-B/32 bf16, seed {SEED}): zero-shot F1 "
        f"{out['zero_shot_f1']:.4f}, Tip F1 {out['tip_f1']:.4f}, Tip-F "
        f"best {out['best_f1']:.4f} at epoch {out['best_epoch']}, hp "
        f"beta {out['hp']['beta']:.4f} alpha {out['hp']['alpha']:.4f} F1 "
        f"{out['hp']['f1']:.4f}; plain route: zero-shot F1 "
        f"{plain.zero_shot_f1:.4f}, Tip F1 {plain.tip_f1:.4f}, cache keys "
        f"cosine >= {cos:.6f}; Tip-F on the card vs the CPU: keys max|d| "
        f"{kerr:.2e}, history equal; launches "
        + json.dumps({k: v for k, v in ctx["launches"]["adapter"].items()
                      if v}) + f"; wall {wall:.2f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in run.seconds.items()) + ")")

    # -- 2. contrastive steps at full ViT-B/32 width ----------------------
    reset()
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    model = CLIP(CLIPConfig(vision=VIT_B32, text=CLIP_TEXT_B32),
                 torch.Generator().manual_seed(SEED)).to(dev)
    cpu_model = copy.deepcopy(model).cpu()
    images = torch.randn((CONTRASTIVE_BATCH, 224, 224, 3), device=dev,
                         generator=g)
    tokens = torch.randint(1, 49407, (CONTRASTIVE_BATCH, 77), device=dev,
                           generator=g)
    tokens[:, 20] = 49407          # EOT, the max id, at a fixed length

    def loss_and_grad_norm(m, imgs, toks, dtype):
        m.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = contrastive.contrastive_loss(m, imgs, toks, dtype)
            loss.backward()
        gn = math.sqrt(sum(float(p.grad.double().pow(2).sum())
                           for p in m.parameters() if p.grad is not None))
        m.zero_grad(set_to_none=True)
        return float(loss.detach()), gn

    ref = loss_and_grad_norm(cpu_model, images.cpu(), tokens.cpu(),
                             torch.float32)
    first = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        first[name] = loss_and_grad_norm(model, images, tokens, dtype)
        ltol, gtol = CONTRASTIVE_TOL[name]
        dl = abs(first[name][0] - ref[0]) / ref[0]
        dg = abs(first[name][1] - ref[1]) / ref[1]
        check(dl <= ltol and dg <= gtol,
              f"4g contrastive {name} step 1 on the card: loss "
              f"{first[name][0]} / grad norm {first[name][1]} vs the CPU's "
              f"f32 {ref} (relative {dl:.2e}, {dg:.2e})")
    step, _ = contrastive.make_train_step(model, learning_rate=CONTRASTIVE_LR)
    losses, step_ms = [], []
    for _ in range(CONTRASTIVE_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(step(images, tokens)))
        step_ms.append((time.perf_counter() - t1) * 1e3)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"4g contrastive losses {losses} do not fall")
    ctx["launches"]["contrastive"] = counts()
    check(ctx["launches"]["contrastive"]["mha_short_seq"] == 0,
          "4g contrastive steps launched K2")
    q = torch.randn((2, 50, 768), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    try:
        mha_short_seq(q, q, q, 12)
        refused = False
    except RuntimeError as e:
        refused = "autograd" in str(e)
    check(refused, "4g K2 ran on inputs that require grad")
    ctx["times"]["contrastive_step_ms"] = step_ms
    ctx["report"].append(
        f"4g contrastive ViT-B/32 + text B/32 at full width, batch "
        f"{CONTRASTIVE_BATCH}, bf16 compute, f32 master weights, AdamW lr "
        f"{CONTRASTIVE_LR}: losses " + ", ".join(f"{x:.6f}" for x in losses)
        + f"; step 1 vs the CPU f32 run (loss {ref[0]:.6f}, grad norm "
        f"{ref[1]:.6f}): card f32 {first['float32'][0]:.6f} / "
        f"{first['float32'][1]:.6f}, card bf16 {first['bfloat16'][0]:.6f} "
        f"/ {first['bfloat16'][1]:.6f}; K2 launches 0, K2 refuses inputs "
        f"that require grad; ms a step "
        + ", ".join(f"{x:.1f}" for x in step_ms))
    del model, cpu_model, step
    torch.cuda.empty_cache()

    # -- 3. the HTTP server over phase 4a's index --------------------------
    gidx = GalleryIndex(np.array(index.embeddings), list(index.paths),
                        list(index.classes))
    engines = {
        "bf16": lambda: SearchEngine(gidx, SearchConfig(), device=dev),
        "int8": lambda: SearchEngine(gidx, SearchConfig(), quantize="int8",
                                     device=dev),
        "int4": lambda: SearchEngine(gidx, SearchConfig(), quantize="int4",
                                     device=dev),
        # every bucket probed (nprobe = C): the exact answer through K7
        "ivf": lambda: SearchEngine(gidx, dataclasses.replace(
            SearchConfig(), ann="ivf", ann_clusters=SERVE_CLUSTERS,
            ann_nprobe=SERVE_CLUSTERS), device=dev),
    }
    def blob_of(path):
        with open(path, "rb") as f:
            return f.read()

    # image queries: lossless PNGs of gallery rows' own pixels (the
    # server's resize_center_crop keeps 224 px as they are); text
    # queries: seeded strings of different words and lengths. Distinct
    # queries, so that one request's hits fail against another's answer
    # (the negative control below)
    rng = np.random.default_rng(SEED + 42)
    rows = rng.choice(len(gidx), SERVE_REQUESTS // 2, replace=False)
    gallery = SyntheticImages(list(zip(gidx.paths, gidx.classes)))
    qpx = np.stack([gallery.image(gidx.paths[r], gidx.classes[r])
                    for r in rows])
    pngs = []
    for px in qpx:
        buf = _io.BytesIO()
        Image.fromarray(px).save(buf, format="PNG")
        pngs.append(base64.b64encode(buf.getvalue()).decode())
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    texts = [" ".join("".join(rng.choice(letters, rng.integers(2, 10)))
                      for _ in range(rng.integers(1, 12)))
             for _ in range(SERVE_REQUESTS // 2)]

    spm = os.path.join(root, "tokenizer.model")
    tiny_sentencepiece(spm)
    vlm = llava.LLaVA(
        llava.LLaVAConfig(vision=VIT_L14_336,
                          lm=dataclasses.replace(LLAMA2_7B, layers=2)),
        torch.Generator(device=dev).manual_seed(SEED + 43), device=dev,
        dtype=torch.bfloat16).requires_grad_(False)
    verifier = LLaVAVerifier(vlm, vlm.cfg, SentencePieceBPE.from_file(spm),
                             max_new_tokens=8, prefill_chunk=64,
                             early_stop=True, device=dev)

    def post(base, path, body):
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    def burst(base, jobs):
        """jobs from SERVE_CLIENTS threads at once: (answers, QPS, p50 ms,
        p99 ms per request)."""
        answers, lat, errors = {}, [], []
        barrier = threading.Barrier(SERVE_CLIENTS)

        def client(c):
            try:
                barrier.wait(timeout=120)
                for j in range(c, len(jobs), SERVE_CLIENTS):
                    t2 = time.perf_counter()
                    answers[j] = post(base, "/v1/search", jobs[j])["hits"][0]
                    lat.append((time.perf_counter() - t2) * 1e3)
            except Exception as e:  # noqa: BLE001 — checked below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t1
        check(not errors and len(answers) == len(jobs)
              and not any(t.is_alive() for t in threads),
              f"4g serve: {len(answers)} answers, errors {errors[:3]}")
        lat.sort()
        return (answers, len(jobs) / wall, lat[len(lat) // 2],
                lat[min(len(lat) - 1, int(0.99 * len(lat)))])

    # text, image, text, ... requests; the direct query of each
    jobs, direct_of = [], []
    for j in range(SERVE_REQUESTS):
        if j % 2 == 0:
            jobs.append({"text": texts[j // 2], "k": 10})
            direct_of.append(lambda e, t=texts[j // 2]: e.query_text(
                towers.text_encode([t]), top_k=10)[0])
        else:
            jobs.append({"image_b64": pngs[j // 2], "k": 10})
            direct_of.append(lambda e, x=j // 2: e.query_image(
                towers.image_encode(qpx[x:x + 1]), top_k=10)[0])

    serve_stats = {}
    served = dict.fromkeys(counts(), 0)    # the servers' own launches
    for rung, make in engines.items():
        engine = make()
        reset()
        svc = SearchService(engine, towers,
                            verifier=verifier if rung == "bf16" else None)
        srv = make_server(svc, host="127.0.0.1", port=0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            # the engine's first requests, then a warm burst, then one
            # under torch.profiler for the device's busy share
            runs = {"cold": burst(base, jobs), "warm": burst(base, jobs)}
            traced = {}
            prof = profile_device(
                lambda: traced.update(run=burst(base, jobs)), top=4)
            stats = json.loads(urllib.request.urlopen(
                base + "/v1/stats", timeout=60).read())["stages"]
            health = json.loads(urllib.request.urlopen(
                base + "/healthz", timeout=60).read())
            # one request at a time: a batch of one, as the direct query
            alone = [post(base, "/v1/search", body)["hits"][0]
                     for body in jobs]
            verify = None
            if rung == "bf16":
                blobs = [base64.b64encode(blob_of(p)).decode()
                         for p in shot_paths[::ADAPT_PER_CLASS][
                             :SERVE_VERIFY_IMAGES]]
                t2 = time.perf_counter()
                verify = post(base, "/v1/verify",
                              {"images_b64": blobs, "category": "c0",
                               "threshold": -1e9})["results"]
                serve_stats["verify_s"] = time.perf_counter() - t2
        finally:
            srv.shutdown()
            srv.server_close()
            svc.close()
            th.join(timeout=60)
        torch.cuda.synchronize()
        for name, n in counts().items():
            served[name] += n
        with torch.inference_mode():
            direct = [direct_of[j](engine) for j in range(len(jobs))]
        err, passed, apart = 0.0, [], {"text": np.inf, "image": np.inf}
        for j in range(len(jobs)):
            check([(h["path"], h["score"]) for h in alone[j]]
                  == [(h.path, h.score) for h in direct[j]],
                  f"4g serve {rung} request {j}: served hits != the direct "
                  f"engine query")
            for run, answers in (*((r, x[0]) for r, x in runs.items()),
                                 ("traced", traced["run"][0])):
                err = max(err, served_hits_agree(
                    answers[j], direct[j],
                    f"4g serve {rung} {run} concurrent request {j}"))
            # negative control: the next request of the same kind (one
            # micro-batch group) must not pass as this one's answer
            other = direct[(j + 2) % len(jobs)]
            if hits_disagreement(runs["warm"][0][j], other) is None:
                passed.append(j)
            kind = "image" if j % 2 else "text"
            apart[kind] = min(apart[kind], max(
                abs(h["score"] - d.score)
                for h, d in zip(runs["warm"][0][j], other)))
            # an image query's own row is in the top 3, except behind int4
            # codes: the random-weight tower's nearest rows score within
            # about 0.2 (of 100) of the own row, and 16 levels a dimension
            # reorder them
            if j % 2 and rung != "int4":
                own = gidx.paths[rows[j // 2]]
                check(own in [h.path for h in direct[j][:3]],
                      f"4g serve {rung} image query {j}: its own row {own} "
                      f"not in the top 3")
        check(not passed, f"4g serve {rung}: requests {passed}'s served hits "
              f"pass against the next same-kind request's direct answer")
        per_call = stats["query"]["items_per_call"]
        check(per_call > 1, f"4g serve {rung}: {per_call} items per query "
              f"dispatch")
        want_quant = {"int8": "int8", "int4": "int4"}.get(rung, "bf16")
        check(health["gallery_quant"] == want_quant
              and health["rows"] == len(gidx) and health["gallery_shards"]
              == 1 and ("ann" in health) == (rung == "ivf"),
              f"4g serve {rung}: healthz {health}")
        serve_stats[rung] = {
            **{run: dict(zip(("qps", "p50_ms", "p99_ms"), x[1:]))
               for run, x in runs.items()},
            "traced": {"wall_ms": prof[0], "device_ms": prof[1],
                       "busy": prof[1] / prof[0],
                       "top": [[k[:60], round(ms, 3), n]
                               for k, ms, n in prof[2]]},
            "items_per_call": per_call, "max_score_err": err,
            "control_min_score_diff": apart}
        if verify is not None:
            check(len(verify) == SERVE_VERIFY_IMAGES
                  and all(r["gate_passed"] for r in verify)
                  and all(isinstance(r["verified"], bool) for r in verify),
                  f"4g /v1/verify results {verify}")
        del engine
    ctx["launches"]["serve"] = served
    for name in ("cosine_topk", "mha_short_seq", "normalize_images",
                 "cosine_topk_quantized", "cosine_topk_int4",
                 "probe_buckets", "chunk_attention", "decode_attention"):
        check(served[name] > 0, f"4g serve run did not launch {name}")
    ctx["times"]["serve"] = serve_stats
    ctx["report"].append(
        f"4g serve over 4a's index ({len(gidx)} x {gidx.dim}), "
        f"{SERVE_REQUESTS} concurrent /v1/search (text and image: gallery "
        f"rows' own pixels) from {SERVE_CLIENTS} clients, three bursts a "
        f"rung (cold, warm, traced); each request alone = the direct engine "
        f"query (paths and scores); concurrent ones within {SERVE_SCORE_TOL} "
        f"of it, and none passes against the next same-kind request's "
        f"answer: "
        + "; ".join(
            f"{r} max|d| {s['max_score_err']:.6f} (next same-kind answer: "
            f"text {s['control_min_score_diff']['text']:.4f}, image "
            f"{s['control_min_score_diff']['image']:.4f} at least), cold "
            f"{s['cold']['qps']:.1f}"
            f" QPS p50 {s['cold']['p50_ms']:.1f} p99 {s['cold']['p99_ms']:.1f}"
            f" ms, warm {s['warm']['qps']:.1f} QPS p50 "
            f"{s['warm']['p50_ms']:.1f} p99 {s['warm']['p99_ms']:.1f} ms, "
            f"{s['items_per_call']:.2f} items a dispatch, traced burst "
            f"device {s['traced']['device_ms']:.1f} of "
            f"{s['traced']['wall_ms']:.1f} ms ({100 * s['traced']['busy']:.1f}"
            f"% busy; top {json.dumps(s['traced']['top'])})"
            for r, s in serve_stats.items() if isinstance(s, dict))
        + f"; /v1/verify of {SERVE_VERIFY_IMAGES} images through the LLaVA "
        f"verifier (7B width, 2 decoder layers, 8 new tokens) "
        f"{serve_stats['verify_s']:.2f} s; the servers' launches "
        + json.dumps({k: v for k, v in served.items() if v}))
    del vlm, verifier
    torch.cuda.empty_cache()

    # -- 4. the streaming scan of a memmapped 1 GiB gallery ---------------
    path = os.path.join(root, "stream.npy")
    out = np.lib.format.open_memmap(path, mode="w+", dtype=np.float16,
                                    shape=(STREAM_ROWS, DIM))
    g = torch.Generator(device=dev).manual_seed(SEED + 44)
    for a in range(0, STREAM_ROWS, STREAM_CHUNK):
        x = torch.randn((STREAM_CHUNK, DIM), device=dev, generator=g)
        out[a:a + STREAM_CHUNK] = (x / x.norm(dim=1, keepdim=True)
                                   ).half().cpu().numpy()
    out.flush()
    del out
    mm = np.load(path, mmap_mode="r")
    src = np.arange(8) * (STREAM_ROWS // 8) + 345
    q = np.asarray(mm[src], np.float32)
    with torch.inference_mode():
        whole = torch.from_numpy(np.array(mm)).to(dev).to(torch.bfloat16)
        fv, fi = cosine_topk(torch.from_numpy(q).to(dev).bfloat16(), whole,
                             11)
        del whole
    # what a call pays before it streams: its ring's pinned host buffers
    # (3 x 256 MiB at prefetch 2) on the first call, from the caching host
    # allocator's blocks on a later one
    ring_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _UploadRing(3, STREAM_CHUNK, DIM, torch.float16, dev)
        ring_ms.append((time.perf_counter() - t1) * 1e3)
    # the host's copy alone: memmap -> one pinned chunk buffer
    pinned = torch.empty((STREAM_CHUNK, DIM), dtype=torch.float16,
                         pin_memory=True)
    t1 = time.perf_counter()
    for a in range(0, STREAM_ROWS, STREAM_CHUNK):
        np.copyto(pinned.numpy(), mm[a:a + STREAM_CHUNK])
    host_gbs = mm.nbytes / (time.perf_counter() - t1) / 1e9
    del pinned
    gbs = {0: [], 2: []}
    for prefetch in (0, 2, 2, 0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        v, i = streaming_topk(mm, q, k=10, chunk_rows=STREAM_CHUNK,
                              device=dev, prefetch=prefetch)
        gbs[prefetch].append(mm.nbytes / (time.perf_counter() - t1) / 1e9)
        check((i[:, 0] == src).all(), f"4g stream prefetch {prefetch}: "
              f"top-1 is not the query's row")
        topk_agree(torch.from_numpy(v), torch.from_numpy(i), fv.cpu(),
                   fi.cpu().long(), tol=1e-5)
    ctx["times"]["stream_gbs"] = gbs
    ctx["times"]["stream"] = {"ring_ms": ring_ms, "host_copy_gbs": host_gbs}
    ctx["report"].append(
        f"4g streaming_topk over a memmapped {STREAM_ROWS} x {DIM} f16 file "
        f"({mm.nbytes / 2 ** 30:.2f} GiB), chunks of {STREAM_CHUNK}, Q=8, "
        f"k=10: ids = flat K1's over the same rows at prefetch 0 and 2; "
        f"GB/s (order 0, 2, 2, 0) prefetch 0 "
        + ", ".join(f"{x:.2f}" for x in gbs[0]) + "; prefetch 2 "
        + ", ".join(f"{x:.2f}" for x in gbs[2])
        + f"; a 3-slot ring's set-up {ring_ms[0]:.1f} ms first, "
        f"{ring_ms[1]:.1f} ms again; the host's memmap -> pinned copy alone "
        f"{host_gbs:.2f} GB/s")
    del mm
    os.remove(path)
    return ctx


# ---- phase 4h: the operations layer and the int4-weight LLaMA -----------------

OPS_CLASSES = ("lychee", "guitar", "baozi", "shirt")
OPS_PER_CLASS = 96
OPS_EZ = 32                   # ez_negative: the VQA easy negatives
OPS_HARD = 24                 # lychee_negative: lychee's hard negatives
# random-weight B/32 towers put distinct images at cosines up to ~0.998;
# the dedup tau sits above them, the planted copy (cosine 1) passes it
OPS_DEDUP_TAU = 0.9999
RANK_GATE_QUERIES = 64
INT4_LAYERS = 2               # LLaMA-2-7B width, 2 decoder layers + lm_head
INT4_GROUP = 128
INT4_PROMPT = 614             # the verifier's prompt length (phase 4e)
INT4_NEW = 32
INT4_STEPS = 16               # decode steps timed a model
PLAN_ROWS = (1_000_000, 10_000_000, 100_000_000)


def ops_tree(root: str, test_root: str, seed: int) -> dict:
    """The lifecycle's labeled tree: OPS_CLASSES x OPS_PER_CLASS seeded
    224-px JPEGs (a class's coarse colour pattern, the image's own and
    noise), a PNG (for the normalize report), one byte copy of a lychee
    image (the planted duplicate), the ez_negative and lychee_negative
    pools; and a held-out tree with byte copies of two training images
    (the leaks) and one new image. Returns what was planted."""
    import shutil

    from PIL import Image

    def coarse(*key):
        cells = np.random.default_rng([seed, *key]).uniform(0, 255,
                                                            (6, 6, 3))
        return np.asarray(Image.fromarray(cells.astype(np.uint8)).resize(
            (224, 224), Image.BICUBIC), np.float32)

    def image(folder: int, i: int):
        noise = np.random.default_rng([seed, 2, folder, i]).uniform(
            -16, 16, (224, 224, 3))
        img = 0.35 * coarse(0, folder) + 0.65 * coarse(1, folder, i) + noise
        return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))

    folders = [(c, OPS_PER_CLASS, k) for k, c in enumerate(OPS_CLASSES)]
    folders += [("ez_negative", OPS_EZ, 10), ("lychee_negative", OPS_HARD, 0)]
    for name, n, key in folders:
        os.makedirs(os.path.join(root, name), exist_ok=True)
        for i in range(n):
            # the hard negatives share lychee's pattern, not its images
            image(key, i + (1000 if name == "lychee_negative" else 0)).save(
                os.path.join(root, name, f"{name}_{i:03d}.jpg"), quality=92)
    image(1, 2000).save(os.path.join(root, "guitar", "guitar_png.png"))
    dup = (os.path.join(root, "lychee", "lychee_000.jpg"),
           os.path.join(root, "lychee", "lychee_dup.jpg"))
    shutil.copyfile(*dup)
    os.makedirs(os.path.join(test_root, "lychee"), exist_ok=True)
    leaks = []
    for j, src in enumerate(("lychee/lychee_001.jpg", "guitar/guitar_005.jpg")):
        dst = os.path.join(test_root, "lychee", f"held{j}.jpg")
        shutil.copyfile(os.path.join(root, src), dst)
        leaks.append((os.path.join(root, src), dst))
    image(0, 3000).save(os.path.join(test_root, "lychee", "held2.jpg"),
                        quality=92)
    return {"dup": dup, "leaks": leaks}


def ivf_geometry(ivf):
    """(rows, clusters, slots fraction, spill fraction) of an IVF index:
    the planner's knobs as this index realized them."""
    n = ivf.n_total
    spill = int((ivf.spill_ids >= 0).sum())
    return n, ivf.n_clusters, ivf.n_clusters * ivf.bucket_cap / n, spill / n


def planner_fit(flat_q1: dict, ivf_q1: dict, probe_q1_ms: float,
                ivfs) -> dict:
    """The planner's four constants as this run measures them (plan.py's
    docstring gives each one's definition) from the eager flat Q=1 top-10
    ms of each rung (`flat_q1`), the eager IVF Q=1 top-10 ms at nprobe =
    IVF_NPROBE (`ivf_q1`) and the bf16 probe alone at Q=1 on the card
    (`probe_q1_ms`); and every rung's Q=1 prediction from the constants
    plan.py holds, beside its measurement."""
    from mmrs_tpu_torch import plan as plan_mod

    scan = GALLERY_ROWS * DIM * 2 / 1e9 / (flat_q1["bf16"] / 1e3)   # GB/s
    n, c, slots, spill = ivf_geometry(ivfs[""])
    rb = plan_mod.row_bytes(DIM, "bf16")
    probed = min(IVF_NPROBE, c) / c * (slots * n + c * 64.0) * rb / 1e9
    rest = (spill * n * rb + c * DIM * 4.0) / 1e9 / (scan / 1e3)
    fit = {"EFFECTIVE_SCAN_GBPS": scan,
           "IVF_GATHER_EFF": probed / (probe_q1_ms / 1e3) / scan,
           "IVF_OVERHEAD_MS": ivf_q1["bf16"] - probe_q1_ms - rest,
           "HBM_GB_DEFAULT": torch.cuda.get_device_properties(
               0).total_memory / 1e9}
    rungs = {f"flat {q}": (plan_mod.predict_flat_q1_ms(GALLERY_ROWS, DIM, q),
                           flat_q1[q]) for q in plan_mod.QUANTS}
    for mode, ivf in ivfs.items():
        q = IVF_RUNGS[mode]
        n, c, slots, spill = ivf_geometry(ivf)
        rungs[f"IVF {q}"] = (plan_mod.predict_ivf_q1_ms(
            n, DIM, q, c, IVF_NPROBE, slots, spill), ivf_q1[q])
    return {"fit": fit, "rungs": rungs,
            "held": {name: getattr(plan_mod, name) for name in fit}}


def audit_rows(path: str, key: str) -> dict:
    """An audit CSV's rows by their `key` column."""
    with open(path, newline="", encoding="utf-8") as f:
        return {r[key]: r for r in csv.DictReader(f)}


def lifecycle_vs_plain(km: dict, pm: dict, scale: float) -> str:
    """Phase 4h's comparison of the kernel route's lifecycle (manifest km)
    with the plain route's (pm) on the same tree; a line for the report."""
    from mmrs_tpu_torch.index.gallery import GalleryIndex

    ki, pi = (GalleryIndex.load(m["index"]["dir"]) for m in (km, pm))
    check(ki.paths == pi.paths, "4h lifecycle: index rows differ in order")
    cos = float((np.asarray(ki.embeddings, np.float32)
                 * np.asarray(pi.embeddings, np.float32)).sum(1).min())
    check(cos >= 0.999, f"4h lifecycle index embeddings vs plain: {cos}")
    grids = []
    for m in (km, pm):
        with open(m["calibrate"]["sweep_csv"], newline="") as f:
            grids.append(np.asarray([float(r["threshold"])
                                     for r in csv.DictReader(f)]))
    grid_d = float(np.abs(grids[0] - grids[1]).max()) \
        if len(grids[0]) == len(grids[1]) else float("inf")
    check(grid_d <= UNION_MARGIN * scale,
          f"4h lifecycle sweep grids: {len(grids[0])} / {len(grids[1])} "
          f"thresholds, max|d| {grid_d}")
    taus = [m["calibrate"]["best_threshold"] for m in (km, pm)]
    margin = UNION_MARGIN * scale

    def far(*pairs):   # every (score, tau) pair more than margin apart
        return all(abs(s - t) > margin for s, t in pairs)

    kc, pc = (audit_rows(m["cascade"]["audit_csv"], "path")
              for m in (km, pm))
    check(set(kc) == set(pc), "4h lifecycle cascade audits list other files")
    decided = 0
    for p, kr in kc.items():
        ks, ps = float(kr["en_score"]), float(pc[p]["en_score"])
        if far((ks, taus[0]), (ps, taus[1])):
            decided += 1
            check(kr["gate"] == pc[p]["gate"],
                  f"4h lifecycle gate of {p}: {kr['gate']} vs plain "
                  f"{pc[p]['gate']} (scores {ks}, {ps}; taus {taus})")
    ku, pu = (audit_rows(m["union"]["audit_csv"], "basename")
              for m in (km, pm))
    for b in set(ku) | set(pu):
        kr, pr = ku.get(b), pu.get(b)
        for col, sim in (("en_pass", "en_sim"), ("cn_pass", "cn_sim")):
            kf = kr is not None and kr[col] == "1"
            pf = pr is not None and pr[col] == "1"
            if kf != pf:
                sims = [float(r[sim]) * scale for r in (kr, pr) if r]
                check(not far(*[(s, t) for s in sims for t in taus]),
                      f"4h lifecycle union {col} of {b}: {kf} vs plain {pf} "
                      f"at scaled sims {sims} (taus {taus})")
    for what in ("dedup", "leakage"):
        with open(km[what]["report"]) as a, open(pm[what]["report"]) as b:
            ka, pa = json.load(a), json.load(b)
        check(ka == pa, f"4h lifecycle {what} reports differ from plain")
    import filecmp

    for f in sorted(os.listdir(km["vqa"]["dir"])):
        check(filecmp.cmp(os.path.join(km["vqa"]["dir"], f),
                          os.path.join(pm["vqa"]["dir"], f), shallow=False),
              f"4h lifecycle VQA file {f} differs from plain")
    return (f"vs the plain route (impl=\"torch\") on the same tree: index "
            f"embeddings cosine >= {cos:.6f}; sweep grids {len(grids[0])} "
            f"thresholds, max|d| {grid_d:.4f}; best thresholds {taus[0]:.4f}"
            f" / {taus[1]:.4f}; gate decisions equal for the {decided} of "
            f"{len(kc)} images more than {UNION_MARGIN} x {scale:g} from "
            f"both thresholds, union decisions likewise; dedup and leakage "
            f"reports and the VQA files equal")


def ops_phase(dev, root: str, kernels, cli, big_engine, big_quant, ivfs):
    """Phase 4h: the operations layer (`mmrs-torch lifecycle`, `parity`,
    `plan`) and the int4-weight LLaMA at full width from seeded weights,
    each run with the launch counts reset before it and read after, each
    against its plain route or oracle. `big_engine` / `big_quant` (4a /
    4b's 1M flat engines) and `ivfs` (the 1M IVF indexes) are what the
    planner's residency is held to. Returns what phases 5 and 6 read."""
    import copy
    import logging

    from PIL import Image

    from mmrs_tpu_torch import plan as plan_mod
    from mmrs_tpu_torch.config import load as load_config
    from mmrs_tpu_torch.eval import parity
    from mmrs_tpu_torch.lifecycle import run_lifecycle
    from mmrs_tpu_torch.models import checkpoint, convert_jax, llama
    from mmrs_tpu_torch.models.clip import CLIP, CLIPConfig
    from mmrs_tpu_torch.models.configs import CLIP_TEXT_B32, VIT_B32
    from mmrs_tpu_torch.models.layers import QLinear4
    from mmrs_tpu_torch.models.quantize import (quantize_llama,
                                                quantize_llama_int4)

    ctx = {"report": [], "launches": {}, "s": {}, "times": {}}

    def reset():
        for fn in kernels:
            fn.launches = 0

    def read(run, names):
        """Keep `run`'s launch counts; each of `names` must have launched."""
        counts = ctx["launches"][run] = {fn.__name__: fn.launches
                                         for fn in kernels}
        for name in names:
            check(counts[name] > 0, f"4h {run} never launched {name}")

    # -- 1. `mmrs-torch lifecycle` in process, then the plain route ----------
    t0 = time.perf_counter()
    tree, held = os.path.join(root, "tree"), os.path.join(root, "held")
    planted = ops_tree(tree, held, SEED)
    ccfg = CLIPConfig(vision=VIT_B32, text=CLIP_TEXT_B32)
    npz = os.path.join(root, "b32.npz")
    checkpoint.save_npz(convert_jax.clip_tree(
        CLIP(ccfg, generator=torch.Generator().manual_seed(SEED))), npz)
    yaml = os.path.join(root, "b32.yaml")
    with open(yaml, "w") as f:
        f.write(f"model:\n  image_tower: vit_b32\n  dtype: bfloat16\n"
                f"  checkpoint_path: {npz}\n")
    ctx["s"]["setup"] = time.perf_counter() - t0
    stamps = []

    class Stages(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("lifecycle "):
                stamps.append(time.perf_counter())

    lc_log = logging.getLogger("mmrs_tpu_torch.lifecycle")
    handler = Stages()
    lc_log.addHandler(handler)
    out = os.path.join(root, "lifecycle")
    reset()
    t0 = time.perf_counter()
    try:
        code, lines = cli(["lifecycle", "--root", tree, "--out", out,
                           "--positive-class", "lychee", "--test-root", held,
                           "--dedup-tau", str(OPS_DEDUP_TAU), "--config",
                           yaml])
    finally:
        lc_log.removeHandler(handler)
    wall = time.perf_counter() - t0
    read("lifecycle", ("normalize_images", "mha_short_seq", "first_match"))
    line = json.loads(lines[-1]) if code == 0 and lines else {}
    check(code == 0 and line.get("union_en_pass_eq_cascade_gate") is True
          and line.get("calibration_rows_eq_index_rows") is True,
          f"4h lifecycle: exit {code}, {lines[-3:]}")
    check(len(stamps) == 7, f"4h lifecycle logged {len(stamps)} stages")
    ctx["times"]["lifecycle_s"] = dict(zip(
        ("normalize", "index", "calibrate", "union", "cascade", "dedup",
         "vqa"), np.diff([t0] + stamps).tolist()))
    ctx["times"]["lifecycle_s"]["wall"] = wall
    with open(os.path.join(out, "lifecycle.json")) as f:
        km = json.load(f)
    check(km["cross_checks"] == {"union_en_pass_eq_cascade_gate": True,
                                 "calibration_rows_eq_index_rows": True},
          f"4h lifecycle cross-checks {km['cross_checks']}")
    # every artifact family (tests/test_lifecycle.py's list)
    paths = [km["normalize"]["report"],
             os.path.join(km["index"]["dir"], "manifest.json"),
             km["calibrate"]["sweep_csv"],
             os.path.join(out, "calibrate", "calibration.json"),
             km["union"]["audit_csv"], km["cascade"]["journal"],
             km["cascade"]["audit_csv"], km["dedup"]["report"],
             km["leakage"]["report"]]
    paths += [os.path.join(km["vqa"]["dir"], f) for f in (
        "dataset_pos.json", "dataset_pos_cross.json",
        "dataset_pos_cross_simple.json",
        "dataset_pos_cross_simple_hard.json")]
    missing = [p for p in paths if not p or not os.path.exists(p)]
    check(not missing, f"4h lifecycle artifacts missing: {missing}")
    n_images = sum(len(fs) for _, _, fs in os.walk(tree))
    check(km["index"]["rows"] == n_images and km["cascade"]["images"]
          == n_images and km["normalize"]["would_convert"] == 1,
          f"4h lifecycle: {km['index']['rows']} rows, "
          f"{km['cascade']['images']} cascade images of {n_images}, "
          f"{km['normalize']['would_convert']} conversions")
    with open(km["cascade"]["journal"], newline="") as f:
        journal = sum(1 for _ in csv.DictReader(f))
    check(journal == n_images, f"4h lifecycle journal {journal} rows")
    with open(km["dedup"]["report"]) as f:
        dups = [tuple(p) for p in json.load(f)["duplicates"]]
    check((planted["dup"][1], planted["dup"][0]) in dups,
          f"4h lifecycle dedup missed the planted copy: {dups[:4]}")
    with open(km["leakage"]["report"]) as f:
        leaked = [tuple(p) for p in json.load(f)["leaked"]]
    check(all(p in leaked for p in planted["leaks"]),
          f"4h lifecycle leakage missed a planted leak: {leaked}")
    with open(km["vqa"]["dir"] + "/dataset_pos_cross_simple_hard.json") as f:
        recs = json.load(f)
    check(any("ez_negative" in r["image"] for r in recs)
          and any("lychee_negative" in r["image"] for r in recs),
          "4h lifecycle VQA v4 did not draw from the negative pools")
    t1 = time.perf_counter()
    pm = run_lifecycle(tree, os.path.join(root, "plain"), "lychee",
                       cfg=load_config(yaml), test_root=held,
                       dedup_tau=OPS_DEDUP_TAU, device=dev, impl="torch")
    ctx["s"]["lifecycle_plain"] = time.perf_counter() - t1
    vs = lifecycle_vs_plain(km, pm, load_config(yaml).search.logit_scale)
    ctx["report"].append(
        f"4h `mmrs-torch lifecycle` (ViT-B/32 bf16, the port's seeded npz) "
        f"over {n_images} images ({len(OPS_CLASSES)} classes x "
        f"{OPS_PER_CLASS}, a PNG, a planted copy, {OPS_EZ} ez / {OPS_HARD} "
        f"hard negatives; a held-out tree of 3 with 2 leaks): "
        f"{json.dumps(line)}; duplicates {dups}; leaked {len(leaked)}; "
        f"journal {journal} rows; every artifact family; {wall:.1f} s "
        f"(plain route {ctx['s']['lifecycle_plain']:.1f} s); launches "
        + json.dumps({k: v for k, v in ctx["launches"]["lifecycle"].items()
                      if v}) + f"; {vs}")

    # -- 2. `mmrs-torch parity`: the rank gate, the int8 tower, a release --
    reset()
    t0 = time.perf_counter()
    code, lines = cli(["parity", "--rank-gate", "--rows", str(GALLERY_ROWS),
                       "--queries", str(RANK_GATE_QUERIES)])
    ctx["s"]["rank_gate"] = time.perf_counter() - t0
    read("rank_gate", ("cosine_topk",))
    rg = json.loads(lines[-1])["rank_gate"] if lines else {}
    check(code == 0 and rg.get("violations") == 0
          and rg.get("planted_exact") is True,
          f"4h parity --rank-gate: exit {code}, {lines[-2:]}")
    ctx["report"].append(
        f"4h `mmrs-torch parity --rank-gate --rows {GALLERY_ROWS} --queries "
        f"{RANK_GATE_QUERIES}`: {json.dumps(rg)}, "
        f"{ctx['s']['rank_gate']:.1f} s; launches "
        + json.dumps({k: v for k, v in ctx["launches"]["rank_gate"].items()
                      if v}))

    reset()
    t0 = time.perf_counter()
    code, lines = cli(["parity", "--int8-tower", "vit_b32"])
    ctx["s"]["int8_tower"] = time.perf_counter() - t0
    read("int8_tower", ("mha_short_seq", "mlp_int8_fused"))
    gate = json.loads(lines[-1])["int8_tower"] if lines else {}
    check(code in (0, 1) and set(gate) == {"tower", "min_cosine_vs_f32",
                                           "top1_agreement", "ok"},
          f"4h parity --int8-tower: exit {code}, {lines[-2:]}")
    model = CLIP(ccfg, generator=torch.Generator().manual_seed(0)).to(dev)
    plain = parity.int8_geometry_gate(model.requires_grad_(False), ccfg,
                                      impl="torch")
    del model
    check(abs(gate["min_cosine_vs_f32"] - plain["min_cosine_vs_f32"]) <= 1e-3
          and gate["top1_agreement"] == plain["top1_agreement"],
          f"4h int8 tower gate {gate} vs plain {plain}")
    ctx["report"].append(
        f"4h `mmrs-torch parity --int8-tower vit_b32` (random weights from "
        f"seed 0; `ok` is the weights' property, not asserted): "
        f"{json.dumps(gate)}; plain route min cosine "
        f"{plain['min_cosine_vs_f32']:.6f}, top-1 "
        f"{plain['top1_agreement']:.4f}; {ctx['s']['int8_tower']:.1f} s; "
        f"launches " + json.dumps({k: v for k, v in ctx["launches"][
            "int8_tower"].items() if v}))

    t0 = time.perf_counter()
    pack = os.path.join(root, "pack")
    os.makedirs(pack)
    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in _rand_state(
        dev, g, openai_clip_shapes(VIT_B32, CLIP_TEXT_B32)).items()},
        os.path.join(pack, "ViT-B-32.pt"))
    with open(os.path.join(pack, "bpe_simple_vocab_16e6.txt"), "w") as f:
        f.write("#version: 0.2\nd o\nc a\na t\nd i\ndi a\ng r\ngr a\n")
    image = os.path.join(root, "CLIP.png")
    Image.fromarray(np.random.default_rng(SEED).integers(
        0, 256, (224, 300, 3), dtype=np.uint8)).save(image)
    ctx["s"]["pack"] = time.perf_counter() - t0
    reset()
    t0 = time.perf_counter()
    code, lines = cli(["parity", "--release", pack, "--image", image])
    ctx["s"]["release"] = time.perf_counter() - t0
    read("release", ("normalize_images", "mha_short_seq", "mlp_int8_fused"))
    rel = json.loads(lines[-1])["release"] if lines else {}
    smoke = rel.get("smoke", {})
    check(code == 1 and set(rel.get("found_models", {})) == {"openai_clip"}
          and "clip_bpe" in rel.get("found_tokenizers", {})
          and len(smoke.get("probs", [])) == 3
          and abs(sum(smoke["probs"]) - 1.0) < 1e-4
          and "min_cosine_vs_f32" in rel.get("int8_tower", {}),
          f"4h parity --release: exit {code}, {lines[-2:]}")
    import importlib.metadata as md

    try:
        oracle = f"transformers {md.version('transformers')}"
    except md.PackageNotFoundError:
        oracle = "no transformers"
    bpe = dict(rel.get("clip_bpe_differential") or {})
    mism = bpe.pop("mismatches", [])
    ctx["report"].append(
        f"4h `mmrs-torch parity --release` over a written OpenAI ViT-B/32 "
        f"archive (seeded f16 state dict) + merges file, --image a seeded "
        f"PNG: exit {code}; ok {rel['ok']} (random weights against the "
        f"real goldens: expected false); smoke probs {smoke['probs']} (sum "
        f"{sum(smoke['probs']):.6f}); int8 tower "
        f"{json.dumps(rel['int8_tower'])}; bpe differential ({oracle}) "
        f"{json.dumps(bpe)}, {len(mism)} mismatches"
        + (f", the first {json.dumps(mism[0])}" if mism else "") + "; pack "
        f"{ctx['s']['pack']:.1f} s, gate {ctx['s']['release']:.1f} s; "
        f"launches " + json.dumps({k: v for k, v in ctx["launches"][
            "release"].items() if v}))

    # -- 3. `mmrs-torch plan`: residency held to the engines' tensors -------
    t0 = time.perf_counter()
    flat = {"bf16": big_engine.gallery.nbytes}
    for mode in ("int8", "int4"):
        eng = big_quant[mode]
        flat[mode] = eng.gallery.nbytes + eng.gallery_scales.nbytes
    res = []
    for quant, nbytes in flat.items():
        pred = plan_mod.flat_resident_gb(GALLERY_ROWS, DIM, quant) * 1e9
        check(abs(pred / nbytes - 1) <= 0.02,
              f"4h plan flat {quant}: predicted {pred} B, engine {nbytes} B")
        res.append(f"flat {quant} {pred / 2 ** 20:.1f} / {nbytes / 2 ** 20:.1f}"
                   f" MiB")
    for mode, ivf in ivfs.items():
        quant = IVF_RUNGS[mode]
        n, c, slots, spill = ivf_geometry(ivf)
        pred = plan_mod.ivf_resident_gb(n, DIM, quant, c, slots, spill) * 1e9
        got = ivf.hbm_bytes()
        check(abs(pred / got - 1) <= 0.10,
              f"4h plan IVF {quant}: predicted {pred} B, index {got} B")
        res.append(f"IVF {quant} {pred / 2 ** 20:.1f} / {got / 2 ** 20:.1f} "
                   f"MiB (C {c}, slots {slots:.3f}, spill {spill:.4f})")
    plans = {}
    for rows in PLAN_ROWS:
        code, lines = cli(["plan", "--rows", str(rows), "--dim", str(DIM)])
        check(code == 0 and lines and lines[-1].startswith("recommended:"),
              f"4h plan --rows {rows}: exit {code}, {lines[-1:]}")
        plans[rows] = lines
    ctx["plans"] = plans
    ctx["report"].append(
        f"4h `mmrs-torch plan` residency (predicted / the 1M engines' and "
        f"IVF indexes' tensors): " + "; ".join(res) + "; recommended at "
        + ", ".join(f"{r:,} x {DIM}: {ls[-1].split(': ', 1)[1]}"
                    for r, ls in plans.items())
        + f"; {time.perf_counter() - t0:.1f} s")

    # -- 4. the int4-weight LLaMA at LLaMA-2-7B width -----------------------
    t0 = time.perf_counter()
    cfg = dataclasses.replace(llama.LLAMA2_7B, layers=INT4_LAYERS)
    g = torch.Generator(device=dev).manual_seed(SEED + 60)
    base = llama.Llama(cfg, generator=g, device=dev).requires_grad_(False)
    lm4 = quantize_llama_int4(copy.deepcopy(base), group=INT4_GROUP)
    lm8 = quantize_llama(copy.deepcopy(base))

    def int8_bytes(m):
        return sum(b.nbytes for b in m.buffers() if b.dtype == torch.int8)

    b4, b8 = int8_bytes(lm4), int8_bytes(lm8)
    check(b4 * 2 == b8, f"4h int4 int8-bytes {b4} x 2 != int8's {b8}")
    q4 = [m for m in lm4.modules() if isinstance(m, QLinear4)]
    check(len(q4) == 7 * INT4_LAYERS + 1, f"4h int4: {len(q4)} QLinear4")

    def as_bf16(m):
        for mod in list(m.modules()):
            for name, child in list(mod.named_children()):
                if isinstance(child, QLinear4):   # JAX's dequantized oracle
                    lin = torch.nn.Linear(1, 1, bias=False, device=dev)
                    lin.weight = torch.nn.Parameter(
                        child.dequantize(torch.bfloat16), requires_grad=False)
                    setattr(mod, name, lin)
                elif isinstance(child, torch.nn.Linear):
                    child.weight.data = child.weight.data.to(torch.bfloat16)
        return m

    oracle = as_bf16(copy.deepcopy(lm4))
    lmbf = as_bf16(base)
    tokens = torch.randint(3, cfg.vocab_size, (LLAVA_B, INT4_PROMPT),
                           device=dev, generator=g)
    emb = llama.embed_tokens(lm4, tokens)
    ctx["s"]["int4_setup"] = time.perf_counter() - t0
    reset()
    t0 = time.perf_counter()
    out4 = llama.greedy_generate(lm4, emb, INT4_NEW, eos_token=-1,
                                 prefill_chunk=64)
    torch.cuda.synchronize()
    ctx["s"]["int4_generate"] = time.perf_counter() - t0
    read("int4", ("chunk_attention", "decode_attention"))
    outr = llama.greedy_generate(oracle, emb, INT4_NEW, eos_token=-1,
                                 prefill_chunk=64)
    check(torch.equal(out4, outr), "4h int4 tokens != the dequantized "
          f"oracle's at {int((out4 != outr).sum())} of {out4.numel()}")
    cache_len = -(-(INT4_PROMPT + INT4_NEW) // 64) * 64
    l4, _ = llama.prefill(lm4, emb, cache_len, prefill_chunk=64)
    lr, _ = llama.prefill(oracle, emb, cache_len, prefill_chunk=64)
    check(torch.equal(l4, lr), f"4h int4 prefill logits != oracle's "
          f"(max|d| {float((l4 - lr).abs().max())})")
    del oracle, l4, lr

    def decode_ms(lm, kv_dtype=None):
        """ms a decode step (B=8, the cache at the prompt's end), CUDA
        events over INT4_STEPS steps after one warm-up step."""
        logits, cache = llama.prefill(lm, emb, cache_len, torch.bfloat16,
                                      kv_dtype, 64)
        e = llama.embed_tokens(lm, logits[:, -1].argmax(-1)[:, None])
        llama.forward(lm, e, cache, INT4_PROMPT)
        return time_ms(lambda: llama.forward(lm, e, cache, INT4_PROMPT + 1),
                       iters=INT4_STEPS, warmup=1), cache

    step = {}
    for name, lm in (("bf16", lmbf), ("int8", lm8), ("int4", lm4)):
        step[name], cache = decode_ms(lm)
    e1 = llama.embed_tokens(lm4, out4[:, :1])
    whole = profile_device(lambda: [llama.forward(lm4, e1, cache,
                                                  INT4_PROMPT + 1)
                                    for _ in range(4)])
    unpack = profile_device(lambda: [[m.dequantize(torch.bfloat16)
                                      for m in q4] for _ in range(4)])
    ctx["times"]["int4"] = {"step_ms": step, "unpack_device_ms": unpack[1] / 4,
                            "step_device_ms": whole[1] / 4,
                            "unpack_share": unpack[1] / whole[1],
                            "step_top": [[k[:60], round(ms / 4, 4), n]
                                         for k, ms, n in whole[2]]}
    del lm4, lm8, lmbf, base, cache
    torch.cuda.empty_cache()
    ctx["report"].append(
        f"4h int4 LLaMA (LLaMA-2-7B width, {INT4_LAYERS} layers + lm_head, "
        f"random weights from the seed; quantize_llama_int4 group "
        f"{INT4_GROUP} on the card): greedy {INT4_NEW} tokens at B={LLAVA_B} "
        f"from a {INT4_PROMPT}-token prompt = the dequantized bf16 oracle's "
        f"(tokens and prefill logits bit-equal); int8 bytes {b4:,} = half "
        f"of quantize_llama's {b8:,}; generate "
        f"{ctx['s']['int4_generate']:.2f} s; launches "
        + json.dumps({k: v for k, v in ctx["launches"]["int4"].items()
                      if v}))
    return ctx


# ---- phase 4i: the data axis of the mesh -------------------------------------

MESH_SHARDS = 4
MESH_RAGGED = GALLERY_ROWS - 3           # 1,048,573: the last shard padded
MESH_WORKERS = 2                         # processes on the card, 2 shards each
MESH_WORKER_IVF_ROWS = 1 << 18           # the workers' IVF: the first rows
MESH_WORKER_CLUSTERS = 256               # of FLAT_SEED's gallery, nprobe = C
HP_ROWS, HP_KEYS, HP_CLASSES = 4096, 64, 8   # search_hp's synthetic problem


def mesh_devices():
    """([4 devices], how): four distinct cards where the machine has them,
    else the first card four times (shards run one after another)."""
    n = torch.cuda.device_count()
    if n >= MESH_SHARDS:
        return ([torch.device("cuda", i) for i in range(MESH_SHARDS)],
                f"{MESH_SHARDS} distinct cards")
    return ([torch.device("cuda", 0)] * MESH_SHARDS,
            f"cuda:0 repeated {MESH_SHARDS} times ({n} card(s) here)")


def separated_equal(vals, ids, ref_vals, ref_ids, gap: float) -> int:
    """Ids equal wherever the reference's neighbours are more than `gap`
    apart; returns how many places were compared."""
    rv = ref_vals.double().cpu()
    d = (rv[:, :-1] - rv[:, 1:]).abs()
    g = torch.full_like(rv, float("inf"))
    g[:, :-1] = d
    g[:, 1:] = torch.minimum(g[:, 1:], d)
    clear = torch.isfinite(rv) & (g > gap)
    bad = clear & (ids.cpu().long() != ref_ids.cpu().long())
    check(not bool(bad.any()), f"ids differ at {int(bad.sum())} separated "
          f"places")
    return int(clear.sum())


def hits_separated(got, want, gap: float) -> None:
    """Engine hits: scores within `gap`, paths equal where separated."""
    for a, b in zip(got, want):
        check(len(a) == len(b) > 0, "hit counts differ")
        ws = np.asarray([h.score for h in b])
        d = float(np.abs(np.asarray([h.score for h in a]) - ws).max())
        check(d <= gap, f"hit scores differ by {d}")
        g = np.full(ws.shape, np.inf)
        dd = np.abs(np.diff(ws))
        g[1:], g[:-1] = np.minimum(g[1:], dd), np.minimum(g[:-1], dd)
        check(all(gg <= gap or x.path == y.path
                  for x, y, gg in zip(a, b, g)), "hit paths differ")


def mesh_worker(argv, dev=None) -> int:
    """`chip_smoke.py --mesh-worker COORD NPROC PID OUT CENTS`: one of the
    processes of phase 4i's part 6. Joins the gloo group, builds the
    process-major hybrid mesh over 2 entries of this card, places only
    its `process_local_rows` of FLAT_SEED's gallery, and answers the
    sharded top-10, the slot-sharded IVF at nprobe = C (centroids CENTS,
    written by the parent) and the dedup ring over phase 4d's planted rows;
    writes them to OUT (npz)."""
    coord, nproc, pid, out, cents_path = argv
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mmrs_tpu_torch.config import MeshConfig
    from mmrs_tpu_torch.index.ivf import build_ivf_streaming, probe_buckets
    from mmrs_tpu_torch.ops.allpairs import first_match
    from mmrs_tpu_torch.ops.topk import cosine_topk
    from mmrs_tpu_torch.parallel.dedup import sharded_first_match
    from mmrs_tpu_torch.parallel.ivf import place_ivf, sharded_ivf_topk
    from mmrs_tpu_torch.parallel.multihost import (distributed_init,
                                                   make_hybrid_mesh,
                                                   place_global_rows,
                                                   process_local_rows)
    from mmrs_tpu_torch.parallel.topk import sharded_cosine_topk

    dev = dev or torch.device("cuda", 0)
    check(distributed_init(coord, int(nproc), int(pid)), "one process")
    mesh = make_hybrid_mesh(MeshConfig(), [dev] * 2)
    g = flat_gallery(dev)
    lo, hi = process_local_rows(GALLERY_ROWS, mesh)
    blocks = place_global_rows(g[lo:hi].float().cpu().numpy(), GALLERY_ROWS,
                               mesh)
    blocks = [None if b is None else b.to(torch.bfloat16) for b in blocks]
    q = g[torch.arange(8, device=dev) * 997].float()
    for fn in (cosine_topk, probe_buckets, first_match):
        fn.launches = 0
    v, i = sharded_cosine_topk(q.to(torch.bfloat16), blocks, 10, mesh,
                               n_valid=GALLERY_ROWS)
    sub = g[:MESH_WORKER_IVF_ROWS]
    cents = torch.from_numpy(np.load(cents_path))
    ivf = place_ivf(build_ivf_streaming(
        lambda: (sub[a:a + IVF_CHUNK]
                 for a in range(0, MESH_WORKER_IVF_ROWS, IVF_CHUNK)),
        MESH_WORKER_IVF_ROWS, DIM, n_clusters=MESH_WORKER_CLUSTERS,
        chunk=IVF_CHUNK, centroids=cents, device=dev), mesh)
    iv, ii = sharded_ivf_topk(q, ivf, k=10, nprobe=MESH_WORKER_CLUSTERS,
                              mesh=mesh)
    x, _ = planted_dedup_rows(dev, SEED)
    fm = sharded_first_match(x, DEDUP_TAU, mesh)
    counts = {fn.__name__: fn.launches
              for fn in (cosine_topk, probe_buckets, first_match)}
    np.savez(out, vals=v.cpu().numpy(), ids=i.cpu().numpy(),
             ivf_vals=iv.cpu().numpy(), ivf_ids=ii.cpu().numpy(),
             first=fm.numpy(), rows=np.asarray([lo, hi]),
             placed=np.asarray([b is not None for b in blocks]),
             counts=json.dumps(counts))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def mesh_phase(dev, root: str, kernels, m: dict, worker_cmd=None):
    """Phase 4i: the data axis of the mesh on `mesh_devices()`, each part
    with the launch counts reset before it and each kernel's launches
    held to S a call (S a ring step): (1) the sharded embed at ViT-B/32
    width, bf16 and int8 towers, batch 224 over 4a's images; (2) flat
    top-10 engines (bf16 / int8 / int4) over 4a's 1M gallery and a ragged
    copy, and each rung's sharded scan timed at S = 1, 2, 4 on one card;
    (3) the slot-sharded IVF over 4c's clustered 1M indexes, and
    build_ivf(mesh=) straight into strips; (4) the dedup ring over 4d's
    planted rows, f32 and bf16; (5) SearchEngine(mesh=) over 4a's index
    (search, sweep_class), streaming_topk(mesh=) over a 1 GiB memmap and
    search_hp(mesh=); (6) MESH_WORKERS processes on the card (gloo), each
    placing its own rows. `m` holds the earlier phases' objects. Returns
    what phases 5 and 6 read."""
    from mmrs_tpu_torch.adapt import tip_adapter as tip
    from mmrs_tpu_torch.config import MeshConfig, SearchConfig
    from mmrs_tpu_torch.index import ivf as ivf_mod
    from mmrs_tpu_torch.index.gallery import GalleryIndex
    from mmrs_tpu_torch.index.ivf import probe_buckets, probe_buckets_q4
    from mmrs_tpu_torch.index.stream import streaming_topk
    from mmrs_tpu_torch.ops.allpairs import first_match
    from mmrs_tpu_torch.ops.attention import mha_short_seq
    from mmrs_tpu_torch.ops.mlp_int8 import mlp_int8_fused
    from mmrs_tpu_torch.ops.normalize import l2_normalize
    from mmrs_tpu_torch.ops.preprocess import normalize_images
    from mmrs_tpu_torch.ops.quant import cosine_topk_quantized, quantize_rows
    from mmrs_tpu_torch.ops.quant4 import cosine_topk_int4, quantize_rows_int4
    from mmrs_tpu_torch.ops.topk import cosine_topk
    from mmrs_tpu_torch.parallel.dedup import sharded_first_match
    from mmrs_tpu_torch.parallel.embed import make_sharded_encoder
    from mmrs_tpu_torch.parallel.ivf import (ShardedIVF, place_ivf,
                                             sharded_ivf_topk)
    from mmrs_tpu_torch.parallel.mesh import make_mesh, shard_rows
    from mmrs_tpu_torch.parallel.quant4 import sharded_cosine_topk_int4
    from mmrs_tpu_torch.parallel.topk import (sharded_cosine_topk,
                                              sharded_cosine_topk_quantized)
    from mmrs_tpu_torch.search.engine import SearchEngine

    ctx = {"report": [], "launches": {}, "s": {}, "times": {}}
    devices, how = mesh_devices()
    s = len(devices)
    mesh = make_mesh(MeshConfig(data_size=s), devices)
    ctx["report"].append(f"4i mesh: {s} shards on {how}")
    sync = (lambda: [torch.cuda.synchronize(d) for d in set(devices)])

    def reset():
        for fn in kernels:
            fn.launches = 0

    def keep(part, per_call: dict):
        """Keep `part`'s counts; fn must have launched `n` times."""
        counts = ctx["launches"][part] = {fn.__name__: fn.launches
                                          for fn in kernels}
        for fn, n in per_call.items():
            check(fn.launches == n, f"4i {part}: {fn.__name__} launched "
                  f"{fn.launches} times, not {n}")

    # -- 1. the sharded embed, bf16 and int8 towers ----------------------
    t0 = time.perf_counter()
    ds, samples = m["ds"], m["samples"]
    layers = len(m["towers"].params.visual.blocks)
    for name, tw in (("bf16", m["towers"]), ("int8", m["towers8"])):
        enc = make_sharded_encoder(tw.params_encode_fn, tw.params, mesh,
                                   EMBED_BATCH)
        batches = [np.stack([ds.image(*x) for x in
                             samples[a:a + EMBED_BATCH]])
                   for a in range(0, len(samples), EMBED_BATCH)]
        reset()
        sync()
        t1 = time.perf_counter()
        got = [enc(px) for px in batches]
        sync()
        sharded_s = time.perf_counter() - t1
        per = {normalize_images: s * len(batches),
               mha_short_seq: s * len(batches) * layers}
        if name == "int8":
            per[mlp_int8_fused] = s * len(batches) * layers
        keep(f"embed_{name}", per)
        t1 = time.perf_counter()
        ref = [tw.image_encode(px) for px in batches]
        one_s = time.perf_counter() - t1
        got = torch.from_numpy(np.concatenate(got))
        ref = torch.from_numpy(np.concatenate(ref))
        cos = float(torch.nn.functional.cosine_similarity(got, ref).min())
        ulps = bf16_ulps(got, ref)
        check(cos >= 0.9999, f"4i sharded {name} embed: min cosine {cos}")
        ctx["times"][f"embed_{name}"] = {"sharded_s": sharded_s,
                                         "one_s": one_s, "ulps": ulps,
                                         "cos": cos}
        ctx["report"].append(
            f"4i (1) sharded embed ViT-B/32 {name}, batch {EMBED_BATCH} "
            f"({EMBED_BATCH // s} a shard), {len(samples)} images: min "
            f"cosine {cos:.7f} to the one-device encode, largest gap "
            f"{ulps:.1f} bf16 ulp; host clock {sharded_s:.3f} s sharded, "
            f"{one_s:.3f} s one device")
    ctx["s"]["embed"] = time.perf_counter() - t0

    # -- 2. flat top-10 engines on the mesh; the shard loop's cost ---------
    t0 = time.perf_counter()
    big, qbig = m["big"], m["qbig"]
    ragged = GalleryIndex(big.embeddings[:MESH_RAGGED],
                          big.paths[:MESH_RAGGED], big.classes[:MESH_RAGGED])
    scans = {"": cosine_topk, "int8": cosine_topk_quantized,
             "int4": cosine_topk_int4}
    ones = {"": m["big_engine"], **m["big_quant"]}
    for gname, gidx in (("1M", big), ("ragged", ragged)):
        for mode, fn in scans.items():
            eng = SearchEngine(gidx, SearchConfig(), mesh=mesh,
                               quantize=mode)
            one = (ones[mode] if gname == "1M" else
                   SearchEngine(gidx, SearchConfig(), quantize=mode,
                                device=dev))
            reset()
            hits = eng.query_vectors(qbig, top_k=10)
            keep(f"flat_{gname}_{mode or 'bf16'}", {fn: s})
            want = one.query_vectors(qbig, top_k=10)
            if mode:
                check([[(h.path, h.score) for h in r] for r in hits]
                      == [[(h.path, h.score) for h in r] for r in want],
                      f"4i {gname} {mode}: mesh hits != one-device hits")
            else:
                hits_separated(hits, want, 1e-2)     # 1e-4 in cosine
            del eng, one
    torch.cuda.empty_cache()
    ctx["report"].append(
        f"4i (2) flat top-10 engines on the mesh, {GALLERY_ROWS} and "
        f"{MESH_RAGGED} rows x {DIM}, Q=8: bf16 hits = one device's "
        f"(scores within 1e-4 cosine, paths where separated), int8 / int4 "
        f"hits and scores equal; each scan launched {s} times a query")
    g = flat_gallery(dev)
    qf = g[torch.arange(8, device=dev) * 997].float()
    p8, s8 = quantize_rows(g.float())
    p4, s4 = quantize_rows_int4(g.float())
    rungs = {"bf16": (sharded_cosine_topk, (g,), qf.to(torch.bfloat16),
                      lambda: cosine_topk(qf.to(torch.bfloat16), g, 10)),
             "int8": (sharded_cosine_topk_quantized, (p8, s8), qf,
                      lambda: cosine_topk_quantized(qf, p8, s8, 10)),
             "int4": (sharded_cosine_topk_int4, (p4, s4), qf,
                      lambda: cosine_topk_int4(qf, p4, s4, 10))}
    flat_ms = {}
    with torch.inference_mode():
        for rung, (fn, gal, qq, direct) in rungs.items():
            r = {"direct_ms": time_ms(direct, iters=20),
                 "direct_graph_ms": graph_ms(direct)[0]}
            for n_sh in (1, 2, 4):
                msh = make_mesh(MeshConfig(data_size=n_sh),
                                [devices[0]] * n_sh)
                blocks = [shard_rows(t, msh) for t in gal]
                call = (lambda fn=fn, qq=qq, blocks=blocks, msh=msh:
                        fn(qq, *blocks, 10, msh))
                r[f"s{n_sh}_ms"] = time_ms(call, iters=20)
                r[f"s{n_sh}_graph_ms"] = graph_ms(call)[0]
            flat_ms[rung] = r
    ctx["times"]["flat"] = flat_ms
    for rung, r in flat_ms.items():
        ctx["report"].append(
            f"4i (2) {rung} top-10 Q=8 over {GALLERY_ROWS} x {DIM} on one "
            f"card, ms eager / card alone: direct {r['direct_ms']:.4f} / "
            f"{r['direct_graph_ms']:.4f}; "
            + "; ".join(f"S={n} {r[f's{n}_ms']:.4f} / {r[f's{n}_graph_ms']:.4f}"
                        for n in (1, 2, 4)))
    del p8, s8, p4, s4
    ctx["s"]["flat"] = time.perf_counter() - t0

    # -- 3. the slot-sharded IVF; build_ivf(mesh=) into strips -------------
    t0 = time.perf_counter()
    ivf_gal, ivfs = m["ivf_gal"], m["ivfs"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    rows = torch.randint(0, GALLERY_ROWS, (64,), device=dev, generator=gen)
    qc = ivf_gal[rows].float() + 0.02 * torch.randn((64, DIM), device=dev,
                                                    generator=gen)
    qc = qc / qc.norm(dim=1, keepdim=True)
    for mode, one in ivfs.items():
        sivf = place_ivf(one, mesh)
        fn = probe_buckets_q4 if mode == "int4" else probe_buckets
        for nprobe in (IVF_NPROBE, IVF_CLUSTERS):
            reset()
            v, i = sharded_ivf_topk(qc, sivf, k=10, nprobe=nprobe, mesh=mesh)
            keep(f"ivf_{IVF_RUNGS[mode]}_{nprobe}", {fn: s})
            rv, ri = ivf_mod.ivf_topk(qc, one, k=10, nprobe=nprobe)
            if mode == "int4":
                check(torch.equal(v.cpu(), rv.cpu())
                      and torch.equal(i.cpu(), ri.cpu()),
                      f"4i IVF int4 nprobe={nprobe}: mesh != one device")
            else:
                d = float((v.cpu() - rv.cpu()).abs().max())
                check(d <= 1e-5, f"4i IVF {mode or 'bf16'} nprobe={nprobe}:"
                      f" values differ by {d}")
                separated_equal(v, i, rv, ri, 1e-5)
        del sivf
    cents = ivf_mod.train_centroids(ivf_gal[::4], IVF_CLUSTERS, device=dev)
    cap = -(-ivfs[""].bucket_cap // (8 * s)) * 8 * s

    def chunks():
        return (ivf_gal[a:a + IVF_CHUNK]
                for a in range(0, GALLERY_ROWS, IVF_CHUNK))

    kw = dict(n_clusters=IVF_CLUSTERS, chunk=IVF_CHUNK, centroids=cents,
              bucket_cap=cap, device=dev)
    a = place_ivf(ivf_mod.build_ivf_streaming(chunks, GALLERY_ROWS, DIM,
                                              **kw), mesh)
    b = ivf_mod.build_ivf_streaming(chunks, GALLERY_ROWS, DIM, mesh=mesh,
                                    **kw)
    check(isinstance(b, ShardedIVF), "build_ivf(mesh=) gave no strips")
    for sa, sb in zip(a.shards, b.shards):
        for name in ("buckets", "bucket_ids"):
            check(torch.equal(getattr(sa, name), getattr(sb, name)),
                  f"4i build_ivf(mesh=) {name} != place_ivf(build_ivf())")
    # the spill pads to 8 S rows (not S), so its strips differ in length;
    # the live rows must be the same, in the same order
    live_a, live_b = a.spill_ids, b.spill_ids
    check(torch.equal(live_a[live_a >= 0], live_b[live_b >= 0]),
          "4i build_ivf(mesh=) spill rows != place_ivf(build_ivf())'s")
    v1, i1 = sharded_ivf_topk(qc, a, k=10, nprobe=IVF_NPROBE, mesh=mesh)
    v2, i2 = sharded_ivf_topk(qc, b, k=10, nprobe=IVF_NPROBE, mesh=mesh)
    check(torch.equal(v1, v2) and torch.equal(i1, i2),
          "4i build_ivf(mesh=) answers != place_ivf(build_ivf())'s")
    ctx["times"]["ivf_build_s"] = b.build_seconds
    del a, b, cents
    torch.cuda.empty_cache()
    ctx["report"].append(
        f"4i (3) slot-sharded IVF over the clustered {GALLERY_ROWS} x {DIM}, "
        f"C={IVF_CLUSTERS}, Q=64, nprobe {IVF_NPROBE} and C: bf16 / int8 "
        f"values within 1e-5 of one-device ivf_topk and ids where "
        f"separated, int4 ids and values equal; K7 / K8 launched {s} times "
        f"a query; build_ivf(mesh=) at cap {cap} = place_ivf(build_ivf()) "
        f"(bucket strips equal, the same spill rows, the same answers; "
        f"build s {json.dumps(ctx['times']['ivf_build_s'])})")
    ctx["s"]["ivf"] = time.perf_counter() - t0

    # -- 4. the dedup ring ----------------------------------------------------
    t0 = time.perf_counter()
    ring = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = m["dedup_x"].to(dt)
        reset()
        got = sharded_first_match(x, DEDUP_TAU, mesh)
        keep(f"ring_{name}", {first_match: s * s})
        one = first_match(x, x, DEDUP_TAU, intra=True).cpu().long()
        check(torch.equal(got, one), f"4i ring {name}: ids differ at "
              f"{int((got != one).sum())} rows")
        if name == "f32":
            ctx["ring_first"] = one.numpy()
        ring[name] = (time_ms(lambda: sharded_first_match(x, DEDUP_TAU,
                                                          mesh),
                              iters=3, warmup=1),
                      time_ms(lambda: first_match(x, x, DEDUP_TAU,
                                                  intra=True),
                              iters=3, warmup=1))
    ctx["times"]["ring_ms"] = ring
    ctx["report"].append(
        f"4i (4) dedup ring over {DEDUP_ROWS} x {DIM} planted rows, "
        f"{s} x {s} blocks: every id = one-device K9's; ms ring / one "
        f"device: " + ", ".join(f"{n} {r:.3f} / {o:.3f}"
                                for n, (r, o) in ring.items()))
    ctx["s"]["ring"] = time.perf_counter() - t0

    # -- 5. the engine, the stream and search_hp on the mesh --------------
    t0 = time.perf_counter()
    idx, engine = m["idx"], m["engine"]
    eng = SearchEngine(idx, SearchConfig(), mesh=mesh)
    reset()
    hits = eng.query_image(m["qvec"], top_k=10)
    keep("engine_search", {cosine_topk: s})
    hits_separated(hits, engine.query_image(m["qvec"], top_k=10), 1e-2)
    labels = np.asarray([c == "c0" for c in idx.classes])
    proto = torch.from_numpy(np.asarray(
        idx.embeddings[np.flatnonzero(labels)[:10]])).mean(0)
    got, want = eng.sweep_class(proto, labels), engine.sweep_class(proto,
                                                                   labels)
    check(abs(got.best_threshold - want.best_threshold) <= 1e-3
          and abs(got.best_f1 - want.best_f1) <= 1e-9,
          f"4i sweep_class {got.best_threshold}/{got.best_f1} vs "
          f"{want.best_threshold}/{want.best_f1}")
    del eng
    path = os.path.join(root, "stream.npy")
    np.save(path, np.asarray(big.embeddings, np.float16))
    mm = np.load(path, mmap_mode="r")
    reset()
    t1 = time.perf_counter()
    sv, si = streaming_topk(mm, qbig, k=10, chunk_rows=STREAM_CHUNK,
                            mesh=mesh)
    stream_s = time.perf_counter() - t1
    chunks_n = -(-GALLERY_ROWS // STREAM_CHUNK)
    keep("stream", {cosine_topk: s * chunks_n})
    ov, oi = streaming_topk(mm, qbig, k=10, chunk_rows=STREAM_CHUNK,
                            device=dev)
    check(float(np.abs(sv - ov).max()) <= 1e-5, "4i stream values")
    separated_equal(torch.from_numpy(sv), torch.from_numpy(si),
                    torch.from_numpy(ov), torch.from_numpy(oi), 1e-5)
    del mm
    os.remove(path)
    rng = np.random.default_rng(SEED + 41)
    feats = rng.normal(size=(HP_ROWS, DIM)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    keys = rng.normal(size=(HP_KEYS, DIM)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    values = np.eye(HP_CLASSES, dtype=np.float32)[
        rng.integers(0, HP_CLASSES, HP_KEYS)]
    cw = rng.normal(size=(DIM, HP_CLASSES)).astype(np.float32)
    cw /= np.linalg.norm(cw, axis=0, keepdims=True)
    labels_hp = rng.integers(0, HP_CLASSES, HP_ROWS)
    f_dev = torch.from_numpy(feats).to(dev)
    t1 = time.perf_counter()
    hp = tip.search_hp(f_dev, keys, values, cw, labels_hp, HP_CLASSES,
                       mesh=mesh)
    hp_s = time.perf_counter() - t1
    hp1 = tip.search_hp(f_dev, keys, values, cw, labels_hp, HP_CLASSES)
    d = float(np.abs(hp.grid - hp1.grid).max())
    check(d <= 1e-6 and (hp.beta, hp.alpha) == (hp1.beta, hp1.alpha),
          f"4i search_hp: grids differ by {d}, ({hp.beta}, {hp.alpha}) vs "
          f"({hp1.beta}, {hp1.alpha})")
    ctx["report"].append(
        f"4i (5) SearchEngine(mesh=) over 4a's index: image top-10 = 4a's, "
        f"sweep_class = 4a's ({got.best_threshold:.4f}, f1 "
        f"{got.best_f1:.4f}); streaming_topk(mesh=) over a 1 GiB f16 "
        f"memmap in {STREAM_CHUNK}-row chunks = one-device stream "
        f"({stream_s:.2f} s, K1 {s} a chunk); search_hp(mesh=) "
        f"{hp.grid.shape} grid within 1e-6 of one device, same (beta, "
        f"alpha) ({hp_s:.2f} s)")
    ctx["s"]["engine_stream_hp"] = time.perf_counter() - t0

    # -- 6. processes on the card ---------------------------------------------
    t0 = time.perf_counter()
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    sub = g[:MESH_WORKER_IVF_ROWS]
    cents_path = os.path.join(root, "worker_cents.npy")
    np.save(cents_path, ivf_mod.train_centroids(
        sub[::4].float().cpu(), MESH_WORKER_CLUSTERS, device="cpu").numpy())
    outs = [os.path.join(root, f"worker{i}.npz")
            for i in range(MESH_WORKERS)]
    cmd = worker_cmd or [sys.executable, os.path.abspath(__file__),
                         "--mesh-worker"]
    procs = [subprocess.Popen(
        cmd + [f"127.0.0.1:{port}", str(MESH_WORKERS), str(i), outs[i],
               cents_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(MESH_WORKERS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        check(p.returncode == 0, f"4i worker exited {p.returncode}: "
              f"{log[-3000:]}")
    res = [dict(np.load(o)) for o in outs]
    q = g[torch.arange(8, device=dev) * 997].float()
    fv, fi = cosine_topk(q.to(torch.bfloat16), g, 10)
    # the IVF fill normalizes its f32 rows again before the bf16 cast
    iv, ii = cosine_topk(q.to(torch.bfloat16), l2_normalize(
        sub.float()).to(torch.bfloat16), 10)
    per = MESH_WORKERS * 2
    for r, w in zip(res, range(MESH_WORKERS)):
        lo = w * GALLERY_ROWS // MESH_WORKERS
        check(r["rows"].tolist() == [lo, lo + GALLERY_ROWS // MESH_WORKERS],
              f"4i worker {w} placed rows {r['rows'].tolist()}")
        check(r["placed"].tolist() == [w * 2 <= p < w * 2 + 2
                                       for p in range(per)],
              f"4i worker {w} placed blocks {r['placed'].tolist()}")
        counts = json.loads(str(r["counts"]))
        check(counts == {"cosine_topk": 2, "probe_buckets": 2,
                         "first_match": 2 * per},
              f"4i worker {w} launches {counts}")
        for key in ("vals", "ids", "ivf_vals", "ivf_ids", "first"):
            check(np.array_equal(r[key], res[0][key]),
                  f"4i workers disagree on {key}")
    r = res[0]
    check(float(np.abs(r["vals"] - fv.cpu().numpy()).max()) <= 1e-6,
          "4i workers' top-10 values")
    separated_equal(torch.from_numpy(r["vals"]), torch.from_numpy(r["ids"]),
                    fv, fi, 1e-5)
    check(float(np.abs(r["ivf_vals"] - iv.cpu().numpy()).max()) <= 1e-5,
          "4i workers' IVF values")
    separated_equal(torch.from_numpy(r["ivf_vals"]),
                    torch.from_numpy(r["ivf_ids"]), iv, ii, 1e-5)
    check(np.array_equal(r["first"], ctx.pop("ring_first")),
          "4i workers' ring != one-device K9")
    ctx["s"]["processes"] = time.perf_counter() - t0
    ctx["report"].append(
        f"4i (6) {MESH_WORKERS} processes on the card (gloo over "
        f"127.0.0.1, 2 shards each, the data axis process-major): each "
        f"placed only its {GALLERY_ROWS // MESH_WORKERS} rows; top-10, IVF "
        f"at nprobe = C ({MESH_WORKER_IVF_ROWS} rows, C="
        f"{MESH_WORKER_CLUSTERS}) and the ring identical in both and equal "
        f"to this process's one-device answers "
        f"({ctx['s']['processes']:.1f} s)")
    del g
    torch.cuda.empty_cache()
    return ctx


def kv_cache(dev, g, layers, b, kvh, s, hd, quantized):
    """A stacked random [L, B, KVH, S, HD] cache: bf16, or int8 + scales."""
    from mmrs_tpu_torch.models.llama import _quantize_kv

    k, v = (torch.randn((layers, b, kvh, s, hd), device=dev, generator=g)
            for _ in range(2))
    if not quantized:
        return k.to(torch.bfloat16), None, v.to(torch.bfloat16), None
    (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
    return kq, ks, vq, vs


def attn_err(out, ref, what: str) -> float:
    """max |kernel - plain| of K10/K11 outputs, held to KV_ATTN_TOL (both
    round the probabilities to bf16; an ulp of exp() may flip a rounding),
    99% of the elements to 1e-4."""
    d = (out - ref).abs()
    err = float(d.max())
    check(err <= KV_ATTN_TOL and float((d > 1e-4).float().mean()) <= 0.01,
          f"{what}: kernel vs plain max|d| {err}, "
          f"{float((d > 1e-4).float().mean()):.4f} of elements over 1e-4")
    return err


def kv_attention_checks(dev, gen):
    """Phase 3 for K10 / K11 at the 7B and draft shapes: each kernel
    against its plain version on layer views of stacked 32-layer caches.
    Returns (max error of K10, of K11, report lines)."""
    from mmrs_tpu_torch.ops.decode_attention import (chunk_attention,
                                                     decode_attention)

    errs = {"chunk_attention": 0.0, "decode_attention": 0.0}
    lines = []
    shapes = {"7B": (32, 1, 128), "draft": (4, 8, 64)}
    for quantized in (False, True):
        kind = "int8" if quantized else "bf16"
        for name, (kvh, g, hd) in shapes.items():
            layers = 32 if name == "7B" else 22
            k, ks, v, vs = kv_cache(dev, gen, layers, LLAVA_B, kvh,
                                    KV_SLOTS, hd, quantized)
            li = layers - 1
            view = (k[li], None if ks is None else ks[li], v[li],
                    None if vs is None else vs[li])
            rows = torch.tensor([650, 3, 703, 511, 640, 600, 0, 100],
                                device=dev)[:LLAVA_B]
            q1 = torch.randn((LLAVA_B, kvh, g, hd), device=dev,
                             generator=gen).to(torch.bfloat16)
            e11 = max(attn_err(decode_attention(q1, *view, p),
                               decode_attention(q1, *view, p, impl="torch"),
                               f"K11 {name} {kind} pos {p}")
                      for p in (0, 650, rows))
            cases = [(64, 576, 640), (64, 0, 64), (5, 600, None),
                     (2, rows.clamp(min=1) - 1, None)] if name == "7B" else [
                (2, 599, None), (2, rows[:LLAVA_B].clamp(1, 700) - 1, None)]
            e10 = 0.0
            for c, p, lim in cases:
                qc = torch.randn((LLAVA_B, kvh, g, c, hd), device=dev,
                                 generator=gen).to(torch.bfloat16)
                e10 = max(e10, attn_err(
                    chunk_attention(qc, *view, p, kv_limit=lim),
                    chunk_attention(qc, *view, p, kv_limit=lim,
                                    impl="torch"),
                    f"K10 {name} {kind} C={c}"))
            errs["decode_attention"] = max(errs["decode_attention"], e11)
            errs["chunk_attention"] = max(errs["chunk_attention"], e10)
            lines.append(
                f"phase 3 K10/K11 {name} {kind} cache [{layers},{LLAVA_B},"
                f"{kvh},{KV_SLOTS},{hd}] G={g}, layer {li}'s view: K11 at "
                f"pos 0 / 650 / per row (dead tails) max|d| {e11:.3e}; K10 "
                f"C={'/'.join(str(c[0]) for c in cases)} (window 640, 64; "
                f"per-row starts) max|d| {e10:.3e}; limit {KV_ATTN_TOL}")
            del k, ks, v, vs
        # C.2: the draft's head shape at S = 8192, past one block's shared
        # memory in the single-block design (its own generator: the later
        # phases draw the same data as before this case was added)
        s_long, g2 = 8192, torch.Generator(device=dev).manual_seed(SEED + 8)
        k, ks, v, vs = kv_cache(dev, g2, 1, LLAVA_B, 4, s_long, 64,
                                quantized)
        view = (k[0], None if ks is None else ks[0], v[0],
                None if vs is None else vs[0])
        q1 = torch.randn((LLAVA_B, 4, 8, 64), device=dev,
                         generator=g2).to(torch.bfloat16)
        rows = torch.randint(0, s_long, (LLAVA_B,), device=dev,
                             generator=g2)
        e11 = max(attn_err(decode_attention(q1, *view, p),
                           decode_attention(q1, *view, p, impl="torch"),
                           f"K11 draft {kind} S={s_long} pos {p}")
                  for p in (s_long - 1, 3000, rows))
        errs["decode_attention"] = max(errs["decode_attention"], e11)
        lines.append(
            f"phase 3 K11 draft {kind} cache [1,{LLAVA_B},4,{s_long},64] "
            f"G=8: pos {s_long - 1} / 3000 / per row max|d| {e11:.3e}; "
            f"limit {KV_ATTN_TOL}")
        del k, ks, v, vs
        # head dims 80 and 96 (LLaMA-family models between the 64 / 128
        # instances; run on the 128 instance, the cache read as it is) at a
        # small depth: 2 layers, 8 kv heads, G = 4 (own generator)
        g3 = torch.Generator(device=dev).manual_seed(SEED + 9)
        for hd in (80, 96):
            k, ks, v, vs = kv_cache(dev, g3, 2, LLAVA_B, 8, KV_SLOTS, hd,
                                    quantized)
            view = (k[1], None if ks is None else ks[1], v[1],
                    None if vs is None else vs[1])
            q1 = torch.randn((LLAVA_B, 8, 4, hd), device=dev,
                             generator=g3).to(torch.bfloat16)
            rows = torch.randint(0, KV_SLOTS, (LLAVA_B,), device=dev,
                                 generator=g3)
            e11 = max(attn_err(decode_attention(q1, *view, p),
                               decode_attention(q1, *view, p, impl="torch"),
                               f"K11 HD={hd} {kind} pos {p}")
                      for p in (650, rows))
            e10 = 0.0
            for c, p, lim in ((64, 576, 640), (5, 600, None)):
                qc = torch.randn((LLAVA_B, 8, 4, c, hd), device=dev,
                                 generator=g3).to(torch.bfloat16)
                e10 = max(e10, attn_err(
                    chunk_attention(qc, *view, p, kv_limit=lim),
                    chunk_attention(qc, *view, p, kv_limit=lim,
                                    impl="torch"),
                    f"K10 HD={hd} {kind} C={c}"))
            errs["decode_attention"] = max(errs["decode_attention"], e11)
            errs["chunk_attention"] = max(errs["chunk_attention"], e10)
            lines.append(
                f"phase 3 K10/K11 HD={hd} {kind} cache [2,{LLAVA_B},8,"
                f"{KV_SLOTS},{hd}] G=4, layer 1's view: K11 at pos 650 / per "
                f"row max|d| {e11:.3e}; K10 C=64 (window 640) / 5 max|d| "
                f"{e10:.3e}; limit {KV_ATTN_TOL}")
            del k, ks, v, vs
    return errs, lines


def repair_checks(dev):
    """Phase 3 for the shapes the kernels once refused (ROADMAP C.3, C.4,
    the K10 / K11 head dims and grids), each against its plain version on
    the card, with its own generator (the later phases draw the same
    data): K2 f32 at the 336-px L/14 shape [8, 577, 1024] / 16 (1e-5),
    bf16 at hd 160 and past 65,535 images; K1 / K4 / K9 at D = 100, 520
    and 2304 (K1 within 1e-5 and ids where separated, K4 ids and values
    equal, K9 every id equal); K10 / K11 at hd 100, 288, 576 and 1024
    (K11's 512 and 1024 instances; K10's rows as K11 calls) and at B or
    KVH past 65,535. Returns (max errors by kernel, report lines)."""
    from mmrs_tpu_torch.ops.allpairs import first_match
    from mmrs_tpu_torch.ops.attention import mha_short_seq
    from mmrs_tpu_torch.ops.decode_attention import (chunk_attention,
                                                     decode_attention)
    from mmrs_tpu_torch.ops.quant import cosine_topk_quantized, quantize_rows
    from mmrs_tpu_torch.ops.topk import cosine_topk

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    errs = {"mha_short_seq": 0.0, "cosine_topk": 0.0, "first_match": 0.0,
            "decode_attention": 0.0, "chunk_attention": 0.0}
    lines = []
    for b, t, w, h, dtype, tol in (
            (LLAVA_B, 577, 1024, 16, torch.float32, 1e-5),
            (2, 577, 320, 2, torch.bfloat16, 2e-2),
            (65_540, 5, 32, 2, torch.bfloat16, 2e-2),
            (65_540, 5, 32, 2, torch.float32, 1e-5)):
        q, k, v = (torch.randn((b, t, w), device=dev, generator=g).to(dtype)
                   for _ in range(3))
        q = q * (w // h) ** -0.5
        d = float((mha_short_seq(q, k, v, h).float()
                   - mha_short_seq(q, k, v, h, impl="torch").float())
                  .abs().max())
        check(d <= tol, f"mha_short_seq {dtype} [{b},{t},{w}]/{h}: max|d| "
                        f"{d} (limit {tol})")
        errs["mha_short_seq"] = max(errs["mha_short_seq"], d)
        lines.append(f"phase 3 K2 mha_short_seq [{b},{t},{w}]/{h} "
                     f"{str(dtype)[6:]}: max|d| {d:.3e} (limit {tol})")
    for d in (100, 520, 2304):
        gal = torch.randn((65_536, d), device=dev, generator=g)
        gal = gal / gal.norm(dim=1, keepdim=True)
        rows = torch.randint(0, 65_536, (8,), device=dev, generator=g)
        qv = gal[rows] + 0.05 * torch.randn((8, d), device=dev, generator=g)
        qv = qv / qv.norm(dim=1, keepdim=True)
        gb, qb = gal.to(torch.bfloat16), qv.to(torch.bfloat16)
        packed = quantize_rows(gb.float())
        for k in (10, 100):
            vals, ids = cosine_topk(qb, gb, k)
            rv, ri = cosine_topk(qb, gb, k + 1, impl="torch")
            errs["cosine_topk"] = max(errs["cosine_topk"],
                                      topk_agree(vals, ids, rv, ri, tol=1e-5))
            vals, ids = cosine_topk_quantized(qv, *packed, k)
            rv, ri = cosine_topk_quantized(qv, *packed, k, impl="torch")
            check(torch.equal(ids, ri) and torch.equal(vals, rv),
                  f"K4 D={d} k={k}: kernel != plain (ids differ at "
                  f"{int((ids != ri).sum())})")
        x = gal[:16_384]
        x[8000:8100] = near_rows(x[:100], 0.995, g)
        for dtype in (torch.float32, torch.bfloat16):
            got = first_match(x.to(dtype), x.to(dtype), DEDUP_TAU, intra=True)
            want = first_match(x.to(dtype), x.to(dtype), DEDUP_TAU,
                               intra=True, impl="torch")
            check(torch.equal(got, want) and int((got >= 0).sum()) >= 100,
                  f"K9 D={d} {dtype}: ids differ at "
                  f"{int((got != want).sum())}")
        lines.append(f"phase 3 C.4 D={d}: K1 (65,536 rows, Q=8, k=10, 100) "
                     f"within 1e-5 and ids agree where separated, K4 ids and "
                     f"values equal, K9 (16,384 rows, f32 and bf16) every id "
                     f"equal to plain")
        del gal, gb, packed, x
    for hd in (100, 288, 576, 1024):
        for quantized in (False, True):
            k, ks, v, vs = kv_cache(dev, g, 1, 2, 4, KV_SLOTS, hd, quantized)
            cache = (k[0], None if ks is None else ks[0], v[0],
                     None if vs is None else vs[0])
            for gq in (1, 8):
                q = torch.randn((2, 4, gq, hd), device=dev,
                                generator=g).to(torch.bfloat16)
                for pos in (KV_SLOTS - 1, torch.tensor([KV_SLOTS - 1, 100],
                                                        device=dev)):
                    errs["decode_attention"] = max(
                        errs["decode_attention"],
                        attn_err(decode_attention(q, *cache, pos),
                                 decode_attention(q, *cache, pos,
                                                  impl="torch"),
                                 f"K11 hd={hd} G={gq}"))
                qc = torch.randn((2, 4, gq, 64, hd), device=dev,
                                 generator=g).to(torch.bfloat16)
                errs["chunk_attention"] = max(
                    errs["chunk_attention"],
                    attn_err(chunk_attention(qc, *cache, 576, kv_limit=640),
                             chunk_attention(qc, *cache, 576, kv_limit=640,
                                             impl="torch"),
                             f"K10 hd={hd} G={gq}"))
        lines.append(f"phase 3 K10/K11 hd={hd} (bf16 and int8 caches, G=1, "
                     f"8, {KV_SLOTS} slots): within {KV_ATTN_TOL} of plain, "
                     f"99% to 1e-4")
    for b, kvh in ((65_600, 1), (1, 65_600)):
        k, ks, v, vs = kv_cache(dev, g, 1, b, kvh, 8, 64, False)
        q = torch.randn((b, kvh, 2, 64), device=dev,
                        generator=g).to(torch.bfloat16)
        pos = torch.randint(0, 8, (b,), device=dev, generator=g)
        errs["decode_attention"] = max(
            errs["decode_attention"],
            attn_err(decode_attention(q, k[0], None, v[0], None, pos),
                     decode_attention(q, k[0], None, v[0], None, pos,
                                      impl="torch"), f"K11 B={b} KVH={kvh}"))
        qc = torch.randn((b, kvh, 2, 3, 64), device=dev,
                         generator=g).to(torch.bfloat16)
        errs["chunk_attention"] = max(
            errs["chunk_attention"],
            attn_err(chunk_attention(qc, k[0], None, v[0], None, 4),
                     chunk_attention(qc, k[0], None, v[0], None, 4,
                                     impl="torch"), f"K10 B={b} KVH={kvh}"))
    lines.append("phase 3 K10/K11 grids B=65,600 x KVH=1 and B=1 x KVH="
                 f"65,600 (8 slots, G=2): within {KV_ATTN_TOL} of plain")
    return errs, lines


def kv_attention_times(dev, gen, prompt_len: int):
    """Phase 6 for K10 / K11 at the 7B verify pack's shapes (B=8, 32 kv
    heads, HD=128, the cache of this run's prompt): the middle decode step
    (K11, also at the draft's head shape: 4 kv heads, G=8, HD=64) and the
    last prefill chunk (K10), bf16 and int8 caches, kernel and plain in
    turns, each beside its bound and (bf16) PyTorch's
    scaled_dot_product_attention on the same inputs with a boolean
    key_pos <= q_pos mask. K11 and its SDPA yardstick are timed on the
    card alone (`graph_ms`), K10 and the plain versions eagerly.
    {(name, kind): (ms, plain ms, (bound ms, by), library ms or None)}
    with name "decode_draft" for the draft's K11; ({(name, kind): (min,
    median, max) ms of a K11 call across graph replays}, {(name, kind):
    ms of an eager K11 call})."""
    from mmrs_tpu_torch.ops.decode_attention import (chunk_attention,
                                                     decode_attention,
                                                     hd_scale)

    b, kvh, hd = LLAVA_B, 32, 128
    cache_len = -(-(prompt_len + LLAVA_MAX_NEW) // 64) * 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out, spreads, eager = {}, {}, {}
    # K11: decode step 16 attends to pos + 1 keys per row
    pos = prompt_len + LLAVA_MAX_NEW // 2
    n = pos + 1
    dmask = (torch.arange(cache_len, device=dev) <= pos)[None, None, None]
    for quantized in (False, True):
        kind = "int8" if quantized else "bf16"
        for name, (dkvh, g, dhd) in (("decode_attention", (kvh, 1, hd)),
                                     ("decode_draft", (4, 8, 64))):
            k, ks, v, vs = kv_cache(dev, gen, 1, b, dkvh, cache_len, dhd,
                                    quantized)
            view = (k[0], None if ks is None else ks[0], v[0],
                    None if vs is None else vs[0])
            per_key = 2 * dhd * k.element_size() + (8 if quantized else 0)
            q1 = torch.randn((b, dkvh, g, dhd), device=dev,
                             generator=gen).to(torch.bfloat16)
            # the kernel alone (a CUDA graph of its launches: the eager
            # call's host dispatch is as long as the kernel), in turns
            # with the plain version; the eager call beside it
            kernel = lambda: decode_attention(q1, *view, pos)
            plain = lambda: decode_attention(q1, *view, pos, impl="torch")
            p1, k1, k2, p2 = (time_ms(plain, 50), graph_ms(kernel),
                              graph_ms(kernel), time_ms(plain, 50))
            kms, pms = (k1[0] + k2[0]) / 2, (p1 + p2) / 2
            spreads[(name, kind)] = k1[1:]
            eager[(name, kind)] = time_ms(kernel, 50)
            bound = least_ms(b * dkvh * (n * per_key + g * dhd * (2 + 4)),
                             4 * b * dkvh * g * n * dhd, "bf16")
            lib = None
            if not quantized:
                qh = q1.view(b, dkvh * g, 1, dhd)
                lib = graph_ms(lambda: sdpa(qh, view[0], view[2],
                                            attn_mask=dmask,
                                            scale=hd_scale(dhd),
                                            enable_gqa=g > 1))[0]
            out[(name, kind)] = (kms, pms, bound, lib)
            del k, ks, v, vs
    for quantized in (False, True):
        kind = "int8" if quantized else "bf16"
        k, ks, v, vs = kv_cache(dev, gen, 2, b, kvh, cache_len, hd,
                                quantized)
        view = (k[1], None if ks is None else ks[1], v[1],
                None if vs is None else vs[1])
        per_key = 2 * hd * k.element_size() + (8 if quantized else 0)
        # K10: the last 64-token chunk of the chunked prefill
        start = (prompt_len - 1) // 64 * 64
        c = prompt_len - start
        lim = min(cache_len, -(-prompt_len // 64) * 64)
        qc = torch.randn((b, kvh, 1, c, hd), device=dev, generator=gen).to(
            torch.bfloat16)
        kms, pms = time_pair(
            lambda: chunk_attention(qc, *view, start, kv_limit=lim),
            lambda: chunk_attention(qc, *view, start, kv_limit=lim,
                                    impl="torch"), iters=50)
        nk = start + c
        causal = sum(start + r + 1 for r in range(c))
        bound = least_ms(b * kvh * (nk * per_key + c * hd * 2 + c * hd * 4),
                         4 * b * kvh * causal * hd, "bf16")
        lib = None
        if not quantized:
            mask = (torch.arange(lim, device=dev)[None, :]
                    <= start + torch.arange(c, device=dev)[:, None])
            lib = time_ms(lambda: sdpa(
                qc[:, :, 0], view[0][:, :, :lim], view[2][:, :, :lim],
                attn_mask=mask, scale=hd_scale(hd)), iters=50)
        out[("chunk_attention", kind)] = (kms, pms, bound, lib)
        del k, ks, v, vs
    return out, (spreads, eager), cache_len, (start, c, lim)


# ---- the float dense layer's epilogue (phases 3, 5 and 6) ---------------------

# [M, N] f32 sums of the towers' denses in one index batch of 256 images:
# ViT-B/32 (50 tokens) wq/wk/wv/wo/w2 and w1, ViT-L/14 (257 tokens) alike;
# w1's epilogue carries QuickGELU
EPILOGUE_SHAPES = (("B/32 w", 12800, 768, None),
                   ("B/32 w1", 12800, 3072, "quick_gelu"),
                   ("L/14 w", 65792, 1024, None),
                   ("L/14 w1", 65792, 4096, "quick_gelu"))
EPILOGUE_BATCH = 256          # the benchmark's index batch


def epilogue_sums(dev, m: int, n: int, seed: int) -> torch.Tensor:
    """f32 sums with zeros, negative zeros, bf16 rounding ties, values past
    QuickGELU's exp overflow and subnormal values among them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn((m, n), device=dev, generator=g) * 3.0
    flat = y.view(-1)
    flat[::101] = 0.0
    flat[7::103] = -0.0
    flat[3::107] = 1.0 + 2.0 ** -8
    flat[11::113] = -60.0
    flat[17::131] = 1e-39
    return y


def dense_epilogue_phase(dev) -> dict:
    """The epilogue kernel against its plain ops at the towers' shapes
    (every bf16 bit, bias with each activation, and without a bias), its
    ms beside its bound (6 bytes an element over PEAK_BYTES) and the plain
    ops' ms (time_pair), and, for a ViT-B/32 and a ViT-L/14 tower at
    random weights, the launches of one 256-image batch (6 a block plus
    the patch embedding) and the batch's ms with the kernel and with the
    plain ops in every dense."""
    from mmrs_tpu_torch.models import layers, vit
    from mmrs_tpu_torch.models.configs import IMAGE_TOWERS
    from mmrs_tpu_torch.ops.dense_epilogue import bias_act

    out = {"lines": [], "times": {}, "bounds": {}, "towers": {}}
    bad = 0
    with torch.inference_mode():
        for i, (name, m, n, act) in enumerate(EPILOGUE_SHAPES):
            y = epilogue_sums(dev, m, n, SEED + i)
            b = torch.randn(n, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(i))
            for a in (None, "quick_gelu", "gelu"):
                for bias in (b, None):
                    got = bias_act(y, bias, a, torch.bfloat16)
                    ref = bias_act(y, bias, a, torch.bfloat16, impl="torch")
                    diff = int((got.view(torch.int16)
                                != ref.view(torch.int16)).sum())
                    bad += diff
                    check(diff == 0, f"bias_act {name} [{m},{n}] act {a} "
                          f"bias {bias is not None}: {diff} elements differ")
            for a in dict.fromkeys((act, "gelu")):
                key = f"{name} [{m},{n}] {a or 'bias'}"
                out["times"][key] = time_pair(
                    lambda: bias_act(y, b, a, torch.bfloat16),
                    lambda: bias_act(y, b, a, torch.bfloat16, impl="torch"),
                    iters=20)
                out["bounds"][key] = m * n * 6 / PEAK_BYTES * 1e3
            del y
        out["lines"].append(
            f"phase 3 dense epilogue bias_act at {len(EPILOGUE_SHAPES)} "
            f"tower shapes x (none, quick_gelu, gelu) x (bias, none): "
            f"{bad} bf16 elements differ from the plain ops")

        def plain(y32, bias, act, out_dtype, impl="auto"):
            return bias_act(y32, bias, act, out_dtype, impl="torch")

        for name in ("vit_b32", "vit_l14"):
            cfg = IMAGE_TOWERS[name]
            with torch.device(dev):
                model = vit.VisionTransformer(cfg)
            model.reset_parameters(torch.Generator(device=dev).manual_seed(0))
            model = model.eval().requires_grad_(False)
            for mod in model.modules():
                if isinstance(mod, torch.nn.Linear):
                    mod.weight.data = mod.weight.data.bfloat16()
            px = torch.randn((EPILOGUE_BATCH, 224, 224, 3), device=dev,
                             generator=torch.Generator(device=dev
                                                       ).manual_seed(1)
                             ).bfloat16()
            before = bias_act.launches
            emb = model(px)
            launches = bias_act.launches - before
            check(launches == 6 * cfg.layers + 1,
                  f"{name} batch of {EPILOGUE_BATCH}: {launches} bias_act "
                  f"launches, want {6 * cfg.layers + 1}")
            kernel_fn = layers.bias_act

            def run_with(fn, call):
                layers.bias_act = fn
                try:
                    return call()
                finally:
                    layers.bias_act = kernel_fn

            ref = run_with(plain, lambda: model(px))
            check(torch.equal(emb, ref), f"{name}: the tower's embedding "
                  f"with the kernel differs from the plain ops'")
            # kernel, plain, plain, kernel
            k1, p1, p2, k2 = (run_with(fn, lambda: time_ms(
                lambda: model(px), iters=3, warmup=1))
                for fn in (kernel_fn, plain, plain, kernel_fn))
            out["towers"][name] = {"launches": launches,
                                   "kernel_ms": (k1 + k2) / 2,
                                   "plain_ms": (p1 + p2) / 2}
            out["lines"].append(
                f"phase 3 dense epilogue {name} batch {EPILOGUE_BATCH}: "
                f"{launches} bias_act launches, embedding equal to the "
                f"plain ops' in every bit")
            del model, px
    return out


def epilogue_time_lines(epi: dict, card: str):
    """Phase 6's lines for dense_epilogue_phase's times."""
    lines = [f"phase 6 dense epilogue bias_act on {card} (CUDA events, 20 "
             f"calls, kernel and plain in turns; bound = 6 bytes an element "
             f"over 3.35 TB/s):"]
    for key, (kms, pms) in epi["times"].items():
        bound = epi["bounds"][key]
        m, n = (int(v) for v in key.split("[")[1].split("]")[0].split(","))
        lines.append(
            f"  {key}: kernel {kms:.4f} ms ({m * n * 6 / kms / 1e6:.0f} "
            f"GB/s, {kms / bound:.2f}x its bound {bound:.4f} ms), plain "
            f"ops {pms:.4f} ms ({pms / kms:.2f}x the kernel)")
    for name, t in epi["towers"].items():
        lines.append(
            f"  {name} tower, batch {EPILOGUE_BATCH} (random weights): "
            f"{t['kernel_ms']:.2f} ms with the kernel, {t['plain_ms']:.2f} "
            f"ms with the plain ops ({EPILOGUE_BATCH / t['kernel_ms'] * 1e3:.0f}"
            f" / {EPILOGUE_BATCH / t['plain_ms'] * 1e3:.0f} img/s), "
            f"{t['launches']} launches")
    return lines


# ---- the SigLIP so400m/14 tower's kernels (K2 at hd 72, E1 tanh GELU) -------

SIGLIP_BATCH = 256            # the siglip-so400m.index cell's batch
SIGLIP_T, SIGLIP_W, SIGLIP_HEADS, SIGLIP_MLP = 729, 1152, 16, 4304


def k2_times(dev) -> dict:
    """K2 at SigLIP's [256, 729, 1152] / 16 heads of 72, of whatever
    package `mmrs_tpu_torch` imports (this tree's, or a parent's under
    --k2-times ROOT): ms a call (CUDA events) and the plan it took."""
    from mmrs_tpu_torch.ops.attention import mha_plan, mha_short_seq

    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn((SIGLIP_BATCH, SIGLIP_T, SIGLIP_W), device=dev,
                           generator=gen).bfloat16() for _ in range(3))
    hd = SIGLIP_W // SIGLIP_HEADS
    q = q * hd ** -0.5
    with torch.inference_mode():
        ms = time_ms(lambda: mha_short_seq(q, k, v, SIGLIP_HEADS), iters=10)
    return {"ms": ms, "plan": list(mha_plan(SIGLIP_T, hd, torch.bfloat16))}


def siglip_phase(dev, card: str, parent: Optional[str] = None) -> list:
    """SigLIP's kernels at the index cell's shapes: K2 at [256, 729, 1152]
    / 16 heads of 72 on its HDP = 80 instance against the plain version,
    its ms beside the parent tree's (hd 72 padded to 128; a process of its
    own, --k2-times), SDPA's and the bound; E1's tanh GELU at [186,624,
    4304] f32 sums (every bf16 bit against the plain ops, its ms beside
    its bound); K6's tanh GELU at [5,832, 1152] -> 4304 (H padded to 4320)
    equal to its plain version; K3 with SigLIP's mean and std at [256,
    384, 384, 3] against its plain version; and one `image_encode` of 256
    uint8 images through `build_towers`'s pair (random weights) with its
    K3, K2, E1 and pool-attention launches."""
    import torch.nn.functional as F

    from mmrs_tpu_torch.models.layers import MLP
    from mmrs_tpu_torch.models.quantize import quantize_tree
    from mmrs_tpu_torch.ops.attention import mha_short_seq, pool_attention
    from mmrs_tpu_torch.ops.dense_epilogue import bias_act, gelu_tanh
    from mmrs_tpu_torch.ops.mlp_int8 import mlp_int8_fused

    lines = []
    b, t, w, h = SIGLIP_BATCH, SIGLIP_T, SIGLIP_W, SIGLIP_HEADS
    hd = w // h
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.inference_mode():
        q, k, v = (torch.randn((b, t, w), device=dev, generator=gen)
                   .bfloat16() for _ in range(3))
        q = q * hd ** -0.5
        d = float((mha_short_seq(q, k, v, h).float()
                   - mha_short_seq(q, k, v, h, impl="torch").float())
                  .abs().max())
        check(d <= 2e-2, f"K2 SigLIP [{b},{t},{w}]/{h}: max|d| {d}")
        kms, pms = time_pair(lambda: mha_short_seq(q, k, v, h),
                             lambda: mha_short_seq(q, k, v, h, impl="torch"),
                             iters=5, warmup=2)
        q4, k4, v4 = (x.view(b, t, h, hd).transpose(1, 2).contiguous()
                      for x in (q, k, v))
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=1.0), iters=10)
        del q4, k4, v4
        bound, by = least_ms(4 * 2 * b * t * w, 4.0 * b * t * t * w, "bf16")
        old = {}
        if parent is not None:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--k2-times",
                 parent], capture_output=True, text=True, timeout=1200)
            check(out.returncode == 0, f"--k2-times {parent}: "
                  f"{out.stderr[-2000:]}")
            old = json.loads(out.stdout.strip().splitlines()[-1])
        lines.append(
            f"phase 3 K2 SigLIP [{b},{t},{w}]/{h} (hd {hd}) bf16 on {card}: "
            f"max|d| {d:.3e}; kernel {kms:.4f} ms (HDP 80), "
            + (f"parent {old['ms']:.4f} ms (plan {old['plan']}), "
               if old else "")
            + f"SDPA {sdpa:.4f} ms, plain {pms:.4f} ms; bound {bound:.4f} "
            f"ms ({by}): {100 * bound / kms:.1f}% of it")
        del q, k, v

        rows = b * t
        y = epilogue_sums(dev, rows, SIGLIP_MLP, SEED + 7)
        bias = torch.randn(SIGLIP_MLP, device=dev, generator=gen)
        got = bias_act(y, bias, "gelu_tanh", torch.bfloat16)
        ref = bias_act(y, bias, "gelu_tanh", torch.bfloat16, impl="torch")
        diff = got.view(torch.int16) != ref.view(torch.int16)
        n_diff = int(diff.sum())
        ulps = bf16_ulps(got, ref)
        check(n_diff == 0, f"E1 gelu_tanh [{rows},{SIGLIP_MLP}]: {n_diff} "
              f"elements differ from the plain ops, at most {ulps} ulp")
        del got, ref, diff
        ems, eplain = time_pair(
            lambda: bias_act(y, bias, "gelu_tanh", torch.bfloat16),
            lambda: bias_act(y, bias, "gelu_tanh", torch.bfloat16,
                             impl="torch"), iters=10)
        ebound = (rows * SIGLIP_MLP * 6 + 4 * SIGLIP_MLP) / PEAK_BYTES * 1e3
        lines.append(
            f"phase 3 E1 gelu_tanh [{rows},{SIGLIP_MLP}] f32 -> bf16 on "
            f"{card}: {n_diff} elements differ from the plain ops; kernel "
            f"{ems:.4f} ms ({ems / ebound:.2f}x its bound {ebound:.4f} ms, "
            f"{100 * ebound / ems:.1f}%), plain ops {eplain:.4f} ms")
        del y

        m = 8 * t
        with torch.device(dev):       # quantized as the int8 tower is
            mlp = quantize_tree(MLP(w, SIGLIP_MLP, gelu_tanh))
        layer1, layer2 = mlp.w1, mlp.w2
        check(layer1.q.shape == (4320, w), f"K6: the int8 MLP's w1 is "
              f"{tuple(layer1.q.shape)}, want H padded to 4320")
        x = torch.randn((m, w), device=dev, generator=gen).bfloat16()
        args = (x, layer1.q, layer1.s, layer1.bias, layer2.q, layer2.s,
                layer2.bias)
        got = mlp_int8_fused(*args, act="gelu_tanh")
        ref = mlp_int8_fused(*args, act="gelu_tanh", impl="torch")
        n_diff = int((got != ref).sum())
        check(n_diff == 0, f"K6 gelu_tanh [{m},{w}]->{SIGLIP_MLP}: {n_diff} "
              f"elements differ")
        lines.append(f"phase 3 K6 gelu_tanh [{m},{w}] -> {SIGLIP_MLP} (H "
                     f"padded to 4320): {n_diff} elements differ from plain")
        del x, got, ref, mlp, layer1, layer2

        # the main path: the pair through build_towers, one image_encode
        # of uint8 384 px images (K3 with SigLIP's mean and std, the
        # tower, the MAP head's `towers.pool`), its launches counted
        from mmrs_tpu_torch.config import Config, ModelConfig
        from mmrs_tpu_torch.ops.preprocess import normalize_images
        from mmrs_tpu_torch.pipeline import build_towers

        towers = build_towers(Config(model=ModelConfig(
            image_tower="siglip_so400m_384",
            text_tower="siglip_text_so400m", dtype="bfloat16"), seed=SEED),
            device=dev)
        cfg = towers.clip_config.vision
        s = cfg.image_size
        px_u8 = torch.randint(0, 256, (b, s, s, 3), device=dev,
                              dtype=torch.uint8, generator=gen)
        half = (0.5, 0.5, 0.5)
        got = normalize_images(px_u8, mean=half, std=half)
        ref = normalize_images(px_u8, impl="torch", mean=half, std=half)
        # as tests/test_torch_cuda.py: at most one bf16 ulp apart
        k3_ok = torch.allclose(got.float(), ref.float(), atol=1e-6,
                               rtol=2 ** -7)
        check(k3_ok, f"K3 SigLIP mean / std [{b},{s},{s},3] against the "
              f"plain ops")
        del got, ref
        px = px_u8.cpu().numpy()
        fns = (normalize_images, mha_short_seq, bias_act, pool_attention)
        before = [f.launches for f in fns]
        emb = towers.image_encode(px)
        counts = tuple(f.launches - n for f, n in zip(fns, before))
        want = (1, cfg.layers, 6 * cfg.layers + 1 + 6, 1)
        check(counts == want,
              f"SigLIP image_encode batch: K3 / K2 / E1 / pool launches "
              f"{counts}, want {want}")
        check(emb.shape == (b, cfg.embed_dim) and bool(np.isfinite(
            emb).all()), f"SigLIP image_encode: {emb.shape}")
        tower = time_ms(lambda: towers.encode_fn(px_u8), iters=3, warmup=1)
        lines.append(
            f"phase 3 SigLIP so400m/14 image_encode (build_towers, bf16, "
            f"random weights), batch {b} of uint8 {s} px on {card}: K3 "
            f"with mean / std 0.5 within one bf16 ulp of the plain ops; "
            f"{tower:.1f} ms on device tensors ({b / tower * 1e3:.1f} "
            f"img/s); {counts[0]} K3, {counts[1]} K2, {counts[2]} E1, "
            f"{counts[3]} pool-attention launches")
        del towers, px_u8, px
    return lines


# ---- the towers' LayerNorm (E2) ------------------------------------------------

# [M, W] rows of one 256-image index batch's full-width norms, and eps:
# ViT-B/32 (50 tokens), ViT-L/14 (257), SigLIP so400m/14 (729)
LAYER_NORM_SHAPES = (("B/32", 12800, 768, 1e-5), ("L/14", 65792, 1024, 1e-5),
                     ("SigLIP", 186624, 1152, 1e-6))
# the index cells' image towers, each with a text tower of its pair
LAYER_NORM_TOWERS = (("vit_b32", "clip_text"), ("vit_l14", "clip_text"),
                     ("siglip_so400m_384", "siglip_text_so400m"))


def ln_rows(dev, m: int, w: int, seed: int) -> torch.Tensor:
    """bf16 rows as the towers' residual streams: N(0, 1), every third row
    40 std from zero mean, every fifth of small spread. A copy of
    tests/layer_norm_cases.rows, which the E2 tests use: keep the two
    alike."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, w), device=dev, generator=g)
    x[::3] += 40.0
    x[1::5] *= 0.01
    return x.bfloat16()


def ln_ulps(a: torch.Tensor, b: torch.Tensor, gain: torch.Tensor) -> float:
    """Largest |a - b| in bf16 spacings at max(|a|, |b|); an output within
    |gain| / 256 of zero counted at the spacing there (the f32 rounding of
    the row's mean, through the gain, sets the difference there). A copy
    of tests/layer_norm_cases.ulps, which the E2 tests hold to one ulp:
    keep the two alike."""
    a, b = a.float(), b.float()
    scale = torch.maximum(torch.maximum(a.abs(), b.abs()),
                          gain.abs() * 2.0 ** -8)
    _, e = torch.frexp(scale)
    return float(((a - b).abs() / torch.ldexp(torch.ones_like(scale),
                                               e - 8)).max())


def layer_norm_phase(dev, card: str) -> dict:
    """E2 against its plain ops at the index cells' shapes (outlier gains:
    1/64 of them 8x): every element within one bf16 ulp of the plain ops
    (`ln_ulps`), and its misses of an f64 LayerNorm rounded to bf16 no more
    than theirs; its ms beside its bound (bf16 in and out, the f32 gains
    and offsets once, over PEAK_BYTES), the plain ops' ms and F.layer_norm
    on the bf16 rows with bf16 gains and offsets (`library_ms`: a
    yardstick the port never calls).
    Then one image_encode of 256 uint8 images through build_towers for
    each index tower (random weights): its E2 launches (ln_pre where the
    tower has it, two a block, ln_post, the MAP head's) and the batch's ms
    on device tensors with E2 and with the plain ops in every norm."""
    import torch.nn.functional as F

    from mmrs_tpu_torch.config import Config, ModelConfig
    from mmrs_tpu_torch.models import layers
    from mmrs_tpu_torch.ops.layer_norm import layer_norm
    from mmrs_tpu_torch.pipeline import build_towers

    out = {"lines": [], "times": {}, "ulps": 0.0, "towers": {}}
    with torch.inference_mode():
        for i, (name, m, w, eps) in enumerate(LAYER_NORM_SHAPES):
            x = ln_rows(dev, m, w, SEED + i)
            g = torch.Generator(device=dev).manual_seed(SEED + 10 + i)
            gain = 1.0 + 0.05 * torch.randn(w, device=dev, generator=g)
            gain[torch.rand(w, device=dev, generator=g) < 1 / 64] *= 8.0
            off = 0.02 * torch.randn(w, device=dev, generator=g)
            before = layer_norm.launches
            got = layer_norm(x, gain, off, eps)
            check(layer_norm.launches == before + 1,
                  f"E2 {name}: the kernel did not launch")
            ref = layer_norm(x, gain, off, eps, impl="torch")
            ulps = ln_ulps(got, ref, gain)
            out["ulps"] = max(out["ulps"], ulps)
            xd = x.double()
            mean = xd.mean(-1, keepdim=True)
            var = (xd - mean).square().mean(-1, keepdim=True)
            exact = ((xd - mean) * torch.rsqrt(var + eps) * gain.double()
                     + off.double()).bfloat16()
            del xd, mean, var
            miss_k = int((got != exact).sum())
            miss_p = int((ref != exact).sum())
            del got, ref, exact
            check(ulps <= 1.0, f"E2 {name} [{m},{w}]: {ulps} bf16 ulp from "
                  f"the plain ops")
            check(miss_k <= miss_p, f"E2 {name} [{m},{w}]: {miss_k} elements "
                  f"miss the f64 LayerNorm, the plain ops {miss_p}")
            kms, pms = time_pair(
                lambda: layer_norm(x, gain, off, eps),
                lambda: layer_norm(x, gain, off, eps, impl="torch"),
                iters=20)
            # on the card alone: at B/32's 39 MB the eager call's host
            # dispatch is longer than the kernel
            alone = graph_ms(lambda: layer_norm(x, gain, off, eps))[0]
            g16, o16 = gain.bfloat16(), off.bfloat16()   # its dtype rule
            lib = time_ms(lambda: F.layer_norm(x, (w,), g16, o16, eps),
                          iters=20)
            bound = least_ms(4 * m * w + 8 * w, 0, "bf16")[0]
            key = f"{name} [{m},{w}]"
            out["times"][key] = {"ms": kms, "alone_ms": alone,
                                 "plain_ms": pms, "library_ms": lib,
                                 "bound_ms": bound}
            out["lines"].append(
                f"phase 3 E2 layer_norm {key} eps {eps:g} on {card}: "
                f"{ulps:.0f} bf16 ulp from the plain ops at most; f64 misses "
                f"{miss_k} (plain {miss_p}) of {m * w}; kernel {kms:.4f} ms "
                f"eager, {alone:.4f} ms on the card alone ("
                f"{100 * bound / alone:.1f}% of its bound {bound:.4f} ms, "
                f"{(4 * m * w + 8 * w) / alone / 1e6:.0f} GB/s), plain ops "
                f"{pms:.4f} ms ({pms / kms:.2f}x eager), F.layer_norm on "
                f"bf16 {lib:.4f} ms")
            del x

        kernel_fn = layers.layer_norm

        def plain(x, weight, bias, eps, impl="auto"):
            return kernel_fn(x, weight, bias, eps, impl="torch")

        def run_with(fn, call):
            layers.layer_norm = fn
            try:
                return call()
            finally:
                layers.layer_norm = kernel_fn

        gen = torch.Generator(device=dev).manual_seed(SEED)
        for image_tower, text_tower in LAYER_NORM_TOWERS:
            towers = build_towers(Config(model=ModelConfig(
                image_tower=image_tower, text_tower=text_tower,
                dtype="bfloat16"), seed=SEED), device=dev)
            cfg = towers.clip_config.vision
            s = cfg.image_size
            px_u8 = torch.randint(0, 256, (256, s, s, 3), device=dev,
                                  dtype=torch.uint8, generator=gen)
            want = (int(cfg.pre_norm) + 2 * cfg.layers + 1
                    + int(cfg.pool == "map"))
            before = layer_norm.launches
            emb = towers.image_encode(px_u8.cpu().numpy())
            launches = layer_norm.launches - before
            check(launches == want, f"{image_tower} image_encode: {launches}"
                  f" E2 launches, want {want}")
            check(bool(np.isfinite(emb).all()), f"{image_tower}: non-finite")
            # E2, plain, plain, E2
            k1, p1, p2, k2 = (run_with(fn, lambda: time_ms(
                lambda: towers.encode_fn(px_u8), iters=3, warmup=1))
                for fn in (kernel_fn, plain, plain, kernel_fn))
            out["towers"][image_tower] = {
                "launches": launches, "kernel_ms": (k1 + k2) / 2,
                "plain_ms": (p1 + p2) / 2}
            out["lines"].append(
                f"phase 3 E2 {image_tower} image_encode (build_towers, bf16,"
                f" random weights), batch 256 on {card}: {launches} E2 "
                f"launches (want {want}); {(k1 + k2) / 2:.2f} ms a batch on "
                f"device tensors with E2, {(p1 + p2) / 2:.2f} ms with the "
                f"plain ops in every norm")
            del towers, px_u8
            torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    if argv[:1] == ["--mesh-worker"] and len(argv) == 6:
        return mesh_worker(argv[1:])
    if argv[:1] == ["--k2-times"] and len(argv) == 2:
        sys.path.insert(0, os.path.abspath(argv[1]))
        print(json.dumps(k2_times(torch.device("cuda", 0))))
        return 0
    if argv[:1] == ["--siglip"] and len(argv) in (1, 3):
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from mmrs_tpu_torch.ops import _cuda

        _cuda.build()
        _cuda.library()
        log = _cuda.library_path()[:-3] + ".log"
        if os.path.exists(log):
            for name, usage in ptxas_lines(log):
                if "mha_mma_kernel" in name or "bias_act" in name:
                    say(f"  ptxas {name}: {usage}")
        parent = (os.path.abspath(argv[2]) if argv[1:2] == ["--parent"]
                  else None)
        for line in siglip_phase(torch.device("cuda", 0), card_line(),
                                 parent):
            say(line)
        print(json.dumps({"ok": True, "seconds": time.perf_counter()
                          - t_start}))
        return 0
    if argv == ["--layer-norm"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from mmrs_tpu_torch.ops import _cuda

        _cuda.build()
        _cuda.library()
        log = _cuda.library_path()[:-3] + ".log"
        if os.path.exists(log):
            for name, usage in ptxas_lines(log):
                if "e2_layer_norm" in name:
                    say(f"  ptxas {name}: {usage}")
        for line in layer_norm_phase(torch.device("cuda", 0),
                                     card_line())["lines"]:
            say(line)
        print(json.dumps({"ok": True, "seconds": time.perf_counter()
                          - t_start}))
        return 0
    if argv[:1] == ["--flat-times"] and len(argv) == 2:
        sys.path.insert(0, os.path.abspath(argv[1]))
        dev = torch.device("cuda", 0)
        flat = flat_scan_times(dev)
        gal, ivfs, _ = clustered_ivfs(dev)
        print(json.dumps({"flat": flat,
                          "probe": probe_scan_times(dev, gal, ivfs)}))
        return 0
    parent = None
    if argv[:1] == ["--parent"] and len(argv) == 2:
        parent = os.path.abspath(argv[1])
    elif argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mmrs_tpu_torch.config import Config, ModelConfig, SearchConfig
    from mmrs_tpu_torch.index import ivf as ivf_mod
    from mmrs_tpu_torch.govern import native as gov_native
    from mmrs_tpu_torch.govern.dedup import embedding_dedup
    from mmrs_tpu_torch.index import gallery as gallery_mod
    from mmrs_tpu_torch.index.gallery import (GalleryIndex, build_index,
                                              update_index)
    from mmrs_tpu_torch.index.ivf import probe_buckets, probe_buckets_q4
    from mmrs_tpu_torch.models import clip
    from mmrs_tpu_torch.models.layers import QLinear
    from mmrs_tpu_torch.ops import _cuda
    from mmrs_tpu_torch.ops.allpairs import first_match
    from mmrs_tpu_torch.models.layers import MLP, quick_gelu
    from mmrs_tpu_torch.models.quantize import quantize_tree
    from mmrs_tpu_torch.ops.attention import mha_short_seq
    from mmrs_tpu_torch.ops.decode_attention import (chunk_attention,
                                                     decode_attention)
    from mmrs_tpu_torch.ops.dense_epilogue import bias_act
    from mmrs_tpu_torch.ops.layer_norm import layer_norm
    from mmrs_tpu_torch.ops.mlp_int8 import mlp_int8_fused
    from mmrs_tpu_torch.ops.normalize import l2_normalize
    from mmrs_tpu_torch.ops.preprocess import normalize_images
    from mmrs_tpu_torch.ops.quant import (_topk_quant_cuda,
                                          cosine_topk_quantized,
                                          quantize_rows)
    from mmrs_tpu_torch.ops import topk as topk_mod
    from mmrs_tpu_torch.ops.quant4 import (_topk_int4_cuda, cosine_topk_int4,
                                           prep_queries, quantize_rows_int4)
    from mmrs_tpu_torch.ops.topk import cosine_topk
    from mmrs_tpu_torch.pipeline import build_towers
    from mmrs_tpu_torch.search import calibrate
    from mmrs_tpu_torch.search.engine import SearchEngine
    from mmrs_tpu_torch.search.prototypes import build_prototype

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    card = card_line()
    kernels = (cosine_topk, mha_short_seq, normalize_images,
               cosine_topk_quantized, cosine_topk_int4, mlp_int8_fused,
               probe_buckets, probe_buckets_q4, first_match,
               chunk_attention, decode_attention, bias_act, layer_norm)
    quant_topk = {"int8": (cosine_topk_quantized, quantize_rows),
                  "int4": (cosine_topk_int4, quantize_rows_int4)}

    # ---- 1. environment --------------------------------------------------
    have = {}
    for mod in ("PIL", "yaml", "regex"):
        try:
            importlib.import_module(mod)
            have[mod] = True
        except ImportError:
            have[mod] = False
    say(f"phase 1 environment: python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" imports {json.dumps(have)}")
    say(card)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    nvcc_s = _cuda.build()
    _cuda.library()
    log = _cuda.library_path()[:-3] + ".log"
    if os.path.exists(log):
        for name, usage in ptxas_lines(log):
            say(f"  ptxas {name}: {usage}")
    t1 = time.perf_counter()
    normalize_images(torch.zeros((1, 224, 224, 3), dtype=torch.uint8,
                                 device=dev))
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t1
    say(f"phase 2 build: nvcc {nvcc_s:.2f} s for {len(_cuda.CUDA_SOURCES)} "
        f"sources in parallel (0 = already built), triton {triton_s:.2f} s, "
        f"total {time.perf_counter() - t0:.2f} s")

    # ---- 3. kernels against their plain versions ---------------------------
    errs = {}
    with torch.inference_mode():
        px = torch.randint(0, 256, (EMBED_BATCH, 224, 224, 3), device=dev,
                           dtype=torch.uint8, generator=gen)
        ulps = bf16_ulps(normalize_images(px), normalize_images(px,
                                                                impl="torch"))
        check(ulps <= 1.0, f"normalize_images off by {ulps} bf16 ulp")
        errs["normalize_images"] = float(
            (normalize_images(px).float()
             - normalize_images(px, impl="torch").float()).abs().max())
        say(f"phase 3 K3 normalize_images [224,224,224,3] u8->bf16: max "
            f"{ulps} ulp, max|d| {errs['normalize_images']:.3e}")
    epi = dense_epilogue_phase(dev)
    errs["bias_act"] = 0.0            # every bit checked
    for line in epi["lines"]:
        say(line)
    for line in siglip_phase(dev, card, parent):
        say(line)
    ln = layer_norm_phase(dev, card)
    errs["layer_norm"] = ln["ulps"]   # bf16 ulp (ln_ulps)
    for line in ln["lines"]:
        say(line)
    with torch.inference_mode():
        errs["mha_short_seq"] = 0.0
        for b, t, w, h in ((EMBED_BATCH, 50, 768, 12), (32, 257, 1024, 16),
                           (LLAVA_B, 577, 1024, 16), (LLAVA_B, 65, 1024, 16),
                           (LLAVA_B, 1, 768, 12)):
            q, k, v = (torch.randn((b, t, w), device=dev, generator=gen)
                       .to(torch.bfloat16) for _ in range(3))
            q = q * (w // h) ** -0.5
            d = float((mha_short_seq(q, k, v, h).float()
                       - mha_short_seq(q, k, v, h, impl="torch").float())
                      .abs().max())
            check(d <= 2e-2, f"mha_short_seq [{b},{t},{w}]/{h}: max|d| {d}")
            errs["mha_short_seq"] = max(errs["mha_short_seq"], d)
            say(f"phase 3 K2 mha_short_seq [{b},{t},{w}]/{h} bf16: max|d| "
                f"{d:.3e}")
        # the f32 route (CUDA-core FMAs, never TF32): within 1e-5 of plain
        for b, t, w, h in ((2, 50, 768, 12), (2, 257, 1024, 16)):
            q, k, v = (torch.randn((b, t, w), device=dev, generator=gen)
                       for _ in range(3))
            q = q * (w // h) ** -0.5
            d = float((mha_short_seq(q, k, v, h)
                       - mha_short_seq(q, k, v, h, impl="torch")).abs().max())
            check(d <= 1e-5,
                  f"mha_short_seq f32 [{b},{t},{w}]/{h}: max|d| {d}")
            say(f"phase 3 K2 mha_short_seq [{b},{t},{w}]/{h} f32: max|d| "
                f"{d:.3e} (limit 1e-5)")

        g = torch.randn((GALLERY_ROWS, DIM), device=dev, generator=gen)
        g = (g / g.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        packed = {mode: quant(g.float())
                  for mode, (_, quant) in quant_topk.items()}
        errs["cosine_topk"] = 0.0
        # K4 / K5 must equal their plain versions exactly, or the run stops
        errs["cosine_topk_quantized"] = errs["cosine_topk_int4"] = 0.0
        for nq in (1, 8, 64):
            rows = torch.randint(0, GALLERY_ROWS, (nq,), device=dev,
                                 generator=gen)
            qv = g[rows].float() + 0.05 * torch.randn((nq, DIM), device=dev,
                                                      generator=gen)
            qv = qv / qv.norm(dim=1, keepdim=True)
            for k in (10, 100):
                vals, ids = cosine_topk(qv.to(torch.bfloat16), g, k)
                rv, ri = cosine_topk(qv.to(torch.bfloat16), g, k + 1,
                                     impl="torch")
                e = topk_agree(vals, ids, rv, ri)
                check(bool((ids[:, 0] == rows.int()).all()),
                      "top-1 is not the query's source row")
                errs["cosine_topk"] = max(errs["cosine_topk"], e)
                say(f"phase 3 K1 cosine_topk N={GALLERY_ROWS} D={DIM} Q={nq}"
                    f" k={k}: max|dv| {e:.3e}, ids agree")
                for mode, (fn, _) in quant_topk.items():
                    vals, ids = fn(qv, *packed[mode], k)
                    rv, ri = fn(qv, *packed[mode], k, impl="torch")
                    check(torch.equal(ids, ri) and torch.equal(vals, rv),
                          f"{fn.__name__} Q={nq} k={k}: kernel != plain "
                          f"(ids differ at {int((ids != ri).sum())}, max|dv|"
                          f" {float((vals - rv).abs().max())})")
                    check(bool((ids[:, 0] == rows.int()).all()),
                          f"{fn.__name__}: top-1 is not the source row")
                    say(f"phase 3 {'K4' if mode == 'int8' else 'K5'} "
                        f"{fn.__name__} {mode} N={GALLERY_ROWS} D={DIM} "
                        f"Q={nq} k={k}: ids and values equal to plain")
        # k past one 256-row chunk (sort merges of up to 8192 candidates,
        # C.1): K1 ids where separated, K4 / K5 ids and values equal
        for nq in (1, 8):
            rows = torch.randint(0, GALLERY_ROWS, (nq,), device=dev,
                                 generator=gen)
            qv = g[rows].float() + 0.05 * torch.randn((nq, DIM), device=dev,
                                                      generator=gen)
            qv = qv / qv.norm(dim=1, keepdim=True)
            for k in LARGE_K:
                vals, ids = cosine_topk(qv.to(torch.bfloat16), g, k)
                rv, ri = cosine_topk(qv.to(torch.bfloat16), g, k + 1,
                                     impl="torch")
                errs["cosine_topk"] = max(errs["cosine_topk"],
                                          topk_agree(vals, ids, rv, ri))
                check(vals.shape == (nq, k) and len(set(ids[0].tolist()))
                      == k, f"K1 k={k}: {tuple(vals.shape)}, repeated ids")
                for mode, (fn, _) in quant_topk.items():
                    vals, ids = fn(qv, *packed[mode], k)
                    rv, ri = fn(qv, *packed[mode], k, impl="torch")
                    check(torch.equal(ids, ri) and torch.equal(vals, rv),
                          f"{fn.__name__} Q={nq} k={k}: kernel != plain "
                          f"(ids differ at {int((ids != ri).sum())})")
            say(f"phase 3 K1/K4/K5 N={GALLERY_ROWS} D={DIM} Q={nq} k="
                f"{','.join(map(str, LARGE_K))}: K1 ids agree where "
                f"separated, K4/K5 ids and values equal to plain")
        # K1 / K5 at the edges of their spans: R = SPAN_MAX rows forced (the
        # wrappers pick it at N = 2^20), N = R - 1, R, R + 1 and 2R + 17
        # (a ragged last span): K5 equal to plain, K1 within 1e-5
        span = topk_mod.SPAN_MAX
        for n in (span - 1, span, span + 1, 2 * span + 17):
            rows = torch.randint(0, n, (8,), device=dev, generator=gen)
            qv = g[rows].float() + 0.05 * torch.randn((8, DIM), device=dev,
                                                      generator=gen)
            qv = qv / qv.norm(dim=1, keepdim=True)
            for k in (10, 32):
                vals, ids = topk_mod._cosine_topk_cuda(
                    qv.to(torch.bfloat16), g[:n], k, span)
                rv, ri = cosine_topk(qv.to(torch.bfloat16), g[:n], k + 1,
                                     impl="torch")
                errs["cosine_topk"] = max(errs["cosine_topk"],
                                          topk_agree(vals, ids, rv, ri,
                                                     tol=1e-5))
                p4, s4 = packed["int4"]
                vals, ids = _topk_int4_cuda(*prep_queries(qv), p4[:n], s4[:n],
                                            k, span)
                rv, ri = cosine_topk_int4(qv, p4[:n], s4[:n], k, impl="torch")
                check(torch.equal(ids, ri) and torch.equal(vals, rv),
                      f"K5 span {span} N={n} k={k}: kernel != plain (ids "
                      f"differ at {int((ids != ri).sum())})")
        say(f"phase 3 K1/K5 span edges (R={span} forced), N = "
            f"{span - 1}, {span}, {span + 1}, {2 * span + 17}, Q=8, k=10, 32: "
            f"K1 within 1e-5 and ids agree where separated, K5 ids and "
            f"values equal to plain")
        # K4 (the span scan on int8 rows) at the same edges, Q = 1, 8, 64
        # (its own generator: the later phases draw the same data)
        g4 = torch.Generator(device=dev).manual_seed(SEED + 10)
        p8, s8 = packed["int8"]
        for n in (span - 1, span, span + 1, 2 * span + 17):
            for nq in (1, 8, 64):
                rows = torch.randint(0, n, (nq,), device=dev, generator=g4)
                qv = g[rows].float() + 0.05 * torch.randn(
                    (nq, DIM), device=dev, generator=g4)
                qv = qv / qv.norm(dim=1, keepdim=True)
                for k in (10, 32):
                    vals, ids = _topk_quant_cuda(*quantize_rows(qv), p8[:n],
                                                 s8[:n], k, span)
                    rv, ri = cosine_topk_quantized(qv, p8[:n], s8[:n], k,
                                                   impl="torch")
                    check(torch.equal(ids, ri) and torch.equal(vals, rv),
                          f"K4 span {span} N={n} Q={nq} k={k}: kernel != "
                          f"plain (ids differ at {int((ids != ri).sum())})")
        say(f"phase 3 K4 span edges (R={span} forced), N = {span - 1}, "
            f"{span}, {span + 1}, {2 * span + 17}, Q=1, 8, 64, k=10, 32: ids "
            f"and values equal to plain")
        tie = torch.randn((1000, DIM), device=dev, generator=gen)
        tie[500] = tie[20]
        tie[900] = tie[20]
        tie = (tie / tie.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        vals, ids = cosine_topk(tie[20:21], tie, 5)
        rv, ri = cosine_topk(tie[20:21], tie, 5, impl="torch")
        check(ids[0, :3].tolist() == [20, 500, 900] and torch.equal(ids, ri),
              f"tie rule: kernel {ids.tolist()} plain {ri.tolist()}")
        say(f"phase 3 K1 tie case: ids {ids[0].tolist()} (lowest row first)")
        for mode, (fn, quant) in quant_topk.items():
            tp = quant(tie.float())
            vals, ids = fn(tie[20:21].float(), *tp, 5)
            rv, ri = fn(tie[20:21].float(), *tp, 5, impl="torch")
            check(ids[0, :3].tolist() == [20, 500, 900]
                  and torch.equal(ids, ri) and torch.equal(vals, rv),
                  f"{mode} tie rule: kernel {ids.tolist()} plain "
                  f"{ri.tolist()}")
            say(f"phase 3 {fn.__name__} tie case: ids {ids[0].tolist()}, "
                f"values {vals[0, :3].tolist()} (lowest row first)")

        towers8 = build_towers(Config(model=ModelConfig(
            image_tower="vit_b32", dtype="int8"), seed=SEED), device=dev)
        check(isinstance(towers8.params.visual.blocks[0].mlp.w1, QLinear),
              "dtype int8 did not quantize the vision tower")
        # K6 on the tower's int8 weights with seeded nonzero biases (the
        # random tower's are zero) and two rows of exact ties (max |x| = 127
        # makes the row scale 1.0, so x.5 codes test rounding half to even).
        # Kernel and plain run the same f32 operations in the same order, so
        # they must be equal: a kernel that drops a bias, rounds h to bf16
        # or rounds half away from zero differs in whole rows.
        mlp = towers8.params.visual.blocks[0].mlp
        x = torch.randn((EMBED_BATCH * 50, 768), device=dev, generator=gen)
        ties = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -3.5],
                            device=dev).repeat(768 // 8)
        x[0], x[1] = ties, -ties
        x = x.to(torch.bfloat16)
        b1, b2 = (0.3 * torch.randn(lin.bias.shape, device=dev, generator=gen)
                  for lin in (mlp.w1, mlp.w2))
        errs["mlp_int8_fused"] = 0.0
        for act in ("quick_gelu", "gelu"):
            args = (x, mlp.w1.q, mlp.w1.s, b1, mlp.w2.q, mlp.w2.s, b2)
            out = mlp_int8_fused(*args, act=act).float()
            ref = mlp_int8_fused(*args, act=act, impl="torch").float()
            d = float((out - ref).abs().max())
            check(torch.equal(out, ref),
                  f"mlp_int8_fused {act}: kernel != plain in "
                  f"{int((out != ref).sum())} elements, max|d| {d}")
            errs["mlp_int8_fused"] = max(errs["mlp_int8_fused"], d)
            say(f"phase 3 K6 mlp_int8_fused {act} [{x.shape[0]},768]->3072 "
                f"bf16, biases N(0, 0.3), tie rows: equal to plain in every "
                f"element")
        # K6 at the 336-px L/14 tower's MLP (W=1024, H=4096, --verifier-int8)
        mlp14 = MLP(1024, 4096, quick_gelu).to(dev)
        for lin in (mlp14.w1, mlp14.w2):
            torch.nn.init.normal_(lin.weight, std=0.02, generator=gen)
            torch.nn.init.normal_(lin.bias, std=0.3, generator=gen)
        quantize_tree(mlp14)
        x14 = torch.randn((LLAVA_B * 577, 1024), device=dev,
                          generator=gen).to(torch.bfloat16)
        x14[0], x14[1] = ties.repeat(1024 // 768 + 1)[:1024], \
            -ties.repeat(1024 // 768 + 1)[:1024]
        args14 = (x14, mlp14.w1.q, mlp14.w1.s, mlp14.w1.bias, mlp14.w2.q,
                  mlp14.w2.s, mlp14.w2.bias)
        out = mlp_int8_fused(*args14).float()
        ref = mlp_int8_fused(*args14, impl="torch").float()
        check(torch.equal(out, ref),
              f"mlp_int8_fused L/14: kernel != plain in "
              f"{int((out != ref).sum())} elements")
        say(f"phase 3 K6 mlp_int8_fused quick_gelu [{x14.shape[0]},1024]->"
            f"4096 bf16 (the 336-px L/14 MLP), biases N(0, 0.3), tie rows: "
            f"equal to plain in every element")
        # ragged M (the last 128-row GEMM tile part full, a lone row), f32 x
        # at B/32, and W/H = 512/2048
        mlp512 = MLP(512, 2048, quick_gelu).to(dev)
        for lin in (mlp512.w1, mlp512.w2):
            torch.nn.init.normal_(lin.weight, std=0.02, generator=gen)
            torch.nn.init.normal_(lin.bias, std=0.3, generator=gen)
        quantize_tree(mlp512)
        x512 = torch.randn((EMBED_BATCH * 50, 512), device=dev,
                           generator=gen).to(torch.bfloat16)
        x512[0], x512[1] = ties.repeat(512 // 768 + 1)[:512], \
            -ties.repeat(512 // 768 + 1)[:512]
        k6_cases = [(f"[{m},768] bf16 quick_gelu", x[:m], mlp.w1.q, mlp.w1.s,
                     b1, mlp.w2.q, mlp.w2.s, b2, "quick_gelu")
                    for m in (1, 17, 127, 129, EMBED_BATCH * 50 - 1)]
        k6_cases += [(f"[{x.shape[0]},768] f32 {act}", x.float(), mlp.w1.q,
                      mlp.w1.s, b1, mlp.w2.q, mlp.w2.s, b2, act)
                     for act in ("quick_gelu", "gelu")]
        k6_cases += [(f"[{x512.shape[0]},512]->2048 bf16 {act}", x512,
                      mlp512.w1.q, mlp512.w1.s, mlp512.w1.bias, mlp512.w2.q,
                      mlp512.w2.s, mlp512.w2.bias, act)
                     for act in ("quick_gelu", "gelu")]
        # H = 8192: f32 h rows of 32 KB, more than a block could keep in
        # shared memory for a useful row tile
        mlp8k = MLP(1024, 8192, quick_gelu).to(dev)
        for lin in (mlp8k.w1, mlp8k.w2):
            torch.nn.init.normal_(lin.weight, std=0.02, generator=gen)
            torch.nn.init.normal_(lin.bias, std=0.3, generator=gen)
        quantize_tree(mlp8k)
        x8k = torch.randn((577, 1024), device=dev, generator=gen)
        k6_cases += [("[577,1024]->8192 f32 gelu", x8k, mlp8k.w1.q,
                      mlp8k.w1.s, mlp8k.w1.bias, mlp8k.w2.q, mlp8k.w2.s,
                      mlp8k.w2.bias, "gelu")]
        for what, *args_c, act in k6_cases:
            out = mlp_int8_fused(*args_c, act=act)
            ref = mlp_int8_fused(*args_c, act=act, impl="torch")
            check(out.shape == ref.shape and torch.equal(out, ref),
                  f"mlp_int8_fused {what}: kernel != plain in "
                  f"{int((out != ref).sum())} elements")
        say(f"phase 3 K6 mlp_int8_fused ragged M (1, 17, 127, 129, "
            f"{EMBED_BATCH * 50 - 1}), f32 x at B/32 (both activations), "
            f"[{x512.shape[0]},512]->2048 (both activations), "
            f"[577,1024]->8192 f32: equal to plain in every element")
        del mlp512, x512, mlp8k, x8k, k6_cases
        del g, px, packed, x

        # K10 / K11 at the LLaVA-v1.5-7B and 1.1B-draft cache shapes
        kv_errs, kv_lines = kv_attention_checks(dev, gen)
        errs.update(kv_errs)
        for line in kv_lines:
            say(line)
        # the shapes once refused (C.3, C.4, K10 / K11 head dims, grids)
        fix_errs, fix_lines = repair_checks(dev)
        for name, e in fix_errs.items():
            errs[name] = max(errs.get(name, 0.0), e)
        for line in fix_lines:
            say(line)

        # K7 / K8: the IVF bucket probes over a clustered 1M x 512 gallery,
        # indexed at C = 1024 for every rung from one set of centroids
        t0 = time.perf_counter()
        ivf_gal, ivfs, ivf_build_s = clustered_ivfs(dev)

        def ivf_chunks():
            return (ivf_gal[a:a + IVF_CHUNK]
                    for a in range(0, GALLERY_ROWS, IVF_CHUNK))

        say(f"phase 3 IVF index {GALLERY_ROWS}x{DIM} C={IVF_CLUSTERS}: cap "
            + ", ".join(f"{IVF_RUNGS[m]} {v.bucket_cap} (spill "
                        f"{int((v.spill_ids >= 0).sum())})"
                        for m, v in ivfs.items())
            + f", {time.perf_counter() - t0:.1f} s")
        errs["probe_buckets"] = errs["probe_buckets_q4"] = 0.0
        for nq in (1, 8, 64):
            rows = torch.randint(0, GALLERY_ROWS, (nq,), device=dev,
                                 generator=gen)
            qv = ivf_gal[rows].float() + 0.02 * torch.randn(
                (nq, DIM), device=dev, generator=gen)
            qv = qv / qv.norm(dim=1, keepdim=True)
            for nprobe in (IVF_NPROBE, IVF_CLUSTERS):
                for mode, ivf in ivfs.items():
                    fn, args = probe_call(
                        ivf, qv, ivf_mod.probe_lists(qv, ivf, nprobe))
                    # the plain top-(k+1) begins with the plain top-k
                    rv, ri = fn(*args, 101, impl="torch")
                    for k in (10, 100):
                        vals, ids = fn(*args, k)
                        if mode == "int4":
                            check(torch.equal(ids, ri[:, :k])
                                  and torch.equal(vals, rv[:, :k]),
                                  f"K8 Q={nq} nprobe={nprobe} k={k}: kernel "
                                  f"!= plain (ids differ at "
                                  f"{int((ids != ri[:, :k]).sum())})")
                        else:
                            errs["probe_buckets"] = max(
                                errs["probe_buckets"],
                                topk_agree(vals, ids, rv, ri, tol=1e-5))
                say(f"phase 3 K7 probe_buckets (bf16, int8) / K8 "
                    f"probe_buckets_q4 C={IVF_CLUSTERS} Q={nq} "
                    f"nprobe={nprobe} k=10,100: K7 max|dv| "
                    f"{errs['probe_buckets']:.3e}, ids agree where "
                    f"separated; K8 ids and values equal to plain")
        # k past one chunk through the probes' merges (C.1), Q=8
        rows = torch.randint(0, GALLERY_ROWS, (8,), device=dev,
                             generator=gen)
        qv = ivf_gal[rows].float() + 0.02 * torch.randn(
            (8, DIM), device=dev, generator=gen)
        qv = qv / qv.norm(dim=1, keepdim=True)
        for mode, ivf in ivfs.items():
            fn, args = probe_call(ivf, qv, ivf_mod.probe_lists(qv, ivf,
                                                               IVF_NPROBE))
            rv, ri = fn(*args, LARGE_K[-1] + 1, impl="torch")
            for k in LARGE_K:
                vals, ids = fn(*args, k)
                if mode == "int4":
                    check(torch.equal(ids, ri[:, :k])
                          and torch.equal(vals, rv[:, :k]),
                          f"K8 k={k}: kernel != plain (ids differ at "
                          f"{int((ids != ri[:, :k]).sum())})")
                else:
                    errs["probe_buckets"] = max(
                        errs["probe_buckets"],
                        topk_agree(vals, ids, rv, ri, tol=1e-5))
        say(f"phase 3 K7/K8 C={IVF_CLUSTERS} Q=8 nprobe={IVF_NPROBE} k="
            f"{','.join(map(str, LARGE_K))}: K7 ids agree where separated "
            f"(max|dv| {errs['probe_buckets']:.3e}), K8 ids and values equal")
        # K8 (bucket-major on s8 tensor cores) at Q = 1, 8, 9 (a ragged
        # query tile), 64 and k = 1, 10, 33, 300, nprobe 128: ids and values
        # equal to plain (its own generator: the later phases draw the same
        # data as before)
        g8 = torch.Generator(device=dev).manual_seed(SEED + 11)
        for nq in (1, 8, 9, 64):
            rows = torch.randint(0, GALLERY_ROWS, (nq,), device=dev,
                                 generator=g8)
            q8 = ivf_gal[rows].float() + 0.02 * torch.randn(
                (nq, DIM), device=dev, generator=g8)
            q8 = q8 / q8.norm(dim=1, keepdim=True)
            fn, args = probe_call(ivfs["int4"], q8, ivf_mod.probe_lists(
                q8, ivfs["int4"], IVF_NPROBE))
            rv, ri = fn(*args, 301, impl="torch")
            for k in (1, 10, 33, 300):
                vals, ids = fn(*args, k)
                check(torch.equal(ids, ri[:, :k])
                      and torch.equal(vals, rv[:, :k]),
                      f"K8 Q={nq} k={k}: kernel != plain (ids differ at "
                      f"{int((ids != ri[:, :k]).sum())})")
        say(f"phase 3 K8 C={IVF_CLUSTERS} nprobe={IVF_NPROBE} Q=1,8,9,64 "
            f"k=1,10,33,300: ids and values equal to plain")
        # K7 and K8 are bucket-major: 8 queries on one probe list (each
        # bucket read once for all of them), on 8 disjoint lists (no bucket
        # shared), on lists naming one bucket twice, and on lists with
        # out-of-range cluster ids (scored as empty slots, never read)
        npr = min(IVF_NPROBE, IVF_CLUSTERS // 8)
        perm = torch.randperm(IVF_CLUSTERS, device=dev,
                              generator=torch.Generator(
                                  device=dev).manual_seed(SEED + 8))
        base = ivf_mod.probe_lists(qv, ivfs[""], npr)
        bad = torch.zeros_like(base, dtype=torch.bool)
        bad[:, 1::5] = True
        k7_lists = {
            "shared": base[:1].repeat(8, 1),
            "disjoint": perm[:8 * npr].view(8, npr).int(),
            "repeats": torch.cat([base[:, :5], base[:, 2:3], base[:, 5:]], 1),
            "out_of_range": torch.where(bad, torch.where(
                torch.arange(npr, device=dev) % 2 == 0, IVF_CLUSTERS + 5,
                -3).int(), base)}
        for mode in IVF_RUNGS:
            for kind, lists in k7_lists.items():
                for k in (10, 100):
                    (vals, ids), (rv, ri) = probe_pair(ivfs[mode], qv, lists,
                                                       k)
                    if mode == "int4":
                        check(torch.equal(ids, ri[:, :k])
                              and torch.equal(vals, rv[:, :k]),
                              f"K8 {kind} lists k={k}: kernel != plain")
                    else:
                        errs["probe_buckets"] = max(
                            errs["probe_buckets"],
                            topk_agree(vals, ids, rv, ri, tol=1e-5))
        say(f"phase 3 K7/K8 Q=8 nprobe={npr}(+1) k=10,100, all queries on one "
            f"list, on 8 disjoint lists, a bucket twice in a list, out-of-"
            f"range ids: K7 ids agree where separated (max|dv| "
            f"{errs['probe_buckets']:.3e}), K8 ids and values equal")
        # equal scores: rows IVF_DUPS share row 77's bucket and come back
        # in slot order, after an earlier-probed bucket
        for mode, ivf in ivfs.items():
            home = int((ivf.bucket_ids == IVF_DUPS[0]).nonzero()[0, 0])
            in_home = [r for r in IVF_DUPS
                       if bool((ivf.bucket_ids[home] == r).any())]
            check(len(in_home) >= 2, f"{mode}: duplicated rows spilled")
            probe = torch.tensor([[(home + 1) % IVF_CLUSTERS, home]],
                                 dtype=torch.int32, device=dev)
            fn, args = probe_call(ivf, ivf_gal[IVF_DUPS[0]:IVF_DUPS[0] + 1],
                                  probe)
            vals, ids = fn(*args, 8)
            rv, ri = fn(*args, 9, impl="torch")
            check(ids[0, :len(in_home)].tolist() == in_home
                  and ri[0, :len(in_home)].tolist() == in_home,
                  f"{mode} probe tie rule: kernel {ids.tolist()} plain "
                  f"{ri.tolist()}")
            if mode == "int4":
                check(torch.equal(ids, ri[:, :8])
                      and torch.equal(vals, rv[:, :8]), "K8 tie case")
            else:
                topk_agree(vals, ids, rv, ri, tol=1e-5)
            say(f"phase 3 {fn.__name__} {IVF_RUNGS[mode]} tie case: ids "
                f"{ids[0].tolist()} (equal rows in slot order)")

        # K9: all-pairs first match at the dedup bench's size, planted pairs
        # at 0.995 / 0.985 around tau 0.99; every id equal to plain
        t0 = time.perf_counter()
        dedup_x, dedup_first = planted_dedup_rows(dev, SEED)
        want_first = torch.from_numpy(dedup_first).to(dev, torch.int32)
        half = DEDUP_ROWS // 2

        def k9_equal(a, b, what, **kw):
            got = first_match(a, b, DEDUP_TAU, **kw)
            ref = first_match(a, b, DEDUP_TAU, impl="torch", **kw)
            check(torch.equal(got, ref),
                  f"K9 {what}: kernel != plain at {int((got != ref).sum())} "
                  f"rows")
            return got

        k9_report = []
        for dtype in (torch.float32, torch.bfloat16):
            x = dedup_x.to(dtype)
            name = "f32" if dtype == torch.float32 else "bf16"
            whole = k9_equal(x, x, f"{name} intra", intra=True)
            check(torch.equal(whole, want_first),
                  f"K9 {name} intra != the planted pairs at "
                  f"{int((whole != want_first).sum())} rows")
            ragged = k9_equal(x[:-1], x[:-1], f"{name} ragged", intra=True)
            check(torch.equal(ragged, whole[:-1]), f"K9 {name} N-1 rows")
            h1 = k9_equal(x[half:], x[:half], f"{name} ring block",
                          intra=True, row_offset=half)
            h2 = k9_equal(x[half:], x[half:], f"{name} ring diagonal",
                          intra=True, row_offset=half, col_offset=half)
            ring = torch.where(h1 >= 0, h1,
                               torch.where(h2 >= 0, h2 + half, -1))
            check(torch.equal(ring, whole[half:]),
                  f"K9 {name}: the ring's halves != the whole set")
            k9_report.append(f"{name} intra {int((whole >= 0).sum())} rows "
                             f"matched = planted, N-1 ragged, ring halves "
                             f"at row_offset {half} = whole")
        # no pair lies within 1e-3 of tau: tau +- 1e-3 give the same answer
        for tau in (DEDUP_TAU - 1e-3, DEDUP_TAU + 1e-3):
            check(torch.equal(first_match(dedup_x, dedup_x, tau, intra=True),
                              want_first), f"K9 at tau {tau} differs")
        # cross set: DEDUP_ROWS train rows against DEDUP_TEST_ROWS test rows
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        test_rows = torch.randn((DEDUP_TEST_ROWS, DIM), device=dev,
                                generator=g)
        test_rows /= test_rows.norm(dim=1, keepdim=True)
        train = dedup_x.clone()
        pick = torch.randperm(DEDUP_ROWS, device=dev, generator=g)[:768]
        leak_to = torch.randperm(DEDUP_TEST_ROWS, device=dev,
                                 generator=g)[:768]
        train[pick[:512]] = near_rows(test_rows[leak_to[:512]], 0.995, g)
        train[pick[512:]] = near_rows(test_rows[leak_to[512:]], 0.985, g)
        # one train row leaks to two test rows: its first match is the lower
        twin = int(leak_to[512 + 255])        # a near-miss target, now reused
        test_rows[twin] = near_rows(train[pick[0]:pick[0] + 1], 0.995, g)[0]
        want_cross = torch.full((DEDUP_ROWS,), -1, dtype=torch.int32,
                                device=dev)
        want_cross[pick[:512]] = leak_to[:512].int()
        want_cross[pick[0]] = min(int(leak_to[0]), twin)
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            got = k9_equal(train.to(dtype), test_rows.to(dtype),
                           f"{name} cross set")
            check(torch.equal(got, want_cross),
                  f"K9 {name} cross set != the planted leaks at "
                  f"{int((got != want_cross).sum())} rows")
        # f32 rows holding f16 values, as the dedup command's f16 index gives
        # them (their lo planes are zero), and rows of mixed magnitudes
        x16 = dedup_x.half().float()
        got = k9_equal(x16, x16, "f32 on f16 values intra", intra=True)
        check(torch.equal(got, want_first),
              f"K9 f32 on f16 values != the planted pairs at "
              f"{int((got != want_first).sum())} rows")
        mixed, want_mixed = mixed_magnitude_rows(dev, SEED + 2,
                                                 DEDUP_TEST_ROWS)
        got = k9_equal(mixed, mixed, "f32 mixed magnitudes intra", intra=True)
        check(torch.equal(got, want_mixed),
              f"K9 f32 mixed magnitudes != the planted copies at "
              f"{int((got != want_mixed).sum())} rows")
        k9_report.append(f"f32 on f16 values = planted; f32 "
                         f"{DEDUP_TEST_ROWS}x{DIM} with entries down to 1e-6 "
                         f"of the rest: {int((got >= 0).sum())} copies = "
                         f"planted")
        # copies 2e-6 either side of tau: the f32 route must decide each row
        # as an f64 dot of the f32 rows does; bf16 rows (the hi.hi product
        # alone) must not, or this check could not catch a lost plane
        near = near_tau_rows(dev, SEED + 3, DEDUP_TEST_ROWS,
                             (NEAR_TAU, -NEAR_TAU))
        near_a = near[:DEDUP_TEST_ROWS // 2]
        near_bad = []
        for what, a, intra in (("intra", near, True), ("cross", near_a, False)):
            want_near, clear = first_match_f64(a, near, intra, NEAR_TAU / 4)
            check(bool(clear.all()), f"K9 near tau {what}: "
                  f"{int((~clear).sum())} rows within {NEAR_TAU / 4} of tau")
            for route in ("cuda", "torch"):
                got = first_match(a, near, DEDUP_TAU, intra=intra, impl=route)
                off = got != want_near
                check(not bool(off.any()),
                      f"K9 f32 near tau {what} ({route}) != the f64 decision "
                      f"at {int(off.sum())} rows: "
                      f"{int((off & (want_near >= 0)).sum())} with a copy "
                      f"above tau, {int((off & (want_near < 0)).sum())} "
                      f"without")
            nb, ab = near.bfloat16(), a.bfloat16()
            near_bad.append(int((first_match(ab, nb, DEDUP_TAU, intra=intra)
                                 != want_near).sum()))
        check(min(near_bad) > 0, "K9 near tau: bf16 rows decided every row "
              "as f64 does, so the check cannot tell a lost plane")
        k9_report.append(f"f32 with {DEDUP_TEST_ROWS // 8} copies at tau +- "
                         f"{NEAR_TAU:g} = the f64 decision, intra and cross "
                         f"(bf16 rows on the same data: {near_bad[0]} / "
                         f"{near_bad[1]} rows differ)")
        del x16, mixed, want_mixed, near, near_a
        del train, test_rows
        errs["first_match"] = 0.0       # ids: equal in every element
        say(f"phase 3 K9 first_match {DEDUP_ROWS}x{DIM} tau {DEDUP_TAU} "
            f"({DEDUP_PLANTS} copies at 0.995, {DEDUP_PLANTS // 4} near "
            f"misses at 0.985, {DEDUP_PLANTS // 4} chains): "
            + "; ".join(k9_report) + f"; cross {DEDUP_ROWS} x "
            f"{DEDUP_TEST_ROWS}: 512 leaks found (one to two test rows, "
            f"lowest taken), 256 near misses not; tau +- 1e-3 same answer; "
            f"every id equal to plain, {time.perf_counter() - t0:.1f} s")

    # ---- 4a. end to end: bf16 ---------------------------------------------
    cfg = Config(model=ModelConfig(image_tower="vit_b32", dtype="bfloat16"),
                 seed=SEED)
    towers = build_towers(cfg, device=dev)
    model = towers.params
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    samples = [(f"synthetic/c{i % SMOKE_CLASSES}/{i:05d}",
                f"c{i % SMOKE_CLASSES}") for i in range(SMOKE_IMAGES)]
    ds = SyntheticImages(samples)
    picks = list(range(0, SMOKE_IMAGES, SMOKE_IMAGES // 8))
    qpx = np.stack([ds.image(*samples[i]) for i in picks])
    tmp = tempfile.TemporaryDirectory()
    epi_before, ln_before = bias_act.launches, layer_norm.launches
    idx = launched(
        (normalize_images, mha_short_seq, bias_act),
        lambda: build_index(ds, towers.image_encode,
                            os.path.join(tmp.name, "idx"),
                            batch_size=cfg.gallery.batch_size),
        "build_index")
    check(len(idx) == SMOKE_IMAGES and idx.dim == DIM,
          f"index has {len(idx)} rows of dim {idx.dim}")
    # one epilogue launch a dense: six a block and the patch embedding
    epi_batches = -(-SMOKE_IMAGES // cfg.gallery.batch_size)
    epi_per_batch = 6 * model.visual.cfg.layers + 1
    check(bias_act.launches - epi_before == epi_batches * epi_per_batch,
          f"build_index: {bias_act.launches - epi_before} bias_act launches"
          f" in {epi_batches} batches, want {epi_per_batch} a batch")
    # one E2 launch a norm: ln_pre, two a block, ln_post (the CLS rows)
    ln_per_batch = 2 * model.visual.cfg.layers + 2
    check(layer_norm.launches - ln_before == epi_batches * ln_per_batch,
          f"build_index: {layer_norm.launches - ln_before} layer_norm "
          f"launches in {epi_batches} batches, want {ln_per_batch} a batch")
    check(bool(np.isfinite(idx.embeddings).all()), "non-finite rows")
    engine = SearchEngine(idx, SearchConfig(), device=dev)

    qvec = launched((normalize_images, mha_short_seq),
                    lambda: towers.image_encode(qpx), "image_encode")
    hits = launched((cosine_topk,),
                    lambda: engine.query_image(qvec, top_k=10),
                    "query_image")
    for i, h in zip(picks, hits):
        check(len(h) == 10 and samples[i][0] in [x.path for x in h[:3]],
              f"image query {i}: own path not in the top 3")
    self_top1 = sum(h[0].path == samples[i][0] for i, h in zip(picks, hits))
    shots = idx.embeddings[[i for i in range(40) if i % 8 == 0]]
    proto_hits = launched(
        (cosine_topk,), lambda: engine.query_prototype(shots, top_k=10),
        "query_prototype")[0]
    same = sum(h.cls == "c0" for h in proto_hits)
    check(same >= PROTO_MIN, f"prototype c0 precision@10 {same}/10")

    ids = np.random.default_rng(SEED).integers(1, 49406, (4, 77))
    lengths = [5, 9, 12, 20]
    tokens = np.zeros((4, 77), np.int64)
    for r, n in enumerate(lengths):
        tokens[r, 0] = 49406
        tokens[r, 1:n + 1] = ids[r, :n]
        tokens[r, n + 1] = 49407      # EOT: the max id
    tvec = clip.encode_text(model, torch.from_numpy(tokens).to(dev))
    check(bool(torch.isfinite(tvec).all()), "non-finite text embeds")
    text_hits = launched((cosine_topk,),
                         lambda: engine.query_text(tvec, top_k=10),
                         "query_text")
    check(all(len(h) == 10 and np.isfinite([x.score for x in h]).all()
              for h in text_hits), "text query hits")

    def sweep_equals_host(eng, what):
        labels = np.asarray([c == "c0" for c in eng.index.classes])
        proto = torch.from_numpy(np.asarray(
            eng.index.embeddings[np.flatnonzero(labels)[:10]])).mean(0)
        res = eng.sweep_class(proto, labels)
        host = calibrate.sweep(
            eng.device_similarities(proto[None])[0].cpu().numpy()
            * eng.config.logit_scale, labels)
        check(0.0 <= res.best_f1 <= 1.0 and np.isfinite(res.best_threshold),
              f"{what} sweep_class result")
        check(abs(res.best_threshold - host.best_threshold) <= 1e-3
              and abs(res.best_f1 - host.best_f1) <= 1e-9,
              f"{what} device sweep {res.best_threshold}/{res.best_f1} vs "
              f"host {host.best_threshold}/{host.best_f1}")
        return res

    def hits_equal_plain(eng, fn, hits, q, what):
        """A quantized engine's hits equal fn's plain version on the same
        gallery and queries (q as query_vectors receives them): the same
        rows in the same order with the same scores."""
        with torch.inference_mode():
            rv, ri = fn(l2_normalize(q), eng.gallery, eng.gallery_scales,
                        len(hits[0]), impl="torch")
        rv, scale = rv.cpu().numpy(), eng.config.logit_scale
        want = [[(eng.index.paths[r], float(rv[i, j] * scale))
                 for j, r in enumerate(row)]
                for i, row in enumerate(ri.tolist())]
        check([[(x.path, x.score) for x in h] for h in hits] == want,
              f"{what}: engine hits != the plain top-k")

    res = sweep_equals_host(engine, "bf16")
    say(f"phase 4a e2e ViT-B/32 bf16: index {len(idx)}x{idx.dim}, image "
        f"self-top1 {self_top1}/8, prototype c0 precision@10 {same}/10, text "
        f"hits ok, calibrate c0 thr {res.best_threshold:.4f} f1 "
        f"{res.best_f1:.4f} (= host sweep), "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    emb = np.empty((GALLERY_ROWS, DIM), np.float16)
    for a in range(0, GALLERY_ROWS, 131072):
        x = rng.standard_normal((min(131072, GALLERY_ROWS - a), DIM),
                                dtype=np.float32)
        emb[a:a + len(x)] = x / np.linalg.norm(x, axis=1, keepdims=True)
    big = GalleryIndex(emb, [f"row/{i}" for i in range(GALLERY_ROWS)],
                       ["c"] * GALLERY_ROWS)
    big_engine = SearchEngine(big, SearchConfig(), device=dev)
    src = np.arange(8) * (GALLERY_ROWS // 9) + 17
    qbig = emb[src].astype(np.float32) + 0.05 * rng.standard_normal(
        (8, DIM), dtype=np.float32)
    big_hits = launched((cosine_topk,),
                        lambda: big_engine.query_vectors(qbig, top_k=10),
                        "1M query_vectors")
    check(all(h[0].path == f"row/{s}" for s, h in zip(src, big_hits)),
          "1M query: top-1 is not the source row")
    say(f"phase 4a e2e 1M x 512 gallery (f16 host -> bf16 device), Q=8: "
        f"top-1 = source row for 8/8, {time.perf_counter() - t0:.1f} s")
    # read before anything else launches a kernel
    launches_bf16 = {fn.__name__: fn.launches for fn in kernels}

    # ---- 4b. end to end: int8 tower, int8 / int4 galleries ----------------
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    idx8 = launched(
        (normalize_images, mha_short_seq, mlp_int8_fused),
        lambda: build_index(ds, towers8.image_encode,
                            os.path.join(tmp.name, "idx8"),
                            batch_size=cfg.gallery.batch_size),
        "int8 build_index")
    check(len(idx8) == SMOKE_IMAGES and idx8.dim == DIM
          and bool(np.isfinite(idx8.embeddings).all()), "int8 index rows")
    e8 = np.asarray(idx8.embeddings, np.float32)
    e16 = np.asarray(idx.embeddings, np.float32)
    tower_cos = float((e8 * e16).sum(1).min())
    qvec8 = launched((normalize_images, mha_short_seq, mlp_int8_fused),
                     lambda: towers8.image_encode(qpx), "int8 image_encode")
    quant_report = []
    row_of = {p: r for r, p in enumerate(idx8.paths)}
    for mode, (fn, _) in quant_topk.items():
        eng = SearchEngine(idx8, SearchConfig(), quantize=mode, device=dev)
        hits = launched((fn,), lambda: eng.query_image(qvec8, top_k=10),
                        f"{mode} query_image")
        hits_equal_plain(eng, fn, hits, torch.from_numpy(qvec8).to(dev),
                         f"{mode} query_image")
        # random towers map every image near one direction (nearest other
        # image at cosine ~0.998): int8's score error stays below that gap,
        # int4's (rms ~0.006) does not. Every query's hits must be the best
        # rows up to the mode's error bound (mmrs_tpu's: 0.02 int8, 0.04
        # int4); int8 must also find the query image in its top 3
        bound = QUANT_SCORE_ERR[mode]
        ranks = []
        for i, qv8, h in zip(picks, qvec8, hits):
            check(len(h) == 10, f"{mode} image query {i}: {len(h)} hits")
            exact = e8[[row_of[x.path] for x in h]] @ qv8
            err = float(np.abs(np.asarray([x.score for x in h])
                               / eng.config.logit_scale - exact).max())
            check(err <= bound and exact[0] >= float(e8[i] @ qv8) - bound,
                  f"{mode} image query {i}: hit scores off the exact "
                  f"cosines by {err}, top-1 exact {exact[0]}")
            paths = [x.path for x in h]
            ranks.append(paths.index(samples[i][0]) if samples[i][0] in paths
                         else ">9")
            check(mode != "int8" or samples[i][0] in paths[:3],
                  f"int8 image query {i}: own path not in the top 3")
        top1 = sum(r == 0 for r in ranks)
        shots8 = idx8.embeddings[[i for i in range(40) if i % 8 == 0]]
        proto_hits = launched(
            (fn,), lambda: eng.query_prototype(shots8, top_k=10),
            f"{mode} query_prototype")
        proto = build_prototype(torch.from_numpy(np.asarray(shots8)).to(dev),
                                strategy=eng.config.prototype)
        hits_equal_plain(eng, fn, proto_hits, proto[None, :],
                         f"{mode} query_prototype")
        prec = sum(h.cls == "c0" for h in proto_hits[0])
        check(prec >= PROTO_MIN,
              f"{mode} prototype c0 precision@10 {prec}/10")
        res8 = sweep_equals_host(eng, mode)
        quant_report.append(
            f"{mode} gallery: image and prototype hits = plain top-10, image "
            f"self-rank {ranks} (top-1 {top1}/8; hit scores within {bound} "
            f"of exact), prototype c0 "
            f"precision@10 {prec}/10, calibrate c0 thr "
            f"{res8.best_threshold:.4f} f1 {res8.best_f1:.4f} (= host sweep)")
    say(f"phase 4b e2e ViT-B/32 int8 tower: index {len(idx8)}x{idx8.dim}, "
        f"embed cosine to the bf16 tower min {tower_cos:.6f}; "
        + "; ".join(quant_report) + f"; {time.perf_counter() - t0:.1f} s")
    check(tower_cos >= 0.99,
          f"int8 tower embed cosine to bf16 {tower_cos} < 0.99")

    t0 = time.perf_counter()
    big_quant = {}
    for mode, (fn, _) in quant_topk.items():
        eng = SearchEngine(big, SearchConfig(), quantize=mode, device=dev)
        hits = launched((fn,), lambda: eng.query_vectors(qbig, top_k=10),
                        f"1M {mode} query_vectors")
        check(all(h[0].path == f"row/{s}" for s, h in zip(src, hits)),
              f"1M {mode} query: top-1 is not the source row")
        big_quant[mode] = eng
    say(f"phase 4b e2e 1M x 512 gallery behind int8 ("
        f"{big_quant['int8'].gallery.nbytes / 2 ** 20:.0f} MiB) and int4 ("
        f"{big_quant['int4'].gallery.nbytes / 2 ** 20:.0f} MiB) engines, "
        f"Q=8: top-1 = source row for 8/8 each, "
        f"{time.perf_counter() - t0:.1f} s")
    launches_quant = {fn.__name__: fn.launches for fn in kernels}

    # ---- 4c. end to end: IVF ------------------------------------------------
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    row_of = {p: r for r, p in enumerate(idx.paths)}

    def ivf_hits_equal_plain(eng, hits, q, what):
        """An IVF engine's hits against the plain IVF top-k on the same
        index and queries (q as query_vectors receives them): int4 the same
        rows, order and scores; bf16 / int8 (f32 sums in another order)
        scores within 1e-5 and rows equal where scores are separated."""
        k, scale = len(hits[0]), eng.config.logit_scale
        check(all(len(h) == k for h in hits), f"{what}: short hit lists")
        with torch.inference_mode():
            rv, ri = ivf_mod.ivf_topk(l2_normalize(q.float()), eng.ivf,
                                      k=k + 1, nprobe=eng.config.ann_nprobe,
                                      impl="torch")
        if eng.ivf.quant == "int4":
            rvn = rv.cpu().numpy()
            want = [[(eng.index.paths[r], float(rvn[i, j] * scale))
                     for j, r in enumerate(row[:k])]
                    for i, row in enumerate(ri.tolist())]
            check([[(x.path, x.score) for x in h] for h in hits] == want,
                  f"{what}: engine hits != the plain IVF top-k")
            return
        vals = torch.tensor([[x.score / scale for x in h] for h in hits],
                            device=dev)
        ids = torch.tensor([[row_of[x.path] for x in h] for h in hits],
                           dtype=torch.int32, device=dev)
        topk_agree(vals, ids, rv, ri, tol=1e-5)

    def refuse(*args, **kwargs):
        raise RuntimeError("the saved sidecar was not used")

    sidecar = os.path.join(idx.directory, "ivf")
    shots_t = torch.from_numpy(np.asarray(shots)).to(dev)
    ivf_report = []
    for mode in IVF_RUNGS:
        fn = probe_buckets_q4 if mode == "int4" else probe_buckets
        eng = SearchEngine(idx, SearchConfig(ann="ivf"), quantize=mode,
                           device=dev)
        check(eng.ivf.quant == mode and eng.gallery is None
              and ivf_mod.sidecar_meta(sidecar)["quant"] == mode,
              f"{IVF_RUNGS[mode]} IVF engine / sidecar")
        hits = launched((fn,), lambda: eng.query_image(qvec, top_k=10),
                        f"IVF {mode} query_image")
        ivf_hits_equal_plain(eng, hits, torch.from_numpy(qvec).to(dev),
                             f"IVF {mode} query_image")
        self1 = sum(h[0].path == samples[i][0] for i, h in zip(picks, hits))
        precs = []
        for strategy in ("mean", "cluster", "robust_mean"):
            ph = launched((fn,), lambda: eng.query_prototype(
                shots, strategy=strategy, top_k=10),
                f"IVF {mode} {strategy} query_prototype")
            c = eng.config
            proto = build_prototype(shots_t, strategy=strategy,
                                    cluster_k=c.cluster_k,
                                    balance_ratio=c.cluster_balance_ratio,
                                    outlier_percentile=c.outlier_percentile)
            ivf_hits_equal_plain(eng, ph, proto[None, :],
                                 f"IVF {mode} {strategy} query_prototype")
            precs.append(sum(h.cls == "c0" for h in ph[0]))
        # a second engine loads the saved sidecar: no k-means, same hits
        train = ivf_mod.train_centroids
        ivf_mod.train_centroids = refuse
        try:
            eng2 = SearchEngine(idx, SearchConfig(ann="ivf"), quantize=mode,
                                device=dev)
        finally:
            ivf_mod.train_centroids = train
        hits2 = eng2.query_image(qvec, top_k=10)
        check([[(x.path, x.score) for x in h] for h in hits2]
              == [[(x.path, x.score) for x in h] for h in hits],
              f"IVF {mode}: the loaded sidecar serves other hits")
        ivf_report.append(
            f"{IVF_RUNGS[mode]} (C={eng.ivf.n_clusters} cap "
            f"{eng.ivf.bucket_cap} nprobe {eng.config.ann_nprobe or 'auto'}):"
            f" image and prototype hits = plain IVF top-10, image self-top1 "
            f"{self1}/8, prototype c0 precision@10 mean/cluster/robust_mean "
            f"{precs}, sidecar load = build")
    eng_t = SearchEngine(idx, SearchConfig(ann="ivf", ann_target_recall=0.95),
                         device=dev)
    tuned = ivf_mod.sidecar_meta(sidecar)["tuned"]
    check(tuned["nprobe"] == eng_t.config.ann_nprobe
          and (tuned["recall"] >= 0.95
               or tuned["nprobe"] == eng_t.ivf.n_clusters),
          f"ann_target_recall: {tuned}")
    say(f"phase 4c e2e IVF over the ViT-B/32 index {len(idx)}x{idx.dim}: "
        + "; ".join(ivf_report) + f"; ann_target_recall 0.95 -> nprobe "
        f"{tuned['nprobe']} (recall {tuned['recall']:.4f}, curve "
        f"{tuned['curve']}), {time.perf_counter() - t0:.1f} s")

    # k = 300, past one 256-row scan chunk (C.1), through every engine
    # route: query_vectors against the plain top-k, and `mmrs-torch search
    # -k 300` on the index directory (the CLI's own towers and engine)
    t0 = time.perf_counter()
    from PIL import Image

    qpath = os.path.join(tmp.name, "query300.png")
    Image.fromarray(qpx[0]).save(qpath)
    n_c = eng_t.ivf.n_clusters
    routes = (("bf16", cosine_topk, {}, [], {}),
              ("int8", cosine_topk_quantized, {"quantize": "int8"},
               ["--gallery-quant", "int8"], {}),
              ("int4", cosine_topk_int4, {"quantize": "int4"},
               ["--gallery-quant", "int4"], {}),
              ("ivf", probe_buckets, {}, ["--ann-nprobe", str(n_c)],
               {"ann": "ivf", "ann_nprobe": n_c}))
    for name, fn, kw, flags, ckw in routes:
        eng = SearchEngine(idx, SearchConfig(**ckw), device=dev, **kw)
        q300 = torch.from_numpy(qvec[:2]).to(dev)
        hits = launched((fn,), lambda: eng.query_vectors(q300, top_k=300),
                        f"{name} query_vectors k=300")
        check(all(len(h) == 300 and len({x.path for x in h}) == 300
                  for h in hits), f"{name} k=300: not 300 distinct hits")
        if name == "ivf":
            ivf_hits_equal_plain(eng, hits, q300, "IVF k=300")
        elif name == "bf16":
            with torch.inference_mode():
                rv, ri = cosine_topk(l2_normalize(q300).to(torch.bfloat16),
                                     eng.gallery, 301, impl="torch")
            scale = eng.config.logit_scale
            topk_agree(torch.tensor([[x.score / scale for x in h]
                                     for h in hits], device=dev),
                       torch.tensor([[row_of[x.path] for x in h]
                                     for h in hits], dtype=torch.int32,
                                    device=dev), rv, ri, tol=1e-5)
        else:
            hits_equal_plain(eng, fn, hits, q300, f"{name} k=300")
        code, lines = run_cli(["search", "--index", idx.directory,
                               "--image", qpath, "-k", "300", *flags])
        ranks = [int(ln.split("\t")[1]) for ln in lines
                 if ln.startswith("0\t")]
        check(code == 0 and ranks == list(range(300)),
              f"mmrs-torch search -k 300 {' '.join(flags)}: exit {code}, "
              f"{len(ranks)} hits")
    say(f"phase 4c C.1 k=300 on the card: query_vectors through flat bf16, "
        f"int8, int4 and ann=ivf (nprobe {n_c}) engines = the plain top-300;"
        f" mmrs-torch search -k 300 prints 300 hits on each route, "
        f"{time.perf_counter() - t0:.1f} s")

    # the clustered 1M gallery: nprobe = C is the flat scan; recall at 128
    t0 = time.perf_counter()
    with torch.inference_mode():
        flat16 = torch.cat([l2_normalize(c.float()).to(torch.bfloat16)
                            for c in ivf_chunks()])
        flat4 = [quantize_rows_int4(l2_normalize(c.float()))
                 for c in ivf_chunks()]
        flat4 = (torch.cat([p for p, _ in flat4]),
                 torch.cat([s for _, s in flat4]))
        rows = torch.randint(0, GALLERY_ROWS, (64,), device=dev,
                             generator=gen)
        qc = ivf_gal[rows].float() + 0.02 * torch.randn((64, DIM), device=dev,
                                                        generator=gen)
        qc = qc / qc.norm(dim=1, keepdim=True)
        ev, ei = cosine_topk(qc.to(torch.bfloat16), flat16, 11)
        recall = {}
        for mode, ivf in ivfs.items():
            fn = probe_buckets_q4 if mode == "int4" else probe_buckets
            vals, ids = launched((fn,), lambda: ivf_mod.ivf_topk(
                qc, ivf, k=10, nprobe=IVF_CLUSTERS), f"1M IVF {mode} nprobe=C")
            if mode == "":
                topk_agree(vals, ids, ev, ei, tol=1e-5)
            elif mode == "int4":
                fv, fi = cosine_topk_int4(qc, *flat4, 10)
                check(torch.equal(ids, fi) and torch.equal(vals, fv),
                      f"1M IVF int4 at nprobe=C != flat K5 (ids differ at "
                      f"{int((ids != fi).sum())})")
            full = recall_at(ids, ei[:, :10])
            _, ids = launched((fn,), lambda: ivf_mod.ivf_topk(
                qc, ivf, k=10, nprobe=IVF_NPROBE), f"1M IVF {mode}")
            recall[IVF_RUNGS[mode]] = (recall_at(ids, ei[:, :10]), full)
        side = os.path.join(tmp.name, "ivf1m")
        ivf_mod.save_ivf(side, ivfs[""])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loaded = ivf_mod.load_ivf(side, make_chunks=ivf_chunks,
                                  n=GALLERY_ROWS, d=DIM, chunk=IVF_CHUNK,
                                  device=dev)
        torch.cuda.synchronize()
        ivf_load_s = time.perf_counter() - t1
        check(torch.equal(loaded.buckets, ivfs[""].buckets)
              and torch.equal(loaded.bucket_ids, ivfs[""].bucket_ids)
              and torch.equal(loaded.spill, ivfs[""].spill),
              "1M sidecar load != build")
        del loaded
    say(f"phase 4c e2e clustered 1M x 512, C={IVF_CLUSTERS}, Q=64: nprobe=C "
        f"ids = flat K1 where separated (bf16), = flat K5 exactly (int4); "
        f"recall@10 vs the exact bf16 scan at nprobe={IVF_NPROBE} (and at "
        f"C): {json.dumps(recall)}; sidecar save + load = build "
        f"({ivf_load_s:.2f} s load), {time.perf_counter() - t0:.1f} s")
    launches_ivf = {fn.__name__: fn.launches for fn in kernels}

    # ---- 4d. end to end: governance ------------------------------------------
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    # (i) the planted rows as an on-disk index (f16 rows, two shards), then
    # `mmrs-torch dedup --mode embedding` as a user runs it
    dedup_dir = os.path.join(tmp.name, "dedup_index")
    os.makedirs(dedup_dir)
    dedup_paths = [f"dedup/{i:06d}.jpg" for i in range(DEDUP_ROWS)]
    rows16 = dedup_x.to(torch.float16).cpu().numpy()
    shards = [gallery_mod._write_shard(
        dedup_dir, s, rows16[a:a + 65536],
        [(p, "c") for p in dedup_paths[a:a + 65536]])
        for s, a in enumerate(range(0, DEDUP_ROWS, 65536))]
    gallery_mod._write_manifest(dedup_dir, shards, DIM)
    del rows16
    t1 = time.perf_counter()
    code, lines = launched((first_match,), lambda: run_cli(
        ["dedup", "--mode", "embedding", "--index", dedup_dir, "--tau",
         str(DEDUP_TAU)]), "dedup --mode embedding")
    cli_s = time.perf_counter() - t1
    planted = keeper_pairs(dedup_first, dedup_paths)
    check(code == 0 and dup_lines(lines) == planted
          and lines[0].startswith(f"{len(planted)} duplicates, 0 errors"),
          f"dedup --mode embedding: exit {code}, {len(dup_lines(lines))} DUP "
          f"lines, {len(planted)} planted")
    idx_d = GalleryIndex.load(dedup_dir)
    plain_rep = embedding_dedup(np.asarray(idx_d.embeddings, np.float32),
                                idx_d.paths, tau=DEDUP_TAU, impl="torch")
    check(plain_rep.duplicates == planted, "plain embedding_dedup report")
    say(f"phase 4d e2e governance (i): mmrs-torch dedup --mode embedding "
        f"over a {DEDUP_ROWS}x{DIM} f16 index: exit 0, {lines[0]!r}, DUP "
        f"lines = the planted pairs (chains to their first keeper) = the "
        f"plain report, {cli_s:.2f} s for the command")

    # (ii) phase 4a's ViT-B/32 index with exact copies of 64 of its images
    # appended (`index update`), deduplicated at a tau between the largest
    # distinct-image cosine and the smallest copy cosine (random towers put
    # distinct images within ~0.002 of each other)
    sources = list(range(0, SMOKE_IMAGES, SMOKE_IMAGES // DEDUP_COPIES))
    copies = [(f"synthetic/{samples[s][1]}/{SMOKE_IMAGES + i:05d}",
               samples[s][1]) for i, s in enumerate(sources)]
    for (name, _), s in zip(copies, sources):
        ds.cache[name] = ds.image(*samples[s])
    ds_copies = dataclasses.replace(ds, samples=samples + copies)
    idx2 = update_index(ds_copies, towers.image_encode, idx.directory,
                        batch_size=cfg.gallery.batch_size)
    check(len(idx2) == SMOKE_IMAGES + DEDUP_COPIES, "index update rows")
    with torch.inference_mode():
        e2 = torch.tensor(np.asarray(idx2.embeddings, np.float32), device=dev)
        sims = e2 @ e2.T
        copy_rows = torch.arange(SMOKE_IMAGES, len(idx2), device=dev)
        src_rows = torch.tensor(sources, device=dev)
        copy_min = float(sims[copy_rows, src_rows].min())
        sims[copy_rows, src_rows] = -2.0
        sims[src_rows, copy_rows] = -2.0
        sims.fill_diagonal_(-2.0)
        distinct_max = float(sims.max())
        del sims, e2
    check(copy_min > distinct_max,
          f"copies (min cosine {copy_min}) not above distinct images (max "
          f"{distinct_max})")
    tau2 = float(np.float32((copy_min + distinct_max) / 2))
    code, lines = launched((first_match,), lambda: run_cli(
        ["dedup", "--mode", "embedding", "--index", idx.directory, "--tau",
         repr(tau2)]), "dedup over the ViT-B/32 index")
    want = [(idx2.paths[SMOKE_IMAGES + i], idx2.paths[s])
            for i, s in enumerate(sources)]
    plain_rep = embedding_dedup(np.asarray(idx2.embeddings, np.float32),
                                idx2.paths, tau=tau2, impl="torch")
    check(code == 0 and dup_lines(lines) == plain_rep.duplicates == want,
          f"dedup over the ViT-B/32 index: {len(dup_lines(lines))} DUP lines,"
          f" plain {len(plain_rep.duplicates)}, {DEDUP_COPIES} copies")
    say(f"phase 4d e2e governance (ii): 4a's index + {DEDUP_COPIES} exact "
        f"image copies (index update, {len(idx2)} rows): copy cosines >= "
        f"{copy_min:.7f}, distinct images <= {distinct_max:.7f}, tau "
        f"{tau2:.7f} (midway): {lines[0]!r}, every copy -> its source, = "
        f"the plain report")

    # (iii) the host-side governance commands, dry runs, on a small tree
    gov = os.path.join(tmp.name, "gov")
    governance_tree(gov)
    g_ = lambda *p: os.path.join(gov, *p)  # noqa: E731
    expect = {
        ("dedup", "--mode", "exact", "--reference", g_("ref"), "--target",
         g_("tgt")): ["1 duplicates, 0 errors, 0 removed (dry_run=True)",
                      f"DUP\t{g_('tgt', 'a_copy.png')}\t-> keeper "
                      f"{g_('ref', 'a.png')}"],
        ("dedup", "--mode", "perceptual", "--target", g_("tgt")):
            f"DUP\t{g_('tgt', 'small.jpg')}\t-> keeper "
            f"{g_('tgt', 'big.jpg')}",
        ("leakage", "--train", g_("train"), "--test", g_("test")):
            ["1 duplicates, 0 errors, 0 removed (dry_run=True)",
             f"LEAK\t{g_('train', 'leaked.png')}\t(matches test "
             f"{g_('test', 't1.png')})"],
        ("convert", "--root", g_("mixed")):
            ["2 converted, 0 errors (dry_run=True)"],
        ("clean", "--root", g_("mixed")): ["2 deleted (dry_run=True)"],
        ("rename", "--root", g_("classes")): ["5 renamed (dry_run=True)"],
        ("merge", "--root", g_("classes"), "--map", "kitty=cat"):
            ["2 moved (dry_run=True)"],
    }
    for variant, n in (("v1", 13), ("v2", 26), ("v3", 13 + 6 + 6),
                       ("v5", 6 + 3 + 4)):
        out = g_(f"{variant}.json")
        expect[("dataset", "make", "--variant", variant, "--root", g_("vqa"),
                "--out", out)] = [json.dumps({"records": n, "out": out})]
    expect[("dataset", "make", "--variant", "v4", "--root", g_("vqa"),
            "--out", g_("v4"))] = [json.dumps(
                {"positives": 9, "with_cross": 12, "with_simple": 15,
                 "with_hard": 15})]
    for argv, want_lines in expect.items():
        code, lines = run_cli(list(argv))
        ok = (want_lines in lines if isinstance(want_lines, str)
              else lines == want_lines)
        check(code == 0 and ok, f"mmrs-torch {' '.join(argv[:3])}: exit "
              f"{code}, {lines}")
    lib = gov_native.load_library()
    say(f"phase 4d e2e governance (iii): dedup exact / perceptual, leakage, "
        f"convert, clean, rename, merge, dataset make v1-v5 (dry runs) on a "
        f"small image tree: the expected lines; hashing scans ran on "
        + (f"the native library {os.path.basename(lib._name)} (g++)" if lib
           else "the numpy fallback (no g++)")
        + f"; {time.perf_counter() - t0:.1f} s for 4d")
    launches_gov = {fn.__name__: fn.launches for fn in kernels}
    tmp.cleanup()

    # ---- 4e. end to end: the LLaVA cascade verifier -------------------------
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    llava_ctx = llava_phase(dev, tmp.name, kernels, run_cli)
    for line in llava_ctx["report"]:
        say(f"phase 4e {line}")
    say(f"phase 4e: {time.perf_counter() - t0:.1f} s")

    # ---- 4j. end to end: the model axis of the mesh (4e's weights) -----------
    t0 = time.perf_counter()
    tp_ctx = tp_phase(dev, kernels, llava_ctx, llava_ctx["paths"],
                      llava_ctx["tok"])
    ck = llava_ctx["tp_ckpt"]
    tp_ctx["report"].append(
        f"(5) in 4e step (4): mmrs-torch cascade ... --verifier-int8 --tp 2: "
        f"{ck['cli']}; load_npz(placement=llava_checkpoint_placement) on "
        f"{ck['mesh']}: {ck['pieces']} pieces bit-equal to "
        f"shard_llava_params of the one-device load; host peak RSS above "
        f"the start: placed {ck['rss_placed']:.3f} GiB in "
        f"{ck['placed_s']:.1f} s, whole tree {ck['rss_plain']:.3f} GiB in "
        f"{ck['plain_s']:.1f} s")
    for line in tp_ctx["report"]:
        say(f"phase 4j {line}")
    tt = tp_ctx["times"]
    wall, dev_ms, _ = tp_ctx["profile_tp2"]
    say(f"phase 4j times on {card}: ms a decode step (past the prefill, "
        f"host clock) / a pack of {VERIFY_BATCH} (32 new tokens; T=1 is "
        f"4e's: its e2e step and a run_streaming pack; T>1 a greedy trace "
        f"and a verify_batch pack), bf16: "
        + ", ".join(f"T={t} {tt[f'tp{t}'][0]:.2f} / {tt[f'tp{t}'][1]:.1f}"
                    for t in (1,) + TP_WIDTHS)
        + f"; TP=2 generate busy {dev_ms:.1f} of "
        f"{wall:.1f} ms ({dev_ms / wall:.3f}); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    say(f"phase 4j: {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in tp_ctx["s"].items())
        + f"; the placed-load checks ran in 4e: "
        f"{ck['cli_s'] + ck['placed_s'] + ck['plain_s']:.1f} s; budget "
        f"120 s)")
    tmp.cleanup()

    # ---- 4f. end to end: the bilingual (EN + CN) union path ------------------
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    bi_ctx = bilingual_phase(dev, tmp.name, kernels, run_cli)
    for line in bi_ctx["report"]:
        say(f"phase {line}")
    say(f"phase 4f: {time.perf_counter() - t0:.1f} s (setup "
        f"{bi_ctx['s']['setup']:.1f} s)")
    tmp.cleanup()

    # ---- 4g. end to end: adaptation and serving ------------------------------
    tmp = tempfile.TemporaryDirectory()
    import shutil

    free = shutil.disk_usage(tmp.name).free
    check(free > 3 * 2 ** 30, f"4g: {free / 2 ** 30:.1f} GiB free under "
          f"{tmp.name}, the streaming scan writes 1 GiB")
    t0 = time.perf_counter()
    ag_ctx = adapt_serve_phase(dev, tmp.name, kernels, run_cli, idx)
    for line in ag_ctx["report"]:
        say(f"phase {line}")
    say(f"phase 4g: {time.perf_counter() - t0:.1f} s")
    tmp.cleanup()

    # ---- 4h. end to end: the operations layer, the int4-weight LLaMA ---------
    tmp = tempfile.TemporaryDirectory()
    free = shutil.disk_usage(tmp.name).free
    check(free > 3 * 2 ** 30, f"4h: {free / 2 ** 30:.1f} GiB free under "
          f"{tmp.name}, the phase writes ~1 GiB of weights")
    t0 = time.perf_counter()
    ops_ctx = ops_phase(dev, tmp.name, kernels, run_cli, big_engine,
                        big_quant, ivfs)
    for line in ops_ctx["report"]:
        say(f"phase {line}")
    say(f"phase 4h: {time.perf_counter() - t0:.1f} s (setup "
        f"{ops_ctx['s']['setup'] + ops_ctx['s']['pack']:.1f} s; budget 90 s)")
    tmp.cleanup()

    # ---- 4i. end to end: the data axis of the mesh ---------------------------
    tmp = tempfile.TemporaryDirectory()
    free = shutil.disk_usage(tmp.name).free
    check(free > 3 * 2 ** 30, f"4i: {free / 2 ** 30:.1f} GiB free under "
          f"{tmp.name}, the streaming scan writes 1 GiB")
    t0 = time.perf_counter()
    mesh_ctx = mesh_phase(dev, tmp.name, kernels, dict(
        towers=towers, towers8=towers8, ds=ds, samples=samples, idx=idx,
        engine=engine, qvec=qvec, big=big, qbig=qbig, big_engine=big_engine,
        big_quant=big_quant, ivf_gal=ivf_gal, ivfs=ivfs, dedup_x=dedup_x))
    for line in mesh_ctx["report"]:
        say(f"phase {line}")
    say(f"phase 4i: {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in mesh_ctx["s"].items())
        + "; predicted 45-100 s)")
    tmp.cleanup()

    # ---- 5. launch counts --------------------------------------------------
    say(f"phase 5 launches during phase 4a (bf16): "
        f"{json.dumps(launches_bf16)}")
    say(f"phase 5 launches during phase 4b (quantized): "
        f"{json.dumps(launches_quant)}")
    for fn in (cosine_topk, mha_short_seq, normalize_images):
        check(launches_bf16[fn.__name__] > 0,
              f"{fn.__name__} never launched in phase 4a")
    for fn in (mha_short_seq, normalize_images, cosine_topk_quantized,
               cosine_topk_int4, mlp_int8_fused):
        check(launches_quant[fn.__name__] > 0,
              f"{fn.__name__} never launched in phase 4b")
    say(f"phase 5 launches during phase 4c (IVF): {json.dumps(launches_ivf)}")
    for fn in (probe_buckets, probe_buckets_q4):
        check(launches_ivf[fn.__name__] > 0,
              f"{fn.__name__} never launched in phase 4c")
    launches = {name: launches_bf16[name] for name in
                ("cosine_topk", "mha_short_seq", "normalize_images",
                 "bias_act", "layer_norm")}
    launches.update({name: launches_quant[name] for name in
                     ("cosine_topk_quantized", "cosine_topk_int4",
                      "mlp_int8_fused")})
    launches.update({name: launches_ivf[name] for name in
                     ("probe_buckets", "probe_buckets_q4")})
    say(f"phase 5 launches during phase 4d (governance): "
        f"{json.dumps(launches_gov)}")
    check(launches_gov["first_match"] > 0,
          "first_match never launched in phase 4d")
    launches["first_match"] = launches_gov["first_match"]
    for run, counts in llava_ctx["launches"].items():
        say(f"phase 5 launches during phase 4e ({run}): "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
    say(f"phase 5 launches during phase 4f (bilingual): "
        f"{json.dumps({k: v for k, v in bi_ctx['launches'].items() if v})}")
    for run, counts in ag_ctx["launches"].items():
        say(f"phase 5 launches during phase 4g ({run}): "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
    for run, counts in ops_ctx["launches"].items():
        say(f"phase 5 launches during phase 4h ({run}): "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
    for run, counts in mesh_ctx["launches"].items():
        say(f"phase 5 launches during phase 4i ({run}): "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
    for fn in kernels[:9]:
        check(any(c[fn.__name__] for c in mesh_ctx["launches"].values()),
              f"{fn.__name__} never launched in phase 4i")
    for run, counts in tp_ctx["launches"].items():
        say(f"phase 5 launches during phase 4j ({run}): "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
    for name in ("mha_short_seq", "normalize_images", "mlp_int8_fused",
                 "chunk_attention", "decode_attention"):
        check(any(c[name] for c in tp_ctx["launches"].values()),
              f"{name} never launched in phase 4j")
    # the verifier's main path is run (1), bf16 (phase 4e checked that
    # K2, K10 and K11 launched in every run and K6 in the int8 runs)
    launches["chunk_attention"] = llava_ctx["launches"]["bf16"][
        "chunk_attention"]
    launches["decode_attention"] = llava_ctx["launches"]["bf16"][
        "decode_attention"]

    # phase 4's answers against the plain versions on the same inputs
    with torch.inference_mode():
        for vec in (qvec, tvec):
            q = l2_normalize(torch.as_tensor(vec, device=dev).float())
            vals, kid = cosine_topk(q.to(torch.bfloat16), engine.gallery, 10)
            rv, ri = cosine_topk(q.to(torch.bfloat16), engine.gallery, 11,
                                 impl="torch")
            topk_agree(vals, kid, rv, ri)
            for mode, (fn, _) in quant_topk.items():
                eng = big_quant[mode]
                vals, kid = fn(q, eng.gallery, eng.gallery_scales, 10)
                rv, ri = fn(q, eng.gallery, eng.gallery_scales, 10,
                            impl="torch")
                check(torch.equal(kid, ri) and torch.equal(vals, rv),
                      f"1M {mode} engine top-10 != plain")
        ref = clip.encode_image(
            model, normalize_images(torch.from_numpy(qpx).to(dev),
                                    impl="torch"), impl="torch")
        cos = float((torch.from_numpy(qvec).to(dev) * ref).sum(1).min())
        check(cos >= 0.999, f"kernel-path embed cosine to plain {cos}")
        ref8 = clip.encode_image(
            towers8.params, normalize_images(torch.from_numpy(qpx).to(dev),
                                             impl="torch"), impl="torch")
        cos8 = float((torch.from_numpy(qvec8).to(dev) * ref8).sum(1).min())
        check(cos8 >= 0.999, f"int8 kernel-path embed cosine to plain {cos8}")
    say(f"phase 5 checks: engine top-10 = plain top-10 (image, text "
        f"queries; bf16 ids where separated, int8/int4 exactly); image "
        f"embed cosine to plain path: bf16 >= {cos:.6f}, int8 >= {cos8:.6f}")

    # ---- 6. times ----------------------------------------------------------
    times = {}
    with torch.inference_mode():
        px = torch.randint(0, 256, (EMBED_BATCH, 224, 224, 3), device=dev,
                           dtype=torch.uint8, generator=gen)
        times["normalize_images"] = time_pair(
            lambda: normalize_images(px),
            lambda: normalize_images(px, impl="torch"), iters=20)
        q, k, v = (torch.randn((EMBED_BATCH, 50, 768), device=dev,
                               generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        times["mha_short_seq"] = time_pair(
            lambda: mha_short_seq(q, k, v, 12),
            lambda: mha_short_seq(q, k, v, 12, impl="torch"), iters=20)
        qb = big_engine.gallery[torch.arange(8, device=dev) * 997]
        times["cosine_topk"] = time_pair(
            lambda: cosine_topk(qb, big_engine.gallery, 10),
            lambda: cosine_topk(qb, big_engine.gallery, 10, impl="torch"))
        # k = 300: the scan keeps whole chunks, two merge passes (C.1)
        top300 = time_pair(
            lambda: cosine_topk(qb, big_engine.gallery, 300),
            lambda: cosine_topk(qb, big_engine.gallery, 300, impl="torch"))
        for mode, (fn, _) in quant_topk.items():
            eng = big_quant[mode]
            times[fn.__name__] = time_pair(
                lambda: fn(qb.float(), eng.gallery, eng.gallery_scales, 10),
                lambda: fn(qb.float(), eng.gallery, eng.gallery_scales, 10,
                           impl="torch"))
        # the flat scans over FLAT_SEED's gallery and the bucket probes over
        # the clustered one, this tree's between two runs of --parent's
        # (each in a process of its own)
        par = [parent_times(parent)] if parent else []
        flat = flat_scan_times(dev)
        probe = probe_scan_times(dev, ivf_gal, ivfs, plain=True)
        if parent:
            par.append(parent_times(parent))
        flat_parent = [p["flat"] for p in par]
        probe_parent = [p["probe"] for p in par]
        mlp = towers8.params.visual.blocks[0].mlp
        x = torch.randn((EMBED_BATCH * 50, 768), device=dev,
                        generator=gen).to(torch.bfloat16)
        args = (x, mlp.w1.q, mlp.w1.s, mlp.w1.bias, mlp.w2.q, mlp.w2.s,
                mlp.w2.bias)
        times["mlp_int8_fused"] = time_pair(
            lambda: mlp_int8_fused(*args),
            lambda: mlp_int8_fused(*args, impl="torch"), iters=20)
        # the yardstick beside K6 (not its "Library" column: no one call
        # computes K6's function): its two products through torch._int_mm
        int_mm_ms = {"b32": int_mm_pair(x.shape[0], mlp.w1.q, mlp.w2.q, gen)}
        k6_split = {"b32": k6_launch_ms(args)}
        embed = {}
        for name, tw in (("bf16", towers), ("int8", towers8)):
            embed[name] = time_pair(
                lambda: tw.encode_fn(px),
                lambda: clip.encode_image(
                    tw.params, normalize_images(px, impl="torch"),
                    impl="torch"), iters=5, warmup=2)
        # the bucket probes K7 / K8 at Q=8, nprobe=128, k=10 (timed above,
        # with --parent's): on the card alone, beside plain's eager ms; then
        # IVF top-10 end to end (centroid scores, probe, spill, merge)
        # beside flat K1
        times["probe_buckets"] = (probe["bf16"]["graph_ms"][0],
                                  probe["bf16"]["plain_ms"])
        times["probe_buckets_q4"] = (probe["int4"]["graph_ms"][0],
                                     probe["int4"]["plain_ms"])
        # K9 at the dedup bench's shape, both input types; the plain
        # version scores the full square in ~1 GiB row blocks
        k9_ms = {}
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            xk = dedup_x.to(dtype)
            k9_ms[name] = time_pair(
                lambda: first_match(xk, xk, DEDUP_TAU, intra=True),
                lambda: first_match(xk, xk, DEDUP_TAU, intra=True,
                                    impl="torch"), iters=2, warmup=1)
        times["first_match"] = k9_ms["f32"]
        # the yardstick for K2: PyTorch's fused attention on the same
        # [B, H, T, hd] inputs (scale 1: q is pre-scaled); the port never
        # calls it
        qh, kh, vh = (t.view(EMBED_BATCH, 50, 12, 64).transpose(1, 2)
                      .contiguous() for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = {"mha_short_seq": time_ms(
            lambda: sdpa(qh, kh, vh, scale=1.0), iters=20)}
        # K2 and K6 at the 336-px L/14 tower's shapes (the verifier's)
        q, k, v = (torch.randn((LLAVA_B, 577, 1024), device=dev,
                               generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        l14 = {"mha_short_seq": time_pair(
            lambda: mha_short_seq(q, k, v, 16),
            lambda: mha_short_seq(q, k, v, 16, impl="torch"), iters=20)}
        qh, kh, vh = (t.view(LLAVA_B, 577, 16, 64).transpose(1, 2)
                      .contiguous() for t in (q, k, v))
        l14_lib = time_ms(lambda: sdpa(qh, kh, vh, scale=1.0), iters=20)
        mlp_l = llava_ctx["model"].visual.blocks[0].mlp     # int8 by now
        x = torch.randn((LLAVA_B * 577, 1024), device=dev,
                        generator=gen).to(torch.bfloat16)
        args = (x, mlp_l.w1.q, mlp_l.w1.s, mlp_l.w1.bias, mlp_l.w2.q,
                mlp_l.w2.s, mlp_l.w2.bias)
        l14["mlp_int8_fused"] = time_pair(
            lambda: mlp_int8_fused(*args),
            lambda: mlp_int8_fused(*args, impl="torch"), iters=20)
        int_mm_ms["l14"] = int_mm_pair(x.shape[0], mlp_l.w1.q, mlp_l.w2.q, gen)
        k6_split["l14"] = k6_launch_ms(args)
        # the bilingual path's shapes: the ViT-L/14 embed and the Taiyi
        # text encode on phase 4f's converted weights; K2 at the 224-px
        # L/14 tower's [B, 257, 1024] / 16 and at f32 [8, 577, 1024] / 16;
        # K1 over a 768-d gallery
        cn_t = bi_ctx["cn_towers"]
        pxl = torch.randint(0, 256, (UNION_BATCH, 224, 224, 3), device=dev,
                            dtype=torch.uint8, generator=gen)
        bi = {"l14_embed": time_pair(
            lambda: cn_t.encode_fn(pxl),
            lambda: clip.encode_image(
                cn_t.params, normalize_images(pxl, impl="torch"),
                impl="torch"), iters=5, warmup=2)}
        ids = torch.randint(5, len(CN_VOCAB), (TAIYI_BATCH, 16), device=dev,
                            generator=gen)
        bi["taiyi_ms"] = time_ms(lambda: clip.taiyi_encode_text(
            cn_t.params, ids, torch.ones_like(ids)), iters=10)
        for key, (b, t, dtype) in (("k2_257", (UNION_BATCH, 257,
                                               torch.bfloat16)),
                                   ("k2_f32", (LLAVA_B, 577, torch.float32))):
            q, k, v = (torch.randn((b, t, 1024), device=dev, generator=gen)
                       .to(dtype) for _ in range(3))
            bi[key] = time_pair(lambda: mha_short_seq(q, k, v, 16),
                                lambda: mha_short_seq(q, k, v, 16,
                                                      impl="torch"), iters=10)
            qh, kh, vh = (x.view(b, t, 16, 64).transpose(1, 2).contiguous()
                          for x in (q, k, v))
            bi[key + "_sdpa"] = time_ms(lambda: sdpa(qh, kh, vh, scale=1.0),
                                        iters=10)
            size = 2 if dtype == torch.bfloat16 else 4
            bi[key + "_bound"] = least_ms(
                4 * b * t * 1024 * size, 4 * b * 16 * t * t * 64,
                "bf16" if size == 2 else "f32")
        g768 = torch.randn((GALLERY_ROWS, 768), device=dev, generator=gen)
        g768 = (g768 / g768.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        q768 = g768[torch.arange(8, device=dev) * 997]
        bi["k1_768"] = {
            "graph_ms": graph_ms(lambda: cosine_topk(q768, g768, 10)),
            "eager_ms": time_ms(lambda: cosine_topk(q768, g768, 10)),
            "plain_ms": time_ms(lambda: cosine_topk(q768, g768, 10,
                                                    impl="torch"), iters=3),
            "matmul_topk_ms": time_ms(lambda: torch.topk(
                q768.float() @ g768.float().T, 10), iters=3),
            "bound": least_ms(GALLERY_ROWS * 768 * 2 + 8 * 768 * 2 + 8 * 80,
                              2 * 8 * GALLERY_ROWS * 768, "bf16")}
        del g768
        kv_times, (kv_spreads, kv_eager), kv_cache_len, \
            (kv_start, kv_c, kv_lim) = kv_attention_times(
                dev, gen, llava_ctx["prompt_len"])
        for name in ("chunk_attention", "decode_attention"):
            times[name] = kv_times[(name, "bf16")][:2]
            library_ms[name] = kv_times[(name, "bf16")][3]
        ivf_ms = {}
        for nq in (1, 8):
            for mode, ivf in ivfs.items():
                ivf_ms[(IVF_RUNGS[mode], nq)] = time_pair(
                    lambda: ivf_mod.ivf_topk(qc[:nq], ivf, k=10,
                                             nprobe=IVF_NPROBE),
                    lambda: cosine_topk(qc[:nq].to(torch.bfloat16), flat16,
                                        10))
        # the planner's constants (plan.py): the bf16 bucket probe K7 alone
        # at Q=1, nprobe = IVF_NPROBE, on the card alone
        fn1, args1 = probe_call(ivfs[""], qc[:1], ivf_mod.probe_lists(
            qc[:1], ivfs[""], IVF_NPROBE))
        probe_q1 = graph_ms(lambda: fn1(*args1, 10))
        planner = planner_fit(
            {q: flat[f"{q} Q=1 k=10"]["eager_ms"] for q in IVF_RUNGS.values()},
            {q: ivf_ms[(q, 1)][0] for q in IVF_RUNGS.values()},
            probe_q1[0], ivfs)
    for line in epilogue_time_lines(epi, card):
        say(line)
    times["bias_act"] = epi["times"]["L/14 w1 [65792,4096] quick_gelu"]
    ln_l14 = ln["times"]["L/14 [65792,1024]"]
    times["layer_norm"] = (ln_l14["ms"], ln_l14["plain_ms"])
    library_ms["layer_norm"] = ln_l14["library_ms"]
    say(f"phase 6 times on {card}:")
    for name, (kms, pms) in times.items():
        say(f"  {name}: kernel {kms:.4f} ms, plain {pms:.4f} ms")
    for name, (kms, pms) in embed.items():
        say(f"  ViT-B/32 {name} embed batch {EMBED_BATCH}: kernels "
            f"{EMBED_BATCH / kms * 1e3:.1f} img/s ({kms:.3f} ms), plain "
            f"{EMBED_BATCH / pms * 1e3:.1f} img/s ({pms:.3f} ms)")
    say(f"  top-10 over {GALLERY_ROWS}x{DIM} at Q=8: bf16 kernel "
        f"{times['cosine_topk'][0]:.4f} ms, int8 kernel "
        f"{times['cosine_topk_quantized'][0]:.4f} ms, int4 kernel "
        f"{times['cosine_topk_int4'][0]:.4f} ms")
    flat_names = {"bf16": "cosine_topk", "int8": "cosine_topk_quantized",
                  "int4": "cosine_topk_int4"}
    flat_rows = {"bf16": DIM * 2, "int8": DIM + 4, "int4": DIM // 2 + 4}
    flat_extra = {}
    say(f"  flat scans over {GALLERY_ROWS}x{DIM} (seed {FLAT_SEED}): on the "
        f"card alone = a CUDA graph of 20 calls (mean, min / median / max "
        f"a call), eager = CUDA events around 20 calls; parent = --parent's "
        f"kernels in the same call, before / after this tree's"
        + ("" if parent else " (not given)"))
    for kind, name in flat_names.items():
        for nq, k in FLAT_SHAPES:
            key = f"{kind} Q={nq} k={k}"
            r = flat[key]
            bms, by = flat_bound(nq, k, flat_rows[kind],
                                 "bf16" if kind == "bf16" else "int8")
            par = [p[key] for p in flat_parent]
            flat_extra.setdefault(name, {})[f"Q={nq} k={k}"] = {
                "graph_ms": r["graph_ms"][0], "graph_spread_ms":
                r["graph_ms"][1:], "eager_ms": r["eager_ms"],
                "bound_ms": bms,
                "parent_graph_ms": [p["graph_ms"][0] for p in par],
                "parent_eager_ms": [p["eager_ms"] for p in par],
                "split_ms": r["split"]}
            say(f"  {key} ({name}): on the card alone {r['graph_ms'][0]:.4f}"
                " ms ({:.4f} / {:.4f} / {:.4f}), eager {:.4f} ms, bound "
                "{:.4f} ms ({}) = {:.2f}x".format(
                    *r["graph_ms"][1:], r["eager_ms"], bms, by,
                    r["graph_ms"][0] / bms)
                + "".join(f"; parent alone {p['graph_ms'][0]:.4f}, eager "
                          f"{p['eager_ms']:.4f}" for p in par)
                + "; by kernel (torch.profiler, 10 calls): " + "; ".join(
                    f"{n} {ms:.4f} ms a launch x{c}" for n, ms, c in r["split"]))
            for i, p in enumerate(par):
                say(f"    parent ({'before' if i == 0 else 'after'}) by "
                    "kernel: " + "; ".join(
                        f"{n} {ms:.4f} ms a launch x{c}"
                        for n, ms, c in p["split"]))
    for rung, r in probe.items():
        bms, by = r["bound"]
        say(f"  IVF bucket probe {rung} ({'K8' if rung == 'int4' else 'K7'})"
            f" Q=8 nprobe={IVF_NPROBE} k=10, clustered 1M x 512 C="
            f"{IVF_CLUSTERS}: on the card alone {r['graph_ms'][0]:.4f} ms "
            "({:.4f} / {:.4f} / {:.4f}), eager {:.4f} ms, plain {:.4f} ms, "
            "bound {:.4f} ms ({}) = {:.2f}x".format(
                *r["graph_ms"][1:], r["eager_ms"], r["plain_ms"], bms, by,
                r["graph_ms"][0] / bms)
            + "".join(f"; parent alone {p[rung]['graph_ms'][0]:.4f}, eager "
                      f"{p[rung]['eager_ms']:.4f}" for p in probe_parent)
            + "; by kernel (torch.profiler, 10 calls): " + "; ".join(
                f"{k} {ms:.4f} ms a launch x{n}" for k, ms, n in r["split"]))
        for i, p in enumerate(probe_parent):
            say(f"    parent ({'before' if i == 0 else 'after'}) by kernel: "
                + "; ".join(f"{k} {ms:.4f} ms a launch x{n}"
                            for k, ms, n in p[rung]["split"]))
    for (rung, nq), (ims, fms) in ivf_ms.items():
        say(f"  IVF top-10 {rung} Q={nq} nprobe={IVF_NPROBE}: {ims:.4f} ms "
            f"(kernel path, end to end); flat K1 bf16 top-10 over the same "
            f"1M rows: {fms:.4f} ms")
    say(f"  IVF build 1M x 512 C={IVF_CLUSTERS}: train_centroids "
        f"{ivf_build_s['train']:.3f} s (262,144-row sample, 10 iterations); "
        + "; ".join(f"{IVF_RUNGS[m]} assign {ivf_build_s[m]['assign']:.3f} "
                    f"s, fill {ivf_build_s[m]['fill']:.3f} s"
                    for m in IVF_RUNGS)
        + f"; sidecar load (bf16, device chunks) {ivf_load_s:.3f} s")
    fit = planner["fit"]
    say(f"phase 6 planner constants fitted ({card}): EFFECTIVE_SCAN_GBPS "
        f"{fit['EFFECTIVE_SCAN_GBPS']:.1f} (1M x 512 bf16 bytes / the eager "
        f"flat Q=1 top-10), IVF_GATHER_EFF {fit['IVF_GATHER_EFF']:.4f} (the "
        f"probed buckets' bytes / K7 alone at Q=1, nprobe {IVF_NPROBE}: "
        f"{probe_q1[0]:.4f} ms, spread {probe_q1[1]:.4f}-{probe_q1[3]:.4f}; "
        f"over the scan rate), IVF_OVERHEAD_MS {fit['IVF_OVERHEAD_MS']:.4f} "
        f"(the eager IVF Q=1 less the probe and the transfer terms), "
        f"HBM_GB_DEFAULT {fit['HBM_GB_DEFAULT']:.3f} (total_memory / 1e9); "
        f"plan.py holds " + ", ".join(f"{k} {v:g}" for k, v in
                                      planner["held"].items()))
    say(f"phase 6 plan Q=1 top-10 predicted (plan.py's constants) / "
        f"measured eager ({card}): " + "; ".join(
            f"{k} {p:.4f} / {m:.4f} ms ({p / m - 1:+.1%}"
            + (", outside +-35%)" if abs(p / m - 1) > 0.35 else ")")
            for k, (p, m) in planner["rungs"].items()))
    for rows, lines in ops_ctx["plans"].items():
        say(f"phase 6 `mmrs-torch plan --rows {rows} --dim {DIM}`: "
            + " | ".join(ln.strip() for ln in lines))
    lt = ops_ctx["times"]["lifecycle_s"]
    say(f"phase 6 lifecycle (4h) stages, host clock ({card}): wall "
        f"{lt['wall']:.3f} s = " + ", ".join(
            f"{k} {v:.3f} s" for k, v in lt.items() if k != "wall"))
    it = ops_ctx["times"]["int4"]
    say(f"phase 6 LLaMA-2-7B width, {INT4_LAYERS} layers + lm_head, B="
        f"{LLAVA_B}, a decode step at {INT4_PROMPT} ({card}): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in it["step_ms"].items())
        + f"; int4 unpack {it['unpack_device_ms']:.3f} of "
        f"{it['step_device_ms']:.3f} ms device time a step "
        f"({100 * it['unpack_share']:.1f}%, torch.profiler); step's top "
        f"kernels {json.dumps(it['step_top'])}")
    say("  IVF residency: " + "; ".join(
        f"{IVF_RUNGS[m]} {v.hbm_bytes() / 2 ** 20:.1f} MiB (buckets "
        f"{v.buckets.nbytes / 2 ** 20:.1f} MiB, cap {v.bucket_cap}, spill "
        f"{v.spill.nbytes / 2 ** 20:.1f} MiB)" for m, v in ivfs.items()))

    pairs = DEDUP_ROWS * (DEDUP_ROWS - 1) // 2      # the intra triangle
    for name, (kms, pms) in k9_ms.items():
        say(f"  K9 first_match {name} {DEDUP_ROWS}x{DIM} intra tau "
            f"{DEDUP_TAU}: kernel {kms:.4f} ms "
            f"({DEDUP_ROWS ** 2 / kms / 1e6:.1f} Gpairs/s as bench.py counts"
            f" N^2), plain {pms:.4f} ms ({DEDUP_ROWS ** 2 / pms / 1e6:.1f} "
            f"Gpairs/s)")
    say(f"  K2 yardstick: scaled_dot_product_attention [{EMBED_BATCH}, 12, "
        f"50, 64] bf16 {library_ms['mha_short_seq']:.4f} ms")
    t14 = LLAVA_B * 577
    l14_bounds = {
        "mha_short_seq": least_ms(4 * t14 * 1024 * 2,
                                  4 * LLAVA_B * 16 * 577 * 577 * 64, "bf16"),
        "mlp_int8_fused": least_ms(2 * t14 * 1024 * 2 + 2 * 1024 * 4096
                                   + (4096 + 1024) * 8,
                                   2 * 2 * t14 * 1024 * 4096, "int8")}
    say(f"  K2 mha_short_seq [{LLAVA_B},577,1024]/16 (ViT-L/14-336): kernel "
        f"{l14['mha_short_seq'][0]:.4f} ms, plain "
        f"{l14['mha_short_seq'][1]:.4f} ms, SDPA {l14_lib:.4f} ms, bound "
        f"{l14_bounds['mha_short_seq'][0]:.4f} ms "
        f"({l14_bounds['mha_short_seq'][1]})")
    kms, pms = bi["l14_embed"]
    say(f"  ViT-L/14 bf16 embed batch {UNION_BATCH} (phase 4f's converted "
        f"weights): kernels {UNION_BATCH / kms * 1e3:.1f} img/s "
        f"({kms:.3f} ms), plain {UNION_BATCH / pms * 1e3:.1f} img/s "
        f"({pms:.3f} ms)")
    say(f"  Taiyi RoBERTa-large text encode, batch {TAIYI_BATCH} x 16 "
        f"tokens, bf16 (plain attention, as the JAX package's): "
        f"{bi['taiyi_ms']:.3f} ms a batch")
    for key, shape in (("k2_257", f"[{UNION_BATCH},257,1024]/16 bf16 "
                                  f"(ViT-L/14 224 px)"),
                       ("k2_f32", f"[{LLAVA_B},577,1024]/16 f32 (C.3)")):
        (kms, pms), (bms, by) = bi[key], bi[key + "_bound"]
        say(f"  K2 mha_short_seq {shape}: kernel {kms:.4f} ms, plain "
            f"{pms:.4f} ms, SDPA {bi[key + '_sdpa']:.4f} ms, bound "
            f"{bms:.4f} ms ({by}) = {kms / bms:.2f}x bound, "
            f"{kms / bi[key + '_sdpa']:.2f}x SDPA")
    r = bi["k1_768"]
    say(f"  K1 cosine_topk {GALLERY_ROWS}x768 bf16 Q=8 k=10: on the card "
        "alone {:.4f} ms ({:.4f} / {:.4f} / {:.4f}), eager {:.4f} ms, plain "
        "{:.4f} ms, matmul + torch.topk {:.4f} ms, bound {:.4f} ms ({}) = "
        "{:.2f}x".format(*r["graph_ms"], r["eager_ms"], r["plain_ms"],
                         r["matmul_topk_ms"], *r["bound"],
                         r["graph_ms"][0] / r["bound"][0]))
    say(f"  K6 mlp_int8_fused [{t14},1024]->4096 (ViT-L/14-336 int8): "
        f"kernel {l14['mlp_int8_fused'][0]:.4f} ms, plain "
        f"{l14['mlp_int8_fused'][1]:.4f} ms, bound "
        f"{l14_bounds['mlp_int8_fused'][0]:.4f} ms "
        f"({l14_bounds['mlp_int8_fused'][1]}); its two products through "
        f"torch._int_mm {int_mm_ms['l14']:.4f} ms")
    say(f"  K6 mlp_int8_fused [{EMBED_BATCH * 50},768]->3072 (ViT-B/32 "
        f"int8): kernel {times['mlp_int8_fused'][0]:.4f} ms, plain "
        f"{times['mlp_int8_fused'][1]:.4f} ms; its two products through "
        f"torch._int_mm {int_mm_ms['b32']:.4f} ms (a yardstick: not one call "
        f"computing K6's function)")
    for shape, key in (("[11200,768]->3072", "b32"),
                       ("[4616,1024]->4096", "l14")):
        ms4 = k6_split[key]
        say(f"  K6 {shape} launches alone: row-quantize x {ms4[0]:.4f} ms, "
            f"x.w1 + activation {ms4[1]:.4f} ms, row-quantize h "
            f"{ms4[2]:.4f} ms, h.w2 {ms4[3]:.4f} ms (sum {sum(ms4):.4f})")
    for (name, kind), (kms, pms, (bms, by), lib) in kv_times.items():
        shape = (f"last prefill chunk C={kv_c} at {kv_start}, window "
                 f"{kv_lim}" if name == "chunk_attention" else
                 f"decode step at pos {llava_ctx['prompt_len'] + 16}")
        model = ("draft (4 kv heads, G=8, HD=64)" if name == "decode_draft"
                 else "7B")
        spread = kv_spreads.get((name, kind))
        say(f"  {'K10' if name == 'chunk_attention' else 'K11'} {name} "
            f"{kind} {model} B={LLAVA_B} cache {kv_cache_len} slots, "
            f"{shape}: kernel {kms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{bms:.4f} ms ({by})"
            + (f", SDPA {lib:.4f} ms" if lib is not None else "")
            + (" ; on the card alone (CUDA graph of 20 calls, 20 replays), "
               "min / median / max {:.4f} / {:.4f} / {:.4f} ms a call; "
               "eager calls {:.4f} ms (host dispatch included)".format(
                   *spread, kv_eager[(name, kind)]) if spread else ""))
    # the rebuilt attention kernels against their yardsticks: kernel ms
    # over SDPA's and over the bound, in this run
    bound50 = least_ms(4 * EMBED_BATCH * 50 * 768 * 2,
                       4 * EMBED_BATCH * 12 * 50 * 50 * 64, "bf16")
    for what, kms, lib, (bms, by) in (
            (f"K2 [{EMBED_BATCH},50,768]/12", times["mha_short_seq"][0],
             library_ms["mha_short_seq"], bound50),
            (f"K2 [{LLAVA_B},577,1024]/16", l14["mha_short_seq"][0], l14_lib,
             l14_bounds["mha_short_seq"]),
            *((f"{label} {kind}", kv_times[(name, kind)][0],
               kv_times[(name, kind)][3], kv_times[(name, kind)][2])
              for name, label in (("chunk_attention", f"K10 C={kv_c}"),
                                  ("decode_attention", "K11 7B"),
                                  ("decode_draft", "K11 draft"))
              for kind in ("bf16", "int8"))):
        say(f"  {what}: kernel {kms:.4f} ms = "
            + (f"{kms / lib:.2f}x SDPA ({lib:.4f} ms), " if lib else "")
            + f"{kms / bms:.2f}x its bound ({bms:.4f} ms, {by})")
    cut = GALLERY_ROWS * DIM * 2 + 8 * DIM * 2 + 8 * 300 * 8
    b300 = least_ms(cut, 2 * 8 * GALLERY_ROWS * DIM, "bf16")
    say(f"  top-300 over {GALLERY_ROWS}x{DIM} bf16 at Q=8 (C.1): kernel "
        f"{top300[0]:.4f} ms (top-10 {times['cosine_topk'][0]:.4f} ms), "
        f"plain {top300[1]:.4f} ms, bound {b300[0]:.4f} ms ({b300[1]})")
    for name, e in llava_ctx["e2e"].items():
        say(f"  verifier {name} pack of {LLAVA_B} (prompt "
            f"{llava_ctx['prompt_len']} tokens, {LLAVA_MAX_NEW} new): "
            f"{llava_ctx['pack_s'][name] * 1e3:.1f} ms per pack through "
            f"run_streaming (early stop, JPEG decode included); "
            + ", ".join(f"{k} {v:.3f}" for k, v in e.items()))
    for name, (wall, dev_ms, top) in llava_ctx["profile"].items():
        say(f"  verifier {name} profile, one generate of a pack (encode, "
            f"prefill, 31 decode steps; torch.profiler): wall {wall:.1f} ms, "
            f"device {dev_ms:.1f} ms ({dev_ms / wall:.1%} busy); "
            + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in top))
    w_mlp = 768 * 3072
    bounds = {   # (bytes each input read once + each output written, ops, type)
        "normalize_images": least_ms(EMBED_BATCH * 224 * 224 * 3 * 3,
                                     EMBED_BATCH * 224 * 224 * 3 * 2, "f32"),
        "mha_short_seq": least_ms(4 * EMBED_BATCH * 50 * 768 * 2,
                                  4 * EMBED_BATCH * 12 * 50 * 50 * 64, "bf16"),
        "cosine_topk": least_ms(
            GALLERY_ROWS * DIM * 2 + 8 * DIM * 2 + 8 * 80,
            2 * 8 * GALLERY_ROWS * DIM, "bf16"),
        "cosine_topk_quantized": least_ms(
            GALLERY_ROWS * (DIM + 4) + 8 * DIM * 4 + 8 * 80,
            2 * 8 * GALLERY_ROWS * DIM, "int8"),
        "cosine_topk_int4": least_ms(
            GALLERY_ROWS * (DIM // 2 + 4) + 8 * DIM * 4 + 8 * 80,
            2 * 8 * GALLERY_ROWS * DIM, "int8"),
        "mlp_int8_fused": least_ms(
            2 * EMBED_BATCH * 50 * 768 * 2 + 2 * w_mlp + (3072 + 768) * 8,
            2 * 2 * EMBED_BATCH * 50 * w_mlp, "int8"),
        "probe_buckets": probe["bf16"]["bound"],
        "probe_buckets_q4": probe["int4"]["bound"],
        # f32 rows as the kernel runs them: six bf16 products of the exact
        # hi/mid/lo split on the tensor cores
        "first_match": least_ms(DEDUP_ROWS * DIM * 4 + DEDUP_ROWS * 4,
                                6 * 2 * DIM * pairs, "bf16"),
        # f32 sums read once, bf16 written once
        "bias_act": least_ms(65792 * 4096 * 6, 0, "f32"),
        # bf16 rows read and written once, the f32 gains and offsets once
        "layer_norm": least_ms(65792 * 1024 * 4 + 8 * 1024, 0, "bf16"),
    }
    k9_bf16_bound = least_ms(DEDUP_ROWS * DIM * 2 + DEDUP_ROWS * 4,
                             2 * DIM * pairs, "bf16")
    k9_fma_bound = least_ms(DEDUP_ROWS * DIM * 4 + DEDUP_ROWS * 4,
                            2 * DIM * pairs, "f32")
    other_rung = {"first_match": ("bf16", k9_bf16_bound),
                  "probe_buckets": ("int8", probe["int8"]["bound"])}
    for name, (ms, by) in bounds.items():
        rung, (oms, oby) = other_rung.get(name, ("", (0.0, "")))
        say(f"  bound {name}: {ms:.4f} ms ({by})"
            + (f"; {rung} {oms:.4f} ms ({oby})" if rung else ""))
    say(f"  bound first_match f32 on CUDA-core FMAs (the rate of the "
        f"earlier FMA design, for comparison): {k9_fma_bound[0]:.4f} ms "
        f"({k9_fma_bound[1]})")

    meta = {
        "cosine_topk": ("cuda", "mmrs_tpu_torch/csrc/cosine_topk.cu",
                        "mmrs_tpu/ops/topk.py:94"),
        "mha_short_seq": ("cuda", "mmrs_tpu_torch/csrc/mha_short_seq.cu",
                          "mmrs_tpu/ops/attention.py:134"),
        "normalize_images": ("triton",
                             "mmrs_tpu_torch/csrc/normalize_triton.py",
                             "mmrs_tpu/ops/preprocess.py:84"),
        "cosine_topk_quantized": ("cuda", "mmrs_tpu_torch/csrc/quant_topk.cu",
                                  "mmrs_tpu/ops/quant.py:93"),
        "cosine_topk_int4": ("cuda", "mmrs_tpu_torch/csrc/quant_topk.cu",
                             "mmrs_tpu/ops/quant4.py:149"),
        "mlp_int8_fused": ("cuda", "mmrs_tpu_torch/csrc/mlp_int8.cu",
                           "mmrs_tpu/ops/mlp_int8.py:62"),
        "probe_buckets": ("cuda", "mmrs_tpu_torch/csrc/ivf_probe.cu",
                          "mmrs_tpu/index/ivf.py:623"),
        "probe_buckets_q4": ("cuda", "mmrs_tpu_torch/csrc/ivf_probe.cu",
                             "mmrs_tpu/index/ivf.py:812"),
        "first_match": ("cuda", "mmrs_tpu_torch/csrc/first_match.cu",
                        "mmrs_tpu/ops/allpairs.py:74"),
        "chunk_attention": ("cuda", "mmrs_tpu_torch/csrc/decode_attention.cu",
                            "mmrs_tpu/ops/decode_attention.py:142"),
        "decode_attention": ("cuda",
                             "mmrs_tpu_torch/csrc/decode_attention.cu",
                             "mmrs_tpu/ops/decode_attention.py:237"),
        "bias_act": ("cuda", "mmrs_tpu_torch/csrc/dense_epilogue.cu",
                     "none (layers.dense's epilogue, the port's own)"),
        "layer_norm": ("cuda", "mmrs_tpu_torch/csrc/layer_norm.cu",
                       "none (layers.LayerNorm, the port's own)"),
    }
    extra = {"layer_norm": {"shapes": ln["times"], "towers": ln["towers"]},
             "first_match": {   # ms/plain_ms/bound_ms above are f32's
        "bf16_ms": k9_ms["bf16"][0], "bf16_plain_ms": k9_ms["bf16"][1],
        "bf16_bound_ms": k9_bf16_bound[0],
        "f32_fma_bound_ms": k9_fma_bound[0],
        "gpairs_s": {n: DEDUP_ROWS ** 2 / t[0] / 1e6
                     for n, t in k9_ms.items()}}}
    extra["cosine_topk"] = {"k300_ms": top300[0], "k300_plain_ms": top300[1],
                            "k300_bound_ms": b300[0]}
    extra["mlp_int8_fused"] = {"int_mm_ms": int_mm_ms["b32"],
                               "l14_int_mm_ms": int_mm_ms["l14"],
                               "launch_ms": k6_split["b32"],
                               "l14_launch_ms": k6_split["l14"]}
    for name in ("mha_short_seq", "mlp_int8_fused"):   # the L/14 shapes
        extra.setdefault(name, {}).update(
            l14_ms=l14[name][0], l14_plain_ms=l14[name][1],
            l14_bound_ms=l14_bounds[name][0],
            l14_library_ms=l14_lib if name == "mha_short_seq" else None)
    for name in ("chunk_attention", "decode_attention"):  # ms: bf16 cache
        kms, pms, (bms, _), _ = kv_times[(name, "int8")]
        extra[name] = {"int8_ms": kms, "int8_plain_ms": pms,
                       "int8_bound_ms": bms}
        bounds[name] = kv_times[(name, "bf16")][2]
    for kind in ("bf16", "int8"):   # K11 at the draft's head shape
        kms, pms, (bms, _), lib = kv_times[("decode_draft", kind)]
        extra["decode_attention"].update({
            f"draft_{kind}_ms": kms, f"draft_{kind}_plain_ms": pms,
            f"draft_{kind}_bound_ms": bms, f"draft_{kind}_library_ms": lib})
    extra["decode_attention"]["spread_ms"] = {
        f"{name}_{kind}": v for (name, kind), v in kv_spreads.items()}
    extra["decode_attention"]["eager_ms"] = {
        f"{name}_{kind}": v for (name, kind), v in kv_eager.items()}
    # K7 / K8: ms = on the card alone (graph_ms), eager and the parent's
    # (--parent, before / after) beside it; K7's int8 rung under int8_*
    for name, rungs in (("probe_buckets", ("bf16", "int8")),
                        ("probe_buckets_q4", ("int4",))):
        d = extra.setdefault(name, {})
        for rung in rungs:
            r = probe[rung]
            pre = "" if rung in ("bf16", "int4") else "int8_"
            d.update({f"{pre}eager_ms": r["eager_ms"],
                      f"{pre}graph_spread_ms": r["graph_ms"][1:],
                      f"{pre}split_ms": r["split"],
                      f"{pre}parent_graph_ms": [p[rung]["graph_ms"][0]
                                                for p in probe_parent],
                      f"{pre}parent_eager_ms": [p[rung]["eager_ms"]
                                                for p in probe_parent]})
            if pre:
                d.update(int8_ms=r["graph_ms"][0], int8_plain_ms=r["plain_ms"],
                         int8_bound_ms=r["bound"][0])
    extra["probe_buckets_q4"]["design"] = (
        "bucket-major probe_scan_kernel<kRowS4> (csrc/ivf_probe.cu): one "
        "read of each distinct bucket of a tile of 8 queries, packed rows "
        "as two s8 nibble planes on mma.sync m16n8k32")
    extra.setdefault("cosine_topk_quantized", {})["design"] = (
        "span scan span_scan_kernel<kRowS8> (csrc/span_scan.cuh): int8 rows "
        "on mma.sync m16n8k32 s8 against 8 queries, a threshold select")
    for name, d in flat_extra.items():
        extra.setdefault(name, {})["flat"] = d
    # the bilingual path (phase 4f) and its phase 6 shapes
    for name in ("cosine_topk", "mha_short_seq", "normalize_images"):
        extra.setdefault(name, {})["launches_4f"] = bi_ctx["launches"][name]
    extra["mha_short_seq"].update({
        f"{key}_{f}": v for key in ("k2_257", "k2_f32") for f, v in (
            ("ms", bi[key][0]), ("plain_ms", bi[key][1]),
            ("library_ms", bi[key + "_sdpa"]),
            ("bound_ms", bi[key + "_bound"][0]))})
    r = bi["k1_768"]
    extra["cosine_topk"]["d768"] = {
        "graph_ms": r["graph_ms"][0], "graph_spread_ms": r["graph_ms"][1:],
        "eager_ms": r["eager_ms"], "plain_ms": r["plain_ms"],
        "matmul_topk_ms": r["matmul_topk_ms"], "bound_ms": r["bound"][0]}
    # phase 4g's times
    for name in ("cosine_topk", "mha_short_seq", "normalize_images",
                 "cosine_topk_quantized", "cosine_topk_int4",
                 "probe_buckets", "chunk_attention", "decode_attention"):
        extra.setdefault(name, {})["launches_4g_serve"] = \
            ag_ctx["launches"]["serve"][name]
    for name in ("mha_short_seq", "normalize_images"):
        extra[name]["launches_4g_adapter"] = \
            ag_ctx["launches"]["adapter"][name]
    at = ag_ctx["times"]
    say(f"phase 6 adapter train --root (4g), {card}: wall "
        f"{at['adapter_s']['wall']:.3f} s = "
        + ", ".join(f"{k} {v:.3f} s" for k, v in at["adapter_s"].items()
                    if k != "wall"))
    say(f"phase 6 contrastive step (4g; ViT-B/32 + text B/32, batch "
        f"{CONTRASTIVE_BATCH}, bf16 compute), {card}: ms a step "
        + ", ".join(f"{x:.2f}" for x in at["contrastive_step_ms"]))
    for rung, st in at["serve"].items():
        if isinstance(st, dict):
            say(f"phase 6 serve (4g) {rung}, {SERVE_CLIENTS} clients, "
                f"{card}: " + ", ".join(
                    f"{run} {st[run]['qps']:.2f} QPS, p50 "
                    f"{st[run]['p50_ms']:.2f} ms, p99 {st[run]['p99_ms']:.2f}"
                    f" ms" for run in ("cold", "warm"))
                + f"; {st['items_per_call']:.2f} items a query dispatch; "
                f"traced burst: device {st['traced']['device_ms']:.3f} of "
                f"{st['traced']['wall_ms']:.3f} ms")
    st = at["stream"]
    say(f"phase 6 streaming_topk (4g) 1 GiB memmap, {card}: GB/s prefetch "
        f"0 " + ", ".join(f"{x:.3f}" for x in at["stream_gbs"][0])
        + "; prefetch 2 "
        + ", ".join(f"{x:.3f}" for x in at["stream_gbs"][2])
        + f"; ring set-up ms {st['ring_ms'][0]:.3f}, {st['ring_ms'][1]:.3f};"
        f" host copy alone {st['host_copy_gbs']:.3f} GB/s")
    extra["cosine_topk"]["stream_gbs"] = {
        str(p): v for p, v in at["stream_gbs"].items()}
    # phase 4h's runs (the operations layer and the int4 LLaMA)
    for name in ("cosine_topk", "mha_short_seq", "normalize_images",
                 "mlp_int8_fused", "first_match", "chunk_attention",
                 "decode_attention"):
        extra.setdefault(name, {})["launches_4h"] = {
            run: c[name] for run, c in ops_ctx["launches"].items()
            if c[name]}
    extra["probe_buckets"]["q1_graph_ms"] = probe_q1[0]
    for name in ("mha_short_seq", "normalize_images", "mlp_int8_fused",
                 "chunk_attention", "decode_attention"):
        extra.setdefault(name, {})["launches_4j"] = {
            run: c[name] for run, c in tp_ctx["launches"].items()
            if c[name]}
    for fn in kernels[:9]:
        extra.setdefault(fn.__name__, {})["launches_4i"] = {
            run: c[fn.__name__] for run, c in mesh_ctx["launches"].items()
            if c[fn.__name__]}
    mt = mesh_ctx["times"]
    for rung, r in mt["flat"].items():
        say(f"phase 6 sharded {rung} top-10 (4i), Q=8, {GALLERY_ROWS} x "
            f"{DIM} on one card, {card}: ms eager / card alone: direct "
            f"{r['direct_ms']:.4f} / {r['direct_graph_ms']:.4f}, "
            + ", ".join(f"S={n} {r[f's{n}_ms']:.4f} / "
                        f"{r[f's{n}_graph_ms']:.4f}" for n in (1, 2, 4)))
    name = {"bf16": "cosine_topk", "int8": "cosine_topk_quantized",
            "int4": "cosine_topk_int4"}
    for rung, r in mt["flat"].items():
        extra[name[rung]]["sharded_4i_ms"] = r
    say(f"phase 6 dedup ring (4i), {DEDUP_ROWS} x {DIM}, {MESH_SHARDS} x "
        f"{MESH_SHARDS} blocks, {card}: ms ring / one-device K9 "
        + ", ".join(f"{n} {a:.3f} / {b:.3f}"
                    for n, (a, b) in mt["ring_ms"].items()))
    extra["first_match"]["ring_4i_ms"] = mt["ring_ms"]
    say(f"phase 6 sharded embed (4i) ViT-B/32, {card}: host s sharded / "
        f"one device " + ", ".join(
            f"{k[6:]} {v['sharded_s']:.3f} / {v['one_s']:.3f}"
            for k, v in mt.items() if k.startswith("embed_")))
    say(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s (the "
        f"build included; limit 1200 s)")
    say(json.dumps({"kernels": [
        {"name": name, "route": route, "source": source, "replaces": where,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library_ms.get(name), **extra.get(name, {})}
        for name, (route, source, where) in meta.items()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
