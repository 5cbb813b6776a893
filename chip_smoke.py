#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero, and the final line is printed only when
every phase passed):

1. env      - the card's name and power limit (nvidia-smi), torch/CUDA
              versions, TF32 off for f32 products, and the nvcc build of every
              kernel in ``src/repro_torch/kernels/csrc`` (build seconds); a
              spill in a Hopper flash, decode or SSD kernel, or in a backward
              of the SSD scan or the router, fails the run.
2. kernels  - each hand-written kernel against its plain PyTorch version on
              the card, at the main path's shapes and the edge cases of the
              JAX package's kernel tests; one JSON line per case with the
              error, tolerance, kernel / plain / library times and the bound.
              A spill in any instantiation at head dim 112 fails phase 1.
              bf16 attention outputs are also held row by row against the RMS
              of the f32 plain output (``row_rel_err``), since bf16's absolute
              tolerance is as large as a long window's outputs.  ssd_scan is
              held at the JAX suite's 5e-4 (atol and rtol; a bf16 output also
              gets its own rounding, 2^-8 of the value) for y and the final
              state, 1e-3 across chunk sizes, on the JAX suite's inputs and
              on those of the mamba2 mixer (fast decay); moe_router's ids
              and slots must be equal and its gates within 1e-6;
              fused_augment at 1e-5 (atol and rtol) on the JAX suite's
              shapes, corners out of range and the ImageNet recipe, and its
              flip as an involution; the flash backward's dq, dk, dv against
              torch.autograd.grad of the plain version in f32 (the
              forward's tolerance as atol and rtol: f32 2e-5, bf16 3e-2),
              bf16 also row by row (floored at the tensor's RMS) against the
              backward's plain version on the kernel's own output and
              log-sum-exp.  The bf16 Hopper kernels are also held at both
              forward tiles (128 x 128, 128 x 64) on their edges
              (``BF16_EDGES``: ragged tails, q_offset with Sq != Sk,
              non-causal, MHA, D = 64 and 32, softcap), the backward must be
              bit-identical across two runs, and every flash record carries
              its achieved TFLOP/s and share of its bound.  decode_attention
              (also on the card's split plan, ``num_splits=None``) and
              ssd_scan must be bit-identical across two runs; decode,
              moe_router, ssd_scan and backward records carry ``device_ms``,
              the profiler's kernel time per call beside the back-to-back
              ``kernel_ms``, and decode and flash backward records SDPA's
              too; ssd_scan is held against its plain version in f64 and
              records the bound at the tensor cores' rate with the passes
              its kernels take.  The cases of
              ``DECODE_CASES_NEW`` and ``SSD_CASES_NEW`` draw from their own
              generator, after every earlier case.  Then, on a generator of
              their own (``D112_REDESIGN_SEED``), kimi-k2's head dim 112 (flash
              forward with SDPA beside it, backward and decode, bf16 and
              f32), the router at T = 1, 65, 4097 and E = 64, 384, and the
              augment at C = 4, unaligned rows, a row longer than one staged
              piece and a generic C; every router case must be bit-equal
              across two runs.  Then, on a generator of their own
              (``BWD_SEED``), the backward kernels: ``ssd_scan_bwd``'s dx,
              ddt, da, dB, dC and dD against ``ssd_scan_bwd_ref`` in f64 on
              the card (f32 within allclose(rtol=5e-4, atol=5e-4 x the
              reference's RMS), bf16 by the row rule at 3e-2) at mamba2's
              train shape, bf16, G < H, a ragged L and a non-zero dh_final,
              and ``moe_router_bwd`` within 1e-6 of its plain version at
              moonshot's and kimi's routing, T = 8 and ties; both bit-equal
              across two runs; then, on a generator of its own
              (``BWD_REDESIGN_SEED``), the SSD backward at a group of 12
              heads (head blocks of 8 and 4).  Right after the flash
              backward cases, on a generator of their own
              (``ENCDEC_VLM_SEED``), whisper-large-v3's and qwen2-vl-2b's
              shapes: flash without the causal mask at B = 8, S = 1500
              (every key tile live, the last ragged) and Sq = 448 != Sk =
              1500, bf16 at both tiles and f32, qwen2-vl's causal prefill
              at G = 6 and whisper's causal decoder self-attention (B = 8,
              S = 448), each run twice for bit-equal outputs and timed on
              the device beside SDPA; decode over the encoder's fixed
              length (G = 1), at G = 6, and over whisper's 448-row self
              cache at lengths up to 64, in bf16.  Each SSD backward record has
              its bounds at f32's FMA rate and at the tensor cores' with the
              passes its kernels take, their shares of the device time, and
              the scratch bytes it moves, and at L = 8192 a profile of one
              call by kernel; the SM clock is sampled after the SSD backward
              cases.  Then, on a generator of their own (``SLICE10_SEED``),
              the routes of the slice that trains whisper-large-v3 and
              qwen2-vl-2b and serves and trains jamba-v0.1-52b: the bf16
              flash backward at their train shapes (whisper's encoder,
              non-causal at B = 8, S = 1500; its cross-attention, Sq = 448
              over Sk = 1500; its decoder self-attention; qwen2-vl's G = 6
              and jamba's G = 4 at S = 4096), the f32 backward non-causal at
              Sq != Sk and at G = 6, jamba's flash prefill (S = 8192, 32/8)
              and decode (G = 4, the CUDA-core route), its SSD scan (128
              heads, N = 16: L = 8192 in bf16, L = 4096 in f32) and
              backward (L = 4096, f32) and its router forward and backward
              at E = 16, k = 2 (T = 8, 4096, 4097, 8192); each timed on the
              device (SDPA's beside attention).
              Last, decode's device time at 1-128 splits beside the card
              plan's pick (``SPLIT_SWEEP``), from which the plan's constants
              were set.  Then the causal conv's cases (``conv_cases``, on
              their own generator, ``CONV_SEED``): forward and backward
              against the plain versions in f64 at mamba2-2.7b's train
              shape and jamba-v0.1-52b's, and at its edges, bit-equal
              across two runs, beside the plain versions' times, the
              bytes bound and, at the main shapes, the time of the glue
              they replaced.  Then the RMSNorm's cases (``norm_cases``,
              ``NORM_SEED``): the plain and gated forms forward and
              backward against the plain versions in f64 at mamba2-2.7b's
              and jamba-v0.1-52b's train shapes, qk-norm, decode and the
              edges of the plan and of the element-wise route, bit-equal
              across two runs, beside the bytes bound and the plain
              version's time (the backward's: autograd through it, the
              glue it replaced).  Then the AdamW update's cases
              (``adamw_cases``, ``ADAMW_SEED``): ptxas compiled all eight
              dtype instantiations with no spill; the kernel against its
              expression in f64 at the largest leaf of each benchmark cell,
              a clipped step, a 1-D leaf and bf16 leaves, gradients and
              moments, bit-equal across two runs, beside the bytes bound,
              the plain version's time and PyTorch's fused AdamW's.  Then
              the memory check of each of the thirteen kernels
              (``phase_kernel_memory``): one call at its main case after a
              warm-up, its rise of ``max_memory_allocated`` against what
              ``repro_torch.launch.memory.MemoryTracker`` charges the same
              call on meta (outputs plus the launch's ``*_scratch``), equal
              within 512 B a tensor.
3. models   - at full width, random weights from a seeded generator, for
              starcoder2-3b (dense), mamba2-2.7b (SSM), moonshot-v1-16b-a3b
              (MoE, bf16 parameters), kimi-k2-1t-a32b (MoE, head dim 112,
              bf16 parameters, its first 2 layers), qwen2-vl-2b (VLM,
              prefill from embeddings with Qwen2-VL's M-RoPE positions) and
              jamba-v0.1-52b (hybrid, bf16 parameters, one 7:1 period of 8
              layers, prefill S = 8192): (a) a prefill, (b) a ServeEngine
              answering 8 requests, (c) teacher-forced decode logits
              against forward logits in f32 (moonshot at 4 of its 48
              layers, kimi at its dense first layer, qwen2-vl at 2 layers,
              jamba at the 2-layer cut of its train run, dropless).  Then whisper-large-v3
              (enc-dec, not cut; ``phase_encdec``): (a) a prefill of 8 clips
              (1500 frames, 448 tokens), (b) the encoder once and 64 greedy
              decode steps (``greedy_decode``: ServeEngine drives
              decoder-only models), (c) its forward and 8 decode steps in
              f32 at 2 + 2 layers on the card against the CPU plain route
              (the reference's decode applies rope and its forward does
              not, so decode is not held against forward).  Launch counters are
              reset just before and read just after each of (a)-(c), and a
              run with fewer launches than the model's layers need fails;
              each phase logs its peak device memory and (a), (b) a profile
              of device time and idle share; a prefill profile that holds
              PyTorch's sort-based scatter (the MoE dispatch before it became
              a plain assignment) fails.  Each model's prefill and one of
              its decode steps are held against the dry run's prediction
              on meta for the same program (``step_memory_check``: the
              record of ``run_cell`` with the phase's config, B, S, batch
              and cast parameters; the card's bytes of the step are its
              arguments plus its rise over what was allocated before it;
              within ``MEM_STEP_TOL``, 10%, of the measured).
4. augment  - ``fused_augment`` as its users call it: ResNet-50's ImageNet
              recipe (256 images 256x256x3 cropped to 224x224, random
              corners and flips) on 8 batches; no model path calls it in
              either package, so this op phase is its main path.
5. train    - ``TRAIN_RUNS``, each fed by a ``repro_torch.feed.DeviceFeeder``
              over packed zipf token batches in the family's layout of the
              JAX package's ``train_input_specs`` (``FamilyBatches``: f32
              ``enc_embeds`` for whisper, f32 ``embeds`` and M-RoPE
              positions in place of tokens for qwen2-vl; their random
              floats cycle through a pool drawn before the timed steps),
              f32 parameters
              and AdamW state, bf16 compute, ``remat="block"``:
              starcoder2-3b at full width (S=8192, 6 steps), mamba2-2.7b at
              full width (64 layers, S=8192, 4 steps), moonshot-v1-16b-a3b
              at full width cut to 4 of its 48 layers (S=4096, 4 steps),
              whisper-large-v3 not cut (B=8 clips of 1500 frames and 448
              tokens, 4 steps), qwen2-vl-2b not cut (S=4096 from
              embeddings, 4 steps) and jamba-v0.1-52b at full width cut to
              2 layers at period 2 (mamba2 + dense, attention + MoE;
              S=4096, 4 steps).  Each logs the
              loss, seconds and tokens per step, peak memory, the feed's
              idle and stall numbers and the launches per step of every
              kernel with a backward (a forward per layer, one more per
              layer of a repeated group under remat, a backward per layer;
              an enc-dec's flash in every encoder layer and twice in every
              decoder layer, each recomputed; fewer fails), then a profiled
              step with the SM clock sampled before and after it, and,
              with the feeder closed, one more step on the profiled
              step's batch held against the dry run's prediction
              (``step_memory_check``; the gradient buffers the step keeps
              from its first call count as its own).  Then each
              at 2 layers in f32 (whisper 2 + 2, jamba at its cut and
              dropless; B=1, S=256): one train step through the
              kernels on the card against the same step on CPU copies
              through the plain route (loss, gradient norm, updated
              parameters, each against a stated tolerance).
6. service  - the paper's main path through the launcher, ``SERVICE_RUNS``:
              ``python -m repro_torch.launch.train --execute --full-width
              --device cuda`` in a subprocess (``examples/train_e2e_torch.py``
              starts the data service, whose 2 workers draw the batches of
              ``launch/specs.py``'s layout; a ``DeviceFeeder`` moves them to
              the card; the trainer runs the kernels built in phase 1) for
              starcoder2-3b (B=1, S=8192, 6 steps) and whisper-large-v3
              uncut (B=8 clips, 448 tokens, 4 steps).  A non-zero exit, a
              timeout or a missing result line fails the run; so do a loss
              that is not finite, a first batch whose loss after the run is
              not below its loss at step 1 (uniform tokens leave the loss
              across batches flat within their noise), fewer launches than
              ``train_launches_per_step`` a step, 80 GB or more of peak
              memory, or a thread or process left running.  Logs the feed's
              idle and stall beside phase 5's in-script feed, and the dry
              run's FLOPs a step (``repro_torch.launch.dryrun`` on meta, the
              same config, B and S) with the achieved TFLOP/s and share of
              989e12.
7. dist     - the distribution layer (``DIST_RUN``): (a) phase 5's
              starcoder2-3b run at full width (B=1, S=8192, 3 steps) as a
              sharded train step on a (data, model) = (1, 1) DeviceMesh over
              one NCCL rank (a local store): the state placed by
              ``make_param_shardings`` / ``make_opt_shardings``, the steps
              under ``use_plan`` fed by ``DeviceFeeder(mesh=, plan=)``; then
              the same steps with no mesh from the same initial state and
              batches.  Losses and every updated parameter must be
              bit-equal, the flash forward and backward must launch at least
              ``train_launches_per_step`` a step, peak memory under 80 GB;
              logs s/step beside phase 5's.  (b) int8 compression of the
              embedding's gradient at (a)'s state (49152 x 3072 f32):
              nearest codes equal to the CPU's and the scale bit-equal, the
              error within ``compression_error_bound``, stochastic rounding
              from a seeded CUDA generator unbiased to 1e-3 of the scale,
              ``compressed_psum`` over the mesh equal to dequantize of
              quantize; each timed.  The process group is destroyed.  (c) the
              dry run on the production meshes (``DIST_DRYRUN`` on ``single``
              and ``multi``, counts on meta): per-device argument bytes,
              ``fits_hbm_80g`` and FLOPs a device.
8. a ``{"kernels": [...]}`` line with each kernel's launches on the main
   paths ((a) and (b) of every model, the augment phase, the steps of the
   train runs, of the service runs and of the sharded run; the checks are
   reported on their own lines) and its times, then the card line, then
   ``{"ok": true, ...}``.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The card's peaks (H100 SXM, dense) and the FLOP and byte formulas of the
# kernels, one copy in the port (``repro_torch.launch.flops``).
try:
    from repro_torch.launch.flops import (HBM_BYTES_PER_S, PEAK_FLOPS, adamw_bytes,
                                          adamw_flops, augment_bound, bound, conv_bwd_flops,
                                          conv_bytes, conv_flops,
                                          decode_bytes, decode_flops, flash_flops,
                                          norm_bwd_flops, norm_bytes, norm_flops,
                                          router_bwd_flops, router_bytes, router_flops,
                                          ssd_bwd_flops, ssd_bwd_product_flops, ssd_flops,
                                          ssd_product_flops)
    from repro_torch.launch.flops import visible_pairs as _visible_pairs
except ModuleNotFoundError as e:  # the script alone: main() says that the port is missing
    if e.name != "repro_torch":
        raise
TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # tests/test_kernels.py
# bf16 edges of the Hopper flash kernels (blocks of 128 query rows, key
# tiles of 128 and 64 in the forward, 128-key blocks and 64-row q tiles in
# the backward): (name, B, Sq, Sk, Hq, Hkv, D, options).  Each runs the
# forward at both tiles and the backward.
BF16_EDGES = (
    ("bf16_S1000_window300", 1, 1000, 1000, 24, 2, 128, dict(window=300)),
    ("bf16_ragged_S300", 2, 300, 300, 4, 2, 64, dict()),
    ("bf16_q_offset_SqneSk", 1, 64, 320, 4, 2, 64, dict(q_offset=256)),
    ("bf16_q_offset_window", 1, 200, 1000, 8, 2, 128, dict(q_offset=800, window=300)),
    ("bf16_noncausal_SqneSk", 1, 64, 320, 4, 4, 64, dict(causal=False)),
    ("bf16_mha_16x16", 1, 1024, 1024, 16, 16, 128, dict()),
    ("bf16_D64", 2, 256, 256, 8, 2, 64, dict()),
    ("bf16_mqa_D32", 1, 192, 192, 6, 1, 32, dict()),
    ("bf16_softcap30", 1, 128, 128, 4, 2, 64, dict(softcap=30.0)),
)
# Cases of the Hopper decode and SSD kernels' redesign.  They draw from a
# generator of their own (NEW_CASES_SEED), after every earlier case, so that
# each earlier case keeps its inputs.  Decode: moonshot's heads (16/16, G = 1,
# no window) at the serve shape and a long cache, and a long context on the
# card's plan (num_splits None); (name, B, S, Hq, Hkv, D, dtype, lengths,
# options).  SSD: the main path's dtype, bf16, in the mixer's regime.
NEW_CASES_SEED = 15
DECODE_CASES_NEW = (
    ("moonshot_serve_B8_S256", 8, 256, 16, 16, 128, "bfloat16", [96] * 8, dict()),
    ("moonshot_long_B8_S4096", 8, 4096, 16, 16, 128, "bfloat16",
     [1, 64, 65, 1000, 2048, 3000, 4095, 4096], dict()),
    ("long_B1_S32768_card_plan", 1, 32768, 24, 2, 128, "bfloat16", [32768],
     dict(splits=(None,))),
)
SSD_CASES_NEW = (
    ("mamba2_prefill_mamba2_regime_bf16", 1, 8192, 80, 64, 128, "bfloat16",
     dict(groups=1, regime="mamba2")),
)
# The decode plan's sweep: device time per call at each split count of
# SWEEP_SPLITS beside the count the card's plan picks, at the long caches of
# the main path's heads (name, B, S, Hq, Hkv, lengths, window; D = 128,
# bf16).  Its inputs come from a generator of their own, after every case.
SWEEP_SPLITS = (1, 2, 4, 8, 16, 32, 64, 128)
SPLIT_SWEEP = (
    ("long_B8_S8192", 8, 8192, 24, 2, [1, 100, 4096, 4097, 5000, 8000, 8192, 3000], 4096),
    ("long_B1_S32768", 1, 32768, 24, 2, [32768], 0),
    ("moonshot_long_B8_S4096", 8, 4096, 16, 16, [1, 64, 65, 1000, 2048, 3000, 4095, 4096], 0),
)
SWEEP_SEED = 16
# Cases of kimi-k2's head dim 112 and of the router and augment redesigns.
# They draw from a generator of their own (D112_REDESIGN_SEED), after every earlier
# case and before the split sweep.  Flash (name, B, Sq, Sk, Hq, Hkv, D, dtype,
# options; all_tiles: every forward tile of the dtype): kimi's prefill shape
# (64/8 heads, causal), a ragged S and a window, and f32 on the scalar
# route; its backward at small S.  Decode (name, B, S, Hq, Hkv, D, dtype,
# lengths, options): kimi's serve shape and a long cache on the mma.sync
# route (G = 8), f32 on the CUDA-core route.  Router (name, T, E, k): T = 1,
# 65 and 4097 (not multiples of the kernel's 32-token blocks) at moonshot's
# and kimi's routing.  Augment (name, B, H, W, C, out_h, out_w), flips on
# every other image: C = 4; an odd W and out_w, so rows start unaligned;
# a row over the kernel's 2048-byte staging piece; C = 7 (the generic path).
D112_REDESIGN_SEED = 17
FLASH_CASES_D112 = (
    ("kimi_prefill_S4096_D112", 1, 4096, 4096, 64, 8, 112, "bfloat16", dict(iters=5)),
    ("kimi_ragged_S1000_D112", 1, 1000, 1000, 64, 8, 112, "bfloat16", dict(all_tiles=True)),
    ("kimi_window300_S1000_D112", 1, 1000, 1000, 64, 8, 112, "bfloat16",
     dict(window=300, all_tiles=True)),
    ("f32_window300_S1000_D112", 1, 1000, 1000, 16, 2, 112, "float32",
     dict(window=300, all_tiles=True)),
)
FLASH_BWD_CASES_D112 = (
    ("kimi_bwd_S512_D112", 1, 512, 512, 64, 8, 112, "bfloat16", dict()),
    ("kimi_bwd_ragged_S300_window64_D112", 2, 300, 300, 16, 2, 112, "bfloat16",
     dict(window=64)),
    ("f32_bwd_S300_window100_D112", 1, 300, 300, 16, 2, 112, "float32", dict(window=100)),
)
DECODE_CASES_D112 = (
    ("kimi_serve_B8_S256_D112", 8, 256, 64, 8, 112, "bfloat16", [96] * 8, dict()),
    ("kimi_long_B8_S4096_D112", 8, 4096, 64, 8, 112, "bfloat16",
     [1, 64, 65, 1000, 2048, 3000, 4095, 4096], dict()),
    ("kimi_f32_B2_S300_D112", 2, 300, 64, 8, 112, "float32", [77, 300],
     dict(window=100, splits=(1, 4, None))),
)
ROUTER_CASES_NEW = tuple((f"T{T}_E{E}_k{k}", T, E, k)
                         for T in (1, 65, 4097) for E, k in ((64, 6), (384, 8)))
AUGMENT_CASES_NEW = (
    ("C4_B16_96x80x4_64x48", 16, 96, 80, 4, 64, 48),
    ("odd_W_B16_67x131x3_45x99", 16, 67, 131, 3, 45, 99),
    ("wide_row_B2_40x1500x3_33x1111", 2, 40, 1500, 3, 33, 1111),
    ("C7_B4_33x35x7_20x21", 4, 33, 35, 7, 20, 21),
)
# Cases of the enc-dec (whisper-large-v3) and VLM (qwen2-vl-2b) slice, at
# routes no earlier case ran at these sizes.  They draw from a generator of
# their own (ENCDEC_VLM_SEED), after the flash backward cases.  Flash (name,
# B, Sq, Sk, Hq, Hkv, D, dtype, options):
# whisper's encoder (non-causal, S = 1500 = 11 x 128 + 92, so every key
# tile is live and the last one ragged, and B = 8, so the TMA map's batch
# boundary is live) and its cross-attention (448 decoder rows, 3.5 query
# tiles, over 1500 encoder rows, non-causal), bf16 and f32; qwen2-vl's
# prefill (12/2 heads, G = 6, causal); whisper's decoder self-attention
# (causal, S = 448, 3.5 query tiles, B = 8).  Decode (name, B, S, Hq, Hkv,
# D, dtype, lengths, options): whisper's cross decode (every row's length the
# encoder's 1500, G = 1: the CUDA-core route), qwen2-vl's serve shape (G =
# 6, rounded up to 8 rows on the CUDA-core route) at ragged lengths, and
# whisper's self decode (a 448-row cache, G = 1, lengths up to the 64
# serving steps: one split of the card's plan).  Each
# flash case also runs twice for bit-equal outputs and is timed on the device;
# all_tiles: every forward tile of the dtype.
ENCDEC_VLM_SEED = 20
FLASH_CASES_ENCDEC_VLM = (
    ("whisper_encoder_S1500", 8, 1500, 1500, 20, 20, 64, "bfloat16",
     dict(causal=False, all_tiles=True)),
    ("whisper_encoder_S1500_f32", 8, 1500, 1500, 20, 20, 64, "float32",
     dict(causal=False, all_tiles=True, iters=5)),
    ("whisper_cross_Sq448_Sk1500", 8, 448, 1500, 20, 20, 64, "bfloat16",
     dict(causal=False, all_tiles=True)),
    ("whisper_cross_Sq448_Sk1500_f32", 8, 448, 1500, 20, 20, 64, "float32",
     dict(causal=False, all_tiles=True, iters=5)),
    ("qwen2vl_prefill_S4096", 1, 4096, 4096, 12, 2, 128, "bfloat16", dict(iters=5)),
    ("whisper_decoder_self_S448", 8, 448, 448, 20, 20, 64, "bfloat16", dict(all_tiles=True)),
)
DECODE_CASES_ENCDEC_VLM = (
    ("whisper_cross_L1500", 8, 1500, 20, 20, 64, "bfloat16", [1500] * 8, dict()),
    ("qwen2vl_serve_G6", 8, 256, 12, 2, 128, "bfloat16", [1, 17, 64, 65, 100, 128, 200, 256],
     dict()),
    ("whisper_self_B8_S448", 8, 448, 20, 20, 64, "bfloat16", [1, 4, 33, 64, 64, 64, 64, 64],
     dict()),
)
# Cases of the backward kernels.  They draw from a generator of their own
# (BWD_SEED), after every earlier case and before the split sweep.  SSD
# (name, B, L, H, P, N, dtype, options): mamba2-2.7b's mixer at the train
# shape in the model's precision (f32 x, B, C) and in bf16, both in the
# mixer's regime; two groups of four heads over a ragged L (300 = 4 x 64 +
# 44) with a non-zero dh_final; a ragged L at the mixer's shape; P = 32, N =
# 16 in bf16 with dh_final.  Router (name, T, E, k, options): moonshot's
# train shape, kimi's routing, a serve batch, ties.
BWD_SEED = 18
SSD_BWD_CASES = (
    ("mamba2_train_S8192", 1, 8192, 80, 64, 128, "float32", dict(groups=1, regime="mamba2")),
    ("mamba2_train_S8192_bf16", 1, 8192, 80, 64, 128, "bfloat16",
     dict(groups=1, regime="mamba2")),
    ("grouped_B2_G2_ragged_L300_dh", 2, 300, 8, 64, 64, "float32",
     dict(groups=2, dh_final=True)),
    ("ragged_L8000_mamba2_regime", 1, 8000, 80, 64, 128, "float32",
     dict(groups=1, regime="mamba2")),
    ("P32_N16_L100_dh_bf16", 1, 100, 4, 32, 16, "bfloat16", dict(dh_final=True)),
)
# The SSD backward's redesign (head blocks of kernel.HEAD_BLOCK heads of one
# group, summed on chip): a group of 12 heads (blocks of 8 and 4) over a
# ragged L, f32, with dh_final, on a generator of its own after every earlier
# case.
BWD_REDESIGN_SEED = 19
SSD_BWD_CASES_NEW = (
    ("grouped_G2_hpg12_L500_dh", 1, 500, 24, 64, 128, "float32", dict(groups=2, dh_final=True)),
)
ROUTER_BWD_CASES = (
    ("moonshot_train_T4096", 4096, 64, 6, dict()),
    ("kimi_T4096", 4096, 384, 8, dict()),
    ("serve_T8", 8, 64, 6, dict()),
    ("ties_T1000", 1000, 64, 6, dict(ties=True)),
)
# Cases of the slice that trains whisper-large-v3 and qwen2-vl-2b and serves
# and trains jamba-v0.1-52b, at routes no earlier case ran at these shapes.
# They draw from a generator of their own (SLICE10_SEED), after every earlier
# case and before the split sweep.  Flash backward (name, B, Sq, Sk, Hq, Hkv,
# D, dtype, options), bf16 at the train shapes: whisper's encoder
# (non-causal, B = 8, S = 1500: a ragged last dQ tile of BWD_Q_PAD rows and
# a ragged key tail at every batch boundary), its cross-attention (448 query
# rows, 3.5 tiles, over 1500 keys, non-causal) and its decoder
# self-attention (causal), qwen2-vl's attention (12/2: G = 6) and jamba's
# (32/8: G = 4); f32 on the scalar route, non-causal Sq = 100 over Sk = 300
# and G = 6.  Each records its device time beside SDPA's backward.
SLICE10_SEED = 21
# (name, B, L, d_inner, G N, heads, x dtype, w dtype) of the causal conv's
# cases: mamba2-2.7b's train shape (B 4, L 2048: Ch 5376, bf16 activations,
# f32 params, as the benchmark's cell runs it) and jamba-v0.1-52b's mixer (B
# 1, L 4096, as its train run here: Ch 8224); then the edges: L of 1 and 5
# (one short strip, ending within the conv's 3 rows of L), 130 (a strip of a
# second block), f32 activations with bf16 weights, bf16 both, and widths no
# multiple of the vector (the element-wise route).
CONV_SEED = 22
CONV_CASES = (
    ("mamba2_train_B4_L2048", 4, 2048, 5120, 128, 80, "bfloat16", "float32"),
    ("jamba_train_B1_L4096", 1, 4096, 8192, 16, 128, "bfloat16", "float32"),
    ("L1", 2, 1, 256, 16, 8, "bfloat16", "float32"),
    ("L5_f32", 2, 5, 256, 16, 8, "float32", "float32"),
    ("L130_bf16_weights", 2, 130, 256, 16, 8, "float32", "bfloat16"),
    ("L130_bf16_both", 2, 130, 256, 16, 8, "bfloat16", "bfloat16"),
    ("unaligned_widths_L300", 2, 300, 250, 13, 5, "bfloat16", "float32"),
)
# of the largest |reference| entry, beside one rounding to the output's
# dtype: the kernels sum in f32 in another order than f64 (the f32 forward
# in the plain version's own order, so within this of it too)
CONV_TOL = 1e-5
# (name, leading shape, width D, gate row width (None: the plain form), x
# dtype, gate dtype, w dtype) of the RMSNorm's cases: mamba2-2.7b's train
# shape as the benchmark's cell runs it (4 x 2048 rows: the gated norm at
# 5120 over the scan's f32 y and z read from the 10576-wide in_proj row, the
# block norm at 2560 in bf16, f32 scales), jamba-v0.1-52b's train run (1 x
# 4096: the gated norm at 8192 from a 16544-wide row, the block norm at
# 4096), qwen3-14b's qk-norm (head dim 128 over 40 heads of 4096 tokens: 16
# threads a row, 8 rows a block), decode at B = 8 (one token a row, y f32 as
# the recurrence leaves it), then the edges: the whole f32 forms, bf16 y,
# bf16 scales, the widest width (16384: 8 chunks a thread), kimi's 7168
# (224 threads), narrow rows whose count is no multiple of a block's rows,
# and widths and strides no multiple of a chunk (the element-wise route).
NORM_SEED = 23
NORM_EPS = 1e-6
NORM_CASES = (
    ("mamba2_gated_B4_L2048", (4, 2048), 5120, 10576, "float32", "bfloat16", "float32"),
    ("mamba2_ln1_B4_L2048", (4, 2048), 2560, None, "bfloat16", None, "float32"),
    ("jamba_gated_B1_L4096", (1, 4096), 8192, 16544, "float32", "bfloat16", "float32"),
    ("jamba_ln_B1_L4096", (1, 4096), 4096, None, "bfloat16", None, "float32"),
    ("qk_norm_D128", (1, 4096, 40), 128, None, "bfloat16", None, "float32"),
    ("decode_gated_B8", (8, 1), 5120, 10576, "float32", "bfloat16", "float32"),
    ("decode_ln1_B8", (8, 1), 2560, None, "bfloat16", None, "float32"),
    ("gated_f32", (2, 300), 1024, 2200, "float32", "float32", "float32"),
    ("gated_bf16_y", (2, 300), 1024, 2200, "bfloat16", "bfloat16", "float32"),
    ("plain_f32_bf16_w", (2, 300), 3072, None, "float32", None, "bfloat16"),
    ("plain_D16384", (2, 64), 16384, None, "bfloat16", None, "bfloat16"),
    ("plain_D7168", (3, 50), 7168, None, "bfloat16", None, "float32"),
    ("narrow_D64_13_rows", (13,), 64, None, "bfloat16", None, "float32"),
    ("gated_unaligned_D250", (3, 70), 250, 517, "float32", "bfloat16", "float32"),
    ("plain_unaligned_D1001", (5, 7), 1001, None, "bfloat16", None, "float32"),
)
# the forward: at least this share of a bf16 output within one bf16 step of
# the plain version in f64 (bit-equal but where the f32 chain's last bit
# moves the rounding); an f32 output, and each gradient, within one step of
# its dtype plus NORM_TOL of its largest entry (``conv_err``'s measure)
NORM_ULP_SHARE = 0.999
NORM_MAX_STEPS = 2  # and no bf16 entry further off (a wrong row or tail store)
NORM_TOL = 1e-5
# (name, leaf shape, p dtype, g dtype, moment dtype, clip scale) of the AdamW
# update's cases: the largest leaf of each benchmark cell (mamba2-2.7b's
# stacked in_proj, 64 x 2560 x 10576, and starcoder2-3b's w1, 30 x 3072 x
# 12288, both trained in f32), a clipped step, a 1-D leaf (not decayed), bf16
# moments, bf16 leaves and gradients, and sizes no multiple of a chunk (the
# scalar tail).  Hyperparameters of a third step, lr 1e-3 so that the step
# stands well above the rounding of p.
ADAMW_SEED = 24
ADAMW_CASES = (
    ("mamba2_in_proj", (64, 2560, 10576), "float32", "float32", "float32", 1.0),
    ("starcoder2_w1", (30, 3072, 12288), "float32", "float32", "float32", 0.25),
    ("vector_1d", (2560,), "float32", "float32", "float32", 1.0),
    ("bf16_moments", (1000, 1003), "float32", "float32", "bfloat16", 0.5),
    ("bf16_leaf_grad", (1000, 1003), "bfloat16", "bfloat16", "float32", 1.0),
    ("bf16_all_odd", (77, 13), "bfloat16", "bfloat16", "bfloat16", 0.5),
    ("f32_odd", (7, 9), "float32", "float32", "float32", 1.0),
)
ADAMW_HYPER = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, c1=0.271, c2=0.142625,
                   weight_decay=0.1)
# of the largest entry (of the step lr * delta, for p), beside one step of
# the output's dtype: a few f32 roundings of the terms against f64
ADAMW_TOL = 1e-6
ADAMW_INSTANTIATIONS = 8  # p, g and the moments each f32 or bf16
FLASH_BWD_CASES_SLICE10 = (
    ("whisper_encoder_bwd_S1500", 8, 1500, 1500, 20, 20, 64, "bfloat16", dict(causal=False)),
    ("whisper_cross_bwd_Sq448_Sk1500", 8, 448, 1500, 20, 20, 64, "bfloat16",
     dict(causal=False)),
    ("whisper_decoder_self_bwd_S448", 8, 448, 448, 20, 20, 64, "bfloat16", dict()),
    ("qwen2vl_bwd_S4096", 1, 4096, 4096, 12, 2, 128, "bfloat16", dict()),
    ("jamba_bwd_S4096", 1, 4096, 4096, 32, 8, 128, "bfloat16", dict()),
    ("f32_noncausal_Sq100_Sk300", 2, 100, 300, 4, 4, 64, "float32", dict(causal=False)),
    ("f32_G6_S200", 1, 200, 200, 12, 2, 64, "float32", dict()),
)
# jamba's attention served: the prefill (S = 8192, 32/8, causal; run twice and
# timed on the device beside SDPA) and decode at the serve batch (B = 8, G =
# 4: ``rows_per_block`` sends it to the CUDA-core route with 4 rows) at
# lengths up to ServeEngine's 96 (a 64-token prompt and 32 new tokens).
FLASH_CASES_SLICE10 = (
    ("jamba_prefill_S8192", 1, 8192, 8192, 32, 8, 128, "bfloat16", dict(iters=5)),
)
DECODE_CASES_SLICE10 = (
    ("jamba_serve_G4", 8, 256, 32, 8, 128, "bfloat16", [9, 20, 33, 47, 64, 72, 88, 96], dict()),
)
# jamba's mixer (128 heads of P = 64, N = 16, one group, chunk 128, in the
# mixer's regime): the scan at the prefill's L = 8192 in bf16 (served with
# bf16 parameters, the mixer hands the scan bf16 x, B and C), and the scan
# and its backward at the train shape L = 4096 in f32 (trained with f32
# parameters: the train step's forward runs ssd_chunk_out on the f32 route).
SSD_CASES_SLICE10 = (
    ("jamba_prefill_L8192_bf16", 1, 8192, 128, 64, 16, "bfloat16",
     dict(groups=1, regime="mamba2")),
    ("jamba_train_L4096_f32", 1, 4096, 128, 64, 16, "float32",
     dict(groups=1, regime="mamba2")),
)
SSD_BWD_CASES_SLICE10 = (
    ("jamba_train_L4096", 1, 4096, 128, 64, 16, "float32", dict(groups=1, regime="mamba2")),
)
# jamba's routing (16 experts, top-2; no earlier case has E < 64 beside the
# JAX suite's small T): a serve batch, the train shape, a T past it that is
# not a multiple of the router's 32-token blocks and the prefill's T = 8192;
# forward and backward.
ROUTER_CASES_SLICE10 = tuple((f"jamba_T{T}_E16_k2", T, 16, 2) for T in (8, 4096, 4097, 8192))
# Kernels of the Hopper redesigns and of the backwards of the SSD scan and
# the router: ptxas must report no spill for any of them, nor for any
# instantiation at head dim 112 (``no_spill``).
NO_SPILL_KERNELS = ("decode_kernel", "decode_merge_kernel", "ssd_chunk_state", "ssd_state_pass",
                    "ssd_chunk_out", "route_blocks", "add_prefix", "augment_rows",
                    "ssd_bwd_chunk_state", "ssd_bwd_state_pass", "ssd_bwd_chunk",
                    "ssd_bwd_group_sum", "ssd_bwd_head_sum", "route_bwd",
                    "causal_conv_fwd_kernel", "causal_conv_bwd_kernel", "causal_conv_bwd_reduce",
                    "rms_norm_fwd_kernel", "rms_norm_bwd_kernel", "rms_norm_bwd_reduce",
                    "adamw_update_kernel")
# bf16 only: largest error in a row over that row's RMS in the f32 plain
# output.  A bf16 step is 2^-8 of a value, so a right kernel stays near
# 2^-8 * (row max / row RMS), about 0.015; one key too many or too few in a
# window of W keys moves a row by about 1/sqrt(W) of its RMS.
REL_TOL = 3e-2
PREFILL_S = 8192  # > starcoder2-3b's 4096 window, so the window is live
SSD_TOL = 5e-4  # tests/test_kernels.py::TestSSDScan (atol and rtol)
SSD_CHUNK_TOL = 1e-3  # ... its chunk-invariance test
BF16_STEP = 2.0 ** -8  # largest relative rounding error of a bf16 value
GATE_TOL = 1e-6  # tests/test_kernels.py::TestMoERouter
AUG_TOL = 1e-5  # tests/test_kernels.py::TestFusedAugment (atol and rtol)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# The train runs of phase 5: (arch, config changes, B, S, steps).  moonshot is
# cut to 4 of its 48 layers (1 dense + 3 MoE): 2.41 B parameters, 38.5 GB of
# f32 parameters, gradients and AdamW state; the whole model's 27.5 B would
# need 440 GB.  whisper-large-v3 is not cut: B = 8 clips of 1500 encoder
# frames (f32 ``enc_embeds``, 61.4 MB a batch) and 448 decoder tokens, 1.535 B
# parameters, 24.6 GB.  qwen2-vl-2b is not cut: S = 4096 from ``embeds`` at
# Qwen2-VL's text-image-text positions, 1.544 B parameters, 24.7 GB.
# jamba-v0.1-52b is cut to 2 layers at period 2 (attn_offset 1): layer 0
# mamba2 with the dense SwiGLU, layer 1 attention with the MoE (16 experts,
# top-2), every width the published one: 3.675 B parameters, 58.8 GB.  One
# whole 7:1 period (8 layers) is 13.27 B parameters, 212 GB to train in f32;
# 4 layers at period 4 would need 110 GB.
TRAIN_RUNS = (
    ("starcoder2-3b", {}, 1, 8192, 6),
    ("mamba2-2.7b", {}, 1, 8192, 4),
    ("moonshot-v1-16b-a3b", {"num_layers": 4}, 1, 4096, 4),
    ("whisper-large-v3", {}, 8, 448, 4),
    ("qwen2-vl-2b", {}, 1, 4096, 4),
    ("jamba-v0.1-52b", {"num_layers": 2, "attn_period": 2, "attn_offset": 1}, 1, 4096, 4),
)
# The f32 train checks' changes beyond 2 layers (``phase_train_check``):
# whisper's encoder at 2 layers too; jamba dropless (moonshot's serving
# check's capacity factor), so that no near-tie of the router's logits
# between the card and the CPU decides which tokens drop.
TRAIN_CHECK = {"whisper-large-v3": {"encoder_layers": 2},
               "jamba-v0.1-52b": {"capacity_factor": 64.0}}
# The f32 train-step check (2 layers, card kernels against the CPU plain
# route): the loss and the gradient norm within a relative 1e-5 and 1e-4
# (f32 sums in another order through two layers and a 49152-wide head), the
# updated parameters within 1e-5, a tenth of the check's learning rate: a
# gradient entry of the wrong sign moves its parameter by 2 x lr = 2e-4.
# AdamW's first step moves an entry by lr * g / (|g| + eps), which turns on
# the rounding where |g| is at the f32 noise of two summation orders; the
# check's eps of 1e-6 bounds that at lr * noise / 1e-6.
CHECK_LR = 1e-4
CHECK_EPS = 1e-6
CHECK_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "params": 1e-5}


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def log_clocks(label: str) -> None:
    """Prints the card's SM clock and its maximum as nvidia-smi reads them
    (a card under sustained load may clock below its maximum)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"not read ({e.__class__.__name__})"
    log(f"clocks {label}: {out}")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms (CUDA events around ``iters``
    calls, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20):
    """Device time of one ``fn()`` call in ms from ``torch.profiler`` over
    ``iters`` calls (after one warm-up call).  Unlike ``time_ms`` it does not
    count the host's time between launches.  The profiler can drop the
    records of a session's first launches, so each kernel counts at its mean
    time per recorded launch, times its launches per call (its records over
    ``iters``, rounded up): right while fewer than ``iters`` of a kernel's
    launches are dropped.  "not measured" when the profiler saw no device
    time."""
    import math

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = per_call_us([(e.self_device_time_total, e.count) for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and e.count], iters)
    return total / 1e3 if total else "not measured"


def per_call_us(records, calls: int) -> float:
    """Device time of one call from a profile of ``calls`` calls, given each
    kernel's (recorded time, recorded launches): its mean time a launch
    times its launches a call, the records over ``calls`` rounded up."""
    return sum(t / n * math.ceil(n / calls) for t, n in records if n)


def single_call_ms(fn, reps: int = 5) -> float:
    """The least time of one ``fn()`` call in ms over ``reps`` calls, each
    between CUDA events after a synchronisation: the device time of a call
    that runs for milliseconds plus the few microseconds until its first
    launch reaches the card."""
    import torch

    fn()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def profile_device(label: str, fn) -> list:
    """Runs ``fn`` once under ``torch.profiler`` and prints the device time
    of the kernels it ran against the wall time (the profiler's own cost
    makes the idle share an upper bound), plus the costliest kernels.
    Returns the names of every kernel that ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    log(dict(profile=label, wall_s=wall, device_busy_s=busy,
             device_idle_share=(1 - busy / wall) if busy else "not measured",
             top_kernels=[dict(name=e.key[:80], ms=e.self_device_time_total / 1e3,
                               calls=e.count,
                               ms_per_call=e.self_device_time_total / 1e3 / e.count)
                          for e in top]))
    return [e.key for e in kernels]


def row_rel_err(out, want32) -> float:
    """Largest |out - want32| of a row (all dims but the last) over the RMS
    of that row of ``want32``."""
    err = (out.float() - want32).abs().amax(-1)
    rms = want32.pow(2).mean(-1).sqrt()
    return float((err / rms.clamp_min(1e-12)).max())


def grad_allclose(got, want32, dtype: str) -> float:
    """The largest |got - want| of a gradient over ``tol + tol * |want|``:
    the JAX suite's ``assert_allclose`` with atol = rtol = the forward's
    tolerance (gradients are sums that the inputs do not bound, so the
    allowance grows with the value); bf16 against the f32 reference rounded
    to bf16, as in the forward cases.  1 or less passes."""
    tol = TOL[dtype]
    want = want32.to(got.dtype).float()
    return float(((got.float() - want).abs() / (tol + tol * want.abs())).max())


def grad_row_rel_err(got, want32) -> float:
    """The largest error of a row over that row's RMS in ``want32``, floored
    at the whole tensor's RMS: a query that sees one key has an exact dq of
    0, so its own RMS is only rounding."""
    err = (got.float() - want32).abs().amax(-1)
    rms = want32.pow(2).mean(-1).sqrt().clamp_min(float(want32.pow(2).mean().sqrt()))
    return float((err / rms.clamp_min(1e-30)).max())


def achieved_tflops(flops: float, ms: float) -> float:
    """FLOP/s of ``flops`` done in ``ms`` milliseconds, in TFLOP/s."""
    return flops / (ms * 1e-3) / 1e12


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------
def phase_env():
    import torch

    from repro_torch.kernels import _build

    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    paths = _build.build(*_build.SOURCES)
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(paths)} "
        f"(per source: { {k: round(v, 1) for k, v in _build.build_seconds.items()} })")
    hopper_spills = {}
    for name in _build.SOURCES:
        lines = _build.build_log(name).splitlines()
        regs = [ln.strip() for ln in lines if "registers" in ln]
        spills = ptxas_spills(lines)
        log(f"ptxas {name}: {len(regs)} kernels; max "
            f"{max((int(r.split('Used ')[1].split()[0]) for r in regs), default=0)} registers; "
            f"spilling: {spills if spills else 'none'}")
        hopper_spills.update({k: v for k, v in spills.items() if no_spill(k)})
    if hopper_spills:
        raise SystemExit(f"ptxas: the Hopper kernels spill: {hopper_spills}")


def no_spill(kernel: str) -> bool:
    """Whether a kernel (``name<int args>`` as ``kernel_name`` gives it) must
    not spill: every ``*_sm90`` kernel, those of ``NO_SPILL_KERNELS``, and
    any instantiation at head dim 112."""
    name, _, args = kernel.partition("<")
    return (name.endswith("_sm90") or name in NO_SPILL_KERNELS
            or "112" in args.rstrip(">").split(","))


def kernel_name(mangled: str) -> str:
    """``name<int args>`` of an Itanium-mangled kernel symbol: the last name
    of its nested name and the integer template arguments."""
    import re

    rest = mangled[2:] if mangled.startswith("_Z") else mangled
    rest = rest[1:] if rest.startswith("N") else rest
    names = []
    while rest[:1].isdigit():
        n = int(re.match(r"\d+", rest).group())
        width = len(str(n))
        names.append(rest[width:width + n])
        rest = rest[width + n:]
    if not names:
        return mangled
    m = re.match(r"I((?:L[a-z]+\d+E)+)E", rest)
    args = re.findall(r"L[a-z]+(\d+)E", m.group(1)) if m else []
    return names[-1] + (f"<{','.join(args)}>" if args else "")


def ptxas_spills(lines) -> dict:
    """{kernel: ptxas's stack/spill line} for each kernel of a ``-Xptxas -v``
    log that spills (its lines follow "Compiling entry function '<name>'")."""
    import re

    out, current = {}, None
    for ln in lines:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            current = kernel_name(m.group(1))
        elif "spill" in ln and current and not re.search(
                r"\b0 bytes spill stores, 0 bytes spill loads", ln):
            out[current] = ln.strip()
    return out


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------
def flash_case(name, B, Sq, Sk, Hq, Hkv, D, dtype, causal=True, window=0, softcap=0.0,
               q_offset=0, blocks=None, iters=10, library=True, twice=False, gen=None):
    """The forward kernel at each tile of ``blocks`` (default: the dtype's
    default tile) against its plain version in f32 on the same inputs.
    ``twice``: the first tile also runs a second time and must give a
    bit-equal output, and the kernel and SDPA are also timed on the device
    (``device_ms``, ``library_device_ms``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention.kernel import TILES

    dt = getattr(torch, dtype)
    blocks = blocks or TILES[dt][:1]
    q = torch.randn((B, Sq, Hq, D), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, Sk, Hkv, D), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, Sk, Hkv, D), generator=gen, device="cuda").to(dt)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    # the plain version computes in f32 and rounds only its output
    want32 = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    want = want32.to(dt).float()
    outs = [flash_attention(q, k, v, block_q=bq, block_k=bk, **kw) for bq, bk in blocks]
    torch.cuda.synchronize()
    err = max(float((o.float() - want).abs().max()) for o in outs)
    rel = max(row_rel_err(o, want32) for o in outs)
    spread = max(float((o.float() - outs[0].float()).abs().max()) for o in outs)
    tol = TOL[dtype]
    rel_tol = REL_TOL if dtype == "bfloat16" else None
    ok = (err <= tol and spread <= tol and (rel_tol is None or rel <= rel_tol)
          and all(bool(torch.isfinite(o).all()) for o in outs))
    bq, bk = blocks[0]

    def kernel():
        return flash_attention(q, k, v, block_q=bq, block_k=bk, **kw)

    extra = {}
    if twice:
        extra["bit_equal_across_runs"] = torch.equal(kernel(), outs[0])
        ok = ok and extra["bit_equal_across_runs"]
        extra["device_ms"] = device_ms(kernel, iters)
    kernel_ms = time_ms(kernel, iters)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, **kw), max(2, iters // 5), 1)
    library_ms = None
    if library and softcap == 0.0:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window > 0 or q_offset or (causal and Sq != Sk):
            qp = q_offset + torch.arange(Sq, device="cuda")[:, None]
            kp = torch.arange(Sk, device="cuda")[None, :]
            mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
            if causal:
                mask &= kp <= qp
            if window > 0:
                mask &= kp > qp - window

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)

        library_ms = time_ms(sdpa, iters)
        if twice:
            extra["library_device_ms"] = device_ms(sdpa, iters)
    flops = flash_flops(B, Sq, Sk, Hq, D, causal, window, q_offset)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    rec = dict(kernel="flash_attention", case=name,
               shape=dict(B=B, Sq=Sq, Sk=Sk, Hq=Hq, Hkv=Hkv, D=D, causal=causal,
                          window=window, softcap=softcap, q_offset=q_offset,
                          blocks=[list(b) for b in blocks]),
               dtype=dtype, max_abs_err=err, block_spread=spread, tol=tol,
               row_rel_err=rel, rel_tol=rel_tol,
               kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, tflops=achieved_tflops(flops, kernel_ms),
               bound_share=bound_ms / kernel_ms, **extra, ok=ok)
    log(rec)
    del want32, want, outs
    torch.cuda.empty_cache()
    return rec


def decode_case(name, B, S, Hq, Hkv, D, dtype, lengths, window=0, splits=(None, 8),
                block_s=256, iters=20, gen=None):
    """decode_attention at each split count of ``splits`` (None: the card's
    plan) against its plain version in f32 on the same inputs; the first
    split count is timed (``kernel_ms`` back to back, ``device_ms`` by the
    profiler, as SDPA's ``library_ms`` and ``library_device_ms``) and run
    twice to check that the two outputs are bit-equal."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref

    dt = getattr(torch, dtype)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dt)
    kc = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dt)
    vc = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dt)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    want32 = decode_attention_ref(q.float(), kc.float(), vc.float(), lens, window=window)
    want = want32.to(dt).float()
    outs = [decode_attention(q, kc, vc, lens, window=window, num_splits=ns, block_s=block_s)
            for ns in splits]
    ns0 = splits[0]

    def kernel():
        return decode_attention(q, kc, vc, lens, window=window, num_splits=ns0, block_s=block_s)

    bit_equal = torch.equal(kernel(), outs[0])
    torch.cuda.synchronize()
    err = max(float((o.float() - want).abs().max()) for o in outs)
    rel = max(row_rel_err(o, want32) for o in outs)
    spread = max(float((o.float() - outs[0].float()).abs().max()) for o in outs)
    tol = TOL[dtype]
    rel_tol = REL_TOL if dtype == "bfloat16" else None
    ok = (err <= tol and spread <= tol and (rel_tol is None or rel <= rel_tol) and bit_equal
          and all(bool(torch.isfinite(o).all()) for o in outs))
    kernel_ms = time_ms(kernel, iters)
    kernel_device_ms = device_ms(kernel, iters)
    plain_ms = time_ms(lambda: decode_attention_ref(q, kc, vc, lens, window=window),
                       max(2, iters // 5), 1)
    pos = torch.arange(S, device="cuda")[None, :]
    mask = pos < lens[:, None].long()
    if window > 0:
        mask &= pos > lens[:, None].long() - 1 - window
    qt = q[:, :, None, :]
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    m4 = mask[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m4, enable_gqa=True)

    library_ms = time_ms(sdpa, iters)
    library_device_ms = device_ms(sdpa, iters)
    visible = int(mask.sum())
    bound_ms, bound_by = bound(decode_flops(Hq, D, visible),
                               decode_bytes(visible, B, Hq, Hkv, D, q.element_size()), dtype)
    rec = dict(kernel="decode_attention", case=name,
               shape=dict(B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, window=window, splits=list(splits),
                          block_s=block_s, lengths=list(lengths)),
               dtype=dtype, max_abs_err=err, split_spread=spread, tol=tol,
               row_rel_err=rel, rel_tol=rel_tol, bit_equal_across_runs=bit_equal,
               kernel_ms=kernel_ms, device_ms=kernel_device_ms, plain_ms=plain_ms,
               library_ms=library_ms, library_device_ms=library_device_ms,
               bound_ms=bound_ms, bound_by=bound_by, ok=ok)
    log(rec)
    torch.cuda.empty_cache()
    return rec


def decode_split_sweep() -> None:
    """Logs, for each shape of ``SPLIT_SWEEP``, decode_attention's device
    time per call (``device_ms``) at each split count of ``SWEEP_SPLITS`` and
    the count that the card's plan (``split_count``) picks there."""
    import torch

    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention.ops import rows_per_block, split_count

    gen = torch.Generator(device="cuda").manual_seed(SWEEP_SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, B, S, Hq, Hkv, lengths, window in SPLIT_SWEEP:
        q = torch.randn((B, Hq, 128), generator=gen, device="cuda").bfloat16()
        kc = torch.randn((B, S, Hkv, 128), generator=gen, device="cuda").bfloat16()
        vc = torch.randn((B, S, Hkv, 128), generator=gen, device="cuda").bfloat16()
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        G = Hq // Hkv
        units = B * Hkv * -(-G // rows_per_block(torch.bfloat16, G))
        times = {ns: device_ms(lambda ns=ns: decode_attention(q, kc, vc, lens, window=window,
                                                              num_splits=ns))
                 for ns in SWEEP_SPLITS}
        log(dict(sweep="decode_splits", case=name, B=B, S=S, Hq=Hq, Hkv=Hkv, window=window,
                 plan=split_count(S, units, sms), device_ms=times))
        del q, kc, vc
    torch.cuda.empty_cache()


def ssd_allowed(want32, dtype):
    """Allowed |out - want32| of an ssd_scan output, elementwise: the JAX
    suite's 5e-4 (atol and rtol), widened for a bf16 output by its own
    rounding (at most 2^-8 of the value)."""
    rtol = SSD_TOL + (BF16_STEP if dtype == "bfloat16" else 0.0)
    return SSD_TOL + rtol * want32.abs()


def ssd_ratio(out, want32, dtype) -> float:
    """Largest |out - want32| over its allowance; 1 or less passes."""
    return float(((out.float() - want32).abs() / ssd_allowed(want32, dtype)).max())


def router_agreement(got, want) -> dict:
    """ids and slots must be equal, gates within GATE_TOL."""
    (gi, gg, gs), (wi, wg, ws) = got, want
    gate_err = float((gg - wg).abs().max())
    ids_equal, slots_equal = bool((gi == wi).all()), bool((gs == ws).all())
    return dict(ids_equal=ids_equal, slots_equal=slots_equal, gate_err=gate_err,
                ok=ids_equal and slots_equal and gate_err <= GATE_TOL)


# Tensor-core passes of each product in csrc/ssd_scan.cu, and the rate they
# run at: bf16 inputs on bf16 mma with C.B^T exact, C h and the state update
# on two bf16 pieces of their f32 operand, W x on three; f32 inputs on
# 3xTF32 (three tf32 passes a product).
SSD_PASSES = {"bfloat16": ("bfloat16", dict(cb=1, ch=2, state=2, wx=3)),
              "float32": ("tf32", dict(cb=3, ch=3, state=3, wx=3))}


def ssd_tensor_core_bound(B, L, H, P, N, chunk, groups, dtype) -> float:
    """ms for the products of an ssd_scan call as ``csrc/ssd_scan.cu`` takes
    them: each product's FLOPs times its passes (``SSD_PASSES``) at its
    tensor-core rate."""
    unit, passes = SSD_PASSES[dtype]
    flops = ssd_product_flops(B, L, H, P, N, chunk, groups)
    return sum(f * passes[k] for k, f in flops.items()) / PEAK_FLOPS[unit] * 1e3


def ssd_inputs(B, L, H, P, N, G, dtype, regime, gen):
    """x, dt, a, B, C, D on the card.  ``regime="jax"``: the JAX suite's
    scales (slow decay: dt = |0.1 n|, a = -|n|).  ``regime="mamba2"``: what
    mamba2-2.7b's mixer hands the scan - x, B, C after silu, dt = softplus
    of a unit normal (about 1), a = -(1..16) as ``init_mamba2`` sets it - so
    the log-decay inside a 128-token chunk reaches the hundreds."""
    import torch
    import torch.nn.functional as F

    dt_ = getattr(torch, dtype)

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    if regime == "mamba2":
        x = F.silu(randn((B, L, H, P))).to(dt_)
        dt = F.softplus(randn((B, L, H)))
        a = -torch.linspace(1.0, 16.0, H, device="cuda")
        Bm, Cm = F.silu(randn((B, L, G, N))).to(dt_), F.silu(randn((B, L, G, N))).to(dt_)
    else:
        x = randn((B, L, H, P), 0.5).to(dt_)
        dt = randn((B, L, H), 0.1).abs()
        a = -randn((H,)).abs()
        Bm, Cm = randn((B, L, G, N), 0.3).to(dt_), randn((B, L, G, N), 0.3).to(dt_)
    return x, dt, a, Bm, Cm, randn((H,))


def ssd_case(name, B, L, H, P, N, dtype, chunks=(128,), groups=None, regime="jax", iters=5,
             gen=None):
    """ssd_scan against its plain version (the token recurrence) in f64 on
    the same (rounded) inputs (``ssd_inputs``) for y and the final state;
    the first chunk is run twice and must give bit-equal outputs.  f64: in
    a row where C_i.B_i dt_i cancels D to about 1e-6 of itself (jamba's N =
    16 has some at L = 8192) the f32 recurrence errs by some percent of the
    row.  Timed back to back (``kernel_ms``) and on the device
    (``device_ms``)."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref

    G = groups or H
    x, dt, a, Bm, Cm, D = ssd_inputs(B, L, H, P, N, G, dtype, regime, gen)
    want, h_want = ssd_scan_ref(*(t.double() for t in (x, dt, a, Bm, Cm, D)))
    outs = [ssd_scan(x, dt, a, Bm, Cm, D, chunk=c) for c in chunks]
    torch.cuda.synchronize()
    err = max(float((y.double() - want).abs().max()) for y, _ in outs)
    ratio = max(ssd_ratio(y, want, dtype) for y, _ in outs)
    state_ratio = max(ssd_ratio(h, h_want, "float32") for _, h in outs)
    spread = max(float((y.float() - outs[0][0].float()).abs().max()) for y, _ in outs)
    rel = row_rel_err(outs[0][0], want) if dtype == "bfloat16" else None
    ok = (ratio <= 1.0 and state_ratio <= 1.0 and spread <= SSD_CHUNK_TOL
          and (rel is None or rel <= REL_TOL)
          and all(bool(torch.isfinite(y).all()) for y, _ in outs))
    c0 = chunks[0]
    again = ssd_scan(x, dt, a, Bm, Cm, D, chunk=c0)
    bit_equal = torch.equal(again[0], outs[0][0]) and torch.equal(again[1], outs[0][1])
    del again
    ok = ok and bit_equal
    kernel_ms = time_ms(lambda: ssd_scan(x, dt, a, Bm, Cm, D, chunk=c0), iters)
    kernel_device_ms = device_ms(lambda: ssd_scan(x, dt, a, Bm, Cm, D, chunk=c0), iters)
    plain_ms = time_ms(lambda: ssd_scan_ref(x, dt, a, Bm, Cm, D), 1, 1)
    flops = ssd_flops(B, L, H, P, N, c0, G)
    nbytes = ((2 * x.numel() + Bm.numel() + Cm.numel()) * x.element_size()
              + 4 * (dt.numel() + a.numel() + D.numel() + B * H * N * P))
    bound_ms, bound_by = bound(flops, nbytes, "float32")  # f32 arithmetic for either type
    tc_bound_ms = ssd_tensor_core_bound(B, L, H, P, N, c0, G, dtype)
    rec = dict(kernel="ssd_scan", case=name,
               shape=dict(B=B, L=L, H=H, P=P, N=N, G=G, chunks=list(chunks)), regime=regime,
               dtype=dtype,
               max_abs_err=err, err_over_allowed=ratio, state_err_over_allowed=state_ratio,
               chunk_spread=spread, tol=SSD_TOL, chunk_tol=SSD_CHUNK_TOL, row_rel_err=rel,
               rel_tol=REL_TOL if rel is not None else None, bit_equal_across_runs=bit_equal,
               kernel_ms=kernel_ms, device_ms=kernel_device_ms, plain_ms=plain_ms,
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
               bound_share=bound_ms / kernel_ms, tensor_core_bound_ms=tc_bound_ms, ok=ok)
    log(rec)
    del want, h_want, outs
    torch.cuda.empty_cache()
    return rec


def router_logits(T, E, ties, gen):
    """(T, E) f32 logits on the card.  ``ties``: integer logits, so many
    experts tie exactly."""
    import torch

    if ties:
        logits = torch.randint(0, 3, (T, E), generator=gen, device="cuda").float()
        logits[: T // 8] = 1.0  # rows where every expert ties
        return logits
    return torch.randn((T, E), generator=gen, device="cuda")


def router_case(name, T, E, k, ties=False, iters=20, gen=None):
    """moe_router against its plain version: ids and slots bit-exact, gates
    within 1e-6."""
    import torch

    from repro_torch.kernels.moe_router import moe_router, moe_router_ref

    logits = router_logits(T, E, ties, gen)
    got = moe_router(logits, k)
    want = moe_router_ref(logits, k)
    again = moe_router(logits, k)
    torch.cuda.synchronize()
    agree = router_agreement(got, want)
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
    kernel_ms = time_ms(lambda: moe_router(logits, k), iters)
    kernel_device_ms = device_ms(lambda: moe_router(logits, k), iters)
    plain_ms = time_ms(lambda: moe_router_ref(logits, k), max(2, iters // 5), 1)
    bound_ms, bound_by = bound(router_flops(T, E, k), router_bytes(T, E, k), "float32")
    rec = dict(kernel="moe_router", case=name, shape=dict(T=T, E=E, k=k, ties=ties),
               dtype="float32", max_abs_err=agree["gate_err"], tol=GATE_TOL,
               ids_equal=agree["ids_equal"], slots_equal=agree["slots_equal"],
               bit_equal_across_runs=bit_equal,
               kernel_ms=kernel_ms, device_ms=kernel_device_ms, plain_ms=plain_ms,
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
               ok=agree["ok"] and bit_equal)
    log(rec)
    return rec


def ssd_bwd_tensor_core_bound(B, L, H, P, N, chunk, groups, dtype) -> float:
    """ms for the products of an ssd_scan backward as the kernels take them
    on the tensor cores.  f32 inputs: every product in three tf32 passes
    (3xTF32) at 495 TFLOP/s.  bf16 inputs, exact in tf32, skip a pass per
    exact operand: C.B^T and G one pass, the products with K and P (dx, dB,
    dC) two, the state terms R^T B, R x and h dy three, the backward chunk
    state two, all at tf32's rate; the recomputed forward chunk state runs
    the forward's bf16 route, two passes at 989."""
    fl = ssd_bwd_product_flops(B, L, H, P, N, chunk, groups)
    tf32, bf = PEAK_FLOPS["tf32"], PEAK_FLOPS["bfloat16"]
    if dtype == "float32":
        return 3 * sum(fl.values()) / tf32 * 1e3
    term = fl["state"] / 5  # each of the five state terms
    tf_flops = fl["cb"] + fl["g"] + 2 * (fl["wdy"] + fl["dbdc"]) + (3 + 3 + 3 + 2) * term
    return (tf_flops / tf32 + 2 * term / bf) * 1e3


def ssd_bwd_scratch_bytes(B, L, H, P, N, groups, dtype) -> int:
    """Bytes of scratch an ssd_scan backward moves through device memory at
    least: the chunk states' buffer written and read by the forward's kernels
    1-2 and then, holding R, written by the backward chunk states, read and
    written by the reverse pass and read by the chunk kernel (6 times); the
    entering states written and read; the head blocks' partials of dB and dC
    written and read (kernel.bwd_scratch_bytes)."""
    import torch

    from repro_torch.kernels.ssd_scan.kernel import bwd_scratch_bytes

    by = bwd_scratch_bytes(B, L, H, groups or H, P, N, getattr(torch, dtype))
    return (6 * by["rstate"] + 2 * by["hp"] + 2 * (by["dB_part"] + by["dC_part"])
            + 2 * (by["cq"] + by["da_part"] + by["dD_part"]))


def ssd_bwd_ratio(got, want) -> float:
    """Largest |got - want| over allclose's allowance with rtol = 5e-4 and
    atol = 5e-4 x the RMS of ``want`` (the forward's SSD_TOL); 1 or less
    passes."""
    rms = float(want.pow(2).mean().sqrt())
    return float(((got.double() - want).abs() / (SSD_TOL * rms + SSD_TOL * want.abs())).max())


SSD_BWD_NAMES = ("dx", "ddt", "da", "dB", "dC", "dD")


def ssd_bwd_verdict(got, again, want, dtype) -> dict:
    """The SSD backward's criteria on its outputs ``got``, a second run's
    ``again`` and the f64 reference ``want`` (each in ``SSD_BWD_NAMES``
    order): f32 within ``ssd_bwd_ratio``, bf16 by the row rule at 3e-2
    (``grad_row_rel_err``), finite, and bit-equal across the two runs."""
    import torch

    errs = {n: float((g.double() - w).abs().max()) for n, g, w in zip(SSD_BWD_NAMES, got, want)}
    if dtype == "float32":
        crit = {n: ssd_bwd_ratio(g, w) for n, g, w in zip(SSD_BWD_NAMES, got, want)}
        lim = 1.0
    else:
        crit = {n: grad_row_rel_err(g, w) for n, g, w in zip(SSD_BWD_NAMES, got, want)}
        lim = REL_TOL
    bit_equal = all(torch.equal(p, q) for p, q in zip(got, again))
    ok = (bit_equal and all(v <= lim for v in crit.values())
          and all(bool(torch.isfinite(g).all()) for g in got))
    return dict(errs=errs, crit=crit, lim=lim, bit_equal=bit_equal, ok=ok)


def router_bwd_verdict(got, again, want) -> dict:
    """The router backward's criteria: within GATE_TOL of its plain
    version, finite, and bit-equal across two runs."""
    import torch

    err = float((got - want).abs().max())
    bit_equal = torch.equal(got, again)
    return dict(err=err, bit_equal=bit_equal,
                ok=err <= GATE_TOL and bit_equal and bool(torch.isfinite(got).all()))


def ssd_bwd_case(name, B, L, H, P, N, dtype, groups=None, regime="jax", dh_final=False,
                 iters=3, gen=None):
    """The SSD backward kernel against ``ssd_scan_bwd_ref`` in f64 on the
    card, on the same (rounded) inputs: each of dx, ddt, da, dB, dC, dD
    within ``ssd_bwd_ratio`` (f32) or the row rule at 3e-2 (bf16,
    ``grad_row_rel_err``); two runs bit-equal.  The plain version's time is
    ``ssd_scan_bwd_ref`` in f32."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_bwd_ref
    from repro_torch.kernels.ssd_scan.kernel import BWD_CHUNK

    G = groups or H
    x, dt, a, Bm, Cm, D = ssd_inputs(B, L, H, P, N, G, dtype, regime, gen)
    dy = torch.randn((B, L, H, P), generator=gen, device="cuda").to(x.dtype)
    dh = torch.randn((B, H, N, P), generator=gen, device="cuda") if dh_final else None
    got = ssd_scan_bwd(x, dt, a, Bm, Cm, D, dy, dh)
    again = ssd_scan_bwd(x, dt, a, Bm, Cm, D, dy, dh)
    want = ssd_scan_bwd_ref(*(t.double() for t in (x, dt, a, Bm, Cm, D, dy)),
                            None if dh is None else dh.double())
    v = ssd_bwd_verdict(got, again, want, dtype)
    del got, again, want
    torch.cuda.empty_cache()
    # at the main shapes 20 back-to-back calls: the host runs far ahead of
    # the card, so the events time the card's work
    kernel_ms = time_ms(lambda: ssd_scan_bwd(x, dt, a, Bm, Cm, D, dy, dh),
                        20 if L >= 8192 else iters, 2)
    kernel_device_ms = device_ms(lambda: ssd_scan_bwd(x, dt, a, Bm, Cm, D, dy, dh), iters)
    one_call_ms = single_call_ms(lambda: ssd_scan_bwd(x, dt, a, Bm, Cm, D, dy, dh))
    if L >= 8192:  # the main shapes: where the backward's device time goes, by kernel
        profile_device(f"ssd_scan_bwd/{name} x4",
                       lambda: [ssd_scan_bwd(x, dt, a, Bm, Cm, D, dy, dh) for _ in range(4)])
    plain_ms = time_ms(lambda: ssd_scan_bwd_ref(x, dt, a, Bm, Cm, D, dy, dh), 1, 1)
    flops = ssd_bwd_flops(B, L, H, P, N, BWD_CHUNK, G)
    # x, dy, B, C read and dx, dB, dC written; dt read and ddt written; a, D,
    # da, dD; dh_final
    nbytes = (3 * x.numel() + 4 * Bm.numel()) * x.element_size() + 4 * (
        2 * dt.numel() + 4 * H + (0 if dh is None else dh.numel()))
    bound_ms, bound_by = bound(flops, nbytes, "float32")
    tc_bound_ms = ssd_bwd_tensor_core_bound(B, L, H, P, N, BWD_CHUNK, G, dtype)
    scratch = ssd_bwd_scratch_bytes(B, L, H, P, N, G, dtype)
    measured = kernel_device_ms if isinstance(kernel_device_ms, float) else None
    rec = dict(kernel="ssd_scan_bwd", case=name,
               shape=dict(B=B, L=L, H=H, P=P, N=N, G=G, dh_final=dh_final), regime=regime,
               dtype=dtype, max_abs_err=max(v["errs"].values()), errs=v["errs"],
               criterion="allclose rtol=atol/rms=5e-4" if dtype == "float32" else "row rule",
               err_over_allowed=v["crit"], limit=v["lim"],
               bit_equal_across_runs=v["bit_equal"], kernel_ms=kernel_ms,
               device_ms=kernel_device_ms, single_call_ms=one_call_ms, plain_ms=plain_ms,
               library_ms=None,
               bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / kernel_ms,
               device_bound_share=bound_ms / measured if measured else None,
               tensor_core_bound_ms=tc_bound_ms,
               device_tensor_core_share=tc_bound_ms / measured if measured else None,
               scratch_bytes=scratch, scratch_ms=scratch / HBM_BYTES_PER_S * 1e3,
               chunk=BWD_CHUNK, ok=v["ok"])
    log(rec)
    torch.cuda.empty_cache()
    return rec


def router_bwd_case(name, T, E, k, ties=False, iters=20, gen=None):
    """The router's backward against its plain version on the forward
    kernel's ids and gates and a random gates' gradient: within GATE_TOL,
    and bit-equal across two runs."""
    import torch

    from repro_torch.kernels.moe_router import moe_router, moe_router_bwd, moe_router_bwd_ref

    logits = router_logits(T, E, ties, gen)
    with torch.no_grad():
        ids, gates, _ = moe_router(logits, k)
    dgates = torch.randn((T, k), generator=gen, device="cuda")
    got = moe_router_bwd(ids, gates, dgates, E)
    again = moe_router_bwd(ids, gates, dgates, E)
    v = router_bwd_verdict(got, again, moe_router_bwd_ref(ids, gates, dgates, E))
    kernel_ms = time_ms(lambda: moe_router_bwd(ids, gates, dgates, E), iters)
    kernel_device_ms = device_ms(lambda: moe_router_bwd(ids, gates, dgates, E), iters)
    plain_ms = time_ms(lambda: moe_router_bwd_ref(ids, gates, dgates, E), max(2, iters // 5), 1)
    bound_ms, bound_by = bound(router_bwd_flops(T, k), router_bytes(T, E, k), "float32")
    rec = dict(kernel="moe_router_bwd", case=name, shape=dict(T=T, E=E, k=k, ties=ties),
               dtype="float32", max_abs_err=v["err"], tol=GATE_TOL,
               bit_equal_across_runs=v["bit_equal"], kernel_ms=kernel_ms,
               device_ms=kernel_device_ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=bound_ms, bound_by=bound_by, ok=v["ok"])
    log(rec)
    return rec


def backward_cases():
    """The cases of the SSD and router backward kernels, on their own
    generator (``BWD_SEED``), then those of the SSD backward's redesign on
    another (``BWD_REDESIGN_SEED``)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(BWD_SEED)
    recs = [ssd_bwd_case(name, *shape, gen=g, **kw) for name, *shape, kw in SSD_BWD_CASES]
    log_clocks("after the ssd_scan_bwd parity cases")
    recs += [router_bwd_case(name, *shape, gen=g, **kw)
             for name, *shape, kw in ROUTER_BWD_CASES]
    g_new = torch.Generator(device="cuda").manual_seed(BWD_REDESIGN_SEED)
    recs += [ssd_bwd_case(name, *shape, gen=g_new, **kw)
             for name, *shape, kw in SSD_BWD_CASES_NEW]
    return recs


# ---------------------------------------------------------------------------
# phase 2, last: the mamba2 mixer's causal conv, forward and backward
# ---------------------------------------------------------------------------
def conv_inputs(B, L, di, gn, H, xdt, wdt, gen):
    """The (x, B, C) columns as the mixer reads them in place from a (z, x,
    B, C, dt) row of the in_proj output, and w (4, Ch) and b (Ch,) at the
    port's init scale of w (0.5) with a bias of 0.1."""
    import torch

    Ch = di + 2 * gn
    zxbcdt = torch.randn((B, L, 2 * di + 2 * gn + H), generator=gen, device="cuda")
    xbc = zxbcdt.to(getattr(torch, xdt))[..., di:di + Ch]
    w = (torch.randn((4, Ch), generator=gen, device="cuda") * 0.5).to(getattr(torch, wdt))
    b = (torch.randn((Ch,), generator=gen, device="cuda") * 0.1).to(getattr(torch, wdt))
    return xbc, w, b


def conv_err(got, want64) -> float:
    """The largest |got - want| over what one step of got's dtype (2^-7 of
    a bf16 value: a value rounded once is within half of it, and the f32
    sums before the rounding can move it across a rounding boundary) plus
    ``CONV_TOL`` of the largest |want| allows: 1 or less passes."""
    import torch

    step = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    allowed = step * want64.abs() + CONV_TOL * float(want64.abs().max())
    return float(((got.double() - want64).abs() / allowed.clamp_min(1e-300)).max())


def conv_case(name, B, L, di, gn, H, xdt, wdt, gen=None):
    """``causal_conv`` and ``causal_conv_bwd`` against their plain versions
    in f64 on the card (``conv_err``: each output and gradient within one
    step of its dtype plus ``CONV_TOL`` of its largest entry), the f32
    forward also against the plain version in its own dtypes, and two runs
    of each bit-equal.  Times: the kernels (CUDA events over 20 calls and
    the profiler's device time), the plain versions, and at L >= 2048 the
    glue the kernels replaced in the mixer (autograd through the plain
    forward: its backward alone, ``glue_bwd_ms``); bounds at the bytes
    (``flops.conv_bytes`` at 3.35 TB/s).  Two records: forward, backward."""
    import torch

    from repro_torch.kernels.causal_conv import (causal_conv, causal_conv_bwd,
                                                 causal_conv_bwd_ref, causal_conv_ref)

    xbc, w, b = conv_inputs(B, L, di, gn, H, xdt, wdt, gen)
    x64, w64, b64 = xbc.double(), w.double(), b.double()
    got, again = causal_conv(xbc, w, b, di), causal_conv(xbc, w, b, di)
    plain = causal_conv_ref(xbc, w, b, di)
    want = causal_conv_ref(x64, w64, b64, di)
    fwd_errs = [conv_err(g, w_) for g, w_ in zip(got, want)]
    fwd_equal = all(torch.equal(g, a) for g, a in zip(got, again))
    plain_gap = max(float((g.double() - p.double()).abs().max()) for g, p in zip(got, plain))
    if got[0].dtype == torch.float32:  # the same op order: near-equal to the plain version
        fwd_errs.append(plain_gap / (CONV_TOL * max(float(p.abs().max()) for p in plain)))
    douts = [torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype) for t in got]
    bgot = causal_conv_bwd(xbc, w, b, *douts)
    bagain = causal_conv_bwd(xbc, w, b, *douts)
    bwant = causal_conv_bwd_ref(x64, w64, b64, *douts)
    bwd_errs = {n: conv_err(g, w_) for n, g, w_ in zip(("dx", "dw", "db"), bgot, bwant)}
    bwd_equal = all(torch.equal(g, a) for g, a in zip(bgot, bagain))
    del got, again, plain, want, bgot, bagain, bwant, x64, w64, b64
    torch.cuda.empty_cache()

    T, Ch = B * L, di + 2 * gn
    xi, oi = xbc.element_size(), torch.empty((), dtype=torch.promote_types(
        xbc.dtype, w.dtype)).element_size()
    recs = []
    for kernel, fn, plain_fn, flops_, errs, equal in (
            ("causal_conv", lambda: causal_conv(xbc, w, b, di),
             lambda: causal_conv_ref(xbc, w, b, di), conv_flops(T, Ch), fwd_errs, fwd_equal),
            ("causal_conv_bwd", lambda: causal_conv_bwd(xbc, w, b, *douts),
             lambda: causal_conv_bwd_ref(xbc, w, b, *douts), conv_bwd_flops(T, Ch),
             list(bwd_errs.values()), bwd_equal)):
        kernel_ms = time_ms(fn, 20, 2)
        dev = device_ms(fn, 20)
        plain_ms = time_ms(plain_fn, 3, 1)
        nbytes = conv_bytes(T, Ch, xi, oi, backward=kernel.endswith("bwd"))
        bound_ms, bound_by = bound(flops_, nbytes, "float32")
        rec = dict(kernel=kernel, case=name, shape=dict(B=B, L=L, d_inner=di, gn=gn, Ch=Ch),
                   dtype=f"{xdt} x, {wdt} w", max_abs_err=max(errs), err_over_allowed=max(errs),
                   tol=CONV_TOL, bit_equal_across_runs=equal, kernel_ms=kernel_ms,
                   device_ms=dev, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                   bound_by=bound_by, bound_share=bound_ms / kernel_ms,
                   device_bound_share=bound_ms / dev if isinstance(dev, float) else None,
                   ok=max(errs) <= 1.0 and equal)
        if kernel == "causal_conv_bwd":
            rec["errs"] = bwd_errs
        else:
            rec["plain_max_abs_gap"] = plain_gap
        if L >= 2048 and kernel == "causal_conv_bwd":
            rec["glue_bwd_ms"] = glue_bwd_ms(xbc, w, b, di, douts)
        log(rec)
        recs.append(rec)
    torch.cuda.empty_cache()
    return recs


def glue_bwd_ms(xbc, w, b, di, douts) -> float:
    """Device time of the backward the mixer ran before the kernel: autograd
    through the plain forward (per-tap products, pad, SiLU, split), the
    graph made once and kept."""
    import torch

    from repro_torch.kernels.causal_conv import causal_conv_ref

    x, w_, b_ = (t.detach().requires_grad_() for t in (xbc, w, b))
    outs = causal_conv_ref(x, w_, b_, di)
    ms = time_ms(lambda: torch.autograd.grad(outs, (x, w_, b_), douts, retain_graph=True), 3, 1)
    del outs
    return ms


def conv_cases():
    """The causal-conv cases (``CONV_CASES``), on their own generator
    (``CONV_SEED``), after phase 2's parity cases: they move no earlier
    case's inputs."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    g = torch.Generator(device="cuda").manual_seed(CONV_SEED)
    recs = [r for name, *shape in CONV_CASES for r in conv_case(name, *shape, gen=g)]
    bad = [(r["kernel"], r["case"]) for r in recs if not r["ok"]]
    if bad:
        raise SystemExit(f"causal conv parity failed: {bad}")
    log(f"causal conv parity: {len(recs)} records passed; launches while comparing (not "
        f"counted as main path): {launch_counts()}")
    reset_launch_counts()
    return recs


# ---------------------------------------------------------------------------
# phase 2, last: the RMSNorm, plain and gated, forward and backward
# ---------------------------------------------------------------------------
def norm_inputs(lead, D, row, xdt, zdt, wdt, gen):
    """x (lead + (D,)), the gate read in place from the first D columns of
    rows ``row`` wide (None for the plain form) and w (D,) near one."""
    import torch

    x = torch.randn(lead + (D,), generator=gen, device="cuda").to(getattr(torch, xdt))
    z = None
    if row is not None:
        zrow = torch.randn(lead + (row,), generator=gen, device="cuda").to(getattr(torch, zdt))
        z = zrow[..., :D]
    w = (1 + 0.1 * torch.randn((D,), generator=gen, device="cuda")).to(getattr(torch, wdt))
    return x, z, w


def ulp_share(got, want64) -> tuple:
    """(share of entries bit-equal to or one bf16 step from ``want64``
    rounded to bf16, the most steps any entry is off)."""
    import torch

    a = got.view(torch.int16).int()
    b = want64.to(torch.bfloat16).view(torch.int16).int()
    # bf16 patterns of one sign are ordered as their values; map the negative
    # half so that one step apart is one apart across zero too
    a, b = (torch.where(t < 0, -(t & 0x7FFF), t) for t in (a, b))
    steps = (a - b).abs()
    return float((steps <= 1).double().mean()), int(steps.max())


def norm_fwd_check(got, want64) -> tuple:
    """(errors, ok) of a forward output against the plain version in f64: a
    bf16 output within one bf16 step on ``NORM_ULP_SHARE`` of its entries
    and none more than ``NORM_MAX_STEPS`` away; an f32 output within one
    step plus ``NORM_TOL`` of its largest entry (``conv_err``)."""
    import torch

    if got.dtype == torch.bfloat16:
        share, worst = ulp_share(got, want64)
        return (dict(ulp_share=share, max_steps=worst),
                share >= NORM_ULP_SHARE and worst <= NORM_MAX_STEPS)
    err = conv_err(got, want64)
    return dict(err_over_allowed=err), err <= 1.0


def norm_library(x, w, dout) -> dict:
    """The one PyTorch call that computes the plain form,
    ``F.rms_norm(x, (D,), w, eps)``, as (forward, backward) callables:
    ``library_ms`` with w as it is (w in another dtype than x's keeps it off
    PyTorch's fused kernel), and ``library_w_cast_ms`` with w cast to x's
    dtype inside the call (its fused kernel; w rounded, so not quite the
    same function) where the dtypes differ."""
    import torch
    import torch.nn.functional as F

    def call(x_, w_, cast):
        return F.rms_norm(x_, (x_.shape[-1],), w_.to(x_.dtype) if cast else w_, NORM_EPS)

    out = {}
    for key, cast in (("library_ms", False), ("library_w_cast_ms", True)):
        if cast and w.dtype == x.dtype:
            continue
        leaves = (x.detach().requires_grad_(), w.detach().requires_grad_())
        y = call(*leaves, cast)
        out[key] = (lambda cast=cast: call(x, w, cast),
                    lambda y=y, leaves=leaves: torch.autograd.grad(
                        y, leaves, dout.to(y.dtype), retain_graph=True))
    return out


def norm_case(name, lead, D, row, xdt, zdt, wdt, gen=None):
    """``rms_norm`` and ``rms_norm_bwd`` against their plain versions in f64
    on the card: the output by ``norm_fwd_check``, every gradient within one
    step of its dtype plus ``NORM_TOL`` of its largest entry (``conv_err``);
    the gated product is rounded as the forward rounds it, in the working
    dtypes, before the f64 norm.  Two runs of each bit-equal.  Times: the
    kernels (CUDA events over 20 calls and the profiler's device time), the
    plain version (autograd through it for the backward: the glue the
    kernel replaced), for the plain form PyTorch's own call
    (``norm_library``, by events and on the device), bounds at the bytes
    (``flops.norm_bytes`` at 3.35 TB/s).  Two records: forward, backward."""
    import torch

    from repro_torch.kernels.rms_norm import (gate_product, rms_norm, rms_norm_bwd,
                                              rms_norm_bwd_ref, rms_norm_ref, rstd_ref)
    from repro_torch.kernels.rms_norm.ops import _forward

    x, z, w = norm_inputs(lead, D, row, xdt, zdt, wdt, gen)
    f64 = torch.float64
    got, rstd = _forward(x, w, z, NORM_EPS)
    again = rms_norm(x, w, NORM_EPS, gate=z)
    want = rms_norm_ref(gate_product(x, z).to(f64), w.to(f64), NORM_EPS)
    fwd_err, fwd_ok = norm_fwd_check(got, want)
    fwd_equal = torch.equal(got, again)
    plain_gap = float((got.double() - rms_norm_ref(x, w, NORM_EPS, z).double()).abs().max())
    dout = torch.randn(got.shape, generator=gen, device="cuda").to(got.dtype)
    bgot = rms_norm_bwd(x, w, rstd, dout, z)
    bagain = rms_norm_bwd(x, w, rstd, dout, z)
    bwant = rms_norm_bwd_ref(x, w, rstd_ref(x, NORM_EPS, z, acc=f64), dout, z, acc=f64)
    bwd_errs = {n: conv_err(g, w_) for n, g, w_ in zip(("dx", "dw", "dz"), bgot, bwant)
                if g is not None}
    bwd_equal = all(torch.equal(g, a) for g, a in zip(bgot, bagain) if g is not None)
    del again, want, bgot, bagain, bwant
    torch.cuda.empty_cache()

    T = x.numel() // D
    xi, oi = x.element_size(), got.element_size()
    zi = 0 if z is None else z.element_size()
    gated = z is not None
    leaves = [t.detach().requires_grad_() for t in ((x, w, z) if gated else (x, w))]
    glue = rms_norm_ref(leaves[0], leaves[1], NORM_EPS, *leaves[2:])
    library = {} if gated else norm_library(x, w, dout)
    recs = []
    for i, (kernel, fn, plain_fn, flops_, errs, equal, ok) in enumerate((
            ("rms_norm", lambda: rms_norm(x, w, NORM_EPS, gate=z),
             lambda: rms_norm_ref(x, w, NORM_EPS, z), norm_flops(T, D, gated), fwd_err,
             fwd_equal, fwd_ok),
            ("rms_norm_bwd", lambda: rms_norm_bwd(x, w, rstd, dout, z),
             lambda: torch.autograd.grad(glue, leaves, dout, retain_graph=True),
             norm_bwd_flops(T, D, gated), bwd_errs, bwd_equal,
             max(bwd_errs.values()) <= 1.0))):
        kernel_ms = time_ms(fn, 20, 2)
        dev = device_ms(fn, 20)
        plain_ms = time_ms(plain_fn, 3, 1)
        lib_ms = {}
        for k, fns in library.items():
            lib_ms[k] = time_ms(fns[i], 20, 2)
            lib_ms[k.replace("_ms", "_device_ms")] = device_ms(fns[i], 20)
        nbytes = norm_bytes(T, D, xi, oi, zi, backward=kernel.endswith("bwd"))
        bound_ms, bound_by = bound(flops_, nbytes, "float32")
        rec = dict(kernel=kernel, case=name, shape=dict(lead=list(lead), D=D, gate_row=row),
                   dtype=f"{xdt} x, {zdt} gate, {wdt} w", errs=errs,
                   max_abs_err=plain_gap if kernel == "rms_norm" else max(errs.values()),
                   tol=NORM_TOL, bit_equal_across_runs=equal, kernel_ms=kernel_ms,
                   device_ms=dev, plain_ms=plain_ms, library_ms=lib_ms.get("library_ms"),
                   library_device_ms=lib_ms.get("library_device_ms"),
                   library_w_cast_ms=lib_ms.get("library_w_cast_ms"),
                   library_w_cast_device_ms=lib_ms.get("library_w_cast_device_ms"),
                   bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes, bound_share=bound_ms / kernel_ms,
                   device_bound_share=bound_ms / dev if isinstance(dev, float) else None,
                   ok=ok and equal)
        if kernel == "rms_norm":
            rec["plain_max_abs_gap"] = plain_gap
        log(rec)
        recs.append(rec)
    del glue, leaves, library
    torch.cuda.empty_cache()
    return recs


def norm_cases():
    """The RMSNorm cases (``NORM_CASES``), on their own generator
    (``NORM_SEED``), after the conv's: they move no earlier case's inputs."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    g = torch.Generator(device="cuda").manual_seed(NORM_SEED)
    recs = [r for name, *shape in NORM_CASES for r in norm_case(name, *shape, gen=g)]
    bad = [(r["kernel"], r["case"], r["errs"]) for r in recs if not r["ok"]]
    if bad:
        raise SystemExit(f"rms_norm parity failed: {bad}")
    log(f"rms_norm parity: {len(recs)} records passed; launches while comparing (not "
        f"counted as main path): {launch_counts()}")
    reset_launch_counts()
    return recs


def adamw_inputs(shape, pdt, gdt, sdt, gen):
    """p, g, m and v of one leaf on the card, as a third step finds them: p
    at the models' init scale, moments of a few steps (v > 0)."""
    import torch

    def randn(scale, dt):
        t = torch.randn(shape, generator=gen, device="cuda")
        return t.mul_(scale).to(getattr(torch, dt))

    v = torch.rand(shape, generator=gen, device="cuda").mul_(1e-8).to(getattr(torch, sdt))
    return randn(0.02, pdt), randn(1e-4, gdt), randn(1e-5, sdt), v


def adamw_f64(p, g, m, v, scale, lr, b1, b2, eps, c1, c2, weight_decay):
    """The kernel's expression in f64 from the same inputs and the same f32
    constants: (p, m, v, the step lr * delta)."""
    import numpy as np
    import torch

    def f(x):
        return float(np.float32(x))

    d64 = torch.float64
    gs = g.to(d64) * scale.to(d64)
    m64 = f(b1) * m.to(d64) + f(1 - b1) * gs
    v64 = f(b2) * v.to(d64) + f(1 - b2) * gs * gs
    delta = (m64 / f(c1)) / (torch.sqrt(v64 / f(c2)) + f(eps))
    if p.dim() >= 2:
        delta = delta + f(weight_decay) * p.to(d64)
    step = f(lr) * delta
    return p.to(d64) - step, m64, v64, step


def adamw_err(got, want64, largest) -> float:
    """The largest |got - want| over one step of got's dtype at want plus
    ``ADAMW_TOL`` of ``largest``: 1 or less passes."""
    import torch

    step = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -23
    allowed = step * want64.abs() + ADAMW_TOL * largest
    return float(((got.double() - want64).abs() / allowed.clamp_min(1e-300)).max())


def bits_print(t) -> int:
    """A fingerprint of ``t``'s bits: their position-weighted sum (two runs
    that differ in any one value differ here)."""
    import torch

    bits = t.reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)
    w = torch.arange(bits.numel(), device=t.device) % 65521 + 1
    return int((bits.long() * w).sum())


def adamw_case(name, shape, pdt, gdt, sdt, scale, gen):
    """``adamw_update`` against its expression in f64 on the card, slice by
    slice of the leading dim (``adamw_err``: p within one step of its dtype
    plus ``ADAMW_TOL`` of the largest step, m and v of their largest entry),
    and a second run from the same inputs bit-equal to the first (by each
    slice's ``bits_print``).  Times: the kernel (CUDA events over 10 calls and
    the profiler's device time), the plain version on the card, and
    PyTorch's fused AdamW (``torch._fused_adamw_``: a timing only, since it
    decays p before the moments and every leaf); the bound at the bytes
    (``flops.adamw_bytes`` at 3.35 TB/s)."""
    import torch

    from repro_torch.kernels import adamw_update
    from repro_torch.kernels.adamw_update import adamw_update_ref

    hyper = ADAMW_HYPER
    p, g, m, v = adamw_inputs(shape, pdt, gdt, sdt, gen)
    s = torch.tensor(scale, device="cuda")
    before = [t.clone() for t in (p, m, v)]
    rows = [slice(i, i + 1) for i in range(shape[0])] if len(shape) > 2 else [slice(None)]
    adamw_update(p, g, m, v, s, **hyper)
    torch.cuda.synchronize()
    errs, gap, first = dict(p=0.0, m=0.0, v=0.0), 0.0, []
    for r in rows:
        want = adamw_f64(before[0][r], g[r], before[1][r], before[2][r], s, **hyper)
        big = float(want[3].abs().max())
        for k, got, w, largest in (("p", p[r], want[0], big),
                                   ("m", m[r], want[1], float(want[1].abs().max())),
                                   ("v", v[r], want[2], float(want[2].abs().max()))):
            errs[k] = max(errs[k], adamw_err(got, w, largest))
        gap = max(gap, float((p[r].double() - want[0]).abs().max()))
        first.append([bits_print(t[r]) for t in (p, m, v)])
        del want
    for t, b in zip((p, m, v), before):
        t.copy_(b)
    adamw_update(p, g, m, v, s, **hyper)
    equal = all([bits_print(t[r]) for t in (p, m, v)] == f for r, f in zip(rows, first))
    del before
    torch.cuda.empty_cache()

    n = p.numel()
    nbytes = adamw_bytes(n, p.element_size(), g.element_size(), m.element_size())
    bound_ms, bound_by = bound(adamw_flops(n, len(shape) >= 2), nbytes, "float32")
    kernel_ms = time_ms(lambda: adamw_update(p, g, m, v, s, **hyper), 10, 2)
    dev = device_ms(lambda: adamw_update(p, g, m, v, s, **hyper), 10)
    plain_ms = time_ms(lambda: adamw_update_ref(p, g, m, v, s, **hyper), 3, 1)
    library_ms = library_dev = None
    if p.dtype == g.dtype == m.dtype:
        steps = [torch.tensor(3.0, device="cuda")]

        def library():
            torch._fused_adamw_([p], [g], [m], [v], [], steps, lr=hyper["lr"],
                                beta1=hyper["b1"], beta2=hyper["b2"],
                                weight_decay=hyper["weight_decay"], eps=hyper["eps"],
                                amsgrad=False, maximize=False)

        library_ms = time_ms(library, 10, 2)
        library_dev = device_ms(library, 10)
    rec = dict(kernel="adamw_update", case=name, shape=list(shape),
               dtype=f"{pdt} p, {gdt} g, {sdt} moments", scale=scale, errs=errs,
               max_abs_err=gap, tol=ADAMW_TOL, bit_equal_across_runs=equal,
               kernel_ms=kernel_ms, device_ms=dev, plain_ms=plain_ms, library_ms=library_ms,
               library_device_ms=library_dev, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, bytes_per_s=nbytes / (kernel_ms * 1e-3),
               bound_share=bound_ms / kernel_ms,
               device_bound_share=bound_ms / dev if isinstance(dev, float) else None,
               ok=max(errs.values()) <= 1.0 and equal)
    log(rec)
    del p, g, m, v
    torch.cuda.empty_cache()
    return rec


def adamw_ptxas() -> dict:
    """ptxas's lines for the update's instantiations: all
    ``ADAMW_INSTANTIATIONS`` compiled, none spilling."""
    from repro_torch.kernels import _build

    _build.build("adamw")
    lines = _build.build_log("adamw").splitlines()
    entries = [ln for ln in lines if "Compiling entry function" in ln
               and "adamw_update_kernel" in ln]
    regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines if "registers" in ln]
    spills = ptxas_spills(lines)
    rec = dict(phase="kernels/adamw_ptxas", instantiations=len(entries),
               max_registers=max(regs, default=0), spills=spills,
               ok=len(entries) == ADAMW_INSTANTIATIONS and not spills)
    log(rec)
    return rec


def adamw_cases():
    """The AdamW update's cases (``ADAMW_CASES``) on their own generator
    (``ADAMW_SEED``), after the norm's, and its ptxas check."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    ptx = adamw_ptxas()
    if not ptx["ok"]:
        raise SystemExit(f"adamw_update: ptxas: {ptx}")
    g = torch.Generator(device="cuda").manual_seed(ADAMW_SEED)
    recs = [adamw_case(name, *case, gen=g) for name, *case in ADAMW_CASES]
    bad = [(r["case"], r["errs"], r["bit_equal_across_runs"]) for r in recs if not r["ok"]]
    if bad:
        raise SystemExit(f"adamw_update parity failed: {bad}")
    log(f"adamw_update parity: {len(recs)} records passed; launches while comparing (not "
        f"counted as main path): {launch_counts()}")
    reset_launch_counts()
    return recs


def augment_inputs(B, H, W, C, oh, ow, corners, gen, alternate_flips=False):
    """images, crops, flips, mean, std on the card.  ``corners="random"``:
    each corner within the image, as the JAX suite draws them;
    ``"out_of_range"``: corners anywhere in [-H, 2H) x [-W, 2W), which the
    kernel and the plain version clamp as ``lax.dynamic_slice`` does.
    ``alternate_flips``: every other image flipped, in place of the drawn
    flags (drawn all the same, so the generator moves as without it).  C
    above 3 repeats ImageNet's mean and std."""
    import torch

    def randint(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=dtype)

    img = randint(0, 256, (B, H, W, C), torch.uint8)
    if corners == "random":
        y0, x0 = randint(0, H - oh + 1, (B,)), randint(0, W - ow + 1, (B,))
    else:
        y0, x0 = randint(-H, 2 * H, (B,)), randint(-W, 2 * W, (B,))
    crops = torch.stack([y0, x0], dim=-1).to(torch.int32).contiguous()
    flips = randint(0, 2, (B,), torch.int32)
    if alternate_flips:
        flips = (torch.arange(B, device="cuda", dtype=torch.int32) % 2).contiguous()
    mean = torch.tensor([IMAGENET_MEAN[c % 3] for c in range(C)], device="cuda")
    std = torch.tensor([IMAGENET_STD[c % 3] for c in range(C)], device="cuda")
    return img, crops, flips, mean, std


def augment_case(name, B, H, W, C, oh, ow, corners="random", iters=20, gen=None,
                 alternate_flips=False):
    """fused_augment against its plain version, atol = rtol = 1e-5."""
    import torch

    from repro_torch.kernels.fused_augment import fused_augment, fused_augment_ref

    args = augment_inputs(B, H, W, C, oh, ow, corners, gen, alternate_flips)
    want = fused_augment_ref(*args, oh, ow)
    got = fused_augment(*args, oh, ow)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max())
    ok = (got.shape == want.shape and bool(torch.isfinite(got).all())
          and bool((diff <= AUG_TOL + AUG_TOL * want.abs()).all()))
    kernel_ms = time_ms(lambda: fused_augment(*args, oh, ow), iters)
    plain_ms = time_ms(lambda: fused_augment_ref(*args, oh, ow), max(2, iters // 5), 1)
    bound_ms, bound_by = augment_bound(B, oh, ow, C)
    rec = dict(kernel="fused_augment", case=name,
               shape=dict(B=B, H=H, W=W, C=C, out_h=oh, out_w=ow, corners=corners,
                          alternate_flips=alternate_flips),
               dtype="uint8->float32", max_abs_err=err, tol=AUG_TOL, kernel_ms=kernel_ms,
               plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by, ok=ok)
    log(rec)
    return rec


def augment_flip_case(gen=None):
    """Flipping is an involution: the flipped crop, reversed along W again,
    is the unflipped one (tests/test_kernels.py::test_flip_is_involution)."""
    import torch

    from repro_torch.kernels.fused_augment import fused_augment

    img, _, _, _, _ = augment_inputs(3, 16, 16, 3, 16, 16, "random", gen)
    crops = torch.zeros((3, 2), dtype=torch.int32, device="cuda")
    mean, std = torch.zeros(3, device="cuda"), torch.ones(3, device="cuda")
    ones = torch.ones(3, dtype=torch.int32, device="cuda")
    a = fused_augment(img, crops, ones, mean, std, 16, 16)
    b = fused_augment(img, crops, ones * 0, mean, std, 16, 16)
    err = float((a.flip(2) - b).abs().max())
    rec = dict(kernel="fused_augment", case="flip_involution", max_abs_err=err, tol=1e-6,
               ok=err <= 1e-6)
    log(rec)
    return rec


def flash_ref_grads(q, k, v, do, kw):
    """(dq, dk, dv) of the plain version by ``torch.autograd.grad`` in f32,
    one kv head and its q heads at a time (the function is separable by kv
    head; this bounds the scores' memory), and the device ms of the
    backward calls."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_ref

    Hq, Hkv = q.shape[2], k.shape[2]
    G = Hq // Hkv
    dq, dk, dv = (torch.empty(t.shape, device="cuda") for t in (q, k, v))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ms = 0.0
    for h in range(Hkv):
        qs = q[:, :, h * G:(h + 1) * G].float().contiguous().requires_grad_()
        ks, vs = (t[:, :, h:h + 1].float().contiguous().requires_grad_() for t in (k, v))
        out = flash_attention_ref(qs, ks, vs, **kw)
        start.record()
        grads = torch.autograd.grad(out, (qs, ks, vs), do[:, :, h * G:(h + 1) * G].float())
        end.record()
        torch.cuda.synchronize()
        ms += start.elapsed_time(end)
        dq[:, :, h * G:(h + 1) * G], dk[:, :, h:h + 1], dv[:, :, h:h + 1] = grads
        del out, grads
    return (dq, dk, dv), ms


def flash_bwd_plain(q, k, v, o, lse, do, kw):
    """The backward kernel's plain version (``flash_attention_bwd_ref``: the
    same math from the same o and lse) in f32, one kv head at a time."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref

    G = q.shape[2] // k.shape[2]
    outs = [torch.empty(t.shape, device=q.device) for t in (q, k, v)]
    for h in range(k.shape[2]):
        qs, os_, dos = (t[:, :, h * G:(h + 1) * G].float() for t in (q, o, do))
        got = flash_attention_bwd_ref(qs, k[:, :, h:h + 1].float(), v[:, :, h:h + 1].float(),
                                      os_, lse[:, h * G:(h + 1) * G].contiguous(), dos, **kw)
        outs[0][:, :, h * G:(h + 1) * G], outs[1][:, :, h:h + 1], outs[2][:, :, h:h + 1] = got
    return outs


def flash_bwd_case(name, B, Sq, Sk, Hq, Hkv, D, dtype, causal=True, window=0, softcap=0.0,
                   q_offset=0, iters=3, library=True, gen=None):
    """The flash backward kernel (through ``flash_attention``'s autograd
    Function) against ``torch.autograd.grad`` of the plain version in f32 on
    the same (rounded) inputs: dq, dk and dv each within the forward's
    tolerance as atol and rtol (``grad_allclose``).  bf16 is also held row
    by row (``grad_row_rel_err``) against the backward's plain version on
    the kernel's own inputs, the forward's bf16 output and log-sum-exp:
    FlashAttention-2 takes Δ = rowsum(dO ∘ O) from the rounded output, which
    moves a row whose exact dq nearly cancels (a query that sees two keys)
    by more than bf16 rounding, and that difference is the algorithm's, not
    the kernel's.  The kernel and SDPA's backward are timed back to back
    and on the device (``device_ms``, ``library_device_ms``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_with_lse)

    dt = getattr(torch, dtype)
    q = torch.randn((B, Sq, Hq, D), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, Sk, Hkv, D), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, Sk, Hkv, D), generator=gen, device="cuda").to(dt)
    do = torch.randn((B, Sq, Hq, D), generator=gen, device="cuda").to(dt)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    want32, plain_ms = flash_ref_grads(q, k, v, do, kw)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(flash_attention(qg, kg, vg, **kw), (qg, kg, vg), do)
    torch.cuda.synchronize()
    errs = [float((g.float() - w.to(dt).float()).abs().max()) for g, w in zip(got, want32)]
    ratios = [grad_allclose(g, w, dtype) for g, w in zip(got, want32)]
    del qg, kg, vg, want32
    o, lse = flash_attention_with_lse(q, k, v, **kw)
    rels, rel_tol = None, None
    if dtype == "bfloat16":
        rel_tol = REL_TOL
        rels = [grad_row_rel_err(g, w)
                for g, w in zip(got, flash_bwd_plain(q, k, v, o, lse, do, kw))]
    # the same inputs twice: no atomics, so the outputs must be bit-identical
    again = [flash_attention_bwd(q, k, v, o, lse, do, **kw) for _ in range(2)]
    bit_equal = all(torch.equal(a, b) for a, b in zip(*again))
    del again
    ok = (max(ratios) <= 1.0 and (rel_tol is None or max(rels) <= rel_tol) and bit_equal
          and all(bool(torch.isfinite(g).all()) for g in got))
    del got
    kernel_ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw), iters, 1)
    kernel_device_ms = device_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw), iters)
    library_ms = library_device_ms = None
    if library and softcap == 0.0:
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        mask = None
        if window > 0 or q_offset or (causal and Sq != Sk):
            qp = q_offset + torch.arange(Sq, device="cuda")[:, None]
            kp = torch.arange(Sk, device="cuda")[None, :]
            mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
            if causal:
                mask &= kp <= qp
            if window > 0:
                mask &= kp > qp - window
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                             is_causal=causal and mask is None, enable_gqa=True)
        dot = do.transpose(1, 2)
        def sdpa_bwd():
            return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

        library_ms = time_ms(sdpa_bwd, iters, 1)
        library_device_ms = device_ms(sdpa_bwd, iters)
        del out, qt, kt, vt
    flops = flash_flops(B, Sq, Sk, Hq, D, causal, window, q_offset, backward=True)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4.0 * B * Hq * Sq
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    rec = dict(kernel="flash_attention_bwd", case=name,
               shape=dict(B=B, Sq=Sq, Sk=Sk, Hq=Hq, Hkv=Hkv, D=D, causal=causal, window=window,
                          softcap=softcap, q_offset=q_offset),
               dtype=dtype, max_abs_err=max(errs), errs_dq_dk_dv=errs, tol=TOL[dtype],
               err_over_allowed=ratios, grad_row_rel_err=rels, rel_tol=rel_tol,
               bit_equal_across_runs=bit_equal, kernel_ms=kernel_ms, device_ms=kernel_device_ms,
               plain_ms=plain_ms, library_ms=library_ms, library_device_ms=library_device_ms,
               bound_ms=bound_ms, bound_by=bound_by, tflops=achieved_tflops(flops, kernel_ms),
               bound_share=bound_ms / kernel_ms, ok=ok)
    log(rec)
    del o, lse
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# the dry run's memory analysis (``repro_torch.launch.memory``) against the card
# ---------------------------------------------------------------------------
# Per kernel (end of phase 2): a call's rise of ``max_memory_allocated``
# over ``memory_allocated`` before it must equal what the tracker charges the
# same call on meta (its outputs plus its launch function's scratch), within
# the caching allocator's rounding of each block.  Per step (phases 3 and 5):
# the dry run's ``per_device_total`` on meta for the phase's own config, B,
# S and batch, against the card's bytes of the step: its arguments (and the
# gradient buffers a train step keeps from its first step) plus the step's
# rise over what was allocated before it.  What was live before and is not
# the step's - the cuBLAS workspace, the decode workspace of earlier calls
# (released, so that the step makes its own, as in the dry run), the f32
# parameters beside the cast ones a serving step reads, the feeder's
# prefetched batches (a train step is measured after the feeder is closed)
# - is taken out of the measurement and logged as ``other_resident_gb``.
BLOCK_ROUND = 512
MEM_STEP_TOL = 0.10  # |predicted - measured| over measured, a step
MEM_STEP_AIM = 0.03  # past this the step is audited op by op (logged)
MEM_SEED = 21
MEM_AUDIT_TOP = 12


def kernel_memory_verdict(kernel, rise, charged, tensors) -> dict:
    """The per-kernel memory check: the card's rise against the meta charge
    within ``BLOCK_ROUND`` bytes a tensor."""
    tol = BLOCK_ROUND * tensors
    return dict(phase="kernels/memory", kernel=kernel, rise_bytes=rise, charged_bytes=charged,
                tensors=tensors, tol_bytes=tol, ok=abs(rise - charged) <= tol)


def step_memory_verdict(label, predicted, measured) -> dict:
    """The per-step memory check: the dry run's prediction within
    ``MEM_STEP_TOL`` of the card's measured bytes."""
    return dict(phase=f"{label}/memory", mem_predicted_gb=predicted / 1e9,
                mem_measured_gb=measured / 1e9, ratio=predicted / measured,
                tol=MEM_STEP_TOL, ok=abs(predicted - measured) <= MEM_STEP_TOL * measured)


def tree_bytes(tree) -> int:
    """Bytes of the tensor leaves of nested dicts, lists and tuples."""
    import torch

    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def _meta_like(x):
    import torch

    return torch.empty(x.shape, dtype=x.dtype, device="meta") if isinstance(x, torch.Tensor) else x


def kernel_memory_cases(gen):
    """(kernel, inputs on the card, call) at each kernel's main case
    (``MAIN_CASE``'s shapes)."""
    import torch

    from repro_torch.kernels import (adamw_update, causal_conv, causal_conv_bwd,
                                     decode_attention, flash_attention, flash_attention_bwd,
                                     fused_augment, moe_router, moe_router_bwd, rms_norm,
                                     rms_norm_bwd, ssd_scan, ssd_scan_bwd)
    from repro_torch.kernels.flash_attention import flash_attention_with_lse

    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    S = PREFILL_S
    q, k, v = randn(1, S, 24, 128, dtype=bf16), randn(1, S, 2, 128, dtype=bf16), randn(
        1, S, 2, 128, dtype=bf16)
    o, lse = flash_attention_with_lse(q, k, v, window=4096)
    dq = randn(1, S, 24, 128, dtype=bf16)
    dq_, dk_ = randn(8, 24, 128, dtype=bf16), randn(8, 256, 2, 128, dtype=bf16)
    lens = torch.full((8,), 96, dtype=torch.int32, device="cuda")
    x, dt = randn(1, 8192, 80, 64), torch.rand((1, 8192, 80), generator=gen, device="cuda")
    a, Bm, Cm, D = -torch.rand((80,), generator=gen, device="cuda"), randn(1, 8192, 1, 128), \
        randn(1, 8192, 1, 128), randn(80)
    logits = randn(4096, 64)
    ids, gates, _ = moe_router(logits, 6)
    imgs = torch.randint(0, 256, (256, 256, 256, 3), generator=gen, device="cuda",
                         dtype=torch.uint8)
    crops = torch.randint(0, 33, (256, 2), generator=gen, device="cuda", dtype=torch.int32)
    flips = torch.randint(0, 2, (256,), generator=gen, device="cuda", dtype=torch.int32)
    mean = torch.tensor(IMAGENET_MEAN, device="cuda")
    std = torch.tensor(IMAGENET_STD, device="cuda")
    # the conv at the benchmark cell's shape, drawn after every earlier input
    _, B_, L_, di, gn, H_, xdt, wdt = CONV_CASES[0]
    xbc, w, b = conv_inputs(B_, L_, di, gn, H_, xdt, wdt, gen)
    douts = [randn(B_, L_, n) for n in (di, gn, gn)]
    # the gated norm at the cell's shape, drawn after every earlier input
    _, lead, Dn, row, ndt, zdt, nwdt = NORM_CASES[0]
    yn, zn, wn = norm_inputs(lead, Dn, row, ndt, zdt, nwdt, gen)
    rstd = torch.rand(lead, generator=gen, device="cuda").reshape(-1)
    dn = randn(*lead, Dn, dtype=zn.dtype)
    # the update of one layer's in_proj (in place: no output, no scratch)
    leaf = adamw_inputs((2560, 10576), "float32", "float32", "float32", gen)
    return [
        ("flash_attention", (q, k, v), lambda *t: flash_attention(*t, window=4096)),
        ("flash_attention_bwd", (q, k, v, o, lse, dq),
         lambda *t: flash_attention_bwd(*t, window=4096)),
        ("decode_attention", (dq_, dk_, dk_.clone(), lens),
         lambda *t: decode_attention(*t, window=4096)),
        ("ssd_scan", (x, dt, a, Bm, Cm, D), ssd_scan),
        ("ssd_scan_bwd", (x, dt, a, Bm, Cm, D, randn(1, 8192, 80, 64)), ssd_scan_bwd),
        ("moe_router", (logits,), lambda t: moe_router(t, 6)),
        ("moe_router_bwd", (ids, gates, randn(4096, 6)), lambda *t: moe_router_bwd(*t, 64)),
        ("fused_augment", (imgs, crops, flips, mean, std),
         lambda *t: fused_augment(*t, out_h=224, out_w=224)),
        ("causal_conv", (xbc, w, b), lambda *t: causal_conv(*t, di)),
        ("causal_conv_bwd", (xbc, w, b, *douts), causal_conv_bwd),
        ("rms_norm", (yn, wn, zn), lambda y_, w_, z_: rms_norm(y_, w_, NORM_EPS, gate=z_)),
        ("rms_norm_bwd", (yn, wn, rstd, dn, zn), rms_norm_bwd),
        ("adamw_update", (*leaf, torch.tensor(0.5, device="cuda")),
         lambda *t: adamw_update(*t, **ADAMW_HYPER)),
    ]


def phase_kernel_memory() -> list:
    """Each kernel called once at its main case after a warm-up: the rise
    of device memory over the call against the tracker's charge of the same
    call on meta (``kernel_memory_verdict``).  Decode's workspace is
    released after the warm-up, so that the measured call makes it, as a
    fresh process (and the dry run) does."""
    import torch

    from repro_torch.kernels.decode_attention.kernel import release_workspaces
    from repro_torch.launch.memory import MemoryTracker

    recs = []
    gen = torch.Generator(device="cuda").manual_seed(MEM_SEED)
    for name, inputs, call in kernel_memory_cases(gen):
        call(*inputs)
        if name == "decode_attention":
            release_workspaces()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = call(*inputs)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - before
        del out
        meta = [_meta_like(t) for t in inputs]  # made before the tracker: arguments
        with MemoryTracker(sms=torch.cuda.get_device_properties(0).multi_processor_count) as mt:
            call(*meta)
        rec = kernel_memory_verdict(name, rise, mt.peak, mt.allocations + mt.scratch_allocations)
        log(rec)
        recs.append(rec)
    bad = [r["kernel"] for r in recs if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel memory: the card's allocation differs from the meta charge: "
                         f"{bad}")
    return recs


def predict_step(arch, kind, B, S, replace, inputs, cast_params=False) -> dict:
    """The dry run's record (on meta, one card) of the step a phase runs:
    its config changes, B, S and batch."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.config import ShapeConfig

    t = time.perf_counter()
    rec = run_cell(arch, ShapeConfig(f"{kind}_{B}x{S}", S, B, kind), replace=replace,
                   inputs=inputs, cast_params=cast_params)
    if rec["status"] != "OK":
        raise SystemExit(f"{arch} {kind}: the dry run gave {rec['status']}: {rec.get('reason')}")
    rec["predict_s"] = time.perf_counter() - t
    return rec


def audit_step(label, fn) -> None:
    """Runs ``fn`` once more under ``MemoryTracker("cuda", audit=True)`` and
    logs the ops whose allocation differs from the tracker's charge, by op
    (count, summed and largest difference)."""
    from repro_torch.launch.memory import MemoryTracker

    with MemoryTracker("cuda", audit=True) as mt:
        fn()
    by_op = {}
    for m in mt.misses:
        d = by_op.setdefault(m["op"], dict(op=m["op"], count=0, diff_bytes=0, largest=None))
        d["count"] += 1
        d["diff_bytes"] += m["rise"] - m["charged"]
        if d["largest"] is None or abs(m["rise"] - m["charged"]) > abs(
                d["largest"]["rise"] - d["largest"]["charged"]):
            d["largest"] = m
    top = sorted(by_op.values(), key=lambda d: -abs(d["diff_bytes"]))[:MEM_AUDIT_TOP]
    log(dict(phase=f"{label}/memory_audit", ops_missed=len(mt.misses), peak_charged_gb=mt.peak / 1e9,
             top=top))


def step_memory_check(label, record, args, fn, held: int = 0) -> dict:
    """Runs the step ``fn`` once with its arguments ``args`` resident and
    holds the dry run's ``record`` against it (``step_memory_verdict``):
    measured = bytes of ``args`` + ``held`` (buffers the step keeps from an
    earlier call) + the rise over the step.  A step past ``MEM_STEP_AIM`` is
    audited (``audit_step``); past ``MEM_STEP_TOL`` the run fails."""
    import torch

    from repro_torch.kernels.decode_attention.kernel import release_workspaces

    release_workspaces()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    arg_bytes = tree_bytes(args)
    mem = record["roofline"]["memory_per_device_bytes"]
    rec = step_memory_verdict(label, mem["per_device_total"], arg_bytes + held + peak - before)
    rec.update(argument_bytes_meta=mem["argument_bytes"], argument_bytes_card=arg_bytes,
               held_bytes=held, temp_bytes_meta=mem["temp_bytes"], rise_bytes=peak - before,
               other_resident_gb=(before - arg_bytes - held) / 1e9,
               max_memory_allocated_gb=peak / 1e9, predict_s=record["predict_s"])
    log(rec)
    if abs(rec["ratio"] - 1) > MEM_STEP_AIM:
        audit_step(label, fn)
    if not rec["ok"]:
        raise SystemExit(f"{label}: predicted {rec['mem_predicted_gb']:.3f} GB against "
                         f"{rec['mem_measured_gb']:.3f} GB measured, past {MEM_STEP_TOL:.0%}")
    return rec


def phase_kernels(main_S: int):
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.kernel import TILES

    g = torch.Generator(device="cuda").manual_seed(0)
    g_edges = torch.Generator(device="cuda").manual_seed(14)
    recs = [
        # starcoder2-3b's attention: Hq=24, Hkv=2, D=128, bf16, window 4096
        flash_case("main_S512", 1, 512, 512, 24, 2, 128, "bfloat16", window=4096, gen=g),
        flash_case(f"main_S{main_S}", 1, main_S, main_S, 24, 2, 128, "bfloat16",
                   window=4096, iters=5, gen=g),
        flash_case("f32", 2, 256, 256, 8, 2, 64, "float32", gen=g),
        # f32 at the main heads with a live window: one key too many or too
        # few moves outputs by about 1/window, far above 2e-5
        flash_case("f32_main_heads_window300", 1, 1024, 1024, 24, 2, 128, "float32",
                   window=300, blocks=((64, 64), (64, 32), (128, 32)), gen=g),
        flash_case("f32_main_heads_window300_q_offset", 1, 128, 1024, 24, 2, 128, "float32",
                   window=300, q_offset=896, blocks=((64, 64), (64, 32), (128, 32)), gen=g),
        flash_case("f32_main_heads_window4096", 1, 5000, 5000, 24, 2, 128, "float32",
                   window=4096, iters=3, gen=g),
        flash_case("ragged_D64", 1, 300, 300, 4, 2, 64, "float32", gen=g),
        flash_case("ragged_D64_bf16", 2, 300, 300, 4, 2, 64, "bfloat16", window=64, gen=g),
        flash_case("noncausal_SqneSk", 1, 64, 320, 4, 4, 64, "float32", causal=False, gen=g),
        flash_case("q_offset", 1, 64, 320, 4, 2, 64, "float32", q_offset=256, gen=g),
        flash_case("mha", 2, 256, 256, 8, 8, 64, "bfloat16", gen=g),
        flash_case("mqa_D32", 1, 192, 192, 6, 1, 32, "float32", gen=g),
        flash_case("softcap", 1, 128, 128, 4, 2, 64, "float32", softcap=30.0, gen=g),
        flash_case("blocks", 1, 256, 256, 4, 2, 64, "float32", blocks=TILES[torch.float32],
                   gen=g),
        flash_case("blocks_bf16_D128", 1, 1000, 1000, 24, 2, 128, "bfloat16", window=300,
                   blocks=TILES[torch.bfloat16], gen=g),
        # the edges (and moonshot's prefill shape, its MHA path) draw from
        # their own generator, so that every earlier case keeps its inputs
        flash_case("moonshot_prefill_S4096", 1, 4096, 4096, 16, 16, 128, "bfloat16", iters=5,
                   gen=g_edges),
        *(flash_case(name, *shape, "bfloat16", blocks=TILES[torch.bfloat16], gen=g_edges, **kw)
          for name, *shape, kw in BF16_EDGES),
        decode_case("main_serve_B8_S256", 8, 256, 24, 2, 128, "bfloat16", [96] * 8,
                    window=4096, gen=g),
        decode_case(f"long_B8_S{main_S}", 8, main_S, 24, 2, 128, "bfloat16",
                    [1, 100, 4096, 4097, 5000, 8000, main_S, 3000], window=4096, gen=g),
        decode_case("f32_D32", 4, 300, 6, 2, 32, "float32", [1, 77, 299, 300], splits=(4,),
                    block_s=128, gen=g),
        decode_case("f32_D64_mha", 1, 1024, 8, 8, 64, "float32", [700], splits=(8,),
                    block_s=128, gen=g),
        decode_case("split_invariance", 2, 2048, 8, 2, 64, "float32", [1500, 2048],
                    window=1000, splits=(1, 2, 8, None), block_s=128, gen=g),
        decode_case("mqa_D128", 2, 256, 4, 1, 128, "float32", [17, 256], splits=(2,),
                    block_s=128, gen=g),
    ]
    for dtype in ("float32", "bfloat16"):
        short = "f32" if dtype == "float32" else "bf16"
        # the shapes of tests/test_kernels.py::TestSSDScan (heads pre-expanded)
        for B, L, H, P, N, chunk in ((1, 64, 2, 32, 16, 16), (2, 128, 4, 64, 32, 32),
                                     (1, 100, 2, 32, 16, 32), (1, 256, 8, 64, 128, 64)):
            recs.append(ssd_case(f"jax_{B}x{L}x{H}x{P}x{N}_c{chunk}_{short}", B, L, H, P, N,
                                 dtype, chunks=(chunk,), gen=g))
        # mamba2-2.7b's prefill: 80 heads, P 64, N 128, one group read in place
        recs.append(ssd_case(f"mamba2_prefill_{short}", 1, 8192, 80, 64, 128, dtype, groups=1,
                             gen=g))
    recs += [
        ssd_case("ragged_L8000", 1, 8000, 80, 64, 128, "float32", groups=1, gen=g),
        ssd_case("chunk_invariance", 1, 128, 2, 32, 16, "float32", chunks=(16, 32, 64, 128),
                 gen=g),
        ssd_case("grouped_B2_G2", 2, 300, 8, 64, 64, "float32", groups=2, chunks=(64, 128),
                 gen=g),
        # chunks that are not multiples of 16: zero rows pad each chunk in
        # shared memory, and the ragged last chunk (300 = 7 x 40 + 20)
        ssd_case("chunks_40_100", 1, 300, 8, 64, 64, "float32", chunks=(40, 100), gen=g),
        ssd_case("chunk_40_bf16", 2, 300, 8, 64, 64, "bfloat16", groups=2, chunks=(40,),
                 gen=g),
        ssd_case("chunks_40_100_mamba2_regime", 2, 300, 80, 64, 128, "float32", groups=1,
                 chunks=(40, 100), regime="mamba2", gen=g),
        # the main path's inputs: fast decay, in-chunk log-decay in the hundreds
        ssd_case("mamba2_prefill_mamba2_regime", 1, 8192, 80, 64, 128, "float32", groups=1,
                 regime="mamba2", gen=g),
    ]
    g_new = torch.Generator(device="cuda").manual_seed(NEW_CASES_SEED)
    recs += [decode_case(name, *shape, gen=g_new, **kw)
             for name, *shape, kw in DECODE_CASES_NEW]
    recs += [ssd_case(name, *shape, gen=g_new, **kw) for name, *shape, kw in SSD_CASES_NEW]
    # the shapes of tests/test_kernels.py::TestMoERouter, then the main path's
    for T, E, k in ((64, 8, 2), (256, 64, 6), (128, 384, 8), (100, 16, 4), (32, 16, 2)):
        recs.append(router_case(f"jax_T{T}_E{E}_k{k}", T, E, k, gen=g))
    recs += [
        router_case("moonshot_prefill", 4096, 64, 6, gen=g),
        router_case("moonshot_serve", 8, 64, 6, gen=g),
        router_case("kimi_T4096", 4096, 384, 8, gen=g),
        router_case("ties", 1000, 64, 6, ties=True, gen=g),
    ]
    # the shapes of tests/test_kernels.py::TestFusedAugment, corners out of
    # range, then ResNet-50's ImageNet recipe at a batch of 256
    for B, H, W, C, oh, ow in ((2, 64, 64, 3, 32, 32), (4, 48, 56, 3, 32, 40),
                               (1, 224, 224, 3, 192, 192), (3, 40, 40, 1, 40, 40)):
        recs.append(augment_case(f"jax_B{B}_{H}x{W}x{C}_{oh}x{ow}", B, H, W, C, oh, ow, gen=g))
    recs += [
        augment_flip_case(gen=g),
        augment_case("out_of_range_corners", 64, 48, 56, 3, 32, 40, corners="out_of_range", gen=g),
        augment_case("imagenet_B256", 256, 256, 256, 3, 224, 224, gen=g),
    ]
    recs += flash_bwd_cases(main_S, g, g_edges)
    recs += encdec_vlm_cases()
    recs += d112_and_redesign_cases()
    recs += backward_cases()
    recs += slice10_cases()
    decode_split_sweep()
    bad = [r["case"] for r in recs if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel parity failed: {bad}")
    log(f"kernel parity: {len(recs)} cases passed; launches while comparing "
        f"(not counted as main path): {launch_counts()}")
    reset_launch_counts()
    return recs


def encdec_vlm_cases():
    """The flash and decode cases of whisper-large-v3 and qwen2-vl-2b, on
    their own generator (``ENCDEC_VLM_SEED``)."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import TILES

    g = torch.Generator(device="cuda").manual_seed(ENCDEC_VLM_SEED)
    recs = []
    for name, *shape, dtype, kw in FLASH_CASES_ENCDEC_VLM:
        kw = dict(kw)
        if kw.pop("all_tiles", False):
            kw["blocks"] = TILES[getattr(torch, dtype)]
        recs.append(flash_case(name, *shape, dtype, twice=True, gen=g, **kw))
    recs += [decode_case(name, *shape, gen=g, **kw)
             for name, *shape, kw in DECODE_CASES_ENCDEC_VLM]
    return recs


def slice10_cases():
    """The cases of the slice that trains whisper-large-v3 and qwen2-vl-2b
    and serves and trains jamba-v0.1-52b, on their own generator
    (``SLICE10_SEED``): the flash backward at the train shapes, jamba's flash
    prefill and decode, its SSD scan and backward, its router forward and
    backward; every one timed on the device."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SLICE10_SEED)
    recs = [flash_bwd_case(name, *shape, gen=g, **kw)
            for name, *shape, kw in FLASH_BWD_CASES_SLICE10]
    recs += [flash_case(name, *shape, twice=True, gen=g, **kw)
             for name, *shape, kw in FLASH_CASES_SLICE10]
    recs += [decode_case(name, *shape, gen=g, **kw) for name, *shape, kw in DECODE_CASES_SLICE10]
    recs += [ssd_case(name, *shape, gen=g, **kw) for name, *shape, kw in SSD_CASES_SLICE10]
    recs += [ssd_bwd_case(name, *shape, gen=g, **kw) for name, *shape, kw in SSD_BWD_CASES_SLICE10]
    recs += [router_case(name, *shape, gen=g) for name, *shape in ROUTER_CASES_SLICE10]
    recs += [router_bwd_case(name, *shape, gen=g) for name, *shape in ROUTER_CASES_SLICE10]
    return recs


def d112_and_redesign_cases():
    """The cases of kimi-k2's head dim 112 (flash forward and backward,
    decode) and of the router and augment redesigns, on their own generator
    (``D112_REDESIGN_SEED``)."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import TILES

    g = torch.Generator(device="cuda").manual_seed(D112_REDESIGN_SEED)
    recs = []
    for name, *shape, dtype, kw in FLASH_CASES_D112:
        kw = dict(kw)
        if kw.pop("all_tiles", False):
            kw["blocks"] = TILES[getattr(torch, dtype)]
        recs.append(flash_case(name, *shape, dtype, gen=g, **kw))
    recs += [flash_bwd_case(name, *shape, gen=g, **kw)
             for name, *shape, kw in FLASH_BWD_CASES_D112]
    recs += [decode_case(name, *shape, gen=g, **kw) for name, *shape, kw in DECODE_CASES_D112]
    recs += [router_case(name, *shape, gen=g) for name, *shape in ROUTER_CASES_NEW]
    recs += [augment_case(name, *shape, gen=g, alternate_flips=True)
             for name, *shape in AUGMENT_CASES_NEW]
    return recs


def flash_bwd_cases(main_S: int, g, g_edges):
    """The backward at the serving heads (starcoder2-3b's 24/2 and
    moonshot's 16/16, D=128) with the window live at S=8192, then the
    edges: ragged tiles, q_offset, non-causal, MQA, softcap.  A small
    warm-up first, so that no case's plain time holds autograd's and the
    libraries' one-time set-up."""
    import torch

    warm = [torch.randn((1, 64, 2, 32), device="cuda") for _ in range(4)]
    flash_ref_grads(*warm, dict(causal=True))
    return [
        flash_bwd_case(f"main_S{main_S}", 1, main_S, main_S, 24, 2, 128, "bfloat16",
                       window=4096, gen=g),
        flash_bwd_case(f"f32_S{main_S}", 1, main_S, main_S, 24, 2, 128, "float32", window=4096,
                       library=False, gen=g),
        flash_bwd_case(f"mha_16x16_S{main_S}", 1, main_S, main_S, 16, 16, 128, "bfloat16",
                       window=4096, gen=g),
        flash_bwd_case(f"mha_16x16_f32_S{main_S}", 1, main_S, main_S, 16, 16, 128, "float32",
                       window=4096, library=False, gen=g),
        flash_bwd_case("f32_main_heads_window300", 1, 1024, 1024, 24, 2, 128, "float32",
                       window=300, gen=g),
        flash_bwd_case("ragged_D64", 2, 300, 300, 4, 2, 64, "float32", gen=g),
        flash_bwd_case("ragged_D64_bf16", 2, 300, 300, 4, 2, 64, "bfloat16", window=64, gen=g),
        flash_bwd_case("q_offset", 1, 64, 320, 4, 2, 64, "float32", q_offset=256, gen=g),
        flash_bwd_case("noncausal_SqneSk", 1, 64, 320, 4, 4, 64, "float32", causal=False, gen=g),
        flash_bwd_case("mqa_D32", 1, 192, 192, 6, 1, 32, "float32", gen=g),
        flash_bwd_case("mqa_D32_bf16", 1, 192, 192, 6, 1, 32, "bfloat16", gen=g),
        flash_bwd_case("softcap", 1, 128, 128, 4, 2, 64, "float32", softcap=30.0, gen=g),
        *(flash_bwd_case(name, *shape, "bfloat16", gen=g_edges, **kw)
          for name, *shape, kw in BF16_EDGES),
    ]


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------
# The models of the main path: (arch, config changes, prefill length, changes
# for the f32 decode-vs-forward check, its sequence lengths).  moonshot is
# served with bf16 parameters (f32 would be 110 GB), and its f32 check runs
# at 4 of its 48 layers (1 dense + 3 MoE), dropless as decode is.  kimi-k2
# (head dim 112, 384 experts top-8) is cut to its first 2 layers (1 dense +
# 1 MoE: 17.2 B parameters in the layers, 39.1 GB in bf16 with the embedding
# and the head; the whole model has 1 T), and its f32 check to the dense
# layer (the f32 MoE layer alone would be 67.6 GB).  qwen2-vl-2b (VLM, 12/2
# heads, M-RoPE) is not cut: it prefills from embeddings with Qwen2-VL's
# position layout (``prefill_batch``); its f32 check runs at 2 layers.
# jamba-v0.1-52b (hybrid: mamba2 mixers with N = 16 and 128 heads, attention
# 32/8 on every 8th layer, MoE of 16 experts top-2 on every 2nd) is cut to
# one whole 7:1 period, 8 of its 32 layers (7 mamba2 + 1 attention, 4 MoE):
# 13.27 B parameters, 26.5 GB in bf16; the whole model's 51.5 B would need
# 103 GB.  Its f32 check runs at the 2-layer cut of its train run (period 2:
# a mamba2 layer with the dense SwiGLU, an attention layer with the MoE),
# dropless as decode is.
MODELS = (
    ("starcoder2-3b", {}, PREFILL_S, {}, (32,)),
    ("mamba2-2.7b", {}, 8192, {}, (32, 40)),
    ("moonshot-v1-16b-a3b", {"param_dtype": "bfloat16"}, 4096,
     {"param_dtype": "float32", "num_layers": 4, "capacity_factor": 64.0}, (32,)),
    ("kimi-k2-1t-a32b", {"num_layers": 2, "param_dtype": "bfloat16"}, 4096,
     {"param_dtype": "float32", "num_layers": 1}, (32,)),
    ("qwen2-vl-2b", {}, 4096, {"num_layers": 2}, (32,)),
    ("jamba-v0.1-52b", {"num_layers": 8, "param_dtype": "bfloat16"}, 8192,
     {"param_dtype": "float32", "num_layers": 2, "attn_period": 2, "attn_offset": 1,
      "capacity_factor": 64.0}, (32, 40)),
)
# Qwen2-VL's text-image-text prompt of the VLM prefill: 256 text tokens, a
# 60 x 60 grid of merged patches (a 1680 x 1680 image at patch 14, merge 2),
# then text to 4096 tokens.
VLM_TEXT, VLM_GRID = 256, 60
# The VLM train batches' embeddings (``FamilyBatches``): the scale of the
# model's embedding table at init (``layers._init``), and the seed of the
# frozen text embeddings.
EMBED_SCALE = 0.02
TEXT_EMBED_SEED = 7
# The train feed's float payloads (``FamilyBatches``: whisper's
# ``enc_embeds``, 61.4 MB a batch, and qwen2-vl's image-patch embeddings):
# FEED_POOL of them are drawn, from a generator seeded (FEED_POOL_SEED,
# seed), when the source is built, before the timed steps, and the batches
# cycle through them, so that a step's time is the port's and not numpy's.
FEED_POOL, FEED_POOL_SEED = 2, 8
# whisper-large-v3 (enc-dec) is not cut.  Prefill: B = 8 clips of 1500
# encoder frames and 448 decoder tokens (max_target_positions of the
# published openai/whisper-large-v3 config).  Serving: the encoder once
# (init_cache), then WHISPER_STEPS greedy decode steps, the first
# WHISPER_PROMPT teacher-forced.  Its f32 check (WHISPER_CHECK layers, B = 2,
# S = 32, 8 decode steps) holds the card against the port's CPU plain route
# at atol = rtol = 1e-4, the gradient-norm tolerance of the train checks:
# the reference applies rope in its decode and not in its forward, so decode
# is not held against forward.
WHISPER = "whisper-large-v3"
WHISPER_B, WHISPER_S = 8, 448
WHISPER_STEPS, WHISPER_PROMPT = 64, 4
WHISPER_CHECK = {"encoder_layers": 2, "num_layers": 2}
WHISPER_CHECK_TOL = 1e-4
# A kernel of PyTorch's sort-based scatter-add (index_put_ with accumulate):
# the MoE dispatch is a plain assignment, so no prefill profile may hold it.
SORT_SCATTER_KERNEL = "indexing_backward_kernel"


def expected_launches(cfg):
    """Kernel launches of one forward and of one decode step: one per
    attention layer (flash / decode), per mamba2 layer (causal_conv and
    ssd_scan, forward only: decode runs the recurrence) and per MoE layer
    (moe_router), and one per RMSNorm (``model_norms``).  An
    enc-dec forward runs flash in each encoder layer and twice (self and
    cross) in each decoder layer; its decode step runs decode twice a
    decoder layer."""
    from repro_torch.models.lm import layer_pattern

    if cfg.family == "encdec":
        return ({"flash_attention": cfg.encoder_layers + 2 * cfg.num_layers,
                 "rms_norm": sum(model_norms(cfg))},
                {"decode_attention": 2 * cfg.num_layers,
                 "rms_norm": sum(model_norms(cfg, decode=True))})
    pattern = layer_pattern(cfg)
    attn = sum(m == "attn" for m, _ in pattern)
    ssm = sum(m == "ssm" for m, _ in pattern)
    moe = sum(f == "moe" for _, f in pattern)
    norms = sum(model_norms(cfg))
    forward = {"flash_attention": attn, "causal_conv": ssm, "ssd_scan": ssm, "moe_router": moe,
               "rms_norm": norms}
    step = {"decode_attention": attn, "moe_router": moe, "rms_norm": norms}
    return ({k: v for k, v in forward.items() if v}, {k: v for k, v in step.items() if v})


def layer_norms(cfg, mixer, ffn) -> int:
    """RMSNorm launches of one decoder layer, forward or decode step: ln1,
    and ln2 where it has a feed-forward, when the block norms are RMSNorm;
    q and k norms in an attention layer with qk-norm; the gated norm in a
    mamba2 layer."""
    block = cfg.norm_type == "rms"
    return (block * (1 + (ffn != "none")) + 2 * (cfg.qk_norm and mixer == "attn")
            + (mixer == "ssm"))


def model_norms(cfg, decode=False) -> tuple:
    """(RMSNorm launches inside the layers of one forward, or of one decode
    step when ``decode``; those outside them, the final norms, run once a
    forward and never recomputed).  A decoder layer has ``layer_norms``; an
    enc-dec's decoder layer has three and its encoder layer two (a decode
    step runs no encoder), and each of its stacks a final norm."""
    from repro_torch.models.lm import layer_pattern

    if cfg.family == "encdec":
        return (3 * cfg.num_layers + (0 if decode else 2 * cfg.encoder_layers),
                1 if decode else 2)
    return (sum(layer_norms(cfg, m, f) for m, f in layer_pattern(cfg)),
            int(cfg.norm_type == "rms"))


def require_launches(label, counts, per_call, calls) -> None:
    """Exits when a kernel launched fewer than ``per_call[k] * calls`` times."""
    short = {k: (counts.get(k, 0), n * calls) for k, n in per_call.items()
             if counts.get(k, 0) < n * calls}
    if short:
        raise SystemExit(f"{label}: kernels launched fewer times than the path needs "
                         f"(got, want): {short}")


def counted(label, fn):
    """Runs ``fn`` with every launch count set to 0 just before; returns its
    result, the seconds it took (host clock after a synchronize), the launch
    counts just after and the peak device memory."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t
    counts = launch_counts()
    log(f"{label}: launches {counts}")
    return out, dt_s, counts, torch.cuda.max_memory_allocated() / 1e9


def qwen2vl_layout(S: int) -> tuple:
    """(text, grid) of the text-image-text prompt in S tokens: the
    prefill's VLM_TEXT text tokens and VLM_GRID x VLM_GRID image where S
    holds them, else S // 4 text tokens and the largest square image in
    S // 2 tokens."""
    if S >= VLM_TEXT + VLM_GRID ** 2:
        return VLM_TEXT, VLM_GRID
    return S // 4, math.isqrt(S // 2)


def qwen2vl_positions(S: int, device=None):
    """(1, S, 3) M-RoPE positions (t, h, w) as Qwen2-VL lays out a
    text-image-text prompt (``qwen2vl_layout``): ``text`` text tokens at (i,
    i, i), a ``grid`` x ``grid`` image at (p, p + row, p + col) with p =
    ``text``, then text from the image's largest position + 1."""
    import torch

    text, grid = qwen2vl_layout(S)
    n_img = grid * grid
    row, col = torch.arange(n_img) // grid, torch.arange(n_img) % grid
    image = torch.stack([torch.full_like(row, text), text + row, text + col], -1)
    tail = text + grid + torch.arange(S - text - n_img)
    pos = torch.cat([torch.arange(text)[:, None].expand(-1, 3), image,
                     tail[:, None].expand(-1, 3)])
    return pos[None].to(device=device, dtype=torch.int32)


def prefill_batch(cfg, S: int, gen):
    """One prefill sequence of S tokens drawn from ``gen``: token ids, or for
    the VLM family embeddings (the vision stub's input) with Qwen2-VL's
    M-RoPE positions."""
    import torch

    from repro_torch.models.layers import cdt

    if cfg.family == "vlm":
        embeds = torch.randn((1, S, cfg.d_model), generator=gen, device=gen.device)
        return {"embeds": embeds.to(cdt(cfg)), "positions": qwen2vl_positions(S, gen.device)}
    return {"tokens": torch.randint(0, cfg.vocab_size, (1, S), generator=gen, device=gen.device)}


def phase_model(arch, replace, prefill_S, check_replace, check_lengths):
    """One model at full width (random weights from a seeded generator):
    (a) prefill of ``prefill_S`` tokens, (b) a ServeEngine answering 8
    requests, (c) teacher-forced decode logits against forward logits in
    f32.  Returns the launches of (a) and (b), the main path."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(arch).replace(**replace)
    model = build_model(cfg)
    per_forward, per_step = expected_launches(cfg)
    log(f"{arch}: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before its init")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    cparams = model.cast_for_compute(params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{arch}: {cfg.num_layers} layers {[g.subpattern for g in model.groups]}, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, params {cfg.param_dtype}, compute {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"(peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB); launches per forward "
        f"{per_forward}, per decode step {per_step}")
    gen = torch.Generator(device="cuda").manual_seed(1)

    # (a) prefill; a short warm-up first
    model.forward(cparams, {"tokens": torch.randint(0, cfg.vocab_size, (1, 256), device="cuda")},
                  last_token_only=True)
    batch = prefill_batch(cfg, prefill_S, gen)
    logits, secs, counts, peak = counted(
        f"{arch} prefill", lambda: model.forward(cparams, batch, last_token_only=True))
    if logits.shape != (1, 1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"{arch} prefill logits bad: shape {tuple(logits.shape)}")
    require_launches(f"{arch} prefill", counts, per_forward, 1)
    totals = dict(counts)
    log(dict(phase=f"{arch}/prefill", B=1, S=prefill_S, seconds=secs,
             tokens_per_s=prefill_S / secs, max_memory_allocated_gb=peak))
    ran = profile_device(f"{arch}/prefill", lambda: model.forward(cparams, batch,
                                                                  last_token_only=True))
    if any(SORT_SCATTER_KERNEL in name for name in ran):
        raise SystemExit(f"{arch} prefill ran the sort-based scatter {SORT_SCATTER_KERNEL}")
    step_memory_check(f"{arch}/prefill",
                      predict_step(arch, "prefill", 1, prefill_S, replace, batch, True),
                      (cparams, batch), lambda: model.forward(cparams, batch,
                                                              last_token_only=True))

    # (b) ServeEngine: 8 requests, prompts of 8-64 tokens, 32 new tokens each
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(1, cfg.vocab_size, int(n))],
                    max_new_tokens=32) for n in rng.integers(8, 65, 8)]
    eng = ServeEngine(model, cparams, batch_size=8, max_seq=256, device="cuda")
    done, secs, counts, peak = counted(f"{arch} serve", lambda: eng.run(reqs))
    totals = {k: totals.get(k, 0) + counts[k] for k in counts}
    steps = eng.cache["pos"]
    for r in done:
        if not r.done or len(r.generated) != 32 or not all(
                0 <= t < cfg.vocab_size for t in r.generated):
            raise SystemExit(f"{arch}: request not answered: {r}")
    require_launches(f"{arch} serve", counts, per_step, steps)
    log(dict(phase=f"{arch}/serve", requests=len(done), decode_steps=steps, seconds=secs,
             steps_per_s=steps / secs, batch_tokens_per_s=steps * 8 / secs,
             generated_tokens_per_s=sum(len(r.generated) for r in done) / secs,
             max_memory_allocated_gb=peak))
    feed = torch.ones((8,), dtype=torch.int32, device="cuda")
    step_memory_check(f"{arch}/decode_step",
                      predict_step(arch, "decode", 8, 256, replace, {"tokens": feed}, True),
                      (eng.params, eng.cache, feed),
                      lambda: eng._step(eng.params, eng.cache, feed))

    def eight_steps():
        for _ in range(8):
            eng._step(eng.params, eng.cache, feed)

    profile_device(f"{arch}/serve_8_decode_steps", eight_steps)
    del eng, cparams, logits

    # (c) teacher-forced decode == forward, in f32
    cfg32 = cfg.replace(dtype="float32", **check_replace)
    model32 = build_model(cfg32)
    if cfg32.param_dtype != cfg.param_dtype or cfg32.num_layers != cfg.num_layers:
        del params
        gc.collect()
        torch.cuda.empty_cache()
        params = model32.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    per_forward32, per_step32 = expected_launches(cfg32)
    B = 2

    def both():
        errs = []
        for S in check_lengths:
            toks = torch.randint(1, cfg.vocab_size, (B, S), generator=gen, device="cuda")
            full = model32.forward(params, {"tokens": toks})
            cache = model32.init_cache(B, S, device="cuda")
            outs = []
            for t in range(S):
                lg, cache = model32.decode_step(params, cache, toks[:, t])
                outs.append(lg)
            dec = torch.stack(outs, dim=1)
            errs.append((S, float((dec - full).abs().max()),
                         bool(torch.allclose(dec, full, atol=2e-3, rtol=2e-3))))
        return errs

    errs, _, counts, peak = counted(f"{arch} decode_vs_forward_f32", both)
    log(dict(phase=f"{arch}/decode_vs_forward_f32", layers=cfg32.num_layers, B=B,
             S=list(check_lengths), max_abs_err=[e for _, e, _ in errs], atol=2e-3, rtol=2e-3,
             ok=all(ok for _, _, ok in errs), max_memory_allocated_gb=peak))
    if not all(ok for _, _, ok in errs):
        raise SystemExit(f"{arch}: decode_step logits disagree with forward logits: {errs}")
    require_launches(f"{arch} decode_vs_forward", counts, per_forward32, len(check_lengths))
    require_launches(f"{arch} decode_vs_forward", counts, per_step32, sum(check_lengths))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def greedy_decode(model, params, enc_embeds, prompt, steps: int, max_seq: int):
    """An enc-dec model's serving loop (``ServeEngine`` drives decoder-only
    models): the encoder once (``init_cache``), then ``steps`` decode steps,
    the prompt's tokens (B, P) teacher-forced, then greedy.  Returns the
    tokens it generated (B, steps - P + 1) and the cache."""
    import torch

    cache = model.init_cache(params, prompt.shape[0], max_seq, enc_embeds=enc_embeds)
    out, nxt = [], None
    for t in range(steps):
        feed = prompt[:, t] if t < prompt.shape[1] else nxt
        logits, cache = model.decode_step(params, cache, feed)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if t >= prompt.shape[1] - 1:
            out.append(nxt)
    return torch.stack(out, dim=1), cache


def phase_encdec(arch=WHISPER):
    """whisper-large-v3 at its published config (random weights from a
    seeded generator): (a) a prefill of ``WHISPER_B`` clips (the encoder over
    their frame embeddings, then ``WHISPER_S`` decoder tokens), (b) serving
    the same clips through ``greedy_decode``, (c) the f32 check, the card's
    kernels against the CPU plain route at ``WHISPER_CHECK`` layers.
    Returns the launches of (a) and (b), the main path."""
    import gc

    import torch

    from repro_torch.bridge import map_with_paths
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import cdt

    cfg = get_config(arch)
    model = build_model(cfg)
    per_forward, per_step = expected_launches(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    cparams = model.cast_for_compute(params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{arch}: {cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers, d_model "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} x {cfg.head_dim}, vocab "
        f"{cfg.vocab_size}, params {cfg.param_dtype}, compute {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; launches per forward "
        f"{per_forward}, per decode step {per_step}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, S, Senc = WHISPER_B, WHISPER_S, cfg.encoder_seq
    enc = torch.randn((B, Senc, cfg.d_model), generator=gen, device="cuda").to(cdt(cfg))
    toks = torch.randint(1, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    batch = {"enc_embeds": enc, "tokens": toks}

    # (a) prefill; a short warm-up first
    model.forward(cparams, {"enc_embeds": enc[:1], "tokens": toks[:1, :16]}, last_token_only=True)
    logits, secs, counts, peak = counted(
        f"{arch} prefill", lambda: model.forward(cparams, batch, last_token_only=True))
    if logits.shape != (B, 1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"{arch} prefill logits bad: shape {tuple(logits.shape)}")
    require_launches(f"{arch} prefill", counts, per_forward, 1)
    totals = dict(counts)
    log(dict(phase=f"{arch}/prefill", B=B, encoder_S=Senc, S=S, seconds=secs,
             encoder_frames_per_s=B * Senc / secs, decoder_tokens_per_s=B * S / secs,
             max_memory_allocated_gb=peak))
    profile_device(f"{arch}/prefill", lambda: model.forward(cparams, batch, last_token_only=True))
    step_memory_check(f"{arch}/prefill", predict_step(arch, "prefill", B, S, {}, batch, True),
                      (cparams, batch),
                      lambda: model.forward(cparams, batch, last_token_only=True))

    # (b) serving: the encoder once, then WHISPER_STEPS decode steps
    prompt = toks[:, :WHISPER_PROMPT].to(torch.int32)
    (generated, cache), secs, counts, peak = counted(
        f"{arch} serve", lambda: greedy_decode(model, cparams, enc, prompt, WHISPER_STEPS, S))
    totals = {k: totals.get(k, 0) + counts.get(k, 0) for k in set(totals) | set(counts)}
    if (cache["pos"] != WHISPER_STEPS or generated.shape != (B, WHISPER_STEPS - WHISPER_PROMPT + 1)
            or not bool(((generated >= 0) & (generated < cfg.vocab_size)).all())):
        raise SystemExit(f"{arch}: serving went wrong: pos {cache['pos']}, tokens "
                         f"{tuple(generated.shape)}")
    require_launches(f"{arch} serve", counts, {"flash_attention": cfg.encoder_layers}, 1)
    require_launches(f"{arch} serve", counts, per_step, WHISPER_STEPS)
    log(dict(phase=f"{arch}/serve", B=B, decode_steps=WHISPER_STEPS, seconds=secs,
             steps_per_s=WHISPER_STEPS / secs, batch_tokens_per_s=WHISPER_STEPS * B / secs,
             max_memory_allocated_gb=peak))
    feed = torch.ones((B,), dtype=torch.int32, device="cuda")
    step_memory_check(f"{arch}/decode_step",
                      predict_step(arch, "decode", B, S, {}, {"tokens": feed}, True),
                      (cparams, cache, feed), lambda: model.decode_step(cparams, cache, feed))

    def eight_steps():
        for _ in range(8):
            model.decode_step(cparams, cache, feed)

    profile_device(f"{arch}/serve_8_decode_steps", eight_steps)
    del cparams, params, cache, logits, batch, enc
    gc.collect()
    torch.cuda.empty_cache()

    # (c) f32: the card's kernels against the CPU plain route, same parameters
    cfg32 = cfg.replace(dtype="float32", **WHISPER_CHECK)
    model32 = build_model(cfg32)
    p_card = model32.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    p_cpu = map_with_paths(p_card, lambda _, t: t.cpu())
    enc32 = torch.randn((2, Senc, cfg.d_model), generator=gen, device="cuda")
    toks32 = torch.randint(1, cfg.vocab_size, (2, 32), generator=gen, device="cuda")

    def run(params, enc_embeds, tokens):
        full = model32.forward(params, {"enc_embeds": enc_embeds, "tokens": tokens})
        cache = model32.init_cache(params, 2, 32, enc_embeds=enc_embeds)
        dec = torch.stack([model32.decode_step(params, cache, tokens[:, t])[0]
                           for t in range(8)], dim=1)
        return full, dec

    (full, dec), _, counts, peak = counted(f"{arch} f32_card_vs_cpu",
                                           lambda: run(p_card, enc32, toks32))
    per_forward32, per_step32 = expected_launches(cfg32)
    require_launches(f"{arch} f32_card_vs_cpu", counts,
                     {"flash_attention": per_forward32["flash_attention"] + cfg32.encoder_layers},
                     1)
    require_launches(f"{arch} f32_card_vs_cpu", counts, per_step32, 8)
    t0 = time.perf_counter()
    full_cpu, dec_cpu = run(p_cpu, enc32.cpu(), toks32.cpu())
    cpu_s = time.perf_counter() - t0
    tol = WHISPER_CHECK_TOL
    errs = {name: (float((got.cpu() - want).abs().max()),
                   bool(torch.allclose(got.cpu(), want, atol=tol, rtol=tol)))
            for name, got, want in (("forward", full, full_cpu), ("decode", dec, dec_cpu))}
    log(dict(phase=f"{arch}/f32_card_vs_cpu", encoder_layers=cfg32.encoder_layers,
             decoder_layers=cfg32.num_layers, B=2, encoder_S=Senc, S=32, decode_steps=8,
             max_abs_err={k: e for k, (e, _) in errs.items()}, atol=tol, rtol=tol,
             cpu_seconds=cpu_s, ok=all(ok for _, ok in errs.values()),
             max_memory_allocated_gb=peak))
    if not all(ok for _, ok in errs.values()):
        raise SystemExit(f"{arch}: card and CPU disagree in f32: {errs}")
    del p_card, p_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return totals

# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------
def phase_augment(gen, batches: int = 8):
    """fused_augment as its users call it: ResNet-50's ImageNet recipe, 256
    images of 256x256x3 cropped to 224x224 at random corners with random
    flips, on ``batches`` batches, after one untimed pass that leaves the
    outputs' memory in PyTorch's caching allocator (the model phases before
    this one empty it); the launch counts are this phase's."""
    import torch

    from repro_torch.kernels.fused_augment import fused_augment

    data = [augment_inputs(256, 256, 256, 3, 224, 224, "random", gen) for _ in range(batches)]

    def run():
        return [fused_augment(*args, 224, 224) for args in data]

    run()  # untimed: its outputs go back to the cache
    outs, secs, counts, peak = counted("augment", run)
    if counts.get("fused_augment", 0) < batches:
        raise SystemExit(f"augment: fused_augment launched {counts} times for {batches} batches")
    for out in outs:
        if out.shape != (256, 224, 224, 3) or not bool(torch.isfinite(out).all()):
            raise SystemExit(f"augment: bad output {tuple(out.shape)}")
    log(dict(phase="augment", batches=batches, images=256 * batches, seconds=secs,
             images_per_s=256 * batches / secs, max_memory_allocated_gb=peak))
    return counts


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------
class ZipfTokens:
    """An in-script distributed dataset: ``session()`` yields ``steps``
    batches {"tokens", "labels"} (B, S) int64, made with numpy from ``seed``
    as examples/train_e2e.py makes its documents (64-511 tokens of zipf(1.3)
    ids clipped to the vocabulary, so no padding id 0), packed end to end
    into rows of S + 1 tokens."""

    def __init__(self, vocab: int, batch: int, seq: int, steps: int, seed: int):
        self.vocab, self.batch, self.seq, self.steps, self.seed = vocab, batch, seq, steps, seed

    def session(self, **overrides):
        return _ZipfSession(self)

    def finish(self, batch: dict, i: int) -> dict:
        """Batch ``i`` as the session yields it (``FamilyBatches`` adds the
        family's inputs)."""
        return batch


class _ZipfSession:
    def __init__(self, src: ZipfTokens):
        self.src = src
        self.closed = False

    def __iter__(self):
        import numpy as np

        src = self.src
        rng = np.random.default_rng(src.seed)
        for i in range(src.steps):
            if self.closed:
                return
            rows = []
            for _ in range(src.batch):
                docs, n = [], 0
                while n < src.seq + 1:
                    doc = np.minimum(rng.zipf(1.3, int(rng.integers(64, 512))), src.vocab - 1)
                    docs.append(doc)
                    n += len(doc)
                rows.append(np.concatenate(docs)[: src.seq + 1])
            arr = np.stack(rows).astype(np.int64)
            yield src.finish({"tokens": arr[:, :-1], "labels": arr[:, 1:]}, i)

    def close(self):
        self.closed = True


class FamilyBatches(ZipfTokens):
    """``ZipfTokens`` in the layout of the JAX package's ``train_input_specs``
    (``launch/specs.py``) for ``cfg``'s family.  The enc-dec family adds
    ``enc_embeds`` (B, encoder_seq, d_model), standard normal (the mel/conv
    stub's frames).  The VLM family takes ``embeds`` (B, S, d_model) and (B,
    S, 3) M-RoPE ``positions`` in place of tokens, for a text-image-text
    prompt (``qwen2vl_layout``), as the vision stub hands them over: at a
    text position the frozen text embedding of its token (``text_row``), at
    an image position a patch embedding drawn at random, both at the scale
    of the model's embedding table at init (``EMBED_SCALE``); an image
    position's label is padding, since Qwen2-VL takes no loss on image
    tokens.  The random frames and patch embeddings come from a pool of
    ``FEED_POOL`` drawn when the source is built (``FEED_POOL_SEED``), which
    the batches cycle through; the tokens are ``ZipfTokens``' own.  The
    card's machine has no ml_dtypes, so the embeddings travel as f32 and the
    model casts them on the card."""

    def __init__(self, cfg, batch: int, seq: int, steps: int, seed: int):
        import numpy as np

        super().__init__(cfg.vocab_size, batch, seq, steps, seed)
        self.cfg = cfg
        self.rows = {}
        width = {"encdec": cfg.encoder_seq, "vlm": seq}.get(cfg.family)
        rng = np.random.default_rng((FEED_POOL_SEED, seed))
        self.pool = [] if width is None else [
            rng.standard_normal((batch, width, cfg.d_model), dtype=np.float32)
            for _ in range(min(FEED_POOL, steps))]
        if cfg.family == "vlm":
            for x in self.pool:
                x *= EMBED_SCALE

    def text_row(self, token: int):
        """The frozen text embedding of ``token``: a seeded draw of its own,
        so that a token's row does not depend on the batches before it."""
        import numpy as np

        if token not in self.rows:
            rng = np.random.default_rng((TEXT_EMBED_SEED, token))
            self.rows[token] = EMBED_SCALE * rng.standard_normal(self.cfg.d_model,
                                                                 dtype=np.float32)
        return self.rows[token]

    def finish(self, batch: dict, i: int) -> dict:
        import numpy as np

        cfg, B, S = self.cfg, self.batch, self.seq
        if cfg.family == "encdec":
            batch["enc_embeds"] = self.pool[i % len(self.pool)]
        elif cfg.family == "vlm":
            text, grid = qwen2vl_layout(S)
            image = np.zeros(S, dtype=bool)
            image[text:text + grid * grid] = True
            tokens = batch.pop("tokens")
            embeds = self.pool[i % len(self.pool)].copy()
            for b, j in zip(*np.nonzero(~image[None].repeat(B, 0))):
                embeds[b, j] = self.text_row(int(tokens[b, j]))
            batch["labels"][:, image] = 0  # the loss's padding id
            batch["embeds"] = embeds
            pos = qwen2vl_positions(S).numpy()
            batch["positions"] = np.ascontiguousarray(np.broadcast_to(pos, (B, S, 3)))
        return batch


# the kernels with a backward: forward, its backward, and the layers that run it
# (its launches in a layer of a config, mixer and feed-forward)
BACKWARD_OF = (("flash_attention", "flash_attention_bwd", lambda cfg, m, f: m == "attn"),
               ("causal_conv", "causal_conv_bwd", lambda cfg, m, f: m == "ssm"),
               ("ssd_scan", "ssd_scan_bwd", lambda cfg, m, f: m == "ssm"),
               ("moe_router", "moe_router_bwd", lambda cfg, m, f: f == "moe"),
               ("rms_norm", "rms_norm_bwd", layer_norms))


def train_launches_per_step(cfg):
    """Launches of one train step of each kernel with a backward under
    ``remat="block"``: a forward per layer that runs it (attention, mamba2,
    MoE; RMSNorm per norm of the layer, ``layer_norms``), one more for each
    such layer of a repeated group (the recomputation), and a backward per
    layer; the final norms once each way (``model_norms``).  An enc-dec
    runs flash once in each encoder layer and twice (self and cross) in
    each decoder layer, and under remat every one of its layers is
    recomputed (``EncDecModel._run``)."""
    from repro_torch.models.lm import compute_groups

    if cfg.family == "encdec":
        n = cfg.encoder_layers + 2 * cfg.num_layers
        norms, final = model_norms(cfg)
        again = cfg.remat == "block"
        return {"flash_attention": 2 * n if again else n, "flash_attention_bwd": n,
                "rms_norm": norms * (1 + again) + final, "rms_norm_bwd": norms + final}
    out = {}
    for fwd_name, bwd_name, runs in BACKWARD_OF:
        fwd = recompute = 0
        for g in compute_groups(cfg):
            n = g.repeats * sum(runs(cfg, m, f) for m, f in g.subpattern)
            fwd += n
            if cfg.remat == "block" and g.repeats > 1:
                recompute += n
        if fwd:
            out[fwd_name], out[bwd_name] = fwd + recompute, fwd
    final = model_norms(cfg)[1]
    if final:
        out["rms_norm"] = out.get("rms_norm", 0) + final
        out["rms_norm_bwd"] = out.get("rms_norm_bwd", 0) + final
    return out


def phase_train(arch, replace, B, S, steps):
    """One model of ``TRAIN_RUNS``, fed by a DeviceFeeder over
    ``FamilyBatches`` (B x S tokens a step): ``steps`` steps, then a profiled
    one.  Returns the launches of the ``steps`` steps (the main path)."""
    import gc
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.feed import DeviceFeeder
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cfg = get_config(arch).replace(**replace)
    model = build_model(cfg)
    # A warmup as in real runs.  AdamW's first steps move every entry by
    # about lr, along a gradient spread over billions of random parameters,
    # so the loss is steep along them: on starcoder2-3b a first step of lr
    # 2.5e-4 throws it from 11.3 to 20, and steps of 3.3e-6 already
    # overshoot.  lr rises to 2e-6 over the run's steps.
    opt = AdamWConfig(lr=2e-6, warmup_steps=steps)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), opt,
                             device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    layers = (f"{cfg.encoder_layers} + {cfg.num_layers}" if cfg.family == "encdec"
              else f"{cfg.num_layers} {[g.subpattern for g in model.groups]}")
    log(f"train {arch}: {layers} layers, params "
        f"{cfg.param_dtype}, compute {cfg.dtype}, remat {cfg.remat}, {n_params / 1e9:.3f} B "
        f"params, AdamW state {opt.state_dtype}; init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    step = make_train_step(model, opt)
    per_step = train_launches_per_step(cfg)
    src = FamilyBatches(cfg, B, S, steps + 1, seed=0)
    losses, secs = [], []
    with DeviceFeeder(src, device="cuda", depth=2) as feeder:
        def run_steps():
            for _ in range(steps):
                t = time.perf_counter()
                batch = feeder.next()
                _, m = step(state, batch)
                losses.append(float(m["loss"]))  # host sync: the step is done
                secs.append(time.perf_counter() - t)
                log(dict(phase="train/step", arch=arch, step=len(losses), loss=losses[-1],
                         total_loss=float(m["total_loss"]), grad_norm=float(m["grad_norm"]),
                         lr=float(m["lr"]), seconds=secs[-1]))

        _, _, counts, peak = counted(f"train {arch} {steps} steps", run_steps)
        feed = feeder.metrics.summary()
        log_clocks(f"before the {arch} train profile")
        last = feeder.next()
        profile_device(f"{arch}/train_step", lambda: step(state, last))
        log_clocks(f"after the {arch} train profile")
    # a warm step with the feeder closed (no batch moves during it); the
    # gradient buffers the step keeps from its first call are the
    # parameters' bytes
    step_memory_check(f"train {arch}", predict_step(arch, "train", B, S, replace, last),
                      (state, last), lambda: step(state, last),
                      held=tree_bytes(state["params"]))
    steady = secs[1:] if len(secs) > 1 else secs
    sps = sum(steady) / len(steady)
    IN_SCRIPT_FEED[arch] = dict(seconds_per_step=sps, idle_s_per_step=feed["idle_s_per_step"],
                                stall_fraction=feed["stall_frac"], breakdown=feed["breakdown"])
    log(dict(phase="train", arch=arch, layers=cfg.num_layers, B=B, S=S, steps=steps,
             losses=losses, seconds_per_step=secs, steady_seconds_per_step=sps,
             tokens_per_s=B * S / sps, max_memory_allocated_gb=peak,
             feed_idle_s_per_step=feed["idle_s_per_step"],
             feed_stall_fraction=feed["stall_frac"], feed_breakdown=feed["breakdown"],
             feed_transfer_s=feed["transfer_s"], feed_bytes=feed["bytes_to_device"],
             launches=counts, launches_per_step_want=per_step))
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"train {arch}: loss not finite and falling: {losses}")
    if peak > 80.0:
        raise SystemExit(f"train {arch}: peak memory {peak:.1f} GB over 80 GB")
    require_launches(f"train {arch}", counts, per_step, steps)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 6: the service feeds the trainer through the launcher
# ---------------------------------------------------------------------------
# (arch, B, S, steps): phase 5's starcoder2-3b run (the window live, flash
# forward twice and backward in all 30 layers) and whisper-large-v3 uncut
# (B = 8 clips: 61.4 MB of f32 enc_embeds a batch, drawn on the workers,
# the heaviest batch the service moves to the card).  The batches are the
# launcher's: uniform tokens, standard normal frames (launch/specs layout).
# Uniform tokens leave the loss nothing to learn across batches but the
# logits' spread: at lr 2e-6 it moves about 1e-4 a step against about 1e-2
# between batches, so the loss of step n against step 1 is a coin flip (so
# is JAX's reduced --execute run's, on the CPU).  What must fall is the
# loss of the run's first batch, taken again after the last step, against
# its loss at step 1 (the same data before and after all the updates), and
# the last batch's, taken again after its own step, against its loss in
# that step (the last update, at the run's full lr, alone).
SERVICE_RUNS = (("starcoder2-3b", 1, 8192, 6), ("whisper-large-v3", 8, 448, 4))
SERVICE_WORKERS = 2
SERVICE_TIMEOUT_S = 400
IN_SCRIPT_FEED = {}  # phase 5's feed numbers by arch, for phase 6's log


def service_command(arch, B, S, steps):
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--execute",
            "--full-width", "--device", "cuda", "--batch", str(B), "--seq", str(S),
            "--steps", str(steps), "--workers", str(SERVICE_WORKERS)]


def run_service(cmd, run=subprocess.run):
    """Runs the launcher's command line from the checkout's root with
    ``PYTHONPATH`` at ``src``; returns (its last stdout line as JSON, its
    stdout, the seconds it took).  A non-zero exit, a timeout or a last line
    that is not a JSON object exits the run."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t = time.perf_counter()
    try:
        out = run(cmd, cwd=str(ROOT), env=env, capture_output=True, text=True,
                  timeout=SERVICE_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise SystemExit(f"service: {' '.join(cmd)} ran past {SERVICE_TIMEOUT_S} s") from e
    seconds = time.perf_counter() - t
    if out.returncode != 0:
        raise SystemExit(f"service: {' '.join(cmd)} exited {out.returncode}:\n"
                         f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    lines = out.stdout.strip().splitlines()
    try:
        res = json.loads(lines[-1])
    except (IndexError, ValueError):
        res = None
    if not isinstance(res, dict) or res.get("run") != "train_e2e_torch":
        raise SystemExit(f"service: no result line from {' '.join(cmd)}:\n{out.stdout[-2000:]}")
    return res, out.stdout, seconds


def service_checks(label, res, per_step) -> None:
    """Exits unless the losses are finite, the first batch's loss after the
    last step is below its loss at step 1 and the last batch's below its
    loss in the last step, every kernel launched at least ``per_step`` times
    a step, the peak memory is under 80 GB and the service left nothing
    running."""
    losses = res["losses"]
    first, last = res["first_batch_loss_after"], res["last_batch_loss_after"]
    if not losses or not all(math.isfinite(x) for x in losses + [first, last]):
        raise SystemExit(f"{label}: losses not finite: {losses}, after the run {first} "
                         f"(first batch), {last} (last batch)")
    if not first < losses[0] or not last < losses[-1]:
        raise SystemExit(f"{label}: a batch's loss did not fall: {losses}, after the run "
                         f"{first} (first batch), {last} (last batch)")
    peak = res["max_memory_allocated_gb"]
    if peak is None or not peak < 80.0:
        raise SystemExit(f"{label}: peak memory {peak} GB, want under 80 GB")
    if res["left_running"]["threads"] or res["left_running"]["processes"]:
        raise SystemExit(f"{label}: left running after the service stopped: "
                         f"{res['left_running']}")
    require_launches(label, res["launches"], per_step, res["steps"])


def phase_service(arch, B, S, steps):
    """``python -m repro_torch.launch.train --execute --full-width`` for one
    model: the data service's workers draw the batches, the DeviceFeeder
    moves them to the card, the trainer runs ``steps`` steps through the
    kernels built in phase 1.  Logs the feed beside phase 5's in-script
    feed for the model, and the dry run's FLOPs a step (the same config, B
    and S, on meta) with the achieved rate.  Returns the subprocess's
    launch counts over its steps (the main path)."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.config import ShapeConfig

    gc.collect()
    torch.cuda.empty_cache()
    label = f"service {arch}"
    cmd = service_command(arch, B, S, steps)
    log(f"{label}: {' '.join(cmd[1:])} (this process holds "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB of the card)")
    res, stdout, seconds = run_service(cmd)
    for line in stdout.strip().splitlines()[:-1]:
        log(f"  | {line}")
    service_checks(label, res, train_launches_per_step(get_config(arch)))
    dry = run_cell(arch, ShapeConfig("service", S, B, "train"))
    flops = dry["roofline"]["flops_per_device"]
    sps = res["steady_seconds_per_step"]
    feed = res["feed"]
    log(dict(phase="service", arch=arch, B=B, S=S, steps=steps, workers=res["workers"],
             losses=res["losses"], first_batch_loss_after=res["first_batch_loss_after"],
             last_batch_loss_after=res["last_batch_loss_after"],
             last_below_first=res["losses"][-1] < res["losses"][0],
             seconds_per_step=res["seconds_per_step"],
             steady_seconds_per_step=sps, tokens_per_s=res["tokens_per_s"],
             max_memory_allocated_gb=res["max_memory_allocated_gb"],
             feed_idle_s_per_step=feed["idle_s_per_step"],
             feed_idle_s_per_step_after_first=feed["idle_s_per_step_after_first"],
             feed_stall_fraction=feed["stall_frac"], feed_breakdown=feed["breakdown"],
             feed_bytes=feed["bytes_to_device"], in_script_feed=IN_SCRIPT_FEED.get(arch),
             dryrun_flops_per_step=flops, dryrun_flops_by_op=dry["flops_by_op"],
             achieved_tflops=flops / sps / 1e12,
             peak_share=flops / sps / PEAK_FLOPS["bfloat16"],
             kernel_builds_s=res["kernel_builds"], command_seconds=seconds,
             launches=res["launches"]))
    return res["launches"]


# ---------------------------------------------------------------------------
# phase 7: the distribution layer
# ---------------------------------------------------------------------------
# (a) phase 5's starcoder2-3b run (B = 1, S = 8192, f32 params and AdamW,
# bf16 compute, block remat) as a sharded train step: a (data, model) =
# (1, 1) DeviceMesh over one NCCL rank, the state placed by the sharding
# rules, the steps under use_plan and fed by DeviceFeeder(mesh=, plan=);
# then the same steps with no mesh from the same initial state and batches.
# A mesh of one device changes nothing in the reference, so the losses and
# every updated parameter must be bit-equal.  (b) int8 compression of the
# embedding's gradient at (a)'s state (49152 x 3072 f32).  (c) the dry run
# on the production meshes, partitioned on meta DTensors over a fake process
# group: one device's FLOPs and bytes, and the collectives it issues
# (launch/comm_cost.py); a null collective term fails.  (d) the partitioned
# step's boundary on the card: on (a)'s (1, 1) mesh the state and batches
# are DTensors (DTensor.from_local with the rules' placements), so every
# kernel wrapper takes them local (kernels/_boundary.py) before it launches;
# starcoder2-3b's 3 steps of (a) (flash forward and backward), one step of
# mamba2-2.7b at 4 layers (the SSD scan and its backward) and 4 decode steps
# of moonshot at 4 layers (router, decode) are bit-equal to the same steps on
# plain tensors.
DIST_RUN = ("starcoder2-3b", 1, 8192, 3)
# (arch, shape, mesh, reduced): the first cell at full size, the others at
# scaled_down() on the same meshes - at full size each took 40-49 s on the
# card's host, 177 s for the four, where the phase may add about 120 s
DIST_DRYRUN = (("llama3-405b", "train_4k", "single", False),
               ("llama3-405b", "train_4k", "multi", True),
               ("kimi-k2-1t-a32b", "train_4k", "single", True),
               ("kimi-k2-1t-a32b", "train_4k", "multi", True))
DIST_DRYRUN_TIMEOUT_S = 240
DIST_STOCHASTIC_TOL = 1e-3  # mean error of stochastic rounding, in units of the scale
# (arch, config changes, B, S, steps) of (d)'s train run beside (a)'s
DTENSOR_TRAIN = (("mamba2-2.7b", {"num_layers": 4}, 1, 8192, 1),)
# (arch, config changes, B, cache rows, decode steps) of (d)'s decode run
DTENSOR_DECODE = ("moonshot-v1-16b-a3b", {"num_layers": 4, "param_dtype": "bfloat16"}, 8, 256,
                  4)


def dtensor_tree(tree, shardings):
    """``tree``'s tensor leaves as ``DTensor``s with the placements of their
    shardings (``DTensor.from_local``; on a mesh of one device the leaf is
    its own shard, so no copy is made)."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.bridge import flatten_with_paths, map_with_paths
    from repro_torch.dist.placement import placements

    flat = dict(flatten_with_paths(shardings))

    def one(key, t):
        if not isinstance(t, torch.Tensor):
            return t
        sh = flat[key]
        return DTensor.from_local(t, sh.mesh, placements(sh), run_check=False)

    return map_with_paths(tree, one)


def _plain(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def dtensor_train(model, opt, state, batches, mesh, plan):
    """One train step a batch with ``state``'s params and moments and each
    batch as ``DTensor``s over ``mesh`` under ``plan``; ``state``'s tensors
    are updated in place.  Returns the losses and the seconds of each step."""
    from repro_torch.dist import sharding_rules as SR
    from repro_torch.dist.context import use_plan
    from repro_torch.train import make_train_step

    cfg = model.cfg
    run = {"params": dtensor_tree(state["params"],
                                  SR.make_param_shardings(mesh, state["params"], cfg, plan)),
           "opt": dict(state["opt"])}
    oshard = SR.make_opt_shardings(mesh, state["opt"], cfg, plan)
    for k in ("m", "v"):
        run["opt"][k] = dtensor_tree(state["opt"][k], oshard[k])
    step = make_train_step(model, opt)
    losses, secs = [], []
    with use_plan(plan, mesh):
        for b in batches:
            b = dtensor_tree(b, SR.batch_sharding(mesh, plan, b))
            t = time.perf_counter()
            _, m = step(run, b)
            losses.append(float(_plain(m["loss"])))
            secs.append(time.perf_counter() - t)
    state["opt"]["step"] = run["opt"]["step"]
    return losses, secs


def decode_logits(model, params, B, rows, tokens, mesh=None, plan=None):
    """The logits of ``len(tokens)`` decode steps from a zeroed cache of
    ``rows`` rows; over ``mesh`` the params, cache and tokens are
    ``DTensor``s laid out by the rules."""
    import contextlib

    import torch

    from repro_torch.dist import sharding_rules as SR
    from repro_torch.dist.context import use_plan

    dev = tokens[0].device
    cache = model.init_cache(B, rows, device=dev)
    scope = contextlib.nullcontext()
    if mesh is not None:
        cfg = model.cfg
        params = dtensor_tree(params, SR.make_param_shardings(mesh, params, cfg, plan))
        cache = dtensor_tree(cache, SR.cache_sharding(mesh, plan, cache, cfg))
        scope = use_plan(plan, mesh)
    out = []
    with torch.no_grad(), scope:
        for tok in tokens:
            if mesh is not None:
                tok = dtensor_tree({"t": tok}, SR.batch_sharding(mesh, plan, {"t": tok}))["t"]
            logits, cache = model.decode_step(params, cache, tok)
            out.append(_plain(logits))
    return out


def leaves_bit_equal(a, b):
    """(the keys of the leaves of tree ``a`` that differ from ``b``'s, their
    largest difference); ``b`` maps keys to tensors."""
    import torch

    from repro_torch.bridge import flatten_with_paths

    differ, worst = [], 0.0
    for k, t in flatten_with_paths(a):
        x, y = _plain(t).detach().cpu(), b[k].detach().cpu()
        if not torch.equal(x, y):
            differ.append(k)
            worst = max(worst, float((x.float() - y.float()).abs().max()))
    return differ, worst


def dryrun_verdict(rec) -> str:
    """Why a production-mesh record of (c) fails, or "" when it passes: a
    status other than OK, or a null or absent collective term."""
    if rec.get("status") != "OK":
        return f"status {rec.get('status')}: {rec.get('error', '')}"
    rl = rec.get("roofline") or {}
    if rl.get("collective_s") is None or rl.get("collective_bytes_per_device") is None:
        return "null collective term"
    if not isinstance((rl.get("memory_per_device_bytes") or {}).get("temp_bytes"), int):
        return "null temp_bytes"
    if not (rl.get("collective_breakdown") or {}).get("counts"):
        return "no collective breakdown"
    return ""


def run_dryrun_cell(arch, shape, mesh_name, out_dir, reduced=False, run=subprocess.run):
    """(c)'s cell in a process of its own (a process has one default process
    group, and the record's ``host_peak_rss_gb`` is then the cell's), at
    the config's ``scaled_down()`` when ``reduced``: the record and the
    command's seconds."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--mesh", mesh_name, "--out", out_dir] + (["--reduced", "--tag", "reduced"]
                                                    if reduced else [])
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t = time.perf_counter()
    res = run(cmd, capture_output=True, text=True, timeout=DIST_DRYRUN_TIMEOUT_S, env=env)
    seconds = time.perf_counter() - t
    tag = "reduced__" if reduced else ""
    path = os.path.join(out_dir, f"{mesh_name}__{tag}{arch}__{shape}.json")
    if res.returncode != 0 or not os.path.exists(path):
        return {"status": "FAIL", "error": res.stderr[-2000:]}, seconds
    with open(path) as f:
        return json.load(f), seconds


def phase_dtensor(mesh, plan, ref):
    """Phase 7(d) on (a)'s (1, 1) mesh; ``ref`` holds (a)'s losses, seconds
    a step and updated parameters (on the host).  Returns the launch counts
    of its DTensor runs (the main path through the boundary)."""
    import gc

    import torch

    from repro_torch.bridge import flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    def cuda_batches(cfg, B, S, steps):
        return [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
                for b in FamilyBatches(cfg, B, S, steps, seed=0).session()]

    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    arch, B, S, steps = DIST_RUN
    cfg = get_config(arch)
    model = build_model(cfg)
    opt = AdamWConfig(lr=2e-6, warmup_steps=steps)  # (a)'s
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), opt,
                             device="cuda")
    batches = cuda_batches(cfg, B, S, steps)
    (losses, secs), _, counts, peak = counted(
        f"dist dtensor {arch}", lambda: dtensor_train(model, opt, state, batches, mesh, plan))
    require_launches(f"dist dtensor {arch}", counts, train_launches_per_step(cfg), steps)
    differ, worst = leaves_bit_equal(state["params"], ref["snap"])
    equal = losses == ref["losses"] and not differ
    steady, ref_steady = secs[1:] or secs, ref["secs"][1:] or ref["secs"]
    log(dict(phase="dist/dtensor_train", arch=arch, B=B, S=S, steps=steps, losses=losses,
             losses_no_mesh=ref["losses"], bit_equal=equal, params_differ=differ[:8],
             params_max_abs_diff=worst, seconds_per_step=secs,
             steady_seconds_per_step=sum(steady) / len(steady),
             phase7a_steady_seconds_per_step=sum(ref_steady) / len(ref_steady),
             max_memory_allocated_gb=peak, launches=counts))
    if not equal:
        raise SystemExit(f"dist dtensor {arch}: the DTensor steps differ from the plain ones "
                         f"({len(differ)} leaves, largest difference {worst})")
    add(counts)
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()

    for arch, changes, B, S, steps in DTENSOR_TRAIN:
        cfg = get_config(arch).replace(**changes)
        model = build_model(cfg)
        opt = AdamWConfig(lr=2e-6, warmup_steps=steps)
        batches = cuda_batches(cfg, B, S, steps)
        plain = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), opt,
                                 device="cuda")
        step = make_train_step(model, opt)
        plain_losses = [float(step(plain, b)[1]["loss"]) for b in batches]
        snap = {k: t.detach().cpu() for k, t in flatten_with_paths(plain["params"])}
        del plain
        state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), opt,
                                 device="cuda")
        (losses, secs), _, counts, peak = counted(
            f"dist dtensor {arch}", lambda: dtensor_train(model, opt, state, batches, mesh, plan))
        require_launches(f"dist dtensor {arch}", counts, train_launches_per_step(cfg), steps)
        differ, worst = leaves_bit_equal(state["params"], snap)
        equal = losses == plain_losses and not differ
        log(dict(phase="dist/dtensor_train", arch=arch, layers=cfg.num_layers, B=B, S=S,
                 steps=steps, losses=losses, losses_no_mesh=plain_losses, bit_equal=equal,
                 params_differ=differ[:8], params_max_abs_diff=worst, seconds_per_step=secs,
                 max_memory_allocated_gb=peak, launches=counts))
        if not equal:
            raise SystemExit(f"dist dtensor {arch}: the DTensor step differs from the plain one")
        add(counts)
        del state, batches, snap
        gc.collect()
        torch.cuda.empty_cache()

    arch, changes, B, rows, steps = DTENSOR_DECODE
    cfg = get_config(arch).replace(**changes)
    model = build_model(cfg)
    params = model.cast_for_compute(model.init(torch.Generator(device="cuda").manual_seed(0),
                                               device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = [torch.randint(1, cfg.vocab_size, (B,), generator=gen, device="cuda",
                            dtype=torch.int32) for _ in range(steps)]
    want = decode_logits(model, params, B, rows, tokens)
    got, seconds, counts, peak = counted(
        f"dist dtensor {arch} decode",
        lambda: decode_logits(model, params, B, rows, tokens, mesh, plan))
    forward, per_step = expected_launches(cfg)
    require_launches(f"dist dtensor {arch} decode", counts, per_step, steps)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    log(dict(phase="dist/dtensor_decode", arch=arch, layers=cfg.num_layers, B=B, rows=rows,
             steps=steps, bit_equal=equal, seconds=seconds, max_abs_diff=diff,
             max_memory_allocated_gb=peak, launches=counts))
    if not equal:
        raise SystemExit(f"dist dtensor {arch}: the DTensor decode differs from the plain one")
    add(counts)
    del params, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def _dist_run(model, opt, B, S, steps, mesh=None, plan=None):
    """``steps`` train steps of ``model`` from the seed-0 state on
    ``FamilyBatches`` (seed 0); over ``mesh`` the state is placed by the
    sharding rules and the steps run under ``use_plan`` from
    ``DeviceFeeder(mesh=, plan=)``.  Returns the state, the losses, the
    seconds a step and the launch counts of the steps."""
    import contextlib

    import torch

    from repro_torch.dist import sharding_rules as SR
    from repro_torch.dist.context import use_plan
    from repro_torch.dist.placement import place_tree
    from repro_torch.feed import DeviceFeeder
    from repro_torch.train import init_train_state, make_train_step

    cfg = model.cfg
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), opt,
                             device="cuda")
    if mesh is not None:
        shard = SR.make_param_shardings(mesh, state["params"], cfg, plan)
        oshard = SR.make_opt_shardings(mesh, state["opt"], cfg, plan)
        state["params"] = place_tree(state["params"], shard)
        for k in ("m", "v"):
            state["opt"][k] = place_tree(state["opt"][k], oshard[k])
        feed_kw, scope = dict(mesh=mesh, plan=plan), use_plan(plan, mesh)
    else:
        feed_kw, scope = dict(device="cuda"), contextlib.nullcontext()
    step = make_train_step(model, opt)
    losses, secs = [], []
    with DeviceFeeder(FamilyBatches(cfg, B, S, steps, seed=0), depth=2, **feed_kw) as feeder:
        def run_steps():
            with scope:
                for _ in range(steps):
                    t = time.perf_counter()
                    _, m = step(state, feeder.next())
                    losses.append(float(m["loss"]))
                    secs.append(time.perf_counter() - t)

        _, _, counts, peak = counted(f"dist {cfg.name} {'mesh' if mesh else 'no mesh'}",
                                     run_steps)
        shardings = feeder.shardings
    return state, losses, secs, counts, peak, shardings


def phase_dist():
    """Phase 7; returns the launch counts of (a)'s sharded steps and (d)'s
    DTensor runs (the main path)."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.bridge import flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.dist import compression as C
    from repro_torch.dist.context import use_plan
    from repro_torch.launch.mesh import make_plan, make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, make_loss_fn

    arch, B, S, steps = DIST_RUN
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_test_mesh(1, 1, device_type="cuda")
        plan = make_plan(mesh)
        log(f"dist: {mesh} over {dist.get_world_size()} {dist.get_backend()} rank, plan {plan}")
        cfg = get_config(arch)
        model = build_model(cfg)
        opt = AdamWConfig(lr=2e-6, warmup_steps=steps)  # phase 5's
        state, losses, secs, counts, peak, b_shard = _dist_run(model, opt, B, S, steps, mesh,
                                                               plan)
        per_step = train_launches_per_step(cfg)
        require_launches(f"dist {arch} sharded", counts, per_step, steps)
        if peak >= 80.0:
            raise SystemExit(f"dist {arch}: peak memory {peak:.1f} GB, not under 80 GB")
        snap = {k: t.detach().cpu() for k, t in flatten_with_paths(state["params"])}
        # (b)'s leaf: the embedding's gradient at the state after the steps,
        # on the run's first batch, under the plan
        batch = next(iter(FamilyBatches(cfg, B, S, 1, seed=0).session()))
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        params = dict(state["params"])
        params["embed"] = params["embed"].detach().requires_grad_(True)
        with use_plan(plan, mesh):
            loss, _ = make_loss_fn(model)(params, batch)
            (grad,) = torch.autograd.grad(loss, [params["embed"]])
        del state, params, loss
        gc.collect()
        torch.cuda.empty_cache()

        plain, plain_losses, plain_secs, plain_counts, plain_peak, _ = _dist_run(
            model, opt, B, S, steps)
        differ, worst = leaves_bit_equal(plain["params"], snap)
        equal = losses == plain_losses and not differ
        steady = secs[1:] or secs
        plain_steady = plain_secs[1:] or plain_secs
        log(dict(phase="dist/sharded_train", arch=arch, B=B, S=S, steps=steps,
                 mesh={n: int(s) for n, s in zip(mesh.mesh_dim_names, mesh.shape)},
                 backend=dist.get_backend(), plan=str(plan),
                 batch_shardings={k: list(v.spec) for k, v in b_shard.items()},
                 losses=losses, losses_no_mesh=plain_losses, bit_equal=equal,
                 params_differ=differ[:8], params_max_abs_diff=worst,
                 seconds_per_step=secs, steady_seconds_per_step=sum(steady) / len(steady),
                 no_mesh_seconds_per_step=plain_secs,
                 no_mesh_steady_seconds_per_step=sum(plain_steady) / len(plain_steady),
                 phase5_seconds_per_step=IN_SCRIPT_FEED.get(arch, {}).get("seconds_per_step"),
                 max_memory_allocated_gb=peak, no_mesh_max_memory_allocated_gb=plain_peak,
                 launches=counts, launches_no_mesh=plain_counts,
                 launches_per_step_want=per_step))
        if not equal:
            raise SystemExit(f"dist {arch}: the sharded steps differ from the unsharded ones "
                             f"(losses {losses} vs {plain_losses}; {len(differ)} leaves, "
                             f"largest difference {worst})")
        del plain
        gc.collect()
        torch.cuda.empty_cache()

        # (b) compression of the gradient leaf on the card
        bound = C.compression_error_bound(grad)
        q, s = C.quantize_int8(grad)
        q_cpu, s_cpu = C.quantize_int8(grad.cpu())
        codes_equal = torch.equal(q.cpu(), q_cpu)
        scale_equal = s.cpu().numpy().tobytes() == s_cpu.numpy().tobytes()
        err = float((C.dequantize_int8(q, s) - grad).abs().max())
        gen = torch.Generator(device="cuda").manual_seed(0)
        qs, ss = C.quantize_int8(grad, gen)
        mean_err = float((C.dequantize_int8(qs, ss) - grad).double().mean().abs())
        summed = C.compressed_psum(grad, mesh, "data")
        psum_equal = torch.equal(summed, C.dequantize_int8(q, s))
        times = {"quantize_nearest_ms": time_ms(lambda: C.quantize_int8(grad)),
                 "quantize_stochastic_ms": time_ms(lambda: C.quantize_int8(grad, gen)),
                 "dequantize_ms": time_ms(lambda: C.dequantize_int8(q, s)),
                 "compressed_psum_ms": time_ms(lambda: C.compressed_psum(grad, mesh, "data"))}
        ok = (codes_equal and scale_equal and err <= bound
              and mean_err < DIST_STOCHASTIC_TOL * float(ss) and psum_equal)
        log(dict(phase="dist/compression", leaf="embed grad", shape=list(grad.shape),
                 dtype=str(grad.dtype), mbytes=grad.numel() * 4 / 1e6, scale=float(s),
                 codes_equal_cpu=codes_equal, scale_bit_equal_cpu=scale_equal,
                 nearest_max_abs_err=err, bound=bound,
                 stochastic_mean_err=mean_err, stochastic_tol=DIST_STOCHASTIC_TOL * float(ss),
                 compressed_psum_equal_dq_q=psum_equal, ok=ok, **times))
        if not ok:
            raise SystemExit("dist: int8 compression on the card disagrees (see the record)")
        del grad, q, qs, summed
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the same steps with the state and batches as DTensors
        d_counts = phase_dtensor(mesh, plan, dict(losses=losses, secs=secs, snap=snap))
        del snap
        for k, v in d_counts.items():
            counts[k] = counts.get(k, 0) + v
    finally:
        dist.destroy_process_group()
    log(f"dist: process group destroyed (initialized: {dist.is_initialized()})")

    # (c) the dry run's production meshes, partitioned on meta
    out_dir = os.path.join(ROOT, "chiprun_out", "dryrun_dist")
    os.makedirs(out_dir, exist_ok=True)
    for arch, shape, mesh_name, reduced in DIST_DRYRUN:
        rec, seconds = run_dryrun_cell(arch, shape, mesh_name, out_dir, reduced)
        rl = rec.get("roofline") or {}
        coll = rl.get("collective_breakdown") or {}
        log(dict(phase="dist/dryrun", arch=arch, shape=shape, mesh=mesh_name,
                 reduced=reduced,
                 status=rec["status"], chips=rl.get("chips"), plan=rec.get("plan"),
                 argument_bytes_per_device=(rl.get("memory_per_device_bytes") or {}).get(
                     "argument_bytes"),
                 temp_bytes_per_device=(rl.get("memory_per_device_bytes") or {}).get(
                     "temp_bytes"),
                 fits_hbm_80g=rec.get("fits_hbm_80g"),
                 flops_per_device=rl.get("flops_per_device"),
                 bytes_per_device=rl.get("bytes_per_device"),
                 collective_bytes_per_device=rl.get("collective_bytes_per_device"),
                 collective_bytes_by_kind={k: coll.get(k) for k in (
                     "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                     "collective-permute")},
                 collective_counts=coll.get("counts"), collective_by_axis=coll.get("by_axis"),
                 compute_s=rl.get("compute_s"), memory_s=rl.get("memory_s"),
                 collective_s=rl.get("collective_s"), dominant=rl.get("dominant"),
                 trace_s=rec.get("trace_s"), command_seconds=seconds,
                 host_peak_rss_gb=rec.get("host_peak_rss_gb")))
        why = dryrun_verdict(rec)
        if why:
            raise SystemExit(f"dist dry run {arch} {shape} {mesh_name}: {why}")
    return counts


def _max_leaf_err(a, b) -> float:
    return max(float((x.detach().cpu().float() - y.detach().float()).abs().max())
               for x, y in zip(_leaves(a), _leaves(b)))


def phase_train_check(arch, replace):
    """One f32 train step of ``arch`` (its train run's changes ``replace``)
    at 2 layers with ``TRAIN_CHECK``'s changes (B=1, S=256, a
    ``FamilyBatches`` batch) through the kernels on the card against the
    same step through the plain route (``_attn_chunked``, the chunked SSD
    einsums, ``top_k`` plus cumsum, and autograd) on CPU copies of the same
    parameters and batch."""
    import gc

    import torch

    from repro_torch.bridge import map_with_paths
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    cfg = get_config(arch).replace(**{**replace, "num_layers": 2, "dtype": "float32",
                                      **TRAIN_CHECK.get(arch, {})})
    model = build_model(cfg)
    opt = AdamWConfig(lr=CHECK_LR, eps=CHECK_EPS, warmup_steps=1)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    cpu_params = map_with_paths(params, lambda _, t: t.cpu().clone())
    gpu = {"params": params, "opt": init_state(params, opt)}
    cpu = {"params": cpu_params, "opt": init_state(cpu_params, opt)}
    batch = next(iter(FamilyBatches(cfg, 1, 256, 1, seed=1).session()))
    batch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    (_, mg), _, counts, peak = counted(
        f"train_check_f32 {arch}", lambda: make_train_step(model, opt)(
            gpu, {k: v.cuda() for k, v in batch.items()}))
    _, mc = make_train_step(model, opt)(cpu, batch)
    per_step = train_launches_per_step(cfg)
    loss_err = abs(float(mg["total_loss"]) - float(mc["total_loss"])) / abs(float(mc["total_loss"]))
    gn_err = abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) / float(mc["grad_norm"])
    p_err = _max_leaf_err(gpu["params"], cpu["params"])
    ok = (loss_err <= CHECK_TOL["loss"] and gn_err <= CHECK_TOL["grad_norm"]
          and p_err <= CHECK_TOL["params"])
    log(dict(phase="train_check_f32", arch=arch, layers=2, batch=sorted(batch), B=1, S=256,
             lr=CHECK_LR,
             eps=CHECK_EPS, loss_card=float(mg["total_loss"]), loss_cpu=float(mc["total_loss"]),
             loss_rel_err=loss_err, grad_norm_rel_err=gn_err, params_max_abs_err=p_err,
             tol=CHECK_TOL, ok=ok, launches=counts, max_memory_allocated_gb=peak))
    if not ok:
        raise SystemExit(f"train_check_f32 {arch}: the card's train step disagrees with the "
                         "plain route")
    require_launches(f"train_check_f32 {arch}", counts, per_step, 1)
    del gpu, cpu, params, cpu_params
    gc.collect()
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


KERNEL_META = {
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:35"),
    "decode_attention": dict(
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:33"),
    "ssd_scan": dict(
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:32"),
    "moe_router": dict(
        source="src/repro_torch/kernels/csrc/moe_router.cu",
        replaces="src/repro/kernels/moe_router/kernel.py:29"),
    "fused_augment": dict(
        source="src/repro_torch/kernels/csrc/fused_augment.cu",
        replaces="src/repro/kernels/fused_augment/kernel.py:29",
        note="no model path calls it in either package: launches are those of its own op "
             "phase (augment)"),
    "flash_attention_bwd": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/layers.py:89",
        note="the port's own kernel: no TPU kernel computes it; JAX trains through autograd "
             "of _attn_chunked (XLA)"),
    "ssd_scan_bwd": dict(
        source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        replaces="src/repro/models/layers.py:362",
        note="the port's own kernel: no TPU kernel computes it; JAX trains through autograd "
             "of the jnp mamba2_mixer (XLA)"),
    "moe_router_bwd": dict(
        source="src/repro_torch/kernels/csrc/moe_router.cu",
        replaces="src/repro/models/layers.py:267",
        note="the port's own kernel (route_bwd): no TPU kernel computes it; JAX trains "
             "through autograd of the jnp moe_ffn (XLA)"),
    "causal_conv": dict(
        source="src/repro_torch/kernels/csrc/causal_conv.cu",
        replaces="src/repro/models/layers.py:383",
        note="the port's own kernel: no TPU kernel computes it; XLA fuses the JAX mixer's "
             "conv and SiLU, eager PyTorch ran them as a dozen kernels"),
    "causal_conv_bwd": dict(
        source="src/repro_torch/kernels/csrc/causal_conv.cu",
        replaces="src/repro/models/layers.py:383",
        note="the port's own kernel: JAX trains through autograd of the jnp mixer (XLA)"),
    "rms_norm": dict(
        source="src/repro_torch/kernels/csrc/rms_norm.cu",
        replaces="src/repro/models/layers.py:41",
        note="the port's own kernel: no TPU kernel computes it; XLA fuses the JAX norms, the "
             "mixer's gated one included, eager PyTorch ran them as 8 to 11 kernels"),
    "rms_norm_bwd": dict(
        source="src/repro_torch/kernels/csrc/rms_norm.cu",
        replaces="src/repro/models/layers.py:41",
        note="the port's own kernel: JAX trains through autograd of the jnp norms (XLA)"),
    "adamw_update": dict(
        source="src/repro_torch/kernels/csrc/adamw.cu",
        replaces="src/repro/train/optimizer.py:71",
        note="the port's own kernel: no TPU kernel computes it; XLA fuses the JAX update "
             "(upd) into one loop a leaf, eager PyTorch ran it as eleven tensor ops"),
}
# the parity case at the main path's shape that each kernel's line reports.
# ssd_scan's is f32: mamba2-2.7b's mixer runs its conv with the f32 params
# uncast (as the JAX function does), so the scan gets f32 x, B and C even in
# bf16 compute; the bf16 case beside it is reported on its own line.
MAIN_CASE = {"flash_attention": f"main_S{PREFILL_S}", "decode_attention": "main_serve_B8_S256",
             "ssd_scan": "mamba2_prefill_mamba2_regime", "moe_router": "moonshot_prefill",
             "fused_augment": "imagenet_B256", "flash_attention_bwd": f"main_S{PREFILL_S}",
             "ssd_scan_bwd": "mamba2_train_S8192", "moe_router_bwd": "moonshot_train_T4096",
             "causal_conv": "mamba2_train_B4_L2048", "causal_conv_bwd": "mamba2_train_B4_L2048",
             "rms_norm": "mamba2_gated_B4_L2048", "rms_norm_bwd": "mamba2_gated_B4_L2048",
             "adamw_update": "mamba2_in_proj"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})", file=sys.stderr)
        return 1

    phase_env()
    recs = phase_kernels(PREFILL_S)
    recs += conv_cases()
    recs += norm_cases()
    recs += adamw_cases()
    phase_kernel_memory()
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    for spec in MODELS:
        add(phase_model(*spec))
    add(phase_encdec())
    add(phase_augment(torch.Generator(device="cuda").manual_seed(2)))
    for run in TRAIN_RUNS:
        add(phase_train(*run))
    for arch, replace, *_ in TRAIN_RUNS:
        phase_train_check(arch, replace)
    for run in SERVICE_RUNS:
        add(phase_service(*run))
    add(phase_dist())

    kernels = []
    for name, meta in KERNEL_META.items():
        r = next(r for r in recs if r["kernel"] == name and r["case"] == MAIN_CASE[name])
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=totals.get(name, 0), max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
            device_ms=r.get("device_ms"), plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            **{key: r[key] for key in ("library_device_ms", "tflops", "bound_share")
               if key in r},
            **({"note": meta["note"]} if "note" in meta else {})))
    if not all(k["launches"] > 0 for k in kernels):
        raise SystemExit(f"a kernel of the main path never launched: {totals}")
    log({"kernels": kernels})
    log(card_line())
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
