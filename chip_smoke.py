#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero, and the final line is printed only when
every phase passed):

1. env      - the card's name and power limit (nvidia-smi), torch/CUDA
              versions, TF32 off for f32 products, and the nvcc build of every
              kernel in ``src/repro_torch/kernels/csrc`` (build seconds).
2. kernels  - each hand-written kernel against its plain PyTorch version on
              the card, at the main path's shapes and the edge cases of the
              JAX package's kernel tests; one JSON line per case with the
              error, tolerance, kernel / plain / library times and the bound.
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
              its achieved TFLOP/s and share of its bound.
3. models   - at full width, random weights from a seeded generator, for
              starcoder2-3b (dense), mamba2-2.7b (SSM) and moonshot-v1-16b-a3b
              (MoE, bf16 parameters): (a) a prefill, (b) a ServeEngine
              answering 8 requests, (c) teacher-forced decode logits against
              forward logits in f32 (moonshot at 4 of its 48 layers).  Launch
              counters are reset just before and read just after each of
              (a)-(c), and a run with fewer launches than the model's layers
              need fails; each phase logs its peak device memory and (a), (b)
              a profile of device time and idle share.
4. augment  - ``fused_augment`` as its users call it: ResNet-50's ImageNet
              recipe (256 images 256x256x3 cropped to 224x224, random
              corners and flips) on 8 batches; no model path calls it in
              either package, so this op phase is its main path.
5. train    - starcoder2-3b at full width (f32 parameters and AdamW state,
              bf16 compute, ``remat="block"``), fed by a
              ``repro_torch.feed.DeviceFeeder`` over packed zipf token
              batches (B=1, S=8192): 6 steps with the loss, seconds and
              tokens per step, peak memory, the feed's idle and stall
              numbers, flash forward/backward launches per step (30 + 30
              recomputed + 30 backward; fewer fails) and a profiled step;
              then the same model at 2 layers in f32 (B=1, S=256): one
              train step through the kernels on the card against the same
              step on CPU copies through the plain route (loss, gradient
              norm, updated parameters, each against a stated tolerance).
6. a ``{"kernels": [...]}`` line with each kernel's launches on the main
   paths ((a) and (b) of every model, the augment phase, the 6 train steps;
   the checks are reported on their own lines) and its times, then the card
   line, then ``{"ok": true, ...}``.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (dense): bf16 tensor cores, f32 outside
# the tensor cores, HBM bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
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
TRAIN_ARCH = "starcoder2-3b"
TRAIN_S = 8192
TRAIN_STEPS = 6
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


def profile_device(label: str, fn) -> None:
    """Runs ``fn`` once under ``torch.profiler`` and prints the device time
    of the kernels it ran against the wall time (the profiler's own cost
    makes the idle share an upper bound), plus the costliest kernels."""
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
                               calls=e.count) for e in top]))


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


def flash_flops(B, Sq, Sk, Hq, D, causal=True, window=0, q_offset=0, backward=False) -> float:
    """The least FLOPs of a flash call on this run's masks: 4 D a visible
    pair (Q K^T and P V) forward; 2.5x that backward (Q K^T, dO V^T, P^T dO,
    dS^T Q, dS K)."""
    fwd = 4.0 * B * Hq * D * _visible_pairs(Sq, Sk, causal, window, q_offset)
    return 2.5 * fwd if backward else fwd


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


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
        hopper_spills.update({k: v for k, v in spills.items() if k.split("<")[0].endswith("_sm90")})
    if hopper_spills:
        raise SystemExit(f"ptxas: the Hopper flash kernels spill: {hopper_spills}")


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
def _visible_pairs(Sq, Sk, causal, window, q_offset=0) -> int:
    import numpy as np

    qp = q_offset + np.arange(Sq)
    hi = np.minimum(qp + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(qp - window + 1, 0) if window > 0 else np.zeros(Sq, dtype=np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


def flash_case(name, B, Sq, Sk, Hq, Hkv, D, dtype, causal=True, window=0, softcap=0.0,
               q_offset=0, blocks=None, iters=10, library=True, gen=None):
    """The forward kernel at each tile of ``blocks`` (default: the dtype's
    default tile) against its plain version in f32 on the same inputs."""
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
    kernel_ms = time_ms(lambda: flash_attention(q, k, v, block_q=bq, block_k=bk, **kw), iters)
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
               bound_share=bound_ms / kernel_ms, ok=ok)
    log(rec)
    del want32, want, outs
    torch.cuda.empty_cache()
    return rec


def decode_case(name, B, S, Hq, Hkv, D, dtype, lengths, window=0, splits=(8,), block_s=256,
                iters=20, gen=None):
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
    torch.cuda.synchronize()
    err = max(float((o.float() - want).abs().max()) for o in outs)
    rel = max(row_rel_err(o, want32) for o in outs)
    spread = max(float((o.float() - outs[0].float()).abs().max()) for o in outs)
    tol = TOL[dtype]
    rel_tol = REL_TOL if dtype == "bfloat16" else None
    ok = (err <= tol and spread <= tol and (rel_tol is None or rel <= rel_tol)
          and all(bool(torch.isfinite(o).all()) for o in outs))
    ns0 = splits[0]
    kernel_ms = time_ms(
        lambda: decode_attention(q, kc, vc, lens, window=window, num_splits=ns0,
                                 block_s=block_s), iters)
    plain_ms = time_ms(lambda: decode_attention_ref(q, kc, vc, lens, window=window),
                       max(2, iters // 5), 1)
    pos = torch.arange(S, device="cuda")[None, :]
    mask = pos < lens[:, None].long()
    if window > 0:
        mask &= pos > lens[:, None].long() - 1 - window
    qt = q[:, :, None, :]
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    m4 = mask[:, None, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=m4, enable_gqa=True), iters)
    visible = int(mask.sum())
    flops = 4.0 * Hq * D * visible
    nbytes = (2 * visible * Hkv * D + 2 * q.numel()) * q.element_size() + lens.numel() * 4
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    rec = dict(kernel="decode_attention", case=name,
               shape=dict(B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, window=window, splits=list(splits),
                          block_s=block_s, lengths=list(lengths)),
               dtype=dtype, max_abs_err=err, split_spread=spread, tol=tol,
               row_rel_err=rel, rel_tol=rel_tol,
               kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, ok=ok)
    log(rec)
    torch.cuda.empty_cache()
    return rec


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


def ssd_flops(B, L, H, P, N, chunk) -> float:
    """Per chunk of q tokens and head: the q(q+1)/2 causal entries of C.B^T
    (2N each) and of W x (2P each, W[i, j] = 0 for j > i), plus 4qNP (C h
    and the state update); the ragged last chunk counts its own q."""
    Q = min(chunk, L)
    qs = [min(Q, L - c) for c in range(0, L, Q)]
    return float(B * H * sum(q * (q + 1) * (N + P) + 4 * q * N * P for q in qs))


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
    """ssd_scan against its plain version (the token recurrence) on the same
    inputs (``ssd_inputs``) for y and the final state."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref

    G = groups or H
    x, dt, a, Bm, Cm, D = ssd_inputs(B, L, H, P, N, G, dtype, regime, gen)
    # the plain version computes in f32 from the same (rounded) inputs
    want32, h32 = ssd_scan_ref(x.float(), dt, a, Bm.float(), Cm.float(), D)
    outs = [ssd_scan(x, dt, a, Bm, Cm, D, chunk=c) for c in chunks]
    torch.cuda.synchronize()
    err = max(float((y.float() - want32).abs().max()) for y, _ in outs)
    ratio = max(ssd_ratio(y, want32, dtype) for y, _ in outs)
    state_ratio = max(ssd_ratio(h, h32, "float32") for _, h in outs)
    spread = max(float((y.float() - outs[0][0].float()).abs().max()) for y, _ in outs)
    rel = row_rel_err(outs[0][0], want32) if dtype == "bfloat16" else None
    ok = (ratio <= 1.0 and state_ratio <= 1.0 and spread <= SSD_CHUNK_TOL
          and (rel is None or rel <= REL_TOL)
          and all(bool(torch.isfinite(y).all()) for y, _ in outs))
    c0 = chunks[0]
    kernel_ms = time_ms(lambda: ssd_scan(x, dt, a, Bm, Cm, D, chunk=c0), iters)
    plain_ms = time_ms(lambda: ssd_scan_ref(x, dt, a, Bm, Cm, D), 1, 1)
    flops = ssd_flops(B, L, H, P, N, c0)
    nbytes = ((2 * x.numel() + Bm.numel() + Cm.numel()) * x.element_size()
              + 4 * (dt.numel() + a.numel() + D.numel() + B * H * N * P))
    bound_ms, bound_by = bound(flops, nbytes, "float32")  # f32 arithmetic for either type
    rec = dict(kernel="ssd_scan", case=name,
               shape=dict(B=B, L=L, H=H, P=P, N=N, G=G, chunks=list(chunks)), regime=regime,
               dtype=dtype,
               max_abs_err=err, err_over_allowed=ratio, state_err_over_allowed=state_ratio,
               chunk_spread=spread, tol=SSD_TOL, chunk_tol=SSD_CHUNK_TOL, row_rel_err=rel,
               rel_tol=REL_TOL if rel is not None else None, kernel_ms=kernel_ms,
               plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by, ok=ok)
    log(rec)
    del want32, h32, outs
    torch.cuda.empty_cache()
    return rec


def router_case(name, T, E, k, ties=False, iters=20, gen=None):
    """moe_router against its plain version: ids and slots bit-exact, gates
    within 1e-6.  ``ties``: integer logits, so many experts tie exactly."""
    import torch

    from repro_torch.kernels.moe_router import moe_router, moe_router_ref

    if ties:
        logits = torch.randint(0, 3, (T, E), generator=gen, device="cuda").float()
        logits[: T // 8] = 1.0  # rows where every expert ties
    else:
        logits = torch.randn((T, E), generator=gen, device="cuda")
    got = moe_router(logits, k)
    want = moe_router_ref(logits, k)
    torch.cuda.synchronize()
    agree = router_agreement(got, want)
    kernel_ms = time_ms(lambda: moe_router(logits, k), iters)
    plain_ms = time_ms(lambda: moe_router_ref(logits, k), max(2, iters // 5), 1)
    # softmax (max, exp, sum, divide) and k rounds of compare-select, per logit
    flops = float(T * E * (4 + 2 * k))
    nbytes = 4.0 * (T * E + 3 * T * k)
    bound_ms, bound_by = bound(flops, nbytes, "float32")
    rec = dict(kernel="moe_router", case=name, shape=dict(T=T, E=E, k=k, ties=ties),
               dtype="float32", max_abs_err=agree["gate_err"], tol=GATE_TOL,
               ids_equal=agree["ids_equal"], slots_equal=agree["slots_equal"],
               kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
               bound_by=bound_by, ok=agree["ok"])
    log(rec)
    return rec


def augment_inputs(B, H, W, C, oh, ow, corners, gen):
    """images, crops, flips, mean, std on the card.  ``corners="random"``:
    each corner within the image, as the JAX suite draws them;
    ``"out_of_range"``: corners anywhere in [-H, 2H) x [-W, 2W), which the
    kernel and the plain version clamp as ``lax.dynamic_slice`` does."""
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
    mean = torch.tensor(IMAGENET_MEAN[:C], device="cuda")
    std = torch.tensor(IMAGENET_STD[:C], device="cuda")
    return img, crops, flips, mean, std


def augment_bound(B, oh, ow, C):
    """Bytes: the crop windows read once (uint8) and the output written once
    (f32), plus corners, flags, mean and std; one FMA per output value."""
    n = B * oh * ow * C
    return bound(2.0 * n, 5.0 * n + 12.0 * B + 8.0 * C, "float32")


def augment_case(name, B, H, W, C, oh, ow, corners="random", iters=20, gen=None):
    """fused_augment against its plain version, atol = rtol = 1e-5."""
    import torch

    from repro_torch.kernels.fused_augment import fused_augment, fused_augment_ref

    args = augment_inputs(B, H, W, C, oh, ow, corners, gen)
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
               shape=dict(B=B, H=H, W=W, C=C, out_h=oh, out_w=ow, corners=corners),
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
    the kernel's."""
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
    library_ms = None
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
        library_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                         retain_graph=True), iters, 1)
        del out, qt, kt, vt
    flops = flash_flops(B, Sq, Sk, Hq, D, causal, window, q_offset, backward=True)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4.0 * B * Hq * Sq
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    rec = dict(kernel="flash_attention_bwd", case=name,
               shape=dict(B=B, Sq=Sq, Sk=Sk, Hq=Hq, Hkv=Hkv, D=D, causal=causal, window=window,
                          softcap=softcap, q_offset=q_offset),
               dtype=dtype, max_abs_err=max(errs), errs_dq_dk_dv=errs, tol=TOL[dtype],
               err_over_allowed=ratios, grad_row_rel_err=rels, rel_tol=rel_tol,
               bit_equal_across_runs=bit_equal, kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               tflops=achieved_tflops(flops, kernel_ms), bound_share=bound_ms / kernel_ms, ok=ok)
    log(rec)
    del o, lse
    torch.cuda.empty_cache()
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
                    window=1000, splits=(1, 2, 8), block_s=128, gen=g),
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
    bad = [r["case"] for r in recs if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel parity failed: {bad}")
    log(f"kernel parity: {len(recs)} cases passed; launches while comparing "
        f"(not counted as main path): {launch_counts()}")
    reset_launch_counts()
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
# at 4 of its 48 layers (1 dense + 3 MoE), dropless as decode is.
MODELS = (
    ("starcoder2-3b", {}, PREFILL_S, {}, (32,)),
    ("mamba2-2.7b", {}, 8192, {}, (32, 40)),
    ("moonshot-v1-16b-a3b", {"param_dtype": "bfloat16"}, 4096,
     {"param_dtype": "float32", "num_layers": 4, "capacity_factor": 64.0}, (32,)),
)


def expected_launches(cfg):
    """Kernel launches of one forward and of one decode step: one per
    attention layer (flash / decode), per mamba2 layer (ssd_scan, forward
    only: decode runs the recurrence) and per MoE layer (moe_router)."""
    from repro_torch.models.lm import layer_pattern

    pattern = layer_pattern(cfg)
    attn = sum(m == "attn" for m, _ in pattern)
    ssm = sum(m == "ssm" for m, _ in pattern)
    moe = sum(f == "moe" for _, f in pattern)
    forward = {"flash_attention": attn, "ssd_scan": ssm, "moe_router": moe}
    step = {"decode_attention": attn, "moe_router": moe}
    return ({k: v for k, v in forward.items() if v}, {k: v for k, v in step.items() if v})


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
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    cparams = model.cast_for_compute(params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{arch}: {cfg.num_layers} layers {[g.subpattern for g in model.groups]}, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, params {cfg.param_dtype}, compute {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; launches per forward "
        f"{per_forward}, per decode step {per_step}")
    gen = torch.Generator(device="cuda").manual_seed(1)

    # (a) prefill; a short warm-up first
    model.forward(cparams, {"tokens": torch.randint(0, cfg.vocab_size, (1, 256), device="cuda")},
                  last_token_only=True)
    toks = torch.randint(0, cfg.vocab_size, (1, prefill_S), generator=gen, device="cuda")
    logits, secs, counts, peak = counted(
        f"{arch} prefill", lambda: model.forward(cparams, {"tokens": toks}, last_token_only=True))
    if logits.shape != (1, 1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"{arch} prefill logits bad: shape {tuple(logits.shape)}")
    require_launches(f"{arch} prefill", counts, per_forward, 1)
    totals = dict(counts)
    log(dict(phase=f"{arch}/prefill", B=1, S=prefill_S, seconds=secs,
             tokens_per_s=prefill_S / secs, max_memory_allocated_gb=peak))
    profile_device(f"{arch}/prefill", lambda: model.forward(cparams, {"tokens": toks},
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


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------
def phase_augment(gen, batches: int = 8):
    """fused_augment as its users call it: ResNet-50's ImageNet recipe, 256
    images of 256x256x3 cropped to 224x224 at random corners with random
    flips, on ``batches`` batches; the launch counts are this phase's."""
    import torch

    from repro_torch.kernels.fused_augment import fused_augment

    data = [augment_inputs(256, 256, 256, 3, 224, 224, "random", gen) for _ in range(batches)]

    def run():
        return [fused_augment(*args, 224, 224) for args in data]

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


class _ZipfSession:
    def __init__(self, src: ZipfTokens):
        self.src = src
        self.closed = False

    def __iter__(self):
        import numpy as np

        src = self.src
        rng = np.random.default_rng(src.seed)
        for _ in range(src.steps):
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
            yield {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def close(self):
        self.closed = True


def train_launches_per_step(cfg):
    """Flash launches of one train step under ``remat="block"``: a forward
    per attention layer, one more for each layer of a repeated group (the
    recomputation), and a backward per attention layer."""
    from repro_torch.models.lm import compute_groups

    fwd = recompute = 0
    for g in compute_groups(cfg):
        n = g.repeats * sum(m == "attn" for m, _ in g.subpattern)
        fwd += n
        if cfg.remat == "block" and g.repeats > 1:
            recompute += n
    return {"flash_attention": fwd + recompute, "flash_attention_bwd": fwd}


def phase_train():
    """starcoder2-3b at full width, fed by a DeviceFeeder: TRAIN_STEPS
    steps, then a profiled one.  Returns the launches of the TRAIN_STEPS
    steps (the main path)."""
    import gc
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.feed import DeviceFeeder
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    # A warmup as in real runs.  AdamW's first steps move every entry by
    # about lr, along a gradient spread over 3.2 B random parameters, so the
    # loss is steep along them: a first step of lr 2.5e-4 throws it from
    # 11.3 to 20, and steps of 3.3e-6 already overshoot.  lr rises to 2e-6
    # over the 6 steps.
    opt = AdamWConfig(lr=2e-6, warmup_steps=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), opt,
                             device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    log(f"train {TRAIN_ARCH}: {cfg.num_layers} layers, params {cfg.param_dtype}, compute "
        f"{cfg.dtype}, remat {cfg.remat}, {n_params / 1e9:.3f} B params, AdamW state "
        f"{opt.state_dtype}; init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    step = make_train_step(model, opt)
    per_step = train_launches_per_step(cfg)
    src = ZipfTokens(cfg.vocab_size, 1, TRAIN_S, TRAIN_STEPS + 1, seed=0)
    losses, secs = [], []
    with DeviceFeeder(src, device="cuda", depth=2) as feeder:
        def steps():
            for _ in range(TRAIN_STEPS):
                t = time.perf_counter()
                batch = feeder.next()
                _, m = step(state, batch)
                losses.append(float(m["loss"]))  # host sync: the step is done
                secs.append(time.perf_counter() - t)
                log(dict(phase="train/step", step=len(losses), loss=losses[-1],
                         total_loss=float(m["total_loss"]), grad_norm=float(m["grad_norm"]),
                         lr=float(m["lr"]), seconds=secs[-1]))

        _, _, counts, peak = counted(f"train {TRAIN_ARCH} {TRAIN_STEPS} steps", steps)
        feed = feeder.metrics.summary()
        profile_device(f"{TRAIN_ARCH}/train_step", lambda: step(state, feeder.next()))
    steady = secs[1:] if len(secs) > 1 else secs
    sps = sum(steady) / len(steady)
    log(dict(phase="train", arch=TRAIN_ARCH, B=1, S=TRAIN_S, steps=TRAIN_STEPS, losses=losses,
             seconds_per_step=secs, steady_seconds_per_step=sps, tokens_per_s=TRAIN_S / sps,
             max_memory_allocated_gb=peak, feed_idle_s_per_step=feed["idle_s_per_step"],
             feed_stall_fraction=feed["stall_frac"], feed_breakdown=feed["breakdown"],
             feed_transfer_s=feed["transfer_s"], feed_bytes=feed["bytes_to_device"],
             launches=counts, launches_per_step_want=per_step))
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"train: loss not finite and falling: {losses}")
    if peak > 80.0:
        raise SystemExit(f"train: peak memory {peak:.1f} GB over 80 GB")
    require_launches("train", counts, per_step, TRAIN_STEPS)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _max_leaf_err(a, b) -> float:
    return max(float((x.detach().cpu().float() - y.detach().float()).abs().max())
               for x, y in zip(_leaves(a), _leaves(b)))


def phase_train_check():
    """One f32 train step of starcoder2-3b at 2 layers (B=1, S=256) through
    the kernels on the card against the same step through the plain route
    (``_attn_chunked``, autograd) on CPU copies of the same parameters and
    batch."""
    import torch

    from repro_torch.bridge import map_with_paths
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    cfg = get_config(TRAIN_ARCH).replace(num_layers=2, dtype="float32")
    model = build_model(cfg)
    opt = AdamWConfig(lr=CHECK_LR, eps=CHECK_EPS, warmup_steps=1)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    cpu_params = map_with_paths(params, lambda _, t: t.cpu().clone())
    gpu = {"params": params, "opt": init_state(params, opt)}
    cpu = {"params": cpu_params, "opt": init_state(cpu_params, opt)}
    batch = next(iter(ZipfTokens(cfg.vocab_size, 1, 256, 1, seed=1).session()))
    batch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    (_, mg), _, counts, peak = counted(
        "train_check_f32", lambda: make_train_step(model, opt)(
            gpu, {k: v.cuda() for k, v in batch.items()}))
    _, mc = make_train_step(model, opt)(cpu, batch)
    per_step = train_launches_per_step(cfg)
    loss_err = abs(float(mg["total_loss"]) - float(mc["total_loss"])) / abs(float(mc["total_loss"]))
    gn_err = abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) / float(mc["grad_norm"])
    p_err = _max_leaf_err(gpu["params"], cpu["params"])
    ok = (loss_err <= CHECK_TOL["loss"] and gn_err <= CHECK_TOL["grad_norm"]
          and p_err <= CHECK_TOL["params"])
    log(dict(phase="train_check_f32", layers=2, B=1, S=256, lr=CHECK_LR, eps=CHECK_EPS,
             loss_card=float(mg["total_loss"]), loss_cpu=float(mc["total_loss"]),
             loss_rel_err=loss_err, grad_norm_rel_err=gn_err, params_max_abs_err=p_err,
             tol=CHECK_TOL, ok=ok, launches=counts, max_memory_allocated_gb=peak))
    if not ok:
        raise SystemExit("train_check_f32: the card's train step disagrees with the plain route")
    require_launches("train_check_f32", counts, per_step, 1)


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
}
# the parity case at the main path's shape that each kernel's line reports
MAIN_CASE = {"flash_attention": f"main_S{PREFILL_S}", "decode_attention": "main_serve_B8_S256",
             "ssd_scan": "mamba2_prefill_mamba2_regime", "moe_router": "moonshot_prefill",
             "fused_augment": "imagenet_B256", "flash_attention_bwd": f"main_S{PREFILL_S}"}


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
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    for spec in MODELS:
        add(phase_model(*spec))
    add(phase_augment(torch.Generator(device="cuda").manual_seed(2)))
    add(phase_train())
    phase_train_check()

    kernels = []
    for name, meta in KERNEL_META.items():
        r = next(r for r in recs if r["kernel"] == name and r["case"] == MAIN_CASE[name])
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=totals.get(name, 0), max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            **{key: r[key] for key in ("tflops", "bound_share") if key in r},
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
