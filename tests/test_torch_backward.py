"""The backward kernels' plain versions (``ssd_scan_bwd_ref``,
``moe_router_bwd_ref``) against ``jax.grad`` of the JAX package's
references, their autograd wiring (``SSDScan``, ``MoERouter``), and the
train runs' memory reckoning of ``chip_smoke.py``, on the CPU.

Inputs are made with numpy from fixed seeds at the sizes of
``scaled_down()`` mamba2 (8 heads, P 32, N 16, chunk 16) and MoE configs,
or smaller.  Tolerances:

* ``ssd_scan_bwd_ref`` against ``jax.grad`` of ``repro.kernels.ssd_scan.
  ref.ssd_scan_ref`` (the token recurrence, f32): atol = rtol = 5e-4, the
  forward's tolerance in ``tests/test_kernels.py::TestSSDScan``; a bf16
  gradient also gets its own rounding (2^-8 of the value), as the chip
  run's forward rule does;
* ``ssd_scan_bwd_ref`` against ``torch.autograd`` of the port's
  ``ssd_scan_ref``, both in f64: 1e-8 (the same function, summed in another
  order);
* ``moe_router_bwd_ref`` against ``jax.grad`` of the gates of ``repro.
  kernels.moe_router.ref.moe_router_ref``: 1e-6, the gates' tolerance of
  ``TestMoERouter``;
* ``ssd_scan_bwd_chunked_model`` (the plain model of the card kernel's
  decomposition: causal tiles, head blocks summed on chip, 3xTF32 operand
  splits) against ``jax.grad`` and against ``ssd_scan_bwd_ref`` in f64: the
  same 5e-4, bf16's 2^-8 added to rtol.
"""
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels.moe_router.ref import moe_router_ref as jax_moe_router_ref
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro_torch.configs import get_config
from repro_torch.kernels.moe_router import moe_router_bwd_ref, moe_router_ref
from repro_torch.kernels.moe_router import ops as router_ops
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_ref, ssd_scan_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_chunked_model

ROOT = Path(__file__).resolve().parent.parent
SSD_TOL = 5e-4
BF16_STEP = 2.0 ** -8
GATE_TOL = 1e-6
NAMES = ("dx", "ddt", "da", "dB", "dC", "dD")


def _ssd_inputs(seed, B, L, H, P, N, G, regime="jax", dh_final=False):
    """numpy f32 x, dt, a, B, C, D, dy (and dh_final).  ``regime="mamba2"``:
    what mamba2's mixer hands the scan (dt = softplus of a unit normal, a =
    -(1..16)), so the log-decay inside a chunk of 16 reaches the hundreds."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32) * 0.5
    if regime == "mamba2":
        dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
        a = -np.linspace(1.0, 16.0, H).astype(np.float32)
    else:
        dt = np.abs(rng.standard_normal((B, L, H))).astype(np.float32) * 0.1
        a = -np.abs(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32) * 0.3
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32) * 0.3
    D = rng.standard_normal(H).astype(np.float32)
    dy = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dh = rng.standard_normal((B, H, N, P)).astype(np.float32) if dh_final else None
    return x, dt, a, Bm, Cm, D, dy, dh


def _jax_ssd_grads(x, dt, a, Bm, Cm, D, dy):
    """jax.grad of the JAX reference (per-head B and C) for the cotangent
    dy: B and C repeated over each group's heads before the call, and their
    gradients summed over those heads after it."""
    H, G = x.shape[2], Bm.shape[2]
    rep = H // G
    Bh, Ch = (np.repeat(m, rep, axis=2) for m in (Bm, Cm))
    _, vjp = jax.vjp(jax_ssd_scan_ref, *(jnp.asarray(t) for t in (x, dt, a, Bh, Ch, D)))
    gx, gdt, ga, gB, gC, gD = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    B_, L = x.shape[:2]
    gB, gC = (g.reshape(B_, L, G, rep, -1).sum(3) for g in (gB, gC))
    return gx, gdt, ga, gB, gC, gD


# (B, L, H, P, N, G, chunk, regime, dtype): scaled_down() mamba2's heads
# (8 x 32, N 16, chunk 16); G < H; ragged last chunks; the mixer's regime
SSD_CASES = {
    "scaled_down_mamba2": (2, 64, 8, 32, 16, 1, 16, "jax", "float32"),
    "grouped_G2_ragged_L50": (1, 50, 8, 32, 16, 2, 16, "jax", "float32"),
    "mamba2_regime_ragged_L40": (1, 40, 8, 32, 16, 1, 16, "mamba2", "float32"),
    "pre_expanded_G_eq_H_chunk64": (1, 70, 4, 32, 16, 4, 64, "jax", "float32"),
    "bf16_grouped_G2": (1, 48, 8, 32, 16, 2, 16, "jax", "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_bwd_ref_matches_jax_grad(case):
    B, L, H, P, N, G, chunk, regime, dtype = SSD_CASES[case]
    x, dt, a, Bm, Cm, D, dy, _ = _ssd_inputs(7, B, L, H, P, N, G, regime)
    tdt = getattr(torch, dtype)
    tx, tB, tC, tdy = (torch.from_numpy(t).to(tdt) for t in (x, Bm, Cm, dy))
    # JAX computes in f32 from the same (rounded) values
    x, Bm, Cm, dy = (t.float().numpy() for t in (tx, tB, tC, tdy))
    want = _jax_ssd_grads(x, dt, a, Bm, Cm, D, dy)
    got = ssd_scan_bwd_ref(tx, torch.from_numpy(dt), torch.from_numpy(a), tB, tC,
                           torch.from_numpy(D), tdy, None, chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        rtol = SSD_TOL + (BF16_STEP if g.dtype == torch.bfloat16 else 0.0)
        np.testing.assert_allclose(g.float().numpy(), w, atol=SSD_TOL, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("G,L,chunk,dh_final", [(2, 37, 8, True), (1, 50, 16, True),
                                                (4, 33, 64, False)])
def test_ssd_bwd_ref_matches_autograd_in_f64(G, L, chunk, dh_final):
    """The port's reference returns the final state too, so this also
    covers a non-zero dh_final (the gradient of that state)."""
    arrs = _ssd_inputs(3, 2, L, 4, 32, 16, G, "mamba2", dh_final)
    x, dt, a, Bm, Cm, D, dy, dh = (None if t is None else torch.from_numpy(t).double()
                                   for t in arrs)
    ins = [t.clone().requires_grad_() for t in (x, dt, a, Bm, Cm, D)]
    y, h = ssd_scan_ref(*ins)
    assert y.dtype == h.dtype == torch.float64
    loss = (y * dy).sum() + ((h * dh).sum() if dh_final else 0.0)
    want = torch.autograd.grad(loss, ins)
    got = ssd_scan_bwd_ref(x, dt, a, Bm, Cm, D, dy, dh, chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-8, rtol=1e-8, err_msg=name)


# (B, L, H, P, N, G, regime, dtype, dh_final, head_block) of the chunked
# model at the kernel's chunk (64): a group of 12 heads over blocks of 8 (8 +
# 4) and of 6 over blocks of 4, ragged last chunks (150, 130, 100, 90 tokens),
# L < chunk (40), the mixer's regime, non-zero dh_final, bf16
MODEL_CASES = {
    "hpg12_head_block8_ragged_L150": (1, 150, 12, 32, 16, 1, "jax", "float32", False, 8),
    "G2_hpg6_head_block4_ragged_L100_dh": (2, 100, 12, 32, 16, 2, "jax", "float32", True, 4),
    "L40_below_chunk_mamba2_regime_dh": (1, 40, 8, 32, 16, 1, "mamba2", "float32", True, 8),
    "mamba2_regime_ragged_L130_hpg12": (1, 130, 12, 32, 16, 1, "mamba2", "float32", False, 8),
    "bf16_G2_hpg12_ragged_L90_dh": (1, 90, 24, 32, 16, 2, "jax", "bfloat16", True, 8),
    "bf16_mamba2_regime_L70_P64": (1, 70, 8, 64, 32, 1, "mamba2", "bfloat16", False, 8),
}


def _model_inputs(case):
    B, L, H, P, N, G, regime, dtype, dh_final, head_block = MODEL_CASES[case]
    x, dt, a, Bm, Cm, D, dy, dh = _ssd_inputs(13, B, L, H, P, N, G, regime, dh_final)
    tdt = getattr(torch, dtype)
    tx, tB, tC, tdy = (torch.from_numpy(t).to(tdt) for t in (x, Bm, Cm, dy))
    tdh = None if dh is None else torch.from_numpy(dh)
    ins = (tx, torch.from_numpy(dt), torch.from_numpy(a), tB, tC, torch.from_numpy(D), tdy)
    got = ssd_scan_bwd_chunked_model(*ins, tdh, chunk=ssd_kernel.BWD_CHUNK,
                                     head_block=head_block)
    return ins, tdh, got


def _assert_grads_close(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        rtol = SSD_TOL + (BF16_STEP if g.dtype == torch.bfloat16 else 0.0)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, dtype=np.float64),
                                   atol=SSD_TOL, rtol=rtol, err_msg=f"{name} vs {what}")


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_ssd_bwd_chunked_model_matches_ref(case):
    """The kernel's decomposition against the plain backward in f64 on the
    same (rounded) inputs."""
    ins, dh, got = _model_inputs(case)
    want = ssd_scan_bwd_ref(*(t.double() for t in ins), None if dh is None else dh.double())
    for g, t in zip(got, (ins[0], ins[1], ins[2], ins[3], ins[4], ins[5])):
        assert g.shape == t.shape and g.dtype == t.dtype
    _assert_grads_close(got, [w.numpy() for w in want], "ssd_scan_bwd_ref")


@pytest.mark.parametrize("case", sorted(c for c, v in MODEL_CASES.items() if not v[8]))
def test_ssd_bwd_chunked_model_matches_jax_grad(case):
    """The kernel's decomposition against jax.grad of the JAX reference (the
    token recurrence, which has no final-state output: the cases without
    dh_final)."""
    ins, _, got = _model_inputs(case)
    x, dt, a, Bm, Cm, D, dy = (t.float().numpy() for t in ins)
    _assert_grads_close(got, _jax_ssd_grads(x, dt, a, Bm, Cm, D, dy), "jax.grad")


def test_ssd_bwd_scratch_reckoning_matches_the_launch(monkeypatch):
    """``kernel.bwd_scratch`` at mamba2-2.7b's train shape (B 1, L 8192, H 80,
    P 64, N 128, G 1, f32) is what ``ssd_scan_bwd_launch`` allocates: R and
    the entering states 335.5 MB each in f32, the head blocks' partials of dB
    and dC 41.9 MB each (10 blocks of 8 heads, where the per-head sums were
    335.5 MB each)."""
    seen = []
    real_empty = torch.empty

    def spy(shape, *args, **kw):
        seen.append((tuple(shape), kw.get("dtype")))
        return real_empty(shape, *args, **kw)

    class Lib:
        def __getattr__(self, name):
            fn = lambda *args: 0  # noqa: E731
            fn.argtypes = fn.restype = None
            return fn

    monkeypatch.setattr(ssd_kernel, "_lib", lambda *args: Lib())
    monkeypatch.setattr(ssd_kernel, "_stream", lambda t: 0)
    monkeypatch.setattr(ssd_kernel.torch, "empty", spy)
    B, L, H, P, N, G = 1, 8192, 80, 64, 128, 1
    meta = dict(device="meta", dtype=torch.float32)
    x, dy = real_empty((B, L, H, P), **meta), real_empty((B, L, H, P), **meta)
    dt, Bm = real_empty((B, L, H), **meta), real_empty((B, L, G, N), **meta)
    vec = real_empty((H,), **meta)
    outs = [real_empty(t.shape, **meta) for t in (x, dt, vec, Bm, Bm, vec)]
    ssd_kernel.ssd_scan_bwd_launch(x, dt, vec, Bm, Bm, vec, dy, None, *outs)
    want = ssd_kernel.bwd_scratch(B, L, H, G, P, N, torch.float32)
    assert seen == list(want.values())
    mb = {k: v / 1e6 for k, v in ssd_kernel.bwd_scratch_bytes(B, L, H, G, P, N,
                                                               torch.float32).items()}
    assert mb["rstate"] == mb["hp"] == pytest.approx(335.5, abs=0.1)
    assert mb["dB_part"] == mb["dC_part"] == pytest.approx(41.9, abs=0.1)
    assert want["dB_part"][0] == (B, L, G, 10, N)
    # bf16 keeps the entering states as two bf16 pieces: the same bytes
    assert ssd_kernel.bwd_scratch_bytes(B, L, H, G, P, N, torch.bfloat16)["hp"] == (
        ssd_kernel.bwd_scratch_bytes(B, L, H, G, P, N, torch.float32)["hp"])


def test_ssd_bwd_head_block_matches_the_kernel_source():
    """The wrapper's head block and chunk are the CUDA source's."""
    import re

    src = (ROOT / "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu").read_text()
    assert int(re.search(r"constexpr int kHeadBlock = (\d+);", src).group(1)) == (
        ssd_kernel.HEAD_BLOCK)
    assert int(re.search(r"constexpr int kQ = (\d+);", src).group(1)) == ssd_kernel.BWD_CHUNK


@pytest.mark.parametrize("T,E,k,ties", [(64, 8, 2, False), (100, 16, 4, True),
                                        (32, 8, 8, False), (50, 64, 6, False)])
def test_router_bwd_ref_matches_jax_grad(T, E, k, ties):
    """Ties (integer logits, whole rows equal) and k = E (every expert wins:
    the gates are the softmax itself)."""
    rng = np.random.default_rng(11)
    if ties:
        logits = rng.integers(0, 3, (T, E)).astype(np.float32)
        logits[: T // 4] = 1.0
    else:
        logits = rng.standard_normal((T, E)).astype(np.float32)
    dg = rng.standard_normal((T, k)).astype(np.float32)
    jids, jgates, _ = jax_moe_router_ref(jnp.asarray(logits), k, T)
    _, vjp = jax.vjp(lambda lg: jax_moe_router_ref(lg, k, T)[1], jnp.asarray(logits))
    want = np.asarray(vjp(jnp.asarray(dg))[0])
    ids, gates, _ = moe_router_ref(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    got = moe_router_bwd_ref(ids, gates, torch.from_numpy(dg), E)
    assert got.shape == (T, E) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=GATE_TOL, rtol=GATE_TOL)
    off = np.ones((T, E), dtype=bool)
    off[np.arange(T)[:, None], ids.numpy()] = False
    assert not got.numpy()[off].any()  # 0 at every expert that did not win


def _ssd_launcher_to_plain(monkeypatch):
    """Points the forward's launcher at the plain version, so that the CUDA
    route's ``SSDScan`` runs on CPU tensors; its backward reaches
    ``ssd_scan_bwd``, whose CPU route is the plain backward."""
    def launch(x, dt, a, Bm, Cm, D, y, h, *, chunk):
        yy, hh = ssd_scan_ref(x, dt, a, Bm, Cm, D)
        y.copy_(yy)
        h.copy_(hh)

    monkeypatch.setattr(ssd_ops, "ssd_scan_fwd", launch)


@pytest.mark.parametrize("use_h", [False, True])
def test_ssd_function_wiring(monkeypatch, use_h):
    """Gradients reach x, dt, a, B, C and D through ``SSDScan`` and equal
    autograd's of the plain version; an unused final state reaches the
    backward as dh_final=None."""
    _ssd_launcher_to_plain(monkeypatch)
    seen = []
    real = ssd_ops.ssd_scan_bwd

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setattr(ssd_ops, "ssd_scan_bwd", spy)
    arrs = _ssd_inputs(5, 1, 40, 8, 32, 16, 2, "jax", True)
    x, dt, a, Bm, Cm, D, dy, dh = (torch.from_numpy(t) for t in arrs)
    ins = [t.clone().requires_grad_() for t in (x, dt, a, Bm, Cm, D)]
    before = ssd_ops.ssd_scan.launches
    y, h = ssd_ops.SSDScan.apply(*ins, 16)
    assert ssd_ops.ssd_scan.launches == before + 1
    loss = (y * dy).sum() + ((h * dh).sum() if use_h else 0.0)
    got = torch.autograd.grad(loss, ins)
    assert len(seen) == 1 and (seen[0] is None) is (not use_h)
    ref_ins = [t.clone().requires_grad_() for t in (x, dt, a, Bm, Cm, D)]
    yr, hr = ssd_scan_ref(*ref_ins)
    want = torch.autograd.grad((yr * dy).sum() + ((hr * dh).sum() if use_h else 0.0), ref_ins)
    for name, g, w in zip(NAMES, got, want):
        assert g is not None and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=SSD_TOL, rtol=SSD_TOL,
                                   err_msg=name)


def test_router_function_wiring(monkeypatch):
    """The gates' gradient reaches the logits through ``MoERouter`` and
    equals autograd's of the plain version; ids and slots carry none."""
    def launch(logits, ids, gates, slots, k):
        for out, ref in zip((ids, gates, slots), moe_router_ref(logits, k)):
            out.copy_(ref)

    monkeypatch.setattr(router_ops, "moe_router_fwd", launch)
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32))
    dg = torch.from_numpy(rng.standard_normal((40, 4)).astype(np.float32))
    lg = logits.clone().requires_grad_()
    ids, gates, slots = router_ops.MoERouter.apply(lg, 4)
    assert not ids.requires_grad and not slots.requires_grad and gates.requires_grad
    got = torch.autograd.grad((gates * dg).sum(), lg)[0]
    lr = logits.clone().requires_grad_()
    want = torch.autograd.grad((moe_router_ref(lr, 4)[1] * dg).sum(), lr)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GATE_TOL, rtol=GATE_TOL)


def test_train_runs_fit_the_card():
    """The chip run's train reckoning: f32 parameters, gradients and AdamW's
    two moments are 16 bytes a parameter.  mamba2-2.7b at full width is 2.70
    B parameters, 43.2 GB; moonshot cut to 4 of its 48 layers (1 dense + 3
    MoE) 2.41 B, 38.5 GB, where the whole model's 27.5 B would need 440 GB.
    Both hold less than starcoder2-3b's 50.9 GB, which trains at S = 8192
    within the 80 GB card; so do whisper-large-v3 (1.535 B, 24.6 GB, not
    cut: B = 8 clips of 1500 frames and 448 tokens) and qwen2-vl-2b (1.544 B,
    24.7 GB, not cut: S = 4096).  jamba-v0.1-52b is cut to 2 layers at
    period 2 (a mamba2 layer with the dense SwiGLU, an attention layer with
    the MoE of 16 experts), every width the published one: 3.675 B, 58.8 GB,
    which leaves 21 GB of the card for a step at S = 4096; one whole 7:1
    period (8 layers) would need 212 GB and 4 layers at period 4 110 GB."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.models.lm import compute_groups, layer_pattern

    runs = {arch: (replace, B, S, steps)
            for arch, replace, B, S, steps in chip_smoke.TRAIN_RUNS}
    assert runs["mamba2-2.7b"] == ({}, 1, 8192, 4)
    assert runs["moonshot-v1-16b-a3b"] == ({"num_layers": 4}, 1, 4096, 4)
    assert runs["whisper-large-v3"] == ({}, 8, 448, 4)
    assert runs["qwen2-vl-2b"] == ({}, 1, 4096, 4)
    jamba_cut = {"num_layers": 2, "attn_period": 2, "attn_offset": 1}
    assert runs["jamba-v0.1-52b"] == (jamba_cut, 1, 4096, 4)
    want_gb = {"mamba2-2.7b": 43.2, "moonshot-v1-16b-a3b": 38.5, "starcoder2-3b": 50.9,
               "whisper-large-v3": 24.6, "qwen2-vl-2b": 24.7, "jamba-v0.1-52b": 58.8}
    for arch, (replace, _, _, _) in runs.items():
        cfg = get_config(arch).replace(**replace)
        gb = 16 * cfg.param_counts()["total"] / 1e9
        assert gb == pytest.approx(want_gb[arch], abs=0.1), arch
        if arch != "jamba-v0.1-52b":
            assert gb <= want_gb["starcoder2-3b"] < 80
    moonshot = get_config("moonshot-v1-16b-a3b")
    assert 16 * moonshot.param_counts()["total"] / 1e9 == pytest.approx(440, abs=1)
    cut = moonshot.replace(num_layers=4)
    assert [f for _, f in layer_pattern(cut)] == ["dense", "moe", "moe", "moe"]
    jamba = get_config("jamba-v0.1-52b")
    cfg = jamba.replace(**jamba_cut)
    assert (cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (
        jamba.d_model, jamba.d_ff, 32, 8, 128)
    assert (cfg.num_experts, cfg.experts_per_token, cfg.ssm_heads, cfg.ssm_state) == (
        16, 2, 128, 16)
    assert layer_pattern(cfg) == [("ssm", "dense"), ("attn", "moe")]
    assert [g.repeats for g in compute_groups(cfg)] == [1]
    assert cfg.param_counts()["total"] / 1e9 == pytest.approx(3.675, abs=0.001)
    assert 16 * jamba.replace(num_layers=8).param_counts()["total"] / 1e9 == pytest.approx(
        212, abs=1)
    assert 16 * jamba.replace(num_layers=4, attn_period=4, attn_offset=3).param_counts()[
        "total"] / 1e9 == pytest.approx(110, abs=1)
