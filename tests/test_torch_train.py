"""The port's training path (``repro_torch.train``, the flash backward's
plain route, the guard of the kernel without a backward, the autograd
routes of the kernels with one) against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds; JAX parameters come from
``init_train_state(model, PRNGKey(0))`` and are carried across with
``repro_torch.bridge.params_from_jax``.  Everything is f32 unless a test says
otherwise.  Tolerances:

* ``cross_entropy``, ``lr_schedule``: 1e-6 relative - one f32 logsumexp,
  cos or pow against another;
* ``apply_updates`` leaf by leaf: 1e-6 relative and absolute - the same f32
  update formula with the products taken in another order (an ulp or two);
* attention gradients (plain route, FlashAttention-2 math, ``_attn_chunked``
  twin) against ``jax.grad`` of JAX's ``_attn_chunked``: 2e-5, the f32
  attention tolerance of ``tests/test_kernels.py``;
* 3-step trajectories (loss at each step, every parameter after three AdamW
  steps at lr 1e-3): 1e-4 - the logits' tolerance of
  ``tests/test_torch_models.py``; the parameters move by about 3e-3 in those
  steps, so a missed decay or a wrong sign shows far above it.  These runs
  use AdamW's eps = 1e-6: Adam's first steps move an entry by lr * g / (|g| +
  eps), which flips with the rounding where a gradient entry is at the f32
  noise of the two frameworks (about 1e-9), and eps = 1e-6 keeps that below
  lr * 1e-3.  The hybrid family (jamba) runs at eps = 1e-3 (``TRAJ_EPS``):
  its gradients carry about 2e-5 of each leaf's largest entry of f32 noise
  in both frameworks (the chunked SSD's exponentials; the port 1.8e-5 and
  JAX 2.1e-5 against an f64 run), and at eps = 1e-6 three steps move 1-2
  of 65,536 embedding entries up to 3e-4 apart on it; at 1e-3, lr times
  that noise over eps is below 1e-5;
* step-1 gradients, leaf by leaf (the port's train step as it hands them
  to AdamW, against ``jax.grad`` of JAX's loss on the same parameters and
  batch): TRAJ_TOL of the JAX leaf's largest entry (measured at most 3.1e-5,
  jamba's ``ssm/A_log``).  A trajectory cannot see a gradient scaled by a
  few percent in a leaf whose entries are far from eps: Adam's first steps
  move such an entry by lr * sign(g) at either eps, so this check is the one
  that holds each leaf's gradient;
* checkpoints: bit-exact.
"""
import json
import os
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.train import AdamWConfig as JaxAdamWConfig
from repro.train import apply_updates as jax_apply_updates
from repro.train import cross_entropy as jax_cross_entropy
from repro.train import init_state as jax_init_state
from repro.train import init_train_state as jax_init_train_state
from repro.train import lr_schedule as jax_lr_schedule
from repro.train import make_train_step as jax_make_train_step
from repro.train.step import make_loss_fn as jax_make_loss_fn
from repro.train import restore_checkpoint as jax_restore_checkpoint
from repro.train import save_checkpoint as jax_save_checkpoint
from repro_torch.bridge import flatten_with_paths, params_from_jax
from repro_torch.configs import get_config
from repro_torch.feed import DeviceFeeder
from repro_torch.kernels import _grad
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                 flash_attention_lse_ref)
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.train import (AdamWConfig, apply_updates, cross_entropy, init_state,
                               init_train_state, latest_step, lr_schedule, make_eval_step,
                               make_train_step, restore_checkpoint, save_checkpoint)
from repro_torch.train import optimizer as torch_optimizer

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

FORMULA_TOL = 1e-6
ATTN_TOL = 2e-5
TRAJ_TOL = 1e-4
TRAJ_EPS = {"hybrid": 1e-3}
ARCHS = ["qwen3-14b", "moonshot-v1-16b-a3b", "mamba2-2.7b"]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _carry(tree):
    return params_from_jax(jax.device_get(tree))


def _batch(rng, vocab, B, S, pad_every=0):
    tokens = rng.integers(1, vocab, (B, S))
    labels = rng.integers(1, vocab, (B, S))
    if pad_every:
        labels[:, ::pad_every] = 0
    return tokens, labels


# ---------------------------------------------------------------------------
# loss and schedule
# ---------------------------------------------------------------------------
def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 16, 64)) * 3).astype(np.float32)
    labels = rng.integers(0, 64, (2, 16))
    labels[0, :3] = 0  # padding, masked out
    logits[1, 2, labels[1, 2]] = 50.0  # a sure hit for the accuracy
    got, gaux = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want, waux = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=FORMULA_TOL)
    for k in ("loss", "z_loss", "accuracy"):
        np.testing.assert_allclose(_np(gaux[k]), np.asarray(waux[k]), rtol=FORMULA_TOL)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(lr=1.0, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1),
    dict(lr=2e-3, warmup_steps=0, decay_steps=50),
])
def test_lr_schedule_matches_jax(cfg):
    tc, jc = AdamWConfig(**cfg), JaxAdamWConfig(**cfg)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000):
        np.testing.assert_allclose(float(lr_schedule(tc, step)),
                                   float(jax_lr_schedule(jc, jnp.asarray(step))),
                                   rtol=FORMULA_TOL, atol=1e-12)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _grads_like(rng, params, scale):
    return jax.tree.map(lambda p: jnp.asarray(
        (rng.standard_normal(p.shape) * scale).astype(np.float32)), params)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-3, 1.0])  # global norm under and over the clip
def test_apply_updates_leaf_by_leaf(state_dtype, grad_scale):
    """Two AdamW steps on mamba2's scaled_down parameters (stacked 2-D norm
    scales and SSM vectors: decayed; ``final_norm``: not), every param and
    moment leaf against JAX."""
    jcfg = jax_get_config("mamba2-2.7b").scaled_down()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    kw = dict(lr=1e-2, weight_decay=0.5, warmup_steps=1, state_dtype=state_dtype)
    jopt, topt = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    tparams = _carry(jparams)
    jstate, tstate = jax_init_state(jparams, jopt), init_state(tparams, topt)
    rng = np.random.default_rng(1)
    for _ in range(2):
        jg = _grads_like(rng, jparams, grad_scale)
        jparams, jstate, jm = jax_apply_updates(jparams, jg, jstate, jopt)
        tparams, tstate, tm = apply_updates(tparams, _carry(jg), tstate, topt)
    np.testing.assert_allclose(_np(tm["grad_norm"]), np.asarray(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(_np(tm["lr"]), np.asarray(jm["lr"]), rtol=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    got = dict(flatten_with_paths({"params": tparams, "m": tstate["m"], "v": tstate["v"]}))
    want = dict(flatten_with_paths(_carry({"params": jparams, "m": jstate["m"],
                                           "v": jstate["v"]})))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        tol = FORMULA_TOL
        if state_dtype == "bfloat16":
            # a moment may round to the neighbouring bf16 value (2^-7 of it),
            # which moves the next step's update by up to 2^-7 of lr
            tol = 2 ** -7 if got[key].dtype == torch.bfloat16 else kw["lr"] * 2 ** -7
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), rtol=tol, atol=tol,
                                   err_msg=key)


def test_decay_mask_follows_jax_leaf_rank():
    """With zero gradients only weight decay moves a parameter: exactly the
    leaves JAX decays (``ndim >= 2`` in the stacked layout) move."""
    jcfg = jax_get_config("jamba-v0.1-52b").scaled_down()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    kw = dict(lr=0.1, weight_decay=0.5, warmup_steps=0, grad_clip=1e9)
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    jnew, _, _ = jax_apply_updates(jparams, zeros, jax_init_state(jparams, JaxAdamWConfig(**kw)),
                                   JaxAdamWConfig(**kw))
    tparams = _carry(jparams)
    tnew, _, _ = apply_updates(tparams, _carry(zeros), init_state(tparams, AdamWConfig(**kw)),
                               AdamWConfig(**kw))
    before = dict(flatten_with_paths(_carry(jparams)))
    jmoved = {k for k, t in flatten_with_paths(_carry(jnew)) if not torch.equal(t, before[k])}
    tmoved = {k for k, t in flatten_with_paths(tnew) if not torch.equal(t, before[k])}
    assert jmoved == tmoved
    assert "final_norm" not in tmoved
    assert {"group0/0/ln1", "group0/0/ssm/D", "group0/0/ssm/A_log", "group0/3/ln2"} <= tmoved


# ---------------------------------------------------------------------------
# train-step trajectories
# ---------------------------------------------------------------------------
def _train_batch(cfg, rng, B, S):
    """A train batch in the layout of JAX's ``launch/specs.py``
    (``train_input_specs``), made with numpy: tokens and labels (1 in 7
    labels padding); the enc-dec family adds ``enc_embeds`` (B,
    encoder_seq, d_model); the VLM family takes ``embeds`` (B, S, d_model)
    and (B, S, 3) M-RoPE ``positions`` in place of tokens: Qwen2-VL's
    text-image-text layout of ``chip_smoke.qwen2vl_positions``, each row
    shifted by a random offset."""
    tokens, labels = _batch(rng, cfg.vocab_size, B, S, pad_every=7)
    if cfg.family == "vlm":
        embeds = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        pos = chip_smoke.qwen2vl_positions(S).numpy() + rng.integers(0, 3, (B, 1, 1))
        return {"embeds": embeds, "positions": pos.astype(np.int32), "labels": labels}
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch,microbatches,remat", [
    ("qwen3-14b", 1, "none"), ("qwen3-14b", 2, "none"), ("qwen3-14b", 1, "block"),
    ("moonshot-v1-16b-a3b", 1, "none"), ("moonshot-v1-16b-a3b", 2, "none"),
    ("mamba2-2.7b", 1, "none"), ("mamba2-2.7b", 2, "block"),
    ("whisper-large-v3", 1, "none"), ("whisper-large-v3", 1, "block"),
    ("qwen2-vl-2b", 1, "none"),
    ("jamba-v0.1-52b", 1, "none"), ("jamba-v0.1-52b", 2, "block"),
])
def test_three_step_trajectory_matches_jax(arch, microbatches, remat):
    """Three train steps of the port against JAX's jitted step on the same
    parameters and batches (``_train_batch``: each family's layout)."""
    jcfg = jax_get_config(arch).scaled_down().replace(remat=remat)
    tcfg = get_config(arch).scaled_down().replace(remat=remat)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    kw = dict(lr=1e-3, warmup_steps=1, eps=TRAJ_EPS.get(tcfg.family, 1e-6))
    jopt, topt = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    jstate = jax_init_train_state(jmodel, jax.random.PRNGKey(0), jopt)
    tstate = {"params": _carry(jstate["params"]), "opt": init_state(_carry(jstate["params"]),
                                                                    topt)}
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, microbatches=microbatches))
    tstep = make_train_step(tmodel, topt, microbatches=microbatches)
    rng = np.random.default_rng(2)
    for i in range(3):
        batch = _train_batch(tcfg, rng, 4, 32)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("total_loss", "loss", "z_loss", "accuracy", "grad_norm", "lr"):
            np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=TRAJ_TOL,
                                       atol=TRAJ_TOL, err_msg=f"step {i + 1} {k}")
    assert int(tstate["opt"]["step"]) == 3
    want = dict(flatten_with_paths(_carry(jstate["params"])))
    for key, t in flatten_with_paths(tstate["params"]):
        np.testing.assert_allclose(_np(t), _np(want[key]), rtol=TRAJ_TOL, atol=TRAJ_TOL,
                                   err_msg=key)


def _step_one_grad_gaps(arch, monkeypatch, plant=None):
    """Per leaf, the largest gap between the port's step-1 gradient (as its
    train step hands it to AdamW) and ``jax.grad`` of JAX's loss on the same
    parameters and batch (the trajectory's first), over the JAX leaf's
    largest entry.  ``plant`` names a leaf whose port gradient is scaled by
    1.05 before the comparison."""
    jcfg, tcfg = jax_get_config(arch).scaled_down(), get_config(arch).scaled_down()
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jax_init_train_state(jmodel, jax.random.PRNGKey(0), JaxAdamWConfig())["params"]
    batch = _train_batch(tcfg, np.random.default_rng(2), 4, 32)
    grad_fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(jmodel), has_aux=True))
    _, jgrads = grad_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    seen = {}
    real = torch_optimizer.apply_updates

    def spy(params, grads, state, cfg):
        seen.update((k, g.clone()) for k, g in flatten_with_paths(grads))
        return real(params, grads, state, cfg)

    monkeypatch.setattr(torch_optimizer, "apply_updates", spy)
    topt = AdamWConfig(lr=1e-3, warmup_steps=1)
    tparams = _carry(jparams)
    make_train_step(tmodel, topt)({"params": tparams, "opt": init_state(tparams, topt)},
                                  {k: torch.from_numpy(v) for k, v in batch.items()})
    if plant is not None:
        seen[plant] = seen[plant] * 1.05
    want = dict(flatten_with_paths(_carry(jgrads)))
    assert seen.keys() == want.keys()
    return {k: float(np.abs(_np(seen[k]) - _np(w)).max() / np.abs(_np(w)).max())
            for k, w in want.items()}


@pytest.mark.parametrize("arch", ARCHS + ["whisper-large-v3", "qwen2-vl-2b", "jamba-v0.1-52b"])
def test_step_one_grads_match_jax(arch, monkeypatch):
    """Every leaf's step-1 gradient within TRAJ_TOL of the JAX leaf's
    largest entry (``_step_one_grad_gaps``)."""
    gaps = _step_one_grad_gaps(arch, monkeypatch)
    assert max(gaps.values()) <= TRAJ_TOL, sorted(gaps.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("leaf", ["group0/0/ssm/A_log", "group0/0/ssm/D", "group0/0/ssm/dt_bias"])
def test_step_one_grads_catch_a_planted_fault(leaf, monkeypatch):
    """One of jamba's SSD leaves with its port gradient scaled by 1.05 (a
    fault that passes jamba's 3-step trajectory at eps 1e-3) fails the
    leaf-by-leaf check, at that leaf only."""
    gaps = _step_one_grad_gaps("jamba-v0.1-52b", monkeypatch, plant=leaf)
    assert gaps[leaf] > 100 * TRAJ_TOL
    assert [k for k, gap in gaps.items() if gap > TRAJ_TOL] == [leaf]


def test_eval_step_and_init():
    cfg = get_config("starcoder2-3b").scaled_down()
    model = build_model(cfg)
    state = init_train_state(model, 0, AdamWConfig(), device="cpu")
    assert int(state["opt"]["step"]) == 0 and state["opt"]["m"]["embed"].dtype == torch.float32
    tokens, labels = _batch(np.random.default_rng(3), cfg.vocab_size, 2, 16)
    aux = make_eval_step(model)(state["params"], {"tokens": torch.from_numpy(tokens),
                                                  "labels": torch.from_numpy(labels)})
    assert set(aux) == {"loss", "z_loss", "accuracy"}
    assert aux["loss"].requires_grad is False and np.isfinite(float(aux["loss"]))


# ---------------------------------------------------------------------------
# the flash backward's plain route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,Sq,Hq,Hkv,D,causal,window,chunk", [
    (2, 64, 4, 2, 32, True, 0, 16),  # GQA causal
    (1, 96, 6, 2, 32, True, 24, 32),  # sliding window
    (1, 80, 4, 1, 64, True, 0, 16),  # MQA
    (2, 48, 4, 4, 32, False, 0, 16),  # MHA, not causal
])
def test_attention_grads_match_jax(B, Sq, Hq, Hkv, D, causal, window, chunk):
    """dq, dk, dv of the port's plain flash route (autograd of the plain
    version), of the backward kernel's plain version (FlashAttention-2's
    math) and of the ``_attn_chunked`` twin, each against ``jax.grad`` of
    JAX's ``_attn_chunked``."""
    rng = np.random.default_rng(B * 100 + Sq)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, Hq, D), (B, Sq, Hkv, D), (B, Sq, Hkv, D)))
    do = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)

    def jloss(q, k, v):
        out = JL._attn_chunked(q, k, v, 0, causal, window, chunk)
        return jnp.sum(out * do)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kw = dict(causal=causal, window=window)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tdo = torch.from_numpy(do)
    routes = {
        "flash_plain": torch.autograd.grad(flash_attention(tq, tk, tv, **kw), (tq, tk, tv), tdo),
        "chunked_twin": torch.autograd.grad(
            TL._attn_chunked(tq, tk, tv, 0, causal, window, chunk), (tq, tk, tv), tdo),
    }
    o, lse = flash_attention_lse_ref(tq.detach(), tk.detach(), tv.detach(), **kw)
    routes["fa2_math"] = flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), o, lse, tdo,
                                             **kw)
    for route, got in routes.items():
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATTN_TOL, rtol=ATTN_TOL,
                                       err_msg=f"{route} {name}")


def test_ragged_last_chunk_grads_match_jax_flash_ref():
    """Sk = 80 is not a multiple of 64.  JAX's ``_attn_chunked`` pads the
    last chunk and then masks keys at or past ``Sk - pad`` (32) instead of
    ``Sk`` (``repro/models/layers.py:132``), so its output is wrong there
    (ROADMAP section 3); the port's routes are held against ``jax.grad`` of
    JAX's plain ``flash_attention_ref`` instead."""
    from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref

    rng = np.random.default_rng(80)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((1, 80, 4, 64), (1, 80, 1, 64), (1, 80, 1, 64), (1, 80, 4, 64)))
    want = jax.grad(lambda q, k, v: jnp.sum(jax_flash_ref(q, k, v, causal=True) * do),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tdo = torch.from_numpy(do)
    for got in (torch.autograd.grad(flash_attention(tq, tk, tv), (tq, tk, tv), tdo),
                torch.autograd.grad(TL._attn_chunked(tq, tk, tv, 0, True, 0, 64), (tq, tk, tv),
                                    tdo)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATTN_TOL, rtol=ATTN_TOL)


def test_softcap_and_offset_backward_math():
    """The FlashAttention-2 math with a softcap and a q offset against
    autograd of the plain version."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn((1, 32, 4, 32), generator=g).requires_grad_()
    k, v = (torch.randn((1, 96, 2, 32), generator=g).requires_grad_() for _ in range(2))
    do = torch.randn((1, 32, 4, 32), generator=g)
    kw = dict(causal=True, window=40, softcap=5.0, q_offset=64)
    want = torch.autograd.grad(flash_attention(q, k, v, **kw), (q, k, v), do)
    o, lse = flash_attention_lse_ref(q.detach(), k.detach(), v.detach(), **kw)
    got = flash_attention_bwd(q.detach(), k.detach(), v.detach(), o, lse, do, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATTN_TOL, rtol=ATTN_TOL)


# ---------------------------------------------------------------------------
# no silent loss of gradients on the card
# ---------------------------------------------------------------------------
def test_refuse_grad_raises_only_while_recording_a_gradient():
    """The guard the CUDA route of decode_attention calls (a CPU stand-in:
    the guard looks at autograd state only, so CPU tensors exercise it as
    CUDA ones would)."""
    x = torch.zeros(4, requires_grad=True)
    y = torch.zeros(4)
    with pytest.raises(RuntimeError, match="no backward.*serving"):
        _grad.refuse_grad("decode_attention", y, x)
    _grad.refuse_grad("decode_attention", y, y)  # nothing needs a gradient
    with torch.no_grad():
        _grad.refuse_grad("decode_attention", x)  # serving: autograd is not recording
    with pytest.raises(RuntimeError, match="decode_attention"):
        _grad.refuse_grad("decode_attention", x * 2)  # an activation downstream of a parameter


def _route_order():
    """Positions, in the route rule's source, of its CPU branch, its
    autograd test, the ``Function`` and the device route."""
    import inspect

    from repro_torch.kernels import _route

    src = inspect.getsource(_route.call)
    return [src.index(t) for t in ('device.type == "cpu"', "torch.is_grad_enabled()",
                                   "return function()", "return device()")]


@pytest.mark.parametrize("module", ["decode_attention"])
def test_kernels_without_backward_guard_their_cuda_route(module):
    """Each such wrapper calls the guard on its CUDA route (the route rule's
    device route, after its device dispatch) before the launch: a call that
    autograd records raises on ``meta`` as on CUDA, and takes the plain
    version on the CPU."""
    import importlib
    import inspect

    ops = importlib.import_module(f"repro_torch.kernels.{module}.ops")
    cpu, _, _, device = _route_order()
    assert cpu < device
    assert "device=lambda: _device(" in inspect.getsource(getattr(ops, module))
    src = inspect.getsource(ops._device)
    assert src.index(f'refuse_grad("{module}"') < src.index("_fwd(")
    q, k = torch.randn(2, 4, 32, requires_grad=True), torch.randn(2, 8, 2, 32)
    lengths = torch.tensor([8, 3], dtype=torch.int32)
    assert getattr(ops, module)(q, k, k, lengths).requires_grad  # the plain version
    with pytest.raises(RuntimeError, match="no backward"):
        getattr(ops, module)(q.detach().to("meta").requires_grad_(), k.to("meta"),
                             k.to("meta"), lengths.to("meta"))


@pytest.mark.parametrize("module,function", [("ssd_scan", "SSDScan"),
                                             ("moe_router", "MoERouter")])
def test_kernels_with_backward_take_their_function_on_the_cuda_route(module, function):
    """ssd_scan and moe_router have backward kernels: on the CUDA route,
    after the device dispatch and before the launch, a call that autograd
    records goes through their ``torch.autograd.Function``, whose backward
    is the backward wrapper; no guard is left on them."""
    import importlib
    import inspect

    ops = importlib.import_module(f"repro_torch.kernels.{module}.ops")
    src = inspect.getsource(getattr(ops, module))
    assert "refuse_grad" not in inspect.getsource(ops)
    cpu, record, apply, device = _route_order()
    assert cpu < record < apply < device
    assert f"function=lambda: {function}.apply(" in src and "device=lambda: _forward(" in src
    fn = getattr(ops, function)
    assert issubclass(fn, torch.autograd.Function)
    assert f"{module}_bwd(" in inspect.getsource(fn.backward)
    if module == "ssd_scan":
        args = [torch.empty(s, device="meta") for s in
                ((1, 16, 4, 32), (1, 16, 4), (4,), (1, 16, 1, 16), (1, 16, 1, 16), (4,))]
        call = lambda *a: ops.ssd_scan(*a, chunk=16)[0]  # noqa: E731
    else:
        args, call = [torch.empty((8, 4), device="meta")], lambda t: ops.moe_router(t, 2)[1]
    assert call(*args).grad_fn is None
    out = call(args[0].requires_grad_(), *args[1:])
    assert out.device.type == "meta" and type(out.grad_fn).__name__ == f"{function}Backward"


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _small_jax_state(param_dtype="float32"):
    cfg = jax_get_config("starcoder2-3b").scaled_down().replace(param_dtype=param_dtype)
    state = jax_init_train_state(jax_build_model(cfg), jax.random.PRNGKey(0), JaxAdamWConfig())
    return cfg, state


def _torch_target(arch_cfg_replace):
    cfg = get_config("starcoder2-3b").scaled_down().replace(**arch_cfg_replace)
    return init_train_state(build_model(cfg), 0, AdamWConfig(), device="cpu")


def test_checkpoint_round_trip_with_jax(tmp_path):
    """JAX saves, torch restores, torch saves, JAX restores: bit-exact."""
    _, jstate = _small_jax_state()
    jax_dir, torch_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_save_checkpoint(jax_dir, 3, jstate)
    restored, step = restore_checkpoint(jax_dir, _torch_target({}))
    assert step == 3 and latest_step(jax_dir) == 3
    want = dict(flatten_with_paths(_carry(jstate)))
    got = dict(flatten_with_paths(restored))
    assert got.keys() == want.keys() and "opt/step" in got
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    save_checkpoint(torch_dir, 3, restored)
    back, step = jax_restore_checkpoint(torch_dir, jax.eval_shape(lambda: jstate))
    assert step == 3
    for (ka, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                               jax.tree_util.tree_flatten_with_path(jstate)[0]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(ka))
    with open(os.path.join(torch_dir, "step_00000003", "manifest.json")) as f:
        with open(os.path.join(jax_dir, "step_00000003", "manifest.json")) as g:
            assert json.load(f) == json.load(g)


def test_checkpoint_bf16_leaves_are_jax_bytes(tmp_path):
    """bf16 leaves restore from JAX's files without ml_dtypes, and the port
    writes byte-equal files (header descr '<V2', manifest "bfloat16")."""
    _, jstate = _small_jax_state("bfloat16")
    jax_dir, torch_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_save_checkpoint(jax_dir, 1, jstate)
    restored, _ = restore_checkpoint(jax_dir, _torch_target({"param_dtype": "bfloat16"}))
    want = dict(flatten_with_paths(_carry(jstate)))
    for key, t in flatten_with_paths(restored):
        assert t.dtype == want[key].dtype and torch.equal(t, want[key]), key
    assert restored["params"]["embed"].dtype == torch.bfloat16
    save_checkpoint(torch_dir, 1, restored)
    names = sorted(os.listdir(os.path.join(jax_dir, "step_00000001")))
    assert names == sorted(os.listdir(os.path.join(torch_dir, "step_00000001")))
    for name in names:
        with open(os.path.join(jax_dir, "step_00000001", name), "rb") as f:
            with open(os.path.join(torch_dir, "step_00000001", name), "rb") as g:
                assert f.read() == g.read(), name


def test_checkpoint_keeps_three_newest_and_writes_atomically(tmp_path):
    state = _torch_target({})
    for step in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), step, state)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004", "step_00000005"]
    os.makedirs(tmp_path / "step_00000009.tmp")  # a crashed save
    assert latest_step(str(tmp_path)) == 5
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), _torch_target({"d_model": 64}))


# ---------------------------------------------------------------------------
# service -> DeviceFeeder -> train step
# ---------------------------------------------------------------------------
def test_service_feeds_torch_train_loop(service_factory):
    """The paper's end-to-end story at miniature scale on the port: service
    workers (a forked pool of 2 processes) make token batches, the torch
    DeviceFeeder delivers them, the torch train step consumes them.  Every
    batch repeats one sequence, so a few steps must lower the loss."""
    from repro.data import Dataset

    cfg = get_config("qwen3-14b").scaled_down()
    model = build_model(cfg)
    opt = AdamWConfig(lr=3e-3, warmup_steps=1)
    state = init_train_state(model, 0, opt, device="cpu")
    step = make_train_step(model, opt)
    V, B, S = cfg.vocab_size, 2, 32

    def tokenize(i):
        t = np.random.default_rng(0).integers(1, V, (S + 1,))
        return {"tokens": t[:-1], "labels": t[1:]}

    svc = service_factory(num_workers=1, worker_processes=2)
    ds = (Dataset.range(16 * B).map(tokenize).batch(B, drop_remainder=True)
          .distribute(service=svc, processing_mode="dynamic"))
    losses = []
    with DeviceFeeder(ds, device="cpu") as feeder:
        for batch in feeder:  # each of the 2 processes drops its shard's odd tail
            assert batch["tokens"].shape == (B, S) and batch["tokens"].dtype == torch.int64
            _, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            if len(losses) == 6:
                break
    assert len(losses) == 6
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.5, losses


def test_feed_and_train_import_without_cuda_nvcc_or_ml_dtypes(tmp_path):
    """``repro_torch.feed`` and ``repro_torch.train`` import with no card, no
    nvcc and no ml_dtypes (the card's machine has none), and a checkpoint
    with bf16 leaves round-trips there."""
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None  # any import of it fails\n"
        "import torch, repro_torch.feed, repro_torch.train\n"
        "from repro_torch.train import save_checkpoint, restore_checkpoint\n"
        f"d = {str(tmp_path)!r}\n"
        "t = {'w': torch.randn(3, 5).bfloat16(), 'step': torch.zeros((), dtype=torch.int32)}\n"
        "save_checkpoint(d, 1, t)\n"
        "back, step = restore_checkpoint(d, t)\n"
        "assert step == 1 and torch.equal(back['w'], t['w']) and back['w'].dtype == torch.bfloat16\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
    )
    env = {"PATH": str(tmp_path), "PYTHONPATH": os.path.abspath(src),
           "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path)}
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)


def test_global_norm_is_exact_on_a_large_leaf():
    """A single f32 reduction over 16 M values drifts on the CPU (about 6e-4
    low; 1.9% at starcoder2-3b's 151 M embedding gradient); the port's
    global norm sums per-row f32 norms in f64 and stays within 1e-6."""
    from repro_torch.train.optimizer import global_norm

    g = torch.Generator().manual_seed(0)
    tree = {"big": torch.randn(16_000_000, generator=g) * 1e-3,
            "odd": [torch.randn((3, 5), generator=g).bfloat16(), torch.randn(1025, generator=g)]}
    want = sum(t.double().square().sum() for t in (tree["big"], *tree["odd"])).sqrt()
    got = global_norm(tree)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
