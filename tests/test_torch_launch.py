"""The port's launcher (``repro_torch.launch``) against the JAX package's
``repro.launch``: input specs, parameter shapes and the 6.N.D model FLOPs
for every (arch x shape) cell; the kernels' shape-only ``meta`` route and
its FLOP formulas; the one-card dry run against JAX's HLO dot FLOPs; the
launcher's batches and its ``--execute`` run on the CPU with the data
service started and stopped."""
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import roofline as jax_roofline  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.config import SHAPES as JAX_SHAPES  # noqa: E402
from repro_torch.bridge import flatten_with_paths  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import KERNELS, _shape, launch_counts  # noqa: E402
from repro_torch.launch import dryrun, flops, roofline, specs  # noqa: E402
from repro_torch.models import SHAPES, build_model  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.train import AdamWConfig, init_state  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) else np.dtype(dt).name


def _jax_leaves(tree):
    return {jax.tree_util.keystr(p): (tuple(x.shape), _dtype_name(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _torch_leaves(tree):
    """{JAX-style key path: (shape, dtype)} of a port tree, keys as
    ``jax.tree_util.keystr`` writes them."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], f"{path}['{k}']")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
        elif isinstance(t, torch.Tensor):
            out[path] = (tuple(t.shape), _dtype_name(t.dtype))

    walk(tree, "")
    return out


def _load_example():
    spec = importlib.util.spec_from_file_location("train_e2e_torch",
                                                  ROOT / "examples" / "train_e2e_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# specs and parameter shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", CELLS)
def test_specs_equal_jax(arch, shape):
    cfg, sh = get_config(arch), SHAPES[shape]
    jcfg, jsh = jax_config(arch), JAX_SHAPES[shape]
    for ours, theirs in ((specs.train_input_specs(cfg, sh), jax_specs.train_input_specs(jcfg, jsh)),
                         (specs.prefill_input_specs(cfg, sh),
                          jax_specs.prefill_input_specs(jcfg, jsh))):
        assert list(ours) == list(theirs)
        assert all(t.device.type == "meta" for t in ours.values())
        assert _torch_leaves(ours) == _jax_leaves(theirs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_specs_equal_jax(arch):
    """The decode cells' token specs and cache, leaf by leaf; the port keeps
    ``pos`` a host int where JAX has an int32 scalar."""
    cfg, sh = get_config(arch), SHAPES["decode_32k"]
    jcfg = jax_config(arch)
    tok, cache = specs.decode_input_specs(build_model(cfg), cfg, sh)
    jtok, jcache = jax_specs.decode_input_specs(jax_build(jcfg), jcfg, JAX_SHAPES["decode_32k"])
    assert _torch_leaves(tok) == _jax_leaves(jtok)
    want = {k: v for k, v in _jax_leaves(jcache).items() if k != "['pos']"}
    assert _torch_leaves(cache) == want
    assert cache["pos"] == 0
    assert all(t.device.type == "meta" for _, t in flatten_with_paths(cache)
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_shape_equals_init(arch):
    """``params_shape`` and ``opt_shape`` build on meta the leaves that
    ``init`` and ``init_state`` build on the CPU (at ``scaled_down()``), and
    the full config's leaves are JAX's."""
    cfg = get_config(arch).scaled_down()
    model = build_model(cfg)
    got = specs.params_shape(model)
    want = model.init(0, device="cpu")
    assert _torch_leaves(got) == _torch_leaves(want)
    assert all(t.device.type == "meta" for _, t in flatten_with_paths(got))
    oc = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    assert _torch_leaves(specs.opt_shape(model, oc)) == _torch_leaves(init_state(want, oc))
    full = jax_build(jax_config(arch))
    jparams = jax.eval_shape(lambda: full.init(jax.random.PRNGKey(0)))
    assert _torch_leaves(specs.params_shape(build_model(get_config(arch)))) == _jax_leaves(jparams)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_jax(arch, shape):
    sh = SHAPES[shape]
    for chips in (1, 256):
        assert roofline.model_flops(get_config(arch), sh, sh.kind, chips) == \
            jax_roofline.model_flops(jax_config(arch), JAX_SHAPES[shape], sh.kind, chips)


def test_roofline_report_keeps_jax_fields():
    import dataclasses

    ours = [f.name for f in dataclasses.fields(roofline.RooflineReport)]
    assert ours == [f.name for f in dataclasses.fields(jax_roofline.RooflineReport)]
    assert roofline.PEAK == 989e12 and roofline.HBM_BW == 3.35e12


# ---------------------------------------------------------------------------
# the kernels' meta route
# ---------------------------------------------------------------------------
def _op_cases(alt: bool = False):
    """(name, wrapper call on a device, formula FLOPs, plain version call):
    each kernel op at a small shape the kernels take; ``alt``: a second
    shape (one sequence of 9 steps, one B/C group, 10 routed tokens)."""
    from repro_torch.kernels.adamw_update import adamw_update, adamw_update_ref
    from repro_torch.kernels.causal_conv import (causal_conv, causal_conv_bwd,
                                                 causal_conv_bwd_ref, causal_conv_ref)
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_ref, flash_attention_ref)
    from repro_torch.kernels.fused_augment import fused_augment, fused_augment_ref
    from repro_torch.kernels.moe_router import moe_router, moe_router_bwd, moe_router_bwd_ref
    from repro_torch.kernels.moe_router import moe_router_ref
    from repro_torch.kernels.rms_norm import (rms_norm, rms_norm_bwd, rms_norm_bwd_ref,
                                              rms_norm_ref, rstd_ref)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd, ssd_scan_bwd_ref, ssd_scan_ref

    B, Sq, Sk, Hq, Hkv, D = 2, 24, 40, 4, 2, 32
    Bs, L, H, P, N, G = (1, 9, 4, 32, 16, 1) if alt else (2, 40, 4, 32, 16, 2)
    T, E, k = (10, 8, 2) if alt else (20, 8, 2)
    seed = 7 if alt else 0

    def flash_in(dev):
        g = torch.Generator().manual_seed(0)
        q, kk, v = (torch.randn(s, generator=g).to(dev) for s in
                    ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
        return q, kk, v

    def flash_bwd_in(dev):
        q, kk, v = flash_in("cpu")
        o = flash_attention_ref(q, kk, v, causal=True, q_offset=16)
        lse = torch.zeros((B, Hq, Sq))
        return [t.to(dev) for t in (q, kk, v, o, lse, torch.ones_like(o))]

    def decode_in(dev):
        g = torch.Generator().manual_seed(1)
        return (torch.randn((B, Hq, D), generator=g).to(dev),
                torch.randn((B, Sk, Hkv, D), generator=g).to(dev),
                torch.randn((B, Sk, Hkv, D), generator=g).to(dev),
                torch.tensor([Sk, 7], dtype=torch.int32).to(dev))

    def ssd_in(dev):
        g = torch.Generator().manual_seed(seed + 2)
        x = torch.randn((1, L, H, P), generator=g)
        dt = torch.rand((1, L, H), generator=g) * 0.1
        a = -torch.rand((H,), generator=g)
        Bm, Cm = torch.randn((1, L, G, N), generator=g), torch.randn((1, L, G, N), generator=g)
        D_ = torch.ones((H,))
        return [t.to(dev) for t in (x, dt, a, Bm, Cm, D_)]

    def router_in(dev):
        return torch.randn((T, E), generator=torch.Generator().manual_seed(seed + 3)).to(dev)

    def router_bwd_in(dev):
        ids, gates, _ = moe_router_ref(router_in("cpu"), k)
        return [t.to(dev) for t in (ids, gates, torch.ones_like(gates))]

    def augment_in(dev):
        g = torch.Generator().manual_seed(4)
        img = torch.randint(0, 255, (2, 12, 10, 3), generator=g, dtype=torch.uint8)
        crops = torch.tensor([[0, 1], [2, 0]], dtype=torch.int32)
        flips = torch.tensor([1, 0], dtype=torch.int32)
        mean, std = torch.rand(3, generator=g), torch.rand(3, generator=g) + 0.5
        return [t.to(dev) for t in (img, crops, flips, mean, std)]

    def conv_in(dev):  # (x, B, C) read in place from a (z, x, B, C, dt) row
        g = torch.Generator().manual_seed(seed + 5)
        zxbcdt = torch.randn((Bs, L, 2 * H * P + 2 * G * N + H), generator=g).bfloat16()
        xbc = zxbcdt[..., H * P:2 * H * P + 2 * G * N]
        return (xbc.to(dev), torch.randn((4, H * P + 2 * G * N), generator=g).to(dev),
                torch.randn((H * P + 2 * G * N,), generator=g).to(dev))

    def conv_bwd_in(dev):
        xbc, w, b = conv_in("cpu")
        outs = causal_conv_ref(xbc, w, b, H * P)
        return [t.to(dev) for t in (xbc, w, b, *(torch.ones_like(o) for o in outs))]

    def norm_in(dev):  # the gated norm: y in f32, z read in place from a (z, x, B, C, dt) row
        g = torch.Generator().manual_seed(seed + 6)
        zxbcdt = torch.randn((Bs, L, 2 * H * P + 2 * G * N + H), generator=g).bfloat16()
        return (torch.randn((Bs, L, H * P), generator=g).to(dev),
                torch.randn((H * P,), generator=g).to(dev), zxbcdt[..., :H * P].to(dev))

    def norm_bwd_in(dev):
        y, w, z = norm_in("cpu")
        out = rms_norm_ref(y, w, 1e-6, z)
        return [t.to(dev) for t in (y, w, rstd_ref(y, 1e-6, z), torch.ones_like(out), z)]

    def adamw_in(dev):  # a stacked (decayed) leaf of 10 x 13 values, no multiple of 8
        g = torch.Generator().manual_seed(seed + 7)
        p, grad, m = (torch.randn((10, 13), generator=g) for _ in range(3))
        v = torch.rand((10, 13), generator=g)
        return [t.to(dev) for t in (p, grad, m, v, torch.tensor(0.5))]

    adamw_kw = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, c1=0.19, c2=0.0975, weight_decay=0.1)

    def updated(fn):  # the update's in-place outputs, as a kernel op's outputs
        return lambda p, g, m, v, s: (fn(p, g, m, v, s, **adamw_kw), (p, m, v))[1]

    fl = flops.flash_flops
    kw = dict(causal=True, window=10, q_offset=16)
    return [
        ("flash_attention", flash_in, lambda *t: flash_attention(*t, **kw),
         fl(B, Sq, Sk, Hq, D, **kw), lambda *t: flash_attention_ref(*t, **kw)),
        ("flash_attention_bwd", flash_bwd_in,
         lambda *t: flash_attention_bwd(*t, causal=True, q_offset=16),
         fl(B, Sq, Sk, Hq, D, True, 0, 16, backward=True),
         lambda *t: flash_attention_bwd_ref(*t, causal=True, q_offset=16)),
        ("decode_attention", decode_in, lambda *t: decode_attention(*t, window=16),
         flops.decode_flops(Hq, D, flops.decode_visible(B, Sk, 16)),
         lambda *t: decode_attention_ref(*t, window=16)),
        ("ssd_scan", ssd_in, lambda *t: ssd_scan(*t, chunk=16),
         flops.ssd_flops(1, L, H, P, N, 16, G), ssd_scan_ref),
        ("ssd_scan_bwd", lambda d: (*ssd_in(d), ssd_in(d)[0]), ssd_scan_bwd,
         flops.ssd_bwd_flops(1, L, H, P, N, groups=G), ssd_scan_bwd_ref),
        ("moe_router", lambda d: (router_in(d),), lambda t: moe_router(t, k),
         flops.router_flops(T, E, k), lambda t: moe_router_ref(t, k)),
        ("moe_router_bwd", router_bwd_in, lambda *t: moe_router_bwd(*t, E),
         flops.router_bwd_flops(T, k), lambda *t: moe_router_bwd_ref(*t, E)),
        ("fused_augment", augment_in, lambda *t: fused_augment(*t, out_h=8, out_w=6),
         flops.augment_flops(2, 8, 6, 3), lambda *t: fused_augment_ref(*t, 8, 6)),
        ("causal_conv", conv_in, lambda *t: causal_conv(*t, H * P),
         flops.conv_flops(Bs * L, H * P + 2 * G * N), lambda *t: causal_conv_ref(*t, H * P)),
        ("causal_conv_bwd", conv_bwd_in, causal_conv_bwd,
         flops.conv_bwd_flops(Bs * L, H * P + 2 * G * N), causal_conv_bwd_ref),
        ("rms_norm", norm_in, lambda y, w, z: rms_norm(y, w, 1e-6, gate=z),
         flops.norm_flops(Bs * L, H * P, gated=True), lambda y, w, z: rms_norm_ref(y, w, 1e-6, z)),
        ("rms_norm_bwd", norm_bwd_in, rms_norm_bwd,
         flops.norm_bwd_flops(Bs * L, H * P, gated=True), rms_norm_bwd_ref),
        ("adamw_update", adamw_in, updated(adamw_update), flops.adamw_flops(10 * 13),
         updated(adamw_update_ref)),
    ]


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


# every wrapper of kernels.KERNELS on each device, and the backward wrappers
# on the CPU at the second shape
ROUTE_CASES = [(n, dev) for n in KERNELS for dev in ("cpu", "meta")] + [
    (n, "cpu-alt") for n in ("ssd_scan_bwd", "moe_router_bwd", "causal_conv_bwd", "rms_norm_bwd",
                             "adamw_update")]


@pytest.mark.parametrize("name,route", ROUTE_CASES)
def test_cpu_takes_the_plain_version_and_meta_the_shape_op(name, route):
    """On CPU tensors the wrapper computes its plain version (not the
    shape-only op, which refuses real tensors); on meta tensors it returns
    the shape op's outputs, the plain version's shapes and dtypes, charged
    its formula under ``FlopCounterMode``.  Neither launches anything."""
    from torch.utils.flop_counter import FlopCounterMode

    _, inputs, op, want_flops, plain = next(
        c for c in _op_cases(alt=route == "cpu-alt") if c[0] == name)
    before = launch_counts()
    want = _as_tuple(plain(*inputs("cpu")))
    if route == "meta":
        args = inputs("meta")
        with FlopCounterMode(display=False) as fc:
            got = _as_tuple(op(*args))
        assert fc.get_total_flops() == int(want_flops) > 0
        assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype)
                                                            for t in want]
        assert all(t.device.type == "meta" for t in got)
    else:
        got = _as_tuple(op(*inputs("cpu")))
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    assert launch_counts() == before


def test_shape_only_ops_refuse_real_tensors():
    with pytest.raises(RuntimeError, match="shape-only"):
        _shape.moe_router(torch.zeros((4, 8)), 2)


def test_meta_autograd_reaches_the_backward_ops():
    """A train step on meta runs each kernel's backward op through its
    ``autograd.Function`` (FlashAttention, CausalConv, SSDScan, MoERouter,
    RMSNorm)."""
    rec = dryrun.run_cell("jamba-v0.1-52b", ShapeConfig("t", 64, 2, "train"), reduced=True)
    assert rec["status"] == "OK"
    for op in ("flash_attention_bwd", "causal_conv_bwd", "ssd_scan_bwd", "moe_router_bwd",
               "rms_norm_bwd"):
        assert rec["flops_by_op"][f"repro_torch.{op}"] > 0


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------
ANCHOR = dict(arch="deepseek-7b", B=4, S=128)


def _anchor_record():
    return dryrun.run_cell(ANCHOR["arch"], ShapeConfig("anchor", ANCHOR["S"], ANCHOR["B"], "train"),
                           reduced=True, remat="none")


def test_6nd_anchor_dense_lm():
    """Twin of tests/test_dist.py::test_6nd_anchor_dense_lm: the counted
    train-step FLOPs are 6.N.D within remat and attention slack."""
    cfg = get_config(ANCHOR["arch"]).scaled_down().replace(remat="none")
    rec = _anchor_record()
    n = cfg.param_counts()["active"]
    ratio = rec["roofline"]["flops_per_device"] / (6.0 * n * ANCHOR["B"] * ANCHOR["S"])
    assert 0.8 < ratio < 3.0, ratio


def test_dryrun_flops_match_jax_dot_flops():
    """The same step's FLOPs against JAX's HLO dot FLOPs (``hlo_cost``).
    JAX's ``_attn_chunked`` computes every (query, key chunk) block: six
    dots of 2 B Hq Sq Sk' D per layer (Q K^T and P V forward; two each
    backward), Sk' the keys padded to the chunk.  The port charges its
    attention by visible pairs (``flops.flash_flops``).  With each side's
    attention term taken out, the rest (projections, MLP, head, their
    backward) must agree within 2%."""
    from repro.launch import hlo_cost
    from repro.train import AdamWConfig as JaxAdamW
    from repro.train import make_train_step as jax_train_step
    from repro.train import optimizer as jax_opt

    B, S = ANCHOR["B"], ANCHOR["S"]
    jcfg = jax_config(ANCHOR["arch"]).scaled_down().replace(remat="none")
    model = jax_build(jcfg)
    state = jax.eval_shape(lambda: {"params": model.init(jax.random.PRNGKey(0)),
                                    "opt": jax_opt.init_state(model.init(jax.random.PRNGKey(0)),
                                                              JaxAdamW())})
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in ("tokens", "labels")}
    hlo = jax.jit(jax_train_step(model, JaxAdamW())).lower(state, batch).compile().as_text()
    jax_flops = hlo_cost.analyze(hlo).flops
    chunk = min(jcfg.attn_chunk, S)
    sk_pad = -(-S // chunk) * chunk
    jax_attn = jcfg.num_layers * 6 * 2.0 * B * jcfg.num_heads * S * sk_pad * jcfg.head_dim
    rec = _anchor_record()
    by_op = rec["flops_by_op"]
    ours_attn = by_op["repro_torch.flash_attention_fwd"] + by_op["repro_torch.flash_attention_bwd"]
    assert ours_attn == jcfg.num_layers * 3.5 * flops.flash_flops(B, S, S, jcfg.num_heads,
                                                                  jcfg.head_dim)
    ours_rest = rec["roofline"]["flops_per_device"] - ours_attn
    assert ours_rest == pytest.approx(jax_flops - jax_attn, rel=0.02)


def test_dryrun_one_full_config_on_meta():
    """starcoder2-3b's train_4k cell at full width, in seconds and no
    memory: the counted FLOPs over 6.N.D, the H100 roofline, the step's
    temporaries counted (256 x 4096 tokens' activations do not fit one
    card); on the production meshes the partitioned step's count on one
    device (between the even split and the one-card count: the 24 heads do
    not divide the 16-wide model axis, so attention is replicated), the
    arguments' shard bytes per device and a collective term."""
    rec = dryrun.run_cell("starcoder2-3b", "train_4k")
    rl = rec["roofline"]
    assert rec["status"] == "OK" and rl["chips"] == 1 and rl["collective_s"] == 0.0
    assert 1.0 < 1.0 / rl["useful_ratio"] < 2.0  # remat recomputes the forward
    assert rl["compute_s"] == rl["flops_per_device"] / 989e12
    mem = rl["memory_per_device_bytes"]
    assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 80e9
    assert mem["per_device_total"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert rec["fits_hbm_80g"] is False
    for mesh, chips in (("single", 256), ("multi", 512)):
        big = dryrun.run_cell("starcoder2-3b", "train_4k", mesh)
        brl = big["roofline"]
        assert big["status"] == "OK" and brl["chips"] == chips
        assert rl["flops_per_device"] / chips <= brl["flops_per_device"] < rl["flops_per_device"]
        assert brl["collective_s"] > 0 and brl["collective_bytes_per_device"] > 0
        per_dev = brl["memory_per_device_bytes"]["argument_bytes"]
        assert rl["memory_per_device_bytes"]["argument_bytes"] / chips <= per_dev
        assert per_dev < rl["memory_per_device_bytes"]["argument_bytes"] / 16


@pytest.mark.parametrize("arch,shape", [("whisper-large-v3", "decode_32k"),
                                        ("mamba2-2.7b", "long_500k"),
                                        ("qwen2-vl-2b", "prefill_32k"),
                                        ("llama3-405b", "long_500k")])
def test_dryrun_serving_cells(arch, shape):
    rec = dryrun.run_cell(arch, shape, reduced=True)
    if shape == "long_500k" and arch == "llama3-405b":
        assert rec["status"] == "SKIP"
        return
    assert rec["status"] == "OK" and rec["roofline"]["flops_per_device"] > 0
    if arch == "whisper-large-v3":
        # per decoder layer: self-attention over the full cache, cross over the frames
        cfg, sh = get_config(arch).scaled_down(), SHAPES[shape]
        per_layer = sum(flops.decode_flops(cfg.num_heads, cfg.head_dim,
                                           flops.decode_visible(sh.global_batch, rows, 0))
                        for rows in (sh.seq_len, cfg.encoder_seq))
        assert rec["flops_by_op"]["repro_torch.decode_attention"] == cfg.num_layers * per_layer


def test_report_tables(tmp_path):
    from repro_torch.launch import report

    for arch, shape in (("starcoder2-3b", "train_4k"), ("qwen3-14b", "long_500k")):
        rec = dryrun.run_cell(arch, shape, reduced=True)
        (tmp_path / f"one__{arch}__{shape}.json").write_text(json.dumps(rec))
    rows = report.load(str(tmp_path))
    table = report.dryrun_table(rows, "one")
    assert "| starcoder2-3b | train_4k | 256 x 4096 | OK |" in table
    assert "| qwen3-14b | long_500k | 1 x 524288 | SKIP |" in table
    assert "| starcoder2-3b | train_4k |" in report.roofline_table(rows)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _jax_make_batch(cfg, B, S, i):
    """JAX's ``_execute_reduced`` ``make_batch`` (``launch/train.py``), on
    JAX's specs."""
    from repro.models.config import ShapeConfig as JaxShape

    spec = jax_specs.train_input_specs(cfg, JaxShape("exec", S, B, "train"))
    rng = np.random.default_rng(int(i))
    out = {}
    for k, v in spec.items():
        shp = v.shape[1:]
        if jnp.issubdtype(v.dtype, jnp.integer):
            out[k] = rng.integers(1, cfg.vocab_size, shp).astype(np.int32)
        else:
            out[k] = rng.standard_normal(shp).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ["starcoder2-3b", "whisper-large-v3", "qwen2-vl-2b"])
def test_make_batch_is_jax_bit_for_bit(arch):
    example = _load_example()
    make_batch, _ = example.spec_batches(get_config(arch).scaled_down(), 4, 64)
    for i in (0, 7):
        got, want = make_batch(i), _jax_make_batch(jax_config(arch).scaled_down(), 4, 64, i)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def _shm_rings():
    try:
        return {n for n in os.listdir("/dev/shm") if n.startswith("repro_ring_")}
    except OSError:
        return set()


def _subprocess_env():
    """The children's environment: ``src`` on the path, and one OpenMP
    thread.  Under the parallel test run (six workers on the machine's
    cores) a child's default OpenMP pool spins against the service's
    threads and the other workers, and a 6-step CPU run that takes seconds
    alone took over 240 s."""
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


def _launcher(*args, timeout=240):
    env = _subprocess_env()
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "whisper-large-v3", "jamba-v0.1-52b"])
def test_launcher_execute_on_cpu(arch):
    """``--execute --device cpu`` at ``scaled_down()``: the service starts,
    feeds 6 steps and stops; the run exits 0 with finite losses, its result
    line, and nothing left running (threads, processes, /dev/shm rings)."""
    rings = _shm_rings()
    out = _launcher("--arch", arch, "--execute", "--device", "cpu", "--steps", "6")
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["run"] == "train_e2e_torch" and res["full_width"] is False
    assert len(res["losses"]) == 6 and all(math.isfinite(x) for x in res["losses"])
    assert res["first_batch_loss_after"] < res["losses"][0]  # the updates followed its gradient
    assert res["last_batch_loss_after"] < res["losses"][-1]  # and the last step its own batch's
    assert res["feed"]["steps"] == 6 and res["B"] == 4 and res["S"] == 64
    assert 0.0 <= res["feed"]["idle_s_per_step_after_first"] <= res["feed"]["idle_s"] / 5
    assert res["left_running"] == {"threads": [], "processes": []}
    assert all(v == 0 for v in res["launches"].values())  # the CPU runs the plain versions
    assert f"[{arch}] feed: idle" in out.stdout
    assert _shm_rings() <= rings


def test_launcher_without_execute_writes_a_dryrun_record(tmp_path):
    out = _launcher("--arch", "starcoder2-3b", "--shape", "train_4k", "--out", str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "one__preflight__starcoder2_3b__train_4k.json").read_text())
    assert rec["status"] == "OK" and rec["mesh"] == "one" and rec["variant"]["tag"] == "preflight"
    assert rec["roofline"]["flops_per_device"] > rec["roofline"]["model_flops_total"]
    multi = _launcher("--arch", "starcoder2-3b", "--mesh", "multi", "--out", str(tmp_path))
    assert multi.returncode == 0, multi.stderr[-3000:]
    rec = json.loads((tmp_path / "multi__preflight__starcoder2_3b__train_4k.json").read_text())
    assert rec["status"] == "OK" and rec["roofline"]["chips"] == 512


def test_corpus_mode_checkpoints_and_resumes(tmp_path):
    """examples/train_e2e_torch.py's default run (examples/train_e2e.py's
    twin) at ``--tiny`` on the CPU: the workers pack the zipf corpus, a
    checkpoint lands every ``--ckpt-every`` steps, and ``--resume`` picks
    up from the last one."""
    env = _subprocess_env()
    base = [sys.executable, str(ROOT / "examples" / "train_e2e_torch.py"), "--tiny",
            "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = subprocess.run(base + ["--steps", "4"], capture_output=True, text=True, timeout=240,
                           env=env)
    assert first.returncode == 0, first.stderr[-3000:]
    assert "checkpoint @ 4" in first.stdout and "feed breakdown" in first.stdout
    from repro_torch.train import latest_step

    assert latest_step(str(tmp_path)) == 4
    again = subprocess.run(base + ["--steps", "6", "--resume"], capture_output=True, text=True,
                           timeout=240, env=env)
    assert again.returncode == 0, again.stderr[-3000:]
    assert "resumed from step 4" in again.stdout and "step    6" in again.stdout
    assert latest_step(str(tmp_path)) == 6


@pytest.mark.parametrize("mode, flag", [([], ["--batch", "16"]), ([], ["--full-width"]),
                                        (["--launcher"], ["--tiny"]),
                                        (["--launcher"], ["--ckpt-every", "5"])])
def test_example_refuses_the_other_modes_flags(mode, flag):
    """A flag that only the other mode reads is an error, not ignored."""
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "train_e2e_torch.py"),
                          *mode, *flag, "--device", "cpu"], capture_output=True, text=True,
                         timeout=120, env=_subprocess_env())
    assert out.returncode == 2 and f"{flag[0]}: not read in" in out.stderr
