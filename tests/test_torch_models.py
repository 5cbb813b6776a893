"""The port's model layers and LanguageModel (dense, MoE, SSM and hybrid
families) against the JAX package.

Inputs are made with numpy from fixed seeds; JAX weights come from
``LanguageModel.init(jax.random.PRNGKey(0))`` (or the layer inits) and are
carried across with ``repro_torch.bridge.params_from_jax``.  Sizes are
``scaled_down()``, everything in f32.  Tolerances:

* elementwise twins (norm, rope): 1e-5 - the two frameworks' f32 rsqrt,
  pow, sin and cos may differ by an ulp or two;
* one projection-bearing layer (mlp, attention): 2e-5 - f32 dot products
  summed in another order;
* logits through 4 layers and a 512-wide head: 1e-4 - those rounding
  differences compound through the residual stream;
* decode vs forward inside one framework: 2e-3, the JAX suite's own
  tolerance for that invariant (``tests/test_serve.py``).

The MoE and mamba2 layers run on both routes of the port (the ``xla`` twin
of the JAX formulation, and the kernel route, whose CPU path is the plain
versions of ``moe_router`` and ``ssd_scan``); the JAX layers call no Pallas
kernel on either setting, so both routes are held to the same JAX output.
The mixer is one projection-bearing layer (2e-5) whose scan sums a sequence
in another order on the kernel route (the token recurrence against the
chunked einsums), so it is held at 1e-4 there.
"""
import inspect

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro_torch.bridge import flatten_with_paths, params_from_jax, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as TL

ELEMENTWISE_TOL = 1e-5
LAYER_TOL = 2e-5
SCAN_LAYER_TOL = 1e-4
LOGITS_TOL = 1e-4
DENSE_ARCHS = ["qwen3-14b", "starcoder2-3b", "deepseek-7b"]
NEW_ARCHS = ["mamba2-2.7b", "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b", "jamba-v0.1-52b"]


def _cfgs(arch, **kw):
    """(JAX config, port config) with the same fields."""
    return jax_get_config(arch).scaled_down().replace(**kw), get_config(arch).scaled_down().replace(**kw)


def _carry(jax_tree):
    return params_from_jax(jax.device_get(jax_tree))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32) * 3
    w = rng.standard_normal(128).astype(np.float32)
    _close(TL.rms_norm(_t(x), _t(w)), JL.rms_norm(jnp.asarray(x), jnp.asarray(w)), ELEMENTWISE_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 4, 32)).astype(np.float32)
    pos = np.stack([np.arange(64), rng.integers(0, 64, 64)]).astype(np.int32)
    got = TL.apply_rope(_t(x), _t(pos), theta)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(got, want, ELEMENTWISE_TOL)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen3-14b"])  # gelu, swiglu
def test_mlp(arch):
    jcfg, tcfg = _cfgs(arch)
    p = JL.init_mlp(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(2).standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    got = TL.mlp(_carry(p), _t(x), tcfg.mlp_act)
    want = JL.mlp(p, jnp.asarray(x), jcfg.mlp_act)
    _close(got, want, LAYER_TOL)


ATTN_CASES = [
    ("starcoder2-3b", "xla", 16),  # GQA, sliding window live at S=64
    ("starcoder2-3b", "pallas_interpret", 16),
    ("qwen3-14b", "xla", 0),  # qk_norm
    ("qwen3-14b", "pallas_interpret", 0),
    ("deepseek-7b", "xla", 0),  # MHA
]


@pytest.mark.parametrize("arch,impl,window", ATTN_CASES)
def test_attention(arch, impl, window):
    jcfg, tcfg = _cfgs(arch, attn_impl=impl, attn_window=window)
    p = JL.init_attention(jax.random.PRNGKey(4), jcfg)
    x = np.random.default_rng(5).standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64)).copy()
    got = TL.attention(_carry(p), _t(x), tcfg, _t(pos))
    want = JL.attention(p, jnp.asarray(x), jcfg, jnp.asarray(pos))
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("arch,impl,window", ATTN_CASES)
def test_attention_decode(arch, impl, window):
    jcfg, tcfg = _cfgs(arch, attn_impl=impl, attn_window=window)
    p = JL.init_attention(jax.random.PRNGKey(6), jcfg)
    rng = np.random.default_rng(7)
    B, Smax, pos = 2, 48, 37
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    shape = (B, Smax, jcfg.num_kv_heads, jcfg.head_dim)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    cache = {"k": _t(kc.copy()), "v": _t(vc.copy())}
    got, got_cache = TL.attention_decode(_carry(p), _t(x), cache, pos, tcfg)
    want, want_cache = JL.attention_decode(
        p, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        jnp.asarray(pos, jnp.int32), jcfg)
    _close(got, want, LAYER_TOL)
    assert got_cache is cache  # updated in place
    for name in ("k", "v"):
        _close(got_cache[name], want_cache[name], LAYER_TOL)


MIXER_CASES = [  # (impl, L, ssm_groups): L = 40 is not a multiple of the chunk (16)
    ("xla", 64, 1),
    ("xla", 40, 1),
    ("pallas", 64, 1),
    ("pallas", 40, 1),
    ("pallas", 40, 2),  # groups read in place by the kernel route
]


@pytest.mark.parametrize("impl,L,groups", MIXER_CASES)
def test_mamba2_mixer(impl, L, groups):
    jcfg, tcfg = _cfgs("mamba2-2.7b", attn_impl=impl, ssm_groups=groups)
    p = JL.init_mamba2(jax.random.PRNGKey(12), jcfg)
    p["D"] = p["D"] * 1.5  # a D other than 1, so a D term added twice shows
    x = np.random.default_rng(13).standard_normal((2, L, jcfg.d_model)).astype(np.float32)
    got = TL.mamba2_mixer(_carry(p), _t(x), tcfg)
    want = JL.mamba2_mixer(p, jnp.asarray(x), jcfg)
    _close(got, want, LAYER_TOL if impl == "xla" else SCAN_LAYER_TOL)


def test_mamba2_mixer_bf16_compute_promotes_like_jax():
    """bf16 activations with f32 params: the conv promotes x, B and C to f32
    in both frameworks, and only the mixer's Y returns to bf16."""
    jcfg, tcfg = _cfgs("mamba2-2.7b", dtype="bfloat16", attn_impl="pallas")
    p = JL.init_mamba2(jax.random.PRNGKey(14), jcfg)
    x = np.random.default_rng(15).standard_normal((1, 48, jcfg.d_model)).astype(np.float32)
    got = TL.mamba2_mixer(_carry(p), _t(x).bfloat16(), tcfg)
    want = JL.mamba2_mixer(p, jnp.asarray(x, jnp.bfloat16), jcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba2_decode(groups):
    jcfg, tcfg = _cfgs("mamba2-2.7b", ssm_groups=groups)
    p = JL.init_mamba2(jax.random.PRNGKey(16), jcfg)
    rng = np.random.default_rng(17)
    B, H, N, P = 2, jcfg.ssm_heads, jcfg.ssm_state, jcfg.ssm_head_dim
    conv_ch = jcfg.ssm_d_inner + 2 * groups * N
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    h = rng.standard_normal((B, H, N, P)).astype(np.float32)
    conv = rng.standard_normal((B, 3, conv_ch)).astype(np.float32)
    state = {"h": _t(h.copy()), "conv": _t(conv.copy())}
    got, got_state = TL.mamba2_decode(_carry(p), _t(x), state, tcfg)
    want, want_state = JL.mamba2_decode(p, jnp.asarray(x), {"h": jnp.asarray(h),
                                                           "conv": jnp.asarray(conv)}, jcfg)
    _close(got, want, LAYER_TOL)
    assert got_state is state  # updated in place
    for name in ("h", "conv"):
        _close(got_state[name], want_state[name], LAYER_TOL)


MOE_CASES = [  # (arch, impl, dropless, capacity_factor, moe_groups)
    ("moonshot-v1-16b-a3b", "xla", False, 0.5, 0),  # capacity drops
    ("moonshot-v1-16b-a3b", "pallas", False, 0.5, 0),
    ("moonshot-v1-16b-a3b", "xla", True, 0.5, 0),
    ("moonshot-v1-16b-a3b", "pallas", True, 0.5, 0),
    ("kimi-k2-1t-a32b", "pallas", False, 1.25, 0),
    ("jamba-v0.1-52b", "pallas", False, 1.25, 2),  # two groups, capacity per group
]


@pytest.mark.parametrize("arch,impl,dropless,cf,groups", MOE_CASES)
def test_moe_ffn(arch, impl, dropless, cf, groups):
    jcfg, tcfg = _cfgs(arch, attn_impl=impl, capacity_factor=cf, moe_groups=groups)
    p = JL.init_moe(jax.random.PRNGKey(18), jcfg)
    T, E, k = 64, jcfg.num_experts, jcfg.experts_per_token
    x = np.random.default_rng(19).standard_normal((T, jcfg.d_model)).astype(np.float32)
    tp = _carry(p)
    # the routing first: a route that picks other experts fails here, loudly
    G = max(1, groups)
    logits = (_t(x).reshape(G, T // G, -1) @ tp["router"]).float()
    if impl == "xla":
        ids, _, slots = TL._route_top_k(logits, k)
    else:
        ids, _, slots = (torch.stack(r) for r in zip(*(TL.moe_router(lg, k) for lg in logits)))
    jlogits = (jnp.asarray(x).reshape(G, T // G, -1) @ p["router"]).astype(jnp.float32)
    _, jids = jax.lax.top_k(jax.nn.softmax(jlogits, axis=-1), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    C = T // G if dropless else min(T // G, int(np.ceil(T // G * k / E * cf)))
    if not dropless and arch == "moonshot-v1-16b-a3b":
        assert int((slots >= C).sum()) > 0  # the case really drops choices
    got = TL.moe_ffn(tp, _t(x), tcfg, dropless=dropless)
    want = JL.moe_ffn(p, jnp.asarray(x), jcfg, dropless=dropless)
    _close(got, want, LAYER_TOL)


def test_dispatch_slots_are_unique_and_drops_take_the_spare_slot():
    """With capacity drops (moonshot at capacity factor 0.5): every kept
    (group, expert, slot) triple of moe_ffn's dispatch is unique and below
    C, the kept slots are the router's, and every dropped choice lands in
    the spare slot C, which the dispatch buffer has in addition to C."""
    _, tcfg = _cfgs("moonshot-v1-16b-a3b", attn_impl="pallas", capacity_factor=0.5)
    T, E, k = 64, tcfg.num_experts, tcfg.experts_per_token
    logits = torch.from_numpy(np.random.default_rng(26).standard_normal((T, E)).astype(np.float32))
    ids, _, pos = TL.moe_router(logits, k)
    C = min(T, int(np.ceil(T * k / E * 0.5)))
    slot = TL.dispatch_slots(pos[None], C)[0]
    keep = pos < C
    assert 0 < int((~keep).sum()) < T * k  # the case keeps some choices and drops others
    assert torch.equal(slot[keep], pos[keep].long()) and bool((slot[keep] < C).all())
    assert bool((slot[~keep] == C).all())
    kept = list(zip(ids[keep].tolist(), slot[keep].tolist()))
    assert len(set(kept)) == len(kept)
    src = inspect.getsource(TL.moe_ffn)
    assert "accumulate" not in src and "dispatch_slots(pos, C)" in src
    assert "(G, E, C + 1, d)" in src


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_kimi_head_dim_112_matches_jax(impl):
    """kimi-k2 at ``scaled_down()`` with its head dim 112 restored (64/8
    heads scaled to 4/2): forward logits and 8 decode steps against JAX's
    LanguageModel, weights carried across."""
    jm, jp, tm, tp = _models("kimi-k2-1t-a32b", attn_impl=impl, head_dim=112)
    assert tm.cfg.head_dim == 112 and tm.cfg.q_dim == 448
    toks = np.random.default_rng(27).integers(1, jm.cfg.vocab_size, (2, 32)).astype(np.int32)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, {"tokens": _t(toks)})
    _close(got, want, LOGITS_TOL)
    step = jax.jit(jm.decode_step)
    jc, tc = jm.init_cache(2, 8), tm.init_cache(2, 8, device="cpu")
    for t in range(8):
        want, jc = step(jp, jc, jnp.asarray(toks[:, t]))
        got, tc = tm.decode_step(tp, tc, _t(toks[:, t]))
        _close(got, want, LOGITS_TOL)


# ---------------------------------------------------------------------------
# LanguageModel
# ---------------------------------------------------------------------------
def _models(arch, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp), like=tm.init(0, device="cpu"))
    return jm, jp, tm, tp


FORWARD_CASES = (
    [(a, "xla", {}) for a in DENSE_ARCHS] + [("starcoder2-3b", "pallas_interpret", {})]
    + [(a, impl, {}) for a in NEW_ARCHS for impl in ("xla", "pallas_interpret")]
    + [("mamba2-2.7b", "pallas_interpret", {"d_ff": 0})]  # the mixer-only block, as published
)


@pytest.mark.parametrize("arch,impl,kw", FORWARD_CASES)
def test_forward_logits_match_jax(arch, impl, kw):
    jm, jp, tm, tp = _models(arch, attn_impl=impl, **kw)
    toks = np.random.default_rng(8).integers(1, jm.cfg.vocab_size, (2, 64)).astype(np.int32)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, {"tokens": _t(toks)})
    assert got.shape == (2, 64, jm.cfg.vocab_size) and got.dtype == torch.float32
    _close(got, want, LOGITS_TOL)
    last = tm.forward(tp, {"tokens": _t(toks)}, last_token_only=True)
    _close(last, np.asarray(want)[:, -1:], LOGITS_TOL)


@pytest.mark.parametrize("arch", DENSE_ARCHS + NEW_ARCHS)
def test_decode_steps_match_jax(arch):
    """16 decode steps: the port's logits and cache (KV and SSM state)
    follow JAX's, leaf by leaf; MoE decode is dropless on both sides."""
    jm, jp, tm, tp = _models(arch, attn_window=8 if arch == "starcoder2-3b" else 0,
                             attn_impl="pallas" if arch in NEW_ARCHS[::2] else "xla")
    toks = np.random.default_rng(9).integers(1, jm.cfg.vocab_size, (2, 16)).astype(np.int32)
    step = jax.jit(jm.decode_step)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16, device="cpu")
    for t in range(16):
        want, jc = step(jp, jc, jnp.asarray(toks[:, t]))
        got, tc = tm.decode_step(tp, tc, _t(toks[:, t]))
        _close(got, want, LOGITS_TOL)
    assert tc["pos"] == int(jc["pos"]) == 16
    jflat = dict(flatten_with_paths(jax.device_get({k: v for k, v in jc.items() if k != "pos"})))
    tflat = dict(flatten_with_paths({k: v for k, v in tc.items() if k != "pos"}))
    assert jflat.keys() == tflat.keys()
    for key in jflat:
        _close(tflat[key], jflat[key], LOGITS_TOL)


@pytest.mark.parametrize(
    "arch,impl", [("qwen3-14b", "xla"), ("starcoder2-3b", "xla"), ("starcoder2-3b", "pallas")]
)
def test_decode_matches_forward_teacher_forcing(arch, impl):
    """Port only: token-by-token decode_step reproduces forward's logits
    (on the CPU, "pallas" runs both kernels' plain versions)."""
    tcfg = get_config(arch).scaled_down().replace(attn_impl=impl, attn_window=6)
    model = build_model(tcfg)
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(10).integers(1, tcfg.vocab_size, (2, 16)))
    full = model.forward(params, {"tokens": toks})
    cache = model.init_cache(2, 16, device="cpu")
    outs = []
    for t in range(16):
        logits, cache = model.decode_step(params, cache, toks[:, t])
        outs.append(logits)
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_new_families_decode_matches_forward(arch, impl):
    """Twin of ``tests/test_serve.py::test_decode_matches_forward_teacher_forcing``
    for the SSM, hybrid and MoE families, on both routes: the forward's
    capacity is made dropless, as decode always is."""
    cfg = get_config(arch).scaled_down().replace(attn_impl=impl)
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=float(cfg.num_experts))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(20).integers(1, cfg.vocab_size, (2, 16)))
    full = model.forward(params, {"tokens": toks})
    cache = model.init_cache(2, 16, device="cpu")
    outs = []
    for t in range(16):
        logits, cache = model.decode_step(params, cache, toks[:, t])
        outs.append(logits)
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full), atol=2e-3, rtol=2e-3)


def test_cast_for_compute_keeps_ssm_leaves():
    """The cast covers in_proj, out_proj and router but leaves the mamba2
    vectors and conv in the parameter dtype (the conv_w promotion rule)."""
    model = build_model(get_config("jamba-v0.1-52b").scaled_down().replace(dtype="bfloat16"))
    cast = model.cast_for_compute(model.init(0, device="cpu"))
    layers = cast["group0"]
    ssm, moe = layers[0]["ssm"], layers[1]["moe"]
    assert ssm["in_proj"].dtype == ssm["out_proj"].dtype == torch.bfloat16
    assert moe["router"].dtype == moe["w1"].dtype == torch.bfloat16
    for name in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w"):
        assert ssm[name].dtype == torch.float32, name


def test_cast_for_compute_matches_per_use_cast():
    """Casting the matmul weights once (bf16 compute) gives the numbers of
    casting them at every use, and leaves the norm scales in f32."""
    tcfg = get_config("qwen3-14b").scaled_down().replace(dtype="bfloat16")
    model = build_model(tcfg)
    params = model.init(0, device="cpu")
    cast = model.cast_for_compute(params)
    assert cast["embed"].dtype == torch.bfloat16 and cast["final_norm"].dtype == torch.float32
    assert cast["group0"][0]["attn"]["q_norm"].dtype == torch.float32
    toks = torch.from_numpy(np.random.default_rng(11).integers(1, tcfg.vocab_size, (2, 8)))
    assert torch.equal(model.forward(params, {"tokens": toks}),
                       model.forward(cast, {"tokens": toks}))


# ---------------------------------------------------------------------------
# bridge and families
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,dtype", [
    ("starcoder2-3b", "float32"), ("starcoder2-3b", "bfloat16"),
    ("mamba2-2.7b", "float32"), ("moonshot-v1-16b-a3b", "bfloat16"),
    ("jamba-v0.1-52b", "float32"), ("jamba-v0.1-52b", "bfloat16"),
])
def test_bridge_round_trip_is_bit_exact(arch, dtype):
    jm = jax_build_model(jax_get_config(arch).scaled_down())
    tree = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    if dtype == "bfloat16":
        tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), tree)
    back = params_to_numpy(params_from_jax(tree))
    want = dict(flatten_with_paths(tree))
    got = dict(flatten_with_paths(back))
    assert got.keys() == want.keys() and "embed" in got
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype and got[key].shape == arr.shape, key
        assert np.array_equal(got[key].view(np.uint8), np.ascontiguousarray(arr).view(np.uint8))


def test_bridge_checks_against_the_port_layout():
    jm = jax_build_model(jax_get_config("qwen3-14b").scaled_down())
    tm = build_model(get_config("qwen3-14b").scaled_down())
    tree = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    like = tm.init(0, device="cpu")
    params_from_jax(tree, like=like)
    del tree["group0"][0]["attn"]["q_norm"]
    with pytest.raises(AssertionError, match="q_norm"):
        params_from_jax(tree, like=like)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b"])
def test_bridge_checks_new_families_against_the_port_layout(arch):
    """The ssm/moe leaves, the leading dense group (first_dense_layers) and
    the hybrid period group carry across with the port's keys, shapes and
    dtypes; a block whose ffn is "none" has no ln2 on either side."""
    jm = jax_build_model(jax_get_config(arch).scaled_down().replace(d_ff=0)
                         if arch == "mamba2-2.7b" else jax_get_config(arch).scaled_down())
    tm = build_model(get_config(arch).scaled_down().replace(d_ff=0)
                     if arch == "mamba2-2.7b" else get_config(arch).scaled_down())
    tree = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    like = tm.init(0, device="cpu")
    keys = [k for k, _ in flatten_with_paths(params_from_jax(tree, like=like))]
    if arch == "mamba2-2.7b":
        assert "group0/0/ssm/conv_w" in keys and not any("ln2" in k for k in keys)
    elif arch == "moonshot-v1-16b-a3b":
        assert "group0/0/mlp/w1" in keys and "group1/0/moe/router" in keys
    else:
        assert "group0/1/moe/w3" in keys and "group0/3/attn/wq" in keys
    blocks = tree["group1"] if arch == "moonshot-v1-16b-a3b" else tree["group0"]
    del blocks[-1][next(k for k in ("moe", "ssm") if k in blocks[-1])]
    with pytest.raises(AssertionError, match="only in the port"):
        params_from_jax(tree, like=like)

