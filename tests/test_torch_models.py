"""The port's model layers and dense LanguageModel against the JAX package.

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
"""
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
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.models import layers as TL

ELEMENTWISE_TOL = 1e-5
LAYER_TOL = 2e-5
LOGITS_TOL = 1e-4
DENSE_ARCHS = ["qwen3-14b", "starcoder2-3b", "deepseek-7b"]


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


# ---------------------------------------------------------------------------
# LanguageModel
# ---------------------------------------------------------------------------
def _models(arch, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp), like=tm.init(0, device="cpu"))
    return jm, jp, tm, tp


@pytest.mark.parametrize(
    "arch,impl",
    [(a, "xla") for a in DENSE_ARCHS] + [("starcoder2-3b", "pallas_interpret")],
)
def test_forward_logits_match_jax(arch, impl):
    jm, jp, tm, tp = _models(arch, attn_impl=impl)
    toks = np.random.default_rng(8).integers(1, jm.cfg.vocab_size, (2, 64)).astype(np.int32)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, {"tokens": _t(toks)})
    assert got.shape == (2, 64, jm.cfg.vocab_size) and got.dtype == torch.float32
    _close(got, want, LOGITS_TOL)
    last = tm.forward(tp, {"tokens": _t(toks)}, last_token_only=True)
    _close(last, np.asarray(want)[:, -1:], LOGITS_TOL)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_steps_match_jax(arch):
    """16 decode steps: the port's logits and cache follow JAX's."""
    jm, jp, tm, tp = _models(arch, attn_window=8 if arch == "starcoder2-3b" else 0)
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bit_exact(dtype):
    jm = jax_build_model(jax_get_config("starcoder2-3b").scaled_down())
    tree = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    if dtype == "bfloat16":
        tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), tree)
    back = params_to_numpy(params_from_jax(tree))
    want = dict(flatten_with_paths(tree))
    got = dict(flatten_with_paths(back))
    assert got.keys() == want.keys() and "group0/0/attn/wq" in got
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


UNPORTED = [a for a in ARCH_IDS if get_config(a).family not in ("dense",)]


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(get_config(arch).scaled_down())
