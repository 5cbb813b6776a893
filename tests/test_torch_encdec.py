"""The port's encoder-decoder (whisper-large-v3 backbone) against the JAX
package's ``repro.models.EncDecModel``.

JAX's parameters come from ``EncDecModel.init(jax.random.PRNGKey(0))`` and
are carried across with ``repro_torch.bridge.params_from_jax``; inputs are
made with numpy from fixed seeds.  Sizes are ``scaled_down()`` (2 encoder
and 2 decoder layers, encoder_seq 32, d_model 128), everything in f32.
Tolerances: 1e-5 for the sinusoids (f32 sin, cos and exp of two
frameworks), 2e-5 for one projection-bearing layer (f32 dot products summed
in another order, as ``tests/test_torch_models.py``), and 1e-5 for the
model's encoder output, logits and caches through 2 + 2 layers.

Both routes of the port are held to JAX: "xla" (the twins of the JAX
formulation) and "pallas" (the kernel wrappers, whose CPU path is the plain
versions of ``flash_attention`` and ``decode_attention``).
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import EncDecModel as JaxEncDecModel
from repro.models import encdec as JE
from repro.models import layers as JL
from repro_torch.bridge import flatten_with_paths, params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import EncDecModel, build_model
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.serve import ServeEngine

ARCH = "whisper-large-v3"
SINUSOID_TOL = 1e-5
LAYER_TOL = 2e-5
MODEL_TOL = 1e-5
ROUTES = ["xla", "pallas"]


def _cfgs(**kw):
    return (jax_get_config(ARCH).scaled_down().replace(**kw),
            get_config(ARCH).scaled_down().replace(**kw))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs()
    return jax.device_get(JaxEncDecModel(jcfg).init(jax.random.PRNGKey(0)))


def _models(impl, jax_params):
    """(JAX model, port model on route ``impl``, carried parameters).  The
    JAX model runs its XLA formulation: its Pallas route compiles for a TPU
    only, and its interpret mode computes the same function."""
    jcfg, tcfg = _cfgs(attn_impl=impl)
    tm = EncDecModel(tcfg)
    jm = JaxEncDecModel(jcfg.replace(attn_impl="xla"))
    return jm, tm, params_from_jax(jax_params, like=tm.init(0, device="cpu"))


def _enc_embeds(cfg, seed=0, B=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _tokens(cfg, S, seed=1, B=2):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq,d", [(32, 128), (64, 1280)])
def test_sinusoid(seq, d):
    _close(TE._sinusoid(seq, d), JE._sinusoid(seq, d), SINUSOID_TOL)


def test_sinusoid_at_whisper_length():
    """At whisper-large-v3's 1500 frames and d_model 1280 the gap to JAX is
    looser than SINUSOID_TOL and bounded: the frequencies (at most 1) differ
    by at most an f32 ulp, 2^-24, which position 1499 turns into 1499 x 2^-24
    of angle; each framework rounds its angle (below 2048) to f32, half an
    ulp of 2^-13 each; sin and cos move no more than their angle, and their
    own rounding stays within SINUSOID_TOL."""
    got = _np(TE._sinusoid(1500, 1280))
    want = _np(JE._sinusoid(1500, 1280))
    assert np.abs(got - want).max() <= 1499 * 2.0 ** -24 + 2.0 ** -13 + SINUSOID_TOL


@pytest.mark.parametrize("pos", [0, 7, 63])
def test_sinusoid_at(pos):
    _close(TE._sinusoid_at(pos, 128), JE._sinusoid_at(jnp.asarray(pos, jnp.int32), 128),
           SINUSOID_TOL)
    assert torch.equal(TE._sinusoid_at(pos, 128), TE._sinusoid(pos + 1, 128)[pos])


def test_sinusoid_frequencies_are_the_rounded_exp():
    """The port rounds an f64 exp to f32, the same on the CPU and the card;
    XLA's f32 exp is off by an ulp on some channels, which a position of
    1499 turns into about 1.2e-4 of the sinusoid, so the two frameworks are
    compared at SINUSOID_TOL at positions below 64 only, and at whisper's
    full length by ``test_sinusoid_at_whisper_length``."""
    import math

    x = np.arange(0, 1280, 2, dtype=np.float32) * np.float32(-math.log(10000.0) / 1280)
    want = np.exp(x.astype(np.float64)).astype(np.float32)
    assert np.array_equal(TE._div(1280, None).numpy(), want)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_cross_attention(impl):
    """Sq = 24 decoder rows over Sk = 32 encoder rows: no rope, no causal
    mask (JAX's ``attention(kv_x=...)``; its Pallas route is the TPU kernel
    in interpret mode)."""
    jcfg, tcfg = _cfgs(attn_impl=impl)
    p = JL.init_attention(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    got = TL.attention(params_from_jax(jax.device_get(p)), _t(x), tcfg, _t(pos),
                       causal=True, kv_x=_t(src))
    want = JL.attention(p, jnp.asarray(x), jcfg, jnp.asarray(pos), causal=True,
                        kv_x=jnp.asarray(src))
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_self_attention_without_rope(impl):
    """The encoder's bidirectional self-attention: ``use_rope=False``,
    ``causal=False``."""
    jcfg, tcfg = _cfgs(attn_impl=impl)
    p = JL.init_attention(jax.random.PRNGKey(6), jcfg)
    x = np.random.default_rng(7).standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32)).copy()
    got = TL.attention(params_from_jax(jax.device_get(p)), _t(x), tcfg, _t(pos),
                       causal=False, use_rope=False)
    want = JL.attention(p, jnp.asarray(x), jcfg, jnp.asarray(pos), causal=False,
                        use_rope=False)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("impl", ROUTES)
def test_cross_attention_decode(impl):
    """One token over the whole encoder K/V: the port's layer (einsums on
    "xla", ``decode_attention``'s plain version with lengths = Senc on
    "pallas") against JAX's ``_cross_decode``."""
    jcfg, tcfg = _cfgs(attn_impl=impl)
    p = JL.init_attention(jax.random.PRNGKey(8), jcfg)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    shape = (2, jcfg.encoder_seq, jcfg.num_kv_heads, jcfg.head_dim)
    xk, xv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    got = TL.cross_attention_decode(params_from_jax(jax.device_get(p)), _t(x), _t(xk), _t(xv),
                                    tcfg)
    want = JaxEncDecModel(jcfg)._cross_decode(p, jnp.asarray(x), jnp.asarray(xk),
                                              jnp.asarray(xv))
    _close(got, want, LAYER_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_params_carry_across(jax_params):
    """JAX's tree (embed, enc, dec with ln_x and xattn, enc_norm,
    final_norm; leaves stacked over layers) is the port's, and ``like``
    catches a missing leaf."""
    _, tcfg = _cfgs()
    like = EncDecModel(tcfg).init(0, device="cpu")
    got = dict(flatten_with_paths(params_from_jax(jax_params, like=like)))
    assert got["dec/xattn/wk"].shape == (tcfg.num_layers, tcfg.d_model, tcfg.kv_dim)
    assert got["enc/ln1"].shape == (tcfg.encoder_layers, tcfg.d_model)
    assert {"embed", "enc_norm", "final_norm", "dec/ln_x"} <= got.keys()
    tree = jax.tree.map(np.asarray, jax_params)
    del tree["dec"]["ln_x"]
    with pytest.raises(AssertionError, match="only in the port"):
        params_from_jax(tree, like=like)


@pytest.mark.parametrize("impl", ROUTES)
def test_encode(impl, jax_params):
    jm, tm, tp = _models(impl, jax_params)
    enc = _enc_embeds(tm.cfg)
    _close(tm.encode(tp, _t(enc)), jm.encode(jax_params, jnp.asarray(enc)), MODEL_TOL)


@pytest.mark.parametrize("impl", ROUTES)
@pytest.mark.parametrize("last_token_only", [False, True])
def test_forward(impl, last_token_only, jax_params):
    jm, tm, tp = _models(impl, jax_params)
    enc, toks = _enc_embeds(tm.cfg), _tokens(tm.cfg, 24)
    got = tm.forward(tp, {"enc_embeds": _t(enc), "tokens": _t(toks)},
                     last_token_only=last_token_only)
    want = jm.forward(jax_params, {"enc_embeds": jnp.asarray(enc), "tokens": jnp.asarray(toks)},
                      last_token_only=last_token_only)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("with_embeds", [True, False])
def test_init_cache(with_embeds, jax_params):
    """Cross K/V of the encoder output (of zeros when no embeddings are
    given, as in JAX), zeroed self K/V, position 0."""
    jm, tm, tp = _models("xla", jax_params)
    enc = _enc_embeds(tm.cfg) if with_embeds else None
    got = tm.init_cache(tp, 2, 16, enc_embeds=None if enc is None else _t(enc))
    want = jm.init_cache(jax_params, 2, 16, enc_embeds=None if enc is None else jnp.asarray(enc))
    assert got["pos"] == int(want["pos"]) == 0
    for name in ("k", "v", "xk", "xv"):
        assert tuple(got[name].shape) == want[name].shape, name
        assert got[name].is_contiguous(), name  # the decode kernel takes slabs of it
        _close(got[name], want[name], MODEL_TOL)
    assert not got["k"].any() and (bool(got["xk"].any()) == with_embeds)


@pytest.mark.parametrize("impl", ROUTES)
def test_decode_steps(impl, jax_params):
    """8 teacher-forced decode steps: logits and the self K/V cache."""
    jm, tm, tp = _models(impl, jax_params)
    enc, toks = _enc_embeds(tm.cfg), _tokens(tm.cfg, 8)
    tcache = tm.init_cache(tp, 2, 16, enc_embeds=_t(enc))
    jcache = jm.init_cache(jax_params, 2, 16, enc_embeds=jnp.asarray(enc))
    jstep = jax.jit(jm.decode_step)
    for t in range(8):
        got, out = tm.decode_step(tp, tcache, _t(toks[:, t]))
        want, jcache = jstep(jax_params, jcache, jnp.asarray(toks[:, t]))
        assert out is tcache  # updated in place
        _close(got, want, MODEL_TOL)
    assert tcache["pos"] == int(jcache["pos"]) == 8
    _close(tcache["k"], jcache["k"], MODEL_TOL)


def test_decode_is_not_the_forward_by_design(jax_params):
    """The reference's decode applies rope in its self-attention and its
    forward does not, so the two differ in both packages; the port's gap
    equals JAX's."""
    jm, tm, tp = _models("xla", jax_params)
    enc, toks = _enc_embeds(tm.cfg), _tokens(tm.cfg, 6)
    full = tm.forward(tp, {"enc_embeds": _t(enc), "tokens": _t(toks)})
    cache = tm.init_cache(tp, 2, 8, enc_embeds=_t(enc))
    dec = torch.stack([tm.decode_step(tp, cache, _t(toks[:, t]))[0] for t in range(6)], 1)
    jfull = jm.forward(jax_params, {"enc_embeds": jnp.asarray(enc), "tokens": jnp.asarray(toks)})
    jcache = jm.init_cache(jax_params, 2, 8, enc_embeds=jnp.asarray(enc))
    jdec, jstep = [], jax.jit(jm.decode_step)
    for t in range(6):
        lg, jcache = jstep(jax_params, jcache, jnp.asarray(toks[:, t]))
        jdec.append(np.asarray(lg))
    jgap = np.abs(np.stack(jdec, 1) - np.asarray(jfull))
    gap = (dec - full).abs().numpy()
    assert float(jgap[:, 1:].max()) > 1e-3  # position 0: rope is the identity
    _close(gap, jgap, MODEL_TOL)


def test_remat_gives_the_same_gradients():
    """``remat="block"`` (each layer under ``torch.utils.checkpoint``) and
    ``"none"`` give bit-equal gradients."""
    grads = []
    for remat in ("none", "block"):
        cfg = get_config(ARCH).scaled_down().replace(remat=remat)
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        for t in params["dec"]["xattn"].values():
            t.requires_grad_(True)
        batch = {"enc_embeds": _t(_enc_embeds(cfg)), "tokens": _t(_tokens(cfg, 16))}
        model.forward(params, batch).square().mean().backward()
        grads.append([t.grad for t in params["dec"]["xattn"].values()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_serve_engine_raises_for_encdec():
    model = build_model(get_config(ARCH).scaled_down())
    assert isinstance(model, EncDecModel)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServeEngine(model, model.init(0, device="cpu"), batch_size=2, max_seq=16, device="cpu")
