"""The port's VLM backbone (qwen2-vl-2b: patch and text embeddings in, 3-stream
M-RoPE positions) against the JAX package.

JAX's parameters come from ``LanguageModel.init(jax.random.PRNGKey(0))`` and
are carried across with ``repro_torch.bridge.params_from_jax``; inputs are
made with numpy from fixed seeds.  Sizes are ``scaled_down()`` (4 layers,
4/2 heads of 32), everything in f32.  Tolerances: 1e-6 for ``apply_rope``
(an elementwise rotation by f32 angles; at D = 128 the sections are 21, 21
and 22 channels), 1e-5 for the logits through 4 layers.
"""
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
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.serve import Request, ServeEngine

ARCH = "qwen2-vl-2b"
ROPE_TOL = 1e-6
MODEL_TOL = 1e-5
THETA = 1_000_000.0  # qwen2-vl's rope_theta


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def _mrope_positions(B, S, rng):
    """(t, h, w) streams as Qwen2-VL lays them out: text runs at (i, i, i)
    and an image's patches at (p, p + row, p + col)."""
    pos = np.zeros((B, S, 3), np.int32)
    for b in range(B):
        text, side = S // 4, int(np.sqrt(S // 2))
        pos[b, :text] = np.arange(text)[:, None]
        r, c = np.divmod(np.arange(side * side), side)
        pos[b, text:text + side * side] = np.stack([np.full_like(r, text), text + r, text + c], 1)
        rest = S - text - side * side
        start = pos[b, :text + side * side].max() + 1
        pos[b, text + side * side:] = (start + np.arange(rest))[:, None]
    pos += rng.integers(0, 3, (B, 1, 1)).astype(np.int32)
    return pos


@pytest.mark.parametrize("D", [32, 128])
def test_apply_rope_mrope(D):
    rng = np.random.default_rng(D)
    x = rng.standard_normal((2, 48, 3, D)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 48, 3)).astype(np.int32)
    got = TL.apply_rope(_t(x), _t(pos), THETA, mrope=True)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), THETA, mrope=True)
    _close(got, want, ROPE_TOL)


def test_mrope_streams_drive_their_sections():
    """With the height and width streams at 0, only the first D//2//3
    frequency channels rotate; equal streams give the plain rotation."""
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((1, 5, 1, 128)).astype(np.float32))
    t = torch.arange(5)[None]
    only_t = torch.stack([t, 0 * t, 0 * t], -1)
    out = TL.apply_rope(x, only_t, THETA, mrope=True)
    assert torch.equal(out[..., 21:64], x[..., 21:64]) and torch.equal(out[..., 85:], x[..., 85:])
    assert not torch.equal(out[..., 1:21], x[..., 1:21])
    same = TL.apply_rope(x, torch.stack([t, t, t], -1), THETA, mrope=True)
    assert torch.equal(same, TL.apply_rope(x, t, THETA))


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(jax_get_config(ARCH).scaled_down())
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("inputs", ["embeds", "tokens"])
def test_forward(impl, inputs, models):
    """The forward from ``embeds`` with 3-stream positions (the vision
    stub's input) and from tokens, on both routes of the port (the JAX
    model runs its XLA formulation)."""
    jm, jp = models
    tcfg = get_config(ARCH).scaled_down().replace(attn_impl=impl)
    tm = build_model(tcfg)
    tp = params_from_jax(jax.device_get(jp), like=tm.init(0, device="cpu"))
    rng = np.random.default_rng(1)
    B, S = 2, 40
    if inputs == "embeds":
        batch = {"embeds": rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32),
                 "positions": _mrope_positions(B, S, rng)}
    else:
        batch = {"tokens": rng.integers(1, tcfg.vocab_size, (B, S)).astype(np.int32)}
    got = tm.forward(tp, {k: _t(v) for k, v in batch.items()})
    want = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert got.shape == (B, S, tcfg.vocab_size) and got.dtype == torch.float32
    _close(got, want, MODEL_TOL)


def test_serve_engine_tokens_match_jax(models):
    """Greedy serving of text prompts: the decode step's 1-D rope, as in
    JAX's ``attention_decode``."""
    jm, jp = models
    tm = build_model(get_config(ARCH).scaled_down())
    tp = params_from_jax(jax.device_get(jp), like=tm.init(0, device="cpu"))
    prompts = [([5, 6, 7], 5), ([9, 10], 4), ([42], 6)]
    want = JaxServeEngine(jm, jp, batch_size=3, max_seq=32).run(
        [JaxRequest(prompt=list(p), max_new_tokens=n) for p, n in prompts])
    got = ServeEngine(tm, tp, batch_size=3, max_seq=32, device="cpu").run(
        [Request(prompt=list(p), max_new_tokens=n) for p, n in prompts])
    assert [r.generated for r in got] == [r.generated for r in want]
