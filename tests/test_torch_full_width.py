"""One mamba2-2.7b layer at its published width (d_model 2560, 80 heads x
P 64, N 128), f32, on the CPU: the port against the JAX package.

At this width the chunked SSD form (JAX's ``mamba2_mixer``, the port's
``xla`` twin and its ``ssd_scan`` kernel) and the token recurrence
(``mamba2_decode``, and ``ssd_scan``'s plain version) differ by more than at
``scaled_down()``: with A = -(1..16) and dt = softplus(...) near 1 the
in-chunk log-decay reaches hundreds, and ``exp(cum_i - cum_j)`` takes the
difference of two large f32 sums.  The JAX package's own decode and forward
differ here as the port's do (asserted below); compounded over 64 layers
that gap is the ~1e-3 the card's f32 decode-vs-forward check shows at the
logits (``PERF.md``).  Tolerance 1e-4 (atol and rtol) for every pair.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import layers as TL

TOL = 1e-4
L = 24


@pytest.fixture(scope="module")
def layer():
    jcfg = jax_get_config("mamba2-2.7b").replace(dtype="float32")
    p = JL.init_mamba2(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(0).standard_normal((1, L, jcfg.d_model)).astype(np.float32)
    want = np.asarray(JL.mamba2_mixer(p, jnp.asarray(x), jcfg))
    return jcfg, p, params_from_jax(jax.device_get(p)), x, want


def _decode(mixer_decode, params, x, state):
    outs = []
    for t in range(L):
        out, state = mixer_decode(params, x[:, t:t + 1], state)
        outs.append(np.asarray(out))
    return np.concatenate(outs, axis=1), state


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mixer_matches_jax_at_full_width(layer, impl):
    jcfg, _, tp, x, want = layer
    tcfg = get_config("mamba2-2.7b").replace(dtype="float32", attn_impl=impl)
    got = TL.mamba2_mixer(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_decode_matches_forward_at_full_width(layer):
    """The port's recurrence against JAX's forward, and JAX's own recurrence
    against its forward: the same gap on both sides, within 1e-4."""
    jcfg, p, tp, x, want = layer
    tcfg = get_config("mamba2-2.7b").replace(dtype="float32")
    conv_ch = jcfg.ssm_d_inner + 2 * jcfg.ssm_groups * jcfg.ssm_state
    hshape = (1, jcfg.ssm_heads, jcfg.ssm_state, jcfg.ssm_head_dim)
    got, tstate = _decode(
        lambda prm, xt, st: TL.mamba2_decode(prm, torch.from_numpy(xt), st, tcfg), tp, x,
        {"h": torch.zeros(hshape), "conv": torch.zeros((1, 3, conv_ch))})
    jdec, jstate = _decode(
        lambda prm, xt, st: JL.mamba2_decode(prm, jnp.asarray(xt), st, jcfg), p, x,
        {"h": jnp.zeros(hshape), "conv": jnp.zeros((1, 3, conv_ch))})
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(jdec, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tstate["h"].numpy(), np.asarray(jstate["h"]), atol=TOL, rtol=TOL)
