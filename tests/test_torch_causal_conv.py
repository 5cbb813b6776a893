"""The mamba2 mixer's causal conv (``repro_torch.kernels.causal_conv``) on the
CPU: its plain forward against the mixer's own formulation
(``_depthwise_causal_conv`` then SiLU) on (x, B, C) read from an in_proj
output with the strides ``mamba2_mixer`` makes, its plain backward against
autograd (and ``gradcheck`` in f64), the wrapper's checks, the shape-only
route on ``meta``, and what the mixer's kernel route dispatches there.  The
CUDA kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` (``conv_cases``)."""
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.causal_conv import (causal_conv, causal_conv_bwd,  # noqa: E402
                                             causal_conv_bwd_ref, causal_conv_ref)
from repro_torch.launch import flops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.lm import MetaGenerator  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
# (d_inner, G N, heads) of the test configs: mamba2-2.7b and jamba-v0.1-52b
# at scaled_down() (one group), and the mixer test's two groups
TEST_WIDTHS = sorted({(c.ssm_d_inner, c.ssm_groups * c.ssm_state, c.ssm_heads) for c in (
    get_config("mamba2-2.7b").scaled_down(), get_config("jamba-v0.1-52b").scaled_down(),
    get_config("mamba2-2.7b").scaled_down().replace(ssm_groups=2))})
LENGTHS = [1, 3, 4, 5, 130]
DTYPE_PAIRS = [(F32, F32), (BF16, F32), (F32, BF16), (BF16, BF16)]


def _inputs(B, L, di, gn, H, xdt, wdt, seed=0, device="cpu"):
    """xbc as the mixer takes it from zxbcdt (z, x, B, C, dt): a (B, L, Ch)
    view at column d_inner of rows 2 di + 2 gn + H wide; w (4, Ch), b (Ch,)."""
    g = torch.Generator().manual_seed(seed)
    Ch = di + 2 * gn
    zxbcdt = torch.randn((B, L, di + Ch + H), generator=g).to(xdt).to(device)
    _, xbc, _ = torch.split(zxbcdt, [di, Ch, H], dim=-1)
    w = (torch.randn((4, Ch), generator=g) * 0.5).to(wdt).to(device)
    b = (torch.randn((Ch,), generator=g) * 0.1).to(wdt).to(device)
    return xbc, w, b


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("xdt,wdt", DTYPE_PAIRS)
def test_plain_forward_is_the_mixers_conv_and_silu(xdt, wdt, L):
    for di, gn, H in TEST_WIDTHS:
        xbc, w, b = _inputs(2, L, di, gn, H, xdt, wdt, seed=L)
        assert xbc.stride() == (L * (2 * di + 2 * gn + H), 2 * di + 2 * gn + H, 1)
        want = torch.split(F.silu(TL._depthwise_causal_conv(xbc.contiguous(), w, b)),
                           [di, gn, gn], dim=-1)
        got = causal_conv(xbc, w, b, di)
        for g_, w_ in zip(got, want):
            assert g_.is_contiguous() and g_.dtype == torch.promote_types(xdt, wdt)
            assert torch.equal(g_, w_)


@pytest.mark.parametrize("L", [1, 4, 5, 37])
def test_plain_backward_gradcheck_f64(L):
    """``gradcheck`` of the plain forward in f64, and the plain backward
    equal to autograd of it (the same math, to f64 rounding)."""
    di, gn, H = 8, 4, 2
    xbc, w, b = (t.double().requires_grad_() for t in _inputs(2, L, di, gn, H, F32, F32, seed=3))
    assert torch.autograd.gradcheck(lambda x, w_, b_: causal_conv_ref(x, w_, b_, di), (xbc, w, b))
    outs = causal_conv_ref(xbc, w, b, di)
    g = torch.Generator().manual_seed(4)
    douts = [torch.randn(o.shape, generator=g, dtype=torch.float64) for o in outs]
    want = torch.autograd.grad(outs, (xbc, w, b), douts)
    got = causal_conv_bwd_ref(xbc.detach(), w.detach(), b.detach(), *douts)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("L", [1, 5, 130])
@pytest.mark.parametrize("xdt,wdt", DTYPE_PAIRS)
def test_plain_backward_against_autograd_of_the_plain_forward(xdt, wdt, L):
    """The plain backward (f32, dx rounded once to x's dtype) against
    autograd of the plain forward in f64, at the working dtypes' rounding:
    dx to 2^-8 of its largest entry in bf16, dw and db likewise in w's."""
    di, gn, H = TEST_WIDTHS[0]
    xbc, w, b = _inputs(2, L, di, gn, H, xdt, wdt, seed=5)
    od = torch.promote_types(xdt, wdt)
    g = torch.Generator().manual_seed(6)
    douts = [torch.randn((2, L, n), generator=g).to(od) for n in (di, gn, gn)]
    x64, w64, b64 = (t.double().requires_grad_() for t in (xbc, w, b))
    want = torch.autograd.grad(causal_conv_ref(x64, w64, b64, di), (x64, w64, b64),
                               [d.double() for d in douts])
    got = causal_conv_bwd_ref(xbc, w, b, *douts)
    for g_, w_, dt in zip(got, want, (xdt, wdt, wdt)):
        assert g_.dtype == dt and g_.shape == w_.shape
        tol = 2 ** -8 if dt == BF16 else 1e-5
        assert float((g_.double() - w_).abs().max()) <= tol * float(w_.abs().max())


def _bad_calls():
    di, gn, H = 8, 4, 2
    xbc, w, b = _inputs(1, 6, di, gn, H, F32, F32)
    return [
        ("width 3", lambda: causal_conv(xbc, w[:3].contiguous(), b, di), "width 4"),
        ("width 5", lambda: causal_conv(xbc, torch.cat([w, w[:1]]), b, di), "width 4"),
        ("w channels", lambda: causal_conv(xbc, w[:, :-2].contiguous(), b, di), "channels"),
        ("b channels", lambda: causal_conv(xbc, w, b[:-2].contiguous(), di), "channels"),
        ("split", lambda: causal_conv(xbc, w, b, di + 1), "split"),
        ("x rank", lambda: causal_conv(xbc[0], w, b, di), "want x"),
        ("x dtype", lambda: causal_conv(xbc.half(), w, b, di), "dtype"),
        ("b dtype", lambda: causal_conv(xbc, w, b.bfloat16(), di), "dtype"),
        ("x strides", lambda: causal_conv(xbc.transpose(0, 2).contiguous().transpose(0, 2), w,
                                          b, di), "contiguous"),
        ("dB shape", lambda: causal_conv_bwd(xbc, w, b, torch.ones(1, 6, di),
                                             torch.ones(1, 6, gn + 1), torch.ones(1, 6, gn)),
         "dB"),
        ("dC dtype", lambda: causal_conv_bwd(xbc, w, b, torch.ones(1, 6, di),
                                             torch.ones(1, 6, gn),
                                             torch.ones(1, 6, gn, dtype=BF16)), "dC"),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _bad_calls()])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    _, call, match = next(c for c in _bad_calls() if c[0] == case)
    with pytest.raises((ValueError, TypeError), match=match):
        call()


def test_meta_route_shapes_and_flops():
    """On meta the three outputs of the kernel's shapes in promote(x, w),
    charged 2 K T Ch, and the backward's gradients, charged twice that."""
    di, gn, H = TEST_WIDTHS[-1]
    B, L = 2, 40
    xbc, w, b = _inputs(B, L, di, gn, H, BF16, F32, device="meta")
    with FlopCounterMode(display=False) as fc:
        outs = causal_conv(xbc, w, b, di)
    assert [(tuple(t.shape), t.dtype) for t in outs] == [
        ((B, L, di), F32), ((B, L, gn), F32), ((B, L, gn), F32)]
    Ch = di + 2 * gn
    assert fc.get_total_flops() == 2 * 4 * B * L * Ch == flops.conv_flops(B * L, Ch)
    with FlopCounterMode(display=False) as fc:
        dx, dw, db = causal_conv_bwd(xbc, w, b, *(torch.empty_like(t) for t in outs))
    assert (dx.shape, dx.dtype, dw.shape, dw.dtype, db.shape) == (
        (B, L, Ch), BF16, w.shape, F32, b.shape)
    assert fc.get_total_flops() == flops.conv_bwd_flops(B * L, Ch) == 2 * 2 * 4 * B * L * Ch


def test_counters_stay_zero_on_the_cpu():
    """The CPU route computes the plain versions and launches nothing, also
    through autograd and through the mixer's kernel route."""
    before = launch_counts()
    di, gn, H = TEST_WIDTHS[0]
    xbc, w, b = (t.requires_grad_() for t in _inputs(1, 12, di, gn, H, F32, F32))
    sum(o.sum() for o in causal_conv(xbc, w, b, di)).backward()
    cfg = get_config("mamba2-2.7b").scaled_down().replace(attn_impl="pallas")
    params = TL.init_mamba2(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(1, 12, cfg.d_model, requires_grad=True)
    TL.mamba2_mixer(params, x, cfg).sum().backward()
    after = launch_counts()
    assert after == before
    assert after["causal_conv"] == before["causal_conv"] == 0
    assert after["causal_conv_bwd"] == 0


class _Ops(TorchDispatchMode):
    """(op name, output shapes) of every op dispatched."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else [out]
        self.ops.append((func, [tuple(t.shape) for t in outs if isinstance(t, torch.Tensor)]))
        return out


@pytest.mark.parametrize("groups", [1, 2])
def test_mixer_kernel_route_dispatches_one_conv_op_and_no_glue(groups):
    """The kernel route of ``mamba2_mixer`` on meta: one ``causal_conv`` op
    forward and one ``causal_conv_bwd`` backward, no ``constant_pad_nd`` and
    no ``cat`` forward, and no other op that makes a tensor of the conv's Ch
    channels (the per-tap products and sums, the bias, the SiLU, copies of
    x, B and C) besides the split's views."""
    cfg = get_config("mamba2-2.7b").scaled_down().replace(attn_impl="pallas", ssm_groups=groups,
                                                          dtype="bfloat16")
    params = TL.init_mamba2(MetaGenerator(), cfg)
    params = {k: v.requires_grad_() for k, v in params.items()}
    Ch = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    x = torch.empty((2, 40, cfg.d_model), dtype=BF16, device="meta", requires_grad=True)
    with _Ops() as fwd:
        y = TL.mamba2_mixer(params, x, cfg)
    names = [str(f.overloadpacket) for f, _ in fwd.ops]
    assert names.count("repro_torch.causal_conv") == 1
    assert not {"aten.constant_pad_nd", "aten.cat", "aten.pad"} & set(names)
    made_ch = [str(f) for f, shapes in fwd.ops if not f.is_view
               and str(f.overloadpacket) != "repro_torch.causal_conv"
               and any(s[-1:] == (Ch,) for s in shapes)]
    assert made_ch == []
    with _Ops() as bwd:
        y.float().sum().backward()
    names = [str(f.overloadpacket) for f, _ in bwd.ops]
    assert names.count("repro_torch.causal_conv_bwd") == 1
    assert "aten.constant_pad_nd" not in names
    assert params["conv_w"].grad.shape == params["conv_w"].shape
