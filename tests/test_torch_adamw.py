"""The port's AdamW update kernel (``repro_torch.kernels.adamw_update``).

On the CPU: the plain version against the JAX package's ``upd`` (through its
``apply_updates``, f32 and bf16 moments, a clipped step, a 1-D leaf that is
not decayed and a leaf of 63 values, no multiple of a vector), the wrapper's
checks, the shape-only route on ``meta`` (no allocation, the FLOP formula),
the ``DTensor`` boundary on a one-rank gloo mesh, and ``apply_updates``
calling the wrapper once a leaf with the clip scale left a tensor.

On the card (``python -m pytest tests/test_torch_adamw.py -m card``): the
kernel against an f64 evaluation of the same expression at those cases, with
bf16 leaves and gradients, misaligned views and one full-size stacked leaf
(mamba2-2.7b's ``in_proj``); one launch a leaf over a train step; and
``apply_updates`` with no host read (``torch.cuda.set_sync_debug_mode``).
This file imports JAX only inside the CPU tests that compare with it, so a
machine with a card and no JAX collects it."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.bridge import flatten_with_paths  # noqa: E402
from repro_torch.kernels import adamw_update, launch_counts  # noqa: E402
from repro_torch.kernels.adamw_update import adamw_update_ref  # noqa: E402
from repro_torch.launch import flops  # noqa: E402
from repro_torch.launch.memory import MemoryTracker  # noqa: E402
from repro_torch.train import AdamWConfig, apply_updates, init_state  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
HYPER = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, c1=0.271, c2=0.142625, weight_decay=0.1)
SHAPES = {"w": (7, 9), "b": (13,)}  # 63 values: no multiple of 4 or 8; b is not decayed


def _leaf_inputs(shape, seed, pdt=F32, gdt=F32, sdt=F32, device="cpu"):
    """p, g, m and v of one leaf: moments as a few steps leave them (v > 0)."""
    g = torch.Generator().manual_seed(seed)
    p, grad, m = (torch.randn(shape, generator=g) for _ in range(3))
    v = torch.rand(shape, generator=g) * 0.1
    return [t.to(dt).to(device) for t, dt in ((p, pdt), (grad, gdt), (0.1 * m, sdt), (v, sdt))]


def _np32(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# the plain version against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_plain_version_is_jaxs_upd(state_dtype, clipped):
    """JAX's ``apply_updates`` on a 2-D leaf of 63 values (decayed) and a 1-D
    leaf (not), from moments of step 2; the plain version of each leaf given
    JAX's clip scale, learning rate and bias corrections.  Gradients of
    global norm about 11 (clipped at 1) or 0.011 (not clipped).  Every
    parameter within 1e-6 relative (an ulp or two of f32), the moments
    within one step of their dtype."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.train import AdamWConfig as JaxAdamWConfig
    from repro.train import apply_updates as jax_apply_updates
    from repro.train import optimizer as jax_opt

    cfg = JaxAdamWConfig(lr=1e-2, weight_decay=0.5, warmup_steps=1, state_dtype=state_dtype)
    sdt = F32 if state_dtype == "float32" else BF16
    leaves = {k: _leaf_inputs(s, i, sdt=sdt) for i, (k, s) in enumerate(SHAPES.items())}
    if not clipped:
        for _, g, _, _ in leaves.values():
            g.mul_(1e-3)
    jnp_of = {F32: jnp.float32, BF16: jnp.bfloat16}

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(jnp_of[t.dtype])

    params = {k: jx(p) for k, (p, _, _, _) in leaves.items()}
    grads = {k: jx(g) for k, (_, g, _, _) in leaves.items()}
    state = {"step": jnp.asarray(2, jnp.int32), "m": {k: jx(t[2]) for k, t in leaves.items()},
             "v": {k: jx(t[3]) for k, t in leaves.items()}}
    new_params, new_state, _ = jax_apply_updates(params, grads, state, cfg)
    gnorm = jax_opt.global_norm(grads)
    scale = jnp.minimum(1.0, cfg.grad_clip / jnp.maximum(gnorm, 1e-12))
    assert (float(scale) < 1.0) is clipped
    step = jnp.asarray(3, jnp.int32)
    kw = dict(lr=float(jax_opt.lr_schedule(cfg, step)), b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
              c1=float(1.0 - cfg.b1 ** step.astype(jnp.float32)),
              c2=float(1.0 - cfg.b2 ** step.astype(jnp.float32)),
              weight_decay=cfg.weight_decay)
    for k, (p, g, m, v) in leaves.items():
        adamw_update_ref(p, g, m, v, torch.tensor(np.float32(scale)), **kw)
        np.testing.assert_allclose(_np32(p), np.asarray(new_params[k], np.float32), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        step_tol = 2.0 ** -7 if sdt == BF16 else 1e-6
        for name, got in (("m", m), ("v", v)):
            want = np.asarray(new_state[name][k].astype(jnp.float32))
            assert got.dtype == sdt
            np.testing.assert_allclose(_np32(got), want, rtol=step_tol, atol=1e-12,
                                       err_msg=f"{name} {k}")


def test_only_leaves_of_two_or_more_dims_are_decayed():
    """With a zero gradient and zero moments only the decay moves a leaf:
    p - lr wd p for the 2-D leaf, the 1-D leaf unchanged."""
    for shape in SHAPES.values():
        p = torch.randn(shape, generator=torch.Generator().manual_seed(3))
        before = p.clone()
        zeros = [torch.zeros(shape) for _ in range(3)]
        adamw_update(p, *zeros, torch.tensor(1.0), **HYPER)
        if len(shape) >= 2:
            want = before - HYPER["lr"] * (HYPER["weight_decay"] * before)
            assert torch.equal(p, want)
        else:
            assert torch.equal(p, before)


def test_wrapper_is_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper computes the plain version in place, bit for
    bit, and launches nothing."""
    before = launch_counts()["adamw_update"]
    got, want = _leaf_inputs((5, 11), 4), _leaf_inputs((5, 11), 4)
    adamw_update(*got, torch.tensor(0.25), **HYPER)
    adamw_update_ref(*want, torch.tensor(0.25), **HYPER)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert launch_counts()["adamw_update"] == before


@pytest.mark.parametrize("case", ["shape", "dtype", "moments", "scale_shape", "scale_dtype",
                                  "contiguous"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    p, g, m, v = _leaf_inputs((4, 6), 5)
    scale = torch.tensor(1.0)
    if case == "shape":
        g = g.reshape(6, 4)
    elif case == "dtype":
        p = p.half()
    elif case == "moments":
        v = v.bfloat16()
    elif case == "scale_shape":
        scale = scale.reshape(1)
    elif case == "scale_dtype":
        scale = scale.double()
    else:
        p = p.t()
        g, m, v = (t.t() for t in (g, m, v))
    with pytest.raises((ValueError, TypeError)):
        adamw_update(p, g, m, v, scale, **HYPER)


@pytest.mark.parametrize("shape,decay", [((64, 10), True), ((640,), False)])
def test_meta_route_allocates_nothing_and_charges_its_formula(shape, decay):
    """On meta the shape-only op runs in place: nothing allocated, the FLOPs
    of ``flops.adamw_flops`` (17 a value decayed, 15 not), 28 bytes an f32
    value by ``flops.adamw_bytes``."""
    args = [torch.empty(shape, device="meta") for _ in range(4)] + [
        torch.empty((), device="meta")]
    with FlopCounterMode(display=False) as fc, MemoryTracker() as mt:
        assert adamw_update(*args, **HYPER) is None
    assert mt.peak == 0 and mt.allocations == 0
    assert fc.get_total_flops() == flops.adamw_flops(640, decay) == (17 if decay else 15) * 640
    assert flops.adamw_bytes(640, 4, 4, 4) == 28 * 640
    before = launch_counts()["adamw_update"]
    adamw_update(*args, **HYPER)
    assert launch_counts()["adamw_update"] == before


def test_apply_updates_calls_the_wrapper_once_a_leaf_with_the_scale_a_tensor(monkeypatch):
    """``apply_updates`` hands every leaf to ``adamw_update`` once, with the
    clip scale a 0-d f32 tensor (never a host float) and the step's host
    floats; the result is the plain version's."""
    from repro_torch.train import optimizer

    seen = []
    real = optimizer.adamw_update

    def spy(p, g, m, v, scale, **kw):
        seen.append((tuple(p.shape), scale, kw))
        return real(p, g, m, v, scale, **kw)

    monkeypatch.setattr(optimizer, "adamw_update", spy)
    params = {k: _leaf_inputs(s, i)[0] for i, (k, s) in enumerate(SHAPES.items())}
    grads = {k: 10 * torch.ones(s) for k, s in SHAPES.items()}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0)
    apply_updates(params, grads, init_state(params, cfg), cfg)
    assert [s for s, _, _ in seen] == [SHAPES[k] for k, _ in flatten_with_paths(params)]
    norm = math.sqrt(100 * (63 + 13))
    for _, scale, kw in seen:
        assert isinstance(scale, torch.Tensor) and scale.shape == () and scale.dtype == F32
        assert float(scale) == pytest.approx(1.0 / norm, rel=1e-6)
        assert kw["c1"] == pytest.approx(0.1, rel=1e-6) and kw["lr"] == pytest.approx(1e-2)


def test_dtensor_boundary_updates_the_local_shards_in_place(tmp_path):
    """On a (1, 1) gloo mesh a ``DTensor`` leaf is updated in place through
    its local tensor, bit for bit as the plain tensors; a pending-sum
    gradient is reduced first; moments laid out unlike the leaf raise."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.launch.mesh import make_test_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh(1, 1)
        plain = _leaf_inputs((6, 10), 6)
        want = [t.clone() for t in plain]
        adamw_update(*want, torch.tensor(0.5), **HYPER)
        rep = [Replicate(), Replicate()]
        p, m, v = (DTensor.from_local(t.clone(), mesh, rep) for t in (plain[0], *plain[2:]))
        g = DTensor.from_local(plain[1].clone(), mesh, [Partial(), Replicate()])
        local_p = p.to_local()
        adamw_update(p, g, m, v, torch.tensor(0.5), **HYPER)
        assert p.to_local().data_ptr() == local_p.data_ptr()
        for got, w in zip((p, m, v), (want[0], want[2], want[3])):
            assert torch.equal(got.to_local(), w)
        bad = DTensor.from_local(plain[2].clone(), mesh, [Partial(), Replicate()])
        with pytest.raises(ValueError, match="laid out as the leaf"):
            adamw_update(p, g, bad, v, torch.tensor(0.5), **HYPER)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA card a ``card`` test runs on; skips where there is none (the
    check runs when the test does, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with "
                    "`python -m pytest tests/test_torch_adamw.py -m card`")
    return torch.device("cuda", 0)


STEP = {F32: 2.0 ** -23, BF16: 2.0 ** -7}  # one step of a dtype, relative
TOL = 1e-6  # of the largest entry: a few f32 roundings of the terms


def _f64_update(p, g, m, v, scale, lr, b1, b2, eps, c1, c2, weight_decay):
    """The kernel's expression in f64 from the same inputs and the same f32
    constants: (p, m, v, the step lr * delta)."""
    f = lambda x: float(np.float32(x))  # noqa: E731
    d64 = torch.float64
    gs = g.to(d64) * scale.to(d64)
    m64 = f(b1) * m.to(d64) + f(1 - b1) * gs
    v64 = f(b2) * v.to(d64) + f(1 - b2) * gs * gs
    delta = (m64 / f(c1)) / (torch.sqrt(v64 / f(c2)) + f(eps))
    if p.dim() >= 2:
        delta = delta + f(weight_decay) * p.to(d64)
    stepd = f(lr) * delta
    return p.to(d64) - stepd, m64, v64, stepd


def _gaps(got, want, largest):
    """Largest |got - want| over (one step of got's dtype at want + TOL of
    ``largest``): at most 1 passes."""
    allowed = STEP[got.dtype] * want.abs() + TOL * largest
    return float(((got.to(torch.float64) - want).abs() / allowed).max())


def _check_against_f64(p, g, m, v, scale, **kw):
    want_p, want_m, want_v, stepd = _f64_update(p, g, m, v, scale, **kw)
    adamw_update(p, g, m, v, scale, **kw)
    big = float(stepd.abs().max())
    return {"p": _gaps(p, want_p, big), "m": _gaps(m, want_m, float(want_m.abs().max())),
            "v": _gaps(v, want_v, float(want_v.abs().max()))}


@pytest.mark.card
@pytest.mark.parametrize("shape", [(7, 9), (13,), (4096, 1031), (3,)])
@pytest.mark.parametrize("dtypes", [(F32, F32, F32), (F32, F32, BF16), (BF16, BF16, F32),
                                    (BF16, F32, BF16), (F32, BF16, F32)])
@pytest.mark.parametrize("scale", [1.0, 0.0625])
def test_kernel_against_f64(card, shape, dtypes, scale):
    """Every dtype combination of leaf, gradient and moments, decayed (2-D)
    and not (1-D), sizes no multiple of 8, clipped and not: every output
    within one step of its dtype of the f64 value plus 1e-6 of the largest
    entry (the step's, for p)."""
    pdt, gdt, sdt = dtypes
    p, g, m, v = _leaf_inputs(shape, 7, pdt, gdt, sdt, device=card)
    gaps = _check_against_f64(p, g, m, v, torch.tensor(scale, device=card), **HYPER)
    assert max(gaps.values()) <= 1.0, gaps


@pytest.mark.card
@pytest.mark.parametrize("offset", [1, 2, 3, 5])
def test_kernel_takes_misaligned_views(card, offset):
    """Leaves that start ``offset`` values into their storage, with the
    moments at another offset (no element where all four align: every
    element goes one by one) and at the same one (a scalar head)."""
    n = 10_000
    for same in (True, False):
        base = [t.reshape(-1) for t in _leaf_inputs((n + 8,), 8, device=card)]
        p, g = base[0][offset:offset + n], base[1][offset:offset + n]
        o2 = offset if same else offset + 1
        m, v = base[2][o2:o2 + n], base[3][o2:o2 + n]
        p2 = p.reshape(100, 100)
        gaps = _check_against_f64(p2, g.reshape(100, 100), m.reshape(100, 100),
                                  v.reshape(100, 100), torch.tensor(0.5, device=card), **HYPER)
        assert max(gaps.values()) <= 1.0, (same, gaps)


@pytest.mark.card
def test_kernel_at_the_mamba2_cells_largest_leaf(card):
    """mamba2-2.7b's stacked ``in_proj``, 64 x 2560 x 10576 f32 (1.73 G
    values, 6.9 GB a tensor): the kernel against f64, layer by layer."""
    shape = (64, 2560, 10576)
    g = torch.Generator(device=card).manual_seed(9)
    p = torch.randn(shape, generator=g, device=card) * 0.02
    grad = torch.randn(shape, generator=g, device=card) * 1e-4
    m = torch.randn(shape, generator=g, device=card) * 1e-5
    v = torch.rand(shape, generator=g, device=card) * 1e-8
    before = [t.clone() for t in (p, m, v)]
    scale = torch.tensor(0.5, device=card)
    adamw_update(p, grad, m, v, scale, **HYPER)
    worst = {"p": 0.0, "m": 0.0, "v": 0.0}
    for i in range(shape[0]):
        want_p, want_m, want_v, stepd = _f64_update(
            before[0][i:i + 1], grad[i:i + 1], before[1][i:i + 1], before[2][i:i + 1], scale,
            **HYPER)
        big = float(stepd.abs().max())
        for k, got, want, largest in (("p", p[i:i + 1], want_p, big),
                                      ("m", m[i:i + 1], want_m, float(want_m.abs().max())),
                                      ("v", v[i:i + 1], want_v, float(want_v.abs().max()))):
            worst[k] = max(worst[k], _gaps(got, want, largest))
    assert max(worst.values()) <= 1.0, worst


@pytest.mark.card
def test_a_train_step_launches_the_update_once_a_leaf(card):
    """mamba2-2.7b at two layers: one step launches ``adamw_update`` once a
    parameter leaf, by the wrapper's counter and by the trace's kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_config("mamba2-2.7b").replace(num_layers=2, ssm_chunk=128)
    model = build_model(cfg)
    opt = AdamWConfig(lr=2e-6, warmup_steps=2)
    state = init_train_state(model, torch.Generator(device=card).manual_seed(0), opt,
                             device=card)
    leaves = len(list(flatten_with_paths(state["params"])))
    step = make_train_step(model, opt)
    tokens = torch.randint(0, cfg.vocab_size, (1, 513),
                           generator=torch.Generator(device=card).manual_seed(1), device=card)
    batch = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
    step(state, batch)  # warm: kernels built and loaded
    torch.cuda.synchronize(card)
    before = launch_counts()["adamw_update"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize(card)
    assert launch_counts()["adamw_update"] - before == leaves
    assert sum("adamw_update_kernel" in e.name for e in prof.events()) == leaves


@pytest.mark.card
def test_apply_updates_makes_no_host_read(card):
    """``apply_updates`` on the card under sync-debug "error": the gradient
    norm, the clip scale and every leaf's update are enqueued with no
    synchronisation (the step's learning rate and corrections are the
    host's); the result is the plain version's within the f64 check's
    tolerance."""
    params = {k: _leaf_inputs(s, i, device=card)[0] for i, (k, s) in enumerate(SHAPES.items())}
    grads = {k: torch.randn(s, device=card) for k, s in SHAPES.items()}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0)
    state = init_state(params, cfg)
    cpu = {k: t.cpu() for k, t in params.items()}
    torch.cuda.synchronize(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, metrics = apply_updates(params, grads, state, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu_state = init_state(cpu, cfg)
    apply_updates(cpu, {k: g.cpu() for k, g in grads.items()}, cpu_state, cfg)
    for k in SHAPES:
        torch.testing.assert_close(params[k].cpu(), cpu[k], rtol=1e-6, atol=1e-7)
    assert metrics["grad_norm"].device == card
