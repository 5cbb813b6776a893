"""The port's RMSNorm (``repro_torch.kernels.rms_norm``), plain and gated by
SiLU, on the CPU: its plain forward against the models' formulation before
the kernel (bit for bit, with the gate a strided view of the in_proj
output), its plain backward against autograd (and ``gradcheck`` in f64), the
wrapper's checks, the shape-only route on ``meta``, every width and stride
the presets hand it, and what the mixer and the block dispatch there.  The
CUDA kernels are held against the plain versions on the card by
``chip_smoke.py`` (``norm_cases``); the ``card`` test below counts their
launches in a traced train step of mamba2-2.7b at the benchmark cell's shape
(``python -m pytest tests/test_torch_rms_norm.py -m card``)."""
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.rms_norm import (rms_norm, rms_norm_bwd, rms_norm_bwd_ref,  # noqa: E402
                                          rms_norm_ref, rstd_ref)
from repro_torch.kernels.rms_norm import kernel as norm_kernel  # noqa: E402
from repro_torch.launch import flops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.lm import MetaGenerator, block_apply  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
EPS = 1e-6


def _composition_rms_norm(x, w, eps):
    """The models' RMSNorm before the kernel, as ``layers.rms_norm`` was."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _gated_inputs(B, L, di, H, gn, dtype, seed=0, device="cpu"):
    """y (B, L, di) in f32 (the scan's output) and z as ``mamba2_mixer``
    takes it: the first di columns of a (z, x, B, C, dt) row of the in_proj
    output, 2 di + 2 gn + H wide, in the compute dtype; w (di,) f32."""
    g = torch.Generator().manual_seed(seed)
    zxbcdt = torch.randn((B, L, 2 * di + 2 * gn + H), generator=g).to(dtype).to(device)
    z = zxbcdt[..., :di]
    y = torch.randn((B, L, di), generator=g).to(device)
    w = (1 + 0.1 * torch.randn((di,), generator=g)).to(device)
    return y, z, w


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("L", [1, 7, 64])
def test_plain_gated_form_is_the_mixers_composition(dtype, L):
    """``Y.to(dtype) * silu(z)`` then RMSNorm, bit for bit, with z read in
    place from a wider row; through the wrapper and ``layers.rms_norm``."""
    y, z, w = _gated_inputs(2, L, 96, 6, 16, dtype, seed=L)
    assert z.stride() == (L * (2 * 96 + 32 + 6), 2 * 96 + 32 + 6, 1)
    want = _composition_rms_norm(y.to(dtype) * F.silu(z), w, EPS)
    for got in (rms_norm_ref(y, w, EPS, z), rms_norm(y, w, EPS, gate=z),
                TL.rms_norm(y, w, EPS, gate=z), rms_norm(y.to(dtype), w, EPS, gate=z)):
        assert got.dtype == dtype and got.shape == (2, L, 96)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 4, 3, 16), (1, 1, 40)])
@pytest.mark.parametrize("wdt", [F32, BF16])
def test_plain_form_is_the_models_composition(dtype, shape, wdt):
    g = torch.Generator().manual_seed(len(shape))
    x = torch.randn(shape, generator=g).to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1:], generator=g)).to(wdt)
    want = _composition_rms_norm(x, w, 1e-5)
    for got in (rms_norm_ref(x, w, 1e-5), rms_norm(x, w, 1e-5), TL.rms_norm(x, w, 1e-5)):
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("gated", [False, True])
def test_plain_backward_gradcheck_f64(gated):
    """``gradcheck`` of the plain forward in f64, and the plain backward
    equal to autograd of it (the same math, to f64 rounding)."""
    y, z, w = (t.double().requires_grad_() for t in _gated_inputs(2, 3, 24, 2, 4, F32, seed=3))
    gate = z if gated else None
    args = (y, w, z) if gated else (y, w)
    assert torch.autograd.gradcheck(lambda *a: rms_norm_ref(a[0], a[1], EPS, *a[2:]), args)
    out = rms_norm_ref(y, w, EPS, gate)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(4),
                       dtype=torch.float64)
    want = torch.autograd.grad(out, args, dout)
    got = rms_norm_bwd_ref(y.detach(), w.detach(), rstd_ref(y.detach(), EPS,
                                                             None if gate is None else z.detach()),
                           dout, None if gate is None else z.detach())
    assert (got[2] is None) == (not gated)
    for g_, w_ in zip([t for t in got if t is not None], want):
        torch.testing.assert_close(g_, w_, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plain_backward_against_autograd_of_the_plain_forward(gated, dtype):
    """The plain backward (f32, each gradient rounded once) against autograd
    of the plain forward at the working dtypes: within 2^-7 of the largest
    entry in bf16 (autograd rounds its products to bf16, the f32 dy too),
    1e-5 in f32."""
    y, z, w = _gated_inputs(2, 5, 64, 4, 8, dtype, seed=5)
    x = y if gated else y.to(dtype)
    gate = z if gated else None
    dout = torch.randn((2, 5, 64), generator=torch.Generator().manual_seed(6)).to(dtype)
    leaves = [t.detach().requires_grad_() for t in ((x, w, z) if gated else (x, w))]
    want = torch.autograd.grad(rms_norm_ref(leaves[0], leaves[1], EPS, *leaves[2:]), leaves, dout)
    got = rms_norm_bwd(x, w, rstd_ref(x, EPS, gate), dout, gate)
    for g_, w_ in zip([t for t in got if t is not None], want):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape
        tol = 2 ** -7 if dtype == BF16 else 1e-5
        assert float((g_.double() - w_.double()).abs().max()) <= tol * float(w_.abs().max())


def _bad_calls():
    y, z, w = _gated_inputs(2, 6, 32, 2, 4, BF16)
    x = y.to(BF16)
    rstd, dout = rstd_ref(y, EPS, z), torch.ones((2, 6, 32), dtype=BF16)
    wide = torch.ones((1, norm_kernel.MAX_WIDTH + 8))
    return [
        ("w width", lambda: rms_norm(x, w[:-1].contiguous(), EPS), "want x"),
        ("w rank", lambda: rms_norm(x, w[None], EPS), "want x"),
        ("too wide", lambda: rms_norm(wide, wide[0], EPS), "widths"),
        ("too wide gated", lambda: rms_norm(wide[:, :8200], wide[0, :8200], EPS,
                                            gate=wide[:, :8200].bfloat16()), "gated"),
        ("x dtype", lambda: rms_norm(x.half(), w, EPS), "dtype"),
        ("w dtype", lambda: rms_norm(x, w.double(), EPS), "dtype"),
        ("gate shape", lambda: rms_norm(y, w, EPS, gate=z[:, :5]), "gate's shape"),
        ("gate dtype", lambda: rms_norm(x, w, EPS, gate=z.float()), "f32 or the gate's"),
        ("last stride", lambda: rms_norm(x.transpose(1, 2).contiguous().transpose(1, 2), w, EPS),
         "unit stride"),
        ("rows", lambda: rms_norm(x.transpose(0, 1), w, EPS), "one row stride"),
        ("w strided", lambda: rms_norm(x, torch.ones(64)[::2], EPS), "contiguous"),
        ("rstd shape", lambda: rms_norm_bwd(y, w, rstd[:-1], dout, z), "rstd"),
        ("rstd dtype", lambda: rms_norm_bwd(y, w, rstd.double(), dout, z), "rstd"),
        ("dout dtype", lambda: rms_norm_bwd(y, w, rstd, dout.float(), z), "dout"),
        ("dout strides", lambda: rms_norm_bwd(y, w, rstd, dout.transpose(0, 1).contiguous()
                                              .transpose(0, 1), z), "dout"),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _bad_calls()])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    _, call, match = next(c for c in _bad_calls() if c[0] == case)
    with pytest.raises((ValueError, TypeError), match=match):
        call()


@pytest.mark.parametrize("gated", [False, True])
def test_meta_route_shapes_flops_and_bytes(gated):
    """On meta the output in the gate's dtype (x's) and each row's rstd,
    charged ``norm_flops``; the backward's gradients, charged
    ``norm_bwd_flops``; no launch counted."""
    B, L, di = 2, 40, 96
    y, z, w = _gated_inputs(B, L, di, 6, 16, BF16, device="meta")
    x, gate = (y, z) if gated else (y.to(BF16), None)
    before = launch_counts()
    with FlopCounterMode(display=False) as fc:
        out = rms_norm(x, w, EPS, gate=gate)
    assert (out.shape, out.dtype, out.device.type) == ((B, L, di), BF16, "meta")
    assert fc.get_total_flops() == flops.norm_flops(B * L, di, gated) == (8 if gated else 4) * (
        B * L * di)
    rstd = torch.empty((B * L,), device="meta")
    with FlopCounterMode(display=False) as fc:
        dx, dw, dz = rms_norm_bwd(x, w, rstd, torch.empty_like(out), gate)
    assert (dx.shape, dx.dtype, dw.shape, dw.dtype) == ((B, L, di), x.dtype, (di,), F32)
    assert (dz is None) == (not gated) and (dz is None or (dz.shape, dz.dtype) == (
        (B, L, di), BF16))
    assert fc.get_total_flops() == flops.norm_bwd_flops(B * L, di, gated)
    assert launch_counts() == before


def test_bytes_at_the_benchmark_cells_shapes():
    """The bytes bound at mamba2-2.7b's train shape (8192 rows): the gated
    norm reads y in f32 and z in bf16 and writes bf16, the block norm reads
    and writes bf16 at width 2560; each row's f32 rstd besides."""
    T = 4 * 2048
    assert flops.norm_bytes(T, 5120, 4, 2, z_item=2) == T * 5120 * 8 + 4 * T  # 336 MB
    assert flops.norm_bytes(T, 5120, 4, 2, z_item=2, backward=True) == T * 5120 * 14 + 4 * T
    assert flops.norm_bytes(T, 2560, 2, 2) == T * 2560 * 4 + 4 * T  # 84 MB
    assert flops.norm_bytes(T, 2560, 2, 2, backward=True) == T * 2560 * 6 + 4 * T


def test_backward_scratch_is_the_partials_of_the_persistent_grid():
    assert norm_kernel.bwd_scratch(8192, 5120) == {
        "partials": ((norm_kernel.BWD_PARTS, 5120), F32)}
    assert norm_kernel.bwd_scratch(8, 128) == {"partials": ((8, 128), F32)}
    assert norm_kernel.fwd_scratch(8192, 5120) == {}


def test_counters_stay_zero_on_the_cpu():
    """The CPU route computes the plain version and launches nothing, also
    through autograd, the mixer and a block."""
    before = launch_counts()
    y, z, w = (t.detach().requires_grad_() for t in _gated_inputs(1, 12, 32, 2, 4, F32))
    rms_norm(y, w, EPS, gate=z).sum().backward()
    cfg = get_config("mamba2-2.7b").scaled_down().replace(attn_impl="pallas")
    params = TL.init_mamba2(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(1, 12, cfg.d_model, requires_grad=True)
    TL.mamba2_mixer(params, x, cfg).sum().backward()
    after = launch_counts()
    assert after == before
    assert after["rms_norm"] == after["rms_norm_bwd"] == 0


def _norm_sites(cfg):
    """(name, x dtype, x shape, gate's row width or None) of every RMSNorm a
    preset runs, at 2 x 3 tokens: the block and final norms at d_model, the
    qk-norm at head_dim over the heads, the gated norm at ssm_d_inner with z
    read from an in_proj row, in a forward and in a decode step."""
    cd = TL.DTYPES[cfg.dtype]
    sites = []
    if cfg.norm_type == "rms":
        sites.append(("block", cd, (2, 3, cfg.d_model), None))
    if cfg.qk_norm:
        sites.append(("qk", cd, (2, 3, cfg.num_heads, cfg.head_dim), None))
        sites.append(("qk kv", cd, (2, 3, cfg.num_kv_heads, cfg.head_dim), None))
    if cfg.family in ("ssm", "hybrid"):
        row = 2 * cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
        sites.append(("gated", F32, (2, 3, cfg.ssm_d_inner), row))
        sites.append(("gated decode", F32, (2, 1, cfg.ssm_d_inner), row))
    return sites


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_width_and_stride_a_preset_makes_passes_the_check(arch):
    cfg = get_config(arch)
    pd = TL.DTYPES[cfg.param_dtype]
    cd = TL.DTYPES[cfg.dtype]
    for name, xdt, shape, row in _norm_sites(cfg):
        D = shape[-1]
        x = torch.empty(shape, dtype=xdt, device="meta")
        w = torch.empty((D,), dtype=pd, device="meta")
        gate = None
        if row is not None:
            zrow = torch.empty((shape[0], shape[1], row), dtype=cd, device="meta")
            gate = zrow[..., :D] if shape[1] > 1 else zrow[:, 0, :D][:, None, :]
            assert gate.stride()[-1] == 1 and gate.stride()[0] % row == 0
        out = rms_norm(x, w, cfg.norm_eps, gate=gate)
        assert out.shape == shape, name
        assert D <= (norm_kernel.MAX_WIDTH if row is None else norm_kernel.MAX_GATED_WIDTH), name


class _Ops(TorchDispatchMode):
    """(op name, output shapes and dtypes) of every op dispatched."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else [out]
        self.ops.append((str(func.overloadpacket),
                         [(tuple(t.shape), t.dtype) for t in outs if isinstance(t, torch.Tensor)]))
        return out

    def names(self):
        return [n for n, _ in self.ops]

    def glue(self, lead, names=("aten.mean", "aten.rsqrt", "aten.pow")):
        """The ops among ``names`` that make a tensor of the activations'
        leading dims ``lead`` (a norm's statistics; rope's frequencies are
        not)."""
        return [n for n, outs in self.ops
                if n in names and any(s[:len(lead)] == lead for s, _ in outs)]


def test_mixer_kernel_route_dispatches_one_norm_op_and_no_glue():
    """``mamba2_mixer``'s kernel route on meta: one ``rms_norm`` op forward
    (gated) and one ``rms_norm_bwd`` backward; no mean, rsqrt or SiLU, and no
    op besides the kernels' that makes a (B, L, d_inner) tensor (the casts
    of Y, the product, the f32 copies) but views."""
    cfg = get_config("mamba2-2.7b").scaled_down().replace(attn_impl="pallas", dtype="bfloat16")
    params = {k: v.requires_grad_() for k, v in TL.init_mamba2(MetaGenerator(), cfg).items()}
    B, L, di = 2, 40, cfg.ssm_d_inner
    x = torch.empty((B, L, cfg.d_model), dtype=BF16, device="meta", requires_grad=True)
    with _Ops() as fwd:
        y = TL.mamba2_mixer(params, x, cfg)
    assert fwd.names().count("repro_torch.rms_norm") == 1
    assert fwd.glue((B, L), ("aten.mean", "aten.rsqrt", "aten.pow", "aten.silu")) == []
    made = [n for n, outs in fwd.ops if not n.startswith("repro_torch.")
            and n not in ("aten.view", "aten._unsafe_view", "aten.split_with_sizes")
            and any(s == (B, L, di) for s, _ in outs)]
    assert made == []
    with _Ops() as bwd:
        y.float().sum().backward()
    assert bwd.names().count("repro_torch.rms_norm_bwd") == 1
    assert bwd.glue((B, L), ("aten.mean", "aten.rsqrt", "aten.pow", "aten.silu",
                             "aten.silu_backward")) == []
    assert params["norm_w"].grad.shape == (di,)


@pytest.mark.parametrize("arch,spec,norms", [
    ("mamba2-2.7b", ("ssm", "none"), 2),  # ln1 and the mixer's gated norm
    ("qwen3-14b", ("attn", "dense"), 4),  # ln1, ln2, q and k norms
])
def test_block_kernel_route_dispatches_one_op_a_norm(arch, spec, norms):
    """``block_apply`` on meta: each RMSNorm is one ``rms_norm`` op forward
    and one ``rms_norm_bwd`` backward, with no mean, rsqrt or pow, and no
    f32 copy of the (B, S, d) activations."""
    cfg = get_config(arch).scaled_down().replace(attn_impl="pallas", dtype="bfloat16")
    gen = MetaGenerator()
    p = {"ln1": torch.ones(cfg.d_model, device="meta"),
         "ln2": torch.ones(cfg.d_model, device="meta")}
    if spec[0] == "ssm":
        p["ssm"] = TL.init_mamba2(gen, cfg)
    else:
        p["attn"], p["mlp"] = TL.init_attention(gen, cfg), TL.init_mlp(gen, cfg)
    leaves = [p["ln1"], p["ln2"]] + [t for k in ("ssm", "attn", "mlp") if k in p
                                     for t in p[k].values()]
    for t in leaves:
        t.requires_grad_()
    B, S, d = 2, 32, cfg.d_model
    x = torch.empty((B, S, d), dtype=BF16, device="meta", requires_grad=True)
    positions = torch.arange(S, device="meta")[None].expand(B, S)
    with _Ops() as fwd:
        out = block_apply(cfg, spec, p, x, positions)
    assert fwd.names().count("repro_torch.rms_norm") == norms
    assert fwd.glue((B, S)) == []
    f32_copies = [n for n, outs in fwd.ops if n == "aten._to_copy"
                  and any(s == (B, S, d) and dt == F32 for s, dt in outs)]
    assert f32_copies == []
    with _Ops() as bwd:
        out.float().sum().backward()
    assert bwd.names().count("repro_torch.rms_norm_bwd") == norms
    assert bwd.glue((B, S)) == []
    assert p["ln1"].grad.shape == (d,)


def _grad_into_embedding(arch, sizes, route, monkeypatch):
    """(the lookup's path, the placements of the gradient that reaches the
    embedding's backward) in one train step of ``arch``'s scaled-down config
    on ``meta`` ``DTensor``s over a fake (data, model) mesh of ``sizes``, as
    the partitioned dry run counts it; the RMSNorm's ``DTensor``s go through
    ``_boundary.rms_norm`` ("boundary") or the plain version as ``DTensor``
    ops ("plain", a CPU mesh's route).  On a one-device mesh the leaves are
    made ``DTensor``s as they are (``DTensor.from_local``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.bridge import flatten_with_paths, map_with_paths
    from repro_torch.dist import sharding_rules as SR
    from repro_torch.dist.context import AbstractMesh, use_plan
    from repro_torch.dist.placement import place_tree, placements
    from repro_torch.kernels import _boundary
    from repro_torch.launch import specs as S
    from repro_torch.launch.dryrun import count_partitioned
    from repro_torch.launch.mesh import fake_device_mesh, make_plan
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, make_train_step

    seen = []
    lookup = TL.embed_lookup

    def hooked(table, tokens, dtype):
        out = lookup(table, tokens, dtype)
        vdims = [i for i, p in enumerate(table.placements)
                 if p.is_shard(0) and table.device_mesh.size(i) > 1]
        path = "vocab_parallel" if len(vdims) == 1 else "index_put"
        out.register_hook(lambda g: seen.append((path, tuple(g.placements))))
        return out

    monkeypatch.setattr(TL, "embed_lookup", hooked)
    if route == "plain":
        monkeypatch.setattr(_boundary, "rms_norm",
                            lambda fn, x, w, gate, eps: rms_norm_ref(x, w, eps, gate))
    mesh = fake_device_mesh(AbstractMesh(sizes, ("data", "model")))
    try:
        if mesh.size() == 1:
            def place(tree, shardings):
                flat = dict(flatten_with_paths(shardings))
                return map_with_paths(tree, lambda k, t: DTensor.from_local(
                    t, mesh, placements(flat[k]), run_check=False))
        else:
            place = place_tree
        cfg = get_config(arch).scaled_down()
        plan = make_plan(mesh)
        model = build_model(cfg)
        oc = AdamWConfig(state_dtype=cfg.opt_state_dtype)
        params, opt = S.params_shape(model), S.opt_shape(model, oc)
        with use_plan(plan, mesh):
            state = {"params": place(params, SR.make_param_shardings(mesh, params, cfg, plan)),
                     "opt": dict(opt)}
            o_shard = SR.make_opt_shardings(mesh, opt, cfg, plan)
            for k in ("m", "v"):
                state["opt"][k] = place(opt[k], o_shard[k])
            batch = {k: torch.zeros((4, 32), dtype=torch.int32, device="meta")
                     for k in ("tokens", "labels")}
            batch = place(batch, SR.batch_sharding(mesh, plan, batch))
            step = make_train_step(model, oc)
            count_partitioned(lambda: step(state, batch), mesh)
    finally:
        dist.destroy_process_group()
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "qwen3-14b"])
def test_one_device_mesh_hands_the_embedding_a_whole_gradient(arch, monkeypatch):
    """On a (1, 1) mesh the gradient reaching DTensor's ``index_put`` (the
    embedding's backward) is whole on both dims: the boundary declares x's
    gradient ``Replicate`` on a one-device dim, where the input's own
    ``Shard(0)`` would reach ``index_put`` as a batch split, the placement
    torch 2.11's values-led ``index_put`` rule maps to ``Shard(-1)`` and
    refuses (``must be normalized``)."""
    from torch.distributed.tensor import Replicate

    assert _grad_into_embedding(arch, (1, 1), "boundary", monkeypatch) == (
        "index_put", (Replicate(), Replicate()))


@pytest.mark.parametrize("sizes", [(1, 2), (2, 1), (2, 2)])
def test_above_one_device_the_boundary_hands_the_embedding_what_the_plain_ops_do(
        sizes, monkeypatch):
    """Above one device the gradient that reaches the embedding's backward
    has the same path and placements through the norm's boundary as through
    the plain version as DTensor ops: the boundary changes nothing there.
    A gradient split along its token dims reaches only the vocab-parallel
    lookup, whose backward is local, never ``index_put``."""
    from torch.distributed.tensor import Shard

    got = _grad_into_embedding("mamba2-2.7b", sizes, "boundary", monkeypatch)
    monkeypatch.undo()
    assert got == _grad_into_embedding("mamba2-2.7b", sizes, "plain", monkeypatch)
    path, pl = got
    assert path == "vocab_parallel" or not any(
        isinstance(p, Shard) and p.dim < 2 for p in pl)


@pytest.fixture
def card():
    """The CUDA card a ``card`` test runs on; skips where there is none (the
    check runs when the test does, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with "
                    "`python -m pytest tests/test_torch_rms_norm.py -m card`")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_a_traced_train_step_of_the_mamba2_cell_launches_the_norms(card):
    """mamba2-2.7b at the benchmark cell's shape (4 rows of 2048 tokens, 64
    layers, bf16 compute, f32 params, every layer recomputed): one traced
    train step launches the forward 257 times (2 x 64 gated and 2 x 64
    ``ln1``, each layer's forward again under remat, and the final norm) and
    the backward 129 times, by the wrappers' counters and by the trace's
    kernel calls."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cfg = get_config("mamba2-2.7b").replace(ssm_chunk=128)
    assert (cfg.num_layers, cfg.remat, cfg.dtype) == (64, "block", "bfloat16")
    model = build_model(cfg)
    opt = AdamWConfig(lr=2e-6, warmup_steps=2)
    state = init_train_state(model, torch.Generator(device=card).manual_seed(0), opt,
                             device=card)
    step = make_train_step(model, opt)
    g = torch.Generator(device=card).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2049), generator=g, device=card)
    batch = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
    step(state, batch)  # warm: kernels built and loaded
    torch.cuda.synchronize(card)
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize(card)
    after = launch_counts()
    assert after["rms_norm"] - before["rms_norm"] == 257
    assert after["rms_norm_bwd"] - before["rms_norm_bwd"] == 129
    calls = {}
    for e in prof.events():
        for k in ("rms_norm_fwd_kernel", "rms_norm_bwd_kernel", "rms_norm_bwd_reduce"):
            if k in e.name:
                calls[k] = calls.get(k, 0) + 1
    assert calls == {"rms_norm_fwd_kernel": 257, "rms_norm_bwd_kernel": 129,
                     "rms_norm_bwd_reduce": 129}
