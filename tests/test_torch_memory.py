"""The dry run's memory analysis (``repro_torch.launch.memory``): the live
set of hand-built programs whose peak is known exactly, each kernel op's
charge on ``meta`` (its outputs plus its launch function's ``*_scratch``),
the launch functions allocating that same scratch, every (arch x shape)
record's memory fields on one device and on a 2 x 2 mesh, and the port's
train steps against JAX's ``compiled.memory_analysis()`` on the CPU: the
argument bytes to the byte, and remat shrinking the temporaries in both
(the temporaries themselves differ: XLA fuses and reuses buffers, an eager
step does neither, so their ratio is recorded, not held to a band)."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.config import ShapeConfig as JaxShape  # noqa: E402
from repro.train import AdamWConfig as JaxAdamW  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.kernels import _scratch, _shape  # noqa: E402
from repro_torch.kernels.adamw_update import adamw_update  # noqa: E402
from repro_torch.kernels.adamw_update import kernel as adamw_kernel  # noqa: E402
from repro_torch.kernels.causal_conv import causal_conv, causal_conv_bwd  # noqa: E402
from repro_torch.kernels.causal_conv import kernel as conv_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as decode_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.fused_augment import fused_augment  # noqa: E402
from repro_torch.kernels.fused_augment import kernel as augment_kernel  # noqa: E402
from repro_torch.kernels.moe_router import kernel as router_kernel  # noqa: E402
from repro_torch.kernels.moe_router import moe_router, moe_router_bwd  # noqa: E402
from repro_torch.kernels.rms_norm import kernel as norm_kernel  # noqa: E402
from repro_torch.kernels.rms_norm import ops as norm_ops  # noqa: E402
from repro_torch.kernels.rms_norm import rms_norm_bwd  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd  # noqa: E402
from repro_torch.launch import dryrun, report  # noqa: E402
from repro_torch.launch.memory import MemoryTracker  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402

META = "meta"
N = 256  # f32 elements: 1024 bytes


def _empty(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# hand-built programs
# ---------------------------------------------------------------------------
def test_chain_views_in_place_and_a_freed_temporary():
    """A chain of ops; views, in-place ops and ``out=`` add nothing; an
    argument made before the tracker is not counted; a temporary freed
    mid-way leaves its mark on the peak only; a view keeps its base alive."""
    arg = _empty(N)
    with MemoryTracker() as mt:
        arg.add_(1)  # the argument, in place: 0
        a = _empty(N)  # 1024
        b = a + arg  # 2048
        v = b.view(16, 16).t()[:4]  # a view: 0
        b.mul_(2)
        torch.add(a, b, out=a)  # 0
        c = (b * 3).sum()  # the product 1024 (peak 3072), the sum 4, the product freed
        assert (mt.live, mt.peak) == (2052, 3076)
        del a  # 1028
        del b  # v keeps b's storage
        assert mt.live == 1028
        del v
        assert mt.live == 4
    assert mt.report()["temp_bytes"] == 3076
    assert mt.report()["live_end_bytes"] == 4 and c.shape == ()


def test_autograd_backward_with_a_saved_tensor():
    """exp saves its result: after the forward only that result and the loss
    stay (1028).  The backward makes the loss's gradient (4) and exp's
    input gradient (1024): peak 2056; then the saved result and the 4-byte
    gradient are freed, and ``x.grad`` takes the gradient itself."""
    x = _empty(N).requires_grad_(True)
    with MemoryTracker() as mt:
        y = x.exp()
        s = y.sum()
        del y  # the graph keeps it
        assert mt.live == 1028
        s.backward()
    assert x.grad is not None and x.grad.shape == (N,)
    assert (mt.peak, mt.live) == (2056, 1028)


def test_storages_are_keyed_by_storage_not_pointer():
    """Every meta pointer is 0: two live tensors are two storages."""
    with MemoryTracker() as mt:
        a, b = _empty(N), _empty(N)
        assert a.data_ptr() == b.data_ptr() == 0
        assert mt.live == 2048
        del a
        assert mt.live == 1024


def test_an_output_with_no_storage_raises():
    """A sparse output has no storage to key: the tracker raises rather than
    count it as nothing (on the CPU: meta has no sparse layout)."""
    dense = torch.zeros((4, 4))
    with MemoryTracker("cpu"):
        with pytest.raises(RuntimeError, match="no storage to key"):
            dense.to_sparse()


def test_a_kernel_op_with_no_scratch_function_raises(monkeypatch):
    monkeypatch.delattr(_shape, "moe_router_scratch")
    with MemoryTracker():
        with pytest.raises(RuntimeError, match="no scratch function"):
            moe_router(_empty((70, 8)), 2)


# ---------------------------------------------------------------------------
# the kernels' scratch
# ---------------------------------------------------------------------------
B, S, HQ, HKV, D = 1, 80, 4, 2, 32
L, H, P, NS, G = 80, 4, 32, 16, 1
T, E, K = 70, 8, 2  # three token blocks of the router
CH = H * P + 2 * G * NS  # the conv's channels at the SSD case's widths
NB = 4  # rows of 80 tokens of the norm's backward: more rows than its blocks (BWD_PARTS)


def _kernel_cases():
    """(name, meta inputs, call, the scratch of its launch function)."""
    bf16 = torch.bfloat16
    q, kv = _empty((B, S, HQ, D), bf16), _empty((B, S, HKV, D), bf16)
    lse = _empty((B, HQ, S))
    x, dt, vec = _empty((1, L, H, P)), _empty((1, L, H)), _empty((H,))
    Bm = _empty((1, L, G, NS))
    ids, gates = _empty((T, K), torch.int32), _empty((T, K))
    imgs = _empty((2, 16, 16, 3), torch.uint8)
    # the conv's (x, B, C) columns read in place from a (z, x, B, C, dt) row
    xbc = _empty((1, L, H * P + CH + H), torch.bfloat16)[..., H * P:H * P + CH]
    w4 = _empty((4, CH))
    # the gated norm: y in f32, z read in place from the same row
    row = _empty((NB, L, H * P + CH + H), torch.bfloat16)
    y, z, wn = _empty((NB, L, H * P)), row[..., :H * P], _empty((H * P,))
    return [
        ("flash_attention", (q, kv, kv), lambda *t: flash_attention(*t, window=16),
         flash_kernel.fwd_scratch(B, S, S, HQ, D, bf16)),
        ("flash_attention_bwd", (q, kv, kv, q, lse, q),
         lambda *t: flash_attention_bwd(*t, window=16),
         flash_kernel.bwd_scratch(B, S, S, HQ, D, bf16)),
        ("decode_attention", (_empty((2, HQ, D), bf16), _empty((2, 1024, HKV, D), bf16),
                              _empty((2, 1024, HKV, D), bf16), _empty((2,), torch.int32)),
         lambda *t: decode_attention(*t, num_splits=4),
         decode_kernel.workspace_scratch(2, HQ, HKV, D, 2, 4)),
        ("ssd_scan", (x, dt, vec, Bm, Bm, vec), lambda *t: ssd_scan(*t, chunk=16),
         ssd_kernel.fwd_scratch(1, L, H, P, NS, 16, torch.float32)),
        ("ssd_scan_bwd", (x, dt, vec, Bm, Bm, vec, x), ssd_scan_bwd,
         ssd_kernel.bwd_scratch(1, L, H, G, P, NS, torch.float32)),
        ("moe_router", (_empty((T, E)),), lambda t: moe_router(t, K),
         router_kernel.fwd_scratch(T, E)),
        ("moe_router_bwd", (ids, gates, gates), lambda *t: moe_router_bwd(*t, E),
         router_kernel.bwd_scratch(T, E, K)),
        ("fused_augment", (imgs, _empty((2, 2), torch.int32), _empty((2,), torch.int32),
                           _empty((3,)), _empty((3,))),
         lambda *t: fused_augment(*t, out_h=8, out_w=6),
         augment_kernel.fwd_scratch(2, 16, 16, 3, 8, 6)),
        ("causal_conv", (xbc, w4, w4[0]), lambda *t: causal_conv(*t, H * P),
         conv_kernel.fwd_scratch(1, L, CH)),
        ("causal_conv_bwd", (xbc, w4, w4[0], _empty((1, L, H * P)), _empty((1, L, G * NS)),
                             _empty((1, L, G * NS))), causal_conv_bwd,
         conv_kernel.bwd_scratch(1, L, CH)),
        # the op's outputs, each row's rstd with the output (the wrapper keeps
        # rstd for autograd only)
        ("rms_norm", (y, wn, z), lambda y_, w_, z_: norm_ops._forward(y_, w_, z_, 1e-6),
         norm_kernel.fwd_scratch(NB * L, H * P)),
        ("rms_norm_bwd", (y, wn, _empty((NB * L,)), _empty((NB, L, H * P), torch.bfloat16), z),
         rms_norm_bwd, norm_kernel.bwd_scratch(NB * L, H * P)),
        # in place on the leaf and its moments: no output, no temporary
        ("adamw_update", (x, x.clone(), x.clone(), x.clone(), _empty(())),
         lambda *t: adamw_update(*t, lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, c1=0.1, c2=0.05,
                                 weight_decay=0.1) or (),
         adamw_kernel.update_scratch(x.numel())),
    ]


KERNELS = [c[0] for c in _kernel_cases()]


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_op_charge_is_its_outputs_plus_its_scratch(name):
    """On meta each kernel op is charged its outputs and, on top while it
    runs, its launch function's ``*_scratch`` (decode's workspace stays)."""
    _, inputs, call, spec = next(c for c in _kernel_cases() if c[0] == name)
    with MemoryTracker() as mt:
        out = call(*inputs)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    scratch = sum(_scratch.nbytes(spec).values())
    assert mt.peak == _bytes(outs) + scratch
    persistent = scratch if name == "decode_attention" else 0
    assert mt.live == _bytes(outs) + persistent
    if name == "fused_augment":
        assert _shape.fused_augment_scratch is not None and spec == {}


def test_scratch_at_the_main_paths_shapes():
    """The scratch the meta route used to miss: the bf16 flash backward at
    starcoder2-3b's train shape (B 1, S 8192, 24 heads, D 128) about 203 MB,
    the SSD forward at mamba2-2.7b's prefill (L 8192, 80 heads, P 64, N 128,
    chunk 128, f32) about 336 MB."""
    fb = sum(_scratch.nbytes(flash_kernel.bwd_scratch(1, 8192, 8192, 24, 128,
                                                      torch.bfloat16)).values())
    assert fb == 2 * 24 * 8192 * 4 + 2 * 8192 * 24 * 128 * 4
    assert 202e6 < fb < 204e6
    sf = sum(_scratch.nbytes(ssd_kernel.fwd_scratch(1, 8192, 80, 64, 128, 128,
                                                    torch.float32)).values())
    assert 335e6 < sf < 336e6
    assert router_kernel.fwd_scratch(32, 64) == {}  # one token block: no counts


def test_decode_workspace_is_charged_once_and_grown():
    """Decode's workspace persists: a second call of the same plan adds its
    output only; a call that needs more grows it, the new buffer made
    before the old one is freed."""
    bf16 = torch.bfloat16
    q, lens = _empty((2, HQ, D), bf16), _empty((2,), torch.int32)
    cache = _empty((2, 1024, HKV, D), bf16)
    small = 4 * decode_kernel.workspace_scratch(2, HQ, HKV, D, 2, 4)["partials"][0][0]
    big = 4 * decode_kernel.workspace_scratch(2, HQ, HKV, D, 2, 8)["partials"][0][0]
    with MemoryTracker() as mt:
        o1 = decode_attention(q, cache, cache, lens, num_splits=4)
        o2 = decode_attention(q, cache, cache, lens, num_splits=4)
        assert mt.live == 2 * o1.nbytes + small
        peak = mt.peak
        o3 = decode_attention(q, cache, cache, lens, num_splits=8)
    assert mt.peak == max(peak, 2 * o1.nbytes + o3.nbytes + small + big)
    assert mt.live == 3 * o1.nbytes + big and mt.report()["decode_workspace_bytes"] == big
    assert o2.shape == q.shape
    # on meta the card's plan follows the H100's SMs; a card of fewer SMs
    # splits less or equal
    with MemoryTracker(sms=16) as few:
        decode_attention(q, cache, cache, lens)
    with MemoryTracker() as h100:
        decode_attention(q, cache, cache, lens)
    assert few.workspace <= h100.workspace


class _Lib:
    def __getattr__(self, name):
        fn = lambda *args: 0  # noqa: E731
        fn.argtypes = fn.restype = None
        return fn


class _Stream:
    cuda_stream = 0


def _launch_case(name):
    """(a call of the launch function on meta stand-ins, its ``*_scratch``)."""
    if name.startswith("flash"):
        dt = torch.bfloat16 if name.endswith("bf16") else torch.float32
        q, kv = _empty((B, S, HQ, D), dt), _empty((B, S, HKV, D), dt)
        lse = _empty((B, HQ, S))
        return (lambda: flash_kernel.flash_attention_bwd_launch(
            q, kv, kv, q, lse, q, q, kv, kv, causal=True, window=0, softcap=0.0, q_offset=0),
            flash_kernel.bwd_scratch(B, S, S, HQ, D, dt))
    if name == "ssd_scan":
        x, Bm, dt, vec, h = (_empty((1, L, H, P)), _empty((1, L, G, NS)), _empty((1, L, H)),
                             _empty((H,)), _empty((1, H, NS, P)))
        return (lambda: ssd_kernel.ssd_scan_fwd(x, dt, vec, Bm, Bm, vec, x, h, chunk=16),
                ssd_kernel.fwd_scratch(1, L, H, P, NS, 16, torch.float32))
    if name == "causal_conv_bwd":
        xbc, w, dxs, dbc = (_empty((1, L, CH), torch.bfloat16), _empty((4, CH)),
                            _empty((1, L, H * P)), _empty((1, L, G * NS)))
        return (lambda: conv_kernel.causal_conv_bwd_launch(xbc, w, w[0], dxs, dbc, dbc, xbc,
                                                           w, w[0]),
                conv_kernel.bwd_scratch(1, L, CH))
    if name == "rms_norm_bwd":
        y, z, w, rstd = (_empty((NB * L, H * P)), _empty((NB * L, H * P), torch.bfloat16),
                         _empty((H * P,)), _empty((NB * L,)))
        return (lambda: norm_kernel.rms_norm_bwd_launch(y, w, z, rstd, z, y, w, z),
                norm_kernel.bwd_scratch(NB * L, H * P))
    if name == "moe_router":
        logits, ids, gates = _empty((T, E)), _empty((T, K), torch.int32), _empty((T, K))
        return (lambda: router_kernel.moe_router_fwd(logits, ids, gates, ids, K),
                router_kernel.fwd_scratch(T, E))
    q, lens = _empty((2, HQ, D), torch.bfloat16), _empty((2,), torch.int32)
    cache = _empty((2, 1024, HKV, D), torch.bfloat16)

    def twice():  # the second call keeps the first one's workspace
        for _ in range(2):
            decode_kernel.decode_attention_fwd(q, cache, cache, lens, q, rows=2, num_splits=4,
                                               window=0)

    return twice, decode_kernel.workspace_scratch(2, HQ, HKV, D, 2, 4)


@pytest.mark.parametrize("name", ["flash_attention_bwd_bf16", "flash_attention_bwd_f32",
                                  "ssd_scan", "moe_router", "decode_attention",
                                  "causal_conv_bwd", "rms_norm_bwd"])
def test_launch_functions_allocate_their_scratch_function(name, monkeypatch):
    """Each CUDA launch function allocates exactly its ``*_scratch`` (its
    kernels replaced by a stub library; meta tensors stand in)."""
    call, want = _launch_case(name)
    seen = []
    real_empty = torch.empty

    def spy(shape, *args, **kw):
        seen.append((tuple(shape), kw.get("dtype")))
        return real_empty(shape, *args, **kw)

    for mod in (flash_kernel, ssd_kernel, router_kernel, decode_kernel, conv_kernel,
                norm_kernel):
        monkeypatch.setattr(mod, "_lib", lambda *a: _Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(decode_kernel, "_workspaces", {})
    monkeypatch.setattr(torch, "empty", spy)
    call()
    assert seen == list(want.values()) and want


# ---------------------------------------------------------------------------
# the dry run's records
# ---------------------------------------------------------------------------
def _small(shape: str) -> ShapeConfig:
    """The shape's kind at a few tokens; long_500k keeps its batch of one
    (on the (2, 2) mesh it cannot split over the data axis)."""
    sh = SHAPES[shape]
    return ShapeConfig(shape, 64 if sh.kind == "decode" else 32, min(sh.global_batch, 4),
                       sh.kind)


@pytest.mark.parametrize("mesh", ["one", "2x2"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_cell_has_integer_temporaries(arch, mesh):
    """At ``scaled_down()``, every shape on one device and on a (2, 2) mesh:
    OK or SKIP, and an OK record's ``temp_bytes`` an integer with
    ``per_device_total = argument_bytes + temp_bytes``, judged by
    ``fits_hbm_80g``."""
    for shape in SHAPES:
        rec = dryrun.run_cell(arch, _small(shape), mesh, reduced=True)
        assert rec["status"] in ("OK", "SKIP"), rec
        if rec["status"] == "SKIP":
            continue
        mem = rec["roofline"]["memory_per_device_bytes"]
        assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0
        assert mem["per_device_total"] == mem["argument_bytes"] + mem["temp_bytes"]
        assert rec["fits_hbm_80g"] is (mem["per_device_total"] < 80e9)
        assert 0 < rec["memory"]["live_end_bytes"] <= mem["temp_bytes"]


def test_a_batch_of_one_decodes_on_a_mesh():
    """A decode batch of one cannot split over the (2, 2) mesh's data axis,
    so the head's contraction stays split there and the logits come out as
    pending sums; the serve step reduces them before its argmax."""
    rec = dryrun.run_cell("deepseek-7b", ShapeConfig("d", 64, 1, "decode"), "2x2",
                          reduced=True)
    assert rec["status"] == "OK"
    assert isinstance(rec["roofline"]["memory_per_device_bytes"]["temp_bytes"], int)
    assert rec["roofline"]["collective_breakdown"]["counts"].get("all-reduce", 0) > 0


FAMILIES = ["deepseek-7b", "moonshot-v1-16b-a3b", "mamba2-2.7b", "jamba-v0.1-52b",
            "whisper-large-v3", "qwen2-vl-2b"]
# jamba at 4 layers of period 2: two repeats of the card's train run's pair
# (mamba2 + dense, attention + MoE), so that remat has a repeated group to
# recompute, at half the compile of its 8 layers
CUT = {"jamba-v0.1-52b": {"num_layers": 4, "attn_period": 2, "attn_offset": 1}}


def _jax_memory(arch: str, remat: str):
    cfg = jax_config(arch).scaled_down().replace(remat=remat, **CUT.get(arch, {}))
    model = jax_build(cfg)
    params = jax_specs.params_shape(model)
    oc = JaxAdamW(state_dtype=cfg.opt_state_dtype)
    opt = jax.eval_shape(lambda: jax_opt.init_state(params, oc))
    batch = jax_specs.train_input_specs(cfg, JaxShape("t", 128, 4, "train"))
    step = jax.jit(jax_train_step(model, oc), donate_argnums=(0,))
    return step.lower({"params": params, "opt": opt}, batch).compile().memory_analysis()


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_memory_against_jax(arch):
    """Each family's train step at ``scaled_down()`` (B 4, S 128): the
    argument bytes equal JAX's ``argument_size_in_bytes`` to the byte, and
    ``remat="block"`` gives less ``temp_bytes`` than ``remat="none"``, in
    the port and in JAX alike."""
    sh = ShapeConfig("t", 128, 4, "train")
    port = {r: dryrun.run_cell(arch, sh, reduced=True, remat=r, replace=CUT.get(arch))
            ["roofline"]["memory_per_device_bytes"] for r in ("block", "none")}
    jx = {r: _jax_memory(arch, r) for r in ("block", "none")}
    assert port["block"]["argument_bytes"] == jx["block"].argument_size_in_bytes
    assert port["none"]["argument_bytes"] == jx["none"].argument_size_in_bytes
    assert port["block"]["temp_bytes"] < port["none"]["temp_bytes"]
    assert jx["block"].temp_size_in_bytes < jx["none"].temp_size_in_bytes


def test_replace_inputs_and_cast_params_describe_the_cards_program():
    """``replace`` changes the config, ``inputs`` takes the caller's batch
    (its dtypes: an int64 token batch is twice the int32 specs' bytes) and
    ``cast_params`` holds a serving step's parameters in the compute dtype."""
    sh = ShapeConfig("t", 32, 4, "prefill")
    base = dryrun.run_cell("deepseek-7b", sh, reduced=True)
    cut = dryrun.run_cell("deepseek-7b", sh, reduced=True, replace={"num_layers": 1})
    assert cut["variant"]["replace"] == {"num_layers": 1}
    mem = lambda r: r["roofline"]["memory_per_device_bytes"]  # noqa: E731
    assert mem(cut)["argument_bytes"] < mem(base)["argument_bytes"]
    wide = dryrun.run_cell("deepseek-7b", sh, reduced=True,
                           inputs={"tokens": torch.zeros((4, 32), dtype=torch.int64)})
    assert mem(wide)["argument_bytes"] - mem(base)["argument_bytes"] == 4 * 32 * 4
    bf16 = {"dtype": "bfloat16"}  # scaled_down() computes in f32: nothing to cast
    cast = dryrun.run_cell("deepseek-7b", sh, reduced=True, cast_params=True, replace=bf16)
    held = dryrun.run_cell("deepseek-7b", sh, reduced=True, replace=bf16)
    assert mem(cast)["argument_bytes"] < mem(held)["argument_bytes"]
    with pytest.raises(ValueError, match="cast_params"):
        dryrun.run_cell("deepseek-7b", ShapeConfig("t", 32, 4, "train"), reduced=True,
                        cast_params=True)


def test_report_names_the_lever_of_a_cell_that_does_not_fit(tmp_path, capsys):
    """One record that fits (starcoder2-3b at ``scaled_down()``) and one that
    does not (llama3-405b's train_4k on one card): the table's "fits 80G
    HBM" column says yes, or names the temporaries and the levers; the
    summary prints the total a device (``mem/dev``)."""
    fits = dryrun.run_cell("starcoder2-3b", "train_4k", reduced=True)
    big = dryrun.run_cell("llama3-405b", "train_4k")
    assert fits["fits_hbm_80g"] is True and big["fits_hbm_80g"] is False
    table = report.dryrun_table([fits, big], "one")
    assert "| arguments | temporaries | total a device | fits 80G HBM |" in table
    row = next(line for line in table.splitlines() if "llama3-405b" in line)
    mem = big["roofline"]["memory_per_device_bytes"]
    assert (f"NO: does not fit: temporaries {report.fmt_bytes(mem['temp_bytes'])} of "
            f"{report.fmt_bytes(mem['per_device_total'])}; try --microbatches / a larger mesh"
            in row)  # llama3-405b already remats each block
    assert "| yes |" in next(line for line in table.splitlines() if "starcoder2-3b" in line)
    for r in (fits, big):
        (tmp_path / dryrun.cell_path("", r["arch"], r["shape"], "one")).write_text(
            __import__("json").dumps(r))
    dryrun.summarize(str(tmp_path))
    out = capsys.readouterr().out
    assert "mem/dev" in out and "args/dev" not in out
    assert f"{mem['per_device_total'] / 1e9:8.1f}G" in out
