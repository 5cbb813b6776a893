"""The dense family (``families/dense.py``, starcoder2-3b's published block)
and the flash metrics.

On the CPU, tiny cells (``tiny_dense.py``) under the real cell's limits: a
sound run is correct and agrees with the reference; runs with the timed
path broken underneath are not - a bias dropped, the window ignored or off
by one, and the embedding looked up from a bf16 copy of the table (its
gradient added in bf16).  The controls read far above a sound run.  The
frozen flash formulas equal the program's, the flash patterns attribute the
kernels the CUDA sources declare, and the flash metrics read a trace made by
hand.  On the card (``-m card``), a traced step of a small dense cell
launches the flash forward twice a layer (remat) and the backward once, as
the counters count and the trace's calls show."""
import json
import re

import pytest
import torch

import portbench.run as run
from portbench.bench import compare, layout, reference
from portbench.bench import flash_flops as FF
from portbench.bench.trace import Families, Trace
from portbench.tests.tiny import copy_bench, write
from portbench.tests.tiny_dense import add_tiny_dense

SEED = 2 ** 31 + 99
CSRC = layout.ROOT / "src" / "repro_torch" / "kernels" / "csrc"


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    base = copy_bench(tmp)
    cells = {"dense": add_tiny_dense(base)}
    # one id at most positions (Zipf exponent 3 over 2 x 512 ids): where a bf16
    # sum of a row's gradients stalls
    cells["repeats"] = add_tiny_dense(base, seq=512, name="tiny-dense-repeats")
    traffic = json.loads((base / "traffic" / "tiny-dense-repeats.json").read_text())
    traffic["zipf_a"] = 3.0
    write(base / "traffic" / "tiny-dense-repeats.json", traffic)
    return tmp, base, cells


def _execute(bench, cell="dense"):
    tmp, base, cells = bench
    return run.execute(cells[cell], SEED, 0.3, False, torch.device("cpu"), base=base, root=tmp)


def _drop_bias(name):
    def fault(monkeypatch):
        from repro_torch.models import layers

        orig = layers.proj

        def proj(x, p, w, b):
            return orig(x, p, w, "" if b == name else b)

        monkeypatch.setattr(layers, "proj", proj)
    return fault


def _layer_norm_shift_dropped(monkeypatch):
    from repro_torch.models import layers

    def layer_norm(x, w, b, eps):
        return layers.F.layer_norm(x.float(), (x.shape[-1],), w.float(), None,
                                   eps).to(x.dtype)

    monkeypatch.setattr(layers, "layer_norm", layer_norm)


def _window(change):
    def fault(monkeypatch):
        from repro_torch.models import layers

        orig = layers.flash_attention

        def flash_attention(q, k, v, causal=True, window=0, softcap=0.0):
            return orig(q, k, v, causal, change(window), softcap)

        monkeypatch.setattr(layers, "flash_attention", flash_attention)
    return fault


def _bf16_lookup(monkeypatch):
    """The lookup before its fix: the rows gathered from a bf16 copy of the
    table, so its backward adds a row's gradients in bf16."""
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "embed_lookup",
                        lambda table, tokens, dtype: table.to(torch.bfloat16)[tokens].to(dtype))


def test_a_sound_dense_run_is_correct(bench):
    for cell in ("dense", "repeats"):
        out = _execute(bench, cell)
        assert out["correct"], out["checks"]
        assert out["failed"] == 0 and out["attempted"] >= 4


@pytest.mark.parametrize("fault,number", [
    (_drop_bias("bo"), "grad_gap"), (_drop_bias("b1"), "grad_gap"),
    (_layer_norm_shift_dropped, "grad_gap"),
    (_window(lambda w: 0), "flash_gap"), (_window(lambda w: w + 1), "flash_gap"),
    (_window(lambda w: w - 1), "flash_gap"),
], ids=["bias_o", "bias_mlp_up", "layer_norm_shift", "window_ignored", "window_plus_one",
        "window_minus_one"])
def test_a_broken_dense_step_is_not_correct(bench, fault, number, monkeypatch):
    fault(monkeypatch)
    out = _execute(bench)
    assert not out["correct"]
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]


def test_the_bf16_lookup_is_not_correct(bench, monkeypatch):
    """Where one id takes most positions the lookup's bf16 sum stalls, and
    the tied embedding's gradient shows it, though the head's gradient
    shares the leaf (``PERF.md`` §2 on what the cell itself sees)."""
    _bf16_lookup(monkeypatch)
    out = _execute(bench, "repeats")
    assert not out["correct"]
    c = out["checks"]["grad_gap"]
    assert c["value"] > c["limit"], out["checks"]


def test_reference_agrees_with_the_ports_plain_route(bench):
    tmp, base, cells = bench
    cell = layout.load_cell(cells["dense"], base)
    prog = cell.driver.Program(cell, SEED, torch.device("cpu"))
    readings = prog.first_steps()
    prog.close()
    batches = cell.source.batches(cell.traffic, cell.token_ids, SEED, 3)
    ref = reference.train_steps(cell.family, cell.config["model"], cell.config["optimizer"],
                                cell.traffic["schedule"], SEED, batches, "cpu")
    g = compare.gaps(readings, ref)
    assert g["loss_gap"] < 1e-5 and g["grad_gap"] < 1e-4 and g["update_gap"] < 1e-4, g
    assert len(ref["grad1"]) == len(list(prog.table.pieces()))
    assert cell.driver.kernel_gap(cell, readings["kernel_call"], torch.device("cpu")) < 1e-5


@pytest.mark.parametrize("precision", ["fp8", "ssd_tf32", "ssd_bf16"])
def test_the_dense_controls_read_far_above_a_sound_run(bench, precision):
    tmp, base, cells = bench
    cell = layout.load_cell(cells["dense"], base)
    m = cell.config["model"]
    batches = cell.source.batches(cell.traffic, cell.token_ids, SEED, 3)

    def readings(**kw):
        return reference.train_steps(cell.family, m, cell.config["optimizer"],
                                     cell.traffic["schedule"], SEED, batches, "cpu", **kw)

    ref = readings()
    prog = cell.driver.Program(cell, SEED, torch.device("cpu"))
    sound = compare.gaps(prog.first_steps(), ref)
    prog.close()
    control = compare.gaps(readings(precision=precision), ref)
    assert max(control[k] / max(sound[k], 1e-12) for k in control) > 100, (sound, control)


@pytest.mark.parametrize("lower", ["tf32", "bf16"])
def test_the_flash_call_controls_read_above_the_programs(bench, lower):
    tmp, base, cells = bench
    cell = layout.load_cell(cells["dense"], base)
    prog = cell.driver.Program(cell, SEED, torch.device("cpu"))
    call = prog.first_steps()["kernel_call"]
    prog.close()
    assert call["args"][3:6] == [True, cell.config["model"]["attn_window"], 0.0]
    sound = cell.driver.kernel_gap(cell, call, torch.device("cpu"))
    control = cell.driver.kernel_gap(cell, call, torch.device("cpu"), lower)
    assert control > 100 * max(sound, 1e-9), (sound, control)


def test_flash_formulas_equal_the_programs():
    """At the cell's shape: B 1, S 8192, 24 query heads of 128, window 4096."""
    from repro_torch.launch import flops as P

    for args in ((8192, 8192, True, 4096), (8192, 8192, True, 0), (512, 4608, True, 4096, 4096)):
        assert FF.visible_pairs(*args) == P.visible_pairs(*args)
    for backward in (False, True):
        assert FF.flash_flops(1, 8192, 8192, 24, 128, True, 4096, backward=backward) == \
            P.flash_flops(1, 8192, 8192, 24, 128, True, 4096, backward=backward)
    # 4096 queries see q + 1 keys, the other 4096 the window's 4096
    assert FF.visible_pairs(8192, 8192, True, 4096) == 4096 * 4097 // 2 + 4096 * 4096


def test_dense_model_flops_by_hand():
    c = layout.load_json("configs", "starcoder2-3b")
    t = layout.load_json("traffic", "train.b1.s8192")
    fam = layout.load_module("families", c["family"])
    B, S = t["batch"], t["seq"]
    d, ff, V, L, Hq, Hkv, D = 3072, 12288, 49152, 30, 24, 2, 128
    n = L * (d * Hq * D + 2 * d * Hkv * D + Hq * D * d + 2 * d * ff) + d * V
    pairs = 4096 * 4097 // 2 + 4096 * 4096
    attn = L * 4 * B * Hq * D * pairs * 3.5  # forward, and the backward's 2.5 times it
    assert fam.model_flops(c["model"], B, S) == pytest.approx(6 * n * B * S + attn, rel=1e-12)


def _kernel_names(source):
    text = (CSRC / source).read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", text)


def test_the_flash_patterns_attribute_the_kernels_of_the_sources():
    """Every kernel that ``flash_attention.cu`` and ``flash_attention_bwd.cu``
    declare, as the profiler names it, falls to its role; one launch of each
    pass is one call; no other kernel of the port falls to flash."""
    fam = Families(layout.kernel_families())
    seen = {}
    for source, role in (("flash_attention.cu", "forward"),
                         ("flash_attention_bwd.cu", "backward")):
        names = _kernel_names(source)
        assert names, source
        for name in names:
            full = f"void (anonymous namespace)::hopper::{name}<128, false>(CUtensorMap, float)"
            assert fam.of(full) == ("flash_attention", role), full
            seen[name] = role
    assert set(seen) == {"fa_fwd_kernel", "fwd_sm90", "delta_kernel", "dkdv_kernel",
                         "dq_kernel", "delta_pad_kernel", "dkdv_sm90", "group_sum_kernel",
                         "dq_sm90"}
    trace = Trace((0.0, 100.0), 1, [(f"void {n}<128>(float)", 0.0, 1.0) for n in seen])
    assert fam.calls(trace, "flash_attention", "forward") == 2  # f32 and bf16 kernels
    assert fam.calls(trace, "flash_attention", "backward") == 2
    others = [n for src in CSRC.glob("*.cu") if not src.name.startswith("flash_attention")
              for n in _kernel_names(src.name)]
    assert others and all((fam.of(f"void {n}<float>(float)") or ("",))[0] != "flash_attention"
                          for n in others)


def test_the_flash_metrics_read_a_hand_made_trace():
    """Two traced steps of the cell's shape, each 60 forward calls of 0.75 ms
    and 30 backward calls of 3.3 ms (four kernels: 0.1, 2.0, 0.2, 1.0)."""
    cell = layout.load_cell("starcoder2-3b.train.s8192")
    fam = Families(layout.kernel_families())
    device, t = [], 0.0
    for _ in range(2):
        for _ in range(60):
            device.append(("void (anonymous namespace)::hopper::fwd_sm90<128, 128, false>()", t,
                           750.0))
            t += 800.0
        for _ in range(30):
            for name, us in (("delta_pad_kernel<128>", 100.0), ("dkdv_sm90<128, false>", 2000.0),
                             ("group_sum_kernel", 200.0), ("dq_sm90<128, false>", 1000.0)):
                device.append((f"void (anonymous namespace)::hopper::{name}()", t, us))
                t += us
        device.append(("ampere_bf16_s16816gemm_bf16_128x128", t, 5000.0))
        t += 5000.0
    run_ = {"trace": Trace((0.0, t), 2, device), "families": fam, "cell": cell}
    flash_ms = layout.load_module("metrics", "flash_ms").read(run_)
    assert flash_ms == pytest.approx(60 * 0.75 + 30 * 3.3)
    fwd = FF.flash_bound_s(1, 8192, 24, 2, 128, 4096, "bfloat16")
    bwd = FF.flash_bound_s(1, 8192, 24, 2, 128, 4096, "bfloat16", backward=True)
    want = (60 * fwd + 30 * bwd) / ((60 * 0.75 + 30 * 3.3) * 1e-3) * 100
    got = layout.load_module("metrics", "flash_roofline_pct").read(run_)
    assert got == pytest.approx(want)
    assert 25 < got < 35  # the bounds: 0.3127 ms forward, 0.7818 backward (operations)
    assert fwd == pytest.approx(0.3127e-3, rel=1e-3) and bwd == pytest.approx(0.7818e-3, rel=1e-3)
    for empty in ({"trace": None}, {"trace": Trace((0.0, 1.0), 1, [])},
                  {"trace": Trace((0.0, 1.0), 1, [("ampere_gemm", 0.0, 1.0)])}):
        for metric in ("flash_ms", "flash_roofline_pct"):
            assert layout.load_module("metrics", metric).read({**run_, **empty}) is None


@pytest.mark.card
def test_a_traced_step_counts_the_flash_launches(card, tmp_path):
    """A small dense cell in bf16 on the card (2 layers, head dim 128, the
    window short of the sequence): per traced step 2 x 2 forward launches
    (each layer's forward, again under remat) and 2 backward, by the
    wrappers' counters and by the trace's calls."""
    from portbench.bench import trace as TR
    from repro_torch.kernels import launch_counts

    base = copy_bench(tmp_path)
    name = add_tiny_dense(base, batch=1, seq=1024, name="card-dense", d_model=256,
                          head_dim=128, num_heads=2, num_kv_heads=1, attn_window=512)
    cfg = json.loads((base / "configs" / "card-dense.json").read_text())
    cfg["precision"]["dtype"] = "bfloat16"
    write(base / "configs" / "card-dense.json", cfg)
    cell = layout.load_cell(name, base)
    prog = cell.driver.Program(cell, SEED, card)
    prog.first_steps()
    steps, L = 3, cell.config["model"]["num_layers"]
    before = launch_counts()
    traced = TR.record(lambda n: [prog.step() for _ in range(n)], steps, True,
                       lambda: torch.cuda.synchronize(card))
    after = launch_counts()
    prog.close()
    fam = Families(layout.kernel_families(base))
    # the counters count the warm step too, the trace only the profiled ones
    assert after["flash_attention"] - before["flash_attention"] == (steps + 1) * 2 * L
    assert after["flash_attention_bwd"] - before["flash_attention_bwd"] == (steps + 1) * L
    assert fam.calls(traced, "flash_attention", "forward") == steps * 2 * L
    assert fam.calls(traced, "flash_attention", "backward") == steps * L
