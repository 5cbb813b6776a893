"""``chip_smoke.py`` off the card: it must refuse to pass without CUDA or
without the port next to it, and its roofline arithmetic must count the
work the run's data needs."""
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def _run(cwd, tmp_path):
    env = {"PATH": os.environ.get("PATH", ""), "HOME": str(tmp_path),
           "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("where", ["checkout", "script_alone"])
def test_fails_without_a_card_or_without_the_port(where, tmp_path):
    if where == "checkout":
        cwd = ROOT
    else:
        cwd = tmp_path / "alone"
        cwd.mkdir()
        shutil.copy(ROOT / "chip_smoke.py", cwd)
    out = _run(cwd, tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize(
    "Sq,Sk,causal,window,q_offset,want",
    [
        (4, 4, True, 0, 0, 10),  # lower triangle with diagonal
        (4, 4, False, 0, 0, 16),
        (5, 5, True, 2, 0, 9),  # 1 + 2 + 2 + 2 + 2
        (2, 6, True, 0, 4, 11),  # rows at positions 4, 5: 5 + 6 keys
        (3, 3, False, 1, 0, 6),  # non-causal window bounds below only: 3 + 2 + 1
    ],
)
def test_visible_pairs(Sq, Sk, causal, window, q_offset, want):
    assert chip_smoke._visible_pairs(Sq, Sk, causal, window, q_offset) == want


@pytest.mark.parametrize("Sq,Sk,window,q_offset", [(256, 256, 100, 0), (64, 512, 100, 448)])
def test_criteria_fail_one_key_too_many(Sq, Sk, window, q_offset):
    """The parity criteria catch a window mask that is off by one key: the
    f32 tolerance and the bf16 row criterion both fail it, and the bf16
    rounding of a right output passes the row criterion."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_ref

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, s, h, 128), generator=g).bfloat16().float()
               for s, h in ((Sq, 4), (Sk, 2), (Sk, 2)))
    right = flash_attention_ref(q, k, v, window=window, q_offset=q_offset)
    wrong = flash_attention_ref(q, k, v, window=window + 1, q_offset=q_offset)
    assert float((wrong - right).abs().max()) > chip_smoke.TOL["float32"]
    assert chip_smoke.row_rel_err(wrong.bfloat16(), right) > chip_smoke.REL_TOL
    assert chip_smoke.row_rel_err(right.bfloat16(), right) <= chip_smoke.REL_TOL / 2


def test_bound_picks_the_larger_time():
    ms, by = chip_smoke.bound(989e12, 1.0, "bfloat16")  # 1 s of bf16 math
    assert by == "operations" and ms == pytest.approx(1e3)
    ms, by = chip_smoke.bound(1.0, 3.35e12, "float32")  # 1 s of HBM traffic
    assert by == "bytes" and ms == pytest.approx(1e3)


def _ssd_inputs(seed, B=1, L=100, H=4, P=16, N=8):
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, L, H, P), generator=g) * 0.5
    dt = (torch.randn((B, L, H), generator=g) * 0.1).abs()
    a = -torch.randn((H,), generator=g).abs()
    Bm, Cm = (torch.randn((B, L, H, N), generator=g) * 0.3 for _ in range(2))
    D = torch.randn((H,), generator=g)
    return x, dt, a, Bm, Cm, D


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_criterion_fails_the_D_term_added_twice(dtype):
    """A scan that adds D * x twice (the mixer's trap) fails the 5e-4 rule
    in f32 and in bf16, while the bf16 rounding of a right output passes."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan_ref

    x, dt, a, Bm, Cm, D = _ssd_inputs(0)
    want32, _ = ssd_scan_ref(x, dt, a, Bm, Cm, D)
    twice = want32 + x * D[None, None, :, None]
    dt_ = getattr(torch, dtype)
    assert chip_smoke.ssd_ratio(twice.to(dt_), want32, dtype) > 1.0
    assert chip_smoke.ssd_ratio(want32.to(dt_), want32, dtype) <= 1.0
    if dtype == "float32":  # an error just past 5e-4 of a value fails too
        assert chip_smoke.ssd_ratio(want32 + 2e-3 * want32.abs() + 6e-4, want32, dtype) > 1.0


def test_ssd_criterion_fails_a_stale_state():
    """The final-state check fails a state that missed the last chunk's update."""
    from repro_torch.kernels.ssd_scan import ssd_scan_ref

    x, dt, a, Bm, Cm, D = _ssd_inputs(1)
    _, h = ssd_scan_ref(x, dt, a, Bm, Cm, D)
    _, h_short = ssd_scan_ref(x[:, :96], dt[:, :96], a, Bm[:, :96], Cm[:, :96], D)
    assert chip_smoke.ssd_ratio(h_short, h, "float32") > 1.0
    assert chip_smoke.ssd_ratio(h, h, "float32") == 0.0


@pytest.mark.parametrize("fault", ["none", "slot", "id", "gate"])
def test_router_criterion_fails_one_entry_off(fault):
    """One slot or id off, or a gate 2e-6 off, fails the router rule."""
    import torch

    from repro_torch.kernels.moe_router import moe_router_ref

    logits = torch.randn((64, 16), generator=torch.Generator().manual_seed(2))
    want = moe_router_ref(logits, 4)
    ids, gates, slots = (t.clone() for t in want)
    if fault == "slot":
        slots[17, 2] += 1
    elif fault == "id":
        ids[5, 0] = (ids[5, 0] + 1) % 16
    elif fault == "gate":
        gates[40, 1] += 2e-6
    agree = chip_smoke.router_agreement((ids, gates, slots), want)
    assert agree["ok"] is (fault == "none")


@pytest.mark.parametrize(
    "B,L,H,P,N,chunk,G,want",
    [
        # mamba2-2.7b's prefill: 64 chunks; the 8256 causal entries of C.B^T
        # once for the one group, then per head those of W x and 4 Q N P
        (1, 8192, 80, 64, 128, 128, 1, 64 * (8256 * 2 * 128 + 80 * (8256 * 2 * 64
                                                                   + 4 * 128 * 128 * 64))),
        # pre-expanded heads (G = H); a ragged tail counts its own 4 tokens
        (1, 100, 2, 32, 16, 32, None, 2 * (3 * (528 * 2 * 16 + 528 * 2 * 32 + 4 * 32 * 16 * 32)
                                           + (10 * 2 * 16 + 10 * 2 * 32 + 4 * 4 * 16 * 32))),
        (2, 40, 1, 4, 4, 128, None, 2 * (820 * 2 * 4 * 2 + 4 * 40 * 4 * 4)),  # chunk capped at L
        # two groups of four heads: C.B^T twice per chunk, not eight times
        (1, 64, 8, 32, 16, 64, 2, 2 * 2080 * 2 * 16 + 8 * (2080 * 2 * 32 + 4 * 64 * 16 * 32)),
    ],
)
def test_ssd_flops(B, L, H, P, N, chunk, G, want):
    """C.B^T counts once per (chunk, group): the least work the function
    needs, whatever implements it."""
    assert chip_smoke.ssd_flops(B, L, H, P, N, chunk, G) == want


def test_ssd_bound_at_the_main_shape():
    """mamba2-2.7b's prefill: 27.0 GFLOP, 0.403 ms at f32's 67 TFLOP/s; on
    the tensor cores as csrc/ssd_scan.cu takes the products: bf16 inputs
    C.B^T in one bf16 pass, C h and the state update in two, W x in three
    (0.0600 ms at 989 TFLOP/s); f32 inputs three tf32 passes a product
    (0.1638 ms at 495 TFLOP/s)."""
    f = chip_smoke.ssd_product_flops(1, 8192, 80, 64, 128, 128, 1)
    assert f == dict(cb=64 * 8256 * 2 * 128, wx=64 * 80 * 8256 * 2 * 64,
                     ch=64 * 80 * 2 * 128 * 128 * 64, state=64 * 80 * 2 * 128 * 128 * 64)
    flops = chip_smoke.ssd_flops(1, 8192, 80, 64, 128, 128, 1)
    assert flops == sum(f.values()) == pytest.approx(27.0e9, rel=2e-3)
    assert chip_smoke.bound(flops, 0.0, "float32")[0] == pytest.approx(0.403, rel=2e-3)
    bf16 = chip_smoke.ssd_tensor_core_bound(1, 8192, 80, 64, 128, 128, 1, "bfloat16")
    assert bf16 == pytest.approx(
        (f["cb"] + 2 * f["ch"] + 2 * f["state"] + 3 * f["wx"]) / 989e12 * 1e3)
    assert bf16 == pytest.approx(0.0600, rel=2e-3)
    f32 = chip_smoke.ssd_tensor_core_bound(1, 8192, 80, 64, 128, 128, 1, "float32")
    assert f32 == pytest.approx(3 * flops / 495e12 * 1e3)
    assert f32 == pytest.approx(0.1638, rel=2e-3)


@pytest.mark.parametrize("needle", [
    "constexpr int kStatePieces = 2;",  # bf16: B o w in two pieces against exact x
    "constexpr int kWPieces = 3;",  # bf16: W in three
    "KH = F32 ? 1 : 2;",  # entering states: f32, or two bf16 pieces against exact C
    "mma(cb[nt], ca, b0, b1);",  # bf16: C.B^T in one pass
    "mma_3xtf32(cb[nt], ca,",  # f32: every product in three tf32 passes
    "mma_3xtf32(acc[nt], wa,",
    "mma_3xtf32(acc[nt], ca,",
    "mma_3xtf32(acc[nt], af,",
])
def test_ssd_passes_follow_the_kernel_source(needle):
    """The passes that ``SSD_PASSES`` charges are the ones the kernels take."""
    src = (chip_smoke.ROOT / "src/repro_torch/kernels/csrc/ssd_scan.cu").read_text()
    assert needle in src
    assert chip_smoke.SSD_PASSES == {
        "bfloat16": ("bfloat16", dict(cb=1, ch=2, state=2, wx=3)),
        "float32": ("tf32", dict(cb=3, ch=3, state=3, wx=3))}


def test_kernels_line_reports_no_computed_bound_but_bound_ms():
    """The ``kernels`` line carries measured numbers and ``bound_ms``; the
    tensor-core bound stays in the ssd_scan records."""
    src = Path(chip_smoke.__file__).read_text()
    at = src.index("kernels.append(dict(")
    assert "tensor_core_bound_ms" not in src[at:at + 800]
    assert "tensor_core_bound_ms=" in src[src.index("def ssd_case("):at]


# The cases of phase 2 that draw from the shared generator (seed 0), in the
# order in which they draw, as they stood before the decode and SSD
# redesign: a case inserted among them would shift the inputs of every case
# after it.
SEED0_CASES = [
    "main_S512",
    "main_S8192",
    "f32",
    "f32_main_heads_window300",
    "f32_main_heads_window300_q_offset",
    "f32_main_heads_window4096",
    "ragged_D64",
    "ragged_D64_bf16",
    "noncausal_SqneSk",
    "q_offset",
    "mha",
    "mqa_D32",
    "softcap",
    "blocks",
    "blocks_bf16_D128",
    "main_serve_B8_S256",
    "long_B8_S8192",
    "f32_D32",
    "f32_D64_mha",
    "split_invariance",
    "mqa_D128",
    "jax_1x64x2x32x16_c16_f32",
    "jax_2x128x4x64x32_c32_f32",
    "jax_1x100x2x32x16_c32_f32",
    "jax_1x256x8x64x128_c64_f32",
    "mamba2_prefill_f32",
    "jax_1x64x2x32x16_c16_bf16",
    "jax_2x128x4x64x32_c32_bf16",
    "jax_1x100x2x32x16_c32_bf16",
    "jax_1x256x8x64x128_c64_bf16",
    "mamba2_prefill_bf16",
    "ragged_L8000",
    "chunk_invariance",
    "grouped_B2_G2",
    "chunks_40_100",
    "chunk_40_bf16",
    "chunks_40_100_mamba2_regime",
    "mamba2_prefill_mamba2_regime",
    "jax_T64_E8_k2",
    "jax_T256_E64_k6",
    "jax_T128_E384_k8",
    "jax_T100_E16_k4",
    "jax_T32_E16_k2",
    "moonshot_prefill",
    "moonshot_serve",
    "kimi_T4096",
    "ties",
    "jax_B2_64x64x3_32x32",
    "jax_B4_48x56x3_32x40",
    "jax_B1_224x224x3_192x192",
    "jax_B3_40x40x1_40x40",
    "flip_involution",
    "out_of_range_corners",
    "imagenet_B256",
]


SLICE10_NAMES = [c[0] for c in chip_smoke.FLASH_BWD_CASES_SLICE10 + chip_smoke.FLASH_CASES_SLICE10
                 + chip_smoke.DECODE_CASES_SLICE10 + chip_smoke.SSD_CASES_SLICE10
                 + chip_smoke.SSD_BWD_CASES_SLICE10] + [
    c[0] for c in chip_smoke.ROUTER_CASES_SLICE10 * 2]


def _phase_kernels_draws(monkeypatch):
    """(kind, case name, generator seed) of every case phase 2 runs, with the
    case functions replaced by recorders and a stand-in generator."""
    import torch

    calls = []

    class Gen:
        def __init__(self, device=None):
            self.seed = None

        def manual_seed(self, seed):
            self.seed = seed
            return self

    def recorder(kind):
        def case(name, *args, gen=None, **kw):
            calls.append((kind, name, gen.seed))
            return dict(kernel=kind, case=name, ok=True)
        return case

    def flip(gen=None):
        calls.append(("augment_flip_case", "flip_involution", gen.seed))
        return dict(kernel="fused_augment", case="flip_involution", ok=True)

    monkeypatch.setattr(torch, "Generator", Gen)
    for kind in ("flash_case", "decode_case", "ssd_case", "router_case", "augment_case",
                 "flash_bwd_case", "ssd_bwd_case", "router_bwd_case"):
        monkeypatch.setattr(chip_smoke, kind, recorder(kind))
    monkeypatch.setattr(chip_smoke, "augment_flip_case", flip)
    monkeypatch.setattr(chip_smoke, "flash_bwd_cases", lambda main_S, g, g_edges: [])
    monkeypatch.setattr(chip_smoke, "decode_split_sweep", lambda: calls.append(
        ("decode_split_sweep", "sweep", chip_smoke.SWEEP_SEED)))
    chip_smoke.phase_kernels(8192)
    return calls


def test_new_cases_draw_from_their_own_generator(monkeypatch):
    """The decode (moonshot's G = 1, the card's plan at S = 32768) and bf16
    SSD cases draw from the generator seeded NEW_CASES_SEED, and the cases
    on the shared generator draw in the order they did before them."""
    calls = _phase_kernels_draws(monkeypatch)
    new = {name for name, *_ in chip_smoke.DECODE_CASES_NEW + chip_smoke.SSD_CASES_NEW}
    assert {name for _, name, seed in calls if seed == chip_smoke.NEW_CASES_SEED} == new
    assert [name for _, name, seed in calls if seed == 0] == SEED0_CASES
    assert chip_smoke.NEW_CASES_SEED not in (0, 14)


def test_new_cases_cover_the_new_routes():
    """Decode at moonshot's heads (16/16, G = 1, no window) at the serve shape
    and a long cache, and a long context on the card's plan; the bf16 SSD
    case in the mixer's regime at mamba2-2.7b's prefill shape."""
    cases = {name: (shape, kw) for name, *shape, kw in chip_smoke.DECODE_CASES_NEW}
    for name in ("moonshot_serve_B8_S256", "moonshot_long_B8_S4096"):
        (B, S, Hq, Hkv, D, dtype, lengths), kw = cases[name]
        assert (Hq, Hkv, D, dtype) == (16, 16, 128, "bfloat16") and kw.get("window", 0) == 0
        assert len(lengths) == B and max(lengths) <= S
    (B, S, Hq, Hkv, *_), kw = cases["long_B1_S32768_card_plan"]
    assert (B, S, Hq, Hkv) == (1, 32768, 24, 2) and kw["splits"] == (None,)
    ((B, L, H, P, N, dtype), kw), = [(tuple(shape), kw)
                                     for _, *shape, kw in chip_smoke.SSD_CASES_NEW]
    assert (B, L, H, P, N, dtype) == (1, 8192, 80, 64, 128, "bfloat16")
    assert kw == dict(groups=1, regime="mamba2")


def test_main_ssd_case_has_the_dtype_the_mixer_hands_the_scan(monkeypatch):
    """The kernels line reports ssd_scan at the dtype mamba2-2.7b's mixer
    hands it in the model's own precision (f32 params, bf16 compute): f32,
    since the mixer's depthwise conv runs with the f32 params uncast, as in
    the JAX function; and in the mixer's regime.  The bf16 case at the same
    shape is a case of its own."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, layers

    seen = []
    real = layers.ssd_scan

    def spy(x, *args, **kw):
        seen.append(x.dtype)
        return real(x, *args, **kw)

    monkeypatch.setattr(layers, "ssd_scan", spy)
    full = get_config("mamba2-2.7b")
    cfg = full.scaled_down().replace(attn_impl="pallas", dtype=full.dtype,
                                     param_dtype=full.param_dtype)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    model.forward(model.cast_for_compute(params),
                  {"tokens": torch.randint(1, cfg.vocab_size, (1, 16))}, last_token_only=True)
    assert seen and set(seen) == {torch.float32}
    name = chip_smoke.MAIN_CASE["ssd_scan"]
    assert name == "mamba2_prefill_mamba2_regime"
    src = inspect.getsource(chip_smoke.phase_kernels)
    call = src[src.index(f'ssd_case("{name}"'):]
    assert '"float32"' in call[:200] and 'regime="mamba2"' in call[:200]
    assert any(n == "mamba2_prefill_mamba2_regime_bf16" for n, *_ in chip_smoke.SSD_CASES_NEW)


def test_split_invariance_checks_the_card_plan():
    """phase 2's split_invariance case runs the card's plan (None) beside
    the explicit split counts."""
    src = inspect.getsource(chip_smoke.phase_kernels)
    at = src.index('"split_invariance"')
    assert "splits=(1, 2, 8, None)" in src[at:at + 200]


@pytest.mark.parametrize(
    "arch,replace,forward,step",
    [
        # RMSNorm: ln1 and ln2 a layer (ln1 alone in a mamba2 block), the
        # mixer's gated norm, and the final norm
        ("starcoder2-3b", {}, {"flash_attention": 30, "rms_norm": 61},
         {"decode_attention": 30, "rms_norm": 61}),
        ("mamba2-2.7b", {}, {"causal_conv": 64, "ssd_scan": 64, "rms_norm": 129},
         {"rms_norm": 129}),
        ("moonshot-v1-16b-a3b", {}, {"flash_attention": 48, "moe_router": 47, "rms_norm": 97},
         {"decode_attention": 48, "moe_router": 47, "rms_norm": 97}),
        ("moonshot-v1-16b-a3b", {"num_layers": 4},
         {"flash_attention": 4, "moe_router": 3, "rms_norm": 9},
         {"decode_attention": 4, "moe_router": 3, "rms_norm": 9}),
        # kimi-k2 as the run cuts it: 1 dense + 1 MoE layer, its f32 check dense only
        ("kimi-k2-1t-a32b", {"num_layers": 2}, {"flash_attention": 2, "moe_router": 1,
                                                "rms_norm": 5},
         {"decode_attention": 2, "moe_router": 1, "rms_norm": 5}),
        ("kimi-k2-1t-a32b", {"num_layers": 1}, {"flash_attention": 1, "rms_norm": 3},
         {"decode_attention": 1, "rms_norm": 3}),
        ("qwen2-vl-2b", {}, {"flash_attention": 28, "rms_norm": 57},
         {"decode_attention": 28, "rms_norm": 57}),
        # whisper: flash in each encoder layer, self and cross in each decoder
        # layer; decode self and cross in each decoder layer; RMSNorm 2 an
        # encoder layer, 3 a decoder layer, the encoder's and the final norm
        ("whisper-large-v3", {}, {"flash_attention": 96, "rms_norm": 162},
         {"decode_attention": 64, "rms_norm": 97}),
        ("whisper-large-v3", {"encoder_layers": 2, "num_layers": 2},
         {"flash_attention": 6, "rms_norm": 12}, {"decode_attention": 4, "rms_norm": 7}),
        # jamba served at one 7:1 period: 7 mamba2 layers, 1 attention, MoE
        # on every 2nd layer; its f32 check at the 2-layer cut
        ("jamba-v0.1-52b", {"num_layers": 8},
         {"flash_attention": 1, "causal_conv": 7, "ssd_scan": 7, "moe_router": 4,
          "rms_norm": 24},
         {"decode_attention": 1, "moe_router": 4, "rms_norm": 24}),
        ("jamba-v0.1-52b", {"num_layers": 2, "attn_period": 2, "attn_offset": 1},
         {"flash_attention": 1, "causal_conv": 1, "ssd_scan": 1, "moe_router": 1,
          "rms_norm": 6},
         {"decode_attention": 1, "moe_router": 1, "rms_norm": 6}),
    ],
)
def test_expected_launches_follow_the_layers(arch, replace, forward, step):
    from repro_torch.configs import get_config

    assert chip_smoke.expected_launches(get_config(arch).replace(**replace)) == (forward, step)


def test_require_launches_fails_a_bypassed_kernel():
    chip_smoke.require_launches("ok", {"moe_router": 94, "flash_attention": 48},
                                {"moe_router": 47}, 2)
    with pytest.raises(SystemExit, match="moe_router"):
        chip_smoke.require_launches("bypass", {"moe_router": 93}, {"moe_router": 47}, 2)


def test_require_launches_fails_a_whisper_step_without_its_cross_decode():
    """A whisper decode step that ran only its 32 self-attention decodes (the
    cross-attention bypassed) fails; one that ran all 64 passes."""
    from repro_torch.configs import get_config

    _, per_step = chip_smoke.expected_launches(get_config(chip_smoke.WHISPER))
    steps = chip_smoke.WHISPER_STEPS
    norms = {"rms_norm": 97 * steps}  # 3 a decoder layer and the final norm
    chip_smoke.require_launches("ok", {"decode_attention": 64 * steps, **norms}, per_step, steps)
    with pytest.raises(SystemExit, match="decode_attention"):
        chip_smoke.require_launches("no cross", {"decode_attention": 32 * steps, **norms},
                                    per_step, steps)


def test_whisper_cell_is_the_published_config():
    """whisper-large-v3 uncut (32 + 32 layers, 1500 frames, 1.53 B
    parameters), 448 decoder tokens (max_target_positions), a cache deep
    enough for the serve steps, and the f32 check at 2 + 2 layers."""
    from repro_torch.configs import get_config

    cfg = get_config(chip_smoke.WHISPER)
    assert (cfg.encoder_layers, cfg.num_layers, cfg.encoder_seq, cfg.d_model) == (32, 32, 1500,
                                                                                 1280)
    assert cfg.param_counts()["total"] / 1e9 == pytest.approx(1.53, abs=0.01)
    assert chip_smoke.WHISPER_S == 448 and chip_smoke.WHISPER_B == 8
    assert chip_smoke.WHISPER_PROMPT < chip_smoke.WHISPER_STEPS <= chip_smoke.WHISPER_S
    assert chip_smoke.WHISPER_CHECK == {"encoder_layers": 2, "num_layers": 2}
    assert chip_smoke.WHISPER_CHECK_TOL == chip_smoke.CHECK_TOL["grad_norm"]
    (arch, replace, prefill_S, check, lengths), = [
        m for m in chip_smoke.MODELS if m[0] == "qwen2-vl-2b"]
    assert replace == {} and prefill_S == 4096 and check == {"num_layers": 2}


def test_vlm_prefill_batch_is_seeded_with_qwen2vl_positions():
    """The VLM prefill batch: seeded embeddings and (1, 4096, 3) positions,
    256 text tokens at (i, i, i), a 60 x 60 grid at (256, 256 + row, 256 +
    col), then text from 316 on, each text run rising by 1 a token."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config("qwen2-vl-2b").scaled_down()
    a, b = (chip_smoke.prefill_batch(cfg, 4096, torch.Generator().manual_seed(1))
            for _ in range(2))
    c = chip_smoke.prefill_batch(cfg, 4096, torch.Generator().manual_seed(2))
    assert a.keys() == {"embeds", "positions"} and a["embeds"].shape == (1, 4096, cfg.d_model)
    assert torch.equal(a["embeds"], b["embeds"]) and not torch.equal(a["embeds"], c["embeds"])
    pos = a["positions"]
    assert pos.shape == (1, 4096, 3) and pos.dtype == torch.int32
    assert torch.equal(pos, c["positions"])
    text = torch.cat([pos[0, :256], pos[0, 256 + 3600:]])
    assert bool((text[:, 0] == text[:, 1]).all() and (text[:, 1] == text[:, 2]).all())
    assert bool((text[1:256, 0] - text[:255, 0] == 1).all())
    assert bool((text[257:, 0] - text[256:-1, 0] == 1).all())
    image = pos[0, 256:256 + 3600]
    assert bool((image[:, 0] == 256).all())
    assert image[:, 1].min() == 256 and image[:, 1].max() == 256 + 59
    assert torch.equal(image[61], torch.tensor([256, 257, 257], dtype=torch.int32))
    assert pos[0, 256 + 3600].tolist() == [316] * 3 and pos[0, -1, 0] == 316 + 239
    assert chip_smoke.prefill_batch(get_config("starcoder2-3b").scaled_down(), 8,
                                    torch.Generator()).keys() == {"tokens"}


def test_encdec_vlm_cases_draw_from_their_own_generator(monkeypatch):
    """The whisper and qwen2-vl cases draw from the generator seeded
    ENCDEC_VLM_SEED, one after another, and no earlier case's inputs move."""
    calls = _phase_kernels_draws(monkeypatch)
    names = [c[0] for c in chip_smoke.FLASH_CASES_ENCDEC_VLM + chip_smoke.DECODE_CASES_ENCDEC_VLM]
    seeds = [seed for _, _, seed in calls]
    assert [name for _, name, seed in calls if seed == chip_smoke.ENCDEC_VLM_SEED] == names
    first = seeds.index(chip_smoke.ENCDEC_VLM_SEED)
    assert seeds[first:first + len(names)] == [chip_smoke.ENCDEC_VLM_SEED] * len(names)
    assert chip_smoke.ENCDEC_VLM_SEED not in (
        0, 14, chip_smoke.NEW_CASES_SEED, chip_smoke.SWEEP_SEED, chip_smoke.D112_REDESIGN_SEED,
        chip_smoke.BWD_SEED, chip_smoke.BWD_REDESIGN_SEED)
    assert [name for _, name, seed in calls if seed == 0] == SEED0_CASES


def test_encdec_vlm_cases_cover_the_new_routes(monkeypatch):
    """bf16 flash without the causal mask at whisper's encoder (S = 1500, a
    ragged last key tile at both tiles, B = 8) and cross-attention (Sq = 448
    != Sk = 1500), each also in f32; qwen2-vl's causal prefill at G = 6;
    whisper's causal decoder self-attention in bf16 at both tiles (B = 8, S
    = 448: 3.5 query tiles); decode over the encoder's fixed length (G = 1),
    at G = 6 in bf16 with ragged lengths, and over whisper's 448-row self
    cache in bf16 at the serving lengths (one split of the card's plan).
    Every flash case runs twice and is timed on the device."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import TILE, rows_per_block, split_count

    flash = {name: (shape, kw) for name, *shape, kw in chip_smoke.FLASH_CASES_ENCDEC_VLM}
    for name in ("whisper_encoder_S1500", "whisper_cross_Sq448_Sk1500"):
        for suffix, dtype in (("", "bfloat16"), ("_f32", "float32")):
            shape, kw = flash[name + suffix]
            assert shape[0] == 8 and shape[3:7] == [20, 20, 64, dtype]
            assert kw["causal"] is False and kw["all_tiles"]
            assert shape[2] == 1500 and shape[2] % 128 and shape[2] % 64
    assert flash["whisper_cross_Sq448_Sk1500"][0][1:3] == [448, 1500]
    shape, kw = flash["qwen2vl_prefill_S4096"]
    assert shape == [1, 4096, 4096, 12, 2, 128, "bfloat16"] and kw.get("causal", True)
    whisper = get_config("whisper-large-v3")
    heads = [whisper.num_heads, whisper.num_kv_heads, whisper.head_dim, "bfloat16"]
    S_dec = chip_smoke.WHISPER_S  # max_target_positions of openai/whisper-large-v3
    shape, kw = flash["whisper_decoder_self_S448"]
    assert shape == [chip_smoke.WHISPER_B, S_dec, S_dec, *heads] and S_dec % 128
    assert kw.get("causal", True) and kw["all_tiles"]
    decode = {name: (shape, kw) for name, *shape, kw in chip_smoke.DECODE_CASES_ENCDEC_VLM}
    (B, S, Hq, Hkv, D, dtype, lengths), _ = decode["whisper_self_B8_S448"]
    assert [B, S, Hq, Hkv, D, dtype] == [chip_smoke.WHISPER_B, S_dec, *heads]
    assert min(lengths) == 1 and max(lengths) == chip_smoke.WHISPER_STEPS <= TILE
    assert split_count(S, B * Hkv, 132) == 1
    (B, S, Hq, Hkv, D, dtype, lengths), _ = decode["whisper_cross_L1500"]
    assert (B, S, Hq, Hkv, D, dtype) == (8, 1500, 20, 20, 64, "bfloat16")
    assert lengths == [S] * B
    (B, S, Hq, Hkv, D, dtype, lengths), _ = decode["qwen2vl_serve_G6"]
    assert (Hq // Hkv, D, dtype) == (6, 128, "bfloat16") and len(set(lengths)) == B
    assert rows_per_block(torch.bfloat16, Hq // Hkv) == 8  # rounded up, CUDA-core route
    seen = []
    monkeypatch.setattr(chip_smoke, "flash_case", lambda name, *a, **kw: seen.append(kw) or
                        dict(kernel="flash_attention", case=name, ok=True))
    monkeypatch.setattr(chip_smoke, "decode_case", lambda name, *a, **kw: dict(case=name, ok=True))
    monkeypatch.setattr(torch, "Generator", lambda device=None: type(
        "G", (), {"manual_seed": lambda self, s: self})())
    chip_smoke.encdec_vlm_cases()
    assert len(seen) == len(flash) and all(kw["twice"] for kw in seen)


@pytest.mark.parametrize("arch,replace,want", [
    # RMSNorm: each layer's norms twice under remat and once backward, the
    # final norm once each way
    ("starcoder2-3b", {}, {"flash_attention": 60, "flash_attention_bwd": 30, "rms_norm": 121,
                           "rms_norm_bwd": 61}),
    ("starcoder2-3b", {"num_layers": 2}, {"flash_attention": 4, "flash_attention_bwd": 2,
                                          "rms_norm": 9, "rms_norm_bwd": 5}),
    ("starcoder2-3b", {"remat": "none"}, {"flash_attention": 30, "flash_attention_bwd": 30,
                                          "rms_norm": 61, "rms_norm_bwd": 61}),
    # the benchmark cell's 257 and 129: 2 x 64 gated, 2 x 64 ln1, the final
    ("mamba2-2.7b", {}, {"causal_conv": 128, "causal_conv_bwd": 64, "ssd_scan": 128,
                         "ssd_scan_bwd": 64, "rms_norm": 257, "rms_norm_bwd": 129}),
    ("mamba2-2.7b", {"num_layers": 2}, {"causal_conv": 4, "causal_conv_bwd": 2, "ssd_scan": 4,
                                        "ssd_scan_bwd": 2, "rms_norm": 9, "rms_norm_bwd": 5}),
    # 1 dense layer (a group of its own, not recomputed) + 3 MoE layers
    ("moonshot-v1-16b-a3b", {"num_layers": 4}, {"flash_attention": 7, "flash_attention_bwd": 4,
                                                "moe_router": 6, "moe_router_bwd": 3,
                                                "rms_norm": 15, "rms_norm_bwd": 9}),
    ("moonshot-v1-16b-a3b", {"num_layers": 2}, {"flash_attention": 2, "flash_attention_bwd": 2,
                                                "moe_router": 1, "moe_router_bwd": 1,
                                                "rms_norm": 5, "rms_norm_bwd": 5}),
    # whisper: 32 encoder layers + 2 x 32 decoder layers (self and cross) =
    # 96 flash forwards, the same again recomputed (every layer is
    # checkpointed), 96 backwards; at the check's 2 + 2 layers 6, 6, 6;
    # RMSNorm 2 an encoder layer and 3 a decoder layer, recomputed, and the
    # encoder's and the final norm once
    ("whisper-large-v3", {}, {"flash_attention": 192, "flash_attention_bwd": 96,
                              "rms_norm": 322, "rms_norm_bwd": 162}),
    ("whisper-large-v3", {"remat": "none"}, {"flash_attention": 96, "flash_attention_bwd": 96,
                                             "rms_norm": 162, "rms_norm_bwd": 162}),
    ("whisper-large-v3", {"encoder_layers": 2, "num_layers": 2},
     {"flash_attention": 12, "flash_attention_bwd": 6, "rms_norm": 22, "rms_norm_bwd": 12}),
    ("qwen2-vl-2b", {}, {"flash_attention": 56, "flash_attention_bwd": 28, "rms_norm": 113,
                         "rms_norm_bwd": 57}),
    # jamba's cut: one group of 2 layers, not repeated, so nothing recomputed
    ("jamba-v0.1-52b", {"num_layers": 2, "attn_period": 2, "attn_offset": 1},
     {"flash_attention": 1, "flash_attention_bwd": 1, "causal_conv": 1, "causal_conv_bwd": 1,
      "ssd_scan": 1, "ssd_scan_bwd": 1, "moe_router": 1, "moe_router_bwd": 1, "rms_norm": 6,
      "rms_norm_bwd": 6}),
])
def test_train_launches_per_step(arch, replace, want):
    """A forward per layer that runs the kernel, one more for each such
    layer of a repeated group under remat, and a backward per layer: at full
    width 30 + 30 + 30 flash launches for starcoder2-3b, 64 + 64 + 64 SSD
    launches for mamba2-2.7b; counted by hand for whisper (an enc-dec
    recomputes every layer) and jamba's cut."""
    from repro_torch.configs import get_config

    assert chip_smoke.train_launches_per_step(get_config(arch).replace(**replace)) == want


def test_augment_bound_is_the_imagenet_bytes():
    """ResNet-50's recipe at B=256: 38.5 MB read + 154.1 MB written over
    3.35 TB/s is 57.5 us, bound by bytes."""
    ms, by = chip_smoke.augment_bound(256, 224, 224, 3)
    assert by == "bytes" and ms == pytest.approx(0.0575, rel=1e-3)


def test_zipf_batches_are_packed_and_seeded():
    """Rows of S + 1 tokens of zipf ids (no padding id 0), labels shifted by
    one, the same batches from the same seed."""
    import numpy as np

    src = chip_smoke.ZipfTokens(vocab=1000, batch=2, seq=700, steps=3, seed=4)
    a, b = list(src.session()), list(src.session(zero_copy=True))
    assert len(a) == 3
    for x, y in zip(a, b):
        assert x["tokens"].shape == x["labels"].shape == (2, 700)
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
        np.testing.assert_array_equal(x["tokens"][:, 1:], x["labels"][:, :-1])
        assert x["tokens"].min() >= 1 and x["labels"].max() <= 999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_criteria_fail_one_key_too_many(dtype):
    """The backward's criteria pass the plain gradients rounded to the
    working type and fail the gradients of a window one key too wide: f32 by
    the allclose rule (``grad_allclose``), bf16 by the row rule
    (``grad_row_rel_err``); a query that sees one key (dq = 0 exactly) does
    not trip the row rule."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_ref

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 256, h, 64), generator=g).bfloat16().float().requires_grad_()
               for h in (4, 2, 2))
    do = torch.randn((1, 256, 4, 64), generator=g)

    def grads(window):
        return torch.autograd.grad(flash_attention_ref(q, k, v, window=window), (q, k, v), do)

    right, wrong = grads(16), grads(17)
    dt = getattr(torch, dtype)
    for r in right:
        assert chip_smoke.grad_allclose(r.to(dt), r, dtype) <= 1.0
        assert chip_smoke.grad_row_rel_err(r.to(dt), r) <= chip_smoke.REL_TOL
    if dtype == "float32":
        assert max(chip_smoke.grad_allclose(w, r, dtype) for w, r in zip(wrong, right)) > 1.0
    else:
        assert max(chip_smoke.grad_row_rel_err(w.to(dt), r)
                   for w, r in zip(wrong, right)) > chip_smoke.REL_TOL


def test_backward_plain_version_on_the_kernels_inputs():
    """``flash_bwd_plain``'s per-kv-head loop is the backward's plain version
    on whole tensors (the function is separable by kv head)."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention_bwd_ref,
                                                     flash_attention_lse_ref)

    g = torch.Generator().manual_seed(4)
    q, do = (torch.randn((1, 96, 6, 32), generator=g) for _ in range(2))
    k, v = (torch.randn((1, 96, 2, 32), generator=g) for _ in range(2))
    kw = dict(causal=True, window=40)
    o, lse = flash_attention_lse_ref(q, k, v, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    got = chip_smoke.flash_bwd_plain(q, k, v, o, lse, do, kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "args,want",
    [
        ((1, 4, 4, 1, 1), 4 * 10),  # 10 visible pairs, 4 D FLOPs each
        ((2, 4, 4, 3, 8, False), 2 * 3 * 4 * 8 * 16),
        ((1, 2, 6, 1, 1, True, 0, 4), 4 * 11),
    ],
)
def test_flash_flops_count_the_visible_pairs(args, want):
    assert chip_smoke.flash_flops(*args) == want
    assert chip_smoke.flash_flops(*args, backward=True) == 2.5 * want


def test_flash_bounds_at_the_main_shape():
    """starcoder2-3b at S=8192 (24/2 heads, D=128, window 4096): 309 GFLOP
    forward, 0.3127 ms at 989 TFLOP/s; 2.5x that backward, 0.7818 ms."""
    fwd = chip_smoke.flash_flops(1, 8192, 8192, 24, 128, True, 4096)
    bwd = chip_smoke.flash_flops(1, 8192, 8192, 24, 128, True, 4096, backward=True)
    assert chip_smoke.bound(fwd, 0.0, "bfloat16")[0] == pytest.approx(0.3127, rel=1e-3)
    assert chip_smoke.bound(bwd, 0.0, "bfloat16")[0] == pytest.approx(0.7818, rel=1e-3)


@pytest.mark.parametrize("flops,ms,want", [(1e12, 1.0, 1000.0), (309e9, 0.3127, 988.2)])
def test_achieved_tflops(flops, ms, want):
    assert chip_smoke.achieved_tflops(flops, ms) == pytest.approx(want, rel=1e-3)


def test_bf16_edges_cover_the_edges_of_the_hopper_tiles():
    """Ragged tails at both tile sizes, q_offset with Sq != Sk, non-causal,
    MHA 16/16, D = 64 and 32, softcap 30, and S=1000 with window 300."""
    cases = {name: (tuple(shape), kw) for name, *shape, kw in chip_smoke.BF16_EDGES}
    assert len(cases) == len(chip_smoke.BF16_EDGES) == 9
    shapes = [shape for shape, _ in cases.values()]
    assert any(Sq % 128 and Sq % 64 for _, Sq, _, _, _, _ in shapes)  # ragged tails
    assert any(kw.get("q_offset") and shape[1] != shape[2] for shape, kw in cases.values())
    assert any(kw.get("causal") is False for _, kw in cases.values())
    assert any(Hq == Hkv == 16 for _, _, _, Hq, Hkv, _ in shapes)
    assert {D for *_, D in shapes} == {32, 64, 128}
    assert any(kw.get("softcap") == 30.0 for _, kw in cases.values())
    assert cases["bf16_S1000_window300"] == ((1, 1000, 1000, 24, 2, 128), {"window": 300})


@pytest.mark.parametrize("case", chip_smoke.BF16_EDGES, ids=lambda c: c[0])
def test_each_bf16_edge_does_work_the_kernels_take(case):
    """Every edge case has visible pairs, a head dim the kernels take and a
    GQA group that divides; the forward's FLOPs follow its masks."""
    _, B, Sq, Sk, Hq, Hkv, D, kw = case
    assert D in (32, 64, 128) and Hq % Hkv == 0
    pairs = chip_smoke._visible_pairs(Sq, Sk, kw.get("causal", True), kw.get("window", 0),
                                      kw.get("q_offset", 0))
    assert 0 < pairs <= Sq * Sk
    assert chip_smoke.flash_flops(B, Sq, Sk, Hq, D, kw.get("causal", True), kw.get("window", 0),
                                  kw.get("q_offset", 0)) == 4.0 * B * Hq * D * pairs


def test_split_sweep_measures_the_plans_picks(monkeypatch):
    """The decode split sweep runs after every case of phase 2, draws from a
    generator of its own and, on 132 SMs, measures the very counts the
    card's plan picks at its shapes."""
    import torch

    from repro_torch.kernels.decode_attention.ops import rows_per_block, split_count

    assert chip_smoke.SWEEP_SEED not in (0, chip_smoke.NEW_CASES_SEED)
    assert _phase_kernels_draws(monkeypatch)[-1][0] == "decode_split_sweep"
    picks = {}
    for name, B, S, Hq, Hkv, lengths, window in chip_smoke.SPLIT_SWEEP:
        assert len(lengths) == B and max(lengths) <= S
        G = Hq // Hkv
        picks[name] = split_count(S, B * Hkv * -(-G // rows_per_block(torch.bfloat16, G)), 132)
    assert picks == {"long_B8_S8192": 16, "long_B1_S32768": 64, "moonshot_long_B8_S4096": 8}
    assert set(picks.values()) <= set(chip_smoke.SWEEP_SPLITS)


D112_REDESIGN_TABLES = ("FLASH_CASES_D112", "FLASH_BWD_CASES_D112", "DECODE_CASES_D112",
                 "ROUTER_CASES_NEW", "AUGMENT_CASES_NEW")


def test_d112_and_redesign_cases_draw_from_their_own_generator(monkeypatch):
    """The head-dim-112, router and augment cases draw from the generator
    seeded D112_REDESIGN_SEED, after every earlier case and before the
    backward cases and the split sweep, so no earlier case's inputs move."""
    calls = _phase_kernels_draws(monkeypatch)
    names = {case[0] for table in D112_REDESIGN_TABLES for case in getattr(chip_smoke, table)}
    assert {name for _, name, seed in calls if seed == chip_smoke.D112_REDESIGN_SEED} == names
    assert chip_smoke.D112_REDESIGN_SEED not in (0, 14, chip_smoke.NEW_CASES_SEED,
                                          chip_smoke.SWEEP_SEED)
    seeds = [seed for _, _, seed in calls]
    first = seeds.index(chip_smoke.D112_REDESIGN_SEED)
    assert set(seeds[first:seeds.index(chip_smoke.BWD_SEED)]) == {chip_smoke.D112_REDESIGN_SEED}
    assert calls[-1][0] == "decode_split_sweep"
    n_cases = sum(len(getattr(chip_smoke, table)) for table in D112_REDESIGN_TABLES)
    assert len(names) == n_cases == seeds.count(chip_smoke.D112_REDESIGN_SEED)  # names unique


def test_d112_and_redesign_cases_cover_the_new_routes():
    """Flash at kimi-k2's prefill shape (B=1, S=4096, 64/8 heads x 112,
    causal), a ragged S and a window, f32; its backward in bf16 and f32;
    decode at kimi's serve shape and a long cache on the mma.sync route
    (G = 8) and f32 on the CUDA-core route; the router at T = 1, 65, 4097 and
    E = 64, 384; the augment at C = 4, unaligned rows, a row longer than one
    staged piece and a generic C, all with flips."""
    import torch

    from repro_torch.kernels.decode_attention.ops import rows_per_block
    from repro_torch.kernels.moe_router.kernel import TOKEN_BLOCK

    flash = {name: (shape, kw) for name, *shape, kw in chip_smoke.FLASH_CASES_D112}
    shape, kw = flash["kimi_prefill_S4096_D112"]
    assert shape == [1, 4096, 4096, 64, 8, 112, "bfloat16"] and kw.get("causal", True)
    assert all(shape[5] == 112 for shape, _ in flash.values())
    assert any(shape[1] % 128 and shape[6] == "bfloat16" for shape, _ in flash.values())
    assert any(kw.get("window") and shape[6] == "bfloat16" for shape, kw in flash.values())
    assert any(shape[6] == "float32" for shape, _ in flash.values())
    bwd = [shape for _, *shape, _ in chip_smoke.FLASH_BWD_CASES_D112]
    assert {s[5] for s in bwd} == {112} and {s[6] for s in bwd} == {"bfloat16", "float32"}
    decode = {name: shape for name, *shape, _ in chip_smoke.DECODE_CASES_D112}
    assert decode["kimi_serve_B8_S256_D112"][:6] == [8, 256, 64, 8, 112, "bfloat16"]
    assert decode["kimi_long_B8_S4096_D112"][:6] == [8, 4096, 64, 8, 112, "bfloat16"]
    routes = {rows_per_block(getattr(torch, s[5]), s[2] // s[3]) for s in decode.values()}
    assert routes == {16, 8}  # the mma.sync route and the CUDA-core route
    router = {(T, E, k) for _, T, E, k in chip_smoke.ROUTER_CASES_NEW}
    assert {T for T, _, _ in router} == {1, 65, 4097} and {E for _, E, _ in router} == {64, 384}
    assert all(T % TOKEN_BLOCK for T, _, _ in router)
    aug = [shape for _, *shape in chip_smoke.AUGMENT_CASES_NEW]
    assert any(C == 4 for _, _, _, C, _, _ in aug)
    assert any(W % 2 and ow % 2 and (ow * C) % 4 for _, _, W, C, _, ow in aug)
    assert any(ow * C > 2048 for _, _, _, C, _, ow in aug)
    assert any(C not in (1, 3, 4) for _, _, _, C, _, _ in aug)


@pytest.mark.parametrize("kernel,want", [
    ("fwd_sm90<128,128,0>", True), ("route_blocks<12>", True), ("add_prefix", True),
    ("route_bwd", True), ("ssd_bwd_chunk<64>", True), ("ssd_bwd_chunk_state<32>", True),
    ("ssd_bwd_state_pass", True), ("ssd_bwd_group_sum", True), ("ssd_bwd_head_sum", True),
    ("augment_rows<0>", True), ("fa_fwd_kernel<112,64,64>", True),
    ("dkdv_kernel<112,64,32>", True), ("decode_kernel<112,16>", True),
    ("fa_fwd_kernel<64,128,64>", False), ("dq_kernel<128,64,32>", False),
    ("delta_kernel", False), ("causal_conv_fwd_kernel", True), ("causal_conv_bwd_kernel", True),
    ("causal_conv_bwd_reduce", True), ("rms_norm_fwd_kernel", True),
    ("rms_norm_bwd_kernel", True), ("rms_norm_bwd_reduce", True),
])
def test_no_spill_rule(kernel, want):
    """Every Hopper redesign's kernel, every backward kernel of the SSD scan
    and the router, and every head-dim-112 instantiation must not spill; the
    first version's f32 kernels at other D may."""
    assert chip_smoke.no_spill(kernel) is want


def test_no_spill_kernels_name_every_kernel_of_the_new_sources():
    """Every ``__global__`` kernel of the backward's source and the router's
    backward is in NO_SPILL_KERNELS."""
    import re

    csrc = chip_smoke.ROOT / "src/repro_torch/kernels/csrc"
    found = set(re.findall(r"__launch_bounds__\([^)]*\)\)?\s*(\w+)\(",
                           (csrc / "ssd_scan_bwd.cu").read_text()))
    assert found == {"ssd_bwd_chunk_state", "ssd_bwd_state_pass", "ssd_bwd_chunk",
                     "ssd_bwd_group_sum", "ssd_bwd_head_sum"}
    assert found | {"route_bwd"} <= set(chip_smoke.NO_SPILL_KERNELS)
    assert "route_bwd(" in (csrc / "moe_router.cu").read_text()


def test_backward_cases_draw_from_their_own_generator(monkeypatch):
    """The SSD and router backward cases draw from the generator seeded
    BWD_SEED, after every earlier case; then the SSD backward redesign's case
    from one seeded BWD_REDESIGN_SEED; then the cases of the slice that
    trains the enc-dec, VLM and hybrid families from one seeded
    SLICE10_SEED; then the split sweep."""
    calls = _phase_kernels_draws(monkeypatch)
    names = [c[0] for c in chip_smoke.SSD_BWD_CASES + chip_smoke.ROUTER_BWD_CASES]
    new = [c[0] for c in chip_smoke.SSD_BWD_CASES_NEW]
    seeds = [seed for _, _, seed in calls]
    assert [name for _, name, seed in calls if seed == chip_smoke.BWD_SEED] == names
    assert [name for _, name, seed in calls if seed == chip_smoke.BWD_REDESIGN_SEED] == new
    earlier = (0, 14, chip_smoke.NEW_CASES_SEED, chip_smoke.SWEEP_SEED,
               chip_smoke.D112_REDESIGN_SEED)
    assert chip_smoke.BWD_SEED not in earlier
    assert chip_smoke.BWD_REDESIGN_SEED not in earlier + (chip_smoke.BWD_SEED,)
    first = seeds.index(chip_smoke.BWD_SEED)
    assert seeds[first:-1] == ([chip_smoke.BWD_SEED] * len(names)
                               + [chip_smoke.BWD_REDESIGN_SEED] * len(new)
                               + [chip_smoke.SLICE10_SEED] * len(SLICE10_NAMES))
    assert calls[-1][0] == "decode_split_sweep"
    assert [name for _, name, seed in calls if seed == 0] == SEED0_CASES


def test_new_ssd_bwd_case_splits_a_group_into_uneven_head_blocks():
    """The redesign's case has a group whose head count is not a multiple of
    the kernel's head block (12 heads: blocks of 8 and 4), in f32, with a
    ragged L and a non-zero dh_final."""
    from repro_torch.kernels.ssd_scan.kernel import BWD_CHUNK, HEAD_BLOCK

    ((B, L, H, P, N, dtype), kw), = [(tuple(shape), kw)
                                     for _, *shape, kw in chip_smoke.SSD_BWD_CASES_NEW]
    hpg = H // kw["groups"]
    assert hpg % HEAD_BLOCK and hpg > HEAD_BLOCK
    assert dtype == "float32" and kw["dh_final"] and L % BWD_CHUNK
    assert (P, N) == (64, 128)


def test_backward_cases_cover_the_train_paths():
    """SSD: mamba2-2.7b's mixer at the train shape (f32, the mixer's regime)
    and in bf16, G < H, a ragged L (not a multiple of the backward's 64-token
    chunk) and a non-zero dh_final; the main case is the f32 one.  Router:
    moonshot's train shape, kimi's routing, T = 8 and ties."""
    from repro_torch.kernels.ssd_scan.kernel import BWD_CHUNK

    ssd = {name: (shape, kw) for name, *shape, kw in chip_smoke.SSD_BWD_CASES}
    shape, kw = ssd[chip_smoke.MAIN_CASE["ssd_scan_bwd"]]
    assert shape == [1, 8192, 80, 64, 128, "float32"]
    assert kw == dict(groups=1, regime="mamba2")
    assert any(s[5] == "bfloat16" and s[:5] == [1, 8192, 80, 64, 128] for s, _ in ssd.values())
    assert any(1 < k.get("groups", s[2]) < s[2] for s, k in ssd.values())
    assert any(s[1] % BWD_CHUNK for s, _ in ssd.values())
    assert any(k.get("dh_final") for _, k in ssd.values())
    assert {s[3] for s, _ in ssd.values()} == {32, 64}
    router = {name: (T, E, k, kw) for name, T, E, k, kw in chip_smoke.ROUTER_BWD_CASES}
    assert router[chip_smoke.MAIN_CASE["moe_router_bwd"]] == (4096, 64, 6, {})
    assert (4096, 384, 8, {}) in router.values()
    assert any(T == 8 for T, *_ in router.values())
    assert any(kw.get("ties") for *_, kw in router.values())


@pytest.mark.parametrize("B,L,H,P,N,chunk,G,want", [
    # one chunk of 2 tokens: q(q+1) = 6; cb 6N, g and wdy 6P each a head,
    # dbdc 12N a head, state 5 x 2NP a token and head
    (1, 2, 1, 4, 3, 64, 1, 6 * 3 + 2 * 6 * 4 + 12 * 3 + 5 * 2 * 2 * 12),
    # two chunks (3 + 1 tokens): q(q+1) = 12 + 2; groups: cb once per group
    (1, 4, 2, 1, 1, 3, 1, 14 + 2 * 2 * 14 + 2 * 2 * 14 + 5 * 4 * 2 * 2),
])
def test_ssd_bwd_flops(B, L, H, P, N, chunk, G, want):
    assert chip_smoke.ssd_bwd_flops(B, L, H, P, N, chunk, G) == want


def test_ssd_bwd_bound_at_the_main_shape():
    """mamba2-2.7b's mixer at S = 8192 in 64-token chunks: 70.1 GFLOP, three
    quarters of it the per-token state terms; 1.046 ms at f32's 67 TFLOP/s."""
    flops = chip_smoke.ssd_bwd_product_flops(1, 8192, 80, 64, 128, 64, 1)
    assert flops["state"] == 5 * 80 * 8192 * 2 * 128 * 64
    assert flops["cb"] == 128 * 64 * 65 * 128
    total = sum(flops.values())
    assert total == pytest.approx(70.113e9, rel=1e-4)
    assert chip_smoke.bound(total, 1e9, "float32") == (pytest.approx(1.0465, rel=1e-3),
                                                         "operations")


def test_ssd_bwd_tensor_core_bound_at_the_main_shape():
    """f32: 3 tf32 passes of the 70.1 GFLOP at 495 TFLOP/s, 0.425 ms.  bf16:
    one pass for C.B^T and G, two for the products with K and P and for the
    backward chunk state, three for the other state terms, and the forward's
    chunk state two bf16 passes at 989."""
    f32 = chip_smoke.ssd_bwd_tensor_core_bound(1, 8192, 80, 64, 128, 64, 1, "float32")
    assert f32 == pytest.approx(3 * 70.113e9 / 495e12 * 1e3, rel=1e-4)
    fl = chip_smoke.ssd_bwd_product_flops(1, 8192, 80, 64, 128, 64, 1)
    term = fl["state"] / 5
    want = ((fl["cb"] + fl["g"] + 2 * (fl["wdy"] + fl["dbdc"]) + 11 * term) / 495e12
            + 2 * term / 989e12) * 1e3
    bf = chip_smoke.ssd_bwd_tensor_core_bound(1, 8192, 80, 64, 128, 64, 1, "bfloat16")
    assert bf == pytest.approx(want, rel=1e-9) and bf < f32


def test_ssd_bwd_scratch_bytes_at_the_main_shape():
    """R and the chunk states' buffer (335.5 MB) six times, the entering
    states twice, the head blocks' partials of dB and dC (41.9 MB each)
    twice: about 2.85 GB, where the function's own inputs and outputs are
    0.53 GB."""
    by = chip_smoke.ssd_bwd_scratch_bytes(1, 8192, 80, 64, 128, 1, "float32")
    mb = 335.544320
    assert by / 1e6 == pytest.approx(6 * mb + 2 * mb + 4 * 41.94304, rel=1e-3)


def test_per_call_time_survives_dropped_records():
    """A profile of 4 calls of a backward (one launch of a kernel, two of
    another a call) that lost one call's first records still gives one
    call's device time: 1000 + 2 x 200 us."""
    assert chip_smoke.per_call_us([(3000.0, 3), (1400.0, 7)], 4) == pytest.approx(1400.0)
    assert chip_smoke.per_call_us([(4000.0, 4), (1600.0, 8)], 4) == pytest.approx(1400.0)
    assert chip_smoke.per_call_us([], 4) == 0


def test_log_clocks_survives_a_missing_nvidia_smi(monkeypatch, capsys):
    """Off the card the clock line says the clocks were not read."""
    monkeypatch.setenv("PATH", "/nonexistent")
    chip_smoke.log_clocks("probe")
    assert "clocks probe: not read" in capsys.readouterr().out


def _ssd_grads(seed, dtype="float32"):
    import torch

    g = torch.Generator().manual_seed(seed)
    shapes = ((1, 20, 2, 8), (1, 20, 2), (2,), (1, 20, 1, 4), (1, 20, 1, 4), (2,))
    want = [torch.randn(s, generator=g, dtype=torch.float64) for s in shapes]
    dt = getattr(torch, dtype)
    got = [w.to(dt) if i in (0, 3, 4) else w.float() for i, w in enumerate(want)]
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_bwd_criteria_fail_one_entry_off(dtype):
    """The rounding of a right gradient passes; one entry of any gradient
    off by 1% of the tensor's RMS fails (f32: allclose at 5e-4; bf16: the
    row rule at 3e-2 needs 10%, so bf16 gets that)."""
    got, want = _ssd_grads(0, dtype)
    assert chip_smoke.ssd_bwd_verdict(got, [t.clone() for t in got], want, dtype)["ok"]
    off = 0.01 if dtype == "float32" else 0.1
    for i in range(6):
        bad = [t.clone() for t in got]
        rms = float(want[i].pow(2).mean().sqrt())
        bad[i].view(-1)[1] += off * rms + abs(float(want[i].view(-1)[1]))
        v = chip_smoke.ssd_bwd_verdict(bad, [t.clone() for t in bad], want, dtype)
        assert not v["ok"], chip_smoke.SSD_BWD_NAMES[i]


def test_bwd_criteria_fail_a_bit_unequal_second_run():
    """A second run one ulp off in one entry fails both backward verdicts."""
    import torch

    got, want = _ssd_grads(1)
    again = [t.clone() for t in got]
    again[2].view(-1)[0] = torch.nextafter(again[2].view(-1)[0], torch.tensor(1e9))
    v = chip_smoke.ssd_bwd_verdict(got, again, want, "float32")
    assert not v["bit_equal"] and not v["ok"]
    d = torch.randn(8, 16)
    assert chip_smoke.router_bwd_verdict(d, d.clone(), d)["ok"]
    d2 = d.clone()
    d2[0, 0] = torch.nextafter(d2[0, 0], torch.tensor(1e9))
    assert not chip_smoke.router_bwd_verdict(d, d2, d)["ok"]
    d3 = d.clone()
    d3[1, 1] += 2e-6
    v = chip_smoke.router_bwd_verdict(d3, d3.clone(), d)
    assert v["bit_equal"] and not v["ok"]


def test_kimi_cell_is_cut_to_fit_the_card():
    """kimi-k2 runs at full width, cut to its first 2 layers (1 dense + 1
    MoE of 384 experts top-8, heads 64/8 x 112): 17.2 B parameters in the
    layers, 39.1 GB in bf16 with the embedding and the head; its f32 check
    at the dense layer alone (the f32 MoE layer would be 67.6 GB)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import layer_pattern

    (arch, replace, prefill_S, check, lengths), = [
        m for m in chip_smoke.MODELS if m[0] == "kimi-k2-1t-a32b"]
    cfg = get_config(arch).replace(**replace)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (7168, 64, 8, 112)
    assert (cfg.num_experts, cfg.experts_per_token, cfg.param_dtype) == (384, 8, "bfloat16")
    assert [f for _, f in layer_pattern(cfg)] == ["dense", "moe"]
    total = cfg.param_counts()["total"]
    emb = 2 * cfg.vocab_size * cfg.d_model
    assert (total - emb) / 1e9 == pytest.approx(17.19, abs=0.01)
    assert 2 * total / 1e9 == pytest.approx(39.08, abs=0.01)
    cfg32 = cfg.replace(dtype="float32", **check)
    assert cfg32.param_dtype == "float32" and cfg32.num_layers == 1
    assert [f for _, f in layer_pattern(cfg32)] == ["dense"]
    assert 4 * cfg32.param_counts()["total"] / 1e9 < 11
    assert 4 * 384 * 3 * 7168 * 2048 / 1e9 == pytest.approx(67.6, abs=0.1)
    assert prefill_S == 4096 and lengths == (32,)


def test_slice10_cases_draw_from_their_own_generator(monkeypatch):
    """The cases of the enc-dec, VLM and hybrid train slice draw from the
    generator seeded SLICE10_SEED, one after another, after every earlier
    case and before the split sweep; no earlier case's inputs move."""
    calls = _phase_kernels_draws(monkeypatch)
    seeds = [seed for _, _, seed in calls]
    assert [name for _, name, seed in calls if seed == chip_smoke.SLICE10_SEED] == SLICE10_NAMES
    first = seeds.index(chip_smoke.SLICE10_SEED)
    assert seeds[first:-1] == [chip_smoke.SLICE10_SEED] * len(SLICE10_NAMES)
    assert calls[-1][0] == "decode_split_sweep"
    assert chip_smoke.BWD_REDESIGN_SEED in seeds[:first]
    assert chip_smoke.SLICE10_SEED not in (
        0, 14, chip_smoke.NEW_CASES_SEED, chip_smoke.SWEEP_SEED, chip_smoke.D112_REDESIGN_SEED,
        chip_smoke.BWD_SEED, chip_smoke.BWD_REDESIGN_SEED, chip_smoke.ENCDEC_VLM_SEED)
    assert [name for _, name, seed in calls if seed == 0] == SEED0_CASES
    kinds = [kind for kind, _, seed in calls if seed == chip_smoke.SLICE10_SEED]
    assert kinds.count("router_case") == kinds.count("router_bwd_case") == 4


def test_slice10_cases_cover_the_train_shapes(monkeypatch):
    """The flash backward in bf16 at whisper's encoder (B = 8, S = 1500,
    non-causal: a ragged last dQ tile of BWD_Q_PAD rows), cross-attention
    (Sq = 448 over Sk = 1500, non-causal) and decoder self-attention
    (causal), qwen2-vl's G = 6 and jamba's G = 4 at S = 4096; in f32 a
    non-causal Sq = 100 over Sk = 300 and G = 6; jamba's prefill (S = 8192,
    32/8) and serve decode (B = 8, G = 4: the CUDA-core route with 4 rows),
    its SSD scan in the mixer's bf16 at L = 8192 and in f32 at the train
    shape L = 4096 (the train step's forward: ``ssd_chunk_out`` on the f32
    route), its backward in f32 at L = 4096 (128 heads, P = 64, N = 16, one
    group, chunk 128), its router at E = 16, k = 2 for T = 8, 4096, 4097 and
    the prefill's 8192.  Every case is timed on the device (the flash
    forward's with ``twice``, the others always)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import rows_per_block
    from repro_torch.kernels.flash_attention.kernel import BWD_Q_PAD

    whisper, qwen, jamba = (get_config(a) for a in ("whisper-large-v3", "qwen2-vl-2b",
                                                     "jamba-v0.1-52b"))
    bwd = {name: (shape, kw) for name, *shape, kw in chip_smoke.FLASH_BWD_CASES_SLICE10}
    wh = [whisper.num_heads, whisper.num_kv_heads, whisper.head_dim, "bfloat16"]
    assert bwd["whisper_encoder_bwd_S1500"] == ([8, 1500, 1500, *wh], dict(causal=False))
    assert bwd["whisper_cross_bwd_Sq448_Sk1500"] == ([8, 448, 1500, *wh], dict(causal=False))
    assert bwd["whisper_decoder_self_bwd_S448"] == ([8, 448, 448, *wh], dict())
    assert 1500 % BWD_Q_PAD and 448 % BWD_Q_PAD
    for name, cfg in (("qwen2vl_bwd_S4096", qwen), ("jamba_bwd_S4096", jamba)):
        assert bwd[name] == ([1, 4096, 4096, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                              "bfloat16"], dict())
    assert (qwen.num_heads // qwen.num_kv_heads, jamba.num_heads // jamba.num_kv_heads) == (6, 4)
    (B, Sq, Sk, Hq, Hkv, D, dtype), kw = bwd["f32_noncausal_Sq100_Sk300"]
    assert (Sq, Sk, dtype, kw) == (100, 300, "float32", dict(causal=False))
    (B, Sq, Sk, Hq, Hkv, D, dtype), kw = bwd["f32_G6_S200"]
    assert (Hq // Hkv, dtype) == (6, "float32")
    (name, *shape, kw), = chip_smoke.FLASH_CASES_SLICE10
    assert shape == [1, 8192, 8192, 32, 8, 128, "bfloat16"] and kw.get("causal", True)
    (name, B, S, Hq, Hkv, D, dtype, lengths, kw), = chip_smoke.DECODE_CASES_SLICE10
    assert (B, Hq, Hkv, D, dtype) == (8, 32, 8, 128, "bfloat16") and max(lengths) <= S
    assert rows_per_block(torch.bfloat16, Hq // Hkv) == 4
    mixer = [1, jamba.ssm_heads, jamba.ssm_head_dim, jamba.ssm_state]
    prefill, train = chip_smoke.SSD_CASES_SLICE10
    for (name, B, L, *heads, dtype, kw), want in ((prefill, (8192, "bfloat16")),
                                                  (train, (4096, "float32"))):
        assert [B, *heads] == mixer and (L, dtype) == want
        assert kw == dict(groups=jamba.ssm_groups, regime="mamba2") and jamba.ssm_chunk == 128
    runs = {a: (r, B, S) for a, r, B, S, _ in chip_smoke.TRAIN_RUNS}
    models = {a: S for a, _, S, *_ in chip_smoke.MODELS}
    assert runs["jamba-v0.1-52b"][1:] == (1, train[2]) and models["jamba-v0.1-52b"] == prefill[2]
    (name, B, L, *heads, dtype, kw), = chip_smoke.SSD_BWD_CASES_SLICE10
    assert [B, *heads] == mixer and (L, dtype) == (4096, "float32")
    assert kw == dict(groups=1, regime="mamba2")
    assert [(T, E, k) for _, T, E, k in chip_smoke.ROUTER_CASES_SLICE10] == [
        (8, 16, 2), (4096, 16, 2), (4097, 16, 2), (8192, 16, 2)]
    assert {train[2], prefill[2]} <= {T for _, T, _, _ in chip_smoke.ROUTER_CASES_SLICE10}
    assert (jamba.num_experts, jamba.experts_per_token) == (16, 2)
    for case in (chip_smoke.flash_bwd_case, chip_smoke.ssd_case, chip_smoke.decode_case,
                 chip_smoke.router_case, chip_smoke.ssd_bwd_case, chip_smoke.router_bwd_case):
        assert "device_ms(" in inspect.getsource(case)
    seen = {}

    def record(kind):
        def case(name, *args, **kw):
            seen[(kind, name)] = kw
            return dict(kernel=kind, case=name, ok=True)
        return case

    for kind in ("flash_case", "decode_case", "ssd_case", "router_case", "flash_bwd_case",
                 "ssd_bwd_case", "router_bwd_case"):
        monkeypatch.setattr(chip_smoke, kind, record(kind))
    monkeypatch.setattr(torch, "Generator", lambda device=None: type(
        "G", (), {"manual_seed": lambda self, s: self})())
    chip_smoke.slice10_cases()
    assert len(seen) == len(SLICE10_NAMES)
    assert all(kw["twice"] for (kind, _), kw in seen.items() if kind == "flash_case")


def test_jamba_cell_is_one_period_at_full_width():
    """jamba-v0.1-52b served at every published width, cut to one whole 7:1
    period (8 of its 32 layers: 7 mamba2 and 1 attention, MoE on every 2nd),
    13.27 B parameters, 26.5 GB in bf16 (the whole 51.5 B would need 103
    GB), prefill at S = 8192; its f32 decode-vs-forward check at the 2-layer
    cut of its train run, dropless as decode is, at two lengths (one with a
    ragged SSD chunk)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import layer_pattern

    (arch, replace, prefill_S, check, lengths), = [
        m for m in chip_smoke.MODELS if m[0] == "jamba-v0.1-52b"]
    cfg = get_config(arch).replace(**replace)
    assert cfg.param_dtype == "bfloat16" and cfg.num_layers == cfg.attn_period == 8
    assert layer_pattern(cfg) == [("ssm", "dense"), ("ssm", "moe")] * 3 + [
        ("ssm", "dense"), ("attn", "moe")]
    assert 2 * cfg.param_counts()["total"] / 1e9 == pytest.approx(26.5, abs=0.1)
    assert 2 * get_config(arch).param_counts()["total"] / 1e9 == pytest.approx(103, abs=1)
    assert prefill_S == 8192
    cfg32 = cfg.replace(dtype="float32", **check)
    runs = {a: r for a, r, *_ in chip_smoke.TRAIN_RUNS}
    assert {k: v for k, v in check.items() if k in runs[arch]} == runs[arch]
    assert layer_pattern(cfg32) == [("ssm", "dense"), ("attn", "moe")]
    assert cfg32.param_dtype == "float32" and cfg32.capacity_factor == 64.0
    assert 4 * cfg32.param_counts()["total"] / 1e9 < 15
    assert any(L % 32 for L in lengths) and all(L <= 64 for L in lengths)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "whisper-large-v3", "qwen2-vl-2b"])
def test_family_batches_follow_the_train_specs(arch):
    """``FamilyBatches`` yields JAX's ``train_input_specs`` layout: tokens and
    labels (the token families: ``ZipfTokens``' very batches); the enc-dec
    family adds f32 ``enc_embeds`` (B, encoder_seq, d_model); the VLM family
    takes f32 ``embeds`` (B, S, d_model) and int32 (B, S, 3) positions in
    Qwen2-VL's layout in place of tokens, a text position's embedding the
    frozen row of its token and an image position's label padding.  Every
    batch holds ``ZipfTokens``' tokens; the random frames and patch
    embeddings are a pool of ``FEED_POOL`` drawn when the source is built,
    which the batches cycle through.  Seeded: the same batches from the same
    seed."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config(arch).scaled_down()
    B, S, n = 2, 256, 3
    src = chip_smoke.FamilyBatches(cfg, B, S, n, seed=3)
    assert chip_smoke.FEED_POOL == 2
    assert len(src.pool) == (0 if cfg.family == "dense" else 2)
    assert len(chip_smoke.FamilyBatches(cfg, B, S, 1, seed=3).pool) == len(src.pool[:1])
    a = list(src.session())
    b = list(chip_smoke.FamilyBatches(cfg, B, S, n, seed=3).session())
    zipf = list(chip_smoke.ZipfTokens(cfg.vocab_size, B, S, n, seed=3).session())
    assert len(a) == n
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for key in x:
            np.testing.assert_array_equal(x[key], y[key])
    if cfg.family == "vlm":
        image = np.zeros(S, dtype=bool)
        image[64:64 + 121] = True
        for x, want in zip(a, zipf):
            assert x.keys() == {"embeds", "positions", "labels"}
            emb, pos = x["embeds"], x["positions"]
            assert emb.shape == (B, S, cfg.d_model) and emb.dtype == np.float32
            assert pos.shape == (B, S, 3) and pos.dtype == np.int32
            assert (pos[:, :64] == np.arange(64)[None, :, None]).all()  # S / 4 text tokens
            assert (pos[:, 64:64 + 121, 0] == 64).all()  # an 11 x 11 image at t = 64
            assert pos[0, 64 + 12].tolist() == [64, 65, 65]
            assert (x["labels"][:, image] == 0).all()
            np.testing.assert_array_equal(x["labels"][:, ~image], want["labels"][:, ~image])
            for bi, i in ((0, 0), (1, 63), (0, 64 + 121), (1, S - 1)):
                np.testing.assert_array_equal(emb[bi, i],
                                              src.text_row(int(want["tokens"][bi, i])))
            assert 0.015 < emb.std() < 0.025  # EMBED_SCALE
        patches = [x["embeds"][:, image] for x in a]
        np.testing.assert_array_equal(patches[2], patches[0])  # the pool, cycled
        assert not np.array_equal(patches[1], patches[0])
        np.testing.assert_array_equal(patches[0], src.pool[0][:, image])
        full = get_config(arch)  # the train run's S holds the prefill's prompt layout
        (batch,) = chip_smoke.FamilyBatches(full, 1, 4096, 1, seed=0).session()
        np.testing.assert_array_equal(batch["positions"],
                                      chip_smoke.qwen2vl_positions(4096).numpy())
        assert chip_smoke.qwen2vl_layout(4096) == (chip_smoke.VLM_TEXT, chip_smoke.VLM_GRID)
        return
    for x, z in zip(a, zipf):
        np.testing.assert_array_equal(x["tokens"], z["tokens"])
        np.testing.assert_array_equal(x["labels"], z["labels"])
    if cfg.family == "encdec":
        for x in a:
            assert x.keys() == {"tokens", "labels", "enc_embeds"}
            assert x["enc_embeds"].shape == (B, cfg.encoder_seq, cfg.d_model)
            assert x["enc_embeds"].dtype == np.float32
        np.testing.assert_array_equal(a[2]["enc_embeds"], a[0]["enc_embeds"])
        assert not np.array_equal(a[1]["enc_embeds"], a[0]["enc_embeds"])
    else:
        assert all(x.keys() == {"tokens", "labels"} for x in a)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-2b", "jamba-v0.1-52b"])
def test_train_check_configs(arch, monkeypatch):
    """The f32 train checks of the new runs: 2 layers of the run's config
    (whisper's encoder at 2 layers too, jamba at its period-2 cut and
    dropless), f32 compute; the earlier runs' checks are as they were (2
    layers, f32, nothing else changed)."""
    from repro_torch.configs import get_config

    import repro_torch.models as models

    runs = {a: r for a, r, *_ in chip_smoke.TRAIN_RUNS}
    built = []

    class Stop(Exception):
        pass

    def fake_build(cfg):
        built.append(cfg)
        raise Stop

    monkeypatch.setattr(models, "build_model", fake_build)
    for a in (arch, "starcoder2-3b", "moonshot-v1-16b-a3b"):
        with pytest.raises(Stop):
            chip_smoke.phase_train_check(a, runs[a])
    cfg, star, moon = built
    assert (cfg.num_layers, cfg.dtype) == (2, "float32")
    if arch == "whisper-large-v3":
        assert cfg.encoder_layers == 2
    if arch == "jamba-v0.1-52b":
        assert (cfg.attn_period, cfg.attn_offset, cfg.capacity_factor) == (2, 1, 64.0)
    assert star == get_config("starcoder2-3b").replace(num_layers=2, dtype="float32")
    assert moon == get_config("moonshot-v1-16b-a3b").replace(num_layers=2, dtype="float32")


# ---------------------------------------------------------------------------
# the formulas' one copy (repro_torch.launch.flops) and phase 6 (service)
# ---------------------------------------------------------------------------
def test_formulas_keep_their_values():
    """chip_smoke.py takes its FLOP and byte formulas from the package; each
    gives the value its own copy gave before the move, bit for bit."""
    from repro_torch.launch import flops

    assert chip_smoke.flash_flops is flops.flash_flops
    assert chip_smoke.flash_flops(1, 8192, 8192, 24, 128, True, 4096) == 309262811136.0
    assert chip_smoke.flash_flops(1, 8192, 8192, 24, 128, True, 4096,
                                  backward=True) == 773157027840.0
    assert chip_smoke.flash_flops(8, 448, 1500, 20, 64, False) == 27525120000.0
    assert chip_smoke._visible_pairs(1000, 1000, True, 300, 0) == 255150
    assert chip_smoke.ssd_flops(1, 8192, 80, 64, 128, 128, 1) == 27020754944.0
    assert chip_smoke.ssd_flops(1, 4097, 128, 64, 16, 128, None) == 7558680576.0
    assert chip_smoke.ssd_bwd_flops(1, 8192, 80, 64, 128, 64, 1) == 70113034240.0
    assert chip_smoke.augment_bound(256, 224, 224, 3) == (0.05751610029850746, "bytes")
    assert chip_smoke.bound(309262811136.0, 1e9, "bfloat16") == (0.31270253906572293,
                                                                "operations")
    # decode_case's and the router cases' inline counts, as they were
    visible, B, Hq, Hkv, D = 1000, 8, 24, 2, 128
    assert flops.decode_flops(Hq, D, visible) == 4.0 * Hq * D * visible
    assert flops.decode_bytes(visible, B, Hq, Hkv, D, 2) == float(
        (2 * visible * Hkv * D + 2 * B * Hq * D) * 2 + B * 4)
    assert flops.router_flops(4096, 64, 6) == float(4096 * 64 * (4 + 2 * 6))
    assert flops.router_bytes(4096, 64, 6) == 4.0 * (4096 * 64 + 3 * 4096 * 6)
    assert flops.router_bwd_flops(4096, 6) == float(4096 * 6 * 4)


def test_service_command_lines():
    assert chip_smoke.SERVICE_RUNS == (("starcoder2-3b", 1, 8192, 6),
                                       ("whisper-large-v3", 8, 448, 4))
    cmd = chip_smoke.service_command("whisper-large-v3", 8, 448, 4)
    assert cmd[1:] == ["-m", "repro_torch.launch.train", "--arch", "whisper-large-v3",
                       "--execute", "--full-width", "--device", "cuda", "--batch", "8",
                       "--seq", "448", "--steps", "4", "--workers", "2"]
    src = inspect.getsource(chip_smoke.main)
    assert src.index("phase_train_check(") < src.index("phase_service(") < src.index(
        '"kernels"')


def _canned(**changes):
    res = {"run": "train_e2e_torch", "arch": "starcoder2-3b", "steps": 2,
           "losses": [11.40, 11.41], "first_batch_loss_after": 11.39,
           "last_batch_loss_after": 11.38,
           "max_memory_allocated_gb": 61.0,
           "launches": {"flash_attention": 120, "flash_attention_bwd": 60},
           "left_running": {"threads": [], "processes": []}}
    res.update(changes)
    return res


PER_STEP = {"flash_attention": 60, "flash_attention_bwd": 30}


def test_service_checks_pass_a_good_run():
    chip_smoke.service_checks("service", _canned(), PER_STEP)


@pytest.mark.parametrize("changes", [
    dict(first_batch_loss_after=11.40),  # the first batch's loss did not fall
    dict(first_batch_loss_after=float("nan")),
    dict(last_batch_loss_after=11.41),  # the last batch's loss did not fall
    dict(last_batch_loss_after=float("nan")),
    dict(losses=[11.40, float("nan")]),
    dict(losses=[]),
    dict(max_memory_allocated_gb=80.0),
    dict(max_memory_allocated_gb=None),
    dict(launches={"flash_attention": 120, "flash_attention_bwd": 59}),
    dict(launches={"flash_attention": 120}),
    dict(left_running={"threads": ["worker-0"], "processes": []}),
    dict(left_running={"threads": [], "processes": ["Process-1"]}),
], ids=lambda c: next(iter(c)))
def test_service_checks_fail(changes):
    with pytest.raises(SystemExit):
        chip_smoke.service_checks("service", _canned(**changes), PER_STEP)


class _Done:
    def __init__(self, returncode, stdout, stderr=""):
        self.returncode, self.stdout, self.stderr = returncode, stdout, stderr


def test_run_service_reads_the_last_line():
    import json

    line = json.dumps(_canned())

    def run(cmd, **kw):
        assert kw["cwd"] == str(chip_smoke.ROOT) and kw["timeout"] == chip_smoke.SERVICE_TIMEOUT_S
        assert kw["env"]["PYTHONPATH"] == str(chip_smoke.ROOT / "src")
        return _Done(0, f"[starcoder2-3b] step 2 loss 11.3\n{line}\n")

    res, stdout, _ = chip_smoke.run_service(["python", "-m", "x"], run=run)
    assert res == _canned() and "step 2" in stdout


@pytest.mark.parametrize("outcome", ["exit_1", "no_line", "not_a_result", "timeout"])
def test_run_service_fails_a_failing_subprocess(outcome):
    import json

    def run(cmd, **kw):
        if outcome == "timeout":
            raise subprocess.TimeoutExpired(cmd, kw["timeout"])
        if outcome == "exit_1":
            return _Done(1, json.dumps(_canned()) + "\n", "Traceback ...")
        if outcome == "no_line":
            return _Done(0, "[starcoder2-3b] step 2 loss 11.3\n")
        return _Done(0, json.dumps({"ok": True}) + "\n")

    with pytest.raises(SystemExit):
        chip_smoke.run_service(["python", "-m", "x"], run=run)


# ---------------------------------------------------------------------------
# phase 7(c) and 7(d): the partitioned step
# ---------------------------------------------------------------------------
@pytest.fixture
def gloo_mesh11(tmp_path):
    """A (1, 1) DeviceMesh over a world of one gloo rank, destroyed after
    the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        yield make_test_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["starcoder2-3b", "mamba2-2.7b"])
def test_dtensor_train_driver_is_bit_equal_on_one_device(arch, gloo_mesh11):
    """Phase 7(d)'s train driver on the CPU at 2 layers: the state and
    batches as DTensors on a (1, 1) mesh through the kernel wrappers'
    boundary give the plain steps' losses and parameters bit for bit."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.bridge import flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_plan
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cfg = get_config(arch).scaled_down().replace(num_layers=2, attn_impl="pallas",
                                                 remat="block")
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in chip_smoke.FamilyBatches(cfg, 2, 32, 2, seed=0).session()]
    plain = init_train_state(model, 0, opt, device="cpu")
    step = make_train_step(model, opt)
    want = [float(step(plain, b)[1]["loss"]) for b in batches]
    state = init_train_state(model, 0, opt, device="cpu")
    seen = []
    real = chip_smoke.dtensor_tree

    def spy(tree, shardings):
        out = real(tree, shardings)
        seen.extend(isinstance(t, DTensor) for _, t in flatten_with_paths(out))
        return out

    chip_smoke.dtensor_tree = spy
    try:
        got, secs = chip_smoke.dtensor_train(model, opt, state, batches, gloo_mesh11,
                                             make_plan(gloo_mesh11))
    finally:
        chip_smoke.dtensor_tree = real
    assert seen and all(seen) and len(secs) == 2
    assert got == want
    differ, worst = chip_smoke.leaves_bit_equal(state["params"],
                                                dict(flatten_with_paths(plain["params"])))
    assert not differ, (differ[:4], worst)


def test_dtensor_decode_driver_is_bit_equal_on_one_device(gloo_mesh11):
    """Phase 7(d)'s decode driver (moonshot at 2 layers, the router and
    decode through the boundary): the same logits bit for bit."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_plan
    from repro_torch.models import build_model

    cfg = get_config("moonshot-v1-16b-a3b").scaled_down().replace(num_layers=2,
                                                                 attn_impl="pallas")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    tokens = [torch.randint(1, cfg.vocab_size, (4,), generator=gen, dtype=torch.int32)
              for _ in range(3)]
    want = chip_smoke.decode_logits(model, params, 4, 8, tokens)
    got = chip_smoke.decode_logits(model, params, 4, 8, tokens, gloo_mesh11,
                                   make_plan(gloo_mesh11))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_dryrun_verdict_fails_a_null_collective_term():
    """Phase 7(c) fails a production-mesh record whose collective term is
    null (the PR before the partitioned dry run wrote such records), one
    whose temporaries are null (the PRs before the memory analysis), a
    failed record, and passes a partitioned one."""
    good = {"status": "OK", "roofline": {
        "collective_s": 1.5, "collective_bytes_per_device": 7.5e10,
        "collective_breakdown": {"total": 7.5e10, "counts": {"all-gather": 3}},
        "memory_per_device_bytes": {"argument_bytes": 9, "temp_bytes": 12}}}
    assert chip_smoke.dryrun_verdict(good) == ""
    no_temp = {**good, "roofline": {**good["roofline"], "memory_per_device_bytes": {
        "argument_bytes": 9, "temp_bytes": None}}}
    assert "null temp_bytes" in chip_smoke.dryrun_verdict(no_temp)
    null = {"status": "OK", "roofline": {"collective_s": None,
                                         "collective_bytes_per_device": None,
                                         "collective_breakdown": {"total": None, "counts": None}}}
    assert "null" in chip_smoke.dryrun_verdict(null)
    assert "FAIL" in chip_smoke.dryrun_verdict({"status": "FAIL", "error": "x"})


def test_dryrun_cells_run_the_first_at_full_size(tmp_path):
    """Phase 7(c) runs llama3-405b's single-pod cell at full size and the
    other three at ``scaled_down()``; a reduced cell's command asks for it
    and its record is read under its tag."""
    assert [c[3] for c in chip_smoke.DIST_DRYRUN] == [False, True, True, True]
    assert {c[2] for c in chip_smoke.DIST_DRYRUN} == {"single", "multi"}
    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        (tmp_path / "multi__reduced__kimi__train_4k.json").write_text('{"status": "OK"}')
        return subprocess.CompletedProcess(cmd, 0, "", "")

    rec, _ = chip_smoke.run_dryrun_cell("kimi", "train_4k", "multi", str(tmp_path), True, run)
    assert rec == {"status": "OK"}
    assert seen[0][-3:] == ["--reduced", "--tag", "reduced"]


# ---------------------------------------------------------------------------
# the memory checks (phases 2, 3 and 5): their logic on the CPU, the card's
# allocations stood in for by the CUDA route's own allocations on meta
# ---------------------------------------------------------------------------
def _card_route_ssd_bwd(monkeypatch, args):
    """What ``ssd_scan_bwd``'s CUDA route allocates, counted on meta: the
    wrapper's six outputs, then the launch function's scratch (its kernels
    a stub library)."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.memory import MemoryTracker

    class Lib:
        def __getattr__(self, name):
            fn = lambda *a: 0  # noqa: E731
            fn.argtypes = fn.restype = None
            return fn

    monkeypatch.setattr(ssd_kernel, "_lib", lambda *a: Lib())
    monkeypatch.setattr(ssd_kernel, "_stream", lambda t: 0)
    x, dt, a, Bm, Cm, D, dy = args
    with MemoryTracker() as mt:
        f32 = dict(dtype=torch.float32, device=x.device)
        outs = (torch.empty_like(x), torch.empty(dt.shape, **f32), torch.empty((80,), **f32),
                torch.empty_like(Bm), torch.empty_like(Cm), torch.empty((80,), **f32))
        ssd_kernel.ssd_scan_bwd_launch(x, dt, a, Bm, Cm, D, dy, None, outs[0], outs[1],
                                       outs[2], outs[3], outs[4], outs[5])
    return mt.peak


def _ssd_bwd_args():
    import torch

    m = dict(device="meta")
    return (torch.empty((1, 8192, 80, 64), **m), torch.empty((1, 8192, 80), **m),
            torch.empty((80,), **m), torch.empty((1, 8192, 1, 128), **m),
            torch.empty((1, 8192, 1, 128), **m), torch.empty((80,), **m),
            torch.empty((1, 8192, 80, 64), **m))


def _plant_gap(monkeypatch):
    """Drops the chunk states from the tracker's reckoning of the SSD
    backward's scratch (the launch still allocates them)."""
    from repro_torch.kernels import _shape

    full = _shape.ssd_scan_bwd_scratch
    monkeypatch.setattr(_shape, "ssd_scan_bwd_scratch",
                        lambda *a: {k: v for k, v in full(*a).items() if k != "rstate"})


@pytest.mark.parametrize("gap", [False, True])
def test_kernel_memory_check_fails_a_dropped_scratch_tensor(gap, monkeypatch):
    """Phase 2's per-kernel check at ``ssd_scan_bwd``'s main case: the CUDA
    route's allocations equal the meta charge (within 512 B a tensor), and a
    scratch tensor dropped from the tracker's reckoning fails it."""
    from repro_torch.kernels import ssd_scan_bwd
    from repro_torch.launch.memory import MemoryTracker

    args = _ssd_bwd_args()
    rise = _card_route_ssd_bwd(monkeypatch, args)
    if gap:
        _plant_gap(monkeypatch)
    with MemoryTracker() as mt:
        ssd_scan_bwd(*args)
    rec = chip_smoke.kernel_memory_verdict("ssd_scan_bwd", rise, mt.peak,
                                           mt.allocations + mt.scratch_allocations)
    assert rec["ok"] is (not gap)
    assert rec["tensors"] == (13 if gap else 14) and (rise == mt.peak) is (not gap)


@pytest.mark.parametrize("gap", [False, True])
def test_step_memory_check_fails_a_dropped_scratch_tensor(gap, monkeypatch):
    """Phases 3 and 5's per-step check, on a step of one kernel call whose
    scratch is most of its memory (``ssd_scan_bwd`` at mamba2's train shape):
    measured = its arguments + the CUDA route's rise; predicted = its
    arguments + the meta peak.  Equal, it passes; with the chunk states
    (335.5 MB) dropped from the tracker's reckoning it is 26% short of the
    1.28 GB measured and fails the 10% limit."""
    from repro_torch.kernels import ssd_scan_bwd
    from repro_torch.launch.memory import MemoryTracker

    args = _ssd_bwd_args()
    arg_bytes = chip_smoke.tree_bytes(args)
    measured = arg_bytes + _card_route_ssd_bwd(monkeypatch, args)
    if gap:
        _plant_gap(monkeypatch)
    with MemoryTracker() as mt:
        ssd_scan_bwd(*args)
    rec = chip_smoke.step_memory_verdict("train x", arg_bytes + mt.peak, measured)
    assert rec["ok"] is (not gap)
    assert rec["ratio"] == 1.0 if not gap else 0.73 < rec["ratio"] < 0.75
    assert rec["tol"] == chip_smoke.MEM_STEP_TOL == 0.10


def test_tree_bytes_walks_tuples_lists_and_dicts():
    import torch

    t = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
    assert chip_smoke.tree_bytes((t, [t, {"a": t, "pos": 3}], None)) == 3 * 64


def test_ulp_share_counts_bf16_steps_across_zero():
    """``ulp_share`` counts how many bf16 steps a kernel's output lies from
    the f64 plain version rounded to bf16, across zero too: one step passes
    as bit-equal does, two do not."""
    import torch

    want = torch.tensor([1.0, -1.5, 3.0e-3, 0.0], dtype=torch.float64)
    got = want.to(torch.bfloat16)
    assert chip_smoke.ulp_share(got, want) == (1.0, 0)
    bits = got.view(torch.int16).clone()
    bits[0] += 1  # one step up from 1.0
    assert chip_smoke.ulp_share(bits.view(torch.bfloat16), want) == (1.0, 1)
    bits[1] += 2  # two steps away from -1.5
    assert chip_smoke.ulp_share(bits.view(torch.bfloat16), want) == (0.75, 2)
    # -0 is zero's own step, the least negative value one step from zero
    below = torch.tensor([-32768, -32767], dtype=torch.int16).view(torch.bfloat16)
    assert chip_smoke.ulp_share(below, torch.zeros(2, dtype=torch.float64)) == (1.0, 1)


def test_norm_forward_check_bounds_the_worst_entry_besides_the_share():
    """A bf16 output passes within one step on ``NORM_ULP_SHARE`` of its
    entries and with no entry more than ``NORM_MAX_STEPS`` away: a few far
    entries (one wrong row of many) fail it though the share holds.  An f32
    output is held by ``conv_err``."""
    import torch

    want = torch.linspace(-3.0, 3.0, 20000, dtype=torch.float64)
    got = want.to(torch.bfloat16)
    assert chip_smoke.norm_fwd_check(got, want) == (dict(ulp_share=1.0, max_steps=0), True)
    bits = got.view(torch.int16).clone()
    bits[:10] += 1
    errs, ok = chip_smoke.norm_fwd_check(bits.view(torch.bfloat16), want)
    assert ok and errs["max_steps"] == 1
    bits[10:12] += chip_smoke.NORM_MAX_STEPS + 1  # 0.01% of the entries, far off
    errs, ok = chip_smoke.norm_fwd_check(bits.view(torch.bfloat16), want)
    assert errs["ulp_share"] >= chip_smoke.NORM_ULP_SHARE and not ok
    f32 = want.float()
    assert chip_smoke.norm_fwd_check(f32, want)[1]
    assert not chip_smoke.norm_fwd_check(f32 + 1e-3, want)[1]


def test_norm_library_is_the_one_pytorch_call_of_the_plain_form():
    """``library_ms`` times ``F.rms_norm`` with w as it is, forward and
    backward; ``library_w_cast_ms`` casts w to x's dtype only where they
    differ."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 64), generator=g).bfloat16()
    w = 1 + 0.1 * torch.randn((64,), generator=g)
    dout = torch.randn((3, 64), generator=g).bfloat16()
    lib = chip_smoke.norm_library(x, w, dout)
    assert sorted(lib) == ["library_ms", "library_w_cast_ms"]
    fwd, bwd = lib["library_ms"]
    assert torch.equal(fwd(), F.rms_norm(x, (64,), w, chip_smoke.NORM_EPS))
    dx, dw = bwd()
    assert (dx.shape, dx.dtype, dw.shape, dw.dtype) == ((3, 64), x.dtype, (64,), w.dtype)
    assert torch.equal(lib["library_w_cast_ms"][0](),
                       F.rms_norm(x, (64,), w.bfloat16(), chip_smoke.NORM_EPS))
    assert sorted(chip_smoke.norm_library(x, w.bfloat16(), dout)) == ["library_ms"]


@pytest.mark.parametrize("arch,replace,forward,decode", [
    ("mamba2-2.7b", {}, (128, 1), (128, 1)),  # ln1 and the gated norm, and the final
    ("starcoder2-3b", {"norm_type": "layer"}, (0, 0), (0, 0)),
    ("qwen3-14b", {}, (4 * 40, 1), (4 * 40, 1)),  # ln1, ln2, q and k norms
    ("whisper-large-v3", {}, (2 * 32 + 3 * 32, 2), (3 * 32, 1)),
])
def test_model_norms_count_the_layers_and_the_final_norms(arch, replace, forward, decode):
    from repro_torch.configs import get_config

    cfg = get_config(arch).replace(**replace)
    assert chip_smoke.model_norms(cfg) == forward
    assert chip_smoke.model_norms(cfg, decode=True) == decode


def test_norm_cases_cover_the_main_path_and_the_plan():
    """The RMSNorm's cases hold the benchmark cell's two norms at their
    shapes (gated at 5120 from the 10576-wide in_proj row, the block norm at
    2560), jamba's, qk-norm at 128, decode at B = 8, the widest widths both
    forms take, a width no multiple of a chunk, and a gate whose row stride is
    no multiple of a chunk (the element-wise route)."""
    from repro_torch.kernels.rms_norm.kernel import MAX_GATED_WIDTH, MAX_WIDTH

    cases = {name: (lead, D, row, x) for name, lead, D, row, x, *_ in chip_smoke.NORM_CASES}
    assert cases[chip_smoke.MAIN_CASE["rms_norm"]] == ((4, 2048), 5120, 10576, "float32")
    assert cases["mamba2_ln1_B4_L2048"][:3] == ((4, 2048), 2560, None)
    assert cases["qk_norm_D128"][1] == 128 and cases["decode_gated_B8"][0] == (8, 1)
    widths = {(D, row is None) for _, D, row, _ in cases.values()}
    assert (MAX_WIDTH, True) in widths and (MAX_GATED_WIDTH, False) in widths
    assert any(D % 8 for D, _ in widths)
    assert any(row is not None and row % 8 for _, _, row, _ in cases.values())
    assert chip_smoke.MAIN_CASE["rms_norm_bwd"] == chip_smoke.MAIN_CASE["rms_norm"]
