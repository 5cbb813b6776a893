"""``chip_smoke.py`` off the card: it must refuse to pass without CUDA or
without the port next to it, and its roofline arithmetic must count the
work the run's data needs."""
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
    "B,L,H,P,N,chunk,want",
    [
        # mamba2-2.7b's prefill: 64 chunks x 80 heads x 7.36 MFLOP, the
        # 8256 causal entries of C.B^T and W x only
        (1, 8192, 80, 64, 128, 128, 64 * 80 * (8256 * 2 * 128 + 8256 * 2 * 64
                                                + 4 * 128 * 128 * 64)),
        # a ragged tail counts its own 4 tokens (10 causal entries)
        (1, 100, 2, 32, 16, 32, 2 * (3 * (528 * 2 * 16 + 528 * 2 * 32 + 4 * 32 * 16 * 32)
                                     + (10 * 2 * 16 + 10 * 2 * 32 + 4 * 4 * 16 * 32))),
        (2, 40, 1, 4, 4, 128, 2 * (820 * 2 * 4 * 2 + 4 * 40 * 4 * 4)),  # chunk capped at L
    ],
)
def test_ssd_flops(B, L, H, P, N, chunk, want):
    assert chip_smoke.ssd_flops(B, L, H, P, N, chunk) == want


@pytest.mark.parametrize(
    "arch,replace,forward,step",
    [
        ("starcoder2-3b", {}, {"flash_attention": 30}, {"decode_attention": 30}),
        ("mamba2-2.7b", {}, {"ssd_scan": 64}, {}),
        ("moonshot-v1-16b-a3b", {}, {"flash_attention": 48, "moe_router": 47},
         {"decode_attention": 48, "moe_router": 47}),
        ("moonshot-v1-16b-a3b", {"num_layers": 4}, {"flash_attention": 4, "moe_router": 3},
         {"decode_attention": 4, "moe_router": 3}),
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


@pytest.mark.parametrize("arch,replace,want", [
    ("starcoder2-3b", {}, {"flash_attention": 60, "flash_attention_bwd": 30}),
    ("starcoder2-3b", {"num_layers": 2}, {"flash_attention": 4, "flash_attention_bwd": 2}),
    ("starcoder2-3b", {"remat": "none"}, {"flash_attention": 30, "flash_attention_bwd": 30}),
])
def test_train_launches_per_step(arch, replace, want):
    """30 forward + 30 recomputed under remat + 30 backward at full width."""
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
