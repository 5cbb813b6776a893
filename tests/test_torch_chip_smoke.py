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
