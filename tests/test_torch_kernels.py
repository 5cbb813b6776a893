"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers compute their plain versions; these tests
hold those plain versions against the Pallas kernels run in interpret mode,
on the shape grids of ``tests/test_kernels.py``, with its tolerances: 2e-5
for f32 (the two sides sum in different orders), 3e-2 for bf16 (outputs are
rounded to bf16 on both sides, at different points).  The CUDA kernels
themselves run only on the card (``chip_smoke.py``).
"""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode_attention
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_attention_ref
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from repro_torch.kernels.decode_attention.ops import split_plan
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

F32_TOL = 2e-5
BF16_TOL = 3e-2


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x, dtype="float32"):
    """The same numpy array as a JAX array and a torch tensor, in dtype."""
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))
    return jx, tx


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


FLASH_SHAPES = [
    (1, 128, 128, 4, 2, 64),
    (2, 256, 256, 8, 8, 64),  # MHA
    (1, 192, 192, 6, 1, 32),  # MQA
    (2, 96, 96, 4, 2, 128),  # ragged seq vs block
    (1, 64, 320, 4, 4, 64),  # cross-shape (Sq != Sk)
]
FLASH_CASES = [
    (shape, causal)
    for shape in FLASH_SHAPES
    for causal in (True, False)
    if not (causal and shape[1] != shape[2])  # causal needs aligned q/k
]


class TestFlashAttentionPlain:
    @pytest.mark.parametrize("shape,causal", FLASH_CASES)
    def test_shapes_vs_pallas(self, shape, causal):
        B, Sq, Sk, Hq, Hkv, D = shape
        rng = np.random.default_rng(0)
        (jq, tq), (jk, tk), (jv, tv) = (
            _both(_randn(rng, s)) for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))
        )
        want = jax_flash_attention(jq, jk, jv, causal=causal, interpret=True,
                                   block_q=64, block_k=64)
        got = flash_attention_ref(tq, tk, tv, causal=causal)
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=F32_TOL)

    @pytest.mark.parametrize("window", [16, 64])
    def test_windowed(self, window):
        rng = np.random.default_rng(1)
        (jq, tq), (jk, tk), (jv, tv) = (
            _both(_randn(rng, s)) for s in ((1, 200, 4, 32), (1, 200, 2, 32), (1, 200, 2, 32))
        )
        want = jax_flash_attention(jq, jk, jv, causal=True, window=window, interpret=True,
                                   block_q=64, block_k=64)
        got = flash_attention_ref(tq, tk, tv, causal=True, window=window)
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=F32_TOL)

    def test_softcap(self):
        rng = np.random.default_rng(2)
        (jq, tq), (jk, tk), (jv, tv) = (
            _both(_randn(rng, s)) for s in ((1, 128, 4, 64), (1, 128, 2, 64), (1, 128, 2, 64))
        )
        want = jax_flash_attention(jq, jk, jv, causal=True, softcap=30.0, interpret=True)
        got = flash_attention_ref(tq, tk, tv, causal=True, softcap=30.0)
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=F32_TOL)

    def test_q_offset(self):
        """Queries at absolute positions 256.. against 320 keys (chunked
        prefill): the causal mask follows q_offset on both sides."""
        rng = np.random.default_rng(3)
        (jq, tq), (jk, tk), (jv, tv) = (
            _both(_randn(rng, s)) for s in ((1, 64, 4, 64), (1, 320, 2, 64), (1, 320, 2, 64))
        )
        want = jax_flash_attention(jq, jk, jv, causal=True, q_offset=256, interpret=True,
                                   block_q=64, block_k=64)
        got = flash_attention_ref(tq, tk, tv, causal=True, q_offset=256)
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=F32_TOL)

    def test_bfloat16(self):
        rng = np.random.default_rng(4)
        (jq, tq), (jk, tk), (jv, tv) = (
            _both(_randn(rng, s), "bfloat16")
            for s in ((1, 128, 4, 64), (1, 128, 2, 64), (1, 128, 2, 64))
        )
        want = jax_flash_attention(jq, jk, jv, causal=True, interpret=True)
        got = flash_attention_ref(tq, tk, tv, causal=True)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_TOL, rtol=BF16_TOL)

    @pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 128), (128, 256), (256, 64)])
    def test_block_shapes_vs_pallas(self, block_q, block_k):
        """Every Pallas block shape agrees with the one plain version."""
        rng = np.random.default_rng(5)
        (jq, tq), (jk, tk), (jv, tv) = (
            _both(_randn(rng, s)) for s in ((1, 256, 4, 64), (1, 256, 2, 64), (1, 256, 2, 64))
        )
        want = jax_flash_attention(jq, jk, jv, causal=True, interpret=True,
                                   block_q=block_q, block_k=block_k)
        got = flash_attention_ref(tq, tk, tv, causal=True)
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=F32_TOL)


DECODE_SHAPES = [
    (2, 512, 4, 2, 64, 4),
    (1, 1024, 8, 8, 64, 8),
    (4, 300, 6, 2, 32, 4),  # ragged cache
    (2, 256, 4, 1, 128, 2),  # MQA wide head
]


class TestDecodeAttentionPlain:
    @pytest.mark.parametrize("B,S,Hq,Hkv,D,ns", DECODE_SHAPES)
    def test_shapes_vs_pallas(self, B, S, Hq, Hkv, D, ns):
        rng = np.random.default_rng(6)
        (jq, tq), (jk, tk), (jv, tv) = (
            _both(_randn(rng, s)) for s in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))
        )
        lens = rng.integers(1, S + 1, (B,)).astype(np.int32)
        want = jax_decode_attention(jq, jk, jv, jnp.asarray(lens), num_splits=ns, block_s=128,
                                    interpret=True)
        got = decode_attention_ref(tq, tk, tv, torch.from_numpy(lens))
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=F32_TOL)

    def test_windowed(self):
        rng = np.random.default_rng(7)
        (jq, tq), (jk, tk), (jv, tv) = (
            _both(_randn(rng, s)) for s in ((3, 4, 64), (3, 512, 2, 64), (3, 512, 2, 64))
        )
        lens = np.asarray([10, 300, 512], np.int32)
        want = jax_decode_attention(jq, jk, jv, jnp.asarray(lens), window=100, num_splits=4,
                                    block_s=128, interpret=True)
        got = decode_attention_ref(tq, tk, tv, torch.from_numpy(lens), window=100)
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=F32_TOL)

    @pytest.mark.parametrize("ns", [1, 2, 4])
    def test_splits_vs_pallas(self, ns):
        """Every Pallas split count agrees with the one plain version."""
        rng = np.random.default_rng(8)
        (jq, tq), (jk, tk), (jv, tv) = (
            _both(_randn(rng, s)) for s in ((2, 4, 64), (2, 512, 2, 64), (2, 512, 2, 64))
        )
        lens = np.asarray([384, 512], np.int32)
        want = jax_decode_attention(jq, jk, jv, jnp.asarray(lens), num_splits=ns, block_s=128,
                                    interpret=True)
        got = decode_attention_ref(tq, tk, tv, torch.from_numpy(lens))
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=F32_TOL)

    def test_matches_model_decode_math(self):
        """Decode over a full cache == flash attention of one query, on both
        sides (the JAX suite's kernel-vs-model invariant)."""
        rng = np.random.default_rng(9)
        (jq, tq), (jk, tk), (jv, tv) = (
            _both(_randn(rng, s)) for s in ((1, 8, 64), (1, 640, 2, 64), (1, 640, 2, 64))
        )
        lens = np.asarray([640], np.int32)
        want = jax_decode_attention(jq, jk, jv, jnp.asarray(lens), interpret=True)
        got = decode_attention_ref(tq, tk, tv, torch.from_numpy(lens))
        also = flash_attention_ref(tq[:, None], tk, tv, causal=False)[:, 0]
        jax_also = jax_flash_attention_ref(jq[:, None], jk, jv, causal=False)[:, 0]
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(_np(also), _np(jax_also), atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(_np(got), _np(also), atol=F32_TOL, rtol=F32_TOL)

    @pytest.mark.parametrize("S,ns,bs", [(512, 8, 128), (300, 4, 128), (100, 8, 256), (8192, 8, 256)])
    def test_split_plan_covers_cache(self, S, ns, bs):
        """The port's split plan is the TPU kernel's: whole segments that
        cover the cache, a multiple of the (capped) block."""
        n, seg = split_plan(S, ns, bs)
        assert 1 <= n <= ns and n * seg >= S and (n - 1) * seg < S
        assert seg % min(bs, -(-S // n)) == 0


class TestWrapperRouting:
    def test_flash_cpu_takes_plain_version(self):
        reset_launch_counts()
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(s, generator=g) for s in ((1, 96, 4, 32), (1, 96, 2, 32),
                                                           (1, 96, 2, 32)))
        got = flash_attention(q, k, v, causal=True, window=40)
        want = flash_attention_ref(q, k, v, causal=True, window=40)
        assert torch.equal(got, want)
        assert launch_counts() == {"flash_attention": 0, "decode_attention": 0}

    def test_decode_cpu_takes_plain_version(self):
        reset_launch_counts()
        g = torch.Generator().manual_seed(1)
        q, k, v = (torch.randn(s, generator=g) for s in ((2, 4, 64), (2, 200, 2, 64),
                                                           (2, 200, 2, 64)))
        lens = torch.tensor([5, 200], dtype=torch.int32)
        got = decode_attention(q, k, v, lens, window=50, num_splits=4, block_s=64)
        want = decode_attention_ref(q, k, v, lens, window=50)
        assert torch.equal(got, want)
        assert launch_counts() == {"flash_attention": 0, "decode_attention": 0}

    def test_other_devices_raise(self):
        """No kernel and no plain fallback for a device that is neither CPU
        nor CUDA."""
        q = torch.empty((1, 64, 4, 64), device="meta")
        k = torch.empty((1, 64, 2, 64), device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            flash_attention(q, k, k)
        with pytest.raises(ValueError, match="no kernel"):
            decode_attention(q[:, 0], k, k, torch.empty((1,), dtype=torch.int32, device="meta"))

    def test_modules_import_without_nvcc_or_cuda(self, tmp_path):
        """Importing the port builds nothing: no nvcc, no GPU, no triton."""
        src = os.path.join(os.path.dirname(__file__), "..", "src")
        code = (
            "import sys\n"
            "import repro_torch, repro_torch.kernels, repro_torch.models, repro_torch.serve\n"
            "import repro_torch.bridge\n"
            "from repro_torch.kernels import _build\n"
            "assert not _build._libs\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
            "assert 'triton' not in sys.modules\n"
        )
        env = {"PATH": str(tmp_path), "PYTHONPATH": os.path.abspath(src),
               "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path)}
        subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
