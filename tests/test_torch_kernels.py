"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers compute their plain versions; these tests
hold those plain versions against the Pallas kernels run in interpret mode,
on the shape grids of ``tests/test_kernels.py``, with its tolerances:

* attention: 2e-5 for f32 (the two sides sum in different orders), 3e-2
  for bf16 (outputs are rounded to bf16 on both sides, at different points);
* ssd_scan: 5e-4 (the plain version is the token recurrence, the Pallas
  kernel the chunked form: one f32 rounding path against another over up
  to 256 steps), 1e-3 across chunk sizes, as the JAX suite;
* moe_router: ids and slots equal, gates within 1e-6 (one f32 softmax
  and one division against another).

The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode_attention
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_attention_ref
from repro.kernels.moe_router.ops import moe_router as jax_moe_router
from repro.kernels.moe_router.ref import moe_router_ref as jax_moe_router_ref
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from repro_torch.kernels.decode_attention.ops import split_plan
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.moe_router import moe_router, moe_router_ref
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
from repro_torch.models.layers import _route_top_k

F32_TOL = 2e-5
BF16_TOL = 3e-2
SSD_TOL = 5e-4
SSD_CHUNK_TOL = 1e-3
GATE_TOL = 1e-6
NO_LAUNCHES = {name: 0 for name in KERNELS}


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


SSD_SHAPES = [  # tests/test_kernels.py::TestSSDScan
    (1, 64, 2, 32, 16, 16),
    (2, 128, 4, 64, 32, 32),
    (1, 100, 2, 32, 16, 32),  # ragged length
    (1, 256, 8, 64, 128, 64),  # mamba2 proportions
]


def _ssd_inputs(rng, B, L, H, P, N, groups=None, D_zero=False):
    """The JAX suite's SSD inputs (scales 0.5 / 0.1 / 0.3), as JAX arrays
    and torch tensors; B and C hold ``groups`` groups when given."""
    G = groups or H
    arrays = (
        rng.standard_normal((B, L, H, P)).astype(np.float32) * 0.5,
        np.abs(rng.standard_normal((B, L, H)).astype(np.float32) * 0.1),
        -np.abs(rng.standard_normal((H,)).astype(np.float32)),
        rng.standard_normal((B, L, G, N)).astype(np.float32) * 0.3,
        rng.standard_normal((B, L, G, N)).astype(np.float32) * 0.3,
        np.zeros((H,), np.float32) if D_zero else rng.standard_normal((H,)).astype(np.float32),
    )
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


class TestSSDScanPlain:
    @pytest.mark.parametrize("B,L,H,P,N,chunk", SSD_SHAPES)
    def test_shapes_vs_pallas(self, B, L, H, P, N, chunk):
        jargs, targs = _ssd_inputs(np.random.default_rng(10), B, L, H, P, N)
        want = jax_ssd_scan(*jargs, chunk=chunk, interpret=True)
        got, _ = ssd_scan_ref(*targs)
        np.testing.assert_allclose(_np(got), _np(want), atol=SSD_TOL, rtol=SSD_TOL)
        np.testing.assert_allclose(_np(got), _np(jax_ssd_scan_ref(*jargs)), atol=SSD_TOL,
                                   rtol=SSD_TOL)

    def test_final_state_matches_sequential(self):
        """The port's final state == the Pallas kernel's == a numpy loop."""
        B, L, H, P, N = 1, 96, 2, 16, 8
        jargs, targs = _ssd_inputs(np.random.default_rng(11), B, L, H, P, N, D_zero=True)
        _, jh = jax_ssd_scan(*jargs, chunk=32, interpret=True, return_state=True)
        _, th = ssd_scan_ref(*targs)
        x, dt, a, Bm = (t.numpy() for t in targs[:4])
        hh = np.zeros((B, H, N, P), np.float32)
        for t in range(L):
            decay = np.exp(dt[:, t] * a[None, :])
            hh = hh * decay[..., None, None] + np.einsum("bhn,bh,bhp->bhnp", Bm[:, t], dt[:, t],
                                                         x[:, t])
        np.testing.assert_allclose(_np(th), hh, atol=SSD_TOL, rtol=SSD_TOL)
        np.testing.assert_allclose(_np(th), _np(jh), atol=SSD_TOL, rtol=SSD_TOL)

    @pytest.mark.parametrize("chunk", [16, 32, 64, 128])
    def test_chunk_invariance(self, chunk):
        """Every Pallas chunk size agrees with the one plain version."""
        jargs, targs = _ssd_inputs(np.random.default_rng(12), 1, 128, 2, 32, 16)
        want = jax_ssd_scan(*jargs, chunk=chunk, interpret=True)
        got, _ = ssd_scan(*targs, chunk=chunk)
        np.testing.assert_allclose(_np(got), _np(want), atol=SSD_CHUNK_TOL, rtol=SSD_CHUNK_TOL)

    def test_groups_read_in_place_equal_expanded_heads(self):
        """B and C with G groups == the same groups expanded to H heads
        with ``jnp.repeat`` (head h reads group h // (H / G)), on the Pallas
        kernel's pre-expanded API."""
        jargs, targs = _ssd_inputs(np.random.default_rng(13), 2, 50, 6, 8, 8, groups=3)
        expanded = [jnp.repeat(m, 2, axis=2) for m in jargs[3:5]]
        want = jax_ssd_scan(*jargs[:3], *expanded, jargs[5], chunk=16, interpret=True)
        got, _ = ssd_scan_ref(*targs)
        np.testing.assert_allclose(_np(got), _np(want), atol=SSD_TOL, rtol=SSD_TOL)

    def test_bfloat16_inputs_give_bfloat16_output(self):
        jargs, targs = _ssd_inputs(np.random.default_rng(14), 1, 64, 2, 16, 8)
        tb = [t.bfloat16() if t.dim() == 4 else t for t in targs]
        got, h = ssd_scan_ref(*tb)
        want, _ = ssd_scan_ref(*[t.float() for t in tb])
        assert got.dtype == torch.bfloat16 and h.dtype == torch.float32
        assert torch.equal(got, want.bfloat16())

    @pytest.mark.parametrize("chunk", [32, 64])
    def test_mamba2_regime_vs_pallas(self, chunk):
        """The inputs mamba2's mixer hands the scan - x, B, C after silu,
        dt = softplus(n) near 1, a = -(1..16) - where the log-decay inside a
        chunk reaches the hundreds: y and the final state agree at 5e-4."""
        rng = np.random.default_rng(19)
        B, L, H, P, N = 1, 200, 8, 16, 32

        def silu(v):
            return v / (1.0 + np.exp(-v))

        arrays = (
            silu(_randn(rng, (B, L, H, P))),
            np.log1p(np.exp(_randn(rng, (B, L, H)))),
            -np.linspace(1.0, 16.0, H, dtype=np.float32),
            silu(_randn(rng, (B, L, 1, N))).repeat(H, axis=2),
            silu(_randn(rng, (B, L, 1, N))).repeat(H, axis=2),
            _randn(rng, (H,)),
        )
        jargs = [jnp.asarray(a, jnp.float32) for a in arrays]
        targs = [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in arrays]
        want, want_h = jax_ssd_scan(*jargs, chunk=chunk, interpret=True, return_state=True)
        got, got_h = ssd_scan_ref(*targs)
        np.testing.assert_allclose(_np(got), _np(want), atol=SSD_TOL, rtol=SSD_TOL)
        np.testing.assert_allclose(_np(got_h), _np(want_h), atol=SSD_TOL, rtol=SSD_TOL)
        np.testing.assert_allclose(_np(got), _np(jax_ssd_scan_ref(*jargs)), atol=SSD_TOL,
                                   rtol=SSD_TOL)


ROUTER_SHAPES = [  # tests/test_kernels.py::TestMoERouter
    (64, 8, 2, 32),
    (256, 64, 6, 64),  # moonshot-like
    (128, 384, 8, 64),  # kimi-like expert count
    (100, 16, 4, 64),  # ragged T
    (32, 16, 2, 256),  # block > T
]


def _router_check(got, want):
    gi, gg, gs = (np.asarray(t) for t in got)
    wi, wg, ws = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_allclose(gg, wg, atol=GATE_TOL)


class TestMoERouterPlain:
    @pytest.mark.parametrize("T,E,k,bt", ROUTER_SHAPES)
    def test_vs_pallas(self, T, E, k, bt):
        logits = _randn(np.random.default_rng(15), (T, E))
        got = moe_router_ref(torch.from_numpy(logits), k)
        assert got[0].dtype == got[2].dtype == torch.int32 and got[1].dtype == torch.float32
        _router_check(got, jax_moe_router(jnp.asarray(logits), k=k, capacity=T, block_t=bt,
                                          interpret=True))
        _router_check(got, jax_moe_router_ref(jnp.asarray(logits), k, T))

    @pytest.mark.parametrize("bt", [16, 64])
    def test_exact_ties_go_to_the_lowest_id(self, bt):
        """Logits with many exact ties: ids (lowest id first), slots and
        gates equal the Pallas kernel's, across its token blocks."""
        logits = np.random.default_rng(16).integers(0, 3, (96, 16)).astype(np.float32)
        logits[:8] = 1.0  # rows with all experts tied
        got = moe_router_ref(torch.from_numpy(logits), 4)
        assert got[0][:8].tolist() == [[0, 1, 2, 3]] * 8
        _router_check(got, jax_moe_router(jnp.asarray(logits), k=4, capacity=96, block_t=bt,
                                          interpret=True))
        np.testing.assert_array_equal(np.asarray(got[0]),
                                      np.asarray(_route_top_k(torch.from_numpy(logits)[None], 4)[0][0]))

    def test_gates_normalized_and_slots_dense(self):
        logits = torch.from_numpy(_randn(np.random.default_rng(17), (128, 32)))
        ids, gates, slots = moe_router_ref(logits, 4)
        np.testing.assert_allclose(gates.sum(1).numpy(), 1.0, atol=1e-5)
        for e in range(32):  # per-expert slots are 0..count-1 (dense, no holes)
            s = sorted(slots[ids == e].tolist())
            assert s == list(range(len(s)))

    def test_agrees_with_layer_dispatch(self):
        """Plain-version slots == the gshard cumsum bookkeeping of the JAX
        ``moe_ffn`` (lax.top_k) and of the port's ``top_k`` twin."""
        T, E, k = 64, 8, 2
        logits = _randn(np.random.default_rng(18), (T, E))
        ids, _, slots = moe_router_ref(torch.from_numpy(logits), k)
        probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
        _, expert_ids = jax.lax.top_k(probs, k)
        onehot = jax.nn.one_hot(expert_ids, E, dtype=jnp.int32).reshape(T * k, E)
        pos = jnp.cumsum(onehot, axis=0) - onehot
        want_slots = (pos * onehot).sum(-1).reshape(T, k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(expert_ids))
        np.testing.assert_array_equal(slots.numpy(), np.asarray(want_slots))
        tids, _, tslots = _route_top_k(torch.from_numpy(logits)[None], k)
        assert torch.equal(tids[0].int(), ids) and torch.equal(tslots[0], slots)


class TestWrapperRouting:
    def test_flash_cpu_takes_plain_version(self):
        reset_launch_counts()
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(s, generator=g) for s in ((1, 96, 4, 32), (1, 96, 2, 32),
                                                           (1, 96, 2, 32)))
        got = flash_attention(q, k, v, causal=True, window=40)
        want = flash_attention_ref(q, k, v, causal=True, window=40)
        assert torch.equal(got, want)
        assert launch_counts() == NO_LAUNCHES

    def test_decode_cpu_takes_plain_version(self):
        reset_launch_counts()
        g = torch.Generator().manual_seed(1)
        q, k, v = (torch.randn(s, generator=g) for s in ((2, 4, 64), (2, 200, 2, 64),
                                                           (2, 200, 2, 64)))
        lens = torch.tensor([5, 200], dtype=torch.int32)
        got = decode_attention(q, k, v, lens, window=50, num_splits=4, block_s=64)
        want = decode_attention_ref(q, k, v, lens, window=50)
        assert torch.equal(got, want)
        assert launch_counts() == NO_LAUNCHES

    def test_ssd_scan_cpu_takes_plain_version(self):
        reset_launch_counts()
        args = _ssd_inputs(np.random.default_rng(20), 1, 40, 4, 8, 8, groups=2)[1]
        got_y, got_h = ssd_scan(*args, chunk=16)
        want_y, want_h = ssd_scan_ref(*args)
        assert torch.equal(got_y, want_y) and torch.equal(got_h, want_h)
        assert launch_counts() == NO_LAUNCHES

    def test_moe_router_cpu_takes_plain_version(self):
        reset_launch_counts()
        logits = torch.randn((50, 16), generator=torch.Generator().manual_seed(2))
        for got, want in zip(moe_router(logits, 4), moe_router_ref(logits, 4)):
            assert torch.equal(got, want)
        assert launch_counts() == NO_LAUNCHES

    def test_other_devices_raise(self):
        """No kernel and no plain fallback for a device that is neither CPU
        nor CUDA."""
        q = torch.empty((1, 64, 4, 64), device="meta")
        k = torch.empty((1, 64, 2, 64), device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            flash_attention(q, k, k)
        with pytest.raises(ValueError, match="no kernel"):
            decode_attention(q[:, 0], k, k, torch.empty((1,), dtype=torch.int32, device="meta"))
        h = torch.empty((4,), device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            ssd_scan(q, q[..., 0], h, k, k, h)
        with pytest.raises(ValueError, match="no kernel"):
            moe_router(torch.empty((8, 16), device="meta"), 2)

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


class TestFlashTiles:
    """The forward's tiles by dtype (``ops.resolve_tile``) and the bf16
    route's sources: bf16 reaches only the Hopper wgmma kernels."""

    @pytest.mark.parametrize("dtype,want", [(torch.bfloat16, (128, 128)),
                                            (torch.float32, (64, 64))])
    def test_default_tile_by_dtype(self, dtype, want):
        from repro_torch.kernels.flash_attention.ops import resolve_tile

        assert resolve_tile(dtype, 128) == want

    @pytest.mark.parametrize("dtype,tile", [
        (torch.bfloat16, (128, 128)), (torch.bfloat16, (128, 64)),
        (torch.float32, (64, 64)), (torch.float32, (64, 32)), (torch.float32, (128, 32)),
        (torch.float32, (128, 64)),
    ])
    def test_each_dtype_takes_its_tiles(self, dtype, tile):
        from repro_torch.kernels.flash_attention.kernel import TILES
        from repro_torch.kernels.flash_attention.ops import resolve_tile

        assert tile in TILES[dtype]
        assert resolve_tile(dtype, 64, *tile) == tile

    @pytest.mark.parametrize("dtype,tile", [
        # the first version's bf16 WMMA tiles, and other shapes
        (torch.bfloat16, (64, 64)), (torch.bfloat16, (64, 32)), (torch.bfloat16, (128, 32)),
        (torch.bfloat16, (256, 128)), (torch.bfloat16, (128, 256)),
        (torch.float32, (128, 128)), (torch.float32, (32, 32)),
    ])
    def test_other_tiles_are_refused(self, dtype, tile):
        from repro_torch.kernels.flash_attention.ops import resolve_tile

        with pytest.raises(ValueError, match="block_q, block_k"):
            resolve_tile(dtype, 64, *tile)

    def test_f32_tile_over_shared_memory_is_refused(self):
        from repro_torch.kernels.flash_attention.ops import resolve_tile

        assert resolve_tile(torch.float32, 64, 128, 64) == (128, 64)
        with pytest.raises(ValueError, match="D=128"):
            resolve_tile(torch.float32, 128, 128, 64)

    def test_one_block_size_given_fills_the_other_from_the_default(self):
        from repro_torch.kernels.flash_attention.ops import resolve_tile

        assert resolve_tile(torch.bfloat16, 128, block_k=64) == (128, 64)
        assert resolve_tile(torch.float32, 128, block_k=32) == (64, 32)
        with pytest.raises(TypeError):
            resolve_tile(torch.float16, 128)

    @pytest.mark.parametrize("source", ["flash_attention.cu", "flash_attention_bwd.cu"])
    def test_flash_sources_have_no_wmma_route(self, source):
        """The bf16 flash calls launch only the wgmma kernels: neither source
        issues a WMMA product or instantiates the f32 tile step for bf16."""
        from repro_torch.kernels import _build

        text = (_build.CSRC / source).read_text()
        for token in ("wmma::", "mma_sync", "load_matrix_sync", "attend_rows<T",
                      "attend_rows<bf16", "nvcuda"):
            assert token not in text, token
        assert "wgmma" in (_build.CSRC / "sm90.cuh").read_text()
        assert '#include "sm90.cuh"' in text

    @pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd"])
    def test_library_path_follows_the_sm90_header(self, name, tmp_path, monkeypatch):
        """An edit of csrc/sm90.cuh rebuilds both flash libraries."""
        import shutil

        from repro_torch.kernels import _build

        csrc = tmp_path / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        monkeypatch.setattr(_build, "CSRC", csrc)
        before = _build.library_path(name)
        assert before == _build.library_path(name)
        (csrc / "sm90.cuh").write_text((csrc / "sm90.cuh").read_text() + "\n// edited\n")
        assert _build.library_path(name) != before
