"""Per-architecture smoke tests of the port, the twin of
``tests/test_models_smoke.py``: for each of the 10 architectures a reduced
config of the same family (``scaled_down()``) runs one forward, one train
step, five train steps on one batch and a few decode steps on the CPU;
shapes are right, nothing is NaN, the parameters move and the loss falls.
The batches are those of JAX's ``launch/specs.py``: tokens and labels, plus
``enc_embeds`` for the enc-dec family and ``embeds`` with (B, S, 3)
positions in place of tokens for the VLM family."""
import pytest

pytest.importorskip("torch")
import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import EncDecModel, build_model
from repro_torch.serve import make_serve_step
from repro_torch.train import AdamWConfig, init_train_state, make_train_step

B, SEQ = 2, 64


def tiny_batch(cfg, rng):
    """Integer entries from [1, vocab), float entries standard normal, as
    the JAX smoke test fills the specs."""
    shapes = {"labels": ((B, SEQ), np.int32)}
    if cfg.family == "encdec":
        shapes["enc_embeds"] = ((B, cfg.encoder_seq, cfg.d_model), np.float32)
    if cfg.family == "vlm":
        shapes["embeds"] = ((B, SEQ, cfg.d_model), np.float32)
        shapes["positions"] = ((B, SEQ, 3), np.int32)
    else:
        shapes["tokens"] = ((B, SEQ), np.int32)
    batch = {}
    for k, (shape, dt) in sorted(shapes.items()):
        if dt == np.int32:
            batch[k] = torch.from_numpy(rng.integers(1, cfg.vocab_size, shape).astype(dt))
        else:
            batch[k] = torch.from_numpy(rng.standard_normal(shape).astype(dt))
    return batch


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch_setup(request):
    cfg = get_config(request.param).scaled_down()
    model = build_model(cfg)
    return request.param, cfg, model


def _state(model):
    return init_train_state(model, 0, AdamWConfig(), device="cpu")


class TestPerArchSmoke:
    def test_forward_shapes_and_finite(self, arch_setup):
        arch, cfg, model = arch_setup
        batch = tiny_batch(cfg, np.random.default_rng(0))
        with torch.no_grad():
            logits = model.forward(_state(model)["params"], batch)
        assert logits.shape == (B, SEQ, cfg.vocab_size)
        assert logits.dtype == torch.float32  # cfg.logits_fp32
        assert bool(torch.isfinite(logits).all())

    def test_train_step_updates_and_finite(self, arch_setup):
        arch, cfg, model = arch_setup
        batch = tiny_batch(cfg, np.random.default_rng(1))
        state = _state(model)
        before = [t.clone() for t in _leaves(state["params"])]
        state, metrics = make_train_step(model, AdamWConfig())(state, batch)
        assert bool(torch.isfinite(metrics["loss"]))
        assert float(metrics["loss"]) > 0
        assert int(state["opt"]["step"]) == 1
        assert any(not torch.equal(a, b) for a, b in zip(before, _leaves(state["params"])))

    def test_loss_decreases_over_steps(self, arch_setup):
        arch, cfg, model = arch_setup
        batch = tiny_batch(cfg, np.random.default_rng(2))  # overfit one fixed batch
        step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1))
        state, losses = _state(model), []
        for _ in range(5):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        assert losses[-1] < losses[0], f"{arch}: no learning signal {losses}"

    def test_decode_step_finite(self, arch_setup):
        arch, cfg, model = arch_setup
        params = _state(model)["params"]
        if isinstance(model, EncDecModel):
            enc = torch.from_numpy(np.random.default_rng(3).standard_normal(
                (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
            cache = model.init_cache(params, B, 32, enc_embeds=enc)
            logits, cache = model.decode_step(params, cache, torch.zeros((B,), dtype=torch.int32))
            assert logits.shape == (B, cfg.vocab_size)
            assert bool(torch.isfinite(logits).all())
            return
        cache = model.init_cache(B, 32, device="cpu")
        step = make_serve_step(model)
        toks = torch.ones((B,), dtype=torch.int32)
        with torch.no_grad():
            for _ in range(4):
                toks, cache = step(params, cache, toks)
        assert toks.shape == (B,)
        assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
