"""The port's serving engine against the JAX package's.

Same weights (JAX init carried across by ``repro_torch.bridge``), same
requests: greedy decoding must give the same tokens.  Logits agree to about
1e-6 in f32 (``test_torch_models.py``), far below the gaps between the top
two logits here, so argmax agrees exactly.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine, make_serve_step

PROMPTS = [([5, 6, 7], 6), ([9, 10], 5), ([11, 3, 8, 200, 17], 4), ([42], 7)]


@pytest.mark.parametrize("arch", ["starcoder2-3b", "mamba2-2.7b", "moonshot-v1-16b-a3b"])
def test_serve_engine_tokens_match_jax(arch):
    """Dense, SSM (state in the cache) and MoE (dropless decode) families."""
    jm = jax_build_model(jax_get_config(arch).scaled_down())
    tm = build_model(get_config(arch).scaled_down())
    jp = jm.init(jax.random.PRNGKey(1))
    tp = params_from_jax(jax.device_get(jp), like=tm.init(0, device="cpu"))
    want = JaxServeEngine(jm, jp, batch_size=4, max_seq=64).run(
        [JaxRequest(prompt=list(p), max_new_tokens=n) for p, n in PROMPTS])
    got = ServeEngine(tm, tp, batch_size=4, max_seq=64, device="cpu").run(
        [Request(prompt=list(p), max_new_tokens=n) for p, n in PROMPTS])
    assert [r.generated for r in got] == [r.generated for r in want]
    for r, (_, n) in zip(got, PROMPTS):
        assert r.done and len(r.generated) == n
        assert all(0 <= t < tm.cfg.vocab_size for t in r.generated)


def test_serve_step_is_pure():
    """Same params, same tokens, fresh cache -> same next tokens (the JAX
    step is pure; the port's updates its cache in place)."""
    cfg = get_config("qwen3-14b").scaled_down()
    model = build_model(cfg)
    params = model.init(2, device="cpu")
    step = make_serve_step(model)
    toks = torch.ones((2,), dtype=torch.int32)
    t1, cache1 = step(params, model.init_cache(2, 32, device="cpu"), toks)
    t2, _ = step(params, model.init_cache(2, 32, device="cpu"), toks)
    assert t1.dtype == torch.int32 and torch.equal(t1, t2)
    assert cache1["pos"] == 1


def test_engine_rejects_more_steps_than_its_cache():
    model = build_model(get_config("starcoder2-3b").scaled_down())
    eng = ServeEngine(model, model.init(0, device="cpu"), batch_size=1, max_seq=8,
                      device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.run([Request(prompt=[1, 2, 3, 4], max_new_tokens=6)])


@pytest.mark.parametrize("entry", ["init", "init_cache", "engine"])
def test_no_device_without_cuda_raises(entry, monkeypatch):
    """With no device= and no CUDA device, entry points raise instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_config("starcoder2-3b").scaled_down())
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "init":
            model.init(0)
        elif entry == "init_cache":
            model.init_cache(1, 8)
        else:
            ServeEngine(model, model.init(0, device="cpu"), batch_size=1, max_seq=8)
