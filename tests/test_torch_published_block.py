"""StarCoder2's published block on the port (``norm_type="layer"``,
``use_bias``, a tied head, a window shorter than the sequence) against the
benchmark's plain dense reference (``portbench/families/dense.py``: plain
PyTorch in f32, which imports nothing of the port) on weights drawn from a
seed by the reference's own rules: the loss and every leaf's gradient, and
prefill then decode through the cache against the full forward.  Also the
embedding lookup's f32 gradient, the new leaves' sharding rules and the dry
run's count of them.  Everything runs on the CPU at a tiny size, the port's
kernel route (``attn_impl="pallas"``: the kernels' plain versions)."""
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import reference  # noqa: E402
from portbench.bench.layout import load_module  # noqa: E402
from repro_torch.bridge import flatten_with_paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.train.step import cross_entropy  # noqa: E402

DENSE = load_module("families", "dense")
FILE = json.loads((ROOT / "portbench" / "configs" / "starcoder2-3b.json").read_text())
# the configuration file's published block at tiny widths; window 8 < S
TINY = dict(FILE["model"], num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, attn_window=8)
B, S = 2, 24
SEED = 2 ** 31 + 29
Z_LOSS = 1e-4
LOSS_RTOL = 1e-6  # f32 against f32
GRAD_TOL = 1e-4  # of the leaf's largest entry: f32 against f32, as -k step_one holds JAX
LOGIT_TOL = 1e-5  # of the largest logit: decode's order of sums against the forward's


def port_config(m=TINY, **changes) -> ModelConfig:
    """The port's starcoder2-3b with every number of ``m`` it has a field
    for, computed in f32 (as ``portbench/drivers/train.py``'s ``port_config`` builds it)."""
    fields = set(ModelConfig.__dataclass_fields__)
    given = {**{k: v for k, v in m.items() if k in fields}, "dtype": "float32", **changes}
    return get_config("starcoder2-3b").replace(**given)


def seeded(m=TINY):
    """(leaf table, the flat f32 buffer of the weights the reference draws
    from ``SEED``)."""
    table = reference.LeafTable(DENSE.leaf_shapes(m))
    return table, reference.make_flat(table, SEED, "cpu", DENSE.init_rules(m))


def leaves(table, flat):
    """{path: leaf}, each a view of ``flat``."""
    return {path: flat[off:off + n].view(shape) for path, shape, _, off, n in table.entries}


def batch():
    g = torch.Generator().manual_seed(7)
    ids = torch.randint(1, TINY["vocab_size"], (B, S + 1), generator=g)
    return ids[:, :-1], ids[:, 1:]


def test_the_layout_is_the_references():
    table = reference.LeafTable(DENSE.leaf_shapes(TINY))
    got = {p: tuple(t.shape) for p, t in
           flatten_with_paths(build_model(port_config()).init(device="meta"))}
    assert got == table.shapes()
    assert "lm_head" not in got and "final_norm_bias" in got


def test_loss_and_every_gradient_match_the_reference():
    table, flat = seeded()
    tokens, labels = batch()
    mine, ref = flat.clone().requires_grad_(True), flat.clone().requires_grad_(True)
    model = build_model(port_config(remat="none"))
    logits = model.forward(reference.tree_of(table, mine), {"tokens": tokens})
    loss, _ = cross_entropy(logits, labels, Z_LOSS)
    loss.backward()
    want = DENSE.loss(leaves(table, ref), tokens, labels, TINY, Z_LOSS, "float32",
                      reference.loss_mask(labels, None))
    want.backward()
    assert float(loss.detach()) == pytest.approx(float(want.detach()), rel=LOSS_RTOL)
    got_grads, want_grads = leaves(table, mine.grad), leaves(table, ref.grad)
    for path in got_grads:
        g, w = got_grads[path], want_grads[path]
        scale = float(w.abs().max())
        assert scale > 0, path
        assert float((g - w).abs().max()) <= GRAD_TOL * scale, path


def test_prefill_then_decode_matches_the_full_forward():
    """Token by token through the cache (the serving path: ``ServeEngine``
    prefills by decoding) against the forward over the whole sequence, past
    the window."""
    table, flat = seeded()
    tokens, _ = batch()
    model = build_model(port_config())
    params = model.cast_for_compute(reference.tree_of(table, flat))
    with torch.no_grad():
        full = model.forward(params, {"tokens": tokens})
        cache = model.init_cache(B, S, device="cpu")
        steps = []
        for t in range(S):
            logits, cache = model.decode_step(params, cache, tokens[:, t])
            steps.append(logits)
    got = torch.stack(steps, dim=1)
    assert float((got - full).abs().max()) <= LOGIT_TOL * float(full.abs().max())


def test_the_biases_shifts_and_window_each_change_the_function():
    """The weights the check draws make each part of the block count: with
    any of them taken away the port's loss moves ten times the loss's
    tolerance or more."""
    table, flat = seeded()
    tokens, labels = batch()

    def loss_of(cfg, flat):
        with torch.no_grad():
            logits = build_model(cfg).forward(reference.tree_of(table, flat),
                                              {"tokens": tokens})
            return float(cross_entropy(logits, labels, Z_LOSS)[0])

    base = loss_of(port_config(), flat)
    for name in ("attn/bo", "mlp/b1", "ln1_bias"):
        cut = flat.clone()
        leaves(table, cut)[f"group0/0/{name}"].zero_()
        assert abs(loss_of(port_config(), cut) - base) > 10 * LOSS_RTOL * abs(base), name
    for window in (0, TINY["attn_window"] + 1):
        moved = abs(loss_of(port_config(attn_window=window), flat) - base)
        assert moved > 10 * LOSS_RTOL * abs(base), window


def test_embedding_gradient_of_repeated_ids_adds_in_f32():
    """One id at most positions: the lookup's gradient (the sum of each
    row's bf16 output gradients) within 1e-3 of the f64 sum.  Gathered
    after a bf16 cast of the table, the sum would be added in bf16 and stall
    far from it; the test checks that it does, so that it can tell."""
    g = torch.Generator().manual_seed(3)
    table = torch.randn(64, 32, generator=g)
    tokens = torch.where(torch.rand(2, 4096, generator=g) < 0.9, 5,
                         torch.randint(0, 64, (2, 4096), generator=g))
    grad_out = torch.randn(2, 4096, 32, generator=g).to(torch.bfloat16)
    want = torch.zeros(64, 32, dtype=torch.float64).index_add_(
        0, tokens.reshape(-1), grad_out.reshape(-1, 32).double())

    def gap(lookup):
        t = table.clone().requires_grad_(True)
        lookup(t).backward(grad_out)
        return float((t.grad.double() - want).abs().max() / want.abs().max())

    assert gap(lambda t: layers.embed_lookup(t, tokens, torch.bfloat16)) <= 1e-3
    assert gap(lambda t: t.to(torch.bfloat16)[tokens]) > 1e-2


def test_sharding_rules_of_the_new_leaves():
    """On the production mesh (data 16 x model 16): a bias follows its
    weight's output split, a LayerNorm's scale and shift replicate."""
    from repro_torch.dist import P
    from repro_torch.dist import sharding_rules as SR
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_plan, make_production_mesh

    cfg = get_config("starcoder2-3b").replace(norm_type="layer", norm_eps=1e-5, use_bias=True)
    mesh = make_production_mesh()
    plan = make_plan(mesh)
    sh = dict(flatten_with_paths(SR.make_param_shardings(
        mesh, SP.params_shape(build_model(cfg)), cfg, plan)))
    fsdp = plan.fsdp_axes[0] if len(plan.fsdp_axes) == 1 else tuple(plan.fsdp_axes)
    want = {"attn/wq": P(None, fsdp, "model"), "attn/bq": P(None, "model"),
            "attn/bk": P(None, "model"), "attn/bv": P(None, "model"),
            "attn/wo": P(None, "model", fsdp), "attn/bo": P(None, fsdp),
            "mlp/b1": P(None, "model"), "mlp/b2": P(None, fsdp),
            "ln1": P(), "ln1_bias": P(), "ln2": P(), "ln2_bias": P()}
    for leaf, spec in want.items():
        assert sh[f"group0/0/{leaf}"].spec == spec, leaf
    assert sh["final_norm"].spec == P() and sh["final_norm_bias"].spec == P()


def test_the_dry_run_counts_the_new_leaves():
    """The parameter count (6 N D) and the dry run's train arguments (f32
    weights and both AdamW moments) take the biases and shifts in: the
    published block against the same config without them."""
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig

    block = dict(norm_type="layer", norm_eps=1e-5, use_bias=True, tie_embeddings=True)
    plain = dict(block, norm_type="rms", use_bias=False)

    def numel(changes):
        cfg = get_config("starcoder2-3b").replace(**changes)
        return sum(t.numel() for _, t in flatten_with_paths(build_model(cfg).init(device="meta")))

    cfgs = [get_config("starcoder2-3b").replace(**c) for c in (block, plain)]
    added = numel(block) - numel(plain)
    L, d = 30, 3072
    assert added == L * (3072 + 2 * 256 + 3072 + 12288 + 3072) + L * 2 * d + d
    # param_counts leaves the final norm out, as the JAX count does
    assert cfgs[0].param_counts()["total"] - cfgs[1].param_counts()["total"] == added - d
    sh = ShapeConfig("t", 64, 1, "train")
    mem = [dryrun.run_cell("starcoder2-3b", sh, replace=c)["roofline"]["memory_per_device_bytes"]
           for c in (block, plain)]
    assert mem[0]["argument_bytes"] - mem[1]["argument_bytes"] == 12 * added
