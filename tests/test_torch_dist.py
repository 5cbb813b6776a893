"""The port's distribution layer (``repro_torch.dist``, ``launch/mesh.py``,
the feeder's mesh path and the dry run's production meshes) against the JAX
package's ``repro.dist``.

* The sharding rules at production sizes, for all 10 architectures: the
  port's specs equal JAX's ``PartitionSpec`` for every leaf of the params,
  the optimizer state, the train / prefill / decode inputs and the decode
  caches, on abstract (16, 16) and (2, 16, 16) meshes (shapes only, no
  tensor), and the per-device bytes equal the sum of JAX's shard shapes.
* ``plan_spec`` and ``shard_activations``; the twins of
  ``tests/test_dist.py::TestShardingRules`` and of
  ``tests/test_compression.py``.
* The feeder's mesh path on 4 gloo ranks of a (2, 2) mesh, the twin of
  ``tests/test_feed.py::TestShardedPlacement``; ``compressed_psum`` on 2
  gloo ranks.  Every multi-rank test spawns its ranks (``torch_dist_ranks``),
  joins them and destroys its process group.
* The dry run on the production meshes and the launcher's mesh flags.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("hypothesis")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JaxNamedSharding  # noqa: E402

import torch_dist_ranks as ranks  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.dist import compression as jax_comp  # noqa: E402
from repro.dist import context as jax_ctx  # noqa: E402
from repro.dist import sharding_rules as JSR  # noqa: E402
from repro.launch import mesh as jax_mesh  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.config import SHAPES as JAX_SHAPES  # noqa: E402
from repro.models.config import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch.bridge import flatten_with_paths, params_from_jax  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.dist import AbstractMesh, NamedSharding, P, ShardingPlan  # noqa: E402
from repro_torch.dist import compression as C  # noqa: E402
from repro_torch.dist import context as ctx  # noqa: E402
from repro_torch.dist import sharding_rules as SR  # noqa: E402
from repro_torch.dist.placement import place_tree, placements, shard_slices  # noqa: E402
from repro_torch.feed import DeviceFeeder  # noqa: E402
from repro_torch.feed.sharded import infer_batch_shardings  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import make_plan, make_production_mesh, make_test_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.train import AdamWConfig, apply_updates, init_state, make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
DECODE_SHAPE = "decode_32k"
TRAIN_TOL = 1e-4  # tests/test_torch_train.py's TRAJ_TOL


def _jax_mesh(name):
    return JaxAbstractMesh(*MESHES[name])


def _port_mesh(name):
    return make_production_mesh(multi_pod=name == "multi")


def _jax_flat(tree):
    """{key: leaf} of a JAX tree, keys as ``bridge.flatten_with_paths``
    writes them (dict keys sorted, list items by index)."""
    out = {}
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxNamedSharding))
    for path, leaf in leaves:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path)] = leaf
    return out


def _specs(flat):
    return {k: tuple(v.spec) for k, v in flat.items()}


def _port_specs(tree):
    return {k: tuple(v.spec) for k, v in flatten_with_paths(tree)}


def _jax_shard_bytes(values, shardings, like):
    """Sum of JAX's ``NamedSharding.shard_shape`` bytes over the leaves that
    are tensors in the port's tree ``like`` (the port keeps a decode cache's
    ``pos`` as a host int, JAX as an int32 array)."""
    vals, shs = _jax_flat(values), _jax_flat(shardings)
    keys = {k for k, v in flatten_with_paths(like) if isinstance(v, torch.Tensor)}
    assert keys <= vals.keys()
    return sum(math.prod(shs[k].shard_shape(vals[k].shape)) * np.dtype(vals[k].dtype).itemsize
               for k in keys)


@pytest.fixture
def mesh11(tmp_path):
    """A (1, 1) ``DeviceMesh`` over a world of one gloo rank (this
    process), destroyed after the test (the partitioned dry run makes a
    process group of its own)."""
    import torch.distributed as dist

    init = tmp_path / "gloo_init"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0, world_size=1)
    try:
        yield make_test_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, *args):
    """Runs ``fn(rank, world, *args)`` in ``world`` spawned processes and
    joins them (raising if one failed)."""
    import torch.multiprocessing as mp

    mp.start_processes(fn, args=(world,) + args, nprocs=world, join=True, start_method="spawn")


def ranks_pipeline(n):
    from repro.data import Dataset

    return Dataset.range(n).map(ranks.row).batch(4, drop_remainder=True)


def _read_ranks(out_dir, world):
    return [json.loads((Path(out_dir) / f"rank{r}.json").read_text()) for r in range(world)]


# ---------------------------------------------------------------------------
# the rules against JAX at production sizes (shapes only)
# ---------------------------------------------------------------------------
_JAX_SHAPES = {}


def _jax_trees(arch):
    """JAX's params, opt state, input specs and decode cache of the full
    config, as ShapeDtypeStructs (built once per architecture)."""
    if arch not in _JAX_SHAPES:
        cfg = jax_config(arch)
        model = jax_build(cfg)
        pshape = jax_specs.params_shape(model)
        oc = jax_opt.AdamWConfig(state_dtype=cfg.opt_state_dtype)
        oshape = jax.eval_shape(lambda: jax_opt.init_state(pshape, oc))
        inputs = {"train": jax_specs.train_input_specs(cfg, JAX_SHAPES["train_4k"]),
                  "prefill": jax_specs.prefill_input_specs(cfg, JAX_SHAPES["prefill_32k"])}
        tok, cache = jax_specs.decode_input_specs(model, cfg, JAX_SHAPES[DECODE_SHAPE])
        inputs["decode"] = tok
        _JAX_SHAPES[arch] = (cfg, pshape, oshape, inputs, cache)
    return _JAX_SHAPES[arch]


def _port_trees(arch):
    cfg = get_config(arch)
    model = build_model(cfg)
    oc = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    inputs = {"train": S.train_input_specs(cfg, SHAPES["train_4k"]),
              "prefill": S.prefill_input_specs(cfg, SHAPES["prefill_32k"])}
    tok, cache = S.decode_input_specs(model, cfg, SHAPES[DECODE_SHAPE])
    inputs["decode"] = tok
    return cfg, S.params_shape(model), S.opt_shape(model, oc), inputs, cache


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_equal_jax_at_production_sizes(arch, mesh_name):
    """Every leaf's spec of the params (with and without FSDP over the pod
    axis), the opt state, the inputs and the decode cache equals JAX's, and
    the per-device bytes of each tree equal the sum of JAX's shard shapes."""
    jcfg, jp, jo, jin, jcache = _jax_trees(arch)
    cfg, tp, to, tin, tcache = _port_trees(arch)
    jm, tm = _jax_mesh(mesh_name), _port_mesh(mesh_name)
    for fsdp_over_pod in (False, True):
        jplan = jax_mesh.make_plan(jm, fsdp_over_pod=fsdp_over_pod)
        tplan = make_plan(tm, fsdp_over_pod=fsdp_over_pod)
        assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
        pairs = [(JSR.make_param_shardings(jm, jp, jcfg, jplan),
                  SR.make_param_shardings(tm, tp, cfg, tplan), jp, tp),
                 (JSR.make_opt_shardings(jm, jo, jcfg, jplan),
                  SR.make_opt_shardings(tm, to, cfg, tplan), jo, to),
                 (JSR.cache_sharding(jm, jplan, jcache, jcfg),
                  SR.cache_sharding(tm, tplan, tcache, cfg), jcache, tcache)]
        for kind in ("train", "prefill", "decode"):
            pairs.append((JSR.batch_sharding(jm, jplan, jin[kind]),
                          SR.batch_sharding(tm, tplan, tin[kind]), jin[kind], tin[kind]))
        for jsh, tsh, jtree, ttree in pairs:
            want, got = _specs(_jax_flat(jsh)), _port_specs(tsh)
            assert got.keys() == want.keys()
            bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
            assert not bad, list(bad.items())[:5]
            assert SR.sharded_nbytes(ttree, tsh) == _jax_shard_bytes(jtree, jsh, ttree)


def test_qwen3_embed_spec_on_the_single_pod_mesh():
    """The example of the rules' reference: qwen3-14b's embedding shards
    vocab over the model axis and d_model over data, a (9496, 320) shard;
    a stacked 1-D ``q_norm`` (L, hd) takes the generic split."""
    cfg = get_config("qwen3-14b")
    mesh = make_production_mesh()
    sh = SR.make_param_shardings(mesh, S.params_shape(build_model(cfg)), cfg, make_plan(mesh))
    assert sh["embed"].spec == P("model", "data")
    assert sh["embed"].shard_shape((cfg.vocab_size, cfg.d_model)) == (9496, 320)
    q_norm = [v for k, v in flatten_with_paths(sh) if k.endswith("attn/q_norm")]
    assert q_norm and all(s.spec == P(None, "model") for s in q_norm)


# ---------------------------------------------------------------------------
# plan_spec and shard_activations
# ---------------------------------------------------------------------------
PLAN_CASES = [
    ("bsd", {}, (32, 64, 48)),
    ("bsd", {"seq_axis": "model"}, (32, 64, 48)),
    ("gtd", {}, (16, 8, 48)),
    ("gecd", {}, (16, 32, 4, 48)),
    ("gecd", {"moe_pin": "group"}, (16, 32, 4, 48)),
    ("gecd", {"moe_pin": "group_ep"}, (16, 32, 4, 48)),
    ("gecd", {"moe_expert_axis": "data"}, (16, 32, 4, 48)),  # data used twice: E replicates
    ("gecd", {"moe_pin": "group_ep", "moe_expert_axis": "data"}, (16, 32, 4, 48)),
    ("bhsd", {"seq_axis": "model"}, (32, 16, 64, 8)),  # model used twice: s replicates
    ("bsh", {}, (32, 64, 7)),  # 7 heads: indivisible, replicate
    ("bsd", {}, (6, 64, 48)),  # 6 rows over 16: indivisible
    ("tcxd", {}, (4, 4, 4, 4)),  # roles without an axis
]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("roles,changes,shape", PLAN_CASES)
def test_plan_spec_equals_jax(roles, changes, shape, mesh_name):
    jm, tm = _jax_mesh(mesh_name), _port_mesh(mesh_name)
    jplan = dataclasses.replace(jax_mesh.make_plan(jm), **changes)
    tplan = dataclasses.replace(make_plan(tm), **changes)
    assert tuple(ctx.plan_spec(roles, tplan, shape, tm)) == tuple(
        jax_ctx.plan_spec(roles, jplan, shape, jm))
    assert tuple(ctx.plan_spec(roles, tplan)) == tuple(jax_ctx.plan_spec(roles, jplan))


def test_shard_activations_is_the_identity_without_a_plan_or_on_one_device(mesh11):
    x = torch.randn(2, 4, 8)
    assert ctx.shard_activations(x, "bsd") is x
    plan = make_plan(mesh11)
    with ctx.use_plan(plan):  # a plan with no mesh
        assert ctx.shard_activations(x, "bsd") is x
    for mesh in (mesh11, AbstractMesh((1, 1), ("data", "model"))):
        with ctx.use_plan(plan, mesh):
            assert ctx.current_plan() is plan and ctx.current_mesh() is mesh
            assert ctx.shard_activations(x, "bsd") is x
    assert ctx.current_plan() is None and ctx.current_mesh() is None
    with ctx.use_plan(plan, make_production_mesh()):
        with pytest.raises(ValueError, match="roles"):
            ctx.shard_activations(x, "bd")
        assert ctx.shard_activations(x, "bsd") is x  # a plain tensor: this rank's own data


FAMILY_ARCHS = ["deepseek-7b", "moonshot-v1-16b-a3b", "mamba2-2.7b", "jamba-v0.1-52b",
                "qwen2-vl-2b", "whisper-large-v3"]


def _family_batch(cfg, rng, B=2, S_=16):
    batch = {}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["embeds"] = torch.from_numpy(
            rng.standard_normal((B, S_, cfg.d_model)).astype(np.float32))
        batch["positions"] = torch.from_numpy(
            rng.integers(0, S_, (B, S_, 3)).astype(np.int32))
    else:
        batch["tokens"] = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S_)))
    return batch


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_with_a_plan_on_one_device_is_bit_equal(arch, mesh11, monkeypatch):
    """A plan over a (1, 1) mesh changes nothing: the logits are bit-equal
    to those with no plan, and the hooks ran with their roles."""
    cfg = get_config(arch).scaled_down()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = _family_batch(cfg, np.random.default_rng(0))
    with torch.no_grad():
        want = model.forward(params, batch)
        roles = []
        real = ctx.shard_activations

        def spy(x, r):
            roles.append(r)
            return real(x, r)

        for mod in ("repro_torch.models.lm", "repro_torch.models.layers",
                    "repro_torch.models.encdec"):
            monkeypatch.setattr(f"{mod}.shard_activations", spy)
        with ctx.use_plan(make_plan(mesh11), mesh11):
            got = model.forward(params, batch)
    assert torch.equal(got, want)
    assert "bsd" in roles and (cfg.family != "moe" or {"gtd", "gecd"} <= set(roles))


# ---------------------------------------------------------------------------
# twins of tests/test_dist.py::TestShardingRules
# ---------------------------------------------------------------------------
class TestShardingRules:
    def test_param_specs_cover_all_leaves(self, mesh11):
        plan = make_plan(mesh11)
        for arch in ("qwen3-14b", "kimi-k2-1t-a32b", "mamba2-2.7b", "jamba-v0.1-52b",
                     "whisper-large-v3"):
            cfg = get_config(arch).scaled_down()
            pshape = S.params_shape(build_model(cfg))
            shardings = SR.make_param_shardings(mesh11, pshape, cfg, plan)
            keys = [k for k, _ in flatten_with_paths(pshape)]
            got = dict(flatten_with_paths(shardings))
            assert sorted(got) == sorted(keys)
            assert all(isinstance(s, NamedSharding) for s in got.values())

    def test_indivisible_dims_fall_back_to_replication(self, mesh11):
        plan = ShardingPlan(data_axes=("data",), model_axis="model", fsdp_axis="data",
                            seq_axis=None)
        cfg = get_config("qwen3-14b").scaled_down()
        leaf = torch.empty((7, 13), device="meta")
        spec = SR.param_spec(("attn", "wq"), leaf, cfg, plan, mesh11)
        assert spec is not None and spec.spec == P("data", "model")  # 1 divides everything
        wide = AbstractMesh((4, 4), ("data", "model"))
        assert SR.param_spec(("attn", "wq"), leaf, cfg, plan, wide).spec == P()
        assert tuple(SR.param_spec(("attn", "wq"), leaf, cfg, plan, wide).spec) == tuple(
            JSR.param_spec((jax.tree_util.DictKey("attn"), jax.tree_util.DictKey("wq")),
                           jax.ShapeDtypeStruct((7, 13), jnp.float32), jax_config("qwen3-14b"),
                           jax_ctx.ShardingPlan(), JaxAbstractMesh((4, 4), ("data", "model"))
                           ).spec)

    def test_train_step_runs_sharded_on_test_mesh(self, mesh11):
        """The state placed by the rules on a (1, 1) DeviceMesh and a step
        under the plan: loss and updated params equal the unsharded port
        step's; the loss is within the train tests' tolerance of JAX's
        jitted step with explicit shardings on its (1, 1) mesh."""
        from repro.launch import specs as JS
        from repro.train import AdamWConfig as JAdamW
        from repro.train import init_train_state as jax_init_state
        from repro.train import make_train_step as jax_make_step

        jcfg = jax_config("deepseek-7b").scaled_down()
        jmodel = jax_build(jcfg)
        jstate = jax_init_state(jmodel, jax.random.PRNGKey(0), JAdamW())
        jm = jax_mesh.make_test_mesh(1, 1)
        jplan = jax_mesh.make_plan(jm)
        in_specs = JS.train_input_specs(jcfg, JaxShapeConfig("t", 32, 2, "train"))
        state_shard = {"params": JSR.make_param_shardings(jm, jstate["params"], jcfg, jplan),
                       "opt": JSR.make_opt_shardings(jm, jstate["opt"], jcfg, jplan)}
        rng = np.random.default_rng(0)
        tokens = rng.integers(1, jcfg.vocab_size, (2, 32))
        labels = rng.integers(1, jcfg.vocab_size, (2, 32))
        with jm:
            jstep = jax.jit(jax_make_step(jmodel, JAdamW()),
                            in_shardings=(state_shard, JSR.batch_sharding(jm, jplan, in_specs)))
            _, jmetrics = jstep(jstate, {"tokens": jnp.asarray(tokens),
                                         "labels": jnp.asarray(labels)})

        cfg = get_config("deepseek-7b").scaled_down()
        model = build_model(cfg)
        batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
        plan = make_plan(mesh11)

        def fresh():
            params = params_from_jax(jax.device_get(jstate["params"]))
            return {"params": params, "opt": init_state(params, AdamWConfig())}

        sharded = fresh()
        shard = {"params": SR.make_param_shardings(mesh11, sharded["params"], cfg, plan),
                 "opt": SR.make_opt_shardings(mesh11, sharded["opt"], cfg, plan)}
        before = [t for _, t in flatten_with_paths(sharded["params"])]
        sharded["params"] = place_tree(sharded["params"], shard["params"])
        for k in ("m", "v"):
            sharded["opt"][k] = place_tree(sharded["opt"][k], shard["opt"][k])
        # one device: placement hands back the same tensors
        assert all(a is b for a, (_, b) in zip(before, flatten_with_paths(sharded["params"])))
        b_shard = infer_batch_shardings(batch, mesh11, plan)
        assert {k: tuple(v.spec) for k, v in b_shard.items()} == {"tokens": ("data",),
                                                                  "labels": ("data",)}
        with ctx.use_plan(plan, mesh11):
            _, m_sharded = make_train_step(model, AdamWConfig())(sharded, batch)
        plain = fresh()
        _, m_plain = make_train_step(model, AdamWConfig())(plain, batch)
        assert torch.equal(m_sharded["loss"], m_plain["loss"])
        for (k, a), (_, b) in zip(flatten_with_paths(sharded["params"]),
                                  flatten_with_paths(plain["params"])):
            assert torch.equal(a, b), k
        assert math.isfinite(float(m_sharded["loss"]))
        np.testing.assert_allclose(float(m_sharded["loss"]), float(jmetrics["loss"]),
                                   rtol=TRAIN_TOL, atol=TRAIN_TOL)


# ---------------------------------------------------------------------------
# twins of tests/test_compression.py
# ---------------------------------------------------------------------------
class TestInt8RoundTrip:
    @given(scale=st.floats(min_value=1e-3, max_value=1e3), n=st.integers(min_value=1, max_value=256))
    @settings(max_examples=40, deadline=None)
    def test_error_within_bound(self, scale, n):
        rng = np.random.default_rng(int(n * 1000 + scale))
        x = torch.from_numpy((rng.standard_normal(n) * scale).astype(np.float32))
        q, s = C.quantize_int8(x)
        err = float((C.dequantize_int8(q, s) - x).abs().max())
        assert err <= C.compression_error_bound(x) * 1.001

    def test_stochastic_rounding_unbiased(self):
        x = torch.full((20000,), 0.35)
        q, s = C.quantize_int8(x, generator=torch.Generator().manual_seed(0))
        mean = float(C.dequantize_int8(q, s).mean())
        assert abs(mean - 0.35) < 1e-3  # E[dq(q(x))] = x

    def test_tree_roundtrip(self):
        tree = {"a": torch.arange(8.0), "b": {"c": torch.ones((3, 3)) * 0.5}}
        qt, st_ = C.quantize_tree(tree)
        back = C.dequantize_tree(qt, st_)
        for (_, a), (_, b) in zip(flatten_with_paths(tree), flatten_with_paths(back)):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       atol=C.compression_error_bound(a) * 1.001)

    def test_zero_tensor_stable(self):
        q, s = C.quantize_int8(torch.zeros(16))
        np.testing.assert_array_equal(C.dequantize_int8(q, s).numpy(), 0.0)

    @pytest.mark.parametrize("seed,n,scale", [(0, 4096, 1.0), (1, 999, 3e-4), (2, 64, 250.0)])
    def test_nearest_codes_and_scales_equal_jax(self, seed, n, scale):
        rng = np.random.default_rng(seed)
        x = (rng.standard_normal(n) * scale).astype(np.float32)
        s = np.float32(np.abs(x).max()) / np.float32(127.0)
        x[1::97] = (np.arange(len(x[1::97])) % 100 + np.float32(0.5)) * s  # halfway codes
        q, s = C.quantize_int8(torch.from_numpy(x))
        jq, js = jax_comp.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()

    def test_training_converges_with_compressed_grads(self):
        """q/dq in the gradient path (stochastic rounding, a generator of
        its own) does not break AdamW on a small least-squares problem."""
        rng = np.random.default_rng(0)
        X = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
        w_true = torch.from_numpy(rng.standard_normal((8,)).astype(np.float32))
        y = X @ w_true
        params = {"w": torch.zeros(8)}
        cfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0)
        state = init_state(params, cfg)

        def loss(p):
            return ((X @ p["w"] - y) ** 2).mean()

        gen = torch.Generator().manual_seed(1)
        for _ in range(60):
            w = params["w"].detach().requires_grad_(True)
            (g,) = torch.autograd.grad(loss({"w": w}), [w])
            qt, sc = C.quantize_tree({"w": g}, generator=gen)
            params, state, _ = apply_updates(params, C.dequantize_tree(qt, sc), state, cfg)
        assert float(loss(params)) < 0.05


class TestCompressedPsum:
    def test_wire_reduce_on_two_ranks(self, tmp_path):
        """Two gloo ranks each hold a row; every rank's result equals the sum
        over ranks of JAX's ``dequantize_int8(*quantize_int8(row))`` (atol 0:
        two f32 terms, one summation order) and is within 2 * max / 127 of
        the exact sum, as the JAX test requires."""
        rows = np.arange(8.0, dtype=np.float32).reshape(2, 4)
        rows[1] *= -0.37
        np.save(tmp_path / "rows.npy", rows)
        _spawn(ranks.psum_rank, 2, str(tmp_path / "init"), str(tmp_path / "rows.npy"),
               str(tmp_path))
        want = sum(np.asarray(jax_comp.dequantize_int8(*jax_comp.quantize_int8(jnp.asarray(r))))
                   for r in rows)
        for out in _read_ranks(tmp_path, 2):
            got = np.asarray(out["sum"], np.float32)
            assert out["dtype"] == "torch.float32"
            np.testing.assert_array_equal(got, want)
            assert np.abs(got - rows.sum(0)).max() <= 2 * (np.abs(rows).max() / 127.0)


# ---------------------------------------------------------------------------
# the feeder's mesh path
# ---------------------------------------------------------------------------
class TestShardedPlacement:
    def test_per_host_shards_disjoint_on_multidevice_mesh(self, tmp_path, service_factory):
        """4 gloo ranks on a (data=2, model=2) mesh, batches of 4 rows from
        a DYNAMIC job of the service in this process (tcp): each batch is a
        DTensor placed [Shard(0), Replicate()]; the data-axis shards are the
        disjoint row ranges (0, 2) and (2, 4); model-axis peers hold equal
        rows; the shards reassemble to the leader's host batch; no element
        comes twice.  ``shard_activations`` under the plan redistributes a
        replicated DTensor to rows over the data axis."""
        svc = service_factory(num_workers=2, transport="tcp")
        _spawn(ranks.feeder_rank, 4, str(tmp_path / "init"), svc.dispatcher_address,
               str(tmp_path))
        outs = _read_ranks(tmp_path, 4)
        n = len(outs[0]["batches"])
        assert n >= 4 and all(len(o["batches"]) == n for o in outs)
        assert outs[0]["leader_shardings"] == {"x": ["data"]}
        seen = []
        for i in range(n):
            bs = [o["batches"][i] for o in outs]
            full = np.asarray(bs[0]["full"])
            assert full.shape == (4, 6)
            ranges = set()
            for b in bs:
                assert b["placements"] == ["Shard(dim=0)", "Replicate()"] and b["shape"] == [4, 6]
                lo = 2 * b["coord"][0]
                ranges.add((lo, lo + 2))
                np.testing.assert_array_equal(np.asarray(b["local"]), full[lo:lo + 2])
                np.testing.assert_array_equal(np.asarray(b["full"]), full)
            assert sorted(ranges) == [(0, 2), (2, 4)]
            by_row = {}
            for b in bs:  # model-axis peers: equal rows
                by_row.setdefault(b["coord"][0], []).append(b["local"])
            assert all(v[0] == v[1] for v in by_row.values())
            assert (full == full[:, :1]).all()
            seen += full[:, 0].tolist()
        assert len(seen) == len(set(seen)) and set(seen) <= set(range(32))
        for o in outs:
            assert o["redistributed"] == ["Shard(dim=0)", "Replicate()"]
            row = outs.index(o) // 2
            np.testing.assert_array_equal(
                np.asarray(o["redistributed_local"]),
                np.arange(24.0).reshape(4, 6)[2 * row:2 * row + 2])

    def test_infer_batch_shardings_equals_jax(self):
        batch = {"tokens": np.zeros((32, 16), np.int32), "labels": np.zeros((32, 16), np.int32),
                 "embeds": np.zeros((32, 16, 8), np.float32), "odd": np.zeros((6, 3), np.int32),
                 "scalar": np.zeros((), np.float32)}
        for name in MESHES:
            tm, jm = _port_mesh(name), _jax_mesh(name)
            got = infer_batch_shardings(batch, tm, make_plan(tm))
            want = JSR.batch_sharding(jm, jax_mesh.make_plan(jm), batch)
            assert _port_specs(got) == _specs(_jax_flat(want))

    def test_indivisible_leading_dim_replicates(self):
        mesh = AbstractMesh((2, 2), ("data", "model"))
        got = infer_batch_shardings({"x": np.zeros((3, 4)), "y": np.zeros((4, 4))}, mesh,
                                    make_plan(mesh))
        assert got["x"].spec == P() and got["y"].spec == P("data")

    def test_explicit_shardings_win_over_mesh_and_plan(self, service_factory, mesh11):
        svc = service_factory(num_workers=1)
        dds = (ranks_pipeline(16).distribute(service=svc, processing_mode="dynamic"))
        explicit = NamedSharding(mesh11, P())
        with DeviceFeeder(dds, mesh=mesh11, plan=make_plan(mesh11), shardings=explicit) as f:
            b = f.next(timeout=60)
            assert f.shardings == {"x": explicit}
            assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        with DeviceFeeder(dds, mesh=mesh11, plan=make_plan(mesh11)) as f:
            rows = [t for b in f for t in b["x"][:, 0].tolist()]
            assert f.shardings["x"].spec == P("data") and f.shardings["x"].mesh is mesh11
        assert len(rows) == len(set(rows))
        with pytest.raises(TypeError, match="together"):
            DeviceFeeder(dds, mesh=mesh11)

    def test_device_feed_example_runs(self):
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        out = subprocess.run([sys.executable, str(ROOT / "examples" / "device_feed_torch.py")],
                             capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-3000:]
        lines = out.stdout.splitlines()
        for r in range(4):
            assert any(line.startswith(f"rank {r} at (data, model)") and
                       "[Shard(dim=0), Replicate()]" in line for line in lines), out.stdout
            assert any(line.startswith(f"rank {r}: consumed 8 sharded batches")
                       for line in lines), out.stdout



def test_shard_slices_and_placements_follow_mesh_order():
    """A dim over ("pod", "data") takes Shard on both mesh dims, split
    major to minor as JAX lays it out; a spec out of the mesh's order is
    refused."""

    class Mesh3:
        mesh_dim_names = ("pod", "data", "model")
        ndim = 3

        @staticmethod
        def size(i):
            return (2, 2, 2)[i]

    sh = NamedSharding(Mesh3(), P(("pod", "data"), "model"))
    assert [repr(p) for p in placements(sh)] == ["Shard(dim=0)", "Shard(dim=0)", "Shard(dim=1)"]
    got = [shard_slices(sh, (8, 4), (p, d, m)) for p in (0, 1) for d in (0, 1) for m in (0, 1)]
    rows = [(s[0].start, s[0].stop) for s in got]
    assert rows == [(0, 2), (0, 2), (2, 4), (2, 4), (4, 6), (4, 6), (6, 8), (6, 8)]
    assert [(s[1].start, s[1].stop) for s in got[:2]] == [(0, 2), (2, 4)]
    with pytest.raises(ValueError, match="order"):
        placements(NamedSharding(Mesh3(), P(("data", "pod"))))


# ---------------------------------------------------------------------------
# the dry run's production meshes
# ---------------------------------------------------------------------------
DRYRUN_CELLS = [("deepseek-7b", "train"), ("moonshot-v1-16b-a3b", "prefill"),
                ("jamba-v0.1-52b", "decode")]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,kind", DRYRUN_CELLS)
def test_dryrun_production_mesh_cells(arch, kind, mesh_name):
    """``run_cell`` on the production meshes at ``scaled_down()``: OK, 256 or
    512 chips, the per-device argument bytes of JAX's shard shapes, the
    FLOPs of one device's partitioned program (between the one-card count
    over the chips and the one-card count: the scaled-down heads and
    experts do not divide the 16-wide model axis, so work is replicated),
    and a collective term with its breakdown."""
    sh = ShapeConfig(f"{kind}_t", 32 if kind != "decode" else 64, 32, kind)
    rec = dryrun.run_cell(arch, sh, mesh_name, reduced=True)
    one = dryrun.run_cell(arch, sh, "one", reduced=True)
    rl = rec["roofline"]
    chips = {"single": 256, "multi": 512}[mesh_name]
    assert rec["status"] == "OK" and rl["chips"] == chips and rec["mesh"] == mesh_name
    coll = rl["collective_breakdown"]
    assert rl["collective_bytes_per_device"] == coll["total"] > 0
    assert coll["total"] == sum(coll[k] for k in ("all-gather", "all-reduce", "reduce-scatter",
                                                  "all-to-all", "collective-permute"))
    assert sum(coll["counts"].values()) > 0 and sum(coll["by_axis"].values()) == coll["total"]
    assert rl["collective_s"] > 0 and "comm_cost" in rl["note"]
    assert rl["dominant"] in ("compute", "memory", "collective")
    one_flops = one["roofline"]["flops_per_device"]
    assert one_flops / chips <= rl["flops_per_device"] <= one_flops

    cfg = get_config(arch).scaled_down()
    model = build_model(cfg)
    tp = S.params_shape(model)
    jcfg = jax_config(arch).scaled_down()
    jmodel = jax_build(jcfg)
    jm = _jax_mesh(mesh_name)
    jplan = jax_mesh.make_plan(jm, fsdp_over_pod=jcfg.fsdp_over_pod)
    jp = jax_specs.params_shape(jmodel)
    jsh = JSR.make_param_shardings(jm, jp, jcfg, jplan)
    if kind == "train":
        jo = jax.eval_shape(lambda: jax_opt.init_state(
            jp, jax_opt.AdamWConfig(state_dtype=jcfg.opt_state_dtype)))
        bi = jax_specs.train_input_specs(jcfg, sh)
        to = S.opt_shape(model, AdamWConfig(state_dtype=cfg.opt_state_dtype))
        want = (_jax_shard_bytes(jp, jsh, tp)
                + _jax_shard_bytes(jo, JSR.make_opt_shardings(jm, jo, jcfg, jplan), to)
                + _jax_shard_bytes(bi, JSR.batch_sharding(jm, jplan, bi),
                                   S.train_input_specs(cfg, sh)))
    elif kind == "prefill":
        bi = jax_specs.prefill_input_specs(jcfg, sh)
        want = (_jax_shard_bytes(jp, jsh, tp)
                + _jax_shard_bytes(bi, JSR.batch_sharding(jm, jplan, bi),
                                   S.prefill_input_specs(cfg, sh)))
    else:
        tok, cache = jax_specs.decode_input_specs(jmodel, jcfg, sh)
        ttok, tcache = S.decode_input_specs(model, cfg, sh)
        want = (_jax_shard_bytes(jp, jsh, tp)
                + _jax_shard_bytes(cache, JSR.cache_sharding(jm, jplan, cache, jcfg), tcache)
                + _jax_shard_bytes(tok, JSR.batch_sharding(jm, jplan, tok), ttok))
    mem = rl["memory_per_device_bytes"]
    assert mem["argument_bytes"] == want
    assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0
    assert mem["per_device_total"] == want + mem["temp_bytes"]
    assert rec["fits_hbm_80g"] is True


def test_dryrun_cli_flags_reach_the_plan(tmp_path):
    """``--seq-shard``, ``--moe-pin`` and ``--moe-expert-axis`` reach the
    record's plan (JAX's ``dataclasses.replace`` of ``make_plan``)."""
    rec = dryrun.run_cell("moonshot-v1-16b-a3b", ShapeConfig("t", 32, 32, "train"), "multi",
                          seq_shard=True, moe_pin="group", moe_expert_axis="data", reduced=True)
    assert rec["plan"]["seq_axis"] == "model" and rec["plan"]["moe_pin"] == "group"
    assert rec["plan"]["moe_expert_axis"] == "data" and rec["variant"]["seq_shard"] is True
    jplan = dataclasses.replace(jax_mesh.make_plan(_jax_mesh("multi"), seq_shard=True),
                                moe_pin="group", moe_expert_axis="data")
    assert json.loads(json.dumps(rec["plan"])) == json.loads(json.dumps(dataclasses.asdict(jplan)))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "whisper-large-v3", "--shape", "decode_32k", "--mesh", "single",
                          "--seq-shard", "--moe-pin", "group_ep", "--moe-expert-axis", "data",
                          "--out", str(tmp_path)], capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "single__whisper-large-v3__decode_32k.json").read_text())
    assert rec["status"] == "OK" and rec["roofline"]["chips"] == 256
    assert rec["plan"]["seq_axis"] == "model" and rec["plan"]["moe_pin"] == "group_ep"
    assert rec["plan"]["moe_expert_axis"] == "data"


def test_launcher_without_execute_writes_a_single_record(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "starcoder2-3b", "--shape", "train_4k", "--mesh", "single",
                          "--moe-pin", "group", "--out", str(tmp_path)],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "single__preflight__starcoder2_3b__train_4k.json").read_text())
    assert rec["status"] == "OK" and rec["mesh"] == "single" and rec["roofline"]["chips"] == 256
    assert rec["plan"]["moe_pin"] == "group" and rec["roofline"]["collective_s"] > 0
