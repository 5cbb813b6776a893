"""The partitioned step: the port's train, prefill and decode steps on
``DTensor``s over a mesh larger than one device, the kernel wrappers as the
local boundary, and ``launch/comm_cost.py`` against JAX's collective count.

* (a, b) One spawn of 4 gloo ranks on a (data=2, model=2) mesh
  (``torch_dist_ranks.partition_rank``) runs, at ``scaled_down()`` through
  the kernel route (``attn_impl="pallas"``: the wrappers' plain versions on
  local shards), two train steps of deepseek-7b, moonshot-v1-16b-a3b,
  mamba2-2.7b and whisper-large-v3 from bridged JAX params, sharded and
  unsharded, and prefill plus decode steps of deepseek-7b and jamba; (c) the
  grouped-heads boundary of flash and decode at llama3-405b's ratio (q heads
  split finer than the kv heads), forward and gradients, and the augment
  kernel's boundary, against the plain versions on whole tensors.
* (d) ``comm_cost`` on a fake (2, 2) mesh against JAX's
  ``parse_collective_bytes`` of the same functions compiled on 4 forced CPU
  devices; (e) deepseek-7b's whole partitioned train step counted by the
  dry run against JAX's ``hlo_cost.analyze`` of its compiled step.

AdamW runs at eps 1e-3 here (``TRAJ_EPS``'s value for the hybrid family in
``tests/test_torch_train.py``): where a gradient is near eps, the first
steps turn its f32 reassociation noise (the sharded sums run in another
order) into changes of the size of the learning rate.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_ranks as ranks  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.train import AdamWConfig as JaxAdamW  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_make_step  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TRAIN_ARCHS = ["deepseek-7b", "moonshot-v1-16b-a3b", "mamba2-2.7b", "whisper-large-v3"]
SERVE_ARCHS = ["deepseek-7b", "jamba-v0.1-52b"]
PART_TOL = 1e-5  # sharded against unsharded, relative
TRAIN_TOL = 1e-4  # the port against JAX (tests/test_torch_train.py's TRAJ_TOL)
OPT = dict(lr=1e-3, warmup_steps=1, eps=1e-3)
# (name, Hq, Hkv, (data, model)): llama3-405b's 16 q heads a kv head
GQA_CASES = [("q16_kv1_on_2", 16, 1, (2, 2)), ("q8_kv2_on_4", 8, 2, (1, 4))]


def _jax_params(arch):
    cfg = jax_config(arch).scaled_down()
    state = jax_init_state(jax_build(cfg), jax.random.PRNGKey(0), JaxAdamW(**OPT))
    return cfg, state


def _train_batches(cfg, rng):
    out = []
    for _ in range(2):
        b = {"tokens": rng.integers(1, cfg.vocab_size, (4, 32)),
             "labels": rng.integers(1, cfg.vocab_size, (4, 32))}
        b["labels"][:, ::7] = 0
        if cfg.family == "encdec":
            b["enc_embeds"] = rng.standard_normal(
                (4, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _gqa_inputs(rng, Hq, Hkv):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(4, 16, Hq, 32), k=f(4, 16, Hkv, 32), v=f(4, 16, Hkv, 32),
                do=f(4, 16, Hq, 32), qd=f(4, Hq, 32), kc=f(4, 24, Hkv, 32),
                vc=f(4, 24, Hkv, 32), lengths=np.array([24, 7, 1, 16], np.int32))


@pytest.fixture(scope="module")
def partitioned(tmp_path_factory):
    """Every rank case in one spawn of 4 gloo ranks (joined); returns
    (rank 0's results, JAX's step-1 losses)."""
    import jax.numpy as jnp
    import torch.multiprocessing as mp

    rng = np.random.default_rng(2)
    cases, jax_loss = {}, {}
    for arch in TRAIN_ARCHS:
        cfg, state = _jax_params(arch)
        batches = _train_batches(cfg, rng)
        _, m = jax.jit(jax_make_step(jax_build(cfg), JaxAdamW(**OPT)))(
            state, {k: jnp.asarray(v) for k, v in batches[0].items()})
        jax_loss[arch] = float(m["loss"])
        cases[f"train/{arch}"] = dict(kind="train", arch=arch, opt=OPT, batches=batches,
                                      params=jax.device_get(state["params"]))
    for arch in SERVE_ARCHS:
        cfg, state = _jax_params(arch)
        cases[f"serve/{arch}"] = dict(kind="serve", arch=arch,
                                      params=jax.device_get(state["params"]),
                                      tokens=rng.integers(1, cfg.vocab_size, (4, 6)))
    for name, Hq, Hkv, mesh in GQA_CASES:
        cases[f"gqa/{name}"] = dict(kind="gqa", mesh=mesh, **_gqa_inputs(rng, Hq, Hkv))
    cases["augment"] = dict(
        kind="augment", images=rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8),
        crops=rng.integers(0, 5, (4, 2)).astype(np.int32),
        flips=np.array([0, 1, 1, 0], np.int32),
        mean=np.array([0.485, 0.456, 0.406], np.float32),
        std=np.array([0.229, 0.224, 0.225], np.float32))
    d = tmp_path_factory.mktemp("partition")
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    mp.start_processes(ranks.partition_rank, args=(4, str(d / "init"), str(d / "cases.pkl"),
                                                   str(d)),
                       nprocs=4, join=True, start_method="spawn")
    outs = [json.loads((d / f"rank{r}.json").read_text()) for r in range(4)]
    assert all(o == outs[0] for o in outs[1:])  # every rank sees the same step
    return outs[0], jax_loss


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_equals_unsharded_and_jax(arch, partitioned):
    """Two steps on the (2, 2) mesh: losses and gradient norms within 1e-5
    relative of the unsharded step's, the updated params within 1e-5 of
    the tree's largest entry, and the step-1 loss within the train tests'
    tolerance of JAX's unsharded step on the same params and batch."""
    got, jax_loss = partitioned
    r = got[f"train/{arch}"]
    print(arch, {k: r[k] for k in ("losses", "plain_losses", "params_gap", "worst_leaf",
                                   "worst_leaf_gap")})
    np.testing.assert_allclose(r["losses"], r["plain_losses"], rtol=PART_TOL)
    np.testing.assert_allclose(r["grad_norms"], r["plain_grad_norms"], rtol=PART_TOL)
    assert r["params_gap"] <= PART_TOL, (r["worst_leaf"], r["params_gap"])
    np.testing.assert_allclose(r["losses"][0], jax_loss[arch], rtol=TRAIN_TOL,
                               atol=TRAIN_TOL)
    assert r["sharded_leaves"] > 0 and r["kernel_calls"] > 0


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_prefill_and_decode_equal_unsharded(arch, partitioned):
    """Prefill's last-token logits and two decode steps' logits on the mesh
    within 1e-5 of the unsharded logits' largest entry; the serve step's
    greedy tokens equal."""
    r = partitioned[0][f"serve/{arch}"]
    print(arch, r)
    assert r["prefill_gap"] <= PART_TOL * r["scale"]
    assert max(r["decode_gaps"]) <= PART_TOL * r["scale"]
    assert r["next_equal"]


@pytest.mark.parametrize("name", [c[0] for c in GQA_CASES])
def test_grouped_heads_boundary_matches_whole_tensors(name, partitioned):
    """q heads split finer than the kv heads: each rank slices the kv head
    its q heads use.  Flash's output and its q, k, v gradients (k and v
    summed over the model axis) and decode's output equal the plain
    versions on whole tensors."""
    r = partitioned[0][f"gqa/{name}"]
    print(name, r)
    assert r["mode"] == "heads"
    assert max(r["flash_gaps"].values()) <= 2e-5
    assert r["decode_gap"] <= 2e-5


def test_augment_boundary_splits_the_batch(partitioned):
    """``fused_augment`` given DTensors: each rank augments its rows (the
    batch over the data axis); the whole equals the plain version's."""
    r = partitioned[0]["augment"]
    assert r["placements"] == ["Shard(dim=0)", "Replicate()"]
    assert r["gap"] <= 1e-6


# ---------------------------------------------------------------------------
# comm_cost against JAX's count of the compiled HLO
# ---------------------------------------------------------------------------
LAYERS = 3
_JAX_CASES = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.launch import hlo_cost
    from repro.launch.roofline import parse_collective_bytes
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    def count(f, ins, shapes):
        j = jax.jit(f, in_shardings=tuple(NamedSharding(mesh, s) for s in ins),
                    out_shardings=NamedSharding(mesh, P()))
        args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
        text = j.lower(*args).compile().as_text()
        hc = hlo_cost.analyze(text)
        return {{"parse": parse_collective_bytes(text), "bytes": hc.collective_detail,
                 "total": hc.collective_bytes, "counts": hc.collective_counts}}
    def layers(x, w1, w2):
        for l in range({layers}):
            x = jnp.tanh((x @ w1[l]) @ w2[l])
        return x
    print(json.dumps({{
        "row_parallel": count(lambda x, w: x @ w, [P(None, "model"), P("model", None)],
                              [(8, 64), (64, 32)]),
        "layer_loop": count(layers, [P(), P(None, None, "model"), P(None, "model", None)],
                            [(8, 64), ({layers}, 64, 128), ({layers}, 128, 64)]),
        "all_gather": count(lambda x: x * 2.0, [P("data", None)], [(8, 64)]),
    }}))
""")


def _jax_subprocess(script):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_cases():
    """The three functions on meta ``DTensor``s over a fake (2, 2) mesh,
    each counted by ``comm_cost``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.dist import AbstractMesh
    from repro_torch.launch.comm_cost import count_collectives
    from repro_torch.launch.mesh import fake_device_mesh

    mesh = fake_device_mesh(AbstractMesh((2, 2), ("data", "model")))
    try:
        R = Replicate()

        def dt(shape, placements):
            local = list(shape)
            for m, p in enumerate(placements):
                if isinstance(p, Shard):
                    local[p.dim] //= mesh.size(m)
            return DTensor.from_local(torch.empty(local, device="meta"), mesh, placements,
                                      run_check=False)

        out = {}
        with count_collectives(mesh) as c:
            (dt((8, 64), [R, Shard(1)]) @ dt((64, 32), [R, Shard(0)])).redistribute(mesh, [R, R])
        out["row_parallel"] = c.detail()
        x = dt((8, 64), [R, R])
        w1, w2 = dt((LAYERS, 64, 128), [R, Shard(2)]), dt((LAYERS, 128, 64), [R, Shard(1)])
        with count_collectives(mesh) as c:
            for i in range(LAYERS):
                x = torch.tanh((x @ w1[i]) @ w2[i])
        out["layer_loop"] = c.detail()
        with count_collectives(mesh) as c:
            (dt((8, 64), [Shard(0), R]) * 2.0).redistribute(mesh, [R, R])
        out["all_gather"] = c.detail()
        return out
    finally:
        dist.destroy_process_group()


def test_comm_cost_equals_jax_parse_collective_bytes():
    """A row-parallel product: one all-reduce of the output's bytes; a
    column-to-row pair in an L-layer loop: L all-reduces; a Shard ->
    Replicate gather: one all-gather of the shard's bytes.  The counts by
    kind equal JAX's ``parse_collective_bytes`` of the compiled HLO
    exactly, and the bytes by kind those of ``hlo_cost.analyze``'s
    collective pass of the same text: this XLA prints an operand by name
    alone, so ``parse_collective_bytes`` (which reads shapes inside the
    operand list) counts the collectives but gives them 0 bytes."""
    want = _jax_subprocess(_JAX_CASES.format(src=str(ROOT / "src"), layers=LAYERS))
    got = _port_cases()
    for case, w in want.items():
        print(case, got[case], w)
        for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                     "collective-permute"):
            assert got[case]["counts"][kind] == w["parse"]["counts"][kind], (case, kind)
            assert got[case]["counts"][kind] == w["counts"][kind], (case, kind)
            assert got[case][kind] == w["bytes"][kind], (case, kind)
        assert got[case]["total"] == w["total"]
    assert got["layer_loop"]["counts"]["all-reduce"] == LAYERS
    assert got["row_parallel"]["all-reduce"] == 8 * 32 * 4
    assert got["all_gather"]["all-gather"] == 4 * 64 * 4


_JAX_STEP = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, {src!r})
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.dist import sharding_rules as SR
    from repro.dist.context import use_plan
    from repro.launch import hlo_cost, specs, mesh as M
    from repro.models import build_model
    from repro.models.config import ShapeConfig
    from repro.train import AdamWConfig, init_train_state, make_train_step
    cfg = get_config("deepseek-7b").scaled_down()
    model = build_model(cfg)
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    plan = M.make_plan(mesh)
    oc = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    state = jax.eval_shape(lambda: init_train_state(model, jax.random.PRNGKey(0), oc))
    batch = specs.train_input_specs(cfg, ShapeConfig("t", {S}, {B}, "train"))
    shard = {{"params": SR.make_param_shardings(mesh, state["params"], cfg, plan),
              "opt": SR.make_opt_shardings(mesh, state["opt"], cfg, plan)}}
    with mesh, use_plan(plan):
        step = jax.jit(make_train_step(model, oc),
                       in_shardings=(shard, SR.batch_sharding(mesh, plan, batch)))
        hc = hlo_cost.analyze(step.lower(state, batch).compile().as_text())
    print(json.dumps({{"flops": hc.flops, "total": hc.collective_bytes,
                       "detail": hc.collective_detail, "counts": hc.collective_counts}}))
""")
STEP_B, STEP_S = 4, 32


def test_deepseek_partitioned_step_against_jax_hlo_cost():
    """deepseek-7b's train step on (2, 2): every collective kind JAX's
    compiled step emits appears in the port's count; the per-device FLOPs
    lie between the one-card count over 4 and the one-card count (the
    partitioned program replicates some work)."""
    want = _jax_subprocess(_JAX_STEP.format(src=str(ROOT / "src"), S=STEP_S, B=STEP_B))
    sh = ShapeConfig("t", STEP_S, STEP_B, "train")
    rec = dryrun.run_cell("deepseek-7b", sh, "2x2", reduced=True)
    one = dryrun.run_cell("deepseek-7b", sh, "one", reduced=True)
    rl = rec["roofline"]
    got = rl["collective_breakdown"]
    ratio = got["total"] / want["total"]
    print("port", json.dumps(got), "\njax", json.dumps(want), "\nratio port/jax", ratio,
          "flops port", rl["flops_per_device"], "jax", want["flops"])
    emitted = {k for k, v in want["detail"].items() if v > 0}
    assert emitted and emitted <= {k for k in emitted if got[k] > 0}, (emitted, got)
    one_flops = one["roofline"]["flops_per_device"]
    assert one_flops / 4 < rl["flops_per_device"] < one_flops
    assert rl["collective_s"] > 0 and rl["chips"] == 4
