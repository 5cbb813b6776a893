"""Rank programs of ``tests/test_torch_dist.py``: each runs in a spawned
process, one gloo rank on the CPU, and writes what it saw to a JSON file
that the test reads.  No JAX here: the ranks import torch, the port and the
data service's client only, so they start fast."""
import json
import os

import numpy as np

from repro.data import register


@register("tests.torch_dist_ranks.row")
def row(i):
    """Element i of the feeder's dataset: a row of 6 copies of i."""
    return {"x": np.full((6,), int(i), np.int32)}


def _init(rank: int, world: int, init_file: str):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)


def _dump(out_dir: str, rank: int, obj) -> None:
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(obj, f)


def feeder_rank(rank: int, world: int, init_file: str, address: str, out_dir: str) -> None:
    """A (data=2, model=2) mesh fed by ``DeviceFeeder(mesh=, plan=)`` from
    the service at ``address`` (a DYNAMIC job of 32 elements in batches of
    4 rows); also redistributes a replicated DTensor by
    ``shard_activations``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro.core import DistributedDataset
    from repro.data import Dataset
    from repro_torch.dist import ShardingPlan, shard_activations, use_plan
    from repro_torch.feed import DeviceFeeder
    from repro_torch.launch.mesh import make_test_mesh

    _init(rank, world, init_file)
    try:
        mesh = make_test_mesh(2, 2)
        plan = ShardingPlan(data_axes=("data",), model_axis="model")
        # shm=False: no /dev/shm ring, which the leak check of tests running
        # beside this one in other workers would count as theirs
        graph = Dataset.range(32).map(row).batch(4, drop_remainder=True).graph
        ds = DistributedDataset(graph, address, processing_mode="dynamic", shm=False)
        batches = []
        with DeviceFeeder(ds, mesh=mesh, plan=plan) as feeder:
            for b in feeder:
                x = b["x"]
                assert isinstance(x, DTensor), type(x)
                full = x.full_tensor()  # a collective: every rank holds the batch
                batches.append(dict(
                    placements=[repr(p) for p in x.placements],
                    shape=list(x.shape), local=x.to_local().tolist(),
                    full=full.tolist(), coord=list(mesh.get_coordinate())))
        y = DTensor.from_local(torch.arange(24.0).reshape(4, 6), mesh, [Replicate(), Replicate()],
                               run_check=False)
        with use_plan(plan, mesh):
            z = shard_activations(y, "bd")
        out = dict(batches=batches, redistributed=[repr(p) for p in z.placements],
                   redistributed_local=z.to_local().tolist(),
                   leader_shardings=None if feeder.shardings is None else
                   {k: list(v.spec) for k, v in feeder.shardings.items()})
        _dump(out_dir, rank, out)
    finally:
        dist.destroy_process_group()


def psum_rank(rank: int, world: int, init_file: str, rows_file: str, out_dir: str) -> None:
    """``compressed_psum`` of this rank's row over a 1-D mesh of ``world``
    ranks."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.compression import compressed_psum

    _init(rank, world, init_file)
    try:
        mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("d",))
        rows = np.load(rows_file)
        out = compressed_psum(torch.from_numpy(rows[rank]), mesh, "d")
        _dump(out_dir, rank, dict(sum=out.tolist(), dtype=str(out.dtype)))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the partitioned step (tests/test_torch_partition.py)
# ---------------------------------------------------------------------------
def _whole(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _param_gaps(sharded, plain):
    """(max |sharded - plain| over the tree / max |plain| over the tree, the
    leaf with the largest gap relative to its own largest entry, that gap,
    the number of DTensor leaves)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.bridge import flatten_with_paths

    want = dict(flatten_with_paths(plain))
    diff = top = 0.0
    leaf_gaps, n_dt = {}, 0
    for key, t in flatten_with_paths(sharded):
        n_dt += isinstance(t, DTensor)
        d = float((_whole(t) - want[key]).abs().max())
        w = float(want[key].abs().max())
        diff, top = max(diff, d), max(top, w)
        leaf_gaps[key] = d / max(w, 1e-30)
    worst = max(leaf_gaps, key=leaf_gaps.get)
    return diff / top, worst, leaf_gaps[worst], n_dt


def _count_boundary_calls():
    """Counts the kernel boundary's local calls (a spy on
    ``kernels._boundary._call``); returns the counter dict."""
    from repro_torch.kernels import _boundary

    calls = {"n": 0}
    orig = _boundary._call

    def spy(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    _boundary._call = spy
    return calls


def _train_case(case, mesh, plan):
    """Two steps of the port's train step unsharded and sharded on ``mesh``
    from the same bridged params and batches."""
    import torch

    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding_rules as SR
    from repro_torch.dist.context import use_plan
    from repro_torch.dist.placement import place_tree
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    cfg = get_config(case["arch"]).scaled_down().replace(attn_impl="pallas")
    model = build_model(cfg)
    opt = AdamWConfig(**case["opt"])

    def fresh():
        params = params_from_jax(case["params"])
        return {"params": params, "opt": init_state(params, opt)}

    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in case["batches"]]
    plain, plain_losses, plain_norms = fresh(), [], []
    step = make_train_step(model, opt)
    for b in batches:
        _, m = step(plain, b)
        plain_losses.append(float(m["loss"]))
        plain_norms.append(float(m["grad_norm"]))
    state = fresh()
    pshard = SR.make_param_shardings(mesh, state["params"], cfg, plan)
    oshard = SR.make_opt_shardings(mesh, state["opt"], cfg, plan)
    state["params"] = place_tree(state["params"], pshard)
    for k in ("m", "v"):
        state["opt"][k] = place_tree(state["opt"][k], oshard[k])
    losses, norms = [], []
    calls = _count_boundary_calls()
    step = make_train_step(model, opt)
    with use_plan(plan, mesh):
        for b in batches:
            b = place_tree(b, SR.batch_sharding(mesh, plan, b))
            _, m = step(state, b)
            losses.append(float(_whole(m["loss"])))
            norms.append(float(_whole(m["grad_norm"])))
    gap, worst, worst_gap, n_dt = _param_gaps(state["params"], plain["params"])
    return dict(losses=losses, plain_losses=plain_losses, grad_norms=norms,
                plain_grad_norms=plain_norms, params_gap=gap, worst_leaf=worst,
                worst_leaf_gap=worst_gap, sharded_leaves=n_dt, kernel_calls=calls["n"])


def _gqa_case(case):
    """Flash (forward and gradients) and decode through the boundary with
    the q heads split finer than the kv heads, against the plain versions
    on whole tensors."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist.context import use_plan
    from repro_torch.kernels import _boundary
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch.mesh import make_plan, make_test_mesh

    mesh = make_test_mesh(*case["mesh"])
    plan = make_plan(mesh)
    t = {k: torch.from_numpy(v) for k, v in case.items() if isinstance(v, np.ndarray)}
    R = Replicate()
    heads, kv = [Shard(0), Shard(2)], [Shard(0), R]

    def leaf(x, placements):
        return distribute_tensor(x, mesh, placements).requires_grad_(True)

    q, k, v = leaf(t["q"], heads), leaf(t["k"], kv), leaf(t["v"], kv)
    with use_plan(plan, mesh):
        out = flash_attention(q, k, v, causal=True)
        (out * distribute_tensor(t["do"], mesh, heads)).sum().backward()
        dec = decode_attention(distribute_tensor(t["qd"], mesh, [Shard(0), Shard(1)]),
                               distribute_tensor(t["kc"], mesh, kv),
                               distribute_tensor(t["vc"], mesh, kv),
                               distribute_tensor(t["lengths"], mesh, [Shard(0), R]))
    wq, wk, wv = (t[n].clone().requires_grad_(True) for n in ("q", "k", "v"))
    want = flash_attention_ref(wq, wk, wv, causal=True)
    (want * t["do"]).sum().backward()
    gaps = {"out": float((out.full_tensor() - want).abs().max())}
    for name, got, ref in (("dq", q, wq), ("dk", k, wk), ("dv", v, wv)):
        gaps[name] = float((got.grad.full_tensor() - ref.grad).abs().max())
    want_dec = decode_attention_ref(t["qd"], t["kc"], t["vc"], t["lengths"])
    return dict(mode=_boundary.head_split(t["q"].shape[2], t["k"].shape[2], mesh.size(1)),
                flash_gaps=gaps, decode_gap=float((dec.full_tensor() - want_dec).abs().max()))


def _augment_case(case, mesh, plan):
    """``fused_augment`` through the boundary (images, crops and flips over
    the data axis) against its plain version on the whole batch."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist.context import use_plan
    from repro_torch.kernels.fused_augment import fused_augment
    from repro_torch.kernels.fused_augment.ref import fused_augment_ref

    t = {k: torch.from_numpy(v) for k, v in case.items() if isinstance(v, np.ndarray)}
    rows, whole = [Shard(0), Replicate()], [Replicate(), Replicate()]
    args = [distribute_tensor(t[k], mesh, rows) for k in ("images", "crops", "flips")]
    args += [distribute_tensor(t[k], mesh, whole) for k in ("mean", "std")]
    with use_plan(plan, mesh):
        got = fused_augment(*args, out_h=12, out_w=10)
    want = fused_augment_ref(t["images"], t["crops"], t["flips"], t["mean"], t["std"], 12, 10)
    return dict(placements=[repr(p) for p in got.placements],
                gap=float((got.full_tensor() - want).abs().max()))


def _serve_case(case, mesh, plan):
    """Prefill logits and two decode steps' logits (and the serve step's
    tokens), sharded against unsharded."""
    import torch

    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding_rules as SR
    from repro_torch.dist.context import use_plan
    from repro_torch.dist.placement import place_tree
    from repro_torch.models import build_model
    from repro_torch.serve.engine import make_serve_step

    cfg = get_config(case["arch"]).scaled_down().replace(attn_impl="pallas")
    model = build_model(cfg)
    params = params_from_jax(case["params"])
    tokens = torch.from_numpy(case["tokens"])
    B = tokens.shape[0]
    out = {}
    with torch.no_grad():
        want_prefill = model.forward(params, {"tokens": tokens}, last_token_only=True)
        cache = model.init_cache(B, 8, device="cpu")
        want_steps, want_next = [], []
        for t in range(2):
            logits, cache = model.decode_step(params, cache, tokens[:, t])
            want_steps.append(logits)
        cache["pos"] = 1
        want_next = make_serve_step(model)(params, cache, tokens[:, 2])[0]
        sp = place_tree(params, SR.make_param_shardings(mesh, params, cfg, plan))
        scache = model.init_cache(B, 8, device="cpu")
        scache = place_tree(scache, SR.cache_sharding(mesh, plan, scache, cfg))
        with use_plan(plan, mesh):
            btok = place_tree({"tokens": tokens}, SR.batch_sharding(mesh, plan,
                                                                   {"tokens": tokens}))
            got = _whole(model.forward(sp, btok, last_token_only=True))
            out["prefill_gap"] = float((got - want_prefill).abs().max())
            gaps = []
            for t in range(2):
                tok = place_tree({"t": tokens[:, t]}, SR.batch_sharding(
                    mesh, plan, {"t": tokens[:, t]}))["t"]
                logits, scache = model.decode_step(sp, scache, tok)
                gaps.append(float((_whole(logits) - want_steps[t]).abs().max()))
            scache["pos"] = 1
            tok = place_tree({"t": tokens[:, 2]}, SR.batch_sharding(
                mesh, plan, {"t": tokens[:, 2]}))["t"]
            nxt = _whole(make_serve_step(model)(sp, scache, tok)[0])
    out.update(decode_gaps=gaps, next_equal=bool(torch.equal(nxt, want_next)),
               scale=float(want_prefill.abs().max()))
    return out


def partition_rank(rank: int, world: int, init_file: str, cases_file: str, out_dir: str) -> None:
    """Each case of ``cases_file`` (a pickle: train and serve cases with
    JAX params to bridge, and grouped-heads cases) on a (data=2, model=2)
    mesh of 4 gloo ranks (a grouped-heads case on its own mesh)."""
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_plan, make_test_mesh

    torch.set_num_threads(1)  # 4 ranks on the test machine's cores
    _init(rank, world, init_file)
    try:
        mesh = make_test_mesh(2, 2)
        plan = make_plan(mesh)
        with open(cases_file, "rb") as f:
            cases = pickle.load(f)
        out = {}
        for name, case in cases.items():
            if case["kind"] == "gqa":
                out[name] = _gqa_case(case)
            elif case["kind"] == "augment":
                out[name] = _augment_case(case, mesh, plan)
            else:
                run = _train_case if case["kind"] == "train" else _serve_case
                out[name] = run(case, mesh, plan)
        _dump(out_dir, rank, out)
    finally:
        dist.destroy_process_group()
