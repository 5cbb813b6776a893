"""The one-card dry run (twin of the JAX package's ``repro/launch/dryrun.py``).

For an (architecture x input shape) cell it builds the full config's step on
the ``meta`` device - the train step for train shapes, the prefill forward or
the serve step (``make_serve_step``; whisper's ``decode_step``) for serving
shapes - against the ``launch.specs`` stand-ins, runs it once with no memory
and no numbers, and counts:

* FLOPs with ``torch.utils.flop_counter.FlopCounterMode``: PyTorch's own
  formulas for the products, and each kernel op's formula for its
  shape-only route (``kernels._shape``), registered by ``launch.flops``;
* bytes as the operand and result bytes of every op that is not a view: an
  unfused upper estimate of XLA's "bytes accessed" (an eager step fuses
  nothing, and an in-place op counts its operand twice).

* memory with ``launch.memory.MemoryTracker`` (the twin of JAX's
  ``compiled.memory_analysis()``): the live set of the storages the step
  allocates, each kernel's scratch charged on its shape-only route; its
  peak is ``temp_bytes``.

It writes a JSON record with the roofline (``launch.roofline``, H100
constants), JAX's memory fields (``argument_bytes``, ``output_bytes``,
``temp_bytes``, ``alias_bytes`` and ``per_device_total = argument_bytes +
temp_bytes``), the tracker's own (``memory``: the live bytes at the step's
end, the allocations, the largest scratch and the decode workspace) and
``fits_hbm_80g``, that total against the card's 80 GB.  The cuBLAS
workspace and the allocator's rounding are not counted (``launch.memory``).

The optimizer reads a few scalars on the host (its clip scale, bias
corrections and learning rate); on ``meta`` those reads return 1
(``StepCounter``), which changes no op and no shape of the step.

Meshes: ``one`` (one H100), and the JAX package's production meshes
``single`` (16 x 16 = 256 chips) and ``multi`` (2 x 16 x 16 = 512) under
``make_plan(mesh, fsdp_over_pod=cfg.fsdp_over_pod, seq_shard=)`` with
``--moe-pin`` and ``--moe-expert-axis`` applied.  On a production mesh the
step is partitioned, the twin of JAX's compile of the sharded step: a
``fake_device_mesh`` (``launch.mesh``: the mesh's names and sizes over a
"fake" process group, seen from rank 0) carries the params, optimizer
state, inputs and cache as ``meta`` ``DTensor``s placed by the shardings,
and the step runs once on them (``count_partitioned``).  The record keeps
JAX's fields per device:

* ``argument_bytes``: the sum of every argument leaf's SHARD bytes under the
  param, opt, batch and cache shardings (``sharding_rules``), which is what
  JAX's ``memory_analysis`` reports for a partitioned step;
* ``flops_per_device`` and ``bytes_per_device``: those of the local program
  one device runs (``LocalCounter``: the shards' ops, replicated work
  included), which is what ``hlo_cost`` reads off the partitioned module;
* ``temp_bytes``: the peak of one device's live set over its local
  program, the outputs of the collectives included (``LocalCounter`` feeds
  the tracker); ``fits_hbm_80g``: arguments plus temporaries against 80 GB;
* ``collective_bytes_per_device`` and ``collective_breakdown``: the operand
  bytes of the collectives the step issues, by kind, count and mesh axis
  (``launch.comm_cost``), priced by the roofline at each axis's link rate.

A decode cell's stacked cache is relaid once at the step's start
(``context.unsplit_repeats``), and that move is counted with the step.
The process group is destroyed when the cell ends, as a process has one;
``--all`` runs each cell in a process of its own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-large-v3 --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b --shape train_4k --mesh multi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --summarize
``--all`` runs each cell in a fresh subprocess and skips cells whose record
exists.  Records go to ``experiments/dryrun_torch/`` (git-ignored) unless
``--out`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from ..models.config import SHAPES, ShapeConfig
from . import flops  # noqa: F401  (the kernel ops' FLOP formulas)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
OUT_DIR = os.path.join(SRC, "..", "experiments", "dryrun_torch")
MESHES = {"one": 1, "single": 256, "multi": 512}
HBM_BYTES = 80e9
# ops that allocate without writing: no bytes moved
_NO_TRAFFIC = ("empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like")


class StepCounter(TorchDispatchMode):
    """Counts the operand and result bytes of every op that is not a view,
    and answers a host read of a ``meta`` scalar (``.item()``, ``float()``)
    with 1, which a ``meta`` tensor cannot give."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default and args[0].device.type == "meta":
            t = args[0]
            return True if t.dtype == torch.bool else (1.0 if t.is_floating_point() else 1)
        out = func(*args, **kwargs)
        if not func.is_view and func.overloadpacket.__name__ not in _NO_TRAFFIC:
            self.ops += 1
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


class LocalCounter(TorchDispatchMode):
    """The counts of one device's program of a partitioned step: an op on
    ``DTensor``s passes to DTensor, whose local ops on this rank's shards
    reach the counter (FLOPs by ``FlopCounterMode``'s formulas, kernel ops
    by theirs, bytes as ``StepCounter`` counts them); DTensor's own shape
    propagation runs on fake tensors and is not counted; each functional
    collective is booked by ``comm_cost`` and moves no HBM bytes here."""

    def __init__(self, comm, memory=None):
        super().__init__()
        self.comm = comm
        self.memory = memory  # a memory.MemoryTracker fed every op counted here
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.by_op: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards
        if any(t is not torch.Tensor for t in types):
            return func(*args, **kwargs)  # DTensor's shape propagation on fake tensors
        if func is torch.ops.aten._local_scalar_dense.default and args[0].device.type == "meta":
            t = args[0]
            return True if t.dtype == torch.bool else (1.0 if t.is_floating_point() else 1)
        packet = func.overloadpacket
        if packet not in flop_registry and not self.comm.record(func, args):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        elif packet not in flop_registry:  # a collective
            out = func(*args, **kwargs)
            self._remember(func, args, kwargs, out)
            return out
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in tree_leaves(out)):
            return out  # a factory op of DTensor's propagation
        self._remember(func, args, kwargs, out)
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            self.by_op[str(packet)] = self.by_op.get(str(packet), 0) + n
        if not func.is_view and packet.__name__ not in _NO_TRAFFIC and func.namespace not in (
                "_c10d_functional", "_c10d_functional_autograd", "_dtensor"):
            self.ops += 1
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out

    def _remember(self, func, args, kwargs, out) -> None:
        if self.memory is not None:
            self.memory.record(func, args, kwargs, out)


def count_partitioned(fn, mesh) -> Dict[str, Any]:
    """Runs ``fn()`` (a step on ``meta`` ``DTensor``s over ``mesh``) under
    ``LocalCounter`` and ``comm_cost``, with a ``MemoryTracker`` fed by the
    counter: {"flops", "bytes", "ops", "flops_by_op", "collectives",
    "memory", "seconds", "out"} of one device."""
    from .comm_cost import CommCounter, alltoall_as_alltoall
    from .memory import MemoryTracker

    comm = CommCounter(mesh)
    t0 = time.perf_counter()
    mt = MemoryTracker()
    counter = LocalCounter(comm, memory=mt)
    with alltoall_as_alltoall(comm), counter:
        out = fn()
    return {"flops": counter.flops, "bytes": counter.bytes, "ops": counter.ops,
            "flops_by_op": counter.by_op, "collectives": comm.detail(),
            "memory": mt.report(), "seconds": time.perf_counter() - t0, "out": out}


def count_step(fn) -> Dict[str, Any]:
    """Runs ``fn()`` on ``meta`` under ``FlopCounterMode``, ``StepCounter``
    and, innermost, a ``MemoryTracker`` (it sees each op first and passes it
    on; ``StepCounter`` answers the host reads): {"flops", "bytes", "ops",
    "flops_by_op", "memory", "seconds", "out"}."""
    from .memory import MemoryTracker

    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, StepCounter() as sc, MemoryTracker() as mt:
        out = fn()
    by_op = {str(k): int(v) for k, v in fc.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(fc.get_total_flops()), "bytes": int(sc.bytes), "ops": sc.ops,
            "flops_by_op": by_op, "memory": mt.report(), "seconds": time.perf_counter() - t0,
            "out": out}


def make_mesh(mesh_name: str):
    """The ``AbstractMesh`` of a ``MESHES`` name, or of "DxM" (a (data=D,
    model=M) mesh, as the tests' small meshes)."""
    from ..dist.context import AbstractMesh
    from .mesh import make_production_mesh

    if "x" in mesh_name:
        return AbstractMesh(tuple(int(n) for n in mesh_name.split("x")), ("data", "model"))
    if mesh_name not in MESHES:
        raise ValueError(f"unknown mesh {mesh_name!r}; one of {sorted(MESHES)} or DxM")
    if mesh_name == "one":
        return AbstractMesh((1, 1), ("data", "model"))
    return make_production_mesh(multi_pod=mesh_name == "multi")


def run_cell(arch: str, shape: Union[str, ShapeConfig], mesh_name: str = "one", *,
             microbatches: int = 1, param_dtype: str = "", moe_groups: int = 0,
             remat: str = "", seq_shard: bool = False, moe_pin: str = "auto",
             moe_expert_axis: str = "model", reduced: bool = False,
             tag: str = "", replace: Optional[Dict[str, Any]] = None,
             inputs: Optional[Dict[str, torch.Tensor]] = None,
             cast_params: bool = False) -> Dict[str, Any]:
    """The record of one cell.  ``shape`` is a name of ``SHAPES`` or a
    ``ShapeConfig`` (any global batch and length); ``reduced`` takes the
    config's ``scaled_down()``.  So that a cell can describe the program a
    caller runs on the card: ``replace`` changes the config (after the
    flags above, e.g. {"num_layers": 4}); ``inputs`` gives the step's batch
    (a decode step's ``{"tokens"}``) in place of the ``launch.specs``
    stand-ins, with its own keys, shapes and dtypes (tensors on any device;
    only their shapes and dtypes are read); ``cast_params`` holds a serving
    step's parameters as ``ServeEngine`` does, cast once to the compute
    dtype (``cast_for_compute``)."""
    from ..configs import cell_supported, get_config

    mesh = make_mesh(mesh_name)
    cfg = get_config(arch)
    cfg = cfg.scaled_down() if reduced else cfg
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    if cast_params and sh.kind == "train":
        raise ValueError("cast_params holds a serving step's parameters; a train step "
                         "updates them in their own dtype")
    changes: Dict[str, Any] = {}
    if param_dtype:
        changes["param_dtype"] = param_dtype
    if moe_groups and cfg.num_experts:
        changes["moe_groups"] = moe_groups
    if remat:
        changes["remat"] = remat
    changes.update(replace or {})
    cfg = cfg.replace(**changes) if changes else cfg
    record: Dict[str, Any] = {
        "arch": arch, "shape": sh.name, "mesh": mesh_name, "status": "unknown",
        "kind": sh.kind, "global_batch": sh.global_batch, "seq_len": sh.seq_len,
        "variant": {"reduced": reduced, "microbatches": microbatches, "seq_shard": seq_shard,
                    "param_dtype": cfg.param_dtype, "remat": cfg.remat, "tag": tag},
    }
    if replace:
        record["variant"]["replace"] = dict(replace)
    if inputs is not None:
        record["variant"]["inputs"] = {k: [list(v.shape), str(v.dtype).split(".")[-1]]
                                       for k, v in inputs.items()}
    if cast_params:
        record["variant"]["cast_params"] = True
    specs_in = None if inputs is None else {
        k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in inputs.items()}
    supported, reason = cell_supported(cfg, sh)
    if not supported:
        record.update(status="SKIP", reason=reason)
        return record

    chips = mesh.size
    kw = dict(microbatches=microbatches, seq_shard=seq_shard, moe_pin=moe_pin,
              moe_expert_axis=moe_expert_axis, inputs=specs_in, cast_params=cast_params)
    if chips == 1:
        return _count_cell(record, mesh, cfg, sh, chips, **kw)
    import torch.distributed as dist

    from .mesh import fake_device_mesh

    if dist.is_initialized():
        raise RuntimeError("the partitioned dry run makes its own process group; destroy this "
                           "process's group first")
    try:
        return _count_cell(record, fake_device_mesh(mesh), cfg, sh, chips, **kw)
    finally:
        dist.destroy_process_group()


def _local_nbytes(tree: Any) -> int:
    """Bytes of this device's shards of the tensor leaves of ``tree``."""
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _count_cell(record: Dict[str, Any], mesh: Any, cfg: Any, sh: ShapeConfig, chips: int, *,
                microbatches: int, seq_shard: bool, moe_pin: str, moe_expert_axis: str,
                inputs: Optional[Dict[str, torch.Tensor]],
                cast_params: bool) -> Dict[str, Any]:
    """Builds the cell's step on ``meta`` and counts it: on one chip the
    whole step; on a mesh of more (``mesh`` a fake ``DeviceMesh``) its
    arguments are placed as ``meta`` ``DTensor``s by the shardings and the
    counts are one device's (``count_partitioned``).  ``inputs``: the batch
    in place of the specs' (``run_cell``)."""
    import dataclasses

    from ..dist import sharding_rules as SR
    from ..dist.context import mesh_axis_sizes, use_plan
    from ..dist.placement import place_tree
    from ..models import build_model
    from ..serve.engine import make_serve_step
    from ..train import AdamWConfig, make_train_step
    from . import specs as S
    from .mesh import make_plan
    from .roofline import build_report

    plan = dataclasses.replace(
        make_plan(mesh, fsdp_over_pod=cfg.fsdp_over_pod, seq_shard=seq_shard),
        moe_pin=moe_pin, moe_expert_axis=moe_expert_axis)
    record["plan"] = dataclasses.asdict(plan)
    model = build_model(cfg)
    params = S.params_shape(model)
    if cast_params:
        params = model.cast_for_compute(params)
    p_shard = SR.make_param_shardings(mesh, params, cfg, plan)
    if chips == 1:
        count, place = count_step, (lambda tree, shardings: tree)
    else:
        count, place = (lambda fn: count_partitioned(fn, mesh)), place_tree
    with use_plan(plan, mesh):
        if sh.kind == "train":
            oc = AdamWConfig(state_dtype=cfg.opt_state_dtype)
            state = {"params": params, "opt": S.opt_shape(model, oc)}
            batch_in = S.train_input_specs(cfg, sh) if inputs is None else inputs
            shards: tuple = ({"params": p_shard,
                              "opt": SR.make_opt_shardings(mesh, state["opt"], cfg, plan)},
                             SR.batch_sharding(mesh, plan, batch_in))
            args: tuple = (state, batch_in)
            alias = SR.sharded_nbytes(state, shards[0])  # updated in place
            run_state = {"params": place(params, p_shard), "opt": dict(state["opt"])}
            for k in ("m", "v"):
                run_state["opt"][k] = place(state["opt"][k], shards[0]["opt"][k])
            run_batch = place(batch_in, shards[1])
            step = make_train_step(model, oc, microbatches=microbatches)
            counted = count(lambda: step(run_state, run_batch))
        elif sh.kind == "prefill":
            batch_in = S.prefill_input_specs(cfg, sh) if inputs is None else inputs
            shards = (p_shard, SR.batch_sharding(mesh, plan, batch_in))
            args = (params, batch_in)
            alias = 0
            run_params, run_batch = place(params, p_shard), place(batch_in, shards[1])
            with torch.no_grad():
                counted = count(lambda: model.forward(run_params, run_batch,
                                                      last_token_only=True))
        else:  # decode: one new token over a cache filled to its last row
            tok, cache = S.decode_input_specs(model, cfg, sh)
            tok = tok if inputs is None else inputs
            cache["pos"] = sh.seq_len - 1
            shards = (p_shard, SR.cache_sharding(mesh, plan, cache, cfg),
                      SR.batch_sharding(mesh, plan, tok)["tokens"])
            serve = model.decode_step if cfg.family == "encdec" else make_serve_step(model)
            args = (params, cache, tok["tokens"])
            alias = SR.sharded_nbytes(cache, shards[1])  # updated in place
            run_params, run_cache = place(params, p_shard), place(cache, shards[1])
            run_tok = place({"t": tok["tokens"]}, {"t": shards[2]})["t"]
            with torch.no_grad():
                counted = count(lambda: serve(run_params, run_cache, run_tok))
    out_bytes = S.nbytes(counted["out"]) if chips == 1 else _local_nbytes(counted["out"])
    live = counted["memory"]
    mem = {"argument_bytes": SR.sharded_nbytes(list(args), list(shards)),
           "output_bytes": out_bytes, "temp_bytes": live["temp_bytes"], "alias_bytes": alias}
    mem["per_device_total"] = mem["argument_bytes"] + mem["temp_bytes"]
    note = ("bytes: operand and result bytes of every non-view op, unfused (an upper "
            "estimate); temp_bytes: the peak of the live set of the storages the step "
            "allocates above its arguments (launch/memory.py), each kernel's scratch and "
            "decode's split workspace (made in the step) included; the cuBLAS workspace and "
            "the caching allocator's 512-byte rounding are not; per_device_total = "
            "argument_bytes + temp_bytes")
    if chips > 1:
        note += ("; per device: the step partitioned on meta DTensors over a fake process "
                 "group of the mesh's size, seen from rank 0: argument bytes are shard bytes "
                 "under the sharding rules; FLOPs, bytes and outputs are this device's local "
                 "program (replicated work included); collective bytes are the operand bytes "
                 "of the collectives it issues (launch/comm_cost.py)")
        cost = {"flops": counted["flops"], "bytes": counted["bytes"],
                "collective_bytes": counted["collectives"]["total"],
                "collectives": counted["collectives"]}
    else:
        cost = {"flops": counted["flops"], "bytes": counted["bytes"], "collective_bytes": 0.0}
    rep = build_report(record["arch"], sh.name, record["mesh"], chips, cost, mem, cfg, sh,
                       sh.kind, note=note, mesh_sizes=mesh_axis_sizes(mesh))
    record.update(status="OK", trace_s=round(counted["seconds"], 3), ops=counted["ops"],
                  flops_by_op=counted["flops_by_op"], roofline=rep.to_json(),
                  memory={k: v for k, v in live.items() if k != "temp_bytes"},
                  fits_hbm_80g=bool(mem["per_device_total"] < HBM_BYTES))
    return record


def peak_rss_gb() -> float:
    """This process's peak resident memory in GB: ``VmHWM`` (Linux; reset by
    exec, where ``ru_maxrss`` keeps the parent's peak across fork and exec),
    else ``ru_maxrss``."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1e6  # kB
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def cell_path(out_dir: str, arch: str, shape: str, mesh: str) -> str:
    return os.path.join(out_dir, f"{mesh}__{arch}__{shape}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="one", choices=["one", "single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--summarize", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-parallel activations over the model axis")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--param-dtype", default="", help="override cfg.param_dtype")
    ap.add_argument("--moe-groups", type=int, default=0, help="GShard 2D dispatch groups")
    ap.add_argument("--moe-pin", default="auto", choices=["auto", "group", "group_ep"],
                    help="MoE dispatch-buffer sharding pin")
    ap.add_argument("--moe-expert-axis", default="model", choices=["model", "data"],
                    help="mesh axis sharding the expert dim of MoE weights")
    ap.add_argument("--remat", default="", choices=["", "none", "block"],
                    help="override cfg.remat")
    ap.add_argument("--tag", default="", help="variant tag, a prefix of the record's name")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's scaled_down() (give it a --tag: the record's name)")
    args = ap.parse_args(argv)
    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)

    if args.summarize:
        summarize(out_dir)
        return
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    prefix = f"{args.tag}__" if args.tag else ""
    if args.all:
        from ..configs import ARCH_IDS
        from ..models.config import SHAPES

        done = ok = failed = 0
        for m in meshes:
            for a in ARCH_IDS:
                for s in SHAPES:
                    if os.path.exists(cell_path(out_dir, f"{prefix}{a}", s, m)) and not args.force:
                        done += 1
                        continue
                    print(f"=== {m} / {a} / {s} ===", flush=True)
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
                           "--shape", s, "--mesh", m, "--out", out_dir]
                    for name, default in (("microbatches", 1), ("param_dtype", ""),
                                          ("moe_groups", 0), ("moe_pin", "auto"),
                                          ("moe_expert_axis", "model"), ("remat", ""),
                                          ("tag", "")):
                        value = getattr(args, name)
                        if value != default:
                            cmd += ["--" + name.replace("_", "-"), str(value)]
                    cmd += ["--seq-shard"] if args.seq_shard else []
                    cmd += ["--reduced"] if args.reduced else []
                    rc = subprocess.run(cmd, env={**os.environ, "PYTHONPATH": _pythonpath()},
                                        timeout=3600).returncode
                    ok, failed = (ok + 1, failed) if rc == 0 else (ok, failed + 1)
        print(f"done(existing)={done} ok={ok} failed={failed}")
        summarize(out_dir)
        return

    record: Dict[str, Any] = {"arch": args.arch, "shape": args.shape, "mesh": meshes[0]}
    try:
        record = run_cell(args.arch, args.shape, meshes[0], microbatches=args.microbatches,
                          param_dtype=args.param_dtype, moe_groups=args.moe_groups,
                          remat=args.remat, seq_shard=args.seq_shard, moe_pin=args.moe_pin,
                          moe_expert_axis=args.moe_expert_axis, reduced=args.reduced,
                          tag=args.tag)
    except Exception as e:  # the record says why; the exit code says it failed
        record.update(status="FAIL", error=repr(e), traceback=traceback.format_exc())
        print(record["traceback"], file=sys.stderr)
    record["host_peak_rss_gb"] = peak_rss_gb()
    path = cell_path(out_dir, f"{prefix}{args.arch}", record.get("shape") or args.shape,
                     meshes[0])
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: v for k, v in record.items() if k != "traceback"}, indent=1))
    print(f"record -> {path}")
    sys.exit(0 if record.get("status") in ("OK", "SKIP") else 1)


def _pythonpath() -> str:
    cur = os.environ.get("PYTHONPATH", "")
    return f"{SRC}:{cur}" if cur else SRC


def summarize(out_dir: str) -> None:
    from .report import load

    print(f"{'mesh':6s} {'arch':22s} {'shape':12s} {'status':6s} "
          f"{'compute_s':>10s} {'memory_s':>10s} {'coll_s':>10s} {'dom':>10s} "
          f"{'useful':>7s} {'mem/dev':>9s} {'trace':>8s}")
    for r in load(out_dir):
        rl = r.get("roofline") or {}
        mem_gb = ((rl.get("memory_per_device_bytes") or {}).get("per_device_total") or 0) / 1e9
        coll = f"{rl.get('collective_s', 0):10.4f}"
        print(f"{r.get('mesh', ''):6s} {r.get('arch', ''):22s} {r.get('shape', ''):12s} "
              f"{r.get('status', ''):6s} "
              f"{rl.get('compute_s', 0):10.4f} {rl.get('memory_s', 0):10.4f} "
              f"{coll} {rl.get('dominant', ''):>10s} "
              f"{rl.get('useful_ratio', 0):7.2f} {mem_gb:8.1f}G "
              f"{r.get('trace_s', 0):7.1f}s")


if __name__ == "__main__":
    main()
