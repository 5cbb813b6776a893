"""The training driver: one cell's run of ``repro_torch`` training fed by
``repro_torch.feed.DeviceFeeder``.

Set-up builds the one training object - the model (``build_model``), the
step (``make_train_step``) and its state, the weights made by the benchmark
from the seed - and the feeder over the traffic's source, then drives it
through ``setup_steps`` steps of the window's own call and feed.  In the
first step it copies the family's kernel call (``KERNEL_CALL``), inputs and
output, to the host; after it, each piece's first gradient as AdamW took it
(the first moment over 1 - b1); after the last, each piece's change since
the start.  What set-up made is then frozen out of the garbage collector's
reach (``gc.freeze``): a full pass over it takes about 0.2 s and, every six
to eight steps, stalled the step it fell in.  The window then runs the same
loop for the cell's seconds: every step's completion is a CUDA event, read
after the window.  With a trace, a few more steps run under the profiler
after the window.

Once the window has closed and the program's state is freed, the plain
reference (``bench/reference.py`` and the family's file) takes the same
weights and the source's first batches through the same steps, and works
the kernel call out again from its inputs; ``bench/compare.py`` judges the
readings, and every batch the step received is checked against the
source's batch of that index.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import inspect
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from portbench.bench import compare, reference
from portbench.bench import trace as TR
from portbench.bench.layout import Cell, kernel_families


def quantile(values: List[float], q: float) -> float:
    """The q-quantile with linear interpolation between order statistics
    (numpy's default, ``statistics.quantiles``' "inclusive")."""
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def port_config(cell: Cell):
    """The port's configuration as the benchmark's file states it: the
    port's own config of that name with every number of the file's
    ``model`` and ``precision`` that it has a field for."""
    from repro_torch.configs import get_config
    from repro_torch.models import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    given = {**cell.config["model"], **cell.config["precision"]}
    return get_config(cell.config["port_config"]).replace(
        **{k: v for k, v in given.items() if k in fields})


def check_program(model, table: reference.LeafTable, z_loss: float) -> None:
    """The program's parameter layout, on ``meta``, must be the reference's
    and its loss's z-loss the configuration's: else the two compute
    different things and no reading means anything."""
    from repro_torch.train import step as step_mod

    got = {p: tuple(t.shape) for p, t in reference.tree_leaves(model.init(device="meta"))}
    want = table.shapes()
    if got != want:
        raise RuntimeError(f"the port's parameters differ from the reference's: "
                           f"{sorted(set(got.items()) ^ set(want.items()))[:6]}")
    default = inspect.signature(step_mod.cross_entropy).parameters["z_loss"].default
    if default != z_loss:
        raise RuntimeError(f"the port's z-loss is {default}, the configuration's {z_loss}")


class FirstCall:
    """Records the inputs and the first output of the first call of
    ``module.name`` (``where``) while it is open, each copied to the host;
    ``got`` stays None if no call came.  The call itself is the program's,
    unchanged."""

    def __init__(self, where: Optional[Tuple[str, str]]):
        self.where, self.got = where, None

    def __enter__(self) -> "FirstCall":
        if self.where is not None:
            module = importlib.import_module(self.where[0])
            self.orig = getattr(module, self.where[1])

            def spy(*args, **kwargs):
                out = self.orig(*args, **kwargs)
                if self.got is None:
                    first = out[0] if isinstance(out, (tuple, list)) else out
                    self.got = {"args": [a.detach().cpu() if torch.is_tensor(a) else a
                                         for a in args],
                                "out": first.detach().cpu()}
                return out

            setattr(module, self.where[1], spy)
        return self

    def __exit__(self, *exc: Any) -> None:
        if self.where is not None:
            setattr(importlib.import_module(self.where[0]), self.where[1], self.orig)


class Program:
    """The system under test as one cell runs it."""

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        from repro_torch.feed import DeviceFeeder
        from repro_torch.models import build_model
        from repro_torch.train import AdamWConfig, init_state, make_train_step

        self.cell, self.seed, self.device = cell, seed, device
        m, opt, sched = cell.config["model"], cell.config["optimizer"], cell.traffic["schedule"]
        self.model = build_model(port_config(cell))
        self.table = reference.LeafTable(cell.family.leaf_shapes(m))
        check_program(self.model, self.table, opt["z_loss"])
        self.flat = reference.make_flat(self.table, seed, device, cell.family.init_rules(m))
        params = reference.tree_of(self.table, self.flat)
        self.opt_cfg = AdamWConfig(
            lr=sched["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
            weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"],
            state_dtype=cell.config["precision"]["opt_state_dtype"],
            warmup_steps=sched["warmup_steps"], decay_steps=sched["decay_steps"],
            min_lr_ratio=sched["min_lr_ratio"])
        self.state = {"params": params, "opt": init_state(params, self.opt_cfg)}
        self.step_fn = make_train_step(self.model, self.opt_cfg)
        src = cell.source.make(cell.traffic, cell.token_ids, seed)
        self.feeder = DeviceFeeder(src, device=device, depth=cell.traffic["feeder_depth"])
        self.delivered: List[Dict[str, torch.Tensor]] = []
        self.losses: List[torch.Tensor] = []

    def step(self) -> None:
        from torch.profiler import record_function

        with record_function("portbench.next_batch"):
            batch = self.feeder.next()
        self.delivered.append(batch)
        with record_function("portbench.step"):
            self.state, metrics = self.step_fn(self.state, batch)
        if len(self.losses) < self.cell.traffic["setup_steps"]:
            self.losses.append(metrics["total_loss"])

    def first_steps(self) -> Dict[str, Any]:
        """The set-up's steps and the readings the reference checks."""
        b1 = self.cell.config["optimizer"]["b1"]
        out: Dict[str, Any] = {"grad1": {}, "update": {}}
        for i in range(self.cell.traffic["setup_steps"]):
            if i == 0:
                with FirstCall(getattr(self.cell.family, "KERNEL_CALL", None)) as call:
                    self.step()
                out["kernel_call"] = call.got
            else:
                self.step()
            if i == 0:
                moments = dict(reference.tree_leaves(self.state["opt"]["m"]))
                for piece, path, *_ in self.table.pieces():
                    out["grad1"][piece] = math.sqrt(reference.square_sum(
                        reference.piece_of(moments[path], piece))) / (1 - b1)
        out["losses"] = [float(x) for x in self.losses]
        self.t_steps = time.perf_counter()
        init = reference.InitialPieces(self.seed, self.device,
                                       self.cell.family.init_rules(self.cell.config["model"]),
                                       self.table.total)
        for piece, path, shape, off, n in self.table.pieces():
            out["update"][piece] = math.sqrt(reference.square_sum(
                self.flat[off:off + n] - init.get(path, shape, off, n)))
        return out

    def delivered_on_host(self) -> List[Dict[str, Any]]:
        return [{k: v.cpu().numpy() for k, v in b.items()} for b in self.delivered]

    def close(self) -> None:
        self.feeder.close()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Collections:
    """The garbage collector's passes while it is open: [step, generation,
    ms] each, the step being the window's step under way."""

    def __init__(self, marks: List[Any]):
        self.marks, self.passes, self._t = marks, [], 0.0

    def __call__(self, phase: str, info: Dict[str, int]) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.passes.append([len(self.marks), info["generation"],
                                (time.perf_counter() - self._t) * 1e3])

    def __enter__(self) -> "_Collections":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        gc.callbacks.remove(self)


def _window(prog: Program, seconds: float) -> Dict[str, Any]:
    """The measured window: steps until ``seconds`` have passed on the host
    clock, each step's completion an event read afterwards."""
    cuda = prog.device.type == "cuda"
    feed = prog.feeder.metrics
    idle0, steps0 = feed.idle_s, feed.steps
    marks: List[Any] = []
    host_ms: List[float] = []
    _sync(prog.device)
    start = torch.cuda.Event(enable_timing=True) if cuda else None
    t0 = time.perf_counter()
    if cuda:
        start.record()
    with _Collections(marks) as collections:
        while True:
            prog.step()
            now = time.perf_counter()
            host_ms.append((now - t0) * 1e3)
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)
            else:
                marks.append(now)
            if now - t0 >= seconds:
                break
        _sync(prog.device)
    t1 = time.perf_counter()
    if cuda:
        ends = [start.elapsed_time(ev) for ev in marks]  # ms since the window's start
    else:
        ends = [(t - t0) * 1e3 for t in marks]
    step_ms = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    return {"steps": len(marks), "seconds": t1 - t0, "step_ms": step_ms,
            "host_ms": host_ms, "gc_passes": collections.passes,
            "feed_idle_s": feed.idle_s - idle0, "feed_steps": feed.steps - steps0}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, on_window_closed: Optional[Callable[[], None]] = None
        ) -> Dict[str, Any]:
    """One run of the cell.  Returns the end-to-end metrics, what the
    per-layer readers read (``"layer_run"``), the device's figures and the
    checks of ``correct``."""
    B, S = cell.traffic["batch"], cell.traffic["seq"]
    cuda = device.type == "cuda"
    t_run = time.perf_counter()
    prog = Program(cell, seed, device)
    t_built = time.perf_counter()
    readings = prog.first_steps()
    _sync(device)
    t_read = time.perf_counter()
    # what set-up left behind goes out of the collector's reach, so that a
    # full pass in the window scans only what the window makes
    gc.collect()
    gc.freeze()
    t_ready = time.perf_counter()
    setup_s = t_ready - t_start
    phases = {"imports": t_run - t_start, "model_weights_feeder": t_built - t_run,
              "setup_steps": prog.t_steps - t_built, "change_read": t_read - prog.t_steps,
              "gc_freeze": t_ready - t_read}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    win = _window(prog, seconds)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    traced = None
    if trace:
        traced = TR.record(lambda n: [prog.step() for _ in range(n)],
                           cell.traffic["profiled_steps"], cuda, lambda: _sync(device))
    if on_window_closed is not None:
        on_window_closed()
    peak = max(peak, torch.cuda.max_memory_allocated(device) if cuda else 0)
    prog.close()
    delivered = prog.delivered_on_host()
    del prog
    gc.unfreeze()  # the program's cycles, frozen with it, are collectable again
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check(cell, seed, device, readings, delivered)
    families = TR.Families(kernel_families(cell.base))
    out: Dict[str, Any] = {
        "attempted": len(delivered),
        "failed": int(checks["batch_mismatches"]["value"]),
        "checks": checks,
        "metrics": {"train_tokens_per_s": win["steps"] * B * S / win["seconds"],
                    "step_ms_p90": quantile(win["step_ms"], 0.9),
                    "setup_s": setup_s},
        "memory_peak_bytes": int(peak),
        "diagnostics": {"setup_phases_s": phases, "window_step_ms": win["step_ms"],
                        "window_host_ms": win["host_ms"], "gc_passes": win["gc_passes"],
                        "check_s": time.perf_counter() - t_check},
        "layer_run": {"cell": cell, "window": win, "tokens_per_step": B * S,
                      "peak_window_bytes": int(window_peak), "trace": traced,
                      "families": families},
    }
    if traced is not None:
        out["busy_s"] = TR.busy_s(traced)
        out["window_s"] = traced.window_s
        out["breakdown"] = TR.breakdown(traced, families)
    return out


def check(cell: Cell, seed: int, device: torch.device, readings: Dict[str, Any],
          delivered: List[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """The reference's steps on the source's first batches, and every
    delivered batch against the source's batch of its index."""
    m = cell.config["model"]
    want = cell.source.batches(cell.traffic, cell.token_ids, seed, len(delivered))
    mismatches = sum(1 for got, ref in zip(delivered, want)
                     if set(got) != set(ref) or any(
                         got[k].shape != ref[k].shape or (got[k] != ref[k]).any() for k in ref))
    ref = reference.train_steps(cell.family, m, cell.config["optimizer"],
                                cell.traffic["schedule"], seed,
                                want[:cell.traffic["setup_steps"]], device)
    values = {"batch_mismatches": float(mismatches), **compare.gaps(readings, ref)}
    number = getattr(cell.family, "KERNEL_NUMBER", None)
    if number is not None:
        values[number] = kernel_gap(cell, readings.get("kernel_call"), device)
    return compare.judge(values, cell.limits)


def kernel_gap(cell: Cell, call: Optional[Dict[str, Any]], device: torch.device,
               lower: Optional[str] = None) -> float:
    """The family's kernel call as the program made it (or, with ``lower``,
    as the family's control makes it) against the reference's f32 work on
    the same inputs; infinite where the program made no such call."""
    if call is None:
        return math.inf
    args = [a.to(device) if torch.is_tensor(a) else a for a in call["args"]]
    with reference.tf32_off():
        want = cell.family.kernel_reference(args)
        got = call["out"].to(device) if lower is None else \
            cell.family.kernel_reference(args, lower)
    return compare.output_gap(got, want)
