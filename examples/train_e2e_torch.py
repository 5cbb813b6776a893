"""End-to-end training on the PyTorch port, with ALL input preprocessing
disaggregated to the data service's workers (twin of ``examples/train_e2e.py``
and of ``repro.launch.train``'s ``--execute`` run).

Two modes, one trainer: the service (dispatcher and workers) builds the
batches, ``repro_torch.feed.DeviceFeeder`` fetches them and moves them to the
card behind a double buffer, and ``repro_torch.train`` trains.

* Corpus (the default; ``examples/train_e2e.py``'s run): synthetic zipf
  documents tokenized and packed to 256 tokens on the workers, a ~100M
  parameter LM of starcoder2's family (``--tiny``: starcoder2-3b's
  ``scaled_down()``), a checkpoint every ``--ckpt-every`` steps in the JAX
  checkpoint format, resumable with ``--resume``.
* ``--launcher`` (what ``python -m repro_torch.launch.train --execute`` runs):
  any arch, its batches drawn on the workers in the layout of
  ``repro_torch.launch.specs.train_input_specs`` with numpy exactly as the
  JAX launcher draws them; ``scaled_down()`` unless ``--full-width``.  It
  prints the loss and s/step every 5 steps, the feed's idle, stall and
  breakdown, and last one JSON line: the losses, the first and the last
  batch's losses again after the last step, s/step, tokens/s, peak memory,
  the feed's summary, the kernels' launch counts over the steps, the
  seconds of any kernel build this process ran (none when the libraries
  are built already) and what was left running after the service stopped.

Of the JAX package it imports the service only (``repro.core``,
``repro.data``), which loads no jax: ``src/repro`` has no package file that
would.

Run:   PYTHONPATH=src python examples/train_e2e_torch.py --steps 200
Quick: PYTHONPATH=src python examples/train_e2e_torch.py --steps 20 --tiny --device cpu
"""
import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro.core import start_service  # noqa: E402
from repro.data import Dataset  # noqa: E402
from repro_torch.bridge import flatten_with_paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.feed import DeviceFeeder  # noqa: E402
from repro_torch.kernels import _build, launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig,
    init_train_state,
    latest_step,
    make_eval_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)

SEQ = 256
BATCH = 8


# ---------------------------------------------------------------------------
# corpus mode (examples/train_e2e.py)
# ---------------------------------------------------------------------------
def corpus_pipeline(vocab: int, num_docs: int = 100_000) -> Dataset:
    """Synthetic 'documents' tokenized and packed on the WORKERS."""

    def make_doc(i):
        rng = np.random.default_rng(int(i))
        n = int(rng.integers(64, 512))
        # zipf-ish token ids: a real tokenizer's output distribution
        return np.minimum(rng.zipf(1.3, n), vocab - 1).astype(np.int64)

    def pack(doc):
        out = np.zeros((SEQ + 1,), np.int64)
        n = min(len(doc), SEQ + 1)
        out[:n] = doc[:n]
        return {"tokens": out[:-1], "labels": out[1:]}

    return (
        Dataset.range(num_docs)
        .shuffle(2048, seed=0)
        .map(make_doc, stochastic=False)
        .map(pack)
        .batch(BATCH, drop_remainder=True)
        .prefetch(8)
    )


def build(tiny: bool):
    cfg = get_config("starcoder2-3b")
    if tiny:
        cfg = cfg.scaled_down()
    else:
        # ~100M-param config of the same family
        cfg = cfg.replace(
            num_layers=10, d_model=640, num_heads=10, num_kv_heads=2,
            head_dim=64, d_ff=2560, vocab_size=32768,
            dtype="float32", param_dtype="float32", remat="none",
        )
    return cfg, build_model(cfg)


def run_corpus(args) -> None:
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_train_e2e")
    cfg, model = build(args.tiny)
    n_params = sum(t.numel() for _, t in flatten_with_paths(S.params_shape(model)))
    print(f"model: {cfg.name} reduced, {n_params/1e6:.1f}M params")

    opt = AdamWConfig(lr=3e-4, warmup_steps=20, decay_steps=args.steps)
    state = init_train_state(model, 0, opt, device=args.device)
    start = 0
    if args.resume and latest_step(ckpt_dir) is not None:
        state, start = restore_checkpoint(ckpt_dir, state)
        print(f"resumed from step {start}")
    step_fn = make_train_step(model, opt)

    service = start_service(num_workers=args.workers)
    try:
        ds = corpus_pipeline(cfg.vocab_size).distribute(
            service=service, processing_mode="dynamic")
        # the feeder replaces a manual next(it) + copy loop: fetch and the
        # host->device copy run behind a double buffer, so the only time the
        # step waits is when the SERVICE falls behind - visible as
        # feeder.metrics.idle_s, not hidden in the step time
        with DeviceFeeder(ds, device=args.device, depth=2) as feeder:
            t0 = time.perf_counter()
            tokens_seen = 0
            for step in range(start + 1, args.steps + 1):
                state, metrics = step_fn(state, feeder.next())
                tokens_seen += BATCH * SEQ
                if step % 10 == 0 or step == args.steps:
                    loss = float(metrics["loss"])  # host sync: the step is done
                    tps = tokens_seen / (time.perf_counter() - t0)
                    fm = feeder.metrics
                    print(f"step {step:4d}  loss {loss:.4f}  lr {float(metrics['lr']):.2e}  "
                          f"idle {fm.idle_s_per_step*1e3:.1f}ms/step  {tps:,.0f} tok/s",
                          flush=True)
                if step % args.ckpt_every == 0:
                    save_checkpoint(ckpt_dir, step, state)
                    print(f"  checkpoint @ {step}")
            bd = feeder.metrics.breakdown()
            print(f"feed breakdown: fetch {bd['fetch']:.0%} / "
                  f"transfer {bd['transfer']:.0%} / compute {bd['compute']:.0%}")
    finally:
        service.orchestrator.stop()
    print("done - re-run with --resume to continue from the last checkpoint")


# ---------------------------------------------------------------------------
# launcher mode (repro_torch.launch.train --execute)
# ---------------------------------------------------------------------------
def spec_batches(cfg, B: int, seq: int):
    """(make_batch, spec): example ``i`` of the launcher's pipeline, drawn
    as the JAX launcher draws it - a generator seeded with i, and per key of
    ``train_input_specs`` in order, integers in [1, vocab) as int32 or
    standard normals as f32."""
    spec = S.train_input_specs(cfg, ShapeConfig("exec", seq, B, "train"))

    def make_batch(i):
        rng = np.random.default_rng(int(i))
        out = {}
        for k, v in spec.items():
            shp = tuple(v.shape[1:])  # per example
            if v.dtype.is_floating_point:
                out[k] = rng.standard_normal(shp).astype(np.float32)
            else:
                out[k] = rng.integers(1, cfg.vocab_size, shp).astype(np.int32)
        return out

    return make_batch, spec


def leftovers(grace_s: float = 2.0) -> dict:
    """Non-daemon threads other than this one and child processes still
    alive ``grace_s`` after the service stopped (a join may be in flight)."""
    deadline = time.monotonic() + grace_s
    while True:
        threads = [t.name for t in threading.enumerate()
                   if t is not threading.current_thread() and t.is_alive() and not t.daemon]
        procs = [p.name for p in multiprocessing.active_children() if p.is_alive()]
        if (not threads and not procs) or time.monotonic() > deadline:
            return {"threads": threads, "processes": procs}
        time.sleep(0.05)


def run_launcher(args) -> None:
    cfg = get_config(args.arch)
    if args.full_width:
        # A warmup as in real runs.  AdamW's first steps move every entry by
        # about lr, along a gradient spread over billions of random
        # parameters, so the loss is steep along them: on starcoder2-3b a
        # first step of lr 2.5e-4 throws it from 11.3 to 20, and steps of
        # 3.3e-6 already overshoot.  lr rises to 2e-6 over the run's steps.
        opt = AdamWConfig(lr=2e-6, warmup_steps=args.steps)
    else:
        cfg = cfg.scaled_down()
        opt = AdamWConfig(lr=1e-3, warmup_steps=5, decay_steps=args.steps)
    model = build_model(cfg)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, 0, opt, device=dev)
    step_fn = make_train_step(model, opt, microbatches=args.microbatches)
    B, S = args.batch, args.seq
    make_batch, _ = spec_batches(cfg, B, S)
    width = "full width" if args.full_width else "reduced"
    print(f"[{args.arch}] {width}, B={B} S={S}, {args.workers} service workers, "
          f"device {dev}", flush=True)

    svc = start_service(num_workers=args.workers)
    losses, secs = [], []
    try:
        ds = (
            Dataset.range(10_000)
            .map(make_batch)
            .batch(B, drop_remainder=True)
            .distribute(service=svc, processing_mode="dynamic")
        )
        # device feed: background fetch + host->device copy with a double
        # buffer - the step never waits on the host loop unless the service
        # itself falls behind (feeder.metrics says which)
        with DeviceFeeder(ds, device=dev, depth=2) as feeder:
            reset_launch_counts()
            t0 = time.perf_counter()
            for step in range(1, args.steps + 1):
                t = time.perf_counter()
                batch = feeder.next()
                if step == 1:  # kept for after the run; the job's start, apart
                    first, idle_first = batch, feeder.metrics.idle_s
                state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))  # host sync: the step is done
                secs.append(time.perf_counter() - t)
                if step % 5 == 0 or step == args.steps:
                    print(f"[{args.arch}] step {step:3d} loss {losses[-1]:.4f} "
                          f"({(time.perf_counter() - t0) / step:.2f}s/step)", flush=True)
            counts = launch_counts()
            # the first and the last batch again, after the last step: each
            # against its loss in its own step (the same data, before that
            # step's update)
            eval_step = make_eval_step(model)
            first_after = float(eval_step(state["params"], first)["loss"])
            last_after = float(eval_step(state["params"], batch)["loss"])
            fm = feeder.metrics
            bd = fm.breakdown()
            print(f"[{args.arch}] feed: idle {fm.idle_s_per_step*1e3:.1f}ms/step "
                  f"(stall {fm.stall_fraction:.1%}) - "
                  f"fetch {bd['fetch']:.0%} / transfer {bd['transfer']:.0%} / "
                  f"compute {bd['compute']:.0%}", flush=True)
            feed = fm.summary()
            # the feed's idle a step once the job runs (steps 2..n)
            feed["idle_s_per_step_after_first"] = (
                (fm.idle_s - idle_first) / (args.steps - 1) if args.steps > 1 else 0.0)
        if args.ckpt_dir:
            save_checkpoint(args.ckpt_dir, args.steps, state)
            print(f"checkpoint -> {args.ckpt_dir}")
    finally:
        svc.orchestrator.stop()
    steady = secs[1:] if len(secs) > 1 else secs
    sps = sum(steady) / len(steady)
    print(json.dumps({
        "run": "train_e2e_torch", "arch": args.arch, "full_width": args.full_width,
        "device": str(dev), "B": B, "S": S, "steps": args.steps, "workers": args.workers,
        "losses": losses, "first_batch_loss_after": first_after,
        "last_batch_loss_after": last_after, "seconds_per_step": secs,
        "steady_seconds_per_step": sps, "tokens_per_s": B * S / sps,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        "feed": feed, "launches": counts, "kernel_builds": dict(_build.build_seconds),
        "left_running": leftovers()}), flush=True)


# the flags that only one mode reads; the other mode refuses them
CORPUS_FLAGS = {"ckpt_every": 50, "resume": False, "tiny": False}
LAUNCHER_FLAGS = {"arch": "starcoder2-3b", "batch": 4, "seq": 64, "full_width": False,
                  "microbatches": 1}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launcher", action="store_true",
                    help="the launcher's --execute run (spec batches, any --arch)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="",
                    help="corpus mode: default <tmp>/repro_torch_train_e2e; launcher mode: "
                         "a checkpoint at the end only when given")
    ap.add_argument("--ckpt-every", type=int, help="corpus mode (default 50)")
    ap.add_argument("--resume", action="store_true", default=None, help="corpus mode")
    ap.add_argument("--tiny", action="store_true", default=None, help="corpus mode")
    ap.add_argument("--arch", help="launcher mode (default starcoder2-3b)")
    ap.add_argument("--batch", type=int, help="launcher mode (default 4)")
    ap.add_argument("--seq", type=int, help="launcher mode (default 64)")
    ap.add_argument("--full-width", action="store_true", default=None, help="launcher mode")
    ap.add_argument("--microbatches", type=int, help="launcher mode (default 1)")
    args = ap.parse_args()
    mine, other = ((LAUNCHER_FLAGS, CORPUS_FLAGS) if args.launcher
                   else (CORPUS_FLAGS, LAUNCHER_FLAGS))
    given = ["--" + k.replace("_", "-") for k in other if getattr(args, k) is not None]
    if given:
        ap.error(f"{' '.join(given)}: not read in "
                 f"{'launcher' if args.launcher else 'corpus'} mode")
    for k, default in mine.items():
        if getattr(args, k) is None:
            setattr(args, k, default)
    if args.launcher:
        run_launcher(args)
    else:
        run_corpus(args)

if __name__ == "__main__":
    main()
