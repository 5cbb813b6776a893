"""Training launcher: any assigned arch x shape as a one-card dry run on
``meta``, or a training run on this host's card, always fed through the
disaggregated data service (twin of the JAX package's
``repro/launch/train.py``).

Two modes:

  --execute      real training, data from a local service deployment
                 (dispatcher and workers): REDUCED config (``scaled_down()``)
                 by default, the smoke-scale twin of the production job;
                 ``--full-width`` trains the published config instead.
  (default)      FULL config: the pre-flight a real launch runs first, the
                 step built and counted on ``meta`` (``launch.dryrun``),
                 its roofline printed and written as a record.

Both run in a subprocess.  ``--execute`` runs ``examples/train_e2e_torch.py``,
which starts the service (``repro.core``, ``repro.data``): this package itself
imports nothing of ``repro``.  The dry run takes ``--mesh one`` (the default,
one card) or the production meshes ``single`` (256 chips) and ``multi``
(512), with ``--seq-shard``, ``--moe-pin`` and ``--moe-expert-axis`` for the
plan over them.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.train --arch kimi-k2-1t-a32b --shape train_4k --mesh multi
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b --execute --steps 30 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b --execute --full-width --batch 1 --seq 8192 --steps 6
"""
import argparse
import os
import subprocess
import sys

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
EXECUTE_SCRIPT = os.path.join(SRC, "..", "examples", "train_e2e_torch.py")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="one", choices=["one", "single", "multi"])
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--moe-pin", default="auto", choices=["auto", "group", "group_ep"])
    ap.add_argument("--moe-expert-axis", default="model", choices=["model", "data"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--execute", action="store_true",
                    help="train for real on this host's card (a reduced config by default)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda", help="where --execute trains (cuda or cpu)")
    ap.add_argument("--batch", type=int, default=4, help="--execute's global batch")
    ap.add_argument("--seq", type=int, default=64, help="--execute's sequence length")
    ap.add_argument("--full-width", action="store_true",
                    help="--execute the published config, not its scaled_down()")
    ap.add_argument("--out", default="", help="the dry run's record directory")
    args = ap.parse_args(argv)

    if args.execute:
        if not os.path.exists(EXECUTE_SCRIPT):
            raise SystemExit(f"--execute runs {EXECUTE_SCRIPT}, which is not in this checkout")
        cmd = [sys.executable, EXECUTE_SCRIPT, "--launcher", "--arch", args.arch,
               "--steps", str(args.steps), "--workers", str(args.workers),
               "--microbatches", str(args.microbatches), "--device", args.device,
               "--batch", str(args.batch), "--seq", str(args.seq)]
        if args.ckpt_dir:
            cmd += ["--ckpt-dir", args.ckpt_dir]
        if args.full_width:
            cmd.append("--full-width")
    else:
        # pre-flight: the full config's step counted on meta, in its own process
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", args.arch.replace("-", "_").replace(".", "p"),
               "--shape", args.shape, "--mesh", args.mesh, "--tag", "preflight"]
        if args.seq_shard:
            cmd.append("--seq-shard")
        cmd += ["--moe-pin", args.moe_pin, "--moe-expert-axis", args.moe_expert_axis]
        if args.microbatches != 1:
            cmd += ["--microbatches", str(args.microbatches)]
        if args.out:
            cmd += ["--out", args.out]
    cur = os.environ.get("PYTHONPATH", "")
    env = {**os.environ, "PYTHONPATH": f"{SRC}:{cur}" if cur else SRC}
    sys.exit(subprocess.run(cmd, env=env).returncode)


if __name__ == "__main__":
    main()
