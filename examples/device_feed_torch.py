"""Device feed over a mesh: service batches landing as DTensors on a
(data=2, model=2) ``DeviceMesh`` of 4 gloo ranks on the CPU (twin of
``examples/device_feed.py``, which forces 4 CPU devices in one JAX process;
in PyTorch each device is a rank).

The parent starts the data service (tcp transport) and spawns the ranks with
its dispatcher address.  Every rank builds the same mesh and plan and runs a
``DeviceFeeder(mesh=, plan=)``: the mesh's first rank holds the service
session and scatters each rank the rows of its data coordinate, laid out by
the batch shardings the train step uses (``repro_torch.dist.sharding_rules.
batch_sharding``), so each batch arrives already laid out for compute:

  service workers ──host batches──▶ leader rank ──scatter──▶ every rank's
      transfer thread ──place──▶ double buffer ──next()──▶ DTensor on the mesh

Run:  PYTHONPATH=src python examples/device_feed_torch.py
"""
import os
import sys
import tempfile

import numpy as np

from repro.core import DistributedDataset, start_service
from repro.data import Dataset, register

BATCH = 8  # divisible by the data axis (2): shards, not replicates
WORLD = 4


@register("examples.device_feed_torch.example")
def example(i):
    rng = np.random.default_rng(int(i))
    return {
        "tokens": rng.integers(1, 1000, (16,)).astype(np.int32),
        "labels": rng.integers(1, 1000, (16,)).astype(np.int32),
    }


def rank_main(rank: int, init_method: str, address: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import ShardingPlan
    from repro_torch.feed import DeviceFeeder
    from repro_torch.launch.mesh import make_test_mesh

    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=WORLD)
    try:
        mesh = make_test_mesh(2, 2)
        plan = ShardingPlan(data_axes=("data",), model_axis="model")
        # over tcp (shm=False): the co-located shm:// ring is the
        # worker-process data plane, not what this example shows
        graph = Dataset.range(64).map(example).batch(BATCH, drop_remainder=True).graph
        ds = DistributedDataset(graph, address, processing_mode="dynamic", shm=False)
        with DeviceFeeder(ds, mesh=mesh, plan=plan, depth=2) as feeder:
            n = 0
            for batch in feeder:
                tok = batch["tokens"]
                assert isinstance(tok, DTensor)
                n += 1
                if n == 1:
                    coord = tuple(mesh.get_coordinate())
                    rows = BATCH // mesh.size(0)
                    lo = coord[0] * rows
                    say(f"rank {rank} at (data, model) = {coord}: batch leaf {tuple(tok.shape)} "
                        f"{tok.dtype}, placements {list(tok.placements)}, local rows "
                        f"{lo}..{lo + rows} {tuple(tok.to_local().shape)}")
            fm = feeder.metrics
            say(f"rank {rank}: consumed {n} sharded batches; idle "
                f"{fm.idle_s_per_step * 1e3:.1f}ms/step, {fm.bytes_to_device / 1e3:.0f} KB "
                "to device")
    finally:
        dist.destroy_process_group()


def say(msg: str) -> None:
    sys.stdout.write(msg + "\n")  # one write: the ranks share the terminal
    sys.stdout.flush()


def main() -> None:
    import torch.multiprocessing as mp

    service = start_service(num_workers=2, transport="tcp")
    try:
        with tempfile.TemporaryDirectory() as tmp:  # the ranks' rendezvous file
            init_method = f"file://{os.path.join(tmp, 'init')}"
            # join=True joins every rank and raises if one failed
            mp.start_processes(rank_main, args=(init_method, service.dispatcher_address),
                               nprocs=WORLD, join=True, start_method="spawn")
    finally:
        service.orchestrator.stop()


if __name__ == "__main__":
    main()
