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
