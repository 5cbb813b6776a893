"""The port's feed subsystem (``repro_torch.feed``) against the real data
service: twins of ``tests/test_feed.py`` with the torch ``DeviceFeeder`` on
``device="cpu"`` (the CUDA path, pinned staging and a side stream, needs a
card and runs in ``chip_smoke.py``'s train phase).

The feeder imports nothing of the service: it takes ``Dataset.distribute``'s
result (anything with ``.session(**overrides)``), or a raw dataset with
``service=``.  Timing tolerances are those of the JAX suite.
"""
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")
import torch

from repro.data import Dataset
from repro_torch.feed import DeviceFeeder, FeedMetrics, StallWindow, host_layout, put_batch


def _ids_pipeline(n, batch=4):
    """Batches whose contents identify their source elements."""
    return (
        Dataset.range(n)
        .map(lambda i: {"x": np.full((8,), int(i), np.int64)})
        .batch(batch, drop_remainder=True)
    )


class TestDeviceFeeder:
    def test_delivers_every_batch_as_tensors(self, service_factory):
        svc = service_factory(num_workers=2)
        dds = _ids_pipeline(32).distribute(service=svc, processing_mode="dynamic")
        seen = []
        with DeviceFeeder(dds, device="cpu") as feeder:
            for b in feeder:
                assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
                seen.extend(b["x"][:, 0].tolist())
        # DYNAMIC: exactly-once without failures, modulo per-shard
        # drop_remainder tails
        assert len(seen) == len(set(seen))
        assert set(seen) <= set(range(32))
        assert len(seen) >= 16

    def test_double_buffer_hides_slow_producer(self, service_factory):
        """With a sleep-map producer and a sleeping 'accelerator', the feeder
        overlaps production/transfer with compute: wall time must beat the
        no-overlap serial bound by a wide margin."""
        produce_s, compute_s, steps = 0.03, 0.03, 8
        svc = service_factory(num_workers=2)

        def slow(i):
            time.sleep(produce_s)
            return {"x": np.full((4,), int(i), np.float32)}

        dds = (
            Dataset.range(256)
            .map(slow)
            .batch(1)
            .distribute(service=svc, processing_mode="dynamic")
        )
        with DeviceFeeder(dds, device="cpu", depth=2) as feeder:
            feeder.next()  # ramp: job rollout + first production
            t0 = time.perf_counter()
            for _ in range(steps):
                feeder.next()
                time.sleep(compute_s)  # the 'train step'
            wall = time.perf_counter() - t0
        serial = steps * (produce_s + compute_s)
        assert wall < 0.75 * serial, f"no overlap: {wall:.3f}s vs serial bound {serial:.3f}s"
        assert feeder.metrics.steps >= steps
        assert feeder.metrics.compute_s > 0

    def test_clean_shutdown_mid_epoch(self, service_factory):
        svc = service_factory(num_workers=2)
        dds = _ids_pipeline(10_000).distribute(service=svc, processing_mode="dynamic")
        feeder = DeviceFeeder(dds, device="cpu", depth=2)
        for _ in range(3):
            feeder.next()
        feeder.close()
        assert not feeder._thread.is_alive()
        feeder.close()  # idempotent
        with pytest.raises(StopIteration):
            feeder.next()
        # the service survives the mid-epoch disconnect
        assert svc.orchestrator.stats()["num_workers"] == 2

    def test_static_mode_registers_per_host_consumers(self, service_factory):
        """Two 'hosts' (threads) of a static-mode feed consume disjoint
        coordinated slots of every round."""
        svc = service_factory(num_workers=2)
        dds = _ids_pipeline(64, batch=2).distribute(
            service=svc, processing_mode="dynamic", job_name="hosts"
        )
        out = [None, None]

        def host(h):
            f = DeviceFeeder(dds, device="cpu", num_hosts=2, host_index=h)
            got = []
            for b in f:
                got.append(tuple(b["x"][:, 0].tolist()))
                if len(got) >= 4:
                    break
            f.close()
            out[h] = got

        ts = [threading.Thread(target=host, args=(h,)) for h in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert out[0] and out[1], out
        assert len(out[0]) == len(out[1]) == 4
        assert not (set(out[0]) & set(out[1])), out

    def test_raw_dataset_requires_service(self):
        with pytest.raises(TypeError):
            DeviceFeeder(_ids_pipeline(8), device="cpu")

    def test_feed_stall_reaches_dispatcher_stats(self, service_factory):
        """The feeder's stall windows flow: report_feed_stall -> client
        heartbeat -> dispatcher job aggregate -> stats()."""
        svc = service_factory(num_workers=1)

        def slow(i):
            time.sleep(0.02)
            return np.full((4,), int(i), np.float32)

        dds = (
            Dataset.range(4000)
            .map(slow)
            .batch(4)
            .distribute(service=svc, processing_mode="dynamic")
        )
        feeder = DeviceFeeder(dds, device="cpu", report_interval_s=0.1)
        try:
            cs = None
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                feeder.next()
                vals = [j.get("client_stall") for j in svc.orchestrator.stats()["jobs"].values()
                        if j.get("client_stall")]
                if vals:
                    cs = vals[0]
                    break
            assert cs is not None, "no client_stall aggregate ever appeared"
            assert cs["clients"] >= 1
            # a producer sleeping 80ms/batch against a ~0ms consumer must
            # read as heavily stalled, and as fetch-dominated
            assert cs["stall_frac"] > 0.5
            assert cs["fetch_s_per_step"] > cs["transfer_s_per_step"]
        finally:
            feeder.close()

    def test_zero_copy_batches_survive_the_next_fetch(self, service_factory):
        """The feeder's session borrows shm views valid only until the next
        fetch; every delivered tensor is an owned copy, so a batch still
        holds its own elements after later batches were fetched."""
        svc = service_factory(num_workers=1, transport="tcp")
        dds = (
            Dataset.range(48)
            .map(lambda i: {"x": np.full((4096,), int(i), np.int64)})
            .batch(4, drop_remainder=True)
            .distribute(service=svc, processing_mode="dynamic")
        )
        kept = []
        with DeviceFeeder(dds, device="cpu", depth=2) as feeder:
            for b in feeder:
                kept.append((b["x"], b["x"][:, 0].clone()))
        assert feeder._client.metrics.shm_batches > 0  # the batches came as borrowed views
        assert len(kept) >= 8
        for x, ids in kept:
            assert x.is_contiguous() and x.data_ptr() % 8 == 0
            torch.testing.assert_close(x, ids[:, None].expand_as(x), rtol=0, atol=0)
        assert len({int(i) for _, ids in kept for i in ids}) == 4 * len(kept)

    def test_mesh_arguments_are_not_ported(self, service_factory, tmp_path):
        """The mesh path is ported (the name is the test's, from before):
        over a (1, 1) DeviceMesh of one gloo rank, ``mesh=`` and ``plan=``
        give plain tensors on the mesh's device, with the batch shardings
        derived from the first batch; a mesh without a plan, or an abstract
        mesh, is refused."""
        import torch.distributed as dist

        from repro_torch.dist import AbstractMesh, P
        from repro_torch.launch.mesh import make_plan, make_test_mesh

        svc = service_factory(num_workers=1)
        dds = _ids_pipeline(32).distribute(service=svc, processing_mode="dynamic")
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                                world_size=1)
        try:
            mesh = make_test_mesh(1, 1)
            with DeviceFeeder(dds, mesh=mesh, plan=make_plan(mesh)) as feeder:
                b = feeder.next(timeout=60)
                assert type(b["x"]) is torch.Tensor and b["x"].device.type == "cpu"
                assert feeder.shardings["x"].spec == P("data")
            with pytest.raises(TypeError, match="together"):
                DeviceFeeder(dds, mesh=mesh)
            with pytest.raises(TypeError, match="AbstractMesh"):
                DeviceFeeder(dds, device="cpu", mesh=AbstractMesh((1, 1), ("data", "model")),
                             plan=make_plan(mesh))
        finally:
            dist.destroy_process_group()

    def test_no_device_means_cuda_or_an_error(self, service_factory, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceFeeder(_ids_pipeline(8), service=None)


class TestPlacement:
    def test_cpu_put_batch_copies_read_only_views(self):
        base = np.arange(12, dtype=np.float32).reshape(3, 4)
        view = base[:, 1:3]
        view.flags.writeable = False
        placed, event = put_batch({"a": view, "b": [np.int32(7), base]}, torch.device("cpu"))
        assert event is None
        base[:] = -1  # the source changes after the copy
        assert placed["a"].tolist() == [[1.0, 2.0], [5.0, 6.0], [9.0, 10.0]]
        assert placed["b"][0].item() == 7 and placed["b"][1].dtype == torch.float32

    def test_host_layout_without_process_group(self):
        assert host_layout() == (0, 1)


class TestFeedMetrics:
    def test_breakdown_and_stall_fraction(self):
        m = FeedMetrics()
        m.add_fetch(0.2)
        m.add_transfer(0.1, 1024)
        m.add_step(idle=0.3, compute=None, depth_frac=0.5)
        m.add_step(idle=0.1, compute=0.1, depth_frac=0.5)
        assert m.steps == 2 and m.batches_fetched == 1
        assert m.idle_s == pytest.approx(0.4)
        assert m.stall_fraction == pytest.approx(0.4 / 0.5)
        bd = m.breakdown()
        assert bd["fetch"] == pytest.approx(0.5)
        assert sum(bd.values()) == pytest.approx(1.0)
        assert m.summary()["bytes_to_device"] == 1024
        assert m.registry.values()["feed_bytes_to_device"] == 1024

    def test_stall_window_reports_deltas_only(self):
        m = FeedMetrics()
        w = StallWindow(m)
        assert w.report() is None  # no steps yet
        m.add_step(idle=0.5, compute=0.5, depth_frac=0.0)
        r = w.report()
        assert r["stall_frac"] == pytest.approx(0.5)
        assert r["steps"] == 1
        assert w.report() is None  # nothing new since
        m.add_step(idle=0.0, compute=1.0, depth_frac=1.0)
        r = w.report()
        assert r["stall_frac"] == pytest.approx(0.0)
