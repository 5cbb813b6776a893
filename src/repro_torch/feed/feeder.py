"""DeviceFeeder: the bridge between the data service and the card (twin of
the JAX package's ``repro/feed/feeder.py``).

The service half of the repo ends at a host iterator (a session of a
distributed dataset yields numpy batches); the training step starts at
tensors on the device.  The feeder runs the hop between them off the step's
critical path:

1. **Per-host consumer registration.**  In ``static`` mode host h of a
   multi-host job registers as consumer h of ``num_hosts`` (coordinated
   reads: every round, host h receives slot h), so hosts consume disjoint,
   aligned shards with no coordination of their own.  In ``dynamic`` mode
   each host is an independent client of a DYNAMIC job.  The host layout is
   the ``torch.distributed`` rank and world size (``sharded.host_layout``);
   over a mesh, the mesh is one host (0 of 1) unless the caller says.

2. **Background fetch + transfer with a double-buffered device queue.**  A
   transfer thread pulls host batches and places them on the device
   (``sharded.put_batch``: pinned staging and a ``non_blocking`` copy on a
   side stream, one event per batch).  Placed batches wait in a
   depth-``depth`` queue (default 2: double buffering), so fetch and copy of
   batch N+1 overlap the train step on batch N.  Over a ``DeviceMesh``
   (``mesh=`` and ``plan=``, or ``shardings=``) the batch is laid out by the
   batch shardings the train step uses: on a mesh of one device as plain
   tensors on it; on a larger mesh the mesh's first rank (the leader) holds
   the session, scatters each rank its shard over a gloo group of the mesh's
   ranks, and every rank places its shard and wraps it as a ``DTensor``
   (``sharded.shard_payloads``, ``sharded.wrap_global``).

3. **Feed-side stall metrics.**  ``FeedMetrics`` splits wall time into
   accelerator-idle / fetch / transfer / compute; a rolling window of the
   same numbers goes to the session's ``report_feed_stall`` (the service
   client's dispatcher heartbeat), the autoscaler's client-latency signal.
   The counters are mirrored in the process registry
   (``repro_torch.obs.get_registry()``), beside the train step's phases.

The feeder imports nothing of the service: it takes any object with
``.session(**overrides)`` (a distributed dataset), or a raw dataset with
``.distribute(service=..., **client_kw)`` together with ``service=``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterator, Optional

import torch

from .. import DeviceLike, resolve_device
from ..dist.context import AbstractMesh
from ..dist.placement import mesh_device
from ..obs import get_registry, span
from .metrics import FeedMetrics, StallWindow
from .sharded import (PinnedRing, host_layout, infer_batch_shardings, leaf_nbytes, leaves,
                      local_arrays, put_batch, resolve_shardings, shard_payloads, sharding_mesh,
                      wrap_global)


class _FeedError:
    """Queued in place of a batch to surface a transfer-thread failure."""

    def __init__(self, error: BaseException):
        self.error = error


class DeviceFeeder:
    """Double-buffered device prefetch over a service-backed dataset.

    Parameters
    ----------
    dataset:
        An object with ``.session(**overrides)`` (``Dataset.distribute(...)``),
        or a raw dataset with ``.distribute(...)`` together with ``service=``.
    service:
        Service handle / dispatcher address; only needed for a raw dataset.
    device:
        Where batches go; ``None`` is the mesh's device, else the current
        CUDA device (and an error when there is none).  ``"cpu"`` gives owned
        CPU tensors.
    depth:
        Device-queue capacity (2 = double buffering).  On CUDA the pinned
        staging ring has ``depth + 1`` slots.
    sharding_mode:
        ``"static"``: per-host static sharding via coordinated-reads consumer
        indexing (forces ``processing_mode="off"``).  ``"dynamic"``: each
        host is an independent client.  ``"auto"`` (default): static iff
        ``num_hosts > 1``.
    host_index, num_hosts:
        Override the host layout (tests emulate hosts).
    report_interval_s:
        How often the rolling stall window goes to the session (0: never).
    mesh, plan:
        A ``DeviceMesh`` and a ``ShardingPlan``: per-leaf batch
        ``NamedSharding``s are derived once, from the first batch, by
        ``sharding_rules.batch_sharding``, the rule of the train step's
        inputs.
    shardings:
        Explicit override: one ``NamedSharding`` for every leaf or a tree
        matching the batch.  Wins over ``mesh``/``plan``.

    Every rank of a mesh larger than one device builds its feeder in the
    same order and consumes the same number of batches: the leader's end of
    data ends every rank's feed.

    Transfer accounting: on CUDA the transfer thread waits for each batch's
    copy event before it records ``transfer_s``, so that bucket holds the
    host→device copy itself, not only its enqueueing; the wait is on the
    transfer thread, never on the consumer's path.  ``next()`` makes the
    consumer's current stream wait on the event as well, and marks each
    tensor with ``record_stream`` so the allocator keeps it for that stream.
    """

    _END = object()

    def __init__(
        self,
        dataset: Any,
        *,
        service: Any = None,
        device: DeviceLike = None,
        depth: int = 2,
        sharding_mode: str = "auto",
        host_index: Optional[int] = None,
        num_hosts: Optional[int] = None,
        report_interval_s: float = 1.0,
        mesh: Any = None,
        plan: Any = None,
        shardings: Any = None,
        **client_kw: Any,
    ):
        if sharding_mode not in ("auto", "static", "dynamic"):
            raise ValueError(f"unknown sharding_mode {sharding_mode!r}")
        if shardings is not None:
            mesh = sharding_mesh(shardings)
        elif (mesh is None) != (plan is None):
            raise TypeError("mesh= and plan= go together (or pass shardings=)")
        if isinstance(mesh, AbstractMesh):
            raise TypeError("DeviceFeeder places batches on a DeviceMesh, not an AbstractMesh")
        self._mesh, self._plan = mesh, plan
        self._explicit_shardings = shardings
        self._shardings: Any = None
        self._shardings_ready = False
        self._group = self._leader = None
        if mesh is not None and device is None:
            device = mesh_device(mesh)
        self.device = resolve_device(device)
        if mesh is not None and mesh.size() > 1:
            import torch.distributed as dist

            ranks = sorted(int(r) for r in mesh.mesh.flatten())
            self._leader = int(mesh.mesh.flatten()[0])
            self._coords = [tuple(int(i) for i in (mesh.mesh == r).nonzero()[0]) for r in ranks]
            self._group = dist.new_group(ranks, backend="gloo")
        self._is_leader = self._leader is None or self._leader == host_layout()[0]
        if hasattr(dataset, "session"):  # a distributed dataset
            if client_kw:
                raise TypeError(
                    "client kwargs belong on Dataset.distribute(...) when "
                    "passing an already-distributed dataset"
                )
            self._dds = dataset
        else:  # raw dataset: distribute it here
            if service is None:
                raise TypeError("service= is required for a raw Dataset")
            client_kw.setdefault("processing_mode", "dynamic")
            self._dds = dataset.distribute(service=service, **client_kw)

        default_index, default_count = (0, 1) if mesh is not None else host_layout()
        self._host_index = default_index if host_index is None else int(host_index)
        self._num_hosts = default_count if num_hosts is None else int(num_hosts)
        if sharding_mode == "auto":
            sharding_mode = "static" if self._num_hosts > 1 else "dynamic"
        self.sharding_mode = sharding_mode

        self.metrics = FeedMetrics(registry=get_registry())
        self._window = StallWindow(self.metrics)
        self._report_interval = report_interval_s
        self._last_report = time.perf_counter()

        self._depth = max(1, depth)
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=self._depth)
        self._ring = PinnedRing(self.device, self._depth + 1) if self.device.type == "cuda" else None
        self._closed = threading.Event()
        self._last_return: Optional[float] = None
        self._client = self._make_session() if self._is_leader else None
        self._thread = threading.Thread(
            target=self._run, name="device-feeder", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------
    # Session / registration
    # ------------------------------------------------------------------
    def _make_session(self) -> Any:
        """Register this host's consumer session per the sharding mode.

        The feeder opts into ``zero_copy=True``: with a co-located worker the
        shm ring's borrowed, read-only views are copied exactly once, into the
        pinned staging buffer (or the owned CPU tensor).  The lease contract
        (views valid until the next ``next(it)``) holds because ``_run``
        copies each batch before fetching the next one; no tensor aliases a
        view.
        """
        overrides: dict = {"zero_copy": True}
        if self.sharding_mode == "static":
            overrides.update(
                processing_mode="off",
                num_consumers=self._num_hosts,
                consumer_index=self._host_index,
            )
        return self._dds.session(**overrides)

    # ------------------------------------------------------------------
    # Transfer thread
    # ------------------------------------------------------------------
    def _run(self) -> None:
        # The session owns the job's trace context; the feeder's spans
        # (fetch / device_put) parent onto the same root.
        tracer = getattr(self._client, "tracer", None)
        root = getattr(self._client, "trace_root", None)
        try:
            it = iter(self._client) if self._client is not None else None
            while not self._closed.is_set():
                t0 = time.perf_counter()
                batch = self._fetch(it)
                if batch is None:
                    break
                dt = time.perf_counter() - t0
                self.metrics.add_fetch(dt)
                sampled = tracer is not None and root is not None and tracer.should_sample()
                if sampled:
                    tracer.record(
                        "feed.fetch", root.child(), time.time() - dt, dt,
                        parent_id=root.span_id,
                    )
                t0 = time.perf_counter()
                local = local_arrays(batch) if self._group is not None else batch
                placed, event = put_batch(local, self.device, self._ring)
                if event is not None:
                    event.synchronize()  # transfer_s holds the copy itself
                dt = time.perf_counter() - t0
                nbytes = leaf_nbytes(local)
                self.metrics.add_transfer(dt, nbytes)
                if sampled:
                    tracer.record(
                        "feed.device_put", root.child(), time.time() - dt, dt,
                        parent_id=root.span_id, nbytes=nbytes,
                    )
                out = wrap_global(placed, batch, self._mesh) if self._group is not None else placed
                if not self._put((out, event, leaves(placed))):
                    return  # closed while the queue was full
                self._maybe_report()
        except Exception as e:  # surface to the consumer, don't die silently
            self._put(_FeedError(e))
        finally:
            self._put(self._END)
            self._report()

    def _fetch(self, it: Any) -> Any:
        """The next host batch, or None at the end of the data.  On a mesh
        larger than one device, this rank's ``Shard`` tree: the leader
        fetches and scatters every rank its shard."""
        batch = error = None
        if it is not None:
            try:
                batch = next(it)
                self._resolve(batch)
            except StopIteration:
                batch = None
            except Exception as e:
                if self._group is None:
                    raise
                error = e
        if self._group is None:
            return batch
        import torch.distributed as dist

        objs = None
        if self._is_leader:
            if error is not None:
                objs = [("error", repr(error))] * len(self._coords)
            elif batch is None:
                objs = [None] * len(self._coords)
            else:
                objs = shard_payloads(batch, self._shardings, self._coords)
        out: list = [None]
        dist.scatter_object_list(out, objs, src=self._leader, group=self._group)
        if error is not None:
            raise error
        if isinstance(out[0], tuple):
            raise RuntimeError(f"the mesh's leader (rank {self._leader}) failed: {out[0][1]}")
        return out[0]

    def _resolve(self, batch: Any) -> None:
        """Derives the batch shardings once, from the first batch: explicit
        ``shardings=`` win over ``mesh=``/``plan=``."""
        if self._shardings_ready:
            return
        if self._explicit_shardings is not None:
            self._shardings = resolve_shardings(batch, self._explicit_shardings)
        elif self._mesh is not None:
            self._shardings = infer_batch_shardings(batch, self._mesh, self._plan)
        self._shardings_ready = True

    @property
    def shardings(self) -> Any:
        """The per-leaf batch shardings (None before the first batch, and
        without a mesh; on the leader only, over a larger mesh)."""
        return self._shardings

    def _put(self, item: Any) -> bool:
        while not self._closed.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # ------------------------------------------------------------------
    # Stall reporting (autoscaler client-latency signal)
    # ------------------------------------------------------------------
    def _maybe_report(self) -> None:
        if self._report_interval <= 0:
            return
        now = time.perf_counter()
        if now - self._last_report >= self._report_interval:
            self._last_report = now
            self._report()

    def _report(self) -> None:
        stats = self._window.report()
        if stats is None:
            return
        report = getattr(self._client, "report_feed_stall", None)
        if report is not None:
            report(stats)

    # ------------------------------------------------------------------
    # Consumption
    # ------------------------------------------------------------------
    def next(self, timeout: Optional[float] = None) -> Any:
        """Block until the next device-resident batch is ready.

        The blocked time is the accelerator-idle metric: with the double
        buffer keeping up it is ~0; when it grows, the feed (service fetch or
        host→device transfer) is the bottleneck.  Under the profiler the
        wait is the span ``feed.wait``.
        """
        t0 = time.perf_counter()
        compute = None if self._last_return is None else t0 - self._last_return
        deadline = None if timeout is None else t0 + timeout
        with span("feed.wait"):
            while True:
                if self._closed.is_set():
                    raise StopIteration("feeder closed")
                try:
                    item = self._queue.get(timeout=0.1)
                    break
                except queue.Empty:
                    if deadline is not None and time.perf_counter() > deadline:
                        raise TimeoutError(
                            f"no batch after {timeout:.1f}s (service stalled?)"
                        )
        now = time.perf_counter()
        if item is self._END:
            self._queue.put(self._END)  # idempotent end for later calls
            raise StopIteration
        if isinstance(item, _FeedError):
            raise RuntimeError("device feed failed") from item.error
        batch, event, local = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in local:
                t.record_stream(stream)
        self.metrics.add_step(
            idle=now - t0,
            compute=compute,
            depth_frac=self._queue.qsize() / self._depth,
        )
        self._last_return = time.perf_counter()
        return batch

    def __iter__(self) -> Iterator[Any]:
        while True:
            try:
                yield self.next()
            except StopIteration:
                return

    def __next__(self) -> Any:
        return self.next()

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def close(self) -> None:
        """Stop the transfer thread and the service session.  Idempotent;
        safe mid-epoch: in-flight batches are dropped, the service job keeps
        running for other consumers."""
        if self._closed.is_set():
            return
        self._closed.set()
        if self._client is not None:
            self._client.close()
        self._thread.join(timeout=5.0)
        if self._group is not None and not self._thread.is_alive():
            import torch.distributed as dist

            dist.destroy_process_group(self._group)
            self._group = None
        # unblock any consumer stuck in next()
        try:
            self._queue.put_nowait(self._END)
        except queue.Full:
            pass

    def __enter__(self) -> "DeviceFeeder":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
