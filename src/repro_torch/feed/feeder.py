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
   the ``torch.distributed`` rank and world size (``sharded.host_layout``).

2. **Background fetch + transfer with a double-buffered device queue.**  A
   transfer thread pulls host batches and places them on the device
   (``sharded.put_batch``: pinned staging and a ``non_blocking`` copy on a
   side stream, one event per batch).  Placed batches wait in a
   depth-``depth`` queue (default 2: double buffering), so fetch and copy of
   batch N+1 overlap the train step on batch N.

3. **Feed-side stall metrics.**  ``FeedMetrics`` splits wall time into
   accelerator-idle / fetch / transfer / compute; a rolling window of the
   same numbers goes to the session's ``report_feed_stall`` (the service
   client's dispatcher heartbeat), the autoscaler's client-latency signal.

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
from .metrics import FeedMetrics, StallWindow
from .sharded import DIST_ITEM, PinnedRing, host_layout, leaf_nbytes, leaves, put_batch


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
        Where batches go; ``None`` is the current CUDA device (and an error
        when there is none).  ``"cpu"`` gives owned CPU tensors.
    depth:
        Device-queue capacity (2 = double buffering).  On CUDA the pinned
        staging ring has ``depth + 1`` slots.
    sharding_mode:
        ``"static"``: per-host static sharding via coordinated-reads consumer
        indexing (forces ``processing_mode="off"``).  ``"dynamic"``: each
        host is an independent client.  ``"auto"`` (default): static iff
        ``num_hosts > 1``.
    host_index, num_hosts:
        Override the ``torch.distributed`` layout (tests emulate hosts).
    report_interval_s:
        How often the rolling stall window goes to the session (0: never).
    mesh, plan, shardings:
        Batch sharding over a mesh is not ported: anything but ``None``
        raises ``NotImplementedError``.

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
        if mesh is not None or plan is not None or shardings is not None:
            raise NotImplementedError(f"DeviceFeeder(mesh=, plan=, shardings=) is not ported "
                                      f"yet; see {DIST_ITEM}")
        self.device = resolve_device(device)
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

        default_index, default_count = host_layout()
        self._host_index = default_index if host_index is None else int(host_index)
        self._num_hosts = default_count if num_hosts is None else int(num_hosts)
        if sharding_mode == "auto":
            sharding_mode = "static" if self._num_hosts > 1 else "dynamic"
        self.sharding_mode = sharding_mode

        self.metrics = FeedMetrics()
        self._window = StallWindow(self.metrics)
        self._report_interval = report_interval_s
        self._last_report = time.perf_counter()

        self._depth = max(1, depth)
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=self._depth)
        self._ring = PinnedRing(self.device, self._depth + 1) if self.device.type == "cuda" else None
        self._closed = threading.Event()
        self._last_return: Optional[float] = None
        self._client = self._make_session()
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
            it = iter(self._client)
            while not self._closed.is_set():
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
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
                placed, event = put_batch(batch, self.device, self._ring)
                if event is not None:
                    event.synchronize()  # transfer_s holds the copy itself
                dt = time.perf_counter() - t0
                nbytes = leaf_nbytes(batch)
                self.metrics.add_transfer(dt, nbytes)
                if sampled:
                    tracer.record(
                        "feed.device_put", root.child(), time.time() - dt, dt,
                        parent_id=root.span_id, nbytes=nbytes,
                    )
                if not self._put((placed, event)):
                    return  # closed while the queue was full
                self._maybe_report()
        except Exception as e:  # surface to the consumer, don't die silently
            self._put(_FeedError(e))
        finally:
            self._put(self._END)
            self._report()

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
        host→device transfer) is the bottleneck.
        """
        t0 = time.perf_counter()
        compute = None if self._last_return is None else t0 - self._last_return
        deadline = None if timeout is None else t0 + timeout
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
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in leaves(batch):
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
        self._client.close()
        self._thread.join(timeout=5.0)
        # unblock any consumer stuck in next()
        try:
            self._queue.put_nowait(self._END)
        except queue.Full:
            pass

    def __enter__(self) -> "DeviceFeeder":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
