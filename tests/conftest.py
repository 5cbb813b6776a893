"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches see
the real single CPU device; only launch/dryrun.py forces 512 devices."""
import os
import sys
import threading
import time

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def _shm_segments():
    """Names of repro ring segments currently present in /dev/shm."""
    from repro.core.shm_ring import SEGMENT_PREFIX

    try:
        return {n for n in os.listdir("/dev/shm") if n.startswith(SEGMENT_PREFIX)}
    except OSError:  # non-Linux or odd container: nothing to sweep
        return set()


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True)
def threads_leaked():
    """Fail any test that leaks a non-daemon thread, a child process, or a
    shared-memory ring segment.

    A leaked non-daemon thread hangs interpreter shutdown (the classic
    symptom: the suite passes, then CI times out on exit).  Daemon threads
    are tolerated — every service background loop in this tree is
    deliberately daemonized — so this only catches the unjoinable kind.
    Leaked ``multiprocessing`` children (executor pools that were never
    ``stop()``-ed) and leaked ``/dev/shm`` segments (``repro_ring_*``
    created without a matching ``unlink``) accumulate across the suite and
    exhaust the box, so they fail the owning test the same way.  Everything
    gets a short grace window: a test that stopped its service is allowed
    the join/unlink that is already in flight.
    """
    import multiprocessing

    before = set(threading.enumerate())
    before_segments = _shm_segments()
    yield
    deadline = time.monotonic() + 2.0
    leaked = procs = segments = ()
    while time.monotonic() < deadline:
        leaked = [
            t
            for t in threading.enumerate()
            if t not in before and t.is_alive() and not t.daemon
        ]
        procs = [p for p in multiprocessing.active_children() if p.is_alive()]
        segments = _shm_segments() - before_segments
        if not leaked and not procs and not segments:
            return
        time.sleep(0.05)
    if leaked:
        names = ", ".join(t.name for t in leaked)
        pytest.fail(f"test leaked non-daemon thread(s): {names}")
    if procs:
        names = ", ".join(f"{p.name} (pid {p.pid})" for p in procs)
        pytest.fail(f"test leaked child process(es): {names}")
    names = ", ".join(sorted(segments))
    pytest.fail(f"test leaked /dev/shm segment(s): {names}")


@pytest.fixture
def service_factory():
    """Yields a start_service wrapper that guarantees teardown."""
    from repro.core import start_service

    handles = []

    def make(num_workers=2, **kw):
        # REPRO_TEST_WORKER_PROCESSES=N reruns any service e2e test with
        # the process-pool pipeline executor (tests that pin an engine
        # pass worker_processes explicitly and win over the env)
        kw.setdefault(
            "worker_processes",
            int(os.environ.get("REPRO_TEST_WORKER_PROCESSES", "0")),
        )
        h = start_service(num_workers=num_workers, **kw)
        handles.append(h)
        return h

    yield make
    for h in handles:
        try:
            h.orchestrator.stop()
        except Exception:
            pass
