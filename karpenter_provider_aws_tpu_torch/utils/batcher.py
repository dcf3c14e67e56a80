"""Generic request-coalescing batcher.

Reference parity: ``pkg/batcher/batcher.go:33-118`` — requests are bucketed
by a hash of batchable options, a window triggers on idle timeout or max
duration or max items, then one wire call serves the whole batch and results
are scattered back to callers. The CreateFleet batcher turns N logical
single-instance launches into one fleet call of capacity N and splits the
results (``createfleet.go:32-110``).

This is the host-side analogue of a collective: gather N logical ops into
one physical op, scatter results. The device-side analogue is the problem
tensor itself (all pods solved in one jit call).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Generic, Hashable, TypeVar

T = TypeVar("T")  # request
U = TypeVar("U")  # response


@dataclass
class BatcherOptions:
    idle_timeout_s: float = 0.035   # createfleet.go:35 — 35ms
    max_timeout_s: float = 1.0      # createfleet.go:36 — 1s
    max_items: int = 1000           # createfleet.go:37
    # Bounded fan-out pool for flushed batches (batcher.go:71-95 runs up to
    # 100 concurrent request workers): one slow wire call must not
    # serialize every later flush behind it.
    max_request_workers: int = 100


class _Pending(Generic[T, U]):
    def __init__(self, request: T):
        self.request = request
        self.event = threading.Event()
        self.result: U | None = None
        self.error: Exception | None = None


class Batcher(Generic[T, U]):
    """Coalesces requests with equal ``hasher(request)`` into one executor call.

    ``executor(requests) -> list[results]`` must return one result (or raise)
    per request, positionally.
    """

    def __init__(
        self,
        executor: Callable[[list[T]], list],
        hasher: Callable[[T], Hashable] = lambda r: 0,
        options: BatcherOptions | None = None,
    ):
        self._executor = executor
        self._hasher = hasher
        self._opts = options or BatcherOptions()
        self._lock = threading.Lock()
        self._closed = False
        self._buckets: dict[Hashable, list[_Pending]] = {}
        self._timers: dict[Hashable, threading.Timer] = {}
        self._first_seen: dict[Hashable, float] = {}
        # worker fan-out: timer threads only DISPATCH; execution happens on
        # this bounded pool (threads spawn lazily, so an idle batcher costs
        # nothing)
        self._pool = ThreadPoolExecutor(
            max_workers=max(self._opts.max_request_workers, 1),
            thread_name_prefix="batcher",
        )
        # metrics
        self.batches_executed = 0
        self.batch_sizes: list[int] = []

    def add(self, request: T) -> U:
        """Block until the batch containing this request executes; return its result."""
        p: _Pending[T, U] = _Pending(request)
        key = self._hasher(request)
        flush_now = False
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            bucket = self._buckets.setdefault(key, [])
            bucket.append(p)
            if len(bucket) >= self._opts.max_items:
                flush_now = True
            else:
                self._arm_timer(key)
        if flush_now:
            self._flush(key)
        if not p.event.wait(timeout=self._opts.max_timeout_s * 4 + 30):
            raise TimeoutError("batch executor did not complete within the batch window")
        if p.error is not None:
            raise p.error
        return p.result  # type: ignore[return-value]

    def _arm_timer(self, key: Hashable) -> None:
        # Called under lock. Idle window restarts per add; a max-duration
        # timer bounds total latency (batcher.go idle/max windows).
        import time
        now = time.monotonic()
        first = self._first_seen.setdefault(key, now)
        remaining_max = self._opts.max_timeout_s - (now - first)
        delay = max(0.0, min(self._opts.idle_timeout_s, remaining_max))
        old = self._timers.pop(key, None)
        if old is not None:
            old.cancel()
        t = threading.Timer(delay, self._flush, args=(key,))
        t.daemon = True
        self._timers[key] = t
        t.start()

    def _flush(self, key: Hashable) -> None:
        """Detach the bucket and hand it to the worker pool. Runs on timer
        threads and on callers hitting max_items — both only dispatch."""
        with self._lock:
            bucket = self._buckets.pop(key, [])
            timer = self._timers.pop(key, None)
            first = self._first_seen.pop(key, None)
            if timer is not None:
                timer.cancel()
        if not bucket:
            return
        try:
            self._pool.submit(self._execute, bucket, first)
        except RuntimeError:  # pool shut down (interpreter teardown)
            self._execute(bucket, first)

    def close(self) -> None:
        """Reject new submits, cancel armed timers, flush every pending
        bucket, then join in-flight work. A bare pool shutdown would
        leave armed ``threading.Timer``s live and pending buckets
        unflushed — every in-flight ``add()`` caller would hang until
        the 4xmax+30s watchdog instead of getting its result."""
        with self._lock:
            self._closed = True
            pending = list(self._buckets)
            for t in self._timers.values():
                t.cancel()
            self._timers.clear()
        for key in pending:
            self._flush(key)
        self._pool.shutdown(wait=True)

    def _execute(self, bucket: list[_Pending], first) -> None:
        import time as _time

        with self._lock:  # pool workers race on the counters
            self.batches_executed += 1
            self.batch_sizes.append(len(bucket))
        try:
            from ..metrics import BATCH_SIZE, BATCH_WINDOW

            BATCH_SIZE.observe(len(bucket))
            if first is not None:
                BATCH_WINDOW.observe(_time.monotonic() - first)
        except Exception:
            pass
        try:
            results = self._executor([p.request for p in bucket])
            if len(results) != len(bucket):
                raise RuntimeError(
                    f"batch executor returned {len(results)} results for {len(bucket)} requests"
                )
            for p, r in zip(bucket, results):
                if isinstance(r, Exception):
                    p.error = r
                else:
                    p.result = r
        except Exception as e:  # executor-wide failure fans out to all callers
            for p in bucket:
                p.error = e
        finally:
            for p in bucket:
                p.event.set()
