"""The batcher (the CreateFleet/Describe coalescer, ``utils/batcher.py``)
copied into the port, held to the reference's own concurrency cases
(``tests/test_stress.py``'s ``TestBatcherFanOut``), each case once per
package."""

import importlib
import threading
import time

import pytest

PACKAGES = ("karpenter_provider_aws_tpu", "karpenter_provider_aws_tpu_torch")


@pytest.fixture(params=PACKAGES)
def batcher(request):
    return importlib.import_module(f"{request.param}.utils.batcher")


def test_slow_batch_does_not_serialize_other_buckets(batcher):
    """A stuck executor call for bucket A must not delay bucket B's flush."""
    release_a = threading.Event()

    def executor(reqs):
        if reqs[0][0] == "a":
            release_a.wait(timeout=10)
        return [f"done-{r}" for r in reqs]

    b = batcher.Batcher(executor, hasher=lambda r: r[0],
                        options=batcher.BatcherOptions(idle_timeout_s=0.01, max_timeout_s=0.1))
    try:
        results: dict = {}

        def call(tag):
            results[tag] = b.add((tag[0], tag))

        ta = threading.Thread(target=call, args=("a1",))
        ta.start()
        time.sleep(0.05)
        t0 = time.monotonic()
        tb = threading.Thread(target=call, args=("b1",))
        tb.start()
        tb.join(timeout=5)
        assert not tb.is_alive()
        assert results["b1"] == "done-('b', 'b1')"
        assert time.monotonic() - t0 < 2.0
        release_a.set()
        ta.join(timeout=5)
        assert results["a1"] == "done-('a', 'a1')"
    finally:
        release_a.set()
        b.close()


def test_hammer_add_while_executor_sleeps(batcher):
    """32 threads x 25 adds against a sleepy executor: every caller gets
    exactly its own result, and calls coalesce."""
    def executor(reqs):
        time.sleep(0.002)
        return [("echo", r) for r in reqs]

    b = batcher.Batcher(executor, hasher=lambda r: r % 4,
                        options=batcher.BatcherOptions(idle_timeout_s=0.005, max_timeout_s=0.05,
                                                       max_items=64))
    try:
        out: dict = {}
        errors: list = []
        lock = threading.Lock()

        def worker(base):
            for i in range(25):
                v = base * 100 + i
                try:
                    r = b.add(v)
                except Exception as e:  # pragma: no cover
                    with lock:
                        errors.append(e)
                    return
                with lock:
                    out[v] = r

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors and len(out) == 32 * 25
        assert all(r == ("echo", v) for v, r in out.items())
        assert b.batches_executed < 32 * 25
    finally:
        b.close()


def test_executor_failure_fans_out_to_its_batch_only(batcher):
    def executor(reqs):
        if any(r < 0 for r in reqs):
            raise RuntimeError("poisoned batch")
        return list(reqs)

    b = batcher.Batcher(executor, hasher=lambda r: r < 0,
                        options=batcher.BatcherOptions(idle_timeout_s=0.005, max_timeout_s=0.05))
    try:
        oks: list = []
        fails: list = []
        lock = threading.Lock()

        def call(v):
            try:
                r = b.add(v)
                with lock:
                    oks.append(r)
            except RuntimeError:
                with lock:
                    fails.append(v)

        threads = [threading.Thread(target=call, args=(v,)) for v in (-1, -2, 1, 2, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert sorted(oks) == [1, 2, 3] and sorted(fails) == [-2, -1]
    finally:
        b.close()
