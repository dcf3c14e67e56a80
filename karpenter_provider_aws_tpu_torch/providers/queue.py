"""The interruption-queue provider seam.

Parity: the upstream provider's ``pkg/providers/sqs/sqs.go:53-73`` — the reference
isolates queue I/O behind a provider interface (long-poll receive of at most
10 messages, explicit per-receipt delete, send for tests/tools) so the
interruption controller never touches the wire client. ``QueueProvider`` is
that declared seam here; ``fake.FakeQueue`` implements it in-memory, a real
adapter (SQS/PubSub/...) slots in at operator wiring without touching the
controller.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, runtime_checkable

# sqs.go:62 MaxNumberOfMessages — one poll returns at most this many.
MAX_RECEIVE = 10
# sqs.go:63 WaitTimeSeconds — the long-poll window a real adapter should use.
WAIT_TIME_S = 20


@dataclass
class QueueMessage:
    """One received message: raw body + the receipt handle that deletes it."""

    body: str
    receipt: str = ""

    def parsed(self) -> dict:
        import json

        return json.loads(self.body)


@runtime_checkable
class QueueProvider(Protocol):
    # Optional attribute (NOT a Protocol member — a data member would make
    # structural isinstance fail for adapters that omit it): providers may
    # set ``blocking_io = False`` to declare receive/delete never touch the
    # network. The interruption controller fans message handling over a
    # worker pool ONLY for blocking providers (the reference's
    # ParallelizeUntil(10) exists to overlap SQS and kube round-trips,
    # controller.go:104); for an in-memory provider the pool is pure
    # dispatch overhead on GIL-bound work and halves small-drain
    # throughput. Consumers read it via getattr(queue, "blocking_io", True).

    def send(self, body) -> None: ...

    def receive(self, max_messages: Optional[int] = None) -> list: ...

    def delete(self, receipt: str) -> None: ...
