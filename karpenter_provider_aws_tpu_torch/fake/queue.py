"""FakeQueue: the SQS-shaped interruption event queue.

Parity: ``pkg/fake/sqsapi.go`` + ``pkg/providers/sqs/sqs.go:53-73`` —
receive up to 10 messages per poll, explicit delete, fault injection.
"""

from __future__ import annotations

import itertools
import json
import threading
from typing import Optional

from ..providers.queue import MAX_RECEIVE, QueueMessage  # noqa: F401 (re-export)

_ids = itertools.count(1)


class FakeQueue:
    MAX_RECEIVE = MAX_RECEIVE  # sqs.go:62 MaxNumberOfMessages
    blocking_io = False  # in-memory: handlers run inline, no worker pool

    def __init__(self):
        self._lock = threading.Lock()
        self._messages: dict[str, QueueMessage] = {}
        self.next_errors: list[Exception] = []
        self.received_count = 0
        self.deleted_count = 0

    def send(self, body) -> None:
        if not isinstance(body, str):
            body = json.dumps(body)
        with self._lock:
            receipt = f"rcpt-{next(_ids)}"
            self._messages[receipt] = QueueMessage(body=body, receipt=receipt)

    def receive(self, max_messages: Optional[int] = None) -> list[QueueMessage]:
        with self._lock:
            if self.next_errors:
                raise self.next_errors.pop(0)
            out = list(self._messages.values())[: max_messages or self.MAX_RECEIVE]
            self.received_count += len(out)
            return out

    def delete(self, receipt: str) -> None:
        with self._lock:
            if self.next_errors:
                raise self.next_errors.pop(0)
            self._messages.pop(receipt, None)
            self.deleted_count += 1

    def reset(self) -> None:
        with self._lock:
            self._messages.clear()
            self.next_errors.clear()
            self.received_count = 0
            self.deleted_count = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._messages)
