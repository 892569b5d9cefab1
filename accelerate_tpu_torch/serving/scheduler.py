"""Continuous-batching scheduler: request queue + slot lifecycle.

Counterpart of ``accelerate_tpu/serving/scheduler.py``, a copy of its pure
host policy. ``submit`` (admission control on queue depth) -> FIFO queue ->
``admit_ready`` pairs queued requests with free capacity -> the engine
reports tokens -> ``retire`` frees the slot for the very next admission.
``preempt_slot`` is the page-pressure hook: the request goes back to the
head of the queue and restarts from its prompt.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np


class QueueFull(RuntimeError):
    """Admission control: the queue is at ``max_queue`` depth. Carries the
    queue depth and the engine's ``retry_after_s`` estimate."""

    def __init__(
        self,
        message: str,
        queue_depth: Optional[int] = None,
        retry_after_s: Optional[float] = None,
    ):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s


@dataclass
class Request:
    """One serving request and its accumulated lifecycle state."""

    id: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    submitted_at: float = field(default_factory=time.perf_counter)
    deadline_s: Optional[float] = None  # relative to submitted_at; None = no deadline
    slot: Optional[int] = None
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    finish_reason: Optional[str] = None  # "eos" | "length" | "expired" | "cancelled" | "failed"
    generated: list[int] = field(default_factory=list)
    cancelled: bool = False
    preemptions: int = 0  # times page pressure evicted this request
    # tokens of prompt[:-1] already in cache pages (starts at the prefix hit)
    prefilled: int = 0
    prefix_hit: int = 0  # tokens reused from the prefix cache at admission

    @property
    def deadline_at(self) -> Optional[float]:
        if self.deadline_s is None:
            return None
        return self.submitted_at + self.deadline_s

    def past_deadline(self, now: float) -> bool:
        deadline = self.deadline_at
        return deadline is not None and now >= deadline

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at


class ContinuousBatchingScheduler:
    """FIFO queue in front of ``num_slots`` decode slots."""

    def __init__(self, num_slots: int, max_queue: Optional[int] = None):
        self.num_slots = num_slots
        self.max_queue = max_queue
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * num_slots
        self._ids = itertools.count()

    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        request_id: Optional[int] = None,
        submitted_at: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ) -> Request:
        """Enqueue a request; raises :class:`QueueFull` past ``max_queue``."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            raise QueueFull(
                f"request queue is full ({len(self.queue)}/{self.max_queue} waiting)",
                queue_depth=len(self.queue),
            )
        request = Request(
            id=next(self._ids) if request_id is None else request_id,
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            deadline_s=deadline_s,
        )
        if submitted_at is not None:
            request.submitted_at = submitted_at
        self.queue.append(request)
        return request

    def cancel(self, request_id: int) -> bool:
        """Mark the request cancelled wherever it lives; the engine retires
        it at the top of the next step."""
        for request in self.queue:
            if request.id == request_id:
                request.cancelled = True
                return True
        for request in self.slots:
            if request is not None and request.id == request_id:
                request.cancelled = True
                return True
        return False

    def preempt_slot(self, slot: int) -> Request:
        """Page pressure evicted this request: back to the HEAD of the queue
        to restart from its prompt (at temperature 0 the re-prefill
        regenerates the same tokens)."""
        request = self.slots[slot]
        if request is None:
            raise ValueError(f"slot {slot} holds no request")
        self.slots[slot] = None
        request.slot = None
        request.generated = []
        request.first_token_at = None
        request.prefilled = 0
        request.prefix_hit = 0
        request.preemptions += 1
        self.queue.appendleft(request)
        return request

    def admit_ready(self, free_slot) -> Iterator[tuple[int, Request]]:
        """Pair queued requests with free capacity, FIFO. ``free_slot`` is a
        callable ``(request) -> slot | None`` (the cache's admission)."""
        while self.queue:
            slot = free_slot(self.queue[0])
            if slot is None:
                return
            request = self.queue.popleft()
            request.slot = slot
            request.admitted_at = time.perf_counter()
            self.slots[slot] = request
            yield slot, request

    def sweep_queue(self, now: float) -> list[Request]:
        """Remove cancelled / past-deadline requests from the waiting queue,
        returning them with ``finish_reason`` set."""
        kept: deque[Request] = deque()
        dropped: list[Request] = []
        for request in self.queue:
            if request.cancelled:
                reason = "cancelled"
            elif request.past_deadline(now):
                reason = "expired"
            else:
                kept.append(request)
                continue
            request.finished_at = now
            request.finish_reason = reason
            dropped.append(request)
        self.queue = kept
        return dropped

    def retire(self, slot: int, reason: str) -> Request:
        request = self.slots[slot]
        if request is None:
            raise ValueError(f"slot {slot} holds no request")
        self.slots[slot] = None
        request.finished_at = time.perf_counter()
        request.finish_reason = reason
        return request

    @property
    def active_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    @property
    def waiting(self) -> int:
        return len(self.queue)

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)
