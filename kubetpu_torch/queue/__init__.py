# Port copy of kubetpu/queue/__init__.py, verbatim apart from this note.
"""Scheduling queue — the framework's pending-work tier.

Analog of ``pkg/scheduler/backend/queue/`` (reference): a three-tier queue
(active / backoff / unschedulable) with event-driven requeue through
per-plugin queueing hints, re-shaped for a *batched* scheduler: ``pop_batch``
drains up to a whole device batch of ready pods at once instead of the
reference's one-pod blocking ``Pop`` (scheduling_queue.go:1175).
"""

from .events import (
    ActionType,
    ClusterEvent,
    EventResource,
    QueueingHint,
    EVENT_ALL,
)
from .priority_queue import PriorityQueue, QueuedPodInfo

__all__ = [
    "ActionType",
    "ClusterEvent",
    "EventResource",
    "QueueingHint",
    "EVENT_ALL",
    "PriorityQueue",
    "QueuedPodInfo",
]
