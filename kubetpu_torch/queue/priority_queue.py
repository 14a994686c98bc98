# Port copy of kubetpu/queue/priority_queue.py, verbatim apart from this note (no JAX in it).
"""Three-tier scheduling queue with event-driven requeue.

Analog of ``PriorityQueue`` (pkg/scheduler/backend/queue/scheduling_queue.go:170):

- **activeQ** — heap ordered by the queue-sort contract (PrioritySort,
  framework/plugins/queuesort/priority_sort.go: priority desc, then queue
  timestamp asc).
- **backoffQ** — heap ordered by backoff expiry; per-pod exponential backoff
  ``initial << (attempts-1)`` capped at ``max * sqrt(entity_size)``
  (backoff_queue.go:247 ``calculateBackoffDuration``).
- **unschedulable pool** — pods parked until a cluster event a queueing hint
  says may help (scheduling_queue.go:1398 ``moveAllToActiveOrBackoffQueue``),
  with a leftover flush after ``max_in_unschedulable_seconds``
  (flushUnschedulableEntitiesLeftover :1150).

Batched-scheduler re-shape: ``pop_batch(n)`` drains up to n ready pods in
sorted order for one device batch (vs. the reference's blocking one-pod
``Pop`` :1175). Events that arrive while pods are in flight are replayed
against the hints when a pod comes back unschedulable, exactly like the
reference's in-flight-events list, so no wake-up is ever lost.

Time is injectable (``clock`` returns seconds) so tests drive it manually.
"""

from __future__ import annotations

import heapq
import itertools
import math
import time as _time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Sequence

from ..api import types as t
from .events import (
    ClusterEvent,
    QueueingHint,
    QueueingHintMap,
)


def pod_key(pod: t.Pod) -> str:
    return f"{pod.namespace}/{pod.name}"


# Three-way requeue decision (the reference's queueingStrategy:
# queueSkip / queueAfterBackoff / queueImmediately, scheduling_queue.go).
_QUEUE_SKIP = "skip"
_QUEUE_BACKOFF = "after_backoff"
_QUEUE_IMMEDIATE = "immediate"


@dataclass
class QueuedPodInfo:
    """fwk.QueuedPodInfo: a pod plus its queueing bookkeeping."""

    pod: t.Pod
    timestamp: float = 0.0            # last time added to a queue (backoff base)
    initial_attempt_timestamp: float | None = None
    attempts: int = 0
    unschedulable_count: int = 0      # rejected-as-unschedulable attempts
    consecutive_errors: int = 0       # error-status attempts (backoff_queue.go:223)
    backoff_expiration: float = 0.0   # cached; 0 = not computed
    unschedulable_plugins: frozenset[str] = frozenset()
    pending_plugins: frozenset[str] = frozenset()
    gated: bool = False
    entity_size: int = 1              # >1 for pod groups (gang entities)
    events_seq: int = 0               # event sequence number when popped
    # preemption nominated this node; victims are terminating (the
    # reference's pod.Status.NominatedNodeName + nominator view)
    nominated_node_name: str | None = None
    # scheduling cycle that assumed this pod — stamps the async bind span
    # so queue→score→assign→bind traces join on one cycle id
    cycle_id: int = 0
    # staged-latency attribution (sched.flightrecorder): total enqueue→pop
    # wall accumulated across EVERY residency — first admission, backoff,
    # unschedulable parks, requeue hops — on perf_counter (the lifecycle
    # clock), independent of the queue's injectable backoff clock.
    # ``enqueued_pc`` is the open residency's start (0 = not in a queue).
    queue_wait_s: float = 0.0
    enqueued_pc: float = 0.0

    @property
    def key(self) -> str:
        return pod_key(self.pod)

    def sort_key(self) -> tuple:
        """PrioritySort.Less: priority desc, then timestamp asc."""
        return (-self.pod.priority, self.timestamp, self.pod.creation_index)


class PriorityQueue:
    """See module docstring. Not thread-safe by design: the batched scheduler
    owns it from a single loop; concurrent informer deliveries go through the
    owning loop (the reference serializes behind a lock instead)."""

    def __init__(
        self,
        hints: QueueingHintMap | None = None,
        pre_enqueue: Sequence[Callable[[t.Pod], str | None]] = (),
        clock: Callable[[], float] = _time.monotonic,
        initial_backoff_seconds: float = 1.0,
        max_backoff_seconds: float = 10.0,
        max_in_unschedulable_seconds: float = 300.0,
        max_event_log: int = 10000,
    ) -> None:
        self._hints: QueueingHintMap = hints or {}
        # PreEnqueue plugins (interface.go:445): return None to admit, or the
        # rejecting plugin's name to gate (SchedulingGates semantics).
        self._pre_enqueue = list(pre_enqueue)
        self._clock = clock
        self._initial_backoff = initial_backoff_seconds
        self._max_backoff = max_backoff_seconds
        self._max_unschedulable = max_in_unschedulable_seconds

        self._seq = itertools.count()
        self._active_heap: list[tuple] = []      # (sort_key, seq, key)
        self._active: dict[str, QueuedPodInfo] = {}
        self._backoff_heap: list[tuple] = []     # (expiry, sort_key, seq, key)
        self._backoff: dict[str, QueuedPodInfo] = {}
        self._unschedulable: dict[str, QueuedPodInfo] = {}
        self._gated: dict[str, QueuedPodInfo] = {}
        self._in_flight: dict[str, QueuedPodInfo] = {}
        # bounded event log for in-flight replay: (seq, event, old, new)
        self._events: list[tuple[int, ClusterEvent, Any, Any]] = []
        self._event_seq = itertools.count(1)
        self._last_event_seq = 0
        self._max_event_log = max_event_log
        self._max_dropped_seq = 0  # highest event seq truncated from the log
        self.moved_by_hint = 0  # metrics: pods requeued because a hint fired

    # ------------------------------------------------------------------ add

    def _tracked(self, key: str) -> bool:
        return (
            key in self._active or key in self._backoff
            or key in self._unschedulable or key in self._gated
            or key in self._in_flight
        )

    def add(self, pod: t.Pod) -> None:
        """Informer Add for an unscheduled pod
        (eventhandlers.go:208 addPodToSchedulingQueue). A re-delivered Add for
        a pod already tracked anywhere (including in flight) is an update —
        never a second queue entry."""
        if self._tracked(pod_key(pod)):
            self.update(None, pod)
            return
        now = self._clock()
        info = QueuedPodInfo(
            pod=pod, timestamp=now, initial_attempt_timestamp=None,
            enqueued_pc=_time.perf_counter(),
        )
        self._enqueue_new(info)

    def _enqueue_new(self, info: QueuedPodInfo) -> None:
        gate = None
        for pe in self._pre_enqueue:
            gate = pe(info.pod)
            if gate is not None:
                break
        if gate is not None:
            info.gated = True
            info.unschedulable_plugins = frozenset({gate})
            self._gated[info.key] = info
        else:
            info.gated = False
            self._push_active(info)

    def _push_active(self, info: QueuedPodInfo) -> None:
        key = info.key
        self._backoff.pop(key, None)
        self._unschedulable.pop(key, None)
        self._gated.pop(key, None)
        self._active[key] = info
        heapq.heappush(
            self._active_heap, (info.sort_key(), next(self._seq), key)
        )

    def _push_backoff(self, info: QueuedPodInfo) -> None:
        key = info.key
        self._active.pop(key, None)
        self._unschedulable.pop(key, None)
        self._backoff[key] = info
        heapq.heappush(
            self._backoff_heap,
            (self._backoff_time(info), info.sort_key(), next(self._seq), key),
        )

    # -------------------------------------------------------------- backoff

    def _backoff_duration(self, count: int, entity_size: int) -> float:
        """backoff_queue.go:247 — initial << (count-1), capped at
        max * sqrt(entity_size)."""
        if count == 0:
            return 0.0
        max_backoff = self._max_backoff
        if entity_size > 1:
            max_backoff *= math.sqrt(entity_size)
        d = self._initial_backoff * (2.0 ** (count - 1))
        return min(d, max_backoff)

    def _backoff_time(self, info: QueuedPodInfo) -> float:
        """backoff_queue.go:217 getBackoffTime — error count wins over
        unschedulable count; cached per (re)queue."""
        if self._max_backoff == 0:
            return 0.0
        count = info.unschedulable_count
        if info.consecutive_errors > 0:
            count = info.consecutive_errors
        if count == 0:
            return 0.0
        if info.backoff_expiration == 0.0:
            info.backoff_expiration = info.timestamp + self._backoff_duration(
                count, info.entity_size
            )
        return info.backoff_expiration

    def is_backing_off(self, info: QueuedPodInfo) -> bool:
        return self._backoff_time(info) > self._clock()

    def flush_backoff_completed(self) -> int:
        """Move backoff-completed pods to activeQ (the reference's 1 s flush
        goroutine, scheduling_queue.go:1133). Returns how many moved."""
        now = self._clock()
        moved = 0
        while self._backoff_heap and self._backoff_heap[0][0] <= now:
            _, _, _, key = heapq.heappop(self._backoff_heap)
            info = self._backoff.get(key)
            if info is None:
                continue  # lazily-deleted entry
            if self._backoff_time(info) > now:
                # stale entry from an earlier backoff residency — the pod
                # re-entered backoff with a later expiry whose genuine entry
                # is still in the heap; keep it parked
                continue
            del self._backoff[key]
            self._push_active(info)
            moved += 1
        return moved

    # ------------------------------------------------------------------ pop

    def pop_batch(self, max_pods: int) -> list[QueuedPodInfo]:
        """Drain up to ``max_pods`` ready pods in queue-sort order — the
        batched replacement for the blocking one-pod Pop (:1175). Popped pods
        are in flight until ``done``/``add_unschedulable`` is called; events
        arriving meanwhile are replayed for them."""
        self.flush_backoff_completed()
        out: list[QueuedPodInfo] = []
        now_pc = _time.perf_counter()
        while self._active_heap and len(out) < max_pods:
            sort_key, _, key = heapq.heappop(self._active_heap)
            info = self._active.get(key)
            if info is None:
                continue  # lazily-deleted entry
            if info.sort_key() != sort_key:
                continue  # stale entry from before an update; the entry
                # matching the current sort key is still in the heap
            del self._active[key]
            if info.enqueued_pc:
                # close this queue residency: backoff + park time all count
                # as queue_wait in the staged latency vector
                info.queue_wait_s += now_pc - info.enqueued_pc
                info.enqueued_pc = 0.0
            info.attempts += 1
            if info.initial_attempt_timestamp is None:
                info.initial_attempt_timestamp = self._clock()
            info.events_seq = self._last_event_seq
            self._in_flight[key] = info
            out.append(info)
        return out

    def done(self, key: str) -> None:
        """Pod left the scheduling pipeline (bound or dropped)."""
        self._in_flight.pop(key, None)
        self.prune_event_log()

    # -------------------------------------------------- unschedulable flow

    def add_unschedulable(
        self,
        info: QueuedPodInfo,
        unschedulable_plugins: Iterable[str] = (),
        pending_plugins: Iterable[str] = (),
        error: bool = False,
    ) -> str:
        """AddUnschedulableIfNotPresent (:1005 analog): a popped pod came back
        unschedulable (or errored). Replays events that fired while the pod
        was in flight; if any hint says QUEUE the pod goes straight to
        backoff/active, else it parks in the unschedulable pool. Returns the
        queue it landed in ("active"|"backoff"|"unschedulable"|"deleted")."""
        if self._in_flight.pop(info.key, None) is None:
            # the pod was delete()d while in flight — the informer already
            # said goodbye; re-enqueueing would resurrect a ghost
            self.prune_event_log()
            return "deleted"
        if self._tracked(info.key):
            # a newer incarnation was re-added while this attempt ran
            # (AddUnschedulableIfNotPresent's "already present" refusal)
            self.prune_event_log()
            return "already-queued"
        info.unschedulable_plugins = frozenset(unschedulable_plugins)
        info.pending_plugins = frozenset(pending_plugins)
        info.enqueued_pc = _time.perf_counter()   # a new queue residency opens
        if error:
            info.consecutive_errors += 1
        else:
            info.consecutive_errors = 0
            info.unschedulable_count += 1
        info.timestamp = self._clock()
        info.backoff_expiration = 0.0

        if not (info.unschedulable_plugins | info.pending_plugins):
            # error-status pod with no rejector recorded: retry after backoff
            # (determineSchedulingHintForInFlightPod's empty-rejector case)
            return self._requeue(info)
        if self._max_dropped_seq > info.events_seq:
            # events this pod needed to see were truncated from the log —
            # conservatively assume one of them was QUEUE-worthy
            return self._requeue(info)
        for seq, event, old, new in self._events:
            if seq <= info.events_seq:
                continue
            hint = self._hint_for(info, event, old, new)
            if hint is _QUEUE_IMMEDIATE:
                self._push_active(info)
                return "active"
            if hint is _QUEUE_BACKOFF:
                return self._requeue(info)
        self._unschedulable[info.key] = info
        return "unschedulable"

    def _requeue(self, info: QueuedPodInfo) -> str:
        if self.is_backing_off(info):
            self._push_backoff(info)
            return "backoff"
        self._push_active(info)
        return "active"

    def _plugin_queues(
        self, plugin: str, info: QueuedPodInfo, event: ClusterEvent,
        old: Any, new: Any,
    ) -> bool:
        for reg in self._hints.get(plugin, ()):  # type: ignore[call-overload]
            if not reg.event.matches(event):
                continue
            if reg.hint is None:
                return True
            try:
                if reg.hint(info.pod, old, new) is QueueingHint.QUEUE:
                    return True
            except Exception:
                return True  # buggy hint never strands a pod (types.go:198)
        return False

    def _hint_for(
        self, info: QueuedPodInfo, event: ClusterEvent, old: Any, new: Any
    ) -> str:
        """isPodWorthRequeuing (:1300 analog): consult the hints of every
        plugin that rejected this pod. No rejector recorded (error case) ⇒
        queue after backoff. A QUEUE from a *pending* plugin (Permit/gang
        wake-up) skips backoff entirely (the reference's queueImmediately);
        from an unschedulable plugin it honors backoff (queueAfterBackoff)."""
        if not (info.unschedulable_plugins | info.pending_plugins):
            return _QUEUE_BACKOFF
        for plugin in info.pending_plugins:
            if self._plugin_queues(plugin, info, event, old, new):
                return _QUEUE_IMMEDIATE
        for plugin in info.unschedulable_plugins:
            if self._plugin_queues(plugin, info, event, old, new):
                return _QUEUE_BACKOFF
        return _QUEUE_SKIP

    def on_event(
        self, event: ClusterEvent, old: Any = None, new: Any = None
    ) -> int:
        """moveAllToActiveOrBackoffQueue (:1398): a cluster event fired —
        requeue every parked pod whose rejector hints say it may now fit.
        Also logged for in-flight replay. Returns how many pods moved."""
        seq = next(self._event_seq)
        self._last_event_seq = seq
        if self._in_flight:
            self._events.append((seq, event, old, new))
            if len(self._events) > self._max_event_log:
                dropped = self._events[: -self._max_event_log]
                self._max_dropped_seq = max(
                    self._max_dropped_seq, dropped[-1][0]
                )
                self._events = self._events[-self._max_event_log :]
        moved = 0
        for key in list(self._unschedulable):
            info = self._unschedulable[key]
            hint = self._hint_for(info, event, old, new)
            if hint is _QUEUE_SKIP:
                continue
            del self._unschedulable[key]
            if hint is _QUEUE_IMMEDIATE:
                self._push_active(info)
            else:
                self._requeue(info)
            self.moved_by_hint += 1
            moved += 1
        # gated pods (PreEnqueue rejections) re-run their gate when a hint
        # of the gating plugin fires (the reference keeps them in the
        # unschedulable pool with the PreEnqueue plugin as rejector, so
        # moveAllToActiveOrBackoffQueue covers them the same way; e.g. a
        # ResourceClaim Add un-gates DynamicResources' waiters)
        for key in list(self._gated):
            info = self._gated[key]
            hint = self._hint_for(info, event, old, new)
            if hint is _QUEUE_SKIP:
                continue
            del self._gated[key]
            self._enqueue_new(info)
            if not info.gated:
                self.moved_by_hint += 1
                moved += 1
        return moved

    def flush_unschedulable_leftover(self) -> int:
        """flushUnschedulableEntitiesLeftover (:1150): pods parked longer than
        ``max_in_unschedulable_seconds`` get another chance (30 s flush loop
        in the reference)."""
        now = self._clock()
        moved = 0
        for key in list(self._unschedulable):
            info = self._unschedulable[key]
            if now - info.timestamp >= self._max_unschedulable:
                del self._unschedulable[key]
                self._requeue(info)
                moved += 1
        return moved

    def prune_event_log(self) -> None:
        if not self._in_flight:
            self._events.clear()

    # -------------------------------------------------------- update/delete

    def activate(self, pods: Iterable[t.Pod]) -> int:
        """queue.Activate: move named pods to activeQ (used by Permit/gang
        wake-ups). Gated pods re-run PreEnqueue — a still-gated pod stays
        parked, as the reference's moveToActiveQ does."""
        moved = 0
        for pod in pods:
            key = pod_key(pod)
            info = (
                self._unschedulable.pop(key, None)
                or self._backoff.pop(key, None)
                or self._gated.pop(key, None)
            )
            if info is not None:
                info.pod = pod
                self._enqueue_new(info)
                if not info.gated:
                    moved += 1
        return moved

    def update(self, old: t.Pod | None, new: t.Pod) -> None:
        """Informer Update for an unscheduled pod: refresh the object; a
        gated pod whose gates cleared is re-admitted through PreEnqueue; an
        unschedulable pod is requeued only if the changed fields fire one of
        its rejectors' hints (the reference gates this on isPodWorthRequeuing
        with the unscheduled-pod-update event, :1005)."""
        from .events import pod_update_event

        key = pod_key(new)
        if key in self._gated:
            info = self._gated.pop(key)
            info.pod = new
            info.timestamp = self._clock()
            self._enqueue_new(info)
            return
        if key in self._active:
            info = self._active[key]
            info.pod = new
            # re-push so a priority change reorders the heap (the stale entry
            # is lazily skipped at pop)
            heapq.heappush(
                self._active_heap, (info.sort_key(), next(self._seq), key)
            )
            return
        if key in self._backoff:
            self._backoff[key].pod = new
            return
        if key in self._unschedulable:
            info = self._unschedulable[key]
            info.pod = new
            hint = self._hint_for(info, pod_update_event(old, new), old, new)
            if hint is _QUEUE_SKIP:
                return  # irrelevant patch: stay parked, object refreshed
            del self._unschedulable[key]
            if hint is _QUEUE_IMMEDIATE:
                self._push_active(info)
            else:
                self._requeue(info)
            return
        if key in self._in_flight:
            self._in_flight[key].pod = new
            # log the update so add_unschedulable's replay sees it — a pod
            # shrunk mid-attempt must fire its scale-down hint on requeue
            ev = pod_update_event(old, new)
            if ev.action:
                self.on_event(ev, old, new)
            return
        self.add(new)

    def delete(self, pod: t.Pod) -> None:
        key = pod_key(pod)
        for pool in (self._active, self._backoff, self._unschedulable,
                     self._gated, self._in_flight):
            pool.pop(key, None)
        # active/backoff heaps clean up lazily on pop

    # ---------------------------------------------------------------- views

    def __len__(self) -> int:
        return (
            len(self._active) + len(self._backoff) + len(self._unschedulable)
            + len(self._gated)
        )

    def pending_pods(self) -> list[t.Pod]:
        return [
            i.pod
            for pool in (self._active, self._backoff, self._unschedulable,
                         self._gated)
            for i in pool.values()
        ]

    def stats(self) -> dict[str, int]:
        return {
            "active": len(self._active),
            "backoff": len(self._backoff),
            "unschedulable": len(self._unschedulable),
            "gated": len(self._gated),
            "in_flight": len(self._in_flight),
        }

    def debug_json(self, limit: int = 512) -> dict:
        """The ``/debug/queue`` body: per-pod pending reasons — which
        pool, how many attempts/requeues, the unschedulable/pending
        plugin sets, the backoff deadline (absolute + seconds remaining)
        and accumulated queue wait. Point-in-time and best-effort: the
        queue is single-owner by design, so a diagnostics thread reads a
        live snapshot (list() copies per pool) — a concurrent mutation
        can tear counts across pools, never crash the walk. The bundle
        capture reuses this view verbatim."""
        now = self._clock()
        pods: list[dict] = []
        pools = (
            ("active", self._active), ("backoff", self._backoff),
            ("unschedulable", self._unschedulable), ("gated", self._gated),
            ("in_flight", self._in_flight),
        )
        for pool_name, pool in pools:
            for info in list(pool.values()):
                entry: dict = {
                    "pod": info.key,
                    "queue": pool_name,
                    "attempts": info.attempts,
                    "requeues": info.unschedulable_count,
                    "consecutive_errors": info.consecutive_errors,
                    "queue_wait_s": round(info.queue_wait_s, 6),
                }
                if info.unschedulable_plugins:
                    entry["unschedulable_plugins"] = sorted(
                        info.unschedulable_plugins
                    )
                if info.pending_plugins:
                    entry["pending_plugins"] = sorted(info.pending_plugins)
                if pool_name == "backoff":
                    deadline = self._backoff_time(info)
                    entry["backoff_deadline"] = round(deadline, 6)
                    entry["backoff_remaining_s"] = round(
                        max(deadline - now, 0.0), 6
                    )
                if info.nominated_node_name:
                    entry["nominated_node"] = info.nominated_node_name
                pods.append(entry)
                if len(pods) >= limit:
                    break
            if len(pods) >= limit:
                break
        counts = self.stats()
        return {
            "counts": counts,
            "pods": pods,
            "truncated": sum(counts.values()) > len(pods),
        }
