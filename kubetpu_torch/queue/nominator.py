# Port copy of kubetpu/queue/nominator.py, verbatim apart from this note (no JAX in it).
"""Pod nominator — resources reserved by preemption nominations.

Analog of ``pkg/scheduler/backend/queue/nominator.go``: a preemptor that
nominated a node after killing victims must see that room held against
*lower-priority* pods while it waits in backoff. The reference implements
this by running filters twice with nominated pods added to the node
(``RunFilterPluginsWithNominatedPods``, framework/runtime — nominated pods
with priority >= the filtered pod's are added via AddPod); the batched
device path encodes the same rule as a reservation tensor: for batch pod p
and node n, the NodeResourcesFit filter sees
``requested[n] + Σ_g gate[p,g] · requests[g]`` where gate is
``priority[g] >= priority[p] and g is not p itself``.

Only the monotone resource/count dimension is reserved (the reference's
two-pass with/without-nominated dance exists for non-monotone filters like
inter-pod affinity; adding usage can only shrink fit feasibility, so the
single strengthened pass is equivalent for fit).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..api import types as t


@dataclass(frozen=True)
class NominatedPod:
    """One nomination: pod identity + what it reserves where. ``ports``
    carries the pod's host-port triples so the victim search can charge them
    (the reference's AddPod includes the whole nominated pod)."""

    uid: str
    node_name: str
    priority: int
    requests: tuple[tuple[str, int], ...]
    ports: tuple[tuple[int, str, str], ...] = ()


class Nominator:
    """uid-keyed nomination registry (single-owner, like the cache)."""

    def __init__(self) -> None:
        self._by_uid: dict[str, NominatedPod] = {}
        # bumped on every mutation — the pipelined scheduler compares it
        # across a dispatched cycle to detect that an informer event changed
        # the reservation set the in-flight encode was built against
        self.version = 0

    def add(self, pod: t.Pod, node_name: str) -> None:
        from ..state.encoder import _pod_port_triples

        self._by_uid[pod.uid] = NominatedPod(
            uid=pod.uid,
            node_name=node_name,
            priority=pod.priority,
            requests=pod.requests,
            ports=tuple(_pod_port_triples(pod)),
        )
        self.version += 1

    def remove(self, uid: str) -> None:
        if self._by_uid.pop(uid, None) is not None:
            self.version += 1

    def get(self, uid: str) -> NominatedPod | None:
        return self._by_uid.get(uid)

    def entries(self) -> list[NominatedPod]:
        return list(self._by_uid.values())

    def __len__(self) -> int:
        return len(self._by_uid)
