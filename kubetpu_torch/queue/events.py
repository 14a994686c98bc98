# Port copy of kubetpu/queue/events.py, verbatim apart from this note (no JAX in it).
"""Cluster events + queueing hints.

Mirrors the event vocabulary of the reference's queueing-hint machinery
(staging/src/k8s.io/kube-scheduler/framework/types.go: ``ClusterEvent`` with
``EventResource`` + ``ActionType`` bitmask, ``QueueingHint`` /
``QueueingHintFn`` :195-230). A hint fn is called for a pod previously
rejected by a plugin when a matching event arrives, and answers whether the
event might make the pod schedulable (QUEUE) or certainly cannot (SKIP).
Errors in hint fns are treated as QUEUE, as the reference does, so a buggy
hint can never strand a pod in the unschedulable pool.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence


class EventResource(str, enum.Enum):
    """types.go EventResource (assignedPod/unschedulablePod collapsed to POD
    plus a dedicated ASSIGNED_POD where the distinction matters)."""

    POD = "Pod"
    ASSIGNED_POD = "AssignedPod"
    NODE = "Node"
    PERSISTENT_VOLUME = "PersistentVolume"
    PERSISTENT_VOLUME_CLAIM = "PersistentVolumeClaim"
    CSI_NODE = "CSINode"
    STORAGE_CLASS = "StorageClass"
    RESOURCE_CLAIM = "ResourceClaim"
    RESOURCE_SLICE = "ResourceSlice"
    DEVICE_CLASS = "DeviceClass"
    WORKLOAD = "Workload"
    WILDCARD = "*"


class ActionType(enum.IntFlag):
    """types.go ActionType bitmask (Add/Delete plus fine-grained Update
    subtypes so hints only fire for relevant field changes)."""

    ADD = 1 << 0
    DELETE = 1 << 1
    UPDATE_NODE_ALLOCATABLE = 1 << 2
    UPDATE_NODE_LABEL = 1 << 3
    UPDATE_NODE_TAINT = 1 << 4
    UPDATE_NODE_CONDITION = 1 << 5
    UPDATE_NODE_ANNOTATION = 1 << 6
    UPDATE_POD_LABEL = 1 << 7
    UPDATE_POD_SCALE_DOWN = 1 << 8
    UPDATE_POD_TOLERATION = 1 << 9
    UPDATE_POD_GATES_ELIMINATED = 1 << 10
    UPDATE_NODE_FEATURE = 1 << 11     # status.declaredFeatures changed
    UPDATE = (
        UPDATE_NODE_ALLOCATABLE | UPDATE_NODE_LABEL | UPDATE_NODE_TAINT
        | UPDATE_NODE_CONDITION | UPDATE_NODE_ANNOTATION | UPDATE_POD_LABEL
        | UPDATE_POD_SCALE_DOWN | UPDATE_POD_TOLERATION
        | UPDATE_POD_GATES_ELIMINATED | UPDATE_NODE_FEATURE
    )
    ALL = ADD | DELETE | UPDATE


@dataclass(frozen=True)
class ClusterEvent:
    """One state change: which resource, what kind of change."""

    resource: EventResource
    action: ActionType
    label: str = ""

    def matches(self, other: "ClusterEvent") -> bool:
        """True when a registered interest (self) covers a fired event
        (other) — a wildcard on either side matches any resource (the
        reference treats a fired WildCardEvent as matching every
        registration, scheduling_queue.go isPodWorthRequeuing), actions
        intersect."""
        if (
            self.resource is not EventResource.WILDCARD
            and other.resource is not EventResource.WILDCARD
            and self.resource is not other.resource
        ):
            return False
        return bool(self.action & other.action)


# The wildcard event the reference uses to force a full requeue
# (types.go EventUnscheduledPodUpdate etc.; WildCardEvent).
EVENT_ALL = ClusterEvent(EventResource.WILDCARD, ActionType.ALL, "WildCardEvent")


class QueueingHint(enum.IntEnum):
    SKIP = 0
    QUEUE = 1


# QueueingHintFn(pod, old_obj, new_obj) -> QueueingHint. ``pod`` is the
# rejected pending pod; old/new are the event's objects (None for add/delete
# respectively), matching types.go:206.
QueueingHintFn = Callable[[Any, Any, Any], QueueingHint]


@dataclass(frozen=True)
class HintRegistration:
    """One (event, hint) registration for a plugin — the analog of
    fwk.ClusterEventWithHint (types.go:180-192). A ``hint`` of None means
    "always QUEUE" (the reference's default when QueueingHintFn is nil)."""

    event: ClusterEvent
    hint: QueueingHintFn | None = None


# plugin name -> registrations; built per profile (scheduler.go:476 builds the
# same map from each plugin's EventsToRegister).
QueueingHintMap = Mapping[str, Sequence[HintRegistration]]


def pod_update_event(old: Any, new: Any) -> ClusterEvent:
    """Classify an unscheduled-pod update into its fine-grained action bits
    (the analog of podSchedulingPropertiesChange in
    pkg/scheduler/util/utils.go) so only hints that care about the changed
    fields fire."""
    action = ActionType(0)
    if old is None:
        return ClusterEvent(EventResource.POD, ActionType.UPDATE)
    if getattr(old, "labels", None) != getattr(new, "labels", None):
        action |= ActionType.UPDATE_POD_LABEL
    if getattr(old, "tolerations", None) != getattr(new, "tolerations", None):
        action |= ActionType.UPDATE_POD_TOLERATION
    old_req = dict(getattr(old, "requests", ()) or ())
    new_req = dict(getattr(new, "requests", ()) or ())
    if new_req != old_req and all(
        new_req.get(k, 0) <= old_req.get(k, 0)
        for k in set(old_req) | set(new_req)
    ):
        action |= ActionType.UPDATE_POD_SCALE_DOWN
    if getattr(old, "scheduling_gates", ()) and not getattr(new, "scheduling_gates", ()):
        action |= ActionType.UPDATE_POD_GATES_ELIMINATED
    # an unclassified change (annotations etc.) keeps action empty — it
    # matches no registration, so irrelevant patches never requeue the pod
    return ClusterEvent(EventResource.POD, action)


def node_update_event(old: Any, new: Any) -> ClusterEvent:
    """Classify a node update into fine-grained action bits (the analog of
    nodeSchedulingPropertiesChange in pkg/scheduler/eventhandlers.go). The
    ``unschedulable`` flag maps to UPDATE_NODE_TAINT, as the reference folds
    spec.unschedulable into the taint event."""
    action = ActionType(0)
    if old is None:
        return ClusterEvent(EventResource.NODE, ActionType.ADD)
    if getattr(old, "allocatable", None) != getattr(new, "allocatable", None):
        action |= ActionType.UPDATE_NODE_ALLOCATABLE
    if getattr(old, "labels", None) != getattr(new, "labels", None):
        action |= ActionType.UPDATE_NODE_LABEL
    if getattr(old, "taints", None) != getattr(new, "taints", None) or (
        getattr(old, "unschedulable", False) != getattr(new, "unschedulable", False)
    ):
        action |= ActionType.UPDATE_NODE_TAINT
    if getattr(old, "declared_features", ()) != getattr(new, "declared_features", ()):
        action |= ActionType.UPDATE_NODE_FEATURE
    return ClusterEvent(EventResource.NODE, action)


def default_queueing_hints(filter_names: Sequence[str]) -> dict[str, list[HintRegistration]]:
    """Default hint map for the in-tree plugin set — which cluster events can
    un-reject a pod rejected by each plugin (each plugin's EventsToRegister;
    e.g. noderesources/fit.go EventsToRegister: Node Add|UpdateNodeAllocatable,
    Pod Delete|UpdatePodScaleDown)."""
    from .. import names as N

    node_add = ClusterEvent(EventResource.NODE, ActionType.ADD)
    reg: dict[str, list[HintRegistration]] = {}

    def add(plugin: str, *events: ClusterEvent) -> None:
        if plugin in filter_names:
            reg[plugin] = [HintRegistration(e) for e in events]

    add(
        N.NODE_RESOURCES_FIT,
        ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_ALLOCATABLE),
        ClusterEvent(EventResource.ASSIGNED_POD, ActionType.DELETE | ActionType.UPDATE_POD_SCALE_DOWN),
        # the pending pod's own request shrank (unscheduled-pod update hint,
        # types.go:142-150 mandates plugins cover this)
        ClusterEvent(EventResource.POD, ActionType.UPDATE_POD_SCALE_DOWN),
    )
    add(
        N.NODE_AFFINITY,
        ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_LABEL),
    )
    add(
        N.NODE_NAME,
        node_add,
    )
    add(
        N.NODE_UNSCHEDULABLE,
        ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_TAINT),
    )
    add(
        N.TAINT_TOLERATION,
        ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_TAINT),
        ClusterEvent(EventResource.POD, ActionType.UPDATE_POD_TOLERATION),
    )
    add(
        N.NODE_PORTS,
        node_add,
        ClusterEvent(EventResource.ASSIGNED_POD, ActionType.DELETE),
    )
    add(
        N.POD_TOPOLOGY_SPREAD,
        ClusterEvent(EventResource.ASSIGNED_POD, ActionType.ADD | ActionType.DELETE | ActionType.UPDATE_POD_LABEL),
        ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.DELETE | ActionType.UPDATE_NODE_LABEL | ActionType.UPDATE_NODE_TAINT),
    )
    add(
        N.INTER_POD_AFFINITY,
        ClusterEvent(EventResource.ASSIGNED_POD, ActionType.ADD | ActionType.DELETE | ActionType.UPDATE_POD_LABEL),
        ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_LABEL | ActionType.UPDATE_NODE_TAINT),
    )
    # DefaultPreemption is not a filter: a preemption-nominated pod waits for
    # its victims' deletes (defaultpreemption EventsToRegister), so its hint
    # registers unconditionally.
    reg[N.DEFAULT_PREEMPTION] = [
        HintRegistration(
            ClusterEvent(EventResource.ASSIGNED_POD, ActionType.DELETE)
        ),
        HintRegistration(node_add),
    ]
    add(
        N.VOLUME_ZONE,
        ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_LABEL),
        ClusterEvent(EventResource.PERSISTENT_VOLUME, ActionType.ADD | ActionType.UPDATE),
        ClusterEvent(EventResource.PERSISTENT_VOLUME_CLAIM, ActionType.ADD | ActionType.UPDATE),
    )
    add(
        N.VOLUME_RESTRICTIONS,
        ClusterEvent(EventResource.ASSIGNED_POD, ActionType.DELETE),
        node_add,
    )
    add(
        N.NODE_VOLUME_LIMITS,
        ClusterEvent(EventResource.CSI_NODE, ActionType.ADD | ActionType.UPDATE),
        ClusterEvent(EventResource.ASSIGNED_POD, ActionType.DELETE),
    )
    add(
        N.NODE_DECLARED_FEATURES,
        # nodedeclaredfeatures EventsToRegister: a node add or a kubelet
        # upgrade changing status.declaredFeatures can un-reject
        ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_FEATURE),
    )
    add(
        N.DYNAMIC_RESOURCES,
        # dynamicresources.go EventsToRegister (:245): claim changes (an
        # allocation/deallocation or the template-instance creation), new
        # slices/classes (capacity appeared), node adds, pod deletes
        # (devices freed via the claim's deallocation)
        ClusterEvent(EventResource.RESOURCE_CLAIM, ActionType.ADD | ActionType.UPDATE | ActionType.DELETE),
        ClusterEvent(EventResource.RESOURCE_SLICE, ActionType.ADD | ActionType.UPDATE),
        ClusterEvent(EventResource.DEVICE_CLASS, ActionType.ADD | ActionType.UPDATE),
        node_add,
        ClusterEvent(EventResource.ASSIGNED_POD, ActionType.DELETE),
    )
    add(
        N.VOLUME_BINDING,
        node_add,
        ClusterEvent(EventResource.PERSISTENT_VOLUME, ActionType.ADD | ActionType.UPDATE),
        ClusterEvent(EventResource.PERSISTENT_VOLUME_CLAIM, ActionType.ADD | ActionType.UPDATE),
        ClusterEvent(EventResource.STORAGE_CLASS, ActionType.ADD),
    )
    return reg
