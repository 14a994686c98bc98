# Port copy of kubetpu/framework/dynamicresources.py, verbatim apart from this note, ``engages`` (the
# pods whose hooks do something: the scheduler skips the runner for the rest) and the API writes,
# which go to the scheduler's client (the port binds in direct mode, with no
# API dispatcher; the reference reaches the same client as handle.dispatcher.client).
"""DynamicResources lifecycle half: Reserve / Unreserve / PreBind.

Reference: pkg/scheduler/framework/plugins/dynamicresources/
dynamicresources.go — Reserve allocates devices in-memory (:1146),
Unreserve rolls the in-memory allocation back and drops the pod's
reservation (:1255), PreBind writes claim status through the API (:1334
bindClaim: allocation + reservedFor entry).

The device-side Filter already enforced feasibility (dense pool columns are
capacity-coupled by the assignment engine; host-path specs carried an exact
feasibility mask), so Reserve's exact re-allocation against the live cache
is the *authoritative* check: a pod that lost an in-batch race on a
host-path claim fails here, is forgotten, and requeues — the reference's
assume-then-fail convergence.
"""

from __future__ import annotations

from ..api import types as t
from . import lifecycle as lc


class DynamicResourcesPlugin(lc.LifecyclePlugin):
    name = "DynamicResources"

    def __init__(self, profile=None) -> None:
        # "ns/name" of pod -> (claim keys WE allocated, all claim keys)
        self._assumed: dict[str, tuple[list[str], list[str]]] = {}

    def engages(self, pod: t.Pod) -> bool:
        return bool(pod.resource_claims)

    # ------------------------------------------------------------- Reserve
    def reserve(self, handle, pod: t.Pod, node_name: str) -> lc.Status:
        # FAST PATH: Reserve runs for every scheduled pod — claimless pods
        # must cost O(1) here
        if not pod.resource_claims:
            return lc.Status()
        index = handle.cache.dra
        keys = [
            f"{pod.namespace}/{rc.claim_name}"
            for rc in pod.resource_claims if rc.claim_name
        ]
        to_allocate: list[t.ResourceClaim] = []
        shared: list[str] = []
        for key in keys:
            claim = index.claims.get(key)
            if claim is None:
                return lc.Status(
                    lc.UNSCHEDULABLE, f"resourceclaim {key} not found",
                    self.name,
                )
            if claim.allocation is not None:
                pinned = claim.allocation.node_name
                if pinned and pinned != node_name:
                    return lc.Status(
                        lc.UNSCHEDULABLE,
                        f"resourceclaim {key} allocated for node {pinned}",
                        self.name,
                    )
                if (
                    pod.uid not in claim.reserved_for
                    and len(claim.reserved_for) >= t.RESERVED_FOR_MAX
                ):
                    return lc.Status(
                        lc.UNSCHEDULABLE,
                        f"resourceclaim {key} reservedFor is full",
                        self.name,
                    )
                shared.append(key)
            else:
                to_allocate.append(claim)
        allocated: list[str] = []
        if to_allocate:
            labels = self._node_labels(handle, node_name)
            allocs = index.allocate_on_node(to_allocate, node_name, labels)
            if allocs is None:
                # lost an in-batch race (or the world moved): forget + requeue
                return lc.Status(
                    lc.UNSCHEDULABLE,
                    f"cannot allocate devices on node {node_name}",
                    self.name,
                )
            for claim, alloc in zip(to_allocate, allocs):
                index.set_allocation(claim.key, alloc, pod.uid)
                allocated.append(claim.key)
        for key in shared:
            index.add_reserved(key, pod.uid)
        self._assumed[f"{pod.namespace}/{pod.name}"] = (allocated, keys)
        if allocated:
            # the in-memory allocation is what the claim informer will echo
            # after PreBind's status write; pods rejected THIS cycle (e.g. a
            # co-batched sharer of the same claim) must see the transition,
            # so fire the claim event now — the queue's in-flight replay
            # delivers it to pods requeued later in the cycle
            self._fire_claim_events(handle, allocated)
        return lc.Status()

    @staticmethod
    def _fire_claim_events(handle, keys) -> None:
        from ..queue.events import ActionType, ClusterEvent, EventResource

        index = handle.cache.dra
        for key in keys:
            handle.queue.on_event(
                ClusterEvent(EventResource.RESOURCE_CLAIM, ActionType.UPDATE),
                None, index.claims.get(key),
            )

    @staticmethod
    def _node_labels(handle, node_name: str) -> dict:
        info = handle.cache.get_node_info(node_name)
        if info is None:
            return {}
        return info.node.labels_dict()

    # ----------------------------------------------------------- Unreserve
    def unreserve(self, handle, pod: t.Pod, node_name: str) -> None:
        entry = self._assumed.pop(f"{pod.namespace}/{pod.name}", None)
        if entry is None:
            return
        allocated, keys = entry
        index = handle.cache.dra
        released = []
        for key in allocated:
            # deallocate ONLY when no co-batched sharer still reserves the
            # claim (release_claim keeps the allocation alive for them)
            if index.release_claim(key, pod.uid):
                released.append(key)
        for key in keys:
            if key not in allocated:
                index.remove_reserved(key, pod.uid)
        if released:
            # deallocation freed devices — wake parked claimants
            self._fire_claim_events(handle, released)

    # ------------------------------------------------------------- PreBind
    def pre_bind(self, handle, pod: t.Pod, node_name: str) -> lc.Status:
        # the entry stays until PostBind: a bind failure AFTER PreBind must
        # still find it so Unreserve can roll the allocation back
        # (bindingCycle's deferred unreserve, schedule_one.go:391)
        entry = self._assumed.get(f"{pod.namespace}/{pod.name}")
        if entry is None:
            return lc.Status()
        _allocated, keys = entry
        index = handle.cache.dra
        client = handle.client
        update = getattr(client, "update_claim_status", None)
        if update is not None:
            for key in keys:
                claim = index.claims.get(key)
                if claim is not None:
                    # the claim-status API write (bindClaim :1478): the
                    # allocation + the pod's reservedFor entry land together
                    update(claim)
        return lc.Status()

    # ------------------------------------------------------------ PostBind
    def post_bind(self, handle, pod: t.Pod, node_name: str) -> None:
        # the bind landed: the allocation is permanent, drop the rollback
        # record (Unreserve after this point must not deallocate)
        self._assumed.pop(f"{pod.namespace}/{pod.name}", None)
