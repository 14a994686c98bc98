# Port copy of kubetpu/framework/volumebinding.py, verbatim apart from this note, ``engages`` (the
# pods whose hooks do something: the scheduler skips the runner for the rest) and the API writes,
# which go to the scheduler's client (the port binds in direct mode, with no
# API dispatcher; the reference reaches the same client as handle.dispatcher.client).
"""VolumeBinding's Reserve / PreBind half as a lifecycle plugin.

Reference: pkg/scheduler/framework/plugins/volumebinding/volume_binding.go —
``Reserve`` (:521) runs AssumePodVolumes: pick concrete PVs for the pod's
unbound WaitForFirstConsumer claims on the chosen node (the binder's
findMatchingVolumes smallest-fit) and assume the binding in cache;
``Unreserve`` (:594) reverts the assumption; ``PreBind`` (:567) issues the
API writes that actually bind the claims (BindPodVolumes) before the pod
binds. The Filter half lives in the encoder's static volume masks
(state/volumes.py).

The assumed PVC→PV bindings are written into the scheduler's CACHE volume
listers (the reference assumes into its PV cache the same way), so later
cycles' Filter masks see claimed PVs as taken; the informer's eventual
PVC/PV updates confirm them.
"""

from __future__ import annotations

from ..api import types as t
from ..state.volumes import VolumeState, node_affinity_matches
from . import lifecycle as lc


class VolumeBindingPlugin(lc.LifecyclePlugin):
    """Reserve/Unreserve/PreBind for WaitForFirstConsumer claims."""

    name = "VolumeBinding"

    def __init__(self, profile=None) -> None:
        # pod key -> [(pvc, pv_name)] assumed at Reserve
        self._assumed: dict[str, list[tuple[t.PersistentVolumeClaim, str]]] = {}

    def engages(self, pod: t.Pod) -> bool:
        return any(v.pvc_name for v in pod.volumes)

    # -- Reserve (volume_binding.go:521 AssumePodVolumes) -----------------
    def reserve(self, handle, pod: t.Pod, node_name: str) -> lc.Status:
        # FAST PATH: Reserve runs for EVERY scheduled pod — a pod without
        # PVC volumes must cost O(1) here, not a snapshot refresh (that
        # regression turned every cycle into O(batch × nodes))
        if not any(v.pvc_name for v in pod.volumes):
            return lc.Status()
        import dataclasses

        # the live cache IS the lister view (single-owner loop); no
        # snapshot refresh needed for per-pod reserve decisions
        cache = handle.cache
        vs = VolumeState(cache)
        node_info = cache.get_node_info(node_name)
        labels = node_info.node.labels_dict() if node_info else {}
        picks: list[tuple[t.PersistentVolumeClaim, str]] = []
        taken: set[str] = set()   # PVs chosen for EARLIER claims of this pod

        def fail(reason: str) -> lc.Status:
            # revert the picks already applied (AssumePodVolumes reverts on
            # failure — a half-reserved pod must leak nothing)
            for pvc_, pv_name in picks:
                pv_ = cache.pvs.get(pv_name)
                if pv_ is not None:
                    cache.update_pv(dataclasses.replace(pv_, claim_ref=""))
                cache.update_pvc(pvc_)   # original unbound object
            return lc.Status(lc.UNSCHEDULABLE, reason, self.name)

        for vol in pod.volumes:
            if not vol.pvc_name:
                continue
            pvc = cache.pvcs.get(f"{pod.namespace}/{vol.pvc_name}")
            if pvc is None:
                return fail("claim disappeared")
            if pvc.volume_name:
                continue   # already bound
            sc = cache.storage_classes.get(pvc.storage_class)
            if sc is None or sc.binding_mode != t.BINDING_WAIT_FOR_FIRST_CONSUMER:
                return fail("claim not bindable here")
            chosen = ""
            for pv in vs.available_pvs_for(pvc):
                if pv.name in taken:
                    continue   # chosen for an earlier claim of this pod
                if node_affinity_matches(pv.node_affinity, labels, node_name):
                    chosen = pv.name
                    break
            if not chosen:
                if sc.provisioner and sc.provisioner != t.NO_PROVISIONER:
                    continue   # dynamic provisioning handles it at PreBind
                return fail("no matching PersistentVolume on node")
            picks.append((pvc, chosen))
            taken.add(chosen)
            # assume: mark the PV claimed and the PVC bound in the cache's
            # lister view so this cycle's later pods (and later cycles)
            # don't double-book it
            pv = cache.pvs[chosen]
            cache.update_pv(dataclasses.replace(pv, claim_ref=pvc.key))
            cache.update_pvc(dataclasses.replace(pvc, volume_name=chosen))
        if picks:
            self._assumed[f"{pod.namespace}/{pod.name}"] = picks
        return lc.Status()

    def unreserve(self, handle, pod: t.Pod, node_name: str) -> None:
        """RevertAssumedPodVolumes (:594)."""
        import dataclasses

        picks = self._assumed.pop(f"{pod.namespace}/{pod.name}", None)
        if not picks:
            return
        cache = handle.cache
        for pvc, pv_name in picks:
            pv = cache.pvs.get(pv_name)
            if pv is not None and pv.claim_ref == pvc.key:
                cache.update_pv(dataclasses.replace(pv, claim_ref=""))
            cur = cache.pvcs.get(pvc.key)
            if cur is not None and cur.volume_name == pv_name:
                cache.update_pvc(dataclasses.replace(cur, volume_name=""))

    # -- PreBind (volume_binding.go:567 BindPodVolumes) --------------------
    def pre_bind(self, handle, pod: t.Pod, node_name: str) -> lc.Status:
        picks = self._assumed.pop(f"{pod.namespace}/{pod.name}", None)
        if not picks:
            return lc.Status()
        client = handle.client
        bind_pvc = getattr(client, "bind_pvc", None)
        for pvc, pv_name in picks:
            if bind_pvc is not None:
                # the API write (PATCH pvc.spec.volumeName + pv.claimRef)
                bind_pvc(pvc, pv_name)
            # the cache already holds the assumed binding from Reserve; the
            # informer's PVC/PV updates will re-deliver the bound objects
        return lc.Status()


def register(registry: lc.Registry) -> None:
    registry.register("VolumeBinding", VolumeBindingPlugin)
