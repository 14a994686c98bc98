# Port copy of kubetpu/state/volumes.py, verbatim apart from this note (no JAX in it).
"""Volume plugin family tensorization: VolumeZone, VolumeBinding (Filter),
VolumeRestrictions (ReadWriteOncePod), NodeVolumeLimits — all as per-pod
``(N,)`` static masks computed once per distinct (namespace, PVC set)
signature and folded into the batch's static mask.

Reference semantics mirrored:

- VolumeZone (plugins/volumezone/volume_zone.go:197 Filter): every bound
  PV's zone/region topology labels must match the node's (beta keys
  translate to GA, :91 translateToGALabel); a node with NO topology labels
  passes everything (:226 single-zone escape); failures are
  UnschedulableAndUnresolvable (:240).
- VolumeBinding Filter (plugins/volumebinding/volume_binding.go:414):
  bound PVC → its PV's spec.nodeAffinity must match the node; unbound PVC
  with an Immediate-mode class → unschedulable everywhere (the PV binder
  owns it); unbound + WaitForFirstConsumer → the node passes iff some
  AVAILABLE PV matches (class, access modes, capacity, node affinity —
  the binder's findMatchingVolumes) or the class can dynamically provision
  (provisioner other than kubernetes.io/no-provisioner).
- VolumeRestrictions (plugins/volumerestrictions/volume_restrictions.go):
  a ReadWriteOncePod PVC already used by another pod rejects the pod
  (PreFilter conflict count > 0).
- NodeVolumeLimits (plugins/nodevolumelimits/csi.go): per CSI driver, the
  count of distinct volumes on the node plus the pod's NEW volumes must
  not exceed the node's ``attachable-volumes-csi-<driver>`` allocatable.

The masks depend on pod spec ONLY through (namespace, pvc names), so they
join the encoder's signature machinery; cluster volume state is read fresh
each encode (the snapshot's lister view).
"""

from __future__ import annotations

import numpy as np

from ..api import types as t
from ..api.selectors import node_selector_term_matches

ATTACHABLE_PREFIX = "attachable-volumes-csi-"

# VolumeZone's topologyLabels (volume_zone.go:83) with beta→GA translation
ZONE_LABELS = {
    "failure-domain.beta.kubernetes.io/zone": "topology.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/region": "topology.kubernetes.io/region",
    "topology.kubernetes.io/zone": None,
    "topology.kubernetes.io/region": None,
}


def node_affinity_matches(
    sel: t.NodeSelector | None, labels: dict, node_name: str
) -> bool:
    """VolumeNodeAffinity required terms (ORed), like pod node affinity."""
    if sel is None:
        return True
    return any(
        node_selector_term_matches(term, labels, node_name)
        for term in sel.terms
    )


class VolumeState:
    """Per-encode view over the snapshot's pv/pvc/storageclass listers plus
    per-node usage aggregates (built lazily)."""

    def __init__(self, snapshot) -> None:
        self.snapshot = snapshot
        self.pvs = snapshot.pvs
        self.pvcs = snapshot.pvcs
        self.classes = snapshot.storage_classes
        self._usage = None          # (driver→(N,) counts, pv→node idx set, rwop)
        self._node_labels = None    # cached list[dict] per encode
        self._driver_limits: dict[str, np.ndarray] = {}

    def has_work(self, pods) -> bool:
        return any(v.pvc_name for p in pods for v in p.volumes)

    def _labels(self, nt) -> list[dict]:
        if self._node_labels is None:
            self._node_labels = [info.node.labels_dict() for info in nt.infos]
        return self._node_labels

    # --- usage aggregates -------------------------------------------------
    def _build_usage(self):
        """Once per VolumeState (= per encode): per-driver distinct-volume
        counts per node, each attached PV's node set, and the in-use RWOP
        claims."""
        if self._usage is not None:
            return self._usage
        infos = self.snapshot.node_infos()
        N = len(infos)
        counts: dict[str, np.ndarray] = {}
        pv_nodes: dict[str, set[int]] = {}
        rwop_used: set[str] = set()   # "ns/name" of RWOP PVCs in use
        for n_i, info in enumerate(infos):
            for pod in info.pods.values():
                for vol in pod.volumes:
                    if not vol.pvc_name:
                        continue
                    key = f"{pod.namespace}/{vol.pvc_name}"
                    pvc = self.pvcs.get(key)
                    if pvc is None:
                        continue
                    if t.READ_WRITE_ONCE_POD in pvc.access_modes:
                        rwop_used.add(key)
                    pv = self.pvs.get(pvc.volume_name) if pvc.volume_name else None
                    if pv is not None and pv.driver:
                        nodes = pv_nodes.setdefault(pv.name, set())
                        if n_i not in nodes:
                            nodes.add(n_i)
                            arr = counts.get(pv.driver)
                            if arr is None:
                                arr = np.zeros(N, dtype=np.int32)
                                counts[pv.driver] = arr
                            arr[n_i] += 1
        self._usage = (counts, pv_nodes, rwop_used)
        return self._usage

    def _limit_array(self, driver: str, nt) -> np.ndarray:
        """(N,) declared attach limit per node, -1 = no limit declared."""
        arr = self._driver_limits.get(driver)
        if arr is None:
            key = ATTACHABLE_PREFIX + driver
            arr = np.full(nt.num_nodes, -1, dtype=np.int64)
            for i, info in enumerate(nt.infos):
                v = info.node.allocatable_dict().get(key)
                if v is not None:
                    arr[i] = v
            self._driver_limits[driver] = arr
        return arr

    # --- the per-signature mask ------------------------------------------
    def mask_for(
        self, namespace: str, volumes, nt, enabled: frozenset
    ) -> np.ndarray | None:
        """(N,) bool or None when the pod has no PVC volumes (or none of the
        volume plugins are enabled). ``nt`` is the NodeTensors (node label
        access); ``enabled`` is the profile's Filter plugin-name set."""
        from .. import names as names_

        want_zone = names_.VOLUME_ZONE in enabled
        want_binding = names_.VOLUME_BINDING in enabled
        want_restrictions = names_.VOLUME_RESTRICTIONS in enabled
        want_limits = names_.NODE_VOLUME_LIMITS in enabled
        if not (want_zone or want_binding or want_restrictions or want_limits):
            return None
        pvc_keys = [
            f"{namespace}/{v.pvc_name}" for v in volumes if v.pvc_name
        ]
        if not pvc_keys:
            return None
        N = nt.num_nodes
        mask = np.ones(N, dtype=bool)
        counts, pv_nodes, rwop_used = self._build_usage()

        node_labels = self._labels(nt)
        new_per_driver: dict[str, set[str]] = {}

        for key in pvc_keys:
            pvc = self.pvcs.get(key)
            if pvc is None:
                # waiting for the PVC object (volume_binding.go PreFilter:
                # unbound claim lookup failure → UnschedulableAndUnresolvable)
                return np.zeros(N, dtype=bool)
            if (
                want_restrictions
                and t.READ_WRITE_ONCE_POD in pvc.access_modes
                and key in rwop_used
            ):
                # VolumeRestrictions: RWOP claim already in use
                return np.zeros(N, dtype=bool)
            if pvc.volume_name:
                pv = self.pvs.get(pvc.volume_name)
                if pv is None:
                    return np.zeros(N, dtype=bool)
                mask &= self._bound_pv_mask(
                    pv, node_labels, nt, want_zone, want_binding
                )
                if pv.driver:
                    new_per_driver.setdefault(pv.driver, set()).add(pv.name)
            elif want_binding:
                sc = self.classes.get(pvc.storage_class)
                if sc is None:
                    return np.zeros(N, dtype=bool)
                if sc.binding_mode != t.BINDING_WAIT_FOR_FIRST_CONSUMER:
                    # Immediate: the PV controller binds it off-scheduler;
                    # until then the pod is unschedulable everywhere
                    return np.zeros(N, dtype=bool)
                mask &= self._wffc_mask(pvc, sc, node_labels, nt)

        # NodeVolumeLimits: new distinct volumes per driver vs allocatable,
        # vectorized over nodes (a PV already attached to a node does not
        # count again — the reference counts unique volume handles)
        if want_limits and new_per_driver:
            for driver, new_pvs in new_per_driver.items():
                limit = self._limit_array(driver, nt)
                if (limit < 0).all():
                    continue   # no node declares a limit for this driver
                existing = counts.get(driver)
                total = (
                    existing.astype(np.int64).copy()
                    if existing is not None else np.zeros(N, dtype=np.int64)
                )
                for pv_name in new_pvs:
                    on_node = pv_nodes.get(pv_name)
                    if not on_node:
                        total += 1
                    else:
                        add = np.ones(N, dtype=np.int64)
                        add[list(on_node)] = 0
                        total += add
                mask &= (limit < 0) | (total <= limit)
        return mask

    def _bound_pv_mask(
        self, pv, node_labels, nt, want_zone: bool, want_binding: bool
    ) -> np.ndarray:
        N = nt.num_nodes
        mask = np.ones(N, dtype=bool)
        # VolumeZone
        pv_labels = pv.labels_dict()
        zone_constraints = [
            (k, v) for k, v in pv_labels.items() if k in ZONE_LABELS
        ]
        if want_zone and zone_constraints:
            for i, labels in enumerate(node_labels):
                if not any(k in labels for k in ZONE_LABELS):
                    continue   # unlabeled node: single-zone escape (:226)
                for k, v in zone_constraints:
                    got = labels.get(k)
                    if got is None and ZONE_LABELS[k]:
                        got = labels.get(ZONE_LABELS[k])   # beta → GA
                    if got != v:
                        mask[i] = False
                        break
        # VolumeBinding bound-PV node affinity
        if want_binding and pv.node_affinity is not None:
            for i, labels in enumerate(node_labels):
                if mask[i] and not node_affinity_matches(
                    pv.node_affinity, labels, nt.node_names[i]
                ):
                    mask[i] = False
        return mask

    def available_pvs_for(self, pvc: t.PersistentVolumeClaim) -> list:
        """The binder's findMatchingVolumes candidate set: unbound PVs of
        the claim's class with compatible access modes and enough capacity,
        smallest first (volume/persistentvolume util's smallest-match)."""
        out = []
        for pv in self.pvs.values():
            if pv.claim_ref and pv.claim_ref != pvc.key:
                continue
            if pv.storage_class != pvc.storage_class:
                continue
            if pvc.access_modes and not set(pvc.access_modes) <= set(pv.access_modes):
                continue
            if pv.capacity < pvc.request:
                continue
            out.append(pv)
        out.sort(key=lambda pv: (pv.capacity, pv.name))
        return out

    def _wffc_mask(self, pvc, sc, node_labels, nt) -> np.ndarray:
        N = nt.num_nodes
        candidates = self.available_pvs_for(pvc)
        mask = np.zeros(N, dtype=bool)
        if candidates:
            for i, labels in enumerate(node_labels):
                for pv in candidates:
                    if node_affinity_matches(
                        pv.node_affinity, labels, nt.node_names[i]
                    ):
                        mask[i] = True
                        break
        if not mask.all() and sc.provisioner and sc.provisioner != t.NO_PROVISIONER:
            # dynamic provisioning can satisfy any node (allowed topologies
            # not yet modeled)
            mask[:] = True
        return mask
