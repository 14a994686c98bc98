# Port copy of kubetpu/bridge/convert.py, verbatim apart from this note (no JAX in it).
"""v1.Pod / v1.Node JSON → kubetpu typed objects.

The extender webhook receives real Kubernetes API objects
(staging/src/k8s.io/kube-scheduler/extender/v1/types.go ExtenderArgs carries
``*v1.Pod`` and ``*v1.NodeList``); this module decodes the
scheduling-relevant envelope into ``kubetpu.api.types`` dataclasses, using
the same aggregation the reference applies (computePodResourceRequest,
fit.go:317; NodeInfo.Resource canonical units).
"""

from __future__ import annotations

import calendar
import time
from typing import Any, Mapping

from ..api import types as t
from ..api.requests import pod_nonzero_requests, pod_requests
from .quantity import canonical_resource

_JSON = Mapping[str, Any]


def _requirements(exprs) -> tuple[t.Requirement, ...]:
    out = []
    for e in exprs or ():
        out.append(
            t.Requirement(
                key=e.get("key", ""),
                operator=t.Operator(e.get("operator", "In")),
                values=tuple(e.get("values") or ()),
            )
        )
    return tuple(out)


def _label_selector(sel: _JSON | None) -> t.LabelSelector | None:
    if sel is None:
        return None
    return t.LabelSelector(
        match_labels=tuple(sorted((sel.get("matchLabels") or {}).items())),
        match_expressions=_requirements(sel.get("matchExpressions")),
    )


def _node_selector_term(term: _JSON) -> t.NodeSelectorTerm:
    return t.NodeSelectorTerm(
        match_expressions=_requirements(term.get("matchExpressions")),
        match_fields=_requirements(term.get("matchFields")),
    )


def _affinity(spec_affinity: _JSON | None) -> t.Affinity | None:
    if not spec_affinity:
        return None
    na = pa = paa = None
    if "nodeAffinity" in spec_affinity:
        j = spec_affinity["nodeAffinity"] or {}
        req = j.get("requiredDuringSchedulingIgnoredDuringExecution")
        required = (
            t.NodeSelector(
                terms=tuple(
                    _node_selector_term(term)
                    for term in req.get("nodeSelectorTerms") or ()
                )
            )
            if req is not None else None
        )
        preferred = tuple(
            t.PreferredSchedulingTerm(
                weight=int(p.get("weight", 0)),
                term=_node_selector_term(p.get("preference") or {}),
            )
            for p in j.get("preferredDuringSchedulingIgnoredDuringExecution") or ()
        )
        na = t.NodeAffinity(required=required, preferred=preferred)

    def pod_aff(j: _JSON | None) -> t.PodAffinity | None:
        if not j:
            return None
        return t.PodAffinity(
            required=tuple(
                _pod_affinity_term(term)
                for term in j.get("requiredDuringSchedulingIgnoredDuringExecution") or ()
            ),
            preferred=tuple(
                t.WeightedPodAffinityTerm(
                    weight=int(w.get("weight", 0)),
                    term=_pod_affinity_term(w.get("podAffinityTerm") or {}),
                )
                for w in j.get("preferredDuringSchedulingIgnoredDuringExecution") or ()
            ),
        )

    pa = pod_aff(spec_affinity.get("podAffinity"))
    paa = pod_aff(spec_affinity.get("podAntiAffinity"))
    if na is None and pa is None and paa is None:
        return None
    return t.Affinity(node_affinity=na, pod_affinity=pa, pod_anti_affinity=paa)


def _pod_affinity_term(term: _JSON) -> t.PodAffinityTerm:
    return t.PodAffinityTerm(
        topology_key=term.get("topologyKey", ""),
        selector=_label_selector(term.get("labelSelector")),
        namespaces=tuple(term.get("namespaces") or ()),
        namespace_selector=_label_selector(term.get("namespaceSelector")),
    )


def _tolerations(spec: _JSON) -> tuple[t.Toleration, ...]:
    out = []
    for j in spec.get("tolerations") or ():
        effect = j.get("effect")
        out.append(
            t.Toleration(
                key=j.get("key", ""),
                operator=t.TolerationOperator(j.get("operator", "Equal")),
                value=j.get("value", ""),
                effect=t.TaintEffect(effect) if effect else None,
            )
        )
    return tuple(out)


def _spread(spec: _JSON) -> tuple[t.TopologySpreadConstraint, ...]:
    out = []
    for j in spec.get("topologySpreadConstraints") or ():
        out.append(
            t.TopologySpreadConstraint(
                max_skew=int(j.get("maxSkew", 1)),
                topology_key=j.get("topologyKey", ""),
                when_unsatisfiable=t.UnsatisfiableConstraintAction(
                    j.get("whenUnsatisfiable", "DoNotSchedule")
                ),
                selector=_label_selector(j.get("labelSelector")),
                min_domains=j.get("minDomains"),
                node_affinity_policy=j.get("nodeAffinityPolicy", "Honor"),
                node_taints_policy=j.get("nodeTaintsPolicy", "Ignore"),
                match_label_keys=tuple(j.get("matchLabelKeys") or ()),
            )
        )
    return tuple(out)


def _creation_index(meta: _JSON) -> int:
    """creationTimestamp (RFC3339) → epoch seconds; the framework only needs
    a monotone ordering for queue sort + victim importance."""
    ts = meta.get("creationTimestamp")
    if not ts:
        return 0
    try:
        return calendar.timegm(time.strptime(ts, "%Y-%m-%dT%H:%M:%SZ"))
    except ValueError:
        return 0


def _container_requests(c: _JSON) -> dict[str, int]:
    req = ((c.get("resources") or {}).get("requests")) or {}
    return {name: canonical_resource(name, q) for name, q in req.items()}


def pod_from_v1(obj: _JSON) -> t.Pod:
    """Decode a v1.Pod JSON object (the scheduling envelope)."""
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    containers = [
        _container_requests(c) for c in spec.get("containers") or ()
    ]
    init_containers = [
        _container_requests(c) for c in spec.get("initContainers") or ()
    ]
    # restartPolicy: Always marks a sidecar whose requests persist for the
    # pod's lifetime (component-helpers/resource/helpers.go:243,438)
    init_restartable = [
        c.get("restartPolicy") == "Always"
        for c in spec.get("initContainers") or ()
    ]
    overhead = {
        name: canonical_resource(name, q)
        for name, q in (spec.get("overhead") or {}).items()
    }
    requests = pod_requests(
        containers, init_containers, overhead, init_restartable=init_restartable
    )
    nonzero = pod_nonzero_requests(
        containers, init_containers, overhead, init_restartable=init_restartable
    )
    ports = []
    for c in spec.get("containers") or ():
        for p in c.get("ports") or ():
            hp = int(p.get("hostPort", 0) or 0)
            if hp > 0:
                ports.append(
                    t.ContainerPort(
                        host_port=hp,
                        protocol=p.get("protocol", "TCP") or "TCP",
                        host_ip=p.get("hostIP", "") or "",
                    )
                )
    images = tuple(
        c["image"] for c in spec.get("containers") or () if c.get("image")
    )
    return t.Pod(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default") or "default",
        uid=meta.get("uid") or f"{meta.get('namespace', 'default')}/{meta.get('name', '')}",
        labels=t.freeze_map(meta.get("labels")),
        requests=t.freeze_map(requests),
        nonzero=t.freeze_map(nonzero),
        node_name=spec.get("nodeName", "") or "",
        node_selector=t.freeze_map(spec.get("nodeSelector")),
        affinity=_affinity(spec.get("affinity")),
        tolerations=_tolerations(spec),
        topology_spread_constraints=_spread(spec),
        priority=int(spec.get("priority", 0) or 0),
        ports=tuple(ports),
        scheduling_gates=tuple(
            g.get("name", "") for g in spec.get("schedulingGates") or ()
        ),
        images=images,
        preemption_policy=spec.get("preemptionPolicy", "PreemptLowerPriority")
        or "PreemptLowerPriority",
        creation_index=_creation_index(meta),
        scheduling_group=(
            (spec.get("schedulingGroup") or {}).get("podGroupName") or ""
        ),
        scheduler_name=spec.get("schedulerName", "default-scheduler")
        or "default-scheduler",
        # spec.resourceClaims with resolved instance names from
        # status.resourceClaimStatuses (the resourceclaim controller fills
        # them; pods with unresolved templates carry claim_name="")
        resource_claims=_resource_claims(obj),
        # the reference INFERS required features from the full spec
        # (component-helpers/nodedeclaredfeatures InferForPodScheduling);
        # this envelope carries aggregates, so the explicit carrier is the
        # kubetpu.io/required-node-features annotation (comma-separated)
        required_node_features=tuple(sorted(
            f.strip() for f in (
                (meta.get("annotations") or {})
                .get("kubetpu.io/required-node-features", "")
                .split(",")
            ) if f.strip()
        )),
    )


def _resource_claims(obj: _JSON) -> tuple[t.PodResourceClaim, ...]:
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    resolved = {
        s.get("name", ""): s.get("resourceClaimName", "")
        for s in status.get("resourceClaimStatuses") or ()
    }
    out = []
    for rc in spec.get("resourceClaims") or ():
        name = rc.get("name", "")
        claim = rc.get("resourceClaimName") or resolved.get(name, "")
        out.append(t.PodResourceClaim(
            name=name, claim_name=claim,
            template=rc.get("resourceClaimTemplateName", "") or "",
        ))
    return tuple(out)


def pod_group_from_v1alpha3(obj: _JSON) -> t.PodGroup:
    """Decode a scheduling/v1alpha3 PodGroup (types.go:339) — gang policy +
    topology constraint keys."""
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    policy = spec.get("schedulingPolicy") or {}
    gang = policy.get("gang")
    constraints = spec.get("schedulingConstraints") or {}
    keys = tuple(
        c.get("key", "") for c in constraints.get("topology") or () if c.get("key")
    )
    return t.PodGroup(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default") or "default",
        gang=t.GangPolicy(min_count=int(gang.get("minCount", 1))) if gang else None,
        topology_keys=keys,
    )


def _selector_to_v1(sel: t.LabelSelector | None) -> dict | None:
    if sel is None:
        return None
    out: dict = {}
    if sel.match_labels:
        out["matchLabels"] = dict(sel.match_labels)
    if sel.match_expressions:
        out["matchExpressions"] = [
            {"key": r.key, "operator": r.operator.value,
             "values": list(r.values)}
            for r in sel.match_expressions
        ]
    return out


def _term_to_v1(term: t.PodAffinityTerm) -> dict:
    out: dict = {"topologyKey": term.topology_key}
    if term.selector is not None:
        out["labelSelector"] = _selector_to_v1(term.selector)
    if term.namespaces:
        out["namespaces"] = list(term.namespaces)
    if term.namespace_selector is not None:
        out["namespaceSelector"] = _selector_to_v1(term.namespace_selector)
    return out


def _node_term_to_v1(term: t.NodeSelectorTerm) -> dict:
    out: dict = {}
    if term.match_expressions:
        out["matchExpressions"] = [
            {"key": r.key, "operator": r.operator.value,
             "values": list(r.values)}
            for r in term.match_expressions
        ]
    if term.match_fields:
        out["matchFields"] = [
            {"key": r.key, "operator": r.operator.value,
             "values": list(r.values)}
            for r in term.match_fields
        ]
    return out


def pod_to_v1(pod: t.Pod) -> dict:
    """Encode a Pod back into the v1 JSON scheduling envelope — the wire
    format the extender CLIENT posts (ExtenderArgs.Pod, extender.go:399
    ``send``). Inverse of :func:`pod_from_v1` for the fields it decodes
    (requests ride a single synthetic container)."""
    spec: dict = {
        "containers": [{
            "name": "c0",
            # canonical units back to quantities: cpu is milli ("750m"),
            # memory/storage are bytes, scalars are counts
            "resources": {"requests": {
                k: (f"{v}m" if k == t.CPU else str(v))
                for k, v in pod.requests
            }},
            "ports": [
                {"hostPort": p.host_port, "protocol": p.protocol,
                 **({"hostIP": p.host_ip} if p.host_ip else {})}
                for p in pod.ports
            ],
        }],
        "priority": pod.priority,
        "schedulerName": pod.scheduler_name,
        "preemptionPolicy": pod.preemption_policy,
    }
    if pod.node_name:
        spec["nodeName"] = pod.node_name
    if pod.node_selector:
        spec["nodeSelector"] = dict(pod.node_selector)
    if pod.tolerations:
        spec["tolerations"] = [
            {
                "key": tol.key, "operator": tol.operator.value,
                "value": tol.value,
                **({"effect": tol.effect.value} if tol.effect else {}),
            }
            for tol in pod.tolerations
        ]
    if pod.scheduling_gates:
        spec["schedulingGates"] = [
            {"name": g} for g in pod.scheduling_gates
        ]
    if pod.topology_spread_constraints:
        spec["topologySpreadConstraints"] = [
            {
                "maxSkew": c.max_skew, "topologyKey": c.topology_key,
                "whenUnsatisfiable": c.when_unsatisfiable.value,
                **({"labelSelector": _selector_to_v1(c.selector)}
                   if c.selector is not None else {}),
                **({"minDomains": c.min_domains}
                   if c.min_domains is not None else {}),
            }
            for c in pod.topology_spread_constraints
        ]
    aff: dict = {}
    if pod.affinity is not None:
        na = pod.affinity.node_affinity
        if na is not None:
            na_out: dict = {}
            if na.required is not None:
                na_out["requiredDuringSchedulingIgnoredDuringExecution"] = {
                    "nodeSelectorTerms": [
                        _node_term_to_v1(term) for term in na.required.terms
                    ]
                }
            if na.preferred:
                na_out["preferredDuringSchedulingIgnoredDuringExecution"] = [
                    {"weight": p.weight, "preference": _node_term_to_v1(p.term)}
                    for p in na.preferred
                ]
            aff["nodeAffinity"] = na_out
        for field_name, pa in (
            ("podAffinity", pod.affinity.pod_affinity),
            ("podAntiAffinity", pod.affinity.pod_anti_affinity),
        ):
            if pa is None:
                continue
            pa_out: dict = {}
            if pa.required:
                pa_out["requiredDuringSchedulingIgnoredDuringExecution"] = [
                    _term_to_v1(term) for term in pa.required
                ]
            if pa.preferred:
                pa_out["preferredDuringSchedulingIgnoredDuringExecution"] = [
                    {"weight": w.weight, "podAffinityTerm": _term_to_v1(w.term)}
                    for w in pa.preferred
                ]
            aff[field_name] = pa_out
    if aff:
        spec["affinity"] = aff
    if pod.resource_claims:
        spec["resourceClaims"] = [
            {"name": rc.name,
             **({"resourceClaimName": rc.claim_name} if rc.claim_name else {}),
             **({"resourceClaimTemplateName": rc.template}
                if rc.template else {})}
            for rc in pod.resource_claims
        ]
    annotations = {}
    if pod.required_node_features:
        annotations["kubetpu.io/required-node-features"] = ",".join(
            pod.required_node_features
        )
    return {
        "metadata": {
            "name": pod.name,
            "namespace": pod.namespace,
            "uid": pod.uid,
            **({"labels": dict(pod.labels)} if pod.labels else {}),
            **({"annotations": annotations} if annotations else {}),
        },
        "spec": spec,
    }


def node_from_v1(obj: _JSON) -> t.Node:
    """Decode a v1.Node JSON object (the scheduling envelope)."""
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    alloc = {
        name: canonical_resource(name, q)
        for name, q in (status.get("allocatable") or {}).items()
    }
    taints = tuple(
        t.Taint(
            key=j.get("key", ""),
            value=j.get("value", "") or "",
            effect=t.TaintEffect(j.get("effect", "NoSchedule")),
        )
        for j in spec.get("taints") or ()
    )
    images: list[tuple[str, t.ImageState]] = []
    for img in status.get("images") or ():
        state = t.ImageState(size_bytes=int(img.get("sizeBytes", 0) or 0))
        for name in img.get("names") or ():
            images.append((name, state))
    return t.Node(
        name=meta.get("name", ""),
        labels=t.freeze_map(meta.get("labels")),
        allocatable=t.freeze_map(alloc),
        taints=taints,
        unschedulable=bool(spec.get("unschedulable", False)),
        images=tuple(sorted(images)),
        # status.declaredFeatures (core/v1 types.go:6828,
        # +featureGate=NodeDeclaredFeatures)
        declared_features=tuple(sorted(status.get("declaredFeatures") or ())),
    )
