# Port copy of kubetpu/api/requests.py, verbatim apart from this note (no JAX in it).
"""Pod resource-request aggregation.

Reference semantics: ``resource.PodRequests`` (k8s.io/component-helpers
resource helpers, helpers.go:243 podRequests / :438 aggregation), as used by
``computePodResourceRequest`` (pkg/scheduler/framework/plugins/noderesources/
fit.go:317-327):

    total  = sum over app containers of per-resource requests
    sidecar init containers (restartPolicy: Always) run for the pod's whole
    lifetime: their requests ADD to the running total, and accumulate into a
    sidecar sum that also rides along with every later (non-sidecar) init
    container's peak:
        for each init container, in order:
            if sidecar: total += req; sidecar_sum += req; candidate = sidecar_sum
            else:       candidate = req + sidecar_sum
            init_peak = max(init_peak, candidate)     (element-wise)
    total  = max(total, init_peak)                    (element-wise)
    total += pod overhead

Pod-level resources (PodLevelResources feature) take precedence when set.
"""

from __future__ import annotations

from typing import Mapping, Sequence


def _add(a: dict[str, int], b: Mapping[str, int]) -> None:
    for k, v in b.items():
        a[k] = a.get(k, 0) + v


def _max_merge(a: dict[str, int], b: Mapping[str, int]) -> None:
    for k, v in b.items():
        if v > a.get(k, 0):
            a[k] = v


def pod_requests(
    containers: Sequence[Mapping[str, int]] = (),
    init_containers: Sequence[Mapping[str, int]] = (),
    overhead: Mapping[str, int] | None = None,
    pod_level: Mapping[str, int] | None = None,
    init_restartable: Sequence[bool] | None = None,
) -> dict[str, int]:
    """Aggregate container requests into the pod's effective request.

    ``init_restartable[i]`` marks init container *i* as a sidecar
    (``restartPolicy: Always``) — its requests persist for the pod's
    lifetime instead of participating only in the init-phase peak
    (helpers.go:243 podRequests restartable branch).
    """
    total: dict[str, int] = {}
    for c in containers:
        _add(total, c)
    sidecar_sum: dict[str, int] = {}
    init_peak: dict[str, int] = {}
    for i, ic in enumerate(init_containers):
        if init_restartable is not None and i < len(init_restartable) and init_restartable[i]:
            _add(total, ic)
            _add(sidecar_sum, ic)
            candidate: Mapping[str, int] = dict(sidecar_sum)
        else:
            cand = dict(ic)
            _add(cand, sidecar_sum)
            candidate = cand
        _max_merge(init_peak, candidate)
    _max_merge(total, init_peak)
    if pod_level:
        # Pod-level resources override the aggregate for the resources they name.
        for k, v in pod_level.items():
            total[k] = v
    if overhead:
        _add(total, overhead)
    return {k: v for k, v in total.items() if v != 0}


def pod_nonzero_requests(
    containers: Sequence[Mapping[str, int]] = (),
    init_containers: Sequence[Mapping[str, int]] = (),
    overhead: Mapping[str, int] | None = None,
    pod_level: Mapping[str, int] | None = None,
    init_restartable: Sequence[bool] | None = None,
) -> dict[str, int]:
    """The NonZeroRequested (scoring) view of the pod's cpu/memory request.

    Reference: PodInfo.CalculateResource (pkg/scheduler/framework/types.go:1035)
    — every *container* missing a cpu/memory request is treated as requesting
    100 mCPU / 200 MiB (getNonMissingContainerRequests, :1387), then the same
    max(sum(containers), max(init)) + overhead aggregation runs. The defaults
    are per-container, so a pod with containers [{cpu:500m}, {memory:1GiB}]
    has Non0CPU = 600m, not 500m. A request EXPLICITLY set to zero is NOT
    defaulted ("Override if un-set, but not if explicitly set to zero" —
    schedutil GetRequestForResource): a present-but-zero key stays zero.

    When pod-level resources are set for a resource, that resource's default
    is not filled (the pod-level value wins).
    """
    from .types import CPU, DEFAULT_MEMORY_REQUEST, DEFAULT_MILLI_CPU_REQUEST, MEMORY

    def fill(c: Mapping[str, int]) -> dict[str, int]:
        out = dict(c)
        if CPU not in out and not (pod_level and pod_level.get(CPU, 0) > 0):
            out[CPU] = DEFAULT_MILLI_CPU_REQUEST
        if MEMORY not in out and not (pod_level and pod_level.get(MEMORY, 0) > 0):
            out[MEMORY] = DEFAULT_MEMORY_REQUEST
        return out

    return pod_requests(
        [fill(c) for c in containers],
        [fill(ic) for ic in init_containers],
        overhead,
        pod_level,
        init_restartable,
    )
