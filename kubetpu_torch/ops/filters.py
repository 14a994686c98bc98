"""Filter kernels — boolean masks over ``(pods, nodes)``.

Port of ``kubetpu/ops/filters.py``: the plain PyTorch versions, function for
function. On a CUDA device the scheduler's main path does not call these
one by one: ``kernels/csrc/score_common.cuh`` fuses them (nominated fit
included) into the ``filter_score``, ``greedy_scan`` and ``batched_round``
kernels, and ``chip_smoke.py`` holds
those kernels to the compositions built from the functions here.

The reference runs Filter plugins per (pod, node) inside a chunked
parallel-for (``findNodesThatPassFilters``, pkg/scheduler/schedule_one.go:771,
``parallelize/parallelism.go:68``). Here every predicate is a vectorized
tensor op producing the full ``(P, N)`` mask; the label/taint predicates
were already folded into ``PodBatch.static_mask`` by the encoder. The
*dynamic* filters — ones that depend on state that evolves as the batch
assigns pods — are NodeResourcesFit (below) and NodePorts (interned port
triples × conflict matrix, evaluated in
``framework.runtime.feasible_and_scores``).
"""

from __future__ import annotations

import torch


def resource_fit_mask(
    pod_requests: torch.Tensor,   # (P, R) int64, exact requests (not NonZero)
    alloc: torch.Tensor,          # (N, R) int64
    requested: torch.Tensor,      # (N, R) int64, exact requested on node
    pod_count: torch.Tensor,      # (N,) int32
    allowed_pods: torch.Tensor,   # (N,) int32
) -> torch.Tensor:
    """NodeResourcesFit Filter (noderesources/fit.go:647 fitsRequest):

    - per resource: infeasible when ``req > 0 and req > allocatable - used``
    - pod count: infeasible when ``len(pods) + 1 > allowedPodNumber``
    Returns (P, N) bool.
    """
    free = alloc - requested                                  # (N, R)
    req = pod_requests[:, None, :]                            # (P, 1, R)
    ok = (req == 0) | (req <= free[None, :, :])               # (P, N, R)
    mask = torch.all(ok, dim=-1)                              # (P, N)
    room = (pod_count + 1) <= allowed_pods                    # (N,)
    return mask & room[None, :]


def resource_fit_mask_nominated(
    pod_requests: torch.Tensor,   # (P, R) int64
    alloc: torch.Tensor,          # (N, R)
    requested: torch.Tensor,      # (N, R)
    pod_count: torch.Tensor,      # (N,)
    allowed_pods: torch.Tensor,   # (N,)
    gate: torch.Tensor,           # (P, G) bool — nomination applies to pod p
    g_node: torch.Tensor,         # (G,) int32 nominated node index (-1 none)
    g_req: torch.Tensor,          # (G, R) int64 nominated pod requests
) -> torch.Tensor:
    """NodeResourcesFit with nominator reservations
    (RunFilterPluginsWithNominatedPods' fit dimension): pod p additionally
    sees ``Σ_g gate[p,g]·requests[g]`` charged to g's nominated node, and
    one pod slot for each such g. The (P,N,R) intermediate is never
    materialized — one (P,N) plane per resource.

    The reference contracts in f64 (an s64 dot is outside XLA's TPU
    vocabulary); so does this version, because CUDA has no integer matmul.
    Every addend is an integer and every partial sum stays below 2^53
    (resource quantities are far below it), so each f64 sum is exact in any
    order and equals the int64 sum bit for bit."""
    n = alloc.shape[0]
    onehot = (
        g_node[:, None] == torch.arange(n, dtype=g_node.dtype, device=g_node.device)
    )                                                                 # (G, N)
    gate_f = gate.to(torch.float64)
    onehot_f = onehot.to(torch.float64)
    extra_cnt = (gate_f @ onehot_f).to(torch.int64)                   # (P, N)
    mask = (pod_count[None, :] + 1 + extra_cnt) <= allowed_pods[None, :]
    free = alloc - requested                                          # (N, R)
    for r in range(alloc.shape[1]):
        plane = onehot_f * g_req[:, r].to(torch.float64)[:, None]     # (G, N)
        extra_r = (gate_f @ plane).to(torch.int64)
        req_r = pod_requests[:, r][:, None]                           # (P, 1)
        mask = mask & ((req_r == 0) | (req_r <= free[None, :, r] - extra_r))
    return mask


def resource_fit_mask_single(
    pod_request: torch.Tensor,    # (R,) int64
    alloc: torch.Tensor,          # (N, R)
    requested: torch.Tensor,      # (N, R)
    pod_count: torch.Tensor,      # (N,)
    allowed_pods: torch.Tensor,   # (N,)
) -> torch.Tensor:
    """(N,) variant: one pod against every node."""
    free = alloc - requested
    ok = (pod_request[None, :] == 0) | (pod_request[None, :] <= free)
    return torch.all(ok, dim=-1) & ((pod_count + 1) <= allowed_pods)
