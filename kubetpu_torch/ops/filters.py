"""Filter kernels — boolean masks over ``(pods, nodes)``.

Port of ``kubetpu/ops/filters.py``: the plain PyTorch versions, function for
function. On a CUDA device the scheduler's main path does not call these
one by one: ``kernels/csrc/score_common.cuh`` fuses them into the
``filter_score`` and ``greedy_scan`` kernels, and ``chip_smoke.py`` holds
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


def resource_fit_mask_nominated(*args, **kwargs) -> torch.Tensor:
    """NodeResourcesFit with nominator reservations. Nominations come with
    preemption, which the port has not reached (ROADMAP Queue A item 8)."""
    raise NotImplementedError(
        "resource_fit_mask_nominated: nominated pods arrive with preemption "
        "(ROADMAP Queue A item 8, kernel B9), not yet ported"
    )


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
