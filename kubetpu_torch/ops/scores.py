"""Score kernels — int64 scores in [0, 100] over ``(pods, nodes)``.

Port of ``kubetpu/ops/scores.py``: the plain PyTorch versions, function for
function. ``kernels/csrc/score_common.cuh`` computes the same arithmetic per
(pod, node) pair inside the hand-written kernels.

The reference computes scores per node inside ``RunScorePlugins``
(framework/runtime/framework.go:1351): parallel per-node Score, then
NormalizeScore, then multiply by plugin weight and sum. Each function here
produces the *raw* per-plugin score tensor; normalization and weighting live
in ``default_normalize`` / the framework runtime so the composition order
matches the reference exactly.

Integer arithmetic is int64 end-to-end where the reference uses int64.
``//`` on torch integer tensors floors, as ``jnp`` does; it is used only
where the reference uses it. ``_trunc_div`` is Go's truncating division.
"""

from __future__ import annotations

import torch

MAX_NODE_SCORE = 100


def _weighted_mean(
    per_res: torch.Tensor,     # (P, N, R) int64 per-resource scores
    pod_req: torch.Tensor,     # (P, R) int64 — pod's request (participation rule)
    cap: torch.Tensor,         # (1, N, R) int64 allocatable
    weights: torch.Tensor,     # (R,) int64
    is_scalar: torch.Tensor,   # (R,) bool
    require_positive_score: bool = False,
    round_half_up: bool = False,
) -> torch.Tensor:
    """The shared weight-accumulation rule of the resource strategies
    (resource_allocation.go:180 skip rules + each strategy's weightSum loop):
    a resource participates when weight > 0, node allocatable > 0, and — for
    extended/scalar resources — the pod requests it. RequestedToCapacityRatio
    additionally requires the per-resource score to be > 0 and rounds the
    final mean half-up (math.Round) instead of truncating."""
    participate = (
        (weights[None, None, :] > 0)
        & (cap > 0)
        & (~is_scalar[None, None, :] | (pod_req[:, None, :] > 0))
    )
    if require_positive_score:
        participate = participate & (per_res > 0)
    w = torch.where(participate, weights[None, None, :], 0)
    num = torch.sum(per_res * w, dim=-1)
    den = torch.sum(w, dim=-1)
    if round_half_up:
        out = (2 * num + den) // (2 * den).clamp(min=1)
    else:
        out = num // den.clamp(min=1)
    return torch.where(den > 0, out, 0)


def least_allocated_score(
    pod_nonzero: torch.Tensor,    # (P, R) int64 — NonZero view (100mCPU/200MiB defaults)
    node_nonzero: torch.Tensor,   # (N, R) int64 — sum of NonZero requests on node
    alloc: torch.Tensor,          # (N, R) int64
    weights: torch.Tensor,        # (R,) int64 — 0 for resources not scored
    is_scalar: torch.Tensor,      # (R,) bool — extended resources (skip when pod req 0)
) -> torch.Tensor:
    """LeastAllocated strategy (noderesources/least_allocated.go:31):

        per-resource: ((capacity - requested) * 100) // capacity,
                      0 if capacity == 0 or requested > capacity
        node score:   Σ(score_i * w_i) // Σ(w_i)   over participating resources

    Returns (P, N) int64.
    """
    cap = alloc[None, :, :]                                   # (1, N, R)
    requested = node_nonzero[None, :, :] + pod_nonzero[:, None, :]  # (P, N, R)
    safe_cap = cap.clamp(min=1)
    per_res = torch.where(
        (cap > 0) & (requested <= cap),
        ((cap - requested) * MAX_NODE_SCORE) // safe_cap,
        0,
    )                                                         # (P, N, R)
    return _weighted_mean(per_res, pod_nonzero, cap, weights, is_scalar)


def most_allocated_score(
    pod_nonzero: torch.Tensor,
    node_nonzero: torch.Tensor,
    alloc: torch.Tensor,
    weights: torch.Tensor,
    is_scalar: torch.Tensor,
) -> torch.Tensor:
    """MostAllocated strategy (noderesources/most_allocated.go):
    per-resource ``(min(requested, capacity) * 100) // capacity`` (requests can
    exceed capacity because of NonZero defaults), 0 when capacity == 0.
    Weighted mean as in LeastAllocated."""
    cap = alloc[None, :, :]
    requested = node_nonzero[None, :, :] + pod_nonzero[:, None, :]
    safe_cap = cap.clamp(min=1)
    clamped = torch.minimum(requested, cap)  # requested > capacity clamps to max score
    per_res = torch.where(cap > 0, (clamped * MAX_NODE_SCORE) // safe_cap, 0)
    return _weighted_mean(per_res, pod_nonzero, cap, weights, is_scalar)


def _trunc_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Go's int64 division truncates toward zero; ``//`` floors. Segment
    slopes in a decreasing shape make the numerator negative, so match Go.
    ``b`` is clamped to at least 1 in magnitude, as the reference does."""
    return torch.div(a, b.abs().clamp(min=1) * torch.where(b < 0, -1, 1),
                     rounding_mode="trunc")


def broken_linear(p: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """helper.BuildBrokenLinearFunction (plugins/helper/shape_score.go):
    exact int64 piecewise-linear bracket. ``xs`` strictly increasing."""
    b = xs.shape[0]
    idx = torch.searchsorted(xs, p.contiguous())      # first i with xs[i] >= p
    hi = idx.clamp(0, b - 1)
    lo = (idx - 1).clamp(0, b - 1)
    x0, y0, x1, y1 = xs[lo], ys[lo], xs[hi], ys[hi]
    interp = y0 + _trunc_div((y1 - y0) * (p - x0), x1 - x0)
    out = torch.where(idx == 0, ys[0], interp)
    return torch.where(idx >= b, ys[-1], out)


def requested_to_capacity_ratio_score(
    pod_nonzero: torch.Tensor,
    node_nonzero: torch.Tensor,
    alloc: torch.Tensor,
    weights: torch.Tensor,
    is_scalar: torch.Tensor,
    shape_utilization: torch.Tensor,  # (B,) int64 — bracket x points, 0..100, increasing
    shape_score: torch.Tensor,        # (B,) int64 — bracket y, PRE-SCALED ×10 to 0..100
) -> torch.Tensor:
    """RequestedToCapacityRatio strategy (noderesources/requested_to_capacity_ratio.go
    buildRequestedToCapacityRatioScorerFunction), exact int64 semantics:

    - utilization = requested*100//capacity; capacity==0 or overflow → 100
    - per-resource score = broken-linear(shape) at that utilization
    - a resource's weight counts only when its score > 0
    - node score = round(Σ(score·w) / Σw), half away from zero (math.Round)
    """
    cap = alloc[None, :, :]
    requested = node_nonzero[None, :, :] + pod_nonzero[:, None, :]
    safe_cap = cap.clamp(min=1)
    util = torch.where(
        (cap > 0) & (requested <= cap),
        (requested * MAX_NODE_SCORE) // safe_cap,
        MAX_NODE_SCORE,
    )
    per_res = broken_linear(util, shape_utilization, shape_score)
    return _weighted_mean(
        per_res, pod_nonzero, cap, weights, is_scalar,
        require_positive_score=True, round_half_up=True,
    )


def _balanced_std(frac: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """std over the participating fractions, with the reference's case split
    (balanced_allocation.go): exactly 2 → |f1-f2|/2; >2 → population std;
    <2 → 0. ``frac`` (..., R) float64, ``present`` (..., R) bool.

    Every sum over R runs in index order (a loop, not a tree reduction), so
    the kernel's loop in ``score_common.cuh`` reproduces it bit for bit."""
    R = frac.shape[-1]
    n = torch.sum(present, dim=-1)
    denom = n.clamp(min=1)
    zero = torch.zeros(frac.shape[:-1], dtype=frac.dtype, device=frac.device)
    total = zero
    for r in range(R):
        total = total + torch.where(present[..., r], frac[..., r], 0.0)
    mean = total / denom
    sq = zero
    absdev = zero
    for r in range(R):
        d = frac[..., r] - mean
        sq = sq + torch.where(present[..., r], d * d, 0.0)
        absdev = absdev + torch.where(present[..., r], d.abs(), 0.0)
    std_many = torch.sqrt(sq / denom)
    # two-resource shortcut: |f1 - f2| / 2 over the two present entries.
    # sum of |f_i - mean| over 2 entries == |f1 - f2|; /2 matches.
    std_two = absdev / 2.0
    return torch.where(n == 2, std_two, torch.where(n > 2, std_many, 0.0))


def balanced_allocation_score(
    pod_requests: torch.Tensor,   # (P, R) int64 — exact requests (useRequested=true)
    node_requested: torch.Tensor,  # (N, R) int64 — exact requested on node
    alloc: torch.Tensor,          # (N, R) int64
    weights: torch.Tensor,        # (R,) int64 — which resources participate (>0)
    is_scalar: torch.Tensor,      # (R,) bool
) -> torch.Tensor:
    """NodeResourcesBalancedAllocation (balanced_allocation.go:248
    balancedResourceScorer):

        score = 50 + (50 + score_with_pod - score_without_pod) / 2

    where each side is ``int64((1 - std(fractions)) * 100)`` and fractions are
    ``min(requested/allocatable, 1)`` over participating resources, in
    float64. Best-effort pods (all participating requests zero) are skipped
    (→ 0) by PreScore. Returns (P, N) int64.
    """
    f64 = torch.float64
    cap = alloc[None, :, :].to(f64)
    present = (
        (weights[None, None, :] > 0)
        & (alloc[None, :, :] > 0)
        & (~is_scalar[None, None, :] | (pod_requests[:, None, :] > 0))
    )                                                          # (P, N, R)
    with_pod = (node_requested[None, :, :] + pod_requests[:, None, :]).to(f64)
    without_pod = node_requested[None, :, :].to(f64).expand(with_pod.shape)
    safe_cap = cap.clamp(min=1.0)
    f_with = torch.clamp(with_pod / safe_cap, max=1.0)
    f_without = torch.clamp(without_pod / safe_cap, max=1.0)
    score_with = ((1.0 - _balanced_std(f_with, present)) * MAX_NODE_SCORE).to(torch.int64)
    score_without = ((1.0 - _balanced_std(f_without, present)) * MAX_NODE_SCORE).to(torch.int64)
    score = MAX_NODE_SCORE // 2 + (MAX_NODE_SCORE // 2 + score_with - score_without) // 2
    # best-effort skip: all participating pod requests are zero
    best_effort = torch.all(
        (pod_requests == 0) | (weights[None, :] == 0), dim=-1
    )                                                          # (P,)
    return torch.where(best_effort[:, None], 0, score)


def default_normalize(
    raw: torch.Tensor, reverse: bool = False, mx: torch.Tensor | None = None
) -> torch.Tensor:
    """helper.DefaultNormalizeScore (plugins/helper/normalize_score.go:27),
    vectorized over the pod axis: per pod, scale [0, max] → [0, 100]
    (integer division), optionally reversed. raw: (P, N) int64. ``mx``
    (P, 1): the row maxima when the caller reduced them itself (over a
    node-sharded row, every shard's)."""
    if mx is None:
        mx = torch.amax(raw, dim=-1, keepdim=True)            # (P, 1)
    scaled = torch.where(mx > 0, (MAX_NODE_SCORE * raw) // mx.clamp(min=1), 0)
    if reverse:
        # maxCount == 0 with reverse=true → all scores become maxPriority.
        scaled = MAX_NODE_SCORE - scaled
    return scaled


def image_locality_score(
    sum_scores: torch.Tensor,     # (P, N) int64 — Σ scaled image sizes present on node
    image_count: torch.Tensor,    # (P,) int32 — number of image sources in pod spec
) -> torch.Tensor:
    """ImageLocality (imagelocality/image_locality.go:96 calculatePriority):
    clamp sumScores to [minThreshold, maxContainerThreshold*imageCount] and
    scale to [0, 100]. minThreshold = 23 MiB, maxContainerThreshold = 1000 MiB
    (image_locality.go:34-35)."""
    min_threshold = 23 * 1024 * 1024
    max_container_threshold = 1000 * 1024 * 1024
    max_threshold = max_container_threshold * image_count.to(torch.int64)[:, None]
    s = torch.clamp(sum_scores, min=min_threshold)
    s = torch.minimum(s, max_threshold.clamp(min=min_threshold))
    denom = (max_threshold - min_threshold).clamp(min=1)
    return MAX_NODE_SCORE * (s - min_threshold) // denom
