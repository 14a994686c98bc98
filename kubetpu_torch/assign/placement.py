"""Placement search for pod-group (gang) scheduling (B11).

Port of ``kubetpu/assign/placement.py``. The reference evaluates candidate
placements SEQUENTIALLY: for each placement it restricts the snapshot, runs
the per-pod algorithm, reverts, and finally scores the successful placements
(pkg/scheduler/schedule_one_podgroup.go:632 podGroupSchedulingPlacementAlgorithm,
framework/plugins/topologyaware/topology_placement.go:61 GeneratePlacements).
kubetpu stacks the D candidate placements into a ``(D, N)`` mask tensor and
runs the assignment engine under every mask in one device program (a vmap).
Every placement's simulation is independent (the reference reverts between
them), so the search is exact.

Here ``placement_assign_plain`` is the plain PyTorch version, a loop over
the masks; a CPU batch runs it. On a CUDA batch ``placement_assign_device``
launches the hand-written ``hypothesis_scan`` kernel on the greedy engine
(``kernels.placement_scan``: one block per placement, the alignment fused
into its epilogue), and on the batched engine ``kernels.batched_hypotheses``:
the ``hypothesis_rows`` kernel builds every placement's node rows, the
landed ``filter_score`` and ``batched_round`` kernels run once per
placement, and the ``slice_epilogue`` kernel (the scan's epilogue on its
own) counts and aligns every placement's result.

Placement selection (findBestPlacement, schedule_one_podgroup.go:706) uses
PlacementScore plugins; the in-tree scorer is PodGroupPodsCount
(plugins/podgrouppodscount/podgroup_pods_count.go:52 — scheduled + proposed
count, min-max normalized). With one scorer, normalization is monotone, so
argmax of the raw count picks the same placement; ties break on the FIRST
placement in generation order (deterministic) where the reference picks a
random tie (score.Randomizer).
"""

from __future__ import annotations

import dataclasses

import torch

from ..framework import runtime as rt
from ..ops.topology import alignment_score
from .batched import batched_assign_plain
from .greedy import greedy_assign_plain


def run_hypotheses(
    b: rt.DeviceBatch,
    params: rt.ScoreParams,
    masks: torch.Tensor,
    assign,
    freed_req: torch.Tensor | None = None,
    freed_count: torch.Tensor | None = None,
):
    """Run ``assign`` (an engine: ``(b, params) -> (assignments, state)``)
    once per row of ``masks`` (H, N) bool, each time with ``node_valid &
    masks[h]`` and, when ``freed_req`` (H, N, R) / ``freed_count`` (H, N)
    are given, with ``requested``, ``nonzero_requested`` and ``pod_count``
    less the freed rows, clamped at 0 — the reference's ``one`` in
    ``placement_assign_device`` and ``dry_run_gang_preemption``. Returns
    ``(assignments (H, P) int32, counts (H,) int32, alignment (H,) int32)``;
    alignment is 0 without a topology leaf."""
    rows, aligns = [], []
    for h in range(masks.shape[0]):
        nodes = dataclasses.replace(b.nodes, node_valid=b.node_valid & masks[h])
        if freed_req is not None:
            nodes = dataclasses.replace(
                nodes,
                requested=torch.clamp(b.requested - freed_req[h], min=0),
                nonzero_requested=torch.clamp(
                    b.nonzero_requested - freed_req[h], min=0),
                pod_count=torch.clamp(b.pod_count - freed_count[h], min=0),
            )
        assignments, _ = assign(rt.with_nodes(b, nodes), params)
        if b.topology is not None:
            align, _, _ = alignment_score(
                assignments, b.pod_valid, b.topology.slice_id,
                b.topology.num_slices,
            )
        else:
            align = torch.zeros((), dtype=torch.int32, device=b.device)
        rows.append(assignments)
        aligns.append(align)
    P = b.requests.shape[0]
    assignments = (
        torch.stack(rows) if rows
        else torch.empty((0, P), dtype=torch.int32, device=b.device)
    )
    alignment = (
        torch.stack(aligns) if aligns
        else torch.empty((0,), dtype=torch.int32, device=b.device)
    )
    counts = torch.sum(
        (assignments >= 0) & b.pod_valid[None, :], dim=1
    ).to(torch.int32)
    return assignments, counts, alignment


def placement_assign_plain(
    b: rt.DeviceBatch,
    params: rt.ScoreParams,
    placement_masks: torch.Tensor,
    engine: str = "greedy",
):
    """The plain placement search: the plain engine once per placement.

    Returns ``(assignments (D, P) int32, counts (D,) int32, alignment
    (D,) int32)`` where ``counts[d]`` is how many batch pods placement d
    schedules (the ProposedAssignments count the placement scorer
    consumes) and ``alignment[d]`` is the slice-alignment score of the
    proposal (Σ c_s² over the topology coordinates — ``ops.topology``).
    Alignment is all-zero when the batch carries no topology block, so
    count-first selection is unchanged on a topology-off build.
    """
    assign = batched_assign_plain if engine == "batched" else greedy_assign_plain
    return run_hypotheses(b, params, placement_masks, assign)


def placement_assign_device(
    b: rt.DeviceBatch,
    params: rt.ScoreParams,
    placement_masks: torch.Tensor,
    engine: str = "greedy",
):
    """The placement search where the batch lives: on the CPU the plain
    version; on a CUDA device the ``hypothesis_scan`` kernel (greedy), or
    ``kernels.batched_hypotheses`` (batched). Same results as
    ``placement_assign_plain``."""
    if b.device.type == "cpu":
        return placement_assign_plain(b, params, placement_masks, engine)
    from .. import kernels

    if engine == "batched":
        return kernels.batched_hypotheses(b, params, placement_masks)
    return kernels.placement_scan(b, params, placement_masks)
