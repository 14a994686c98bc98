"""Slice-alignment functions over the dense topology coordinates (B12).

Port of ``kubetpu/ops/topology.py``: the plain PyTorch versions of its four
functions, each a scatter-add over ``(P,)`` assignment vectors or ``(N,)``
node columns (``index_add_`` in int32). With dense slice ids in ``[0, S]``
(``S`` = the unlabeled bucket) a gang's per-slice member counts are ONE
scatter-add, and from those counts both alignment (same-slice
concentration, Σ c_s²) and the cross-slice cut (G² − Σ c_s²) follow
without a (P, P) pairwise matrix.

On a CUDA device ``slice_counts`` and ``alignment_score`` run fused into
the ``hypothesis_scan`` kernel's epilogue (``kernels/csrc/
hypothesis_scan.cu``), which the placement search and the gang dry run
launch; the functions here are what a CPU batch runs and what that
epilogue is held to. ``slice_occupancy`` prices the packing engine's
slice terms (``assign.packing``); on a CUDA device it runs fused into the
``packing_round`` kernel's node penalties and its end
(``kernels/csrc/packing_round.cu``). ``free_slices`` has no caller in the
port yet (the reference's trace runner reads it).
"""

from __future__ import annotations

import torch

from .reduce import run_local


def slice_counts(
    assignments: torch.Tensor,
    pod_valid: torch.Tensor,
    slice_id: torch.Tensor,
    num_slices: int,
) -> torch.Tensor:
    """(S+1,) int32 — assigned pods per slice (last bucket = unlabeled).

    ``assignments`` is the engine's (P,) node index (-1 unassigned);
    unassigned/padded pods land in the unlabeled bucket with weight 0.
    """
    assigned = (assignments >= 0) & pod_valid
    # clip the -1 sentinel before the gather; its weight is already 0
    node = torch.clamp(assignments, 0, slice_id.shape[0] - 1).long()
    sl = torch.where(assigned, slice_id[node], num_slices).long()
    return torch.zeros(
        num_slices + 1, dtype=torch.int32, device=assignments.device
    ).index_add_(0, sl, assigned.to(torch.int32))


def alignment_score(
    assignments: torch.Tensor,
    pod_valid: torch.Tensor,
    slice_id: torch.Tensor,
    num_slices: int,
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """``(alignment, cut, slices_used)`` for one candidate placement.

    alignment = Σ_s c_s² over LABELED slices — maximal when the whole
    gang shares one slice; cut = G_labeled² − alignment ∝ cross-slice
    member pairs (the DCN traffic proxy); slices_used counts labeled
    slices the gang touches (the fragmentation footprint). All int32
    scalars, comparable across candidates.
    """
    counts = slice_counts(assignments, pod_valid, slice_id, num_slices)
    labeled = counts[:num_slices].to(torch.int64)
    align = torch.sum(labeled * labeled).to(torch.int32)
    g = torch.sum(labeled).to(torch.int32)
    cut = g * g - align
    used = torch.sum(labeled > 0).to(torch.int32)
    return align, cut, used


def slice_occupancy(
    requested: torch.Tensor,
    node_valid: torch.Tensor,
    slice_id: torch.Tensor,
    num_slices: int,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Per-slice occupancy from the node resource rows.

    Returns ``(active, sizes)``: (S+1,) bool — slice has ANY requested
    resource on a valid node — and (S+1,) int32 valid-node counts. The
    packing objective reads these to price "opening" a fully-free slice
    (fragmentation) vs landing in an already-active one (alignment).
    """
    return run_local(slice_occupancy_steps(requested, node_valid, slice_id, num_slices))


def slice_occupancy_steps(requested, node_valid, slice_id, num_slices: int):
    """``slice_occupancy`` in steps form (``ops.reduce``): a slice's nodes
    may span node shards, so its busy-node and valid-node counts are sums
    over the nodes at hand, one reduction point (the two counts stacked)."""
    busy = (torch.sum(requested, dim=1) > 0) & node_valid
    sid = slice_id.long()
    counts = torch.zeros(
        (2, num_slices + 1), dtype=torch.int32, device=requested.device)
    counts[0].index_add_(0, sid, busy.to(torch.int32))
    counts[1].index_add_(0, sid, node_valid.to(torch.int32))
    counts = yield ("sum", counts)
    return counts[0] > 0, counts[1]


def free_slices(
    requested: torch.Tensor,
    node_valid: torch.Tensor,
    slice_id: torch.Tensor,
    num_slices: int,
) -> torch.Tensor:
    """() int32 — labeled slices with ≥1 valid node and ZERO requested
    resources anywhere (the bench's ``slices_free_at_steady_state``)."""
    active, sizes = slice_occupancy(requested, node_valid, slice_id, num_slices)
    labeled_active = active[:num_slices]
    labeled_sizes = sizes[:num_slices]
    return torch.sum((~labeled_active) & (labeled_sizes > 0)).to(torch.int32)
