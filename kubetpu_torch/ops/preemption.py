"""Preemption victim search (kernel B9) and the gang dry run (kernel B13).

Port of ``kubetpu/ops/preemption.py``: the reference's dry-run preemption
(pkg/scheduler/framework/preemption/preemption.go:404 DryRunPreemption +
pkg/scheduler/framework/plugins/defaultpreemption/default_preemption.go:252
SelectVictimsOnNode), exhaustive over all candidate nodes at once instead of
sampling a candidate subset and simulating nodes one goroutine at a time.

Per-node semantics, as in the reference:

1. potential victims = pods with priority < preemptor's
   (default_preemption.go:396 isPreemptionAllowed)
2. preemptor must fit with ALL of them removed (:302) — fit here covers the
   victim-*dependent* filters (NodeResourcesFit, NodePorts, pod count);
   victim-independent filters are the caller-supplied ``potential`` mask
3. PDB violation marking walks victims in MoreImportantPod order
   (:315 filterPodsWithPDBViolation; util.MoreImportantPod = higher
   priority first, earlier start time breaks ties; equal keys keep slot
   order, as the reference's stable ``lax.sort`` does)
4. reprieve: violating victims first, then non-violating, each in importance
   order; a victim is reprieved iff the preemptor still fits with it back
   (:316-343)
5. node choice = pickOneNodeForPreemption's lexicographic refinement
   (preemption.go:311): fewest PDB violations → lowest highest-victim
   priority → lowest summed priority (+2^31 per victim) → fewest victims →
   latest earliest-start-time among highest-priority victims → first node.

Scope note (the reference's documented divergence, kept): the in-kernel
re-check covers resources/count/ports; nodes whose failure involved hard
spread/inter-pod-affinity are excluded by the caller's ``potential`` mask.

``dry_run_preemption_plain`` is the plain PyTorch version: the reference's
``select_victims_node`` vmapped over nodes becomes a node axis written out in
front, and its two sorts and two scans over the K victim slots become stable
sorts and Python loops over K. ``dry_run_preemption`` launches the
hand-written ``dry_run_preemption`` CUDA kernel (``kernels/csrc/
dry_run_preemption.cu``) for tensors on a CUDA device, and runs the plain
version for tensors on the CPU. The reference donates ``potential`` and
``v_valid`` to its outputs; torch has no donation, so the outputs here are
fresh tensors.

``dry_run_gang_preemption`` is the topology-aware gang mode: the
preemptor gang's whole engine under C "this gang evicted" hypotheses, on a
CUDA device in the ``hypothesis_scan`` kernel (``kernels/csrc/
hypothesis_scan.cu``), with ``dry_run_gang_preemption_plain`` beside it.
"""

from __future__ import annotations

import torch

I64_MIN = -(2**62)
I64_MAX = 2**62
PRIO_OFFSET = 2**31  # preemption.go:339 MaxInt32+1 shift


def _fits(pod_req, alloc, req_state, count_state, allowed, wants_conf, port_counts):
    """Does the preemptor fit each node's state? NodeResourcesFit semantics
    (req==0 passes; fit.go fitsRequest) + pod count + NodePorts conflict
    against live port-usage counts. Node axis leading: ``alloc`` /
    ``req_state`` (N, R), ``count_state`` / ``allowed`` (N,),
    ``port_counts`` (N, Kp); returns (N,) bool."""
    ok_r = torch.all((pod_req[None, :] == 0) | (pod_req[None, :] <= alloc - req_state), dim=-1)
    ok_c = (count_state + 1) <= allowed
    ok_p = ~torch.any(wants_conf[None, :] & (port_counts > 0), dim=-1)
    return ok_r & ok_c & ok_p


def _stable_order(keys, n_slots):
    """Slot order of each row by the lexicographic ``keys`` (each (N, K),
    most significant first), ties by ascending slot: stable sorts from the
    least significant key up."""
    order = torch.arange(n_slots, device=keys[0].device).expand(keys[0].shape[0], n_slots)
    for key in reversed(keys):
        k_sorted = torch.gather(key, 1, order)
        idx = torch.sort(k_sorted, dim=1, stable=True).indices
        order = torch.gather(order, 1, idx)
    return order


def select_victims_node(
    pod_req,        # (R,) int64 — preemptor exact requests
    pod_prio,       # () int64
    wants_conf,     # (Kp,) bool — preemptor port triples × conflict matrix
    alloc,          # (N, R) int64
    requested,      # (N, R) int64
    pod_count,      # (N,) int32
    allowed,        # (N,) int32
    v_valid,        # (N, K) bool
    v_prio,         # (N, K) int64
    v_start,        # (N, K) int64
    v_req,          # (N, K, R) int64
    v_ports,        # (N, K, Kp) int8
    v_pdb,          # (N, K, D) bool
    port_counts,    # (N, Kp) int32
    pdb_allowed,    # (D,) int64
):
    """Every node's SelectVictimsOnNode (the reference's function vmapped
    over the leading node axis). Returns ``(ok, victims (N, K) bool,
    n_pdb_viol, max_prio, sum_prio, n_victims, earliest_start)``, each
    stat (N,) — they feed pick_node."""
    N, K = v_valid.shape
    rows = torch.arange(N, device=v_valid.device)
    eligible = v_valid & (v_prio < pod_prio)
    has_eligible = torch.any(eligible, dim=1)
    e64 = eligible.to(torch.int64)

    # state with every eligible victim removed
    base_req = requested - torch.sum(e64[:, :, None] * v_req, dim=1)
    base_count = pod_count.to(torch.int64) - torch.sum(e64, dim=1)
    base_ports = port_counts - torch.sum(
        e64[:, :, None] * v_ports.to(torch.int64), dim=1
    ).to(port_counts.dtype)
    fits_base = _fits(
        pod_req, alloc, base_req, base_count, allowed, wants_conf, base_ports
    )

    # importance order: priority desc, start asc; ineligible slots last
    imp_key = torch.where(eligible, -v_prio, I64_MAX)
    by_importance = _stable_order((imp_key, v_start), K)

    # PDB violation flags, walking importance order
    allowed_d = pdb_allowed[None, :].expand(N, -1).clone()
    violating = torch.zeros((N, K), dtype=torch.bool, device=v_valid.device)
    for j in range(K):
        k = by_importance[:, j]
        matched = v_pdb[rows, k] & eligible[rows, k][:, None]     # (N, D)
        allowed_d = allowed_d - matched.to(torch.int64)
        violating[rows, k] = torch.any(matched & (allowed_d < 0), dim=1)

    # reprieve order: violating group first, then importance within group
    grp_key = torch.where(violating, 0, 1)
    grp_key = torch.where(eligible, grp_key, 2)
    reprieve_order = _stable_order((grp_key, imp_key, v_start), K)

    req_s, cnt_s, ports_s = base_req, base_count, base_ports
    victims = torch.zeros((N, K), dtype=torch.bool, device=v_valid.device)
    n_pdb_viol = torch.zeros(N, dtype=torch.int64, device=v_valid.device)
    for j in range(K):
        k = reprieve_order[:, j]
        try_req = req_s + v_req[rows, k]
        try_cnt = cnt_s + 1
        try_ports = ports_s + v_ports[rows, k].to(ports_s.dtype)
        fits = _fits(
            pod_req, alloc, try_req, try_cnt, allowed, wants_conf, try_ports
        )
        elig_k = eligible[rows, k]
        take = elig_k & fits            # reprieved: stays on the node
        req_s = torch.where(take[:, None], try_req, req_s)
        cnt_s = torch.where(take, try_cnt, cnt_s)
        ports_s = torch.where(take[:, None], try_ports, ports_s)
        is_victim = elig_k & ~fits
        victims[rows, k] = is_victim
        n_pdb_viol = n_pdb_viol + (is_victim & violating[rows, k]).to(torch.int64)

    n_victims = torch.sum(victims, dim=1).to(torch.int64)
    ok = has_eligible & fits_base & (n_victims > 0)
    max_prio = torch.max(torch.where(victims, v_prio, I64_MIN), dim=1).values
    sum_prio = torch.sum(torch.where(victims, v_prio + PRIO_OFFSET, 0), dim=1)
    highest = victims & (v_prio == max_prio[:, None])
    earliest_start = torch.min(torch.where(highest, v_start, I64_MAX), dim=1).values
    return ok, victims, n_pdb_viol, max_prio, sum_prio, n_victims, earliest_start


def pick_node(ok, n_pdb_viol, max_prio, sum_prio, n_victims, earliest_start):
    """pickOneNodeForPreemption (preemption.go:311): iterative lexicographic
    refinement over score functions, first node breaking any remaining tie.
    Returns the chosen node index as a () int32 tensor, -1 when no node is
    a candidate."""
    any_ok = torch.any(ok)
    cands = ok
    # maximize each score in turn, keeping only argmax ties
    for score in (
        -n_pdb_viol,            # fewest PDB violations
        -max_prio,              # lowest highest-victim priority
        -sum_prio,              # lowest summed (shifted) priorities
        -n_victims,             # fewest victims
        earliest_start,         # latest earliest-start of highest-prio victims
    ):
        best = torch.max(torch.where(cands, score, I64_MIN))
        cands = cands & (score == best)
    idx = torch.argmax(cands.to(torch.int8)).to(torch.int32)  # first candidate
    return torch.where(any_ok, idx, torch.tensor(-1, dtype=torch.int32, device=ok.device))


def dry_run_preemption_plain(
    pod_req, pod_prio, wants_conf, potential,
    alloc, requested, pod_count, allowed, port_counts,
    v_valid, v_prio, v_start, v_req, v_ports, v_pdb, pdb_allowed,
):
    """All nodes at once: SelectVictimsOnNode over every node, gated by the
    caller's ``potential`` (N,) mask (nodes whose failure preemption could
    resolve — preemption.go:180 NodesForStatusCode(Unschedulable)), then
    pick_node. ``pod_prio`` is an int (or a () int64 tensor).

    Returns ``(node_idx () int32, victims (N, K) bool, ok (N,) bool, n_pdb
    (N,) int64)`` — the victims row of the chosen node is the preemption
    plan; ``ok``/``n_pdb`` expose the full candidate set."""
    ok, victims, n_pdb, max_p, sum_p, n_v, early = select_victims_node(
        pod_req, pod_prio, wants_conf, alloc, requested, pod_count, allowed,
        v_valid, v_prio, v_start, v_req, v_ports, v_pdb, port_counts,
        pdb_allowed,
    )
    ok = ok & potential
    node_idx = pick_node(ok, n_pdb, max_p, sum_p, n_v, early)
    return node_idx, victims, ok, n_pdb


def dry_run_preemption_ranked_plain(
    pod_req, pod_prio, wants_conf, potential,
    alloc, requested, pod_count, allowed, port_counts,
    v_valid, v_prio, v_start, v_req, v_ports, v_pdb, pdb_allowed,
    nodes_per_block: int = 8,
):
    """The plain mirror of the ``dry_run_preemption`` kernel's decomposition
    (``kernels/csrc/dry_run_preemption.cu``), for the tests: each slot's
    importance rank by counting (the slots before it: a lower key, or an
    equal key and an earlier start, or both equal and a lower slot); each
    PDB's violation flags from prefix counts of its matched eligible slots
    over those ranks; the reprieve order by counting too (a violating
    slot's step is the number of violating slots before it in rank order,
    another eligible slot's the violating slots' count plus the other
    eligible slots before it) and the walk over its steps, on the free
    room (alloc - requested + the eligible slots' requests) and the port
    counts; the stats; then each block of ``nodes_per_block`` nodes keeps
    its best ok node by pick_node's refinement, and the blocks' bests merge
    with ``first_best``. Same arguments and results as
    ``dry_run_preemption_plain``."""
    from ..parallel.mesh import first_best

    N, K = v_valid.shape
    D = pdb_allowed.shape[0]
    dev = v_valid.device
    rows = torch.arange(N, device=dev)
    eligible = v_valid & (v_prio < pod_prio)
    key = torch.where(eligible, -v_prio, I64_MAX)
    e64 = eligible.to(torch.int64)
    n_elig = e64.sum(dim=1)
    free = alloc - requested + torch.sum(e64[:, :, None] * v_req, dim=1)
    ports_s = port_counts - torch.sum(
        e64[:, :, None] * v_ports.to(torch.int64), dim=1).to(port_counts.dtype)
    cnt = pod_count.to(torch.int64) - n_elig

    def fits(free, ports_s, cnt):
        ok_r = torch.all((pod_req[None, :] == 0) | (pod_req[None, :] <= free), dim=-1)
        ok_p = ~torch.any(wants_conf[None, :] & (ports_s > 0), dim=-1)
        return ok_r & ok_p & (cnt + 1 <= allowed)

    fits_base = fits(free, ports_s, cnt)

    # importance ranks by counting; order[rank] = slot
    slot = torch.arange(K, device=dev)
    kj, kk = key[:, None, :], key[:, :, None]
    sj, sk = v_start[:, None, :], v_start[:, :, None]
    before = (kj < kk) | ((kj == kk) & (
        (sj < sk) | ((sj == sk) & (slot[None, None, :] < slot[None, :, None]))))
    rank = before.sum(dim=2)
    order = torch.empty_like(rank).scatter_(1, rank, slot.expand(N, K).contiguous())

    # PDB flags by prefix counts over the ranks
    matched = v_pdb & eligible[:, :, None]
    m_ord = torch.gather(matched, 1, order[:, :, None].expand(N, K, D))
    count = torch.cumsum(m_ord.to(torch.int64), dim=1)
    viol_ord = torch.any(m_ord & (pdb_allowed[None, None, :] - count < 0), dim=2)

    # the reprieve order by counting: the violating slots, then the other
    # eligible ones, each group in rank order (ineligible slots to a
    # column past the end)
    elig_ord = torch.gather(eligible, 1, order)
    first = elig_ord & viol_ord
    second = elig_ord & ~viol_ord
    n_first = first.sum(dim=1, keepdim=True)
    step = torch.where(first, torch.cumsum(first.to(torch.int64), dim=1) - 1,
                       n_first + torch.cumsum(second.to(torch.int64), dim=1) - 1)
    step = torch.where(elig_ord, step, K)
    rep = torch.full((N, K + 1), -1, dtype=torch.int64, device=dev)
    rep.scatter_(1, step, torch.where(elig_ord, order, -1))

    # the reprieve: a walk over the steps
    victims = torch.zeros((N, K), dtype=torch.bool, device=dev)
    n_pdb_viol = torch.zeros(N, dtype=torch.int64, device=dev)
    for i in range(K):
        k = rep[:, i]
        walk = k >= 0
        k = torch.clamp(k, min=0)
        try_free = free - v_req[rows, k]
        try_ports = ports_s + v_ports[rows, k].to(ports_s.dtype)
        f = fits(try_free, try_ports, cnt + 1)
        keep = walk & f
        free = torch.where(keep[:, None], try_free, free)
        ports_s = torch.where(keep[:, None], try_ports, ports_s)
        cnt = cnt + keep.to(torch.int64)
        victim = walk & ~f
        victims[rows, k] = victims[rows, k] | victim
        n_pdb_viol = n_pdb_viol + (victim & (i < n_first[:, 0])).to(torch.int64)

    n_victims = torch.sum(victims, dim=1).to(torch.int64)
    ok = (n_elig > 0) & fits_base & (n_victims > 0) & potential
    max_prio = torch.max(torch.where(victims, v_prio, I64_MIN), dim=1).values
    sum_prio = torch.sum(torch.where(victims, v_prio + PRIO_OFFSET, 0), dim=1)
    highest = victims & (v_prio == max_prio[:, None])
    earliest = torch.min(torch.where(highest, v_start, I64_MAX), dim=1).values

    # each block's best, then the merge
    bests = []
    for lo in range(0, N, nodes_per_block):
        hi = min(N, lo + nodes_per_block)
        j = int(pick_node(ok[lo:hi], n_pdb_viol[lo:hi], max_prio[lo:hi], sum_prio[lo:hi],
                          n_victims[lo:hi], earliest[lo:hi]))
        if j >= 0:
            bests.append((pick_keys(n_pdb_viol, max_prio, sum_prio, n_victims, earliest,
                                    lo + j), lo + j))
    node = first_best(bests)
    return (torch.tensor(node, dtype=torch.int32, device=dev), victims, ok, n_pdb_viol)


def dry_run_preemption(*args):
    """The dry run where its tensors live: the hand-written
    ``dry_run_preemption`` kernel on a CUDA device, the plain version on the
    CPU. Same arguments and results as ``dry_run_preemption_plain``."""
    if args[3].device.type == "cpu":
        return dry_run_preemption_plain(*args)
    from ..kernels import dry_run_preemption as kernel

    return kernel(*args)


def pick_keys(n_pdb_viol, max_prio, sum_prio, n_victims, earliest_start, j: int) -> tuple:
    """pick_node's five keys of node ``j``, each to maximize, in order."""
    return (-int(n_pdb_viol[j]), -int(max_prio[j]), -int(sum_prio[j]),
            -int(n_victims[j]), int(earliest_start[j]))


def dry_run_preemption_sharded(shard_args, offsets):
    """The dry run over node shards: ``shard_args[g]`` is shard g's
    ``dry_run_preemption`` arguments (its node rows of every node-axis
    argument, a copy of the rest, all on its device), ``offsets[g]`` its
    first global node. Each shard searches its own nodes and keeps its
    first best by pick_node's refinement; the shards' five-key tuples
    then reduce with -global index (``parallel.mesh.first_best``). On CUDA
    shards the
    per-shard searches are kernel B9 and the reduction kernel K3
    (``kernels.sharded_dry_run``).

    Returns ``(node_idx () int32 global, victims, ok, n_pdb)``, the last
    three as ``parallel.mesh.ShardedTensor``s of the shards' rows."""
    if shard_args[0][3].device.type != "cpu":
        from ..kernels import sharded_dry_run

        return sharded_dry_run(shard_args, offsets)
    return dry_run_preemption_sharded_plain(shard_args, offsets)


def dry_run_preemption_sharded_plain(shard_args, offsets):
    """The plain version of ``dry_run_preemption_sharded`` (on any
    device): each shard's ``select_victims_node`` and ``pick_node``, then
    ``first_best`` over the shards' tuples."""
    from ..parallel.mesh import ShardedTensor, first_best

    keys, outs = [], []
    for args, off in zip(shard_args, offsets):
        (pod_req, pod_prio, wants_conf, potential, alloc, requested, pod_count,
         allowed, port_counts, v_valid, v_prio, v_start, v_req, v_ports, v_pdb,
         pdb_allowed) = args
        ok, victims, n_pdb, max_p, sum_p, n_v, early = select_victims_node(
            pod_req, pod_prio, wants_conf, alloc, requested, pod_count, allowed,
            v_valid, v_prio, v_start, v_req, v_ports, v_pdb, port_counts,
            pdb_allowed,
        )
        ok = ok & potential
        j = int(pick_node(ok, n_pdb, max_p, sum_p, n_v, early))
        keys.append(((), -1) if j < 0 else (pick_keys(n_pdb, max_p, sum_p, n_v, early, j),
                                            off + j))
        outs.append((victims, ok, n_pdb))
    node = first_best(keys)
    dev = shard_args[0][3].device
    return (torch.tensor(node, dtype=torch.int32, device=dev),
            ShardedTensor([o[0] for o in outs]), ShardedTensor([o[1] for o in outs]),
            ShardedTensor([o[2] for o in outs]))


# --------------------------------------------------------------------------
# gang mode (topology-aware): evict ONE whole gang, not per-pod victims
# --------------------------------------------------------------------------


def dry_run_gang_preemption_plain(
    b, params, candidate_masks, freed_req, freed_count, engine="greedy",
):
    """Gang mode of the dry run (B13), the plain version: each candidate is
    "evict one low-priority gang and offer its CONTIGUOUS SLICE as the node
    set". ``candidate_masks`` is (C, N) bool — the full slice the victim
    gang occupies; ``freed_req`` (C, N, R) int64 / ``freed_count`` (C, N)
    int32 are the resources and pod counts the eviction returns. The
    preemptor gang's whole assignment engine runs under each hypothesis,
    with ``requested``, ``nonzero_requested`` and ``pod_count`` less the
    freed rows, clamped at 0, and ``node_valid & mask``, so admission is
    judged by the real filters and scores. As in the reference
    (kubetpu/ops/preemption.py:247), ``nonzero_requested`` is reduced by
    the freed *requests*, not by their nonzero amounts, and spread counts
    and affinity sums are not reduced.

    Returns ``(counts (C,) int32, alignment (C,) int32)`` — pods the
    preemptor would schedule under each eviction, and the slice-alignment
    of that proposal (``ops.topology.alignment_score``)."""
    from ..assign.batched import batched_assign_plain
    from ..assign.greedy import greedy_assign_plain
    from ..assign.placement import run_hypotheses

    assign = batched_assign_plain if engine == "batched" else greedy_assign_plain
    _, counts, alignment = run_hypotheses(
        b, params, candidate_masks, assign, freed_req, freed_count)
    return counts, alignment


def dry_run_gang_preemption(
    b, params, candidate_masks, freed_req, freed_count, engine="greedy",
):
    """The gang dry run where the batch lives: on the CPU the plain version;
    on a CUDA device the ``hypothesis_scan`` kernel (greedy engine,
    ``kernels.gang_dry_run_scan``), or ``kernels.batched_hypotheses``
    (batched engine: ``hypothesis_rows``, then ``filter_score`` +
    ``batched_round`` once per hypothesis, then ``slice_epilogue``). Same
    results as ``dry_run_gang_preemption_plain``."""
    if b.device.type == "cpu":
        return dry_run_gang_preemption_plain(
            b, params, candidate_masks, freed_req, freed_count, engine)
    from .. import kernels

    if engine == "batched":
        _, counts, alignment = kernels.batched_hypotheses(
            b, params, candidate_masks, freed_req, freed_count)
        return counts, alignment
    return kernels.gang_dry_run_scan(b, params, candidate_masks, freed_req, freed_count)
