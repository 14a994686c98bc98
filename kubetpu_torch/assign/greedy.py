"""Greedy assignment: pods one at a time against the running node state.

Port of ``kubetpu/assign/greedy.py``. The reference runs the greedy scan as
one ``lax.scan`` that XLA fuses into a single device program. Eager
PyTorch would split each step into dozens of launches, so on a CUDA batch
``greedy_assign_device`` launches the hand-written ``greedy_scan`` kernel
(``kernels/csrc/greedy_scan.cu``): one persistent block that loops over the
pods on the device. ``greedy_assign_plain`` is the plain PyTorch version,
a Python loop over pods that calls ``feasible_and_scores`` for one pod
against the running state; it is what a CPU batch runs and what the
kernel is held to.

The reference schedules pods strictly one at a time: ``scheduleOne`` pops a
pod, filters + scores all nodes against the *current* cache (which includes
all previously assumed pods), picks the best node (``selectHost``,
schedule_one.go:605), and assumes the pod onto it (cache.AssumePod,
backend/cache/cache.go:397) before the next pod starts.

Tie-breaking: the reference picks uniformly at random among max-score nodes
(schedule_one.go:1037 reservoir sample). kubetpu and this port take the
FIRST max-score node in snapshot order — deterministic and replayable.
"""

from __future__ import annotations

import dataclasses

import torch

from ..framework import runtime as rt


def _pod_view(b: rt.DeviceBatch, i: int) -> rt.DeviceBatch:
    """P=1 view of pod ``i`` over the same nodes."""

    def row(a):
        return None if a is None else a[i:i + 1]

    return dataclasses.replace(
        b,
        requests=b.requests[i:i + 1],
        nonzero_requests=b.nonzero_requests[i:i + 1],
        pod_valid=b.pod_valid[i:i + 1],
        static_sig=row(b.static_sig),
        score_sig=row(b.score_sig),
        image_sig=row(b.image_sig),
        image_count=row(b.image_count),
        extender_mask=row(b.extender_mask),
        extender_score=row(b.extender_score),
        dra_score_sig=row(b.dra_score_sig),
        pod_ports=b.pod_ports[i:i + 1],
        nominated_gate=row(b.nominated_gate),
        pod_priority=row(b.pod_priority),
        spread=_spread_view(b.spread, i),
        podaffinity=_pa_view(b.podaffinity, i),
    )


def _pa_view(pa, i: int):
    if pa is None:
        return None
    return dataclasses.replace(
        pa,
        update=pa.update[i:i + 1],
        fa_rows=pa.fa_rows[i:i + 1],
        fa_self=pa.fa_self[i:i + 1],
        ra_rows=pa.ra_rows[i:i + 1],
        ea_rows=pa.ea_rows[i:i + 1],
        score_rows=pa.score_rows[i:i + 1],
        score_vals=pa.score_vals[i:i + 1],
    )


def _spread_view(sp, i: int):
    if sp is None:
        return None
    return dataclasses.replace(
        sp,
        sig_idx=sp.sig_idx[i:i + 1],
        action=sp.action[i:i + 1],
        max_skew=sp.max_skew[i:i + 1],
        min_domains=sp.min_domains[i:i + 1],
        self_match=sp.self_match[i:i + 1],
        pod_match_sig=sp.pod_match_sig[i:i + 1],
        ignored=sp.ignored[i:i + 1],
    )


def greedy_assign_plain(b: rt.DeviceBatch, params: rt.ScoreParams):
    """The plain PyTorch greedy loop. Returns ``(assignments (P,) int32 node
    index or -1, final_state)``; ``final_state`` has the reference's seven
    slots ``(requested, nonzero_requested, pod_count, node_ports,
    spread_counts, pa_sums, nominated_active)``; ``spread_counts`` is None
    without a ``spread`` leaf, ``pa_sums`` without a ``podaffinity`` leaf,
    ``nominated_active`` (G,) bool without the nomination leaves. Runs on
    whatever device ``b`` lives on, with no host sync inside the loop."""
    n = b.alloc.shape[0]
    node_iota = torch.arange(n, dtype=torch.int32, device=b.device)
    requested = b.requested
    nonzero = b.nonzero_requested
    pod_count = b.pod_count
    node_ports = b.node_ports
    pa = b.podaffinity
    pa_sums = None if pa is None else pa.base_sums
    sp = b.spread
    spread_counts = None if sp is None else sp.node_count
    nom_active = (
        None if b.nominated_pod_idx is None
        else torch.ones(b.nominated_pod_idx.shape[0], dtype=torch.bool,
                        device=b.device)
    )
    chosen_all = []
    for i in range(b.requests.shape[0]):
        view = _pod_view(b, i)
        mask, score = rt.feasible_and_scores(
            view, params,
            requested=requested, nonzero_requested=nonzero,
            pod_count=pod_count, node_ports=node_ports,
            spread_counts=spread_counts, pa_sums=pa_sums,
            nominated_active=nom_active,
        )
        mask, score = mask[0], score[0]
        feasible = torch.any(mask)
        best = torch.argmax(torch.where(mask, score, -1)).to(torch.int32)
        chosen = torch.where(feasible, best, -1).to(torch.int32)
        onehot = (node_iota == chosen) & feasible           # (N,) bool
        oh64 = onehot.to(torch.int64)[:, None]
        requested = requested + oh64 * view.requests[0][None, :]
        nonzero = nonzero + oh64 * view.nonzero_requests[0][None, :]
        pod_count = pod_count + onehot.to(pod_count.dtype)
        node_ports = node_ports | (onehot[:, None] & view.pod_ports[0][None, :])
        if spread_counts is not None:
            # updateWithPod (podtopologyspread/filtering.go:181): +1 in every
            # signature whose selector+namespace the assigned pod matches,
            # on the chosen node, when that node is eligible for it
            upd = sp.pod_match_sig[i][:, None] & sp.eligible & onehot[None, :]
            spread_counts = spread_counts + upd.to(spread_counts.dtype)
        if pa_sums is not None:
            # interpodaffinity updateWithPod (filtering.go:75): add the
            # assigned pod's increments into each row at the chosen node's
            # domain (no-op when the node lacks the row's topology key)
            dcol = torch.where(
                chosen >= 0, pa.node_domain[:, torch.clamp(chosen, min=0).long()],
                -1,
            )                                                   # (R,)
            inc = torch.where(dcol >= 0, pa.update[i], 0)
            rows = torch.arange(pa_sums.shape[0], device=b.device)
            pa_sums = pa_sums.index_put(
                (rows, torch.clamp(dcol, min=0).long()), inc, accumulate=True
            )
        if nom_active is not None:
            # assume deletes the nomination (schedule_one.go:307): once the
            # loop assigns a nomination's own pod, stop charging it
            nom_active = nom_active & ~((b.nominated_pod_idx == i) & feasible)
        chosen_all.append(chosen)
    assignments = (
        torch.stack(chosen_all) if chosen_all
        else torch.empty(0, dtype=torch.int32, device=b.device)
    )
    return assignments, (
        requested, nonzero, pod_count, node_ports, spread_counts, pa_sums,
        nom_active,
    )


def greedy_assign_sharded_plain(sb, params: rt.ScoreParams):
    """The plain greedy loop over a node-sharded batch
    (``parallel.mesh.ShardedBatch``). Each step runs every shard's
    Filter + Score on its own rows in lockstep (``mesh.run_sharded``
    combines the normalize maxima, spread sums, bitmaps and counts), picks
    each shard's first maximum, then the step's node by (score, -global
    index) over the shards (``mesh.first_best``). The owner shard applies
    the resource, port and spread-count updates to its rows and publishes
    the chosen node's affinity domains, which every shard adds into its
    replicated (RA, D) sums; the live nominations are replicated.

    Returns ``(assignments (P,) int32 global node index or -1, final
    state)``: the seven slots, the node-axis ones as
    ``mesh.ShardedTensor``s, the affinity sums and nominations as shard 0's
    copies."""
    from ..parallel.mesh import ShardedTensor, first_best, run_sharded

    shards, offsets, mesh = sb.shards, sb.offsets, sb.mesh
    G = len(shards)
    req = [s.requested.clone() for s in shards]
    nz = [s.nonzero_requested.clone() for s in shards]
    pc = [s.pod_count.clone() for s in shards]
    ports = [s.node_ports.clone() for s in shards]
    sp_counts = [None if s.spread is None else s.spread.node_count.clone() for s in shards]
    pa_sums = [None if s.podaffinity is None else s.podaffinity.base_sums for s in shards]
    nom = [
        None if s.nominated_pod_idx is None
        else torch.ones(s.nominated_pod_idx.shape[0], dtype=torch.bool, device=s.device)
        for s in shards
    ]
    chosen_all = []
    for i in range(shards[0].requests.shape[0]):
        views = [_pod_view(s, i) for s in shards]
        outs = run_sharded([
            rt.feasible_and_scores_steps(
                views[g], params, requested=req[g], nonzero_requested=nz[g],
                pod_count=pc[g], node_ports=ports[g], spread_counts=sp_counts[g],
                pa_sums=pa_sums[g], nominated_active=nom[g])
            for g in range(G)
        ], mesh)
        keys = []
        for g, (mask, score) in enumerate(outs):
            m, sc = mask[0], score[0]
            if bool(torch.any(m)):
                j = int(torch.argmax(torch.where(m, sc, -1)))
                keys.append(((int(sc[j]),), offsets[g] + j))
            else:
                keys.append(((), -1))
        chosen = first_best(keys)
        chosen_all.append(chosen)
        if chosen < 0:
            continue
        o = max(g for g in range(G) if offsets[g] <= chosen)
        j = chosen - offsets[o]
        v = views[o]
        req[o][j] += v.requests[0]
        nz[o][j] += v.nonzero_requests[0]
        pc[o][j] += 1
        ports[o][j] |= v.pod_ports[0]
        sp = shards[o].spread
        if sp is not None:
            sp_counts[o][:, j] += (sp.pod_match_sig[i] & sp.eligible[:, j]).to(torch.int32)
        if pa_sums[0] is not None:
            # the owner publishes the chosen node's domain in every row
            dcol = shards[o].podaffinity.node_domain[:, j]
            for g in range(G):
                pa = shards[g].podaffinity
                d = dcol.to(pa.base_sums.device)
                inc = torch.where(d >= 0, pa.update[i], 0)
                rows = torch.arange(pa_sums[g].shape[0], device=d.device)
                pa_sums[g] = pa_sums[g].index_put(
                    (rows, torch.clamp(d, min=0).long()), inc, accumulate=True)
        if nom[0] is not None:
            for g in range(G):
                nom[g] = nom[g] & (shards[g].nominated_pod_idx != i)
    assignments = torch.tensor(chosen_all, dtype=torch.int32, device=shards[0].device)
    return assignments, (
        ShardedTensor(req), ShardedTensor(nz), ShardedTensor(pc), ShardedTensor(ports),
        None if sp_counts[0] is None else ShardedTensor(sp_counts, axis=1),
        pa_sums[0], nom[0],
    )


def greedy_assign_device(b, params: rt.ScoreParams):
    """Run the greedy assignment. A CUDA batch launches the ``greedy_scan``
    kernel; a CPU batch runs ``greedy_assign_plain``. A node-sharded batch
    (``parallel.mesh.ShardedBatch``) runs the sharded scan kernel on CUDA
    shards and ``greedy_assign_sharded_plain`` on CPU ones. Same return
    shape as ``greedy_assign_plain``."""
    from ..parallel.mesh import ShardedBatch

    if isinstance(b, ShardedBatch):
        if b.device.type == "cpu":
            return greedy_assign_sharded_plain(b, params)
        from ..kernels import sharded_greedy_scan

        return sharded_greedy_scan(b, params)
    if b.device.type == "cpu":
        return greedy_assign_plain(b, params)
    from ..kernels import greedy_scan

    return greedy_scan(b, params)
