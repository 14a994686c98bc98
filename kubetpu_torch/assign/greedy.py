"""Greedy assignment: pods one at a time against the running node state.

Port of ``kubetpu/assign/greedy.py``. The reference runs the greedy scan as
one ``lax.scan`` that XLA fuses into a single device program. Eager
PyTorch would split each step into dozens of launches, so on a CUDA batch
``greedy_assign_device`` launches the hand-written ``greedy_scan`` kernel
(``kernels/csrc/greedy_scan.cu``): one persistent block that loops over the
pods on the device. ``greedy_assign_plain`` is the plain PyTorch version,
a Python loop over pods that calls ``feasible_and_scores`` for one pod
against the running state; it is what a CPU batch runs and what the
kernel is held to. A sharded batch runs the scan over its tiles
(``greedy_assign_tiled_plain``, kernel K7): a pods x nodes grid, or a node
mesh, which is one pod row.

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


def greedy_assign_tiled_plain(tb, params: rt.ScoreParams, rows_out: list | None = None):
    """The plain greedy loop over a sharded batch
    (``parallel.mesh.ShardedBatch``: a pods x nodes grid, or a node mesh,
    which is one pod row). Step p reads pod p from its pod row ``p // (P /
    PG)``: that row's tiles run the step's Filter + Score on their node
    columns in lockstep (``mesh.run_sharded``, which combines the
    normalize maxima, spread sums, bitmaps and counts), and the step's
    node is the first best over the columns by (score, -global index)
    (``mesh.first_best``). Every pod row's copy of the owner column's rows
    takes the pick (resources, ports, spread counts), every tile's
    replicated affinity sums and live nominations too, so the rows' copies
    stay equal.

    Returns ``(assignments (P,) int32 global node index or -1, final
    state)``: the seven slots, the node-axis ones as
    ``mesh.ShardedTensor``s of pod row 0's tiles, the affinity sums and
    nominations as tile 0's copies; ``rows_out`` as
    ``batched.batched_assign_tiled_plain``'s."""
    from ..parallel.mesh import first_best, run_sharded
    from .batched import _row_slots

    tiles, offsets = tb.shards, tb.offsets
    PG, NG = tb.pod_rows, tb.columns
    pb = int(tiles[0].requests.shape[0])
    req = [s.requested.clone() for s in tiles]
    nz = [s.nonzero_requested.clone() for s in tiles]
    pc = [s.pod_count.clone() for s in tiles]
    ports = [s.node_ports.clone() for s in tiles]
    sp_counts = [None if s.spread is None else s.spread.node_count.clone() for s in tiles]
    pa_sums = [None if s.podaffinity is None else s.podaffinity.base_sums for s in tiles]
    nom = [
        None if s.nominated_pod_idx is None
        else torch.ones(s.nominated_pod_idx.shape[0], dtype=torch.bool, device=s.device)
        for s in tiles
    ]
    chosen_all = []
    for p in range(PG * pb):
        i, q = divmod(p, pb)
        row = range(i * NG, (i + 1) * NG)
        views = [_pod_view(tiles[t], q) for t in row]
        outs = run_sharded([
            rt.feasible_and_scores_steps(
                v, params, requested=req[t], nonzero_requested=nz[t], pod_count=pc[t],
                node_ports=ports[t], spread_counts=sp_counts[t], pa_sums=pa_sums[t],
                nominated_active=nom[t])
            for v, t in zip(views, row)
        ], tb.mesh.row(i))
        keys = []
        for j, (mask, score) in enumerate(outs):
            m, sc = mask[0], score[0]
            if bool(torch.any(m)):
                k = int(torch.argmax(torch.where(m, sc, -1)))
                keys.append(((int(sc[k]),), offsets[j] + k))
            else:
                keys.append(((), -1))
        chosen = first_best(keys)
        chosen_all.append(chosen)
        if chosen < 0:
            continue
        o = max(j for j in range(NG) if offsets[j] <= chosen)
        k = chosen - offsets[o]
        v = views[o]
        dcol = None if pa_sums[0] is None else tiles[i * NG + o].podaffinity.node_domain[:, k]
        for t, s in enumerate(tiles):
            if t % NG == o:
                # every pod row's copy of the owner column takes the pick
                req[t][k] += v.requests[0].to(s.device)
                nz[t][k] += v.nonzero_requests[0].to(s.device)
                pc[t][k] += 1
                ports[t][k] |= v.pod_ports[0].to(s.device)
                if s.spread is not None:
                    match = v.spread.pod_match_sig[0].to(s.device)
                    sp_counts[t][:, k] += (match & s.spread.eligible[:, k]).to(torch.int32)
            if dcol is not None:
                d = dcol.to(s.device)
                inc = torch.where(d >= 0, v.podaffinity.update[0].to(s.device), 0)
                rows = torch.arange(pa_sums[t].shape[0], device=s.device)
                pa_sums[t] = pa_sums[t].index_put(
                    (rows, torch.clamp(d, min=0).long()), inc, accumulate=True)
            if nom[t] is not None:
                nom[t] = nom[t] & (s.nominated_pod_idx != p)
    assignments = torch.tensor(chosen_all, dtype=torch.int32, device=tiles[0].device)
    if rows_out is not None:
        rows_out.extend(_row_slots(req, nz, pc, ports, sp_counts, i, NG) for i in range(PG))
    return assignments, _row_slots(req, nz, pc, ports, sp_counts, 0, NG) + (
        pa_sums[0], nom[0])


def greedy_assign_device(b, params: rt.ScoreParams):
    """Run the greedy assignment. A CUDA batch launches the ``greedy_scan``
    kernel; a CPU batch runs ``greedy_assign_plain``. A sharded batch
    (``parallel.mesh.ShardedBatch``, a node mesh or a pods x nodes grid)
    runs the tiled scan kernel on CUDA tiles and
    ``greedy_assign_tiled_plain`` on CPU ones. Same return shape as
    ``greedy_assign_plain``."""
    from ..parallel.mesh import ShardedBatch

    if isinstance(b, ShardedBatch):
        if b.device.type == "cpu":
            return greedy_assign_tiled_plain(b, params)
        from ..kernels import tiled_greedy_scan

        return tiled_greedy_scan(b, params)
    if b.device.type == "cpu":
        return greedy_assign_plain(b, params)
    from ..kernels import greedy_scan

    return greedy_scan(b, params)
