"""Scheduling flight recorder + per-pod lifecycle attribution.

Port of ``kubetpu/sched/flightrecorder.py``: ``PodFlight`` and the host
``FlightRecorder`` are the reference's code (decision records, the
requeue / preemption / bind outcomes, ``lookup`` / ``records_json``, the
staged latency vector), and its two device programs become functions that
dispatch on the batch's device:

- ``_explain_kernel`` (B10, kubetpu/sched/flightrecorder.py:92): the plain
  PyTorch ``explain_summary_plain`` on the CPU; on CUDA
  ``kernels.explain_summary``, which works on the batch's pod classes:
  ``filter_score``'s passes on each class's representative into (C, N)
  rows, then one pass over (class, node tile) blocks reducing the
  feasible count, the five components' rejection counts and the top 3
  (score, node) pairs, merged per class and written to every pod with its
  winner's score (``explain_summary_tiled_plain`` is the plain mirror of
  that decomposition);
- ``_explain_masks_kernel`` (:146): the five per-plugin masks (the first
  five of ``runtime.filter_components``) of the cycle's unschedulable pods
  only, packed a bit a component into one (U, N) byte buffer:
  ``filter_component_masks_rows_plain`` on the CPU,
  ``kernels.filter_component_masks`` on CUDA (once a pod class). It runs
  only for cycles with an unschedulable pod; the buffer comes to the host
  in one copy and ``_pod_breakdown`` reads its bits.

Each cycle's explain is launched on the current stream inside
``note_cycle``, before the next cycle's resident-block scatter, so it reads
the cycle-start state. Its results are copied into pinned host memory with
``non_blocking`` copies and a CUDA event is recorded after them; the next
``note_cycle`` (or a read) waits on that event, never on a bare ``.cpu()``.

Deviations from the reference, by design:

- **Errors propagate.** The reference catches every explain error
  (kubetpu/sched/scheduler.py:1489-1490, flightrecorder.py:298-302) and
  turns the breakdown off after three. On CUDA that would hide a kernel
  that fails, so here an error from a kernel, a launch or a fetch
  propagates to the cycle; ``breakdown_failures`` stays 0.
- **No histograms.** ``note_bind`` computes, records and returns the staged
  latency vector, but nothing observes it into the
  ``scheduler_e2e_scheduling_duration_seconds{stage}`` histograms: the
  metrics registry is ROADMAP Queue A item 15. The gang lane's
  ``note_gang`` is kept for item 10.
"""

from __future__ import annotations

import collections
import itertools
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .. import names as N

#: how the fused device filter decomposes for attribution: the component
#: order of ``runtime.filter_components``. The static mask fuses the
#: spec-static plugins (NodeSelector/NodeAffinity/TaintToleration/NodeName/
#: NodeUnschedulable) — they cannot be split post-encode, so they report
#: as one group.
STATIC_FILTER_GROUP = (
    f"{N.NODE_AFFINITY}+{N.TAINT_TOLERATION}+{N.NODE_NAME}"
    f"+{N.NODE_UNSCHEDULABLE}"
)
_COMPONENT_NAMES = (
    STATIC_FILTER_GROUP,
    N.NODE_RESOURCES_FIT,
    N.NODE_PORTS,
    N.POD_TOPOLOGY_SPREAD,
    N.INTER_POD_AFFINITY,
)


#: score sentinel for infeasible nodes in the top-k (far below any real
#: score so a masked node can never surface)
_NEG = -(2 ** 62)


def filter_component_masks_plain(device_batch, params):
    """The plain version of ``_explain_masks_kernel`` and of the
    ``filter_component_masks`` kernel: ``runtime.filter_components``'s five
    per-plugin masks ``(static, fit, ports_ok, spread_ok, pa_ok)``, None
    where a plugin is off or has no work."""
    from ..framework import runtime as rt

    return rt.filter_components(device_batch, params)[:5]


def filter_component_masks_rows_plain(device_batch, params, rows=None):
    """The plain version of the ``filter_component_masks`` kernel:
    ``filter_component_masks_plain``'s masks of pods ``rows`` (host ints;
    None: every pod), packed: ``(bits (U, N) uint8, present)``, bit c of
    ``bits[u, n]`` component c's verdict for pod ``rows[u]`` at node n (0
    where component c is absent), ``present`` which of the five are."""
    b = device_batch
    comps = filter_component_masks_plain(b, params)
    P, N = b.requests.shape[0], b.alloc.shape[0]
    idx = (torch.arange(P, device=b.device) if rows is None
           else torch.as_tensor(np.asarray(rows, dtype=np.int64).reshape(-1), device=b.device))
    bits = torch.zeros((idx.shape[0], N), dtype=torch.uint8, device=b.device)
    for c, m in enumerate(comps):
        if m is not None:
            bits |= m[idx].to(torch.uint8) << c
    return bits, tuple(m is not None for m in comps)


def explain_summary_plain(device_batch, params, assignments):
    """The plain version of ``_explain_kernel`` and of the
    ``explain_summary`` kernel, the reference's arithmetic on tensors:
    against the batch's own (cycle-start) state, the feasible count over
    valid nodes, each component's rejection count over valid nodes, the top
    3 (score, node) pairs by three masked first-max passes (``torch.argmax``
    takes the first maximum; each pick is then masked to ``_NEG``), and the
    score at each pod's assignment (node 0 for -1). Returns ``(feasible (P,)
    int32, reject (five (P,) int32 or None), top_vals (P, k) int64, top_idx
    (P, k) int32, win (P,) int64)``, k = min(3, N)."""
    from ..framework import runtime as rt

    b = device_batch
    comps = rt.filter_components(b, params)[:5]
    mask, total = rt.feasible_and_scores(b, params)
    valid = b.node_valid[None, :]
    mask = mask & valid
    feasible = mask.sum(dim=1).to(torch.int32)
    reject = tuple(
        None if c is None else ((~c) & valid).sum(dim=1).to(torch.int32)
        for c in comps
    )
    masked = torch.where(mask, total, _NEG)
    k = min(3, masked.shape[1])
    rows = torch.arange(masked.shape[0], device=masked.device)
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(masked, dim=1)
        vals.append(masked[rows, i])
        idxs.append(i.to(torch.int32))
        masked = masked.clone()
        masked[rows, i] = _NEG
    top_vals = torch.stack(vals, dim=1)
    top_idx = torch.stack(idxs, dim=1)
    idx = torch.as_tensor(assignments, device=total.device).long()
    win = total[rows, torch.clamp(idx, min=0)]
    return feasible, reject, top_vals, top_idx, win


def _top3_merge(vals, idxs):
    """The top 3 of each row of (score, node) candidates ``vals`` / ``idxs``
    (R, M) int64, node -1 an empty slot: higher score first, then the lower
    node (the masked first-max passes' order, total on distinct nodes).
    Returns (R, 3) values and nodes, node -1 (and ``_NEG``) where a row has
    fewer than three candidates."""
    alive = idxs >= 0
    big = torch.iinfo(torch.int64).max
    out_v, out_i = [], []
    for _ in range(3):
        best = torch.where(alive, vals, _NEG - 1).max(dim=1).values
        node = torch.where(alive & (vals == best[:, None]), idxs, big).min(dim=1).values
        found = node != big
        out_v.append(torch.where(found, best, _NEG))
        out_i.append(torch.where(found, node, -1))
        alive = alive & ~(found[:, None] & (idxs == node[:, None]))
    return torch.stack(out_v, dim=1), torch.stack(out_i, dim=1)


def explain_summary_tiled_plain(device_batch, params, assignments, tile_width: int):
    """The plain mirror of the ``explain_summary`` kernel's decomposition
    (``kernels/csrc/explain_summary.cu``), its tile width a parameter: the
    component verdicts, mask and total of each pod class's representative
    only (``runtime.pod_classes``; a class a pod without them), as (C, N)
    rows; each (class, tile of ``tile_width`` nodes)'s partial: its valid
    nodes' feasible and rejection counts and the top 3 of its feasible
    nodes (higher score, then lower node); the partials merged in tile
    order into each class's summary, an empty slot filled with (``_NEG``,
    node 0); and each pod its class's summary, its ``win`` the class's
    total at the pod's assignment (node 0 for -1). Equal to
    ``explain_summary_plain``. The class rows are the representatives'
    rows of the batch's verdicts and totals: a pod's rows depend on its own
    leaves only."""
    from ..framework import runtime as rt

    b = device_batch
    P, N = b.requests.shape[0], b.alloc.shape[0]
    classes = rt.pod_classes(b)
    if classes is not None and classes.shared:
        reps = torch.as_tensor(classes.host_reps(), dtype=torch.long, device=b.device)
        class_of = torch.as_tensor(classes.class_of, dtype=torch.long, device=b.device)
    else:
        reps = class_of = torch.arange(P, device=b.device)
    C = len(reps)
    comps = [None if c is None else c[reps] for c in rt.filter_components(b, params)[:5]]
    mask, total = rt.feasible_and_scores(b, params)
    mask, total = mask[reps], total[reps]
    valid = b.node_valid[None, :]
    T = max(-(-N // tile_width), 1)
    pad = T * tile_width - N

    def tiles(x, fill):
        return torch.nn.functional.pad(x, (0, pad), value=fill).view(C, T, tile_width)

    feas = mask & valid
    counts = [feas] + [None if c is None else (~c) & valid for c in comps]
    part_counts = [None if x is None else tiles(x.long(), 0).sum(dim=2) for x in counts]
    cand = feas & (total > _NEG)
    nodes = torch.arange(N, device=b.device).expand(C, N)
    part_v, part_i = _top3_merge(
        tiles(torch.where(cand, total, _NEG), _NEG).reshape(C * T, tile_width),
        tiles(torch.where(cand, nodes, -1), -1).reshape(C * T, tile_width))
    part_v, part_i = part_v.view(C, T, 3), part_i.view(C, T, 3)
    run_v = torch.full((C, 3), _NEG, dtype=torch.int64, device=b.device)
    run_i = torch.full((C, 3), -1, dtype=torch.int64, device=b.device)
    for t in range(T):
        run_v, run_i = _top3_merge(torch.cat([run_v, part_v[:, t]], dim=1),
                                   torch.cat([run_i, part_i[:, t]], dim=1))
    sums = [None if x is None else x.sum(dim=1).to(torch.int32) for x in part_counts]
    k = min(3, N)
    top_vals = torch.where(run_i < 0, _NEG, run_v)[class_of, :k]
    top_idx = torch.clamp(run_i, min=0).to(torch.int32)[class_of, :k]
    idx = torch.as_tensor(assignments, device=b.device).long()
    win = total[class_of, torch.clamp(idx, min=0)]
    reject = tuple(None if r is None else r[class_of] for r in sums[1:])
    return sums[0][class_of], reject, top_vals, top_idx, win


def _explain_kernel(device_batch, params, assignments):
    """One batched Filter+Score evaluation against cycle-start state,
    REDUCED ON DEVICE to the per-pod summaries the records need (see
    ``explain_summary_plain``), so the host fetch is a few KB per cycle.
    The plain version on a CPU batch, the ``filter_score`` and
    ``explain_summary`` kernels on a CUDA one."""
    idx = torch.as_tensor(assignments, dtype=torch.int32,
                          device=device_batch.device)
    if device_batch.device.type == "cpu":
        return explain_summary_plain(device_batch, params, idx)
    from ..kernels import explain_summary

    return explain_summary(device_batch, params, idx)


def _explain_masks_kernel(device_batch, params, rows):
    """The per-component masks of pods ``rows``, packed (``(bits (U, N)
    uint8, present)``, see ``filter_component_masks_rows_plain``) —
    computed ONLY for cycles with an unschedulable pod. The plain version
    on a CPU batch, the ``filter_component_masks`` kernel on a CUDA one."""
    if device_batch.device.type == "cpu":
        return filter_component_masks_rows_plain(device_batch, params, rows)
    from ..kernels import filter_component_masks

    return filter_component_masks(device_batch, params, rows)


class _Fetch:
    """Device tensors on their way to the host: on CUDA, ``non_blocking``
    copies into pinned host tensors followed by a recorded (timing) event;
    on the CPU, the tensors themselves. ``get()`` waits for the event and
    returns the numpy arrays (None leaves stay None)."""

    def __init__(self, tensors) -> None:
        self.event = None
        self.start = None           # the explain's start event, if timed
        live = [x for x in tensors if x is not None]
        if live and live[0].device.type == "cuda":
            self.host = [
                None if x is None
                else torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                for x in tensors
            ]
            for h, x in zip(self.host, tensors):
                if x is not None:
                    h.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.host = list(tensors)

    def get(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return [None if h is None else h.numpy() for h in self.host]


@dataclass
class PodFlight:
    """Lifecycle stamps for one pending pod (perf_counter seconds)."""

    key: str
    trace_id: str = ""
    ingest_pc: float = 0.0      # apiserver REST-create stamp (0 = direct)
    deliver_pc: float = 0.0     # informer delivery into the scheduler
    informer_s: float = 0.0     # delivery-handler wall


class FlightRecorder:
    """See module docstring. Appends happen on the scheduler loop thread;
    HTTP reads snapshot the deque with the tracer's retry idiom."""

    def __init__(
        self,
        max_records: int = 4096,
        max_e2e_samples: int = 65536,
        top_k: int = 3,
        replica: str = "",
    ) -> None:
        self.top_k = top_k
        # federation stamp: every decision record carries the scheduler
        # replica that made it ("" in single-scheduler mode) so a
        # multi-replica bind history is attributable per record
        self.replica = replica
        self._records: collections.deque[dict] = collections.deque(
            maxlen=max_records
        )
        # key -> latest record; bounded alongside the ring (an LRU twice
        # the ring keeps lookups alive slightly past eviction, never grows)
        self._by_key: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict()
        )
        self._by_key_max = 2 * max_records
        # key -> PodFlight for pods still pending (dropped at ack/delete)
        self._flights: "collections.OrderedDict[str, PodFlight]" = (
            collections.OrderedDict()
        )
        self._flights_max = 4 * max_records
        # (ack perf_counter, e2e seconds) — the soak stage's raw reservoir
        self.e2e_samples: collections.deque = collections.deque(
            maxlen=max_e2e_samples
        )
        # explain errors propagate here (module docstring): the count the
        # reference keeps for its soft-off stays 0
        self.breakdown_failures = 0
        # explains launched and resolved, and their seconds: "explain" the
        # device time from the launch to the copies' end (CUDA events; the
        # host wall of the plain version on the CPU), "fetch" the host's
        # wait for the copies at resolve time
        self.explains = 0
        self.spans = {"explain": 0.0, "fetch": 0.0}
        self._seq = itertools.count()
        # the previous cycle's launched-but-unfetched explain: (summary
        # fetch, masks fetch or None, {record index: fetched mask row},
        # records, node names, n_real, assignment per record). Resolved at
        # the NEXT note_cycle or on first read — the kernels and copies
        # overlap host work instead of stalling the loop (outputs are fresh
        # buffers). A one-slot deque: append (loop thread) and popleft
        # (loop OR a reader thread) are atomic, so concurrent resolvers can
        # never double-fetch or drop a newly-launched cycle
        self._pending: collections.deque = collections.deque()

    # ------------------------------------------------------------ lifecycle
    def note_delivery(self, pod, deliver_pc: float, informer_s: float) -> None:
        """Informer delivered a pending pod: open (or refresh) its flight.
        The FIRST delivery wins — a re-delivered update must not reset the
        e2e base."""
        key = f"{pod.namespace}/{pod.name}"
        fl = self._flights.get(key)
        if fl is None:
            fl = PodFlight(
                key=key,
                trace_id=getattr(pod, "trace_id", "") or "",
                ingest_pc=float(getattr(pod, "ingest_ts", 0.0) or 0.0),
                deliver_pc=deliver_pc,
                informer_s=informer_s,
            )
            self._flights[key] = fl
            while len(self._flights) > self._flights_max:
                self._flights.popitem(last=False)
        else:
            fl.informer_s += informer_s

    def drop(self, key: str) -> None:
        """Pod deleted while pending — forget its flight."""
        self._flights.pop(key, None)

    # ------------------------------------------------------------ decisions
    def note_cycle(
        self,
        batch,
        device_batch,
        params,
        batch_infos,
        idx,
        cycle_id: int,
        profile: str,
        encode_s: float,
        kernel_s: float,
        breakdown: bool = True,
        engine: str = "",
        objective_value: "float | None" = None,
        solver_iters: "int | None" = None,
        skipped_reason: str | None = None,
        assignments=None,
    ) -> None:
        """One decision record per pod of the finished cycle. ``idx`` is
        the scan's assignment vector (node index or -1). ``breakdown``
        gates the extra explain kernel (off under a mesh — the sharded
        batch is not re-evaluated here). ``objective_value`` /
        ``solver_iters`` are the packing engine's solve diagnostics
        (assign.packing; None otherwise) — stamped on every record of the
        cycle so ``kubetpu explain`` can render the packing rationale, and
        the breakdown's ``top_nodes[0]`` (the cycle-start masked argmax —
        exactly what the greedy scan would have picked first) doubles as
        the greedy counterfactual beside it. ``skipped_reason`` names WHY
        ``breakdown=False`` was passed (e.g. ``"mesh"`` — the sharded
        batch is not re-evaluated here) so explain renders "breakdown
        skipped: mesh" instead of an empty block reading as
        "no rejections". ``assignments``: the engine's assignments as a
        tensor on the batch's device (``idx`` is uploaded when None)."""
        self._resolve_pending()
        summary = masks = present = None
        mask_rows: dict[int, int] = {}
        node_names = batch.node_names
        n_real = batch.num_nodes
        if breakdown:
            start = None
            if device_batch.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            summary_dev = _explain_kernel(
                device_batch, params,
                idx if assignments is None else assignments,
            )
            feasible, reject, top_vals, top_idx, win = summary_dev
            summary = _Fetch((feasible, *reject, top_vals, top_idx, win))
            unsched = [
                k for k in range(len(batch_infos))
                if not (0 <= int(idx[k]) < len(node_names))
            ]
            if unsched:
                # an unschedulable pod in the cycle: also compute the
                # per-component masks of those pods' rows so their records
                # can name example rejected nodes (the all-feasible steady
                # state never pays this), packed into one buffer, one copy
                bits, present = _explain_masks_kernel(device_batch, params, unsched)
                masks = _Fetch((bits,))
                mask_rows = {k: r for r, k in enumerate(unsched)}
            if start is None:
                self.spans["explain"] += time.perf_counter() - t0
            summary.start = start
        recs: list = []
        for k, info in enumerate(batch_infos):
            j = int(idx[k])
            rec: dict[str, Any] = {
                "pod": info.key,
                "uid": info.pod.uid,
                "cycle": cycle_id,
                "profile": profile,
                "replica": self.replica,
                "attempts": info.attempts,
                "status": (
                    "scheduled" if 0 <= j < len(node_names)
                    else "unschedulable"
                ),
                "node": node_names[j] if 0 <= j < len(node_names) else None,
                "priority": info.pod.priority,
                "encode_s": encode_s,
                "kernel_s": kernel_s,
                "queue_wait_s": getattr(info, "queue_wait_s", 0.0),
            }
            if engine:
                rec["engine"] = engine
            if objective_value is not None:
                rec["objective_value"] = objective_value
            if solver_iters is not None:
                rec["solver_iters"] = solver_iters
            if skipped_reason and not breakdown:
                rec["skipped_reason"] = skipped_reason
            fl = self._flights.get(info.key)
            if fl is not None and fl.trace_id:
                rec["trace_id"] = fl.trace_id
            self._insert(rec)
            recs.append(rec)
        if summary is not None:
            self._pending.append((
                summary, masks, present, mask_rows, recs, node_names, n_real,
                [int(idx[k]) for k in range(len(recs))],
            ))

    def _resolve_pending(self) -> None:
        """Fetch the previous cycle's launched explain results (tiny
        arrays; the kernels and copies overlapped host work since) and fold
        the breakdown into its records in place — they live in the ring."""
        try:
            p = self._pending.popleft()
        except IndexError:
            return
        summary, masks, present, mask_rows, recs, node_names, n_real, js = p
        t0 = time.perf_counter()
        host = self._fetch_summary(summary)
        comp_masks = None if masks is None else (masks.get()[0], present, mask_rows)
        self.spans["fetch"] += time.perf_counter() - t0
        if summary.start is not None:
            # the masks' copies were recorded after the summary's: wait for
            # both, then time from the launch to the later one
            end = summary.event if masks is None else masks.event
            self.spans["explain"] += summary.start.elapsed_time(end) / 1e3
        self.explains += 1
        for k, (rec, j) in enumerate(zip(recs, js)):
            rec.update(self._pod_breakdown(
                k, j, host, comp_masks, node_names, n_real
            ))

    @staticmethod
    def _fetch_summary(summary: _Fetch):
        """Materialize the summary reduction (a few KB): wait for its
        copies' event, then split the arrays back into the reference's
        ``(feasible, reject, top_vals, top_idx, win)``."""
        arrs = summary.get()
        return arrs[0], tuple(arrs[1:6]), arrs[6], arrs[7], arrs[8]

    def _pod_breakdown(
        self, k: int, j: int, summary, comp_masks, node_names, n_real: int
    ) -> dict:
        """Top-k score breakdown + per-plugin-group rejection counts for
        pod ``k``, against the cycle-start view (from the device-reduced
        summary; example rejected nodes only when the cycle's masks were
        fetched)."""
        feasible, reject, top_vals, top_idx, win = summary
        rejected: dict[str, int] = {}
        for name, r in zip(_COMPONENT_NAMES, reject):
            if r is not None and r[k]:
                rejected[name] = int(r[k])
        out: dict[str, Any] = {
            "view": "cycle-start",
            "feasible_nodes": int(feasible[k]),
            "total_nodes": int(n_real),
            "rejected_by": rejected,
        }
        if comp_masks is not None and not (0 <= j < len(node_names)):
            # only the unschedulable pods' rows were fetched, a bit a
            # component
            bits, present, rows = comp_masks
            row = bits[rows[k]][:n_real]
            examples: dict[str, list[str]] = {}
            for c, (name, on) in enumerate(zip(_COMPONENT_NAMES, present)):
                if not on or name not in rejected:
                    continue
                ex = np.flatnonzero(((row >> c) & 1) == 0)[:3]
                examples[name] = [node_names[int(i)] for i in ex]
            out["rejected_examples"] = examples
        top = [
            {"node": node_names[int(i)], "score": int(v)}
            for v, i in zip(top_vals[k], top_idx[k])
            if v > _NEG // 2 and 0 <= int(i) < n_real
        ][: self.top_k]
        if top:
            out["top_nodes"] = top
            if 0 <= j < len(node_names):
                win_score = int(win[k]) if j < n_real else None
                runner = next(
                    (t["score"] for t in top if t["node"] != node_names[j]),
                    None,
                )
                out["win"] = {
                    "node": node_names[j],
                    "score": win_score,
                    "margin": (
                        None if win_score is None or runner is None
                        else win_score - runner
                    ),
                }
        return out

    def _insert(self, rec: dict) -> None:
        rec["seq"] = next(self._seq)
        self._records.append(rec)
        self._by_key[rec["pod"]] = rec
        self._by_key.move_to_end(rec["pod"])
        while len(self._by_key) > self._by_key_max:
            self._by_key.popitem(last=False)

    # ------------------------------------------------------------- outcomes
    def note_requeue(
        self, key: str, where: str, plugins=(), nominated: str | None = None,
        error: bool = False,
    ) -> None:
        """The unschedulable/bind-failure epilogue: where the pod was
        requeued, which plugins rejected it, and any preemption
        nomination."""
        rec = self._by_key.get(key)
        if rec is None:
            return
        hop = {"queue": where, "plugins": sorted(plugins)}
        if error:
            hop["error"] = True
        hops = rec.setdefault("requeue", [])
        hops.append(hop)
        del hops[:-8]           # bounded history
        if nominated is not None:
            rec["nominated_node"] = nominated

    def note_preemption(self, key: str, nominated: str, victims) -> None:
        rec = self._by_key.get(key)
        if rec is not None:
            rec["nominated_node"] = nominated
            rec["preemption_victims"] = list(victims)[:16]

    def note_gang(
        self,
        key: str,
        status: str,
        engine: str = "",
        placement: str | None = None,
        members: int = 0,
        need: int = 0,
        alignment: "int | None" = None,
        slices_considered=(),
        fragmentation_delta: "int | None" = None,
        victims=(),
        victim_group: str | None = None,
    ) -> None:
        """One record per GANG placement decision, keyed by the group's
        ``ns/name`` — WHY the gang landed where it did: the winning
        placement, its slice-alignment score, which slices the search
        considered, the fragmentation delta (slices newly opened minus
        freed), and — for topology-aware preemption — the evicted gang +
        its member pods. ``kubetpu explain ns/name`` renders it."""
        rec: dict[str, Any] = {
            "pod": key,
            "kind": "gang",
            "status": status,
            "replica": self.replica,
            "members": members,
            "need": need,
        }
        if engine:
            rec["engine"] = engine
        if placement is not None:
            rec["placement"] = placement
        if alignment is not None:
            rec["alignment_score"] = int(alignment)
        if slices_considered:
            rec["slices_considered"] = list(slices_considered)[:16]
        if fragmentation_delta is not None:
            rec["fragmentation_delta"] = int(fragmentation_delta)
        if victims:
            rec["preemption_victims"] = list(victims)[:16]
        if victim_group is not None:
            rec["victim_group"] = victim_group
        self._insert(rec)

    def note_bind(
        self,
        info,
        err: Exception | None,
        t_dispatch: float,
        t_exec: float,
        t_done: float,
    ) -> dict[str, float] | None:
        """Bind completion: compute the staged latency vector, fold it into
        the pod's record, and return it (stage -> seconds; the scheduler
        observes it into the {stage} histograms). None on bind error — and
        None for a pod with NO lifecycle flight (the gang/podgroup lane
        bypasses per-pod delivery stamping): its record still closes as
        bound, but a delivery-less pod must not pollute the staged
        histograms or the soak reservoir with a bind-span-only "e2e". (No
        histogram observes it yet: module docstring.)"""
        key = info.key
        rec = self._by_key.get(key)
        if err is not None:
            if rec is not None:
                rec["status"] = "bind_error"
                rec["bind_error"] = f"{type(err).__name__}: {err}"
            return None
        fl = self._flights.pop(key, None)
        if rec is not None:
            rec["status"] = "bound"
        if fl is None or not fl.deliver_pc:
            return None
        # the ingest stamp is a perf_counter from the APISERVER process —
        # trust it only when it reads as the same clock domain (the
        # in-process stack; 0 <= create→delivery < 1h). A cross-host
        # deployment's foreign-epoch stamp degrades to delivery-based
        # attribution instead of corrupting every e2e percentile.
        ingest = fl.ingest_pc
        if ingest and not (0.0 <= fl.deliver_pc - ingest < 3600.0):
            ingest = 0.0
        stages: dict[str, float] = {}
        if ingest:
            stages["api_ingest"] = fl.deliver_pc - ingest
        stages["informer"] = max(fl.informer_s, 0.0)
        stages["queue_wait"] = max(getattr(info, "queue_wait_s", 0.0), 0.0)
        if rec is not None:
            stages["encode"] = max(rec.get("encode_s", 0.0), 0.0)
            stages["kernel"] = max(rec.get("kernel_s", 0.0), 0.0)
        if t_exec:
            stages["dispatch"] = max(t_exec - t_dispatch, 0.0)
            stages["bind_rtt"] = max(t_done - t_exec, 0.0)
        else:
            stages["bind_rtt"] = max(t_done - t_dispatch, 0.0)
        e2e = max(t_done - (ingest or fl.deliver_pc), 0.0)
        stages["e2e"] = e2e
        if rec is not None:
            # raw seconds; rendered (and rounded) to stages_ms at read
            # time — the bind-ack path is per-pod hot
            rec["_stages"] = stages
        self.e2e_samples.append((t_done, e2e))
        return stages

    # ----------------------------------------------------------- inspection
    def _snapshot(self) -> list[dict]:
        while True:
            try:
                return list(self._records)
            except RuntimeError:
                continue

    @staticmethod
    def _render(rec: dict) -> dict:
        """Read-time view of one record: raw per-pod seconds become the
        rounded ``stages_ms`` block (hot-path writes stay cheap; readers
        pay the formatting)."""
        out = dict(rec)
        out["queue_wait_s"] = round(out.get("queue_wait_s", 0.0), 6)
        stages = out.pop("_stages", None)
        if stages is not None:
            out["stages_ms"] = {
                k: round(v * 1000.0, 3) for k, v in stages.items()
            }
        return out

    def lookup(self, key: str) -> dict | None:
        """Latest record for a pod key, breakdown resolved and rendered
        (public read — internal updaters go through ``_by_key`` and
        tolerate a pending breakdown)."""
        self._resolve_pending()
        rec = self._by_key.get(key)
        return None if rec is None else self._render(rec)

    def records_json(
        self, pod: str | None = None, limit: int = 256
    ) -> dict:
        """The /debug/flightrecorder body: newest-first records, optionally
        scoped to one pod key (``ns/name``)."""
        self._resolve_pending()
        recs = self._snapshot()
        if pod:
            recs = [r for r in recs if r["pod"] == pod]
        recs = recs[-max(limit, 1):]
        recs.reverse()
        return {
            "records": [self._render(r) for r in recs],
            "count": len(recs),
            "breakdown_failures": self.breakdown_failures,
        }

    def soak_split(
        self, t0: float, t1: float
    ) -> dict | None:
        """The SustainedChurn gate: p99 e2e of the window's first half vs
        its second (sample ack times on this recorder's clock). None when
        either half is empty."""
        if t1 <= t0:
            return None
        mid = (t0 + t1) / 2.0
        first = [e for (t, e) in self.e2e_samples if t0 <= t < mid]
        second = [e for (t, e) in self.e2e_samples if mid <= t <= t1]
        if not first or not second:
            return None
        p99a = float(np.percentile(first, 99)) * 1000.0
        p99b = float(np.percentile(second, 99)) * 1000.0
        ratio = p99b / p99a if p99a > 0 else float("inf")
        return {
            "p99_first_half_ms": round(p99a, 2),
            "p99_second_half_ms": round(p99b, 2),
            "ratio": round(ratio, 3),
            "samples": [len(first), len(second)],
            # "flat" = the second half did not degrade past 2x the first —
            # the sustained-churn acceptance gate (ROADMAP item 2)
            "p99_flat": ratio <= 2.0,
        }
