#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of kubetpu (``kubetpu_torch``) on one NVIDIA
card and check it.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order (any failure raises: the exit code is then non-zero and the
final ``ok`` line is not printed):

1. device: requires CUDA, prints ``nvidia-smi``'s name and power limit;
2. build: compiles the nine kernel libraries from
   ``kubetpu_torch/kernels/csrc`` with nvcc (one process per source,
   started together) and prints the build time and ptxas' register /
   spill report;
3. kernels vs plain: on seeded encoded batches — one SchedulingBasic cycle
   at 1024 pods × 5120 padded nodes, a mixed cluster (static masks, host
   ports, images, node-affinity preferences, taints, an extended
   resource) under all three scoring strategies, a saturated batch, a
   mixed inter-pod affinity cluster (several zones, a zone key missing on
   some nodes, required affinity with the self-affinity escape, required
   anti-affinity, existing pods' anti-affinity, preferred terms of both
   signs), one SchedulingPodAffinity cycle at 1024 × 5120, a mixed
   topology-spread cluster under two profiles (hard and soft zone and
   hostname constraints — hostname signatures make the domain axis as wide
   as the node axis — minDomains above the zone count, a key no node
   carries, ignored nodes, the Honor policies, and a Service's default
   constraints), the same with the domain bitmaps forced into global
   memory, and one TopologySpreading and one PreferredTopologySpreading
   cycle at 1024 × 5120 — ``filter_score`` must equal the plain
   ``feasible_and_scores`` (mask and int64 total), the ``greedy_scan``
   engine must equal ``greedy_assign_plain`` (assignments, final node
   state, spread counts and affinity sums; at 1024 x 5120 on
   SchedulingBasic and PreferredTopologySpreading only, the affinity and
   spread terms at 512 x 2048) and the batched engine's
   ``batched_round`` solve (one launch a batch) must equal
   ``batched_assign_plain`` (the same, and the round count) exactly, on
   CUDA tensors; then ``scatter_rows``
   must equal ``scatter_node_rows_plain`` on a seeded 5120-row resident
   block (1000 dirty rows, 8 boundary rows flipping validity, pads at and
   past N) through a block's launch plan, the delta packed as the cycle
   packs it, a replaced block's plan must
   raise and write nothing, and a SchedulingBasic resident block after a
   delta refresh must equal a full upload of the same node tensors; then
   preemption:
   ``dry_run_preemption`` must equal ``dry_run_preemption_plain`` (node,
   victims, ok, n_pdb) on seeded 5120-node victim tensors with 8 slots
   (PreemptionAsync's K), 128 and 130 slots, each with 1, 3 or 5 PDBs,
   host ports and many equal (priority, start) keys; ``filter_score``, ``greedy_scan``
   and ``batched_round`` must equal their plain versions on a
   PreemptionAsync-shaped 1024 x 5120 cycle with 64 nominations (state
   slot 6 included); and ``filter_score``'s potential mode must equal the
   evaluator's plain potential mask for failed pods of that cycle and for
   pods of the mixed spread and affinity clusters; then the extender
   terms: ``filter_score``, ``greedy_scan`` and ``batched_round`` must
   equal their plain versions on the SchedulingBasic cycle and the mixed
   cluster with a seeded ``extender_mask`` (about 30% false, an eighth of
   the rows all false) and ``extender_score`` (raw x 5 x 10); then the
   flight recorder's kernels (B10): ``explain_summary`` must equal
   ``explain_summary_plain``, and ``filter_component_masks`` (packed rows)
   must equal ``filter_component_masks_rows_plain`` on every row and on
   the unassigned pods' rows (every seventh pod where none is), on the
   SchedulingBasic cycle with its greedy assignments, the saturated batch
   (rows with fewer than three feasible nodes, unassigned pods), the
   mixed, affinity and spread clusters, the 64-nomination PreemptionAsync
   cycle and the two extender batches, and on row 0 of a 4-pod Basic
   batch (the bridge's call); then the gang lane (B11-B13): ``placement_scan`` must equal
   ``placement_assign_plain`` (assignments, counts, alignment) on the
   SchedulingBasic block labeled into 32 TPU slices (1000 pods, 33
   placements: every slice and ``<all>``; the plain search on 1 slice and
   ``<all>``, phase 4 holds 2) and on the mixed, affinity and
   spread clusters cut into 8 slices (9 placements, the plain search on 1
   and ``<all>``; there the batched engine's placement search too:
   ``hypothesis_rows``, a ``batched_round`` solve a placement,
   ``slice_epilogue``), and
   ``gang_dry_run_scan`` must equal ``dry_run_gang_preemption_plain``
   (counts, alignment; the plain dry run on the first 2) at 32 eviction
   hypotheses on a full 5000-node
   sliced cluster, with freed rows on each victim slice, some more than
   the node holds, and so must the batched engine's dry run on the same
   inputs; ``hypothesis_rows`` alone must equal the plain rows of those
   32 hypotheses and of the 33 SchedulingBasic placements, and
   ``slice_epilogue`` alone the plain counts and alignment of the Basic
   placements' results (with and without the slices) and the dry run's;
   then the packing engine (B14, with B12's ``slice_occupancy`` fused):
   ``kernels.packing_assign`` must equal ``packing_assign_plain``
   (assignments, the seven state slots, the duals' bits, iterations and
   nodes used; the objective, a float32 sum taken in another order,
   within rtol 1e-5; one launch a solve), at 1024 x 5120 on the
   SchedulingBasic block cold and warm, on it labeled into 32 slices with
   ``topology="on"``, on a BinPacking block, on the coupled-heavy
   SchedulingPodAffinity and TopologySpreading blocks, on the mixed
   cluster (512 x 2048) and under a profile without the NodeResourcesFit
   filter, and stopped at 1 and 2 rounds (the stop rule on the device) on
   four of them and with no pod valid (no round); and the dual ascent's
   log1p on the card must
   equal the plain version's bits at every count in [0, 1024]; then the
   DynamicResources score term (``dra_checks``): ``filter_score``, the
   ``greedy_scan`` engine, the ``batched_round`` rounds, the packing engine
   and the placement search on both engines (all
   nodes, every other node) must equal their plain versions on the
   SchedulingBasic block given a seeded DRA leaf (8 rows of raw scores in
   [0, 64], every pod a signature) and on an encoded prioritized-list batch
   (1024 pods over 512 nodes: 768 pods with a (fast, slow) claim, 256 with
   a one-device claim on a dense pool, so R = 4), and the first three on a
   SchedulingWithResourceClaimTemplate batch (R = 4, no score leaf) and on
   a PV batch with one static row per pod (zoned PVs, 5000 nodes); the
   first two batches' ``filter_score`` and ``greedy_scan`` are timed with
   and without the leaf; then the node mesh at four logical shards on the
   card (``mesh_checks``): kernel K4 (the exchange's cross-shard argmax)
   against its plain version, one exchange round trip timed; K1 (the
   sharded ``greedy_scan``) against the unsharded kernel on the
   SchedulingBasic batch with and without a DRA leaf, the mixed, affinity
   and spread clusters, and the SchedulingPodAffinity and
   PreferredTopologySpreading cycles (every template variant), and against
   the sharded plain engine on the mixed spread cluster (``--mesh``: on
   one cut batch of each variant; the full
   Basic batch's plain run is the unsharded kernel's); a tie batch whose first pick must be the first shard's
   last node; the sharded ``filter_score`` passes and K2 (the batched
   solve over the shards) against the unsharded kernels on the
   SchedulingPodAffinity and
   TopologySpreading cycles and three mixed clusters, and against the
   sharded plain rounds on the first two; K3 (the sharded dry run) against
   the unsharded kernel and the sharded plain version at 5120 x 8 and x
   128; and a routed delta into a sharded resident block against the
   unsharded block (B5m, timed); then the preemption evaluator's
   potential mask with a hard zone spread constraint over that mesh and a
   2 x 2 grid (``potential_mesh_checks``: exact against the unsharded
   kernel and the plain version on a batch the shards' own counts would
   decide otherwise); then the packing solve over that mesh (K5, one
   launch a solve) against the unsharded kernel and the tiled plain solve,
   also stopped at 1 and 2 rounds and with no pod valid, and on a 2 x 2
   grid of logical tiles K6, K7 and, on the BinPacking batch cut to 256
   pods with and without 32 slices, K8 (``packing_grid_checks``:
   assignments, every pod row's node slots, every tile's duals' bits,
   iterations and nodes used exact against the tiled plain solve and the
   unsharded kernel; the objective within rtol 1e-5; timed beside K5 and
   the unsharded kernel); then the batched solve on its own batches
   (``batched_solve_checks``: B6 unsharded, K2 over the four shards and K6
   on the grid, each exact against the plain rounds and K2 / K6 against
   B6 too, every pod row's copy of the node rows equal): the hotspot of
   ``tests/test_torch_batched_stop.py`` (one pod a round) stopped at 1, 2,
   11 and P rounds, SchedulingPodAffinity with no pod valid, 1024 pods of
   64 classes whose tie groups mix classes (stopped at 1, 2 and 6
   rounds), crafted extender rows whose tie groups collide on one key
   (key 0 among them, the key of invalid pods), eight pods whose first
   rejection falls in the grid's second pod row, a nominated
   PreemptionAsync-shaped batch, SchedulingBasic with extender rows
   (stopped at 1, 2 and 6 rounds) and with a DRA leaf; and
   ``filter_score`` on its pod classes
   (``class_checks``; every batch above already runs on its classes):
   exact against its plain version on the BinPacking block (four
   classes), on SchedulingBasic, SchedulingPodAffinity and
   PreferredTopologySpreading rebuilt with pods that differ pairwise in
   one leaf each (with the greedy engine on the first and the batched
   rounds on the first two), on an all-singleton batch and on the webhook
   batch, and through the sharded entry on the node mesh and the grid;
   and the greedy scan's own cases (``scan_checks``): two templates taking
   turns pod by pod (also K1 and K7 against the unsharded kernel),
   ``--time-dra``'s scattered batch G, nominations released on nodes other
   threads own, and 15000 and 500 nodes, each exact against the plain
   engine;
4. main paths, each with the launch counts reset just before it and read
   just after and a full garbage collection just before (the line counts
   the full collections that fell inside the run, and the seconds the
   collector ran inside the measured phase), through
   ``run_workload(..., device="cuda")`` on its defaults (encode cache on,
   resident node block, serial cycle):
   ``SchedulingBasic/5000Nodes_10000Pods`` on the greedy engine,
   ``SchedulingPodAffinity/5000Nodes_5000Pods`` on the batched engine,
   ``TopologySpreading/5000Nodes_5000Pods`` on the batched engine,
   ``PreferredTopologySpreading/5000Nodes_5000Pods`` on the greedy engine,
   ``DefaultTopologySpreading/500Nodes`` on the greedy engine,
   ``PreemptionAsync/5000Nodes`` on the greedy engine (its churn pods
   preempt: at least one must nominate a node, every victim must have a
   lower priority than its preemptor, ``dry_run_preemption`` must have
   launched, and its first cycle with nominations must equal the plain
   engine's; it prints ``preempt()``'s ms a call, split into upload,
   potential mask, dry run and fetch); each
   checks that all its pods are bound, that no node exceeds its
   allocatable or its pod count, that its kernels were launched, and that
   the first cycle's kernel assignments (and the first cycle's with a
   spread leaf) equal the plain engine's on the same batch, and (the flight
   recorder is on by default, as in the reference) that every record in
   the recorder's ring has its breakdown resolved, no explain failed and
   ``explain_summary`` launched once a finished cycle;
   DefaultTopologySpreading holds EVERY cycle to the plain engine
   (assignments and final state), PreemptionAsync also requires
   ``filter_component_masks`` to have launched;
   TopologySpreading also checks that the bound color=blue pods' per-zone
   counts differ by at most its maxSkew, 5, and SchedulingBasic that every
   cycle after the first ships less than the whole node block; the
   5000-node paths must have launched ``scatter_rows``. Each prints its
   node-upload bytes a cycle against the block, the encode cache's hit
   rate and the stage-1 / stage-2 spans. Then SchedulingBasic again with
   ``flight_recorder=False`` (the recorder's on/off pods/s, printed, not
   gated: the reference's FlightRecorderOverhead; its bound map must
   equal the recorder-on run's); then
   ``SchedulingBasic/500Nodes`` with 400 measured pods on the greedy and
   on the batched engine behind a seeded in-process webhook (filter and prioritize, weight 5,
   NodeCacheCapable, rejecting ~15% of the nodes for each pod): every pod
   bound, none on a node the webhook rejected for it, the first cycle equal
   to the plain engine with the same extender leaves. Then the gang lane with
   GenericWorkload, GangScheduling and TopologyAwareWorkloadScheduling on:
   ``GangScheduling/5000Nodes_3Gangs_3000Pods_1000PerGroup`` and
   ``GangScheduling/5000Nodes_1000Gangs_3000Pods`` on a fleet labeled into
   32 TPU slices with ``topology="on"`` (placement cycles through
   ``hypothesis_scan``; every gang on one slice; the first placement
   search's first two placements equal to ``placement_assign_plain``),
   the former again on the batched
   engine (placement cycles through ``hypothesis_rows``, a ``batched_round``
   solve a placement and ``slice_epilogue``), the latter again unlabeled with
   ``topology="off"`` (coalesced greedy cycles), and a gang preemption
   scenario at 5000 nodes and 32 slices (16 priority-0 gangs each on a
   slice, priority-10 pods on every other node, then a priority-10 gang
   that fits nowhere: the gang dry run over at least 16 hypotheses, equal
   to its plain version on that call's inputs, exactly one gang evicted,
   the preemptor bound on the freed slice). Then the packing engine:
   ``BinPacking/1000Nodes_3000Pods`` on the greedy, batched and packing
   engines (each engine's pods/s, nodes carrying the measured pods,
   priority SLO hit rate and solver iterations a cycle printed; packing
   must use no more nodes than greedy), and
   ``SchedulingBasic/5000Nodes_10000Pods`` on packing, unlabeled and on
   the 32-slice fleet with ``topology="on"``: every pod bound, capacity
   held, the start, round and end kernels launched, the first cycle equal
   to the plain solve from cold duals. Then volumes and DRA:
   ``SchedulingInTreePVs`` and ``SchedulingCSIPVs``/5000Nodes_2000Pods on
   the greedy engine (3000 bound, every PVC's PV bound to it once, no
   PreBind write for a claim already bound, no pick left assumed, every
   pod on a node its PV allows),
   ``SchedulingWithResourceClaimTemplate``/5000pods_500nodes on the greedy
   engine and cut to 1000 pods on the batched engine (5000 and 1000 bound, every claim allocated on its
   pod's node, no device allocated twice, at most 10 claims a node, every
   claim's status written once by PreBind), and the prioritized-list
   scenario at 500 nodes (10 slow devices a node, 2 fast ones on every
   second node, 1000 pods each with its own (fast, slow) claim, through the
   Scheduler under a stepped clock: every pod bound, each fast device
   allocated at most once, EVERY cycle's kernel assignments and final
   state equal to the plain engine's; it prints the cycles, the Reserve
   rejections and the pods on a fast device), then again under device
   contention (one fast device and no slow one on every second node:
   Reserve must reject the scan's in-batch losers, which requeue and
   bind in a later cycle, every fast device taken). Then SchedulingBasic and
   PreferredTopologySpreading run again with ``pipeline=True``: their
   bound maps must equal the serial runs', pod for pod (the serial runs
   hold the plain engine); last, a seeded
   preempt-then-schedule scenario under a stepped clock (500 nodes of four
   priority-0 pods, 256 3-cpu preemptors, 300 default pods) runs on
   ``cuda`` and on ``cpu``: bound maps, victims and nominations must be
   equal and every preemptor bound; and the extender bridge: the port's
   ``ExtenderServer`` on ``cuda`` and a second on ``cpu`` each hold the
   5000 nodes and 1000 bound pods of SchedulingBasic/5000Nodes (loaded
   through /cache/nodes and /cache/pods), 128 pods post ``filter`` and
   ``prioritize`` with all 5000 node names, some also ``preempt`` and
   ``bind``, one ``filter`` carries full Nodes items: every reply of the
   card's server must equal the cpu server's; requests/s and p50/p99 ms
   per verb are printed. Under the node mesh (four logical shards, after
   the pipelined paths): SchedulingBasic/5000Nodes_10000Pods on greedy,
   SchedulingPodAffinity/5000Nodes_5000Pods on batched (each bound map
   equal to the unsharded run's, pod for pod; ``sharded_scan`` /
   ``sharded_round`` and the routed ``scatter_rows`` launched; every
   record "skipped: mesh") and PreemptionAsync/5000Nodes (every measured
   pod bound, at least one nomination, ``shard_pick`` launched); after the
   packing paths, BinPacking/1000Nodes_3000Pods and SchedulingBasic on
   packing under the node mesh (K5) and on a 2 x 2 grid of logical tiles
   (K8), PodAffinity (batched, K6) and Basic (greedy, K7) on the grid, each
   bound map (and packing's nodes used) equal to the unsharded run's; then
   the gang lane under a mesh, run as the reference runs it (each group
   batch unsharded on the mesh's first card): the 3 x 1000 gangs on 32
   slices, greedy under the node mesh and batched on the grid (every gang
   on one slice, bound maps equal to the unsharded runs'), and the
   unlabeled 1000 gangs on packing, unsharded and under the node mesh,
   each followed by 512 plain pods (bound maps, and the duals the engine
   carried across the group and per-pod cycles, equal);
5. prints the kernels' JSON line, the card line, and the ``ok`` line last.

Tolerance everywhere: exact (integer masks, scores and assignments).

``python3 chip_smoke.py --time-basic ROOT`` instead builds the checkout at
``ROOT`` (printing ptxas' report), times only its ``filter_score`` and
``greedy_scan`` engine on the SchedulingBasic cycle and its placement
search (B11) at P = 1000 over 33 placements and for a 3-pod gang, and
prints one JSON line; where the checkout has ``csrc/scan_split.cu`` the
line also holds the scan's step split and step floor (``scan_split``);
``--time-spread ROOT`` does the same on the PreferredTopologySpreading
cycle and on the mixed spread cluster under the spread profile;
``--time-batched ROOT`` times its batched engine (``time_batched``): B6 on
the SchedulingPodAffinity, TopologySpreading and BinPacking batches, the
batched gang placement search (33 placements), and K2 and K6 on
SchedulingPodAffinity's batch at four logical shards and on the 2 x 2
grid, each with the card's busy time a call and, where the checkout has
it, the solve's split into its steps;
``--time-recorder ROOT`` times its flight recorder's explain (B10) on the
SchedulingBasic batch (one pod class) and with a class a pod, its
resident block's scatter (B5) of a 1024-slot Basic delta as the cycle
calls it, ``filter_component_masks`` as its callers take it (the bridge's
``_components`` on a one-pod request; the recorder's launch and fetch for
one unschedulable pod of the Basic batch) and the dry run (B9) at
5120 x 8 and x 128 (``time_recorder``);
``--time-mesh ROOT`` times its node mesh's greedy, batched and packing
engines (kernels K1, K2 and K5 at four logical shards) and its packing
solve on a 2 x 2 grid of logical tiles (K8), on the BinPacking block and
its cut to 256 pods, beside its unsharded kernels (B14 for packing).
Run any of them on two checkouts in turns (parent, change, change,
parent) to compare the two on one card within one call. ``--time-dra`` splits the scan's time on
the SchedulingBasic cycle with a DynamicResources score leaf into the
normalize pass and the placements the leaf moves (``time_dra``).
``--mesh`` runs the node mesh's checks (``mesh_checks``, the packing and
grid checks, K8 also on the full BinPacking block, the batched solve's
``batched_solve_checks``) and its paths, with
SchedulingBasic, SchedulingPodAffinity, PreemptionAsync, the packing
paths and the 3 x 1000 gangs unsharded first, over one shard a card on
every visible card (four logical shards when only one is visible), prints the exchange's round trip and
``measure_collective_wall``, and ends with the same ``ok`` line, its count
the cards visible. ``--webhook-queue`` loads the extender paths' webhook
fixture on the host alone and prints the calls lost under socketserver's
default listen queue of 5 and under the fixture's 128
(``webhook_queue_mode``).
"""

from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and non-tensor FP64 rate, the
# rates the bounds below divide by
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12


def log(*a) -> None:
    print(*a, flush=True)


_STAMPS = [time.perf_counter()]


def stamp(what: str) -> None:
    """Log the seconds since the script started and since the last stamp
    (where the run's time goes, against its 1200 s limit)."""
    now = time.perf_counter()
    log(f"[t={now - _STAMPS[0]:.1f} s] {what} took {now - _STAMPS[-1]:.1f} s")
    _STAMPS.append(now)


# ------------------------------------------------------------- 1. device
def device_phase() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return card


# -------------------------------------------------------------- 2. build
def build_phase() -> float:
    from kubetpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.1f} s")
    log_build_report(kernels)
    return secs


def log_build_report(kernels) -> None:
    """ptxas' register, stack and spill report of each kernel built, each
    after the (mangled) name of its entry function."""
    for src, text in kernels.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry function" in line:
                log(f"  {src}: {line.strip()}")


# --------------------------------------------------- 3. kernels vs plain
def _cache_with(nodes, pods_bound):
    from kubetpu_torch.state.snapshot import Cache

    cache = Cache()
    for n in nodes:
        cache.add_node(n)
    for p in pods_bound:
        cache.add_pod(p)
    return cache


def basic_case(n_nodes=5000, n_bound=1000, n_pending=1024):
    """A SchedulingBasic cycle: node_default nodes, pod_default pods (the
    init pods already bound round-robin), a full batch pending."""
    from kubetpu_torch.perf import workloads as W

    nodes = [W.node_default(i) for i in range(n_nodes)]
    bound = [
        W.pod_default(f"init-{j}", "namespace-0").with_node(nodes[j % n_nodes].name)
        for j in range(n_bound)
    ]
    pending = [W.pod_default(f"measure-{j}", "namespace-1") for j in range(n_pending)]
    return _cache_with(nodes, bound), pending


def mixed_case(seed=0, n_nodes=2000, n_bound=3000, n_pending=512):
    """A seeded cluster that exercises every leaf the kernels take: static
    masks (node selectors, NoSchedule taints, unschedulable nodes), host
    ports, an extended resource, images, preferred node affinity and
    PreferNoSchedule taints."""
    import numpy as np

    from kubetpu_torch.api import types as t
    from kubetpu_torch.api.wrappers import make_node, make_pod

    rng = np.random.default_rng(seed)
    images = [f"img-{i}" for i in range(6)]
    nodes = []
    for i in range(n_nodes):
        labels = {"kubernetes.io/hostname": f"node-{i}",
                  "zone": f"z{i % 3}"}
        if rng.random() < 0.3:
            labels["disktype"] = str(rng.choice(["ssd", "hdd"]))
        taints = ()
        if rng.random() < 0.25:
            effect = rng.choice([t.TaintEffect.NO_SCHEDULE, t.TaintEffect.PREFER_NO_SCHEDULE])
            taints = (t.Taint(key="dedicated", value="gpu", effect=effect),)
        node_images = {
            im: t.ImageState(size_bytes=int(rng.integers(10, 900)) * 1024**2,
                             num_nodes=int(rng.integers(1, n_nodes)))
            for im in images if rng.random() < 0.3
        }
        nodes.append(make_node(
            f"node-{i}", cpu_milli=int(rng.integers(1000, 16001)),
            memory=int(rng.integers(2, 64)) * 1024**3,
            pods=int(rng.integers(4, 110)), labels=labels, taints=taints,
            extended={"example.com/foo": int(rng.integers(0, 8))},
            unschedulable=bool(rng.random() < 0.05), images=node_images,
        ))
    bound = []
    for j in range(n_bound):
        node = nodes[int(rng.integers(0, n_nodes))]
        bound.append(make_pod(
            f"existing-{j}", cpu_milli=int(rng.integers(0, 1001)),
            memory=int(rng.integers(0, 4)) * 256 * 1024**2, node_name=node.name,
            host_ports=[int(rng.integers(8000, 8004))] if rng.random() < 0.2 else [],
        ))
    pending = []
    for j in range(n_pending):
        kw = {}
        if rng.random() < 0.3:
            kw["node_selector"] = {"disktype": "ssd"}
        if rng.random() < 0.5:
            kw["tolerations"] = [t.Toleration(
                key="dedicated", operator=t.TolerationOperator.EQUAL,
                value="gpu", effect=None)]
        if rng.random() < 0.4:
            kw["affinity"] = t.Affinity(node_affinity=t.NodeAffinity(preferred=(
                t.PreferredSchedulingTerm(int(rng.integers(1, 100)), t.NodeSelectorTerm(
                    (t.Requirement("zone", t.Operator.IN, (f"z{int(rng.integers(0, 3))}",)),))),
            )))
        if rng.random() < 0.5:
            kw["images"] = [str(im) for im in rng.choice(images, size=2, replace=False)]
        req = {}
        if rng.random() < 0.9:
            req[t.CPU] = int(rng.integers(0, 3001))
        if rng.random() < 0.9:
            req[t.MEMORY] = int(rng.integers(0, 8)) * 256 * 1024**2
        if rng.random() < 0.4:
            req["example.com/foo"] = int(rng.integers(1, 4))
        pending.append(make_pod(
            f"pending-{j}", requests=req, creation_index=j,
            host_ports=[int(rng.integers(8000, 8004))] if rng.random() < 0.2 else [],
            **kw,
        ))
    return _cache_with(nodes, bound), pending


def affinity_case(seed=0, n_nodes=2000, n_bound=3000, n_pending=512):
    """A seeded inter-pod affinity cluster with every slot kind: three
    zones and nodes without a zone label, assigned pods carrying required
    (anti-)affinity and preferred terms, pending pods with required zone
    affinity (some matching their own terms: the self-affinity escape on an
    app no pod runs yet), required hostname and zone anti-affinity, and
    preferred affinity and anti-affinity of both signs."""
    import numpy as np

    from kubetpu_torch.api import types as t
    from kubetpu_torch.api.wrappers import make_node, make_pod, pod_affinity_term

    zone, host = "topology.kubernetes.io/zone", "kubernetes.io/hostname"
    apps = ["web", "db", "cache", "fresh"]
    rng = np.random.default_rng(seed)

    def affinity():
        app = str(rng.choice(apps))
        key = zone if rng.random() < 0.6 else host
        term = pod_affinity_term(key, match_labels={"app": app})
        weighted = t.WeightedPodAffinityTerm(int(rng.integers(1, 101)), term)
        kind = rng.random()
        if kind < 0.25:
            return t.Affinity(pod_affinity=t.PodAffinity(required=(term,)))
        if kind < 0.45:
            return t.Affinity(pod_anti_affinity=t.PodAffinity(required=(term,)))
        if kind < 0.75:
            return t.Affinity(pod_affinity=t.PodAffinity(preferred=(weighted,)))
        return t.Affinity(pod_anti_affinity=t.PodAffinity(preferred=(weighted,)))

    nodes = []
    for i in range(n_nodes):
        labels = {host: f"node-{i}"}
        if rng.random() < 0.9:
            labels[zone] = f"z{i % 3}"
        nodes.append(make_node(
            f"node-{i}", cpu_milli=int(rng.integers(2000, 16001)),
            memory=int(rng.integers(4, 64)) * 1024**3,
            pods=int(rng.integers(8, 110)), labels=labels,
        ))
    bound = []
    for j in range(n_bound):
        node = nodes[int(rng.integers(0, n_nodes))]
        bound.append(make_pod(
            f"existing-{j}", cpu_milli=int(rng.integers(0, 501)),
            memory=int(rng.integers(0, 4)) * 256 * 1024**2, node_name=node.name,
            labels={"app": str(rng.choice(apps[:3]))},
            affinity=affinity() if rng.random() < 0.2 else None,
        ))
    pending = []
    for j in range(n_pending):
        pending.append(make_pod(
            f"pending-{j}", cpu_milli=int(rng.integers(0, 2001)),
            memory=int(rng.integers(0, 8)) * 256 * 1024**2, creation_index=j,
            labels={"app": str(rng.choice(apps))},
            affinity=affinity() if rng.random() < 0.7 else None,
        ))
    return _cache_with(nodes, bound), pending


def podaffinity_case(n_nodes=5000, n_bound=5000, n_pending=1024):
    """A SchedulingPodAffinity cycle: node_default nodes all in zone1, the
    init pods of pod_with_pod_affinity already bound round-robin in
    sched-0, a full batch of measured pods pending in sched-1."""
    from kubetpu_torch.api import types as t
    from kubetpu_torch.perf import workloads as W

    nodes = [W.node_default(i, ("zone1",)) for i in range(n_nodes)]
    bound = [
        W.pod_with_pod_affinity(f"init-{j}", "sched-0").with_node(nodes[j % n_nodes].name)
        for j in range(n_bound)
    ]
    pending = [W.pod_with_pod_affinity(f"measure-{j}", "sched-1")
               for j in range(n_pending)]
    cache = _cache_with(nodes, bound)
    for i in range(2):
        cache.add_namespace(t.Namespace(name=f"sched-{i}"))
    return cache, pending


def spread_case(seed=0, n_nodes=2000, n_bound=3000, n_pending=512):
    """A seeded topology-spread cluster with every kind of slot: three zones
    with the zone label missing on some nodes, NoSchedule taints, assigned
    pods of three apps in two namespaces, and pending pods with hard and
    soft zone and hostname constraints (hostname signatures make the domain
    axis as wide as the node axis), minDomains above the zone count, a
    topology key no node carries (hard: infeasible everywhere; soft: every
    node ignored), node selectors and taint tolerations under the Honor
    policies, and pods with no constraints of their own that a Service
    selects (the profile's default constraints)."""
    import dataclasses

    import numpy as np

    from kubetpu_torch.api import types as t
    from kubetpu_torch.api.wrappers import make_node, make_pod, spread_constraint

    zone, host = "topology.kubernetes.io/zone", "kubernetes.io/hostname"
    hard = t.UnsatisfiableConstraintAction.DO_NOT_SCHEDULE
    soft = t.UnsatisfiableConstraintAction.SCHEDULE_ANYWAY
    apps = ["web", "db", "cache", "fresh"]
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n_nodes):
        labels = {host: f"node-{i}"}
        if rng.random() < 0.9:
            labels[zone] = f"z{i % 3}"
        if rng.random() < 0.4:
            labels["disktype"] = "ssd"
        taints = ()
        if rng.random() < 0.1:
            taints = (t.Taint(key="dedicated", value="gpu",
                              effect=t.TaintEffect.NO_SCHEDULE),)
        nodes.append(make_node(
            f"node-{i}", cpu_milli=int(rng.integers(2000, 16001)),
            memory=int(rng.integers(4, 64)) * 1024**3,
            pods=int(rng.integers(8, 110)), labels=labels, taints=taints,
        ))
    bound = []
    for j in range(n_bound):
        node = nodes[int(rng.integers(0, n_nodes))]
        bound.append(make_pod(
            f"existing-{j}", cpu_milli=int(rng.integers(0, 501)),
            memory=int(rng.integers(0, 4)) * 256 * 1024**2, node_name=node.name,
            namespace=str(rng.choice(["default", "other"])),
            labels={"app": str(rng.choice(apps[:3]))},
        ))

    def constraint(app):
        key = str(rng.choice([zone, zone, host, "example.com/rack"],
                             p=[0.45, 0.1, 0.4, 0.05]))
        c = spread_constraint(
            int(rng.integers(1, 6)), key,
            when=hard if rng.random() < 0.5 else soft,
            match_labels={"app": app},
            min_domains=4 if key == zone and rng.random() < 0.3 else None,
        )
        if rng.random() < 0.3:
            c = dataclasses.replace(c, node_taints_policy="Honor")
        if rng.random() < 0.2:
            c = dataclasses.replace(c, node_affinity_policy="Ignore")
        return c

    pending = []
    for j in range(n_pending):
        app = str(rng.choice(apps))
        kw = {}
        if rng.random() < 0.7:
            kw["spread"] = tuple(constraint(app) for _ in range(int(rng.integers(1, 3))))
        if rng.random() < 0.2:
            kw["node_selector"] = {"disktype": "ssd"}
        if rng.random() < 0.5:
            kw["tolerations"] = [t.Toleration(
                key="dedicated", operator=t.TolerationOperator.EQUAL,
                value="gpu", effect=None)]
        pending.append(make_pod(
            f"pending-{j}", cpu_milli=int(rng.integers(0, 2001)),
            memory=int(rng.integers(0, 8)) * 256 * 1024**2, creation_index=j,
            labels={"app": app}, **kw,
        ))
    cache = _cache_with(nodes, bound)
    cache.add_service(t.Service(name="web", namespace="default",
                                selector=(("app", "web"),)))
    return cache, pending


def topology_case(template, n_nodes=5000, n_init=5000, n_spread=1000, n_pending=1024):
    """A TopologySpreading / PreferredTopologySpreading cycle: node_default
    nodes round-robin over zones moon-1/2/3, the pod_default init pods and
    ``n_spread`` pods of ``template`` already bound round-robin, a full
    batch of ``template`` pods pending."""
    from kubetpu_torch.perf import workloads as W

    nodes = [W.node_default(i, ("moon-1", "moon-2", "moon-3")) for i in range(n_nodes)]
    bound = [W.pod_default(f"init-{j}", "namespace-0").with_node(nodes[j % n_nodes].name)
             for j in range(n_init)]
    bound += [template(f"spread-{j}", "namespace-1").with_node(nodes[j % n_nodes].name)
              for j in range(n_spread)]
    pending = [template(f"measure-{j}", "namespace-1") for j in range(n_pending)]
    return _cache_with(nodes, bound), pending


def saturated_case(n_nodes=64, n_pending=512):
    """More pods than capacity: most of the batch ends unschedulable (-1)."""
    from kubetpu_torch.api.wrappers import make_node, make_pod

    nodes = [make_node(f"small-{i}", cpu_milli=1000, memory=4 * 1024**3, pods=10)
             for i in range(n_nodes)]
    pending = [make_pod(f"p-{j}", cpu_milli=300, memory=256 * 1024**2)
               for j in range(n_pending)]
    return _cache_with(nodes, []), pending


def profiles():
    from kubetpu_torch.framework import config as C

    return {
        "least": C.Profile(),
        "most": C.Profile(scoring_strategy=C.ScoringStrategy(type=C.MOST_ALLOCATED)),
        "rtcr": C.Profile(scoring_strategy=C.ScoringStrategy(
            type=C.REQUESTED_TO_CAPACITY_RATIO,
            shape=((0, 0), (40, 8), (100, 3)))),  # a decreasing segment
        # three balanced resources: the population-std branch (sqrt)
        "balanced3": C.Profile(balanced_resources=(
            ("cpu", 1), ("memory", 1), ("example.com/foo", 1))),
    }


def encode(cache, pending, profile):
    batch, params = encode_batch_full(cache, pending, profile)
    return batch.device, params


def cuda_ms(fn, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` runs, each timed with CUDA events
    after one warm-up run; one run alone, with no warm-up, when ``reps``
    is 1 (the plain versions at full size: seconds a run, nothing to
    warm)."""
    import torch

    if reps > 1:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def f64_ops_per_pair(params, b) -> int:
    """float64 operations for one (pod, node) pair: the balanced score's
    (per side, each present resource costs a divide, a min, an add, a
    subtract, a multiply, an abs and two adds; then a mean divide, the std
    divide or sqrt, and the final subtract and multiply) and, with affinity
    score rows, the affinity normalize's (two conversions, a multiply and a
    divide)."""
    n_bal = sum(1 for w in params.balanced_weights if w > 0)
    ops = 2 * (8 * n_bal + 4) if params.w_balanced else 0
    pa = b.podaffinity
    if pa is not None and params.w_interpod and pa.has_score_work:
        ops += 4
    return ops


def scored_pods(b) -> int:
    """The pods whose pairs ``filter_score`` scores: one a pod class
    (``runtime.pod_classes``), every pod of a batch without classes. The
    bounds count the float64 work of these pairs: what the run's data
    needs."""
    from kubetpu_torch.framework import runtime as rt

    classes = rt.pod_classes(b)
    return int(b.requests.shape[0]) if classes is None else classes.count


def spread_f64_ops(params, b) -> int:
    """float64 operations of one spread score of every scored (pod, node)
    pair (``scored_pods``): per ScheduleAnyway slot a conversion, a
    multiply and two adds (the maxSkew - 1 term and the running sum), then
    the rounding of the sum."""
    from kubetpu_torch.framework import runtime as rt

    sp = b.spread
    if sp is None or not (params.w_spread and sp.has_soft):
        return 0
    sig, action = sp.sig_idx, sp.action
    classes = rt.pod_classes(b)
    if classes is not None and classes.shared:
        sig, action = sig[classes.reps.long()], action[classes.reps.long()]
    n_soft = int(((sig >= 0) & (action == 1)).sum().item())
    return b.alloc.shape[0] * (4 * n_soft + int(sig.shape[0]))


def _max_abs(a, b) -> int:
    import torch

    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def _engine_err(name, ka, ks, pa, ps) -> int:
    """Largest difference between two engines' outputs; raises unless they
    are equal (assignments and every state slot: node state, spread
    counts, affinity sums, live nominations)."""
    import torch

    err = _max_abs(ka, pa)
    same = torch.equal(ka, pa)
    for i in range(7):
        if ks[i] is None and ps[i] is None:
            continue
        if ks[i] is None or ps[i] is None:
            raise AssertionError(f"{name}: state slot {i} differs in presence")
        err = max(err, _max_abs(ks[i], ps[i]))
        same = same and torch.equal(ks[i], ps[i])
    if not same:
        raise AssertionError(f"{name}: kernel differs from the plain version (max abs err {err})")
    return err


def check_case(name, b, params, results, batched=True, plain_greedy=True):
    """Hold the kernels to their plain versions on one batch: filter_score,
    the greedy_scan engine (unless ``plain_greedy`` is false: a batch whose
    greedy engine is held at full size elsewhere, or at a smaller size on
    the same terms) and (when ``batched``) the batched_round rounds. The
    plain greedy run's ms (CUDA events, one run) is kept in
    ``results["greedy_scan"]["plain_ms_of"][name]``. Returns the greedy
    kernel's assignments."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.batched import batched_assign_plain
    from kubetpu_torch.assign.greedy import greedy_assign_plain
    from kubetpu_torch.framework import runtime as rt

    def note(kernel, err):
        results[kernel]["cases"].append(name)
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)

    km, kt = kernels.filter_score(b, params)
    pm, pt = rt.feasible_and_scores(b, params)
    torch.cuda.synchronize()
    err_fs = max(_max_abs(km, pm), _max_abs(kt, pt))
    if not (torch.equal(km, pm) and torch.equal(kt, pt)):
        raise AssertionError(f"{name}: filter_score differs from the plain version "
                             f"(max abs err {err_fs})")
    note("filter_score", err_fs)
    ka, ks = kernels.greedy_scan(b, params)
    if plain_greedy:
        plain_out = []
        results["greedy_scan"].setdefault("plain_ms_of", {})[name] = cuda_ms(
            lambda: plain_out.append(greedy_assign_plain(b, params)), 1)
        pa, ps = plain_out[0]
        note("greedy_scan", _engine_err(f"{name} greedy_scan", ka, ks, pa, ps))
    n_valid = int(b.pod_valid.sum().item())
    extra = ""
    if batched:
        k_rounds, p_rounds = [], []
        va, vs = kernels.batched_assign(b, params, rounds_out=k_rounds)
        wa, ws = batched_assign_plain(b, params, rounds_out=p_rounds)
        torch.cuda.synchronize()
        err = _engine_err(f"{name} batched_round", va, vs, wa, ws)
        if k_rounds != p_rounds:
            raise AssertionError(f"{name}: batched rounds {k_rounds} != plain {p_rounds}")
        note("batched_round", err)
        extra = (f", batched: {k_rounds[0]} rounds, unschedulable "
                 f"{int((va[:n_valid] < 0).sum().item())}")
    pa_rows = "none" if b.podaffinity is None else tuple(b.podaffinity.base_sums.shape)
    sp_sigs = ("none" if b.spread is None else
               f"{tuple(b.spread.domain_present.shape)} slots {b.spread.sig_idx.shape[1]}")
    log(f"kernels vs plain [{name}]: P={b.requests.shape[0]} N={b.alloc.shape[0]} "
        f"R={b.alloc.shape[1]} K={b.port_conflict.shape[0]} affinity rows x domains "
        f"{pa_rows}, spread signatures x domains {sp_sigs}: exact (feasible pairs "
        f"{int(km.sum().item())}, greedy "
        f"unschedulable {int((ka[:n_valid] < 0).sum().item())}"
        f"{'' if plain_greedy else ' (greedy kernel only)'}{extra})")
    return ka


def affinity_profiles():
    from kubetpu_torch.framework import config as C

    return {
        "default": C.Profile(),
        # the affinity filter and a heavier affinity score, nothing else
        # that normalizes
        "interpod": C.Profile(
            filters=C.PluginSet(enabled=(
                (C.NODE_RESOURCES_FIT, 1), (C.INTER_POD_AFFINITY, 1),
            )),
            scores=C.PluginSet(enabled=(
                (C.NODE_RESOURCES_FIT, 1), (C.INTER_POD_AFFINITY, 2),
            )),
            default_spread_constraints=(),
        ),
    }


def spread_profiles():
    from kubetpu_torch.framework import config as C

    return {
        "default": C.Profile(),
        # the spread filter and a heavier spread score beside the fit terms
        "spread": C.Profile(
            filters=C.PluginSet(enabled=(
                (C.NODE_RESOURCES_FIT, 1), (C.POD_TOPOLOGY_SPREAD, 1),
            )),
            scores=C.PluginSet(enabled=(
                (C.NODE_RESOURCES_FIT, 1), (C.POD_TOPOLOGY_SPREAD, 2),
            )),
            default_spread_constraints=(),
        ),
    }


@contextlib.contextmanager
def bitmaps_in_global():
    """Put every spread domain bitmap in a global scratch row, as a
    signature with more domains than shared memory holds bits for has it
    (a limit of 0 leaves room for no bitmap word)."""
    from kubetpu_torch import kernels

    limit = kernels._SMEM_LIMIT
    kernels._SMEM_LIMIT = 0
    try:
        yield
    finally:
        kernels._SMEM_LIMIT = limit


def spread_checks(results, scale=1.0):
    """Phase 3's spread batches: the mixed spread cluster under both
    profiles, the same with the domain bitmaps in global memory, then one
    TopologySpreading and one PreferredTopologySpreading cycle at the main
    paths' shapes. Returns the two cycles' batches and, under
    ``spread/<profile>``, the mixed cluster's batches with their greedy
    assignments."""
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.perf import workloads as W

    out = {}
    for name, prof in spread_profiles().items():
        cache_s, pending_s = spread_case(
            seed=3, n_nodes=int(2000 * scale), n_bound=int(3000 * scale),
            n_pending=int(512 * scale))
        bs, ps = encode(cache_s, pending_s, prof)
        out[f"spread/{name}"] = (bs, ps, check_case(f"spread/{name}", bs, ps, results))
    with bitmaps_in_global():
        cache_s, pending_s = spread_case(seed=4, n_nodes=int(1000 * scale),
                                         n_bound=int(1500 * scale), n_pending=int(256 * scale))
        bs, ps = encode(cache_s, pending_s, C.Profile())
        check_case("spread/default, domain bitmaps in global memory", bs, ps, results)
    for name, template in (("TopologySpreading", W.pod_with_topology_spreading),
                           ("PreferredTopologySpreading",
                            W.pod_with_preferred_topology_spreading)):
        cache_t, pending_t = topology_case(
            template, n_nodes=int(5000 * scale), n_init=int(5000 * scale),
            n_spread=int(1000 * scale), n_pending=int(1024 * scale))
        bt, pt = encode(cache_t, pending_t, C.Profile())
        # the greedy engine at this size: PreferredTopologySpreading's in
        # _spread_timing, and on the main path's first cycles; the spread
        # terms at 512 x 2048 above
        check_case(f"{name} {bt.requests.shape[0]}x{bt.alloc.shape[0]}", bt, pt, results,
                   plain_greedy=False)
        out[name] = (bt, pt)
    return out


def _bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    bytes_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / FP64_FLOPS
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def spread_read_nbytes(params, b, kernel) -> int:
    """Bytes of the batch that ``kernel`` (or its plain version) reads:
    every leaf but the spread leaves that this batch's work skips. The
    (P, N) ``ignored`` rows and ``is_hostname`` are read only by the spread
    score, which runs only when the profile weighs it and a pod has a
    ScheduleAnyway slot; ``pod_match_sig`` only by the engines' count
    updates, not by ``filter_score``."""
    from kubetpu_torch.framework import runtime as rt

    total = rt.batch_nbytes(b)
    sp = b.spread
    if sp is None:
        return total
    if not (params.w_spread and sp.has_soft):
        total -= int(sp.ignored.nbytes) + int(sp.is_hostname.nbytes)
    if kernel == "filter_score":
        total -= int(sp.pod_match_sig.nbytes)
    return total


def _spread_timing(case, b, params, kernel, results=None) -> dict:
    """Time one kernel (its engine, for the scan and the rounds) and its
    plain version on a topology-spreading cycle's batch (the greedy
    engine's one plain run also holds the kernel to it, noted in
    ``results``), with the bound of
    that work: the batch's bytes that the work reads (``spread_read_nbytes``:
    the (P, N) ``ignored`` rows only where a soft slot is scored) read once
    and the kernel's outputs written once, over HBM bandwidth, against its
    float64 operations over the FP64 rate."""
    from kubetpu_torch import kernels
    from kubetpu_torch.assign.batched import batched_assign_plain
    from kubetpu_torch.assign.greedy import greedy_assign_plain
    from kubetpu_torch.framework import runtime as rt

    P, N = b.requests.shape[0], b.alloc.shape[0]
    in_bytes = spread_read_nbytes(params, b, kernel)
    state = sum(int(x.nbytes) for x in (b.requested, b.nonzero_requested,
                                        b.pod_count, b.node_ports, b.spread.node_count))
    per_pair = f64_ops_per_pair(params, b)
    out = {"batch": f"{case} {P}x{N}"}
    scored = bool(params.w_spread and b.spread.has_soft)
    if kernel == "filter_score":
        out["ms"] = cuda_ms(lambda: kernels.filter_score(b, params), 20)
        out["plain_ms"] = cuda_ms(lambda: rt.feasible_and_scores(b, params), 5)
        if scored:
            with bitmaps_in_global():
                out["bitmaps_in_global_ms"] = cuda_ms(
                    lambda: kernels.filter_score(b, params), 20)
        work = (in_bytes + P * N * (1 + 8),
                scored_pods(b) * N * per_pair + spread_f64_ops(params, b))
    elif kernel == "greedy_scan":
        out["ms"] = cuda_ms(lambda: kernels.greedy_scan(b, params), 5)
        plain_out = []
        out["plain_ms"] = cuda_ms(lambda: plain_out.append(greedy_assign_plain(b, params)), 1)
        ka, ks = kernels.greedy_scan(b, params)
        _engine_err(f"{case} {P}x{N} greedy_scan", ka, ks, *plain_out[0])
        if results is not None:
            results["greedy_scan"]["cases"].append(f"{case} {P}x{N}")
        if scored:
            with bitmaps_in_global():
                out["bitmaps_in_global_ms"] = cuda_ms(
                    lambda: kernels.greedy_scan(b, params), 5)
        # a step rescores the nodes the batch's earlier pods landed on that
        # changed since their verdicts were kept
        rescored = _rescored(kernels.greedy_scan(b, params)[0].cpu().tolist(),
                             class_of=_class_of(b))
        work = (in_bytes + P * 4 + state,
                (scored_pods(b) * N + rescored) * per_pair + spread_f64_ops(params, b))
    else:
        rounds: list = []
        kernels.batched_assign(b, params, rounds_out=rounds)
        out["ms"] = cuda_ms(lambda: kernels.batched_assign(b, params), 10)
        out["plain_ms"] = cuda_ms(lambda: batched_assign_plain(b, params), 3)
        out["rounds"] = rounds[0]
        work = (in_bytes + P * 4 + state,
                rounds[0] * (scored_pods(b) * N * per_pair + spread_f64_ops(params, b)))
    out["bound_ms"], out["bound_by"] = _bound(*work)
    return out


def scatter_block(seed=0, n_real=5000, n_pad=5120, n_rows=1000, r=3):
    """A seeded resident block at the Basic path's shape on the card and
    one cycle's delta: ``n_rows`` distinct dirty rows in random order, the
    boundary rows [n_real, n_real + 8) flipping validity, then pads to the
    1024-slot bucket: index ``n_pad`` (the refresh's pad) and a few past
    it. Returns ``(nodes, idx, updates)``."""
    import numpy as np
    import torch

    from kubetpu_torch.framework import runtime as rt

    rng = np.random.default_rng(seed)

    def block(n, valid):
        return (
            rng.integers(0, 1 << 40, (n, r)), rng.integers(0, 1 << 40, (n, r)),
            rng.integers(0, 1 << 40, (n, r)),
            rng.integers(0, 110, n).astype(np.int32),
            rng.integers(0, 111, n).astype(np.int32), valid,
        )

    nodes = rt.DeviceNodeState(*(torch.from_numpy(np.asarray(a)).cuda() for a in block(
        n_pad, np.arange(n_pad) < n_real)))
    rows = rng.permutation(n_real)[:n_rows]
    flips = np.arange(n_real, n_real + 8)
    slots = 1024
    pads = np.full(slots - n_rows - len(flips), n_pad)
    pads[:4] = n_pad + rng.integers(1, 100, 4)
    idx = np.concatenate([rows, flips, pads]).astype(np.int32)
    valid = np.concatenate([np.ones(n_rows, bool), np.ones(len(flips), bool),
                            np.zeros(len(pads), bool)])
    updates = tuple(torch.from_numpy(np.asarray(a)).cuda() for a in block(slots, valid))
    return nodes, torch.from_numpy(idx).cuda(), updates


def _clone_nodes(nodes):
    from kubetpu_torch.framework import runtime as rt

    return rt.DeviceNodeState(*(getattr(nodes, n).clone() for n in rt.NODE_FIELDS))


def _nodes_err(a, b) -> int:
    from kubetpu_torch.framework import runtime as rt

    return max(_max_abs(getattr(a, n), getattr(b, n)) for n in rt.NODE_FIELDS)


def basic_delta(cache, pending):
    """A SchedulingBasic resident block on the card after the cycle's own
    delta refresh: the first encode uploads the block, the pending pods
    are then bound onto distinct nodes (1024 dirty rows) and the second
    encode ships them in its packed upload and scatters them. Returns
    ``(resident, shipped, first, second)``: ``shipped`` the tensors the
    block's ``scatter`` took (the delta's ``DELTA_FIELDS`` views among
    them), ``first`` / ``second`` the two encoded batches."""
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.framework import runtime as rt

    resident = rt.ResidentNodeState("cuda")
    snap = cache.update_snapshot()
    first = rt.encode_batch(snap, pending, C.Profile(), resident=resident, device="cuda")
    for j, p in enumerate(pending):
        cache.add_pod(p.with_node(first.node_names[(7 * j) % first.num_nodes]))
    snap = cache.update_snapshot(snap)
    shipped: dict = {}
    scatter = resident.scatter

    def grab(tensors):
        shipped.update(tensors)
        scatter(tensors)

    resident.scatter = grab
    second = rt.encode_batch(snap, pending, C.Profile(), prev_nt=first.node_tensors,
                             resident=resident, device="cuda")
    resident.scatter = scatter
    return resident, shipped, first, second


def _packed(nodes_idx, updates):
    """``DELTA_FIELDS`` arrays of an index and six update rows (tensors),
    packed into one buffer on the card as the cycle's upload packs them."""
    from kubetpu_torch.framework import runtime as rt

    arrays = [nodes_idx, *updates]
    return rt.upload_packed(dict(zip(rt.DELTA_FIELDS, (a.cpu().numpy() for a in arrays))),
                            "cuda")


def scatter_checks(results) -> dict:
    """Phase 3's B5 checks, each exact against ``scatter_node_rows_plain``
    (every buffer): ``scatter_rows`` through a block's launch plan on a
    seeded resident block, the delta packed as the cycle packs it; a plan
    of a replaced block raises and writes
    nothing; then a Basic cluster's resident block after the cycle's delta
    refresh (1024 pods bound onto distinct nodes) against a full upload of
    the same NodeTensors. Returns the timing entry: the block's
    ``scatter`` of that delta (the cycle's call), the plain version and six
    ``index_copy_`` calls on the in-range rows (the library yardstick) on
    the same delta, and the bytes of the bound: the index read once, the
    in-range slots' update rows read once and their block rows written
    once (a pad slot's row is never read)."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.framework import runtime as rt

    nodes, idx, updates = scatter_block()
    got, want = _clone_nodes(nodes), _clone_nodes(nodes)
    kernels.ScatterLaunch(got).scatter(_packed(idx, updates))
    rt.scatter_node_rows_plain(want, idx, updates)
    torch.cuda.synchronize()
    err = _nodes_err(got, want)
    if err or not torch.equal(got.node_valid, want.node_valid):
        raise AssertionError(f"scatter_rows differs from the plain version (max abs err {err})")
    results["scatter_rows"]["cases"].append("seeded block 1024 slots x 5120 rows")
    log("kernels vs plain [scatter_rows 1024 slots into 5120x3, packed as the cycle packs "
        "a delta]: exact")

    # a delta refresh against a full upload, through the cycle's own path
    cache, pending = basic_case()
    launches = kernels.launch_counts["scatter_rows"]
    resident, shipped, first, second = basic_delta(cache, pending)
    full = rt.encode_batch(cache.update_snapshot(), pending, C.Profile(), device="cuda")
    torch.cuda.synchronize()
    if kernels.launch_counts["scatter_rows"] != launches + 1:
        raise AssertionError("the delta refresh did not launch scatter_rows")
    err_r = _nodes_err(second.device.nodes, full.device.nodes)
    if err_r:
        raise AssertionError(f"resident block after a delta refresh differs from a full "
                             f"upload (max abs err {err_r})")
    results["scatter_rows"]["cases"].append("Basic delta refresh vs full upload")
    results["scatter_rows"]["max_abs_err"] = max(err, err_r)
    log(f"resident block after a delta refresh ({second.node_upload_bytes} bytes against "
        f"a {second.resident_bytes}-byte block) equals a full upload: exact")

    # a plan outlived by its block: the next full upload replaces the block
    stale = resident.plans[0]
    old = resident.device
    before = _clone_nodes(old)
    resident._full_upload(second.node_tensors, second.num_nodes)
    try:
        stale.scatter(shipped)
    except rt.StalePlan:
        pass
    else:
        raise AssertionError("a replaced block's scatter plan did not raise")
    torch.cuda.synchronize()
    if _nodes_err(old, before) or not torch.equal(old.node_valid, before.node_valid):
        raise AssertionError("a replaced block's scatter plan wrote into the block")
    results["scatter_rows"]["cases"].append("a replaced block's plan raises, no write")
    log("scatter_rows: a replaced block's plan raises and writes nothing")

    didx = shipped[rt.DELTA_FIELDS[0]]
    ups = tuple(shipped[n] for n in rt.DELTA_FIELDS[1:])
    block = resident.device
    in_range = (didx >= 0) & (didx < block.alloc.shape[0])
    rows = didx[in_range].long()
    kept = tuple(u[in_range] for u in ups)

    def library():
        for name, u in zip(rt.NODE_FIELDS, kept):
            getattr(block, name).index_copy_(0, rows, u)

    M, R = didx.shape[0], block.alloc.shape[1]
    row_bytes = 3 * 8 * R + 4 + 4 + 1
    n_in = int(in_range.sum().item())
    bytes_moved = 4 * M + 2 * n_in * row_bytes
    return {
        "ms": cuda_ms(lambda: resident.scatter(shipped), 50),
        "plain_ms": cuda_ms(lambda: rt.scatter_node_rows_plain(block, didx, ups), 20),
        "library_ms": cuda_ms(library, 50),
        "bytes": bytes_moved, "ops": 0, "shape": [M, block.alloc.shape[0]],
    }


# ------------------------------------------------ 3b. preemption (B9, B1n)
def preemption_case(n_nodes=5000, n_pending=1024, n_nominated=64, seed=0):
    """A PreemptionAsync-shaped cycle with nominations: node_default nodes
    each holding four pod_low_priority pods (3.6 of 4 cpu), a batch of
    pod_high_priority_3cpu preemptors, pod_default pods and a few
    priority-5 pods with a host port, and ``n_nominated`` nominations: half
    of batch pods, half of 3-cpu pods outside the batch (some holding the
    same host port), each on a random node. Returns ``(cache, pending,
    nominator)``."""
    import numpy as np

    from kubetpu_torch.api.wrappers import make_pod
    from kubetpu_torch.perf import workloads as W
    from kubetpu_torch.queue.nominator import Nominator

    rng = np.random.default_rng(seed)
    nodes = [W.node_default(i) for i in range(n_nodes)]
    bound = [W.pod_low_priority(f"low-{j}", "init").with_node(nodes[j % n_nodes].name)
             for j in range(4 * n_nodes)]
    pending = []
    for j in range(n_pending):
        kind = j % 8
        if kind == 0:
            pending.append(W.pod_high_priority_3cpu(f"high-{j}", "churn"))
        elif kind == 1:
            pending.append(make_pod(f"mid-{j}", namespace="m", cpu_milli=100,
                                    memory=500 * 1024**2, priority=5, host_ports=[8080]))
        else:
            pending.append(W.pod_default(f"d-{j}", "m"))
    nom = Nominator()
    half = n_nominated // 2
    for j in rng.choice(n_pending, size=half, replace=False):
        nom.add(pending[int(j)], nodes[int(rng.integers(0, n_nodes))].name)
    for g in range(n_nominated - half):
        kw = {"host_ports": [8080]} if g % 2 else {}
        nom.add(make_pod(f"nominee-{g}", namespace="churn", cpu_milli=3000,
                         memory=500 * 1024**2, priority=10, **kw),
                nodes[int(rng.integers(0, n_nodes))].name)
    return _cache_with(nodes, bound), pending, nom


def encode_batch_full(cache, pending, profile, nominated=()):
    """The EncodedBatch (the evaluator needs its host half too) and its
    params, on the card."""
    from kubetpu_torch.framework import runtime as rt

    # no nominated= without nominations: --time-basic ROOT encodes with
    # checkouts that predate it
    kw = {"nominated": nominated} if nominated else {}
    batch = rt.encode_batch(cache.update_snapshot(), pending, profile, device="cuda", **kw)
    return batch, rt.score_params(profile, batch.resource_names)


def victim_tensors(seed, N, K, D, R=3, Kp=4, pod_prio=25):
    """Seeded arguments of dry_run_preemption on the card: N nodes of K
    victim slots, D PDBs, Kp port triples; priorities and start times from
    small sets, so equal (priority, start) pairs are common."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    v_valid = rng.random((N, K)) < 0.8
    v_prio = (rng.integers(0, 4, (N, K)) * 10).astype(np.int64)
    v_start = rng.integers(0, 3, (N, K)).astype(np.int64)
    v_req = (rng.integers(0, 400, (N, K, R)) * v_valid[:, :, None]).astype(np.int64)
    # about one holder of each triple a node, whatever K: a triple the
    # preemptor wants that a higher-priority pod holds leaves no candidate
    v_ports = ((rng.random((N, K, Kp)) < min(0.15, 1.0 / K))
               & v_valid[:, :, None]).astype(np.int8)
    v_pdb = (rng.random((N, K, D)) < 0.3) & v_valid[:, :, None]
    requested = v_req.sum(1) + rng.integers(0, 100, (N, R))
    alloc = requested + rng.integers(0, 300, (N, R))
    pod_count = (v_valid.sum(1) + rng.integers(0, 2, N)).astype(np.int32)
    allowed = (pod_count + rng.integers(0, 3, N)).astype(np.int32)
    port_counts = (v_ports.sum(1) + (rng.random((N, Kp)) < 0.1)).astype(np.int32)
    pdb_allowed = rng.integers(0, 3, D).astype(np.int64)
    pod_req = rng.integers(0, 700, R).astype(np.int64)
    wants = rng.random(Kp) < 0.3
    potential = rng.random(N) < 0.8
    arrays = (pod_req, pod_prio, wants, potential, alloc, requested, pod_count, allowed,
              port_counts, v_valid, v_prio, v_start, v_req, v_ports, v_pdb, pdb_allowed)
    return tuple(a if isinstance(a, int) else torch.from_numpy(a).cuda() for a in arrays)


def dry_run_nbytes(args) -> int:
    """Bytes the dry run must move: each tensor input read once, the
    (N, K) victims, (N,) ok, (N,) n_pdb and the node index written once."""
    N, K = args[9].shape
    ins = sum(int(a.nbytes) for a in args if not isinstance(a, int))
    return ins + N * K + N + 8 * N + 4


def _dry_run_equal(name, args) -> tuple[int, dict]:
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.ops import preemption as OP

    got = kernels.dry_run_preemption(*args)
    want = OP.dry_run_preemption_plain(*args)
    torch.cuda.synchronize()
    err = 0
    for what, g, w in zip(("node", "victims", "ok", "n_pdb"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name}: dry_run_preemption {what} is {g.dtype} "
                                 f"{tuple(g.shape)}, plain {w.dtype} {tuple(w.shape)}")
        err = max(err, _max_abs(g.reshape(-1), w.reshape(-1)))
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: dry_run_preemption {what} differs from the "
                                 f"plain version (max abs err {err})")
    info = {"node": int(got[0]), "candidates": int(got[2].sum().item()),
            "victims": int(got[1][int(got[0])].sum().item()) if int(got[0]) >= 0 else 0}
    log(f"kernels vs plain [{name}]: exact (node {info['node']}, "
        f"{info['candidates']} candidate nodes, {info['victims']} victims)")
    return err, info


def preemption_checks(results) -> dict:
    """Phase 3's preemption checks, on CUDA tensors, all exact:

    - ``dry_run_preemption`` against ``dry_run_preemption_plain`` on seeded
      5120-node victim tensors with PreemptionAsync's K = 8 slots, K = 128
      and K = 130, D = 1, 3 and 5 PDBs, host ports;
    - ``filter_score``, the ``greedy_scan`` engine and the ``batched_round``
      rounds against their plain versions on a PreemptionAsync-shaped
      1024 x 5120 cycle with 64 nominations (B1n in the pair function);
    - ``filter_score``'s potential mode against the plain potential mask
      (``PreemptionEvaluator._potential_mask_plain``) for failed pods of
      that cycle, and for pods of the mixed spread and affinity clusters.

    Returns the timings: the dry run at both K (kernel, plain, bound), the
    nominated cycle's ``filter_score`` against the same batch without its
    nominations, and the potential mask (kernel, plain)."""
    import dataclasses

    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.framework import runtime as rt
    from kubetpu_torch.framework.preemption import PreemptionEvaluator
    from kubetpu_torch.ops import preemption as OP

    out = {}
    err = 0
    for name, (K, D, seed) in (("K=8", (8, 3, 0)), ("K=128", (128, 5, 1)),
                               ("", (8, 1, 2)), ("", (8, 5, 3)), ("", (128, 1, 4)),
                               ("", (130, 1, 5)), ("", (130, 5, 6))):
        args = victim_tensors(seed, 5120, K, D)
        e, info = _dry_run_equal(f"dry_run_preemption {args[9].shape[0]} nodes x {K} "
                                 f"slots, D={D}", args)
        if info["candidates"] < 1:
            raise AssertionError(f"dry_run_preemption 5120x{K} D={D}: the seeded tensors "
                                 "leave no candidate node")
        err = max(err, e)
        results["dry_run_preemption"]["cases"].append(f"5120x{K} D={D}")
        if not name:
            continue
        bound_ms, bound_by = _bound(dry_run_nbytes(args), 0)
        out[name] = {
            "ms": cuda_ms(lambda: kernels.dry_run_preemption(*args), 20),
            "plain_ms": cuda_ms(lambda: OP.dry_run_preemption_plain(*args), 2),
            "bytes": dry_run_nbytes(args), "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": [5120, K], **info,
        }
    results["dry_run_preemption"]["max_abs_err"] = err

    # a PreemptionAsync-shaped cycle with nominations through all three
    # kernels (the nominated fit and ports of the pair function)
    cache, pending, nom = preemption_case()
    batch, params = encode_batch_full(cache, pending, C.Profile(), nom.entries())
    b = batch.device
    if b.nominated_gate is None or not bool(b.nominated_gate.any()):
        raise AssertionError("the nominated cycle carries no live nomination gate")
    ka = check_case(f"PreemptionAsync {b.requests.shape[0]}x{b.alloc.shape[0]}, "
                    f"{len(nom)} nominations", b, params, results)
    bare = dataclasses.replace(b, **{f: None for f in rt.POD_FIELDS
                                      if f.startswith("nominated_")})
    P, N = b.requests.shape[0], b.alloc.shape[0]
    out["nominated"] = {
        "batch": f"PreemptionAsync {P}x{N}, G={len(nom)}",
        "ms": cuda_ms(lambda: kernels.filter_score(b, params), 20),
        "plain_ms": cuda_ms(lambda: rt.feasible_and_scores(b, params), 5),
        "without_nominations_ms": cuda_ms(lambda: kernels.filter_score(bare, params), 20),
        "bytes": rt.batch_nbytes(b) + P * N * (1 + 8),
        "ops": scored_pods(b) * N * f64_ops_per_pair(params, b),
    }
    out["nominated"]["bound_ms"], out["nominated"]["bound_by"] = _bound(
        out["nominated"]["bytes"], out["nominated"]["ops"])

    # the potential mask: kernel mode against the plain composition
    def potential_equal(label, batch, params, pods):
        ka_, ks = kernels.greedy_scan(batch.device, params)
        ev = PreemptionEvaluator(
            batch, params, requested=ks[0], pod_count=ks[2], spread_counts=ks[4],
            pa_sums=ks[5], nominated_active=ks[6])
        up = ev._upload(ev._potential_arrays())
        worst, resolvable = 0, 0
        for i in pods:
            got = ev._potential_mask(i, up)
            want = ev._potential_mask_plain(i, up)
            torch.cuda.synchronize()
            worst = max(worst, _max_abs(got, want))
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: potential mask of pod {i} differs from "
                                     f"the plain version")
            resolvable += int(got.sum().item())
        results["filter_score"]["cases"].append(f"potential mask: {label}")
        log(f"kernels vs plain [potential mask, {label}]: exact on {len(pods)} pods "
            f"({resolvable} resolvable node verdicts)")
        return ev, up

    out["explain"] = (f"PreemptionAsync {len(nom)} nominations", b, params, ka)
    failed = [i for i, j in enumerate(ka[: batch.num_pods].cpu().tolist()) if j < 0]
    ev, up = potential_equal(f"PreemptionAsync {len(nom)} nominations", batch, params,
                             failed[:24])
    i0 = failed[0]
    out["potential"] = {
        "batch": f"PreemptionAsync 1x{N}",
        "ms": cuda_ms(lambda: ev._potential_mask(i0, up), 20),
        "plain_ms": cuda_ms(lambda: ev._potential_mask_plain(i0, up), 5),
    }
    for label, case, prof in (
        ("mixed spread", spread_case(seed=3, n_nodes=1000, n_bound=1500, n_pending=128),
         spread_profiles()["spread"]),
        ("mixed affinity", affinity_case(seed=2, n_nodes=1000, n_bound=1500, n_pending=128),
         C.Profile()),
    ):
        bt, pt = encode_batch_full(*case, prof)
        potential_equal(label, bt, pt, list(range(0, bt.num_pods, 8)))
    return out


# ------------------------------- 3c. the explain path (B10), extender terms
def with_extender(b, seed=0, weight=5):
    """``b`` with a seeded extender mask and score on the card, shaped as
    ``run_extenders`` returns them: about 30% of the real (pod, node)
    pairs false, an eighth of the real pods' rows all false and a few
    rows passing one or two nodes only, pads false; the score raw (0..10)
    x weight x MaxNodeScore / MaxExtenderPriority."""
    import dataclasses

    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    P, N = b.requests.shape[0], b.alloc.shape[0]
    n_pods = int(b.pod_valid.sum().item())
    n_nodes = int(b.node_valid.sum().item())
    mask = np.zeros((P, N), dtype=bool)
    mask[:n_pods, :n_nodes] = rng.random((n_pods, n_nodes)) >= 0.3
    rows = rng.choice(n_pods, size=max(3, n_pods // 8 + 4), replace=False)
    mask[rows] = False
    for i, r in enumerate(rows[:4]):
        mask[r, rng.choice(n_nodes, size=1 + i % 2, replace=False)] = True
    score = np.zeros((P, N), dtype=np.int64)
    score[:n_pods, :n_nodes] = rng.integers(0, 11, (n_pods, n_nodes)) * (weight * 100 // 10)
    dev = b.alloc.device
    return dataclasses.replace(b, extender_mask=torch.from_numpy(mask).to(dev),
                               extender_score=torch.from_numpy(score).to(dev))


def _masks_equal(name, b, params, rows, results) -> tuple:
    """Hold ``filter_component_masks`` on pod rows ``rows`` (None: all) to
    ``filter_component_masks_rows_plain``: the packed bits and which
    components are present; raises unless equal. Returns ``(max abs err,
    present)``."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.sched.flightrecorder import filter_component_masks_rows_plain

    got, present = kernels.filter_component_masks(b, params, rows)
    want, want_present = filter_component_masks_rows_plain(b, params, rows)
    torch.cuda.synchronize()
    if present != want_present:
        raise AssertionError(f"{name}: component masks present {present}, plain "
                             f"{want_present}")
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: component bits {got.dtype} {tuple(got.shape)}, plain "
                             f"{want.dtype} {tuple(want.shape)}")
    err = _max_abs(got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: component bits differ from the plain version "
                             f"({int((got != want).sum().item())} bytes)")
    results["filter_component_masks"]["cases"].append(
        f"{name}, {'all' if rows is None else len(rows)} rows")
    results["filter_component_masks"]["max_abs_err"] = max(
        results["filter_component_masks"]["max_abs_err"], err)
    return err, present


def _explain_equal(name, b, params, idx, results) -> dict:
    """Hold ``explain_summary`` and ``filter_component_masks`` to their
    plain versions on one batch with the engine's assignments ``idx`` (the
    masks on every row, and on the unassigned pods' rows, every seventh
    pod where none is); raises unless every output is equal. Returns the
    summary's facts."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.sched.flightrecorder import explain_summary_plain

    got = kernels.explain_summary(b, params, idx)
    want = explain_summary_plain(b, params, idx)
    torch.cuda.synchronize()
    flat_got = [got[0], *got[1], *got[2:]]
    flat_want = [want[0], *want[1], *want[2:]]
    err = 0
    for i, (g, w) in enumerate(zip(flat_got, flat_want)):
        if (g is None) != (w is None):
            raise AssertionError(f"{name}: explain_summary output {i} differs in presence")
        if g is None:
            continue
        err = max(err, _max_abs(g, w))
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{name}: explain_summary output {i} differs from the "
                                 f"plain version (max abs err {err})")
    results["explain_summary"]["cases"].append(name)
    results["explain_summary"]["max_abs_err"] = max(
        results["explain_summary"]["max_abs_err"], err)
    unassigned = [i for i, j in enumerate(idx.tolist()) if j < 0]
    for rows in (None, unassigned or list(range(0, b.requests.shape[0], 7))):
        _, present = _masks_equal(name, b, params, rows, results)
    n_pods = int(b.pod_valid.sum().item())
    feas = got[0][:n_pods]
    facts = {
        "pods": n_pods,
        "no_feasible": int((feas == 0).sum().item()),
        "one_feasible": int((feas == 1).sum().item()),
        "two_feasible": int((feas == 2).sum().item()),
        "unassigned": int((idx[:n_pods] < 0).sum().item()),
        "components": list(present),
    }
    log(f"kernels vs plain [explain, {name}]: explain_summary and "
        f"filter_component_masks exact ({facts})")
    return facts


def explain_checks(results, batches) -> dict:
    """Phase 3's B10 checks on each (name, batch, params, assignments):
    exact; the batches must hold unassigned pods (the saturated one) and
    rows with no feasible node, with one and with two (the extender
    batches), the top-3 edge cases. ``filter_component_masks`` is also
    held on row 0 of a 4-pod Basic batch (the bridge's call). Returns the
    Basic batch's timings: both wrappers on every row, their plain
    versions, and their bounds (the masks': the batch read once and the
    (P, N) packed bytes written; the five (P, N) masks of the parent's
    design beside it); ``explain_summary`` on the same batch with every
    pod a class of its own (``singletons_ms``, the webhook paths' shape);
    and the masks as their callers take them (``masks_calls``)."""
    import dataclasses

    from kubetpu_torch import kernels
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.framework import runtime as rt
    from kubetpu_torch.sched.flightrecorder import (
        explain_summary_plain,
        filter_component_masks_rows_plain,
    )

    seen = {"no_feasible": 0, "one_feasible": 0, "two_feasible": 0, "unassigned": 0}
    for name, b, params, idx in batches:
        facts = _explain_equal(name, b, params, idx, results)
        for k in seen:
            seen[k] += facts[k]
    if not all(seen.values()):
        raise AssertionError(f"the explain batches miss an edge case: {seen}")
    small, small_params = encode(*basic_case(n_pending=4), C.Profile())
    _masks_equal("SchedulingBasic 4 pods", small, small_params, [0], results)
    name, b, params, idx = batches[0]
    P, N = b.requests.shape[0], b.alloc.shape[0]
    n_comp = sum(kernels.filter_component_masks(b, params)[1])
    # explain_summary(b, params, idx): reads the batch and the assignments
    # once, writes 40 bytes a pod (feasible, five counts, top 3, win);
    # its float64 work is the total's, on one pod a class (scored_pods)
    singles = dataclasses.replace(b)
    summary = {
        "ms": cuda_ms(lambda: kernels.explain_summary(b, params, idx), 20),
        "plain_ms": cuda_ms(lambda: explain_summary_plain(b, params, idx), 5),
        "bytes": rt.batch_nbytes(b) + P * 4 + P * (4 + 5 * 4 + 3 * (8 + 4) + 8),
        "ops": scored_pods(b) * N * f64_ops_per_pair(params, b), "shape": [P, N],
        "classes": scored_pods(b),
        "singletons_ms": cuda_ms(lambda: kernels.explain_summary(singles, params, idx), 20),
    }
    masks = {
        "ms": cuda_ms(lambda: kernels.filter_component_masks(b, params), 20),
        "plain_ms": cuda_ms(lambda: filter_component_masks_rows_plain(b, params), 5),
        "bytes": rt.batch_nbytes(b) + P * N, "ops": 0, "shape": [P, N],
        "five_masks_bytes": rt.batch_nbytes(b) + P * N * n_comp,
        "masks_calls": masks_calls(b, params),
    }
    return {"explain_summary": summary, "filter_component_masks": masks}


def masks_as_recorder(b, params, rows):
    """The recorder's component masks for pods ``rows`` as its cycle takes
    them (``note_cycle`` then ``_resolve_pending``): the launch, the copy
    into pinned memory and the wait for it. A checkout from before the
    packed rows computes its five (P, N) masks and copies the rows'
    ``index_select`` of each."""
    import inspect

    import torch

    from kubetpu_torch.sched import flightrecorder as FR

    if len(inspect.signature(FR._explain_masks_kernel).parameters) == 3:
        bits, _ = FR._explain_masks_kernel(b, params, rows)
        return FR._Fetch((bits,)).get()
    sel = torch.as_tensor(rows, device=b.device)
    return FR._Fetch(tuple(None if c is None else c.index_select(0, sel)
                           for c in FR._explain_masks_kernel(b, params))).get()


def masks_calls(b, params) -> dict:
    """CUDA-event medians (ms) of the component masks as their callers take
    them: the recorder's launch and fetch for one unschedulable pod of
    batch ``b`` (``masks_as_recorder``, its last pod's row), and the bridge's
    ``ExtenderBackend._components`` on a one-pod request's batch (row 0,
    copied to the host)."""
    from kubetpu_torch.bridge.server import ExtenderBackend
    from kubetpu_torch.framework import config as C

    one, one_params = encode(*basic_case(n_pending=1), C.Profile())
    return {
        "recorder_ms": cuda_ms(
            lambda: masks_as_recorder(b, params, [b.requests.shape[0] - 1]), 50),
        "bridge_ms": cuda_ms(lambda: ExtenderBackend._components(None, one, one_params), 50),
        "bridge_shape": [one.requests.shape[0], one.alloc.shape[0]],
    }


def extender_checks(results, basic, mixed) -> dict:
    """``filter_score``, ``greedy_scan`` and ``batched_round`` against their
    plain versions on the Basic batch and the mixed cluster with seeded
    extender leaves; the mixed cluster's node-affinity and taint
    preferences make the normalize run over the shrunk mask. Returns the
    Basic batch's kernel times with and without the leaves, and the
    extender batches (for the explain checks)."""
    from kubetpu_torch import kernels

    out = []
    for name, (b, params), seed in (("SchedulingBasic 1024x5120 + extender", basic, 5),
                                    ("mixed/least + extender", mixed, 6)):
        be = with_extender(b, seed=seed)
        ka = check_case(name, be, params, results)
        out.append((name, be, params, ka))
    b, params = basic
    be = out[0][1]
    timing = {
        "filter_score_ms": cuda_ms(lambda: kernels.filter_score(be, params), 20),
        "filter_score_without_ms": cuda_ms(lambda: kernels.filter_score(b, params), 20),
        "greedy_scan_ms": cuda_ms(lambda: kernels.greedy_scan(be, params), 10),
        "greedy_scan_without_ms": cuda_ms(lambda: kernels.greedy_scan(b, params), 10),
    }
    log(f"timing [extender terms] on the SchedulingBasic batch: filter_score "
        f"{timing['filter_score_ms']:.4f} ms with the leaves, "
        f"{timing['filter_score_without_ms']:.4f} without; greedy_scan "
        f"{timing['greedy_scan_ms']:.4f} / {timing['greedy_scan_without_ms']:.4f} ms")
    return {"timing": timing, "batches": out}


class SteppedClock:
    """A clock the driver advances by hand (backoff and flush timers)."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


STEPPED = {"n_nodes": 500, "n_preemptors": 256, "n_default": 300, "calls": 24}


def stepped_preemption_run(device: str, n_nodes: int, n_preemptors: int, n_default: int,
                           calls: int) -> dict:
    """A seeded preempt-then-schedule scenario under a stepped clock:
    ``n_nodes`` node_default nodes each filled to 3.6 cpu by four
    pod_low_priority pods, then ``n_preemptors`` pod_high_priority_3cpu pods
    and ``n_default`` pod_default pods arrive at once; ``calls`` cycles,
    the informer events delivered after each and the clock advanced 0.75 s.
    Returns the bound map, the victims (name, reason), the nominations,
    the metrics and the flight recorder's records without their timing
    fields."""
    from kubetpu_torch.perf import workloads as W
    from kubetpu_torch.perf.runner import _Client
    from kubetpu_torch.sched import Scheduler

    client, clock = _Client(), SteppedClock()
    sched = Scheduler(client, device=device, clock=clock)
    client.sched = sched
    sched.enable_preemption()
    for i in range(n_nodes):
        sched.on_node_add(W.node_default(i))
    for j in range(4 * n_nodes):
        sched.on_pod_add(W.pod_low_priority(f"low-{j}", "init").with_node(
            f"scheduler-perf-{j % n_nodes}"))
    for j in range(n_preemptors):
        sched.on_pod_add(W.pod_high_priority_3cpu(f"high-{j}", "churn"))
    for j in range(n_default):
        sched.on_pod_add(W.pod_default(f"d-{j}", "m"))
    for _ in range(calls):
        sched.schedule_batch()
        client.deliver()
        clock.t += 0.75
    return {
        "bound": dict(client.bound),
        "victims": [(p.name, reason) for p, reason in client.deleted],
        "nominated": [(p.name, node) for p, node in client.nominated],
        "attempts": sched.metrics.preemption_attempts,
        "evictions": sched.metrics.preemption_victims,
        "records": [
            {k: v for k, v in r.items()
             if k not in ("encode_s", "kernel_s", "queue_wait_s", "stages_ms")}
            for r in sched.flight_recorder.records_json(limit=1 << 20)["records"]
        ],
    }


def stepped_preemption_phase() -> dict:
    """The stepped scenario on ``cuda`` (launch counts read around it) and
    on ``cpu`` (the plain versions): the bound maps, victims, nominations
    and the flight recorder's records (every breakdown: the card's
    explain, resolved a cycle later, against the plain one of the cycle
    start) must be equal, every preemptor bound, and every victim of
    priority 0."""
    from kubetpu_torch import kernels

    gc.collect()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    gpu = stepped_preemption_run("cuda", **STEPPED)
    t1 = time.perf_counter()
    launches = dict(kernels.launch_counts)
    cpu = stepped_preemption_run("cpu", **STEPPED)
    t2 = time.perf_counter()
    for key in ("bound", "victims", "nominated", "attempts", "evictions", "records"):
        if gpu[key] != cpu[key]:
            raise AssertionError(f"stepped preemption: {key} on cuda differs from cpu")
    highs = sum(1 for name in gpu["bound"] if name.startswith("high-"))
    if highs != STEPPED["n_preemptors"] or not gpu["victims"]:
        raise AssertionError(f"stepped preemption: {highs} of {STEPPED['n_preemptors']} "
                             f"preemptors bound, {len(gpu['victims'])} victims")
    if launches["dry_run_preemption"] < 1:
        raise AssertionError("stepped preemption never launched dry_run_preemption")
    line = {"stepped_preemption": {
        "nodes": STEPPED["n_nodes"], "preemptors": STEPPED["n_preemptors"],
        "bound": len(gpu["bound"]),
        "victims": len(gpu["victims"]), "nominations": len(gpu["nominated"]),
        "records": len(gpu["records"]),
        "attempts": gpu["attempts"], "equal_cuda_cpu": True,
        "cuda_s": t1 - t0, "cpu_s": t2 - t1, "launches": launches,
    }}
    log(json.dumps(line))
    return launches


def preemption_check(sched) -> dict:
    """PreemptionAsync's own checks: at least one preemption nominated a
    node, and every victim had a lower priority than the preemptor that
    evicted it."""
    client = sched.client
    if not client.nominated:
        raise AssertionError("PreemptionAsync: no preemption succeeded")
    prio = {f"{p.namespace}/{p.name}": p.priority for p, _ in client.nominated}
    for victim, reason in client.deleted:
        key = reason[len("preempted by "):]
        if key not in prio or not victim.priority < prio[key]:
            raise AssertionError(f"PreemptionAsync: victim {victim.name} (priority "
                                 f"{victim.priority}) of {key!r}")
    return {"nominations": len(client.nominated), "evictions": len(client.deleted)}


# --------------------------------- 3d. the gang lane (B11, B12, B13)
SLICES = 32
# the placements a phase-4 path's first placement search is held to the
# plain search on (the first 2; phase 3 holds 1 slice and <all>), and the
# gang dry run's hypotheses phase 3 holds to the plain dry run (the first 2
# of 32): each placement and each hypothesis is searched on its own, and
# the whole plain searches took ~100 s a path and 28 s (cut, to keep the
# run's time, from 5 placements, ~3 s each, then from 3, and from 4
# hypotheses)
PLAIN_PLACEMENTS = 2
GANG_PLAIN = 2


def sliced(cache, slices):
    """The cache's nodes (in order) relabeled with ``slices`` TPU slices
    and a rack per four under the shared grammar, with the same pods."""
    import dataclasses

    from kubetpu_torch.perf import workloads as W

    infos = cache.update_snapshot().node_infos()
    nodes = [
        dataclasses.replace(info.node, labels=tuple(sorted(
            {**info.node.labels_dict(),
             **W.trace_topology_labels(info.node.name, slices)}.items())))
        for info in infos
    ]
    out = _cache_with(nodes, [p for info in infos for p in info.pods.values()])
    for svc in cache._services.values():
        out.add_service(svc)
    return out


def slice_masks(batch):
    """The placements the gang lane generates on a sliced cluster
    (``sched.podgroup.generate_placements``): one (N,) mask per slice in
    sorted order, then ``<all>``. Returns ``(masks (D, N) bool on the card,
    names)``."""
    import numpy as np
    import torch

    from kubetpu_torch.state.topology import SLICE_KEY

    rows: dict = {}
    for i, info in enumerate(batch.node_tensors.infos):
        val = info.node.labels_dict().get(SLICE_KEY)
        if val is not None:
            rows.setdefault(val, []).append(i)
    names = sorted(rows)
    masks = np.zeros((len(names) + 1, batch.device.alloc.shape[0]), dtype=bool)
    for d, val in enumerate(names):
        masks[d, rows[val]] = True
    masks[-1, :batch.num_nodes] = True
    return torch.from_numpy(masks).cuda(), [f"slice:{v}" for v in names] + ["<all>"]


def encode_topology(cache, pending, profile):
    """The batch (``topology="on"``: the slice leaf attached) and params."""
    from kubetpu_torch.framework import runtime as rt

    batch = rt.encode_batch(cache.update_snapshot(), pending, profile, device="cuda",
                            topology="on")
    return batch, rt.score_params(profile, batch.resource_names)


def gang_victims_case(n_nodes=5000, n_pending=256, seed=0):
    """The gang dry run's inputs: node_default nodes in 32 slices, each
    holding four pod_low_priority pods (3.6 of 4 cpu), a preemptor gang of
    2-cpu pods, and one hypothesis a slice whose freed rows return one to
    four of those pods on about half the slice's nodes, and on a few nodes
    more than the node holds (the clamp at 0)."""
    import numpy as np
    import torch

    from kubetpu_torch.api.wrappers import make_pod
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.perf import workloads as W

    rng = np.random.default_rng(seed)
    nodes = [W.node_default(i, (), SLICES) for i in range(n_nodes)]
    bound = [W.pod_low_priority(f"low-{j}", "init").with_node(nodes[j % n_nodes].name)
             for j in range(4 * n_nodes)]
    pending = [make_pod(f"train-{j}", namespace="train", cpu_milli=2000,
                        memory=500 * 1024**2, priority=10, scheduling_group="train",
                        creation_index=j) for j in range(n_pending)]
    batch, params = encode_topology(_cache_with(nodes, bound), pending, C.Profile())
    masks, _ = slice_masks(batch)
    masks = masks[:-1]                                  # the 32 slices
    c, (nc, r) = masks.shape[0], batch.device.alloc.shape
    on = masks.cpu().numpy() & (rng.random((c, nc)) < 0.5)
    pod = np.array([900, 500 * 1024**2] + [0] * (r - 2), dtype=np.int64)
    k = rng.integers(1, 5, (c, nc))
    fr = (k[:, :, None] * pod[None, None, :]) * on[:, :, None]
    fc = (k * on).astype(np.int32)
    over = on & (rng.random((c, nc)) < 0.05)
    fr[over] += 10**12
    fc[over] += 100
    return batch, params, masks, torch.from_numpy(fr).cuda(), torch.from_numpy(fc).cuda()


def _rescored(assignments, start=(), class_of=None) -> int:
    """Pairs a scan recomputes beyond filter_score's start: at a step whose
    pod is of another class than the step before's (every step when
    ``class_of``, the batch's ``PodClasses.class_of``, is None), every node
    touched so far (freed nodes start touched); at any other step the node
    the pod before landed on (scan_loop.cuh keeps the others' verdicts)."""
    seen = set(start)
    n = 0
    prev = -1
    for p, j in enumerate(assignments):
        same = class_of is not None and p > 0 and class_of[p] == class_of[p - 1]
        n += int(prev >= 0) if same else len(seen)
        prev = j
        if j >= 0:
            seen.add(j)
    return n


def _class_of(b):
    """The batch's ``PodClasses.class_of``, None without classes."""
    from kubetpu_torch.framework import runtime as rt

    classes = rt.pod_classes(b)
    return None if classes is None else classes.class_of


def _hyp_bound(b, params, masks, assignments, freed=None) -> dict:
    """B11 / B13's bound, worked out as B4's: bytes = the batch read once,
    the masks (and freed rows) read once, each hypothesis's running state
    and assignments written once; f64 operations = the start pass over
    every scored (pod, node) pair (``scored_pods``) plus each hypothesis's
    recomputed touched pairs, at ``f64_ops_per_pair``."""
    from kubetpu_torch.framework import runtime as rt

    H, N = masks.shape
    P = b.requests.shape[0]
    state = sum(int(x.nbytes) for x in (b.requested, b.nonzero_requested, b.pod_count,
                                         b.node_ports))
    nbytes = rt.batch_nbytes(b) + int(masks.nbytes) + H * (state + 4 * P + 8)
    starts = [()] * H
    if freed is not None:
        nbytes += sum(int(x.nbytes) for x in freed)
        touched = ((freed[0] != 0).any(-1) | (freed[1] != 0)) & masks
        starts = [touched[h].nonzero().flatten().tolist() for h in range(H)]
    rescored = sum(_rescored(assignments[h], starts[h], _class_of(b)) for h in range(H))
    ops = (scored_pods(b) * N + rescored) * f64_ops_per_pair(params, b)
    bound_ms, bound_by = _bound(nbytes, ops)
    return {"bytes": nbytes, "ops": ops, "bound_ms": bound_ms, "bound_by": bound_by}


def timed(fn):
    """``fn()`` once between two CUDA events: ``(result, ms)``."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _equal_or_raise(name, got, want) -> int:
    """Raise unless the tensors of ``got`` equal those of ``want`` (a None
    only matches a None); return the largest absolute difference."""
    import torch

    if any((g is None) != (w is None) for g, w in zip(got, want)):
        raise AssertionError(f"{name}: kernel and plain version return different outputs")
    pairs = [(g, w) for g, w in zip(got, want) if g is not None]
    err = max(_max_abs(g, w) for g, w in pairs)
    if not all(torch.equal(g, w) for g, w in pairs):
        raise AssertionError(f"{name}: kernel differs from the plain version "
                             f"(max abs err {err})")
    return err


def gang_checks(results) -> dict:
    """Phase 3's gang-lane checks: ``placement_scan`` (B11, B12 fused)
    against ``placement_assign_plain`` on the SchedulingBasic block cut
    into 32 slices (P = 1000, D = 33; the plain search on 1 slice and
    ``<all>``), and on the mixed, affinity and
    spread clusters cut into 8 slices (D = 9; the plain search on 1 slice
    and ``<all>``), there also the batched engine's search;
    ``gang_dry_run_scan`` (B13) against ``dry_run_gang_preemption_plain``
    (its first GANG_PLAIN hypotheses) at C = 32 on a full sliced cluster
    with freed rows, some clamping at 0, on both engines; the batched
    engine's ``hypothesis_rows`` and ``slice_epilogue`` alone. Exact
    (assignments, counts, alignment, rows). Returns the three kernels'
    timings (kernel medians; the plain search's one checked run)."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.placement import (
        placement_assign_device,
        placement_assign_plain,
    )
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.ops.preemption import (
        dry_run_gang_preemption,
        dry_run_gang_preemption_plain,
    )

    def note(name, err, kernel="hypothesis_scan"):
        results[kernel]["cases"].append(name)
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)

    def note_batched(name, err):
        for kernel in ("hypothesis_rows", "slice_epilogue"):
            note(name, err, kernel)

    cache, pending = basic_case(n_pending=1000)
    b, params = encode_topology(sliced(cache, SLICES), pending, C.Profile())
    masks, _ = slice_masks(b)
    got = got_basic = kernels.placement_scan(b.device, params, masks)
    # the plain search of 1 slice and <all> (each placement's search is
    # independent of the others); phase 4's GangScheduling paths hold their
    # first search's first PLAIN_PLACEMENTS placements to the plain one
    sel = torch.tensor([0, masks.shape[0] - 1], device=masks.device)
    want, plain_ms = timed(lambda: placement_assign_plain(b.device, params, masks[sel]))
    note("SchedulingBasic placement",
         _equal_or_raise("placement_scan Basic", tuple(x[sel] for x in got), want))
    counts, align = got[1].tolist(), got[2].tolist()
    log(f"kernels vs plain [placement_scan SchedulingBasic]: P=1000 N="
        f"{b.device.alloc.shape[0]} D={masks.shape[0]} slices {b.device.topology.num_slices}: "
        f"exact on {len(sel)} placements (counts {min(counts)}..{max(counts)}, alignment "
        f"{min(align)}..{max(align)})")
    timing = {
        "ms": cuda_ms(lambda: kernels.placement_scan(b.device, params, masks), 5),
        "plain_ms": plain_ms, "plain_placements": len(sel),
        "shape": [1000, b.device.alloc.shape[0], masks.shape[0]],
        "filter_score_ms": cuda_ms(lambda: kernels.filter_score(b.device, params), 10),
        # where the time goes: the <all> placement alone, the 32 slices alone
        "all_only_ms": cuda_ms(lambda: kernels.placement_scan(b.device, params, masks[-1:]), 5),
        "slices_only_ms": cuda_ms(
            lambda: kernels.placement_scan(b.device, params, masks[:-1]), 5),
        "greedy_scan_ms": cuda_ms(lambda: kernels.greedy_scan(b.device, params), 5),
        **_hyp_bound(b.device, params, masks, got[0].tolist()),
    }
    for name, case, prof in (
        ("mixed", lambda: mixed_case(seed=5), C.Profile()),
        ("affinity", lambda: affinity_case(seed=6, n_pending=256),
         affinity_profiles()["default"]),
        ("spread", lambda: spread_case(seed=7), spread_profiles()["spread"]),
    ):
        cache_m, pending_m = case()
        bm, pm = encode_topology(sliced(cache_m, 8), pending_m, prof)
        mm, _ = slice_masks(bm)
        # the plain searches of 1 slice and <all> (each placement on its own)
        part = torch.tensor([0, mm.shape[0] - 1], device=mm.device)
        got = kernels.placement_scan(bm.device, pm, mm)
        want = placement_assign_plain(bm.device, pm, mm[part])
        note(f"{name} placement", _equal_or_raise(
            f"placement_scan {name}", tuple(x[part] for x in got), want))
        # the batched engine under the same placements: hypothesis_rows,
        # B3 + B6 a placement, slice_epilogue
        note_batched(f"{name} batched placement", _equal_or_raise(
            f"batched placement {name}",
            tuple(x[part] for x in placement_assign_device(bm.device, pm, mm, "batched")),
            placement_assign_plain(bm.device, pm, mm[part], "batched")))
        d = bm.device
        log(f"kernels vs plain [placement_scan {name}]: P={d.requests.shape[0]} "
            f"N={d.alloc.shape[0]} D={mm.shape[0]} spread "
            f"{'none' if d.spread is None else tuple(d.spread.domain_present.shape)} "
            f"affinity {'none' if d.podaffinity is None else tuple(d.podaffinity.base_sums.shape)}"
            f": exact on {len(part)} placements (counts {got[1].tolist()}); the batched "
            "engine's placements too")
    bg, pg, mg, fr, fc = gang_victims_case()
    got = kernels.gang_dry_run_scan(bg.device, pg, mg, fr, fc)
    # the plain dry run of the first GANG_PLAIN hypotheses (each on its own)
    want, gang_plain_ms = timed(lambda: dry_run_gang_preemption_plain(
        bg.device, pg, mg[:GANG_PLAIN], fr[:GANG_PLAIN], fc[:GANG_PLAIN]))
    note("gang dry run", _equal_or_raise(
        "gang_dry_run_scan", tuple(x[:GANG_PLAIN] for x in got), want))
    a_all, _, _ = kernels._hypothesis_scan(bg.device, pg, mg, fr, fc, "gang_dry_run_scan")
    log(f"kernels vs plain [gang_dry_run_scan]: P={bg.device.requests.shape[0]} "
        f"N={bg.device.alloc.shape[0]} C={mg.shape[0]} R={bg.device.alloc.shape[1]}, "
        f"{int((fr > bg.device.requested[None]).any(-1).sum())} freed rows clamp at 0: "
        f"exact on {GANG_PLAIN} hypotheses (counts {min(got[0].tolist())}.."
        f"{max(got[0].tolist())})")
    timing["gang_dry_run"] = {
        "ms": cuda_ms(lambda: kernels.gang_dry_run_scan(bg.device, pg, mg, fr, fc), 5),
        "plain_ms": gang_plain_ms, "plain_hypotheses": GANG_PLAIN,
        "shape": [bg.device.requests.shape[0], bg.device.alloc.shape[0], mg.shape[0]],
        **_hyp_bound(bg.device, pg, mg, a_all.tolist(), (fr, fc)),
    }
    # the gang dry run on the batched engine: hypothesis_rows, B3 + B6 a
    # hypothesis, slice_epilogue
    got = dry_run_gang_preemption(bg.device, pg, mg, fr, fc, "batched")
    want, batched_plain_ms = timed(
        lambda: dry_run_gang_preemption_plain(bg.device, pg, mg, fr, fc, "batched"))
    note_batched("batched gang dry run", _equal_or_raise("batched gang dry run", got, want))
    _, batched_ms = timed(lambda: dry_run_gang_preemption(bg.device, pg, mg, fr, fc, "batched"))
    log(f"kernels vs plain [batched gang dry run]: C={mg.shape[0]}: exact (counts "
        f"{min(got[0].tolist())}..{max(got[0].tolist())}); {batched_ms:.3f} ms against the "
        f"plain version's {batched_plain_ms:.3f} ms")
    timing["gang_dry_run"]["batched_ms"] = batched_ms
    timing["gang_dry_run"]["batched_plain_ms"] = batched_plain_ms
    # the two batched-engine kernels alone, against the rows and the counts
    # run_hypotheses builds: the node rows of the 32 eviction hypotheses and
    # of the 33 SchedulingBasic placements; the epilogue over the Basic
    # placements' and the dry run's assignments, with and without slices
    rows_err = max(
        _equal_or_raise(f"hypothesis_rows {label}", kernels.hypothesis_rows(*args),
                        _plain_rows(*args))
        for label, args in (("eviction", (bg.device, mg, fr, fc)),
                            ("placement", (b.device, masks))))
    note("32 eviction hypotheses, 33 placements", rows_err, "hypothesis_rows")
    topo = b.device.topology
    ab = got_basic[0]
    epi_err = max(
        _equal_or_raise(f"slice_epilogue {label}", kernels.slice_epilogue(*args),
                        _plain_epilogue(*args))
        for label, args in (
            ("Basic placements", (ab, b.device.pod_valid, topo.slice_id, topo.num_slices)),
            ("Basic placements, no slices", (ab, b.device.pod_valid, None, 0)),
            ("gang dry run", (a_all, bg.device.pod_valid, bg.device.topology.slice_id,
                              bg.device.topology.num_slices))))
    note("Basic placements with and without slices, gang dry run", epi_err, "slice_epilogue")
    log(f"kernels vs plain [hypothesis_rows, slice_epilogue]: exact on "
        f"{mg.shape[0]} eviction hypotheses and {masks.shape[0]} placements")
    N, R = bg.device.alloc.shape
    H = mg.shape[0]
    # each input read once, each output written once; their integer
    # arithmetic is not counted (bytes bound both)
    rows_bytes = (N + H * N + 2 * N * R * 8 + N * 4 + H * N * R * 8 + H * N * 4
                  + H * N + 2 * H * N * R * 8 + H * N * 4)
    Hb, Pb = ab.shape
    epi_bytes = Hb * Pb * 4 + Pb + topo.slice_id.shape[0] * 4 + Hb * 8
    return {
        "hypothesis_scan": timing,
        "hypothesis_rows": {
            "ms": cuda_ms(lambda: kernels.hypothesis_rows(bg.device, mg, fr, fc), 20),
            "plain_ms": cuda_ms(lambda: _plain_rows(bg.device, mg, fr, fc), 5),
            "shape": [H, N], "bytes": rows_bytes, "ops": 0,
        },
        "slice_epilogue": {
            "ms": cuda_ms(lambda: kernels.slice_epilogue(
                ab, b.device.pod_valid, topo.slice_id, topo.num_slices), 20),
            "plain_ms": cuda_ms(lambda: _plain_epilogue(
                ab, b.device.pod_valid, topo.slice_id, topo.num_slices), 5),
            "shape": [Hb, Pb], "bytes": epi_bytes, "ops": 0,
        },
    }


def _plain_rows(b, masks, freed_req=None, freed_count=None):
    """The hypotheses' node rows as ``assign.placement.run_hypotheses``
    builds them, stacked: ``(valid, req, nz, pc)``, the last three None
    without freed rows."""
    import torch

    H = masks.shape[0]
    valid = torch.stack([b.node_valid & masks[h] for h in range(H)])
    if freed_req is None:
        return valid, None, None, None
    return (valid,
            torch.stack([torch.clamp(b.requested - freed_req[h], min=0) for h in range(H)]),
            torch.stack([torch.clamp(b.nonzero_requested - freed_req[h], min=0)
                         for h in range(H)]),
            torch.stack([torch.clamp(b.pod_count - freed_count[h], min=0)
                         for h in range(H)]))


def _plain_epilogue(assignments, pod_valid, slice_id, num_slices):
    """Each row's count and alignment as ``run_hypotheses`` computes them."""
    import torch

    from kubetpu_torch.ops.topology import alignment_score

    counts = torch.sum((assignments >= 0) & pod_valid[None, :], dim=1).to(torch.int32)
    if slice_id is None:
        return counts, torch.zeros_like(counts)
    return counts, torch.stack([
        alignment_score(row, pod_valid, slice_id, num_slices)[0] for row in assignments])


# ------------------------------- 3e. the packing engine (B14, B12 fused)
def binpack_case(n_nodes=5000, n_bound=20, n_pending=1024):
    """A BinPacking cycle at full width: node_default nodes, pod_binpack
    init pods bound round-robin over the first nodes, a full batch of
    pod_binpack pods pending (the 10-slot size and priority cycle)."""
    from kubetpu_torch.perf import workloads as W

    nodes = [W.node_default(i) for i in range(n_nodes)]
    bound = [W.pod_binpack(f"init-1-namespace-0-{j}", "namespace-0").with_node(
        nodes[j % n_nodes].name) for j in range(n_bound)]
    pending = [W.pod_binpack(f"measure-2-namespace-1-{j}", "namespace-1")
               for j in range(n_pending)]
    return _cache_with(nodes, bound), pending


def nofit_profile():
    """The NodeResourcesFit filter off (its score on): the solve must not
    re-impose capacity."""
    from kubetpu_torch.framework import config as C

    return C.Profile(filters=C.PluginSet(enabled=()),
                     scores=C.PluginSet(enabled=((C.NODE_RESOURCES_FIT, 1),)),
                     default_spread_constraints=())


def _bits_equal(name, got, want) -> int:
    """float32 tensors equal bit for bit; raises otherwise."""
    import torch

    return _equal_or_raise(name, (got.view(torch.int32),), (want.view(torch.int32),))


def _packing_equal(name, b, params, lam, weights, results, max_iters=0) -> tuple:
    """``kernels.packing_assign`` (one launch a solve) against
    ``packing_assign_plain`` on one batch, stopped at ``max_iters`` rounds
    (0: the batch's pods, kubetpu's cap) — assignments, the seven state
    slots, the duals (bits), iterations and nodes used exactly, the
    objective within rtol 1e-5. Returns the kernel's solve."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign import packing as PK

    got = kernels.packing_assign(b, params, lam, weights, max_iters)
    want = PK.packing_assign_plain(b, params, lam, weights, max_iters)
    torch.cuda.synchronize()
    ka, ks, klam, kobj, kit, knu = got
    pa, ps, plam, pobj, pit, pnu = want
    err = _engine_err(f"{name} packing", ka, ks, pa, ps)
    err = max(err, _bits_equal(f"{name} duals", klam, plam))
    if kit != pit or int(knu) != int(pnu):
        raise AssertionError(f"{name}: kernel {kit} iterations, {int(knu)} nodes used; "
                             f"plain {pit}, {int(pnu)}")
    rel = abs(float(kobj) - float(pobj)) / max(abs(float(pobj)), 1e-30)
    if rel > 1e-5:
        raise AssertionError(f"{name}: objective {float(kobj)} against the plain "
                             f"{float(pobj)} (rel {rel})")
    cap = f", stopped at {max_iters} rounds" if max_iters else ""
    results["packing_round"]["cases"].append(name + cap)
    results["packing_round"]["max_abs_err"] = max(results["packing_round"]["max_abs_err"], err)
    n_valid = int(b.pod_valid.sum().item())
    log(f"kernels vs plain [{name} packing{cap}]: P={b.requests.shape[0]} "
        f"N={b.alloc.shape[0]} topology {b.topology is not None}: exact ({kit} iterations, "
        f"{int((ka[:n_valid] >= 0).sum().item())} of {n_valid} pods placed on {int(knu)} "
        f"nodes, objective {float(kobj):.6f} against {float(pobj):.6f}, rel {rel:.2e})")
    return got


def idle_batch(b):
    """``b`` with no pod valid: the solve runs no round."""
    import dataclasses

    import torch

    return dataclasses.replace(b, pod_valid=torch.zeros_like(b.pod_valid))


def packing_round_bytes(b) -> int:
    """The bytes one round of the solve must move: the node rows it reads
    (capacity, the running state, pod room, validity, ports), each pod
    class's verdicts, totals and tie nodes written once, the duals read and
    written, and the per-pod vectors (admission order and its inverse,
    pick, admission, active flag, assignment)."""
    N, R = b.alloc.shape
    K = b.port_conflict.shape[0]
    P = b.requests.shape[0]
    return (N * (3 * R * 8 + 4 + 4 + 1 + K) + scored_pods(b) * N * (1 + 8 + 4) + 2 * 4 * N
            + P * (4 + 4 + 4 + 4 + 1 + 4))


def packing_checks(results) -> dict:
    """Phase 3's packing checks (B14, with B12's ``slice_occupancy`` fused)
    at full width, N = 5120 and P = 1024: the SchedulingBasic block cold and
    warm (the cold solve's duals), a BinPacking block, the Basic block on
    the 32-slice labeled fleet with ``topology="on"``, the coupled-heavy
    SchedulingPodAffinity and TopologySpreading blocks, the mixed cluster
    (host ports, taints, images; 2000 x 512) and the Basic block under a
    profile with the NodeResourcesFit filter off; the stop rule at 1 and 2
    rounds on the BinPacking, sliced Basic, PodAffinity and
    TopologySpreading blocks, and on a BinPacking batch with no pod valid
    (no round); then the dual ascent's log1p on the card for every count in
    [0, 1024] against the plain version on the CPU. Returns the solve's
    timing."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign import packing as PK
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.framework import runtime as rt
    from kubetpu_torch.perf import workloads as W

    weights = PK.PackingWeights().tensor("cuda")

    def cold(b):
        return torch.zeros(b.alloc.shape[0], dtype=torch.float32, device=b.device)

    cache, pending = basic_case()
    bb, pb = encode(cache, pending, C.Profile())
    basic = _packing_equal("SchedulingBasic 1024x5120", bb, pb, cold(bb), weights, results)
    _packing_equal("SchedulingBasic warm", bb, pb, basic[2], weights, results)
    bs, ps_ = encode_topology(sliced(cache, SLICES), pending, C.Profile())
    cache_b, pending_b = binpack_case()
    bp, pp = encode(cache_b, pending_b, C.Profile())
    binpack = _packing_equal("BinPacking 1024x5120", bp, pp, cold(bp), weights, results)
    stops = [("BinPacking 1024x5120", bp, pp), ("SchedulingBasic, 32 slices", bs.device, ps_)]
    _packing_equal("SchedulingBasic, 32 slices", bs.device, ps_, cold(bs.device), weights,
                   results)
    for name, (cache_c, pending_c), prof in (
            ("SchedulingPodAffinity 1024x5120", podaffinity_case(), C.Profile()),
            ("TopologySpreading 1024x5120",
             topology_case(W.pod_with_topology_spreading), C.Profile()),
            ("mixed 512x2048", mixed_case(seed=1), C.Profile())):
        bc, pc = encode(cache_c, pending_c, prof)
        _packing_equal(name, bc, pc, cold(bc), weights, results)
        if not name.startswith("mixed"):
            stops.append((name, bc, pc))
    bn, pn = encode(cache, pending, nofit_profile())
    _packing_equal("SchedulingBasic, fit filter off", bn, pn, cold(bn), weights, results)
    for name, b, params in stops:
        for cap in (1, 2):
            _packing_equal(name, b, params, cold(b), weights, results, max_iters=cap)
    idle = _packing_equal("BinPacking, no pod valid", idle_batch(bp), pp, cold(bp), weights,
                          results)
    if idle[4] != 0:
        raise AssertionError(f"a batch with no pod valid ran {idle[4]} rounds")

    k = torch.arange(0, 1025, dtype=torch.float32)
    ours, cuda = kernels.packing_log1p(k.cuda())
    want = PK.log1p_counts(k)
    _bits_equal("log1p of the overflow counts", ours.cpu(), want)
    off_cuda = int((cuda.cpu().view(torch.int32) != want.view(torch.int32)).sum().item())
    off_torch = int((torch.log1p(k).view(torch.int32) != want.view(torch.int32)).sum().item())
    log(f"log1p of the counts 0..1024: the kernel's equal to the plain version's bits; "
        f"CUDA's log1pf differs at {off_cuda} counts, torch.log1p on the CPU at {off_torch}")

    # timings: the whole solve on the BinPacking block (bins open one a
    # round) and on the Basic block
    P, N = bp.requests.shape[0], bp.alloc.shape[0]
    state_bytes = sum(int(x.nbytes) for x in (bp.requested, bp.nonzero_requested,
                                              bp.pod_count, bp.node_ports))
    lam0 = cold(bp)
    iters_bp, iters_basic = binpack[4], basic[4]
    return {"packing_round": {
        "ms": cuda_ms(lambda: kernels.packing_assign(bp, pp, lam0, weights), 5),
        "plain_ms": cuda_ms(lambda: PK.packing_assign_plain(bp, pp, lam0, weights), 1),
        # the batch read and the outputs written once, and each round's
        # node rows, class rows, duals and pod vectors
        "bytes": rt.batch_nbytes(bp) + 2 * 4 * N + P * 4 + state_bytes
        + iters_bp * packing_round_bytes(bp),
        # each round's float64 work over one pod a class
        "ops": iters_bp * scored_pods(bp) * N * f64_ops_per_pair(pp, bp),
        "shape": [P, N], "iterations": iters_bp,
        "basic_ms": cuda_ms(lambda: kernels.packing_assign(bb, pb, cold(bb), weights), 5),
        "basic_plain_ms": cuda_ms(lambda: PK.packing_assign_plain(bb, pb, cold(bb), weights),
                                  1),
        "basic_iterations": iters_basic,
        "filter_score_ms": cuda_ms(lambda: kernels.filter_score(bp, pp), 20),
    }}


# --------------------------------------------------- 3. volumes and DRA
DRA_DRIVER = "test-driver.cdi.k8s.io"


def dra_leaf(b, seed=0, rows=8, flat=False):
    """``b`` with a seeded DynamicResources score leaf on the card, built
    like ``with_extender``: S5 = ``rows`` rows of raw prioritized-list
    scores in [0, 8 * FIRST_AVAILABLE_MAX] over the real nodes (row 0 all
    zero, so its pods' term is 0), and every real pod given a signature.
    With ``flat`` each row holds one value on every node, so the term adds
    the same amount to every feasible node and the assignments are those of
    the batch without the leaf: the term's own cost, timed apart from the
    placements it changes."""
    import dataclasses

    import numpy as np
    import torch

    from kubetpu_torch.api import types as t

    rng = np.random.default_rng(seed)
    P, N = b.requests.shape[0], b.alloc.shape[0]
    n_pods = int(b.pod_valid.sum().item())
    n_nodes = int(b.node_valid.sum().item())
    raw = np.zeros((rows, N), dtype=np.int64)
    raw[1:, :n_nodes] = rng.integers(0, 8 * t.FIRST_AVAILABLE_MAX + 1,
                                     (rows - 1, 1 if flat else n_nodes))
    sig = np.zeros(P, dtype=np.int32)
    sig[:n_pods] = rng.integers(0, rows, n_pods)
    dev = b.alloc.device
    return dataclasses.replace(b, dra_score_raw=torch.from_numpy(raw).to(dev),
                               dra_score_sig=torch.from_numpy(sig).to(dev))


def dra_objects(n_nodes=500, slow=10, fast=2, fast_every=2, n_prio=1000, n_dense=0,
                slow_on_fast=True):
    """The prioritized-list scenario (``tests/test_dra.py:357`` scaled up):
    ``node_with_dra`` nodes each with ``slow`` slow devices, every
    ``fast_every``-th also with ``fast`` fast ones (and then no slow one
    unless ``slow_on_fast``); two device classes
    (``fast-gpu``, ``slow-gpu``: the driver and the device's kind); then
    ``n_prio`` pods each with its own claim whose one request is
    first_available = (fast, slow), and ``n_dense`` pods each with its own
    one-device claim on ``slow-gpu`` (a dense pool: one more resource
    column). Every pod requests 100m / 500Mi. Returns (nodes, classes,
    slices, claims, pods)."""
    from kubetpu_torch.api import types as t
    from kubetpu_torch.api.wrappers import make_pod
    from kubetpu_torch.perf import workloads as W

    nodes = [W.node_with_dra(i) for i in range(n_nodes)]
    classes = [
        t.DeviceClass(name=f"{kind}-gpu", selectors=(t.CELSelector(
            f'device.driver == "{DRA_DRIVER}" && device.attributes["kind"] == "{kind}"'),))
        for kind in ("fast", "slow")
    ]
    slices = []
    for i, n in enumerate(nodes):
        has_fast = i % fast_every == 0
        kinds = ((("slow", slow),) if slow_on_fast or not has_fast else ()) + (
            (("fast", fast),) if has_fast else ())
        for kind, count in kinds:
            slices.append(t.ResourceSlice(
                name=f"slice-{n.name}-{kind}", driver=DRA_DRIVER, pool=f"{n.name}-{kind}",
                node_name=n.name, devices=tuple(
                    t.Device(f"{kind}-{d}", attributes=(("kind", kind),))
                    for d in range(count))))
    claims, pods = [], []
    for j in range(n_prio + n_dense):
        name = f"dra-{j}"
        if j < n_prio:
            req = t.DeviceRequest(name="req", first_available=(
                t.DeviceSubRequest(name="fast", device_class_name="fast-gpu"),
                t.DeviceSubRequest(name="slow", device_class_name="slow-gpu")))
        else:
            req = t.DeviceRequest(name="req", device_class_name="slow-gpu")
        claims.append(t.ResourceClaim(name=f"{name}-claim", namespace="dra",
                                      uid=f"dra/{name}-claim", requests=(req,)))
        pods.append(make_pod(name, namespace="dra", cpu_milli=100, memory=500 * 1024**2,
                             claims=(f"{name}-claim",), creation_index=j))
    return nodes, classes, slices, claims, pods


def dra_cache(objects):
    """A Cache holding ``dra_objects``' nodes and DRA objects; returns
    ``(cache, pods)``."""
    from kubetpu_torch.state.snapshot import Cache

    nodes, classes, slices, claims, pods = objects
    cache = Cache()
    for n in nodes:
        cache.add_node(n)
    for c in classes:
        cache.dra.add_class(c)
    for s in slices:
        cache.dra.add_slice(s)
    for c in claims:
        cache.dra.add_claim(c)
    return cache, pods


def claim_template_case(n_nodes=500, per_node=10, n_pending=1024):
    """A SchedulingWithResourceClaimTemplate cycle: ``node_with_dra`` nodes
    with ``per_node`` devices of the test class, and pods each with its own
    one-device claim (one dense pool column, no score leaf)."""
    from kubetpu_torch.api import types as t
    from kubetpu_torch.api.wrappers import make_pod
    from kubetpu_torch.perf import workloads as W
    from kubetpu_torch.state.snapshot import Cache

    cache = Cache()
    cache.dra.add_class(t.DeviceClass(name="test-class", selectors=(
        t.CELSelector(f'device.driver == "{DRA_DRIVER}"'),)))
    for i in range(n_nodes):
        n = W.node_with_dra(i)
        cache.add_node(n)
        cache.dra.add_slice(t.ResourceSlice(
            name=f"slice-{n.name}", driver=DRA_DRIVER, pool=n.name, node_name=n.name,
            devices=tuple(t.Device(name=f"device-{d}") for d in range(per_node))))
    pending = []
    for j in range(n_pending):
        cache.dra.add_claim(t.ResourceClaim(
            name=f"c{j}", namespace="test", uid=f"test/c{j}",
            requests=(t.DeviceRequest(name="req-0", device_class_name="test-class"),)))
        pending.append(make_pod(f"p{j}", namespace="test", claims=(f"c{j}",)))
    return cache, pending


def pv_case(n_nodes=5000, n_pending=1024, zones=("zone-a", "zone-b", "zone-c")):
    """A SchedulingInTreePVs-shaped cycle whose volume rows are not all
    true: zoned ``node_default`` nodes, and each pod with its own bound
    ReadOnlyMany PV+PVC, the PV labeled with one of the zones (every pod
    its own static row: S = P)."""
    from kubetpu_torch.api import types as t
    from kubetpu_torch.api.wrappers import make_pod
    from kubetpu_torch.perf import workloads as W
    from kubetpu_torch.state.snapshot import Cache

    cache = Cache()
    for i in range(n_nodes):
        cache.add_node(W.node_default(i, zones))
    pending = []
    for j in range(n_pending):
        cache.add_pv(t.PersistentVolume(
            name=f"pv-{j}", access_modes=("ReadOnlyMany",), capacity=1024**3,
            labels=((W.ZONE_KEY, zones[j % len(zones)]),), claim_ref=f"pv/claim-{j}"))
        cache.add_pvc(t.PersistentVolumeClaim(
            name=f"claim-{j}", namespace="pv", volume_name=f"pv-{j}",
            access_modes=("ReadOnlyMany",), request=1024**3))
        pending.append(make_pod(f"pvpod-{j}", namespace="pv", cpu_milli=100,
                                memory=500 * 1024**2, pvcs=(f"claim-{j}",),
                                creation_index=j))
    return cache, pending


def dra_checks(results, basic) -> dict:
    """Phase 3's DynamicResources and volume checks. ``filter_score``, the
    ``greedy_scan`` engine, the ``batched_round`` rounds, the packing
    engine (``_packing_equal``) and the placement
    search (``placement_scan``, and on the batched engine
    ``hypothesis_rows`` + B3 + B6 + ``slice_epilogue``; two placements: all
    nodes, every other node) and the recorder's ``explain_summary`` and
    ``filter_component_masks`` against their plain versions, exactly, on (a)
    the SchedulingBasic block with a seeded DRA leaf (``dra_leaf``) and (b)
    an encoded prioritized-list batch, 1024 pods over 512 nodes (768 with
    a (fast, slow) claim, 256 with a one-device claim on a dense pool,
    R = 4); then the first three on a SchedulingWithResourceClaimTemplate
    batch (R = 4, no score leaf) and a PV batch with one static row per
    pod at 5000 nodes. Returns the ``filter_score`` and ``greedy_scan``
    times on (a) and (b) with and without the leaf, and on (a) with a flat
    leaf (``dra_leaf(flat=True)``: the same assignments as without it)."""
    import dataclasses

    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign import packing as PK
    from kubetpu_torch.assign.placement import placement_assign_device, placement_assign_plain
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.framework import runtime as rt

    def note(kernel, name, err):
        results[kernel]["cases"].append(name)
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)

    def two_placements(b):
        n = int(b.node_valid.sum().item())
        masks = torch.zeros((2, b.alloc.shape[0]), dtype=torch.bool, device=b.device)
        masks[0, :n] = True
        masks[1, :n:2] = True
        return masks

    weights = PK.PackingWeights().tensor("cuda")
    b0, params = basic
    bd = dra_leaf(b0, seed=9)
    prio_cache, prio_pods = dra_cache(dra_objects(n_nodes=512, n_prio=768, n_dense=256))
    bp, pp = encode(prio_cache, prio_pods, C.Profile())
    if bp.dra_score_raw is None or bp.alloc.shape[1] != 4:
        raise AssertionError("prioritized-list batch: no DRA leaf or R != 4")
    for name, b, prm in (("SchedulingBasic 1024x5120 + DRA leaf", bd, params),
                         ("prioritized list 1024x512, R=4", bp, pp)):
        ka = check_case(name, b, prm, results)
        _explain_equal(name, b, prm, ka, results)
        lam = torch.zeros(b.alloc.shape[0], dtype=torch.float32, device=b.device)
        _packing_equal(name, b, prm, lam, weights, results)
        masks = two_placements(b)
        note("hypothesis_scan", f"{name} placement", _equal_or_raise(
            f"placement_scan {name}", kernels.placement_scan(b, prm, masks),
            placement_assign_plain(b, prm, masks)))
        err = _equal_or_raise(f"batched placement {name}",
                              placement_assign_device(b, prm, masks, "batched"),
                              placement_assign_plain(b, prm, masks, "batched"))
        for kernel in ("hypothesis_rows", "slice_epilogue"):
            note(kernel, f"{name} batched placement", err)
        log(f"kernels vs plain [{name}]: S5={b.dra_score_raw.shape[0]} DRA rows; the "
            "packing solve and two placements on both engines exact too")
    for name, (cache, pending) in (
            ("SchedulingWithResourceClaimTemplate 1024x512, R=4", claim_template_case()),
            ("SchedulingInTreePVs zoned 1024x5120", pv_case())):
        b, prm = encode(cache, pending, C.Profile())
        rows = None if b.static_mask is None else b.static_mask.shape[0]
        if "PVs" in name and rows != len(pending):
            raise AssertionError(f"{name}: {rows} static rows for {len(pending)} pods")
        if "Claim" in name and b.alloc.shape[1] != 4:
            raise AssertionError(f"{name}: R = {b.alloc.shape[1]}, not 4")
        check_case(f"{name}, static rows {rows}", b, prm, results)
    bare = dataclasses.replace(bp, dra_score_raw=None, dra_score_sig=None)
    flat = dra_leaf(b0, seed=9, flat=True)
    if not torch.equal(kernels.greedy_scan(flat, params)[0], kernels.greedy_scan(b0, params)[0]):
        raise AssertionError("a flat DRA leaf moved the Basic batch's assignments")
    timing = {}
    for key, with_leaf, without, prm in (("basic", bd, b0, params),
                                         ("basic_flat", flat, b0, params),
                                         ("prioritized", bp, bare, pp)):
        P, N = with_leaf.requests.shape[0], with_leaf.alloc.shape[0]
        ka, _ = kernels.greedy_scan(with_leaf, prm)
        state_bytes = sum(int(x.nbytes) for x in (
            with_leaf.requested, with_leaf.nonzero_requested, with_leaf.pod_count,
            with_leaf.node_ports))
        ops = scored_pods(with_leaf) * N * f64_ops_per_pair(prm, with_leaf)
        fs_bound = _bound(rt.batch_nbytes(with_leaf) + P * N * (1 + 8), ops)
        gs_bound = _bound(rt.batch_nbytes(with_leaf) + P * 4 + state_bytes,
                          ops + _rescored(ka.cpu().tolist(), class_of=_class_of(with_leaf))
                          * f64_ops_per_pair(prm, with_leaf))
        timing[key] = {
            "filter_score_ms": cuda_ms(lambda: kernels.filter_score(with_leaf, prm), 20),
            "filter_score_without_ms": cuda_ms(lambda: kernels.filter_score(without, prm), 20),
            "filter_score_plain_ms": cuda_ms(lambda: rt.feasible_and_scores(with_leaf, prm), 5),
            "filter_score_bound_ms": fs_bound[0], "filter_score_bound_by": fs_bound[1],
            "greedy_scan_ms": cuda_ms(lambda: kernels.greedy_scan(with_leaf, prm), 10),
            "greedy_scan_without_ms": cuda_ms(lambda: kernels.greedy_scan(without, prm), 10),
            "greedy_scan_bound_ms": gs_bound[0], "greedy_scan_bound_by": gs_bound[1],
            "shape": [P, N], "dra_rows": int(with_leaf.dra_score_raw.shape[0]),
        }
        tm = timing[key]
        log(f"timing [DRA term, {key} batch {P}x{N}, S5={tm['dra_rows']}]: filter_score "
            f"{tm['filter_score_ms']:.4f} ms with the leaf, "
            f"{tm['filter_score_without_ms']:.4f} without (plain "
            f"{tm['filter_score_plain_ms']:.4f}, bound {fs_bound[0]:.6f} ({fs_bound[1]})); "
            f"greedy_scan {tm['greedy_scan_ms']:.4f} / {tm['greedy_scan_without_ms']:.4f} ms "
            f"(bound {gs_bound[0]:.6f} ({gs_bound[1]}))")
    return timing


def kernels_phase():
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.batched import batched_assign_plain
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.framework import runtime as rt

    results = {k: {"cases": [], "max_abs_err": 0}
               for k in ("filter_score", "greedy_scan", "batched_round", "scatter_rows",
                         "dry_run_preemption", "explain_summary",
                         "filter_component_masks", "hypothesis_scan", "hypothesis_rows",
                         "slice_epilogue", "packing_round")}
    # (name, batch, params, greedy assignments) for the explain checks
    explain_batches = []
    # the SchedulingBasic cycle: the greedy main path's shapes and timings
    cache, pending = basic_case()
    b, params = encode(cache, pending, C.Profile())
    ka = check_case("SchedulingBasic 1024x5120", b, params, results)
    explain_batches.append(("SchedulingBasic 1024x5120", b, params, ka))
    for name, prof in profiles().items():
        cache_m, pending_m = mixed_case(seed=1)
        bm, pm = encode(cache_m, pending_m, prof)
        km = check_case(f"mixed/{name}", bm, pm, results, batched=name == "least")
        if name == "least":
            mixed_least = (bm, pm)
            explain_batches.append(("mixed/least", bm, pm, km))
    cache_s, pending_s = saturated_case()
    bs, ps = encode(cache_s, pending_s, C.Profile())
    explain_batches.append(("saturated", bs, ps, check_case("saturated", bs, ps, results)))
    for name, prof in affinity_profiles().items():
        cache_a, pending_a = affinity_case(seed=2)
        ba, pa_ = encode(cache_a, pending_a, prof)
        kaf = check_case(f"affinity/{name}", ba, pa_, results)
        if name == "default":
            explain_batches.append(("affinity/default", ba, pa_, kaf))
            ba_default, pa_default = ba, pa_
    stamp("phase 3: Basic, mixed, saturated and affinity checks")
    # the SchedulingPodAffinity cycle: the batched main path's shapes
    cache_p, pending_p = podaffinity_case()
    bp, pp = encode(cache_p, pending_p, C.Profile())
    # its greedy engine is held at 512 x 2048 on the affinity clusters
    check_case("SchedulingPodAffinity 1024x5120", bp, pp, results, plain_greedy=False)
    # the spread batches, and the TopologySpreading / Preferred cycles
    spread = spread_checks(results)
    explain_batches.append(("spread/spread", *spread["spread/spread"]))
    stamp("phase 3: PodAffinity and spread checks")

    P, N = b.requests.shape[0], b.alloc.shape[0]
    in_bytes = rt.batch_nbytes(b)
    state_bytes = sum(int(x.nbytes) for x in (b.requested, b.nonzero_requested,
                                              b.pod_count, b.node_ports))
    # the greedy engine scores every pair once at the batch's start, and
    # again at a step the nodes earlier pods of the batch landed on that
    # changed since their verdicts were kept
    rescored = _rescored(ka.cpu().tolist(), class_of=_class_of(b))
    rounds: list = []
    kernels.batched_assign(bp, pp, rounds_out=rounds)
    Pp, Np = bp.requests.shape[0], bp.alloc.shape[0]
    pa_bytes = int(bp.podaffinity.base_sums.nbytes)
    p_state = sum(int(x.nbytes) for x in (bp.requested, bp.nonzero_requested,
                                          bp.pod_count, bp.node_ports))
    timing = {
        "filter_score": {
            "ms": cuda_ms(lambda: kernels.filter_score(b, params), 20),
            "plain_ms": cuda_ms(lambda: rt.feasible_and_scores(b, params), 5),
            "bytes": in_bytes + P * N * (1 + 8),
            "ops": scored_pods(b) * N * f64_ops_per_pair(params, b),
            "shape": [P, N],
            "podaffinity_ms": cuda_ms(lambda: kernels.filter_score(bp, pp), 20),
            "podaffinity_plain_ms": cuda_ms(lambda: rt.feasible_and_scores(bp, pp), 5),
        },
        "greedy_scan": {
            "ms": cuda_ms(lambda: kernels.greedy_scan(b, params), 10),
            "plain_ms": results["greedy_scan"]["plain_ms_of"]["SchedulingBasic 1024x5120"],
            "bytes": in_bytes + P * 4 + state_bytes,
            "ops": (scored_pods(b) * N + rescored) * f64_ops_per_pair(params, b),
            "shape": [P, N],
            "podaffinity_ms": cuda_ms(lambda: kernels.greedy_scan(bp, pp), 5),
        },
        "batched_round": {
            "ms": cuda_ms(lambda: kernels.batched_assign(bp, pp), 10),
            "plain_ms": cuda_ms(lambda: batched_assign_plain(bp, pp), 3),
            "bytes": rt.batch_nbytes(bp) + Pp * 4 + p_state + pa_bytes,
            "ops": rounds[0] * scored_pods(bp) * Np * f64_ops_per_pair(pp, bp),
            "shape": [Pp, Np],
            "rounds": rounds[0],
        },
    }
    timing["filter_score"]["spread"] = _spread_timing(
        "TopologySpreading", *spread["TopologySpreading"], "filter_score")
    timing["filter_score"]["spread_soft"] = _spread_timing(
        "PreferredTopologySpreading", *spread["PreferredTopologySpreading"], "filter_score")
    timing["greedy_scan"]["spread"] = _spread_timing(
        "PreferredTopologySpreading", *spread["PreferredTopologySpreading"], "greedy_scan",
        results)
    timing["batched_round"]["spread"] = _spread_timing(
        "TopologySpreading", *spread["TopologySpreading"], "batched_round")
    stamp("phase 3: timings of the three pair kernels")
    timing["scatter_rows"] = scatter_checks(results)
    pre = preemption_checks(results)
    stamp("phase 3: scatter and preemption checks")
    timing["filter_score"]["nominated"] = pre["nominated"]
    timing["filter_score"]["potential"] = pre["potential"]
    timing["dry_run_preemption"] = {
        **{k: pre["K=8"][k] for k in ("ms", "plain_ms", "bytes", "shape")},
        "ops": 0, "k128": pre["K=128"],
    }
    explain_batches.append(pre["explain"])
    ext = extender_checks(results, (b, params), mixed_least)
    timing["filter_score"]["extender"] = ext["timing"]
    timing.update(explain_checks(results, explain_batches + ext["batches"]))
    stamp("phase 3: extender and explain checks")
    timing.update(gang_checks(results))
    stamp("phase 3: gang checks")
    timing.update(packing_checks(results))
    stamp("phase 3: packing checks")
    # K1 against the sharded plain engine (12 s a batch) on spread/spread
    # only; on every batch against the unsharded kernel, which is held to
    # the plain engine on each of them above (--mesh runs the three)
    mesh_batch_list = [
        ("SchedulingBasic 1024x5120", b, params, False),
        ("SchedulingBasic with a DRA leaf", dra_leaf(b), params, False),
        ("mixed/least", *mixed_least, False),
        ("affinity/default", ba_default, pa_default, False),
        ("SchedulingPodAffinity 1024x5120", bp, pp, False),
        ("spread/default", *spread["spread/default"][:2], False),
        ("spread/spread", *spread["spread/spread"][:2], True),
        ("PreferredTopologySpreading 1024x5120", *spread["PreferredTopologySpreading"], False),
    ]
    dra = dra_checks(results, (b, params))
    stamp("phase 3: DRA checks")
    timing["filter_score"]["dra"] = {k: {n: v for n, v in t.items() if "greedy" not in n}
                                     for k, t in dra.items()}
    timing["greedy_scan"]["dra"] = {k: {n: v for n, v in t.items() if "filter" not in n}
                                    for k, t in dra.items()}
    out = []
    for name, src, replaces in (
        ("filter_score", "kubetpu_torch/kernels/csrc/filter_score.cu",
         "kubetpu/framework/runtime.py:1578"),
        ("greedy_scan", "kubetpu_torch/kernels/csrc/greedy_scan.cu",
         "kubetpu/assign/greedy.py:107"),
        ("batched_round", "kubetpu_torch/kernels/csrc/batched_round.cu (+ filter_pass.cuh, "
         "solve_sync.cuh)",
         "kubetpu/assign/batched.py:135 (the whole solve: the rounds with :55, :94 and their "
         "filter_score_batch)"),
        ("scatter_rows", "kubetpu_torch/kernels/csrc/scatter_rows.cu",
         "kubetpu/framework/runtime.py:240"),
        ("dry_run_preemption", "kubetpu_torch/kernels/csrc/dry_run_preemption.cu",
         "kubetpu/ops/preemption.py:186"),
        ("explain_summary", "kubetpu_torch/kernels/csrc/explain_summary.cu",
         "kubetpu/sched/flightrecorder.py:92"),
        ("filter_component_masks", "kubetpu_torch/kernels/csrc/filter_component_masks.cu",
         "kubetpu/sched/flightrecorder.py:146"),
        ("hypothesis_scan", "kubetpu_torch/kernels/csrc/hypothesis_scan.cu",
         "kubetpu/assign/placement.py:38; kubetpu/ops/preemption.py:219; "
         "kubetpu/ops/topology.py:19, :41"),
        ("hypothesis_rows", "kubetpu_torch/kernels/csrc/hypothesis_scan.cu",
         "kubetpu/assign/placement.py:59; kubetpu/ops/preemption.py:243 (each hypothesis's "
         "node rows, engine=batched)"),
        ("slice_epilogue", "kubetpu_torch/kernels/csrc/hypothesis_scan.cu",
         "kubetpu/ops/topology.py:19, :41 (engine=batched)"),
        ("packing_round", "kubetpu_torch/kernels/csrc/packing_round.cu (+ filter_pass.cuh, "
         "solve_sync.cuh)",
         "kubetpu/assign/packing.py:259 (the whole solve: :187 _priority_order, the rounds "
         "with :146, :198 and their filter_score_batch, :467-499 the end); "
         "kubetpu/ops/topology.py:64 (slice_occupancy, fused)"),
    ):
        tm = timing[name]
        bound_ms, bound_by = _bound(tm["bytes"], tm["ops"])
        line = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": None, "result": "equal to the plain version",
            "max_abs_err": results[name]["max_abs_err"],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": tm.get("library_ms"),
            "cases": results[name]["cases"], "shape": tm["shape"],
        }
        for k in ("podaffinity_ms", "podaffinity_plain_ms", "rounds", "spread",
                  "spread_soft", "nominated", "potential", "k128", "extender",
                  "filter_score_ms", "classes", "singletons_ms", "gang_dry_run", "iterations",
                  "basic_ms", "basic_plain_ms", "basic_iterations", "node_pass",
                  "plain_placements", "dra", "five_masks_bytes", "masks_calls"):
            if k in tm:
                line[k] = tm[k]
        out.append(line)
        lib = (f", library {tm['library_ms']:.4f} ms" if "library_ms" in tm else "")
        log(f"timing [{name}] at {tm['shape'][0]}x{tm['shape'][1]}: kernel "
            f"{tm['ms']:.4f} ms, plain {tm['plain_ms']:.4f} ms, bound {bound_ms:.6f} ms "
            f"({bound_by}){lib}")
    for name in ("filter_score", "greedy_scan"):
        plain = timing[name].get("podaffinity_plain_ms")
        log(f"timing [{name}] on the SchedulingPodAffinity batch: kernel "
            f"{timing[name]['podaffinity_ms']:.4f} ms"
            + ("" if plain is None else f", plain {plain:.4f} ms"))
    nm = timing["filter_score"]["nominated"]
    log(f"timing [filter_score] on the {nm['batch']} batch: kernel {nm['ms']:.4f} ms "
        f"(without its nominations {nm['without_nominations_ms']:.4f} ms), plain "
        f"{nm['plain_ms']:.4f} ms, bound {nm['bound_ms']:.6f} ms ({nm['bound_by']})")
    pm = timing["filter_score"]["potential"]
    log(f"timing [filter_score potential mode] on the {pm['batch']} view: kernel "
        f"{pm['ms']:.4f} ms, plain {pm['plain_ms']:.4f} ms")
    es = timing["explain_summary"]
    log(f"timing [explain_summary] on the SchedulingBasic batch: {es['classes']} pod "
        f"classes {es['ms']:.4f} ms, a class a pod {es['singletons_ms']:.4f} ms")
    fm = timing["filter_component_masks"]
    log(f"timing [filter_component_masks] on the SchedulingBasic batch, every row: "
        f"{fm['ms']:.4f} ms; as the recorder takes one pod's row "
        f"{fm['masks_calls']['recorder_ms']:.4f} ms, the bridge's _components on a one-pod "
        f"request {fm['masks_calls']['bridge_ms']:.4f} ms")
    hs = timing["hypothesis_scan"]
    log(f"timing [hypothesis_scan] placement on the SchedulingBasic batch, D="
        f"{hs['shape'][2]}: its filter_score launch alone {hs['filter_score_ms']:.4f} ms of "
        f"the wrapper's {hs['ms']:.4f} ms; <all> alone {hs['all_only_ms']:.4f} ms, the "
        f"{hs['shape'][2] - 1} slices alone {hs['slices_only_ms']:.4f} ms, the greedy_scan "
        f"engine (D = 1 of greedy_scan.cu) {hs['greedy_scan_ms']:.4f} ms")
    gd = hs["gang_dry_run"]
    log(f"timing [hypothesis_scan] gang dry run at {gd['shape'][0]}x{gd['shape'][1]}, C="
        f"{gd['shape'][2]}: kernel {gd['ms']:.4f} ms, plain {gd['plain_ms']:.4f} ms, bound "
        f"{gd['bound_ms']:.6f} ms ({gd['bound_by']}); on the batched engine "
        f"{gd['batched_ms']:.3f} ms, plain {gd['batched_plain_ms']:.3f} ms")
    pr = timing["packing_round"]
    log(f"timing [packing_round] whole solve on the BinPacking block ({pr['iterations']} "
        f"iterations; filter_score alone {pr['filter_score_ms']:.4f} ms), on the "
        f"SchedulingBasic block {pr['basic_ms']:.4f} ms ({pr['basic_iterations']} "
        f"iterations), plain {pr['basic_plain_ms']:.4f} ms")
    k128 = timing["dry_run_preemption"]["k128"]
    log(f"timing [dry_run_preemption] at 5120x128: kernel {k128['ms']:.4f} ms, plain "
        f"{k128['plain_ms']:.4f} ms, bound {k128['bound_ms']:.6f} ms ({k128['bound_by']})")
    for name, key in (("filter_score", "spread"), ("filter_score", "spread_soft"),
                      ("greedy_scan", "spread"), ("batched_round", "spread")):
        sp = timing[name][key]
        glob = (f", bitmaps in global memory {sp['bitmaps_in_global_ms']:.4f} ms"
                if "bitmaps_in_global_ms" in sp else "")
        log(f"timing [{name}] on the {sp['batch']} batch: kernel {sp['ms']:.4f} ms, "
            f"plain {sp['plain_ms']:.4f} ms, bound {sp['bound_ms']:.6f} ms "
            f"({sp['bound_by']}){glob}")
    # the node mesh: four logical shards on this card (K1, K3, K4, B5m)
    # (the many-round batches meet the tiled plain rounds in
    # batched_solve_checks)
    round_batch_list = [
        ("SchedulingPodAffinity 1024x5120", bp, pp, True),
        ("TopologySpreading 1024x5120", *spread["TopologySpreading"], True),
        ("mixed/least", *mixed_least, False),
        ("affinity/default", ba_default, pa_default, False),
        ("spread/spread", *spread["spread/spread"][:2], False),
    ]
    mesh4 = node_mesh(4, True)
    mesh_timing = mesh_checks(mesh4, results, mesh_batch_list, (b, params), round_batch_list)
    stamp("phase 3: mesh checks")
    out[0]["potential_mesh"] = potential_mesh_checks(
        [("4 shards", mesh4), ("2 x 2 grid", grid_mesh(True))], results)
    stamp("phase 3: sharded potential mask checks")
    # the packing engine on the node mesh (K5), and the 2 x 2 grid (K6, K7)
    pm_cases = packing_mesh_batches((b, params))
    mesh_timing.update(packing_mesh_checks(mesh4, results, pm_cases))
    grid4 = grid_mesh(True)
    mesh_timing.update(grid_checks(grid4, results, grid_batches(
        (b, params), (bp, pp), spread["TopologySpreading"])))
    stamp("phase 3: packing-mesh and grid checks")
    out[0]["classes"] = class_checks(
        results, (b, params), (bp, pp), spread["PreferredTopologySpreading"], mesh4, grid4)
    stamp("phase 3: pod class checks")
    # the packing engine on the 2 x 2 grid (K8), on K5's cut batches
    mesh_timing.update(packing_grid_checks(grid4, mesh4, results, [
        c[:3] for c in pm_cases if c[0].startswith("BinPacking 256x5120")]))
    stamp("phase 3: packing-grid checks")
    batched_solve_checks(results, mesh4, grid4, solve_batches((b, params), (bp, pp)))
    stamp("phase 3: batched solve checks")
    scan_checks(results, (b, params), mesh4, grid4)
    stamp("phase 3: scan checks")
    out += mesh_kernel_lines(results, mesh_timing)
    torch.cuda.synchronize()
    return out


# ------------------------------------------ 3s. the scan loop's own cases
def interleaved_case(n_nodes=5000, n_bound=1000, n_pending=1024):
    """SchedulingBasic's cluster with two pod templates taking turns pod by
    pod (pod_default, and 250m / 1 Gi), so that the scan's staged pod
    inputs change at every step."""
    from kubetpu_torch.api.wrappers import make_pod
    from kubetpu_torch.perf import workloads as W

    cache, pending = basic_case(n_nodes, n_bound, n_pending)
    pending = [p if j % 2 == 0 else make_pod(f"wide-{j}", namespace="namespace-1",
                                             cpu_milli=250, memory=1024**3)
               for j, p in enumerate(pending)]
    return cache, pending


def released_elsewhere(b, assignments) -> int:
    """The nominations whose pod the scan placed and whose node another
    thread of its block owns than the one that releases them (thread g %
    SCAN_THREADS for nomination g; node n's owner is n % SCAN_THREADS)."""
    from kubetpu_torch.kernels import SCAN_THREADS as threads

    idx = b.nominated_pod_idx.tolist()
    nodes = b.nominated_node.tolist()
    placed = assignments.tolist()
    return sum(1 for g, (i, n) in enumerate(zip(idx, nodes))
               if i >= 0 and n >= 0 and placed[i] >= 0 and n % threads != g % threads)


def scan_checks(results, basic, mesh, grid) -> None:
    """The cases aimed at the scan loop's design (``scan_loop.cuh``), each
    exact against the plain engine (``check_case`` without the batched
    rounds; the nominated cycle's greedy engine is held in
    ``preemption_checks``): two templates interleaved pod by pod (the staged inputs and
    the kept verdicts change every step; also K1 on the node mesh and K7
    on the 2 x 2 grid, two pod rows carrying the touched flags, against
    the unsharded kernel); the placements of ``--time-dra``'s batch G
    (every pick on a node of its own across the block: the touched flags
    of many threads); the PreemptionAsync cycle with nominations released
    on nodes that other threads own; N = 15360 (15000 nodes) and N = 512
    (500 nodes: half the threads own no node); the gang dry run with
    freed rows lives in ``gang_checks``."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.parallel import mesh as M

    b, params = basic
    bi, pi = encode(*interleaved_case(), C.Profile())
    check_case("interleaved templates 1024x5120", bi, pi, results, batched=False)
    want = kernels.greedy_scan(bi, pi)
    note = results.setdefault("tiled_scan", {"cases": [], "max_abs_err": 0})
    note["cases"].append("interleaved templates")
    _mesh_err("interleaved K1", kernels.tiled_greedy_scan(M.shard_batch(bi, mesh), pi), want)
    _mesh_err("interleaved K7", kernels.tiled_greedy_scan(M.shard_batch(bi, grid), pi), want)
    log("kernels vs plain [interleaved templates]: K1 on the 4-shard mesh and K7 on the "
        "2 x 2 grid equal to greedy_scan")
    chosen = [j for j in kernels.greedy_scan(dra_leaf(b, seed=9), params)[0].tolist() if j >= 0]
    bg = _loaded_except(b, set(chosen))
    ka = check_case("scattered picks (batch G) 1024x5120", bg, params, results, batched=False)
    owners = len({j % kernels.SCAN_THREADS for j in ka.tolist() if j >= 0})
    if owners < 64:
        raise AssertionError(f"batch G's picks fall on {owners} threads' nodes only")
    log(f"kernels vs plain [scattered picks]: on the nodes of {owners} threads")
    # preemption_checks holds this batch (preemption_case's defaults) to the
    # plain engine; here the kernel's picks show that it releases
    # nominations on other threads' nodes
    cache, pending, nom = preemption_case()
    batch, prm = encode_batch_full(cache, pending, C.Profile(), nom.entries())
    bn = batch.device
    kn = check_case("nominations released elsewhere 1024x5120", bn, prm, results,
                    batched=False, plain_greedy=False)
    moved = released_elsewhere(bn, kn)
    if moved < 1:
        raise AssertionError("no nomination was released on another thread's node")
    log(f"kernels vs plain [nominations]: {moved} released on nodes of other threads")
    for n_nodes in (15000, 500):
        bw, pw = encode(*basic_case(n_nodes=n_nodes, n_bound=min(1000, n_nodes)),
                        C.Profile())
        check_case(f"SchedulingBasic {bw.requests.shape[0]}x{bw.alloc.shape[0]}", bw, pw,
                   results, batched=False)
    torch.cuda.synchronize()


# ------------------------------------------ 3p. the pod classes of B3
# (leaf path, pod): pod ``pod`` of a pairwise batch differs from pod 0 in
# this leaf alone (the leaves a batch lacks are skipped)
PAIRWISE = (("requests", 1), ("nonzero_requests", 3), ("pod_valid", 5), ("pod_ports", 7),
            ("static_sig", 9), ("score_sig", 11), ("image_sig", 13), ("image_count", 15),
            ("dra_score_sig", 17), ("nominated_gate", 19), ("podaffinity.update", 21),
            ("podaffinity.fa_self", 23), ("podaffinity.score_vals", 25),
            ("spread.max_skew", 27), ("spread.min_domains", 29), ("spread.self_match", 31),
            ("spread.pod_match_sig", 33), ("spread.ignored", 35))


def batch_numpy(b) -> dict:
    """The numpy leaves of a device batch (``device_batch_from_numpy``'s
    names; the spread leaf without template ids, so its ignored rows are
    keyed whole)."""
    from types import SimpleNamespace

    from kubetpu_torch.framework import runtime as rt

    out = {}
    for name, v in rt.batch_leaves(b).items():
        if name in rt.NESTED and v is not None:
            _, fields, flags = rt.NESTED[name]
            out[name] = SimpleNamespace(
                **{f: getattr(v, f).cpu().numpy().copy() for f in fields},
                **{f: getattr(v, f) for f in flags})
        else:
            out[name] = None if v is None else v.cpu().numpy().copy()
    return out


def pairwise(b):
    """``b`` rebuilt with pod ``i`` of each ``PAIRWISE`` entry changed in
    that leaf alone (a signature moved to another row of its table, a flag
    flipped, a count raised by one), so those pods differ pairwise in one
    leaf each. Returns ``(batch, leaves changed)``."""
    from kubetpu_torch.framework import runtime as rt

    leaves = batch_numpy(b)
    tables = {"static_sig": "static_mask", "score_sig": "node_affinity_raw",
              "image_sig": "image_sum_scores", "dra_score_sig": "dra_score_raw"}
    changed = []
    for path, i in PAIRWISE:
        parent, _, field = path.rpartition(".")
        obj = leaves.get(parent) if parent else leaves
        a = None if obj is None else (obj.get(field) if isinstance(obj, dict)
                                      else getattr(obj, field))
        if a is None or i >= a.shape[0]:
            continue
        if field in tables:
            table = leaves.get(tables[field])
            if table is None:
                table = leaves.get("taint_prefer_raw")
            if table is None or table.shape[0] < 2:
                continue
            a[i] = (a[i] + 1) % table.shape[0]
        else:
            cell = (i,) + (0,) * (a.ndim - 1)
            a[cell] = (not a[cell]) if a.dtype == bool else a[cell] + 1
        changed.append(path)
    return rt.device_batch_from_numpy(leaves, b.device), changed


def singletons(b):
    """``b`` rebuilt with every real pod's first request distinct: every
    pod a class of its own."""
    from kubetpu_torch.framework import runtime as rt

    import numpy as np

    leaves = batch_numpy(b)
    n = int(leaves["pod_valid"].sum())
    for name in ("requests", "nonzero_requests"):
        leaves[name][:n, 0] += np.arange(n, dtype=leaves[name].dtype)
    return rt.device_batch_from_numpy(leaves, b.device)


def class_checks(results, basic, podaffinity, preferred, mesh, grid) -> dict:
    """B3 on its pod classes, exact against the plain version: the
    BinPacking block (its four pod sizes), SchedulingBasic,
    SchedulingPodAffinity and PreferredTopologySpreading rebuilt with pods
    that differ pairwise in one leaf each (``pairwise``), an all-singleton
    batch and the webhook batch (every pod its own class: today's launch);
    the greedy engine (B3 without the total, then B4) on the Basic pairwise
    batch and the batched rounds on it and on PodAffinity's; then the
    sharded entry (``kt_filter_score_shard``, K2's
    and K6's first half) on the node mesh and on the grid against the
    unsharded kernel. Returns each batch's class count."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.batched import batched_assign_plain
    from kubetpu_torch.assign.greedy import greedy_assign_plain
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.framework import runtime as rt
    from kubetpu_torch.parallel import mesh as M

    def fs_equal(name, b, params):
        km, kt = kernels.filter_score(b, params)
        pm, pt = rt.feasible_and_scores(b, params)
        torch.cuda.synchronize()
        err = max(_max_abs(km, pm), _max_abs(kt, pt))
        if not (torch.equal(km, pm) and torch.equal(kt, pt)):
            raise AssertionError(f"{name}: filter_score differs from the plain version "
                                 f"(max abs err {err})")
        results["filter_score"]["cases"].append(name)
        results["filter_score"]["max_abs_err"] = max(results["filter_score"]["max_abs_err"],
                                                     err)
        return km, kt

    classes = {}
    bb, bpar = encode(*binpack_case(), C.Profile())
    basic2, changed_b = pairwise(basic[0])
    aff2, changed_a = pairwise(podaffinity[0])
    pref2, changed_p = pairwise(preferred[0])
    for name, b, params, engines in (
            ("BinPacking 1024x5120", bb, bpar, ""),
            (f"SchedulingBasic pairwise ({len(changed_b)} leaves)", basic2, basic[1], "both"),
            (f"SchedulingPodAffinity pairwise ({len(changed_a)} leaves)", aff2, podaffinity[1],
             "batched"),
            (f"PreferredTopologySpreading pairwise ({len(changed_p)} leaves)", pref2,
             preferred[1], ""),
            ("SchedulingBasic all singletons", singletons(basic[0]), basic[1], ""),
            ("SchedulingBasic + webhook", with_extender(basic[0]), basic[1], "")):
        cl = rt.pod_classes(b)
        classes[name] = int(b.requests.shape[0]) if cl is None else cl.count
        km, _ = fs_equal(f"{name}, {classes[name]} classes", b, params)
        if engines in ("greedy", "both"):
            ka, ks = kernels.greedy_scan(b, params)
            pa, ps = greedy_assign_plain(b, params)
            torch.cuda.synchronize()
            err = _engine_err(f"{name} greedy_scan", ka, ks, pa, ps)
            results["greedy_scan"]["cases"].append(f"{name} (classes)")
            results["greedy_scan"]["max_abs_err"] = max(results["greedy_scan"]["max_abs_err"],
                                                        err)
        if engines in ("batched", "both"):
            k_rounds, p_rounds = [], []
            va, vs = kernels.batched_assign(b, params, rounds_out=k_rounds)
            wa, ws = batched_assign_plain(b, params, rounds_out=p_rounds)
            torch.cuda.synchronize()
            err = _engine_err(f"{name} batched_round", va, vs, wa, ws)
            if k_rounds != p_rounds:
                raise AssertionError(f"{name}: batched rounds {k_rounds} != plain {p_rounds}")
            results["batched_round"]["cases"].append(f"{name} (classes)")
        log(f"kernels vs plain [{name}]: {classes[name]} pod classes of "
            f"{b.requests.shape[0]} pods; filter_score exact"
            + (f", {engines} engine(s) exact" if engines else ""))
    # the sharded entry on the classes, over the node mesh and the grid
    for name, b, params in (("BinPacking 1024x5120", bb, bpar),
                            ("SchedulingBasic pairwise", basic2, basic[1]),
                            ("PreferredTopologySpreading pairwise", pref2, preferred[1])):
        km, kt = kernels.filter_score(b, params)
        for label, layout in (("node mesh", mesh), ("grid", grid)):
            sb = M.shard_batch(b, layout)
            mask, total = rt.filter_score_batch(sb, params)
            if not (torch.equal(mask.gather().to(km.device), km)
                    and torch.equal(total.gather().to(kt.device), kt)):
                raise AssertionError(f"{name}: the sharded filter_score on the {label} "
                                     f"differs from the kernel")
            results["filter_score"]["cases"].append(f"{name} sharded on the {label}")
        log(f"kernels vs plain [{name}]: the sharded filter_score on the node mesh and the "
            f"grid equal to the unsharded kernel")
    return classes


# ----------------------------------------- 3m. the node mesh (K1-K4, B5m)
# the mesh's kernels, their sources and the device programs they replace
MESH_KERNELS = (
    ("sharded_scan", "kubetpu_torch/kernels/csrc/greedy_scan.cu (tiled_scan_kernel on one "
     "pod row; + scan_loop.cuh, exchange.cuh)", "kubetpu/parallel/mesh.py:234 (sharded_greedy)"),
    ("sharded_round", "kubetpu_torch/kernels/csrc/batched_round.cu (one launch a solve on "
     "each card, one pod row; + filter_pass.cuh, solve_sync.cuh, exchange.cuh)",
     "kubetpu/parallel/mesh.py:352 (sharded_batched)"),
    ("shard_pick", "kubetpu_torch/kernels/csrc/dry_run_preemption.cu",
     "kubetpu/parallel/mesh.py:161 (batch_shardings) with kubetpu/ops/preemption.py:156 "
     "(pick_node across node shards)"),
    ("shard_argmax", "kubetpu_torch/kernels/csrc/greedy_scan.cu (+ exchange.cuh)",
     "kubetpu/parallel/mesh.py:327 (measure_collective_wall)"),
    ("sharded_packing", "kubetpu_torch/kernels/csrc/packing_round.cu (one launch a solve on "
     "each card, one pod row; + filter_pass.cuh, solve_sync.cuh, exchange.cuh)",
     "kubetpu/parallel/mesh.py:369 (sharded_packing)"),
    ("tiled_round", "kubetpu_torch/kernels/csrc/batched_round.cu (one launch a solve on "
     "each card; + filter_pass.cuh, solve_sync.cuh, exchange.cuh)",
     "kubetpu/parallel/mesh.py:352 (sharded_batched with pod_axis=\"pods\")"),
    ("tiled_scan", "kubetpu_torch/kernels/csrc/greedy_scan.cu (+ scan_loop.cuh, exchange.cuh)",
     "kubetpu/parallel/mesh.py:234 (sharded_greedy with pod_axis=\"pods\")"),
    ("tiled_packing", "kubetpu_torch/kernels/csrc/packing_round.cu (one launch a solve on "
     "each card; + filter_pass.cuh, solve_sync.cuh, exchange.cuh)",
     "kubetpu/parallel/mesh.py:369 (sharded_packing with pod_axis=\"pods\")"),
)


def node_mesh(shards: int, one_card: bool):
    """``shards`` logical shards on cuda:0, or one shard a card."""
    import torch

    from kubetpu_torch.parallel import mesh as M

    if one_card:
        return M.make_mesh([torch.device("cuda", 0)] * shards)
    return M.make_mesh([torch.device("cuda", i) for i in range(shards)])


def _whole(x):
    """A sharded result joined on its first device (a read-back)."""
    from kubetpu_torch.parallel.mesh import ShardedTensor

    return x.gather() if isinstance(x, ShardedTensor) else x


def _mesh_err(name, got, want) -> int:
    """``_engine_err`` of a sharded engine's output against an unsharded
    one's (or another sharded one's)."""
    (ga, gs), (wa, ws) = got, want
    dev = wa.device
    gs = tuple(None if x is None else _whole(x).to(dev) for x in gs)
    ws = tuple(None if x is None else _whole(x).to(dev) for x in ws)
    return _engine_err(name, ga.to(dev), gs, wa, ws)


def wall_ms(fn, reps: int) -> float:
    """Median wall ms of ``fn`` (which ends in a host sync), after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def tie_case(mesh, n_nodes=5000, n_pending=1024):
    """Identical nodes with the first shard full but for its last node: the
    best score then ties between that node and every node of the later
    shards, so the first maximum is the first shard's last node and the
    scan crosses the boundary with every later pick. A pick that let a
    later shard win a tie, or took a shard's lowest local index first,
    lands elsewhere."""
    from kubetpu_torch.perf import workloads as W
    from kubetpu_torch.state import encoder as enc

    per = enc.shard_aligned(enc.round_up(n_nodes), mesh.size) // mesh.size
    nodes = [W.node_default(i) for i in range(n_nodes)]
    bound = [W.pod_default(f"fill-{j}", "namespace-0").with_node(nodes[j].name)
             for j in range(per - 1)]
    pending = [W.pod_default(f"tie-{j}", "namespace-1") for j in range(n_pending)]
    return _cache_with(nodes, bound), pending, per - 1


def mesh_checks(mesh, results, batches, basic, round_batches) -> dict:
    """Phase 3 on the mesh, all exact on CUDA tensors:

    - K4: the cross-shard argmax of a 2^14 int64 vector against its plain
      version; one exchange round trip timed as the difference of 1001 and
      1 exchanges;
    - K1: the sharded ``greedy_scan`` against the unsharded kernel on every
      batch of ``batches`` (each template variant: none, affinity, spread,
      DRA), and against its plain version (``greedy_assign_tiled_plain``:
      each shard's steps in lockstep, explicit reductions) where asked;
      then the tie batch, whose first pick must be the first shard's last
      node;
    - K2: the sharded ``filter_score`` (mask and total) against the
      unsharded kernel, and the sharded batched rounds against the
      unsharded ``batched_round`` engine (assignments, the seven slots,
      rounds) and the sharded plain rounds, on every batch of
      ``round_batches``;
    - K3: the sharded dry run against the unsharded kernel and its plain
      version at 5120 x 8 and 5120 x 128;
    - B5m: a SchedulingBasic resident block sharded over the mesh, after a
      routed delta, against the unsharded block after the same delta.

    Returns the mesh kernels' timing entries."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.greedy import greedy_assign_tiled_plain
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.framework import runtime as rt
    from kubetpu_torch.ops import preemption as OP
    from kubetpu_torch.parallel import mesh as M

    G = mesh.size
    for k, _, _ in MESH_KERNELS:
        results.setdefault(k, {"cases": [], "max_abs_err": 0})

    def note(kernel, case, err):
        results[kernel]["cases"].append(case)
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)

    timing = {}
    # K4, and the exchange's round trip
    n = 1 << 14
    per = n // G
    pieces = [torch.arange(g * per, (g + 1) * per, dtype=torch.int64, device=d)
              for g, d in enumerate(mesh.devices)]
    got = kernels.shard_argmax(pieces, mesh)
    want = M.shard_argmax_plain(pieces)
    if got != want or got != n - 1:
        raise AssertionError(f"shard_argmax: {got}, plain {want}, expected {n - 1}")
    note("shard_argmax", f"2^14 int64 over {G} shards", 0)
    one = wall_ms(lambda: kernels.shard_argmax(pieces, mesh), 9)
    many = wall_ms(lambda: kernels.shard_argmax(pieces, mesh, reps=1001), 3)
    whole = torch.cat([x.to(mesh.devices[0]) for x in pieces])
    timing["shard_argmax"] = {
        "ms": one, "plain_ms": wall_ms(lambda: M.shard_argmax_plain(pieces), 5),
        "library_ms": cuda_ms(lambda: torch.argmax(whole), 20),
        "library_host_ms": wall_ms(lambda: int(torch.argmax(whole)), 21),
        "bytes": n * 8, "ops": 0, "shape": [n, G],
        "exchange_us": 1e3 * (many - one) / 1000,
        "collective_wall_s": M.measure_collective_wall(mesh),
    }
    k4 = timing["shard_argmax"]
    log(f"mesh [{G} shards on {len(mesh.cards())} card(s)] shard_argmax exact; host wall "
        f"{one:.4f} ms a call (torch.argmax with its read {k4['library_host_ms']:.4f} ms); one "
        f"exchange round trip {k4['exchange_us']:.3f} us; measure_collective_wall "
        f"{k4['collective_wall_s'] * 1e3:.4f} ms")
    # K1 on every batch; the plain engine timed on the first batch it runs on
    plain_ms = plain_shape = None
    for name, b, params, with_plain in batches:
        sb = M.shard_batch(b, mesh)
        got = kernels.tiled_greedy_scan(sb, params)
        err = _mesh_err(f"{name} sharded_scan vs greedy_scan", got,
                        kernels.greedy_scan(b, params))
        line = "the unsharded kernel"
        if with_plain:
            t0 = time.perf_counter()
            plain = greedy_assign_tiled_plain(sb, params)
            torch.cuda.synchronize()
            if plain_ms is None:
                plain_ms = 1e3 * (time.perf_counter() - t0)
                plain_shape = [b.requests.shape[0], b.alloc.shape[0], G]
            err = max(err, _mesh_err(f"{name} sharded_scan vs its plain version", got, plain))
            line += " and the sharded plain engine"
        note("sharded_scan", name, err)
        log(f"mesh [{name}] sharded_scan over {G} shards equal to {line} "
            f"(affinity {b.podaffinity is not None}, spread {b.spread is not None}, DRA "
            f"{b.dra_score_raw is not None and params.w_dra != 0})")
    cache_t, pending_t, first = tie_case(mesh)
    bt, ptie = encode(cache_t, pending_t, C.Profile())
    got = kernels.tiled_greedy_scan(M.shard_batch(bt, mesh), ptie)
    _mesh_err("tie batch", got, kernels.greedy_scan(bt, ptie))
    if int(got[0][0]) != first:
        raise AssertionError(f"tie batch: first pick {int(got[0][0])}, expected {first}")
    note("sharded_scan", "tie across the first shard boundary", 0)
    log(f"mesh [tie batch] first pick node {first} (the first shard's last), every "
        "assignment equal to the unsharded kernel")
    # K1 timing on the Basic batch (its full-size plain engine is not run:
    # the unsharded kernel is held to it at full size, K1 to that kernel)
    b, params = basic
    sb = M.shard_batch(b, mesh)
    P, N = b.requests.shape[0], b.alloc.shape[0]
    state_bytes = sum(int(x.nbytes) for x in (b.requested, b.nonzero_requested,
                                              b.pod_count, b.node_ports))
    timing["sharded_scan"] = {
        "ms": cuda_ms(lambda: kernels.tiled_greedy_scan(sb, params), 5),
        "unsharded_ms": cuda_ms(lambda: kernels.greedy_scan(b, params), 5),
        "plain_ms": plain_ms, "plain_shape": plain_shape,
        "bytes": rt.batch_nbytes(b) + P * 4 + state_bytes,
        "ops": scored_pods(b) * N * f64_ops_per_pair(params, b), "shape": [P, N, G],
        "exchanges_per_step": 1,
    }
    # K2: the sharded filter_score and batched rounds
    from kubetpu_torch.assign.batched import batched_assign_tiled_plain

    for name, b, params, with_plain in round_batches:
        sb = M.shard_batch(b, mesh)
        mask, total = rt.filter_score_batch(sb, params)
        km, kt = kernels.filter_score(b, params)
        if not (torch.equal(mask.gather().to(km.device), km)
                and torch.equal(total.gather().to(kt.device), kt)):
            raise AssertionError(f"{name}: the sharded filter_score differs from the kernel")
        k_rounds, s_rounds = [], []
        got = kernels.tiled_batched_assign(sb, params, rounds_out=s_rounds)
        err = _mesh_err(f"{name} sharded batched rounds vs batched_round", got,
                        kernels.batched_assign(b, params, rounds_out=k_rounds))
        if s_rounds != k_rounds:
            raise AssertionError(f"{name}: sharded rounds {s_rounds} != {k_rounds}")
        if with_plain:
            p_rounds = []
            plain = batched_assign_tiled_plain(sb, params, rounds_out=p_rounds)
            torch.cuda.synchronize()
            err = max(err, _mesh_err(f"{name} sharded rounds vs the sharded plain rounds",
                                     got, plain))
        note("sharded_round", name, err)
        log(f"mesh [{name}] sharded filter_score and batched rounds ({s_rounds[0]} rounds) "
            f"over {G} shards equal to the unsharded kernels"
            + (" and the sharded plain rounds" if with_plain else ""))
        if "sharded_round" not in timing:
            Pp, Np = b.requests.shape[0], b.alloc.shape[0]
            p_state = sum(int(x.nbytes) for x in (b.requested, b.nonzero_requested,
                                                  b.pod_count, b.node_ports))
            t0 = time.perf_counter()
            batched_assign_tiled_plain(sb, params)
            torch.cuda.synchronize()
            timing["sharded_round"] = {
                "ms": cuda_ms(lambda: kernels.tiled_batched_assign(sb, params), 5),
                "unsharded_ms": cuda_ms(lambda: kernels.batched_assign(b, params), 5),
                "plain_ms": 1e3 * (time.perf_counter() - t0),
                "bytes": rt.batch_nbytes(b) + Pp * 4 + p_state, "ops":
                k_rounds[0] * scored_pods(b) * Np * f64_ops_per_pair(params, b),
                "shape": [Pp, Np, G], "rounds": k_rounds[0], "batch": name,
            }
    # K3
    for K, D in ((8, 3), (128, 5)):
        args = victim_tensors(0, 5120, K, D)
        want = kernels.dry_run_preemption(*args)
        per = 5120 // G
        rows = set(range(3, 15))
        shard_args = [tuple(x[g * per:(g + 1) * per].to(mesh.devices[g]).contiguous()
                            if j in rows else (x.to(mesh.devices[g]) if hasattr(x, "to") else x)
                            for j, x in enumerate(args)) for g in range(G)]
        offsets = [g * per for g in range(G)]
        got = OP.dry_run_preemption_sharded(shard_args, offsets)
        plain = OP.dry_run_preemption_sharded_plain(shard_args, offsets)
        for other, label in ((want, "the unsharded kernel"), (plain, "the plain version")):
            if int(got[0]) != int(other[0]):
                raise AssertionError(f"shard_pick K={K}: node {int(got[0])} vs {label}'s "
                                     f"{int(other[0])}")
            for nm, x, w in zip(("victims", "ok", "n_pdb"), got[1:], other[1:]):
                if not torch.equal(_whole(x), _whole(w).to(_whole(x).device)):
                    raise AssertionError(f"shard_pick K={K}: {nm} differs from {label}")
        note("shard_pick", f"5120x{K}, D={D}", 0)
        if K == 8:
            timing["shard_pick"] = {
                "ms": cuda_ms(lambda: OP.dry_run_preemption_sharded(shard_args, offsets), 20),
                "unsharded_ms": cuda_ms(lambda: kernels.dry_run_preemption(*args), 20),
                "plain_ms": cuda_ms(
                    lambda: OP.dry_run_preemption_sharded_plain(shard_args, offsets), 3),
                "bytes": dry_run_nbytes(args), "ops": 0, "shape": [5120, K, G],
            }
        log(f"mesh [dry run 5120x{K}] sharded (B9 a shard, then shard_pick) equal to the "
            f"unsharded kernel and the plain version: node {int(got[0])}")
    # B5m: the routed delta into a sharded resident block
    cache_r, pending_r = basic_case()
    prof = C.Profile()
    sharded = rt.ResidentNodeState("cuda", mesh=mesh)
    single = rt.ResidentNodeState("cuda")
    snap = cache_r.update_snapshot()
    outs = [rt.encode_batch(snap, pending_r, prof, resident=r, device="cuda")
            for r in (sharded, single)]
    from kubetpu_torch.perf import workloads as W

    for j in range(1500):
        cache_r.add_pod(W.pod_default(f"dirty-{j}", "namespace-2").with_node(
            f"scheduler-perf-{(j * 7) % 5000}"))
    snap = cache_r.update_snapshot(snap)
    outs = [rt.encode_batch(snap, pending_r, prof, prev_nt=o.node_tensors, resident=r,
                            device="cuda") for o, r in zip(outs, (sharded, single))]
    torch.cuda.synchronize()
    rows = sum(sharded.last_rows_per_shard)
    if not 0 < sharded.last_upload_bytes < sharded.nbytes:
        raise AssertionError("routed scatter: the delta was not routed")
    for f in rt.NODE_FIELDS:
        whole = torch.cat([getattr(x, f).to(mesh.devices[0]) for x in sharded.shards])
        if not torch.equal(whole, getattr(single.device, f).to(mesh.devices[0])):
            raise AssertionError(f"routed scatter: {f} differs from the unsharded block")
    note("scatter_rows", f"routed delta over {G} shards ({rows} rows)", 0)
    # B5m's time: the same routed delta scattered again (idempotent), each
    # shard's block on its card, against the unsharded scatter of the same rows
    nt = outs[0].node_tensors
    dirty = sorted(set(range(5000)) & {(j * 7) % 5000 for j in range(1500)})
    routed = sharded._routed(nt, dirty, nt.num_nodes)
    shipped = [None if d is None else rt.upload_packed(d, mesh.devices[g])
               for g, d in enumerate(routed)]
    whole_delta = rt.upload_packed(single._delta(nt, dirty, nt.num_nodes), mesh.devices[0])

    def scatter_routed():
        for g, t_ in enumerate(shipped):
            if t_ is not None:
                with rt.on_device(mesh.devices[g]):
                    sharded.block(g).scatter(t_)

    def scatter_routed_plain():
        for g, t_ in enumerate(shipped):
            if t_ is not None:
                rt.scatter_node_rows_plain(sharded.shards[g], t_[rt.DELTA_FIELDS[0]],
                                           tuple(t_[n] for n in rt.DELTA_FIELDS[1:]))

    timing["routed_scatter"] = {
        "ms": cuda_ms(scatter_routed, 20), "plain_ms": cuda_ms(scatter_routed_plain, 5),
        "unsharded_ms": cuda_ms(lambda: single.scatter(whole_delta), 20),
        "bytes": sum(int(x.nbytes) for t_ in shipped if t_ is not None for x in t_.values()),
        "rows": len(dirty),
    }
    log(f"timing [scatter_rows routed over {G} shards] {len(dirty)} rows: kernels "
        f"{timing['routed_scatter']['ms']:.4f} ms, plain {timing['routed_scatter']['plain_ms']:.4f}"
        f" ms, unsharded scatter {timing['routed_scatter']['unsharded_ms']:.4f} ms")
    log(f"mesh [routed scatter] {rows} dirty rows to {G} shards "
        f"({sharded.last_rows_per_shard}), {sharded.last_upload_bytes} bytes, every shard's "
        "block equal to its slice of the unsharded block")
    torch.cuda.synchronize()
    return timing


def hard_spread_case(n_nodes=5000, n_pending=8):
    """A cluster where a hard zone spread constraint's verdict needs the
    global counts: every node nearly full (a 900m filler on 4000m less
    3000m of capacity), zones z-a / z-b alternating over the first 3840
    nodes and z-c on the rest (the last quarter of 5120 padded rows: the
    last shard of four, the second column of two). app=x pods count z-a 12
    (all below node 1280), z-b 30 (ten in each of the first three
    quarters), z-c 10. The preemptors (priority 100, app=x, maxSkew 11 over
    zones) pass z-a (12 + 1 - 10) and z-c, and fail z-b (30 + 1 - 10 = 21);
    a shard or column that counted alone (z-c absent: minMatch 0, ten z-b
    pods) would pass its z-b nodes."""
    from kubetpu_torch.api import wrappers as WR

    def zone(i):
        return "z-c" if i >= 3840 else ("z-a", "z-b")[i % 2]

    nodes = [WR.make_node(f"hs-{i}", cpu_milli=1000, memory=2**33,
                          labels={"topology.kubernetes.io/zone": zone(i)})
             for i in range(n_nodes)]
    za = [i for i in range(0, 1280) if zone(i) == "z-a"][:12]
    zb = [i for q in range(3) for i in range(q * 1280, (q + 1) * 1280) if zone(i) == "z-b"][
        ::64][:30]
    zc = list(range(3840, n_nodes))[:10]
    match = set(za) | set(zb) | set(zc)
    bound = [WR.make_pod(f"fill-{i}", cpu_milli=900, priority=i % 3, node_name=f"hs-{i}",
                         creation_index=i, labels={"app": "x"} if i in match else {})
             for i in range(n_nodes)]
    spread = WR.spread_constraint(11, "topology.kubernetes.io/zone",
                                  match_labels={"app": "x"})
    pending = [WR.make_pod(f"pre-{j}", cpu_milli=800, priority=100, creation_index=n_nodes + j,
                           labels={"app": "x"}, spread=[spread]) for j in range(n_pending)]
    return _cache_with(nodes, bound), pending


def potential_mesh_checks(layouts, results) -> dict:
    """Item 21 on the card: the potential mask of ``hard_spread_case``'s
    preemptors over each layout of ``layouts`` (name, mesh: a node mesh or a
    pods x nodes grid), through the sharded potential mode
    (``kernels.sharded_potential_mask``, each pod on its pod row's columns),
    exact against the unsharded kernel and the plain version; and the mask
    that the shards' own counts give (the plain filters on each shard
    alone) differs from it, so the batch decides. Returns each layout's
    times of the last pod's mask (CUDA events): the sharded kernel, the
    unsharded kernel, the plain version."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.framework import runtime as rt
    from kubetpu_torch.framework.preemption import (PreemptionEvaluator, _one_pod_view,
                                                    _potential_of)
    from kubetpu_torch.parallel import mesh as M

    batch, params = encode_batch_full(*hard_spread_case(), C.Profile())
    b = batch.device
    if b.spread is None or not b.spread.has_hard:
        raise AssertionError("the hard spread case carries no DoNotSchedule constraint")
    ev = PreemptionEvaluator(batch, params)
    up = ev._upload(ev._potential_arrays())
    pods = list(range(batch.num_pods))
    counts = b.spread.node_count
    timing = {}
    for name, mesh in layouts:
        sb = M.shard_batch(b, mesh)
        ng, pb = sb.columns, int(sb.shards[0].requests.shape[0])
        decided = 0
        for i in pods:
            r, q = divmod(i, pb)
            shards = sb.shards[r * ng:(r + 1) * ng]
            states, local = [], []
            for s, off in zip(shards, sb.offsets):
                n = int(s.alloc.shape[0])
                cut = (up["requested"][off:off + n], up["pod_count"][off:off + n],
                       up["node_ports"][off:off + n], counts[:, off:off + n].contiguous(),
                       None)
                states.append(tuple(None if x is None else x.to(s.device) for x in cut))
                view = _one_pod_view(s, q)
                comps = rt.filter_components(view, params, requested=states[-1][0],
                                             pod_count=states[-1][1], node_ports=states[-1][2],
                                             spread_counts=states[-1][3])
                local.append(_potential_of(*comps[:5]))
            views = [_one_pod_view(s, q) for s in shards]

            def sharded(views=views, row=mesh.row(r), states=states):
                return kernels.sharded_potential_mask(views, row, params, states,
                                                      [None] * len(views))

            got = torch.cat([x.to(b.alloc.device) for x in sharded()])
            unsharded = ev._potential_mask(i, up)
            plain = ev._potential_mask_plain(i, up)
            torch.cuda.synchronize()
            for what, want in (("the unsharded kernel", unsharded),
                               ("the plain version", plain)):
                if not torch.equal(got, want):
                    raise AssertionError(f"{name}: pod {i}'s sharded potential mask differs "
                                         f"from {what}")
            decided += int((torch.cat([x.to(got.device) for x in local]) != got).sum())
        if not decided:
            raise AssertionError(f"{name}: the shards' own counts give the same masks; the "
                                 "batch does not test the combine")
        results["filter_score"]["cases"].append(f"sharded potential mask, hard spread, {name}")
        timing[name] = {"ms": cuda_ms(sharded, 20),
                        "unsharded_ms": cuda_ms(lambda: ev._potential_mask(i, up), 20),
                        "plain_ms": cuda_ms(lambda: ev._potential_mask_plain(i, up), 5)}
        log(f"mesh [{name}] sharded potential mask with a hard spread constraint exact against "
            f"the unsharded kernel and the plain version on {len(pods)} pods "
            f"({int(plain.sum())} potential nodes of the last; {decided} node verdicts a "
            f"shard's own counts would have given otherwise); the last pod's mask "
            f"{timing[name]['ms']:.4f} ms, unsharded {timing[name]['unsharded_ms']:.4f} ms, "
            f"plain {timing[name]['plain_ms']:.4f} ms")
    return timing


def grid_mesh(one_card: bool):
    """A 2 x 2 pods x nodes grid: four logical tiles on cuda:0, or one tile
    a card."""
    import torch

    from kubetpu_torch.parallel import mesh as M

    devs = [torch.device("cuda", 0)] * 4 if one_card else [
        torch.device("cuda", i) for i in range(4)]
    return M.make_mesh_2d(devs, pods=2)


def packing_mesh_batches(basic):
    """The batches K5 is held on: (name, batch, params, with the sharded
    plain solve too): the BinPacking block (bins open one a round), the
    SchedulingBasic block (``basic``: its batch and
    params) with and without the 32-slice fleet, and the BinPacking batch
    cut to 256 pods with and without the slices (its slices span the shard
    boundaries), where the plain solve runs too."""
    from kubetpu_torch.framework import config as C

    out = []
    cache_b, pending_b = binpack_case()
    # the full block's plain solve is not repeated: the unsharded kernel is
    # held to it at full size (packing_checks) and K5 to that kernel here
    out.append(("BinPacking 1024x5120", *encode(cache_b, pending_b, C.Profile()), False))
    cache, pending = basic_case()
    out.append(("SchedulingBasic 1024x5120", *basic, False))
    bs, ps = encode_topology(sliced(cache, SLICES), pending, C.Profile())
    out.append(("SchedulingBasic, 32 slices", bs.device, ps, False))
    cache_c, pending_c = binpack_case(n_pending=256)
    out.append(("BinPacking 256x5120", *encode(cache_c, pending_c, C.Profile()), True))
    bt, pt = encode_topology(sliced(cache_c, SLICES), pending_c, C.Profile())
    out.append(("BinPacking 256x5120, 32 slices", bt.device, pt, True))
    return out


def _packing_mesh_err(name, got, want) -> int:
    """A sharded solve against another solve: assignments, the seven state
    slots, the duals (bits), iterations and nodes used exactly, the
    objective within rtol 1e-5 (its float32 sums are taken in another
    order)."""
    ga, gs, glam, gobj, git, gnu = got
    wa, ws, wlam, wobj, wit, wnu = want
    err = _mesh_err(name, (ga, gs), (wa, ws))
    dev = wa.device
    err = max(err, _bits_equal(f"{name} duals", _whole(glam).to(dev).contiguous(),
                               _whole(wlam).to(dev).contiguous()))
    if git != wit or int(gnu) != int(wnu):
        raise AssertionError(f"{name}: {git} iterations, {int(gnu)} nodes used; the other "
                             f"{wit}, {int(wnu)}")
    rel = abs(float(gobj) - float(wobj)) / max(abs(float(wobj)), 1e-30)
    if rel > 1e-5:
        raise AssertionError(f"{name}: objective {float(gobj)} against {float(wobj)} "
                             f"(rel {rel})")
    return err


def packing_stop_checks(layout, kernel, results, name, b, params) -> None:
    """The stop rule of the solve over ``layout`` (a node mesh or a grid,
    counted as ``kernel``) on the device: stopped at 1 and 2 rounds against
    the unsharded kernel and the tiled plain solve stopped alike, and a
    batch with no pod valid (no round)."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign import packing as PK
    from kubetpu_torch.parallel import mesh as M

    weights = PK.PackingWeights().tensor("cuda")
    for label, batch, caps in ((name, b, (1, 2)), (f"{name}, no pod valid", idle_batch(b),
                                                   (0,))):
        sb = M.shard_batch(batch, layout)
        cold = torch.zeros(batch.alloc.shape[0], dtype=torch.float32, device="cuda")
        for cap in caps:

            def pieces():
                return [torch.zeros(s.alloc.shape[0], dtype=torch.float32, device=s.device)
                        for s in sb.shards]

            got = kernels.tiled_packing_assign(sb, params, pieces(), weights, cap)
            err = _packing_mesh_err(f"{label} {kernel} stopped at {cap}", got,
                                    kernels.packing_assign(batch, params, cold, weights, cap))
            err = max(err, _packing_mesh_err(
                f"{label} {kernel} stopped at {cap} vs its plain version", got,
                PK.packing_assign_tiled_plain(sb, params, pieces(), weights, cap)))
            if cap == 0 and got[4] != 0:
                raise AssertionError(f"{label} {kernel}: {got[4]} rounds with no pod valid")
            results[kernel]["cases"].append(f"{label}, stopped at {cap or 'P'}")
            results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)
            log(f"[{label}] {kernel} stopped at {cap or 'P'} rounds equal to the unsharded "
                f"kernel and the tiled plain solve ({got[4]} iterations)")


def packing_mesh_checks(mesh, results, cases) -> dict:
    """K5 on the node mesh: the sharded solve against the unsharded
    ``packing_assign`` on every batch of ``cases`` (cold duals) and, where
    asked, against ``packing_assign_tiled_plain``; timed with CUDA events
    beside the unsharded kernel on the full BinPacking block and on the cut
    one (its plain version once, on the cut block). Returns K5's timing
    entry."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign import packing as PK
    from kubetpu_torch.framework import runtime as rt
    from kubetpu_torch.parallel import mesh as M

    G = mesh.size
    weights = PK.PackingWeights().tensor("cuda")
    results.setdefault("sharded_packing", {"cases": [], "max_abs_err": 0})
    timing = {}
    for name, b, params, with_plain in cases:
        N = b.alloc.shape[0]
        sb = M.shard_batch(b, mesh)

        def pieces(sb=sb):
            return [torch.zeros(s.alloc.shape[0], dtype=torch.float32, device=s.device)
                    for s in sb.shards]

        cold = torch.zeros(N, dtype=torch.float32, device="cuda")
        got = kernels.tiled_packing_assign(sb, params, pieces(), weights)
        want = kernels.packing_assign(b, params, cold, weights)
        err = _packing_mesh_err(f"{name} sharded_packing vs packing_round", got, want)
        line = "the unsharded kernel"
        plain_ms = None
        if with_plain:
            t0 = time.perf_counter()
            plain = PK.packing_assign_tiled_plain(sb, params, pieces(), weights)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            err = max(err, _packing_mesh_err(f"{name} sharded_packing vs its plain version",
                                             got, plain))
            line += " and the sharded plain solve"
        results["sharded_packing"]["cases"].append(name)
        results["sharded_packing"]["max_abs_err"] = max(
            results["sharded_packing"]["max_abs_err"], err)
        log(f"mesh [{name}] sharded_packing over {G} shards equal to {line} "
            f"({got[4]} iterations, {int(got[5])} nodes used, objective {float(got[3]):.6f} "
            f"against {float(want[3]):.6f}; topology {b.topology is not None})")
        P = b.requests.shape[0]
        state_bytes = sum(int(x.nbytes) for x in (b.requested, b.nonzero_requested,
                                                  b.pod_count, b.node_ports))
        if not name.startswith("BinPacking") or "slices" in name:
            continue
        entry = {
            "ms": cuda_ms(lambda: kernels.tiled_packing_assign(sb, params, pieces(),
                                                               weights), 3),
            "unsharded_ms": cuda_ms(lambda: kernels.packing_assign(b, params, cold, weights),
                                    3),
            "plain_ms": plain_ms, "iterations": got[4], "batch": name,
            # the batch read and the outputs written once, and each round's
            # node rows, class rows, duals and pod vectors; each round's
            # float64 work over one pod a class
            "bytes": rt.batch_nbytes(b) + 2 * 4 * N + P * 4 + state_bytes
            + got[4] * packing_round_bytes(b),
            "ops": got[4] * scored_pods(b) * N * f64_ops_per_pair(params, b),
            "shape": [P, N, G],
        }
        if name == "BinPacking 1024x5120":
            timing.update(entry)
        else:
            timing["cut"] = entry
    # the plain solve's time: on the cut block (the full block's is not run)
    timing["plain_ms"], timing["plain_shape"] = timing["cut"]["plain_ms"], timing["cut"]["shape"]
    cut_case = next(c for c in cases if c[0] == "BinPacking 256x5120, 32 slices")
    packing_stop_checks(mesh, "sharded_packing", results, *cut_case[:3])
    cut = timing["cut"]
    log(f"timing [sharded_packing] on the BinPacking batch cut to {cut['shape'][0]} pods "
        f"({cut['iterations']} iterations): kernel {cut['ms']:.4f} ms, unsharded "
        f"{cut['unsharded_ms']:.4f} ms, plain {cut['plain_ms']:.4f} ms")
    return {"sharded_packing": timing}


def packing_grid_checks(grid, mesh, results, cases, full=None) -> dict:
    """K8 on the pods x nodes grid: the tiled solve against
    ``packing_assign_tiled_plain`` (assignments, every pod row's node
    slots, every tile's duals' bits, iterations and nodes used exactly, the
    objective within rtol 1e-5) and against the unsharded ``packing_assign``
    on every batch of ``cases`` (name, batch, params; cold duals), every pod
    row's copy of the node rows and of the duals equal to pod row 0's.
    Timed with CUDA events on the first case beside K5 (the solve over
    ``mesh``, a node mesh) and the unsharded kernel, its plain solve once;
    ``full`` (name, batch, params): the same at full size. Returns K8's
    timing entry."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign import packing as PK
    from kubetpu_torch.framework import runtime as rt
    from kubetpu_torch.parallel import mesh as M

    weights = PK.PackingWeights().tensor("cuda")
    results.setdefault("tiled_packing", {"cases": [], "max_abs_err": 0})
    shape = list(grid.shape)
    ng = grid.node_shards

    def pieces(sb):
        return [torch.zeros(s.alloc.shape[0], dtype=torch.float32, device=s.device)
                for s in sb.shards]

    def check(name, b, params):
        tb = M.shard_batch(b, grid)
        rows, plain_rows = [], []
        got = kernels.tiled_packing_assign(tb, params, pieces(tb), weights, rows_out=rows)
        cold = torch.zeros(b.alloc.shape[0], dtype=torch.float32, device="cuda")
        err = _packing_mesh_err(f"{name} tiled_packing vs packing_round", got,
                                kernels.packing_assign(b, params, cold, weights))
        t0 = time.perf_counter()
        plain = PK.packing_assign_tiled_plain(tb, params, pieces(tb), weights,
                                              rows_out=plain_rows)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        err = max(err, _packing_mesh_err(f"{name} tiled_packing vs its plain version", got,
                                         plain))
        for i, (row, prow) in enumerate(zip(rows, plain_rows)):
            for k, (x, y, z) in enumerate(zip(row, prow, rows[0])):
                if x is None:
                    continue
                x = _whole(x)
                if not (torch.equal(x, _whole(y).to(x.device))
                        and torch.equal(x, _whole(z).to(x.device))):
                    raise AssertionError(f"{name}: pod row {i}'s state slot {k} differs from "
                                         "the plain version's or from pod row 0's")
        for t, (x, y) in enumerate(zip(got[2].pieces, plain[2].pieces)):
            err = max(err, _bits_equal(f"{name} tile {t}'s duals", x, y.to(x.device)))
            err = max(err, _bits_equal(f"{name} tile {t}'s duals against pod row 0's", x,
                                       got[2].pieces[t % ng].to(x.device)))
        results["tiled_packing"]["cases"].append(name)
        results["tiled_packing"]["max_abs_err"] = max(results["tiled_packing"]["max_abs_err"],
                                                      err)
        log(f"grid [{name}] tiled_packing on the {shape} grid equal to the unsharded kernel "
            f"and the tiled plain solve, every pod row's node rows and duals equal "
            f"({got[4]} iterations, {int(got[5])} nodes used; topology "
            f"{b.topology is not None})")
        return tb, got, plain_ms

    def timed(name, b, params):
        tb, got, plain_ms = check(name, b, params)
        sb = M.shard_batch(b, mesh)
        cold = torch.zeros(b.alloc.shape[0], dtype=torch.float32, device="cuda")
        P, N = b.requests.shape[0], b.alloc.shape[0]
        state_bytes = sum(int(x.nbytes) for x in (b.requested, b.nonzero_requested,
                                                  b.pod_count, b.node_ports))
        return {
            "ms": cuda_ms(lambda: kernels.tiled_packing_assign(tb, params, pieces(tb),
                                                               weights), 3),
            "sharded_ms": cuda_ms(lambda: kernels.tiled_packing_assign(sb, params, pieces(sb),
                                                                       weights), 3),
            "unsharded_ms": cuda_ms(lambda: kernels.packing_assign(b, params, cold, weights),
                                    3),
            "plain_ms": plain_ms, "iterations": got[4], "batch": name,
            # the batch read and the outputs written once, and each round's
            # node rows, class rows, duals and pod vectors; each round's
            # float64 work over one pod a class
            "bytes": rt.batch_nbytes(b) + 2 * 4 * N + P * 4 + state_bytes
            + got[4] * packing_round_bytes(b),
            "ops": got[4] * scored_pods(b) * N * f64_ops_per_pair(params, b),
            "shape": [P, N] + shape,
        }

    timing = timed(*cases[0])
    for case in cases[1:]:
        check(*case)
    packing_stop_checks(grid, "tiled_packing", results, *cases[-1])
    lines = [("", timing)]
    if full is not None:
        timing["full"] = timed(*full)
        lines.append((" full", timing["full"]))
    for tag, tm in lines:
        log(f"timing [tiled_packing{tag}] on {tm['batch']} ({tm['iterations']} iterations) on "
            f"the {shape} grid: kernel {tm['ms']:.4f} ms, K5 on {mesh.size} shards "
            f"{tm['sharded_ms']:.4f} ms, unsharded {tm['unsharded_ms']:.4f} ms, plain "
            f"{tm['plain_ms']:.4f} ms")
    return {"tiled_packing": timing}


def grid_checks(grid, results, batches) -> dict:
    """K6 and K7 on the pods x nodes grid: the grid's batched rounds
    against the unsharded ``batched_round`` engine (assignments, the seven
    slots, rounds), every pod row's copy of the node rows against pod row
    0's, and the grid's scan against the unsharded ``greedy_scan``, on
    every batch of ``batches`` (name, batch, params, batch cut for the
    plain scan or None); the plain tiled rounds on every batch, the plain
    tiled scan on the cut batches and on the full SchedulingBasic batch
    (the grid greedy path's). Timed with CUDA events beside the unsharded
    kernels. Returns their timing entries."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.batched import batched_assign_tiled_plain
    from kubetpu_torch.assign.greedy import greedy_assign_tiled_plain
    from kubetpu_torch.framework import runtime as rt
    from kubetpu_torch.parallel import mesh as M

    shape = list(grid.shape)
    for k in ("tiled_round", "tiled_scan"):
        results.setdefault(k, {"cases": [], "max_abs_err": 0})

    def note(kernel, case, err):
        results[kernel]["cases"].append(case)
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)

    timing = {}
    for name, b, params, cut in batches:
        tb = M.shard_batch(b, grid)
        k_rounds, t_rounds, rows = [], [], []
        got = kernels.tiled_batched_assign(tb, params, rounds_out=t_rounds, rows_out=rows)
        err = _mesh_err(f"{name} tiled rounds vs batched_round", got,
                        kernels.batched_assign(b, params, rounds_out=k_rounds))
        if t_rounds != k_rounds:
            raise AssertionError(f"{name}: tiled rounds {t_rounds} != {k_rounds}")
        for i, row in enumerate(rows[1:], 1):
            for k, (x, y) in enumerate(zip(row, rows[0])):
                if x is not None and not torch.equal(_whole(x), _whole(y).to(_whole(x).device)):
                    raise AssertionError(f"{name}: pod row {i}'s state slot {k} differs from "
                                         "pod row 0's")
        plain = batched_assign_tiled_plain(tb, params)
        torch.cuda.synchronize()
        err = max(err, _mesh_err(f"{name} tiled rounds vs the tiled plain rounds", got, plain))
        note("tiled_round", name, err)
        got = kernels.tiled_greedy_scan(tb, params)
        err = _mesh_err(f"{name} tiled scan vs greedy_scan", got, kernels.greedy_scan(b, params))
        line = "the unsharded kernel"
        if cut is not None:
            bc, pc = cut
            tc = M.shard_batch(bc, grid)
            got_c = kernels.tiled_greedy_scan(tc, pc)
            err = max(err, _mesh_err(f"{name} cut tiled scan vs greedy_scan", got_c,
                                     kernels.greedy_scan(bc, pc)))
            t0 = time.perf_counter()
            plain = greedy_assign_tiled_plain(tc, pc)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            err = max(err, _mesh_err(f"{name} cut tiled scan vs its plain version",
                                     got_c, plain))
            line += f" and, cut to {bc.requests.shape[0]} pods, the tiled plain scan"
        note("tiled_scan", name, err)
        log(f"mesh [{name}] on the {shape} grid: tiled rounds ({t_rounds[0]} rounds) equal "
            f"to the unsharded kernel and the tiled plain rounds, every pod row's node rows "
            f"equal; tiled scan equal to {line}")
        P, N = b.requests.shape[0], b.alloc.shape[0]
        state_bytes = sum(int(x.nbytes) for x in (b.requested, b.nonzero_requested,
                                                  b.pod_count, b.node_ports))
        if name.startswith("SchedulingPodAffinity"):
            t0 = time.perf_counter()
            batched_assign_tiled_plain(tb, params)
            torch.cuda.synchronize()
            timing["tiled_round"] = {
                "ms": cuda_ms(lambda: kernels.tiled_batched_assign(tb, params), 5),
                "unsharded_ms": cuda_ms(lambda: kernels.batched_assign(b, params), 5),
                "plain_ms": 1e3 * (time.perf_counter() - t0),
                "bytes": rt.batch_nbytes(b) + P * 4 + state_bytes
                + int(b.podaffinity.base_sums.nbytes),
                "ops": k_rounds[0] * scored_pods(b) * N * f64_ops_per_pair(params, b),
                "shape": [P, N] + shape, "rounds": k_rounds[0], "batch": name,
            }
        if name.startswith("SchedulingBasic") and cut is not None:
            bc, pc = cut
            Pc = bc.requests.shape[0]
            timing["tiled_scan"] = {
                "ms": cuda_ms(lambda: kernels.tiled_greedy_scan(tb, params), 3),
                "unsharded_ms": cuda_ms(lambda: kernels.greedy_scan(b, params), 3),
                # the full-size plain scan is not run (the unsharded kernel
                # is held to it at full size): the cut's
                "plain_ms": plain_ms, "plain_shape": [Pc, bc.alloc.shape[0]] + shape,
                "bytes": rt.batch_nbytes(b) + P * 4 + state_bytes,
                "ops": scored_pods(b) * N * f64_ops_per_pair(params, b),
                "shape": [P, N] + shape, "batch": name,
                "cut": {"pods": Pc,
                        "ms": cuda_ms(lambda: kernels.tiled_greedy_scan(tc, pc), 5),
                        "unsharded_ms": cuda_ms(lambda: kernels.greedy_scan(bc, pc), 5),
                        "plain_ms": plain_ms},
            }
    return timing


def grid_batches(basic, podaffinity, spread):
    """The batches K6 and K7 are held on: SchedulingPodAffinity,
    TopologySpreading and SchedulingBasic at 1024 x 5120, each with a
    batch of its template cut for the plain tiled scan (128 pods; Basic's,
    whose scan is timed, 256). Each argument is (batch, params) at full
    size."""
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.perf import workloads as W

    cache_p, pending_p = podaffinity_case(n_pending=128)
    cache_s, pending_s = topology_case(W.pod_with_topology_spreading, n_pending=128)
    cache_b, pending_b = basic_case(n_pending=256)
    return [
        ("SchedulingPodAffinity 1024x5120", *podaffinity,
         encode(cache_p, pending_p, C.Profile())),
        ("TopologySpreading 1024x5120", *spread, encode(cache_s, pending_s, C.Profile())),
        ("SchedulingBasic 1024x5120", *basic, encode(cache_b, pending_b, C.Profile())),
    ]


# --------------------------------- 3b6. the batched solve (B6, K2, K6)
def hotspot_case():
    """``tests/test_torch_batched_stop.py``'s hotspot: four nodes and twelve
    pods that fit one of them only (NodeName): one pod binds a round."""
    from kubetpu_torch.api.wrappers import make_node, make_pod
    from kubetpu_torch.framework import config as C

    nodes = [make_node(f"n{i}", cpu_milli=10000) for i in range(4)]
    pending = [make_pod(f"p{j}", cpu_milli=100, node_name="n2", creation_index=j)
               for j in range(12)]
    profile = C.Profile(
        filters=C.PluginSet(enabled=((C.NODE_NAME, 1), (C.NODE_RESOURCES_FIT, 1))),
        scores=C.PluginSet(enabled=((C.NODE_RESOURCES_FIT, 1),)),
        default_spread_constraints=())
    return encode(_cache_with(nodes, []), pending, profile)


def crowd_case():
    """Five identical empty nodes and eight identical pods, one a node: the
    first rejection (pod 5, rank 5, behind pod 0 on node 0) falls in the
    second pod row of a 2 x 2 grid."""
    from kubetpu_torch.api.wrappers import make_node, make_pod
    from kubetpu_torch.framework import config as C

    nodes = [make_node(f"n{i}", cpu_milli=1000, memory=8 * 1024**3) for i in range(5)]
    pending = [make_pod(f"p{j}", cpu_milli=600, memory=128 * 1024**2, creation_index=j)
               for j in range(8)]
    return encode(_cache_with(nodes, []), pending, C.Profile())


def collision_case():
    """``tests/test_torch_batched_stop.py``'s crafted extender rows (a class
    a pod) on the card: pods 1, 2 and 6 tie on nodes 1 and 3 at half their
    tie hash (group key 0, the key of invalid pods 0 and 5, which count in
    the rank), pods 3 and 4 on node 5 and on nodes 4 and 6 at best scores
    that give them one nonzero key, pod 7 on nodes 0 and 2; the NodeResourcesFit
    filter and no score plugin, so a total is its extender score."""
    import dataclasses

    import numpy as np
    import torch

    from kubetpu_torch.api.wrappers import make_node, make_pod
    from kubetpu_torch.assign.batched import tie_weights
    from kubetpu_torch.framework import config as C

    nodes = [make_node(f"n{i}", cpu_milli=4000, memory=8 * 1024**3) for i in range(8)]
    pending = [make_pod(f"p{j}", cpu_milli=100, memory=64 * 1024**2, creation_index=j)
               for j in range(8)]
    profile = C.Profile(filters=C.PluginSet(enabled=((C.NODE_RESOURCES_FIT, 1),)),
                        scores=C.PluginSet(enabled=()), default_spread_constraints=())
    b, params = encode(_cache_with(nodes, []), pending, profile)
    P, N = b.requests.shape[0], b.alloc.shape[0]
    w = tie_weights(N, "cpu").tolist()
    mask = np.zeros((P, N), dtype=bool)
    score = np.zeros((P, N), dtype=np.int64)
    key = w[5] ^ (100 << 1)
    for p, ties, best in ((1, [1, 3], (w[1] + w[3]) // 2), (2, [1, 3], (w[1] + w[3]) // 2),
                          (6, [1, 3], (w[1] + w[3]) // 2), (3, [5], 100),
                          (4, [4, 6], (key ^ (w[4] + w[6])) >> 1), (7, [0, 2], 7)):
        mask[p, ties] = True
        score[p, ties] = best
    valid = b.pod_valid.clone()
    valid[[0, 5]] = False
    dev = b.alloc.device
    return dataclasses.replace(b, pod_valid=valid, extender_mask=torch.from_numpy(mask).to(dev),
                               extender_score=torch.from_numpy(score).to(dev)), params


def classes_case(n_nodes=500, n_pending=1024, templates=64):
    """Many pod classes whose tie groups mix classes: node_default nodes,
    pods of ``templates`` templates taking turns, each with a host port of
    its own (a class each; the templates score alike until their ports
    part them), every sixteenth pod asking more than a node has (live with
    key 0, beside the pods committed before it)."""
    from kubetpu_torch.api.wrappers import make_pod
    from kubetpu_torch.perf import workloads as W

    nodes = [W.node_default(i) for i in range(n_nodes)]
    pending = []
    for j in range(n_pending):
        t = j % templates
        cpu = 100000 if j % 16 == 15 else 100
        pending.append(make_pod(f"c{j}", namespace="m", cpu_milli=cpu, memory=256 * 1024**2,
                                host_ports=[9000 + t], creation_index=j))
    return _cache_with(nodes, []), pending


def solve_batches(basic, podaffinity) -> list:
    """The batches ``batched_solve_checks`` holds the batched solve on:
    (name, batch, params, the round caps, 0 for P). ``basic`` and
    ``podaffinity`` are phase 3's (batch, params) at 1024 x 5120."""
    import dataclasses

    from kubetpu_torch.framework import config as C

    b, params = basic
    bp, pp = podaffinity
    cache, pending, nom = preemption_case(n_nodes=1000, n_pending=256, n_nominated=64)
    bn, pn = encode_batch_full(cache, pending, C.Profile(), nom.entries())
    return [
        ("hotspot 16x8", *hotspot_case(), (0, 1, 2, 11)),
        ("PodAffinity, no pod valid", dataclasses.replace(
            bp, pod_valid=bp.pod_valid.new_zeros(bp.pod_valid.shape)), pp, (0,)),
        ("many classes 1024x512", *encode(*classes_case(), C.Profile()), (1, 2, 6)),
        ("colliding keys (extender rows) 8x8", *collision_case(), (0,)),
        ("rejection in pod row 1 8x8", *crowd_case(), (0, 1)),
        ("nominations 256x1024", bn.device, pn, (0,)),
        ("SchedulingBasic, extender rows", with_extender(b), params, (1, 2, 6)),
        ("SchedulingBasic, DRA leaf", dra_leaf(b), params, (0,)),
    ]


def batched_solve_checks(results, mesh, grid, batches) -> None:
    """The batched solve held exactly to the plain rounds on ``batches``
    (``solve_batches``) at each round cap: B6 unsharded to
    ``batched_assign_plain``, K2 on ``mesh`` and K6 on ``grid`` to
    ``batched_assign_tiled_plain`` and to B6 (the assignments, the seven
    state slots, the rounds, and every pod row's copy of the node rows)."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.batched import batched_assign_plain, batched_assign_tiled_plain
    from kubetpu_torch.parallel import mesh as M

    for k in ("batched_round", "sharded_round", "tiled_round"):
        results.setdefault(k, {"cases": [], "max_abs_err": 0})

    def note(kernel, case, err):
        results[kernel]["cases"].append(case)
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)

    for name, b, params, caps in batches:
        seen = []
        for cap in caps:
            case = f"{name}, max_rounds {cap or 'P'}"
            k_rounds, p_rounds = [], []
            want = kernels.batched_assign(b, params, cap, k_rounds)
            err = _engine_err(case, *want, *batched_assign_plain(b, params, cap, p_rounds))
            if k_rounds != p_rounds:
                raise AssertionError(f"{case}: rounds {k_rounds} != plain {p_rounds}")
            note("batched_round", case, err)
            for kernel, layout in (("sharded_round", mesh), ("tiled_round", grid)):
                sb = M.shard_batch(b, layout)
                t_rounds, q_rounds, rows = [], [], []
                got = kernels.tiled_batched_assign(sb, params, cap, t_rounds, rows)
                err = _mesh_err(f"{case} {kernel} vs batched_round", got, want)
                err = max(err, _mesh_err(f"{case} {kernel} vs its plain rounds", got,
                                         batched_assign_tiled_plain(sb, params, cap, q_rounds)))
                if not t_rounds == q_rounds == k_rounds:
                    raise AssertionError(f"{case} {kernel}: rounds {t_rounds}, plain "
                                         f"{q_rounds}, unsharded {k_rounds}")
                for i, row in enumerate(rows[1:], 1):
                    for s, (x, y) in enumerate(zip(row, rows[0])):
                        if x is not None and not torch.equal(_whole(x),
                                                             _whole(y).to(_whole(x).device)):
                            raise AssertionError(f"{case} {kernel}: pod row {i}'s state slot "
                                                 f"{s} differs from pod row 0's")
                note(kernel, case, err)
            seen.append(f"{cap or 'P'}: {k_rounds[0]} rounds, "
                        f"{int((want[0] >= 0).sum().item())} bound")
        log(f"batched solve [{name}]: exact unsharded, over {mesh.size} shards and on the "
            f"{list(grid.shape)} grid, to the plain rounds ({'; '.join(seen)})")
    torch.cuda.synchronize()


def mesh_kernel_lines(results, timing) -> list:
    """The mesh kernels' lines of the kernels JSON line."""
    out = []
    for name, src, replaces in MESH_KERNELS:
        tm = timing[name]
        bound_ms, bound_by = _bound(tm["bytes"], tm["ops"])
        line = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": None, "result": "equal to the plain version and the unsharded kernel",
            "max_abs_err": results[name]["max_abs_err"],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": tm.get("library_ms"),
            "cases": results[name]["cases"], "shape": tm["shape"],
        }
        for k in ("unsharded_ms", "sharded_ms", "exchange_us", "collective_wall_s",
                  "exchanges_per_step", "rounds", "batch", "cut", "full", "iterations",
                  "plain_shape",
                  "library_host_ms"):
            if k in tm:
                line[k] = tm[k]
        out.append(line)
        extra = ""
        if "unsharded_ms" in tm:
            extra += f", unsharded {tm['unsharded_ms']:.4f} ms"
        if "library_ms" in tm:
            extra += f", library {tm['library_ms']:.4f} ms"
        log(f"timing [{name}] at {tm['shape']}: kernel {tm['ms']:.4f} ms, plain "
            f"{tm['plain_ms']:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}){extra}")
    return out


def mesh_recorder_check(sched, launches) -> dict:
    """The recorder under a mesh skips its breakdown, as the reference's
    does: every record of the ring is there, each pod's says "skipped:
    mesh", each gang's (the group cycles note their gangs as without a
    mesh) is placed or preempting, and ``explain_summary`` never
    launched."""
    fr = sched.flight_recorder
    body = fr.records_json(limit=fr._records.maxlen)
    attempted = sum(c.pods for c in sched.metrics.cycle_timings)
    gangs = [r for r in body["records"] if r.get("kind") == "gang"]
    records = [r for r in body["records"] if r.get("kind") != "gang"]
    unplaced = [r["pod"] for r in gangs if r.get("status") not in ("placed", "preempting")]
    if unplaced:
        raise AssertionError(f"recorder: gang records {unplaced[:5]} not resolved")
    if len(records) != min(attempted, fr._records.maxlen - len(gangs)):
        raise AssertionError(f"recorder: {len(records)} records for {attempted} attempts")
    odd = [r["pod"] for r in records if r.get("skipped_reason") != "mesh"]
    if odd:
        raise AssertionError(f"recorder under a mesh: records {odd[:5]} not marked skipped")
    if launches["explain_summary"]:
        raise AssertionError("recorder under a mesh: explain_summary launched")
    return {"recorder": {"records": len(records), "gang_records": len(gangs),
                         "attempted": attempted, "skipped_reason": "mesh"}}


# -------------------------------------------------------- 4. main paths
def _check_capacity(sched) -> None:
    """Every node's exact requests within allocatable, pods within 110."""
    for info in sched.cache.update_snapshot().node_infos():
        alloc = dict(info.node.allocatable)
        for k, v in info.requested.items():
            if v > alloc.get(k, 0):
                raise AssertionError(f"{info.node.name}: {k} {v} > {alloc.get(k, 0)}")
        if len(info.pods) > alloc.get("pods", 0):
            raise AssertionError(f"{info.node.name}: {len(info.pods)} pods")


def zone_skew(sched, labels=(("color", "blue"),)) -> dict:
    """Per-zone count of the bound pods carrying ``labels``, and its max -
    min: TopologySpreading's measured pods spread over zone with maxSkew 5
    (DoNotSchedule), so the skew must stay within 5."""
    from kubetpu_torch.perf.workloads import ZONE_KEY

    counts: dict = {}
    for info in sched.cache.update_snapshot().node_infos():
        zone = dict(info.node.labels).get(ZONE_KEY)
        counts.setdefault(zone, 0)
        for q in info.pods.values():
            if all(dict(q.labels).get(k) == v for k, v in labels):
                counts[zone] += 1
    skew = max(counts.values()) - min(counts.values())
    if skew > 5:
        raise AssertionError(f"zone skew {skew} > maxSkew 5: {counts}")
    return {"zone_counts": counts, "zone_skew": skew}


def steady_deltas(sched) -> dict:
    """After the first cycle (the full upload that makes the block
    resident) every cycle of the path must ship less than the whole node
    block: only its dirty rows, through ``scatter_rows``."""
    later = sched.metrics.cycle_timings[1:]
    worst = max(c.node_upload_bytes for c in later)
    block = max(c.resident_bytes for c in later)
    if not worst < block:
        raise AssertionError(f"a steady-state cycle shipped {worst} node bytes, "
                             f"the whole block is {block}")
    return {"steady_node_upload_bytes_max": worst}


def _clone(x):
    return None if x is None else x.clone()


def recorder_check(sched, launches) -> dict:
    """The flight recorder's checks after a path: every record in its ring
    (the last min(4096, attempted) pods) has its breakdown resolved, no
    explain failed, and ``explain_summary`` launched once a finished
    cycle. Returns the recorder's fields for the path's line."""
    fr = sched.flight_recorder
    fr.records_json(limit=1)               # resolves the last cycle's explain
    gangs = [r for r in fr._records if r.get("kind") == "gang"]
    records = [r for r in fr._records if r.get("kind") != "gang"]
    unplaced = [r["pod"] for r in gangs if r.get("status") not in ("placed", "preempting")]
    if unplaced:
        raise AssertionError(f"recorder: gang records {unplaced[:5]} not resolved")
    attempted = sum(c.pods for c in sched.metrics.cycle_timings)
    cycles = len(sched.metrics.cycle_timings)
    if fr.breakdown_failures:
        raise AssertionError(f"recorder: {fr.breakdown_failures} breakdown failures")
    if len(records) != min(attempted, fr._records.maxlen - len(gangs)):
        raise AssertionError(f"recorder: {len(records)} records for {attempted} attempts")
    unresolved = sum(1 for r in records if "view" not in r)
    if unresolved:
        raise AssertionError(f"recorder: {unresolved} records without a breakdown")
    if launches["explain_summary"] != cycles or fr.explains != cycles:
        raise AssertionError(f"recorder: explain_summary launched "
                             f"{launches['explain_summary']} times, resolved {fr.explains}, "
                             f"for {cycles} cycles")
    return {"recorder": {
        "records": len(records), "gang_records": len(gangs), "attempted": attempted,
        "explains": fr.explains,
        "breakdown_failures": fr.breakdown_failures,
        "explain_ms_per_cycle": 1e3 * fr.spans["explain"] / max(fr.explains, 1),
        "fetch_ms_per_cycle": 1e3 * fr.spans["fetch"] / max(fr.explains, 1),
        "mask_launches": launches["filter_component_masks"],
    }}


def run_path(card, case, workload, engine, expected, plain, kernel_names,
             check=None, pipeline=False, flight_recorder=True, extenders=(),
             every_cycle=False, workload_kw=None) -> tuple[dict, dict, float]:
    """Drive one main path with the launch counts set to 0 just before it
    and read just after; check it and print its JSON line. ``check``, when
    given, takes the run's Scheduler, raises on a fault and returns more
    fields for the line. With the flight recorder on (the default, as in
    the reference), ``recorder_check`` runs too. ``every_cycle`` holds
    every cycle, not only the first, to the plain engine on the same
    batch: assignments and final state. ``workload_kw`` goes to
    ``run_workload`` (the gang lane's gates, topology mode and slices); the
    gang lane's first placement search is held to
    ``placement_assign_plain`` on its batch. Returns the launch counts, the
    bound map, the measured pods/s and the ``WorkloadResult``."""
    import dataclasses

    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign import placement
    from kubetpu_torch.perf import run_workload

    label = getattr(workload, "name", workload)
    captured: dict = {}
    real_placement = placement.placement_assign_device

    def first_placement(b, params, masks, engine="greedy"):
        out = real_placement(b, params, masks, engine)
        if "first_placement" not in captured:
            captured["first_placement"] = (
                dataclasses.replace(b, nodes=_clone_nodes(b.nodes)), params,
                masks.clone(), engine, tuple(x.clone() for x in out))
        return out

    def observe(sched):
        captured["sched"] = sched
        engine_fn = sched._assign_device

        def first_cycle_recorder(b, params):
            out = engine_fn(b, params)
            if plain is None:
                return out

            kept: list = []

            def keep():
                # the node block is resident and later scatters write into
                # it: keep this cycle's copy for the plain engine (one copy
                # a cycle, however many keys it is the first of)
                if not kept:
                    kept.append((dataclasses.replace(b, nodes=_clone_nodes(b.nodes)),
                                 params, out[0].clone()))
                return kept[0]

            if "first" not in captured:
                captured["first"] = keep()
            if b.spread is not None and "first_spread" not in captured:
                captured["first_spread"] = keep()
            if b.nominated_node is not None and "first_nominated" not in captured:
                captured["first_nominated"] = keep()
            if every_cycle:
                captured.setdefault("cycles", []).append(
                    keep() + (tuple(_clone(x) for x in out[1]),))
            return out

        sched._assign_device = first_cycle_recorder

    # the earlier phases' and paths' garbage (each path's Scheduler holds
    # a whole cluster in reference cycles) is collected now, not inside
    # this path's spans; the line reports the full collections that still
    # fell inside the run
    gc.collect()
    full0 = gc.get_stats()[2]["collections"]
    kernels.reset_launch_counts()
    placement.placement_assign_device = first_placement
    t0 = time.perf_counter()
    try:
        res = run_workload(case, workload, engine=engine, device="cuda",
                           on_scheduler=observe, pipeline=pipeline,
                           flight_recorder=flight_recorder, extenders=extenders,
                           **(workload_kw or {}))
    finally:
        placement.placement_assign_device = real_placement
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    full_collections = gc.get_stats()[2]["collections"] - full0

    sched = captured["sched"]
    if (expected is not None and res.bound_total != expected) \
            or res.scheduled != res.measure_pods:
        raise AssertionError(f"{case}/{label}: bound {res.bound_total} of {expected} "
                             f"pods, {res.scheduled} of {res.measure_pods} measured")
    _check_capacity(sched)
    # the run's first cycle, and its first cycles with a spread leaf and
    # with nominations
    checked: list = []
    for key in ("first", "first_spread", "first_nominated"):
        if key not in captured or any(captured[key] is c for c in checked):
            continue
        checked.append(captured[key])
        b, params, first = captured[key]
        want, _ = plain(b, params)
        torch.cuda.synchronize()
        if not torch.equal(first, want):
            raise AssertionError(f"{case}: {key} cycle's kernel assignments differ from "
                                 "the plain engine's")
    if "first_placement" in captured:
        # the plain search of the first PLAIN_PLACEMENTS hypotheses (each is
        # searched on its own, so their rows of the kernel's result must
        # equal it): the whole D = 33 plain search took ~100 s a path
        b, params, masks, eng, got = captured["first_placement"]
        k = min(PLAIN_PLACEMENTS, masks.shape[0])
        _equal_or_raise(f"{case} first placement search", tuple(x[:k] for x in got),
                        placement.placement_assign_plain(b, params, masks[:k], eng))
        log(f"[{case}/{label}] first placement search (D={masks.shape[0]}, "
            f"P={b.requests.shape[0]}): its first {k} placements equal to "
            "placement_assign_plain")
    for i, (b, params, got, state) in enumerate(captured.get("cycles", ())):
        want, want_state = plain(b, params)
        torch.cuda.synchronize()
        _engine_err(f"{case} cycle {i}", got, state, want, want_state)
    if every_cycle:
        log(f"[{case}] every cycle ({len(captured['cycles'])}) equal to the plain "
            "engine: assignments and final state")
    for name in kernel_names:
        if launches[name] < 1:
            raise AssertionError(f"{case}/{label}: main path never launched {name}")
    rounds = [c.rounds for c in sched.metrics.cycle_timings]
    extra = check(sched) if check is not None else {}
    if flight_recorder and sched.mesh is not None:
        extra.update(mesh_recorder_check(sched, launches))
    elif flight_recorder:
        extra.update(recorder_check(sched, launches))
    elif launches["explain_summary"]:
        raise AssertionError(f"{case}: the recorder is off but explain_summary launched")
    line = {
        "main_path": {
            "workload": f"{case}/{label}", "engine": engine,
            "pipeline": pipeline, "pipeline_replays": res.pipeline_replays,
            "pods_bound": res.bound_total, "pods_per_s": res.throughput,
            "measured_pods": res.scheduled, "measured_s": res.duration_s,
            "cycles": res.cycles, "cycle_ms": res.cycle_ms,
            "upload_bytes_per_cycle": res.upload_bytes_per_cycle,
            "node_upload_bytes_per_cycle": res.node_upload_bytes_per_cycle,
            "resident_bytes": res.resident_bytes,
            "encode_cache_hit_rate": res.encode_cache_hit_rate,
            "rounds_per_cycle": res.rounds_per_cycle,
            "rounds_by_cycle": rounds if engine == "batched" else None,
            "solver_iters_by_cycle": [c.solver_iters for c in sched.metrics.cycle_timings]
            if engine == "packing" else None,
            "nodes_used_at_steady_state": res.nodes_used_at_steady_state,
            "priority_slo_hit_rate": res.priority_slo_hit_rate,
            "solver_iters_per_cycle": res.solver_iters_per_cycle,
            "run_s": wall, "gc_full_collections": full_collections,
            "gc_s_measured": res.gc_s,
            "launches": launches,
            "first_cycle_equal": True if "first" in captured else None,
            "first_placement_equal": True if "first_placement" in captured else None,
            "group_cycles": res.group_cycles,
            "hypotheses_per_cycle": res.hypotheses_per_cycle,
            "group_cycle_ms": res.group_cycle_ms,
            "every_cycle_equal": True if every_cycle else None,
            "flight_recorder": flight_recorder, "extenders": len(extenders),
            "first_spread_cycle_equal": True if "first_spread" in captured else None,
            "first_nominated_cycle_equal": True if "first_nominated" in captured else None,
            "preemption_attempts": res.preemption_attempts,
            "preemption_victims": res.preemption_victims,
            "preemptions": res.preemptions, "preempt_calls": res.preempt_calls,
            "preempt_ms": res.preempt_ms,
            "mesh_shape": list(res.mesh_shape), "collective_wall_s": res.collective_wall_s,
            "card": card, **extra,
        }
    }
    log(json.dumps(line))
    if res.group_cycles:
        gm = res.group_cycle_ms
        log(f"[{case}/{label}] {res.group_cycles} group cycles, "
            f"{res.hypotheses_per_cycle:.1f} placements a cycle: {gm['total']:.3f} ms a "
            f"cycle, of which encode {gm['encode']:.3f} ms and the device call "
            f"{gm['device']:.3f} ms (placement search: "
            + ("hypothesis_rows, filter_score + batched_round a placement, slice_epilogue"
               if engine == "batched" else "filter_score + hypothesis_scan")
            + f"; coalesced: the engine); {res.throughput:.1f} pods/s")
    ms = res.cycle_ms
    if not ms:
        return launches, dict(sched.client.bound), res.throughput, res
    log(f"[{case}{' pipelined' if pipeline else ''}] node upload "
        f"{res.node_upload_bytes_per_cycle:.0f} bytes a cycle against a "
        f"{res.resident_bytes}-byte block; encode cache hit rate "
        f"{res.encode_cache_hit_rate}; stage 1 {ms['pre_encode']:.3f} ms, stage 2 "
        f"{ms['finalize']:.3f} ms (node encode {ms['nodes']:.3f} ms, staleness refreshes "
        f"{ms['refresh']:.3f} ms), upload {ms['upload']:.3f} ms, kernel "
        f"{ms['kernel']:.3f} ms, wait {ms['wait']:.3f} ms, recorder {ms['recorder']:.3f} ms, "
        f"extenders {ms['extenders']:.3f} ms; {res.gc_s * 1e3:.1f} ms in the "
        f"garbage collector; {res.throughput:.1f} pods/s")
    if res.preempt_calls:
        pm = res.preempt_ms
        log(f"[{case}] {res.preemption_attempts} preemption attempts, "
            f"{res.preemptions} nominated, {res.preemption_victims} victims; PostFilter "
            f"{ms['postfilter']:.3f} ms a cycle; preempt() "
            f"{sum(pm.values()):.3f} ms a call over {res.preempt_calls} calls: upload "
            f"{pm['upload']:.3f}, potential mask {pm['potential']:.3f}, dry run "
            f"{pm['dry_run']:.3f}, fetch {pm['fetch']:.3f} ms")
    if engine == "packing":
        log(f"[{case}/{label} packing] {res.solver_iters_per_cycle:.2f} solver iterations "
            f"a cycle, {res.nodes_used_at_steady_state} nodes carry the measured pods")
    return launches, dict(sched.client.bound), res.throughput, res



class ScriptedWebhook:
    """An in-process scheduler-extender webhook (``filter`` and
    ``prioritize`` verbs, NodeCacheCapable requests) with seeded verdicts:
    for each pod it rejects about ``reject_pct`` percent of the nodes and
    scores every node 0..10, both from a CRC32 of (seed, pod, node), so
    the verdicts are the same in every process."""

    def __init__(self, seed: int = 0, reject_pct: int = 15, listen_queue: int = 128):
        import http.server
        import threading

        self.seed, self.reject_pct = seed, reject_pct
        self.calls = {"filter": 0, "prioritize": 0}
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):  # noqa: N802 (http.server API)
                args = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                meta = (args.get("Pod") or {}).get("metadata") or {}
                pod = f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
                names = args.get("NodeNames") or []
                if self.path.endswith("/filter"):
                    outer.calls["filter"] += 1
                    body = {
                        "NodeNames": [n for n in names if not outer.rejects(pod, n)],
                        "FailedNodes": {n: "scripted" for n in names if outer.rejects(pod, n)},
                        "FailedAndUnresolvableNodes": {}, "Error": "",
                    }
                else:
                    outer.calls["prioritize"] += 1
                    body = [{"Host": n, "Score": outer.score(pod, n)} for n in names]
                raw = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

        class Server(http.server.ThreadingHTTPServer):
            # the scheduler's extender pool opens up to its parallelism (16)
            # connections at once; socketserver's listen queue of 5 can
            # overflow while the accept thread waits for the interpreter
            # lock, and a connection it drops fails that pod's calls
            # (``--webhook-queue`` shows it)
            request_queue_size = listen_queue
            daemon_threads = True

        self.httpd = Server(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def _hash(self, pod: str, node: str) -> int:
        import zlib

        return zlib.crc32(f"{self.seed}/{pod}/{node}".encode())

    def rejects(self, pod: str, node: str) -> bool:
        return self._hash(pod, node) % 100 < self.reject_pct

    def score(self, pod: str, node: str) -> int:
        return (self._hash(pod, node) >> 8) % 11

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=10)


def webhook_queue_mode(seconds: float = 20.0) -> int:
    """``--webhook-queue``: the webhook fixture under a load heavier than the
    extender paths', on the host alone. Client threads post ``filter`` calls
    over 500 node names through the scheduler's own client
    (``HTTPExtender``, 30 s timeout) while one more thread keeps the
    interpreter busy, for ``seconds`` each, against socketserver's default
    listen queue of 5 and the fixture's 128, with 16 clients (the
    scheduler's extender pool) and with 64. Prints one line a row: the calls
    answered and the failures by kind. Fails if the fixture's queue loses a
    call."""
    import collections
    import threading

    from kubetpu_torch.api.wrappers import make_pod
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.sched.extender import HTTPExtender

    names = [f"node-{i}" for i in range(500)]
    lost = 0
    for queue, clients in ((5, 16), (128, 16), (5, 64), (128, 64)):
        hook = ScriptedWebhook(seed=11, listen_queue=queue)
        ext = HTTPExtender(C.ExtenderConfig(url_prefix=hook.url, filter_verb="filter",
                                            node_cache_capable=True))
        failed: collections.Counter = collections.Counter()
        answered = [0] * clients
        stop = threading.Event()

        def client(i):
            while not stop.is_set():
                try:
                    ext.filter(make_pod(f"p{i}-{answered[i]}", cpu_milli=100, memory=1 << 20),
                               names)
                    answered[i] += 1
                except Exception as e:  # noqa: BLE001 (counted by kind)
                    failed[f"{type(e).__name__}: {e}"[:80]] += 1

        def busy():
            while not stop.is_set():
                sum(range(2000))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
        threads.append(threading.Thread(target=busy))
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        time.sleep(seconds)
        stop.set()
        for th in threads:
            th.join()
        hook.close()
        if queue == 128:
            lost += sum(failed.values())
        log(json.dumps({"webhook_queue": {
            "listen_queue": queue, "clients": clients, "answered": sum(answered),
            "failed": dict(failed), "s": time.perf_counter() - t0}}))
    if lost:
        raise AssertionError(f"the fixture's listen queue lost {lost} calls")
    return 0


def _webhook_workload():
    from kubetpu_torch.perf import workloads as W

    # SchedulingBasic/500Nodes with 400 measured pods, not 1000: each pod
    # waits on the webhook's two calls (about 14 s a cycle on an H100 host)
    return W.Workload("500Nodes_400Pods", {"initNodes": 500, "initPods": 500,
                                           "measurePods": 400})


def extender_paths(card, device="cuda") -> dict:
    """SchedulingBasic/500Nodes (400 measured pods) on the greedy and on
    the batched engine, each behind a ``ScriptedWebhook`` (filter and prioritize, weight 5,
    NodeCacheCapable): every pod bound, none on a node the webhook rejected
    for it, capacity held (``run_path``), and the first cycle's kernel
    assignments equal to the plain engine's on the same batch with the
    same extender leaves. Returns the two runs."""
    from kubetpu_torch.assign.batched import batched_assign_plain
    from kubetpu_torch.assign.greedy import greedy_assign_plain
    from kubetpu_torch.framework import config as C

    webhook_workload = _webhook_workload()
    runs = {}
    for engine, plain, kern in (
            ("greedy", greedy_assign_plain, "greedy_scan"),
            ("batched", batched_assign_plain, "batched_round")):
        hook = ScriptedWebhook(seed=11)
        try:
            cfg = C.ExtenderConfig(url_prefix=hook.url, filter_verb="filter",
                                   prioritize_verb="prioritize", weight=5,
                                   node_cache_capable=True)

            def no_rejected_node(sched, hook=hook):
                placed = 0
                for info in sched.cache.update_snapshot().node_infos():
                    for q in info.pods.values():
                        if hook.rejects(f"{q.namespace}/{q.name}", info.node.name):
                            raise AssertionError(f"extender path: {q.name} bound to "
                                                 f"{info.node.name}, which the webhook "
                                                 "rejected for it")
                        placed += 1
                return {"extender_calls": dict(hook.calls), "pods_checked": placed}

            try:
                runs[f"extender {engine}"] = run_path(
                    card, "SchedulingBasic", webhook_workload, engine, 500 + 400, plain,
                    # the batched solve runs its Filter + Score inside its launch
                    ("filter_score",) * (engine == "greedy") + (kern, "explain_summary"),
                    check=no_rejected_node,
                    extenders=(cfg,))
            except AssertionError as e:
                # a pod whose webhook call failed is unschedulable until the
                # queue's flush: the calls that reached the webhook tell a
                # lost request (fewer than one of each verb a pod attempt)
                # from a wrong placement
                raise AssertionError(f"extender {engine}: {e}; the webhook answered "
                                     f"{dict(hook.calls)}") from e
        finally:
            hook.close()
    return runs


def _node_v1(node) -> dict:
    """A node_default node as the v1.Node JSON a kube-scheduler sends."""
    alloc = dict(node.allocatable)
    return {
        "metadata": {"name": node.name, "labels": dict(node.labels)},
        "spec": {},
        "status": {"allocatable": {
            "cpu": f"{alloc['cpu']}m", "memory": str(alloc["memory"]),
            "pods": str(alloc["pods"]),
        }},
    }


def _post(url: str, body) -> object:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def bridge_phase(card, n_nodes=5000, n_bound=1000, n_pods=128) -> dict:
    """The port's ``ExtenderServer`` on the card, as a real kube-scheduler
    drives it: the 5000 node_default nodes and 1000 bound pod_default pods
    of SchedulingBasic/5000Nodes loaded through /cache/nodes and
    /cache/pods, then ``n_pods`` pod_default pods each posting ``filter`` and
    ``prioritize`` with every node name, some also ``preempt`` and
    ``bind``, and one ``filter`` in non-cache-capable mode with full Nodes
    items. A second server on ``device="cpu"`` holds the same cache and
    gets the same requests: every response body must be equal. Launch
    counts are read around the requests; prints requests/s and p50/p99 ms
    per verb of the card's server."""
    from kubetpu_torch import kernels
    from kubetpu_torch.bridge import ExtenderBackend, ExtenderServer
    from kubetpu_torch.bridge.convert import pod_to_v1
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.perf import workloads as W

    servers = {d: ExtenderServer(ExtenderBackend(profile=C.Profile(), device=d)).start()
               for d in ("cuda", "cpu")}
    try:
        nodes = [_node_v1(W.node_default(i)) for i in range(n_nodes)]
        names = [n["metadata"]["name"] for n in nodes]
        bound = [pod_to_v1(W.pod_default(f"init-{j}", "namespace-0").with_node(
            names[j % n_nodes])) for j in range(n_bound)]
        for srv in servers.values():
            _post(srv.url + "/cache/nodes", {"Nodes": nodes})
            _post(srv.url + "/cache/pods", {"Pods": bound})
        requests = []
        for j in range(n_pods):
            pod = pod_to_v1(W.pod_default(f"measure-{j}", "namespace-1"))
            requests.append(("filter", {"Pod": pod, "NodeNames": names}))
            requests.append(("prioritize", {"Pod": pod, "NodeNames": names}))
            if j % 32 == 5:
                requests.append(("preempt", {"Pod": pod, "NodeNameToVictims": {
                    names[k]: {"Pods": [{"metadata": {"uid": f"namespace-0/init-{k}"}}],
                               "NumPDBViolations": k % 2}
                    for k in range(8)}}))
            if j % 16 == 3:
                requests.append(("bind", {"PodName": f"measure-{j}",
                                          "PodNamespace": "namespace-1",
                                          "PodUID": f"namespace-1/measure-{j}",
                                          "Node": names[(7 * j) % n_nodes]}))
        requests.append(("filter", {"Pod": pod_to_v1(W.pod_default("full-nodes", "namespace-1")),
                                    "Nodes": {"Items": nodes[:64]}}))
        gc.collect()
        kernels.reset_launch_counts()
        lat: dict = {}
        wall = 0.0
        for verb, body in requests:
            t0 = time.perf_counter()
            got = _post(servers["cuda"].url + "/" + verb, body)
            dt = time.perf_counter() - t0
            wall += dt
            want = _post(servers["cpu"].url + "/" + verb, body)
            if got != want:
                raise AssertionError(f"bridge: the card's {verb} reply differs from the "
                                     f"cpu backend's for {body['Pod']['metadata']['name']}")
            if verb == "filter" and "NodeNames" in body and not got["NodeNames"]:
                raise AssertionError("bridge: a filter passed no node")
            lat.setdefault(verb, []).append(dt)
        launches = dict(kernels.launch_counts)
        if launches["filter_component_masks"] < n_pods or launches["filter_score"] < n_pods:
            raise AssertionError(f"bridge: too few launches {launches}")
        per_verb = {
            verb: {"requests": len(v), "p50_ms": 1e3 * statistics.median(v),
                   "p99_ms": 1e3 * sorted(v)[min(len(v) - 1, int(0.99 * len(v)))],
                   "mean_ms": 1e3 * sum(v) / len(v)}
            for verb, v in lat.items()
        }
        line = {"bridge": {
            "nodes": n_nodes, "bound_pods": n_bound, "pods": n_pods,
            "requests": len(requests), "requests_per_s": len(requests) / wall,
            "equal_cuda_cpu": True, "per_verb": per_verb, "launches": launches,
            "card": card,
        }}
        log(json.dumps(line))
        return launches
    finally:
        for srv in servers.values():
            srv.close()


# ------------------------------------------------ 4b. the gang lane paths
GANG_GATES = {"GenericWorkload": True, "GangScheduling": True,
              "TopologyAwareWorkloadScheduling": True}


def slice_of(sched) -> dict:
    """Node name -> its slice label (None when unlabeled)."""
    from kubetpu_torch.state.topology import SLICE_KEY

    return {info.node.name: info.node.labels_dict().get(SLICE_KEY)
            for info in sched.cache.update_snapshot().node_infos()}


def gang_check(per: int, sliced_fleet: bool):
    """GangScheduling's own checks: on a sliced fleet every gang (pods
    gangpod-j, gang j // per) lands on one slice. Returns the group
    cycles' fields for the path's line."""
    def check(sched) -> dict:
        groups = sched.metrics.group_cycles
        out = {"group_cycles": len(groups),
               "placements_per_cycle": sum(g.hypotheses for g in groups) / len(groups)}
        if sliced_fleet:
            where = slice_of(sched)
            by_gang: dict = {}
            for name, node in sched.client.bound:
                by_gang.setdefault(int(name.split("-")[1]) // per, set()).add(where[node])
            split = [g for g, s in by_gang.items() if len(s) != 1 or None in s]
            if split:
                raise AssertionError(f"GangScheduling: gangs {split[:5]} span slices")
            out["slices_used"] = len(set().union(*by_gang.values()))
        return out
    return check


def drive_until_idle(sched, client, clock, max_calls=200) -> None:
    idle = 0
    for _ in range(max_calls):
        res = sched.schedule_batch()
        client.deliver()
        clock.t += 1.0
        idle = 0 if (res["scheduled"] or res["unschedulable"]) else idle + 1
        if idle >= 3:
            return


GANG_PREEMPTION = {"n_nodes": 5000, "low_gangs": 16, "low_size": 150, "train_size": 100}


def gang_preemption_phase(card) -> dict:
    """The shape of tests/test_topology.py's gang preemption at full size:
    5000 node_default nodes in 32 slices; 16 priority-0 gangs of 150 whole-
    node (4-cpu) pods, each placed on one slice (every slice of the crc32
    labelling holds 151 to 163 nodes); priority-10 non-gang pods fill every
    other node; then a priority-10 gang of 100 whole-node pods fits no
    placement and preempts. Checks: the gang dry run launched with C >= 16
    hypotheses; exactly one gang evicted, all its members; the preemptor
    bound on the freed slice once the deletes landed; the dry run equal to
    ``dry_run_gang_preemption_plain`` on that call's inputs (its batch's
    node block cloned at the call); every recorder record resolved."""
    import dataclasses

    from kubetpu_torch import kernels
    from kubetpu_torch.api.wrappers import make_pod, make_pod_group
    from kubetpu_torch.ops import preemption as ops_preemption
    from kubetpu_torch.perf import workloads as W
    from kubetpu_torch.perf.runner import _Client
    from kubetpu_torch.sched import Scheduler

    cfg = GANG_PREEMPTION
    calls = []
    real = ops_preemption.dry_run_gang_preemption

    def spy(b, params, masks, fr, fc, engine="greedy"):
        keep = (dataclasses.replace(b, nodes=_clone_nodes(b.nodes)), params,
                masks.clone(), fr.clone(), fc.clone(), engine)
        out, ms = timed(lambda: real(b, params, masks, fr, fc, engine))
        calls.append((keep, tuple(x.clone() for x in out), ms))
        return out

    gc.collect()
    client, clock = _Client(), SteppedClock()
    sched = Scheduler(client, device="cuda", clock=clock, feature_gates=GANG_GATES,
                      topology="on")
    client.sched = sched
    sched.enable_preemption()
    kernels.reset_launch_counts()
    ops_preemption.dry_run_gang_preemption = spy
    t0 = time.perf_counter()
    try:
        for i in range(cfg["n_nodes"]):
            sched.on_node_add(W.node_default(i, (), SLICES))

        def gang(name, size, prio, base):
            sched.on_pod_group_add(make_pod_group(name, min_count=size))
            for j in range(size):
                sched.on_pod_add(make_pod(
                    f"{name}-{j}", cpu_milli=4000, memory=1024**3, priority=prio,
                    scheduling_group=name, creation_index=base + j))

        for g in range(cfg["low_gangs"]):
            gang(f"low-{g}", cfg["low_size"], 0, g * 1000)
        drive_until_idle(sched, client, clock)
        n_low = cfg["low_gangs"] * cfg["low_size"]
        n_serve = cfg["n_nodes"] - n_low
        for j in range(n_serve):
            sched.on_pod_add(make_pod(f"serve-{j}", cpu_milli=4000, memory=1024**3,
                                      priority=10, creation_index=10**5 + j))
        drive_until_idle(sched, client, clock)
        bound0 = dict(client.bound)
        if len(bound0) != n_low + n_serve:
            raise AssertionError(f"gang preemption: {len(bound0)} of {n_low + n_serve} "
                                 "pods bound before the preemptor")
        t_pre = time.perf_counter()
        gang("train", cfg["train_size"], 10, 10**6)
        drive_until_idle(sched, client, clock)
        wall = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
    finally:
        ops_preemption.dry_run_gang_preemption = real
    where = slice_of(sched)
    low_slices = {}
    for name, node in bound0.items():
        if name.startswith("low-"):
            low_slices.setdefault(name.rsplit("-", 1)[0], set()).add(where[node])
    if any(len(s) != 1 for s in low_slices.values()):
        raise AssertionError("gang preemption: a low-priority gang spans slices")
    victims = [p.name for p, _ in client.deleted]
    groups = {v.rsplit("-", 1)[0] for v in victims}
    if len(groups) != 1 or len(victims) != cfg["low_size"]:
        raise AssertionError(f"gang preemption: evicted {len(victims)} pods of {groups}")
    (victim_group,) = groups
    freed = next(iter(low_slices[victim_group]))
    train = {name: node for name, node in client.bound if name.startswith("train-")}
    if len(train) != cfg["train_size"] or {where[n] for n in train.values()} != {freed}:
        raise AssertionError(f"gang preemption: {len(train)} preemptor pods bound, on "
                             f"{sorted({where[n] for n in train.values()})}, freed {freed}")
    if not calls or launches["hypothesis_scan"] < 1:
        raise AssertionError("gang preemption: the gang dry run never launched")
    (args, got, dry_ms), c_max = calls[0], max(c[0][2].shape[0] for c in calls)
    if c_max < 16:
        raise AssertionError(f"gang preemption: dry run over {c_max} hypotheses, not >= 16")
    for keep, out, _ in calls:
        want = ops_preemption.dry_run_gang_preemption_plain(*keep)
        _equal_or_raise("gang preemption dry run", out, want)
    _check_capacity(sched)
    rec = sched.flight_recorder.lookup("default/train")
    if rec is None or rec.get("status") != "placed":
        raise AssertionError(f"gang preemption: the preemptor's record is {rec}")
    extra = recorder_check(sched, launches)
    line = {"gang_preemption": {
        **cfg, "slices": SLICES, "serve_pods": n_serve,
        "hypotheses": [c[0][2].shape[0] for c in calls], "dry_run_calls": len(calls),
        "dry_run_ms": [c[2] for c in calls], "victim_group": victim_group,
        "evicted": len(victims), "freed_slice": freed, "preemptor_bound": len(train),
        "dry_run_equal_plain": True, "run_s": wall, "preempt_to_bound_s": wall - (t_pre - t0),
        "group_cycles": len(sched.metrics.group_cycles), "launches": launches,
        "card": card, **extra,
    }}
    log(json.dumps(line))
    log(f"[gang preemption] 5000 nodes, {SLICES} slices: dry run over C={c_max} "
        f"eviction hypotheses, {dry_ms:.3f} ms (gang_dry_run_scan with its filter_score); "
        f"evicted {victim_group} ({len(victims)} pods), the preemptor's {len(train)} pods "
        f"bound on {freed}")
    return launches


def gang_paths(card) -> tuple[dict, dict]:
    """The GangScheduling paths through ``run_workload(device="cuda")`` with
    the three gates, then the gang preemption scenario. Returns the paths'
    runs by key and the scenario's launch counts."""
    from kubetpu_torch.assign.batched import batched_assign_plain
    from kubetpu_torch.assign.greedy import greedy_assign_plain

    sliced_kernels = ("filter_score", "hypothesis_scan")
    runs = {
        "gang3 greedy": run_path(
            card, "GangScheduling", "5000Nodes_3Gangs_3000Pods_1000PerGroup", "greedy", 3000,
            greedy_assign_plain, sliced_kernels, check=gang_check(1000, True),
            workload_kw=dict(feature_gates=GANG_GATES, topology="on", slices=SLICES)),
        # the batched engine's placement search: hypothesis_rows, a B6 solve
        # a placement (its Filter + Score inside), slice_epilogue
        "gang3 batched": run_path(
            card, "GangScheduling", "5000Nodes_3Gangs_3000Pods_1000PerGroup", "batched", 3000,
            batched_assign_plain, ("batched_round", "hypothesis_rows", "slice_epilogue"),
            check=gang_check(1000, True),
            workload_kw=dict(feature_gates=GANG_GATES, topology="on", slices=SLICES)),
        "gang1000 greedy": run_path(
            card, "GangScheduling", "5000Nodes_1000Gangs_3000Pods", "greedy", 3000,
            greedy_assign_plain, sliced_kernels, check=gang_check(3, True),
            workload_kw=dict(feature_gates=GANG_GATES, topology="on", slices=SLICES)),
        "gang1000 unlabeled greedy": run_path(
            card, "GangScheduling", "5000Nodes_1000Gangs_3000Pods", "greedy", 3000,
            greedy_assign_plain, ("filter_score", "greedy_scan"), check=gang_check(3, False),
            workload_kw=dict(feature_gates=GANG_GATES, topology="off")),
    }
    return runs, gang_preemption_phase(card)


def coalesced_packing_check(into: dict, extra: int = 512):
    """The unlabeled gangs on packing: after the workload's coalesced group
    cycles, ``extra`` plain pods run per-pod cycles on the same scheduler
    (under a mesh, sharded ones: K5 must launch), each solve taking the
    duals the last one left. Puts into ``into`` (and returns) the engine's
    resets and carries, and a digest of every dual vector it holds (its
    float32 bits by padded capacity)."""
    def check(sched) -> dict:
        import hashlib

        from kubetpu_torch import kernels
        from kubetpu_torch.parallel.mesh import ShardedTensor
        from kubetpu_torch.perf import workloads as W

        what = "packing_round" if sched.mesh is None else "sharded_packing"
        before = kernels.launch_counts[what]
        for j in range(extra):
            sched.on_pod_add(W.pod_default(f"plain-{j}", "gang-0"))
        for _ in range(20):
            res = sched.schedule_batch()
            sched.client.deliver()
            if not (res["scheduled"] or res["unschedulable"]):
                break
        bound = sum(1 for name, _ in sched.client.bound if name.startswith("plain-"))
        if bound != extra:
            raise AssertionError(f"coalesced packing: {bound} of {extra} plain pods bound")
        if kernels.launch_counts[what] == before:
            raise AssertionError(f"coalesced packing: the plain pods' cycles never launched "
                                 f"{what}")
        st = sched._packing.state
        digest = {}
        for n, lam in sorted(st._lam.items()):
            lam = lam.gather("cpu") if isinstance(lam, ShardedTensor) else lam.cpu()
            digest[str(n)] = hashlib.sha256(lam.numpy().tobytes()).hexdigest()[:16]
        into.update(duals=digest, resets=st.resets, carries=st.carries)
        return dict(into)
    return check


def gang_mesh_paths(card, mesh, grid, unsharded: dict) -> dict:
    """The gang lane under a mesh, run as kubetpu runs it (each group batch
    unsharded on the mesh's first card): the 3 x 1000 gangs on 32 slices on
    the greedy engine under the node ``mesh`` and on the batched engine on
    ``grid`` (each gang on one slice; bound maps equal to the unsharded
    runs' of ``unsharded``), then the unlabeled 1000 gangs on packing
    unsharded and under ``mesh``, each followed by plain pods
    (``coalesced_packing_check``): bound maps, duals, resets and carries
    equal. Returns the runs by key."""
    shape = "x".join(map(str, mesh.shape))
    gshape = "x".join(map(str, grid.shape))
    sliced = dict(feature_gates=GANG_GATES, topology="on", slices=SLICES)
    runs = {}
    for key, engine, m, label, names in (
            ("gang3 greedy", "greedy", mesh, f"mesh {shape}", ("filter_score", "hypothesis_scan")),
            ("gang3 batched", "batched", grid, f"grid {gshape}",
             ("batched_round", "hypothesis_rows", "slice_epilogue"))):
        run = run_path(card, "GangScheduling", "5000Nodes_3Gangs_3000Pods_1000PerGroup", engine,
                       3000, None, names, check=gang_check(1000, True),
                       workload_kw=dict(mesh=m, **sliced))
        _same_bound(f"GangScheduling {engine} on the {label}", run, unsharded[key])
        log(f"[GangScheduling 3 x 1000 {engine} {label}] every gang on one slice, bound map "
            f"equal to the unsharded run's ({len(run[1])} pods); {run[2]:.1f} pods/s against "
            f"the unsharded {unsharded[key][2]:.1f}")
        runs[f"{key} {label}"] = run
    coalesced = dict(feature_gates=GANG_GATES, topology="off")
    packing = ("packing_round",)
    duals: dict = {"ref": {}, "mesh": {}}
    # the recorder is off: the check's plain pods run cycles after the
    # path's launch counts were read
    ref = run_path(card, "GangScheduling", "5000Nodes_1000Gangs_3000Pods", "packing", None,
                   None, packing, check=coalesced_packing_check(duals["ref"]),
                   flight_recorder=False, workload_kw=coalesced)
    run = run_path(card, "GangScheduling", "5000Nodes_1000Gangs_3000Pods", "packing", None,
                   None, packing, check=coalesced_packing_check(duals["mesh"]),
                   flight_recorder=False, workload_kw=dict(mesh=mesh, **coalesced))
    _same_bound(f"unlabeled gangs on packing on the mesh {shape}", run, ref)
    if duals["mesh"] != duals["ref"]:
        raise AssertionError(f"unlabeled gangs on packing on the mesh {shape}: duals, resets "
                             f"or carries {duals['mesh']} against unsharded {duals['ref']}")
    got, want = run[3], ref[3]
    if not got.group_cycles or duals["mesh"]["carries"] < 2:
        raise AssertionError("unlabeled gangs on packing: no coalesced group cycle, or no "
                             "duals carried")
    log(f"[GangScheduling 1000 gangs unlabeled packing mesh {shape}] bound map equal to the "
        f"unsharded run's ({len(run[1])} pods, 512 plain pods after the gangs), duals equal "
        f"({duals['mesh']['carries']} carries, {duals['mesh']['resets']} resets); "
        f"{got.throughput:.1f} pods/s against the unsharded {want.throughput:.1f}")
    runs["gang1000 unlabeled packing"] = ref
    runs[f"gang1000 unlabeled packing mesh {shape}"] = run
    return runs


def plain_packing(b, params):
    """The plain packing engine from cold duals (a path's first cycle):
    ``(assignments, final_state)``."""
    import torch

    from kubetpu_torch.assign.packing import PackingWeights, packing_assign_plain

    lam = torch.zeros(b.alloc.shape[0], dtype=torch.float32, device=b.device)
    out = packing_assign_plain(b, params, lam, PackingWeights().tensor(b.device))
    return out[0], out[1]


PACKING = ("packing_round", "explain_summary")


def packing_paths(card) -> dict:
    """The packing engine's paths: BinPacking/1000Nodes_3000Pods on the
    greedy, batched and packing engines (the frontier: packing must use no
    more nodes than greedy), SchedulingBasic/5000Nodes_10000Pods on
    packing, and the same on the 32-slice fleet with ``topology="on"``.
    Returns the runs by key."""
    from kubetpu_torch.assign.batched import batched_assign_plain
    from kubetpu_torch.assign.greedy import greedy_assign_plain

    frontier = {}
    runs = {}
    for engine, plain, names in (
            ("greedy", greedy_assign_plain, ("filter_score", "greedy_scan", "explain_summary")),
            ("batched", batched_assign_plain,
             ("batched_round", "explain_summary")),
            ("packing", plain_packing, PACKING)):
        run = run_path(card, "BinPacking", "1000Nodes_3000Pods", engine, 200 + 3000, plain,
                       names)
        res = run[3]
        frontier[engine] = {
            "pods_per_s": res.throughput,
            "nodes_used_at_steady_state": res.nodes_used_at_steady_state,
            "priority_slo_hit_rate": res.priority_slo_hit_rate,
            "solver_iters_per_cycle": res.solver_iters_per_cycle,
        }
        runs[f"binpack {engine}"] = run
    used = {e: f["nodes_used_at_steady_state"] for e, f in frontier.items()}
    if used["packing"] > used["greedy"]:
        raise AssertionError(f"BinPacking: packing uses {used['packing']} nodes, greedy "
                             f"{used['greedy']}")
    log(json.dumps({"packing_frontier": {
        "workload": "BinPacking/1000Nodes_3000Pods", **frontier, "card": card}}))
    runs["basic packing"] = run_path(card, "SchedulingBasic", "5000Nodes_10000Pods", "packing",
                                     1000 + 10000, plain_packing, PACKING + ("scatter_rows",),
                                     check=steady_deltas)
    runs["basic packing sliced"] = run_path(card, "SchedulingBasic", "5000Nodes_10000Pods",
                                            "packing", 1000 + 10000, plain_packing, PACKING,
                                            workload_kw=dict(topology="on", slices=SLICES))
    return runs


def pv_check(sched) -> dict:
    """The PV cases' own check. The runner creates every PV bound to its
    PVC and restricting no node, as the reference's templates do, so
    VolumeBinding has nothing to bind: what the scheduler can get wrong
    here is a PreBind write for a claim already bound (the client's
    ``pvc_binds``), a pick left assumed in the plugin, a PV rebound in
    its cache, a bound pod missing from its node, or a pod on a node its
    PV's node affinity excludes. Each of these is checked."""
    from kubetpu_torch.state.volumes import node_affinity_matches

    cache = sched.cache
    if sched.client.pvc_binds:
        raise AssertionError(f"VolumeBinding wrote {len(sched.client.pvc_binds)} PVC "
                             f"bindings for claims that were bound: "
                             f"{sched.client.pvc_binds[:3]}")
    vb = [p for p in sched.lifecycle.reserve_plugins if p.name == "VolumeBinding"]
    if vb[0]._assumed:
        raise AssertionError(f"VolumeBinding left {len(vb[0]._assumed)} picks assumed")
    refs = {}
    for key, pvc in cache.pvcs.items():
        pv = cache.pvs.get(pvc.volume_name)
        if pv is None or pv.claim_ref != key:
            raise AssertionError(f"PVC {key}: its PV {pvc.volume_name} is not bound to it")
        refs[pv.name] = refs.get(pv.name, 0) + 1
    twice = [n for n, c in refs.items() if c != 1]
    if twice:
        raise AssertionError(f"PVs {twice[:5]} bound to more than one PVC")
    where = dict(sched.client.bound)
    placed = 0
    for node_name in set(where.values()):
        info = cache.get_node_info(node_name)
        labels = info.node.labels_dict()
        for pod in info.pods.values():
            for vol in pod.volumes:
                pv = cache.pvs[cache.pvcs[f"{pod.namespace}/{vol.pvc_name}"].volume_name]
                if not node_affinity_matches(pv.node_affinity, labels, node_name):
                    raise AssertionError(f"pod {pod.name} on {node_name}, which its PV "
                                         f"{pv.name} excludes")
            placed += bool(pod.volumes)
    if placed != len(where):
        raise AssertionError(f"{placed} PV pods on their nodes in the cache, "
                             f"{len(where)} bound")
    return {"pvcs_bound_once": len(refs), "pv_pods_on_allowed_nodes": placed,
            "pvc_bind_writes": len(sched.client.pvc_binds)}


def claim_check(per_node: int):
    """SchedulingWithResourceClaimTemplate's own check: every claim of a
    bound pod allocated on that pod's node, no device allocated to two
    claims, at most ``per_node`` claims a node, and every allocated claim's
    status written once by PreBind (the client's ``update_claim_status``).
    Returns the claims' fields for the path's line."""
    def check(sched) -> dict:
        claims = sched.cache.dra.claims
        where = dict(sched.client.bound)
        devices, per = set(), {}
        for key, c in claims.items():
            a = c.allocation
            if a is None:
                raise AssertionError(f"claim {key} not allocated")
            pod = key.split("/", 1)[1][:-len("-claim")]
            if where.get(pod) != a.node_name:
                raise AssertionError(f"claim {key} on {a.node_name}, its pod on {where.get(pod)}")
            for r in a.results:
                dev = (r.driver, r.pool, r.device)
                if dev in devices:
                    raise AssertionError(f"device {dev} allocated twice")
                devices.add(dev)
            per[a.node_name] = per.get(a.node_name, 0) + 1
        if max(per.values()) > per_node:
            raise AssertionError(f"a node holds {max(per.values())} claims, over {per_node}")
        written = [c.key for c in sched.client.claim_status]
        if sorted(written) != sorted(claims):
            raise AssertionError(f"PreBind wrote {len(written)} claim statuses "
                                 f"({len(set(written))} distinct) for {len(claims)} claims")
        return {"claims_allocated": len(claims), "devices_allocated": len(devices),
                "max_claims_per_node": max(per.values()),
                "claim_status_writes": len(written)}
    return check


# The prioritized-list scenario at size: 500 DRA nodes with 10 slow devices
# each, 250 of them also with 2 fast ones, and 1000 claim pods. In the
# contention form the 250 fast nodes carry one fast device and no slow one:
# the scan, which sees each node's devices only through the cycle's static
# mask, puts many of a batch's pods on one fast node, and Reserve rejects
# all but the first, which requeue and bind on slow nodes in later cycles.
PRIORITIZED = {"n_nodes": 500, "slow": 10, "fast": 2, "fast_every": 2, "n_pods": 1000,
               "slow_on_fast": True}
PRIORITIZED_CONTENTION = {**PRIORITIZED, "fast": 1, "slow_on_fast": False}


def prioritized_phase(card, cfg: dict) -> dict:
    """Prioritized lists at size (``tests/test_dra.py:357``'s scenario scaled
    up, a drive of the port's DynamicResources, not a scheduler_perf case):
    ``cfg``'s DRA nodes (``PRIORITIZED`` or ``PRIORITIZED_CONTENTION``)
    and pods each with its own claim whose one request is first_available
    = (fast, slow), through the port's Scheduler on the card (greedy
    engine, defaults, recorder on) under a stepped clock. Gates: every pod
    bound, each fast device allocated at most once, every claim's status
    written by PreBind, capacity held, the kernels launched, every
    recorder record resolved, every cycle's kernel assignments and final
    state equal to the plain engine's on that cycle's batch (cycles whose
    pods Reserve rejects and requeues included), and in the contention
    form at least one Reserve rejection and every fast device taken.
    Prints the cycles, the Reserve rejections, the pods on a fast device,
    pods/s and the per-cycle spans. Returns the launch counts."""
    import dataclasses

    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.greedy import greedy_assign_plain
    from kubetpu_torch.perf.runner import _Client, _cycle_ms
    from kubetpu_torch.sched import Scheduler

    nodes, classes, slices, claims, pods = dra_objects(
        n_nodes=cfg["n_nodes"], slow=cfg["slow"], fast=cfg["fast"],
        fast_every=cfg["fast_every"], n_prio=cfg["n_pods"],
        slow_on_fast=cfg["slow_on_fast"])
    contention = not cfg["slow_on_fast"]
    clock = SteppedClock()
    client = _Client()
    sched = Scheduler(client, device="cuda", clock=clock)
    client.sched = sched
    sched.enable_preemption()
    for c in classes:
        sched.on_device_class_add(c)
    for n in nodes:
        sched.on_node_add(n)
    for s in slices:
        sched.on_resource_slice_add(s)
    sched.warmup()
    cycles, rejected = [], []
    engine = sched._assign_device

    def keep(b, params):
        out = engine(b, params)
        cycles.append((dataclasses.replace(b, nodes=_clone_nodes(b.nodes)), params,
                       out[0].clone(), tuple(_clone(x) for x in out[1])))
        return out

    reject = sched._reject_assumed

    def note_reject(info, assumed, st):
        rejected.append((info.key, st.plugin))
        reject(info, assumed, st)

    sched._assign_device = keep
    sched._reject_assumed = note_reject
    gc.collect()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for c, p in zip(claims, pods):
        sched.on_resource_claim_add(c)
        sched.on_pod_add(p)
    for _ in range(200):
        sched.schedule_batch()
        client.deliver()
        if len(client.bound) == len(pods):
            break
        clock.t += 1.0
    secs = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    if len(client.bound) != len(pods):
        raise AssertionError(f"prioritized lists: {len(client.bound)} of {len(pods)} bound")
    _check_capacity(sched)
    fast = [(r.pool, r.device) for c in sched.cache.dra.claims.values()
            for r in c.allocation.results if r.request.endswith("/fast")]
    if len(fast) != len(set(fast)):
        raise AssertionError("prioritized lists: a fast device allocated twice")
    written = sorted(c.key for c in client.claim_status)
    if written != sorted(sched.cache.dra.claims):
        raise AssertionError(f"prioritized lists: {len(written)} claim-status writes")
    fast_devices = cfg["n_nodes"] // cfg["fast_every"] * cfg["fast"]
    if contention and not (rejected and len(fast) == fast_devices):
        raise AssertionError(f"prioritized lists under contention: {len(rejected)} Reserve "
                             f"rejections, {len(fast)} of {fast_devices} fast devices taken")
    if any(plugin != "DynamicResources" for _, plugin in rejected):
        raise AssertionError(f"prioritized lists: rejections {sorted(set(rejected))[:5]}")
    for i, (b, params, got, state) in enumerate(cycles):
        want, want_state = greedy_assign_plain(b, params)
        torch.cuda.synchronize()
        _engine_err(f"prioritized lists cycle {i}", got, state, want, want_state)
    for name in ("filter_score", "greedy_scan", "explain_summary"):
        if launches[name] < 1:
            raise AssertionError(f"prioritized lists: never launched {name}")
    timings = sched.metrics.cycle_timings
    line = {"main_path": {
        "workload": f"prioritized lists (tests/test_dra.py:357 at {cfg['n_nodes']} nodes"
                    f"{', contention' if contention else ''})",
        "engine": "greedy", **cfg, "pods_bound": len(client.bound),
        "pods_per_s": len(pods) / secs, "run_s": secs, "cycles": len(timings),
        "every_cycle_equal": len(cycles), "reserve_rejections": len(rejected),
        "pods_on_fast_devices": len(fast), "claim_status_writes": len(written),
        "cycle_ms": _cycle_ms(timings), "launches": launches, "card": card,
        **recorder_check(sched, launches),
    }}
    log(json.dumps(line))
    ms = line["main_path"]["cycle_ms"]
    log(f"[prioritized lists{', contention' if contention else ''}] {len(timings)} cycles "
        f"(each equal to the plain engine), {len(rejected)} Reserve rejections, "
        f"{len(fast)} pods on a fast device of {fast_devices}; stage 1 "
        f"{ms['pre_encode']:.3f} ms, stage 2 {ms['finalize']:.3f} ms, kernel "
        f"{ms['kernel']:.3f} ms, bind {ms['bind']:.3f} ms a cycle; "
        f"{len(pods) / secs:.1f} pods/s")
    return launches


def dra_paths(card) -> list:
    """The volume and DRA paths through ``run_workload(device="cuda")`` on
    the defaults: SchedulingInTreePVs and SchedulingCSIPVs
    /5000Nodes_2000Pods (greedy; every PVC's PV bound once),
    SchedulingWithResourceClaimTemplate/5000pods_500nodes on the greedy
    and the batched engine (R = 4; ``claim_check``), then the
    prioritized-list scenario with and without device contention
    (``prioritized_phase``). Returns their
    launch counts."""
    from kubetpu_torch.assign.batched import batched_assign_plain
    from kubetpu_torch.assign.greedy import greedy_assign_plain
    from kubetpu_torch.perf import workloads as W

    greedy = ("filter_score", "greedy_scan", "explain_summary")
    batched = ("batched_round", "explain_summary")
    runs = [
        run_path(card, case, "5000Nodes_2000Pods", "greedy", 1000 + 2000,
                 greedy_assign_plain, greedy + ("scatter_rows",), check=pv_check)
        for case in ("SchedulingInTreePVs", "SchedulingCSIPVs")
    ]
    # 500 nodes: every cycle dirties more than half of them, so the node
    # block ships whole (no scatter_rows). The batched engine's run is cut
    # to 1000 pods (its binds take about 2.6 s a cycle)
    cut = W.Workload("1000pods_500nodes", {"nodesWithDRA": 500, "nodesWithoutDRA": 0,
                                           "initPods": 500, "measurePods": 500,
                                           "maxClaimsPerNode": 10})
    for engine, plain, names, workload, expected in (
            ("greedy", greedy_assign_plain, greedy, "5000pods_500nodes", 2500 + 2500),
            ("batched", batched_assign_plain, batched, cut, 500 + 500)):
        runs.append(run_path(card, "SchedulingWithResourceClaimTemplate", workload,
                             engine, expected, plain, names, check=claim_check(10)))
    return [run[0] for run in runs] + [prioritized_phase(card, cfg) for cfg in (
        PRIORITIZED, PRIORITIZED_CONTENTION)]


def main_path_phase(card: str) -> dict:
    """The six paths on the defaults (encode cache, resident block,
    serial cycle), then SchedulingBasic and PreferredTopologySpreading
    again with the pipelined cycle, whose bound maps must equal the serial
    runs' pod for pod. Returns every run (``run_path``'s tuple) by key."""
    from kubetpu_torch.assign.batched import batched_assign_plain
    from kubetpu_torch.assign.greedy import greedy_assign_plain

    # the 5000-node paths bind at most 2048 distinct nodes a cycle (1024
    # assumes, 1024 confirmations), under the dense-update rule's half:
    # their node uploads go through scatter_rows. 500 nodes take the full
    # upload every cycle.
    greedy = ("filter_score", "greedy_scan", "scatter_rows", "explain_summary")
    batched = ("batched_round", "scatter_rows", "explain_summary")
    runs = {
        "basic": run_path(card, "SchedulingBasic", "5000Nodes_10000Pods", "greedy",
                          1000 + 10000, greedy_assign_plain, greedy, check=steady_deltas),
        "affinity": run_path(card, "SchedulingPodAffinity", "5000Nodes_5000Pods",
                             "batched", 5000 + 5000, batched_assign_plain, batched),
        "spread": run_path(card, "TopologySpreading", "5000Nodes_5000Pods", "batched",
                           5000 + 5000, batched_assign_plain, batched, check=zone_skew),
        "preferred": run_path(card, "PreferredTopologySpreading", "5000Nodes_5000Pods",
                              "greedy", 5000 + 5000, greedy_assign_plain, greedy),
        "default": run_path(card, "DefaultTopologySpreading", "500Nodes", "greedy",
                            1000 + 1000, greedy_assign_plain,
                            ("filter_score", "greedy_scan", "explain_summary"),
                            every_cycle=True),
        # churn pods preempt: the bound total depends on their timing
        "preemption": run_path(card, "PreemptionAsync", "5000Nodes", "greedy", None,
                               greedy_assign_plain,
                               greedy + ("dry_run_preemption", "filter_component_masks"),
                               check=preemption_check),
    }
    # the reference's FlightRecorderOverhead comparison: Basic again with
    # the recorder off (printed, not gated)
    # (its decisions are the recorder-on run's: its bound map must equal
    # that run's, and the plain engine is not run again)
    off = run_path(card, "SchedulingBasic", "5000Nodes_10000Pods", "greedy", 1000 + 10000,
                   None, greedy[:3], check=steady_deltas, flight_recorder=False)
    if off[1] != runs["basic"][1]:
        raise AssertionError("SchedulingBasic with the recorder off bound pods elsewhere than "
                             "with it on")
    on_pps, off_pps = runs["basic"][2], off[2]
    log(json.dumps({"flight_recorder_overhead": {
        "workload": "SchedulingBasic/5000Nodes_10000Pods", "pods_per_s_on": on_pps,
        "pods_per_s_off": off_pps, "on_over_off": on_pps / off_pps, "card": card}}))
    runs["basic recorder off"] = off
    runs.update(extender_paths(card))
    for key, case, expected in (("basic", "SchedulingBasic", 1000 + 10000),
                                ("preferred", "PreferredTopologySpreading", 5000 + 5000)):
        workload = "5000Nodes_10000Pods" if key == "basic" else "5000Nodes_5000Pods"
        # held to the serial run pod for pod, which is held to the plain engine
        run = run_path(card, case, workload, "greedy", expected, None, greedy, pipeline=True)
        bound, serial = run[1], runs[key][1]
        if bound != serial:
            moved = sum(1 for k, v in bound.items() if serial.get(k) != v)
            raise AssertionError(f"{case} pipelined: {moved} pods bound elsewhere than "
                                 "in the serial run")
        log(f"[{case} pipelined] bound map equal to the serial run's, pod for pod "
            f"({len(bound)} pods); {run[2]:.1f} pods/s against the serial run's "
            f"{runs[key][2]:.1f}")
        runs[key + " pipelined"] = run
    stamp("phase 4: main, webhook and pipelined paths")
    # the node mesh: four logical shards on this card
    runs.update(mesh_paths(card, node_mesh(4, True), runs))
    return runs


def mesh_paths(card, mesh, unsharded: dict) -> dict:
    """Phase 4 under the node mesh: ``SchedulingBasic/5000Nodes_10000Pods``
    on the greedy engine (11000 bound, the bound map equal pod for pod to
    the unsharded run's, ``sharded_scan`` and the routed ``scatter_rows``
    launched, every recorder record there and marked "skipped: mesh"),
    ``SchedulingPodAffinity/5000Nodes_5000Pods`` on the batched engine (the
    same gates, through ``sharded_round``), and
    ``PreemptionAsync/5000Nodes`` (every measured pod bound, at least one
    nomination, victims below their preemptor, the sharded dry run
    launched). ``unsharded`` holds the unsharded runs' results by case.
    Returns the runs' launch counts."""
    greedy = ("filter_score", "sharded_scan", "scatter_rows")
    shape = "x".join(map(str, mesh.shape))
    runs = {}
    basic = run_path(card, "SchedulingBasic", "5000Nodes_10000Pods", "greedy", 1000 + 10000,
                     None, greedy, check=steady_deltas, workload_kw=dict(mesh=mesh))
    want = unsharded["basic"]
    if basic[1] != want[1]:
        moved = sum(1 for k, v in basic[1].items() if want[1].get(k) != v)
        raise AssertionError(f"SchedulingBasic under the mesh: {moved} pods bound elsewhere "
                             "than in the unsharded run")
    log(f"[SchedulingBasic mesh {shape}] bound map equal to the unsharded run's, pod for pod "
        f"({len(basic[1])} pods); {basic[2]:.1f} pods/s against the unsharded "
        f"{want[2]:.1f}")
    runs["basic mesh"] = basic
    affinity = run_path(card, "SchedulingPodAffinity", "5000Nodes_5000Pods", "batched",
                        5000 + 5000, None, ("sharded_round", "scatter_rows"),
                        workload_kw=dict(mesh=mesh))
    want = unsharded["affinity"]
    if affinity[1] != want[1]:
        moved = sum(1 for k, v in affinity[1].items() if want[1].get(k) != v)
        raise AssertionError(f"SchedulingPodAffinity under the mesh: {moved} pods bound "
                             "elsewhere than in the unsharded run")
    log(f"[SchedulingPodAffinity batched mesh {shape}] bound map equal to the unsharded "
        f"run's, pod for pod ({len(affinity[1])} pods); {affinity[2]:.1f} pods/s against "
        f"the unsharded {want[2]:.1f}")
    runs["affinity mesh"] = affinity
    pre = run_path(card, "PreemptionAsync", "5000Nodes", "greedy", None, None,
                   greedy + ("dry_run_preemption", "shard_pick"), check=preemption_check,
                   workload_kw=dict(mesh=mesh))
    want = unsharded["preemption"]
    log(f"[PreemptionAsync mesh {shape}] {pre[3].scheduled} of {pre[3].measure_pods} measured "
        f"pods bound ({len(pre[1])} in all, unsharded {len(want[1])}); "
        f"{pre[3].preemptions} nominations; {pre[2]:.1f} pods/s against the unsharded "
        f"{want[2]:.1f}")
    runs["preemption mesh"] = pre
    return runs


def _same_bound(label, got, want) -> None:
    if got[1] != want[1]:
        moved = sum(1 for k, v in got[1].items() if want[1].get(k) != v)
        raise AssertionError(f"{label}: {moved} pods bound elsewhere than in the unsharded run")


def mesh12_paths(card, mesh, grid, unsharded: dict) -> dict:
    """Phase 4 for the packing engine on the node mesh and the pods x nodes
    grid: ``BinPacking/1000Nodes_3000Pods`` and
    ``SchedulingBasic/5000Nodes_10000Pods`` on packing under ``mesh``
    (through ``sharded_packing``; bound maps pod for pod and nodes used
    equal to the unsharded packing runs'), then
    ``SchedulingPodAffinity/5000Nodes_5000Pods`` on the batched engine
    (``tiled_round``) and ``SchedulingBasic/5000Nodes_10000Pods`` on the
    greedy engine (``tiled_scan``) under ``grid``, bound maps equal to the
    unsharded runs'. ``unsharded`` holds those runs by key. Then the same two
    packing paths on ``grid`` (through ``tiled_packing``, K8). Returns the
    runs."""
    shape = "x".join(map(str, mesh.shape))
    gshape = "x".join(map(str, grid.shape))
    runs = {}
    for where, m, kernel in (("mesh", mesh, "sharded_packing"), ("grid", grid, "tiled_packing")):
        label = f"{where} {shape if where == 'mesh' else gshape}"
        for key, case, workload, expected, names in (
                ("binpack packing", "BinPacking", "1000Nodes_3000Pods", 200 + 3000,
                 (kernel,)),
                ("basic packing", "SchedulingBasic", "5000Nodes_10000Pods", 1000 + 10000,
                 (kernel, "scatter_rows"))):
            run = run_path(card, case, workload, "packing", expected, None, names,
                           workload_kw=dict(mesh=m))
            want = unsharded[key]
            _same_bound(f"{case} packing on the {where}", run, want)
            used = run[3].nodes_used_at_steady_state
            want_used = want[3].nodes_used_at_steady_state
            if used != want_used:
                raise AssertionError(f"{case} packing on the {where}: {used} nodes used, "
                                     f"unsharded {want_used}")
            log(f"[{case} packing {label}] bound map equal to the unsharded run's, pod for "
                f"pod ({len(run[1])} pods), {used} nodes used; {run[2]:.1f} pods/s against "
                f"the unsharded {want[2]:.1f}")
            runs[f"{key} {where}"] = run
    # (the batched solve runs its Filter + Score inside; the tiled scan
    # after each tile's filter_score)
    for key, case, workload, engine, expected, kernels_ in (
            ("affinity", "SchedulingPodAffinity", "5000Nodes_5000Pods", "batched", 5000 + 5000,
             ("tiled_round", "scatter_rows")),
            ("basic", "SchedulingBasic", "5000Nodes_10000Pods", "greedy", 1000 + 10000,
             ("filter_score", "tiled_scan", "scatter_rows"))):
        run = run_path(card, case, workload, engine, expected, None, kernels_,
                       workload_kw=dict(mesh=grid))
        want = unsharded[key]
        _same_bound(f"{case} {engine} on the grid", run, want)
        log(f"[{case} {engine} grid {gshape}] bound map equal to the unsharded run's, pod for "
            f"pod ({len(run[1])} pods); {run[2]:.1f} pods/s against the unsharded "
            f"{want[2]:.1f}")
        runs[key + " grid"] = run
    return runs


def mesh_batches():
    """The batches the mesh's K1 is held on: (name, batch, params, with
    the sharded plain engine too). Every template variant of the scan:
    none (SchedulingBasic, the mixed cluster), affinity (the affinity
    cluster, SchedulingPodAffinity), spread (the spread cluster under both
    profiles, PreferredTopologySpreading), DRA (SchedulingBasic with a
    seeded leaf)."""
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.perf import workloads as W

    out = []
    cache, pending = basic_case()
    b, params = encode(cache, pending, C.Profile())
    basic = (b, params)
    out.append(("SchedulingBasic 1024x5120", b, params, False))
    out.append(("SchedulingBasic with a DRA leaf", dra_leaf(b), params, False))
    cache, pending = mixed_case(seed=1)
    out.append(("mixed/least", *encode(cache, pending, C.Profile()), True))
    cache, pending = affinity_case(seed=2)
    out.append(("affinity/default",
                *encode(cache, pending, affinity_profiles()["default"]), True))
    cache, pending = podaffinity_case()
    out.append(("SchedulingPodAffinity 1024x5120", *encode(cache, pending, C.Profile()),
                False))
    for name, prof in spread_profiles().items():
        cache, pending = spread_case(seed=3)
        out.append((f"spread/{name}", *encode(cache, pending, prof), True))
    cache, pending = topology_case(W.pod_with_preferred_topology_spreading)
    out.append(("PreferredTopologySpreading 1024x5120", *encode(cache, pending, C.Profile()),
                False))
    rounds = sorted(((name, b_, p_, True) for name, b_, p_, _ in out
                     if name.startswith(("SchedulingPodAffinity", "mixed", "affinity",
                                         "spread/spread"))),
                    key=lambda r: not r[0].startswith("SchedulingPodAffinity"))
    cache, pending = topology_case(W.pod_with_topology_spreading)
    rounds.append(("TopologySpreading 1024x5120", *encode(cache, pending, C.Profile()), True))
    return out, basic, rounds


def mesh_mode() -> int:
    """``python3 chip_smoke.py --mesh``: the mesh's checks and paths with one
    shard (one tile) a card over every visible card (on a machine of four
    H100s, four node shards and a 2 x 2 grid; with one card, four logical
    shards and four logical tiles on it): phase 3's mesh checks
    (``mesh_checks``, ``packing_mesh_checks``, ``grid_checks``), the
    unsharded SchedulingBasic, SchedulingPodAffinity, PreemptionAsync,
    BinPacking and packing paths, the same under the mesh and the grid
    (``mesh_paths``, ``mesh12_paths``), ``measure_collective_wall``; then
    the mesh kernels' JSON line, the cards' line and the ``ok`` line."""
    import torch

    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    card = device_phase()
    build_phase()
    count = torch.cuda.device_count()
    mesh = node_mesh(count, False) if count > 1 else node_mesh(4, True)
    grid = grid_mesh(count < 4)
    log(f"mesh: {mesh.size} shards on {len(mesh.cards())} card(s), grid {list(grid.shape)} "
        f"on {len(grid.cards())} card(s), {torch.cuda.device_count()} visible")
    batches, basic, rounds = mesh_batches()
    results: dict = {"scatter_rows": {"cases": [], "max_abs_err": 0}}
    timing = mesh_checks(mesh, results, batches, basic, rounds)
    pm_cases = packing_mesh_batches(basic)
    timing.update(packing_mesh_checks(mesh, results, pm_cases))
    by_name = {name: (b_, p_) for name, b_, p_, _ in batches + rounds}
    timing.update(grid_checks(grid, results, grid_batches(
        basic, by_name["SchedulingPodAffinity 1024x5120"],
        by_name["TopologySpreading 1024x5120"])))
    batched_solve_checks(results, mesh, grid, solve_batches(
        basic, by_name["SchedulingPodAffinity 1024x5120"]))
    results.setdefault("filter_score", {"cases": [], "max_abs_err": 0})
    potential_mesh_checks([(f"{mesh.size} shards", mesh), ("2 x 2 grid", grid)], results)
    pm = {c[0]: c[:3] for c in pm_cases}
    timing.update(packing_grid_checks(
        grid, mesh, results, [pm["BinPacking 256x5120"], pm["BinPacking 256x5120, 32 slices"]],
        full=pm["BinPacking 1024x5120"]))
    lines = mesh_kernel_lines(results, timing)
    from kubetpu_torch.assign.batched import batched_assign_plain
    from kubetpu_torch.assign.greedy import greedy_assign_plain

    greedy = ("filter_score", "greedy_scan", "scatter_rows", "explain_summary")
    unsharded = {
        "basic": run_path(card, "SchedulingBasic", "5000Nodes_10000Pods", "greedy",
                          1000 + 10000, greedy_assign_plain, greedy, check=steady_deltas),
        "affinity": run_path(card, "SchedulingPodAffinity", "5000Nodes_5000Pods", "batched",
                             5000 + 5000, batched_assign_plain,
                             ("batched_round", "scatter_rows",
                              "explain_summary")),
        "preemption": run_path(card, "PreemptionAsync", "5000Nodes", "greedy", None,
                               greedy_assign_plain,
                               greedy + ("dry_run_preemption", "filter_component_masks"),
                               check=preemption_check),
        "binpack packing": run_path(card, "BinPacking", "1000Nodes_3000Pods", "packing",
                                    200 + 3000, plain_packing, PACKING),
        "basic packing": run_path(card, "SchedulingBasic", "5000Nodes_10000Pods", "packing",
                                  1000 + 10000, plain_packing, PACKING + ("scatter_rows",)),
    }
    runs = mesh_paths(card, mesh, unsharded)
    runs.update(mesh12_paths(card, mesh, grid, unsharded))
    sliced = dict(feature_gates=GANG_GATES, topology="on", slices=SLICES)
    gang = {
        f"gang3 {engine}": run_path(card, "GangScheduling",
                                    "5000Nodes_3Gangs_3000Pods_1000PerGroup", engine, 3000,
                                    None, names, check=gang_check(1000, True),
                                    workload_kw=sliced)
        for engine, names in (("greedy", ("filter_score", "hypothesis_scan")),
                              ("batched", ("batched_round", "hypothesis_rows",
                                           "slice_epilogue")))}
    runs.update(gang_mesh_paths(card, mesh, grid, gang))
    for k in lines:
        k["launches"] = sum(run[0][k["name"]] for run in runs.values())
    from kubetpu_torch.parallel import mesh as M

    log(json.dumps({"mesh": {"shape": list(mesh.shape), "cards": len(mesh.cards()),
                             "grid": list(grid.shape), "grid_cards": len(grid.cards()),
                             "device_count": count,
                             "exchange_us_per_round_trip": timing["shard_argmax"]["exchange_us"],
                             "measure_collective_wall_s": M.measure_collective_wall(mesh),
                             "card": card}}))
    log(f"chip_smoke --mesh: all phases passed in {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": lines}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
    }}), flush=True)
    return 0


def time_checkout(mode: str, root: str) -> int:
    """The ``--time-basic ROOT``, ``--time-spread ROOT`` and ``--time-mesh
    ROOT`` modes: CUDA-event medians of the checkout at ``root``'s
    ``filter_score`` and ``greedy_scan`` engine, on the SchedulingBasic
    cycle (``basic``), or on the PreferredTopologySpreading cycle and the
    mixed spread cluster under the spread profile (``spread``); 1024 pods
    x 5120 padded nodes but the mixed cluster's 512 x 2048. ``mesh``: its
    greedy engine on the SchedulingBasic cycle, its batched engine on the
    SchedulingPodAffinity cycle and its packing solve on the BinPacking
    block (1024 and 256 pods), each sharded by its ``shard_batch`` over
    four logical shards on cuda:0 (kernels K1, K2 and K5, through its
    ``greedy_assign_device`` / ``batched_assign_device`` /
    ``packing_assign_device``) and unsharded."""
    sys.path.insert(0, str(Path(root).resolve()))
    card = device_phase()
    from kubetpu_torch import kernels
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.perf import workloads as W

    if mode in ("mesh", "batched"):
        # the libraries the mode launches (the others take most of a build)
        kernels.SOURCES = tuple(src for src in kernels.SOURCES if src in (
            "filter_score.cu", "greedy_scan.cu", "batched_round.cu", "packing_round.cu",
            "hypothesis_scan.cu"))
    if mode == "recorder":
        kernels.SOURCES = tuple(src for src in kernels.SOURCES if src in (
            "filter_score.cu", "scatter_rows.cu", "dry_run_preemption.cu",
            "explain_summary.cu", "filter_component_masks.cu"))
    kernels.build()
    log_build_report(kernels)
    line = {"root": root, "card": card}
    if mode == "mesh":
        time_mesh(line)
        log(json.dumps({"time_mesh": line}))
        return 0
    if mode == "batched":
        time_batched(line)
        log(json.dumps({"time_batched": line}))
        return 0
    if mode == "recorder":
        time_recorder(line)
        log(json.dumps({"time_recorder": line}))
        return 0
    if mode == "b3":
        time_b3(line)
        log(json.dumps({"time_b3": line}))
        return 0
    if mode == "basic":
        batches = {"": encode(*basic_case(), C.Profile())}
    else:
        batches = {
            "preferred_": encode(*topology_case(W.pod_with_preferred_topology_spreading),
                                 C.Profile()),
            "mixed_": encode(*spread_case(seed=3), spread_profiles()["spread"]),
        }
    for prefix, (b, params) in batches.items():
        line[prefix + "filter_score_ms"] = cuda_ms(lambda: kernels.filter_score(b, params), 20)
        line[prefix + "greedy_scan_ms"] = cuda_ms(lambda: kernels.greedy_scan(b, params), 10)
    if mode == "basic":
        time_hypotheses(line)
    split_lib = scan_split_lib(kernels)
    if split_lib is not None:
        for prefix, (b, params) in list(batches.items())[:1]:
            line[prefix + "split"] = scan_split(kernels, split_lib, b, params)
    log(json.dumps({f"time_{mode}": line}))
    return 0


def time_hypotheses(line: dict) -> None:
    """``--time-basic``'s B11 entries of ``line``: the imported
    checkout's placement search (``placement_scan``, one
    ``hypothesis_scan`` launch after its ``filter_score``) on the
    SchedulingBasic block cut into 32 slices, P = 1000 and D = 33
    placements, and on the 3-pod gang of the 1000-gang case over the same
    placements (CUDA-event medians)."""
    from kubetpu_torch import kernels
    from kubetpu_torch.framework import config as C

    for key, pods, reps in (("placement_scan_ms", 1000, 5), ("placement_scan_3pod_ms", 3, 20)):
        cache, pending = basic_case(n_pending=pods)
        b, params = encode_topology(sliced(cache, SLICES), pending, C.Profile())
        masks, _ = slice_masks(b)
        line[key] = cuda_ms(lambda: kernels.placement_scan(b.device, params, masks), reps)
    line["placement_shape"] = [1000, int(b.device.alloc.shape[0]), int(masks.shape[0])]


def scan_split_lib(kernels):
    """The imported checkout's timing build of the scan
    (``csrc/scan_split.cu``: ``greedy_scan.cu`` with the step split compiled
    in, and the step floor), built with its nvcc flags and ptxas' report
    printed; None when the checkout has none."""
    import hashlib

    src = kernels.CSRC / "scan_split.cu"
    if not src.exists():
        return None
    key = hashlib.sha256((kernels._digest()).encode() + src.read_bytes()).hexdigest()[:16]
    out = kernels.BUILD_DIR / "split" / key / "libscan_split.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".tmp")
        proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on scan_split.cu:\n" + proc.stdout + proc.stderr)
        for text in (proc.stdout, proc.stderr):
            for row in text.splitlines():
                if "registers" in row or "spill" in row or "Compiling entry function" in row:
                    log(f"  scan_split.cu: {row.strip()}")
        tmp.replace(out)
    return load_split_lib(kernels, out)


def load_split_lib(kernels, path):
    """The timing build at ``path`` loaded, its entries typed."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    lib.kt_greedy_scan.argtypes = kernels._ARGTYPES["greedy_scan"]
    lib.kt_greedy_scan.restype = ctypes.c_int
    lib.kt_greedy_scan_error.argtypes = [ctypes.c_int]
    lib.kt_greedy_scan_error.restype = ctypes.c_char_p
    lib.kt_scan_split.argtypes = [ctypes.c_void_p]
    lib.kt_scan_split.restype = ctypes.c_int
    lib.kt_scan_floor.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p]
    lib.kt_scan_floor.restype = ctypes.c_int
    return lib


def scan_split(kernels, lib, b, params, check=True) -> dict:
    """Where a step of the scan goes on batch ``b``: the timing build's
    ``greedy_scan`` (the wrapper's arguments, the split library's kernel;
    with ``check`` its assignments must equal the real kernel's), µs a step
    from its
    clock64() marks (``scan_loop.cuh`` KT_SCAN_SPLIT), and the step floor:
    the same block shape and steps with only the reductions and barriers
    (``scan_floor_kernel``, CUDA events)."""
    import ctypes

    import torch

    want = kernels.greedy_scan(b, params)[0]
    real = kernels._libs["greedy_scan"]
    kernels._libs["greedy_scan"] = lib
    try:
        got = kernels.greedy_scan(b, params)[0]
        torch.cuda.synchronize()
    finally:
        kernels._libs["greedy_scan"] = real
    if check and not torch.equal(got, want):
        raise AssertionError("the split build's scan differs from the kernel's")
    words = (ctypes.c_uint64 * 16)()
    if lib.kt_scan_split(ctypes.byref(words)) != 0:
        raise RuntimeError("kt_scan_split failed")
    P, N = int(b.requests.shape[0]), int(b.alloc.shape[0])
    ns_per_cycle = words[12] / max(words[11], 1)

    def us(cycles):
        return cycles * ns_per_cycle / 1000 / P

    norm = 6 if b.spread is not None else 2
    out = torch.empty((1,), dtype=torch.int64, device=b.alloc.device)
    stream = torch.cuda.current_stream().cuda_stream

    def floor():
        code = lib.kt_scan_floor(P, N, norm, out.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"kt_scan_floor failed ({code})")

    parts = {name: us(words[i]) for i, name in enumerate(SPLIT_PARTS)}
    return {
        "step_us": words[12] / 1000 / P, "ghz": 1 / ns_per_cycle,
        # the four parts of the loop before the redesign
        "verdicts_us": sum(parts[k] for k in SPLIT_PARTS[:4]),
        "normalize_us": parts["fold"] + parts["norm_reduce"],
        "score_argmax_us": parts["score"] + parts["argmax"], "update_end_us": parts["update"],
        "parts_us": parts, "touched_most_thread_us": us(words[9]),
        "touched_mean_thread_us": us(words[10]),
        "touched_verdict_mean_thread_us": us(words[13]),
        "floor_us": cuda_ms(floor, 10) * 1000 / P, "floor_norm_values": norm,
    }


# scan_loop.cuh's split marks, in order (kt_split[0:9])
SPLIT_PARTS = ("staging", "untouched", "touched", "weights", "fold", "norm_reduce", "score",
               "argmax", "update")


def time_mesh(line: dict) -> None:
    """``--time-mesh``'s entries of ``line``: the node mesh's engines of
    the imported checkout against its unsharded kernels (the sharded
    assignments must equal the unsharded ones)."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.batched import batched_assign_device
    from kubetpu_torch.assign.greedy import greedy_assign_device
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.parallel import mesh as M

    mesh = node_mesh(4, True)
    for prefix, case, sharded, unsharded in (
            ("basic_greedy_", basic_case, greedy_assign_device, kernels.greedy_scan),
            ("podaffinity_batched_", podaffinity_case, batched_assign_device,
             kernels.batched_assign)):
        b, params = encode(*case(), C.Profile())
        sb = M.shard_batch(b, mesh)
        got, want = sharded(sb, params), unsharded(b, params)
        if not torch.equal(got[0].to(want[0].device), want[0]):
            raise AssertionError(f"{prefix}: the sharded engine's assignments differ")
        line[prefix + "sharded_ms"] = cuda_ms(lambda: sharded(sb, params), 20)
        line[prefix + "unsharded_ms"] = cuda_ms(lambda: unsharded(b, params), 20)
    # the packing solve over the node mesh (K5) and the 2 x 2 grid (K8),
    # through the engine's entry point, and unsharded (B14), on the
    # BinPacking block and on its cut to 256 pods
    from kubetpu_torch.assign.packing import PackingWeights, packing_assign_device

    w = PackingWeights().tensor("cuda")
    grid = grid_mesh(True)
    for prefix, n_pending, reps in (("binpack_packing_", 1024, 9), ("binpack256_packing_", 256,
                                                                     15)):
        b, params = encode(*binpack_case(n_pending=n_pending), C.Profile())
        cold = torch.zeros(b.alloc.shape[0], dtype=torch.float32, device="cuda")
        want = kernels.packing_assign(b, params, cold, w)
        for what, layout in (("sharded", mesh), ("grid", grid)):
            sb = M.shard_batch(b, layout)

            def lam(sb=sb):
                return M.ShardedTensor([torch.zeros(s.alloc.shape[0], dtype=torch.float32,
                                                    device=s.device) for s in sb.shards],
                                       rows=sb.pod_rows)

            got = packing_assign_device(sb, params, lam(), w)
            if not torch.equal(got[0].to(want[0].device), want[0]) or got[4] != want[4]:
                raise AssertionError(f"{prefix}{what}: the solve differs from the unsharded one")
            line[prefix + what + "_ms"] = cuda_ms(
                lambda sb=sb, lam=lam: packing_assign_device(sb, params, lam(), w), reps)
            if n_pending == 1024:
                # the card's busy time inside a call (every kernel and copy)
                line[prefix + what + "_device_ms"] = kernel_device_ms(
                    lambda sb=sb, lam=lam: packing_assign_device(sb, params, lam(), w), ("",),
                    3)
        line[prefix + "unsharded_ms"] = cuda_ms(lambda: kernels.packing_assign(b, params, cold,
                                                                               w), reps)
        if n_pending == 1024:
            line[prefix + "unsharded_device_ms"] = kernel_device_ms(
                lambda: kernels.packing_assign(b, params, cold, w), ("",), 3)
            if hasattr(kernels, "packing_split"):
                line[prefix + "split_us"] = packing_split(
                    b, params, w, cold, [("sharded", M.shard_batch(b, mesh)),
                                         ("grid", M.shard_batch(b, grid))])
        line[prefix + "iterations"] = want[4]


# the parts of a packing solve (packing_round.cu's kSplit order)
PACKING_PARTS = ("start", "partials_0_2", "verdicts_3", "normalize_4", "totals_5", "best_6",
                 "ties_7", "rank_pick_8", "admissions_9", "commit_10", "end")


def packing_split(b, params, w, cold, layouts) -> dict:
    """µs in each part of one packing solve (``kernels.packing_split``:
    block 0's clock between marks, barrier waits included), unsharded and
    over each of ``layouts`` (name, sharded batch)."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.packing import packing_assign_device
    from kubetpu_torch.parallel import mesh as M

    out = {}
    runs = [("unsharded", lambda: kernels.packing_assign(b, params, cold, w))] + [
        (name, lambda sb=sb: packing_assign_device(sb, params, M.ShardedTensor(
            [torch.zeros(s.alloc.shape[0], dtype=torch.float32, device=s.device)
             for s in sb.shards], rows=sb.pod_rows), w)) for name, sb in layouts]
    for name, fn in runs:
        kernels.packing_split = torch.zeros(kernels.PACKING_SPLIT, dtype=torch.int64,
                                            device="cuda")
        fn()
        ns = kernels.packing_split.tolist()
        kernels.packing_split = None
        out[name] = dict(zip(PACKING_PARTS, (x / 1e3 for x in ns)))
    return out


def time_batched(line: dict) -> None:
    """``--time-batched``'s entries of ``line``, for the imported checkout's
    batched engine: B6 (``kernels.batched_assign``) on the
    SchedulingPodAffinity, TopologySpreading and BinPacking batches (1024
    x 5120), one batched gang placement search (``batched_hypotheses``:
    the SchedulingBasic block of 1000 pods cut into 32 slices, 33
    placements, one batched solve each), and the batched engine over
    SchedulingPodAffinity's batch on four logical shards (K2) and on the
    2 x 2 grid (K6) of cuda:0, each held to the unsharded kernel first.
    Each: CUDA events around the call (median), the card's busy time a
    call (``torch.profiler``, every kernel and copy), the rounds, and,
    where the checkout has ``kernels.batched_split``, µs in each part of
    one solve (block 0's clock between its marks)."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.batched import batched_assign_device
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.parallel import mesh as M
    from kubetpu_torch.perf import workloads as W

    def split(fn) -> dict | None:
        if not hasattr(kernels, "batched_split"):
            return None
        kernels.batched_split = torch.zeros(kernels.BATCHED_SPLIT, dtype=torch.int64,
                                            device="cuda")
        fn()
        ns = kernels.batched_split.tolist()
        kernels.batched_split = None
        return dict(zip(BATCHED_PARTS, (x / 1e3 for x in ns)))

    def entry(prefix, fn, reps, rounds):
        line[prefix + "ms"] = cuda_ms(fn, reps)
        line[prefix + "device_ms"] = kernel_device_ms(fn, ("",), 3)
        line[prefix + "rounds"] = rounds
        line[prefix + "split_us"] = split(fn)

    batches = {
        "podaffinity": encode(*podaffinity_case(), C.Profile()),
        "topologyspreading": encode(*topology_case(W.pod_with_topology_spreading),
                                    C.Profile()),
        "binpacking": encode(*binpack_case(), C.Profile()),
    }
    for name, (b, params) in batches.items():
        rounds: list = []
        kernels.batched_assign(b, params, rounds_out=rounds)
        entry(f"b6_{name}_", lambda b=b, params=params: kernels.batched_assign(b, params), 10,
              rounds[0])
    cache, pending = basic_case(n_pending=1000)
    bg, pg = encode_topology(sliced(cache, SLICES), pending, C.Profile())
    masks, _ = slice_masks(bg)
    line["gang_placements"] = int(masks.shape[0])
    entry("gang_batched_hypotheses_",
          lambda: kernels.batched_hypotheses(bg.device, pg, masks), 3, None)
    b, params = batches["podaffinity"]
    want = kernels.batched_assign(b, params)
    for prefix, layout in (("k2_4shards_", node_mesh(4, True)), ("k6_2x2_", grid_mesh(True))):
        sb = M.shard_batch(b, layout)
        rounds = []
        got = batched_assign_device(sb, params, rounds_out=rounds)
        if not torch.equal(got[0].to(want[0].device), want[0]):
            raise AssertionError(f"--time-batched {prefix}: the sharded engine's assignments "
                                 "differ from the unsharded kernel's")
        entry(prefix, lambda sb=sb: batched_assign_device(sb, params), 5, rounds[0])


def kernel_split_us(fn, reps: int) -> dict | None:
    """Device µs a call of ``fn`` spends in each CUDA kernel it launches
    (by the kernel's name, its template arguments cut off), from
    ``torch.profiler`` over ``reps`` calls after a warm-up; None when the
    trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as err:
        log(f"kernel_split_us: torch.profiler failed ({err})")
        return None
    out: dict = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total:
            key = ev.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = key.split("(")[0].split("<")[0].split("::")[-1].strip()[:48]
            out[name] = out.get(name, 0.0) + ev.self_device_time_total / reps
    return out or None


def time_recorder(line: dict) -> None:
    """``--time-recorder``'s entries of ``line``, for the imported checkout:
    B10 (``kernels.explain_summary``) on the SchedulingBasic batch (1024 x
    5120, one pod class) with the plain greedy engine's assignments, and
    ``filter_score`` alone on the batch (a checkout whose explain starts
    with a ``filter_score`` launch spends this in it); B10 on the same
    batch with every pod a class of its own (C = P, as on the webhook
    paths); B5 as the cycle calls it, ``ResidentNodeState.scatter`` of a
    1024-slot Basic delta (1024 rows, pads included, shipped in the
    cycle's packed upload); ``filter_component_masks`` as its callers take
    it: the recorder's launch and fetch for one unschedulable pod of the
    Basic batch (``masks_as_recorder``) and the bridge's
    ``ExtenderBackend._components`` on a one-pod request; and B9
    (``dry_run_preemption``) at 5120 x 8 (PreemptionAsync's K, its main
    path launches) and 5120 x 128. Each: CUDA-event median ms a call and
    the card's busy ms a call (``torch.profiler``, every kernel and copy);
    the explain's busy µs split by kernel."""
    import dataclasses

    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.greedy import greedy_assign_plain
    from kubetpu_torch.bridge.server import ExtenderBackend
    from kubetpu_torch.framework import config as C

    def entry(prefix, fn, reps):
        line[prefix + "ms"] = cuda_ms(fn, reps)
        line[prefix + "device_ms"] = kernel_device_ms(fn, ("",), 5)

    cache, pending = basic_case()
    b, params = encode(cache, pending, C.Profile())
    idx = greedy_assign_plain(b, params)[0].to(torch.int32)
    torch.cuda.synchronize()
    entry("b10_basic_", lambda: kernels.explain_summary(b, params, idx), 50)
    line["b10_basic_split_us"] = kernel_split_us(
        lambda: kernels.explain_summary(b, params, idx), 5)
    entry("b3_basic_", lambda: kernels.filter_score(b, params), 50)
    # a class a pod: a replaced batch carries no pod classes
    singles = dataclasses.replace(b)
    entry("b10_singletons_", lambda: kernels.explain_summary(singles, params, idx), 20)
    line["b10_singletons_split_us"] = kernel_split_us(
        lambda: kernels.explain_summary(singles, params, idx), 3)

    # a Basic delta through the cycle's own refresh, captured at its scatter
    resident, shipped, _, _ = basic_delta(cache, pending)
    line["b5_slots"] = int(shipped["delta.idx"].shape[0])
    entry("b5_delta_", lambda: resident.scatter(shipped), 200)

    entry("fcm_recorder_", lambda: masks_as_recorder(b, params, [b.requests.shape[0] - 1]),
          50)
    one, one_params = encode(*basic_case(n_pending=1), C.Profile())
    entry("fcm_bridge_", lambda: ExtenderBackend._components(None, one, one_params), 50)
    for K in (8, 128):
        args = victim_tensors(11, 5120, K, 3)
        entry(f"b9_k{K}_", lambda args=args: kernels.dry_run_preemption(*args), 20)


# the parts of a batched solve (batched_round.cu's kSplit order)
BATCHED_PARTS = ("start", "partials_0_2", "verdicts_3", "normalize_4", "best_5", "ties_6",
                 "rank_pick_7", "admissions_8", "commit_9", "end")


def kernel_device_ms(fn, kernels: tuple, reps: int):
    """Device ms a call of ``fn`` spends in the kernels whose name, in
    lower case, holds one of ``kernels``, from ``torch.profiler`` over
    ``reps`` calls (after a warm-up); None when the trace holds no such
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as err:
        # no device trace on this machine: the time is then not measured
        log(f"kernel_device_ms: torch.profiler failed ({err})")
        return None
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        # the kernels themselves, not the host ops that launched them
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and any(k in ev.key.lower() for k in kernels)):
            total_us += ev.self_device_time_total
            count += ev.count
    return None if count == 0 else total_us / reps / 1e3


# the names of B3's kernels (either tree's), for the device time a launch
B3_KERNELS = ("filter_score_pairs", "filter_score_normalize", "broadcast_rows", "prelaunch")


def time_b3(line: dict) -> None:
    """``--time-b3``'s entries of ``line``, for the imported checkout: B3
    (``kernels.filter_score``, CUDA-event medians) on the SchedulingBasic,
    SchedulingPodAffinity, TopologySpreading, PreferredTopologySpreading
    and BinPacking batches (1024 x 5120), the webhook batch (Basic with
    extender leaves: every pod its own class) and the prioritized-list
    batch (1024 x 512), and in potential mode on a one-pod view; the Basic
    greedy engine (B3 without the total, then B4) and the packing solve on
    the BinPacking block (B3 in every round); K4 at 2^14 int64 over four
    logical shards: its host wall a call and its kernel's device time
    (``torch.profiler``) beside ``torch.argmax`` over the gathered vector
    (its host wall with the read, and its CUDA-event time as PERF.md's
    library column has it); and the host cost of the class key a batch
    (``runtime.pod_classes_of``, where the checkout has it). Each B3 batch
    is also timed as the rounds launch it (arguments packed once,
    ``_launch_filter_score``: ``*_launch_ms``) and by its kernels' device
    time (``*_device_ms``), and held to the plain version first."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.greedy import _pod_view
    from kubetpu_torch.assign.packing import PackingWeights
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.framework import runtime as rt
    from kubetpu_torch.perf import workloads as W

    key_us: dict = {}
    if hasattr(rt, "pod_classes_of"):
        plain_key = rt.pod_classes_of

        def timed_key(leaves):
            t0 = time.perf_counter()
            out = plain_key(leaves)
            key_us.setdefault("last", []).append(1e6 * (time.perf_counter() - t0))
            return out

        rt.pod_classes_of = timed_key
    batches = {}
    for name, case in (
            ("basic", basic_case), ("podaffinity", podaffinity_case),
            ("topologyspreading", lambda: topology_case(W.pod_with_topology_spreading)),
            ("preferred", lambda: topology_case(W.pod_with_preferred_topology_spreading)),
            ("binpacking", binpack_case),
            ("prioritized", lambda: dra_cache(dra_objects(n_nodes=512, n_prio=768,
                                                          n_dense=256)))):
        key_us.pop("last", None)
        batches[name] = encode(*case(), C.Profile())
        if "last" in key_us:
            line[f"{name}_class_key_us"] = key_us["last"][-1]
    b, params = batches["basic"]
    batches["webhook"] = (with_extender(b), params)
    for name, (bb, pp) in batches.items():
        cl = getattr(rt, "pod_classes", lambda _: None)(bb)
        line[f"{name}_classes"] = int(bb.requests.shape[0]) if cl is None else cl.count
        km, kt = kernels.filter_score(bb, pp)
        pm, pt = rt.feasible_and_scores(bb, pp)
        if not (torch.equal(km, pm) and torch.equal(kt, pt)):
            raise AssertionError(f"--time-b3 {name}: filter_score differs from plain")
        line[f"{name}_filter_score_ms"] = cuda_ms(lambda: kernels.filter_score(bb, pp), 20)
        # as the rounds launch it: its arguments packed once
        a, keep = kernels._score_args(bb, pp, "time_b3", bits_blocks=bb.requests.shape[0])
        extra = {"classes": cl} if cl is not None else {}
        launch = (lambda: kernels._launch_filter_score(a, bb.device, True, True,
                                                       kernels._smem(bb), **extra))
        line[f"{name}_launch_ms"] = cuda_ms(launch, 20)
        line[f"{name}_device_ms"] = kernel_device_ms(launch, B3_KERNELS, 20)
    view = _pod_view(b, 0)
    line["potential_ms"] = cuda_ms(lambda: kernels.potential_mask(
        view, params, b.requested, b.pod_count, b.node_ports), 20)
    line["basic_greedy_scan_ms"] = cuda_ms(lambda: kernels.greedy_scan(b, params), 10)
    bb, pp = batches["binpacking"]
    w = PackingWeights().tensor("cuda")
    cold = torch.zeros(bb.alloc.shape[0], dtype=torch.float32, device="cuda")
    line["binpacking_packing_ms"] = cuda_ms(lambda: kernels.packing_assign(bb, pp, cold, w), 5)
    line["binpacking_packing_iterations"] = int(kernels.packing_assign(bb, pp, cold, w)[4])
    # K4 beside torch.argmax
    mesh = node_mesh(4, True)
    n = 1 << 14
    per = n // mesh.size
    pieces = [torch.arange(g * per, (g + 1) * per, dtype=torch.int64, device=d)
              for g, d in enumerate(mesh.devices)]
    whole = torch.cat(pieces)
    if kernels.shard_argmax(pieces, mesh) != n - 1:
        raise AssertionError("shard_argmax: wrong pick")
    line["k4_host_ms"] = wall_ms(lambda: kernels.shard_argmax(pieces, mesh), 101)
    line["k4_device_ms"] = kernel_device_ms(lambda: kernels.shard_argmax(pieces, mesh),
                                            ("shard_argmax",), 50)
    line["argmax_host_ms"] = wall_ms(lambda: int(torch.argmax(whole)), 101)
    line["argmax_cuda_ms"] = cuda_ms(lambda: torch.argmax(whole), 20)
    line["argmax_device_ms"] = kernel_device_ms(lambda: torch.argmax(whole), ("argmax",), 50)
    log(json.dumps({"time_b3_partial": line}))


def _touched_slots(assignments, threads=1024) -> tuple[int, int]:
    """What a scan's steps pay for the nodes touched so far: summed over
    the steps, the touched nodes (each a recomputed verdict and base
    score) and the (iteration, warp) slots of the scan's node loop that
    hold at least one touched node (thread ``tid`` takes nodes ``tid``,
    ``tid + threads``, ...; a slot with one touched lane runs the
    recompute for its whole warp)."""
    seen, slots = set(), set()
    nodes = warps = 0
    for j in assignments:
        nodes += len(seen)
        warps += len(slots)
        if j >= 0:
            seen.add(j)
            slots.add((j // threads, (j % threads) // 32))
    return nodes, warps


def _loaded_except(b, keep):
    """``b`` with every real node but those in ``keep`` holding one
    SchedulingBasic init pod and those in ``keep`` none, so that the scan
    without a score leaf fills the ``keep`` nodes in index order."""
    import dataclasses

    import torch

    n_nodes = int(b.node_valid.sum().item())
    # the Basic block's node 0 holds one init pod, its last node none
    loaded = torch.ones(b.alloc.shape[0], dtype=torch.bool, device=b.alloc.device)
    loaded[n_nodes:] = False
    loaded[torch.tensor(sorted(keep), dtype=torch.long, device=b.alloc.device)] = False
    nodes = _clone_nodes(b.nodes)
    for name in ("requested", "nonzero_requested", "pod_count"):
        x = getattr(nodes, name)
        one, empty = x[0].clone(), x[n_nodes - 1].clone()
        x[:n_nodes] = empty
        x[loaded] = one
    return dataclasses.replace(b, nodes=nodes)


def time_dra() -> int:
    """The ``--time-dra`` mode: where the scan's time goes with a
    DynamicResources score leaf, on the SchedulingBasic cycle (1024 pods x
    5120 padded nodes, whose node-affinity and taint rows already run the
    normalize pass every step). Five batches: (A) without a DRA leaf; (B)
    a flat leaf, which adds the term but keeps A's assignments; (C) the
    seeded leaf of phase 3, which moves them; (G) without a leaf, with the
    node state loaded so that the scan fills first, in index order, every
    node C chose; (H) G with the flat leaf (G's assignments). Prints each
    one's ``greedy_scan`` median (CUDA events), timed twice in mirrored
    order, with the touched nodes and touched warp slots its steps
    recompute (``_touched_slots``), the term's cost at either placement
    (B - A, H - G) and the cost of scattered placements without the term
    (G - A)."""
    import dataclasses

    sys.path.insert(0, str(ROOT))
    card = device_phase()
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.framework import config as C

    kernels.build()
    log_build_report(kernels)
    b0, params = encode(*basic_case(), C.Profile())
    batches = {"A": b0, "B": dra_leaf(b0, seed=9, flat=True), "C": dra_leaf(b0, seed=9)}
    chosen = [j for j in kernels.greedy_scan(batches["C"], params)[0].tolist() if j >= 0]
    batches["G"] = _loaded_except(b0, set(chosen))
    batches["H"] = dataclasses.replace(batches["G"], dra_score_raw=batches["B"].dra_score_raw,
                                       dra_score_sig=batches["B"].dra_score_sig)
    out = {k: kernels.greedy_scan(b, params)[0] for k, b in batches.items()}
    for x, y in (("A", "B"), ("G", "H")):
        if not torch.equal(out[x], out[y]):
            raise AssertionError(f"the flat leaf moved batch {x}'s assignments")
    if out["G"][:len(set(chosen))].tolist() != sorted(set(chosen)):
        raise AssertionError("batch G does not fill first the nodes that batch C chose")
    ms = {k: [] for k in batches}
    for k in list(batches) + list(batches)[::-1]:
        ms[k].append(cuda_ms(lambda: kernels.greedy_scan(batches[k], params), 10))
    line = {"card": card, "shape": list(b0.requests.shape[:1]) + [b0.alloc.shape[0]]}
    for k, a in out.items():
        nodes, warps = _touched_slots([j for j in a.tolist()])
        line[k] = {"greedy_scan_ms": ms[k], "distinct_nodes": len(set(a.tolist()) - {-1}),
                   "touched_nodes_summed": nodes, "touched_warp_slots_summed": warps}
    med = {k: statistics.median(v) for k, v in ms.items()}
    line["term_ms_contiguous"] = med["B"] - med["A"]
    line["term_ms_scattered"] = med["H"] - med["G"]
    line["scatter_ms_without_leaf"] = med["G"] - med["A"]
    line["seeded_over_same_nodes_flat"] = med["C"] / med["H"]
    log(json.dumps({"time_dra": line}))
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] in ("--time-basic", "--time-spread", "--time-mesh",
                                              "--time-b3", "--time-batched",
                                              "--time-recorder"):
        return time_checkout(sys.argv[1][len("--time-"):], sys.argv[2])
    if sys.argv[1:] == ["--time-dra"]:
        return time_dra()
    if sys.argv[1:] == ["--webhook-queue"]:
        sys.path.insert(0, str(ROOT))
        return webhook_queue_mode()
    if sys.argv[1:] == ["--mesh"]:
        if not (ROOT / "kubetpu_torch" / "kernels" / "csrc").is_dir():
            raise SystemExit("chip_smoke: run from the root of a kubetpu checkout")
        return mesh_mode()
    if not (ROOT / "kubetpu_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from the root of a kubetpu checkout "
                         "(kubetpu_torch/ not found beside this script)")
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    card = device_phase()
    build_phase()
    stamp("phases 1-2")
    kernel_lines = kernels_phase()
    runs = main_path_phase(card)
    stamp("phase 4: mesh paths")
    path_launches = [run[0] for run in runs.values()]
    gang_runs, gang_preemption = gang_paths(card)
    path_launches += [run[0] for run in gang_runs.values()] + [gang_preemption]
    stamp("phase 4: gang paths")
    packing_runs = packing_paths(card)
    path_launches += [run[0] for run in packing_runs.values()]
    stamp("phase 4: packing paths")
    mesh4, grid4 = node_mesh(4, True), grid_mesh(True)
    path_launches += [run[0] for run in mesh12_paths(
        card, mesh4, grid4, {**runs, **packing_runs}).values()]
    stamp("phase 4: packing-mesh and grid paths")
    path_launches += [run[0] for run in gang_mesh_paths(card, mesh4, grid4,
                                                         gang_runs).values()]
    stamp("phase 4: gang paths under the mesh and the grid")
    path_launches += dra_paths(card)
    stamp("phase 4: DRA paths")
    path_launches.append(bridge_phase(card))
    stamp("phase 4: bridge")
    stepped_preemption_phase()
    stamp("phase 4: stepped preemption")
    for k in kernel_lines:
        k["launches"] = sum(launches[k["name"]] for launches in path_launches)
    import torch

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": kernel_lines}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
